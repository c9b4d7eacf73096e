"""The course of a run on one card: set-up, warm frame, timed or traced
window, peak memory, the reference's check, the metrics."""

from __future__ import annotations

import contextlib
import gc
import importlib
import time

import torch

from . import check, harness, trace, work


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def log_builds() -> None:
    """The seconds each kernel source and the native builder took to build
    in this process (0.0 where the build directory already held it)."""
    from pathtracer_tpu_torch.accel import native
    from pathtracer_tpu_torch.ops import _build

    for name, rec in sorted(_build.BUILDS.items()):
        harness.log(f"build {name}.cu {rec['seconds']:.3f} s")
    if native.BUILD:
        harness.log(f"build bvh_builder.cpp "
                    f"{native.BUILD.get('seconds', 0.0):.3f} s")


def device_kind(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def set_up(run, Mode):
    """The mode's set-up through the warm frame; sets run.setup_s."""
    mode = Mode(run)
    mode.start(run.seed)
    mode.frame(0)
    sync(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    log_builds()
    harness.log(f"{run.name} set-up {run.setup_s:.3f} s (scene build "
                f"{run.scene_build_s:.3f} s)")
    return mode


def measure(run, mode, metric_mods) -> None:
    """The timed window (trace 0) or the traced one (trace 1)."""
    if not run.trace:
        harness.window(run, lambda i: mode.frame(i + 1))
        harness.log_steps(run)
        return
    n = int(run.params["trace_frames"])
    with contextlib.ExitStack() as stack:
        for mod in metric_mods:
            spec = getattr(mod, "RECORD", None)
            if spec and spec not in run.recorded:
                rec = work.Recorder(importlib.import_module(spec[0]),
                                    spec[1])
                run.recorded[spec] = stack.enter_context(rec)
        run.summary = trace.capture(
            lambda: [mode.frame(i + 1) for i in range(n)], n,
            lambda: sync(run.device))
    run.attempted = n
    harness.log(f"{run.name} traced {n} frames in "
                f"{run.summary.window_s:.3f} s, busy "
                f"{run.summary.busy_s:.6f} s, "
                f"{run.summary.data['unattributed_ops']} device operations "
                f"without a launch record")


def peak_memory(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free(mode) -> None:
    mode.free()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(run, mode, outputs) -> None:
    """The reference's numbers of the run's outputs against the limits."""
    t0 = time.perf_counter()
    ref = check.Reference(run.config, run.device)
    for name, value in mode.numbers(outputs, ref).items():
        run.compare(name, value)
    harness.log(f"{run.name} reference check {time.perf_counter() - t0:.3f} s")


def single(run, Mode) -> dict:
    entries = harness.cell_metrics(harness.benchmark(), run.name, run.trace)
    mods = [harness.load_module("metrics", m["name"]) for m in entries]
    mode = set_up(run, Mode)
    measure(run, mode, mods)
    run.memory_peak_bytes = peak_memory(run.device)
    outputs = mode.outputs()
    free(mode)
    judge(run, mode, outputs)
    metrics = harness.metric_values(run, entries)
    return harness.result(run, metrics, device_kind(run.device), 1)
