"""The parts every traffic mode shares: finding a cell's files by name, the
timed window, the checks' verdict, the metrics and the result line.

A cell is `workloads/<cell>.json` (its mode, the mode's parameters and the
limits of its checks) on the configuration `configs/<config>.json` (the
preset it runs). A mode is `modes/<mode>.py`, a metric `metrics/<name>.py`
(a `read(run)` that returns a number or None), a span `spans/<name>.json`;
each is found by name, so a new one is a new file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the run must not have loaded (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")


def log(msg: str) -> None:
    print(f"[ptbench] {msg}", file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"ptbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"ptbench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"ptbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: its end-to-end metrics
    (trace 0) or its per-layer ones (trace 1)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Run:
    """One run of one cell: its files, its arguments and what it measured."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, t_start: float, device=None,
                 overrides: dict | None = None):
        self.name = workload
        self.cell = load_json("workloads", workload)
        self.config = load_json("configs", self.cell["config"])
        # Tests shrink a cell: {"config": {...}, "preset": {...},
        # "params": {...}} update those dicts.
        self.overrides = overrides or {}
        for key, over in self.overrides.items():
            if key == "config":
                self.config.update(over)
            else:
                target = self.config if key == "preset" else self.cell
                target[key] = {**target[key], **over}
        self.params = self.cell["params"]
        self.recorded = {}       # (module, function) -> work.Recorder
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.device = device
        self.rank, self.world = 0, 1
        # Filled by the run.
        self.setup_s = None
        self.scene_build_s = None
        self.step_s: list = []
        self.rays = 0
        self.window_s = None
        self.memory_peak_bytes = 0
        self.summary = None      # trace.Summary of the traced window
        self.bound_ms = {}       # roofline bound per kernel, ms per frame
        self.checks: list = []   # (name, value, limit), in compare order
        self.attempted = 0
        self.failed = 0

    @property
    def render_seed(self) -> int:
        """The renders' 32-bit sampler seed, drawn from --seed."""
        return self.seed % (2 ** 31)

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    def compare(self, name: str, value: float) -> bool:
        """Records `value` against the cell's limit `name`; True if within."""
        limit = self.limit(name)
        ok = value == value and value <= limit
        self.checks.append((name, float(value), limit))
        return ok

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for _, v, lim in self.checks)


def window(run: Run, step, go_on=None) -> None:
    """Runs step(i) -> useful rays (an int, after a device barrier) back to
    back for run.seconds, each timed on the host clock; fills run.step_s,
    run.rays, run.window_s and run.attempted. `go_on(more) -> bool`, where
    given, turns this process's verdict after each step (whether its clock
    is short of the end) into the one every process follows."""
    rays = 0
    t_end = time.perf_counter() + run.seconds
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        rays += step(i)
        e = time.perf_counter()
        run.step_s.append(e - s)
        i += 1
        more = e < t_end
        if go_on is not None:
            more = go_on(more)
        if not more:
            break
    run.window_s = time.perf_counter() - t0
    run.rays = rays
    run.attempted = i


def log_steps(run: Run) -> None:
    """The spread of the window's frame or step times, on standard error."""
    from .stats import percentile

    s = run.step_s
    log(f"{run.name} window {run.window_s:.3f} s, {run.attempted} frames, "
        f"{run.rays} rays; frame s min {min(s):.4f} median "
        f"{percentile(s, 50):.4f} p95 {percentile(s, 95):.4f} max "
        f"{max(s):.4f}")


def metric_values(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run, metrics: dict, kind: str, count: int) -> dict:
    """The result line. A run off the card (the tests' CPU runs) says
    platform "cpu" and carries no metric, busy time or breakdown: its
    times are no card's."""
    import torch

    on_card = torch.device(run.device).type == "cuda"
    if not on_card:
        metrics = {}
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind,
              "count": count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if on_card and run.trace and run.summary is not None:
        device["busy_s"] = run.summary.busy_s_mean
        device["window_s"] = run.summary.window_s
        out["breakdown"] = run.summary.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in run.checks}
    return out


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    sys.stdout.flush()
    print(json.dumps(out), flush=True)


def set_cache_dirs() -> None:
    """Compile caches at fixed paths inside the checkout, so that only the
    first run in a checkout builds (the port's own kernel and native
    builds already live under build/)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
