"""Benchmark of the PyTorch/CUDA port: useful rays/s of whole frames.

    python bench_torch.py [--smoke] [--scene cornell_mesh] [--depth 4]
                          [--backend jnp|pallas|cluster|stream|grid]
                          [--budget 60] [--compact] [--grad]
                          [--device cuda|cpu]

The port's counterpart of ``bench.py``. Prints ONE JSON line on stdout, its
last line:
    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N}

Metric: useful rays traced per second (live path segments + candidate
shadow rays, dead lanes excluded, counted by the engine's
``trace_sample(with_stats=True)``) over whole frames of the ``bench``
preset (cornell_mesh, 1024², 1 spp, depth 4) unless flags say otherwise.
A frame traces every one of its ``spp`` samples over the tile-ordered
pixel ids and counts all their rays. With ``--grad`` each sample is a
value-and-grad step of ``mean(rad²)`` w.r.t. the materials, and the rays
are its forward rays, so grad rays/s compares with forward rays/s.

Timing: one untimed warm-up frame (which builds the kernels), then frames
timed one by one on the host clock, each ending in a device barrier, until
``--budget`` seconds have passed and at least MIN_FRAMES frames were timed.
``value`` is the sum of rays over the sum of seconds; the per-frame median,
min and max rays/s go on the log line (stderr) and into the metrics row.

Records (never the reference's TPU records): each run but ``--smoke``
appends a row to ``bench_metrics_torch.jsonl``; ``--record-baseline``
stores the run's value for its task in ``.bench_baseline_torch.json``.
``vs_baseline`` is the ratio to the stored value of the same task only
when that entry carries a methodology stamp of its own equal to this
run's (which names the device); otherwise it is null.

Runs on the card unless given ``--device cpu``; without a CUDA device,
``--device cuda`` (the default) exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import PRESETS
from pathtracer_tpu_torch.diff.render import value_and_grad
from pathtracer_tpu_torch.engine.camera import tiled_pixel_ids
from pathtracer_tpu_torch.engine.wavefront import trace_sample
from pathtracer_tpu_torch.scene.builder import build_scene
from pathtracer_tpu_torch.utils.logging import log, log_json
from pathtracer_tpu_torch.utils.profiling import device_barrier

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_PATH = os.path.join(HERE, ".bench_baseline_torch.json")
METRICS_PATH = os.path.join(HERE, "bench_metrics_torch.jsonl")
MIN_FRAMES = 5
MAX_FRAMES = 10_000
METHODOLOGY_VERSION = "whole-frames-all-spp-v1"


def make_frame(scene, cfg, grad: bool, device):
    """A callable that runs one frame and returns its useful rays after a
    device barrier."""
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    g, cam, lights = scene.geometry, scene.camera, scene.lights

    @torch.inference_mode()
    def frame() -> int:
        rays = torch.zeros((), dtype=torch.int64, device=device)
        for s in range(cfg.spp):
            _, n = trace_sample(g, scene.materials, cam, lights, cfg, ids, s,
                                with_stats=True)
            rays = rays + n
        return int(device_barrier(rays))

    def grad_frame() -> int:
        rays = torch.zeros((), dtype=torch.int64, device=device)
        done = torch.zeros((), dtype=torch.float32, device=device)
        for s in range(cfg.spp):
            stats = {}

            def loss_fn(mats):
                rad, stats["n"] = trace_sample(g, mats, cam, lights, cfg, ids,
                                               s, with_stats=True)
                return torch.mean(rad * rad)

            loss, grads = value_and_grad(loss_fn, scene.materials)
            rays = rays + stats["n"]
            # The barrier waits on the loss and every grad leaf.
            done = done + loss + grads.albedo.abs().sum() \
                + grads.emission.abs().sum()
        device_barrier(done)
        return int(rays)

    return grad_frame if grad else frame


def time_frames(frame, budget: float) -> list:
    """(seconds, rays) of frames timed one by one until `budget` seconds
    have passed and at least MIN_FRAMES were timed."""
    samples = []
    deadline = time.perf_counter() + budget
    while len(samples) < MIN_FRAMES or time.perf_counter() < deadline:
        t0 = time.perf_counter()
        n = frame()
        samples.append((time.perf_counter() - t0, n))
        if len(samples) >= MAX_FRAMES:
            break
    return samples


def load_store(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            store = json.load(f)
        if isinstance(store.get("tasks"), dict):
            return store
    return {"tasks": {}}


def vs_baseline(store: dict, task: str, value: float,
                methodology: dict) -> float | None:
    """value over the task's stored baseline, only when the entry carries
    its own methodology stamp equal to `methodology`; else None."""
    base = store["tasks"].get(task)
    if base and base.get("value") and base.get("methodology") == methodology:
        return round(value / float(base["value"]), 4)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch.py")
    ap.add_argument("--smoke", action="store_true",
                    help="128x128, budget at most 20 s; writes no records")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--budget", type=float, default=60.0,
                    help="wall-clock seconds of timed frames (at least "
                    f"{MIN_FRAMES} frames are timed)")
    ap.add_argument("--backend", default=None,
                    choices=["jnp", "pallas", "cluster", "stream", "grid"],
                    help="override cfg.backend")
    ap.add_argument("--compact", action="store_true",
                    help="enable stream compaction between bounces")
    ap.add_argument("--grid-axis", type=int, default=None,
                    help="override the grid backend's cells-per-axis "
                    "(accel/grid.py:pick_axis otherwise)")
    ap.add_argument("--grad", action="store_true",
                    help="time value-and-grad steps of mean(rad^2) w.r.t. "
                    "the materials; rays are their forward rays")
    ap.add_argument("--record-baseline", action="store_true",
                    help="store this run's value as the baseline of its "
                    "task under this run's methodology")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = pt._device(args.device)
    except RuntimeError:
        ap.error(f"--device {args.device}: no CUDA device; pass --device "
                 "cpu to run on the CPU")

    cfg = PRESETS["bench"]
    if args.smoke:
        cfg = cfg.replace(width=128, height=128)
        args.budget = min(args.budget, 20.0)
    for field, flag in [("width", "width"), ("height", "height"),
                        ("max_depth", "depth"), ("scene", "scene"),
                        ("backend", "backend"), ("spp", "spp")]:
        v = getattr(args, flag)
        if v is not None:
            cfg = cfg.replace(**{field: v})
    if args.compact:
        cfg = cfg.replace(compact=True)

    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    scene = prepare_accel(scene, cfg, grid_axis=args.grid_axis).to(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    frame = make_frame(scene, cfg, args.grad, device)
    t0 = time.perf_counter()
    n0 = frame()
    log("bench warmed up", secs=round(time.perf_counter() - t0, 3),
        rays=n0, cfg=cfg.scene, backend=cfg.backend, device=kind)

    samples = time_frames(frame, args.budget)
    total_secs = sum(s for s, _ in samples)
    total_rays = sum(n for _, n in samples)
    rays_per_s = total_rays / max(total_secs, 1e-12)
    per_frame = [n / s for s, n in samples]
    spread = {
        "frame_rays_per_s_median": round(statistics.median(per_frame), 1),
        "frame_rays_per_s_min": round(min(per_frame), 1),
        "frame_rays_per_s_max": round(max(per_frame), 1),
    }
    log("bench measured", frames=len(samples), secs=round(total_secs, 3),
        rays=total_rays, **spread)

    methodology = {"timing": METHODOLOGY_VERSION, "device": kind}
    task = (f"{cfg.scene} {cfg.width}x{cfg.height} {cfg.spp}spp "
            f"depth{cfg.max_depth}" + (" grad" if args.grad else ""))
    store = load_store(BASELINE_PATH)
    ratio = vs_baseline(store, task, rays_per_s, methodology)
    if args.record_baseline and not args.smoke:
        store["tasks"][task] = {
            "value": rays_per_s, "unit": "rays/s", "device": kind,
            "cfg": cfg.to_json(), "methodology": methodology,
        }
        with open(BASELINE_PATH, "w") as f:
            json.dump(store, f, indent=1)

    if not args.smoke:
        log_json(
            METRICS_PATH,
            config=f"{cfg.scene} {cfg.width}x{cfg.height} {cfg.spp}spp "
                   f"depth{cfg.max_depth} backend={cfg.backend} "
                   f"compact={cfg.compact}"
                   + (" grad=fwd+bwd" if args.grad else ""),
            chips=1, hosts=1,
            rays_per_s_per_chip=round(rays_per_s, 1),
            scaling_eff=1.0, device=kind, frames=len(samples),
            secs=round(total_secs, 3), **spread,
        )

    print(json.dumps({
        "metric": (
            f"{'grad-step ' if args.grad else ''}rays/s/chip "
            f"({cfg.scene} {cfg.width}x{cfg.height} "
            f"{cfg.spp}spp depth{cfg.max_depth} backend={cfg.backend} "
            f"on {kind})"
        ),
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        # null unless the task's stored baseline carries this run's stamp.
        "vs_baseline": ratio,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
