"""Device-time profile of one bench frame or one value-and-grad step, on
the card (the counterpart of the reference's ``scripts/band_profile.py``).

    python -m pathtracer_tpu_torch.band_profile [--preset bench]
        [--backend cluster] [--grad] [--reps 3] [--top 15]

Builds the preset's scene on the card, runs one warm-up, then times
``--reps`` runs and records ``--reps`` more with ``torch.profiler``: a
forward frame (trace_sample over the tile-ordered frame, under inference
mode) or, with ``--grad``, a
value-and-grad step of ``mean(rad²)`` w.r.t. the materials (bench.py
--grad's loss). Prints the synchronised wall seconds of the unprofiled
runs, the device busy time per profiled run (the sum of device kernel
time), the idle share (1 - busy / median wall) and the kernels by device
time. The card only: without CUDA it exits.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from .accel.auto import prepare_accel
from .accel.build import with_bvh
from .config import PRESETS
from .diff.render import value_and_grad
from .engine import wavefront
from .engine.camera import tiled_pixel_ids
from .scene.builder import build_scene
from .utils.profiling import card_line, device_kernel_times


def _runner(scene, cfg, ids, grad: bool):
    args = (scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
            ids, 0)

    def frame():
        with torch.inference_mode():
            wavefront.trace_sample(*args)

    def step():
        value_and_grad(
            lambda mats: torch.mean(wavefront.trace_sample(
                scene.geometry, mats, *args[2:]) ** 2), scene.materials)

    return step if grad else frame


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.band_profile",
        description="torch.profiler device-time split of one frame or "
                    "grad step on the card.")
    ap.add_argument("--preset", default="bench", choices=sorted(PRESETS))
    ap.add_argument("--backend", default=None)
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_profile measures the card: no CUDA device")
    cfg = PRESETS[args.preset]
    if args.backend:
        cfg = cfg.replace(backend=args.backend)
    device = torch.device("cuda")
    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    scene = prepare_accel(scene, cfg).to(device)
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    run = _runner(scene, cfg, ids, args.grad)
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    by_name = {name: (ms / args.reps, n) for name, (ms, n)
               in device_kernel_times(run, args.reps).items()}
    busy_ms = sum(ms for ms, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    wall_s = statistics.median(walls)
    what = "grad step" if args.grad else "frame"
    print(f"[profile] {args.preset} backend={cfg.backend} {what} "
          f"{cfg.width}x{cfg.height} depth {cfg.max_depth}: wall s "
          f"{[round(w, 6) for w in walls]}, "
          f"median {wall_s:.6f}; device busy {busy_ms:.3f} ms per run "
          f"({n_kernels // args.reps} kernels), idle "
          f"{1.0 - busy_ms / 1e3 / wall_s:.3f}; on {card_line()}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    for name, (ms, n) in top:
        print(f"[profile]   {ms:10.3f} ms {100 * ms / busy_ms:5.1f}% "
              f"{n // args.reps:6d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
