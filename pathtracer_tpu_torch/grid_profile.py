"""The grid path's profile on the card: per-pass time, era-ladder
diagnostics and the device-time split between the pair kernel (K2) and its
glue (the counterpart of the reference's ``scripts/grid_profile.py``).

    python -m pathtracer_tpu_torch.grid_profile [--scene big_mesh]
        [--axis N] [--rays 262144] [--reps 5]
        [--sweep "W0,We[,l1-l2];..."] [--trace]

Builds the scene as config 5 builds it (its BVH, then the grid at
config 5's axis, or --axis), rebuilds the bench band's three passes at
--rays rays per call (roofline.band_passes: primary, bounce 1, shadow 1),
and prints per pass, from ``closest_hit_grid(..., stats=True)``: the
milliseconds of the whole call (CUDA events, warm, best of --reps) and
Mrays/s, the eras, the rays still live after stage A
(``live_after_phase0``), the pair kernel's cluster visits and visits per
ray, and the pair kernel's launches. The reference's ``unfinished`` column
is not printed: the port's era walk runs until no ray is live
(ops/intersect_grid.py raises if it ever would not), so it is 0 by
construction.

``--sweep`` times each combination of stage A's width W0, the era width
We and, optionally, the ladder's divisors l1-l2 in one process, in place
of the default knobs.
``--trace`` records the bounce pass three times with ``torch.profiler`` and
prints the device time in K2 (``pair_hit_kernel``), in sorts, in gathers
and scatters and in everything else, the top 15 kernels, and the idle
share of those calls (1 - device busy / synchronised wall). The card
only: without CUDA it exits.
"""

from __future__ import annotations

import argparse
import time

import torch

from .accel.auto import prepare_accel
from .accel.build import with_bvh
from .config import PRESETS
from .ops import intersect_grid as ig
from .roofline import DEFAULT_RAYS, band_passes, best_ms
from .scene.builder import build_scene
from .utils.profiling import card_line, device_kernel_times

TOP_KERNELS = 15
TRACE_CALLS = 3
K2 = "K2 (pair_hit)"
# Device kernels by name, in this order: the pair kernel, sorts (cub's
# radix sorts), gathers and scatters (indexing, index_put, scatter), and
# everything else (the DDA, windows, compaction and reductions).
CLASSES = ((K2, ("pair_hit_kernel",)),
           ("sorts", ("sort",)),
           ("gathers and scatters", ("gather", "scatter", "index")))


def pass_stats(g, passes, kw: dict) -> list:
    """closest_hit_grid(stats=True)'s dict for each (name, o, d, t_max) of
    `passes`, with the pair kernel's launches of the call."""
    out = []
    for _, o, d, t_max in passes:
        n0 = ig.LAUNCHES
        *_, info = ig.closest_hit_grid(g, o, d, t_max=t_max, stats=True,
                                       **kw)
        out.append({**info, "launches": ig.LAUNCHES - n0})
    return out


def time_passes(g, passes, kw: dict, reps: int) -> tuple:
    """Prints each pass's time and stats; returns the passes' total ms and
    their stats (pass_stats)."""
    print(f"[grid_profile] knobs {kw or 'default'}")
    print(f"[grid_profile] {'pass':26s} {'ms':>9} {'Mrays/s':>8} "
          f"{'eras':>5} {'live A':>7} {'visits':>8} {'v/ray':>7} "
          f"{'K2 x':>5}")
    total = 0.0
    stats = pass_stats(g, passes, kw)
    for (name, o, d, t_max), info in zip(passes, stats):
        ms = best_ms(lambda: ig.closest_hit_grid(g, o, d, t_max=t_max, **kw),
                     reps)
        total += ms
        R = o.shape[0]
        print(f"[grid_profile] {name:26s} {ms:9.3f} {R / ms / 1e3:8.3f} "
              f"{info['eras']:5d} {info['live_after_phase0']:7d} "
              f"{info['visits']:8d} {info['visits'] / R:7.4f} "
              f"{info['launches']:5d}")
    print(f"[grid_profile] {'total (3 passes)':26s} {total:9.3f}")
    return total, stats


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def trace_split(g, o, d, t_max) -> dict:
    """Device time of TRACE_CALLS calls on (o, d, t_max) by kernel class,
    from torch.profiler, and their idle share against the synchronised
    wall time of TRACE_CALLS unprofiled calls; prints both and the top
    kernels, and returns the per-class ms, busy and wall ms and the idle
    share."""

    def call():
        ig.closest_hit_grid(g, o, d, t_max=t_max)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRACE_CALLS):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_kernel_times(call, TRACE_CALLS)
    busy = sum(ms for ms, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    split = {label: 0.0 for label, _ in CLASSES}
    split["other"] = 0.0
    for name, (ms, _) in by_name.items():
        split[kernel_class(name)] += ms
    idle = 1.0 - busy / wall_ms
    print(f"[grid_profile] {TRACE_CALLS} calls: wall {wall_ms:.3f} ms "
          f"(unprofiled, synchronised), device busy {busy:.3f} ms "
          f"({n_kernels} kernels, profiled), idle {idle:.4f}")
    for label, ms in split.items():
        print(f"[grid_profile]   {label:22s} {ms:10.3f} ms "
              f"{100 * ms / max(busy, 1e-9):5.1f}%")
    print(f"[grid_profile] top {TOP_KERNELS} kernels by device time:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    for name, (ms, n) in top:
        print(f"[grid_profile]   {ms:10.3f} ms {n:6d}x  {name[:100]}")
    return {"split_ms": split, "busy_ms": busy, "wall_ms": wall_ms,
            "idle": idle, "kernels": n_kernels}


def parse_sweep(text: str) -> list:
    """'W0,We[,l1-l2];...' -> one dict of closest_hit_grid's knobs
    (first_steps, era_steps[, ladder]) per combination."""
    out = []
    for combo in text.split(";"):
        parts = combo.split(",")
        if len(parts) not in (2, 3):
            raise ValueError(f"sweep combination {combo!r}: want W0,We or "
                             "W0,We,l1-l2")
        kw = {"first_steps": int(parts[0]), "era_steps": int(parts[1])}
        if len(parts) == 3:
            kw["ladder"] = tuple(int(x) for x in parts[2].split("-"))
        out.append(kw)
    return out


def run(scene, cfg, n_rays: int, reps: int, device, sweep=None,
        trace: bool = False) -> dict:
    """The profile of `scene` (on the card, with grid tables) at the
    default knobs; returns the passes' total ms and stats (with `sweep`,
    each combination's total instead) and, with `trace`, the bounce pass's
    device split."""
    g = scene.geometry
    passes = band_passes(scene, cfg, n_rays, device)
    print(f"[grid_profile] scene={cfg.scene} triangles={g.tri_v0.shape[0]} "
          f"axis={ig.grid_axis(g)} clusters={g.cl_feat_split.shape[0]} "
          f"rays/call={n_rays} reps={reps} on {card_line()}")
    out = {}
    if sweep:
        totals = [(time_passes(g, passes, combo, reps)[0], combo)
                  for combo in sweep]
        best = min(totals, key=lambda tc: tc[0])
        print(f"[grid_profile] best: {best[1]} total {best[0]:.3f} ms")
        out["sweep"] = totals
    else:
        out["total_ms"], out["stats"] = time_passes(g, passes, {}, reps)
    if trace:
        name, o, d, t_max = passes[1]
        print(f"[grid_profile] device-time split of {TRACE_CALLS}x {name}:")
        out["trace"] = trace_split(g, o, d, t_max)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.grid_profile",
        description="Per-pass time, era diagnostics and the K2-vs-glue "
                    "split of the grid path on the card.")
    ap.add_argument("--scene", default="big_mesh")
    ap.add_argument("--axis", type=int, default=None,
                    help="grid axis (default: config 5's, accel/grid.py:"
                    "pick_axis)")
    ap.add_argument("--rays", type=int, default=DEFAULT_RAYS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", default=None,
                    help="semicolon list of W0,We[,l1-l2] combinations "
                    "timed in one process, e.g. '4,4;6,4;4,4,2-8'")
    ap.add_argument("--trace", action="store_true",
                    help="torch.profiler split of the bounce pass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grid_profile measures the card: no CUDA device")
    device = torch.device("cuda")
    cfg = PRESETS["config5"].replace(scene=args.scene)
    sweep = parse_sweep(args.sweep) if args.sweep else None
    with torch.inference_mode():
        scene = build_scene(cfg.scene)
        if cfg.use_bvh:
            scene = with_bvh(scene)
        scene = prepare_accel(scene, cfg, grid_axis=args.axis).to(device)
        run(scene, cfg, args.rays, args.reps, device, sweep=sweep,
            trace=args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
