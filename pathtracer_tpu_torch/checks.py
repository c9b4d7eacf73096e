"""The check suite on the card: the kernels against brute force and the BVH
walk, and the engine against the oracle (the counterpart of the
reference's ``scripts/tpu_checks.py``).

    python -m pathtracer_tpu_torch.checks [--full]

Prints one line per check with its numbers and the kernels it launched,
then ``PASS`` or ``FAIL``; ``main`` returns 0 only when every check
passed. Each check runs its route's kernel on the card, never its plain
version: a check that launches other kernels than its own (the ops
modules' launch counters) fails. The card only: without CUDA it exits.

  [0] K1 (closest_hit_cluster) vs brute force: cornell_mesh, 4,096 seeded
      random rays; hit agreement > 0.999, |dt| q99 < 1e-4, materials
      agree > 0.999.
  [1] K4 (bvh_hit) on the same rays: bit for bit its mirror
      bvh_hit_ordered_plain; against the skip-link walk equal hit masks, t
      equal where the same triangle wins and within rtol 4e-3 / atol 2e-4,
      materials equal where t is equal.
  [2] the engine on the card (config 1 as the preset stands, brute force,
      no kernel) vs the oracle: allclose atol 5e-4, rtol 1e-3.
With --full:
  [3] config 2 at 128² through the cluster route (K1) vs the BVH route
      (K4): under 0.005 of pixels with a channel off by more than
      5e-3 + 5e-3 |bvh|.
  [4] the same through the stream route (K3), at [3]'s bar.
  [5] K2 (closest_hit_grid) vs brute force on cornell_mesh with a grid at
      axis 8, at [0]'s bars.
  [6] config 2 at 128² through the grid route (K2), at [3]'s bar.
  [7] compact=True vs compact=False, bit for bit: config 2 at 64², depth
      4, the cluster route.
  [8] cornell_sphlight through the cluster route (K1) vs the oracle, MIS
      off and on (64², spp 2, depth 3, roulette off), at [3]'s bar against
      the oracle: K1 computes the split product, so edge pairs and shadow
      tests near a light may flip, and a whole-image allclose is the wrong
      bar.
  [9] a value-and-grad step through the cluster route (K1), the bench
      preset at 32² and depth 2: the loss equals the same-seed forward
      frame's bit for bit; grads finite and, against central differences
      of the oracle, within tests/grad/test_grad.py's oracle bar (rtol
      3e-2; atol 1e-5 albedo, 1e-6 emission).
  [10] the furnace (one diffuse sphere in a background of 1) at depth 2,
      no roulette, albedo 1.0 and 0.5: every pixel equals the albedo or 1
      within 1e-5, and the oracle's image within 1e-5.
  [11] every host read inside closest_hit_grid is marked: one config-5
      frame (the 2M-triangle scene, built here) under the profiler and
      torch.cuda's sync debug mode; the synchronising calls raised inside
      closest_hit_grid equal its `pt.read` spans (utils/profiling.py:
      host_read), and there is at least one. The line also gives each
      read's source line and the synchronising calls elsewhere in the
      frame.
  [12] the DDA window kernel (dda_window): its windows bit-equal to the
      plain version's, without and with the occupancy bitmask, at every
      ptr from 0 to 3*axis (at the era width and width 1, and mixed per
      ray), one launch per call; on the real queries of one config-5
      frame (every bounce's closest-hit and shadow rays) and on 2^20
      seeded rays with edge cases (zero direction components, far
      origins, short and dead t_max) around grids of axis 4, 8 and 16;
      and closest_hit_grid's t, normal and material on the frame's
      queries through the kernel equal to those through the plain DDA
      (dda_window_plain), with one DDA launch per phase.
  [13] the per-ray line cull kernel (ray_cluster_mask): its (B, C) mask
      bit-equal to ray_cluster_mask_plain's on 2^20 seeded rays with edge
      cases (cull_rays) against the first C of 512 seeded boxes
      (cull_boxes), C = 2, 64, 213 and 512, one launch per call.
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np
import torch

from . import constants as C
from .accel.auto import prepare_accel
from .accel.build import with_bvh
from .config import PRESETS, RenderConfig
from .diff import render as dr
from .engine import intersect as isect
from .engine import wavefront
from .ops import intersect_cluster as ic
from .ops import intersect_grid as ig
from .ops import intersect_stream as st
from .ops import traverse_bvh as tb
from .oracle import tracer as oracle
from .scene import builder, model
from .utils.profiling import card_line

N_RAYS = 4096  # seeded random rays of checks [0], [1] and [5]
# Kernel against brute force (scripts/tpu_checks.py:80-90): hit masks and
# materials agree on more than HIT_AGREE / MAT_AGREE of the rays, and the
# 99th percentile of |dt| over rays both hit is below DT_Q99.
HIT_AGREE, MAT_AGREE, DT_Q99 = 0.999, 0.999, 1e-4
# The reference's intersection t bar (tests/unit/test_grid.py).
T_RTOL, T_ATOL = 4e-3, 2e-4
# The reference's engine-vs-oracle image bar (tests/oracle/test_engine.py).
ORACLE_ATOL, ORACLE_RTOL = 5e-4, 1e-3
# The reference's engine bar of a kernel route against another route or
# the oracle (scripts/tpu_checks.py:113-126): a pixel is bad where a
# channel differs by more than ENGINE_BAR + ENGINE_BAR * |reference|, and
# fewer than ENGINE_BAD_PIXELS of the pixels are bad.
ENGINE_BAR, ENGINE_BAD_PIXELS = 5e-3, 0.005
# tests/grad/test_grad.py: the central-difference step and the bar of the
# engine's grads against the oracle's finite differences.
FD_EPS, FD_RTOL = 2e-3, 3e-2
FD_ATOL = {"albedo": 1e-5, "emission": 1e-6}
FURNACE_ATOL = 1e-5
# Launch counters: kernel -> (its wrapper's module, the module's counter).
KERNELS = {"K1": (ic, "LAUNCHES"), "K2": (ig, "LAUNCHES"),
           "K3": (st, "LAUNCHES"), "K4": (tb, "LAUNCHES"),
           "DDA": (ig, "DDA_LAUNCHES"), "CULL": (ic, "CULL_LAUNCHES")}
# [12]'s seeded rays around grids of these axes over [DDA_LO, DDA_LO +
# DDA_EXTENT].
DDA_RAYS, DDA_AXES = 1 << 20, (4, 8, 16)
DDA_LO, DDA_EXTENT = (-0.25, -0.5, 0.125), 1.5
# [13]'s seeded rays, against the first C of cull_boxes' boxes.
CULL_RAYS, CULL_CLUSTERS = 1 << 20, (2, 64, 213, 512)


def furnace_scene(albedo: float) -> model.Scene:
    """tests/oracle/test_furnace.py's scene: one diffuse sphere of the
    given albedo floating in a uniform background of radiance 1."""
    geom = model.make_geometry(
        tri_verts=np.zeros((0, 3, 3), np.float32),
        tri_mat=np.zeros((0,), np.int32),
        sph_c=np.array([[0.0, 0.0, 2.5]], np.float32),
        sph_r=np.array([1.0], np.float32),
        sph_mat=np.array([0], np.int32),
    )
    mats = model.Materials(**model._tensors(dict(
        albedo=np.full((1, 3), albedo, np.float32),
        emission=np.zeros((1, 3), np.float32))))
    return model.Scene(geometry=geom, materials=mats,
                       camera=builder.default_camera(),
                       lights=model.make_lights(geom, mats,
                                                background=(1.0, 1.0, 1.0)))


def random_rays(n: int, device, seed: int = 0):
    """scripts/tpu_checks.py's rays: origins inside the box, uniform
    directions, from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def _launches() -> dict:
    return {name: getattr(m, counter)
            for name, (m, counter) in KERNELS.items()}


def vs_brute(g, hit, o, d) -> tuple:
    """hit(g, o, d) against brute force at scripts/tpu_checks.py's bars;
    returns (ok, line)."""
    t_k, _, m_k = hit(g, o, d)
    t_b, _, m_b = isect.brute(g, o, d)
    hit_k, hit_b = t_k < C.T_FAR * 0.5, t_b < C.T_FAR * 0.5
    hit_same = (hit_k == hit_b).double().mean().item()
    both = hit_k & hit_b
    dt99 = torch.quantile((t_k - t_b)[both].abs().double(), 0.99).item()
    mat_same = (m_k == m_b).double().mean().item()
    return (hit_same > HIT_AGREE and dt99 < DT_Q99 and mat_same > MAT_AGREE,
            f"vs brute: hit agree {hit_same:.4f}, |dt| q99 {dt99:.3g}, mats "
            f"agree {mat_same:.4f} ({int(both.sum())} of {o.shape[0]} rays "
            "hit in both)")


def bad_pixels(img, ref) -> tuple:
    """The share of pixels with a channel off by more than ENGINE_BAR +
    ENGINE_BAR * |ref|, and the max abs difference."""
    diff = (img - ref).abs()
    bad = (diff > ENGINE_BAR + ENGINE_BAR * ref.abs()).any(-1)
    return bad.double().mean().item(), diff.max().item()


def routes_agree(img, ref, what: str) -> tuple:
    frac, dmax = bad_pixels(img, ref)
    return (frac < ENGINE_BAD_PIXELS,
            f"{what}: max abs diff {dmax:.3g}, bad-pixel share {frac:.6f} "
            f"(bar {ENGINE_BAR} + {ENGINE_BAR}|ref|, under "
            f"{ENGINE_BAD_PIXELS})")


def check_k1_vs_brute(ctx) -> tuple:
    return vs_brute(ctx["mesh"].geometry, ic.closest_hit_cluster,
                    *ctx["rays"])


def check_k4_vs_plain(ctx) -> tuple:
    g = ctx["mesh"].geometry
    o, d = ctx["rays"]
    t_k, s_k, v_k, n_k = outs = tb.bvh_hit(g.bvh_nodes, g.bvh_pairs,
                                           g.bvh_tris, o, d)
    mirror = tb.bvh_hit_ordered_plain(g.bvh_pairs, g.bvh_tris, o, d)
    same = all(torch.equal(x, y) for x, y in zip(outs, mirror))
    t_p, s_p, _, _ = tb.bvh_hit_plain(g.bvh_nodes, g.bvh_tris, o, d)
    hit_k, hit_p = s_k >= 0, s_p >= 0
    masks = torch.equal(hit_k, hit_p)
    changed = s_k != s_p
    t_same = torch.equal(t_k[~changed], t_p[~changed])
    t_close = bool(((t_k - t_p).abs()
                    <= T_ATOL + T_RTOL * t_p.abs())[hit_k & hit_p].all())
    eq_t = hit_k & (t_k == t_p)
    mats = torch.equal(g.tri_mat[s_k[eq_t].long()],
                       g.tri_mat[s_p[eq_t].long()])
    dt = (t_k - t_p)[hit_k & hit_p].abs().max().item() if masks else -1.0
    return (same and masks and t_same and t_close and mats,
            f"bit-equal to bvh_hit_ordered_plain (t, triangle, visits, "
            f"tests): {same}; vs the skip-link walk: hit masks equal "
            f"{masks}, {int(changed.sum())} winners changed, t equal where "
            f"the same triangle wins {t_same}, within rtol {T_RTOL} / atol "
            f"{T_ATOL} {t_close} (max abs {dt:.3g}), materials equal where "
            f"t is equal {mats}")


def check_engine_vs_oracle(ctx) -> tuple:
    cfg = PRESETS["config1"]
    scene = builder.build_scene(cfg.scene).to(ctx["device"])
    img = wavefront.render(scene, cfg).cpu().numpy()
    ref = oracle.render(scene, cfg)
    close = np.allclose(img, ref, atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    return (bool(close),
            f"config1 {cfg.width}x{cfg.height} brute force vs the oracle: "
            f"max abs diff {np.abs(img - ref).max():.3g}, allclose atol "
            f"{ORACLE_ATOL} rtol {ORACLE_RTOL}: {close}")


def check_cluster_route(ctx) -> tuple:
    cfg = ctx["cfg2"]
    ctx["img_bvh"] = wavefront.render(ctx["mesh"], cfg)
    img = wavefront.render(ctx["mesh"], cfg.replace(backend="cluster"))
    return routes_agree(img, ctx["img_bvh"], f"config2 {cfg.width}x"
                        f"{cfg.height} cluster route (K1) vs BVH route (K4)")


def check_stream_route(ctx) -> tuple:
    cfg = ctx["cfg2"]
    img = wavefront.render(ctx["mesh"], cfg.replace(backend="stream"))
    return routes_agree(img, ctx["img_bvh"], f"config2 {cfg.width}x"
                        f"{cfg.height} stream route (K3) vs BVH route")


def check_k2_vs_brute(ctx) -> tuple:
    return vs_brute(ctx["grid"].geometry, ig.closest_hit_grid, *ctx["rays"])


def check_grid_route(ctx) -> tuple:
    cfg = ctx["cfg2"]
    img = wavefront.render(ctx["grid"], cfg.replace(backend="grid"))
    return routes_agree(img, ctx["img_bvh"], f"config2 {cfg.width}x"
                        f"{cfg.height} grid route (K2, axis 8) vs BVH route")


def check_compaction(ctx) -> tuple:
    cfg = ctx["cfg2"].replace(width=64, height=64, max_depth=4,
                              backend="cluster")
    plain = wavefront.render(ctx["mesh"], cfg)
    compact = wavefront.render(ctx["mesh"], cfg.replace(compact=True))
    same = torch.equal(plain, compact)
    return (same, f"config2 64x64 depth 4 cluster route: compact=True == "
                  f"compact=False bit for bit: {same}")


def check_sphlight_vs_oracle(ctx) -> tuple:
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=3, rr_start=99,
                       scene="cornell_sphlight", use_bvh=True,
                       backend="cluster")
    scene = prepare_accel(with_bvh(builder.cornell_sphlight()), cfg) \
        .to(ctx["device"])
    ok, parts = True, []
    for mis in (False, True):
        c = cfg.replace(mis=mis)
        img = wavefront.render(scene, c)
        ref = torch.from_numpy(oracle.render(scene, c)).to(img.device)
        good, line = routes_agree(img, ref, f"MIS {'on' if mis else 'off'}")
        ok &= good
        parts.append(line)
    return ok, (f"cornell_sphlight {cfg.width}x{cfg.height} spp {cfg.spp} "
                f"depth {cfg.max_depth} cluster route (K1) vs the oracle: "
                + "; ".join(parts))


def check_grad(ctx) -> tuple:
    scene = ctx["mesh"]
    cfg = PRESETS["bench"].replace(width=32, height=32, max_depth=2)
    with torch.inference_mode():
        fwd = torch.mean(dr.render_image(scene, cfg, scene.materials))
    loss, grads = dr.grad_render(scene, cfg)
    same = torch.equal(loss, fwd)
    finite = bool(torch.isfinite(grads.albedo).all()
                  and torch.isfinite(grads.emission).all())
    ok, parts = same and finite, []
    for field, idx, ch in (("albedo", builder.WHITE, 0),
                           ("albedo", builder.RED, 0),
                           ("albedo", builder.GREEN, 1),
                           ("emission", builder.LIGHT, 0)):
        g = getattr(grads, field)[idx, ch].item()
        means = []
        for sign in (1.0, -1.0):
            arr = getattr(scene.materials, field).clone()
            arr[idx, ch] += sign * FD_EPS
            mats = scene.materials.replace(**{field: arr})
            means.append(oracle.render(scene.replace(materials=mats),
                                       cfg).mean())
        fd = (means[0] - means[1]) / (2 * FD_EPS)
        good = abs(g - fd) <= FD_ATOL[field] + FD_RTOL * abs(fd)
        ok &= good
        parts.append(f"{field}[{idx},{ch}] {g:.6g} vs {fd:.6g} (rel "
                     f"{abs(g - fd) / max(abs(fd), 1e-30):.3g})")
    return ok, (f"bench {cfg.width}x{cfg.height} depth {cfg.max_depth} "
                f"value-and-grad via K1: loss {loss.item()!r} bit-equal to "
                f"the forward frame's: {same}; grads finite: {finite}; vs the "
                f"oracle's central differences (rtol {FD_RTOL}): "
                + ", ".join(parts))


def read_marks(scene, cfg) -> dict:
    """One frame of `scene` (warmed by one unmarked frame) under a CPU
    profiler and, on the card, torch.cuda's sync debug mode "warn":
    {"syncs": the synchronising calls raised inside closest_hit_grid,
    "reads": the pt.read spans inside pt.grid, "elsewhere": the
    synchronising calls elsewhere in the frame, "where": each call's
    source file:line with its count, "named": each read's name with its
    count}."""
    g = scene.geometry
    ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=g.tri_v0.device)
    args = (g, scene.materials, scene.camera, scene.lights, cfg, ids, 0)
    inner, in_grid = ig.closest_hit_grid, []

    def counted(*a, **k):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            try:
                return inner(*a, **k)
            finally:
                in_grid.extend(got)

    on_card = ids.is_cuda
    with torch.inference_mode():
        wavefront.trace_sample(*args)
        if on_card:
            torch.cuda.synchronize()
        ig.closest_hit_grid = counted
        acts = [torch.profiler.ProfilerActivity.CPU]
        # Turning the mode on warns once itself, and the profiler's start
        # and stop may synchronise: neither is recorded.
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.profiler.profile(activities=acts) as prof, \
                    warnings.catch_warnings(record=True) as outside:
                warnings.simplefilter("always")
                wavefront.trace_sample(*args)
        finally:
            ig.closest_hit_grid = inner
            if on_card:
                torch.cuda.set_sync_debug_mode(0)

    def syncs(found):
        return [w for w in found if "synchroniz" in str(w.message)]

    grids = [e.time_range for e in prof.events() if e.name == "pt.grid"]
    reads = [e.name[len("pt.read["):-1] for e in prof.events()
             if e.name.startswith("pt.read[")
             and any(r.start <= e.time_range.start <= r.end
                     for r in grids)]
    where, named = {}, {}
    for w in syncs(in_grid) + syncs(outside):
        key = f"{os.path.basename(w.filename)}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    for r in reads:
        named[r] = named.get(r, 0) + 1
    return {"syncs": len(syncs(in_grid)), "reads": len(reads),
            "elsewhere": len(syncs(outside)), "where": where,
            "named": named}


def config5_scene(ctx):
    """Config 5's 2M-triangle scene on the device, built once for [11]
    and [12]."""
    if "config5" not in ctx:
        cfg = PRESETS["config5"]
        ctx["config5"] = prepare_accel(
            with_bvh(builder.build_scene(cfg.scene)), cfg).to(ctx["device"])
    return ctx["config5"]


def check_reads_marked(ctx) -> tuple:
    cfg = PRESETS["config5"]
    scene = config5_scene(ctx)
    m = read_marks(scene, cfg)
    ok = m["syncs"] == m["reads"] > 0
    return ok, (f"config5 {cfg.width}x{cfg.height} frame: "
                f"{m['syncs']} synchronising calls inside closest_hit_grid, "
                f"{m['reads']} pt.read spans inside pt.grid {m['named']}; "
                f"{m['elsewhere']} synchronising calls elsewhere in the "
                f"frame; by source line {m['where']}")


def grid_queries(scene, cfg) -> list:
    """(o, d, t_max, knobs) of every closest_hit_grid call of one frame of
    `scene`: each bounce's closest-hit and shadow queries, in order."""
    g = scene.geometry
    ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=g.tri_v0.device)
    inner, calls = ig.closest_hit_grid, []

    def record(geom, o, d, t_max=None, **kw):
        calls.append((o.clone(), d.clone(),
                      None if t_max is None else t_max.clone(), kw))
        return inner(geom, o, d, t_max=t_max, **kw)

    ig.closest_hit_grid = record
    try:
        with torch.inference_mode():
            wavefront.trace_sample(g, scene.materials, scene.camera,
                                   scene.lights, cfg, ids, 0)
    finally:
        ig.closest_hit_grid = inner
    return calls


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def dda_rays(n: int, device, seed: int = 0):
    """n seeded rays around the grid of [DDA_LO, DDA_LO + DDA_EXTENT]:
    origins inside, near and far outside it, unit directions with zero
    components, and t_max finite, infinite and dead."""
    gen = torch.Generator().manual_seed(seed)
    lo = torch.tensor(DDA_LO)
    o = lo + (torch.rand((n, 3), generator=gen) * 1.6 - 0.3) * DDA_EXTENT
    o[: n // 8] = lo + torch.tensor([0.5, 0.5, -1.4]) * DDA_EXTENT \
        + torch.randn((n // 8, 3), generator=gen) * 0.01
    o[n // 8: n // 4] *= 50.0
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=1)
    d[:64, 0] = 0.0
    d[64:128, 1:] = 0.0
    d[128:192, 2] = -0.0
    pick = torch.rand(n, generator=gen)
    t_max = torch.where(pick < 0.3, torch.rand(n, generator=gen) * 2.0,
                        torch.full((n,), C.T_FAR))
    t_max[pick > 0.9] = C.T_MIN
    return o.to(device), d.to(device), t_max.to(device)


def dda_grid(axis: int, device, seed: int = 0):
    """A grid of axis^3 cells over [DDA_LO, DDA_LO + DDA_EXTENT] and a
    seeded occupancy bitmask of about a third of its cells: (grid_lo,
    cell, occ_words)."""
    gen = torch.Generator().manual_seed(seed + axis)
    lo = torch.tensor(DDA_LO, device=device)
    cell = torch.full((3,), DDA_EXTENT / axis, device=device)
    counts = (torch.rand(axis ** 3, generator=gen) < 0.35).to(torch.int32)
    start = torch.cat([torch.zeros(1, dtype=torch.int32),
                       torch.cumsum(counts, 0).to(torch.int32)])
    return lo, cell, ig.pack_occupancy(start.to(device))


def dda_mismatches(o, d, t_max, grid_lo, cell, axis: int,
                   occ_words=None) -> dict:
    """dda_window against the windows of the plain full DDA (dda_cells,
    then _step_window, or _window with the bitmask) at every ptr from 0
    to 3*axis, at the era width and width 1, then at ptrs mixed per ray
    (seeded): the windows compared, those not bit-equal, the calls that
    launched other than one kernel, and the cells the windows hold."""
    R = o.shape[0]
    dda = dict(grid_lo=grid_lo, cell=cell, axis=axis, occ_words=occ_words)
    full = ig.dda_cells(o, d, t_max, **dda)
    S, width = 3 * axis, ig.PHASE_STEPS + 1
    cases = [(torch.full((R,), p, dtype=torch.int32, device=o.device), w)
             for p in range(S + 1) for w in (width, 1)]
    gen = torch.Generator().manual_seed(axis)
    cases.append((torch.randint(0, S + 1, (R,), generator=gen,
                                dtype=torch.int32).to(o.device), width))
    out = {"windows": 0, "differ": 0, "launches_off": 0, "cells": 0}
    for ptr, w in cases:
        n0 = ig.DDA_LAUNCHES
        got = ig.dda_window(o, d, t_max, ptr, w, **dda)
        out["launches_off"] += ig.DDA_LAUNCHES != n0 + 1
        want = (ig._step_window(*full, ptr, w) if occ_words is None
                else ig._window(*full, ptr, w))
        out["windows"] += 1
        out["differ"] += not all(
            a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
        out["cells"] += int((got[0] >= 0).sum())
    return out


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def check_dda_kernel(ctx) -> tuple:
    cfg = PRESETS["config5"]
    scene = config5_scene(ctx)
    g = scene.geometry
    axis = ig.grid_axis(g)
    occ = ig.pack_occupancy(g.gr_cell_start)
    queries = grid_queries(scene, cfg)
    real, synthetic = {}, {}
    bad_calls = bad_phases = 0
    rays = []
    with torch.inference_mode():
        for o, d, t_max, kw in queries:
            R = o.shape[0]
            rays.append(R)
            tm = (torch.full((R,), C.T_FAR, device=o.device)
                  if t_max is None else t_max.to(torch.float32))
            for ow in (None, occ):
                _add(real, dda_mismatches(o, d, tm, g.gr_lo, g.gr_cell,
                                          axis, ow))
            *kern, info = ig.closest_hit_grid(g, o, d, t_max=t_max,
                                              stats=True, **kw)
            bad_phases += info["dda_launches"] != info["eras"] + 1
            kernel_window = ig.dda_window
            ig.dda_window = ig.dda_window_plain
            try:
                plain = ig.closest_hit_grid(g, o, d, t_max=t_max, **kw)
            finally:
                ig.dda_window = kernel_window
            bad_calls += not all(torch.equal(a, b)
                                 for a, b in zip(kern, plain))
        o, d, tm = dda_rays(DDA_RAYS, ctx["device"])
        for ax in DDA_AXES:
            lo, cell, ow = dda_grid(ax, ctx["device"])
            for words in (None, ow):
                _add(synthetic, dda_mismatches(o, d, tm, lo, cell, ax,
                                               words))
    ok = (bool(queries) and real["cells"] > 0 and synthetic["cells"] > 0
          and bad_calls == bad_phases == 0
          and all(t["differ"] == t["launches_off"] == 0
                  for t in (real, synthetic)))
    return ok, (f"config5 {cfg.width}x{cfg.height} frame, {len(queries)} "
                f"grid queries of {rays} rays: {real['differ']} of "
                f"{real['windows']} kernel windows differ from the plain "
                f"DDA's, {real['launches_off']} calls not one launch; "
                f"{DDA_RAYS} seeded rays, axes {list(DDA_AXES)}: "
                f"{synthetic['differ']} of {synthetic['windows']} differ, "
                f"{synthetic['launches_off']} not one launch (both modes, "
                f"every ptr, widths {ig.PHASE_STEPS + 1} and 1 and mixed); "
                f"{bad_calls} queries give another t, normal or material "
                f"through the kernel than through the plain DDA; "
                f"{bad_phases} queries launch other than one DDA kernel "
                f"per phase")


def cull_boxes(n_clusters: int, device, seed: int = 0):
    """The first n_clusters of RAY_CULL_MAX_C seeded cluster boxes: corners
    on a 1/64 lattice of the unit cube (so that an origin can lie exactly on
    a face), edges of 1/64 to 19/64; box 1 holds the origin 0 of the
    zero-work point rays. Returns (lo, hi), each (n_clusters, 3) f32."""
    gen = torch.Generator().manual_seed(seed)
    n = ic.RAY_CULL_MAX_C
    lo = torch.floor(torch.rand((n, 3), generator=gen) * 56.0) / 64.0
    hi = lo + torch.ceil(torch.rand((n, 3), generator=gen) * 18.0 + 1.0) \
        / 64.0
    lo[1], hi[1] = -1.0 / 64.0, 3.0 / 64.0
    return lo[:n_clusters].to(device), hi[:n_clusters].to(device)


def cull_rays(n: int, device, seed: int = 0):
    """n seeded rays (n a multiple of RAY_BLOCK) for the per-ray line cull
    against cull_boxes, in 512-ray blocks of four kinds in turn: coherent
    (one origin and a narrow cone of directions a block, as camera rays),
    scattered (as diffuse bounces), sparse (8 live rays among _pad_rays'
    zero-work rays, o = 0, d = +z, t_max = T_MIN, so that the block's mask
    is nearly each ray's own) and short (coherent, t_max below T_MIN, at
    T_MIN or up to 0.05). In every block, among the first 64 rays:
    direction components of 0, -0 and +-1e-21, axis-aligned rays and
    origins exactly on box faces, as given and inflated. t_max is T_FAR
    for half of the other rays. Returns (o, d, t_max) on `device`."""
    L = ic.RAY_BLOCK
    B = n // L
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    def unit(x):
        return torch.nn.functional.normalize(x, dim=-1)

    kind = torch.arange(B) % 4
    o = rand(B, 1, 3) * 1.2 - 0.1 + torch.randn((B, L, 3), generator=gen) \
        * 0.002
    d = unit(unit(torch.randn((B, 1, 3), generator=gen))
             + torch.randn((B, L, 3), generator=gen) * 0.05)
    scattered = kind == 1
    o[scattered] = rand(int(scattered.sum()), L, 3) * 1.2 - 0.1
    d[scattered] = unit(torch.randn((int(scattered.sum()), L, 3),
                                    generator=gen))
    t_max = torch.where(rand(B, L) < 0.5, C.T_FAR, rand(B, L) * 1.5)
    # Edge cases on lanes 0-63 of every block, by lane mod 8.
    lane = torch.arange(64) % 8
    e = d[:, :64]
    e[:, lane == 1, 0] = 0.0
    e[:, lane == 2, 1] = -0.0
    e[:, lane == 3, 2] = 1e-21
    e[:, lane == 4, 0] = -1e-21
    e[:, lane == 4, 1] = 1e-21
    e[:, lane == 5] = torch.tensor([0.0, 0.0, -1.0])
    e[:, lane == 5, 0] = -0.0
    # Origins on faces: a box (low indices likeliest, so that few boxes see
    # them too), a point inside it, then one coordinate on a face.
    face = (lane == 6) | (lane == 7)
    k = int(face.sum()) * B
    lo, hi = cull_boxes(ic.RAY_CULL_MAX_C, "cpu", seed)
    lo_i, hi_i = ic._inflate(lo, hi)
    box = torch.clamp((ic.RAY_CULL_MAX_C ** rand(k)).long() - 1, 0,
                      ic.RAY_CULL_MAX_C - 1)
    p = lo[box] + (hi[box] - lo[box]) * rand(k, 3)
    axis = torch.randint(0, 3, (k,), generator=gen)
    pick = torch.randint(0, 4, (k,), generator=gen)
    planes = torch.stack([lo, hi, lo_i, hi_i])[pick, box, axis]
    p[torch.arange(k), axis] = planes
    o[:, :64][:, face] = p.view(B, -1, 3)
    # Sparse blocks: lanes 8-511 are zero-work point rays.
    sparse = kind == 2
    o[sparse, 8:] = 0.0
    d[sparse, 8:] = torch.tensor([0.0, 0.0, 1.0])
    t_max[sparse, 8:] = C.T_MIN
    # Short blocks: t_max of 0, half T_MIN, T_MIN and up to 0.05.
    short = kind == 3
    levels = torch.tensor([0.0, 0.5 * C.T_MIN, C.T_MIN, 0.05])
    t_max[short] = levels[torch.randint(0, 4, (int(short.sum()), L),
                                        generator=gen)] \
        * torch.where(torch.arange(L) % 4 == 3, rand(L), 1.0)
    return (o.reshape(n, 3).to(device), d.reshape(n, 3).to(device),
            t_max.reshape(n).to(torch.float32).to(device))


def cull_mismatches(o, d, t_max, lo, hi) -> dict:
    """ray_cluster_mask against ray_cluster_mask_plain on the same inputs:
    the blocks whose mask differs, the launches the call made, and the
    clusters kept of all (block, cluster) pairs."""
    n0 = ic.CULL_LAUNCHES
    got = ic.ray_cluster_mask(lo, hi, o, d, t_max)
    launches = ic.CULL_LAUNCHES - n0
    want = ic.ray_cluster_mask_plain(lo, hi, o, d, t_max)
    same = got.dtype == want.dtype and got.shape == want.shape
    return {"differ": int((got != want).any(dim=1).sum()) if same
            else want.shape[0], "launches": launches,
            "kept": int(want.sum()), "pairs": want.numel()}


def check_cull_kernel(ctx) -> tuple:
    o, d, t_max = cull_rays(CULL_RAYS, ctx["device"])
    ok, parts = True, []
    for n in CULL_CLUSTERS:
        got = cull_mismatches(o, d, t_max, *cull_boxes(n, ctx["device"]))
        ok &= (got["differ"] == 0 and got["launches"] == 1
               and 0 < got["kept"] < got["pairs"])
        parts.append(f"C={n}: {got['differ']} blocks differ, "
                     f"{got['launches']} launches, "
                     f"{got['kept'] / got['pairs']:.4f} of pairs kept")
    return ok, (f"ray_cluster_mask kernel vs plain on {CULL_RAYS} seeded "
                f"rays: " + "; ".join(parts))


def check_furnace(ctx) -> tuple:
    cfg = RenderConfig(width=32, height=32, spp=1, max_depth=2, rr_start=8,
                       scene="furnace", use_bvh=False)
    ok, parts = True, []
    for albedo in (1.0, 0.5):
        scene = furnace_scene(albedo).to(ctx["device"])
        img = wavefront.render(scene, cfg).cpu().numpy().reshape(-1, 3)
        ref = oracle.render(scene, cfg).reshape(-1, 3)
        is_bg = np.all(np.abs(img - 1.0) < FURNACE_ATOL, axis=-1)
        is_srf = np.all(np.abs(img - albedo) < FURNACE_ATOL, axis=-1)
        err = float(np.abs(img - ref).max())
        good = bool(np.all(is_bg | is_srf) and is_bg.any() and is_srf.any()
                    and err <= FURNACE_ATOL)
        ok &= good
        parts.append(f"albedo {albedo}: {int(is_srf.sum())} sphere and "
                     f"{int(is_bg.sum())} background pixels of "
                     f"{len(img)}, max abs diff vs the oracle {err:.3g}")
    return ok, (f"furnace {cfg.width}x{cfg.height} depth {cfg.max_depth}: "
                + "; ".join(parts) + f" (bar {FURNACE_ATOL})")


# (label, function, the kernels it must launch, --full only)
CHECKS = (
    ("0", check_k1_vs_brute, {"K1", "CULL"}, False),
    ("1", check_k4_vs_plain, {"K4"}, False),
    ("2", check_engine_vs_oracle, set(), False),
    ("3", check_cluster_route, {"K1", "K4", "CULL"}, True),
    ("4", check_stream_route, {"K3"}, True),
    ("5", check_k2_vs_brute, {"K2", "DDA"}, True),
    ("6", check_grid_route, {"K2", "DDA"}, True),
    ("7", check_compaction, {"K1", "CULL"}, True),
    ("8", check_sphlight_vs_oracle, {"K1"}, True),
    ("9", check_grad, {"K1", "CULL"}, True),
    ("10", check_furnace, set(), True),
    ("11", check_reads_marked, {"K2", "DDA"}, True),
    ("12", check_dda_kernel, {"K2", "DDA"}, True),
    ("13", check_cull_kernel, {"CULL"}, True),
)


def context(device) -> dict:
    """The scenes and rays the checks share: cornell_mesh with its BVH and
    cluster tables, the same on a grid at axis 8, config 2 at 128² and
    the random rays."""
    cfg2 = PRESETS["config2"].replace(width=128, height=128)
    base = with_bvh(builder.cornell_mesh())
    return {
        "device": device,
        "cfg2": cfg2,
        "mesh": prepare_accel(base, cfg2.replace(backend="cluster"))
        .to(device),
        "grid": prepare_accel(base, cfg2.replace(backend="grid"),
                              grid_axis=8).to(device),
        "rays": random_rays(N_RAYS, device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.checks",
        description="The kernels and the engine against brute force, the "
                    "BVH walk and the oracle, on the card.")
    ap.add_argument("--full", action="store_true",
                    help="also checks [3]-[13]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("checks run on the card: no CUDA device")
    device = torch.device("cuda")
    print(f"[checks] {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {time.strftime('%Y-%m-%d %H:%M')}")
    ctx = context(device)
    ok = True
    for label, fn, kernels, full in CHECKS:
        if full and not args.full:
            continue
        before = _launches()
        t0 = time.perf_counter()
        passed, line = fn(ctx)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in _launches().items()
                    if n != before[k]}
        own = set(launched) == kernels
        passed = bool(passed and own)
        ok &= passed
        print(f"[{label}] {line}; launches {launched or 'none'}"
              f"{'' if own else f' (expected {sorted(kernels)})'}; "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{'PASS' if passed else 'FAIL'}", flush=True)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
