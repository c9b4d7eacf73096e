"""Card checks of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the seven CUDA sources (the cluster, pair, stream and BVH-walk
kernels, the grid's DDA window kernel, the sampler's threefry kernel and
the three visit-arithmetic probes) and the native BVH builder from the
repository's sources, all at once, then checks the port on the card. It
measures no frame rate: the port's benchmark is ``python3 ptbench/run.py
--workload <cell>``.

Holds each kernel against its plain PyTorch version at its main path's
shapes, both timed with CUDA events beside the kernel's bound
(``roofline.py``): the probes at the probe script's shapes and at full
width on the bench table, beside a library call; the cluster, pair and
stream kernels, whose visit is the split product on the tensor cores, also
against the f32 product at the reference's bar, the cluster kernel on
bounce 0's and bounce 1's queries and on each of the bench frame's 8
calls; the BVH walk, K4, against both of its plain versions, bit for bit
against its mirror and at the reference's bar against the skip-link walk,
on config 3's bounce-0 queries and config 5's bounce-0 and bounce-1 ones,
and on cornell_mesh's BVH built with leaves of up to 4, 6 and 7 triangles,
against brute force, with the bench frame through it; the sampler kernel
bit for bit on every call of a bench frame; the DDA window kernel bit for
bit on every DDA call of a config-5 frame. Runs the probe entry point and
renders the golden scenes through the cluster, grid, BVH and stream routes
against ``tests/golden``.

Then renders every route at full size, each frame checked to launch its
route's kernel and no other: the ``bench`` preset (cornell_mesh, K1; its
image also against the BVH walk's) and the same scene through K4;
``config2`` and ``config3`` (K4); ``config5`` (big_mesh, 2M triangles, its
native BVH and the stream route's cluster table checked by
check_invariants and check_cluster_invariants; the grid route, K2 and the
DDA window kernel) and the same scene through K4 and through the stream
route (K3, within its time limit), the grid's and the stream's frames also
against the same-seed frame through K4, and the grid profile of the bench
band's three passes on the config-5 scene with its profiler split of K2
against its glue (``grid_profile.py --trace``). Then a value-and-grad step
of the full bench frame through K1 and through K4 (the loss bit-equal to
the forward frame's); material gradients against central differences; the
check suite (``checks.py --full``: K1-K4 against brute force, the BVH walk
and each other, the engine against the port's oracle on config 1,
cornell_sphlight with and without MIS and the furnace, and a
value-and-grad step against the oracle's finite differences); the sharded
path (``parallel/mesh.py``) in child processes: over two gloo ranks that
share the card, the full bench frame (K1) and the full config-5 frame
(K2), each bit-equal to the single-process frame, the bench frame's
sharded loss and grads against ``pt.grad_render`` and two train steps with
the materials bit-identical on both ranks; over one NCCL rank that
``torchrun`` starts and that joins through ``initialize_distributed``, the
bench frame and a train step; and the front end in this process through
``cli.main``: config 3 with a checkpoint resumed (equal to ``pt.render``),
the bench frame to a PNG (K1 only) and five fit steps on the bench frame
(a falling loss). Every phase either passes or raises; the last line of
standard output is ``{"ok": true, "device": {...}}`` only when all passed,
after the ``kernels`` line. There is no CPU path: without a CUDA device
the script fails at once.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import struct
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch import checks, cli
from pathtracer_tpu_torch import constants as C
from pathtracer_tpu_torch import grid_profile, roofline
from pathtracer_tpu_torch.accel import native
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import check_invariants, with_bvh
from pathtracer_tpu_torch.accel.clusters import (
    ClusterSet,
    check_cluster_invariants,
)
from pathtracer_tpu_torch.accel.traverse import hit_from_index, mt_test
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import intersect as isect
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.diff import render as dr
from pathtracer_tpu_torch.engine.camera import camera_rays, tiled_pixel_ids
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.ops import intersect_grid as ig
from pathtracer_tpu_torch.ops import intersect_stream as st
from pathtracer_tpu_torch.ops import traverse_bvh as tb
from pathtracer_tpu_torch.ops import visit_probe as vp
from pathtracer_tpu_torch.parallel import mesh as pmesh
from pathtracer_tpu_torch.parallel.mesh import spawn_ranks
# The bars the checks share: the reference's intersection t bar, material
# agreement, and its engine bar of one route against another (a pixel is
# bad where a channel differs by more than ENGINE_BAR + ENGINE_BAR * |ref|,
# and fewer than ENGINE_BAD_PIXELS of the pixels are bad).
from pathtracer_tpu_torch.checks import (
    ENGINE_BAD_PIXELS,
    ENGINE_BAR,
    MAT_AGREE,
    T_ATOL,
    T_RTOL,
    bad_pixels,
)
# The bound arithmetic: the card's peaks, the operations per test and the
# bytes of a call.
from pathtracer_tpu_torch.roofline import (
    OPS_PER_MT_TEST,
    OPS_PER_NODE,
    PEAK_BF16,
    PEAK_BYTES,
    PEAK_F32,
    PEAK_INT32_ISSUE,
    add_bound,
    add_split_bound,
    k1_bytes,
    k4_bytes,
    nbytes,
    new_bound,
    reference_work_ms,
    sampler_work,
    split_bytes,
    tri_tests,
    warp_tests,
)
from pathtracer_tpu_torch.sampling import rng as rng_mod
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.utils.profiling import card_line

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces, its wrapper's module,
    # the module's launch counter)
    "cluster_hit": ("pathtracer_tpu_torch/ops/csrc/intersect_cluster.cu",
                    "pathtracer_tpu/ops/intersect_cluster.py:211", ic,
                    "LAUNCHES"),
    "pair_hit": ("pathtracer_tpu_torch/ops/csrc/intersect_pair.cu",
                 "pathtracer_tpu/ops/intersect_grid.py:279", ig, "LAUNCHES"),
    "stream_hit": ("pathtracer_tpu_torch/ops/csrc/intersect_stream.cu",
                   "pathtracer_tpu/ops/intersect_stream.py:76", st,
                   "LAUNCHES"),
    "bvh_hit": ("pathtracer_tpu_torch/ops/csrc/traverse_bvh.cu",
                "pathtracer_tpu/ops/traverse_pallas.py:92", tb, "LAUNCHES"),
    "grid_dda": ("pathtracer_tpu_torch/ops/csrc/grid_dda.cu",
                 "none: jnp glue in the reference", ig, "DDA_LAUNCHES"),
    "sampler": ("pathtracer_tpu_torch/ops/csrc/threefry.cu",
                "none: jax.random threefry in the reference", rng_mod,
                "SAMPLER_LAUNCHES"),
    "probe_f32": ("pathtracer_tpu_torch/ops/csrc/visit_probe.cu",
                  "scripts/_probe_compile.py:19", vp, "F32_LAUNCHES"),
    "probe_split_in": ("pathtracer_tpu_torch/ops/csrc/visit_probe.cu",
                       "scripts/_probe_compile.py:30", vp,
                       "SPLIT_IN_LAUNCHES"),
    "probe_split_pre": ("pathtracer_tpu_torch/ops/csrc/visit_probe.cu",
                        "scripts/_probe_compile.py:45", vp,
                        "SPLIT_PRE_LAUNCHES"),
}
GRID = ("pair_hit", "grid_dda")  # the kernels of the grid route
# Launched by every frame whatever the route: check_only does not count them
# as another route's kernels.
EVERY_FRAME = ("sampler",)
SOURCES = ("intersect_cluster", "intersect_pair", "intersect_stream",
           "traverse_bvh", "visit_probe", "grid_dda", "threefry")
CHECK_PIXELS = 256 * 1024  # rays per query in the kernel-vs-plain phases
BVH_CHECK_PIXELS_C5 = 64 * 1024  # K4 vs plain on the config-5 scene
# K1-K3 (the split product on the tensor cores) against their plain
# versions on the split table: only the summation order inside an mma
# k-step differs, so hit masks agree on all but 1e-5 of rays and t within
# the probe's K6-vs-plain bar where both hit.
SPLIT_HIT_AGREE, SPLIT_T_ATOL = 0.99999, 2e-6
# ... and against the f32 product (visit_plain on the f32 table) at the
# reference's bar (TPU_CHECKS.md: hit agreement 1.0000, materials
# 0.9998): what the engine reads of each result (engine_reads) agrees on
# F32_HIT_AGREE of a closest-hit query's entries and on all but
# SHADOW_FLIPS of a shadow query's; where both hit, materials agree on
# MAT_AGREE; and the split's error explains (split_explains) every flip the
# engine reads and every t outside T_RTOL / T_ATOL of the f32 t. The split
# must show: max |dt| over both-hit rays of the closest-hit query at least
# SPLIT_T_FLOOR (a kernel that kept the f32 product fails here).
F32_HIT_AGREE = 0.9999
# A shadow ray that reaches its light hits the light at t = t_max up to
# rounding, and the engine reads it as lit from t_max * (1 -
# SHADOW_REL_EPS) on; near the lights the split's t error reaches
# SHADOW_REL_EPS (hits at 0.998-0.999 t_max that the f32 product puts
# beyond the threshold), so about 3e-4 of a shadow query's entries flip,
# each within the split's error. Held to this share, under twice that.
SHADOW_FLIPS = 5e-4
SPLIT_T_FLOOR = 1e-6
# The split's error per product term: x*y against hi_x*hi_y + lo_x*hi_y +
# hi_x*lo_y, with hi = bf16(x) (|x - hi| <= 2^-8 |x|) and lo = bf16(x - hi)
# (|x - hi - lo| <= 2^-16 |x|), is at most 3 * 2^-16 |x*y|; with the f32
# sums' rounding, within 2^-14 |x*y|.
SPLIT_TERM_ERR = 2.0 ** -14
GRID_BAR = 2e-3  # the reference's grid-vs-jnp render bar: |d| <= a + a|ref|
GRID_BAD_PIXELS = 0.002  # ... on all but this share of pixels
STREAM_FRAME_LIMIT_S = 120.0  # the stream frame runs at 1024^2 within this
STREAM_PROBE_SIDE = 512  # ... judged by a frame of this side first
PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-6  # K5 vs its plain version
# K6/K7 vs their plain versions: above the f32 summation-order differences
# (7.2e-7 seen on values of 0.5-2) and below the split's own error (7.2e-6),
# so a kernel that skipped the split would fail here.
SPLIT_PLAIN_RTOL, SPLIT_PLAIN_ATOL = 0.0, 2e-6
SPLIT_RTOL, SPLIT_ATOL = 1e-4, 1e-5  # K6/K7 vs the f32 result: the split
SPLIT_FLOOR = 1e-6  # ... which must show: full-width max |K6/K7 - K5|
PROBE_PAD_ROWS = vp.FEAT_ROWS  # bench rays: 11 feature rows padded to 16
FD_EPS = 2e-3  # tests/grad/test_grad.py's central-difference step
FD_SIDE = 256  # the bench frame's side for the FD cases
FRONT_DIR = os.path.join(ROOT, "build", "front_end")  # the CLI's files
FIT_STEPS = 5
RESUME_ATOL = 1e-6  # resumed and pt.render images against the CLI's
DIST_TIMEOUT_S = 300.0  # each group of ranks in [dist]: start, builds, frames
# [dist] (b): one rank started by torchrun, as a multi-host run starts each.
DIST_TORCHRUN_CMD = [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node", "1", "--no-python",
                     sys.executable, "-c",
                     "import chip_smoke; chip_smoke.dist_nccl_rank()"]
# The reference's sharded-vs-single bars (tests/dist/test_sharding.py).
DIST_LOSS_RTOL, DIST_GRAD_RTOL, DIST_GRAD_ATOL = 1e-5, 1e-4, 1e-7
# [max_leaf]: K4 on cornell_mesh's BVH built with leaves of up to m
# triangles, on the bench frame's bounce-0 rays and this many random rays
# inside the box, against brute force taken this many rays at a time.
LEAF_SIZES = (4, 6, 7)
LEAF_RANDOM_RAYS = 65_536
BRUTE_CHUNK = 8192
GRID_PROFILE_REPS = 3  # [grid_profile]: best of this many timed calls


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def reset_launches() -> None:
    for _, _, module, counter in KERNELS.values():
        setattr(module, counter, 0)


def launches() -> dict:
    return {name: getattr(module, counter)
            for name, (_, _, module, counter) in KERNELS.items()}


def check_only(what: str, counts: dict, kernel) -> None:
    """The path launched `kernel` (a name, or a tuple of names: each of
    them) and no other kernel but those of EVERY_FRAME."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    for name in names:
        check(counts[name] > 0, f"{what} never launched {name}")
    others = {k: n for k, n in counts.items()
              if k not in names and k not in EVERY_FRAME and n}
    check(not others, f"{what} launched {others}")


def bench_scene(cfg: RenderConfig, device):
    scene = builder.build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    return prepare_accel(scene, cfg).to(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build() -> None:
    """nvcc for each kernel source and g++ for the native BVH builder, all
    started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        jobs = [pool.submit(_build.load, name) for name in SOURCES]
        jobs.append(pool.submit(native.load))
        for job in jobs:
            job.result()
    print(f"[build] all sources: {time.perf_counter() - t0:.2f} s wall")
    for name in SOURCES:
        rec = _build.BUILDS[name]
        print(f"[build] {name}.cu: nvcc {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] ptxas: {line.strip()}")
    print(f"[build] native/bvh_builder.cpp: g++ "
          f"{native.BUILD['seconds']:.2f} s")


def trace_bounce0(scene, cfg, pixel_ids) -> None:
    wavefront.trace_sample(scene.geometry, scene.materials, scene.camera,
                           scene.lights, cfg.replace(max_depth=1), pixel_ids,
                           0)


def record_main_path_queries(scene, cfg, pixel_ids):
    """The arguments the main path hands to cluster_hit, (cand, count,
    tnear, rayf, split table, box_lo, box_hi) per call, over `cfg`'s
    bounces: per bounce its closest-hit query, then its NEE shadow query."""
    calls = []
    real = ic.cluster_hit

    def recording(*args):
        calls.append(args)
        return real(*args)

    ic.cluster_hit = recording
    try:
        wavefront.trace_sample(scene.geometry, scene.materials, scene.camera,
                               scene.lights, cfg, pixel_ids, 0)
    finally:
        ic.cluster_hit = real
    return calls


def compare_hits(name, t_k, s_k, t_p, s_p, mats) -> float:
    """Kernel vs plain results: equal hit masks, t within the bar, materials
    (mats[slot]) agreeing; returns the max abs t error over hits."""
    hit_k, hit_p = s_k >= 0, s_p >= 0
    check(torch.equal(hit_k, hit_p), f"{name}: hit masks differ in "
          f"{int((hit_k != hit_p).sum())} entries")
    torch.testing.assert_close(t_k[hit_k], t_p[hit_p], rtol=T_RTOL,
                               atol=T_ATOL)
    if not hit_k.any():
        return 0.0
    agree = (mats[s_k[hit_k].long()] == mats[s_p[hit_p].long()]).float() \
        .mean().item()
    check(agree >= MAT_AGREE, f"{name}: material agreement {agree}")
    return (t_k[hit_k] - t_p[hit_p]).abs().max().item()


def compare_split(name, t_k, s_k, t_p, s_p, bound) -> tuple:
    """A split kernel (K1-K3) against its plain version on the split
    table: hit masks agree on at least SPLIT_HIT_AGREE of the entries and
    t within SPLIT_T_ATOL (rtol 0) where both hit. A flip whose hit lies
    within SPLIT_T_ATOL of the entry's t bound `bound` does not count: a
    hit at t >= t_max may read as a miss, and a shadow ray that reaches its
    light hits it at t = t_max up to rounding. Returns (mask flips, flips
    at the bound, max |dt| over both-hit entries)."""
    flip = (s_k >= 0) != (s_p >= 0)
    t_hit = torch.where(s_k >= 0, t_k, t_p)
    at_bound = int((flip & ((bound - t_hit).abs() <= SPLIT_T_ATOL)).sum())
    flips = int(flip.sum()) - at_bound
    check(1.0 - flips / max(flip.numel(), 1) >= SPLIT_HIT_AGREE,
          f"{name}: {flips} of {flip.numel()} hit masks differ from the "
          "split plain version's")
    both = (s_k >= 0) & (s_p >= 0)
    dt = (t_k - t_p)[both].abs().max().item() if both.any() else 0.0
    check(dt <= SPLIT_T_ATOL, f"{name}: max |t - split plain t| {dt:.3g} "
          f"above {SPLIT_T_ATOL}")
    return flips, at_bound, dt


def engine_reads(t, s, bound, shadow: bool) -> torch.Tensor:
    """What the engine reads of a query's result: for a closest-hit query
    its hit mask; for a shadow query whether the light is occluded, a hit
    nearer than bound * (1 - SHADOW_REL_EPS) (engine/wavefront.py)."""
    hit = s >= 0
    return hit & (t < bound * (1.0 - C.SHADOW_REL_EPS)) if shadow else hit


def split_explains(feat, rays, t_a, s_a, t_b, s_b) -> tuple:
    """Whether the split's error explains why two products' results (t_a,
    s_a) and (t_b, s_b) differ. Takes the triangle of the nearer hit and
    its four quantities (det, u*det, v*det, t*det) in float64 from the f32
    table `feat` and the entries' ray features `rays` (11, n), each with
    its error bound (SPLIT_TERM_ERR times the sum of its terms' |.|).
    Explained (a, b): (a) one of the visit's predicates (det > DET_EPS,
    u >= 0, v >= 0, u + v <= det, t > T_MIN, in the sign-canonical form)
    lies within its bound of 0, so the other product may drop the triangle
    (a ray through a shared edge misses both triangles and reaches a
    surface behind, or nothing); or (b) the other t (a hit's, or the
    entry's bound on a miss) lies within twice that triangle's t error
    bound. Returns the (n,) bool masks (a, b)."""
    a_nearer = (s_a >= 0) & ((t_a <= t_b) | (s_b < 0))
    slot = torch.where(a_nearer, s_a, s_b).long()
    cid, row = slot // ic.CLUSTER_TRIS, slot % ic.CLUSTER_TRIS
    quantity = torch.arange(4, device=slot.device)[:, None]
    cols = cid * ic.CLUSTER_COLS + quantity * ic.CLUSTER_TRIS + row  # (4, n)
    used = ic._FEAT_USED
    terms = feat[:used, cols].double() * rays[:used, None, :].double()
    sign = torch.where(terms[:, 0].sum(0) < 0, -1.0, 1.0)
    adet, un, vn, tn = terms.sum(0) * sign
    e_d, e_u, e_v, e_t = terms.abs().sum(0) * SPLIT_TERM_ERR
    margin = torch.stack([
        adet / e_d, (adet - C.DET_EPS) / e_d, un / e_u, vn / e_v,
        (adet - un - vn) / (e_d + e_u + e_v),
        (tn - adet * C.T_MIN) / (e_t + C.T_MIN * e_d),
    ]).abs().min(0).values
    t_err = (tn / adet).abs() * (e_t / tn.abs() + e_d / adet.abs())
    at_predicate = margin <= 1.0
    within_t = ~at_predicate & ((t_a - t_b).abs().double() <= 2.0 * t_err)
    return at_predicate, within_t


def compare_f32(name, t_k, s_k, t_f, s_f, mats, bound, shadow, feat,
                rays) -> tuple:
    """A split kernel (K1-K3) against the f32 product (the f32 visit on
    the f32 table `feat`) at the reference's bar: what the engine reads
    (engine_reads; `bound` the entries' t bounds) agrees on at least
    F32_HIT_AGREE of the entries (a `shadow` query's on all but
    SHADOW_FLIPS); where both hit, materials (mats[slot])
    agree on at least MAT_AGREE; and every flip the engine reads and every
    both-hit t outside T_RTOL / T_ATOL of the f32 t is explained by the
    split's error (split_explains; `rays` the entries' ray features).
    Returns (flips the engine reads, hit-mask flips, t outside the bar,
    explained at a predicate, explained within t's error, max |dt| over
    both-hit entries)."""
    read_k = engine_reads(t_k, s_k, bound, shadow)
    read_f = engine_reads(t_f, s_f, bound, shadow)
    flip = read_k != read_f
    flips = int(flip.sum())
    share = SHADOW_FLIPS if shadow else 1.0 - F32_HIT_AGREE
    if shadow and flips:
        near = torch.where(read_k, t_k, t_f)[flip] / bound[flip]
        print(f"[kernel] {name} query: {flips} shadow flips, the occluding "
              f"hit at {near.min().item():.5f}-{near.max().item():.5f} of "
              f"t_max, on the split side in {int(read_k[flip].sum())}")
    check(flips <= share * flip.numel(), f"{name}: the engine reads {flips} "
          f"of {flip.numel()} results otherwise than the f32 product's, "
          f"above {share}")
    both = (s_k >= 0) & (s_f >= 0)
    dt = (t_k - t_f).abs()
    far = both & (dt > T_ATOL + T_RTOL * t_f.abs())
    odd = torch.nonzero(flip | far).flatten()
    at_predicate, within_t = split_explains(
        feat, rays[:, odd], t_k[odd], s_k[odd], t_f[odd], s_f[odd])
    unexplained = odd[~(at_predicate | within_t)]
    check(unexplained.numel() == 0, f"{name}: {unexplained.numel()} entries "
          f"(flips the engine reads, or t outside rtol {T_RTOL} / atol "
          f"{T_ATOL}) differ from the f32 product's beyond the split's "
          f"error (entries {unexplained[:8].tolist()})")
    if both.any():
        agree = (mats[s_k[both].long()] == mats[s_f[both].long()]).float() \
            .mean().item()
        check(agree >= MAT_AGREE, f"{name}: material agreement {agree} with "
              "the f32 product")
    return (flips, int(((s_k >= 0) != (s_f >= 0)).sum()), int(far.sum()),
            int(at_predicate.sum()), int(within_t.sum()),
            dt[both].max().item() if both.any() else 0.0)


def f32_line(counts) -> str:
    """compare_f32's counts, summed over calls, as printed."""
    flips, mask_flips, far, at_predicate, within_t, dt = counts
    return (f"{flips} flips the engine reads ({mask_flips} hit-mask flips), "
            f"t outside its bar on {far} entries, all explained by the "
            f"split's error ({at_predicate} with a predicate within it, "
            f"{within_t} within t's), t max abs diff {dt:.3g}")


def new_totals() -> dict:
    """A kernel's totals for the kernels line: its times, error and bound."""
    return {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
            "library_ms": None, **new_bound()}


def add_totals(out, ms, plain_ms, err) -> None:
    out["ms"] += ms
    out["plain_ms"] += plain_ms
    out["max_abs_err"] = max(out["max_abs_err"], err)


def query_label(i) -> str:
    return f"bounce {i // 2} {('closest', 'shadow')[i % 2]}"


def phase_kernel_vs_plain(scene, cfg, device) -> dict:
    """K1 against its plain version on the split table (bar a) and against
    the f32 walk (bar b, and the split floor on the closest-hit queries) on
    bounce 0's and bounce 1's closest-hit and shadow queries of the first
    CHECK_PIXELS tile-ordered pixels, timed beside the plain version and
    its bound (the warps' work in the tensor-core form; the reference's
    work, every block visit, printed beside it). Returns bounce 0's two
    calls' totals, the kernels line's entry; bounce 1's are printed."""
    g = scene.geometry
    mats = g.cl_slot_nm[:, 3]
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                          device=device)[:CHECK_PIXELS]
    before = ic.LAUNCHES
    queries = record_main_path_queries(scene, cfg.replace(max_depth=2), ids)
    check(len(queries) == 4, f"bounces 0 and 1 made {len(queries)} cluster "
          "queries, expected 4 (closest hit + shadow each)")
    check(ic.LAUNCHES == before + 4, "main-path queries launched the kernel")
    per_bounce = [new_totals(), new_totals()]
    ref_work = [0.0, 0.0]  # bound on the reference's work, per bounce
    for i, args in enumerate(queries):
        label, shadow = query_label(i), i % 2 == 1
        cand, count, _, rayf = args[:4]
        n0 = ic.LAUNCHES
        outs = ic.cluster_hit(*args)
        torch.cuda.synchronize()
        check(ic.LAUNCHES == n0 + 1, "cluster_hit launched the kernel")
        t_k, s_k, v_k, w_k = outs
        t_p, s_p, v_p, _ = ic.cluster_hit_plain(*args)
        bound = rayf[ic.RAY_FEATS - 1]
        flips_a, edge_a, err = compare_split(label, t_k, s_k, t_p, s_p, bound)
        check(bool((v_k <= v_p).all() and (w_k <= 8 * v_k).all()),
              f"{label}: visits above the plain walk's")
        t_f, s_f = bound.clone(), torch.full_like(s_k, -1)
        ic.walk_candidates_plain(cand, count, rayf,
                                 ic.cluster_major(g.cl_feat), ic.visit_plain,
                                 t_f, s_f)
        b = compare_f32(label, t_k, s_k, t_f, s_f, mats, bound, shadow,
                        g.cl_feat, rayf)
        if not shadow:
            check(b[-1] >= SPLIT_T_FLOOR, f"{label}: max |t - f32 t| "
                  f"{b[-1]:.3g} below {SPLIT_T_FLOOR}: the product was not "
                  "split")
        n_bytes = k1_bytes(args, outs)
        totals = per_bounce[i // 2]
        bound_ms, f32_bound = add_split_bound(totals, n_bytes, warp_tests(w_k))
        ref_ms = reference_work_ms(n_bytes, v_k)
        ref_work[i // 2] += ref_ms
        ms = cuda_ms(lambda: ic.cluster_hit(*args), 20)
        plain_ms = cuda_ms(lambda: ic.cluster_hit_plain(*args),
                           3 if i < 2 else 1)
        print(f"[kernel] cluster_hit {label} query: {rayf.shape[1]} rays "
              f"({int((bound > C.T_MIN).sum())} live) in {cand.shape[0]} "
              f"blocks, {int((s_k >= 0).sum())} hits, visits/block kernel "
              f"{v_k.float().mean().item():.3f} plain "
              f"{v_p.float().mean().item():.3f}, warp visits/block "
              f"{w_k.float().mean().item():.3f} (without the skip "
              f"{8 * v_k.float().mean().item():.3f}); vs split plain: "
              f"{flips_a} mask flips (+{edge_a} at the t bound), t max abs "
              f"err {err:.3g}; vs f32 walk: {f32_line(b)}; kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"(tensor-core form on the warps' work, {n_bytes / 1e6:.1f} "
              f"MB; on the reference's work {ref_ms:.4f} ms; f32 form "
              f"{f32_bound:.4f} ms)")
        add_totals(totals, ms, plain_ms, err)
    for bounce, totals in enumerate(per_bounce):
        print(f"[kernel] cluster_hit bounce {bounce} checked calls: kernel "
              f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, "
              f"bound {totals['bound_ms']:.4f} ms (tensor-core form on the "
              f"warps' work; on the reference's work "
              f"{ref_work[bounce]:.4f} ms)")
    return per_bounce[0]


def phase_k1_frame(scene, device, card: str) -> None:
    """Each of the 8 cluster_hit calls of one full bench frame, timed with
    CUDA events beside its bound, with its block visits and warp visits
    per block, and their sum: K1's milliseconds per frame."""
    cfg = pt.PRESETS["bench"]
    calls = record_main_path_queries(
        scene, cfg, tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                                    device=device))
    check(len(calls) == 2 * cfg.max_depth, f"the bench frame made "
          f"{len(calls)} cluster queries, expected {2 * cfg.max_depth}")
    total, total_bound, total_ref = 0.0, 0.0, 0.0
    for i, args in enumerate(calls):
        outs = ic.cluster_hit(*args)
        v_k, w_k = outs[2].float(), outs[3].float()
        n_bytes = k1_bytes(args, outs)
        bound_ms, _ = add_split_bound(new_totals(), n_bytes,
                                      warp_tests(outs[3]))
        ref_ms = reference_work_ms(n_bytes, outs[2])
        ms = cuda_ms(lambda: ic.cluster_hit(*args), 10)
        total, total_bound, total_ref = (total + ms, total_bound + bound_ms,
                                         total_ref + ref_ms)
        live = int((args[3][ic.RAY_FEATS - 1] > C.T_MIN).sum())
        print(f"[main] bench K1 call {i} ({query_label(i)}): "
              f"{args[3].shape[1]} rays ({live} live), kernel {ms:.4f} ms, "
              f"visits/block {v_k.mean().item():.3f}, warp visits/block "
              f"{w_k.mean().item():.3f} (without the skip "
              f"{8 * v_k.mean().item():.3f}), bound {bound_ms:.4f} ms "
              f"(tensor-core form on the warps' work; on the reference's "
              f"work {ref_ms:.4f} ms)")
    print(f"[main] bench K1 per frame: {total:.4f} ms over {len(calls)} "
          f"calls (CUDA events), bound {total_bound:.4f} ms (on the "
          f"reference's work {total_ref:.4f} ms), on {card}")


def record_bvh_queries(scene, cfg, pixel_ids):
    """The (o, d) the BVH route hands to bvh_hit over `cfg`'s bounces: per
    bounce its closest-hit query, then its NEE shadow query."""
    calls = []
    real = tb.bvh_hit

    def recording(nodes, pairs, tris, o, d, max_leaf=None):
        calls.append((o, d))
        return real(nodes, pairs, tris, o, d, max_leaf)

    tb.bvh_hit = recording
    try:
        wavefront.trace_sample(scene.geometry, scene.materials, scene.camera,
                               scene.lights, cfg, pixel_ids, 0)
    finally:
        tb.bvh_hit = real
    return calls


def phase_bvh_vs_plain(label, scene, cfg, n_pixels, device, out,
                       depth: int = 1) -> None:
    """K4 on the queries of `cfg` (a BVH route) over the first n_pixels
    tile-ordered pixels, bounces 0 to depth - 1, against both plain
    versions: bit for bit (t, triangle, per-block visits and triangle
    tests) against its mirror bvh_hit_ordered_plain, and at the
    reference's bar against the skip-link walk bvh_hit_plain (equal hit
    masks, t bit-equal where the same triangle wins, within T_RTOL / T_ATOL
    and materials equal where t is equal). Timed beside the plain walk and
    the bound on the distinct entries and triangles the walks read; bounce
    0's calls add to `out` (the kernels line), later ones are printed."""
    g = scene.geometry
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                          device=device)[:n_pixels]
    queries = record_bvh_queries(scene, cfg.replace(max_depth=depth), ids)
    check(len(queries) == 2 * depth, f"{label}: bounces 0-{depth - 1} made "
          f"{len(queries)} BVH queries, expected {2 * depth} (closest hit + "
          "shadow each)")
    tables = (g.bvh_nodes, g.bvh_pairs, g.bvh_tris)
    whole_ms = 0.0
    for i, (o, d) in enumerate(queries):
        name = f"{label} {query_label(i)}"
        R = o.shape[0]
        n0 = tb.LAUNCHES
        outs = tb.bvh_hit(*tables, o, d)
        torch.cuda.synchronize()
        check(tb.LAUNCHES == n0 + 1, "bvh_hit launched the kernel")
        t_k, s_k, v_k, n_k = outs
        seen = (torch.zeros(g.bvh_pairs.shape[0], dtype=torch.bool,
                            device=device),
                torch.zeros(g.bvh_tris.shape[0], dtype=torch.bool,
                            device=device))
        t0 = time.perf_counter()
        mirror = tb.bvh_hit_ordered_plain(g.bvh_pairs, g.bvh_tris, o, d,
                                          chunk=R, seen=seen)
        torch.cuda.synchronize()
        mirror_ms = (time.perf_counter() - t0) * 1e3
        for what, x, y in zip(("t", "triangle", "visits", "tests"), outs,
                              mirror):
            check(torch.equal(x, y), f"{name}: {what} differs from "
                  "bvh_hit_ordered_plain's")
        t0 = time.perf_counter()
        t_p, s_p, v_p, n_p = tb.bvh_hit_plain(g.bvh_nodes, g.bvh_tris, o, d,
                                              chunk=R)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = compare_hits(name, t_k, s_k, t_p, s_p, g.tri_mat)
        changed = s_k != s_p
        check(torch.equal(t_k[~changed], t_p[~changed]),
              f"{name}: t differs from the skip-link walk's where the same "
              "triangle wins")
        same_t = (s_k >= 0) & (t_k == t_p)
        check(torch.equal(g.tri_mat[s_k[same_t].long()],
                          g.tri_mat[s_p[same_t].long()]),
              f"{name}: materials differ where t is equal")
        n_bytes = k4_bytes(g, seen, o, d, *outs)
        n_ops = (2 * int(v_k.to(torch.int64).sum()) * OPS_PER_NODE
                 + int(n_k.to(torch.int64).sum()) * OPS_PER_MT_TEST)
        totals = out if i < 2 and out is not None else new_totals()
        bound = add_bound(totals, n_bytes, n_ops)
        whole_ms += nbytes(g.bvh_nodes, g.bvh_tris, o, d, t_k, s_k, v_k) \
            / PEAK_BYTES * 1e3
        ms = cuda_ms(lambda: tb.bvh_hit(*tables, o, d), 20)
        print(f"[kernel] bvh_hit {name} query: {R} rays, "
              f"{g.bvh_pairs.shape[0]} pair entries, {int((s_k >= 0).sum())} "
              f"hits; per ray: pair fetches {v_k.sum().item() / R:.3f} (box "
              f"tests {2 * v_k.sum().item() / R:.3f}), skip-link node visits "
              f"{v_p.sum().item() / R:.3f}; triangle tests "
              f"{n_k.sum().item() / R:.3f}, skip-link "
              f"{n_p.sum().item() / R:.3f}; t, triangle, visits and tests "
              f"bit-equal to bvh_hit_ordered_plain; vs the skip-link walk: "
              f"hit masks equal, {int(changed.sum())} winners changed, t max "
              f"abs err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms (mirror {mirror_ms:.4f} ms), bound {bound:.4f} ms "
              f"({int(seen[0].sum())} entries and {int(seen[1].sum())} "
              f"triangles read, {n_bytes / 1e6:.2f} MB; {n_ops:.4g} f32 "
              f"operations)")
        if totals is out:
            add_totals(out, ms, plain_ms, err)
    print(f"[kernel] bvh_hit {label}: counting both whole tables (nodes and "
          f"triangles) as read by every call, the bound would be "
          f"{whole_ms:.4f} ms over these {len(queries)} calls")


def random_box_rays(n, seed, device):
    """tests/unit/test_bvh.py:_random_rays: origins inside the Cornell box,
    directions uniform on the sphere, from a numpy seed."""
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def walk_rounding_brute(g, o, d):
    """Closest triangle hit of each ray over every triangle, in the walks'
    own rounding (accel/traverse.py:mt_test: each product and sum rounded
    on its own, as K4 rounds), with no BVH: (t, tri), T_FAR and -1 on a
    miss; ties keep the lower index. For a few rays at a time."""
    n_tris = g.tri_v0.shape[0]
    idx = torch.arange(n_tris, device=o.device)
    ts, tris = [], []
    for r in range(o.shape[0]):
        t, ok = mt_test(g.tri_v0, g.tri_e1, g.tri_e2, idx,
                        o[r].expand(n_tris, 3), d[r].expand(n_tris, 3))
        v, i = torch.where(ok, t, C.T_FAR).min(0)
        ts.append(v)
        tris.append(torch.where(v < C.T_FAR, i, -1))
    return torch.stack(ts), torch.stack(tris)


def rays_off_brute(g, o, d, hit, tri) -> dict:
    """A walk's hits (t, n, mat) and triangles against brute force
    (engine/intersect.py:brute), BRUTE_CHUNK rays at a time.

    A ray is off where its t or normal is outside T_RTOL / T_ATOL of brute
    force's or its material differs, unless it is
      - an equal-t tie: t within the bar, and the walk's triangle hit in
        brute force's arithmetic at a t within the bar of brute force's
        best (two triangles of a shared edge); or
      - a rounding edge: the walk's t is bit for bit the closest hit over
        every triangle in the walks' own rounding (walk_rounding_brute;
        an equal t may name another triangle), so only brute force's
        rounding differs
        (its cross products may contract to FMAs on the card).
    A triangle the walk leaves untested gives a farther t or a miss in
    both yardsticks: off. Returns the counts (off, ties, ties with t
    bit-equal to brute force's, rounding edges), the largest |dt| of a
    tie, and up to 4 lines describing the rays that are not ties."""
    t, n, mat = hit
    out = {"off": 0, "ties": 0, "exact": 0, "rounding": 0, "tie_dt": 0.0,
           "rays": []}
    for s in range(0, o.shape[0], BRUTE_CHUNK):
        sl = slice(s, s + BRUTE_CHUNK)
        t_b, n_b, m_b = isect.brute(g, o[sl], d[sl])
        close = torch.isclose(t[sl], t_b, rtol=T_RTOL, atol=T_ATOL)
        bad = ~(close & (mat[sl] == m_b) & torch.isclose(
            n[sl], n_b, rtol=T_RTOL, atol=T_ATOL).all(1))
        if not bool(bad.any()):
            continue
        idx = bad.nonzero()[:, 0]
        o_x, d_x = o[sl][idx], d[sl][idx]
        t_x, k, t_bx = t[sl][idx], tri[sl][idx].long(), t_b[idx]
        tt = isect.intersect_tris_brute(o_x, d_x, g.tri_v0, g.tri_e1,
                                        g.tri_e2)
        t_at_k = tt.gather(1, k.clamp(min=0)[:, None])[:, 0]
        tie = close[idx] & (k >= 0) & torch.isclose(
            t_at_k, t_bx, rtol=T_RTOL, atol=T_ATOL)
        out["ties"] += int(tie.sum())
        out["exact"] += int((tie & (t_x == t_bx)).sum())
        if bool(tie.any()):
            out["tie_dt"] = max(out["tie_dt"],
                                (t_x - t_bx)[tie].abs().max().item())
        rest = (~tie).nonzero()[:, 0]
        t_w, k_w = walk_rounding_brute(g, o_x[rest], d_x[rest])
        same = t_w == t_x[rest]
        out["rounding"] += int(same.sum())
        out["off"] += int((~same).sum())
        for j, r in enumerate(rest.tolist()):
            if len(out["rays"]) < 4:
                out["rays"].append(
                    f"ray {s + int(idx[r])}: o {o_x[r].tolist()} d "
                    f"{d_x[r].tolist()}; walk t {t_x[r].item():.9g} "
                    f"triangle {int(k[r])}; brute force t "
                    f"{t_bx[r].item():.9g} triangle "
                    f"{int(tt[r].argmin())}, its t at the walk's triangle "
                    f"{t_at_k[r].item():.9g}; walks' rounding over every "
                    f"triangle t {t_w[j].item():.9g} triangle "
                    f"{int(k_w[j])}: "
                    f"{'rounding edge' if bool(same[j]) else 'OFF'}")
    return out


def phase_max_leaf(device, card: str) -> None:
    """[max_leaf]: every triangle of a leaf is tested. K4 on cornell_mesh's
    BVH built with leaves of up to m triangles (with_bvh(max_leaf=m,
    engine="numpy"), m in LEAF_SIZES), on the bench frame's bounce-0
    closest-hit rays (recorded from the m = 4 scene) and LEAF_RANDOM_RAYS
    random rays inside the box: no ray off brute force at any m, equal-t
    ties printed. K4's mirror shares the walk's leaf bound, so brute force
    is the yardstick. Then the bench frame via K4 on the m = 6 BVH against
    the same-seed frame on the m = 4 one, which is the default BVH
    (with_bvh's numpy build below 100k triangles), at the engine bar."""
    t_start = time.perf_counter()
    cfg = pt.PRESETS["bench"].replace(backend="jnp")
    base = builder.build_scene(cfg.scene)
    scenes = {m: with_bvh(base, max_leaf=m, engine="numpy").to(device)
              for m in LEAF_SIZES}
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    o_cam, d_cam = record_bvh_queries(scenes[4], cfg.replace(max_depth=1),
                                      ids)[0]
    o_rnd, d_rnd = random_box_rays(LEAF_RANDOM_RAYS, 11, device)
    o = torch.cat([o_cam, o_rnd]).contiguous()
    d = torch.cat([d_cam, d_rnd]).contiguous()
    ms = {}
    for m, scene in scenes.items():
        g = scene.geometry
        tables = (g.bvh_nodes, g.bvh_pairs, g.bvh_tris)
        n0 = tb.LAUNCHES
        t, tri, _, tests = tb.bvh_hit(*tables, o, d)
        torch.cuda.synchronize()
        check(tb.LAUNCHES == n0 + 1, "bvh_hit launched the kernel")
        res = rays_off_brute(g, o, d, hit_from_index(g, o, d, t, tri), tri)
        ms[m] = cuda_ms(lambda: tb.bvh_hit(*tables, o, d), 10)
        print(f"[max_leaf] m={m}: largest leaf {int(g.bvh_count.max())}, "
              f"{g.bvh_lo.shape[0]} nodes; K4 on {o.shape[0]} rays "
              f"({o_cam.shape[0]} bench bounce-0 + {o_rnd.shape[0]} random): "
              f"{int((tri >= 0).sum())} hits, triangle tests per ray "
              f"{tests.sum().item() / o.shape[0]:.3f}; vs brute force: "
              f"{res['off']} rays off, {res['ties']} equal-t ties "
              f"({res['exact']} with t bit-equal to brute force's, max |dt| "
              f"{res['tie_dt']:.3g}), {res['rounding']} rounding edges "
              f"(K4 bit-equal to every triangle tested in the walks' "
              f"rounding); K4 {ms[m]:.4f} ms on {card}")
        for line in res["rays"]:
            print(f"[max_leaf] m={m} {line}")
        check(res["off"] == 0, f"max_leaf={m}: {res['off']} rays off brute "
              "force")
    imgs = {}
    for m in (4, 6):
        reset_launches()
        imgs[m] = pt.render(scenes[m], cfg)
        torch.cuda.synchronize()
        check_only(f"bench via K4, max_leaf={m}", launches(), "bvh_hit")
        check_image(f"bench via K4, max_leaf={m}", imgs[m], cfg)
    frac, dmax = bad_pixels(imgs[6], imgs[4])
    print(f"[max_leaf] render(bench) via K4 on the max_leaf=6 BVH vs the "
          f"default (max_leaf=4) BVH, same seed: max abs diff {dmax:.3g}, "
          f"bad-pixel share {frac:.6f} (bar {ENGINE_BAR} + {ENGINE_BAR}|ref|,"
          f" under {ENGINE_BAD_PIXELS}); K4 {ms[6]:.4f} ms at m=6 vs "
          f"{ms[4]:.4f} ms at m=4 on the checked rays, on {card}")
    check(frac < ENGINE_BAD_PIXELS, f"max_leaf=6 frame: bad-pixel share "
          f"{frac}")
    print(f"[max_leaf] phase: {time.perf_counter() - t_start:.1f} s")


def record_pair_queries(scene, cfg, pixel_ids):
    """The pair-kernel inputs of stage A (the first pair phase) of the main
    path's bounce-0 closest-hit and NEE shadow queries: (offsets, cand,
    pair_ray, rayf, pair_block), rayf as it was at the call."""
    calls, firsts = [], []
    real_hit, real_grid = ig.pair_hit, ig.closest_hit_grid

    def recording_grid(*args, **kw):
        firsts.append(len(calls))
        return real_grid(*args, **kw)

    def recording_hit(offsets, cand, pair_ray, rayf, feat, pair_block):
        calls.append((offsets, cand, pair_ray, rayf.clone(), pair_block))
        return real_hit(offsets, cand, pair_ray, rayf, feat, pair_block)

    ig.pair_hit, ig.closest_hit_grid = recording_hit, recording_grid
    try:
        trace_bounce0(scene, cfg, pixel_ids)
    finally:
        ig.pair_hit, ig.closest_hit_grid = real_hit, real_grid
    return [calls[i] for i in firsts]


def phase_pair_vs_plain(scene, cfg, device) -> dict:
    """K2 against its plain version on the split table (bar a) and against
    the f32 product (bar b, and the split floor on the closest-hit query)
    on stage A of the bounce-0 closest-hit and shadow queries."""
    g = scene.geometry
    mats = g.cl_slot_nm[:, 3]
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                          device=device)[:CHECK_PIXELS]
    queries = record_pair_queries(scene, cfg, ids)
    check(len(queries) == 2, f"bounce 0 made {len(queries)} grid queries, "
          "expected 2 (closest hit + shadow)")
    out = new_totals()
    for name, (offsets, cand, pair_ray, rayf, pb) in zip(
            ("closest", "shadow"), queries):
        args = (offsets, cand, pair_ray, rayf, g.cl_feat_split, pb)
        n0 = ig.LAUNCHES
        t_k, s_k, v_k = ig.pair_hit(*args)
        torch.cuda.synchronize()
        check(ig.LAUNCHES == n0 + 1, "pair_hit launched the kernel")
        t_p, s_p, v_p = ig.pair_hit_plain(*args)
        rays = rayf[:, pair_ray.long()]
        bound = rays[ic.RAY_FEATS - 1]
        flips_a, edge_a, err = compare_split(name, t_k, s_k, t_p, s_p, bound)
        check(torch.equal(v_k, v_p), f"{name}: visits per block differ")
        t_f, s_f, _ = ig.pair_walk_plain(offsets, cand, pair_ray, rayf,
                                         ic.cluster_major(g.cl_feat),
                                         ic.visit_plain, pb)
        b = compare_f32(name, t_k, s_k, t_f, s_f, mats, bound,
                        name == "shadow", g.cl_feat, rays)
        if name == "closest":
            check(b[-1] >= SPLIT_T_FLOOR, f"{name}: max |t - f32 t| "
                  f"{b[-1]:.3g} below {SPLIT_T_FLOOR}: the product was not "
                  "split")
        P = pair_ray.shape[0]
        per_block = (P - pb * torch.arange(v_k.shape[0], device=device)
                     ).clamp(max=pb)
        n_bytes = nbytes(*args[:4], t_k, s_k, v_k) + split_bytes(
            g.cl_feat_split, cand[:int(offsets[-1])])
        bound, f32_bound = add_split_bound(out, n_bytes,
                                           tri_tests(v_k, per_block))
        ms = cuda_ms(lambda: ig.pair_hit(*args), 10)
        plain_ms = cuda_ms(lambda: ig.pair_hit_plain(*args), 1)
        print(f"[kernel] pair_hit {name} query, stage A: "
              f"{rayf.shape[1]} rays, {pair_ray.shape[0]} pairs in "
              f"{v_k.shape[0]} blocks of {pb}, {int((s_k >= 0).sum())} "
              f"hits, visits/block mean {v_k.float().mean().item():.2f} "
              f"max {int(v_k.max())}; vs split plain: {flips_a} mask flips "
              f"(+{edge_a} at the t bound), t max abs err {err:.3g}; vs f32 "
              f"product: {f32_line(b)}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms (tensor-core form, "
              f"{n_bytes / 1e6:.1f} MB; f32 form {f32_bound:.4f} ms)")
        add_totals(out, ms, plain_ms, err)
    return out


def record_stream_rounds(scene, cfg, pixel_ids, keep_inputs: bool):
    """One trace_sample(with_stats=True); returns its useful rays and, per
    closest_hit_stream call, the visits and warp visits of each round and,
    with keep_inputs, its stream_hit arguments (cand, count, tnear, rayf,
    t_in, slot_in, split table, box_lo, box_hi)."""
    queries = []
    real_hit, real_stream = st.stream_hit, st.closest_hit_stream

    def recording_stream(*args, **kw):
        queries.append({"rays": args[1].shape[0], "visits": [],
                        "warp_visits": [], "inputs": []})
        return real_stream(*args, **kw)

    def recording_hit(*args):
        out = real_hit(*args)
        queries[-1]["visits"].append(int(out[2].sum()))
        queries[-1]["warp_visits"].append(int(out[3].sum()))
        if keep_inputs:
            queries[-1]["inputs"].append(args)
        return out

    st.stream_hit, st.closest_hit_stream = recording_hit, recording_stream
    try:
        _, n_rays = wavefront.trace_sample(
            scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
            pixel_ids, 0, with_stats=True)
    finally:
        st.stream_hit, st.closest_hit_stream = real_hit, real_stream
    return int(n_rays), queries


def phase_stream_vs_plain(scene, cfg, device) -> dict:
    """K3 against its plain version on the split table (bar a) and against
    the f32 product (bar b, and the split floor on the closest-hit query)
    on every round of the stream route's bounce-0 closest-hit and shadow
    queries."""
    g = scene.geometry
    mats = g.cl_slot_nm[:, 3]
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                          device=device)[:CHECK_PIXELS]
    _, queries = record_stream_rounds(scene, cfg.replace(max_depth=1), ids,
                                      keep_inputs=True)
    check(len(queries) == 2, f"bounce 0 made {len(queries)} stream "
          "queries, expected 2 (closest hit + shadow)")
    out = new_totals()
    for name, q in zip(("closest", "shadow"), queries):
        check(len(q["inputs"]) > 0, f"stream {name} query ran no round")
        ms = plain_ms = err = bound = f32_bound = ref_bound = 0.0
        flips_a = [0, 0]  # vs split plain: mask flips, flips at the bound
        b = [0, 0, 0, 0, 0, 0.0]  # vs f32: compare_f32's counts
        visits, warp_visits, mb = [], [], 0.0
        for args in q["inputs"]:
            n0 = st.LAUNCHES
            t_k, s_k, v_k, w_k = st.stream_hit(*args)
            torch.cuda.synchronize()
            check(st.LAUNCHES == n0 + 1, "stream_hit launched the kernel")
            t0 = time.perf_counter()
            t_p, s_p, _, _ = st.stream_hit_plain(*args)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            cand, count, _, rayf, t_in, slot_in = args[:6]
            t_max = rayf[ic.RAY_FEATS - 1]
            *f, e = compare_split(name, t_k, s_k, t_p, s_p, t_max)
            t_f, s_f = t_in.clone(), slot_in.clone()
            ic.walk_candidates_plain(cand, count, rayf,
                                     ic.cluster_major(g.cl_feat),
                                     ic.visit_plain, t_f, s_f)
            *f32, dt = compare_f32(name, t_k, s_k, t_f, s_f, mats, t_max,
                                   name == "shadow", g.cl_feat, rayf)
            flips_a = [x + y for x, y in zip(flips_a, f)]
            b = [x + y for x, y in zip(b, f32)] + [max(b[-1], dt)]
            err = max(err, e)
            walked = torch.arange(cand.shape[1], device=device)[None, :] \
                < v_k[:, None]
            n_bytes = nbytes(*args[:6], *args[7:], t_k, s_k, v_k, w_k) \
                + split_bytes(g.cl_feat_split, cand[walked])
            r_bound, r_f32 = add_split_bound(out, n_bytes, warp_tests(w_k))
            bound, f32_bound = bound + r_bound, f32_bound + r_f32
            ref_bound += reference_work_ms(n_bytes, v_k)
            mb += n_bytes / 1e6
            ms += cuda_ms(lambda: st.stream_hit(*args), 5)
            visits.append(int(v_k.sum()))
            warp_visits.append(int(w_k.sum()))
        if name == "closest":
            check(b[-1] >= SPLIT_T_FLOOR, f"stream {name}: max |t - f32 t| "
                  f"{b[-1]:.3g} below {SPLIT_T_FLOOR}: the product was not "
                  "split")
        B = q["inputs"][0][0].shape[0]
        print(f"[kernel] stream_hit {name} query: {q['rays']} rays in {B} "
              f"blocks, {len(q['inputs'])} rounds, visits per round "
              f"{visits} (mean per block {sum(visits) / B:.2f}), warp visits "
              f"per round {warp_visits} (mean per block "
              f"{sum(warp_visits) / B:.2f}); vs split "
              f"plain: {flips_a[0]} mask flips (+{flips_a[1]} at the t "
              f"bound), t max abs err {err:.3g}; vs f32 product: "
              f"{f32_line(b)}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms (tensor-core form on the warps' work, "
              f"{mb:.1f} MB; on the reference's work {ref_bound:.4f} ms; "
              f"f32 form {f32_bound:.4f} ms; all rounds)")
        add_totals(out, ms, plain_ms, err)
    return out


def check_golden(name, img, rtol, atol) -> float:
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    check(np.isfinite(img).all(), f"{name}: finite image")
    bad_px = (~np.isclose(img, golden, rtol=rtol, atol=atol)).any(-1).mean()
    print(f"[golden] {name}: max abs diff {np.abs(img - golden).max():.3g}, "
          f"pixels outside rtol={rtol} atol={atol}: {bad_px:.3g}")
    return bad_px


def phase_goldens(device) -> None:
    """The golden scenes through the cluster route (the reference's
    cluster-vs-jnp and engine-vs-oracle bars), through the grid route at
    axis 8 (the reference's grid-vs-jnp bar), through the BVH walk that
    rendered them (the reference's engine bar, every pixel) and through the
    stream route (the cluster bar)."""
    mesh = builder.procedural_bunny(2)
    c3 = RenderConfig(width=32, height=32, spp=4, max_depth=4, rr_start=2,
                      scene="cornell_mesh", use_bvh=True, backend="cluster",
                      compact=True)
    c2 = RenderConfig(width=48, height=48, spp=2, max_depth=1,
                      scene="cornell_mesh", use_bvh=True, backend="grid")
    cases = [
        # (name, scene, cfg, rtol, atol, share of pixels allowed outside)
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh), c3, 2e-3, 2e-3,
         1e-4),
        ("config1_64", builder.cornell_spheres(),
         RenderConfig(width=64, height=64, spp=4, max_depth=1,
                      scene="cornell_spheres", use_bvh=False), 1e-3, 5e-4,
         1e-4),
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh),
         c3.replace(backend="grid", compact=False), GRID_BAR, GRID_BAR,
         GRID_BAD_PIXELS),
        ("config2_48", builder.cornell_mesh(mesh_tris=mesh), c2, GRID_BAR,
         GRID_BAR, GRID_BAD_PIXELS),
        ("config2_48", builder.cornell_mesh(mesh_tris=mesh),
         c2.replace(backend="jnp"), 1e-3, 5e-4, 0.0),
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh),
         c3.replace(backend="jnp", compact=False), 2e-3, 2e-3, 0.0),
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh),
         c3.replace(backend="stream"), 2e-3, 2e-3, 1e-4),
    ]
    for name, scene, cfg, rtol, atol, allowed in cases:
        if cfg.use_bvh:
            scene = with_bvh(scene)
        scene = prepare_accel(scene, cfg, grid_axis=8).to(device)
        reset_launches()
        img = pt.render(scene, cfg).cpu().numpy()
        print(f"[golden] {name} backend={cfg.backend}: launches "
              f"{launches()}")
        bad_px = check_golden(name, img, rtol, atol)
        check(bad_px <= allowed, f"{name}: {bad_px} of pixels outside the "
              "bar")


def check_image(name, img, cfg) -> float:
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"{name}: image shape")
    check(bool(torch.isfinite(img).all()), f"{name}: finite image")
    check(bool((img >= 0).all()), f"{name}: non-negative image")
    mean = img.mean().item()
    check(mean > 0.0, f"{name}: image mean above 0")
    return mean


def frame_args(scene, cfg, device):
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    return (scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
            ids, 0)


def phase_main_path(scene, device) -> int:
    cfg = pt.PRESETS["bench"]
    reset_launches()
    img = pt.render(scene, cfg)
    torch.cuda.synchronize()
    counts = launches()
    mean = check_image("bench", img, cfg)
    check_only("bench", counts, "cluster_hit")
    check(counts["cluster_hit"] == 2 * cfg.max_depth,
          f"{counts['cluster_hit']} kernel launches, expected "
          f"{2 * cfg.max_depth}")
    check(counts["sampler"] == 1 + cfg.max_depth,
          f"{counts['sampler']} sampler launches, expected "
          f"{1 + cfg.max_depth}")
    print(f"[main] render(bench) {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth}: mean {mean:.6f}, launches {counts}")
    # The same seed through the BVH walk (K4, the f32 product): the split
    # product's effect on the main path's image.
    check_against_k4("bench via K1", scene, cfg, img)

    route_frame("bench", frame_args(scene, cfg, device), "cluster_hit")
    return counts["cluster_hit"]


def record_sampler_calls(args):
    """The sampler's _per_pixel calls of one trace_sample(*args): per call
    its key, ids (cloned) and draws per id, in order."""
    calls = []
    real = rng_mod._per_pixel

    def recording(key, pixel_ids, n):
        calls.append((key, pixel_ids.clone(), n))
        return real(key, pixel_ids, n)

    rng_mod._per_pixel = recording
    try:
        wavefront.trace_sample(*args)
    finally:
        rng_mod._per_pixel = real
    return calls


def phase_sampler_vs_plain(bench, device) -> tuple[int, dict]:
    """The sampler kernel against its plain version (_per_pixel_plain) on
    every sampler call of one full bench frame (1,048,576 ids; the jitter's
    2 draws per id, then each bounce's 7): bit for bit, one launch per
    call; each call timed beside the plain version and its bound, the
    larger of its int32 operations at PEAK_INT32_ISSUE and its bytes
    (roofline.sampler_work). Returns the kernel's launches in the frame and
    the totals."""
    cfg = pt.PRESETS["bench"]
    reset_launches()
    calls = record_sampler_calls(frame_args(bench, cfg, device))
    frame_launches = launches()["sampler"]
    check(frame_launches == len(calls) == 1 + cfg.max_depth,
          f"a bench frame made {len(calls)} sampler calls and "
          f"{frame_launches} launches, expected {1 + cfg.max_depth}")
    check(all(ids.shape[0] == cfg.n_pixels for _, ids, _ in calls),
          "a bench-frame sampler call not over every pixel id")
    out = new_totals()
    per_call = []
    for key, ids, n in calls:
        n0 = rng_mod.SAMPLER_LAUNCHES
        got = rng_mod._per_pixel(key, ids, n)
        torch.cuda.synchronize()
        check(rng_mod.SAMPLER_LAUNCHES == n0 + 1,
              "_per_pixel launched the kernel once")
        want = rng_mod._per_pixel_plain(key, ids, n)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"sampler on {ids.shape[0]} ids, {n} draws: the kernel's "
              "draws differ from the plain version's")
        n_bytes, n_ops = sampler_work(ids.shape[0], n)
        bound = add_bound(out, n_bytes, n_ops, PEAK_INT32_ISSUE)
        ms = cuda_ms(lambda: rng_mod._per_pixel(key, ids, n), 20)
        plain_ms = cuda_ms(lambda: rng_mod._per_pixel_plain(key, ids, n),
                           2)
        add_totals(out, ms, plain_ms, 0.0)
        per_call.append(f"n={n} {ms:.4f} (bound {bound:.4f})")
    print(f"[kernel] sampler bench frame: {len(calls)} calls of "
          f"{cfg.n_pixels} ids, every draw bit-equal to the plain "
          f"version's; per call ms {per_call}; kernel {out['ms']:.4f} ms, "
          f"plain {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"(int32 operations {out['ops_ms']:.4f}, bytes "
          f"{out['bytes_ms']:.4f}) per frame; {frame_launches} launches in "
          f"one bench frame")
    return frame_launches, out


def check_against_k4(name, scene, cfg, img) -> None:
    """img, rendered with cfg, against the same-seed frame through the BVH
    walk (K4, the f32 product) at the reference's engine bar: a pixel is
    bad where a channel differs by more than ENGINE_BAR + ENGINE_BAR * |K4|,
    and fewer than ENGINE_BAD_PIXELS of the pixels are bad."""
    reset_launches()
    bvh = pt.render(scene, cfg.replace(backend="jnp"))
    torch.cuda.synchronize()
    counts = launches()
    check_only(f"{name}: the frame via K4", counts, "bvh_hit")
    diff = (img - bvh).abs()
    bad = (diff > ENGINE_BAR + ENGINE_BAR * bvh.abs()).any(-1).float() \
        .mean().item()
    print(f"[main] render({name}) vs via K4 ({cfg.width}x{cfg.height}, "
          f"{counts['bvh_hit']} K4 launches): max abs diff "
          f"{diff.max().item():.3g}, bad-pixel share {bad:.6f} (bar "
          f"{ENGINE_BAR} + {ENGINE_BAR}|K4|, under {ENGINE_BAD_PIXELS})")
    check(bad < ENGINE_BAD_PIXELS, f"{name} vs via K4: bad-pixel share "
          f"{bad}")


def route_frame(name, args, kernel) -> None:
    """One trace_sample(*args, with_stats=True): it launches `kernel` (a
    name, or a tuple of names) and no other route's kernel."""
    reset_launches()
    _, n = wavefront.trace_sample(*args, with_stats=True)
    n = int(n)
    torch.cuda.synchronize()
    counts = launches()
    check_only(name, counts, kernel)
    print(f"[main] trace_sample({name}, tiled, with_stats): {n} useful "
          f"rays, launches {counts}")


def phase_bvh_presets(device) -> int:
    """config2 and config3 as they stand, through the BVH walk (K4 only);
    returns config3's K4 launches."""
    for name in ("config2", "config3"):
        cfg = pt.PRESETS[name]
        t0 = time.perf_counter()
        scene = bench_scene(cfg, device)
        build_s = time.perf_counter() - t0
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pt.render(scene, cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches()
        mean = check_image(name, img, cfg)
        check_only(name, counts, "bvh_hit")
        print(f"[main] render({name}) {cfg.width}x{cfg.height} spp "
              f"{cfg.spp} (chunks of {cfg.spp_chunk or cfg.spp}) depth "
              f"{cfg.max_depth} backend={cfg.backend}: mean {mean:.6f}, "
              f"launches {counts}, {seconds:.3f} s (host build "
              f"{build_s:.2f} s)")
    return counts["bvh_hit"]


def config5_host_scene(cfg):
    """big_mesh -> with_bvh on the host, timed, and its BVH checked
    (check_config5_bvh)."""
    t0 = time.perf_counter()
    mesh = builder.build_scene(cfg.scene)
    t1 = time.perf_counter()
    scene = with_bvh(mesh)
    t2 = time.perf_counter()
    g = scene.geometry
    print(f"[main] big_mesh: {g.tri_v0.shape[0]} triangles, "
          f"{g.bvh_lo.shape[0]} BVH nodes, {g.bvh_pairs.shape[0]} pair "
          f"entries, depth {int(g.bvh_pairs[0, 7].view(torch.int32))}; host "
          f"build s: big_mesh {t1 - t0:.2f}, native BVH and its tables "
          f"{t2 - t1:.2f}")
    check_config5_bvh(mesh, scene)
    return scene


def check_config5_bvh(mesh, scene) -> None:
    """check_invariants on config 5's native BVH. The scene keeps only the
    reordered triangles, so the tree is built again on the mesh
    (build_bvh_native, timed), held equal to the scene's arrays (its
    `order` gives the scene's triangles), then checked, timed."""
    g = mesh.geometry
    tris = [np.asarray(x) for x in (g.tri_v0, g.tri_e1, g.tri_e2)]
    t0 = time.perf_counter()
    bvh = native.build_bvh_native(*tris)
    t1 = time.perf_counter()
    s = scene.geometry
    for name in ("lo", "hi", "first", "count", "skip"):
        check(np.array_equal(getattr(bvh, name),
                             np.asarray(getattr(s, f"bvh_{name}"))),
              f"config5: the rebuilt BVH's {name} differs from the scene's")
    check(np.array_equal(tris[0][bvh.order], np.asarray(s.tri_v0)),
          "config5: the rebuilt order does not give the scene's triangles")
    t2 = time.perf_counter()
    check_invariants(bvh, len(tris[0]))
    t3 = time.perf_counter()
    print(f"[main] config5 check_invariants on the native BVH "
          f"({len(bvh.lo)} nodes, {len(tris[0])} triangles, largest leaf "
          f"{int(bvh.count.max())}): passed in {t3 - t2:.2f} s (the tree "
          f"built again in {t1 - t0:.2f} s, equal to the scene's)")


def config5_scene(host, cfg, device):
    """prepare_accel -> the card, timed."""
    t = [time.perf_counter()]
    scene = prepare_accel(host, cfg)
    t.append(time.perf_counter())
    scene = scene.to(device)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    g = scene.geometry
    cs = g.gr_cell_start
    n_clusters = int(cs[-1])
    print(f"[main] config5 scene: {g.tri_v0.shape[0]} triangles, grid axis "
          f"{ig.grid_axis(g)}, {n_clusters} clusters, "
          f"{(cs[1:] > cs[:-1]).float().mean().item():.4f} of cells "
          f"occupied, max {int((cs[1:] - cs[:-1]).max())} clusters per "
          f"cell, feature table {g.cl_feat.numel() * 4 / 1e6:.1f} MB and "
          f"split table {nbytes(g.cl_feat_split) / 1e6:.1f} MB on the card; "
          f"host build s: grid tables (split table included) "
          f"{t[1] - t[0]:.2f}, to card {t[2] - t[1]:.2f}")
    return scene


def grid_stats_frame(args):
    """One trace_sample with every grid query's stats recorded."""
    infos = []
    real = ig.closest_hit_grid

    def recording(g, o, d, **kw):
        t, n, m, info = real(g, o, d, stats=True, **kw)
        infos.append((o.shape[0], kw.get("first_steps"), info))
        return t, n, m

    ig.closest_hit_grid = recording
    try:
        wavefront.trace_sample(*args, with_stats=True)
    finally:
        ig.closest_hit_grid = real
    return infos


def phase_config5(scene, device) -> int:
    cfg = pt.PRESETS["config5"]
    reset_launches()
    t0 = time.perf_counter()
    img = pt.render(scene, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()
    mean = check_image("config5", img, cfg)
    check_only("config5", counts, GRID)
    print(f"[main] render(config5) {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth}: mean {mean:.6f}, launches {counts}, "
          f"{seconds:.3f} s (first frame)")
    check_against_k4("config5 via the grid", scene, cfg, img)

    args = frame_args(scene, cfg, device)
    for i, (n_rays, first, info) in enumerate(grid_stats_frame(args)):
        print(f"[main] config5 query {i} (bounce {i // 2}, "
              f"{('closest', 'shadow')[i % 2]}, first_steps {first}): "
              f"{n_rays} rays, {info['live_after_phase0']} live entering "
              f"the eras, {info['eras']} eras of <= {info['era_rays']} rays, "
              f"{info['visits']} pair-kernel visits, "
              f"{info['dda_launches']} DDA launches")
        check(info["dda_launches"] == info["eras"] + 1, f"config5 query "
              f"{i}: {info['dda_launches']} DDA launches, expected one per "
              f"phase ({info['eras'] + 1})")
    route_frame("config5", args, GRID)
    return counts["pair_hit"], counts["grid_dda"]


def record_dda_calls(args):
    """The main path's dda_window calls of one trace_sample(*args): per
    call its arguments, cloned, in order."""
    calls = []
    real = ig.dda_window

    def recording(o, d, t_max, ptr, width, **kw):
        calls.append(((o.clone(), d.clone(), t_max.clone(), ptr.clone(),
                       width), kw))
        return real(o, d, t_max, ptr, width, **kw)

    ig.dda_window = recording
    try:
        wavefront.trace_sample(*args)
    finally:
        ig.dda_window = real
    return calls


def phase_dda_vs_plain(scene, cfg, device) -> dict:
    """The DDA window kernel against its plain version (dda_window_plain)
    on every dda_window call of one full config-5 frame: bit for bit, one
    launch per call; each call timed beside the plain version and its
    bound, the bytes it must move (rays, ptr, grid, bitmask and windows,
    each once) at the card's memory rate."""
    calls = record_dda_calls(frame_args(scene, cfg, device))
    check(len(calls) > 0, "the config-5 frame made no dda_window call")
    out = new_totals()
    rays = 0
    for (o, d, t_max, ptr, width), kw in calls:
        n0 = ig.DDA_LAUNCHES
        got = ig.dda_window(o, d, t_max, ptr, width, **kw)
        torch.cuda.synchronize()
        check(ig.DDA_LAUNCHES == n0 + 1, "dda_window launched the kernel")
        want = ig.dda_window_plain(o, d, t_max, ptr, width, **kw)
        for a, b in zip(got, want):
            check(a.dtype == b.dtype and torch.equal(
                a.view(torch.int32), b.view(torch.int32)),
                f"dda_window on {o.shape[0]} rays, width {width}: the "
                "kernel's window differs from the plain version's")
        grid = [kw["grid_lo"], kw["cell"]] + (
            [] if kw.get("occ_words") is None else [kw["occ_words"]])
        n_bytes = nbytes(o, d, t_max, ptr, *grid, *got)
        add_bound(out, n_bytes, 0)
        ms = cuda_ms(lambda: ig.dda_window(o, d, t_max, ptr, width, **kw),
                     10)
        plain_ms = cuda_ms(lambda: ig.dda_window_plain(o, d, t_max, ptr,
                                                       width, **kw), 1)
        add_totals(out, ms, plain_ms, 0.0)
        rays += o.shape[0]
    mode = ("occupied cells" if calls[0][1].get("occ_words") is not None
            else "DDA steps")
    print(f"[kernel] grid_dda config5 frame: {len(calls)} calls "
          f"({mode}), {rays} rays in all, every window bit-equal to the "
          f"plain version's; kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"(bytes) per frame")
    return out


def stream_scene(host, cfg, device):
    """prepare_accel -> the card, timed; the cluster table checked on the
    host (check_cluster_invariants), timed."""
    t0 = time.perf_counter()
    scene = prepare_accel(host, cfg)
    t1 = time.perf_counter()
    g = scene.geometry
    check_cluster_invariants(ClusterSet(
        lo=np.asarray(g.cl_lo), hi=np.asarray(g.cl_hi),
        feat=np.asarray(g.cl_feat), tri_map=np.asarray(g.cl_map)),
        int(g.tri_v0.shape[0]))
    t2 = time.perf_counter()
    print(f"[main] config5 stream scene: check_cluster_invariants on "
          f"{g.cl_lo.shape[0]} clusters of {g.tri_v0.shape[0]} triangles "
          f"passed in {t2 - t1:.2f} s")
    scene = scene.to(device)
    torch.cuda.synchronize()
    g = scene.geometry
    print(f"[main] config5 stream scene: {g.cl_lo.shape[0]} clusters, "
          f"{g.su_lo.shape[0]} supers, feature table "
          f"{g.cl_feat.numel() * 4 / 1e6:.1f} MB and split table "
          f"{nbytes(g.cl_feat_split) / 1e6:.1f} MB on the card; host build "
          f"s: cluster tables (split table included) {t1 - t0:.2f}, to card "
          f"{time.perf_counter() - t2:.2f}")
    return scene


def phase_stream(scene, device, card: str) -> int:
    """The stream route at the full scene size: render a frame of side
    STREAM_PROBE_SIDE, then time one frame at the preset's 1024x1024 when
    four times the first frame's seconds fit STREAM_FRAME_LIMIT_S (else at
    the smaller side), with its launches, rounds and visits per query and
    peak memory; returns that frame's K3 launches."""
    cfg = pt.PRESETS["config5"].replace(backend="stream")
    small = cfg.replace(width=STREAM_PROBE_SIDE, height=STREAM_PROBE_SIDE)
    reset_launches()
    t0 = time.perf_counter()
    img = pt.render(scene, small)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()
    mean = check_image("config5 stream", img, small)
    check_only("config5 stream render", counts, "stream_hit")
    print(f"[main] render(config5, backend=stream) {small.width}x"
          f"{small.height} depth "
          f"{small.max_depth}: mean {mean:.6f}, launches {counts}, "
          f"{seconds:.3f} s")
    check_against_k4("config5 via the stream", scene, small, img)
    if 4.0 * seconds > STREAM_FRAME_LIMIT_S:
        print(f"[main] config5 stream frame stays at {small.width}x"
              f"{small.height}: {cfg.width}x{cfg.height} would take about "
              f"{4 * seconds:.1f} s > {STREAM_FRAME_LIMIT_S} s")
        cfg = small
    args = frame_args(scene, cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    n_rays, queries = record_stream_rounds(scene, cfg, args[5],
                                           keep_inputs=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()
    check_only("config5 stream frame", counts, "stream_hit")
    for i, q in enumerate(queries):
        print(f"[main] config5 stream query {i} (bounce {i // 2}, "
              f"{('closest', 'shadow')[i % 2]}): {q['rays']} rays, "
              f"{len(q['visits'])} rounds, {sum(q['visits'])} K3 cluster "
              f"visits (per round {q['visits']}), {sum(q['warp_visits'])} "
              f"warp visits")
    print(f"[main] trace_sample(config5 backend=stream {cfg.width}x"
          f"{cfg.height}, tiled, with_stats): {n_rays} useful rays, frame s "
          f"{seconds:.6f}, {n_rays / seconds:.1f} useful rays/s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB, launches {counts} on {card}")
    return counts["stream_hit"]


PROBES = {
    # kernel name: (probe variant, wrapper, plain version, peak rate)
    "probe_f32": ("f32", vp.probe_f32, vp.probe_f32_plain, PEAK_F32),
    "probe_split_in": ("split_in", vp.probe_split_in,
                       vp.probe_split_in_plain, PEAK_BF16),
    "probe_split_pre": ("split_pre", vp.probe_split_pre,
                        vp.probe_split_pre_plain, PEAK_BF16),
}
LIB_CHUNK = 1 << 15  # rays per library product: (C*512, chunk) outputs


def probe_args(name, mask, rayf, feat):
    """A probe's inputs from the f32 rays and table: K7 takes them split."""
    if name == "probe_split_pre":
        return (mask, *vp.split_bf16(rayf), *vp.split_bf16(feat))
    return (mask, rayf, feat)


def bench_probe_inputs(scene, cfg, device):
    """All-ones mask, the bench scene's f32 cluster table and the bench
    frame's bounce-0 closest-hit ray features (all 1024² tile-ordered
    rays), padded with zero rows from the port's 11 to the probe's 16."""
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    rayf = record_main_path_queries(scene, cfg.replace(max_depth=1),
                                    ids)[0][3]
    rays = torch.zeros((PROBE_PAD_ROWS, rayf.shape[1]), dtype=torch.float32,
                       device=device)
    rays[:rayf.shape[0]] = rayf
    feat = scene.geometry.cl_feat
    mask = torch.ones((vp.MASK_ROWS, feat.shape[1] // vp.CLUSTER_COLS),
                      dtype=torch.int32, device=device)
    return mask, rays, feat


def probe_products(mask, n_rays) -> int:
    """(ray, column) products a probe computes over n_rays rays: each
    512-ray block b tests the clusters of mask row b % 8."""
    rows = torch.arange(n_rays // vp.RAY_BLOCK, device=mask.device) \
        % vp.MASK_ROWS
    return int((mask[rows] > 0).sum()) * vp.RAY_BLOCK * vp.CLUSTER_COLS


def library_min(name, mask, rayf, feat):
    """The library yardstick of a probe: one torch.matmul per LIB_CHUNK
    rays (f32 with TF32 off for K5; bf16 over the K = 48 hi/lo stacks for
    K6 and K7, with a bf16 output) and the masked amin. Timed only."""
    C = mask.shape[1]
    R = rayf.shape[1]
    if name == "probe_f32":
        table, rays = feat.T, rayf
    else:
        (f_hi, f_lo), (r_hi, r_lo) = vp.split_bf16(feat), vp.split_bf16(rayf)
        table = torch.cat([f_hi, f_hi, f_lo]).T
        rays = torch.cat([r_hi, r_lo, r_hi])
    rows = (torch.arange(R, device=rayf.device) // vp.RAY_BLOCK) \
        % vp.MASK_ROWS
    enabled = (mask[rows] > 0).T  # (C, R)
    out = torch.empty((R,), dtype=torch.float32, device=rayf.device)
    for r0 in range(0, R, LIB_CHUNK):
        q = torch.matmul(table, rays[:, r0:r0 + LIB_CHUNK])
        m = q.view(C, vp.CLUSTER_COLS, -1).amin(1).float()
        m = torch.where(enabled[:, r0:r0 + LIB_CHUNK], m, vp.INIT)
        out[r0:r0 + LIB_CHUNK] = torch.clamp(m.amin(0), max=vp.INIT)
    return out


def phase_probe_checks(bench, cfg, device) -> dict:
    """K5-K7 against their plain versions at the probe script's shapes (R =
    512, C = 4, a random mask) and at full width (the bench table against
    the bench frame's bounce-0 rays, an all-ones mask), where they are also
    timed beside their bound and the library yardstick; K6 and K7 are also
    held to the f32 result at the split's bar, and must differ from it by
    at least SPLIT_FLOOR."""
    rng = np.random.default_rng(0)
    small_mask = (rng.random((vp.MASK_ROWS, 4)) < 0.5).astype(np.int32)
    small_mask[:, 0] = 1
    _, small_rays, small_feat = vp.probe_inputs(seed=1, device=device)
    small_mask = torch.from_numpy(small_mask).to(device)
    full = bench_probe_inputs(bench, cfg, device)
    print(f"[kernel] probe inputs: full width {full[1].shape[1]} rays x "
          f"{full[0].shape[1]} clusters ({full[2].shape[1]} columns)")
    out = {}
    f32_full = None
    for name, (variant, wrapper, plain, peak) in PROBES.items():
        totals = new_totals()
        for shape, (mask, rayf, feat) in (
                ("script", (small_mask, small_rays, small_feat)),
                ("full", full)):
            args = probe_args(name, mask, rayf, feat)
            n0 = launches()[name]
            got = wrapper(*args)
            torch.cuda.synchronize()
            check(launches()[name] == n0 + 1, f"{name} launched its kernel")
            want = plain(*args)
            check(bool(torch.isfinite(got).all()), f"{name}: finite")
            rtol, atol = ((PROBE_RTOL, PROBE_ATOL) if name == "probe_f32"
                          else (SPLIT_PLAIN_RTOL, SPLIT_PLAIN_ATOL))
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            err = (got - want).abs().max().item()
            line = (f"[kernel] {name} ({variant}) {shape}: "
                    f"{rayf.shape[1]} rays, {mask.shape[1]} clusters, "
                    f"max abs err vs plain {err:.3g}")
            if shape == "full":
                if name == "probe_f32":
                    f32_full = got
                else:
                    torch.testing.assert_close(got, f32_full,
                                               rtol=SPLIT_RTOL,
                                               atol=SPLIT_ATOL)
                    split_err = (got - f32_full).abs().max().item()
                    check(split_err >= SPLIT_FLOOR,
                          f"{name}: max |split - f32| {split_err:.3g} below "
                          f"{SPLIT_FLOOR}: the product was not split")
                    line += f", vs f32 max abs {split_err:.3g}"
                ops = probe_products(mask, rayf.shape[1]) * vp.FEAT_ROWS * 2 \
                    * (1 if name == "probe_f32" else 3)
                bound = add_bound(totals, nbytes(*args, got), ops, peak)
                ms = cuda_ms(lambda: wrapper(*args), 5)
                plain_ms = cuda_ms(lambda: plain(*args), 1)
                lib = library_min(name, mask, rayf, feat)
                lib_err = ((lib - want).abs()
                           / want.abs().clamp(min=1e-6)).max().item()
                totals["library_ms"] = cuda_ms(
                    lambda: library_min(name, mask, rayf, feat), 2)
                add_totals(totals, ms, plain_ms, err)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"library {totals['library_ms']:.4f} ms (max rel "
                         f"diff {lib_err:.3g}), bound {bound:.4f} ms "
                         f"({ops:.4g} {'f32' if peak == PEAK_F32 else 'bf16'}"
                         f" operations, {nbytes(*args, got) / 1e6:.1f} MB)")
            else:
                totals["max_abs_err"] = max(totals["max_abs_err"], err)
            print(line)
        out[name] = totals
    return out


def phase_probe_entry() -> dict:
    """The probe's entry point (python -m
    pathtracer_tpu_torch.ops.visit_probe <variant>), in process, once per
    variant at the script's shapes: each launches its own kernel once and
    no other. Returns the launches."""
    counts = {}
    for name, (variant, _, _, _) in PROBES.items():
        reset_launches()
        check(vp.main([variant]) == 0, f"visit_probe {variant} failed")
        n = launches()
        check_only(f"visit_probe {variant}", n, name)
        check(n[name] == 1, f"visit_probe {variant}: {n[name]} launches")
        counts[name] = n[name]
    return counts


def seen_materials(scene, cfg, ids) -> list:
    """Materials that the frame's camera rays hit."""
    jitter = rng_mod.pixel_jitter(cfg.seed, 0, ids)
    o, d = camera_rays(scene.camera, cfg.width, cfg.height, jitter, ids)
    t, _, mat = wavefront._intersector(scene.geometry, cfg)(scene.geometry,
                                                            o, d)
    return torch.unique(mat[t < C.T_FAR]).tolist()


def grad_step(scene, cfg, ids):
    """One value-and-grad step of bench.py --grad: the loss mean(rad²) of
    the tile-ordered frame and its grads w.r.t. the materials, with the
    frame's useful rays."""
    stats = {}

    def loss_fn(mats):
        rad, stats["n"] = wavefront.trace_sample(
            scene.geometry, mats, scene.camera, scene.lights, cfg, ids, 0,
            with_stats=True)
        return torch.mean(rad * rad)

    loss, grads = dr.value_and_grad(loss_fn, scene.materials)
    return loss, int(stats["n"]), grads


def phase_grad(scene, device) -> None:
    """A value-and-grad step of the full bench frame, through K1 and
    through K4: the loss equals the forward frame's bit for bit, the step
    launches only its route's kernel, 2 per bounce (no recompute at 1 spp),
    the grads are finite, non-zero for every albedo the camera sees, and
    no geometry table takes a gradient even as a leaf that requires one."""
    for backend, kernel in (("cluster", "cluster_hit"), ("jnp", "bvh_hit")):
        cfg = pt.PRESETS["bench"].replace(backend=backend)
        ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
        with torch.inference_mode():
            rad = wavefront.trace_sample(*frame_args(scene, cfg, device))
            fwd_loss = torch.mean(rad * rad).clone()
            seen = seen_materials(scene, cfg, ids)
        reset_launches()
        loss, n, grads = grad_step(scene, cfg, ids)
        torch.cuda.synchronize()
        counts = launches()
        check_only(f"grad {backend}", counts, kernel)
        check(counts[kernel] == 2 * cfg.max_depth,
              f"grad {backend}: {counts[kernel]} launches, expected "
              f"{2 * cfg.max_depth}")
        check(torch.equal(loss, fwd_loss), f"grad {backend}: loss "
              f"{loss.item()!r} differs from the forward frame's "
              f"{fwd_loss.item()!r}")
        check(bool(torch.isfinite(grads.albedo).all()
                   and torch.isfinite(grads.emission).all()),
              f"grad {backend}: finite grads")
        zero = [m for m in seen if not bool((grads.albedo[m] != 0).any())]
        check(not zero, f"grad {backend}: seen materials {zero} have zero "
              "albedo grads")
        geometry_gets_no_grad(scene, cfg)
        print(f"[grad] bench backend={backend} ({kernel}) {cfg.width}x"
              f"{cfg.height} depth {cfg.max_depth}: loss {loss.item()!r} "
              f"bit-equal to the forward frame's, launches {counts}, seen "
              f"materials {seen} all with non-zero albedo grads, no geometry "
              f"table took a gradient, albedo grad abs sum "
              f"{grads.albedo.abs().sum().item():.6g}, emission "
              f"{grads.emission.abs().sum().item():.6g}, {n} useful rays")


def fd_grad(scene, cfg, field, idx, ch) -> float:
    """Central difference of mean(image) in one material entry."""
    means = []
    for sign in (-1.0, 1.0):
        arr = getattr(scene.materials, field).clone()
        arr[idx, ch] += sign * FD_EPS
        with torch.inference_mode():
            img = dr.render_image(scene, cfg,
                                  scene.materials.replace(**{field: arr}))
        means.append(img.double().mean().item())
    return (means[1] - means[0]) / (2 * FD_EPS)


def geometry_gets_no_grad(scene, cfg) -> None:
    """Every float geometry table as a leaf that requires grad: after a
    backward pass none has a non-zero gradient."""
    g = scene.geometry
    leaves = {f.name: getattr(g, f.name).clone().requires_grad_(True)
              for f in dataclasses.fields(g)
              if getattr(g, f.name).is_floating_point()}
    geom = dataclasses.replace(g, **leaves)
    mats = scene.materials.replace(
        albedo=scene.materials.albedo.clone().requires_grad_(True))
    ids = torch.arange(cfg.n_pixels, dtype=torch.int64,
                       device=g.tri_v0.device)
    wavefront.trace_sample(geom, mats, scene.camera, scene.lights, cfg, ids,
                           0).mean().backward()
    check(mats.albedo.grad is not None, "no albedo grad")
    bad = [n for n, x in leaves.items()
           if x.grad is not None and bool((x.grad != 0).any())]
    check(not bad, f"geometry tables {bad} took a gradient")


def phase_grad_fd(bench, device) -> None:
    """Material grads against central differences at the bars of
    tests/grad/test_grad.py: config4 as it stands (brute force, 4 spp, so
    the spp checkpoint), and one albedo entry of bench at 256² with RR off
    through K1 and through K4."""
    spheres = builder.build_scene("cornell_spheres").to(device)
    alb = [("albedo", m, ch, 2e-2, 1e-5) for m, ch in
           ((builder.WHITE, 0), (builder.RED, 0), (builder.GREEN, 1))]
    emis = [("emission", builder.LIGHT, ch, 2e-2, 1e-6) for ch in range(3)]
    bench_cfg = pt.PRESETS["bench"].replace(width=FD_SIDE, height=FD_SIDE,
                                            rr_start=99)
    cases = [
        ("config4", spheres, pt.PRESETS["config4"], alb + emis),
        ("bench K1", bench, bench_cfg, alb[:1]),
        ("bench K4", bench, bench_cfg.replace(backend="jnp"), alb[:1]),
    ]
    for label, scene, cfg, entries in cases:
        reset_launches()
        t0 = time.perf_counter()
        loss, grads = dr.grad_render(scene, cfg)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        for field, idx, ch, rtol, atol in entries:
            g = getattr(grads, field)[idx, ch].item()
            fd = fd_grad(scene, cfg, field, idx, ch)
            print(f"[grad] fd {label} {cfg.width}x{cfg.height} spp {cfg.spp} "
                  f"depth {cfg.max_depth}: d mean / d {field}[{idx},{ch}] "
                  f"autograd {g:.6g}, central difference {fd:.6g} (rel "
                  f"{abs(g - fd) / max(abs(fd), 1e-30):.3g}; bar rtol {rtol} "
                  f"atol {atol}); grad step {grad_s:.3f} s, launches "
                  f"{launches()}")
            check(abs(g - fd) <= atol + rtol * abs(fd),
                  f"fd {label} {field}[{idx},{ch}]: {g} vs {fd}")


def run_cli(argv) -> list:
    """cli.main(argv) in this process, with standard output and error
    captured at the file descriptors and echoed as [front] lines; fails on
    a non-zero exit. Returns [stdout, stderr]."""
    sys.stdout.flush()
    sys.stderr.flush()
    files = [open(os.path.join(FRONT_DIR, f"cli.{fd}.txt"), "w+")
             for fd in (1, 2)]
    saved = [os.dup(1), os.dup(2)]
    rc, texts = None, []
    try:
        for fd, f in zip((1, 2), files):
            os.dup2(f.fileno(), fd)
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, s in zip((1, 2), saved):
            os.dup2(s, fd)
            os.close(s)
        for f in files:
            f.seek(0)
            texts.append(f.read())
            f.close()
        for name, text in zip(("out", "err"), texts):
            for line in text.splitlines():
                print(f"[front]   {name}: {line}")
    check(rc == 0, f"cli {' '.join(argv)}: exit {rc}")
    return texts


def front_render_config3(device, card) -> None:
    """config 3 as it stands through the CLI (chunks of 16, a checkpoint
    every 16 spp, a preview every 32): only K4; a 32-spp checkpoint resumed
    to 64 spp and pt.render of the preset both give its image."""
    cfg = pt.PRESETS["config3"]

    def path(name):
        return os.path.join(FRONT_DIR, name)

    reset_launches()
    t0 = time.perf_counter()
    out, _ = run_cli(["render", "--preset", "config3", "--checkpoint",
                      path("ck.npz"), "--checkpoint-every", "16",
                      "--preview-every", "32", "--out", path("a.npy")])
    seconds = time.perf_counter() - t0
    counts = launches()
    check_only("cli render config3", counts, "bvh_hit")
    check(out.count("checkpointed ") == 4 and out.count("preview ") == 2,
          "cli render config3: 4 checkpoints and 2 previews")
    img = np.load(path("a.npy"))
    check(img.shape == (cfg.height, cfg.width, 3)
          and bool(np.isfinite(img).all()) and img.mean() > 0,
          "cli render config3: a finite, non-black image")
    check(np.array_equal(np.load(path("a.preview.npy")), img),
          "cli render config3: the last preview is the image")
    run_cli(["render", "--preset", "config3", "--spp", "32", "--checkpoint",
             path("ck32.npz"), "--out", path("half.npy")])
    out, _ = run_cli(["render", "--preset", "config3", "--resume",
                      path("ck32.npz"), "--out", path("b.npy")])
    check(f"resumed at 32/{cfg.spp} spp" in out, "cli render: resumed")
    resumed = float(np.abs(np.load(path("b.npy")) - img).max())
    direct = float(np.abs(
        pt.render(bench_scene(cfg, device), cfg).cpu().numpy() - img).max())
    print(f"[front] cli render --preset config3 {cfg.width}x{cfg.height} "
          f"{cfg.spp} spp (chunks of {cfg.spp_chunk}) depth {cfg.max_depth}: "
          f"{seconds:.3f} s (scene build included), launches {counts}; "
          f"32-spp checkpoint resumed to {cfg.spp}: max abs diff "
          f"{resumed:.3g}, pt.render: {direct:.3g} (atol {RESUME_ATOL}) on "
          f"{card}")
    check(resumed <= RESUME_ATOL, f"resumed config3 differs by {resumed}")
    check(direct <= RESUME_ATOL, f"pt.render config3 differs by {direct}")


def front_render_bench(card) -> None:
    """The bench preset through the CLI into a PNG: only K1, 2 per bounce."""
    cfg = pt.PRESETS["bench"]
    png = os.path.join(FRONT_DIR, "bench.png")
    reset_launches()
    t0 = time.perf_counter()
    run_cli(["render", "--preset", "bench", "--out", png])
    seconds = time.perf_counter() - t0
    counts = launches()
    check_only("cli render bench", counts, "cluster_hit")
    check(counts["cluster_hit"] == 2 * cfg.max_depth,
          f"cli render bench: {counts['cluster_hit']} K1 launches, "
          f"expected {2 * cfg.max_depth}")
    with open(png, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n"
          and struct.unpack(">II", head[16:24]) == (cfg.width, cfg.height),
          "cli render bench: a PNG of the frame's size")
    print(f"[front] cli render --preset bench -> PNG {cfg.width}x"
          f"{cfg.height}: {seconds:.3f} s (scene build included), launches "
          f"{counts} on {card}")


def front_fit(card) -> None:
    """FIT_STEPS fit steps on the full bench frame from the perturbed
    albedo: finite losses, the last below the first; only K1."""
    cfg = pt.PRESETS["bench"]
    reset_launches()
    out, _ = run_cli(["fit", "--preset", "bench", "--steps",
                      str(FIT_STEPS), "--perturb"])
    counts = launches()
    check_only("cli fit bench", counts, "cluster_hit")
    # The target, every step's forward pass and the final image.
    want = 2 * cfg.max_depth * (FIT_STEPS + 2)
    check(counts["cluster_hit"] == want, f"cli fit bench: "
          f"{counts['cluster_hit']} K1 launches, expected {want}")
    losses = [float(x) for x in
              re.findall(r"^step +\d+  loss (\S+)$", out, re.M)]
    print(f"[front] cli fit --preset bench --steps {FIT_STEPS} --perturb "
          f"({cfg.width}x{cfg.height}, depth {cfg.max_depth}): losses "
          f"{losses}, launches {counts} on {card}")
    check(len(losses) == FIT_STEPS, f"cli fit: {len(losses)} losses")
    check(all(math.isfinite(x) for x in losses), "cli fit: finite losses")
    check(losses[-1] < losses[0], f"cli fit: loss {losses[0]} -> "
          f"{losses[-1]} did not fall")


def phase_front_end(device, card) -> None:
    """The front end on the card, in this process through cli.main: config
    3 with its checkpoint round trip, the bench frame to a PNG and a fit on
    the bench frame."""
    os.makedirs(FRONT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    front_render_config3(device, card)
    front_render_bench(card)
    front_fit(card)
    print(f"[front] phase: {time.perf_counter() - t0:.1f} s")


def on_rank0(mesh, fn):
    """fn() on rank 0 while the other ranks wait; its value on rank 0,
    None elsewhere."""
    out = fn() if mesh.rank == 0 else None
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    return out


def close(a, b, rtol, atol) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def rank_label(mesh) -> str:
    return (f"[dist] rank {mesh.rank} of {mesh.size} "
            f"({dist.get_backend(mesh.group)})")


def dist_frame(what, scene, cfg, mesh, kernel, n_launches=None) -> list:
    """render_sharded of the full frame: this rank launches only `kernel`
    (n_launches times, where given), and on rank 0 the image equals
    pt.render's bit for bit."""
    reset_launches()
    img = pmesh.render_sharded(scene, cfg, mesh)
    torch.cuda.synchronize()
    counts = launches()
    check_only(f"{what} sharded, rank {mesh.rank}", counts, kernel)
    if n_launches is not None:
        check(counts[kernel] == n_launches, f"{what} sharded, rank "
              f"{mesh.rank}: {counts[kernel]} launches, expected "
              f"{n_launches}")

    def single():
        ref = pt.render(scene, cfg, device=mesh.device)
        diff = (img - ref).abs().max().item()
        check(torch.equal(img, ref), f"{what}: the sharded frame differs "
              f"from pt.render's (max abs diff {diff})")
        return "; bit-equal to pt.render"

    return [f"{rank_label(mesh)}: {what} {cfg.width}x{cfg.height} depth "
            f"{cfg.max_depth}: launches {counts}, mean "
            f"{img.mean().item():.6f}{on_rank0(mesh, single) or ''}"]


def dist_grads(scene, cfg, mesh, target) -> list:
    """loss_and_grad_sharded of the full frame against pt.grad_render with
    the same target, at the reference's sharded bars (on rank 0)."""
    reset_launches()
    loss, g = pmesh.loss_and_grad_sharded(scene, cfg, scene.materials,
                                          target, mesh)
    torch.cuda.synchronize()
    counts = launches()
    check_only(f"sharded grads, rank {mesh.rank}", counts, "cluster_hit")

    def single():
        loss1, g1 = pt.grad_render(scene, cfg, target=target,
                                   device=mesh.device)
        check(close(loss, loss1, DIST_LOSS_RTOL, 0.0), f"sharded loss "
              f"{loss.item()!r} vs pt.grad_render's {loss1.item()!r}")
        for field in ("albedo", "emission"):
            a, b = getattr(g, field), getattr(g1, field)
            check(bool(torch.isfinite(a).all()), f"sharded {field} grads "
                  "not finite")
            check(close(a, b, DIST_GRAD_RTOL, DIST_GRAD_ATOL),
                  f"sharded {field} grads vs pt.grad_render's: max abs "
                  f"diff {(a - b).abs().max().item()}")
        check(bool((g.emission != 0).any()), "sharded emission grads are 0")
        return (f"; pt.grad_render loss {loss1.item()!r}, "
                f"grads within rtol {DIST_GRAD_RTOL} / atol "
                f"{DIST_GRAD_ATOL} (max abs diff albedo "
                f"{(g.albedo - g1.albedo).abs().max().item():.3g}, emission "
                f"{(g.emission - g1.emission).abs().max().item():.3g})")

    return [f"{rank_label(mesh)}: loss_and_grad_sharded bench: loss "
            f"{loss.item()!r}, launches {counts}"
            f"{on_rank0(mesh, single) or ''}"]


def dist_train(scene, cfg, mesh, target, n_steps) -> list:
    """n_steps of make_train_step: finite losses, falling over two or
    more steps; the materials bit-identical on every rank."""
    step = pmesh.make_train_step(scene, cfg, target, mesh)
    mats, losses = scene.materials, []
    reset_launches()
    for _ in range(n_steps):
        loss, mats = step(mats)
        losses.append(loss.item())
    counts = launches()
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(n_steps < 2 or losses[-1] < losses[0], f"train loss {losses} did "
          "not fall")
    flat = torch.cat([mats.albedo.reshape(-1), mats.emission.reshape(-1)])
    every = mesh.all_gather(flat[None])
    check(all(torch.equal(every[0], x) for x in every),
          "the materials differ across ranks after the train steps")
    return [f"{rank_label(mesh)}: make_train_step bench x{n_steps}: losses "
            f"{losses}, launches {counts}; materials bit-identical on all "
            f"{mesh.size} ranks"]


def dist_gloo_rank(rank) -> list:
    """[dist] (a), on each of two gloo ranks that share cuda:0: the bench
    frame (K1), its loss and grads, two train steps, and the config-5
    frame (K2), against the single-process paths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pmesh.make_mesh()
    cfg = pt.PRESETS["bench"]
    bench = bench_scene(cfg, mesh.device)
    target = torch.zeros((cfg.height, cfg.width, 3), device=mesh.device)
    lines = dist_frame("bench (K1)", bench, cfg, mesh, "cluster_hit",
                       2 * cfg.max_depth)
    lines += dist_grads(bench, cfg, mesh, target)
    lines += dist_train(bench, cfg, mesh, target, 2)
    del bench
    c5 = pt.PRESETS["config5"]
    t0 = time.perf_counter()
    scene = bench_scene(c5, mesh.device)
    lines.append(f"{rank_label(mesh)}: config5 scene built in "
                 f"{time.perf_counter() - t0:.2f} s")
    lines += dist_frame("config5 (K2)", scene, c5, mesh, GRID)
    return lines


def dist_nccl_rank() -> None:
    """[dist] (b), the one rank that torchrun starts: joins the group as a
    multi-host process does (initialize_distributed with no arguments, its
    env:// branch; NCCL on the card), then the bench frame against
    pt.render and one train step. Prints its lines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pmesh.initialize_distributed()
    try:
        check(dist.is_initialized() and dist.get_backend() == "nccl",
              "initialize_distributed under torchrun formed no NCCL group")
        mesh = pmesh.make_mesh()
        cfg = pt.PRESETS["bench"]
        bench = bench_scene(cfg, mesh.device)
        target = torch.zeros((cfg.height, cfg.width, 3), device=mesh.device)
        lines = (dist_frame("bench (K1)", bench, cfg, mesh, "cluster_hit",
                            2 * cfg.max_depth)
                 + dist_train(bench, cfg, mesh, target, 1))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for line in lines:
        print(line)


def phase_dist() -> None:
    """Sharded rendering and training on the card: (a) two gloo ranks that
    share it, (b) one NCCL rank under torchrun. A rank that fails or
    outlives DIST_TIMEOUT_S fails the phase."""
    t0 = time.perf_counter()
    for lines in spawn_ranks(dist_gloo_rank, 2, timeout=DIST_TIMEOUT_S):
        for line in lines:
            print(line)
    out = subprocess.run(DIST_TORCHRUN_CMD, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True,
                         timeout=DIST_TIMEOUT_S)
    for line in out.stdout.splitlines():
        print(line)
    for line in out.stderr.splitlines():
        print(f"[dist]   err: {line}")
    check(out.returncode == 0, f"torchrun NCCL rank: exit {out.returncode}")
    check("bit-equal to pt.render" in out.stdout and "make_train_step"
          in out.stdout, "torchrun NCCL rank: its checks did not all print")
    print(f"[dist] phase: {time.perf_counter() - t0:.1f} s")


def phase_grid_profile(scene, device) -> None:
    """The grid profile (grid_profile.py) on the config-5 scene, with its
    profiler split of the bounce pass: only K2, and K2 device time seen."""
    t0 = time.perf_counter()
    reset_launches()
    out = grid_profile.run(scene, pt.PRESETS["config5"],
                           roofline.DEFAULT_RAYS, GRID_PROFILE_REPS, device,
                           trace=True)
    counts = launches()
    check_only("grid_profile", counts, GRID)
    check(all(info["visits"] > 0 for info in out["stats"]),
          f"grid_profile: a pass with no pair-kernel visit: {out['stats']}")
    split = out["trace"]["split_ms"]
    check(split[grid_profile.K2] > 0, "grid_profile: the "
          f"profiler saw no K2 device time ({split})")
    print(f"[grid_profile] phase: {time.perf_counter() - t0:.1f} s, "
          f"launches {counts}")


def phase_checks() -> None:
    """The card's check suite (checks.py --full): every check passes, and
    the suite launched K1-K4 and the DDA window kernel and no probe."""
    t0 = time.perf_counter()
    reset_launches()
    rc = checks.main(["--full"])
    counts = launches()
    check(rc == 0, f"checks --full: exit {rc}")
    missing = [k for k in ("cluster_hit", "pair_hit", "stream_hit",
                           "bvh_hit", "grid_dda") if counts[k] == 0]
    check(not missing, f"checks --full never launched {missing}")
    check(not any(counts[k] for k in PROBES), f"checks --full launched a "
          f"probe: {counts}")
    print(f"[checks] phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}")


def kernel_entry(name, n_launches, k) -> dict:
    source, replaces, _, _ = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": ("operations" if k["ops_ms"] >= k["bytes_ms"]
                         else "bytes"),
            "library_ms": k["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); this check runs on the "
                         "GPU only")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build()
    probe_launches = phase_probe_entry()
    with torch.inference_mode():
        t0 = time.perf_counter()
        bench = bench_scene(pt.PRESETS["bench"], device)
        print(f"[main] bench scene: {bench.geometry.tri_v0.shape[0]} "
              f"triangles, {bench.geometry.cl_lo.shape[0]} clusters, "
              f"{bench.geometry.bvh_lo.shape[0]} BVH nodes, host build "
              f"{time.perf_counter() - t0:.2f} s")
        k1 = phase_kernel_vs_plain(bench, pt.PRESETS["bench"], device)
        probes = phase_probe_checks(bench, pt.PRESETS["bench"], device)
        k4 = new_totals()
        c3 = pt.PRESETS["config3"]
        phase_bvh_vs_plain("config3", bench_scene(c3, device), c3,
                           c3.n_pixels, device, k4)
        phase_max_leaf(device, card)
        phase_goldens(device)
        k1_launches = phase_main_path(bench, device)
        sampler_launches, sampler = phase_sampler_vs_plain(bench, device)
        phase_k1_frame(bench, device, card)
        bench_k4 = pt.PRESETS["bench"].replace(backend="jnp")
        route_frame("bench backend=jnp", frame_args(bench, bench_k4, device),
                    "bvh_hit")
        del bench
        k4_launches = phase_bvh_presets(device)

        c5 = pt.PRESETS["config5"]
        host = config5_host_scene(c5)
        scene = config5_scene(host, c5, device)
        k2 = phase_pair_vs_plain(scene, c5, device)
        k2_launches, dda_launches = phase_config5(scene, device)
        dda = phase_dda_vs_plain(scene, c5, device)
        c5_k4 = c5.replace(backend="jnp")
        phase_bvh_vs_plain("config5", scene, c5_k4, BVH_CHECK_PIXELS_C5,
                           device, k4, depth=2)
        route_frame("config5 backend=jnp", frame_args(scene, c5_k4, device),
                    "bvh_hit")
        phase_grid_profile(scene, device)
        del scene
        torch.cuda.empty_cache()

        c5_stream = c5.replace(backend="stream")
        scene = stream_scene(host, c5_stream, device)
        del host
        k3 = phase_stream_vs_plain(scene, c5_stream, device)
        k3_launches = phase_stream(scene, device, card)
        del scene
    torch.cuda.empty_cache()
    # Gradients need tensors made outside inference mode: a new scene.
    bench = bench_scene(pt.PRESETS["bench"], device)
    phase_grad(bench, device)
    phase_grad_fd(bench, device)
    del bench
    torch.cuda.empty_cache()
    phase_checks()
    phase_dist()
    phase_front_end(device, card)
    print(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f}"
          f" s, the builds included")
    print(json.dumps({"kernels": [
        kernel_entry("cluster_hit", k1_launches, k1),
        kernel_entry("pair_hit", k2_launches, k2),
        kernel_entry("grid_dda", dda_launches, dda),
        kernel_entry("sampler", sampler_launches, sampler),
        kernel_entry("stream_hit", k3_launches, k3),
        kernel_entry("bvh_hit", k4_launches, k4),
        *(kernel_entry(name, probe_launches[name], probes[name])
          for name in PROBES),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
