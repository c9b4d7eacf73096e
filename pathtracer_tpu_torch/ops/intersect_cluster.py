"""Cluster closest-hit intersection: the port's main-path intersector.

The reference's ``ops/intersect_cluster.py`` in two parts:

  glue (plain PyTorch, as it is plain XLA in the reference): the scene-box
      exit bound, the ray features, the per-ray cluster line cull, the
      per-block near-first candidate lists, the winner decode and the
      sphere merge. The cull granularity is the reference's 512-ray block,
      so candidate lists equal the reference's. On a CUDA tensor the
      per-ray line cull (``ray_cluster_mask``) launches the hand-written
      kernel in ``csrc/cluster_cull.cu``, bit-equal to its plain version.

  fine test (``cluster_hit``): per 512-ray block, walk the candidate
      clusters front to back and test each cluster's 128 triangles with the
      reference's bf16 hi/lo split product (``Geometry.cl_feat_split``);
      stop once no ray's best hit lies beyond the next cluster's entry
      bound. On a CUDA tensor this launches the hand-written kernel in
      ``csrc/intersect_cluster.cu``, which also skips, per 64-ray warp, a
      cluster whose box none of the warp's rays crosses nearer than its
      best hit; on a CPU tensor it runs ``cluster_hit_plain``, the plain
      PyTorch version of the same contract.

Contract: the hit set of engine/intersect.py:brute (same DET_EPS/T_MIN
predicate, in multiply-by-|det| form) at the reference's tolerance of the
split product: t agrees to rtol 4e-3 / atol 2e-4, and a hit whose
predicate lies within the split's error may flip; which of two triangles
at an equal t wins may differ.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..accel.clusters import (
    CLUSTER_COLS,
    CLUSTER_TRIS,
    SPLIT_K,
    split_bf16,
    unsplit_columns,
)
from ..engine.intersect import merge_spheres
from ..utils.profiling import span
from . import _build
from .boundary import no_gradient

RAY_BLOCK = 512  # rays per cull block = rays per CUDA thread block
WARP_RAYS = 64  # rays per warp of the walk kernels: the box skip's grain
# The box skip tests a warp's rays up to their best t times this slack, so
# that a split t a little before the exact hit never skips a cluster whose
# triangle could still win (see warp_box_skip).
SKIP_T_SLACK = 1.0 + 2.0 ** -12
RAY_FEATS = 11  # ray-feature rows: 10 pair with the table, row 10 = t_max
_FEAT_USED = 10

# The reference routes a scene to its cluster kernel while the 48-row bf16
# table fits 10 MiB of TPU VMEM (~213 clusters). The port keeps that bound
# so the same scenes reach the cluster kernel (and, above it, the grid) in
# both packages; a bound measured on the H100 is still open (PERF.md).
_ROUTE_TABLE_BYTES = 10 * 1024 * 1024
_REFERENCE_BYTES_PER_COL = 48 * 2

# Per-ray line cull at cluster granularity up to this many clusters, else
# at super-cluster granularity (every cluster-routed scene is below it).
RAY_CULL_MAX_C = 512

# Kernel launches through cluster_hit and ray_cluster_mask (CUDA tensors
# only).
LAUNCHES = 0
CULL_LAUNCHES = 0


def routes_to_cluster(n_clusters: int) -> bool:
    return n_clusters * CLUSTER_COLS * _REFERENCE_BYTES_PER_COL \
        <= _ROUTE_TABLE_BYTES


def _safe_inverse(d: torch.Tensor) -> torch.Tensor:
    tiny = 1e-20
    dd = torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
    return 1.0 / dd


def exit_bound(cl_lo, cl_hi, o, d):
    """Per-ray exit distance from the union box of all clusters.

    No ray can hit anything beyond it, so best-t starts there: rays that
    miss the scene finish their ordered walk early. The small relative and
    absolute epsilon keeps triangles on a box face inside the bound; the
    clamp keeps it at or below T_FAR.
    """
    lo = cl_lo.min(dim=0).values
    hi = cl_hi.max(dim=0).values
    inv = _safe_inverse(d)
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    t_exit = torch.maximum(t0, t1).min(dim=-1).values
    return torch.clamp(torch.clamp(t_exit, min=0.0) * 1.0001 + 1e-3,
                       max=C.T_FAR)


def ray_features(o, d, t_max):
    """(R, 3) origins/directions + (R,) t_max -> planar (11, R) rows.

    Rows [d(3), o x d(3), o(3), 1] pair with the table's feature columns;
    row 10 is the per-ray initial best-t (hits at t >= t_max may be
    reported as misses).
    """
    R = o.shape[0]
    ones = torch.ones((1, R), dtype=torch.float32, device=o.device)
    return torch.cat([
        d.T, torch.linalg.cross(o, d).T, o.T, ones,
        t_max.to(torch.float32).reshape(1, R),
    ], dim=0).contiguous()


def _interval_prod_bounds(xlo, xhi, ylo, yhi):
    """Elementwise interval product bounds: [xlo,xhi] * [ylo,yhi]."""
    p1 = xlo * ylo
    p2 = xlo * yhi
    p3 = xhi * ylo
    p4 = xhi * yhi
    pmin = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    pmax = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    return pmin, pmax


def block_cluster_intervals(cl_lo, cl_hi, o, d):
    """Conservative per-(block, cluster) slab-test intervals.

    Returns (tnear_lo, tfar_hi), each (B, C): a lower bound of the entry
    distance and an upper bound of the exit distance of cluster c for any
    ray of block b.
    """
    B = o.shape[0] // RAY_BLOCK
    inv = _safe_inverse(d)
    o_b = o.reshape(B, RAY_BLOCK, 3)
    i_b = inv.reshape(B, RAY_BLOCK, 3)
    olo = o_b.min(dim=1).values[:, None, :]  # (B, 1, 3)
    ohi = o_b.max(dim=1).values[:, None, :]
    ilo = i_b.min(dim=1).values[:, None, :]
    ihi = i_b.max(dim=1).values[:, None, :]
    a_lo = cl_lo[None, :, :] - ohi  # (B, C, 3) lower end of (lo - o)
    a_hi = cl_lo[None, :, :] - olo
    b_lo = cl_hi[None, :, :] - ohi
    b_hi = cl_hi[None, :, :] - olo
    pmin_a, pmax_a = _interval_prod_bounds(a_lo, a_hi, ilo, ihi)
    pmin_b, pmax_b = _interval_prod_bounds(b_lo, b_hi, ilo, ihi)
    tnear_lo = torch.minimum(pmin_a, pmin_b).max(dim=-1).values
    tfar_hi = torch.maximum(pmax_a, pmax_b).min(dim=-1).values
    return tnear_lo, tfar_hi


def _block_cull(cl_lo, cl_hi, o, d):
    """(hit, tnear_lo), each (B, C): the conservative interval slab test of
    block_cluster_intervals (False only where no ray of block b can cross
    cluster c), and the lower bound of the entry distance."""
    tnear_lo, tfar_hi = block_cluster_intervals(cl_lo, cl_hi, o, d)
    return tfar_hi >= torch.clamp(tnear_lo, min=C.T_MIN), tnear_lo


def cull_mask(cl_lo, cl_hi, o, d):
    """Conservative (n_blocks, C) i32 mask: 0 where no ray of RAY_BLOCK-ray
    block b can hit cluster c. The reference's cull_mask, whose `block`
    argument is here always RAY_BLOCK (512), the port's cull block."""
    return _block_cull(cl_lo, cl_hi, o, d)[0].to(torch.int32)


def _inflate(cl_lo, cl_hi):
    """Cluster boxes grown by 1e-6 of each axis' largest coordinate
    magnitude plus 1e-7, so that rounding never drops a hit on a face."""
    pad = 1e-6 * torch.maximum(cl_lo.abs(), cl_hi.abs()) + 1e-7
    return cl_lo - pad, cl_hi + pad


def ray_cluster_mask_plain(cl_lo, cl_hi, o, d, t_max):
    """(B, C) per-ray line cull at cluster granularity, in plain PyTorch.

    Every ray is slab-tested against every (slightly inflated) cluster box
    within its own [T_MIN, t_max]; cluster c survives for block b iff some
    ray of b crosses it. A hit at t < t_max lies inside its cluster's box,
    so this never drops a hit.
    """
    R = o.shape[0]
    inv = _safe_inverse(d)
    lo, hi = _inflate(cl_lo, cl_hi)
    n = cl_lo.shape[0]
    t_in = torch.full((R, n), -torch.inf, dtype=torch.float32,
                      device=o.device)
    t_out = torch.full((R, n), torch.inf, dtype=torch.float32,
                       device=o.device)
    for ax in range(3):
        t0 = (lo[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (hi[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t_in = torch.maximum(t_in, torch.minimum(t0, t1))
        t_out = torch.minimum(t_out, torch.maximum(t0, t1))
    crossed = (t_out >= torch.clamp(t_in, min=C.T_MIN)) \
        & (t_in <= t_max[:, None])
    return crossed.reshape(R // RAY_BLOCK, RAY_BLOCK, n).any(dim=1)


def _check_mask_inputs(cl_lo, cl_hi, o, d, t_max) -> None:
    """Raises ValueError on malformed inputs of ray_cluster_mask."""
    for name, x in (("cl_lo", cl_lo), ("cl_hi", cl_hi), ("o", o), ("d", d),
                    ("t_max", t_max)):
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name} must be a tensor; got {type(x)}")
    if cl_lo.dim() != 2 or o.dim() != 2:
        raise ValueError(f"cl_lo and o must be 2-d; got {tuple(cl_lo.shape)} "
                         f"and {tuple(o.shape)}")
    n, R = cl_lo.shape[0], o.shape[0]
    for name, x, shape in (("cl_lo", cl_lo, (n, 3)), ("cl_hi", cl_hi, (n, 3)),
                           ("o", o, (R, 3)), ("d", d, (R, 3)),
                           ("t_max", t_max, (R,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
    if R % RAY_BLOCK:
        raise ValueError(f"the ray count must be a multiple of {RAY_BLOCK}; "
                         f"got {R}")
    if not 1 <= n <= RAY_CULL_MAX_C:
        raise ValueError(f"the per-ray cull takes 1 to {RAY_CULL_MAX_C} "
                         f"clusters; got {n}")


def _cull_kernel():
    fn = _build.load("cluster_cull").cluster_cull_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ray_cluster_mask(cl_lo, cl_hi, o, d, t_max):
    """(B, C) bool per-ray line cull at cluster granularity (see
    ray_cluster_mask_plain): o, d (R, 3) and t_max (R,) f32 rays, R a
    multiple of RAY_BLOCK; cl_lo, cl_hi the (C, 3) f32 cluster boxes, 1 <= C
    <= RAY_CULL_MAX_C.

    CPU tensors run the plain version. CUDA tensors launch the CUDA kernel
    (built at first use) on the current stream, one thread per ray and no
    (R, C) intermediate, and count the launch in CULL_LAUNCHES; a failed
    launch raises RuntimeError. The mask is bit-equal to the plain
    version's; it carries no gradient. Malformed inputs raise ValueError.
    """
    global CULL_LAUNCHES
    _check_mask_inputs(cl_lo, cl_hi, o, d, t_max)
    dev = o.device
    if dev.type == "cpu":
        return ray_cluster_mask_plain(cl_lo, cl_hi, o, d, t_max)
    if dev.type != "cuda":
        raise ValueError(f"ray_cluster_mask runs on cpu or cuda, not {dev}")
    lo, hi = (x.contiguous()
              for x in _inflate(cl_lo.detach(), cl_hi.detach()))
    o, d, t_max = (x.detach().contiguous() for x in (o, d, t_max))
    B, n = o.shape[0] // RAY_BLOCK, lo.shape[0]
    mask = torch.empty((B, n), dtype=torch.bool, device=dev)
    if B == 0:
        return mask
    launch = _cull_kernel()
    with torch.cuda.device(dev):
        err = launch(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), mask.data_ptr(), B, n, C.T_MIN,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ray_cluster_mask kernel launch failed: CUDA "
                           f"error {err}")
    CULL_LAUNCHES += 1
    return mask


def ray_super_mask(su_lo, su_hi, cl_super, o, d, t_max,
                   chunk_blocks: int = 64):
    """(B, C) per-ray line cull at super-cluster granularity: cluster c
    survives for block b iff some ray of b crosses super(c) within its own
    [T_MIN, t_max].

    Works `chunk_blocks` whole ray blocks at a time, so its (rays, S, 3)
    intermediates stay near 200 MB at ~500 supers (a 1M-ray query in one
    piece would hold ~6 GB each); every ray's test is its own, so the
    result does not depend on the chunking.
    """
    R = o.shape[0]
    inv = _safe_inverse(d)
    step = chunk_blocks * RAY_BLOCK
    parts = [torch.zeros((0, su_lo.shape[0]), dtype=torch.bool,
                         device=o.device)]
    for r0 in range(0, R, step):
        o_c, i_c = o[r0:r0 + step, None, :], inv[r0:r0 + step, None, :]
        t0 = (su_lo[None, :, :] - o_c) * i_c  # (rays, S, 3)
        t1 = (su_hi[None, :, :] - o_c) * i_c
        t_in = torch.minimum(t0, t1).max(dim=-1).values
        t_out = torch.maximum(t0, t1).min(dim=-1).values
        crossed = (t_out >= torch.clamp(t_in, min=C.T_MIN)) \
            & (t_in <= t_max[r0:r0 + step, None])
        parts.append(crossed.reshape(-1, RAY_BLOCK, crossed.shape[1])
                     .any(dim=1))
    return torch.cat(parts)[:, cl_super.to(torch.int64)]


def cull_candidates(cl_lo, cl_hi, o, d, t_max=None, extra_mask=None):
    """Per-block candidate cluster lists, near-first.

    The conservative interval slab test of cull_mask, ANDed with
    `extra_mask` ((B, C) bool), and with per-ray `t_max` also dropping
    clusters that start beyond the block's farthest bound. Candidates are
    sorted by the lower bound of their entry distance (stable sort; ties
    only change the visit order).

    Returns (cand, count, tnear):
      cand: (B, C) i32 cluster ids, -1 padded
      count: (B,) i32 number of valid candidates per block
      tnear: (B, C) f32 sorted entry-distance lower bounds (T_FAR padded)
    """
    hit, tnear_lo = _block_cull(cl_lo, cl_hi, o, d)
    if t_max is not None:
        block_tmax = t_max.reshape(-1, RAY_BLOCK).max(dim=1).values
        hit = hit & (tnear_lo < block_tmax[:, None])
    if extra_mask is not None:
        hit = hit & extra_mask
    count = hit.sum(dim=1).to(torch.int32)
    key = torch.where(hit, tnear_lo, torch.inf)
    order = torch.argsort(key, dim=1, stable=True)
    tkey = torch.gather(key, 1, order)
    rank = torch.arange(order.shape[1], device=o.device)[None, :]
    in_range = rank < count[:, None]
    cand = torch.where(in_range, order, -1).to(torch.int32)
    tnear = torch.where(in_range, tkey, C.T_FAR)
    return cand.contiguous(), count, tnear.contiguous()


def _check_hit_inputs(cand, count, tnear, rayf, feat, box_lo, box_hi):
    """Raises ValueError on malformed inputs: cand/count/tnear/rayf as the
    walks take them, feat the split table (check_table), box_lo/box_hi its
    clusters' (C, 3) f32 boxes."""
    if cand.dim() != 2:
        raise ValueError(f"cand must be (B, K); got {tuple(cand.shape)}")
    check_table(feat)
    B, K = cand.shape
    n_clusters = feat.shape[0]
    expect = {
        "cand": (cand, torch.int32, (B, K)),
        "count": (count, torch.int32, (B,)),
        "tnear": (tnear, torch.float32, (B, K)),
        "rayf": (rayf, torch.float32, (RAY_FEATS, B * RAY_BLOCK)),
        "box_lo": (box_lo, torch.float32, (n_clusters, 3)),
        "box_hi": (box_hi, torch.float32, (n_clusters, 3)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}; got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, x in [(n, e[0]) for n, e in expect.items()] + [("feat", feat)]:
        if x.device != rayf.device:
            raise ValueError(f"{name} is on {x.device}, rayf on {rayf.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def cluster_hit_plain(cand, count, tnear, rayf, feat, box_lo, box_hi,
                      chunk_blocks: int = 256):
    """Plain PyTorch version of the cluster kernel's contract.

    Args:
      cand: (B, K) i32 candidate cluster ids per 512-ray block (-1 pads).
      count: (B,) i32 valid candidates per block (clamped to K).
      tnear: (B, K) f32 entry-distance lower bounds (unused here: without
        the early exit every valid candidate is tested, which cannot change
        the hit set).
      rayf: (11, R) f32 ray features, R = 512 * B; row 10 is the initial
        best-t.
      feat: (C, 512, 32) bf16 split table (Geometry.cl_feat_split): each
        visit is the split product (visit_split_plain).
      box_lo, box_hi: (C, 3) f32 cluster boxes (checked, unused here: they
        feed the kernel's per-warp box skip, which changes no result but in
        the deep-cancellation case warp_box_skip names).

    Returns (t, slot, visits, warp_visits): (R,) f32 best t (row 10 where
    nothing nearer), (R,) i32 winning padded slot cid*128 + row or -1, (B,)
    i32 clusters tested per block, and (B,) i32 warp visits per block (8 per
    cluster tested: no warp skips here). Ties keep the lower row, then the
    earlier visit. Works block chunk by block chunk to bound memory.
    """
    _check_hit_inputs(cand, count, tnear, rayf, feat, box_lo, box_hi)
    t_best = rayf[_FEAT_USED].clone()
    best = torch.full_like(t_best, -1, dtype=torch.int32)
    visits, warp_visits = walk_candidates_plain(
        cand, count, rayf, feat, visit_split_plain, t_best, best,
        chunk_blocks)
    return t_best, best, visits, warp_visits


def walk_candidates_plain(cand, count, rayf, by_cluster, visit, t_best, best,
                          chunk_blocks: int = 256, boxes=None) -> tuple:
    """Every valid candidate of every block, in order, with no early exit:
    updates the (R,) t_best (f32) and best (i32) in place and returns the
    (B,) i32 clusters tested per block (count clamped to K) and the (B,) i32
    warp visits per block. Only blocks with candidates are computed,
    `chunk_blocks` at a time. `visit` tests a cluster of `by_cluster`, the
    table indexed by cluster id that it takes: visit_split_plain on the
    split table, visit_plain on cluster_major(f32 table).

    With boxes = (cl_lo, cl_hi), each visit is the walk kernels' per-warp
    cluster-box skip in plain form (warp_box_skip): the rays of a 64-ray
    warp take the visit only when one of them crosses the cluster's box
    before its current best t (with the skip's slack). Without, every warp
    takes every visit.
    """
    B, K = cand.shape
    n_cand = torch.clamp(count, min=0, max=K).to(torch.int64)
    rays = rayf[:_FEAT_USED].T.reshape(B, RAY_BLOCK, _FEAT_USED)
    t_blk = t_best.view(B, RAY_BLOCK)
    best_blk = best.view(B, RAY_BLOCK)
    n_clusters = by_cluster.shape[0]
    warps = RAY_BLOCK // WARP_RAYS
    warp_visits = n_cand * warps
    busy = torch.nonzero(n_cand > 0).flatten()
    for c0 in range(0, busy.shape[0], chunk_blocks):
        ib = busy[c0:c0 + chunk_blocks]
        r = rays[ib]
        nc = n_cand[ib]
        tb = t_blk[ib]
        bs = best_blk[ib]
        taken = torch.zeros_like(nc)
        for k in range(int(nc.max())):
            cid = torch.clamp(cand[ib, k].to(torch.int64), 0, n_clusters - 1)
            on = (k < nc)[:, None]
            if boxes is not None:
                crossing = warp_box_skip(r, boxes[0][cid], boxes[1][cid], tb)
                taken += (crossing & on).sum(dim=1)
                on = on & crossing.repeat_interleave(WARP_RAYS, dim=1)
            visit(r, by_cluster[cid], cid, on, tb, bs)
        t_blk[ib] = tb
        best_blk[ib] = bs
        if boxes is not None:
            warp_visits[ib] = taken
    return n_cand.to(torch.int32), warp_visits.to(torch.int32)


def warp_box_skip(r, lo, hi, t_best) -> torch.Tensor:
    """The walk kernels' per-warp cluster-box test (csrc/visit_mma.cuh:
    warp_crosses) in plain form. r: (Bc, L, 10) ray features; lo, hi:
    (Bc, 3) the box of each block's visited cluster; t_best: (Bc, L) the
    rays' current best t. Returns (Bc, L // 64) bool: whether some ray of
    each 64-ray warp crosses the box, inflated as ray_cluster_mask inflates
    it, within [T_MIN, its t_best * SKIP_T_SLACK] (ray_cluster_mask's slab
    test).

    A triangle whose exact hit is nearer than that lies inside the box. The
    slack covers the split product's error in t: at an edge two clusters
    share, the first one's split t may lie a little before the exact hit,
    and so before the second one's box, whose triangle the walk without the
    skip would still test and might take at a split t nearer still. The
    split's q errs by about 2^-17 of its terms' magnitudes, so its t errs by
    far less than 2^-12 unless det or t*det cancel deeply: only such a hit,
    at such a seam, could be skipped where the walk without the skip takes
    it."""
    lo, hi = _inflate(lo, hi)
    o = r[:, :, 6:9]
    inv = _safe_inverse(r[:, :, 0:3])
    t_in = torch.full_like(t_best, -torch.inf)
    t_out = torch.full_like(t_best, torch.inf)
    for ax in range(3):
        t0 = (lo[:, ax, None] - o[:, :, ax]) * inv[:, :, ax]
        t1 = (hi[:, ax, None] - o[:, :, ax]) * inv[:, :, ax]
        t_in = torch.maximum(t_in, torch.minimum(t0, t1))
        t_out = torch.minimum(t_out, torch.maximum(t0, t1))
    crossed = (t_out >= torch.clamp(t_in, min=C.T_MIN)) \
        & (t_in <= t_best * SKIP_T_SLACK)
    return crossed.view(crossed.shape[0], -1, WARP_RAYS).any(dim=2)


def cluster_major(feat: torch.Tensor) -> torch.Tensor:
    """(16, C*512) table -> (C, 10, 512) view of the used rows by cluster."""
    n_clusters = feat.shape[1] // CLUSTER_COLS
    return feat[:_FEAT_USED].reshape(_FEAT_USED, n_clusters,
                                     CLUSTER_COLS).permute(1, 0, 2)


def check_table(feat: torch.Tensor) -> None:
    """Raises ValueError unless feat is the (C, 512, 32) bf16 split table,
    C >= 1: the table every visit kernel takes."""
    if not (feat.dtype == torch.bfloat16 and feat.dim() == 3
            and feat.shape[0] > 0
            and tuple(feat.shape[1:]) == (CLUSTER_COLS, SPLIT_K)):
        raise ValueError(f"feat must be the bfloat16 (C, {CLUSTER_COLS}, "
                         f"{SPLIT_K}) split table with C >= 1; got "
                         f"{feat.dtype} {tuple(feat.shape)}")


def check_bulk_aligned(feat: torch.Tensor) -> None:
    """The split kernels bulk-copy a cluster's 32 KB block from the table:
    its start must be 16-byte aligned (every torch allocation is)."""
    if feat.data_ptr() % 16:
        raise ValueError("the split table must start 16-byte aligned")


def visit_plain(r, f, cid, enabled, t_best, best) -> None:
    """One cluster visit per block, in place, with the exact f32 product:
    the yardstick of the split product (visit_split_plain), on no render
    path.

    r: (Bc, L, 10) ray features of each block's L lanes; f: (Bc, 10, 512)
    the visited cluster's columns; cid: (Bc,) its id; enabled: (Bc,) bool,
    or (Bc, L) per lane. t_best (Bc, L) f32 and best (Bc, L) i32 take
    strictly nearer hits (ties keep the lower row, then the earlier visit).
    Products and sums round one at a time and there is no matrix product,
    so TF32 never applies: the card gives the CPU's bits.
    """
    q = r[:, :, 0, None] * f[:, None, 0, :]  # (Bc, L, 512)
    for i in range(1, _FEAT_USED):
        q = q + r[:, :, i, None] * f[:, None, i, :]
    visit_epilogue(q, cid, enabled, t_best, best)


def stack_rays_split(r: torch.Tensor) -> torch.Tensor:
    """(..., 10) f32 ray features -> (..., 32) ray side of the split product
    in k order: [hi(10); lo(10); hi(10); 0; 0] (see accel/clusters.py:
    SPLIT_K), as bf16 values."""
    hi, lo = split_bf16(r)
    pad = torch.zeros(r.shape[:-1] + (SPLIT_K - 3 * _FEAT_USED,),
                      dtype=torch.bfloat16, device=r.device)
    return torch.cat([hi, lo, hi, pad], dim=-1)


def visit_split_plain(r, s, cid, enabled, t_best, best) -> None:
    """One cluster visit per block, in place, with the bf16 hi/lo split
    product (split_product): the plain version of the cluster, stream and
    pair kernels' visit (csrc/visit_mma.cuh) and of the reference's visit_q
    + visit_epilogue, without its 127-ulp t encoding.

    r: (Bc, L, 10) f32 ray features; s: (Bc, 512, 32) the visited
    cluster's split columns (accel/clusters.py:split_table); the rest, the
    epilogue and the tie rule as visit_plain.
    """
    visit_epilogue(split_product(r, s), cid, enabled, t_best, best)


def split_product(r, s) -> torch.Tensor:
    """(Bc, L, 10) f32 rays x (Bc, 512, 32) split columns -> (Bc, L, 512)
    q: per (ray, column) the sum over k of a_k * b_k, the ray side [hi; lo;
    hi] against the table side [hi; hi; lo]. Each product of two bf16 is
    exact in f32, and the 30 products are summed in k order, one rounding
    per term: the reference's visit_q as it runs on the CPU, bit for bit.
    The kernel's tensor cores sum each k-step in their own order."""
    a = stack_rays_split(r).to(torch.float32)  # (Bc, L, 32)
    b = unsplit_columns(s).to(torch.float32).transpose(1, 2).contiguous()
    q = a[:, :, 0, None] * b[:, None, 0, :]  # (Bc, L, 512)
    for k in range(1, 3 * _FEAT_USED):
        q.addcmul_(a[:, :, k, None], b[:, None, k, :])
    return q


def visit_epilogue(q, cid, enabled, t_best, best) -> None:
    """The sign-canonical multiply-form Moller-Trumbore predicate on q
    (Bc, L, 512) = [det | u*det | v*det | t*det] of one cluster, the
    division, and a strict-less update of (t_best, best) in place (ties
    keep the lower row, then the earlier visit)."""
    n = CLUSTER_TRIS
    s = torch.where(q[:, :, 0:n] < 0.0, -1.0, 1.0)
    adet = q[:, :, 0:n] * s
    un = q[:, :, n:2 * n] * s
    vn = q[:, :, 2 * n:3 * n] * s
    tn = q[:, :, 3 * n:4 * n] * s
    valid = ((adet > C.DET_EPS) & (un >= 0.0) & (vn >= 0.0)
             & (un + vn <= adet) & (tn > adet * C.T_MIN))
    tc = torch.where(valid, tn / torch.clamp(adet, min=1e-30), 2.0 * C.T_FAR)
    tmin, row = tc.min(dim=2)
    better = (tmin < t_best) & enabled.reshape(enabled.shape[0], -1)
    best.copy_(torch.where(better, (cid[:, None] * n + row).to(torch.int32),
                           best))
    t_best.copy_(torch.where(better, tmin, t_best))


def _kernel():
    fn = _build.load("intersect_cluster").cluster_hit_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cluster_hit(cand, count, tnear, rayf, feat, box_lo, box_hi):
    """Cluster closest hit of every ray block (see cluster_hit_plain) on the
    split table `feat` (Geometry.cl_feat_split) and its clusters' boxes.

    CPU tensors run the plain version. CUDA tensors launch the CUDA kernel
    (built at first use) on the current stream, with the ordered early
    exit and the per-warp cluster-box skip, and count the launch in
    LAUNCHES; a failed launch raises. Returns (t, slot, visits,
    warp_visits) as cluster_hit_plain does, except that visits counts the
    clusters the early-exiting walk actually staged and warp_visits the
    visits its warps computed. An autograd boundary (ops/boundary.py): no
    gradient flows back.
    """
    return no_gradient(_cluster_hit, cand, count, tnear, rayf, feat, box_lo,
                       box_hi)


def _cluster_hit(cand, count, tnear, rayf, feat, box_lo, box_hi):
    global LAUNCHES
    _check_hit_inputs(cand, count, tnear, rayf, feat, box_lo, box_hi)
    dev = rayf.device
    if dev.type == "cpu":
        return cluster_hit_plain(cand, count, tnear, rayf, feat, box_lo,
                                 box_hi)
    if dev.type != "cuda":
        raise ValueError(f"cluster_hit runs on cpu or cuda, not {dev}")
    B, K = cand.shape
    R = rayf.shape[1]
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    visits = torch.empty((B,), dtype=torch.int32, device=dev)
    warp_visits = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return t, slot, visits, warp_visits
    check_bulk_aligned(feat)
    launch = _kernel()
    with torch.cuda.device(dev):
        err = launch(
            cand.data_ptr(), count.data_ptr(), tnear.data_ptr(),
            rayf.data_ptr(), feat.data_ptr(), box_lo.data_ptr(),
            box_hi.data_ptr(), t.data_ptr(), slot.data_ptr(),
            visits.data_ptr(), warp_visits.data_ptr(), B, K, feat.shape[0],
            R, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cluster_hit kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return t, slot, visits, warp_visits


def _pad_rays(o, d, t_max):
    """Pad rays to a whole block: zero-work point rays (o=0, d=+z) whose
    t_max is T_MIN, so they never widen the block's early-exit bound."""
    pad = (-o.shape[0]) % RAY_BLOCK
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)])
        if t_max is not None:
            t_max = torch.cat([t_max.to(torch.float32),
                               t_max.new_full((pad,), C.T_MIN,
                                              dtype=torch.float32)])
    return o, d, t_max


def decode_winner(geom, slot, t_best):
    """(t, n, mat) of each ray's winning padded slot via the pre-joined
    per-slot [n(3), mat, valid] rows; t is T_FAR where nothing was hit."""
    row_nm = geom.cl_slot_nm[torch.clamp(slot, min=0).to(torch.int64)]
    hit = (slot >= 0) & (row_nm[:, 4] > 0.0)
    n_best = torch.where(hit[:, None], row_nm[:, 0:3], 0.0)
    m_best = torch.where(hit, row_nm[:, 3].to(torch.int32), 0)
    return torch.where(hit, t_best, C.T_FAR), n_best, m_best


def closest_hit_cluster(geom, o, d, t_max=None, use_cull: bool = True):
    """Closest hit through the cluster tables: (t, n_geom, mat), t == T_FAR
    on a miss (the engine/intersect.py:brute contract).

    t_max: optional (R,) per-ray bound; hits at t >= t_max[i] may read as
    misses (right for shadow queries), hits strictly nearer are found.
    use_cull=False tests every cluster in index order with no early exit.
    Spheres are merged by brute force.
    """
    n_clusters = int(geom.cl_lo.shape[0])
    if n_clusters == 0:
        raise ValueError("no cluster tables: call with_clusters(scene)")
    with span("cluster"):
        R0 = o.shape[0]
        with span("cluster.cull"):
            o_p, d_p, t_max_p = _pad_rays(o, d, t_max)
            t_exit = exit_bound(geom.cl_lo, geom.cl_hi, o_p, d_p)
            t_max_p = (t_exit if t_max_p is None
                       else torch.minimum(t_max_p, t_exit))
            rayf = ray_features(o_p, d_p, t_max_p)
            B = o_p.shape[0] // RAY_BLOCK
            if use_cull:
                extra = None
                if 1 < n_clusters <= RAY_CULL_MAX_C:
                    extra = ray_cluster_mask(geom.cl_lo, geom.cl_hi, o_p,
                                             d_p, t_max_p)
                elif geom.su_lo.shape[0] > 1:
                    extra = ray_super_mask(geom.su_lo, geom.su_hi,
                                           geom.cl_super, o_p, d_p, t_max_p)
                cand, count, tnear = cull_candidates(
                    geom.cl_lo, geom.cl_hi, o_p, d_p, t_max=t_max_p,
                    extra_mask=extra,
                )
            else:
                cand = torch.arange(n_clusters, dtype=torch.int32,
                                    device=o.device)
                cand = cand.expand(B, n_clusters).contiguous()
                count = torch.full((B,), n_clusters, dtype=torch.int32,
                                   device=o.device)
                tnear = torch.full((B, n_clusters), -torch.inf,
                                   dtype=torch.float32, device=o.device)
        with span("cluster.k1"):
            t_best, slot, _, _ = cluster_hit(cand, count, tnear, rayf,
                                             geom.cl_feat_split, geom.cl_lo,
                                             geom.cl_hi)
        with span("cluster.decode"):
            t_out, n_best, m_best = decode_winner(geom, slot[:R0],
                                                  t_best[:R0])
            return merge_spheres(geom, o, d, t_out, n_best, m_best)
