"""Stream closest-hit intersection: the cluster walk in K-candidate rounds.

The counterpart of the reference's ``ops/intersect_stream.py``. The
reference built this route for cluster tables too large for its cluster
kernel's VMEM: the table stays in HBM and each ray block walks its
near-first candidate list in rounds of ``ROUND_CAND`` clusters. In two
parts:

  glue (plain PyTorch): pad to whole 512-ray blocks, the scene-box exit
      cap, the block-interval cull and, when the scene has more than one
      super-cluster, the per-ray super cull (the cluster route's functions),
      and the full near-first candidate order padded by one extra window.
      Then the ROUND loop: after each round a block is resolved when its
      worst best t is at or below the first entry bound the window left
      out (later bounds only grow, so no later cluster can win) or when its
      list is exhausted; resolved blocks get count 0, and the loop, one
      host sync per round, stops when every block is resolved. Exact for
      any candidate distribution: at worst ceil(C / K) rounds visit every
      culled cluster.

  fine test (``stream_hit``): one round for every block, continuing from
      the carried-in best t and slot with the ordered early exit, on the
      split table (``Geometry.cl_feat_split``): each visit's product is the
      reference's bf16 hi/lo split, as its kernel computes it. On a CUDA
      tensor it launches the hand-written kernel in
      ``csrc/intersect_stream.cu`` (the cluster kernel's walk, with its
      per-warp cluster-box skip); on a CPU tensor it runs
      ``stream_hit_plain``, which tests every windowed candidate.

Contract: that of intersect_cluster.closest_hit_cluster, (t, n_geom, mat)
with t == T_FAR on a miss and the optional per-ray t_max bound, at the
reference's split-product tolerance.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..engine.intersect import merge_spheres
from ..utils.profiling import host_read, span
from . import _build
from .boundary import no_gradient
from .intersect_cluster import (
    RAY_BLOCK,
    _check_hit_inputs,
    _pad_rays,
    check_bulk_aligned,
    cull_candidates,
    decode_winner,
    exit_bound,
    ray_features,
    ray_super_mask,
    visit_split_plain,
    walk_candidates_plain,
)

# Candidates per round window (the reference's value; not tuned on the
# H100 yet).
ROUND_CAND = 256

# Kernel launches through stream_hit (CUDA tensors only).
LAUNCHES = 0


def _check_stream_inputs(cand, count, tnear, rayf, t_in, slot_in, feat,
                         box_lo, box_hi):
    _check_hit_inputs(cand, count, tnear, rayf, feat, box_lo, box_hi)
    R = rayf.shape[1]
    for name, x, dtype in (("t_in", t_in, torch.float32),
                           ("slot_in", slot_in, torch.int32)):
        if x.dtype != dtype or tuple(x.shape) != (R,):
            raise ValueError(f"{name} must be {dtype} ({R},); got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != rayf.device:
            raise ValueError(f"{name} is on {x.device}, rayf on {rayf.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stream_hit_plain(cand, count, tnear, rayf, t_in, slot_in, feat, box_lo,
                     box_hi):
    """Plain PyTorch version of the stream kernel's contract.

    Args:
      cand: (B, K) i32 the round's candidate window per 512-ray block.
      count: (B,) i32 candidates to walk this round (0 skips the block).
      tnear: (B, K) f32 sorted entry-distance lower bounds (unused here:
        without the early exit every windowed candidate is tested, which
        cannot change the result).
      rayf: (11, R) f32 ray features, R = 512 * B.
      t_in, slot_in: (R,) f32 / i32 carried best t and padded slot.
      feat: (C, 512, 32) bf16 split table: each visit is the split product
        (intersect_cluster.visit_split_plain).
      box_lo, box_hi: (C, 3) f32 cluster boxes (checked, unused here: they
        feed the kernel's per-warp box skip, which changes no result but in
        the deep-cancellation case intersect_cluster.warp_box_skip names).

    Returns (t, slot, visits, warp_visits): the new (R,) best t and slot
    (strictly nearer hits only; ties keep the lower row, then the earlier
    visit), the (B,) i32 clusters tested per block and the (B,) i32 warp
    visits per block (8 per cluster tested).
    """
    _check_stream_inputs(cand, count, tnear, rayf, t_in, slot_in, feat,
                         box_lo, box_hi)
    t = t_in.clone()
    slot = slot_in.clone()
    visits, warp_visits = walk_candidates_plain(
        cand, count, rayf, feat, visit_split_plain, t, slot)
    return t, slot, visits, warp_visits


def _kernel():
    fn = _build.load("intersect_stream").stream_hit_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_hit(cand, count, tnear, rayf, t_in, slot_in, feat, box_lo,
               box_hi):
    """One round of every block's walk (see stream_hit_plain) on the split
    table `feat` (Geometry.cl_feat_split) and its clusters' boxes.

    CPU tensors run the plain version. CUDA tensors launch the CUDA kernel
    (built at first use) on the current stream, with the ordered early
    exit and the per-warp cluster-box skip, and count the launch in
    LAUNCHES; a failed launch raises. Returns (t, slot, visits,
    warp_visits) as stream_hit_plain does, except that visits counts the
    clusters the early-exiting walk actually staged and warp_visits the
    visits its warps computed. An autograd boundary (ops/boundary.py): no
    gradient flows back.
    """
    return no_gradient(_stream_hit, cand, count, tnear, rayf, t_in, slot_in,
                       feat, box_lo, box_hi)


def _stream_hit(cand, count, tnear, rayf, t_in, slot_in, feat, box_lo,
                box_hi):
    global LAUNCHES
    _check_stream_inputs(cand, count, tnear, rayf, t_in, slot_in, feat,
                         box_lo, box_hi)
    dev = rayf.device
    if dev.type == "cpu":
        return stream_hit_plain(cand, count, tnear, rayf, t_in, slot_in, feat,
                                box_lo, box_hi)
    if dev.type != "cuda":
        raise ValueError(f"stream_hit runs on cpu or cuda, not {dev}")
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
            rayf.data_ptr(), t_in.data_ptr(), slot_in.data_ptr(),
            feat.data_ptr(), box_lo.data_ptr(), box_hi.data_ptr(),
            t.data_ptr(), slot.data_ptr(), visits.data_ptr(),
            warp_visits.data_ptr(), B, K, feat.shape[0], R,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_hit kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return t, slot, visits, warp_visits


def closest_hit_stream(geom, o, d, max_cand: int = ROUND_CAND, t_max=None):
    """Closest hit through the cluster tables in K-candidate rounds:
    (t, n_geom, mat), t == T_FAR on a miss.

    t_max: optional (R,) per-ray bound; hits at t >= t_max[i] may read as
    misses, hits strictly nearer are found. max_cand is the round window K
    (changes only the work, never the result). Spheres are merged by brute
    force.
    """
    n_clusters = int(geom.cl_lo.shape[0])
    if n_clusters == 0:
        raise ValueError("no cluster tables: call with_clusters(scene)")
    if max_cand < 1:
        raise ValueError(f"max_cand must be >= 1; got {max_cand}")
    with span("stream"):
        return _rounds(geom, o, d, max_cand, t_max, n_clusters)


def _rounds(geom, o, d, max_cand, t_max, n_clusters):
    """closest_hit_stream's rounds (its arguments checked)."""
    R0 = o.shape[0]
    o_p, d_p, t_max_p = _pad_rays(o, d, t_max)
    # Scene-box exit cap: without it, rays that miss the scene never
    # resolve and every block walks its whole list.
    t_exit = exit_bound(geom.cl_lo, geom.cl_hi, o_p, d_p)
    t_max_p = t_exit if t_max_p is None else torch.minimum(t_max_p, t_exit)
    rayf = ray_features(o_p, d_p, t_max_p)
    B = o_p.shape[0] // RAY_BLOCK
    extra = None
    if geom.su_lo.shape[0] > 1:
        extra = ray_super_mask(geom.su_lo, geom.su_hi, geom.cl_super, o_p,
                               d_p, t_max_p)
    cand, count, tnear = cull_candidates(geom.cl_lo, geom.cl_hi, o_p, d_p,
                                         t_max=t_max_p, extra_mask=extra)
    K = min(max_cand, n_clusters)
    n_rounds = -(-n_clusters // K)
    # Whole rounds plus one window, so the resolution cap of the last
    # round reads inside the table.
    pad = n_rounds * K + K - n_clusters
    cand = torch.cat([cand, cand.new_full((B, pad), -1)], dim=1)
    tnear = torch.cat([tnear, tnear.new_full((B, pad), C.T_FAR)], dim=1)

    t_cur = t_max_p.to(torch.float32).contiguous()
    slot_cur = torch.full_like(t_cur, -1, dtype=torch.int32)
    resolved = count == 0  # empty blocks are born resolved
    for r in range(n_rounds):
        with host_read("round.resolved"):
            if bool(resolved.all()):
                break
        start = r * K
        cnt_r = torch.where(resolved, 0, torch.clamp(count - start, 0, K))
        t_cur, slot_cur, _, _ = stream_hit(
            cand[:, start:start + K].contiguous(), cnt_r.to(torch.int32),
            tnear[:, start:start + K].contiguous(), rayf, t_cur, slot_cur,
            geom.cl_feat_split, geom.cl_lo, geom.cl_hi)
        cap = tnear[:, start + K]
        worst = t_cur.view(B, RAY_BLOCK).max(dim=1).values
        resolved = resolved | (worst <= cap) | (count <= start + K)
    t_out, n_best, m_best = decode_winner(geom, slot_cur[:R0], t_cur[:R0])
    return merge_spheres(geom, o, d, t_out, n_best, m_best)
