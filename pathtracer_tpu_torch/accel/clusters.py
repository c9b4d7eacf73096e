"""Triangle clustering for the cluster intersector (host-side numpy).

Triangles are partitioned into clusters of <= 128 by recursive median split
(the accel/build.py policy), each cluster padded to exactly 128 slots with
one AABB, and every triangle gets feature columns such that each
Möller-Trumbore quantity is a dot product with a shared per-ray feature
vector F = [d, o x d, o, 1] (rows 0-9):

  det column: [e2 x e1, 0, 0, 0]            -> det   = e1 . (d x e2)
  u   column: [v0 x e2, e2, 0, 0]           -> u_num = tvec . (d x e2)
  v   column: [-(v0 x e1), -e1, 0, 0]       -> v_num = d . (tvec x e1)
  t   column: [0, 0, e1 x e2, -v0 . n]      -> t_num = e2 . (tvec x e1)

Per cluster the 512 columns are [det(128) | u(128) | v(128) | t(128)];
padding slots have all-zero columns (det = 0, never hit). The table is kept
in float32, (16, C*512), rows 10-15 zero. Clustering does not permute the
caller's triangles: `cl_map` maps padded slots back to triangle ids.

`split_table` packs the same columns once per scene for the tensor-core
visit of the stream and pair kernels (ops/csrc/visit_mma.cuh): each used
feature as its bf16 hi/lo error split (the reference's `split_bf16`), one
cluster per contiguous 32 KB block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.model import Scene

CLUSTER_TRIS = 128  # triangles per padded cluster
FEAT_ROWS = 16  # feature-table rows (10 used)
QUANTITIES = 4  # det, u_num, v_num, t_num
CLUSTER_COLS = CLUSTER_TRIS * QUANTITIES  # feature columns per cluster
SUPER_GROUP = 32  # clusters per super-cluster
FEAT_USED = 10  # feature rows that pair with a ray's features
# The split visit's product has depth SPLIT_K = 32: table rows
# [hi(10); hi(10); lo(10); 0; 0] against ray rows [hi; lo; hi; 0; 0] give
# hi*hi + lo*hi + hi*lo (the reference's three partial products, dropping
# lo*lo) in two k-steps of mma.m16n8k16 instead of the three that the
# reference's 16-row stacks (K = 48) would take.
SPLIT_K = 32
# Storage order of a column's 32 k values: a column is 16 words of two bf16
# (the lower k in the low half), and word slot 4t + j holds k pair
# 2t + 8j, so lane t of an mma quad reads its four B registers (k pairs 2t,
# 2t + 8, 2t + 16, 2t + 24) as one 16-byte load. SPLIT_PERM[p] is the k
# value at position p.
SPLIT_PERM = tuple(2 * ((p // 2) // 4 + 4 * ((p // 2) % 4)) + p % 2
                   for p in range(SPLIT_K))


@dataclasses.dataclass
class ClusterSet:
    lo: np.ndarray  # (C, 3) f32 cluster AABB min
    hi: np.ndarray  # (C, 3) f32 cluster AABB max
    feat: np.ndarray  # (16, C*512) f32 feature columns
    tri_map: np.ndarray  # (C*128,) i32 padded slot -> original tri (-1 pad)


def split_bf16(x: torch.Tensor):
    """bf16 hi/lo error split, x ~= hi + lo: round-to-nearest-even casts,
    as the reference's split_bf16 (ops/intersect_cluster.py)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def stack_feat_bf16(feat32: torch.Tensor) -> torch.Tensor:
    """(16, N) f32 table -> the reference's (48, N) bf16 [hi; hi; lo] stack.

    Round-to-nearest-even casts, as the reference's stack_feat; used only to
    hold the port's table against the reference's bit for bit.
    """
    hi, lo = split_bf16(feat32)
    return torch.cat([hi, hi, lo], dim=0)


def split_table(feat32) -> torch.Tensor:
    """(16, C*512) f32 table -> (C, 512, 32) bf16 split columns.

    Column j of cluster c holds the table side of the split product, k
    order [hi(10); hi(10); lo(10); 0; 0] of the used rows, stored in
    SPLIT_PERM order: one cluster is one contiguous 32 KB block, the unit
    of the kernels' bulk copy.
    """
    f = torch.as_tensor(feat32)[:FEAT_USED]
    n_cols = f.shape[1]
    hi, lo = split_bf16(f)
    by_k = {k: hi[k % FEAT_USED] for k in range(2 * FEAT_USED)}
    by_k.update({2 * FEAT_USED + i: lo[i] for i in range(FEAT_USED)})
    out = torch.zeros((n_cols, SPLIT_K), dtype=torch.bfloat16)
    for p, k in enumerate(SPLIT_PERM):
        if k in by_k:
            out[:, p] = by_k[k]
    return out.reshape(n_cols // CLUSTER_COLS, CLUSTER_COLS, SPLIT_K)


def unsplit_columns(split: torch.Tensor) -> torch.Tensor:
    """(..., 32) split columns -> the same in k order (SPLIT_PERM undone)."""
    inv = [0] * SPLIT_K
    for p, k in enumerate(SPLIT_PERM):
        inv[k] = p
    return split[..., inv]


def _median_split_clusters(tri_lo, tri_hi, max_tris: int) -> list[np.ndarray]:
    """Partition triangle ids into spatial clusters of <= max_tris."""
    T = len(tri_lo)
    centroid = (tri_lo + tri_hi) * 0.5
    out: list[np.ndarray] = []
    stack = [np.arange(T, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= max_tris:
            out.append(ids)
            continue
        c = centroid[ids]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            mid = len(ids) // 2
            stack.append(ids[mid:])
            stack.append(ids[:mid])
            continue
        part = np.argsort(c[:, axis], kind="stable")
        mid = len(ids) // 2
        stack.append(ids[part[mid:]])
        stack.append(ids[part[:mid]])
    return out


def _tri_bounds(v0, e1, e2):
    p1 = v0 + e1
    p2 = v0 + e2
    return (np.minimum(np.minimum(v0, p1), p2),
            np.maximum(np.maximum(v0, p1), p2))


def cluster_tables(groups: list[np.ndarray], v0, e1, e2) -> ClusterSet:
    """Feature-column tables for an explicit cluster decomposition.

    `groups` is a list of triangle-id arrays, each of length <= 128.
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    tri_lo, tri_hi = _tri_bounds(v0, e1, e2)
    C = len(groups)

    tri_map = np.full((C, CLUSTER_TRIS), -1, np.int32)
    lens = np.fromiter((len(g) for g in groups), np.int64, count=C)
    assert (lens <= CLUSTER_TRIS).all()
    if C:
        flat = np.concatenate(groups)
        rows = np.repeat(np.arange(C), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        tri_map[rows, cols] = flat
    valid = tri_map >= 0
    safe = np.maximum(tri_map, 0)

    big = np.float32(3.0e38)
    lo = np.where(valid[:, :, None], tri_lo[safe], big).min(1)
    hi = np.where(valid[:, :, None], tri_hi[safe], -big).max(1)

    # float64 cross products, rounded once at the end.
    v0d, e1d, e2d = (a.astype(np.float64) for a in (v0, e1, e2))
    n = np.cross(e1d, e2d)  # e1 x e2
    det_col = np.cross(e2d, e1d)  # = -n
    u_d = np.cross(v0d, e2d)
    v_d = -np.cross(v0d, e1d)
    t_c = -(v0d * n).sum(-1)

    feat4 = np.zeros((FEAT_ROWS, C, QUANTITIES, CLUSTER_TRIS), np.float64)
    vm = valid[None, :, :]

    def put(rows, q, src):  # src: (T, k) per-triangle rows
        feat4[rows, :, q, :] = np.where(vm, src[safe].transpose(2, 0, 1), 0.0)

    put(slice(0, 3), 0, det_col)
    put(slice(0, 3), 1, u_d)
    put(slice(3, 6), 1, e2d)
    put(slice(0, 3), 2, v_d)
    put(slice(3, 6), 2, -e1d)
    put(slice(6, 9), 3, n)
    feat4[9, :, 3, :] = np.where(valid, t_c[safe], 0.0)
    feat = feat4.reshape(FEAT_ROWS, C * CLUSTER_COLS).astype(np.float32)
    return ClusterSet(lo=lo.astype(np.float32), hi=hi.astype(np.float32),
                      feat=feat, tri_map=tri_map.reshape(-1))


def build_clusters(v0, e1, e2, max_tris: int = CLUSTER_TRIS) -> ClusterSet:
    """Cluster triangles (v0, v0+e1, v0+e2) and compute feature columns."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    if len(v0) == 0:
        return ClusterSet(
            lo=np.zeros((0, 3), np.float32),
            hi=np.zeros((0, 3), np.float32),
            feat=np.zeros((FEAT_ROWS, 0), np.float32),
            tri_map=np.zeros((0,), np.int32),
        )
    tri_lo, tri_hi = _tri_bounds(v0, e1, e2)
    groups = _median_split_clusters(tri_lo, tri_hi, max_tris)
    return cluster_tables(groups, v0, e1, e2)


def build_supers(cl_lo: np.ndarray, cl_hi: np.ndarray,
                 group: int = SUPER_GROUP):
    """Group clusters into super-clusters of <= `group` (median split).

    Returns (su_lo, su_hi, cl_super): super AABBs, inflated by a hair so the
    per-ray slab test stays conservative under f32 rounding, and the
    cluster -> super id map.
    """
    C = len(cl_lo)
    if C == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0,), np.int32))
    groups = _median_split_clusters(cl_lo, cl_hi, group)
    S = len(groups)
    su_lo = np.empty((S, 3), np.float32)
    su_hi = np.empty((S, 3), np.float32)
    cl_super = np.empty((C,), np.int32)
    for si, ids in enumerate(groups):
        lo = cl_lo[ids].min(0)
        hi = cl_hi[ids].max(0)
        pad = 1e-6 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-7
        su_lo[si] = lo - pad
        su_hi[si] = hi + pad
        cl_super[ids] = si
    return su_lo, su_hi, cl_super


def slot_nm_table(tri_map: np.ndarray, tri_n, tri_mat) -> np.ndarray:
    """(C*128, 8) pre-joined per-slot [n(3), mat, valid, pad(3)] rows."""
    valid = tri_map >= 0
    safe = np.maximum(tri_map, 0)
    tri_mat = np.asarray(tri_mat)
    if tri_mat.size and int(tri_mat.max()) >= 2 ** 24:
        raise ValueError("material ids >= 2^24 do not round-trip through the "
                         "f32 slot table")
    out = np.zeros((len(tri_map), 8), np.float32)
    out[:, 0:3] = np.asarray(tri_n)[safe]
    out[:, 3] = tri_mat[safe].astype(np.float32)
    out[:, 4] = valid.astype(np.float32)
    return out


def with_clusters(scene: Scene, max_tris: int = CLUSTER_TRIS,
                  super_group: int = SUPER_GROUP) -> Scene:
    """Scene with cluster tables attached to its Geometry (non-permuting)."""
    g = scene.geometry
    cs = build_clusters(g.tri_v0.cpu().numpy(), g.tri_e1.cpu().numpy(),
                        g.tri_e2.cpu().numpy(), max_tris)
    su_lo, su_hi, cl_super = build_supers(cs.lo, cs.hi, super_group)
    g2 = g.replace(
        cl_lo=cs.lo, cl_hi=cs.hi, cl_feat=cs.feat, cl_map=cs.tri_map,
        cl_feat_split=split_table(cs.feat),
        su_lo=su_lo, su_hi=su_hi, cl_super=cl_super,
        cl_slot_nm=slot_nm_table(cs.tri_map, g.tri_n.cpu().numpy(),
                                 g.tri_mat.cpu().numpy()),
    )
    return scene.replace(geometry=g2)


def check_cluster_invariants(cs: ClusterSet, n_tris: int,
                             max_tris: int = CLUSTER_TRIS) -> None:
    """Structural invariants; raises AssertionError on a violation: the
    table shapes, every triangle in exactly one cluster slot, 1..max_tris
    triangles per cluster, and lo <= hi.

    The reference's check (pathtracer_tpu/accel/clusters.py:
    check_cluster_invariants) on the port's layout: `feat` is the f32
    (FEAT_ROWS, C * CLUSTER_COLS) table, where the reference holds the
    (FEAT_STACK, C * CLUSTER_COLS) bf16 [hi; hi; lo] stack; `tri_map` is
    (C * CLUSTER_TRIS,) in both.
    """
    C = len(cs.lo)
    assert cs.feat.shape == (FEAT_ROWS, C * CLUSTER_COLS)
    assert cs.tri_map.shape == (C * CLUSTER_TRIS,)
    real = cs.tri_map[cs.tri_map >= 0]
    assert np.array_equal(np.sort(real), np.arange(n_tris)), (
        "every triangle in exactly one cluster slot")
    per_cluster = (cs.tri_map.reshape(C, CLUSTER_TRIS) >= 0).sum(1)
    assert (per_cluster >= 1).all() and (per_cluster <= max_tris).all()
    assert (cs.lo <= cs.hi).all()
