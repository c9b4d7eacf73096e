"""Stackless BVH walk + Möller–Trumbore in plain PyTorch (the reference's
``accel/traverse.py``).

Every ray walks the skip-link layout of accel/build.py with its own int
cursor: a box hit on an inner node advances the cursor to c + 1, a miss or
a finished leaf jumps to ``skip[c]``, and the walk ends at the ``n_nodes``
sentinel. The batch loops until every cursor has reached it, in chunks of
``chunk`` rays (a ray's result does not depend on its chunk). This is the
plain version of the BVH kernel (ops/traverse_bvh.py) and, on the CPU, the
"jnp" route.

Each cross and dot product is written out term by term in one fixed order
(the reference's ops/traverse_pallas.py form), every product and sum rounds
on its own, and the divisions are IEEE, so the CUDA kernel, which rounds in
the same order, returns the same bits.

Every leaf's triangles are all tested: the walk runs as many leaf steps
as the table's largest leaf holds, each masked by the leaf's own count.
The reference tests at most ``max_leaf`` (4 by default) whatever the leaf
holds, so a BVH built with larger leaves misses triangles there; here
``max_leaf`` is kept for parity and may only restate the table's bound
(``leaf_bound``).

Return contract of closest_hit: engine/intersect.py:brute's (t, n_geom,
mat), t == T_FAR on a miss.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..engine.intersect import merge_spheres
from ..ops.intersect_cluster import _safe_inverse

# Rays per walk chunk (the reference's value).
CHUNK = 8192


def leaf_bound(largest: int, max_leaf: int | None) -> int:
    """The triangles a walk tests per leaf at most: `largest`, the table's
    largest leaf count. `max_leaf` (None, or the reference's argument) may
    only restate that bound: a value below it raises ValueError instead of
    leaving a leaf's last triangles untested."""
    if max_leaf is not None and max_leaf < largest:
        raise ValueError(f"max_leaf={max_leaf} is below the table's largest "
                         f"leaf ({largest} triangles); the walks test every "
                         "triangle of a leaf")
    return largest


def slab(lo, hi, o, inv_d):
    """(tnear, tfar) of each ray's slab test against its box (lo, hi)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    return (torch.minimum(t0, t1).max(dim=1).values,
            torch.maximum(t0, t1).min(dim=1).values)


def box_hit(tnear, tfar, t_best):
    """The slab test, culled against the current best hit."""
    return (tfar >= torch.clamp(tnear, min=C.T_MIN)) & (tnear < t_best)


def mt_test(v0, e1, e2, idx, o, d):
    """(t, ok): Möller–Trumbore of each ray against triangle idx, every
    product and sum rounded on its own in the kernels' order."""
    o0, o1, o2 = o.unbind(1)
    d0, d1, d2 = d.unbind(1)
    v0x, v0y, v0z = v0[idx].unbind(1)
    e1x, e1y, e1z = e1[idx].unbind(1)
    e2x, e2y, e2z = e2[idx].unbind(1)
    pv0 = d1 * e2z - d2 * e2y  # pvec = d x e2
    pv1 = d2 * e2x - d0 * e2z
    pv2 = d0 * e2y - d1 * e2x
    det = e1x * pv0 + e1y * pv1 + e1z * pv2
    big = det.abs() > C.DET_EPS
    inv = torch.where(big, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tv0 = o0 - v0x
    tv1 = o1 - v0y
    tv2 = o2 - v0z
    uu = (tv0 * pv0 + tv1 * pv1 + tv2 * pv2) * inv
    qv0 = tv1 * e1z - tv2 * e1y  # qvec = tvec x e1
    qv1 = tv2 * e1x - tv0 * e1z
    qv2 = tv0 * e1y - tv1 * e1x
    vv = (d0 * qv0 + d1 * qv1 + d2 * qv2) * inv
    t = (e2x * qv0 + e2y * qv1 + e2z * qv2) * inv
    ok = (big & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (t > C.T_MIN) & (t < C.T_FAR))
    return t, ok


def _walk_chunk(lo, hi, first, count, skip, v0, e1, e2, o, d, n_test):
    n_nodes = lo.shape[0]
    last_tri = v0.shape[0] - 1
    R = o.shape[0]
    dev = o.device
    inv_d = _safe_inverse(d)
    cursor = torch.zeros((R,), dtype=torch.int64, device=dev)
    t_best = torch.full((R,), C.T_FAR, dtype=torch.float32, device=dev)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    visits = torch.zeros((R,), dtype=torch.int32, device=dev)
    tests = torch.zeros((R,), dtype=torch.int32, device=dev)
    while True:
        active = cursor < n_nodes
        if not bool(active.any()):
            break
        c = torch.clamp(cursor, max=n_nodes - 1)  # finished lanes
        hit_box = active & box_hit(*slab(lo[c], hi[c], o, inv_d), t_best)
        cnt = count[c]
        is_leaf = cnt > 0
        first_c = first[c].to(torch.int64)
        for k in range(n_test):
            idx = torch.clamp(first_c + k, max=last_tri)
            valid = hit_box & is_leaf & (k < cnt)
            t, ok = mt_test(v0, e1, e2, idx, o, d)
            tests += valid.to(torch.int32)
            # Strict: ties keep the earlier hit.
            better = valid & ok & (t < t_best)
            t_best = torch.where(better, t, t_best)
            best = torch.where(better, idx, best)
        nxt = torch.where(hit_box & ~is_leaf, c + 1, skip[c].to(torch.int64))
        cursor = torch.where(active, nxt, cursor)
        visits += active.to(torch.int32)
    return t_best, best.to(torch.int32), visits, tests


def walk(lo, hi, first, count, skip, v0, e1, e2, o, d,
         max_leaf: int | None = None, chunk: int = CHUNK):
    """Closest triangle of every ray by the skip-link walk.

    lo/hi (N, 3) f32 node boxes, first/count/skip (N,) node links (count 0
    = inner node), v0/e1/e2 (T, 3) f32 triangles in leaf order; o, d (R, 3).
    Every triangle of a leaf is tested; `max_leaf` is checked by
    leaf_bound. Returns (t, tri, visits, tests): (R,) f32 best t (T_FAR on
    a miss), (R,) i32 triangle index (-1 on a miss), (R,) i32 nodes visited
    and triangles tested.
    """
    R = o.shape[0]
    n_test = leaf_bound(int(count.max()) if count.shape[0] else 0, max_leaf)
    if lo.shape[0] == 0 or R == 0:
        return (torch.full((R,), C.T_FAR, dtype=torch.float32,
                           device=o.device),
                torch.full((R,), -1, dtype=torch.int32, device=o.device),
                torch.zeros((R,), dtype=torch.int32, device=o.device),
                torch.zeros((R,), dtype=torch.int32, device=o.device))
    parts = [_walk_chunk(lo, hi, first, count, skip, v0, e1, e2,
                         o[s:s + chunk], d[s:s + chunk], n_test)
             for s in range(0, R, chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def hit_from_index(geom, o, d, t_best, tri):
    """(t, n_geom, mat) from each ray's winning triangle (-1 = miss), with
    the scene's spheres merged by brute force."""
    hit = tri >= 0
    safe = torch.clamp(tri, min=0).to(torch.int64)
    n_best = torch.where(hit[:, None], geom.tri_n[safe], 0.0)
    m_best = torch.where(hit, geom.tri_mat[safe], 0)
    t_out = torch.where(hit, t_best, C.T_FAR)
    return merge_spheres(geom, o, d, t_out, n_best, m_best)


def closest_hit(geom, o, d, max_leaf: int | None = None,
                chunk: int = CHUNK):
    """Closest hit via the BVH walk (triangles) + brute spheres; the
    engine/intersect.py:brute contract."""
    t_best, tri, _, _ = walk(geom.bvh_lo, geom.bvh_hi, geom.bvh_first,
                          geom.bvh_count, geom.bvh_skip, geom.tri_v0,
                          geom.tri_e1, geom.tri_e2, o, d, max_leaf, chunk)
    return hit_from_index(geom, o, d, t_best, tri)
