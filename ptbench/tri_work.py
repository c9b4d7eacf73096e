"""The work of a closest-hit query counted by triangle boxes: what any
exact walk over axis-aligned boxes must do, whatever its tree.

A ray whose answer is t must test every triangle whose own box the segment
[T_MIN, min(t, t_max)] crosses. Every box that encloses such a triangle
(each of its ancestors' in any BVH) is crossed nearer than t, so no walk
skips it, in any visit order and however it culls by the best t so far.
Those (ray, triangle) tests are the query's work here; a BVH walk tests
far fewer triangles than the whole clusters that ptbench/work.py counts.
The bytes and the least time are work.py's: each live ray's inputs (28
B) and answer (20 B) once, 36 B for each distinct triangle counted, and
the tests at work.py's cost per test. Queries of over work.SAMPLE_RAYS
live rays are counted on work.py's sample of them and scaled.

The count is exact with any prefilter by enclosing boxes: the slab test
is monotone in a box's corners, in floating point too, so where a
triangle's box is crossed every box that encloses it is crossed. The
prefilter here is a tree of boxes over the scene's triangle table: GROUP
consecutive triangles, GROUP consecutive groups of them, and so on up to
at most GROUP boxes (the BVH builds order the table by leaf, so
neighbours lie close).
"""

from __future__ import annotations

import torch

from . import work

GROUP = 64
PAIR_CHUNK = 1 << 22  # (ray, box) slab tests per chunk


def tri_boxes(geom):
    """(T, 3) lo and hi of each triangle (v0, v0 + e1, v0 + e2)."""
    v0 = geom.tri_v0.float()
    v1, v2 = v0 + geom.tri_e1.float(), v0 + geom.tri_e2.float()
    return (torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2))


def group_boxes(lo, hi):
    """The boxes of GROUP consecutive boxes (the last group may be short)."""
    pad = (-lo.shape[0]) % GROUP
    lo = torch.cat([lo, lo.new_full((pad, 3), float("inf"))])
    hi = torch.cat([hi, hi.new_full((pad, 3), float("-inf"))])
    return (lo.reshape(-1, GROUP, 3).amin(dim=1),
            hi.reshape(-1, GROUP, 3).amax(dim=1))


def _inverse(d):
    # work.crossed's.
    return 1.0 / torch.where(d == 0.0, 1e-30, d)


def _crossed(lo, hi, o, inv, t_end):
    """work.crossed's test, elementwise over broadcast shapes: lo, hi
    (..., 3) boxes, o, inv (..., 3), t_end (...)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (near <= far) & (far >= work.T_MIN) & (near <= t_end)


def _descend(rays, parents, lo, hi, o, inv, t_end):
    """(ray, child) pairs: of each pair's parent box, the GROUP children
    (lo, hi)[parent * GROUP + j] that the ray crosses."""
    n = lo.shape[0]
    j = torch.arange(GROUP, device=lo.device)
    per = max(1, PAIR_CHUNK // GROUP)
    out_r, out_c = [rays[:0]], [parents[:0]]
    for s in range(0, rays.numel(), per):
        r = rays[s:s + per]
        c = parents[s:s + per, None] * GROUP + j
        valid = c < n
        c = torch.clamp(c, max=n - 1)
        x = valid & _crossed(lo[c], hi[c], o[r][:, None], inv[r][:, None],
                             t_end[r][:, None])
        pr, pj = torch.nonzero(x, as_tuple=True)
        out_r.append(r[pr])
        out_c.append(c[pr, pj])
    return torch.cat(out_r), torch.cat(out_c)


def crossed_tris(geom, o, d, t_end):
    """(ray, triangle) index pairs of every triangle whose box the segment
    o + s d, s in [T_MIN, t_end], crosses."""
    levels = [tri_boxes(geom)]
    while levels[-1][0].shape[0] > GROUP:
        levels.append(group_boxes(*levels[-1]))
    inv = _inverse(d)
    # Every ray starts at one root whose children are the top level.
    rays = torch.arange(o.shape[0], device=o.device)
    boxes = torch.zeros_like(rays)
    for lo, hi in reversed(levels):
        rays, boxes = _descend(rays, boxes, lo, hi, o, inv, t_end)
    return rays, boxes


def query_work(geom, o, d, t_max, t) -> dict:
    """Tests and bytes one query (rays o, d, t_max; answers t) needs, as
    work.query_work's with triangle boxes for its clusters' boxes."""
    t_end = t.float() if t_max is None else torch.minimum(t.float(),
                                                          t_max.float())
    live = t_end > work.T_MIN if t_max is None else t_max.float() > work.T_MIN
    t_end = torch.clamp(t_end, max=work.T_FAR)
    idx = torch.nonzero(live).squeeze(1)
    n_live = idx.numel()
    if n_live == 0 or geom.tri_v0.shape[0] == 0:
        return {"tests": 0.0, "bytes": 0.0}
    if n_live > work.SAMPLE_RAYS:
        g = torch.Generator(device="cpu").manual_seed(0)
        pick = torch.randperm(n_live, generator=g)[:work.SAMPLE_RAYS]
        idx = idx[pick.to(o.device)]
    _, tri = crossed_tris(geom, o[idx].float(), d[idx].float(), t_end[idx])
    tests = tri.numel() * n_live / idx.numel()
    n_bytes = n_live * (work.RAY_IN_BYTES + work.RAY_OUT_BYTES) \
        + torch.unique(tri).numel() * work.TRI_BYTES
    return {"tests": float(tests), "bytes": float(n_bytes)}


def bound_ms(calls) -> float:
    """The summed least time, in ms, of the recorded calls (geom, o, d,
    t_max, t) of a work.Recorder."""
    return sum(work.bound_ms(query_work(*c)) for c in calls)
