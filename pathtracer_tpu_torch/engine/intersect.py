"""Closest-hit intersection by brute force (all rays × all primitives).

The reference's ``engine/intersect.py``: Möller–Trumbore over every
(ray, triangle) pair plus analytic spheres, O(R·T) memory. It is the route
of the sphere scenes (config 1) and the cluster path's sphere merge.

Return contract: (t, n_geom, mat) with t == T_FAR on a miss.
"""

from __future__ import annotations

import torch

from .. import constants as C


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def intersect_tris_brute(o, d, v0, e1, e2):
    """Möller–Trumbore over every (ray, triangle) pair → t (R, T)."""
    pvec = torch.linalg.cross(d[:, None, :].expand(-1, e2.shape[0], -1),
                              e2[None, :, :].expand(d.shape[0], -1, -1))
    det = _dot(e1[None, :, :], pvec)
    safe = torch.where(det == 0, 1.0, det)
    inv = torch.where(det.abs() > C.DET_EPS, 1.0 / safe, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    uu = _dot(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e1[None, :, :].expand_as(tvec))
    vv = _dot(d[:, None, :], qvec) * inv
    t = _dot(e2[None, :, :], qvec) * inv
    ok = (
        (det.abs() > C.DET_EPS)
        & (uu >= 0.0)
        & (vv >= 0.0)
        & (uu + vv <= 1.0)
        & (t > C.T_MIN)
        & (t < C.T_FAR)
    )
    return torch.where(ok, t, C.T_FAR)


def intersect_spheres(o, d, c, r):
    """Analytic sphere hits → t (R, S)."""
    oc = o[:, None, :] - c[None, :, :]
    b = _dot(oc, d[:, None, :])
    c0 = _dot(oc, oc) - (r**2)[None, :]
    disc = b * b - c0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > C.T_MIN, t0, t1)
    ok = (disc > 0.0) & (t > C.T_MIN) & (t < C.T_FAR)
    return torch.where(ok, t, C.T_FAR)


def merge_spheres(geom, o, d, t_best, n_best, m_best):
    """Closest of the given hit and the scene's spheres (no-op without)."""
    if geom.sph_c.shape[0] == 0:
        return t_best, n_best, m_best
    ts = intersect_spheres(o, d, geom.sph_c, geom.sph_r)
    sv, si = ts.min(dim=1)
    better = sv < t_best
    p = o + sv[:, None] * d
    ns = (p - geom.sph_c[si]) / geom.sph_r[si][:, None]
    t_best = torch.where(better, sv, t_best)
    n_best = torch.where(better[:, None], ns, n_best)
    m_best = torch.where(better, geom.sph_mat[si], m_best)
    return t_best, n_best, m_best


def brute(geom, o, d):
    """Closest hit over all triangles + spheres."""
    R = o.shape[0]
    t_best = torch.full((R,), C.T_FAR, dtype=torch.float32, device=o.device)
    n_best = torch.zeros((R, 3), dtype=torch.float32, device=o.device)
    m_best = torch.zeros((R,), dtype=torch.int32, device=o.device)
    if geom.tri_v0.shape[0] > 0:
        tt = intersect_tris_brute(o, d, geom.tri_v0, geom.tri_e1,
                                  geom.tri_e2)
        tv, ti = tt.min(dim=1)
        better = tv < t_best
        t_best = torch.where(better, tv, t_best)
        n_best = torch.where(better[:, None], geom.tri_n[ti], n_best)
        m_best = torch.where(better, geom.tri_mat[ti], m_best)
    return merge_spheres(geom, o, d, t_best, n_best, m_best)
