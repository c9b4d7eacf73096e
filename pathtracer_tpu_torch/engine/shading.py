"""Shading and sampling, elementwise over the ray batch (the reference's
``engine/shading.py``).

Dot products and norms are written out per component (``dot3``), so a
ray's arithmetic never depends on where it sits in the batch: the
compacted render then equals the plain one bit for bit.
"""

from __future__ import annotations

import math

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def norm3(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(a, a))


# Differentiable tables of at most this many rows take the scatter-free
# transpose of _SmallRows; larger ones the gather's own backward (the
# reference's take_small_rows threshold).
_SMALL_ROWS = 32


class _SmallRows(torch.autograd.Function):
    """rows[clamp(eff)] whose backward is one masked sum of the cotangent per
    row, the reference's scatter-free transpose, instead of the gather's
    accumulating index_put: on the card that sorts a million ids into a
    handful of rows and adds each row's long run of duplicates serially."""

    @staticmethod
    def forward(ctx, rows, eff):
        ctx.save_for_backward(eff)
        ctx.n_rows = rows.shape[0]
        return rows[eff.clamp(0, rows.shape[0] - 1)]

    @staticmethod
    def backward(ctx, g):
        (eff,) = ctx.saved_tensors
        shape = eff.shape + (1,) * (g.dim() - eff.dim())
        d_rows = torch.stack([
            torch.where((eff == m).reshape(shape), g, 0.0).sum(dim=0)
            for m in range(ctx.n_rows)
        ])
        return d_rows, None


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[idx] with JAX gather semantics in both directions (the
    reference's take_small_rows). Forward: negative ids wrap once, then
    every id is clamped into range (torch would raise). Backward: a wrapped
    id credits its row, an id still out of range after the wrap credits
    nothing (JAX's scatter drops it; a clamped torch gather would credit
    the edge row); tables of up to _SMALL_ROWS rows take the scatter-free
    transpose."""
    L = rows.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + L, idx)
    if rows.requires_grad and L <= _SMALL_ROWS:
        return _SmallRows.apply(rows, idx)
    out = rows[idx.clamp(0, L - 1)]
    if out.requires_grad:
        inside = ((idx >= 0) & (idx < L)).reshape(
            idx.shape + (1,) * (rows.dim() - 1))
        out = torch.where(inside, out, out.detach())
    return out


def onb(n):
    """Branchless Duff/Frisvad orthonormal basis; n: (R,3) unit normals."""
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=-1
    )
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return t, bt


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction about unit normal n (pdf = cos/pi)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, b = onb(n)
    d = x[:, None] * t + y[:, None] * b + z[:, None] * n
    return d / norm3(d)[:, None]


def reflect(d, n_shade, cos_o):
    """Mirror reflection of d about unit normal n_shade; cos_o = dot(n,-d)."""
    return d + 2.0 * cos_o[:, None] * n_shade


def refract_dir(d, n_shade, cos_o, eta):
    """Snell refraction of d through n_shade (normal toward the ray side).

    Returns (t_dir, tir): the unit transmitted direction (meaningless where
    tir) and the total-internal-reflection mask.
    """
    k = 1.0 - eta * eta * (1.0 - cos_o * cos_o)
    tir = k < 0.0
    t = eta[:, None] * d + (
        eta * cos_o - torch.sqrt(torch.clamp(k, min=0.0))
    )[:, None] * n_shade
    t = t / torch.clamp(norm3(t), min=1e-20)[:, None]
    return t, tir


def schlick(cos_x, ior):
    """Schlick Fresnel reflectance for a dielectric of index ior."""
    r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    return r0 + (1.0 - r0) * (1.0 - torch.clamp(cos_x, 0.0, 1.0)) ** 5


def light_rows(lights, geom, emission):
    """(L, 16) pre-joined light rows, triangle lights then sphere lights.

    Triangle rows: [v0, e1, e2, n, mat, emis]. Sphere rows:
    [center, (r,0,0), 0(3), 0(3), -(mat+1), emis]; the negated material id
    marks a sphere row. Row order matches the make_lights cdf.
    """
    lt = lights.tri_idx.to(torch.int64)
    mat_l = take_rows(geom.tri_mat, lt)
    tri_rows = torch.cat([
        geom.tri_v0[lt], geom.tri_e1[lt], geom.tri_e2[lt], geom.tri_n[lt],
        mat_l.to(torch.float32)[:, None],
        take_rows(emission, mat_l),
    ], dim=1)
    Ls = int(lights.sph_idx.shape[0])
    if Ls == 0:
        return tri_rows
    si = lights.sph_idx.to(torch.int64)
    smat = take_rows(geom.sph_mat, si)
    sph_rows = torch.cat([
        geom.sph_c[si],
        geom.sph_r[si][:, None],
        torch.zeros((Ls, 8), dtype=torch.float32, device=si.device),
        (-(smat.to(torch.float32) + 1.0))[:, None],
        take_rows(emission, smat),
    ], dim=1)
    return torch.cat([tri_rows, sph_rows], dim=0)


def sample_light(lights, geom, u_sel, u1, u2, emission):
    """Uniform-by-area point on the emissive surfaces.

    Triangles use the sqrt-barycentric warp, sphere lights uniform surface
    sampling (z = 1-2*u1, phi = 2*pi*u2) with the sampled normal as the
    light normal; the sphere branch is skipped when the scene has no sphere
    lights. Returns (x_l, n_l, mat_l, emis_l). The scene must have lights.
    """
    su = torch.sqrt(u1)
    cdf = lights.cdf
    idx = torch.clamp(torch.searchsorted(cdf, u_sel.contiguous(), right=True),
                      max=cdf.shape[0] - 1)
    rows = take_rows(light_rows(lights, geom, emission), idx)
    x_l = rows[:, 0:3] + (1.0 - su)[:, None] * rows[:, 3:6] \
        + (u2 * su)[:, None] * rows[:, 6:9]
    n_l = rows[:, 9:12]
    mat_f = rows[:, 12]
    if int(lights.sph_idx.shape[0]) > 0:
        is_sph = mat_f < 0.0
        z = 1.0 - 2.0 * u1
        phi = 2.0 * math.pi * u2
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        n_sph = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z],
                            dim=1)
        x_sph = rows[:, 0:3] + rows[:, 3:4] * n_sph
        x_l = torch.where(is_sph[:, None], x_sph, x_l)
        n_l = torch.where(is_sph[:, None], n_sph, n_l)
        mat_f = torch.where(is_sph, -mat_f - 1.0, mat_f)
    return x_l, n_l, mat_f.to(torch.int32), rows[:, 13:16]
