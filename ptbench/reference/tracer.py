"""The benchmark's plain reference of the path tracer, in PyTorch.

It renders chosen pixels of a scene from `reference/scenes.py` by the
estimator the path tracer documents: a pinhole camera ray with threefry
jitter, then per bounce the closest hit by brute force over every
triangle, emission on front faces reached by the camera, next-event
estimation (one uniform-by-area light sample, its shadow ray by brute
force), a cosine-sampled diffuse lobe (mirror and dielectric lobes too),
and Russian roulette from `rr_start`. Materials carry gradients under the
estimator's detach policy: hits, the NEE geometric term and the roulette
probability are constants.

It imports nothing of the program and reads nothing the program made. The
ray-triangle test is Moller-Trumbore written as four inner products of a
ray's features [d, o x d, o, 1] with per-triangle columns (det, u * det,
v * det, t * det), so that one matrix product per tile does the pairs;
float32 products run with TF32 off. `dtype` sets the precision of every
floating-point step (float32 for the reference; bfloat16 for the control
that the limits are set against).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry as tf

T_MIN = 1e-4
T_FAR = 1e8
DET_EPS = 1e-9
RAY_OFFSET = 1e-3
SHADOW_REL_EPS = 1e-3
RR_CLAMP_LO, RR_CLAMP_HI = 0.05, 0.95
MAT_DIFF, MAT_SPEC, MAT_REFR = 0, 1, 2

TILE_PAIRS = 1 << 23  # (ray, triangle) pairs per matrix-product tile


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Geometry:
    """A scene's triangles on `device`, as the test's feature columns in
    `dtype`, plus unit normals and material ids (float32 / int64)."""

    def __init__(self, scene: dict, device, dtype=torch.float32,
                 tile_tris: int = 1 << 16):
        _no_tf32()
        tri = scene["tri"].to(torch.float32).numpy()
        v0 = tri[:, 0]
        e1 = tri[:, 1] - v0
        e2 = tri[:, 2] - v0
        n = np.cross(e1, e2)
        unit = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                              1e-20)
        T = len(tri)
        # Rows pair with the ray features [d(3), m = o x d (3), o(3), 1].
        cols = np.zeros((4, 10, T), np.float32)
        cols[0, 0:3] = -n.T                               # det = -d.n
        cols[1, 0:3] = -np.cross(e2, v0).T                # u * det
        cols[1, 3:6] = e2.T
        cols[2, 0:3] = np.cross(e1, v0).T                 # v * det
        cols[2, 3:6] = -e1.T
        cols[3, 6:9] = n.T                                # t * det
        cols[3, 9] = -(v0 * n).sum(-1)
        cols = torch.from_numpy(cols)
        self.tile_tris = tile_tris
        self.tiles = [
            cols[:, :, s:s + tile_tris].permute(1, 0, 2).reshape(10, -1)
            .to(device=device, dtype=dtype).contiguous()
            for s in range(0, T, tile_tris)]
        self.n_tris = T
        self.normal = torch.from_numpy(unit.astype(np.float32)).to(device)
        self.v0 = torch.from_numpy(v0).to(device)
        self.e1 = torch.from_numpy(e1).to(device)
        self.e2 = torch.from_numpy(e2).to(device)
        self.mat = scene["tri_mat"].to(device=device, dtype=torch.int64)
        self.dtype = dtype
        self.device = device


def closest_hit(geo: Geometry, o, d):
    """(t float32 with T_FAR on a miss, triangle id) of each ray."""
    R = o.shape[0]
    dt = geo.dtype
    feats = torch.cat([d, torch.linalg.cross(o, d), o,
                       torch.ones_like(o[:, :1])], dim=1).to(dt)
    best_t = torch.full((R,), T_FAR, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((R,), dtype=torch.int64, device=o.device)
    rays_per_tile = max(1, TILE_PAIRS // min(geo.tile_tris, geo.n_tris))
    for r0 in range(0, R, rays_per_tile):
        f = feats[r0:r0 + rays_per_tile]
        bt = best_t[r0:r0 + rays_per_tile]
        bi = best_i[r0:r0 + rays_per_tile]
        for k, cols in enumerate(geo.tiles):
            q = (f @ cols).view(f.shape[0], 4, -1)
            det, u, v, t = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
            ok = det.abs() > DET_EPS
            inv = 1.0 / torch.where(ok, det, 1.0)
            u = u * inv
            v = v * inv
            t = t * inv
            ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
                & (t > T_MIN) & (t < T_FAR)
            val, idx = torch.where(ok, t.float(), T_FAR).min(dim=1)
            better = val < bt
            bt = torch.where(better, val, bt)
            bi = torch.where(better, idx + k * geo.tile_tris, bi)
        best_t[r0:r0 + rays_per_tile] = bt
        best_i[r0:r0 + rays_per_tile] = bi
    return best_t, best_i


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _unit(v):
    return v / torch.sqrt(_dot(v, v))[:, None]


def camera_rays(scene, width, height, jitter, ids, dt):
    pos = scene["position"].to(ids.device, dt)
    look = scene["look_at"].to(ids.device, dt)
    up = scene["up"].to(ids.device, dt)
    w = look - pos
    w = w / torch.sqrt((w * w).sum())
    u = torch.linalg.cross(up, w)
    u = u / torch.sqrt((u * u).sum())
    v = torch.linalg.cross(w, u)
    half_h = torch.tan(scene["fov_y"].to(ids.device, dt) / 2.0)
    half_w = half_h * (width / height)
    ys = ids // width
    xs = ids - ys * width
    sx = ((xs + jitter[:, 0]) / width) * 2.0 - 1.0
    sy = 1.0 - ((ys + jitter[:, 1]) / height) * 2.0
    d = w[None] + sx[:, None] * (half_w * u)[None] \
        + sy[:, None] * (half_h * v)[None]
    return pos.expand_as(d), _unit(d)


def _onb(n):
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]],
                    dim=-1)
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return t, bt


def render(geo: Geometry, scene: dict, cfg: dict, seed: int, spp_idx: int,
           ids: torch.Tensor, albedo, emission):
    """(len(ids), 3) float32 radiance of one sample of pixels `ids`.

    cfg: width, height, max_depth, rr_start (mis off). albedo, emission:
    (M, 3) float32 on the device, differentiable.
    """
    dt = geo.dtype
    dev = ids.device
    N = ids.shape[0]
    ids = ids.to(torch.int64)
    alb = albedo.to(dt)
    emis = emission.to(dt)
    mtype = scene["mat_type"].to(dev)
    mior = scene["mat_ior"].to(dev, dt)
    light_tri = scene["light_tri"].to(dev)
    cdf = scene["light_cdf"].to(dev)
    area = float(scene["light_area"])
    bg = scene["background"].to(dev, dt)

    jit = tf.uniforms(seed, spp_idx, tf.JITTER_TAG, ids, 2).to(dt)
    o, d = camera_rays(scene, cfg["width"], cfg["height"], jit, ids, dt)
    radiance = torch.zeros((N, 3), dtype=dt, device=dev)
    through = torch.ones((N, 3), dtype=dt, device=dev)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    spec_chain = torch.ones((N,), dtype=torch.bool, device=dev)

    def hit(o_, d_, mask):
        t = torch.full((N,), T_FAR, dtype=torch.float32, device=dev)
        tri = torch.zeros((N,), dtype=torch.int64, device=dev)
        sel = torch.nonzero(mask).squeeze(1)
        if sel.numel():
            t_s, i_s = closest_hit(geo, o_[sel].detach(), d_[sel].detach())
            t[sel] = t_s
            tri[sel] = i_s
        return t, tri

    for bounce in range(cfg["max_depth"]):
        U = tf.uniforms(seed, spp_idx, bounce, ids, tf.N_DRAWS)
        t, tri = hit(o, d, alive)
        is_hit = t < T_FAR
        n_geom = geo.normal[tri].to(dt)
        mat = geo.mat[tri]
        miss = alive & ~is_hit
        radiance = radiance + torch.where(miss[:, None], through * bg, 0.0)
        cos_in = -_dot(n_geom, d)
        prim = alive & is_hit & (cos_in > 0.0) & spec_chain
        radiance = radiance + torch.where(prim[:, None],
                                          through * emis[mat], 0.0)
        alive = alive & is_hit
        p = o + t.to(dt)[:, None] * d
        n_shade = n_geom * torch.where(cos_in > 0.0, 1.0, -1.0).to(dt)[:, None]
        mt = mtype[mat]
        is_diff = mt == MAT_DIFF
        is_refr = mt == MAT_REFR

        # Next-event estimation: a point on the emissive triangles,
        # uniform by area, and its shadow ray.
        u_sel = U[:, tf.LIGHT_SEL].contiguous()
        li = torch.clamp(torch.searchsorted(cdf, u_sel, right=True),
                         max=cdf.shape[0] - 1)
        lt = light_tri[li]
        su = torch.sqrt(U[:, tf.LIGHT_U1]).to(dt)
        u2 = U[:, tf.LIGHT_U2].to(dt)
        x_l = geo.v0[lt].to(dt) + (1.0 - su)[:, None] * geo.e1[lt].to(dt) \
            + (u2 * su)[:, None] * geo.e2[lt].to(dt)
        n_l = geo.normal[lt].to(dt)
        o_sh = p + n_shade * RAY_OFFSET
        dvec = x_l - o_sh
        dist = torch.sqrt(_dot(dvec, dvec))
        wi = dvec / torch.clamp(dist, min=1e-20)[:, None]
        cos_s = _dot(n_shade, wi)
        cos_l = -_dot(n_l, wi)
        cand = alive & is_diff & (cos_s > 0.0) & (cos_l > 0.0)
        t_sh, _ = hit(o_sh, wi, cand)
        vis = t_sh >= dist.float() * (1.0 - SHADOW_REL_EPS)
        geo_term = (cos_s * cos_l * area
                    / torch.clamp(dist * dist, min=1e-12)).detach()
        geo_term = torch.where(cand, geo_term, 0.0)
        contrib = through * (alb[mat] / math.pi) * emis[geo.mat[lt]] \
            * geo_term[:, None]
        radiance = radiance + torch.where((cand & vis)[:, None], contrib,
                                          0.0)
        if bounce + 1 >= cfg["max_depth"]:
            break

        # Scatter: cosine lobe, mirror, or dielectric by Schlick-Fresnel.
        r = torch.sqrt(U[:, tf.BSDF_U1]).to(dt)
        phi = (2.0 * math.pi * U[:, tf.BSDF_U2]).to(dt)
        z = torch.sqrt(torch.clamp(1.0 - U[:, tf.BSDF_U1], min=0.0)).to(dt)
        tb, bb = _onb(n_shade)
        d_diff = _unit((r * torch.cos(phi))[:, None] * tb
                       + (r * torch.sin(phi))[:, None] * bb
                       + z[:, None] * n_shade)
        cos_o = torch.clamp(
            cos_in * torch.where(cos_in > 0.0, 1.0, -1.0).to(dt), min=0.0)
        d_refl = d + 2.0 * cos_o[:, None] * n_shade
        entering = cos_in > 0.0
        ior = mior[mat]
        eta = torch.where(entering, 1.0 / ior, ior)
        k = 1.0 - eta * eta * (1.0 - cos_o * cos_o)
        tir = k < 0.0
        d_refr = eta[:, None] * d + (
            eta * cos_o - torch.sqrt(torch.clamp(k, min=0.0)))[:, None] \
            * n_shade
        d_refr = d_refr / torch.clamp(torch.sqrt(_dot(d_refr, d_refr)),
                                      min=1e-20)[:, None]
        r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        cos_x = torch.where(entering, cos_o, _dot(d_refr, n_geom))
        fres = r0 + (1.0 - r0) * (1.0 - torch.clamp(cos_x, 0.0, 1.0)) ** 5
        reflect = tir | (U[:, tf.FRESNEL_U].to(dt) < fres)
        d_glass = torch.where(reflect[:, None], d_refl, d_refr)
        transmit = is_refr & ~reflect
        new_d = torch.where(is_diff[:, None], d_diff,
                            torch.where(is_refr[:, None], d_glass, d_refl))
        through = through * alb[mat]
        off = torch.where(transmit, -RAY_OFFSET, RAY_OFFSET).to(dt)
        o = p + n_shade * off[:, None]
        d = new_d
        spec_chain = ~is_diff

        if bounce >= cfg["rr_start"]:
            pcont = torch.clamp(through.max(dim=-1).values, RR_CLAMP_LO,
                                RR_CLAMP_HI).detach()
            kill = U[:, tf.RR_U].to(dt) >= pcont
            alive = alive & ~kill
            through = torch.where(alive[:, None], through / pcont[:, None],
                                  through)
    return radiance.float()


def render_blocks(geo, scene, cfg, seed, spp_idx, ids, albedo, emission,
                  block: int = 1 << 16):
    """render() over `ids` in blocks of `block` pixels, without gradients."""
    with torch.no_grad():
        return torch.cat([
            render(geo, scene, cfg, seed, spp_idx, ids[s:s + block], albedo,
                   emission)
            for s in range(0, ids.shape[0], block)])
