"""The wavefront render loop (the reference's ``engine/wavefront.py``).

The whole ray batch advances bounce by bounce in lockstep stages —
intersect, shade, NEE shadow batch, scatter, roulette, coherence sort — each
a batch of PyTorch ops on the scene's device. Stage order and arithmetic
follow the reference statement for statement, so fixed-seed renders agree
with it to f32 tolerance; all randomness keys off absolute pixel ids, so
any split or permutation of the pixel set gives the same per-pixel values.

Materials follow the DIFF/SPEC/REFR palette (constants.MAT_*): Lambertian
vertices use NEE + cosine sampling; mirror and dielectric vertices are
delta lobes (no NEE; the next emissive hit is credited directly). All lanes
compute all three lobes and select by material type.

Gradients flow to the materials (albedo, emission) under the reference's
detach policy (diff/render.py): the intersection is a no-gradient boundary
(its kernels return none, its outputs t and n_geom are detached, and its
inputs are detached so that its glue records no graph); the MIS weights,
the NEE geometric term and the roulette probability are detached too. The
forward-only entry points, render and render_accumulate, run trace_sample
under ``torch.inference_mode()`` and so build no graph.
"""

from __future__ import annotations

import math
import warnings

import torch

from .. import constants as C
from ..config import RenderConfig
from ..sampling import rng as rng_mod
from ..scene.model import Scene
from . import intersect as isect
from ..utils.profiling import span
from .camera import camera_rays
from .shading import (
    cosine_hemisphere,
    dot3,
    norm3,
    reflect,
    refract_dir,
    sample_light,
    schlick,
    take_rows,
)


def _stream_hit():
    from ..ops.intersect_stream import closest_hit_stream

    def hit(g, o, d, t_max=None, sparse_hint=False):
        return closest_hit_stream(g, o, d, t_max=t_max)

    hit.impl = "stream"
    return hit


def _grid_hit():
    from ..ops import intersect_grid

    def hit(g, o, d, t_max=None, sparse_hint=False):
        # Ladder-only mode (no full-width stage A) where most lanes are dead.
        return intersect_grid.closest_hit_grid(
            g, o, d, t_max=t_max,
            first_steps=0 if sparse_hint else intersect_grid.FIRST_STEPS)

    hit.impl = "grid"
    return hit


def _intersector(geom, cfg: RenderConfig):
    """The closest-hit function for this scene and config.

    Every route has the signature hit(g, o, d, t_max=None,
    sparse_hint=False); `hit.impl` names it. t_max is the shadow bound
    (hits at t >= t_max may read as misses); sparse_hint marks calls where
    most lanes are dead, which only the grid route reads. Routes:
    "grid" with grid tables takes ops/intersect_grid.py; "stream" with
    cluster tables takes ops/intersect_stream.py; "cluster" takes
    ops/intersect_cluster.py when its table is within the cluster route's
    bound, else the grid when the scene has grid tables (the accel/auto.py
    route), else the stream route with a warning, as in the reference.
    Otherwise, with use_bvh and a BVH, "jnp" and "pallas" (and a backend
    whose tables are missing) take the BVH walk of ops/traverse_bvh.py,
    which is handed t_max and does not use it yet (its walk runs to the
    closest hit, as the reference's walks do); without a BVH, brute
    force. Unlike the reference, "grid" without grid tables and "stream"
    without cluster tables raise instead of falling through.
    """
    has_grid = geom.gr_cell_start.shape[0] > 1
    has_clusters = geom.cl_lo.shape[0] > 0
    if cfg.backend == "grid":
        if not has_grid:
            raise ValueError('backend="grid" needs grid tables: build the '
                             "scene with accel.auto.prepare_accel (or "
                             "accel.grid.with_grid)")
        return _grid_hit()
    if cfg.backend == "stream":
        if not has_clusters:
            raise ValueError('backend="stream" needs cluster tables: build '
                             "the scene with accel.auto.prepare_accel (or "
                             "accel.clusters.with_clusters)")
        return _stream_hit()
    if cfg.backend == "cluster" and has_clusters:
        from ..ops.intersect_cluster import (
            closest_hit_cluster,
            routes_to_cluster,
        )

        if not routes_to_cluster(int(geom.cl_lo.shape[0])):
            if has_grid:
                return _grid_hit()
            warnings.warn(
                "the cluster table is above the cluster route's bound and "
                "no grid tables are present; falling back to the stream "
                "route (much slower than the grid on large scenes). Build "
                "the scene with accel.auto.prepare_accel (or "
                "accel.grid.with_grid) to get the grid route.",
                stacklevel=2,
            )
            return _stream_hit()

        def hit(g, o, d, t_max=None, sparse_hint=False):
            return closest_hit_cluster(g, o, d, t_max=t_max)

        hit.impl = "cluster"
        return hit
    if cfg.use_bvh and geom.bvh_lo.shape[0] > 0:
        from ..ops.traverse_bvh import closest_hit_bvh

        def hit(g, o, d, t_max=None, sparse_hint=False):
            return closest_hit_bvh(g, o, d, t_max=t_max)

        hit.impl = "pallas" if cfg.backend == "pallas" else "bvh"
        return hit

    def hit(g, o, d, t_max=None, sparse_hint=False):
        return isect.brute(g, o, d)

    hit.impl = "brute"
    return hit


# Direction of masked-out lanes: with o=0 and t_max=T_MIN such a ray does
# no walk work.
_CANON_DIR = (0.0, 0.0, 1.0)


def _coherence_key(o, d, alive, scene_lo, scene_hi):
    """Sort key for stream compaction + ray coherence.

    Dead rays sort to the tail; live rays group by a 64-bin direction
    morton (2 bits/axis of d) then a 4096-cell position morton (4 bits/axis
    of o). The key only orders work: the final unscramble restores caller
    order exactly.
    """
    q = torch.clamp((o - scene_lo[None, :]) / (scene_hi - scene_lo)[None, :],
                    0.0, 0.999)
    cell = (q * 16.0).to(torch.int32)
    morton = torch.zeros_like(cell[:, 0])
    for b in range(4):
        for ax in range(3):
            morton = morton | (((cell[:, ax] >> b) & 1) << (3 * b + ax))
    dq = torch.clamp(((d + 1.0) * 2.0).to(torch.int32), 0, 3)
    dmort = torch.zeros_like(dq[:, 0])
    for b in range(2):
        for ax in range(3):
            dmort = dmort | (((dq[:, ax] >> b) & 1) << (3 * b + ax))
    key = (dmort << 12) | morton
    return torch.where(alive, key, 1 << 30)


def compact_rays(o, d, radiance, throughput, pixel_ids, slot, alive,
                 spec_chain, prev_pdf, scene_lo, scene_hi):
    """Stream compaction + coherence sort of the wavefront's state.

    The rays are reordered by a stable sort on _coherence_key (dead rays
    to the tail) and returned in the argument order: (o, d, radiance,
    throughput, pixel_ids, slot, alive, spec_chain, prev_pdf). `slot`
    carries each ray's original buffer slot, for the final unscramble.
    """
    key = _coherence_key(o, d, alive, scene_lo, scene_hi)
    perm = torch.argsort(key, stable=True)
    # One (N, 16) row gather of the packed state; ints ride as bit-cast f32
    # columns, so the permuted values are exact.
    flags = alive.to(torch.float32) * 2.0 + spec_chain.to(torch.float32)
    pid32 = pixel_ids.to(torch.int32)  # wraps ids >= 2^31
    state = torch.cat([
        o, d, radiance, throughput,
        pid32.view(torch.float32)[:, None],
        slot.view(torch.float32)[:, None],
        flags[:, None], prev_pdf[:, None],
    ], dim=1)[perm]
    pixel_ids = state[:, 12].contiguous().view(torch.int32) \
        .to(torch.int64) & 0xFFFFFFFF
    slot = state[:, 13].contiguous().view(torch.int32)
    fl = state[:, 14]
    return (state[:, 0:3], state[:, 3:6], state[:, 6:9], state[:, 9:12],
            pixel_ids, slot, fl >= 2.0, (fl == 1.0) | (fl == 3.0),
            state[:, 15])


def _material_rows(geometry, materials) -> torch.Tensor:
    """(n_rows, 16) joined rows [albedo(3), emission(3), mat_type, ior,
    pad(8)] spanning the larger of the Materials and structural tables;
    missing structural rows get MAT_DIFF / ior 1.5, missing Materials rows
    repeat the last row (the reference's clamp semantics)."""
    albedo, emission = materials.albedo, materials.emission
    dev = albedo.device
    M = albedo.shape[0]
    mt_tab = geometry.mat_type.to(torch.float32)
    ior_tab = geometry.mat_ior.to(torch.float32)
    n_rows = max(M, int(mt_tab.shape[0]), int(ior_tab.shape[0]))
    mt_tab = torch.cat([mt_tab, mt_tab.new_zeros(n_rows - mt_tab.shape[0])])
    ior_tab = torch.cat([ior_tab,
                         ior_tab.new_full((n_rows - ior_tab.shape[0],), 1.5)])
    albedo = torch.cat([albedo, albedo[-1:].expand(n_rows - M, 3)])
    emission = torch.cat([emission, emission[-1:].expand(n_rows - M, 3)])
    return torch.cat([
        albedo, emission, mt_tab[:, None], ior_tab[:, None],
        torch.zeros((n_rows, 8), dtype=torch.float32, device=dev),
    ], dim=1)


def trace_sample(geometry, materials, camera, lights, cfg: RenderConfig,
                 pixel_ids: torch.Tensor, spp_idx: int,
                 with_stats: bool = False):
    """Trace one path per pixel id; returns (N, 3) radiance.

    pixel_ids: (N,) absolute row-major ids on the scene's device.
    with_stats=True also returns the number of useful rays traced (live
    path segments + candidate shadow rays) as a 0-d int64 tensor — the
    numerator of the rays/s metric, excluding dead lanes.
    """
    with span("frame", spp_idx):
        return _trace_sample(geometry, materials, camera, lights, cfg,
                             pixel_ids, spp_idx, with_stats)


def _trace_sample(geometry, materials, camera, lights, cfg, pixel_ids,
                  spp_idx, with_stats):
    intersect = _intersector(geometry, cfg)
    dev = pixel_ids.device
    pixel_ids = pixel_ids.to(torch.int64)
    emission = materials.emission
    mat_rows = _material_rows(geometry, materials)
    bg = lights.background
    n_lights = lights.tri_idx.shape[0] + lights.sph_idx.shape[0]
    total_area = lights.total_area
    N = pixel_ids.shape[0]
    canon = torch.tensor(_CANON_DIR, dtype=torch.float32, device=dev)

    jitter = rng_mod.pixel_jitter(cfg.seed, spp_idx, pixel_ids)
    o, d = camera_rays(camera, cfg.width, cfg.height, jitter, pixel_ids)

    radiance = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((N, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    # True when the previous scatter was a delta lobe (or the camera ray):
    # such hits see emission directly; diffuse-scattered hits rely on NEE.
    spec_chain = torch.ones((N,), dtype=torch.bool, device=dev)
    # Solid-angle pdf of the previous diffuse scatter (MIS bookkeeping).
    prev_pdf = torch.zeros((N,), dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    # Original buffer slot of each ray (for unscrambling after compaction).
    slot = torch.arange(N, dtype=torch.int32, device=dev)
    if cfg.compact:
        if geometry.bvh_lo.shape[0] > 0:
            scene_lo, scene_hi = geometry.bvh_lo[0], geometry.bvh_hi[0]
        else:
            scene_lo = geometry.tri_v0.min(dim=0).values
            scene_hi = geometry.tri_v0.max(dim=0).values

    for bounce in range(cfg.max_depth):
        with span("bounce", bounce):
            n_rays = n_rays + alive.sum()
            U = rng_mod.bounce_uniforms(cfg.seed, spp_idx, bounce, pixel_ids)
            # Dead lanes become zero-work point rays; their results are never
            # used (every radiance term is masked by `alive`).
            o_q = torch.where(alive[:, None], o, 0.0)
            d_q = torch.where(alive[:, None], d, canon)
            t_cap = torch.where(alive, C.T_FAR, C.T_MIN)
            # Late bounces are mostly dead lanes (misses, roulette): there the
            # grid route skips its full-width first phase (the reference's
            # choice of bounce >= 3).
            sparse = bounce >= 3
            with span("query", "hit"):
                t, n_geom, mat = intersect(geometry, o_q.detach(),
                                           d_q.detach(), t_max=t_cap,
                                           sparse_hint=sparse)
            # Detach geometry: grads flow only through the shading chain.
            t = t.detach()
            n_geom = n_geom.detach()
            hit = t < C.T_FAR
            mrow = take_rows(mat_rows, mat)
            alb_m = mrow[:, 0:3]
            emis_m = mrow[:, 3:6]

            miss = alive & ~hit
            radiance = radiance + torch.where(
                miss[:, None], throughput * bg[None, :], 0.0)

            cos_in = -dot3(n_geom, d)
            if cfg.mis and n_lights > 0:
                # Every front-face emissive hit counts; diffuse-reached ones
                # carry the power-heuristic weight vs the NEE pdf of the same
                # light point. Miss lanes' t (T_FAR) would overflow when
                # squared; their weight is never used.
                t_eff = torch.where(hit, t, 1.0)
                p_nee = (t_eff * t_eff) / torch.clamp(cos_in * total_area,
                                                      min=1e-12)
                w_b = (prev_pdf * prev_pdf) / torch.clamp(
                    prev_pdf * prev_pdf + p_nee * p_nee, min=1e-20)
                w_emit = torch.where(spec_chain, 1.0, w_b).detach()
                prim = alive & hit & (cos_in > 0.0)
                radiance = radiance + torch.where(
                    prim[:, None], throughput * emis_m * w_emit[:, None], 0.0)
            else:
                prim = alive & hit & (cos_in > 0.0) & spec_chain
                radiance = radiance + torch.where(
                    prim[:, None], throughput * emis_m, 0.0)

            alive = alive & hit
            p = o + t[:, None] * d
            n_shade = n_geom * torch.where(cos_in > 0.0, 1.0, -1.0)[:, None]
            mt = mrow[:, 6].to(torch.int32)
            is_diff = mt == C.MAT_DIFF
            is_refr = mt == C.MAT_REFR

            # --- Next-event estimation (one shadow ray per path vertex) ----
            if n_lights > 0:
                x_l, n_l, _, emis_l = sample_light(
                    lights, geometry, U[:, rng_mod.LIGHT_SEL],
                    U[:, rng_mod.LIGHT_U1], U[:, rng_mod.LIGHT_U2], emission,
                )
                o_sh = p + n_shade * C.RAY_OFFSET
                dvec = x_l - o_sh
                dist = norm3(dvec)
                wi = dvec / torch.clamp(dist, min=1e-20)[:, None]
                cos_s = dot3(n_shade, wi)
                cos_l = -dot3(n_l, wi)
                cand = alive & is_diff & (cos_s > 0.0) & (cos_l > 0.0)
                n_rays = n_rays + cand.sum()
                # The shadow query carries its distance bound; non-candidate
                # lanes become zero-work point rays (their visibility is
                # never read).
                o_shq = torch.where(cand[:, None], o_sh, 0.0)
                wi_q = torch.where(cand[:, None], wi, canon)
                t_sh_cap = torch.where(cand, dist, C.T_MIN)
                with span("query", "shadow"):
                    t_sh, _, _ = intersect(geometry, o_shq.detach(),
                                           wi_q.detach(),
                                           t_max=t_sh_cap.detach(),
                                           sparse_hint=sparse)
                vis = t_sh >= dist * (1.0 - C.SHADOW_REL_EPS)
                geo_term = (cos_s * cos_l * total_area
                            / torch.clamp(dist * dist, min=1e-12))
                if cfg.mis and bounce + 1 < cfg.max_depth:
                    # Power heuristic vs the cosine-BSDF pdf; the last vertex
                    # keeps w=1 (BSDF counterpart truncated by max_depth).
                    p_l = (dist * dist) / torch.clamp(cos_l * total_area,
                                                      min=1e-12)
                    p_b = cos_s / math.pi
                    w_nee = (p_l * p_l) / torch.clamp(p_l * p_l + p_b * p_b,
                                                      min=1e-20)
                    geo_term = geo_term * w_nee
                # Only candidate lanes read contrib. Elsewhere dist² may
                # overflow, making w_nee inf/inf = NaN, and the zero cotangent
                # the masking where sends back times that NaN is NaN: zero the
                # term there (the forward result is unchanged).
                geo_term = torch.where(cand, geo_term, 0.0)
                contrib = throughput * (alb_m / math.pi) * emis_l \
                    * geo_term.detach()[:, None]
                radiance = radiance + torch.where(
                    (cand & vis)[:, None], contrib, 0.0)

            if bounce + 1 >= cfg.max_depth:
                break

            # --- Scatter: DIFF cosine hemisphere, SPEC mirror, REFR Schlick
            # Fresnel reflect/refract with total internal reflection ---------
            d_diff = cosine_hemisphere(
                n_shade, U[:, rng_mod.BSDF_U1], U[:, rng_mod.BSDF_U2])
            cos_o = torch.clamp(
                cos_in * torch.where(cos_in > 0.0, 1.0, -1.0), min=0.0)
            d_refl = reflect(d, n_shade, cos_o)
            entering = cos_in > 0.0
            ior = mrow[:, 7]
            eta = torch.where(entering, 1.0 / ior, ior)
            d_refr, tir = refract_dir(d, n_shade, cos_o, eta)
            cos_x = torch.where(entering, cos_o, dot3(d_refr, n_geom))
            fres = schlick(cos_x, ior)
            do_reflect = tir | (U[:, rng_mod.FRESNEL_U] < fres)
            d_glass = torch.where(do_reflect[:, None], d_refl, d_refr)
            transmit = is_refr & ~do_reflect

            new_d = torch.where(
                is_diff[:, None], d_diff,
                torch.where(is_refr[:, None], d_glass, d_refl))
            throughput = throughput * alb_m
            off = torch.where(transmit, -C.RAY_OFFSET, C.RAY_OFFSET)
            o = p + n_shade * off[:, None]
            d = new_d
            spec_chain = ~is_diff
            prev_pdf = torch.where(
                is_diff, torch.clamp(dot3(n_shade, d), min=0.0) / math.pi, 0.0)

            # --- Russian roulette ------------------------------------------
            if bounce >= cfg.rr_start:
                pcont = torch.clamp(throughput.max(dim=-1).values,
                                    C.RR_CLAMP_LO, C.RR_CLAMP_HI).detach()
                kill = U[:, rng_mod.RR_U] >= pcont
                alive = alive & ~kill
                throughput = torch.where(
                    alive[:, None], throughput / pcont[:, None], throughput)

            # --- Stream compaction / coherence sort ------------------------
            if cfg.compact:
                with span("compact"):
                    (o, d, radiance, throughput, pixel_ids, slot, alive,
                     spec_chain, prev_pdf) = compact_rays(
                        o, d, radiance, throughput, pixel_ids, slot, alive,
                        spec_chain, prev_pdf, scene_lo, scene_hi)

    if cfg.compact and cfg.max_depth > 1:
        # Unscramble to the caller's ray order: `slot` is a permutation of
        # arange(N), so this scatter is its exact inverse.
        out = torch.empty_like(radiance)
        out[slot.to(torch.int64)] = radiance
        radiance = out

    if with_stats:
        return radiance, n_rays
    return radiance


@torch.inference_mode()
def render_accumulate(scene: Scene, cfg: RenderConfig, materials=None,
                      spp_start: int = 0, n_spp: int | None = None,
                      pixel_ids: torch.Tensor | None = None):
    """Sum of n_spp samples starting at spp_start, as a flat (N, 3) tensor,
    on the scene's device, over `pixel_ids` (absolute row-major ids on that
    device; default all cfg.n_pixels in order). Chunks at different
    spp_start values add up to the all-at-once render because samples are
    keyed by spp index; any split of the ids gives the same per-pixel sums
    because they are keyed by pixel id."""
    mats = materials if materials is not None else scene.materials
    if n_spp is None:
        n_spp = cfg.spp
    dev = scene.geometry.tri_v0.device
    if pixel_ids is None:
        pixel_ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=dev)
    args = (scene.geometry, mats, scene.camera, scene.lights, cfg,
            pixel_ids)
    if n_spp == 1:
        return trace_sample(*args, spp_start)
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                      device=dev)
    for i in range(n_spp):
        acc = acc + trace_sample(*args, spp_start + i)
    return acc


@torch.inference_mode()
def render(scene: Scene, cfg: RenderConfig, materials=None):
    """Full render → (height, width, 3) float32 linear-radiance image, on
    the scene's device."""
    chunk = cfg.spp_chunk if cfg.spp_chunk > 0 else cfg.spp
    chunk = min(chunk, cfg.spp)
    acc = None
    s = 0
    while s < cfg.spp:
        n = min(chunk, cfg.spp - s)
        part = render_accumulate(scene, cfg, materials, spp_start=s, n_spp=n)
        acc = part if acc is None else acc + part
        s += n
    img = acc / float(cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)
