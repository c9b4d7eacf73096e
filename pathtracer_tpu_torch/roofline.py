"""The bound arithmetic of every kernel, and the bench band's passes (the
counterpart of the reference's ``scripts/roofline.py``).

The bound of a call is the larger of two times: the bytes it must move
(each input read once, each output written once; of a cluster table only
the distinct clusters its blocks walked) at the card's memory rate, and
its operations at the card's peak rate for their type. For K1-K3 the
operations are the split product's: per (ray, triangle) test 240 bf16
tensor-core operations and 6 f32 ones in the epilogue, counted on the
tests the warps computed (a warp visit that the box skip drops does no
test). This module is the one home of that arithmetic: chip_smoke.py
imports it for the bounds beside its checked kernel calls.

:func:`band_passes` rebuilds the bench band's three passes with the
engine's own functions: the primary rays in tile order
(engine/camera.py:tiled_pixel_ids); bounce 1, cosine-sampled from the
primary hits (engine/shading.py:cosine_hemisphere) and sorted by the
engine's coherence key (engine/wavefront.py:_coherence_key); and shadow 1,
from the same sorted vertices towards a light sample
(engine/shading.py:sample_light), each capped at its light's distance.
grid_profile.py times the grid query on them (:func:`best_ms`).

K1's share of its roofline in a real frame is the benchmark's
``k1_roofline_pct`` (``python3 ptbench/run.py --workload bench.render
--trace 1``).
"""

from __future__ import annotations

import torch

from . import constants as C
from .engine import wavefront
from .engine.camera import camera_rays, tiled_pixel_ids
from .engine.shading import cosine_hemisphere, dot3, norm3, sample_light
from .ops import intersect_cluster as ic
from .sampling import rng as rng_mod

# The card's peak rates (NVIDIA's H100 SXM data sheet, dense): f32 on the
# CUDA cores (an FMA counted as two), bf16 on the tensor cores, HBM.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# f32 operations per (ray, triangle) test in the f32 form (visit_plain's
# product on the CUDA cores, the port's cluster kernel before the tensor
# cores): the four feature dot products (40 multiplies + 36 adds), four
# sign multiplies, u + v and |det| * T_MIN (compares and selects not
# counted).
OPS_PER_TRI_TEST = 82
# The same test in visit_mma.cuh's form: the four split products, 30 bf16
# multiply-adds each, on the tensor cores, and the epilogue's 6 f32
# operations (four sign multiplies, u + v, |det| * T_MIN) on the CUDA cores.
TC_OPS_PER_TRI_TEST = 4 * 30 * 2
EPILOGUE_OPS_PER_TRI_TEST = 6
# f32 operations per box test of traverse_bvh.cu (two per pair entry the
# walk fetches: entry 0 tests the root and a box no ray hits): two slab
# differences and products per axis (12), their min and max (6), the
# entry/exit reductions (4) and two compares.
OPS_PER_NODE = 24
# f32 operations per Moller-Trumbore test of traverse_bvh.cu:tri_test:
# three cross terms for pvec (9), det (5), its reciprocal (1), tvec (3),
# u (5 + 1), three cross terms for qvec (9), v (5 + 1), t (5 + 1) and
# u + v (1); compares not counted.
OPS_PER_MT_TEST = 46
# The rate at which int32 instructions can issue: each of an SM's four
# schedulers issues one warp instruction (32 lanes) a clock, on 132 SMs at
# the 1.98 GHz boost clock (NVIDIA's Hopper white paper). The INT32 pipe
# alone has half of it (64 lanes an SM), but adds also issue to the FP32
# pipe as IMAD, so only the issue rate bounds a mix of adds, shifts and
# xors from below.
PEAK_INT32_ISSUE = 132 * 128 * 1.98e9
# int32 operations per Threefry-2x32 block of threefry.cu: 20 rounds of an
# add, a rotate (one funnel shift) and a xor, the key's two first adds and
# five injections of two adds each (the round constant folded into the key
# word once per key) ...
OPS_PER_THREEFRY = 72
# ... and per draw: the xor of the two output words, the shift and the or
# of the mantissa fill, and the subtraction of 1.0.
OPS_PER_DRAW = 4
DEFAULT_RAYS = 262144  # the reference's rays per call


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def new_bound() -> dict:
    """A bound total: its bytes' and operations' times and their larger,
    summed over the calls add_bound / add_split_bound add."""
    return {"bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}


def add_bound(out, n_bytes, n_ops, peak=PEAK_F32) -> float:
    """Adds one call's bound to out: the larger of its bytes (each input
    read once, each output written once) over the memory rate and its
    operations over `peak`; returns it in ms."""
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = n_ops / peak * 1e3
    out["bytes_ms"] += bytes_ms
    out["ops_ms"] += ops_ms
    out["bound_ms"] += max(bytes_ms, ops_ms)
    return max(bytes_ms, ops_ms)


def sampler_work(n_ids: int, n: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one sampler call of n draws per id:
    each 8-byte id read once and each f32 draw written once; per id the
    key's threefry block and one per draw."""
    return (n_ids * (8 + 4 * n),
            n_ids * ((1 + n) * OPS_PER_THREEFRY + n * OPS_PER_DRAW))


def tri_tests(visits, rays_per_block) -> int:
    """(ray, triangle) tests of visits (per block) cluster visits of
    rays_per_block rays (a tensor or an int per block) x 128 triangles."""
    return int((visits.to(torch.int64) * rays_per_block).sum()) \
        * ic.CLUSTER_TRIS


def warp_tests(warp_visits) -> int:
    """(ray, triangle) tests the walk kernels' (K1, K3) warps computed:
    warp visits x 64 rays x 128 triangles. A warp visit the box skip drops
    does no test, so it is no work of the bound."""
    return int(warp_visits.to(torch.int64).sum()) * ic.WARP_RAYS \
        * ic.CLUSTER_TRIS


def split_ops_ms(tests) -> float:
    """The least time of the operations of `tests` (ray, triangle) tests in
    visit_mma.cuh's form: the split products at the bf16 tensor rate or the
    epilogue at the f32 rate, whichever is longer."""
    return max(tests * TC_OPS_PER_TRI_TEST / PEAK_BF16,
               tests * EPILOGUE_OPS_PER_TRI_TEST / PEAK_F32) * 1e3


def split_bytes(feat_split, visited) -> int:
    """Bytes of the split table's clusters among the ids `visited`: each
    distinct cluster read once, the clusters no block visits not at all."""
    return int(torch.unique(visited).numel()) * nbytes(feat_split[0])


def add_split_bound(out, n_bytes, tests) -> tuple:
    """Adds one call of a split kernel (K1-K3) to out at its bound in
    visit_mma.cuh's form; returns that bound and the same tests' bound in
    the f32 form (82 f32 operations per test), in ms."""
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = split_ops_ms(tests)
    out["bytes_ms"] += bytes_ms
    out["ops_ms"] += ops_ms
    out["bound_ms"] += max(bytes_ms, ops_ms)
    return (max(bytes_ms, ops_ms),
            max(bytes_ms, tests * OPS_PER_TRI_TEST / PEAK_F32 * 1e3))


def reference_work_ms(n_bytes, visits) -> float:
    """The bound in visit_mma.cuh's form on the reference's work, which the
    box skip does not cut: every block visit x 512 rays x 128 triangles."""
    return max(n_bytes / PEAK_BYTES * 1e3,
               split_ops_ms(tri_tests(visits, ic.RAY_BLOCK)))


def k1_bytes(args, outs) -> int:
    """Bytes of one cluster_hit call: its inputs but the table and its
    outputs once each, and the split table's clusters its blocks walked,
    each distinct cluster once."""
    cand, count, tnear, rayf, feat, box_lo, box_hi = args
    walked = torch.arange(cand.shape[1], device=cand.device)[None, :] \
        < outs[2][:, None]
    return nbytes(cand, count, tnear, rayf, box_lo, box_hi, *outs) \
        + split_bytes(feat, cand[walked])


def k4_bytes(g, seen, *arrays) -> int:
    """Bytes of one bvh_hit call: the distinct pair entries and triangles
    its walks read (`seen`, from bvh_hit_ordered_plain), once each, and the
    rays and outputs."""
    return (int(seen[0].sum()) * nbytes(g.bvh_pairs[0])
            + int(seen[1].sum()) * nbytes(g.bvh_tris[0]) + nbytes(*arrays))


def band_passes(scene, cfg, n_rays: int, device) -> list:
    """The bench band's three passes over its first n_rays tile-ordered
    pixels, as (name, o, d, t_max): the primary rays (t_max T_FAR); bounce
    1, cosine-sampled at the primary hits (the scene's own intersector)
    and sorted by the engine's coherence key, dead lanes as zero-work
    point rays (t_max T_MIN); and shadow 1, from the same sorted vertices
    to a light sample of bounce 0's draws, capped at its distance."""
    g = scene.geometry
    hit = wavefront._intersector(g, cfg)
    ids = tiled_pixel_ids(0, n_rays, cfg.width, device=device)
    jitter = rng_mod.pixel_jitter(cfg.seed, 0, ids)
    o0, d0 = camera_rays(scene.camera, cfg.width, cfg.height, jitter, ids)
    tm0 = torch.full((n_rays,), C.T_FAR, dtype=torch.float32, device=device)
    t0, n0, _ = hit(g, o0, d0, t_max=tm0)
    alive = t0 < C.T_FAR
    cos_in = -dot3(n0, d0)
    n_shade = n0 * torch.where(cos_in > 0.0, 1.0, -1.0)[:, None]
    U = rng_mod.bounce_uniforms(cfg.seed, 0, 0, ids)
    d1 = cosine_hemisphere(n_shade, U[:, rng_mod.BSDF_U1],
                           U[:, rng_mod.BSDF_U2])
    o1 = o0 + t0[:, None] * d0 + n_shade * C.RAY_OFFSET
    if g.bvh_lo.shape[0] > 0:
        lo, hi = g.bvh_lo[0], g.bvh_hi[0]
    else:
        lo, hi = g.tri_v0.min(dim=0).values, g.tri_v0.max(dim=0).values
    perm = torch.argsort(wavefront._coherence_key(o1, d1, alive, lo, hi),
                         stable=True)
    o1s, d1s, live = o1[perm], d1[perm], alive[perm]
    x_l = sample_light(scene.lights, g, U[:, rng_mod.LIGHT_SEL],
                       U[:, rng_mod.LIGHT_U1], U[:, rng_mod.LIGHT_U2],
                       scene.materials.emission)[0][perm]
    dvec = x_l - o1s
    dist = norm3(dvec)
    wi = dvec / torch.clamp(dist, min=1e-20)[:, None]
    canon = torch.tensor(wavefront._CANON_DIR, dtype=torch.float32,
                         device=device)

    def query(d, t_max):
        return (torch.where(live[:, None], o1s, 0.0),
                torch.where(live[:, None], d, canon),
                torch.where(live, t_max, C.T_MIN))

    return [("primary (tiled)", o0, d0, tm0),
            ("bounce 1 (sorted)", *query(d1s, tm0)),
            ("shadow 1 (sorted, capped)", *query(wi, dist))]


def best_ms(fn, reps: int) -> float:
    """The least milliseconds of fn() over reps runs (CUDA events around
    each), after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)
