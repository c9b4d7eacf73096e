"""K1's roofline on the card over the bench band's real rays, and the bound
arithmetic of every kernel (the counterpart of the reference's
``scripts/roofline.py``).

    python -m pathtracer_tpu_torch.roofline [--scene cornell_mesh]
        [--rays 262144] [--reps 6]

:func:`band_passes` rebuilds the bench band's three passes with the
engine's own functions: the primary rays in tile order
(engine/camera.py:tiled_pixel_ids); bounce 1, cosine-sampled from the
primary hits (engine/shading.py:cosine_hemisphere) and sorted by the
engine's coherence key (engine/wavefront.py:_coherence_key); and shadow 1,
from the same sorted vertices towards a light sample
(engine/shading.py:sample_light), each capped at its light's distance.
For each pass the script records the cluster_hit call that
closest_hit_cluster makes and prints K1's block and warp visits per block
(its own per-block counts), the kernel's and the whole call's
milliseconds (CUDA events, warm, the best of --reps batches of 10
back-to-back calls), the tensor-core operations of the tests the warps
computed, the achieved TFLOP/s and the bound. The card only: without CUDA
it exits.

The bound of a call is the larger of two times: the bytes it must move
(each input read once, each output written once; of a cluster table only
the distinct clusters its blocks walked) at the card's memory rate, and
its operations at the card's peak rate for their type. For K1-K3 the
operations are the split product's: per (ray, triangle) test 240 bf16
tensor-core operations and 6 f32 ones in the epilogue, counted on the
tests the warps computed (a warp visit that the box skip drops does no
test). This module is the one home of that arithmetic: chip_smoke.py
imports it.
"""

from __future__ import annotations

import argparse

import torch

from . import constants as C
from .accel.auto import prepare_accel
from .accel.build import with_bvh
from .config import PRESETS
from .engine import wavefront
from .engine.camera import camera_rays, tiled_pixel_ids
from .engine.shading import cosine_hemisphere, dot3, norm3, sample_light
from .ops import intersect_cluster as ic
from .sampling import rng as rng_mod
from .scene.builder import build_scene
from .utils.profiling import card_line

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
BATCH = 10  # back-to-back calls per timed batch of a pass


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


def cluster_call(g, o, d, t_max) -> tuple:
    """The cluster_hit arguments closest_hit_cluster builds for (o, d,
    t_max), recorded from one call."""
    calls = []
    real = ic.cluster_hit

    def recording(*args):
        calls.append(args)
        return real(*args)

    ic.cluster_hit = recording
    try:
        ic.closest_hit_cluster(g, o, d, t_max=t_max)
    finally:
        ic.cluster_hit = real
    return calls[0]


def best_ms(fn, reps: int, batch: int = 1) -> float:
    """The least mean milliseconds of fn() over reps batches of `batch`
    back-to-back runs (CUDA events around each batch), after one warm-up
    run. A batch hides the host's launch time behind the runs before it,
    which a single short call on an idle stream would count."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return min(times)


def pass_roofline(g, o, d, t_max, reps: int) -> dict:
    """K1 on one pass: its visits, times, operations and bound."""
    args = cluster_call(g, o, d, t_max)
    outs = ic.cluster_hit(*args)
    visits, warp_visits = outs[2], outs[3]
    n_bytes = k1_bytes(args, outs)
    tests = warp_tests(warp_visits)
    bound = new_bound()
    add_split_bound(bound, n_bytes, tests)
    kernel_ms = best_ms(lambda: ic.cluster_hit(*args), reps, BATCH)
    return {
        "rays": o.shape[0], "live": int((t_max > C.T_MIN).sum()),
        "blocks": args[0].shape[0],
        "visits_per_block": visits.double().mean().item(),
        "warp_visits_per_block": warp_visits.double().mean().item(),
        "tests": tests, "tc_ops": tests * TC_OPS_PER_TRI_TEST,
        "kernel_ms": kernel_ms,
        "call_ms": best_ms(lambda: ic.closest_hit_cluster(g, o, d,
                                                          t_max=t_max),
                           reps, BATCH),
        "bytes": n_bytes, "bound_ms": bound["bound_ms"],
        "bound_by": ("operations" if bound["ops_ms"] >= bound["bytes_ms"]
                     else "bytes"),
        "reference_work_ms": reference_work_ms(n_bytes, visits),
    }


def run(scene, cfg, n_rays: int, reps: int, device) -> list:
    """Prints K1's roofline over the band's passes on `scene` (on the
    card, with cluster tables); returns one dict per pass."""
    g = scene.geometry
    print(f"[roofline] scene={cfg.scene} clusters={g.cl_lo.shape[0]} "
          f"rays/call={n_rays} reps={reps} on {card_line()}")
    print(f"[roofline] {'pass':26s} {'live':>7} {'vis/blk':>8} "
          f"{'warp/blk':>8} {'K1 ms':>8} {'call ms':>8} {'TC ops':>10} "
          f"{'TFLOP/s':>8} {'%peak':>6} {'bound ms':>9} {'x bound':>8} "
          f"{'ref-work ms':>11}")
    rows = []
    for name, o, d, t_max in band_passes(scene, cfg, n_rays, device):
        r = pass_roofline(g, o, d, t_max, reps)
        tflops = r["tc_ops"] / r["kernel_ms"] / 1e9
        print(f"[roofline] {name:26s} {r['live']:7d} "
              f"{r['visits_per_block']:8.3f} "
              f"{r['warp_visits_per_block']:8.3f} {r['kernel_ms']:8.4f} "
              f"{r['call_ms']:8.4f} {r['tc_ops']:10.4g} {tflops:8.3f} "
              f"{100 * tflops * 1e12 / PEAK_BF16:5.2f}% "
              f"{r['bound_ms']:9.4f} {r['kernel_ms'] / r['bound_ms']:8.2f} "
              f"{r['reference_work_ms']:11.4f}  ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.2f} MB)")
        rows.append({"pass": name, "tflops": tflops, **r})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.roofline",
        description="K1's roofline over the bench band's passes on the "
                    "card.")
    ap.add_argument("--scene", default="cornell_mesh")
    ap.add_argument("--rays", type=int, default=DEFAULT_RAYS)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("roofline measures the card: no CUDA device")
    device = torch.device("cuda")
    cfg = PRESETS["bench"].replace(scene=args.scene)
    with torch.inference_mode():
        scene = prepare_accel(with_bvh(build_scene(cfg.scene)), cfg)
        if scene.geometry.cl_lo.shape[0] == 0:
            raise SystemExit(f"{args.scene} is above the cluster route's "
                             "bound: K1 does not run on it")
        run(scene.to(device), cfg, args.rays, args.reps, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
