"""The cluster route's split walk (ops/intersect_cluster.py:cluster_hit on
the split table) against the reference's cluster kernel, the walk kernels'
per-warp cluster-box skip in plain form against the walk without it, and
the cluster route's image against the BVH route's.

Bars: against the reference's _cluster_impl in interpret mode, hit masks
equal except where the hit lies within 2e-5 relative of the query's t
bound, and t within rtol 2e-5 (the reference reports t with its low 7
mantissa bits cleared, its 127-ulp row encoding); the skip changes no
(t, slot), bit for bit; images at the reference's own bar
(scripts/tpu_checks.py: a pixel is bad where a channel differs by more
than 5e-3 + 5e-3 |bvh|, and under 0.005 of pixels are bad).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.ops import intersect_cluster as ref_ic
from pathtracer_tpu.scene import builder as ref_builder
import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.camera import tiled_pixel_ids
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

PARTS = ("geometry", "materials", "camera", "lights")
N_RAYS = 8 * ic.RAY_BLOCK  # the reference windows its blocks 8 at a time
T_BOUND_RTOL = 2e-5  # the reference's 127-ulp encoding, relative


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def mesh_pair():
    """The bench scene (cornell_mesh with the bunny asset, 64 clusters):
    reference and port geometry."""
    ref = ref_with_clusters(ref_builder.cornell_mesh())
    return ref.geometry, _carry(ref).geometry


def _queries(g, bounded: bool):
    """The cluster route's kernel inputs for seeded rays inside the box:
    t_max the scene-box exit, or (bounded) also a seeded bound of 0.05-2,
    as a shadow query carries one."""
    rng = np.random.default_rng(31 if bounded else 30)
    o = (rng.random((N_RAYS, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = _t(o), _t(d)
    t_max = ic.exit_bound(g.cl_lo, g.cl_hi, o, d)
    if bounded:
        t_max = torch.minimum(t_max, _t(rng.uniform(0.05, 2.0, N_RAYS)
                                       .astype(np.float32)))
    extra = ic.ray_cluster_mask(g.cl_lo, g.cl_hi, o, d, t_max)
    cand, count, tnear = ic.cull_candidates(g.cl_lo, g.cl_hi, o, d,
                                            t_max=t_max, extra_mask=extra)
    return cand, count, tnear, ic.ray_features(o, d, t_max)


@pytest.mark.parametrize("bounded", [False, True], ids=["closest", "bounded"])
def test_split_walk_matches_reference_kernel(mesh_pair, bounded):
    """cluster_hit (the split plain walk on the CPU) against the
    reference's Pallas cluster kernel in interpret mode, on the same
    candidate lists and ray features."""
    ref_g, g = mesh_pair
    cand, count, tnear, rayf = _queries(g, bounded)
    t, slot, visits, _ = ic.cluster_hit(cand, count, tnear, rayf,
                                        g.cl_feat_split, g.cl_lo, g.cl_hi)
    rows16 = np.zeros((16, N_RAYS), np.float32)
    rows16[:ic.RAY_FEATS] = rayf.numpy()
    t_r, s_r = ref_ic._cluster_impl(
        jnp.asarray(cand.numpy()), jnp.asarray(count.numpy()),
        jnp.asarray(tnear.numpy()), jnp.asarray(rows16),
        jnp.asarray(ref_g.cl_feat), interpret=True)
    t, slot = t.numpy(), slot.numpy()
    t_r, s_r = np.asarray(t_r), np.asarray(s_r)
    bound = rayf[ic.RAY_FEATS - 1].numpy()
    hit, hit_r = slot >= 0, s_r >= 0
    flip = hit != hit_r
    t_hit = np.where(hit, t, t_r)
    at_bound = np.abs(t_hit - bound) <= T_BOUND_RTOL * bound
    assert not (flip & ~at_bound).any(), np.argwhere(flip & ~at_bound)
    assert 0.3 < hit_r.mean() < 1.0 and visits.sum() > 0
    both = hit & hit_r
    np.testing.assert_allclose(t[both], t_r[both], rtol=T_BOUND_RTOL,
                               atol=0.0)
    mats = g.cl_slot_nm[:, 3].numpy()
    assert (mats[slot[both]] == mats[s_r[both]]).mean() >= 0.999


def _bounce1_queries():
    """The cluster_hit inputs of bounce 1's closest-hit and shadow queries
    of a 64² bench frame (cornell_mesh, compaction: the rays are sorted by
    the coherence key, the dead ones last) and the scene's geometry."""
    cfg = pt.PRESETS["bench"].replace(width=64, height=64, max_depth=2)
    scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene)), cfg)
    calls = []
    real = ic.cluster_hit

    def recording(*args):
        calls.append(args[:4])
        return real(*args)

    ic.cluster_hit = recording
    try:
        wavefront.trace_sample(scene.geometry, scene.materials, scene.camera,
                               scene.lights, cfg,
                               tiled_pixel_ids(0, cfg.n_pixels, cfg.width), 0)
    finally:
        ic.cluster_hit = real
    assert len(calls) == 4
    return calls[2:], scene.geometry


@pytest.fixture(scope="module")
def bounce1():
    return _bounce1_queries()


@pytest.mark.parametrize("query", [0, 1], ids=["closest", "shadow"])
def test_warp_box_skip_changes_nothing(bounce1, query):
    """The per-warp cluster-box skip (warp_box_skip, walked at 64-ray
    granularity with each ray's current best t) gives the same (t, slot)
    as the walk without it, bit for bit, while it skips warp visits."""
    (queries, g) = bounce1
    cand, count, _, rayf = queries[query]
    out = []
    for boxes in (None, (g.cl_lo, g.cl_hi)):
        t = rayf[ic.RAY_FEATS - 1].clone()
        slot = torch.full_like(t, -1, dtype=torch.int32)
        visits, warp_visits = ic.walk_candidates_plain(
            cand, count, rayf, g.cl_feat_split, ic.visit_split_plain, t, slot,
            boxes=boxes)
        out.append((t, slot, visits, warp_visits))
    (t, slot, visits, full), (t_s, slot_s, visits_s, skipped) = out
    assert torch.equal(t, t_s) and torch.equal(slot, slot_s)
    assert torch.equal(visits, visits_s) and int(visits.sum()) > 0
    assert torch.equal(full, 8 * visits)
    assert 0 < int(skipped.sum()) < int(full.sum())
    assert bool((skipped <= full).all())


def test_warp_box_skip_is_the_ray_cull(mesh_pair):
    """With each ray's bound as its best t, a warp takes a cluster exactly
    when one of its rays survives ray_cluster_mask's per-ray test of that
    cluster up to the bound times the skip's slack (the same inflated slab
    test, rounded the same way)."""
    _, g = mesh_pair
    cand, count, _, rayf = _queries(g, bounded=True)
    n = g.cl_lo.shape[0]
    o, d, t_max = rayf[6:9].T, rayf[0:3].T, rayf[ic.RAY_FEATS - 1]
    reach = t_max * ic.SKIP_T_SLACK
    assert bool((reach > t_max).all())
    per_ray = []
    for r0 in range(0, N_RAYS, ic.WARP_RAYS):  # one warp as one "block"
        sl = slice(r0, r0 + ic.WARP_RAYS)
        per_ray.append(ic.ray_cluster_mask(
            g.cl_lo, g.cl_hi, o[sl].repeat(8, 1), d[sl].repeat(8, 1),
            reach[sl].repeat(8))[0])
    want = torch.stack(per_ray).view(-1, 8, n)  # (B, warps, C)
    r = rayf[:10].T.reshape(-1, ic.RAY_BLOCK, 10)
    tb = t_max.view(-1, ic.RAY_BLOCK)
    for c in range(n):
        ids = torch.full((r.shape[0],), c)
        got = ic.warp_box_skip(r, g.cl_lo[ids], g.cl_hi[ids], tb)
        assert torch.equal(got, want[:, :, c]), c
    assert 0 < int(want.sum()) < want.numel()


def test_cluster_route_image_matches_bvh_route():
    """A 64² bench frame (depth 4, roulette, compaction) through the
    cluster route (the split product) and through the BVH walk (the f32
    product), at the reference's cluster-vs-jnp engine bar."""
    cfg = pt.PRESETS["bench"].replace(width=64, height=64)
    scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene)), cfg)
    img_c = pt.render(scene, cfg, device="cpu").numpy()
    img_b = pt.render(scene, cfg.replace(backend="jnp"), device="cpu").numpy()
    assert np.isfinite(img_c).all() and img_c.mean() > 0.0
    bad = (np.abs(img_c - img_b) > 5e-3 + 5e-3 * np.abs(img_b)).any(-1)
    assert bad.mean() < 0.005, bad.mean()
