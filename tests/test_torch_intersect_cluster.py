"""The port's cluster intersector (plain path on the CPU) against the
reference's Pallas kernel in interpret mode and against brute force.

The bar is the reference's own (tests/unit/test_cluster.py): equal hit
masks, t at rtol 4e-3 / atol 2e-4 with the 99th-percentile error below
2e-5, and at least 0.999 of materials and normals agreeing; both packages'
cluster routes compute the bf16 hi/lo split product. The glue that
is plain array code in both packages (exit bound, ray features, culls,
candidate lists) must agree exactly, or to 1e-6 where XLA may fuse.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import constants as C
from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.engine import intersect as ref_isect
from pathtracer_tpu.ops import intersect_cluster as ref_ic
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu_torch.engine import intersect as isect
from pathtracer_tpu_torch.engine.camera import camera_rays, tiled_pixel_ids
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

PARTS = ("geometry", "materials", "camera", "lights")


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


@pytest.fixture(scope="module")
def mesh_pair():
    """cornell_mesh with cluster tables (64 clusters): reference and port."""
    ref = ref_with_clusters(ref_builder.cornell_mesh())
    return ref.geometry, _carry(ref).geometry


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_reference_bar(t_want, n_want, m_want, t_got, n_got, m_got):
    t_want, t_got = np.asarray(t_want), np.asarray(t_got)
    hit_w = t_want < C.T_FAR * 0.5
    hit_g = t_got < C.T_FAR * 0.5
    np.testing.assert_array_equal(hit_w, hit_g)
    err = np.abs(t_got[hit_w] - t_want[hit_w])
    assert np.quantile(err, 0.99) < 2e-5, np.quantile(err, 0.99)
    np.testing.assert_allclose(t_got[hit_w], t_want[hit_w], rtol=4e-3,
                               atol=2e-4)
    assert (np.asarray(m_want) == np.asarray(m_got)).mean() > 0.999
    close_n = np.abs(np.asarray(n_want) - np.asarray(n_got)).max(-1) < 1e-4
    assert close_n[hit_w].mean() > 0.999


def test_matches_brute(mesh_pair):
    ref_g, g = mesh_pair
    o, d = _random_rays(1500)
    t_b, n_b, m_b = ref_isect.brute(ref_g, o, d)
    t_c, n_c, m_c = ic.closest_hit_cluster(g, _t(o), _t(d))
    _assert_reference_bar(t_b, n_b, m_b, t_c.numpy(), n_c.numpy(),
                          m_c.numpy())


def test_matches_reference_kernel(mesh_pair):
    ref_g, g = mesh_pair
    o, d = _random_rays(1100, seed=11)
    t_r, n_r, m_r = ref_ic.closest_hit_cluster(ref_g, o, d, interpret=True)
    t_c, n_c, m_c = ic.closest_hit_cluster(g, _t(o), _t(d))
    _assert_reference_bar(t_r, n_r, m_r, t_c.numpy(), n_c.numpy(),
                          m_c.numpy())
    # Both compute the split product: t agrees to the reference's 127-ulp
    # encoding of it.
    hit = np.asarray(t_r) < C.T_FAR * 0.5
    np.testing.assert_allclose(t_c.numpy()[hit], np.asarray(t_r)[hit],
                               rtol=2e-5, atol=0.0)


def test_port_brute_matches_reference_brute(mesh_pair):
    ref_g, g = mesh_pair
    o, d = _random_rays(300, seed=2)
    t_b, n_b, m_b = ref_isect.brute(ref_g, o, d)
    t_p, n_p, m_p = isect.brute(g, _t(o), _t(d))
    _assert_reference_bar(t_b, n_b, m_b, t_p.numpy(), n_p.numpy(),
                          m_p.numpy())


def test_cull_on_equals_cull_off(mesh_pair):
    _, g = mesh_pair
    o, d = _random_rays(1024, seed=3)
    t_a, _, m_a = ic.closest_hit_cluster(g, _t(o), _t(d), use_cull=True)
    t_b, _, m_b = ic.closest_hit_cluster(g, _t(o), _t(d), use_cull=False)
    assert torch.equal(t_a, t_b)
    assert torch.equal(m_a, m_b)


def test_t_max_contract(mesh_pair):
    """Hits strictly nearer than t_max are found; a bound below every hit
    reads as a miss."""
    _, g = mesh_pair
    o, d = _random_rays(1024, seed=13)
    t_ref, _, _ = ic.closest_hit_cluster(g, _t(o), _t(d))
    t_ref = t_ref.numpy()
    hit = t_ref < C.T_FAR * 0.5
    above = np.where(hit, t_ref * 1.5, C.T_FAR).astype(np.float32)
    t_a, _, _ = ic.closest_hit_cluster(g, _t(o), _t(d), t_max=_t(above))
    np.testing.assert_allclose(t_a.numpy()[hit], t_ref[hit], rtol=1e-6,
                               atol=1e-6)
    below = np.where(hit, t_ref * 0.5, 1e-3).astype(np.float32)
    t_b, _, _ = ic.closest_hit_cluster(g, _t(o), _t(d), t_max=_t(below))
    assert (t_b.numpy() >= C.T_FAR * 0.5).all()


def test_spheres_merge():
    ref = ref_with_clusters(ref_builder.cornell_spheres())
    g = _carry(ref).geometry
    o, d = _random_rays(512, seed=7)
    t_b, _, m_b = ref_isect.brute(ref.geometry, o, d)
    t_c, _, m_c = ic.closest_hit_cluster(g, _t(o), _t(d))
    np.testing.assert_allclose(t_c.numpy(), np.asarray(t_b), rtol=4e-3,
                               atol=2e-4)
    assert (np.asarray(m_b) == m_c.numpy()).mean() > 0.999


@pytest.fixture(scope="module")
def glue_inputs(mesh_pair):
    """1024 rays (2 blocks) with per-ray t_max clipped to the exit bound,
    as closest_hit_cluster hands them to the cull."""
    ref_g, _ = mesh_pair
    o, d = _random_rays(1024, seed=21)
    t_max = np.random.default_rng(5).uniform(0.05, 2.0, 1024).astype(
        np.float32)
    t_exit = np.asarray(ref_ic.exit_bound(jnp.asarray(ref_g.cl_lo),
                                          jnp.asarray(ref_g.cl_hi), o, d))
    return o, d, np.minimum(t_max, t_exit)


def test_exit_bound_and_ray_features(mesh_pair, glue_inputs):
    ref_g, g = mesh_pair
    o, d, t_max = glue_inputs
    want = np.asarray(ref_ic.exit_bound(jnp.asarray(ref_g.cl_lo),
                                        jnp.asarray(ref_g.cl_hi), o, d))
    got = ic.exit_bound(g.cl_lo, g.cl_hi, _t(o), _t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rows = np.asarray(ref_ic._ray_features(jnp.asarray(o), jnp.asarray(d),
                                           t_max))
    feats = ic.ray_features(_t(o), _t(d), _t(t_max)).numpy()
    assert feats.shape == (ic.RAY_FEATS, 1024)
    np.testing.assert_allclose(feats, rows[:ic.RAY_FEATS], rtol=1e-6,
                               atol=1e-6)


def test_ray_masks_equal(mesh_pair, glue_inputs):
    ref_g, g = mesh_pair
    o, d, t_max = glue_inputs
    want = np.asarray(ref_ic.ray_cluster_mask(
        jnp.asarray(ref_g.cl_lo), jnp.asarray(ref_g.cl_hi), jnp.asarray(o),
        jnp.asarray(d), t_max))
    got = ic.ray_cluster_mask(g.cl_lo, g.cl_hi, _t(o), _t(d), _t(t_max))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    # The super-cluster mask, with supers of 4 clusters.
    from pathtracer_tpu.accel.clusters import build_supers

    su_lo, su_hi, cl_super = build_supers(np.asarray(ref_g.cl_lo),
                                          np.asarray(ref_g.cl_hi), 4)
    want = np.asarray(ref_ic.ray_super_mask(
        jnp.asarray(su_lo), jnp.asarray(su_hi), jnp.asarray(cl_super),
        jnp.asarray(o), jnp.asarray(d), t_max))
    got = ic.ray_super_mask(_t(su_lo), _t(su_hi), _t(cl_super), _t(o), _t(d),
                            _t(t_max))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cull_candidates_equal(mesh_pair, glue_inputs):
    ref_g, g = mesh_pair
    o, d, t_max = glue_inputs
    extra_ref = ref_ic.ray_cluster_mask(
        jnp.asarray(ref_g.cl_lo), jnp.asarray(ref_g.cl_hi), jnp.asarray(o),
        jnp.asarray(d), t_max)
    cand_r, count_r, tnear_r, _ = ref_ic.cull_candidates(
        jnp.asarray(ref_g.cl_lo), jnp.asarray(ref_g.cl_hi), jnp.asarray(o),
        jnp.asarray(d), t_max=t_max, extra_mask=extra_ref)
    extra = ic.ray_cluster_mask(g.cl_lo, g.cl_hi, _t(o), _t(d), _t(t_max))
    cand, count, tnear = ic.cull_candidates(g.cl_lo, g.cl_hi, _t(o), _t(d),
                                            t_max=_t(t_max),
                                            extra_mask=extra)
    cand_r, count_r, tnear_r = (np.asarray(x) for x in
                                (cand_r, count_r, tnear_r))
    np.testing.assert_array_equal(count.numpy(), count_r)
    np.testing.assert_allclose(tnear.numpy(), tnear_r, rtol=1e-6, atol=1e-6)
    # Ties in tnear may order differently (the reference sort is unstable);
    # the candidate sets per block are equal.
    for b in range(cand.shape[0]):
        n = int(count_r[b])
        assert sorted(cand[b, :n].tolist()) == sorted(cand_r[b, :n].tolist())
        assert (cand[b, n:] == -1).all()


def test_cluster_hit_plain_visits_every_candidate(mesh_pair):
    _, g = mesh_pair
    o, d = _random_rays(512, seed=9)
    t_exit = ic.exit_bound(g.cl_lo, g.cl_hi, _t(o), _t(d))
    rayf = ic.ray_features(_t(o), _t(d), t_exit)
    cand, count, tnear = ic.cull_candidates(g.cl_lo, g.cl_hi, _t(o), _t(d),
                                            t_max=t_exit)
    tables = (g.cl_feat_split, g.cl_lo, g.cl_hi)
    t, slot, visits, warp_visits = ic.cluster_hit_plain(cand, count, tnear,
                                                        rayf, *tables)
    assert visits.tolist() == count.tolist()
    assert warp_visits.tolist() == (8 * count).tolist()  # no warp skips
    assert t.shape == (512,) and slot.dtype == torch.int32
    # A miss keeps its initial bound and reports slot -1.
    miss = slot < 0
    assert torch.equal(t[miss], t_exit[miss])
    # Block chunking does not change the result.
    t2, slot2, _, _ = ic.cluster_hit_plain(cand, count, tnear, rayf, *tables,
                                           chunk_blocks=1)
    assert torch.equal(t, t2) and torch.equal(slot, slot2)


def test_cluster_hit_rejects_bad_inputs(mesh_pair):
    _, g = mesh_pair
    B, K = 2, g.cl_lo.shape[0]
    cand = torch.zeros((B, K), dtype=torch.int32)
    count = torch.zeros((B,), dtype=torch.int32)
    tnear = torch.zeros((B, K))
    rayf = torch.zeros((ic.RAY_FEATS, B * ic.RAY_BLOCK))
    split, lo, hi = g.cl_feat_split, g.cl_lo, g.cl_hi
    ok = (cand, count, tnear, rayf, split, lo, hi)
    ic.cluster_hit(*ok)
    bad = [
        (cand.long(), count, tnear, rayf, split, lo, hi),
        (cand, count, tnear, rayf[:, :-1], split, lo, hi),
        (cand, count, tnear.double(), rayf, split, lo, hi),
        (cand, count, tnear, rayf, split[:, :100], lo, hi),
        (cand.T.contiguous().T, count, tnear, rayf, split, lo, hi),
        (cand, count, tnear, rayf, split.to("meta"), lo, hi),
        # The f32 table: the kernel takes the split one.
        (cand, count, tnear, rayf, g.cl_feat, lo, hi),
        (cand, count, tnear, rayf, split, lo[:-1], hi),
        (cand, count, tnear, rayf, split, lo, hi.double()),
        (cand, count, tnear, rayf, split, lo, hi.T.contiguous().T),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ic.cluster_hit(*args)
    launches = ic.LAUNCHES
    ic.cluster_hit(*ok)
    assert ic.LAUNCHES == launches, "CPU tensors never launch the kernel"


def _cull_rays(rays, n):
    """n random rays inside the box, or n camera rays of a 64x64 frame in
    tile order (each 512-ray block one screen tile: coherent blocks, which
    the cull narrows)."""
    if rays == "random":
        return _random_rays(n, seed=5)
    scene = _carry(ref_builder.cornell_mesh())
    ids = tiled_pixel_ids(0, 64 * 64, 64)[:n]
    jitter = torch.from_numpy(np.random.default_rng(3).random(
        (n, 2), np.float32))
    o, d = camera_rays(scene.camera, 64, 64, jitter, ids)
    return o.numpy(), d.numpy()


@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("rays", ["random", "camera"])
def test_cull_mask_equal_and_keeps_actual_hits(mesh_pair, rays, n):
    """cull_mask is bit-equal to the reference's (block 512), and keeps
    every (block, cluster) where a ray of the block hits a triangle of the
    cluster (tests/unit/test_cluster.py:test_cull_mask_keeps_actual_hits,
    by brute force per cluster)."""
    ref_g, g = mesh_pair
    o, d = _cull_rays(rays, n)
    want = np.asarray(ref_ic.cull_mask(
        jnp.asarray(ref_g.cl_lo), jnp.asarray(ref_g.cl_hi), jnp.asarray(o),
        jnp.asarray(d), block=ic.RAY_BLOCK))
    got = ic.cull_mask(g.cl_lo, g.cl_hi, _t(o), _t(d))
    assert got.dtype == torch.int32
    assert got.shape == (n // ic.RAY_BLOCK, g.cl_lo.shape[0])
    np.testing.assert_array_equal(got.numpy(), want)
    # Hits per (ray, cluster): each slot's triangle, brute force.
    tt = isect.intersect_tris_brute(_t(o), _t(d), g.tri_v0, g.tri_e1,
                                    g.tri_e2)
    slots = g.cl_map.long()
    hit = (tt[:, slots.clamp(min=0)] < C.T_FAR) & (slots >= 0)
    hit = hit.reshape(n, g.cl_lo.shape[0], -1).any(dim=2)
    block_hit = hit.reshape(-1, ic.RAY_BLOCK, hit.shape[1]).any(dim=1)
    assert bool(block_hit.any())
    assert not bool((block_hit & (got == 0)).any())
    if rays == "camera":
        assert bool((got == 0).any()), "coherent blocks cull clusters"
