"""The port's BVH walk (accel/traverse.py, and ops/traverse_bvh.py, whose
plain version CPU tensors run) against the reference's walks and brute
force, and the "jnp"/"pallas" engine routes against the reference's engine.

Bars are the reference's own: walk vs walk and vs brute t and normals at
atol 1e-5 with materials equal (tests/unit/test_pallas.py); engine renders
at the engine bar of tests/oracle/test_engine.py (atol 5e-4 / rtol 1e-3
for direct light, 1e-3 / 2e-3 multi-bounce); the goldens, which the
reference rendered through its BVH walk, at the golden bar (atol 1e-5 /
rtol 1e-5, tests/golden/test_golden.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu import constants as C
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.accel.traverse import closest_hit as ref_closest_hit
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.engine import intersect as ref_isect
from pathtracer_tpu.engine import wavefront as ref_wavefront
from pathtracer_tpu.ops.traverse_pallas import closest_hit_pallas
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu_torch import render
from pathtracer_tpu_torch.accel import traverse
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import intersect as isect
from pathtracer_tpu_torch.ops import traverse_bvh as tb
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("geometry", "materials", "camera", "lights")


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def mesh_pair():
    """The goldens' small mesh scene (bunny subdiv 2) with its BVH."""
    ref = ref_with_bvh(ref_builder.cornell_mesh(
        mesh_tris=ref_builder.procedural_bunny(2)))
    return ref, _carry(ref)


def _assert_walk_bar(want, got):
    t_w, n_w, m_w = (np.asarray(x) for x in want)
    t_g, n_g, m_g = (x.numpy() for x in got)
    np.testing.assert_allclose(t_g, t_w, atol=1e-5)
    np.testing.assert_allclose(n_g, n_w, atol=1e-5)
    np.testing.assert_array_equal(m_g, m_w)


@pytest.mark.parametrize("against", ["jnp", "pallas", "brute"])
def test_walk_matches_reference(mesh_pair, against):
    """The plain walk against the reference's jnp walk, its Pallas kernel
    in interpret mode, and the port's brute force."""
    ref, scene = mesh_pair
    o, d = _random_rays(512, seed=1)
    got = traverse.closest_hit(scene.geometry, _t(o), _t(d))
    if against == "jnp":
        want = ref_closest_hit(ref.geometry, o, d)
    elif against == "pallas":
        want = closest_hit_pallas(ref.geometry, o, d, interpret=True)
    else:
        want = isect.brute(scene.geometry, _t(o), _t(d))
    _assert_walk_bar(want, got)
    assert (got[0].numpy() < C.T_FAR).mean() > 0.5


def test_kernel_route_equals_walk_and_odd_batch(mesh_pair):
    """closest_hit_bvh (the plain version on the CPU) equals the walk bit
    for bit, at an odd batch size against the reference."""
    ref, scene = mesh_pair
    o, d = _random_rays(173, seed=4)
    walk = traverse.closest_hit(scene.geometry, _t(o), _t(d))
    kern = tb.closest_hit_bvh(scene.geometry, _t(o), _t(d))
    for a, b in zip(walk, kern):
        assert torch.equal(a, b)
    _assert_walk_bar(ref_closest_hit(ref.geometry, o, d), kern)


def test_chunked_equals_unchunked(mesh_pair):
    _, scene = mesh_pair
    g = scene.geometry
    o, d = _random_rays(700, seed=5)
    args = (g.bvh_lo, g.bvh_hi, g.bvh_first, g.bvh_count, g.bvh_skip,
            g.tri_v0, g.tri_e1, g.tri_e2, _t(o), _t(d))
    whole = traverse.walk(*args)
    chunked = traverse.walk(*args, chunk=64)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    t, tri, visits = whole
    assert (visits > 0).all()
    assert torch.equal(tri < 0, t >= C.T_FAR)


def test_spheres_merged():
    ref = ref_with_bvh(ref_builder.cornell_spheres())
    g = _carry(ref).geometry
    assert g.sph_c.shape[0] > 0 and g.bvh_lo.shape[0] > 0
    o, d = _random_rays(256, seed=6)
    want = ref_isect.brute(ref.geometry, o, d)
    got = tb.closest_hit_bvh(g, _t(o), _t(d))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_axis_aligned_rays(mesh_pair):
    """Zero direction components (the sign-preserving 1e-20 clamp) give no
    NaN and the brute-force hits."""
    _, scene = mesh_pair
    dirs = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0],
                     [0, 1, 0], [0, -1, 0], [-0.0, 0.0, -1]], np.float32)
    o = np.repeat(np.array([[0.5, 0.5, 0.5], [0.3, 0.2, 0.7]], np.float32),
                  len(dirs), axis=0)
    d = np.tile(dirs, (2, 1))
    t, n, m = tb.closest_hit_bvh(scene.geometry, _t(o), _t(d))
    assert torch.isfinite(t).all() and torch.isfinite(n).all()
    t_b, _, m_b = isect.brute(scene.geometry, _t(o), _t(d))
    np.testing.assert_allclose(t.numpy(), t_b.numpy(), atol=1e-5)
    assert torch.equal(m, m_b)


def test_packed_tables_equal_direct_gather(mesh_pair):
    """bvh_nodes/bvh_tris hold the BVH and triangle arrays bit for bit,
    whether derived from carried arrays or built by with_bvh."""
    _, carried = mesh_pair
    built = with_bvh(builder.cornell_mesh(
        mesh_tris=builder.procedural_bunny(2))).geometry
    for g in (carried.geometry, built):
        nodes, tris = g.bvh_nodes, g.bvh_tris
        assert nodes.shape == (g.bvh_lo.shape[0], 8)
        assert tris.shape == (g.tri_v0.shape[0], 12)
        assert torch.equal(nodes[:, 0:3], g.bvh_lo)
        assert torch.equal(nodes[:, 4:7], g.bvh_hi)
        words = nodes.view(torch.int32)
        assert torch.equal(words[:, 3], g.bvh_skip)
        leaf = g.bvh_count > 0
        assert torch.equal(words[:, 7], torch.where(
            leaf, g.bvh_first * 8 + g.bvh_count, 0))
        assert torch.equal(tris[:, 0:3], g.tri_v0)
        assert torch.equal(tris[:, 3:6], g.tri_e1)
        assert torch.equal(tris[:, 6:9], g.tri_e2)
        assert not tris[:, 9:].any()
        lo, hi, first, count, skip, v0, e1, e2 = tb.unpack_tables(nodes, tris)
        assert torch.equal(count, g.bvh_count)
        assert torch.equal(first[leaf], g.bvh_first[leaf])
    assert torch.equal(carried.geometry.bvh_nodes, built.bvh_nodes)
    no_bvh = builder.cornell_spheres().geometry
    assert no_bvh.bvh_nodes.shape == (0, 8) and no_bvh.bvh_tris.shape == (0, 12)


def test_pack_rejects_unwalkable_links(mesh_pair):
    _, scene = mesh_pair
    g = scene.geometry
    arrays = [x.numpy().copy() for x in (
        g.bvh_lo, g.bvh_hi, g.bvh_first, g.bvh_count, g.bvh_skip, g.tri_v0,
        g.tri_e1, g.tri_e2)]
    leaf = int(np.nonzero(arrays[3])[0][0])
    for field, index, value in ((3, leaf, 8), (4, 5, 5), (4, 0, 10 ** 6),
                                (2, leaf, len(arrays[5]))):
        bad = [a.copy() for a in arrays]
        bad[field][index] = value
        with pytest.raises(ValueError):
            tb.pack_tables(*bad)


def test_bvh_hit_contract(mesh_pair):
    """Visits are summed per 256-ray block; misses report -1 and T_FAR;
    CPU tensors never launch the kernel; malformed inputs raise."""
    _, scene = mesh_pair
    g = scene.geometry
    o, d = _random_rays(300, seed=8)
    launches = tb.LAUNCHES
    t, tri, visits = tb.bvh_hit(g.bvh_nodes, g.bvh_tris, _t(o), _t(d))
    assert tb.LAUNCHES == launches, "CPU tensors never launch the kernel"
    assert visits.shape == (2,) and visits.dtype == torch.int32
    _, _, per_ray = traverse.walk(
        g.bvh_lo, g.bvh_hi, g.bvh_first, g.bvh_count, g.bvh_skip, g.tri_v0,
        g.tri_e1, g.tri_e2, _t(o), _t(d))
    assert visits.tolist() == [int(per_ray[:256].sum()),
                               int(per_ray[256:].sum())]
    assert torch.equal(tri < 0, t >= C.T_FAR)
    bad = [
        (g.bvh_nodes[:, :7].contiguous(), g.bvh_tris, _t(o), _t(d)),
        (g.bvh_nodes, g.bvh_tris.double(), _t(o), _t(d)),
        (g.bvh_nodes, g.bvh_tris, _t(o)[:-1], _t(d)),
        (g.bvh_nodes, g.bvh_tris, _t(o).T.contiguous().T, _t(d)),
        (g.bvh_nodes[:0], g.bvh_tris, _t(o), _t(d)),
        (g.bvh_nodes, g.bvh_tris.to("meta"), _t(o), _t(d)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tb.bvh_hit(*args)


# ---- the engine routes ----------------------------------------------------

@pytest.mark.parametrize("backend,depth", [("jnp", 1), ("pallas", 3)])
def test_bvh_routes_match_reference_engine(mesh_pair, backend, depth):
    ref, scene = mesh_pair
    cfg = dict(width=24, height=24, spp=1, max_depth=depth, rr_start=2,
               scene="cornell_mesh", use_bvh=True, backend=backend)
    img = render(scene, RenderConfig(**cfg), device="cpu").numpy()
    want = np.asarray(ref_wavefront.render(ref, RefConfig(**cfg)))
    if depth == 1:
        np.testing.assert_allclose(img, want, atol=5e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(img, want, atol=1e-3, rtol=2e-3)


@pytest.mark.parametrize("name,cfg", [
    ("config2_48", dict(width=48, height=48, spp=2, max_depth=1)),
    ("config3_32", dict(width=32, height=32, spp=4, max_depth=4,
                        rr_start=2)),
])
def test_goldens_through_bvh_route(name, cfg):
    """The route that rendered the goldens (scripts/regen_goldens.py: no
    backend given, so "jnp", the BVH walk), at the golden bar."""
    cfg = RenderConfig(scene="cornell_mesh", use_bvh=True, **cfg)
    assert cfg.backend == "jnp"
    scene = with_bvh(builder.cornell_mesh(
        mesh_tris=builder.procedural_bunny(2)))
    img = render(scene, cfg, device="cpu").numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npy"))
    np.testing.assert_allclose(img, golden, atol=1e-5, rtol=1e-5)
