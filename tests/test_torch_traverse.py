"""The port's BVH walks against the reference's walks and brute force, and
the "jnp"/"pallas" engine routes against the reference's engine: the
skip-link walk (accel/traverse.py, the plain version that CPU tensors run
through ops/traverse_bvh.py), and the near-first pair walk of the CUDA
kernel in plain PyTorch (bvh_hit_ordered_plain) with its child-pair table.

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
from pathtracer_tpu_torch.accel.build import build_bvh, with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import intersect as isect
from pathtracer_tpu_torch.engine.camera import camera_rays
from pathtracer_tpu_torch.ops import traverse_bvh as tb
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays
from pathtracer_tpu_torch.scene.model import make_geometry

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
    t, tri, visits, tests = whole
    assert (visits > 0).all() and (tests >= 0).all()
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
        assert g.bvh_pairs.shape == (int((g.bvh_count == 0).sum()) + 1, 16)
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
    assert torch.equal(carried.geometry.bvh_pairs, built.bvh_pairs)
    no_bvh = builder.cornell_spheres().geometry
    assert no_bvh.bvh_nodes.shape == (0, 8) and no_bvh.bvh_tris.shape == (0, 12)
    assert no_bvh.bvh_pairs.shape == (0, 16)


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
    """Visits and triangle tests are summed per 256-ray block; misses
    report -1 and T_FAR; CPU tensors never launch the kernel; malformed
    inputs raise."""
    _, scene = mesh_pair
    g = scene.geometry
    o, d = _random_rays(300, seed=8)
    launches = tb.LAUNCHES
    t, tri, visits, tests = tb.bvh_hit(g.bvh_nodes, g.bvh_pairs, g.bvh_tris,
                                       _t(o), _t(d))
    assert tb.LAUNCHES == launches, "CPU tensors never launch the kernel"
    assert visits.shape == (2,) and visits.dtype == torch.int32
    assert tests.shape == (2,) and tests.dtype == torch.int32
    _, _, per_ray, tests_per_ray = traverse.walk(
        g.bvh_lo, g.bvh_hi, g.bvh_first, g.bvh_count, g.bvh_skip, g.tri_v0,
        g.tri_e1, g.tri_e2, _t(o), _t(d))
    assert visits.tolist() == [int(per_ray[:256].sum()),
                               int(per_ray[256:].sum())]
    assert tests.tolist() == [int(tests_per_ray[:256].sum()),
                              int(tests_per_ray[256:].sum())]
    assert torch.equal(tri < 0, t >= C.T_FAR)
    n, p, tr = g.bvh_nodes, g.bvh_pairs, g.bvh_tris
    bad = [
        (n[:, :7].contiguous(), p, tr, _t(o), _t(d)),
        (n, p[:, :15].contiguous(), tr, _t(o), _t(d)),
        (n, p, tr.double(), _t(o), _t(d)),
        (n, p, tr, _t(o)[:-1], _t(d)),
        (n, p, tr, _t(o).T.contiguous().T, _t(d)),
        (n[:0], p, tr, _t(o), _t(d)),
        (n, p[:0], tr, _t(o), _t(d)),
        (n, p, tr.to("meta"), _t(o), _t(d)),
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


# ---- the near-first pair walk (the CUDA kernel's, in plain PyTorch) ------

@pytest.fixture(scope="module")
def big_native():
    """big_mesh at ~20k triangles with the native SAH builder."""
    return with_bvh(builder.big_mesh(n_target=20_000), engine="native")


def _tables(g):
    return tuple(x.numpy() for x in (g.bvh_lo, g.bvh_hi, g.bvh_first,
                                     g.bvh_count, g.bvh_skip))


@pytest.mark.parametrize("which", ["bunny", "big_mesh_native"])
def test_pair_table_round_trips(mesh_pair, big_native, which):
    """Entry e of interior node i holds its children i + 1 and skip[i + 1]:
    their boxes, and each child's leaf word or entry * 8; entry 0 holds the
    root and a box no ray hits, with the tree's depth."""
    g = mesh_pair[1].geometry if which == "bunny" else big_native.geometry
    lo, hi, first, count, skip = _tables(g)
    pairs = g.bvh_pairs.numpy()
    words = pairs.view(np.int32)
    inner = np.nonzero(count == 0)[0]
    entry = np.zeros(len(lo), np.int64)
    entry[inner] = np.arange(1, len(inner) + 1)

    def word(c):
        return np.where(count[c] > 0, first[c] * 8 + count[c], entry[c] * 8)

    for half, child in ((0, inner + 1), (8, skip[inner + 1])):
        np.testing.assert_array_equal(pairs[1:, half:half + 3], lo[child])
        np.testing.assert_array_equal(pairs[1:, half + 4:half + 7],
                                      hi[child])
        np.testing.assert_array_equal(words[1:, half + 3], word(child))
    assert not words[1:, [7, 15]].any()
    np.testing.assert_array_equal(pairs[0, 0:3], lo[0])
    np.testing.assert_array_equal(pairs[0, 4:7], hi[0])
    assert words[0, 3] == word(np.array([0]))[0] == 8
    assert np.isposinf(pairs[0, [8, 9, 10, 12, 13, 14]]).all()
    assert words[0, 11] == 0
    # The depth: the most interior ancestors of any node.
    depth = np.zeros(len(lo), np.int64)
    for i in inner:
        depth[i + 1] = depth[skip[i + 1]] = depth[i] + 1
    assert words[0, 7] == depth.max() <= tb.STACK_DEPTH
    # The children's subtrees tile the parent's.
    assert (skip[skip[inner + 1]] == skip[inner]).all()


def _chain(levels):
    """Skip-link arrays of a tree `levels` interior nodes deep: each
    interior node has a one-triangle leaf on the left and the rest of the
    chain on the right; the last interior node has two leaves."""
    lo, hi, first, count, skip = [], [], [], [], []

    def node(n_tri, d):
        i = len(lo)
        lo.append([0.0, 0.0, 0.0])
        hi.append([1.0, 1.0, 1.0])
        first.append(0)
        count.append(n_tri)
        skip.append(-1)
        if n_tri == 0:
            node(1, 0)
            node(1, 0) if d == 1 else node(0, d - 1)
        skip[i] = len(lo)

    node(0, levels)
    v = np.zeros((1, 3), np.float32)
    return (np.array(lo, np.float32), np.array(hi, np.float32),
            np.array(first), np.array(count), np.array(skip), v, v, v)


def test_pack_rejects_a_tree_deeper_than_the_stack():
    nodes, pairs, _ = tb.pack_tables(*_chain(tb.STACK_DEPTH))
    assert int(pairs[0].view(np.int32)[7]) == tb.STACK_DEPTH
    with pytest.raises(ValueError, match="deep"):
        tb.pack_tables(*_chain(tb.STACK_DEPTH + 1))
    # A skip-link walk that is not a binary tree in preorder.
    lo, hi, first, count, skip, v0, e1, e2 = _chain(3)
    skip[1] = 3  # the first leaf swallows its sibling
    with pytest.raises(ValueError):
        tb.pack_tables(lo, hi, first, count, skip, v0, e1, e2)


def test_root_leaf():
    """A BVH that is one leaf (four triangles): the pair table is entry 0
    alone, and the ordered walk equals the skip-link walk and brute force."""
    tris = np.array([[[0.2, 0.2, 0.5], [0.8, 0.2, 0.5], [0.2, 0.8, 0.5]],
                     [[0.8, 0.8, 0.5], [0.2, 0.8, 0.5], [0.8, 0.2, 0.5]],
                     [[0.1, 0.1, 0.9], [0.9, 0.1, 0.9], [0.1, 0.9, 0.9]],
                     [[0.3, 0.3, 0.2], [0.4, 0.3, 0.2], [0.3, 0.4, 0.2]]],
                    np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    bvh = build_bvh(v0, e1, e2)
    assert len(bvh.lo) == 1
    perm = bvh.order
    nodes, pairs, packed = (torch.from_numpy(x) for x in tb.pack_tables(
        bvh.lo, bvh.hi, bvh.first, bvh.count, bvh.skip, v0[perm], e1[perm],
        e2[perm]))
    assert pairs.shape == (1, 16)
    o, d = _random_rays(200, seed=11)
    o[:100] = [0.5, 0.5, 0.0]  # these hit the quad at z = 0.5
    d[:100] = np.clip(d[:100], -0.3, 0.3)
    d[:100, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    skip = tb.bvh_hit_plain(nodes, packed, _t(o), _t(d))
    ordered = tb.bvh_hit_ordered_plain(pairs, packed, _t(o), _t(d))
    for a, b in zip(skip[:2], ordered[:2]):
        assert torch.equal(a, b)
    assert int(ordered[2].sum()) == 200  # entry 0 only
    assert (skip[1][:100] >= 0).all()
    g = make_geometry(tris[perm], np.zeros(4, np.int32))
    t_b, _, _ = isect.brute(g, _t(o), _t(d))
    np.testing.assert_allclose(skip[0].numpy(), t_b.numpy(), atol=1e-5)


def _camera_rays(scene, side, seed):
    ids = torch.arange(side * side, dtype=torch.int64)
    jitter = torch.from_numpy(np.random.default_rng(seed).random(
        (side * side, 2), np.float32))
    o, d = camera_rays(scene.camera, side, side, jitter, ids)
    return o.numpy(), d.numpy()


def _bounce_like_rays(n, seed):
    """Random origins and directions in the box, then axis-aligned rays and
    rays grazing the Cornell walls (origins on x = 0, y = 0, x = 1, y = 1,
    z = 1, directions in or barely off the wall's plane): rays that lie on
    box faces."""
    o, d = _random_rays(n, seed)
    rng = np.random.default_rng(seed + 100)
    m = n // 4
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, m)]
    d[:m] = axes * rng.choice([-1.0, 1.0], (m, 1)).astype(np.float32)
    wall = rng.integers(0, 5, m)
    axis = np.array([0, 1, 0, 1, 2])[wall]
    side = np.array([0.0, 0.0, 1.0, 1.0, 1.0], np.float32)[wall]
    rows = np.arange(m, 2 * m)
    o[rows, axis] = side
    d[rows, axis] = rng.choice([0.0, 1e-7, -1e-7, 1e-3], m)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("rays", ["camera", "bounce"])
@pytest.mark.parametrize("against", ["jnp", "pallas"])
def test_ordered_walk_matches_reference(mesh_pair, rays, against):
    """The kernel's walk (bvh_hit_ordered_plain) against the reference's
    skip-link walks at the reference's bar: t and normals at atol 1e-5,
    materials equal."""
    ref, scene = mesh_pair
    g = scene.geometry
    if rays == "camera":
        o, d = _camera_rays(scene, 24, seed=3)
    else:
        o, d = _bounce_like_rays(800, seed=9)
    t, tri, _, _ = tb.bvh_hit_ordered_plain(g.bvh_pairs, g.bvh_tris, _t(o),
                                            _t(d))
    got = traverse.hit_from_index(g, _t(o), _t(d), t, tri)
    if against == "jnp":
        want = ref_closest_hit(ref.geometry, o, d)
    else:
        want = closest_hit_pallas(ref.geometry, o, d, interpret=True)
    _assert_walk_bar(want, got)
    assert (t < C.T_FAR).float().mean() > 0.5


@pytest.mark.parametrize("which", ["bunny", "big_mesh_native"])
def test_ordered_walk_against_skip_links(mesh_pair, big_native, which):
    """On bounce-like rays: the same hit masks, t bit-equal wherever the
    same triangle wins, and no more triangle tests, box tests (one per
    child of each entry, and the root's) or visits in total than the
    skip-link walk; the footprint covers every triangle tested."""
    scene = mesh_pair[1] if which == "bunny" else big_native
    g = scene.geometry
    o, d = _bounce_like_rays(1000, seed=12)
    if which == "big_mesh_native":
        lo, hi = g.bvh_lo[0].numpy(), g.bvh_hi[0].numpy()
        o = (lo + (hi - lo) * (o - 0.05) / 0.9).astype(np.float32)
    skip = tb.bvh_hit_plain(g.bvh_nodes, g.bvh_tris, _t(o), _t(d))
    seen = (torch.zeros(g.bvh_pairs.shape[0], dtype=torch.bool),
            torch.zeros(g.bvh_tris.shape[0], dtype=torch.bool))
    ordered = tb.bvh_hit_ordered_plain(g.bvh_pairs, g.bvh_tris, _t(o),
                                       _t(d), chunk=256, seen=seen)
    assert torch.equal(skip[1] >= 0, ordered[1] >= 0)
    same = skip[1] == ordered[1]
    assert torch.equal(skip[0][same], ordered[0][same])
    assert same.float().mean() > 0.99
    visits, tests = int(ordered[2].sum()), int(ordered[3].sum())
    boxes = 2 * visits - len(o)  # entry 0 tests the root alone
    assert int(skip[3].sum()) >= tests
    assert int(skip[2].sum()) >= boxes >= visits
    assert seen[0][0] and int(seen[0].sum()) <= visits
    assert 0 < int(seen[1].sum()) <= tests


# ---- every leaf's full count: BVHs built with max_leaf > 4 -------------

# The intersection bar (tests/unit/test_grid.py): t, normal and material.
HIT_RTOL, HIT_ATOL = 4e-3, 2e-4
LEAF_SIZES = (4, 6, 7)


def _ordered_hit(g, o, d, max_leaf=None):
    t, tri, _, _ = tb.bvh_hit_ordered_plain(g.bvh_pairs, g.bvh_tris, o, d,
                                            max_leaf)
    return traverse.hit_from_index(g, o, d, t, tri)


LEAF_WALKS = {
    "closest_hit_bvh": tb.closest_hit_bvh,
    "bvh_hit_ordered_plain": _ordered_hit,
    "traverse.closest_hit": traverse.closest_hit,
}


@pytest.fixture(scope="module")
def leaf_scenes():
    """cornell_mesh (the bench scene) with numpy BVHs of leaves up to m."""
    base = builder.cornell_mesh()
    return {m: with_bvh(base, max_leaf=m, engine="numpy")
            for m in LEAF_SIZES}


def _rays_off(got, want):
    """Rays whose t, normal or material is off the intersection bar."""
    (t_g, n_g, m_g), (t_w, n_w, m_w) = got, want
    ok = (torch.isclose(t_g, t_w, rtol=HIT_RTOL, atol=HIT_ATOL)
          & torch.isclose(n_g, n_w, rtol=HIT_RTOL, atol=HIT_ATOL).all(1)
          & (m_g == m_w))
    return int((~ok).sum())


@pytest.mark.parametrize("walk", list(LEAF_WALKS))
@pytest.mark.parametrize("m", LEAF_SIZES)
def test_walks_test_every_leaf_triangle(leaf_scenes, m, walk):
    """2,048 random rays inside the box through each walk of a max_leaf=m
    BVH: no ray off brute force at the intersection bar. Before the walks
    tested each leaf's full count, m = 6 and 7 missed hits in leaves of
    5-6 triangles."""
    g = leaf_scenes[m].geometry
    assert int(g.bvh_count.max()) == (3 if m == 4 else 6)
    o, d = (_t(x) for x in _random_rays(2048, seed=21))
    want = isect.brute(g, o, d)
    got = LEAF_WALKS[walk](g, o, d)
    assert _rays_off(got, want) == 0, (
        f"{_rays_off(got, want)} of 2048 rays off brute force")
    assert (got[0] < C.T_FAR).float().mean() > 0.5


@pytest.fixture(scope="module")
def big_native_m6():
    """big_mesh at ~20k triangles, native SAH builder, leaves up to 6."""
    return with_bvh(builder.big_mesh(n_target=20_000), max_leaf=6,
                    engine="native")


@pytest.mark.parametrize("walk", list(LEAF_WALKS))
def test_walks_test_every_leaf_triangle_native(big_native_m6, walk):
    g = big_native_m6.geometry
    assert int(g.bvh_count.max()) > 4
    o, d = _random_rays(2048, seed=22)
    lo, hi = g.bvh_lo[0].numpy(), g.bvh_hi[0].numpy()
    o = (lo + (hi - lo) * (o - 0.05) / 0.9).astype(np.float32)
    o, d = _t(o), _t(d)
    want = isect.brute(g, o, d)
    got = LEAF_WALKS[walk](g, o, d)
    assert _rays_off(got, want) == 0, (
        f"{_rays_off(got, want)} of 2048 rays off brute force")
    assert (got[0] < C.T_FAR).float().mean() > 0.5


def _walk_call(g, o, d, max_leaf):
    return traverse.walk(g.bvh_lo, g.bvh_hi, g.bvh_first, g.bvh_count,
                         g.bvh_skip, g.tri_v0, g.tri_e1, g.tri_e2, o, d,
                         max_leaf)


MAX_LEAF_CALLS = {
    **LEAF_WALKS,
    "bvh_hit": lambda g, o, d, m: tb.bvh_hit(g.bvh_nodes, g.bvh_pairs,
                                             g.bvh_tris, o, d, m),
    "bvh_hit_plain": lambda g, o, d, m: tb.bvh_hit_plain(
        g.bvh_nodes, g.bvh_tris, o, d, m),
    "traverse.walk": _walk_call,
}


@pytest.mark.parametrize("call", list(MAX_LEAF_CALLS))
def test_max_leaf_below_the_largest_leaf_raises(leaf_scenes, call):
    """max_leaf may restate the table's bound (the same result as None)
    but never truncate a leaf: below the largest leaf it raises."""
    g = leaf_scenes[6].geometry
    o, d = (_t(x) for x in _random_rays(300, seed=23))
    fn = MAX_LEAF_CALLS[call]
    with pytest.raises(ValueError, match="largest leaf"):
        fn(g, o, d, 4)
    with pytest.raises(ValueError, match="largest leaf"):
        fn(g, o, d, 5)
    for a, b in zip(fn(g, o, d, 6), fn(g, o, d, None)):
        assert torch.equal(a, b)
    for a, b in zip(fn(g, o, d, 7), fn(g, o, d, None)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", LEAF_SIZES)
def test_largest_leaf_read_from_both_tables(leaf_scenes, m):
    """The pair table's leaf words and the skip-link counts give the same
    largest leaf, the bound every walk runs to."""
    g = leaf_scenes[m].geometry
    assert tb.largest_leaf(g.bvh_pairs) == int(g.bvh_count.max())
    _, _, _, count, _, _, _, _ = tb.unpack_tables(g.bvh_nodes, g.bvh_tris)
    assert int(count.max()) == int(g.bvh_count.max())


def test_engine_on_a_max_leaf_6_bvh(leaf_scenes):
    """pt.render through the BVH route (backend="jnp") on the max_leaf=6
    BVH equals the default BVH's frame at the engine bar (multi-bounce:
    atol 1e-3 / rtol 2e-3)."""
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=3, rr_start=2,
                       scene="cornell_mesh", use_bvh=True, backend="jnp")
    default = render(with_bvh(builder.cornell_mesh()), cfg,
                     device="cpu").numpy()
    img = render(leaf_scenes[6], cfg, device="cpu").numpy()
    np.testing.assert_allclose(img, default, atol=1e-3, rtol=2e-3)
    assert img.mean() > 0
