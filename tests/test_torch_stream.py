"""The port's stream route (ops/intersect_stream.py; the plain version of
its kernel on the CPU) against the reference's closest_hit_stream in
Pallas interpret mode, brute force and the reference's engine.

Bars are the reference's own (tests/unit/test_stream.py,
tests/unit/test_supers.py): equal hit masks, t at rtol 4e-3 / atol 2e-4,
at least 0.999 of materials agreeing; a smaller round window must not
change the result; engine renders at the engine bar of
tests/oracle/test_engine.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu import constants as C
from pathtracer_tpu.accel.auto import prepare_accel as ref_prepare_accel
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.engine import intersect as ref_isect
from pathtracer_tpu.engine import wavefront as ref_wavefront
from pathtracer_tpu.ops.intersect_stream import (
    closest_hit_stream as ref_closest_hit_stream,
)
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu.scene import model as ref_model
from pathtracer_tpu_torch import render
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.accel.clusters import stack_feat_bf16, with_clusters
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.ops import intersect_stream as st
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

PARTS = ("geometry", "materials", "camera", "lights")


def _arrays(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def _carry(ref_scene):
    return scene_from_arrays(*(_arrays(getattr(ref_scene, p)) for p in PARTS))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_rays(n, seed=0, lo=0.05, spread=0.9):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * spread + lo).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def mesh_pair():
    """cornell_mesh (bunny asset) with BVH, 64 clusters and 2 supers."""
    ref = ref_with_clusters(ref_with_bvh(ref_builder.cornell_mesh()))
    return ref, _carry(ref)


@pytest.fixture(scope="module")
def soup_pair():
    """The many-supers triangle soup of tests/unit/test_supers.py
    (1200 triangles, clusters of 16, supers of 4)."""
    rng = np.random.default_rng(12)
    base = (rng.random((1200, 1, 3)) - 0.5) * 4.0
    verts = (base + rng.normal(size=(1200, 3, 3)) * 0.25).astype(np.float32)
    geom = ref_model.make_geometry(verts, np.zeros((1200,), np.int32))
    mats = ref_model.Materials(albedo=np.full((1, 3), 0.5, np.float32),
                               emission=np.zeros((1, 3), np.float32))
    ref = ref_with_clusters(ref_model.Scene(
        geometry=geom, materials=mats,
        camera=ref_builder.cornell_mesh().camera,
        lights=ref_model.make_lights(geom, mats)), max_tris=16,
        super_group=4)
    return ref, _carry(ref)


def _assert_cluster_bar(want, got):
    t_w, _, m_w = (np.asarray(x) for x in want)
    t_g, _, m_g = (x.numpy() for x in got)
    hit = t_w < C.T_FAR * 0.5
    np.testing.assert_array_equal(hit, t_g < C.T_FAR * 0.5)
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=4e-3, atol=2e-4)
    assert (m_g == m_w).mean() >= 0.999
    assert hit.mean() > 0.3


def test_matches_reference_stream(mesh_pair):
    ref, scene = mesh_pair
    assert scene.geometry.su_lo.shape[0] > 1  # the super cull runs
    o, d = _random_rays(1100, seed=11)
    want = ref_closest_hit_stream(ref.geometry, o, d, interpret=True)
    got = st.closest_hit_stream(scene.geometry, _t(o), _t(d))
    _assert_cluster_bar(want, got)
    _assert_cluster_bar(ref_isect.brute(ref.geometry, o, d), got)


def test_small_window_equals_full_window(mesh_pair):
    """max_cand=8 on 64 clusters forces up to 8 rounds; the result must not
    change (the rounds' resolution test keeps the walk exact)."""
    _, scene = mesh_pair
    o, d = _random_rays(768, seed=9)
    full = st.closest_hit_stream(scene.geometry, _t(o), _t(d))
    small = st.closest_hit_stream(scene.geometry, _t(o), _t(d), max_cand=8)
    np.testing.assert_allclose(small[0].numpy(), full[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(small[2], full[2])
    # The cluster route walks the same candidates in one window with the
    # same split product (the reference's stream-vs-dense comparison,
    # tests/unit/test_stream.py): its culls drop only clusters that no ray
    # of a block crosses, so the result is the same, bit for bit.
    cluster = ic.closest_hit_cluster(scene.geometry, _t(o), _t(d))
    assert (full[0] < C.T_FAR * 0.5).float().mean() > 0.3
    for got, want in zip(cluster, full):
        assert torch.equal(got, want)


def test_t_max_contract(mesh_pair):
    """Hits strictly nearer than t_max are found; a bound below every hit
    reads as a miss."""
    _, scene = mesh_pair
    g = scene.geometry
    o, d = _random_rays(1024, seed=13)
    t_ref = st.closest_hit_stream(g, _t(o), _t(d))[0].numpy()
    hit = t_ref < C.T_FAR * 0.5
    above = np.where(hit, t_ref * 1.5, C.T_FAR).astype(np.float32)
    t_a = st.closest_hit_stream(g, _t(o), _t(d), t_max=_t(above))[0].numpy()
    np.testing.assert_allclose(t_a[hit], t_ref[hit], rtol=1e-6, atol=1e-6)
    below = np.where(hit, t_ref * 0.5, 1e-3).astype(np.float32)
    t_b = st.closest_hit_stream(g, _t(o), _t(d), t_max=_t(below))[0]
    assert (t_b.numpy() >= C.T_FAR * 0.5).all()


def test_many_supers_scene(soup_pair):
    """A scene of many supers, with a small window: multi-round resolution
    under the super cull, against brute force and the reference."""
    ref, scene = soup_pair
    assert scene.geometry.su_lo.shape[0] > 4
    o, d = _random_rays(1024, seed=2, lo=-2.5, spread=5.0)
    got = st.closest_hit_stream(scene.geometry, _t(o), _t(d), max_cand=8)
    _assert_cluster_bar(ref_isect.brute(ref.geometry, o, d), got)
    want = ref_closest_hit_stream(ref.geometry, o, d, interpret=True,
                                  max_cand=8)
    _assert_cluster_bar(want, got)


def test_super_mask_chunked_equals_unchunked(soup_pair):
    _, scene = soup_pair
    g = scene.geometry
    o, d = _random_rays(2048, seed=3, lo=-2.5, spread=5.0)
    o[1024:] += 10.0  # the last two blocks start far outside the soup
    t_max = torch.full((2048,), 3.0)
    whole = ic.ray_super_mask(g.su_lo, g.su_hi, g.cl_super, _t(o), _t(d),
                              t_max)
    chunked = ic.ray_super_mask(g.su_lo, g.su_hi, g.cl_super, _t(o), _t(d),
                                t_max, chunk_blocks=1)
    assert whole.shape == (4, g.cl_lo.shape[0])
    assert torch.equal(whole, chunked)
    assert 0 < int(whole.sum()) < whole.numel()


def test_prepare_accel_stream_tables_equal_reference():
    """prepare_accel(backend="stream") attaches the reference's cluster and
    super-cluster tables (the feature table through its bf16 stack)."""
    cfg = dict(width=16, height=16, scene="cornell_mesh", backend="stream")
    ref = ref_prepare_accel(ref_with_bvh(ref_builder.cornell_mesh()),
                            RefConfig(**cfg))
    port = prepare_accel(with_bvh(builder.cornell_mesh()),
                         RenderConfig(**cfg))
    for name, want in _arrays(ref.geometry).items():
        got = getattr(port.geometry, name)
        if name == "cl_feat":
            got = stack_feat_bf16(got).view(torch.int16).numpy()
            want = want.view(np.int16)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.geometry.su_lo.shape[0] > 1


def test_stream_hit_contract(mesh_pair):
    """A block with count 0 keeps its carried values; CPU tensors never
    launch the kernel; malformed inputs, the f32 table among them (the
    kernel takes the split table), raise."""
    _, scene = mesh_pair
    g = scene.geometry
    split = g.cl_feat_split
    o, d = _random_rays(1024, seed=21)
    t_exit = ic.exit_bound(g.cl_lo, g.cl_hi, _t(o), _t(d))
    rayf = ic.ray_features(_t(o), _t(d), t_exit)
    cand, count, tnear = ic.cull_candidates(g.cl_lo, g.cl_hi, _t(o), _t(d),
                                            t_max=t_exit)
    count[1] = 0
    t_in = t_exit.clone()
    slot_in = torch.full((1024,), -1, dtype=torch.int32)
    boxes = (g.cl_lo, g.cl_hi)
    launches = st.LAUNCHES
    t, slot, visits, warp_visits = st.stream_hit(cand, count, tnear, rayf,
                                                 t_in, slot_in, split, *boxes)
    assert st.LAUNCHES == launches, "CPU tensors never launch the kernel"
    assert visits.tolist() == [int(count[0]), 0]
    assert warp_visits.tolist() == [8 * int(count[0]), 0]
    assert torch.equal(t[512:], t_in[512:]) and (slot[512:] == -1).all()
    assert (slot[:512] >= 0).any() and torch.equal(t_in, t_exit)
    ok = (cand, count, tnear, rayf, t_in, slot_in, split, *boxes)
    bad = [
        (cand, count, tnear, rayf, t_in.double(), slot_in, split, *boxes),
        (cand, count, tnear, rayf, t_in, slot_in[:-1], split, *boxes),
        (cand, count, tnear, rayf, t_in, slot_in.long(), split, *boxes),
        (cand.long(), count, tnear, rayf, t_in, slot_in, split, *boxes),
        (cand, count, tnear, rayf, t_in, slot_in.to("meta"), split, *boxes),
        (cand, count, tnear, rayf, t_in, slot_in, g.cl_feat, *boxes),
        (cand, count, tnear, rayf, t_in, slot_in, split, g.cl_lo[:2],
         g.cl_hi),
    ]
    st.stream_hit(*ok)
    for args in bad:
        with pytest.raises(ValueError):
            st.stream_hit(*args)


# ---- the engine route -------------------------------------------------------

def test_stream_route_matches_reference_engine(mesh_pair):
    """The engine bar on every pixel but one. The port's split product
    equals the reference's visit_q bit for bit on the CPU, but the
    reference's kernels report t with its low 7 mantissa bits cleared (the
    127-ulp row encoding of its visit_epilogue, which the port does not
    copy). That moves the bounce-1 origin of a ray of this frame by a few
    ulps, and its grazing shadow ray reads occluded on one side and lit on
    the other: one pixel that differs by that one NEE sample."""
    ref, scene = mesh_pair
    cfg = dict(width=24, height=24, spp=1, max_depth=2, rr_start=2,
               scene="cornell_mesh", use_bvh=True, backend="stream")
    img = render(scene, RenderConfig(**cfg), device="cpu").numpy()
    want = np.asarray(ref_wavefront.render(ref, RefConfig(**cfg)))
    bad = ~np.isclose(img, want, atol=1e-3, rtol=2e-3).all(axis=-1)
    assert bad.sum() <= 1, np.argwhere(bad)
    np.testing.assert_allclose(img[~bad], want[~bad], atol=1e-3, rtol=2e-3)
    assert np.abs(img - want).max() < 1e-2


def test_over_bound_without_grid_warns_and_streams(monkeypatch):
    """A cluster table above the cluster route's bound with no grid tables
    warns and takes the stream route, which renders bit-equal to the
    explicit stream backend."""
    scene = with_clusters(with_bvh(builder.cornell_mesh(
        mesh_tris=builder.procedural_bunny(2))))
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=2,
                       scene="cornell_mesh", backend="cluster")
    explicit = render(scene, cfg.replace(backend="stream"), device="cpu")
    monkeypatch.setattr(ic, "_ROUTE_TABLE_BYTES", 0)
    with pytest.warns(UserWarning, match="falling back"):
        hit = wavefront._intersector(scene.geometry, cfg)
    assert hit.impl == "stream"
    with pytest.warns(UserWarning, match="falling back"):
        routed = render(scene, cfg, device="cpu")
    assert torch.equal(routed, explicit)
