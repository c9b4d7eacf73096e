"""The port's grid path (accel/grid.py, ops/intersect_grid.py, the grid
route of accel/auto.py and the engine) against the reference's.

The reference runs as its own tests run it on the CPU: its pair kernel in
Pallas interpret mode. Host tables and the DDA are bit-exact by design in
both packages. Intersections are held at the reference's grid bar
(tests/unit/test_grid.py): equal hit masks, t at rtol 4e-3 / atol 2e-4
with the 99th-percentile error below 2e-5, materials and normals agreeing
on at least 0.999 of hits. Within the port, no performance knob may change
a single bit of t, normal or material. Renders are held at the reference's
grid-vs-jnp bar: |diff| <= 2e-3 + 2e-3*|ref| on all but 0.2% of pixels.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import constants as RC
from pathtracer_tpu.accel import grid as ref_grid
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.engine import intersect as ref_isect
from pathtracer_tpu.engine import wavefront as ref_wavefront
from pathtracer_tpu.ops import intersect_cluster as ref_ic
from pathtracer_tpu.ops import intersect_grid as ref_ig
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu_torch import constants as C
from pathtracer_tpu_torch import render
from pathtracer_tpu_torch.accel import clusters, grid
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import intersect as isect
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.ops import intersect_grid as ig
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("geometry", "materials", "camera", "lights")


def _arrays(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def _carry(ref_scene):
    return scene_from_arrays(*(_arrays(getattr(ref_scene, p))
                               for p in PARTS))


def _feat_bits(feat32: torch.Tensor) -> np.ndarray:
    return clusters.stack_feat_bf16(feat32).view(torch.int16).numpy() \
        .view(np.uint16)


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
    """cornell_mesh on an 8^3 grid: the reference scene and its carry."""
    ref = ref_grid.with_grid(ref_builder.cornell_mesh(), axis=8)
    return ref.geometry, _carry(ref).geometry


def _assert_bar(t_want, n_want, m_want, t_got, n_got, m_got):
    t_want, t_got = np.asarray(t_want), np.asarray(t_got)
    hit = t_want < C.T_FAR * 0.5
    np.testing.assert_array_equal(hit, t_got < C.T_FAR * 0.5)
    if hit.any():
        err = np.abs(t_got[hit] - t_want[hit])
        assert np.quantile(err, 0.99) < 2e-5, np.quantile(err, 0.99)
        np.testing.assert_allclose(t_got[hit], t_want[hit], rtol=4e-3,
                                   atol=2e-4)
        assert (np.asarray(m_want) == np.asarray(m_got))[hit].mean() \
            >= 0.999
        close_n = np.abs(np.asarray(n_want)
                         - np.asarray(n_got)).max(-1) < 1e-4
        assert close_n[hit].mean() >= 0.999


# ---- host tables ----------------------------------------------------------

@pytest.mark.parametrize("axis", [2, 4, 8, None])
def test_build_grid_equal(axis):
    """Every table equal to the reference's, at fixed axes and at
    pick_axis; the feature table bit-equal through its bf16 stack."""
    g = ref_with_bvh(ref_builder.cornell_mesh()).geometry
    args = [np.asarray(a) for a in (g.tri_v0, g.tri_e1, g.tri_e2)]
    want = ref_grid.build_grid(*args, axis=axis)
    got = grid.build_grid(*args, axis=axis)
    assert got.axis == want.axis == (axis or grid.pick_axis(len(args[0])))
    for name in ("cell_start", "grid_lo", "cell_size", "tri_map", "lo",
                 "hi"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(_feat_bits(torch.from_numpy(got.feat)),
                                  np.asarray(want.feat).view(np.uint16))
    v0, p1, p2 = args[0], args[0] + args[1], args[0] + args[2]
    grid.check_grid_invariants(got, np.minimum(np.minimum(v0, p1), p2),
                               np.maximum(np.maximum(v0, p1), p2))


def test_pick_axis_equal():
    for n in (0, 1000, 256_000, 256_001, 2_048_000, 2_048_001, 10 ** 9):
        assert grid.pick_axis(n) == ref_grid.pick_axis(n)
    assert grid.pick_axis(1_999_372) == 8


def test_with_grid_scene_equal_and_carried():
    """with_grid on the port's scene equals the reference's field for field
    (super tables cleared), and carrying the reference's grid scene keeps
    the gr_* tables and the bf16 stack equal."""
    ref = ref_grid.with_grid(ref_builder.cornell_spheres(), axis=4)
    port = grid.with_grid(builder.cornell_spheres(), axis=4)
    for p in (port, _carry(ref)):
        for part in PARTS:
            for name, want in _arrays(getattr(ref, part)).items():
                got = getattr(getattr(p, part), name)
                if name == "cl_feat":
                    np.testing.assert_array_equal(_feat_bits(got),
                                                  want.view(np.uint16))
                    continue
                assert got.numpy().dtype == want.dtype, name
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{part}.{name}")
    assert port.geometry.gr_cell_start.shape[0] == 4 ** 3 + 1
    assert port.geometry.su_lo.shape[0] == 0


# ---- DDA ------------------------------------------------------------------

@pytest.mark.parametrize("occupancy", [False, True])
def test_dda_cells_equal(mesh_pair, occupancy):
    """Cells, occupied-cell indices and entries bit-equal to the reference's
    on seeded rays: interior, near the camera, far outside the grid, with
    zero direction components, finite and dead-lane t_max."""
    ref_g, g = mesh_pair
    rng = np.random.default_rng(1)
    n = 2048
    o = (rng.random((n, 3)) * 1.6 - 0.3).astype(np.float32)
    o[:256] = np.float32([0.5, 0.5, -1.4]) \
        + rng.normal(size=(256, 3)).astype(np.float32) * 0.01
    o[256:384] *= 50.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16, 0] = 0.0
    t_max = np.where(rng.random(n) < 0.3, rng.random(n) * 2.0,
                     C.T_FAR).astype(np.float32)
    t_max[rng.random(n) < 0.1] = C.T_MIN
    occ_r = ref_ig.pack_occupancy(jnp.asarray(ref_g.gr_cell_start))
    occ = ig.pack_occupancy(g.gr_cell_start)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))
    want = ref_ig.dda_cells(jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(t_max), jnp.asarray(ref_g.gr_lo),
                            jnp.asarray(ref_g.gr_cell), 8,
                            occ_words=occ_r if occupancy else None)
    got = ig.dda_cells(_t(o), _t(d), _t(t_max), g.gr_lo, g.gr_cell, 8,
                       occ_words=occ if occupancy else None)
    assert len(got) == len(want) == (3 if occupancy else 2)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[0] >= 0).any() and (got[0] < 0).any()
    # The first steps alone are the same prefix.
    short = ig.dda_cells(_t(o), _t(d), _t(t_max), g.gr_lo, g.gr_cell, 8,
                         length=5)
    assert torch.equal(short[0], got[0][:5])


# ---- the pair kernel's contract -------------------------------------------

@pytest.fixture(scope="module")
def pair_inputs(mesh_pair):
    """The stage-A pairs of 1024 seeded rays (first 4 cells each), cell
    sorted: (o, d, cell_s, pair_ray, rayf)."""
    _, g = mesh_pair
    o, d = _random_rays(1024, seed=5)
    o, d = _t(o), _t(d)
    t_cap = torch.full((1024,), C.T_FAR)
    cells, _ = ig.dda_cells(o, d, t_cap, g.gr_lo, g.gr_cell, 8, length=4)
    flat = cells.T.reshape(-1)
    pos = torch.nonzero(flat >= 0).squeeze(1)
    cell_s, order = torch.sort(flat[pos], stable=True)
    pair_ray = (pos[order] // 4).to(torch.int32)
    return o, d, cell_s, pair_ray, ic.ray_features(o, d, t_cap)


@pytest.mark.parametrize("pair_block", [128, 512])
def test_pair_candidates_are_the_blocks_cells(mesh_pair, pair_inputs,
                                              pair_block):
    _, g = mesh_pair
    _, _, cell_s, pair_ray, _ = pair_inputs
    offsets, cand = ig.pair_candidates(cell_s, g.gr_cell_start, pair_block)
    cs = g.gr_cell_start.numpy()
    assert offsets.shape[0] == -(-pair_ray.shape[0] // pair_block) + 1
    for b in range(offsets.shape[0] - 1):
        block = cell_s[b * pair_block:(b + 1) * pair_block].tolist()
        want = np.concatenate([np.arange(cs[c], cs[c + 1])
                               for c in dict.fromkeys(block)])
        np.testing.assert_array_equal(cand[offsets[b]:offsets[b + 1]],
                                      want)


def test_pair_hit_plain_matches_reference_kernel(mesh_pair, pair_inputs):
    """pair_hit_plain on the split table (the kernel's function) against
    the reference's _pair_pallas (interpret) on the same blocks' candidate
    lists: equal hit masks, t at the bar, materials through cl_slot_nm on
    >= 0.999 of hits."""
    ref_g, g = mesh_pair
    o, d, cell_s, pair_ray, rayf = pair_inputs
    PB = ig.PAIR_BLOCK
    offsets, cand = ig.pair_candidates(cell_s, g.gr_cell_start, PB)
    t_p, slot_p, vis_p = ig.pair_hit_plain(offsets, cand, pair_ray, rayf,
                                           g.cl_feat_split)
    P = pair_ray.shape[0]
    Bp = offsets.shape[0] - 1
    count = (offsets[1:] - offsets[:-1]).numpy()
    np.testing.assert_array_equal(vis_p.numpy(), count)
    # The reference takes (Bp8, K) candidate rows and (16, Bp8*PB) pair
    # feature rows, Bp8 a multiple of 8; padding pairs have t bound 0.
    Bp8 = -(-Bp // 8) * 8
    cand_r = np.zeros((Bp8, int(count.max())), np.int32)
    for b in range(Bp):
        cand_r[b, :count[b]] = cand[offsets[b]:offsets[b + 1]].numpy()
    count_r = np.zeros((Bp8,), np.int32)
    count_r[:Bp] = count
    rows = np.asarray(ref_ic._ray_features(jnp.asarray(o.numpy()),
                                           jnp.asarray(d.numpy()),
                                           jnp.full((1024,), RC.T_FAR)))
    rayf_r = np.zeros((rows.shape[0], Bp8 * PB), np.float32)
    rayf_r[:, :P] = rows[:, pair_ray.numpy()]
    t_r, slot_r, _ = ref_ig._pair_pallas(
        jnp.asarray(cand_r), jnp.asarray(count_r), jnp.asarray(rayf_r),
        True, PB, jnp.asarray(ref_g.cl_feat))
    t_r, slot_r = np.asarray(t_r)[:P], np.asarray(slot_r)[:P]
    hit = slot_r >= 0
    np.testing.assert_array_equal(slot_p.numpy() >= 0, hit)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(t_p.numpy()[hit], t_r[hit], rtol=4e-3,
                               atol=2e-4)
    nm = g.cl_slot_nm.numpy()
    assert (nm[slot_p.numpy()[hit], 3] == nm[slot_r[hit], 3]).mean() \
        >= 0.999


def test_pair_hit_plain_matches_brute(mesh_pair, pair_inputs):
    """Each pair's t is the brute-force min over the triangles of its
    block's candidate clusters, at any block width, with the split product
    as with the f32 one (the reference's split kernel passes this too); a
    miss keeps its ray's bound and slot -1."""
    _, g = mesh_pair
    o, d, cell_s, pair_ray, rayf = pair_inputs
    PB = 128
    offsets, cand = ig.pair_candidates(cell_s, g.gr_cell_start, PB)
    split = ig.pair_hit_plain(offsets, cand, pair_ray, rayf,
                              g.cl_feat_split, pair_block=PB)
    f32 = ig.pair_walk_plain(offsets, cand, pair_ray, rayf,
                             ic.cluster_major(g.cl_feat), ic.visit_plain,
                             pair_block=PB)
    for t_p, slot_p, _ in (split, f32):
        _pair_plain_matches_brute(g, o, d, offsets, cand, pair_ray, t_p,
                                  slot_p, PB)


def _pair_plain_matches_brute(g, o, d, offsets, cand, pair_ray, t_p, slot_p,
                              PB):
    cl_map = g.cl_map.numpy().reshape(-1, 128)
    for b in range(offsets.shape[0] - 1):
        rays = pair_ray[b * PB:(b + 1) * PB].long()
        slots = cl_map[cand[offsets[b]:offsets[b + 1]].numpy()].reshape(-1)
        tris = torch.from_numpy(np.unique(slots[slots >= 0]))
        t_b = isect.intersect_tris_brute(o[rays], d[rays], g.tri_v0[tris],
                                         g.tri_e1[tris],
                                         g.tri_e2[tris]).min(dim=1).values
        got, slot = t_p[b * PB:(b + 1) * PB], slot_p[b * PB:(b + 1) * PB]
        hit = t_b < C.T_FAR
        assert torch.equal(slot >= 0, hit)
        torch.testing.assert_close(got[hit], t_b[hit], rtol=4e-3, atol=2e-4)
        assert (got[~hit] == C.T_FAR).all()


def test_pair_hit_rejects_bad_inputs(mesh_pair, pair_inputs):
    """CPU tensors never launch the kernel; malformed inputs, the f32 table
    among them (the kernel takes the split table), raise."""
    _, g = mesh_pair
    _, _, cell_s, pair_ray, rayf = pair_inputs
    split = g.cl_feat_split
    offsets, cand = ig.pair_candidates(cell_s, g.gr_cell_start)
    ok = (offsets, cand, pair_ray, rayf, split)
    launches = ig.LAUNCHES
    ig.pair_hit(*ok)
    assert ig.LAUNCHES == launches, "CPU tensors never launch the kernel"
    bad = [
        ((offsets.long(), cand, pair_ray, rayf, split), {}),
        ((offsets[:-1].contiguous(), cand, pair_ray, rayf, split), {}),
        ((offsets, cand, pair_ray, rayf[:10].contiguous(), split), {}),
        ((offsets, cand, pair_ray, rayf, split[:, :100]), {}),
        ((offsets, cand, pair_ray, rayf, split.to("meta")), {}),
        ((offsets, cand, pair_ray, rayf, g.cl_feat), {}),
        (ok, {"pair_block": 100}),
        (ok, {"pair_block": 1024}),
    ]
    for args, kw in bad:
        with pytest.raises(ValueError):
            ig.pair_hit(*args, **kw)


# ---- closest_hit_grid -----------------------------------------------------

def _case(name):
    """(reference geometry, port geometry, o, d, t_max or None, knobs) of
    one of the reference suite's grid cases."""
    knobs = {}
    t_max = None
    if name.startswith("axis"):
        axis = int(name[4:])
        ref = ref_grid.with_grid(ref_builder.cornell_mesh(), axis=axis)
        o, d = _random_rays(768, seed=axis)
    elif name == "spheres":
        ref = ref_grid.with_grid(ref_builder.cornell_spheres(), axis=4)
        o, d = _random_rays(512, seed=5)
    else:
        ref = ref_grid.with_grid(ref_builder.cornell_mesh(),
                                 axis=2 if name == "wide" else 8)
        o, d = _random_rays(1024, seed=7)
    if name == "wide":
        # 8 cells: every block holds few cells and many pairs per cell.
        knobs = dict(first_steps=4, era_steps=4)
    elif name == "shadow":
        rng = np.random.default_rng(3)
        t_ref = np.asarray(ref_isect.brute(ref.geometry, o, d)[0])
        t_max = np.where(rng.random(len(o)) < 0.4,
                         t_ref * (1.0 + rng.random(len(o))),
                         np.float32(C.T_FAR)).astype(np.float32)
        t_max[rng.random(len(o)) < 0.1] = C.T_MIN
    elif name in ("miss", "mixed"):
        # Rays skimming above the ceiling: inside the grid's inflated box
        # for part of their length, hitting nothing; "mixed" adds hits.
        rng = np.random.default_rng(13)
        o = np.stack([rng.random(512) * 0.8 + 0.1, np.full(512, 2.0),
                      rng.random(512) * 0.8 + 0.1], -1).astype(np.float32)
        d = rng.normal(size=(512, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        if name == "mixed":
            o2, d2 = _random_rays(512, seed=14)
            o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    return ref.geometry, _carry(ref).geometry, o, d, t_max, knobs


@pytest.mark.parametrize("name", ["axis2", "axis4", "axis8", "axis16",
                                  "shadow", "miss", "mixed", "spheres",
                                  "wide"])
def test_closest_hit_grid_matches_reference_and_brute(name):
    ref_g, g, o, d, t_max, knobs = _case(name)
    t_b, n_b, m_b = ref_isect.brute(ref_g, o, d)
    t_r, n_r, m_r = ref_ig.closest_hit_grid(ref_g, o, d, interpret=True,
                                            t_max=t_max, **knobs)
    t_g, n_g, m_g = ig.closest_hit_grid(
        g, _t(o), _t(d), t_max=None if t_max is None else _t(t_max),
        **knobs)
    t_g, n_g, m_g = t_g.numpy(), n_g.numpy(), m_g.numpy()
    if t_max is None:
        _assert_bar(t_b, n_b, m_b, t_g, n_g, m_g)
        _assert_bar(t_r, n_r, m_r, t_g, n_g, m_g)
    else:
        # The shadow contract: dead lanes miss; hits strictly nearer than
        # t_max are found.
        t_b = np.asarray(t_b)
        dead = t_max == C.T_MIN
        assert (t_g[dead] >= C.T_FAR * 0.5).all()
        near = ~dead & (t_b < C.T_FAR * 0.5) & (t_b < t_max * 0.999)
        np.testing.assert_allclose(t_g[near], t_b[near], rtol=4e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(t_g[near], np.asarray(t_r)[near],
                                   rtol=4e-3, atol=2e-4)
    if name == "miss":
        assert (t_g >= C.T_FAR * 0.5).all() and (n_g == 0.0).all()


@pytest.mark.parametrize("knobs", [
    dict(first_steps=0),
    dict(first_steps=1, era_steps=1),
    dict(first_steps=4, era_steps=2),
    dict(first_steps=7, era_steps=3),
    dict(first_steps=2, ladder=(2, 8)),
    dict(first_steps=1, era_steps=1, ladder=(64, 256)),
    dict(occupied_windows=True),
    dict(occupied_windows=True, first_steps=0, ladder=(16,)),
    dict(pair_block=128),
    dict(pair_block=256, era_steps=5),
], ids=str)
def test_knobs_never_change_results(mesh_pair, knobs):
    """Stage-A width, era width, ladder, occupied windows and pair-block
    width are performance knobs: t, normal and material are bit-equal to
    the default walk."""
    _, g = mesh_pair
    o, d = _random_rays(1024, seed=11)
    t_0, n_0, m_0 = ig.closest_hit_grid(g, _t(o), _t(d),
                                        occupied_windows=False)
    t_1, n_1, m_1, info = ig.closest_hit_grid(g, _t(o), _t(d), stats=True,
                                              **knobs)
    assert torch.equal(t_0, t_1)
    assert torch.equal(n_0, n_1)
    assert torch.equal(m_0, m_1)
    assert info["visits"] > 0 and info["eras"] >= 1


def test_stats_and_bad_knobs(mesh_pair):
    _, g = mesh_pair
    o, d = _random_rays(1024, seed=2)
    *_, info = ig.closest_hit_grid(g, _t(o), _t(d), stats=True)
    assert info["n_phases"] == -(-24 // ig.PHASE_STEPS)
    assert 0 < info["live_after_phase0"] < 1024
    assert info["era_rays"] == 1024 // 4
    for bad in (dict(ladder=()), dict(ladder=(8, 2)), dict(ladder=(0,)),
                dict(era_steps=0), dict(first_steps=-1)):
        with pytest.raises(ValueError):
            ig.closest_hit_grid(g, _t(o), _t(d), **bad)
    no_grid = builder.cornell_mesh().geometry
    with pytest.raises(ValueError, match="prepare_accel"):
        ig.closest_hit_grid(no_grid, _t(o), _t(d))


# ---- routing and the engine -----------------------------------------------

def _cfg(**kw):
    base = dict(width=16, height=16, spp=1, max_depth=2,
                scene="cornell_mesh", use_bvh=True, backend="cluster")
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def bvh_mesh():
    return with_bvh(builder.cornell_mesh())


def test_routing(bvh_mesh, monkeypatch):
    """backend="grid" attaches grid tables; a cluster scene over the
    cluster route's bound gets grid tables and the grid intersector, and
    renders bit-equal to the explicit grid render."""
    grid_scene = prepare_accel(bvh_mesh, _cfg(backend="grid"))
    assert grid_scene.geometry.gr_cell_start.shape[0] == 4 ** 3 + 1
    assert wavefront._intersector(grid_scene.geometry,
                                  _cfg(backend="grid")).impl == "grid"
    small = prepare_accel(bvh_mesh, _cfg())
    assert small.geometry.gr_cell_start.shape[0] == 0
    assert wavefront._intersector(small.geometry, _cfg()).impl == "cluster"
    explicit = render(grid_scene, _cfg(backend="grid"), device="cpu")
    monkeypatch.setattr(ic, "_ROUTE_TABLE_BYTES", 0)
    routed_scene = prepare_accel(bvh_mesh, _cfg())
    assert routed_scene.geometry.gr_cell_start.shape[0] > 1
    assert wavefront._intersector(routed_scene.geometry,
                                  _cfg()).impl == "grid"
    assert torch.equal(render(routed_scene, _cfg(), device="cpu"), explicit)
    # Above the bound without grid tables: the stream route, with a warning.
    with pytest.warns(UserWarning, match="stream route"):
        assert wavefront._intersector(small.geometry,
                                      _cfg()).impl == "stream"


def _bad_pixels(img, want):
    bad = np.abs(img - want) > 2e-3 + 2e-3 * np.abs(want)
    return bad.any(-1).mean()


def test_grid_render_matches_reference():
    """48x48, depth 5 (so the sparse-hint bounces 3 and 4 run), port grid
    render vs the reference's grid render of the same scene."""
    ref = ref_grid.with_grid(ref_with_bvh(ref_builder.cornell_mesh(
        mesh_tris=ref_builder.procedural_bunny(2))), axis=8)
    cfg = dict(width=48, height=48, spp=1, max_depth=5, scene="cornell_mesh",
               backend="grid")
    want = np.asarray(ref_wavefront.render(ref, RefConfig(**cfg)))
    img = render(_carry(ref), RenderConfig(**cfg), device="cpu").numpy()
    assert _bad_pixels(img, want) < 0.002


def test_grid_render_matches_golden():
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=4, rr_start=2,
                       scene="cornell_mesh", use_bvh=True, backend="grid")
    scene = prepare_accel(with_bvh(builder.cornell_mesh(
        mesh_tris=builder.procedural_bunny(2))), cfg, grid_axis=8)
    img = render(scene, cfg, device="cpu").numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden", "config3_32.npy"))
    assert _bad_pixels(img, golden) < 0.002


def test_big_mesh_render_matches_reference():
    """The config-5 path at small size: big_mesh at ~20k triangles, numpy
    BVH order, grid at pick_axis, 16x16, depth 4."""
    cfg = dict(width=16, height=16, spp=1, max_depth=4, rr_start=2,
               scene="big_mesh", spp_chunk=1, backend="grid")
    ref = ref_grid.with_grid(ref_with_bvh(ref_builder.big_mesh(
        n_target=20_000)))
    port = prepare_accel(with_bvh(builder.big_mesh(n_target=20_000)),
                         RenderConfig(**cfg))
    assert torch.equal(port.geometry.gr_cell_start,
                       torch.from_numpy(np.asarray(ref.geometry
                                                   .gr_cell_start)))
    want = np.asarray(ref_wavefront.render(ref, RefConfig(**cfg)))
    img = render(port, RenderConfig(**cfg), device="cpu").numpy()
    assert img.mean() > 0.0
    assert _bad_pixels(img, want) < 0.002
