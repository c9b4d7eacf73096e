"""The port's scene and acceleration tables against the reference's.

Host tables are bit-exact by design in both packages (the same numpy
builders), so every array must be equal, dtype included; the cluster
feature table is compared through its bf16 [hi; hi; lo] stack.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu.accel import build as ref_build
from pathtracer_tpu.accel import clusters as ref_clusters
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu.scene import model as ref_model
from pathtracer_tpu_torch.accel import build, clusters
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import PRESETS, RenderConfig
from pathtracer_tpu_torch.scene import builder, model
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

PARTS = ("geometry", "materials", "camera", "lights")


def _arrays(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def _carry(ref_scene, device="cpu"):
    return scene_from_arrays(*(_arrays(getattr(ref_scene, p)) for p in PARTS),
                             device=device)


def _feat_bits(feat32: torch.Tensor) -> np.ndarray:
    stack = clusters.stack_feat_bf16(feat32).view(torch.int16)
    return stack.numpy().view(np.uint16)


def assert_scene_equal(port, ref):
    for part in PARTS:
        for name, want in _arrays(getattr(ref, part)).items():
            got = getattr(getattr(port, part), name)
            if name == "cl_feat":
                np.testing.assert_array_equal(_feat_bits(got),
                                              want.view(np.uint16))
                continue
            got = got.numpy()
            assert got.dtype == want.dtype, (part, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{part}.{name}")


@pytest.mark.parametrize("name", ["cornell_spheres", "cornell_specular",
                                  "cornell_biglight", "cornell_sphlight",
                                  "cornell_mesh"])
def test_builtin_scenes_equal(name):
    assert_scene_equal(builder.build_scene(name),
                       ref_builder.build_scene(name))


def test_bunny_mesh_and_obj_loader_equal():
    np.testing.assert_array_equal(builder.procedural_bunny(2),
                                  ref_builder.procedural_bunny(2))
    np.testing.assert_array_equal(builder._bunny_asset(),
                                  ref_builder._bunny_asset())


@pytest.fixture(scope="module")
def bench_pair():
    """The bench scene (cornell_mesh, BVH, clusters) from both packages."""
    ref = ref_clusters.with_clusters(ref_with_bvh(ref_builder.cornell_mesh()))
    port = prepare_accel(with_bvh(builder.cornell_mesh()), PRESETS["bench"])
    return port, ref


def test_bench_tables_equal(bench_pair):
    port, ref = bench_pair
    assert_scene_equal(port, ref)
    g = port.geometry
    assert g.tri_v0.shape[0] == 5132 and g.cl_lo.shape[0] == 64
    assert g.cl_feat.shape == (16, 64 * 512)
    assert g.bvh_lo.shape[0] == 4095


def test_with_bvh_equal_and_lights_remapped():
    mesh = builder.procedural_bunny(2)
    port = with_bvh(builder.cornell_mesh(mesh_tris=mesh))
    ref = ref_with_bvh(ref_builder.cornell_mesh(mesh_tris=mesh))
    assert_scene_equal(port, ref)
    lit = port.geometry.tri_mat[port.lights.tri_idx.long()]
    assert (lit == builder.LIGHT).all()


def test_build_supers_and_slot_table_equal(bench_pair):
    port, ref = bench_pair
    g = ref.geometry
    lo, hi = np.asarray(g.cl_lo), np.asarray(g.cl_hi)
    for group in (4, 32):
        for a, b in zip(clusters.build_supers(lo, hi, group),
                        ref_clusters.build_supers(lo, hi, group)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        clusters.slot_nm_table(np.asarray(g.cl_map), np.asarray(g.tri_n),
                               np.asarray(g.tri_mat)),
        ref_clusters.slot_nm_table(np.asarray(g.cl_map), np.asarray(g.tri_n),
                                   np.asarray(g.tri_mat)))


def test_make_lights_mixed_table_equal():
    ref = ref_builder.cornell_sphlight()
    port = builder.cornell_sphlight()
    lights = model.make_lights(port.geometry, port.materials, (0.1, 0.2, 0.3))
    want = ref_model.make_lights(ref.geometry, ref.materials, (0.1, 0.2, 0.3))
    for name, arr in _arrays(want).items():
        np.testing.assert_array_equal(getattr(lights, name).numpy(), arr)
    assert lights.sph_idx.numel() == 1 and lights.tri_idx.numel() == 2


def test_scene_from_arrays_round_trip(bench_pair):
    port, ref = bench_pair
    carried = _carry(ref)
    assert_scene_equal(carried, ref)
    for part in PARTS:
        for f in dataclasses.fields(getattr(port, part)):
            assert torch.equal(getattr(getattr(carried, part), f.name),
                               getattr(getattr(port, part), f.name)), f.name


def test_scene_from_arrays_without_clusters():
    ref = ref_builder.cornell_spheres()
    assert_scene_equal(_carry(ref), ref)


def test_scene_from_arrays_rejects_tampered_feat(bench_pair):
    _, ref = bench_pair
    arrays = [_arrays(getattr(ref, p)) for p in PARTS]
    feat = arrays[0]["cl_feat"].copy()
    bits = feat.view(np.uint16)
    bits[2, 7] ^= 1  # one ulp of one hi entry
    arrays[0]["cl_feat"] = feat
    with pytest.raises(ValueError, match="cl_feat"):
        scene_from_arrays(*arrays)


def test_scene_to_device_moves_every_tensor(bench_pair):
    port, _ = bench_pair
    moved = port.to("meta")
    for part in PARTS:
        for f in dataclasses.fields(getattr(moved, part)):
            assert getattr(getattr(moved, part), f.name).device.type == "meta"


def test_unported_routes_raise():
    """big_mesh builds, the native BVH builder runs, prepare_accel attaches
    grid tables for "grid" and cluster tables for "stream" (no route raises
    for being unported any more), and an unknown BVH engine raises."""
    big = builder.build_scene("big_mesh", n_target=3000)
    assert big.geometry.tri_v0.shape[0] == 12 + 2 * 1280
    scene = builder.cornell_spheres()
    grid_scene = prepare_accel(scene, RenderConfig(backend="grid"))
    assert grid_scene.geometry.gr_cell_start.shape[0] == 4 ** 3 + 1
    stream_scene = prepare_accel(scene, RenderConfig(backend="stream"))
    assert stream_scene.geometry.cl_lo.shape[0] > 0
    assert stream_scene.geometry.gr_cell_start.shape[0] == 0
    native = with_bvh(scene, engine="native")
    assert native.geometry.bvh_lo.shape[0] > 0
    with pytest.raises(ValueError):
        with_bvh(scene, engine="sah")


def test_presets_equal_reference():
    from pathtracer_tpu.config import PRESETS as REF_PRESETS

    assert PRESETS.keys() == REF_PRESETS.keys()
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            REF_PRESETS[name])
    assert RenderConfig.from_json(PRESETS["bench"].to_json()) == \
        PRESETS["bench"]


def test_constants_are_the_reference_values():
    from pathtracer_tpu import constants as ref_c
    from pathtracer_tpu_torch import constants as c

    names = [n for n in dir(ref_c) if n.isupper()]
    assert names and all(getattr(c, n) == getattr(ref_c, n) for n in names)


# ---- the host-table invariant checks, held to the reference's verdicts ---

@pytest.fixture(scope="module")
def mesh_tris():
    """cornell_mesh's triangles (v0, e1, e2) as numpy arrays."""
    g = builder.cornell_mesh().geometry
    return tuple(x.numpy() for x in (g.tri_v0, g.tri_e1, g.tri_e2))


@pytest.fixture(scope="module")
def mesh_bvh(mesh_tris):
    bvh = build.build_bvh(*mesh_tris)
    want = ref_build.build_bvh(*mesh_tris)
    for f in dataclasses.fields(bvh):
        np.testing.assert_array_equal(getattr(bvh, f.name),
                                      getattr(want, f.name))
    return bvh


def _bvh_fields(bvh) -> dict:
    return {f.name: getattr(bvh, f.name).copy()
            for f in dataclasses.fields(bvh)}


def _bvh_verdicts(fields, n_tris, max_leaf=4):
    """(reference passes, port passes) on the same arrays. The reference's
    loop reads skip[i + 1] before it asserts i + 1 < n, so an IndexError
    is its rejection too."""
    verdicts = []
    for cls, check, rejects in (
            (ref_build.FlatBVH, ref_build.check_invariants,
             (AssertionError, IndexError)),
            (build.FlatBVH, build.check_invariants, AssertionError)):
        try:
            check(cls(**{k: v.copy() for k, v in fields.items()}), n_tris,
                  max_leaf)
            verdicts.append(True)
        except rejects:
            verdicts.append(False)
    return tuple(verdicts)


def test_check_invariants_passes_on_the_numpy_build(mesh_tris, mesh_bvh):
    n_tris = len(mesh_tris[0])
    assert _bvh_verdicts(_bvh_fields(mesh_bvh), n_tris) == (True, True)
    bvh6 = build.build_bvh(*mesh_tris, max_leaf=6)
    assert _bvh_verdicts(_bvh_fields(bvh6), n_tris, 6) == (True, True)
    # A leaf of up to 6 is over the default bound of 4.
    assert _bvh_verdicts(_bvh_fields(bvh6), n_tris) == (False, False)


def _first_leaf(f, at_least=1):
    return int(np.nonzero(f["count"] >= at_least)[0][0])


def _dup_triangle(f):
    f["order"][1] = f["order"][0]


def _backward_skip(f):
    f["skip"][10] = 3


def _leaf_over_max_leaf(f):
    f["count"][_first_leaf(f)] = 5


def _coverage_gap(f):
    f["count"][_first_leaf(f, 2)] -= 1


def _child_outside_parent(f):
    inner = int(np.nonzero(f["count"] == 0)[0][3])
    f["lo"][f["skip"][inner + 1]] = f["lo"][inner] - 0.01


BVH_TAMPERS = {
    "duplicated_triangle": _dup_triangle,
    "backward_skip": _backward_skip,
    "leaf_over_max_leaf": _leaf_over_max_leaf,
    "gap_in_leaf_coverage": _coverage_gap,
    "child_box_outside_parent": _child_outside_parent,
}


@pytest.mark.parametrize("tamper", list(BVH_TAMPERS))
def test_check_invariants_rejects_a_tampered_bvh(mesh_tris, mesh_bvh,
                                                 tamper):
    fields = _bvh_fields(mesh_bvh)
    BVH_TAMPERS[tamper](fields)
    with pytest.raises(AssertionError):
        ref_build.check_invariants(ref_build.FlatBVH(**fields),
                                   len(mesh_tris[0]))
    with pytest.raises(AssertionError):
        build.check_invariants(build.FlatBVH(**fields), len(mesh_tris[0]))


@pytest.mark.parametrize("seed", range(12))
def test_check_invariants_verdict_equals_the_reference(mesh_tris, mesh_bvh,
                                                       seed):
    """Random single-entry edits (a skip, count, first, order entry or a
    box corner moved by a small or a large step): the port's vectorised
    check gives the reference's verdict on each."""
    rng = np.random.default_rng(seed)
    n_tris = len(mesh_tris[0])
    for _ in range(8):
        fields = _bvh_fields(mesh_bvh)
        name = str(rng.choice(["skip", "count", "first", "order", "lo",
                               "hi"]))
        arr = fields[name]
        i = int(rng.integers(len(arr)))
        if arr.ndim == 2:
            arr[i, int(rng.integers(3))] += np.float32(
                rng.choice([-1e-7, 1e-7, -0.05, 0.05]))
        else:
            step = int(rng.choice([-2, -1, 1, 2, len(arr)]))
            arr[i] = max(arr[i] + step, -1)
        ref_ok, port_ok = _bvh_verdicts(fields, n_tris)
        assert ref_ok == port_ok, (name, i, ref_ok)


@pytest.fixture(scope="module")
def mesh_clusters(mesh_tris):
    """Both packages' cluster tables of cornell_mesh (64 clusters)."""
    return (clusters.build_clusters(*mesh_tris),
            ref_clusters.build_clusters(*mesh_tris))


def test_check_cluster_invariants_passes(mesh_tris, mesh_clusters):
    port, ref = mesh_clusters
    n_tris = len(mesh_tris[0])
    assert port.feat.shape == (clusters.FEAT_ROWS, port.lo.shape[0] * 512)
    clusters.check_cluster_invariants(port, n_tris)
    ref_clusters.check_cluster_invariants(ref, n_tris)


def _dup_slot(cs):
    cs.tri_map[1] = cs.tri_map[0]


def _empty_cluster(cs):
    """A 65th cluster with no triangle (every other invariant holds)."""
    cs.lo = np.concatenate([cs.lo, cs.lo[:1]])
    cs.hi = np.concatenate([cs.hi, cs.hi[:1]])
    cs.feat = np.concatenate([cs.feat, np.zeros_like(cs.feat[:, :512])], 1)
    cs.tri_map = np.concatenate([cs.tri_map,
                                 np.full(128, -1, cs.tri_map.dtype)])


def _lo_above_hi(cs):
    cs.lo[5, 1] = cs.hi[5, 1] + 0.01


def _wrong_feat_shape(cs):
    cs.feat = cs.feat[:, :-1]


CLUSTER_TAMPERS = {
    "duplicated_slot": _dup_slot,
    "empty_cluster": _empty_cluster,
    "lo_above_hi": _lo_above_hi,
    "wrong_feat_shape": _wrong_feat_shape,
}


@pytest.mark.parametrize("tamper", list(CLUSTER_TAMPERS))
def test_check_cluster_invariants_rejects_a_tampered_table(
        mesh_tris, mesh_clusters, tamper):
    n_tris = len(mesh_tris[0])
    for module, cs in zip((clusters, ref_clusters), mesh_clusters):
        cs = dataclasses.replace(cs, **{
            f.name: getattr(cs, f.name).copy()
            for f in dataclasses.fields(cs)})
        CLUSTER_TAMPERS[tamper](cs)
        with pytest.raises(AssertionError):
            module.check_cluster_invariants(cs, n_tris)


def test_check_cluster_invariants_max_tris(mesh_tris, mesh_clusters):
    """Clusters of up to 128 break a bound of 64 in both packages, and
    pass the bound they were built with."""
    n_tris = len(mesh_tris[0])
    for module, cs in zip((clusters, ref_clusters), mesh_clusters):
        with pytest.raises(AssertionError):
            module.check_cluster_invariants(cs, n_tris, max_tris=64)
        small = module.build_clusters(*mesh_tris, max_tris=64)
        module.check_cluster_invariants(small, n_tris, max_tris=64)
