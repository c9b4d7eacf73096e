"""The port's scene and acceleration tables against the reference's.

Host tables are bit-exact by design in both packages (the same numpy
builders), so every array must be equal, dtype included; the cluster
feature table is compared through its bf16 [hi; hi; lo] stack.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu.accel import clusters as ref_clusters
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu.scene import model as ref_model
from pathtracer_tpu_torch.accel import clusters
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
