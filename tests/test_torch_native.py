"""The port's native BVH builder and big_mesh against the reference's.

Both wrappers drive the same C++ source, native/bvh_builder.cpp, compiled
with native/Makefile's flags; the port builds it into build/native/. The
reference is pointed at that same library, so the two wrappers are compared
on one binary and no test writes into native/. Host tables are bit-exact by
design: every array must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu.accel import build as ref_build
from pathtracer_tpu.accel import clusters as ref_clusters
from pathtracer_tpu.accel import native as ref_native
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu_torch.accel import build, clusters, native
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.scene import builder

torch.set_num_threads(2)

PARTS = ("geometry", "materials", "camera", "lights")


@pytest.fixture(scope="module")
def big_pair():
    """big_mesh at ~20k triangles from both packages."""
    return (builder.big_mesh(n_target=20_000),
            ref_builder.big_mesh(n_target=20_000))


@pytest.fixture
def ref_on_port_library(monkeypatch):
    native.load()
    monkeypatch.setattr(ref_native, "_LIB_PATH", native.BUILD["path"])
    monkeypatch.setattr(ref_native, "_lib", None)
    assert ref_native.available()


def _assert_equal(port, ref, parts=PARTS):
    """Every array equal, dtype included; the cluster feature table (empty
    here: no clusters yet) through its bf16 stack."""
    for part in parts:
        x = getattr(ref, part)
        for f in dataclasses.fields(x):
            want = np.asarray(getattr(x, f.name))
            got = getattr(getattr(port, part), f.name)
            if f.name == "cl_feat":
                got = clusters.stack_feat_bf16(got).view(torch.int16).numpy()
                want = want.view(np.int16)
            else:
                got = got.numpy()
            assert got.dtype == want.dtype, (part, f.name)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{part}.{f.name}")


def test_big_mesh_equal(big_pair):
    port, ref = big_pair
    _assert_equal(port, ref)
    assert port.geometry.tri_v0.shape[0] == 12 + 15 * 1280


def test_native_builder_equal(big_pair, ref_on_port_library):
    port, ref = big_pair
    g = ref.geometry
    args = [np.asarray(a) for a in (g.tri_v0, g.tri_e1, g.tri_e2)]
    got = native.build_bvh_native(*args)
    want = ref_native.build_bvh_native(*args)
    for name in ("lo", "hi", "first", "count", "skip", "order"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert native.BUILD["path"].startswith(str(native.BUILD_DIR))


@pytest.mark.parametrize("engine", ["native", "auto"])
def test_with_bvh_native_equal(big_pair, ref_on_port_library, monkeypatch,
                               engine):
    """engine="native", and "auto" above the threshold (lowered here), give
    the reference's triangle order, BVH and light indices."""
    from pathtracer_tpu.accel import build as ref_build
    from pathtracer_tpu_torch.accel import build

    monkeypatch.setattr(build, "AUTO_NATIVE_THRESHOLD", 1000)
    monkeypatch.setattr(ref_build, "AUTO_NATIVE_THRESHOLD", 1000)
    port, ref = big_pair
    got = with_bvh(port, engine=engine)
    _assert_equal(got, ref_with_bvh(ref, engine=engine))
    numpy_order = with_bvh(port, engine="numpy").geometry.tri_v0
    assert not torch.equal(numpy_order, got.geometry.tri_v0)


def _tris(scene):
    g = scene.geometry
    return [g.tri_v0.numpy(), g.tri_e1.numpy(), g.tri_e2.numpy()]


@pytest.mark.parametrize("max_leaf", [4, 6])
def test_check_invariants_on_the_native_build(big_pair, ref_on_port_library,
                                              max_leaf):
    """Both packages' checks pass on the native SAH build of big_mesh, the
    builder of config 5's 2M-triangle tree, and both reject it against a
    leaf bound below its largest leaf."""
    args = _tris(big_pair[0])
    n_tris = len(args[0])
    bvh = native.build_bvh_native(*args, max_leaf)
    want = ref_native.build_bvh_native(*args, max_leaf)
    for f in dataclasses.fields(bvh):
        np.testing.assert_array_equal(getattr(bvh, f.name),
                                      getattr(want, f.name))
    build.check_invariants(bvh, n_tris, max_leaf)
    ref_build.check_invariants(want, n_tris, max_leaf)
    largest = int(bvh.count.max())
    assert 1 < largest <= max_leaf
    for check, table in ((build.check_invariants, bvh),
                         (ref_build.check_invariants, want)):
        with pytest.raises(AssertionError):
            check(table, n_tris, largest - 1)


def test_check_cluster_invariants_on_big_mesh(big_pair):
    """Both packages' cluster checks pass on big_mesh's cluster tables (the
    stream route's, with_clusters), each on its own layout."""
    args = _tris(big_pair[0])
    n_tris = len(args[0])
    cs = clusters.build_clusters(*args)
    ref_cs = ref_clusters.build_clusters(*args)
    np.testing.assert_array_equal(cs.tri_map, ref_cs.tri_map)
    assert len(cs.lo) >= -(-n_tris // clusters.CLUSTER_TRIS)
    clusters.check_cluster_invariants(cs, n_tris)
    ref_clusters.check_cluster_invariants(ref_cs, n_tris)
