"""The port's wavefront engine against the reference's, end to end.

Both packages render the same carried scene at the same seeds on the CPU
(the reference's cluster kernel in Pallas interpret mode, the port's plain
PyTorch version). Bars are the reference's own: cluster vs jnp engine
rtol/atol 2e-3 (tests/unit/test_cluster.py), engine vs oracle atol 5e-4
rtol 1e-3 for direct light and 1e-3/2e-3 for multi-bounce
(tests/oracle/test_engine.py); compaction must not change a bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.auto import prepare_accel as ref_prepare_accel
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.engine import wavefront as ref_wavefront
from pathtracer_tpu.engine.camera import camera_rays as ref_camera_rays
from pathtracer_tpu.engine.camera import tiled_pixel_ids as ref_tiled_ids
from pathtracer_tpu.engine.wavefront import trace_sample as ref_trace_sample
from pathtracer_tpu.sampling import rng as ref_rng
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu_torch import render
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.camera import camera_rays, tiled_pixel_ids
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
PARTS = ("geometry", "materials", "camera", "lights")


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


def _both(cfg: dict):
    return RenderConfig(**cfg), RefConfig(**cfg)


@pytest.fixture(scope="module")
def small_mesh():
    """The goldens' small mesh scene (bunny subdiv 2), BVH + clusters."""
    ref = ref_with_clusters(ref_with_bvh(ref_builder.cornell_mesh(
        mesh_tris=ref_builder.procedural_bunny(2))))
    return ref, _carry(ref)


SLICE = dict(width=32, height=32, spp=1, max_depth=4, rr_start=2,
             scene="cornell_mesh", use_bvh=True, backend="cluster",
             compact=True)


def test_camera_rays_match():
    scene = builder.cornell_spheres()
    ref = ref_builder.cornell_spheres()
    ids = np.arange(48 * 40, dtype=np.uint32)
    jitter = np.array(ref_rng.pixel_jitter(0, 0, ids))
    o_r, d_r = ref_camera_rays(ref.camera, 48, 40, jitter, ids)
    o, d = camera_rays(scene.camera, 48, 40, torch.from_numpy(jitter),
                       torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=1e-6)


def test_tiled_pixel_ids_equal():
    for start, n, width in [(0, 1024 * 64, 1024), (1024 * 16, 1024 * 32,
                                                   1024), (5, 100, 30)]:
        want = np.asarray(ref_tiled_ids(np.uint32(start), n, width))
        got = tiled_pixel_ids(start, n, width).numpy()
        np.testing.assert_array_equal(got, want)


def test_slice_matches_reference(small_mesh):
    """The main path (cluster backend, compaction, depth 4, roulette from
    bounce 2) at 32x32 against the reference on the same scene."""
    ref, scene = small_mesh
    cfg, ref_cfg = _both(SLICE)
    img = render(scene, cfg, device="cpu").numpy()
    want = np.asarray(ref_wavefront.render(ref, ref_cfg))
    assert img.shape == (32, 32, 3)
    np.testing.assert_allclose(img, want, rtol=2e-3, atol=2e-3)


def test_trace_sample_stats_and_tiled_order(small_mesh):
    """trace_sample over tile-ordered ids returns the same per-pixel
    radiance as the row-major render, and counts useful rays."""
    _, scene = small_mesh
    cfg = RenderConfig(**SLICE)
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width)
    rad, n = wavefront.trace_sample(scene.geometry, scene.materials,
                                    scene.camera, scene.lights, cfg, ids, 0,
                                    with_stats=True)
    img = render(scene, cfg, device="cpu").reshape(-1, 3)
    assert torch.equal(rad, img[ids])
    assert cfg.n_pixels < int(n) < 2 * cfg.max_depth * cfg.n_pixels


@pytest.mark.parametrize("backend", ["cluster", "jnp"])
def test_compact_equals_plain_bit_for_bit(small_mesh, backend):
    _, scene = small_mesh
    cfg = RenderConfig(**{**SLICE, "rr_start": 1, "backend": backend,
                          "use_bvh": backend == "cluster"})
    a = render(scene, cfg, device="cpu")
    b = render(scene, cfg.replace(compact=False), device="cpu")
    assert torch.equal(a, b)


# The frame whose useful rays (the numerator of every benchmark cell's rate)
# are held to the reference's on each route: name -> (backend, use_bvh).
RAY_ROUTES = {"brute": ("jnp", False), "bvh": ("jnp", True),
              "cluster": ("cluster", True), "grid": ("grid", True),
              "stream": ("stream", True)}
RAY_FRAME = dict(width=16, height=16, spp=2, max_depth=3,
                 scene="cornell_mesh")


@pytest.fixture(scope="module", params=list(RAY_ROUTES))
def route_scene(request):
    """cornell_mesh prepared for one route by the reference, the same
    arrays carried into the port, and the frame's configs."""
    backend, use_bvh = RAY_ROUTES[request.param]
    cfg, ref_cfg = _both({**RAY_FRAME, "backend": backend,
                          "use_bvh": use_bvh})
    ref = ref_builder.cornell_mesh()
    if use_bvh:
        ref = ref_with_bvh(ref)
    ref = ref_prepare_accel(ref, ref_cfg)
    scene = _carry(ref)
    assert wavefront._intersector(scene.geometry, cfg).impl \
        == request.param
    return ref, scene, cfg, ref_cfg


@pytest.mark.parametrize("spp_idx", [0, 1])
def test_useful_rays_equal_reference(route_scene, spp_idx):
    """trace_sample(with_stats=True)'s useful rays (live path segments
    plus candidate shadow rays) of a tile-ordered frame equal the
    reference's count on the same route, exactly, for each spp sample."""
    ref, scene, cfg, ref_cfg = route_scene
    _, want = ref_trace_sample(
        ref.geometry, ref.materials, ref.camera, ref.lights, ref_cfg,
        ref_tiled_ids(0, ref_cfg.n_pixels, ref_cfg.width),
        jnp.uint32(spp_idx), with_stats=True)
    _, got = wavefront.trace_sample(
        scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
        tiled_pixel_ids(0, cfg.n_pixels, cfg.width), spp_idx,
        with_stats=True)
    assert int(want) > cfg.n_pixels
    assert int(got) == int(want)


@pytest.mark.parametrize("scene_name,cfg", [
    ("cornell_spheres", dict(width=64, height=64, spp=1, max_depth=1,
                             use_bvh=False)),
    ("cornell_specular", dict(width=24, height=24, spp=2, max_depth=5,
                              rr_start=2, use_bvh=False)),
    ("cornell_biglight", dict(width=24, height=24, spp=1, max_depth=3,
                              use_bvh=False, mis=True)),
    ("cornell_sphlight", dict(width=24, height=24, spp=1, max_depth=3,
                              use_bvh=False, mis=True)),
])
def test_brute_path_matches_reference(scene_name, cfg):
    """config1 (direct light) and the delta-lobe, MIS and sphere-light
    branches, on the brute-force route."""
    ref = ref_builder.build_scene(scene_name)
    cfg, ref_cfg = _both({**cfg, "scene": scene_name})
    img = render(_carry(ref), cfg, device="cpu").numpy()
    want = np.asarray(ref_wavefront.render(ref, ref_cfg))
    if cfg.max_depth == 1:
        np.testing.assert_allclose(img, want, atol=5e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(img, want, atol=1e-3, rtol=2e-3)


def test_spp_chunking_sums_samples(small_mesh):
    _, scene = small_mesh
    cfg = RenderConfig(**{**SLICE, "width": 16, "height": 16, "spp": 3})
    full = render(scene, cfg, device="cpu")
    chunked = render(scene, cfg.replace(spp_chunk=1), device="cpu")
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-6)
    parts = [wavefront.render_accumulate(scene, cfg, spp_start=s, n_spp=1)
             for s in range(3)]
    np.testing.assert_allclose(((parts[0] + parts[1] + parts[2]) / 3.0)
                               .reshape(16, 16, 3).numpy(), full.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["config1_64", "config3_32"])
def test_port_matches_golden(name):
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    if name == "config1_64":
        scene = builder.cornell_spheres()
        cfg = RenderConfig(width=64, height=64, spp=4, max_depth=1,
                           scene="cornell_spheres", use_bvh=False)
        rtol, atol = 1e-3, 5e-4
    else:
        # Rendered by the reference through its BVH walk; the port takes
        # the cluster route the bench uses.
        cfg = RenderConfig(width=32, height=32, spp=4, max_depth=4,
                           rr_start=2, scene="cornell_mesh", use_bvh=True,
                           backend="cluster", compact=True)
        scene = prepare_accel(with_bvh(builder.cornell_mesh(
            mesh_tris=builder.procedural_bunny(2))), cfg)
        rtol, atol = 2e-3, 2e-3
    img = render(scene, cfg, device="cpu").numpy()
    np.testing.assert_allclose(img, golden, rtol=rtol, atol=atol)


@pytest.mark.parametrize("backend,use_bvh,impl", [
    ("cluster", True, "cluster"), ("grid", True, "grid"),
    ("stream", True, "stream"), ("jnp", True, "bvh"),
    ("pallas", True, "pallas"), ("jnp", False, "brute"),
])
def test_backend_routes(backend, use_bvh, impl):
    """Every backend name, on a scene prepared for it, routes to its
    intersector and renders."""
    cfg = RenderConfig(**{**SLICE, "width": 8, "height": 8,
                          "backend": backend, "use_bvh": use_bvh})
    scene = builder.cornell_mesh(mesh_tris=builder.procedural_bunny(2))
    if use_bvh:
        scene = with_bvh(scene)
    scene = prepare_accel(scene, cfg)
    assert wavefront._intersector(scene.geometry, cfg).impl == impl
    img = render(scene, cfg, device="cpu")
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_unported_backends_raise(small_mesh):
    """A backend whose tables were not built raises ValueError naming
    prepare_accel: the grid route without grid tables and the stream route
    without cluster tables (every backend is ported; test_backend_routes
    renders each one)."""
    _, scene = small_mesh
    with pytest.raises(ValueError, match="prepare_accel"):
        render(scene, RenderConfig(**{**SLICE, "backend": "grid"}),
               device="cpu")
    bvh_only = with_bvh(builder.cornell_mesh(
        mesh_tris=builder.procedural_bunny(2)))
    with pytest.raises(ValueError, match="prepare_accel"):
        render(bvh_only, RenderConfig(**{**SLICE, "backend": "stream"}),
               device="cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import pathtracer_tpu_torch as pt\n"
        "from pathtracer_tpu_torch.accel.auto import prepare_accel\n"
        "from pathtracer_tpu_torch.accel.build import with_bvh\n"
        "cfg = pt.PRESETS['bench'].replace(width=8, height=8)\n"
        "scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene)), cfg)\n"
        "img = pt.render(scene, cfg, device='cpu')\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "cfg = pt.PRESETS['config5'].replace(width=8, height=8)\n"
        "scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene, "
        "n_target=3000), engine='native'), cfg)\n"
        "img = pt.render(scene, cfg, device='cpu')\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "cfg = cfg.replace(backend='stream')\n"
        "scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene, "
        "n_target=3000), engine='native'), cfg)\n"
        "img = pt.render(scene, cfg, device='cpu')\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "cfg = pt.PRESETS['config3'].replace(width=8, height=8, spp=2)\n"
        "scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene)), cfg)\n"
        "img = pt.render(scene, cfg, device='cpu')\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "cfg = pt.PRESETS['config4'].replace(width=8, height=8, spp=2)\n"
        "loss, g = pt.grad_render(pt.build_scene(cfg.scene), cfg, "
        "device='cpu')\n"
        "assert bool(torch.isfinite(g.albedo).all()) and float(loss) > 0\n"
        "from pathtracer_tpu_torch.utils import profiling  # noqa: F401\n"
        "from pathtracer_tpu_torch.ops import visit_probe\n"
        "assert visit_probe.main(['split_pre', '--device', 'cpu']) == 0\n"
        "from pathtracer_tpu_torch.parallel import mesh as pmesh\n"
        "cfg = pt.PRESETS['bench'].replace(width=8, height=8)\n"
        "scene = prepare_accel(with_bvh(pt.build_scene(cfg.scene)), cfg)\n"
        "img = pmesh.render_sharded(scene, cfg, "
        "pmesh.make_mesh(device='cpu'))\n"
        "assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())\n"
        "from pathtracer_tpu_torch import checks, grid_profile  # noqa: F401\n"
        "from pathtracer_tpu_torch import roofline  # noqa: F401\n"
        "from pathtracer_tpu_torch.oracle import tracer\n"
        "cfg = pt.PRESETS['config1'].replace(width=8, height=8)\n"
        "img = tracer.render(pt.build_scene(cfg.scene), cfg)\n"
        "assert img.shape == (8, 8, 3) and img.mean() > 0\n"
        "from pathtracer_tpu_torch.accel import build, clusters\n"
        "from pathtracer_tpu_torch.ops import intersect_cluster as ic\n"
        "g = pt.build_scene('cornell_mesh').geometry\n"
        "tris = [x.numpy() for x in (g.tri_v0, g.tri_e1, g.tri_e2)]\n"
        "build.check_invariants(build.build_bvh(*tris, max_leaf=6), "
        "len(tris[0]), 6)\n"
        "cs = clusters.build_clusters(*tris)\n"
        "clusters.check_cluster_invariants(cs, len(tris[0]))\n"
        "o = torch.full((512, 3), 0.5)\n"
        "d = torch.nn.functional.normalize(torch.randn(512, 3), dim=1)\n"
        "mask = ic.cull_mask(torch.from_numpy(cs.lo), "
        "torch.from_numpy(cs.hi), o, d)\n"
        "assert mask.shape == (1, len(cs.lo)) and bool(mask.any())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pathtracer_tpu.') or m == 'pathtracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_entry_points_default_to_the_card(small_mesh, monkeypatch):
    """render and grad_render run on CUDA unless given device="cpu": with
    no CUDA device they raise, with device="cpu" they run there."""
    import pathtracer_tpu_torch as pt

    _, scene = small_mesh
    cfg = RenderConfig(**{**SLICE, "width": 8, "height": 8})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.render(scene, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.grad_render(scene, cfg)
    img = pt.render(scene, cfg, device="cpu")
    assert img.device.type == "cpu" and img.shape == (8, 8, 3)
    loss, grads = pt.grad_render(scene, cfg, device="cpu")
    assert grads.albedo.device.type == "cpu" and float(loss) > 0.0
