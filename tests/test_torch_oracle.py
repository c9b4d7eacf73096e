"""The port's numpy oracle (oracle/tracer.py) against the reference's, and
the port's engine against the port's oracle.

The oracle is the reference's, statement for statement, with its draws
from the port's sampler: the same numpy math on bit-equal threefry draws,
so it must equal the reference's oracle bit for bit (np.array_equal) in
every case. The port's engine (device="cpu") is held to the port's oracle
on the patterns of the reference's tests/oracle/ suite, at their bars:
lockstep images (atol 5e-4 / rtol 1e-3 for direct light, 1e-3 / 2e-3
multi-bounce), the furnace identity at 1e-5, roulette and MIS
unbiasedness, MIS doing nothing without lights, the sphere light against
a triangulated sphere, and sphere-light emission grads against the
oracle's finite differences (rtol 2e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu import constants as RC
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.oracle import tracer as ref_oracle
from pathtracer_tpu.sampling import rng as ref_rng
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu.scene import model as ref_model
import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch import constants as C
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.checks import furnace_scene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.oracle import tracer as oracle
from pathtracer_tpu_torch.scene import builder, model

torch.set_num_threads(2)


def _ref_furnace(albedo: float):
    """tests/oracle/test_furnace.py's scene in the reference's package:
    one diffuse sphere in a uniform background of radiance 1."""
    geom = ref_model.make_geometry(
        tri_verts=np.zeros((0, 3, 3), np.float32),
        tri_mat=np.zeros((0,), np.int32),
        sph_c=np.array([[0.0, 0.0, 2.5]], np.float32),
        sph_r=np.array([1.0], np.float32),
        sph_mat=np.array([0], np.int32),
    )
    mats = ref_model.Materials(albedo=np.full((1, 3), albedo, np.float32),
                               emission=np.zeros((1, 3), np.float32))
    return ref_model.Scene(
        geometry=geom, materials=mats, camera=ref_builder.default_camera(),
        lights=ref_model.make_lights(geom, mats, background=(1.0, 1.0, 1.0)))


def _scenes(name: str):
    """(port scene, reference scene) of a builtin scene or the furnace (the
    port's is checks.py's); the builders are array-for-array equal
    (tests/test_torch_scene.py)."""
    if name.startswith("furnace"):
        albedo = float(name.split("_")[1])
        return furnace_scene(albedo), _ref_furnace(albedo)
    if name == "cornell_mesh":
        return (with_bvh(builder.cornell_mesh()),
                ref_with_bvh(ref_builder.cornell_mesh()))
    return builder.build_scene(name), getattr(ref_builder, name)()


def _cfg(scene: str, **kw):
    base = dict(width=24, height=24, spp=2, max_depth=3, rr_start=99,
                scene=scene, use_bvh=scene == "cornell_mesh")
    base.update(kw)
    return base


# -- the port's oracle against the reference's, bit for bit --------------

def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(mod, scene):
    ids = np.arange(48 * 40, dtype=np.uint32)
    jitter = np.asarray(ref_rng.pixel_jitter(0, 3, ids))
    return mod.camera_rays(scene.camera, 48, 40, jitter)


def _cosine(mod, scene):
    rng = np.random.default_rng(1)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u1, u2 = rng.random((2, 512)).astype(np.float32)
    return (mod.cosine_hemisphere(n, u1, u2),)


def _light(mod, scene):
    u = np.random.default_rng(2).random((3, 4096)).astype(np.float32)
    return mod._sample_light(scene.lights, scene.geometry, *u)


def _closest(mod, scene):
    return mod.intersect_closest(scene.geometry, *_rays(2048))


@pytest.mark.parametrize("fn, scene", [
    (_camera_rays, "cornell_spheres"),
    (_cosine, "cornell_spheres"),
    (_light, "cornell_sphlight"),
    (_closest, "cornell_mesh"),
    (_closest, "cornell_sphlight"),
])
def test_oracle_functions_bit_equal(fn, scene):
    ours, ref = _scenes(scene)
    got, want = fn(oracle, ours), fn(ref_oracle, ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


RENDER_CASES = {
    "config1 32x32": _cfg("cornell_spheres", width=32, height=32, spp=1,
                          max_depth=1, rr_start=2),
    "sphlight": _cfg("cornell_sphlight"),
    "sphlight mis": _cfg("cornell_sphlight", mis=True),
    "biglight mis": _cfg("cornell_biglight", mis=True),
    "specular": _cfg("cornell_specular", max_depth=5, rr_start=2),
    "furnace rr": _cfg("furnace_0.5", width=16, height=16, spp=4,
                       rr_start=0),
    "config2 mesh": _cfg("cornell_mesh", spp=1, max_depth=1, rr_start=2),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_oracle_render_bit_equal(case):
    kw = RENDER_CASES[case]
    ours, ref = _scenes(kw["scene"])
    got = oracle.render(ours, RenderConfig(**kw))
    want = ref_oracle.render(ref, RefConfig(**kw))
    assert got.shape == (kw["height"], kw["width"], 3)
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_array_equal(got, want)


def test_constants_shared():
    for name in ("DET_EPS", "T_MIN", "T_FAR", "RAY_OFFSET", "SHADOW_REL_EPS",
                 "RR_CLAMP_LO", "RR_CLAMP_HI", "MAT_DIFF", "MAT_SPEC",
                 "MAT_REFR"):
        assert getattr(C, name) == getattr(RC, name), name


# -- the port's engine against the port's oracle -------------------------

def _engine(scene, cfg: RenderConfig) -> np.ndarray:
    return pt.render(scene, cfg, device="cpu").numpy()


LOCKSTEP = {
    # tests/oracle/test_engine.py, test_mis.py, test_sphlight.py: (config,
    # atol, rtol)
    "config1": (_cfg("cornell_spheres", width=64, height=64, spp=1,
                     max_depth=1, rr_start=2), 5e-4, 1e-3),
    "multibounce rr": (_cfg("cornell_spheres", width=32, height=32,
                            max_depth=4, rr_start=1), 1e-3, 1e-3),
    "config2 mesh bvh": (_cfg("cornell_mesh", width=32, height=32, spp=1,
                              max_depth=1, rr_start=2), 5e-4, 1e-3),
    "config3 gi": (_cfg("cornell_mesh", max_depth=4, rr_start=2), 1e-3,
                   2e-3),
    "specular": (_cfg("cornell_specular", max_depth=5, rr_start=2), 1e-3,
                 2e-3),
    "biglight mis": (_cfg("cornell_biglight", width=48, height=48,
                          mis=True), 5e-4, 1e-3),
    "sphlight": (_cfg("cornell_sphlight", width=48, height=48), 5e-4,
                 1e-3),
    "sphlight mis": (_cfg("cornell_sphlight", width=48, height=48,
                          mis=True), 5e-4, 1e-3),
}


@pytest.mark.parametrize("case", sorted(LOCKSTEP))
def test_engine_matches_oracle(case):
    kw, atol, rtol = LOCKSTEP[case]
    scene, _ = _scenes(kw["scene"])
    cfg = RenderConfig(**kw)
    np.testing.assert_allclose(_engine(scene, cfg), oracle.render(scene, cfg),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("albedo", [1.0, 0.5])
def test_furnace_identity(albedo):
    """Depth 2, no roulette: every pixel is the background (1) or the
    sphere's albedo, within 1e-5, on the engine and the oracle."""
    scene, _ = _scenes(f"furnace_{albedo}")
    cfg = RenderConfig(width=32, height=32, spp=1, max_depth=2, rr_start=8,
                       scene="furnace", use_bvh=False)
    img = _engine(scene, cfg)
    np.testing.assert_allclose(img, oracle.render(scene, cfg), atol=1e-5)
    flat = img.reshape(-1, 3)
    is_bg = np.all(np.abs(flat - 1.0) < 1e-5, axis=-1)
    is_srf = np.all(np.abs(flat - albedo) < 1e-5, axis=-1)
    assert np.all(is_bg | is_srf)
    assert is_srf.any() and is_bg.any()


UNBIASED = {
    # (scene, render kw, the variant's kw, bar on |mean difference|: an
    # absolute one, or relative to the base image's mean) at the bars of
    # test_furnace.py, test_oracle.py, test_mis.py and test_sphlight.py
    "furnace rr": ("furnace_0.5", dict(width=16, height=16, spp=256,
                                       rr_start=8),
                   dict(rr_start=0), ("abs", 0.01)),
    "spheres rr": ("cornell_spheres", dict(width=12, height=12, spp=256,
                                           rr_start=99),
                   dict(rr_start=1), ("rel", 0.05)),
    "biglight mis": ("cornell_biglight", dict(width=16, height=16, spp=256),
                     dict(mis=True), ("rel", 0.01)),
    "sphlight mis": ("cornell_sphlight", dict(width=16, height=16, spp=256),
                     dict(mis=True), ("rel", 0.015)),
}


@pytest.mark.parametrize("case", sorted(UNBIASED))
def test_engine_estimators_unbiased(case):
    """Roulette and MIS keep the expectation: the base and the variant
    images' means agree within the reference's bars; with MIS on the big
    light, also test_mis.py's per-pixel bar (|mis - base| / (|base| +
    0.05) under 0.25 on more than 99% of pixels)."""
    name, kw, variant, (kind, bar) = UNBIASED[case]
    scene, _ = _scenes(name)
    cfg = RenderConfig(**_cfg(name, **kw))
    base = _engine(scene, cfg)
    other = _engine(scene, cfg.replace(**variant))
    scale = base.mean() if kind == "rel" else 1.0
    assert abs(base.mean() - other.mean()) < bar * scale, \
        (base.mean(), other.mean())
    if case == "biglight mis":
        dev = np.abs(other - base) / (np.abs(base) + 0.05)
        assert (dev < 0.25).mean() > 0.99, (dev.max(), (dev >= 0.25).sum())


def test_mis_noop_without_lights():
    scene = builder.cornell_spheres(background=(1.0, 1.0, 1.0))
    mats = scene.materials.replace(
        emission=torch.zeros_like(scene.materials.emission))
    scene = dataclasses.replace(
        scene, materials=mats,
        lights=model.make_lights(scene.geometry, mats, (1.0, 1.0, 1.0)))
    cfg = RenderConfig(width=24, height=24, spp=2, max_depth=2,
                       use_bvh=False)
    np.testing.assert_array_equal(_engine(scene, cfg),
                                  _engine(scene, cfg.replace(mis=True)))


def _box_with_light(sph: bool):
    """test_sphlight.py's box lit only by a sphere: analytic (sph=True) or
    a subdiv-3 icosphere of the same center, radius and radiance."""
    c = np.array([0.5, 0.72, 0.5], np.float32)
    r = np.float32(0.12)
    tris, mats = builder._walls()
    if sph:
        geom = model.make_geometry(
            tris, mats, sph_c=c[None, :], sph_r=np.array([r], np.float32),
            sph_mat=np.array([builder.SPHERE_B], np.int32))
    else:
        ico = builder._icosphere(3).astype(np.float32) * r + c
        geom = model.make_geometry(
            np.concatenate([tris, ico]),
            np.concatenate([mats, np.full(len(ico), builder.SPHERE_B,
                                          np.int32)]))
    base = builder.default_materials()
    emission = base.emission.clone()
    emission[builder.LIGHT] = 0.0
    emission[builder.SPHERE_B] = 10.0
    materials = base.replace(emission=emission)
    return model.Scene(geometry=geom, materials=materials,
                       camera=builder.default_camera(),
                       lights=model.make_lights(geom, materials))


def test_sphere_light_consistent_with_triangulated():
    """The icosphere is inscribed (about 2% less area and power at subdiv
    3); 5% covers that and the noise."""
    cfg = RenderConfig(width=16, height=16, spp=48, max_depth=2,
                       rr_start=99, use_bvh=False)
    m_s = _engine(_box_with_light(True), cfg).mean()
    m_t = _engine(_box_with_light(False), cfg).mean()
    assert abs(m_s - m_t) < 0.05 * max(m_s, m_t), (m_s, m_t)


def test_sphere_light_emission_grads_match_oracle_fd():
    """d mean(image) / d emission of the emissive sphere by autograd
    through the engine against central differences of the oracle."""
    scene = builder.cornell_sphlight()
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2, rr_start=99,
                       scene="cornell_sphlight", use_bvh=False)
    _, grads = pt.grad_render(scene, cfg, device="cpu")
    g_em = grads.emission.numpy()
    assert np.isfinite(g_em).all()
    assert abs(g_em[builder.SPHERE_B]).sum() > 0
    eps = 5e-2
    means = []
    for sign in (1.0, -1.0):
        em = scene.materials.emission.clone()
        em[builder.SPHERE_B, 0] += sign * eps
        means.append(oracle.render(dataclasses.replace(
            scene, materials=scene.materials.replace(emission=em)),
            cfg).mean())
    fd = (means[0] - means[1]) / (2 * eps)
    np.testing.assert_allclose(g_em[builder.SPHERE_B, 0], fd, rtol=2e-2,
                               atol=1e-6)


# -- the port's oracle against closed forms (tests/oracle/test_oracle.py) --

def test_oracle_direct_light_closed_form():
    """Under the light's center, the oracle's NEE estimate converges to the
    form-factor integral by dense quadrature over the light rectangle."""
    scene = builder.cornell_spheres()
    albedo = scene.materials.albedo[builder.WHITE].numpy()
    Le = scene.materials.emission[builder.LIGHT].numpy()
    p = np.array([0.5, 0.0, 0.5])
    xs = np.linspace(0.325, 0.675, 200)
    X, Z = np.meshgrid(xs, xs)
    d = np.stack([X - p[0], np.full_like(X, 0.9995) - p[1], Z - p[2]], -1)
    dist2 = (d ** 2).sum(-1)
    cos = d[..., 1] / np.sqrt(dist2)  # floor normal +y, light normal -y
    integral = (cos * cos / dist2 * (0.35 / 200) ** 2).sum()
    expected = albedo / np.pi * Le * integral

    N = 20000
    u = np.random.default_rng(3).random((N, 3)).astype(np.float32)
    x_l, n_l, mat_l = oracle._sample_light(scene.lights, scene.geometry,
                                           u[:, 0], u[:, 1], u[:, 2])
    o = np.tile(p.astype(np.float32), (N, 1)) + np.array(
        [0, C.RAY_OFFSET, 0], np.float32)
    dvec = x_l - o
    dist = np.linalg.norm(dvec, axis=-1)
    wi = dvec / dist[:, None]
    cl = -(n_l * wi).sum(-1)
    est = ((albedo / np.pi)[None, :] * scene.materials.emission.numpy()[mat_l]
           * (wi[:, 1] * cl * float(scene.lights.total_area)
              / dist ** 2)[:, None]).mean(0)
    np.testing.assert_allclose(est, expected, rtol=0.02)


def test_oracle_emission_only_on_primary():
    """Depth 2 adds bounded indirect light, not a second direct term."""
    scene = builder.cornell_spheres()
    cfg = RenderConfig(width=48, height=48, spp=8, max_depth=1,
                       scene="cornell_spheres")
    gain = (oracle.render(scene, cfg.replace(max_depth=2)).mean()
            / oracle.render(scene, cfg).mean())
    assert 1.0 < gain < 1.9, gain
