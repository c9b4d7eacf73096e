"""The port's material gradients (diff/render.py) against the reference.

Scenes come over through scene/convert.py:scene_from_arrays, so both
packages differentiate the very same arrays. Bars: the port's grads against
the reference's jax.grad at rtol 2e-3 / atol 1e-6 (the engine-vs-engine
image bar is 2e-3); against central finite differences at the bars of
tests/grad/test_grad.py (albedo rtol 2e-2, emission atol 1e-6, the
oracle's FD rtol 3e-2); compact against non-compact at rtol 1e-5; the
checkpointed spp loop against the unrolled one bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.diff import render as ref_dr
from pathtracer_tpu.engine.shading import take_small_rows as ref_take_rows
from pathtracer_tpu.oracle import tracer as oracle
from pathtracer_tpu.scene import builder as ref_builder
import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.diff import render as dr
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.shading import take_rows
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays
from pathtracer_tpu_torch.scene.model import Materials

torch.set_num_threads(2)

PARTS = ("geometry", "materials", "camera", "lights")
GEOMETRY_FLOATS = ("tri_v0", "tri_e1", "tri_e2", "tri_n", "sph_c", "sph_r",
                   "bvh_lo", "bvh_hi", "cl_lo", "cl_hi", "cl_feat",
                   "cl_slot_nm", "bvh_nodes", "bvh_tris", "bvh_pairs")


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


def _cfg(**kw):
    """tests/grad/test_grad.py's configuration: RR off, so finite
    differences of the estimator stay smooth."""
    base = dict(width=24, height=24, spp=2, max_depth=2,
                scene="cornell_spheres", use_bvh=False, rr_start=99)
    base.update(kw)
    return RenderConfig(**base)


MESH = dict(width=32, height=32, spp=1, max_depth=4, rr_start=2,
            scene="cornell_mesh", use_bvh=True, backend="cluster",
            compact=True)


@pytest.fixture(scope="module")
def spheres():
    ref = ref_builder.cornell_spheres()
    return ref, _carry(ref)


@pytest.fixture(scope="module")
def small_mesh():
    """The goldens' small mesh scene (bunny subdiv 2), BVH + clusters."""
    ref = ref_with_clusters(ref_with_bvh(ref_builder.cornell_mesh(
        mesh_tris=ref_builder.procedural_bunny(2))))
    return ref, _carry(ref)


def _perturb(mats, field, idx, ch, eps):
    arr = getattr(mats, field).clone()
    arr[idx, ch] += eps
    return dataclasses.replace(mats, **{field: arr})


def _fd_engine(scene, cfg, field, idx, ch, eps=2e-3):
    with torch.no_grad():
        lo = dr.render_image(scene, cfg,
                             _perturb(scene.materials, field, idx, ch, -eps))
        hi = dr.render_image(scene, cfg,
                             _perturb(scene.materials, field, idx, ch, eps))
    return (hi.double().mean() - lo.double().mean()).item() / (2 * eps)


def _fd_oracle(ref_scene, cfg, field, idx, ch, eps=2e-3):
    def scene_at(delta):
        arr = np.asarray(getattr(ref_scene.materials, field)).copy()
        arr[idx, ch] += delta
        mats = dataclasses.replace(ref_scene.materials, **{field: arr})
        return dataclasses.replace(ref_scene, materials=mats)

    return (oracle.render(scene_at(eps), cfg).mean()
            - oracle.render(scene_at(-eps), cfg).mean()) / (2 * eps)


@pytest.mark.parametrize("case", ["spheres", "spheres_mis", "mesh_cluster"])
def test_grads_match_reference_jax_grad(case, spheres, small_mesh):
    """grad_render against the reference's jax.grad: cornell_spheres (24²,
    spp 2, depth 2, RR off; brute force, the spp checkpoint), the same with
    MIS at depth 1 (where the reference's MIS grads are finite) and the
    small cornell_mesh through the cluster route (32², depth 4, RR from
    bounce 2, compaction; the reference runs K1 in interpret mode, the port
    its plain version)."""
    if case == "spheres":
        (ref, scene), cfgd = spheres, dataclasses.asdict(_cfg())
    elif case == "spheres_mis":
        (ref, scene), cfgd = spheres, dataclasses.asdict(
            _cfg(max_depth=1, mis=True))
    else:
        (ref, scene), cfgd = small_mesh, MESH
    loss_r, g_r = ref_dr.grad_render(ref, RefConfig(**cfgd))
    loss, g = pt.grad_render(scene, RenderConfig(**cfgd), device="cpu")
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=2e-3)
    for field in ("albedo", "emission"):
        got, want = getattr(g, field).numpy(), np.asarray(getattr(g_r, field))
        assert got.shape == want.shape and np.isfinite(got).all()
        print(f"{case} {field}: max |port - jax| "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)
    assert np.abs(g.albedo.numpy()).sum() > 0.0


def test_albedo_grad_matches_finite_diff(spheres):
    _, scene = spheres
    cfg = _cfg()
    _, grads = pt.grad_render(scene, cfg, device="cpu")
    for idx, ch in [(builder.WHITE, 0), (builder.RED, 0),
                    (builder.GREEN, 1)]:
        fd = _fd_engine(scene, cfg, "albedo", idx, ch)
        np.testing.assert_allclose(grads.albedo[idx, ch].item(), fd,
                                   rtol=2e-2, atol=1e-5)


def test_emission_grad_matches_finite_diff(spheres):
    _, scene = spheres
    cfg = _cfg(max_depth=1)
    _, grads = pt.grad_render(scene, cfg, device="cpu")
    for ch in range(3):
        fd = _fd_engine(scene, cfg, "emission", builder.LIGHT, ch)
        np.testing.assert_allclose(grads.emission[builder.LIGHT, ch].item(),
                                   fd, rtol=2e-2, atol=1e-6)


@pytest.mark.parametrize("scene_name,depth", [
    ("cornell_spheres", 2), ("cornell_spheres", 3),
    ("cornell_sphlight", 2), ("cornell_sphlight", 3)])
def test_mis_grads_finite_and_match_finite_diff(scene_name, depth):
    """With MIS on and depth >= 2 every material grad is finite (the NEE
    term of non-candidate lanes, whose MIS weight is inf/inf there, no
    longer multiplies a zero cotangent into NaN), and the albedo and
    emission grads, the sphere light's among them, match central
    differences at tests/grad/test_grad.py's bars. The reference's jax.grad
    stays NaN here, so it is not the yardstick."""
    scene = builder.build_scene(scene_name)
    cfg = _cfg(scene=scene_name, max_depth=depth, mis=True)
    _, grads = pt.grad_render(scene, cfg, device="cpu")
    assert bool(torch.isfinite(grads.albedo).all())
    assert bool(torch.isfinite(grads.emission).all())
    for idx, ch in [(builder.WHITE, 0), (builder.RED, 0),
                    (builder.GREEN, 1)]:
        fd = _fd_engine(scene, cfg, "albedo", idx, ch)
        np.testing.assert_allclose(grads.albedo[idx, ch].item(), fd,
                                   rtol=2e-2, atol=1e-5)
    lights = [builder.LIGHT]
    if scene_name == "cornell_sphlight":
        lights.append(builder.SPHERE_B)
    for idx in lights:
        fd = _fd_engine(scene, cfg, "emission", idx, 1)
        np.testing.assert_allclose(grads.emission[idx, 1].item(), fd,
                                   rtol=2e-2, atol=1e-6)


def test_grad_matches_oracle_finite_diff(spheres):
    """The port's autodiff against the reference oracle's finite
    differences (the two share only the semantics)."""
    ref, scene = spheres
    cfg = _cfg(width=16, height=16, spp=1)
    _, grads = pt.grad_render(scene, cfg, device="cpu")
    ref_cfg = RefConfig(**dataclasses.asdict(cfg))
    fd = _fd_oracle(ref, ref_cfg, "albedo", builder.WHITE, 1)
    np.testing.assert_allclose(grads.albedo[builder.WHITE, 1].item(), fd,
                               rtol=3e-2, atol=1e-5)


@pytest.mark.parametrize("case", ["spheres", "mesh_cluster"])
def test_geometry_receives_no_grad(case, spheres, small_mesh):
    """Every float geometry table, made a leaf that requires grad, gets no
    gradient (or exactly zero): the intersection is a no-gradient
    boundary and the NEE geometric term is detached."""
    if case == "spheres":
        scene, cfg = spheres[1], _cfg(width=8, height=8, spp=1)
    else:
        scene = small_mesh[1]
        cfg = RenderConfig(**{**MESH, "width": 16, "height": 16})
    leaves = {n: getattr(scene.geometry, n).clone().requires_grad_(True)
              for n in GEOMETRY_FLOATS}
    geom = dataclasses.replace(scene.geometry, **leaves)
    mats = Materials(albedo=scene.materials.albedo.clone().requires_grad_(),
                     emission=scene.materials.emission.clone())
    ids = torch.arange(cfg.n_pixels, dtype=torch.int64)
    out = wavefront.trace_sample(geom, mats, scene.camera, scene.lights, cfg,
                                 ids, 0)
    out.mean().backward()
    assert mats.albedo.grad is not None
    assert float(mats.albedo.grad.abs().sum()) > 0.0
    for name, leaf in leaves.items():
        assert leaf.grad is None or bool((leaf.grad == 0).all()), name


def test_unseen_material_gets_zero_grad(spheres):
    _, scene = spheres
    cfg = _cfg(width=16, height=16, spp=1, max_depth=1)
    mats = scene.materials
    extended = Materials(
        albedo=torch.cat([mats.albedo, torch.tensor([[0.5, 0.5, 0.5]])]),
        emission=torch.cat([mats.emission, torch.zeros((1, 3))]),
    )
    _, grads = pt.grad_render(dataclasses.replace(scene, materials=extended),
                              cfg, device="cpu")
    assert bool((grads.albedo[-1] == 0.0).all())
    assert bool((grads.emission[-1] == 0.0).all())
    assert float(grads.albedo[:-1].abs().sum()) > 0.0


def test_inverse_rendering_converges(spheres):
    """Recover a perturbed albedo by Adam on the image loss, under the
    reference's bounds: by step 30 the loss is below 30% of the first,
    after 45 below 5%, and the white albedo within 0.05."""
    _, scene = spheres
    cfg = _cfg(width=16, height=16, spp=2, max_depth=2)
    with torch.no_grad():
        target = dr.render_image(scene, cfg, scene.materials)
    start = _perturb(_perturb(scene.materials, "albedo", builder.WHITE, 0,
                              -0.25), "albedo", builder.RED, 0, 0.2)
    albedo = start.albedo.clone().requires_grad_(True)
    emission = start.emission.clone().requires_grad_(True)
    opt = torch.optim.Adam([albedo, emission], lr=0.05)
    losses = []
    for _ in range(45):
        loss, grads = dr.loss_and_grad(
            scene, cfg, Materials(albedo=albedo, emission=emission), target)
        losses.append(float(loss))
        opt.zero_grad()
        albedo.grad, emission.grad = grads.albedo, grads.emission
        opt.step()
    assert losses[30] < 0.30 * losses[0], (losses[0], losses[30])
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    np.testing.assert_allclose(albedo.detach()[builder.WHITE].numpy(),
                               scene.materials.albedo[builder.WHITE].numpy(),
                               atol=0.05)


def test_checkpointed_spp_equals_unrolled(small_mesh):
    """render_image checkpoints each sample at spp > 1; its grads equal
    those of the same samples summed with no checkpoint, bit for bit."""
    _, scene = small_mesh
    cfg = RenderConfig(**{**MESH, "width": 16, "height": 16, "spp": 3})

    def unrolled(mats):
        ids = torch.arange(cfg.n_pixels, dtype=torch.int64)
        acc = torch.zeros((cfg.n_pixels, 3))
        for i in range(cfg.spp):
            acc = acc + wavefront.trace_sample(
                scene.geometry, mats, scene.camera, scene.lights, cfg, ids, i)
        return torch.mean(acc / float(cfg.spp))

    loss_c, g_c = dr.grad_render(scene, cfg)
    loss_u, g_u = dr.value_and_grad(unrolled, scene.materials)
    assert torch.equal(loss_c, loss_u)
    assert torch.equal(g_c.albedo, g_u.albedo)
    assert torch.equal(g_c.emission, g_u.emission)


def test_compact_equals_non_compact_grads(small_mesh):
    _, scene = small_mesh
    cfg = RenderConfig(**{**MESH, "rr_start": 1})
    loss_a, g_a = dr.grad_render(scene, cfg)
    loss_b, g_b = dr.grad_render(scene, cfg.replace(compact=False))
    assert torch.equal(loss_a, loss_b)
    for a, b in ((g_a.albedo, g_b.albedo), (g_a.emission, g_b.emission)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_rows", [7, 40])
def test_take_rows_grad_matches_jax(n_rows):
    """Forward and backward of the row gather against the reference's
    take_small_rows (its custom_vjp at <= 32 rows, the plain jnp gather
    above): negative ids wrap, out-of-range ids read the edge row and
    credit no row."""
    rng = np.random.default_rng(n_rows)
    rows = rng.standard_normal((n_rows, 16)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, n_rows, 200),
                          [-1, -n_rows, -n_rows - 3, n_rows, n_rows + 2,
                           3 * n_rows]]).astype(np.int32)
    w = rng.standard_normal((idx.shape[0], 16)).astype(np.float32)

    def f(r):
        return jnp.sum(ref_take_rows(r, jnp.asarray(idx)) * w)

    want_val = np.asarray(ref_take_rows(jnp.asarray(rows), jnp.asarray(idx)))
    want_grad = np.asarray(jax.grad(f)(jnp.asarray(rows)))
    t_rows = torch.from_numpy(rows).requires_grad_(True)
    got = take_rows(t_rows, torch.from_numpy(idx))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want_val)
    np.testing.assert_allclose(t_rows.grad.numpy(), want_grad, rtol=1e-6,
                               atol=1e-6)
    assert not bool(t_rows.grad[n_rows - 1].isnan().any())


def test_forward_render_builds_no_graph(small_mesh):
    """render runs under inference_mode: materials that require grad give
    an image with no graph behind it."""
    _, scene = small_mesh
    cfg = RenderConfig(**{**MESH, "width": 16, "height": 16})
    mats = Materials(albedo=scene.materials.albedo.clone().requires_grad_(),
                     emission=scene.materials.emission.clone()
                     .requires_grad_())
    img = pt.render(scene, cfg, materials=mats, device="cpu")
    assert not img.requires_grad and img.grad_fn is None
    grad_img = dr.render_image(scene, cfg, mats)
    assert grad_img.requires_grad
    assert torch.equal(img, grad_img.detach())
