"""The port's sharded rendering and training (parallel/mesh.py) against its
single-process paths and against the reference's parallel/mesh.py.

Ranks are CPU processes joined in a gloo group (scaling.spawn_ranks: a
``file://`` rendezvous, one thread each, a wall limit after which the
ranks are killed and the test fails). Two groups run per module, of 2 and
4 ranks; each renders every case once and the tests read the results.
Scenes come over through scene/convert.py:scene_from_arrays, so both
packages see the very same arrays.

Bars: sharded against single-process bit for bit where the pixel count
divides into the ranks (sampling is keyed by absolute pixel ids); the
unaligned case at the reference's atol 1e-6 / rtol 1e-5
(tests/dist/test_sharding.py); sharded loss and grads against the
one-rank mesh at the reference's sharded bars (loss rtol 1e-5, grads
rtol 1e-4 / atol 1e-7); the port against the reference's 8-device mesh
at the engine-vs-engine bar rtol/atol 2e-3 for images and
tests/test_torch_diff.py's rtol 2e-3 / atol 1e-6 for grads.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.accel.grid import with_grid as ref_with_grid
from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.parallel import mesh as ref_pmesh
from pathtracer_tpu.scene import builder as ref_builder
import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.parallel import mesh as pmesh
from pathtracer_tpu_torch.parallel.scaling import spawn_ranks
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("geometry", "materials", "camera", "lights")
RANKS_TIMEOUT_S = 240.0  # one group of ranks: start, every case, exit
LR = 1e-2

BASE = dict(width=32, height=32, spp=2, max_depth=2, scene="cornell_spheres",
            use_bvh=False)
MESH24 = dict(BASE, scene="cornell_mesh", width=24, height=24)
# name: (scene, config) — tests/dist/test_sharding.py's cases at 2 spp.
RENDERS = {
    "brute": ("spheres", BASE),
    "bvh": ("mesh", dict(MESH24, use_bvh=True)),
    "cluster": ("mesh", dict(MESH24, use_bvh=True, backend="cluster")),
    "grid": ("grid", dict(MESH24, backend="grid")),
    "grid_deep_compact": ("grid", dict(MESH24, backend="grid", width=16,
                                       height=16, max_depth=5,
                                       compact=True)),
}
UNALIGNED = ("spheres", dict(BASE, width=30, height=17))  # 510 pixels
# Loss and grads against a black target, as the reference's tests.
LOSSES = {
    "brute": ("spheres", BASE),
    "grid": ("grid", dict(MESH24, backend="grid", width=16, height=16,
                          spp=1)),
}
TRAIN = ("spheres", BASE)


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


@pytest.fixture(scope="module")
def scenes():
    """name -> (reference scene, the port's copy)."""
    refs = {
        "spheres": ref_builder.cornell_spheres(),
        "mesh": ref_with_clusters(ref_with_bvh(ref_builder.cornell_mesh())),
        "grid": ref_with_grid(ref_builder.cornell_mesh(), axis=4),
    }
    return {k: (ref, _carry(ref)) for k, ref in refs.items()}


def _black(cfg: dict) -> np.ndarray:
    return np.zeros((cfg["height"], cfg["width"], 3), np.float32)


@pytest.fixture(scope="module")
def train_target(scenes):
    """The train step's target: the same scene rendered at another seed."""
    _, scene = scenes[TRAIN[0]]
    cfg = RenderConfig(**TRAIN[1]).replace(seed=1)
    return pt.render(scene, cfg, device="cpu").numpy()


def _rank_work(rank, jobs):
    """One rank's share of every job: images, (loss, grads), and the
    losses and materials of two train steps."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(device="cpu")
    out = {}
    for name, (scene, cfg) in jobs["renders"].items():
        out[name] = pmesh.render_sharded(scene, cfg, mesh).numpy()
    for name, (scene, cfg, target) in jobs["losses"].items():
        loss, g = pmesh.loss_and_grad_sharded(scene, cfg, scene.materials,
                                              target, mesh)
        out[f"loss_{name}"] = (loss.item(), g.albedo.numpy(),
                               g.emission.numpy())
    scene, cfg, target = jobs["train"]
    step = pmesh.make_train_step(scene, cfg, target, mesh, lr=LR)
    mats, losses = scene.materials, []
    for _ in range(2):
        loss, mats = step(mats)
        losses.append(loss.item())
    out["train"] = (losses, mats.albedo.numpy(), mats.emission.numpy())
    return out


def _jobs(scenes, train_target, n_ranks):
    renders = dict(RENDERS)
    if n_ranks == 4:
        renders["unaligned"] = UNALIGNED
    return {
        "renders": {k: (scenes[s][1], RenderConfig(**c))
                    for k, (s, c) in renders.items()},
        "losses": {k: (scenes[s][1], RenderConfig(**c), _black(c))
                   for k, (s, c) in LOSSES.items()},
        "train": (scenes[TRAIN[0]][1], RenderConfig(**TRAIN[1]),
                  train_target),
    }


@pytest.fixture(scope="module")
def sharded(scenes, train_target):
    """n_ranks -> each rank's results, computed once per group size."""
    cache = {}

    def get(n_ranks):
        if n_ranks not in cache:
            cache[n_ranks] = spawn_ranks(
                _rank_work, n_ranks,
                args=(_jobs(scenes, train_target, n_ranks),),
                timeout=RANKS_TIMEOUT_S)
        return cache[n_ranks]

    return get


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_padded_ids_match_reference(n_shards):
    for w, h in [(32, 32), (30, 17), (7, 5), (1, 1)]:
        ids, pad = pmesh._padded_ids(RenderConfig(width=w, height=h),
                                     n_shards)
        want, want_pad = ref_pmesh._padded_ids(RefConfig(width=w, height=h),
                                               n_shards)
        assert pad == want_pad and ids.dtype == torch.int64
        np.testing.assert_array_equal(ids.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("case", list(RENDERS))
def test_sharded_render_equals_single(case, n_ranks, scenes, sharded):
    """Every rank holds the same image, equal bit for bit to pt.render:
    brute force, the BVH walk (K4's plain version), the cluster route
    (K1's), the grid (K2's, axis 4) and the grid at depth 5 with
    compaction (sparse bounces; each rank sorts only its own rays)."""
    name, cfg = RENDERS[case]
    single = pt.render(scenes[name][1], RenderConfig(**cfg),
                       device="cpu").numpy()
    images = [r[case] for r in sharded(n_ranks)]
    assert single.shape == (cfg["height"], cfg["width"], 3)
    for img in images:
        np.testing.assert_array_equal(img, single)


def test_sharded_render_unaligned_pixel_count(scenes, sharded):
    """30x17 = 510 pixels over 4 ranks: 2 padding rays on the last rank,
    dropped after the gather."""
    name, cfg = UNALIGNED
    single = pt.render(scenes[name][1], RenderConfig(**cfg),
                       device="cpu").numpy()
    for r in sharded(4):
        assert r["unaligned"].shape == (17, 30, 3)
        np.testing.assert_allclose(r["unaligned"], single, atol=1e-6,
                                   rtol=1e-5)


def test_sharded_render_matches_reference(scenes, sharded):
    """The port's 2-rank image against the reference's render_sharded over
    the 8 virtual devices tests/conftest.py provides."""
    name, cfg = RENDERS["brute"]
    assert len(jax.devices()) == 8
    want = np.asarray(ref_pmesh.render_sharded(
        scenes[name][0], RefConfig(**cfg), ref_pmesh.make_mesh(8)))
    np.testing.assert_allclose(sharded(2)[0]["brute"], want, rtol=2e-3,
                               atol=2e-3)


def _one_rank_loss(scenes, case):
    name, cfg = LOSSES[case]
    scene = scenes[name][1]
    return pmesh.loss_and_grad_sharded(
        scene, RenderConfig(**cfg), scene.materials, _black(cfg),
        pmesh.make_mesh(device="cpu"))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("case", list(LOSSES))
def test_sharded_grads_match_one_rank(case, n_ranks, scenes, sharded):
    """All-reduced loss and grads over the ranks against the one-rank mesh
    (no process group), the same on every rank; finite, non-zero albedo
    and emission grads."""
    loss1, g1 = _one_rank_loss(scenes, case)
    results = [r[f"loss_{case}"] for r in sharded(n_ranks)]
    for loss, albedo, emission in results:
        assert (loss, albedo.tobytes(), emission.tobytes()) == (
            results[0][0], results[0][1].tobytes(), results[0][2].tobytes())
        np.testing.assert_allclose(loss, loss1.item(), rtol=1e-5)
        np.testing.assert_allclose(albedo, g1.albedo.numpy(), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(emission, g1.emission.numpy(), rtol=1e-4,
                                   atol=1e-7)
        assert np.isfinite(albedo).all() and np.isfinite(emission).all()
        assert np.abs(albedo).sum() > 0 and np.abs(emission).sum() > 0


@pytest.mark.parametrize("case", list(LOSSES))
def test_sharded_grads_match_reference(case, scenes, sharded):
    """The port's 4-rank loss and grads against the reference's
    loss_and_grad_sharded over 8 devices."""
    name, cfg = LOSSES[case]
    ref = scenes[name][0]
    loss_r, g_r = ref_pmesh.loss_and_grad_sharded(
        ref, RefConfig(**cfg), ref.materials, _black(cfg),
        ref_pmesh.make_mesh(8))
    loss, albedo, emission = sharded(4)[0][f"loss_{case}"]
    print(f"{case}: loss {loss!r} vs {float(loss_r)!r}; max |port - jax| "
          f"albedo {np.abs(albedo - np.asarray(g_r.albedo)).max():.3g}, "
          f"emission {np.abs(emission - np.asarray(g_r.emission)).max():.3g}")
    np.testing.assert_allclose(loss, float(loss_r), rtol=2e-3)
    np.testing.assert_allclose(albedo, np.asarray(g_r.albedo), rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(emission, np.asarray(g_r.emission),
                               rtol=2e-3, atol=1e-6)


def test_train_step_bit_identical_across_ranks(sharded):
    """Two steps over 2 ranks: every rank ends with the very same losses
    and materials, and the loss falls."""
    results = [r["train"] for r in sharded(2)]
    losses, albedo, emission = results[0]
    for other in results[1:]:
        assert other[0] == losses
        assert other[1].tobytes() == albedo.tobytes()
        assert other[2].tobytes() == emission.tobytes()
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_train_step_matches_reference(scenes, train_target, sharded):
    """Against the reference's make_train_step with optax.adam(1e-2) over
    8 devices. Adam's update is lr * m_hat / (sqrt(v_hat) + eps): with the
    grads within rtol 2e-3 of the reference's, each step's update is
    within lr * 2 * 2e-3 of its counterpart wherever |grad| is far above
    eps (the first step is lr * sign(grad)), so after two steps the
    materials agree within 2 * lr * 4e-3 = 8e-5. Rows whose grads are 0
    in both stay where they were in both."""
    name, cfg = TRAIN
    ref = scenes[name][0]
    optimizer = optax.adam(LR)
    step = ref_pmesh.make_train_step(ref, RefConfig(**cfg), train_target,
                                     ref_pmesh.make_mesh(8), optimizer)
    mats, state, losses_r = ref.materials, optimizer.init(ref.materials), []
    for _ in range(2):
        loss, mats, state = step(mats, state)
        losses_r.append(float(loss))
    losses, albedo, emission = sharded(2)[0]["train"]
    print(f"train: losses {losses} vs {losses_r}; max |port - jax| albedo "
          f"{np.abs(albedo - np.asarray(mats.albedo)).max():.3g}, emission "
          f"{np.abs(emission - np.asarray(mats.emission)).max():.3g}")
    np.testing.assert_allclose(losses, losses_r, rtol=2e-3)
    moved = np.abs(albedo - np.asarray(ref.materials.albedo)).max()
    assert moved > LR  # two steps of about lr each
    np.testing.assert_allclose(albedo, np.asarray(mats.albedo), rtol=0,
                               atol=8e-5)
    np.testing.assert_allclose(emission, np.asarray(mats.emission), rtol=0,
                               atol=8e-5)


def test_one_rank_mesh_without_a_group(scenes, monkeypatch):
    """Without a process group the mesh has one rank and identity
    collectives, and render_sharded is pt.render; the mesh defaults to the
    card and raises without one; more ranks need a group."""
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert pmesh.AXIS == "rays"
    name, cfg = RENDERS["brute"]
    cfg = RenderConfig(**cfg)
    np.testing.assert_array_equal(
        pmesh.render_sharded(scenes[name][1], cfg, mesh).numpy(),
        pt.render(scenes[name][1], cfg, device="cpu").numpy())
    pmesh.initialize_distributed()  # no group, no torchrun: a no-op
    pmesh.initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        pmesh.make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh(device="cuda")


def test_scaling_script_smoke(tmp_path):
    """The scaling script over 2 CPU gloo ranks prints its JSON line with
    every spp sample's rays counted and writes no metrics row."""
    rows = os.path.join(ROOT, "bench_metrics_torch.jsonl")
    before = open(rows).read() if os.path.exists(rows) else None
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.parallel.scaling",
         "--cpu-ranks", "2", "--scene", "cornell_spheres", "--width", "32",
         "--height", "32", "--depth", "2", "--budget", "2",
         "--single-chip-ref", "1000"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(row) == {"metric", "value", "unit", "scaling_eff"}
    assert row["unit"] == "rays/s" and row["value"] > 0
    assert row["scaling_eff"] == pytest.approx(row["value"] / 1000, rel=1e-3)
    assert "2ranks" in row["metric"]
    assert "rays_per_frame=" in out.stderr
    after = open(rows).read() if os.path.exists(rows) else None
    assert after == before


def test_scaling_counts_every_spp_sample(scenes):
    """frame_rays over a one-rank mesh at 2 spp is the sum of both
    samples' useful rays (the reference's pod script counts sample 0
    only)."""
    from pathtracer_tpu_torch.engine.wavefront import trace_sample
    from pathtracer_tpu_torch.parallel.scaling import frame_rays

    name, cfg = RENDERS["brute"]
    scene, cfg = scenes[name][1], RenderConfig(**cfg)
    ids = torch.arange(cfg.n_pixels)
    per_sample = [int(trace_sample(scene.geometry, scene.materials,
                                   scene.camera, scene.lights, cfg, ids, s,
                                   with_stats=True)[1])
                  for s in range(cfg.spp)]
    assert per_sample[0] != per_sample[1]
    assert frame_rays(scene, cfg, pmesh.make_mesh(device="cpu")) \
        == sum(per_sample)
