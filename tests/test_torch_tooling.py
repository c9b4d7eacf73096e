"""The port's tooling on the CPU: the roofline's band passes
(roofline.py), the grid profile's per-pass stats (grid_profile.py), the
card's check suite (checks.py) run through its plain versions, and the
entry points, which need the card.

band_passes must hand the intersector exactly the rays the engine's own
bounce loop does (bit for bit); the grid profile's stats must equal the
reference's closest_hit_grid(stats=True) wherever both count the same
thing; the checks' logic must pass on the plain versions.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel import grid as ref_grid
from pathtracer_tpu.accel.build import with_bvh as ref_with_bvh
from pathtracer_tpu.ops import intersect_grid as ref_ig
from pathtracer_tpu.scene import builder as ref_builder
import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch import checks, grid_profile, roofline
from pathtracer_tpu_torch import constants as C
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.camera import tiled_pixel_ids
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.ops import intersect_grid as ig
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("geometry", "materials", "camera", "lights")
BAND = pt.PRESETS["bench"].replace(width=16, height=16, max_depth=2)


@pytest.fixture(scope="module")
def small_mesh():
    """The goldens' small mesh scene (bunny subdiv 2), BVH + clusters."""
    scene = with_bvh(builder.cornell_mesh(
        mesh_tris=builder.procedural_bunny(2)))
    return prepare_accel(scene, BAND)


def test_band_passes_are_the_engines_queries(small_mesh, monkeypatch):
    """The primary and bounce-1 passes equal the closest-hit queries of the
    engine's bounce loop (the bench path: cluster route, compaction) bit
    for bit; every ray of the engine's bounce-0 shadow query is in the
    shadow pass, which holds the same vertices' light samples in the
    coherence order of bounce 1."""
    calls = []
    real = ic.closest_hit_cluster

    def recording(g, o, d, t_max=None, **kw):
        calls.append((o, d, t_max))
        return real(g, o, d, t_max=t_max, **kw)

    monkeypatch.setattr(ic, "closest_hit_cluster", recording)
    g = small_mesh.geometry
    wavefront.trace_sample(g, small_mesh.materials, small_mesh.camera,
                           small_mesh.lights, BAND,
                           tiled_pixel_ids(0, BAND.n_pixels, BAND.width), 0)
    engine = list(calls)
    passes = roofline.band_passes(small_mesh, BAND, BAND.n_pixels, "cpu")
    assert [p[0] for p in passes] == ["primary (tiled)", "bounce 1 (sorted)",
                                      "shadow 1 (sorted, capped)"]
    assert len(engine) == 2 * BAND.max_depth
    for mine, theirs in ((passes[0], engine[0]), (passes[1], engine[2])):
        for a, b in zip(mine[1:], theirs):
            assert torch.equal(a, b)
    o, d, t_max = engine[1]
    cand = t_max > C.T_MIN
    assert cand.any()
    _, o_s, d_s, t_s = passes[2]
    band = {tuple(r) for r in torch.cat([o_s, d_s, t_s[:, None]], 1)
            [t_s > C.T_MIN].tolist()}
    rows = torch.cat([o, d, t_max[:, None]], 1)[cand].tolist()
    assert all(tuple(r) in band for r in rows)
    live = passes[1][3] > C.T_MIN
    assert torch.equal(live, t_s > C.T_MIN)


def _carry(ref_scene):
    return scene_from_arrays(*(
        {f.name: np.asarray(getattr(getattr(ref_scene, p), f.name))
         for f in dataclasses.fields(getattr(ref_scene, p))}
        for p in PARTS))


@pytest.fixture(scope="module")
def big_pair():
    """big_mesh at ~20k triangles on config 5's grid, in both packages, and
    the band's three passes at 32x32 through the port's grid route."""
    ref = ref_grid.with_grid(ref_with_bvh(ref_builder.big_mesh(
        n_target=20_000)))
    port = _carry(ref)
    cfg = pt.PRESETS["config5"].replace(width=32, height=32)
    return ref, port, roofline.band_passes(port, cfg, cfg.n_pixels, "cpu")


@pytest.mark.parametrize("knobs", ["default", "ladder (1,)"])
def test_grid_stats_match_reference(big_pair, knobs, monkeypatch):
    """live_after_phase0 equals the reference's on every pass (stage A runs
    before the ladder); with the ladder (1,), where both packages' era
    capacities are every live ray, so do the eras. The reference rounds
    its capacities up to multiples of 2048 rays and counts visits of its
    own pair blocks per candidate round, so at the default ladder its eras
    and its visits count other things: the port's visits are held to the
    sum of the pair kernel's per-block visits instead."""
    ref, port, passes = big_pair
    kw = {} if knobs == "default" else {"ladder": (1,)}
    visits = []
    real = ig.pair_hit

    def counting(*args):
        out = real(*args)
        visits[-1] += int(out[2].sum())
        return out

    monkeypatch.setattr(ig, "pair_hit", counting)
    real_grid = ig.closest_hit_grid

    def per_call(*args, **kwargs):
        visits.append(0)
        return real_grid(*args, **kwargs)

    monkeypatch.setattr(ig, "closest_hit_grid", per_call)
    stats = grid_profile.pass_stats(port.geometry, passes, kw)
    assert len(stats) == len(visits) == 3
    for (name, o, d, t_max), info, n in zip(passes, stats, visits):
        *_, want = ref_ig.closest_hit_grid(
            ref.geometry, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            t_max=jnp.asarray(t_max.numpy()), stats=True, **kw)
        want = {k: int(np.asarray(v)) for k, v in want.items()}
        assert want["unfinished"] == 0, name
        assert info["live_after_phase0"] == want["live_after_phase0"], name
        if kw:
            assert info["eras"] == want["eras"], name
        assert info["visits"] == n > 0, name
        assert info["launches"] == 0, name  # the plain version on the CPU


def test_span_frames_on_the_cpu(big_pair):
    """grid_profile --spans' turns on the CPU, where nothing runs on a
    device: each frame is idle from its start to its end, the grid query
    opens inside it with its host reads marked, and no turn launches the
    DDA kernel or a CUDA call."""
    _, port, _ = big_pair
    cfg = pt.PRESETS["config5"].replace(width=16, height=16)
    turns = grid_profile.span_frames(port, cfg, 1, torch.device("cpu"))
    assert [t["mode"] for t in turns] == list(grid_profile.SPAN_TURNS)
    for t in turns:
        spans = t["spans"]
        assert (t["device_ops"], t["busy_ms"], t["calls"],
                t["dda_launches"]) == (0, 0, 0, 0)
        assert spans["pt.frame"][0] == 1
        assert t["idle_ms"] == pytest.approx(spans["pt.frame"][1])
        assert spans["pt.frame"][2] == pytest.approx(spans["pt.frame"][1])
        assert 0 < spans["pt.grid"][0] <= 2 * cfg.max_depth
        assert spans["pt.grid"][2] <= spans["pt.frame"][2]
        assert spans["pt.read"][0] > 0 and spans["pt.grid.dda"][0] > 0


@pytest.mark.parametrize("main", [checks.main, grid_profile.main],
                         ids=["checks", "grid_profile"])
def test_entry_points_need_the_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main([])


def test_chip_smoke_imports_no_jax_and_owns_no_bound():
    """chip_smoke.py imports nothing of JAX or the reference, takes its
    bound arithmetic from roofline.py (one home), and exits at once
    without a CUDA device."""
    names = ("PEAK_F32", "PEAK_BF16", "PEAK_BYTES", "add_bound",
             "add_split_bound", "tri_tests", "warp_tests", "split_bytes",
             "reference_work_ms", "k1_bytes", "k4_bytes", "nbytes",
             "cull_work")
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import chip_smoke\n"
        "from pathtracer_tpu_torch import roofline\n"
        f"names = {names!r}\n"
        "assert all(getattr(chip_smoke, n) is getattr(roofline, n) "
        "for n in names)\n"
        "try:\n"
        "    chip_smoke.main()\n"
        "except SystemExit as e:\n"
        "    assert 'no CUDA device' in str(e)\n"
        "else:\n"
        "    raise AssertionError('main ran without CUDA')\n"
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


def test_parse_sweep_and_kernel_classes():
    assert grid_profile.parse_sweep("4,4;6,4,2-8") == [
        {"first_steps": 4, "era_steps": 4},
        {"first_steps": 6, "era_steps": 4, "ladder": (2, 8)}]
    with pytest.raises(ValueError):
        grid_profile.parse_sweep("4")
    assert [grid_profile.kernel_class(n) for n in (
        "pair_hit_kernel(int const*)",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>",
        "void at::native::index_elementwise_kernel<128, 4>",
        "void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
    )] == ["K2 (pair_hit)", "sorts", "gathers and scatters", "other"]


def test_bound_arithmetic():
    """A call's bound is the larger of its bytes at the memory rate and its
    operations at the unit's peak; the split bound counts 240 tensor-core
    operations per test on the warps' work."""
    out = roofline.new_bound()
    assert roofline.add_bound(out, 3.35e9, 0) == pytest.approx(1.0)
    assert roofline.add_bound(out, 0, 67e9) == pytest.approx(1.0)
    assert out["bound_ms"] == pytest.approx(2.0)
    warp_visits = torch.tensor([3, 1], dtype=torch.int32)
    tests = roofline.warp_tests(warp_visits)
    assert tests == 4 * ic.WARP_RAYS * ic.CLUSTER_TRIS
    bound, f32 = roofline.add_split_bound(roofline.new_bound(), 0, tests)
    assert bound == pytest.approx(tests * 240 / roofline.PEAK_BF16 * 1e3)
    assert f32 == pytest.approx(tests * 82 / roofline.PEAK_F32 * 1e3)
    assert roofline.reference_work_ms(0, warp_visits) == pytest.approx(
        roofline.split_ops_ms(4 * ic.RAY_BLOCK * ic.CLUSTER_TRIS))
    feat = torch.zeros((5, 512, 32), dtype=torch.bfloat16)
    assert roofline.split_bytes(feat, torch.tensor([4, 1, 4])) == 2 * 512 \
        * 32 * 2


@pytest.fixture(scope="module")
def check_context():
    return checks.context(torch.device("cpu"))


@pytest.mark.parametrize("label", ["0", "2", "5", "8", "10"])
def test_checks_pass_on_the_plain_versions(check_context, label):
    """The checks whose plain versions are cheap, run on the CPU: their
    comparisons and bars hold there too."""
    fn = next(f for lab, f, _, _ in checks.CHECKS if lab == label)
    ok, line = fn(check_context)
    assert ok, line
