"""Config 5's BVH route (backend "pallas", K4) as the benchmark runs it, on
the CPU: the shadow bound handed to closest_hit_bvh, its counters under a
profiler, the benchmark's shrunk config5_bvh.render cell against the plain
reference, and the triangle-box work count behind k4_roofline_pct.

closest_hit_bvh takes t_max and does not use it yet, so its answers are
bit-equal with and without it; STATS (lanes, visits, tests) is touched
only while a profiler records; the shrunk cell (cornell_mesh, 32x32) is
correct, and the answer fault makes it incorrect; ptbench/tri_work.py's
count equals a brute-force count over every triangle's box and never
exceeds ptbench/work.py's cluster count.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import PRESETS
from pathtracer_tpu_torch.engine import intersect, wavefront
from pathtracer_tpu_torch.ops import traverse_bvh as tb
from pathtracer_tpu_torch.scene import builder
from ptbench import tri_work, work

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "config5_bvh.render"
# The cell shrunk as ptbench/tests/helpers.py shrinks config5.render: the
# bench scene at 32x32 (the 2M-triangle scene is the card's).
TINY = {"preset": {"width": 32, "height": 32, "scene": "cornell_mesh"},
        "params": {"check_pixels": 256, "ref_block": 4096}}


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 0.8 + 0.1
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=1)
    return o, d


def _shadow_bound(n):
    t_max = torch.full((n,), 1e8)
    t_max[::3] = 0.3            # shadow-like bounds
    t_max[::7] = work.T_MIN     # dead lanes
    return t_max


@pytest.fixture(scope="module")
def bvh_scene():
    cfg = PRESETS["config5"].replace(width=16, height=16,
                                     scene="cornell_mesh", backend="pallas")
    return prepare_accel(with_bvh(builder.build_scene(cfg.scene)), cfg), cfg


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def test_t_max_changes_no_answer(bvh_scene):
    scene, _ = bvh_scene
    g = scene.geometry
    o, d = _rays(700, 0)
    plain = tb.closest_hit_bvh(g, o, d)
    bounded = tb.closest_hit_bvh(g, o, d, t_max=_shadow_bound(700))
    assert all(torch.equal(a, b) for a, b in zip(plain, bounded))
    assert bool((plain[0] < 1e8).any())


def test_engine_hands_t_max_to_the_bvh_query(bvh_scene, monkeypatch):
    scene, cfg = bvh_scene
    g = scene.geometry
    seen = []
    real = tb.closest_hit_bvh

    def spy(*a, **k):
        seen.append(k.get("t_max"))
        return real(*a, **k)

    monkeypatch.setattr(tb, "closest_hit_bvh", spy)
    hit = wavefront._intersector(g, cfg)
    assert hit.impl == "pallas"
    o, d = _rays(64, 1)
    t_max = _shadow_bound(64)
    hit(g, o, d, t_max=t_max)
    hit(g, o, d)
    assert seen[0] is t_max and seen[1] is None


def test_stats_only_under_a_profiler(bvh_scene):
    scene, _ = bvh_scene
    g = scene.geometry
    o, d = _rays(600, 2)
    tb.take_stats()
    tb.closest_hit_bvh(g, o, d, t_max=_shadow_bound(600))
    assert tb.STATS is None and tb.take_stats() is None
    _profiled(lambda: [tb.closest_hit_bvh(g, o, d),
                       tb.closest_hit_bvh(g, o[:300], d[:300])])
    got = tb.take_stats()
    assert tb.STATS is None
    _, _, visits, tests = tb.bvh_hit(g.bvh_nodes, g.bvh_pairs, g.bvh_tris,
                                     o, d)
    _, _, v2, t2 = tb.bvh_hit(g.bvh_nodes, g.bvh_pairs, g.bvh_tris,
                              o[:300].contiguous(), d[:300].contiguous())
    want = [900, int(visits.sum() + v2.sum()), int(tests.sum() + t2.sum())]
    assert got.dtype == torch.int64 and got.tolist() == want
    assert want[2] > 0


def test_stats_under_inference_mode_then_outside(bvh_scene):
    """render's inference mode makes no inference tensor of STATS: a query
    outside it still adds to the same counters."""
    scene, _ = bvh_scene
    g = scene.geometry
    o, d = _rays(100, 3)
    tb.take_stats()
    with torch.inference_mode():
        _profiled(lambda: tb.closest_hit_bvh(g, o, d))
    _profiled(lambda: tb.closest_hit_bvh(g, o, d))
    assert tb.take_stats()[0] == 200


# ---- the benchmark's cell, shrunk, in a process without JAX -------------

PROBE = r"""
import json, sys, torch
from ptbench import run
torch.set_num_threads(2)
out = {}
for fault in (None, "answer"):
    argv = ["--workload", %(cell)r, "--seed", "2147483701", "--seconds",
            "0.5", "--trace", "0"]
    if fault:
        argv += ["--fault", fault]
    rc = run.main(argv, device=torch.device("cpu"), overrides=%(tiny)r)
    out[str(fault)] = rc
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cell_runs():
    """The shrunk cell run plainly and with the answer fault by run.main,
    in a child process (this one has loaded JAX, which a run refuses):
    {fault: (exit code, result line)}."""
    out = subprocess.run(
        [sys.executable, "-c", PROBE % {"cell": CELL, "tiny": TINY}],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    rcs = json.loads(lines[-1])
    results = [json.loads(x) for x in lines[:-1] if x.startswith("{")]
    assert len(results) == 2, out.stdout[-3000:]
    return {"None": (rcs["None"], results[0]),
            "answer": (rcs["answer"], results[1])}


@pytest.mark.parametrize("fault,correct", [("None", True),
                                           ("answer", False)])
def test_shrunk_cell_against_the_reference(cell_runs, fault, correct):
    rc, out = cell_runs[fault]
    assert rc == 0
    assert out["correct"] is correct, out["checks"]
    assert set(out["checks"]) == {"bad_px_share"}
    assert out["device"]["platform"] == "cpu" and out["metrics"] == {}
    assert out["attempted"] >= 1


# ---- the triangle-box work count (ptbench/tri_work.py) ------------------

@pytest.fixture(scope="module")
def count_scenes():
    """The bench scene with its cluster table, and a small big_mesh
    (several levels of groups) with its own."""
    cfg = PRESETS["bench"]
    return {
        "cornell_mesh": prepare_accel(
            with_bvh(builder.build_scene(cfg.scene)), cfg).geometry,
        "big_mesh": prepare_accel(
            with_bvh(builder.big_mesh(n_target=6000)),
            cfg.replace(backend="stream")).geometry,
    }


@pytest.mark.parametrize("scene", ["cornell_mesh", "big_mesh"])
def test_tri_count_is_brute_force_and_below_clusters(count_scenes, scene):
    g = count_scenes[scene]
    n = 400
    o, d = _rays(n, 4)
    t_max = _shadow_bound(n)
    t, _, _ = intersect.brute(g, o, d)
    got = tri_work.query_work(g, o, d, t_max, t)
    live = t_max > work.T_MIN
    t_end = torch.clamp(torch.minimum(t, t_max), max=work.T_FAR)
    lo, hi = tri_work.tri_boxes(g)
    x = work.crossed(lo, hi, o[live], d[live], t_end[live])
    n_live = int(live.sum())
    assert got["tests"] == float(x.sum()) > 0
    assert got["bytes"] == float(
        n_live * (work.RAY_IN_BYTES + work.RAY_OUT_BYTES)
        + int(x.any(dim=0).sum()) * work.TRI_BYTES)
    clusters = work.query_work(g, o, d, t_max, t)
    assert got["tests"] <= clusters["tests"]
    assert work.bound_ms(got) <= work.bound_ms(clusters)


def test_tri_count_sample_scales(count_scenes, monkeypatch):
    """Over SAMPLE_RAYS live rays the count is made on work.py's sample
    and scaled: repeated rays count as the whole."""
    g = count_scenes["cornell_mesh"]
    o, d = _rays(64, 5)
    o, d = o.repeat(8, 1), d.repeat(8, 1)
    t = torch.full((512,), 1e8)
    whole = tri_work.query_work(g, o, d, None, t)
    monkeypatch.setattr(work, "SAMPLE_RAYS", 64)
    part = tri_work.query_work(g, o, d, None, t)
    assert abs(part["tests"] - whole["tests"]) <= 0.25 * whole["tests"]
    assert tri_work.query_work(g, o, d, None,
                               torch.full((512,), work.T_MIN)) == {
        "tests": 0.0, "bytes": 0.0}
