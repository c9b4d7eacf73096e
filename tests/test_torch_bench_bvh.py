"""The bench preset through the BVH walk (backend "pallas", K4) with
compaction, as the benchmark's bench_bvh.render cell runs it, on the CPU.

The compaction is engine/wavefront.py's compact_rays: its output is the
state indexed by the stable argsort of _coherence_key, with `slot` a
permutation; a compacted pallas frame equals the same frame without
compaction bit for bit; the benchmark's compaction span wraps that very
function; and the shrunk cell (32x32, K4's plain walk) is correct, and
incorrect under the answer and half_batch faults.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from pathtracer_tpu_torch import render
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import PRESETS
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.scene import builder
from ptbench import harness, trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "bench_bvh.render"
# The cell shrunk as ptbench/tests/helpers.py shrinks bench.render.
TINY = {"preset": {"width": 32, "height": 32},
        "params": {"check_pixels": 256, "ref_block": 4096}}
FAULTS = ("None", "answer", "half_batch")


def test_cell_runs_the_bench_preset_on_k4():
    cfg = harness.load_json("configs", "bench_bvh")["preset"]
    bench = harness.load_json("configs", "bench")["preset"]
    assert cfg == {**bench, "backend": "pallas"}
    assert cfg["compact"] and cfg["use_bvh"]


@pytest.fixture(scope="module")
def bvh_scene():
    cfg = PRESETS["bench"].replace(width=32, height=32, backend="pallas")
    return prepare_accel(with_bvh(builder.build_scene(cfg.scene)), cfg), cfg


def test_compacted_pallas_frame_is_bit_identical(bvh_scene):
    scene, cfg = bvh_scene
    assert cfg.compact and cfg.max_depth == 4
    hit = wavefront._intersector(scene.geometry, cfg)
    assert hit.impl == "pallas"
    compacted = render(scene, cfg, device="cpu")
    plain = render(scene, cfg.replace(compact=False), device="cpu")
    assert bool((compacted > 0).any())
    assert torch.equal(compacted, plain)


def _state(n, seed):
    """A wavefront's state of n rays: a third dead, pixel ids up to 2^32
    (past int32), slots as the frame's first compaction finds them."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 1.2 - 0.1
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=1)
    radiance = torch.rand((n, 3), generator=g)
    throughput = torch.rand((n, 3), generator=g)
    pixel_ids = torch.randint(0, 2 ** 32, (n,), generator=g)
    slot = torch.arange(n, dtype=torch.int32)
    alive = torch.rand((n,), generator=g) > 0.33
    spec_chain = torch.rand((n,), generator=g) > 0.5
    prev_pdf = torch.rand((n,), generator=g)
    return (o, d, radiance, throughput, pixel_ids, slot, alive, spec_chain,
            prev_pdf)


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_rays_is_the_stable_argsort(seed):
    state = _state(1000, seed)
    o, d, alive = state[0], state[1], state[6]
    lo, hi = torch.zeros(3), torch.ones(3)
    got = wavefront.compact_rays(*state, lo, hi)
    perm = torch.argsort(wavefront._coherence_key(o, d, alive, lo, hi),
                         stable=True)
    assert len(got) == len(state)
    for g, s in zip(got, state):
        assert g.dtype == s.dtype and torch.equal(g, s[perm])
    slot = got[5]
    assert torch.equal(torch.sort(slot).values,
                       torch.arange(1000, dtype=torch.int32))
    # Dead rays form the tail.
    n_live = int(alive.sum())
    assert bool(got[6][:n_live].all()) and not bool(got[6][n_live:].any())


def test_compact_span_wraps_compact_rays():
    spec = trace.span_specs()["compact"]
    assert spec["layer"] == "compaction"
    (module, dotted), = spec["targets"]
    owner, attr = trace._resolve(module, dotted)
    assert owner is wavefront and attr == "compact_rays"
    assert getattr(owner, attr) is wavefront.compact_rays


# ---- the benchmark's cell, shrunk, in a process without JAX -------------

PROBE = r"""
import json, sys, torch
from ptbench import run
torch.set_num_threads(2)
out = {}
for fault in %(faults)r:
    argv = ["--workload", %(cell)r, "--seed", "2147483701", "--seconds",
            "0.5", "--trace", "0"]
    if fault != "None":
        argv += ["--fault", fault]
    out[fault] = run.main(argv, device=torch.device("cpu"),
                          overrides=%(tiny)r)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cell_runs():
    """The shrunk cell run plainly and with each fault by run.main, in a
    child process (this one has loaded JAX, which a run refuses):
    {fault: (exit code, result line)}."""
    out = subprocess.run(
        [sys.executable, "-c",
         PROBE % {"cell": CELL, "tiny": TINY, "faults": FAULTS}],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    rcs = json.loads(lines[-1])
    results = [json.loads(x) for x in lines[:-1] if x.startswith("{")]
    assert len(results) == len(FAULTS), out.stdout[-3000:]
    return {f: (rcs[f], r) for f, r in zip(FAULTS, results)}


@pytest.mark.parametrize("fault,correct", [("None", True),
                                           ("answer", False),
                                           ("half_batch", False)])
def test_shrunk_cell_against_the_reference(cell_runs, fault, correct):
    rc, out = cell_runs[fault]
    assert rc == 0
    assert out["correct"] is correct, out["checks"]
    assert set(out["checks"]) == {"bad_px_share"}
    assert out["device"]["platform"] == "cpu" and out["metrics"] == {}
    assert out["attempted"] >= 1
