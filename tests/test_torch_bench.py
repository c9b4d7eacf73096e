"""The port's bench script (bench_torch.py) on the CPU.

Its frames count the same useful rays as the reference's
trace_sample(with_stats=True) over the same tile-ordered frame, every spp
sample included; the smoke run prints the reference's four-key JSON line
after at least MIN_FRAMES timed frames; a baseline ratio needs the task
entry's own methodology stamp; the script writes only its own records.
Also: the port's front end (cli.main render and fit, bench_torch.main)
imports neither JAX nor the reference package.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as RefConfig
from pathtracer_tpu.engine.camera import tiled_pixel_ids as ref_tiled_ids
from pathtracer_tpu.engine.wavefront import trace_sample as ref_trace_sample
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu.scene.model import scene_to_device
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.scene import builder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--width", "16", "--height", "16", "--scene",
         "cornell_spheres", "--depth", "1", "--budget", "0"]
# The frame the ray counts are held on: brute force (no BVH), two bounces
# so that the count includes scattered segments and their shadow rays.
FRAME = dict(width=16, height=16, spp=1, max_depth=2, scene="cornell_spheres",
             use_bvh=False, backend="jnp")


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(ROOT, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """bench_torch with its record files moved into tmp_path."""
    mod = _load_bench()
    monkeypatch.setattr(mod, "BASELINE_PATH", str(tmp_path / "base.json"))
    monkeypatch.setattr(mod, "METRICS_PATH", str(tmp_path / "rows.jsonl"))
    return mod


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _ref_rays(spp_idx: int, **over) -> int:
    cfg = RefConfig(**{**FRAME, **over})
    scene = scene_to_device(ref_builder.cornell_spheres())
    ids = ref_tiled_ids(0, cfg.n_pixels, cfg.width)
    _, n = ref_trace_sample(scene.geometry, scene.materials, scene.camera,
                            scene.lights, cfg, ids, jnp.uint32(spp_idx),
                            with_stats=True)
    return int(n)


def test_smoke_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--smoke",
         "--device", "cpu", "--width", "16", "--height", "16", "--budget",
         "1"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["value"] > 0 and row["unit"] == "rays/s"
    assert row["vs_baseline"] is None
    assert "cornell_mesh 16x16 1spp depth4 backend=cluster on cpu" \
        in row["metric"]
    frames = int(re.search(r"bench measured frames=(\d+)", r.stderr)[1])
    assert frames >= 5


@pytest.mark.parametrize("spp", [1, 2])
def test_frame_rays_equal_reference(bench, spp):
    """A frame's rays are the reference's with_stats count of the same
    tile-ordered frame, summed over every spp sample."""
    cfg = RenderConfig(**{**FRAME, "spp": spp})
    frame = bench.make_frame(builder.cornell_spheres(), cfg, False,
                             torch.device("cpu"))
    per_sample = [_ref_rays(s, spp=spp) for s in range(spp)]
    assert frame() == sum(per_sample)
    assert min(per_sample) > 0


def test_grad_frame_counts_forward_rays(bench):
    cfg = RenderConfig(**{**FRAME, "spp": 2})
    scene = builder.cornell_spheres()
    fwd = bench.make_frame(scene, cfg, False, torch.device("cpu"))()
    assert bench.make_frame(scene, cfg, True, torch.device("cpu"))() == fwd


def test_grad_run(bench, capsys):
    assert bench.main([*SMALL, "--smoke", "--grad", "--spp", "2"]) == 0
    row = _last_json(capsys.readouterr().out)
    assert row["metric"].startswith("grad-step rays/s/chip (cornell_spheres "
                                    "16x16 2spp depth1")
    assert row["value"] > 0


def test_baseline_needs_the_entry_stamp(bench, tmp_path, capsys):
    task = "cornell_spheres 16x16 1spp depth1"
    # An entry without a stamp of its own gives no ratio, even under a
    # store-level stamp equal to the run's.
    methodology = {"timing": bench.METHODOLOGY_VERSION, "device": "cpu"}
    (tmp_path / "base.json").write_text(json.dumps({
        "methodology": methodology,
        "tasks": {task: {"value": 1.0, "unit": "rays/s"}}}))
    assert bench.main(SMALL) == 0
    assert _last_json(capsys.readouterr().out)["vs_baseline"] is None
    rows = (tmp_path / "rows.jsonl").read_text().splitlines()
    assert len(rows) == 1
    row = json.loads(rows[0])
    assert row["frames"] >= 5 and row["device"] == "cpu"
    assert row["frame_rays_per_s_min"] <= row["frame_rays_per_s_median"] \
        <= row["frame_rays_per_s_max"]

    # --record-baseline stamps the entry; the next run gets a ratio.
    assert bench.main([*SMALL, "--record-baseline"]) == 0
    capsys.readouterr()
    store = json.loads((tmp_path / "base.json").read_text())
    assert store["tasks"][task]["methodology"] == methodology
    assert bench.main(SMALL) == 0
    ratio = _last_json(capsys.readouterr().out)["vs_baseline"]
    assert isinstance(ratio, float) and ratio > 0

    # Another stamp (another device's entry) gives no ratio.
    store["tasks"][task]["methodology"] = {**methodology, "device": "other"}
    (tmp_path / "base.json").write_text(json.dumps(store))
    assert bench.main(SMALL) == 0
    assert _last_json(capsys.readouterr().out)["vs_baseline"] is None


def test_smoke_writes_nothing(bench, tmp_path):
    assert bench.main([*SMALL, "--smoke", "--record-baseline"]) == 0
    assert not os.path.exists(tmp_path / "base.json")
    assert not os.path.exists(tmp_path / "rows.jsonl")


def test_reference_records_untouched(bench, tmp_path):
    """The port writes only its own record files, never the reference's
    TPU records."""
    paths = [os.path.join(ROOT, ".bench_baseline.json"),
             os.path.join(ROOT, "bench_metrics.jsonl")]
    before = [open(p, "rb").read() for p in paths]
    defaults = _load_bench()
    assert os.path.basename(defaults.BASELINE_PATH) == \
        ".bench_baseline_torch.json"
    assert os.path.basename(defaults.METRICS_PATH) == \
        "bench_metrics_torch.jsonl"
    assert bench.main([*SMALL, "--record-baseline"]) == 0
    assert bench.main([*SMALL, "--grad"]) == 0
    assert [open(p, "rb").read() for p in paths] == before
    assert sorted(os.listdir(tmp_path)) == ["base.json", "rows.jsonl"]


def test_front_end_imports_no_jax(tmp_path):
    """cli.main render and fit and bench_torch.main --smoke on the CPU,
    with neither JAX nor the reference package imported."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from pathtracer_tpu_torch import cli\n"
        "import bench_torch\n"
        f"d = {str(tmp_path)!r}\n"
        "small = ['--width', '8', '--height', '8', '--spp', '2', '--depth',"
        " '1', '--scene', 'cornell_spheres', '--no-bvh', '--device', 'cpu']\n"
        "assert cli.main(['render', *small, '--checkpoint', d + '/ck.npz',"
        " '--out', d + '/o.png']) == 0\n"
        "assert cli.main(['fit', *small, '--steps', '2', '--perturb']) == 0\n"
        "assert bench_torch.main(['--smoke', '--device', 'cpu', '--width',"
        " '8', '--height', '8', '--budget', '0']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pathtracer_tpu.') or m == 'pathtracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
