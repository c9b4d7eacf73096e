"""No module the benchmark loads is JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from ptbench import harness

ROOT = str(harness.ROOT)

PROBE = r"""
import json, sys, torch
from ptbench import run
from ptbench.tests.helpers import TINY
torch.set_num_threads(2)
for cell, trace in (("bench.render", "0"), ("bench.fit", "0")):
    rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                   "--trace", trace], device=torch.device("cpu"),
                  overrides=TINY[cell])
    assert rc == 0, rc
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch_like", object())
    assert "pathtracer_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pathtracer_tpu.config", object())
    assert "pathtracer_tpu.config" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pathtracer_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_run_refuses_without_cards(monkeypatch, capsys):
    import torch

    from ptbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "bench.render", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_rank_0_refuses_the_cpu(capsys):
    from ptbench import run

    rc = run.main(["--workload", "bench.render", "--seed", "1",
                   "--seconds", "1", "--trace", "0", "--device", "cpu",
                   "--overrides", "{}"])
    assert rc != 0
    assert capsys.readouterr().out == ""
