"""The port's logging and timing helpers (utils/logging.py,
utils/profiling.py) on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.utils import logging as lg
from pathtracer_tpu_torch.utils import profiling as pf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_is_host_zero_without_distributed():
    assert not torch.distributed.is_initialized()
    assert lg.is_host_zero()


def test_is_host_zero_on_rank_zero_of_a_group(tmp_path):
    """Rank 0 of an initialised (one-process, gloo) group is host zero."""
    code = (
        "import sys, torch.distributed as dist\n"
        "from pathtracer_tpu_torch.utils.logging import is_host_zero\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/pg',"
        " rank=0, world_size=1)\n"
        "try:\n"
        "    assert dist.is_initialized() and is_host_zero()\n"
        "finally:\n"
        "    dist.destroy_process_group()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_log_json_row_sorted(tmp_path, capsys):
    path = tmp_path / "rows.jsonl"
    lg.log_json(str(path), zeta=1, alpha="a", mid=[1, 2])
    lg.log_json(str(path), beta=2.5)
    lines = path.read_text().splitlines()
    assert lines == ['{"alpha": "a", "mid": [1, 2], "zeta": 1}',
                     '{"beta": 2.5}']
    lg.log_json(None, b=1, a=2)
    assert capsys.readouterr().out == json.dumps({"a": 2, "b": 1}) + "\n"


def test_log_line(capsys):
    lg.log("bench measured", frames=5, secs=1.5)
    err = capsys.readouterr().err
    assert err.startswith("[pathtracer ")
    assert err.rstrip().endswith("] bench measured frames=5 secs=1.5")


def test_device_barrier_and_timer_on_cpu():
    x = torch.arange(3.0, 7.0)
    assert pf.device_barrier(x) == 3.0
    assert pf.device_barrier(torch.tensor(5, dtype=torch.int64)) == 5.0
    assert pf.device_barrier(np.array([[2.5, 1.0]])) == 2.5
    with pf.Timer() as t:
        y = (x * 2).sum()
        secs = t.barrier(y)
    assert secs == t.seconds and secs >= 0.0
    with pf.Timer() as t2:
        pass
    assert t2.seconds is not None and t2.seconds >= 0.0
    assert pf.rays_per_second(100, 2.0) == 50.0
    assert pf.rays_per_second(5, 0.0) == pytest.approx(5e12)


def test_trace_writes_a_trace_file(tmp_path):
    with pf.trace(str(tmp_path)) as prof:
        (torch.ones(64) * 3.0).sum().item()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(tmp_path)
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert any("aten::ones" in e.key for e in prof.key_averages())
