"""On the card: a short run of each one-card cell comes out correct with
its result line complete (python -m pytest ptbench/tests -m card)."""

import json

import pytest

from ptbench import run as run_mod


@pytest.mark.card
@pytest.mark.parametrize("cell", ["bench.render", "bench.fit"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_run_is_correct(card, cell, trace, capsys):
    rc = run_mod.main(["--workload", cell, "--seed", "2147483999",
                       "--seconds", "3", "--trace", trace])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["metrics"]
    if trace == "1":
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
