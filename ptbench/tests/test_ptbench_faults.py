"""A run with its timed path broken underneath comes out not correct, for
each fault its cell can have; the same run unbroken comes out correct.
The runs skip the look for a card and go through run.py's whole course on
the CPU, shrunk."""

import pytest

from ptbench.tests.helpers import run_cell

CASES = [
    ("bench.render", None, True),
    ("bench.render", "answer", False),
    ("bench.render", "half_batch", False),
    ("config5.render", "answer", False),
    ("bench.fit", None, True),
    ("bench.fit", "unchanged", False),
    ("bench.fit", "half_batch", False),
    ("config5_4gpu.render", None, True),
    ("config5_4gpu.render", "exchange", False),
    ("config5_4gpu.render", "answer", False),
]


@pytest.mark.parametrize("cell,fault,correct", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_fault_is_caught(cell, fault, correct, capsys):
    rc, out = run_cell(cell, fault=fault, capsys=capsys)
    assert rc == 0
    assert out["correct"] is correct, out["checks"]
    assert list(out)[-1] == "checks"
    # A run off the card puts no number under a card's name.
    assert out["device"]["platform"] == "cpu" and out["metrics"] == {}
