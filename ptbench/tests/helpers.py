"""Small cells for the CPU tests: the real files, shrunk."""

import torch

from ptbench import run as run_mod

TINY = {
    "bench.render": {"preset": {"width": 32, "height": 32},
                     "params": {"check_pixels": 256, "ref_block": 4096}},
    "bench.fit": {"preset": {"width": 32, "height": 32},
                  "params": {"ref_block": 4096}},
    # The grid route on the bench scene (the 2M-triangle scene is the
    # card's).
    "config5.render": {"preset": {"width": 32, "height": 32,
                                  "scene": "cornell_mesh"},
                       "params": {"check_pixels": 256, "ref_block": 4096}},
    # Two gloo ranks on the bench scene's cluster route.
    "config5_4gpu.render": {
        "config": {"chips": 2},
        "preset": {"width": 32, "height": 32, "scene": "cornell_mesh",
                   "backend": "cluster"},
        "params": {"check_pixels": 256, "ref_block": 4096}},
}


def run_cell(cell, seed=2147483701, seconds=1.0, fault=None, capsys=None):
    """Runs a shrunk cell on the CPU; returns (exit code, result dict)."""
    import json

    torch.set_num_threads(4)
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0"]
    if fault:
        argv += ["--fault", fault]
    rc = run_mod.main(argv, device=torch.device("cpu"),
                      overrides=TINY[cell])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])
