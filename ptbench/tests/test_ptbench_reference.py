"""The reference agrees with the port at a small size on the CPU, and the
control (the reference in bfloat16) does not: each cell's check passes the
port and fails the control by its own limits."""

import pytest
import torch

from ptbench import check, harness, program
from ptbench.reference import scenes
from ptbench.tests.helpers import TINY

from pathtracer_tpu_torch.scene.builder import build_scene


def small_run(cell, seed):
    run = harness.Run(cell, seed, 0.0, False, 0.0, torch.device("cpu"),
                      overrides=TINY[cell])
    mode = harness.load_module("modes", run.cell["mode"]).Mode
    return run, mode


@pytest.mark.parametrize("name", ["cornell_mesh"])
def test_reference_scene_equals_the_program_s(name):
    ref = scenes.build(name, str(harness.ROOT))
    prog = build_scene(name)
    g = prog.geometry
    tri = ref["tri"]
    assert torch.equal(tri[:, 0], g.tri_v0)
    assert torch.equal(tri[:, 1] - tri[:, 0], g.tri_e1)
    assert torch.equal(ref["light_cdf"], prog.lights.cdf)
    assert torch.equal(ref["light_tri"].to(torch.int32), prog.lights.tri_idx)
    assert torch.equal(ref["albedo"], prog.materials.albedo)


def test_big_mesh_definition_small():
    from pathtracer_tpu_torch.scene.builder import big_mesh

    ref = scenes.big_mesh_tris(20_000)
    prog = big_mesh(n_target=20_000).geometry
    assert torch.equal(torch.from_numpy(ref[:, 0]), prog.tri_v0[12:])


@pytest.mark.parametrize("cell", ["bench.render", "config5.render"])
def test_render_check_passes_port_fails_control(cell):
    torch.set_num_threads(4)
    run, Mode = small_run(cell, 123)
    mode = Mode(run)
    mode.start(123)
    for i in range(run.params["check_within"] + 2):
        mode.frame(i)
    ref = check.Reference(run.config, run.device)
    sound = mode.numbers(mode.outputs(), ref)
    low = check.Reference(run.config, run.device, torch.bfloat16)
    control = mode.control(ref, low)
    limit = run.limit("bad_px_share")
    assert sound["bad_px_share"] <= limit
    assert control["bad_px_share"] > limit


def test_fit_check_passes_port_fails_control():
    torch.set_num_threads(4)
    run, Mode = small_run("bench.fit", 7)
    mode = Mode(run)
    mode.start(7)
    ref = check.Reference(run.config, run.device)
    sound = mode.numbers(mode.outputs(), ref)
    low = check.Reference(run.config, run.device, torch.bfloat16)
    control = mode.control(ref, low)
    mode.free()
    for name, value in sound.items():
        assert value <= run.limit(name), (name, value)
    assert any(v > run.limit(k) for k, v in control.items()), control


def test_program_config_is_the_preset():
    from pathtracer_tpu_torch.config import PRESETS

    for name in ("bench", "config5"):
        cfg = program.render_config(harness.load_json("configs", name), 0)
        assert cfg == PRESETS[name]
