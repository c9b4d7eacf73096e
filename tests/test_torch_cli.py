"""The port's CLI (pathtracer_tpu_torch/cli.py) on the CPU, against the
reference's.

The five cases of tests/unit/test_cli.py run through
``python -m pathtracer_tpu_torch.cli ... --device cpu``. Beside them: the
same render through both CLIs within tests/oracle/test_engine.py's bar
(atol 5e-4, rtol 1e-3); a resumed render equal to a straight one (atol
1e-6); a checkpoint written by either CLI resumed by the other; the same
checkpoint and preview lines and the same fit losses from both; the fit's
Adam against optax.adam; no CUDA device, no run without --device cpu; and
cli.main render and fit import neither JAX nor the reference package.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import PRESETS, RenderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "16", "--height", "16", "--depth", "1", "--scene",
         "cornell_spheres", "--no-bvh"]
ENGINE_ATOL, ENGINE_RTOL = 5e-4, 1e-3  # tests/oracle/test_engine.py:63


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return dict(env, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **kw)


def _run(args, device="cpu"):
    """The port's CLI in a subprocess (on the CPU unless device=None)."""
    dev = [] if device is None else ["--device", device]
    return subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", *args, *dev],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300,
    )


def _run_ref(args):
    """The reference's CLI in a subprocess, on JAX's CPU backend."""
    return subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu.cli", *args],
        cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=420,
    )


def _ok(r):
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """A straight 4-spp render through each CLI: {"port": img, "ref": img}."""
    d = tmp_path_factory.mktemp("straight")
    args = [*SMALL, "--spp", "4"]
    _ok(_run(["render", *args, "--out", str(d / "port.npy")]))
    _ok(_run_ref(["render", *args, "--out", str(d / "ref.npy")]))
    return {"port": np.load(d / "port.npy"), "ref": np.load(d / "ref.npy")}


def test_render_smoke(tmp_path):
    out = tmp_path / "out.png"
    r = _run(["render", "--width", "32", "--height", "32", "--spp", "1",
              "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
              "--out", str(out)])
    assert "wrote" in _ok(r)
    assert out.exists()


def test_render_resume_roundtrip(tmp_path):
    out = tmp_path / "o.npy"
    ck = tmp_path / "ck.npz"
    _ok(_run(["render", *SMALL, "--spp", "4", "--checkpoint", str(ck),
              "--checkpoint-every", "2", "--out", str(out)]))
    full = np.load(out)
    # Resume from the checkpoint (which holds all 4 spp) → identical image.
    out2 = tmp_path / "o2.npy"
    _ok(_run(["render", *SMALL, "--spp", "4", "--resume", str(ck),
              "--out", str(out2)]))
    np.testing.assert_allclose(np.load(out2), full, atol=1e-6)


def test_render_progressive_preview(tmp_path, straight):
    """--preview-every dumps a converging preview every N spp without
    perturbing the final image."""
    out = tmp_path / "prog.npy"
    stdout = _ok(_run(["render", *SMALL, "--spp", "4", "--preview-every",
                       "2", "--out", str(out)]))
    assert stdout.count("preview ") == 2, stdout  # at 2 and 4 spp
    preview = tmp_path / "prog.preview.npy"
    assert preview.exists()
    np.testing.assert_allclose(np.load(preview), np.load(out), atol=1e-6)
    np.testing.assert_allclose(straight["port"], np.load(out), atol=1e-6)


def test_configs_dir_matches_presets():
    """configs/*.json (the reference's presets on disk) equal the port's
    PRESETS exactly."""
    cfg_dir = os.path.join(ROOT, "configs")
    on_disk = {f[:-5] for f in os.listdir(cfg_dir) if f.endswith(".json")}
    assert on_disk == set(PRESETS), (on_disk, set(PRESETS))
    for name, cfg in PRESETS.items():
        with open(os.path.join(cfg_dir, f"{name}.json")) as f:
            assert RenderConfig.from_json(f.read()) == cfg, name


def test_fit_smoke():
    stdout = _ok(_run(["fit", *SMALL, "--spp", "1", "--steps", "3",
                       "--perturb"]))
    assert "loss" in stdout


def test_render_matches_reference_cli(straight):
    np.testing.assert_allclose(straight["port"], straight["ref"],
                               atol=ENGINE_ATOL, rtol=ENGINE_RTOL)


def test_camera_flags_match_reference_cli(tmp_path):
    """--cam-pos/--cam-look/--cam-fov give the reference CLI's image."""
    args = ["render", *SMALL, "--spp", "2", "--cam-pos", "0.3", "0.6",
            "2.4", "--cam-look", "0.5", "0.35", "0.5", "--cam-fov", "50"]
    _ok(_run([*args, "--out", str(tmp_path / "port.npy")]))
    _ok(_run_ref([*args, "--out", str(tmp_path / "ref.npy")]))
    port, ref = np.load(tmp_path / "port.npy"), np.load(tmp_path / "ref.npy")
    np.testing.assert_allclose(port, ref, atol=ENGINE_ATOL, rtol=ENGINE_RTOL)
    _ok(_run(["render", *SMALL, "--spp", "2", "--out",
              str(tmp_path / "default.npy")]))
    assert not np.allclose(port, np.load(tmp_path / "default.npy"),
                           atol=1e-3)


def test_resumed_render_equals_straight(tmp_path, straight):
    """A 2-spp checkpoint resumed to 4 spp equals the straight 4-spp
    render."""
    ck = tmp_path / "ck2.npz"
    _ok(_run(["render", *SMALL, "--spp", "2", "--checkpoint", str(ck),
              "--out", str(tmp_path / "half.npy")]))
    stdout = _ok(_run(["render", *SMALL, "--spp", "4", "--resume", str(ck),
                       "--out", str(tmp_path / "resumed.npy")]))
    assert "resumed at 2/4 spp" in stdout
    np.testing.assert_allclose(np.load(tmp_path / "resumed.npy"),
                               straight["port"], atol=1e-6)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_resumes_across_clis(tmp_path, straight, writer):
    """A 2-spp checkpoint from one package's CLI, resumed to 4 spp by the
    other's, equals the resuming package's straight render within the
    engine bar."""
    ck = str(tmp_path / "ck2.npz")
    half = ["render", *SMALL, "--spp", "2", "--checkpoint", ck, "--out",
            str(tmp_path / "half.npy")]
    resume = ["render", *SMALL, "--spp", "4", "--resume", ck, "--out",
              str(tmp_path / "resumed.npy")]
    if writer == "ref":
        _ok(_run_ref(half))
        stdout = _ok(_run(resume))
        reader = "port"
    else:
        _ok(_run(half))
        stdout = _ok(_run_ref(resume))
        reader = "ref"
    assert "resumed at 2/4 spp" in stdout
    np.testing.assert_allclose(np.load(tmp_path / "resumed.npy"),
                               straight[reader], atol=ENGINE_ATOL,
                               rtol=ENGINE_RTOL)


def _progress_lines(stdout):
    """The checkpointed and preview lines, without the path and time."""
    return [line.split(" -> ")[0] for line in stdout.splitlines()
            if line.startswith(("checkpointed ", "preview "))]


def test_checkpoint_and_preview_lines_match_reference(tmp_path):
    args = [*SMALL, "--spp", "8", "--checkpoint-every", "3",
            "--preview-every", "2"]
    port = _ok(_run(["render", *args, "--checkpoint",
                     str(tmp_path / "p.npz"), "--out",
                     str(tmp_path / "p.npy")]))
    ref = _ok(_run_ref(["render", *args, "--checkpoint",
                        str(tmp_path / "r.npz"), "--out",
                        str(tmp_path / "r.npy")]))
    lines = _progress_lines(port)
    assert lines == _progress_lines(ref)
    assert lines == ["preview 2/8 spp", "checkpointed 3/8 spp",
                     "preview 4/8 spp", "checkpointed 6/8 spp",
                     "preview 6/8 spp", "checkpointed 8/8 spp",
                     "preview 8/8 spp"]


def _losses(stdout):
    return [float(x) for x in re.findall(r"^step +\d+  loss (\S+)$", stdout,
                                         re.M)]


def test_fit_matches_reference_cli():
    """The same perturbation, target and optimizer: both CLIs print the
    same losses to their printed precision."""
    args = ["fit", *SMALL, "--spp", "1", "--steps", "3", "--perturb"]
    port, ref = _losses(_ok(_run(args))), _losses(_ok(_run_ref(args)))
    assert len(port) == len(ref) == 3
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=2e-6)


def test_adam_matches_optax():
    """Three steps of the fit's optimizer on fixed grads equal
    optax.adam's. optax computes the bias corrections 1 - b^t in f32 (up to
    3e-5 relative error on 1 - 0.999^t; torch in f64), so each update may
    differ by lr * 2e-5 = 6e-7: atol 2e-6 over three steps."""
    rng = np.random.default_rng(3)
    init = [rng.random((7, 3)).astype(np.float32) for _ in range(2)]
    grads = [[rng.normal(size=(7, 3)).astype(np.float32) for _ in range(2)]
             for _ in range(3)]
    params = [torch.from_numpy(x.copy()).requires_grad_(True) for x in init]
    opt = cli.adam(params, 0.03)
    ref_opt = optax.adam(0.03)
    ref_params = [jnp.asarray(x) for x in init]
    state = ref_opt.init(ref_params)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        updates, state = ref_opt.update([jnp.asarray(x) for x in g], state,
                                        ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        for p, rp in zip(params, ref_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp),
                                       rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("cmd", ["render", "fit"])
def test_no_cuda_device_exits_nonzero(cmd):
    """Without a CUDA device the default --device cuda refuses to run and
    names --device cpu; there is no fallback to the CPU."""
    assert not torch.cuda.is_available()
    args = {"render": ["render", *SMALL], "fit": ["fit", *SMALL]}[cmd]
    r = _run(args, device=None)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert "wrote" not in r.stdout and "loss" not in r.stdout


def test_front_end_imports_no_jax(tmp_path):
    """cli.main render and fit on the CPU, with neither JAX nor the
    reference package imported."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from pathtracer_tpu_torch import cli\n"
        f"d = {str(tmp_path)!r}\n"
        "small = ['--width', '8', '--height', '8', '--spp', '2', '--depth',"
        " '1', '--scene', 'cornell_spheres', '--no-bvh', '--device', 'cpu']\n"
        "assert cli.main(['render', *small, '--checkpoint', d + '/ck.npz',"
        " '--out', d + '/o.png']) == 0\n"
        "assert cli.main(['fit', *small, '--steps', '2', '--perturb']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pathtracer_tpu.') or m == 'pathtracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
