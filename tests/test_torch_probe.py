"""The visit-arithmetic probes (ops/visit_probe.py) against the JAX kernels
of scripts/_probe_compile.py (K5 kern_f32, K6 kern_split_in, K7
kern_split_pre).

The script cannot be imported (it reads sys.argv and launches at import),
so its kernel functions and `dims` are taken from its source with `ast` and
run through pl.pallas_call in TPU interpret mode with the script's specs;
where R spans several 512-ray blocks the rays are blocked per grid step (in
the script R is one block, so its whole-array spec is that block). Inputs
come from a numpy seed. Bars: the plain versions against the JAX kernels at
rtol 1e-5 / atol 1e-6; the hi/lo split bit-equal to JAX's astype split.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pathtracer_tpu_torch.ops import visit_probe as vp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "_probe_compile.py")
RB = 512
ZERO_ROW = 1  # the mask row left all zero: block 1 of R = 2048 gives 1e9


def _script_body():
    tree = ast.parse(open(SCRIPT).read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name.startswith("kern_"))
            or (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "dims" for t in n.targets))]
    assert {n.name for n in keep if isinstance(n, ast.FunctionDef)} == {
        "kern_f32", "kern_split_in", "kern_split_pre"}
    return compile(ast.Module(body=keep, type_ignores=[]), SCRIPT, "exec")


BODY = _script_body()


def _jax_probe(variant, mask, *args):
    """The script's kern_<variant> over R rays and C clusters → (8, R)."""
    C = mask.shape[1]
    R = args[0].shape[1]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "C": C, "RB": RB}
    exec(BODY, ns)
    vspec = pl.BlockSpec(memory_space=pltpu.VMEM)
    rspec = pl.BlockSpec((16, RB), lambda i: (0, i), memory_space=pltpu.VMEM)
    sspec = pl.BlockSpec((8, C), lambda i: (0, 0), memory_space=pltpu.SMEM)
    out_spec = pl.BlockSpec((8, RB), lambda i: (0, i),
                            memory_space=pltpu.VMEM)
    n_rays = 1 if variant in ("f32", "split_in") else 2
    in_specs = [sspec] + [rspec] * n_rays + [vspec] * n_rays
    out = pl.pallas_call(
        ns[f"kern_{variant}"], grid=(R // RB,), in_specs=in_specs,
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct((8, R), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(mask, *args)
    return np.asarray(out)


def _jax_split(x):
    hi = jnp.asarray(x).astype(jnp.bfloat16)
    lo = (jnp.asarray(x) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, lo


def _inputs(R, C, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((8, C)) < 0.6).astype(np.int32)
    mask[:, rng.integers(C)] = 1
    mask[ZERO_ROW] = 0
    rayf = rng.random((16, R), np.float32)
    feat = rng.random((16, C * 512), np.float32)
    return mask, rayf, feat


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("variant", vp.VARIANTS)
@pytest.mark.parametrize("R,C", [(512, 4), (512, 6), (2048, 4), (2048, 6)])
def test_plain_matches_jax_kernel(variant, R, C):
    mask, rayf, feat = _inputs(R, C, seed=R + C)
    tm = torch.from_numpy(mask)
    if variant == "split_pre":
        want = _jax_probe(variant, mask, *_jax_split(rayf), *_jax_split(feat))
        got = vp.probe_split_pre_plain(
            tm, *vp.split_bf16(torch.from_numpy(rayf)),
            *vp.split_bf16(torch.from_numpy(feat)))
    else:
        want = _jax_probe(variant, mask, rayf, feat)
        plain = getattr(vp, f"probe_{variant}_plain")
        got = plain(tm, torch.from_numpy(rayf), torch.from_numpy(feat))
    assert (want == want[0]).all()  # the TPU kernel's broadcast rows
    assert got.shape == (R,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[0], rtol=1e-5, atol=1e-6)
    if R > RB:
        assert (got[RB:2 * RB] == vp.INIT).all()  # block 1: row ZERO_ROW


def test_split_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 100,
                        rng.random(4096, np.float32),
                        np.float32([0.0, -0.0, 1e8, 3.0e38, 1e-30, -2.5])])
    hi, lo = vp.split_bf16(torch.from_numpy(x))
    want_hi, want_lo = _jax_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(hi), _bf16_bits(want_hi))
    np.testing.assert_array_equal(_bf16_bits(lo), _bf16_bits(want_lo))


def test_split_costs_what_the_reference_says():
    """The split products agree with the f32 product to about 2^-16 of the
    terms' magnitude (the dropped lo*lo term and lo's rounding)."""
    mask, rayf, feat = _inputs(1024, 4, seed=3)
    args = (torch.from_numpy(mask), torch.from_numpy(rayf),
            torch.from_numpy(feat))
    f32 = vp.probe_f32_plain(*args)
    split = vp.probe_split_in_plain(*args)
    np.testing.assert_allclose(split.numpy(), f32.numpy(), rtol=1e-4)
    assert not torch.equal(split, f32)


def test_wrappers_run_plain_on_cpu_and_do_not_count():
    mask, rayf, feat = (torch.from_numpy(a) for a in _inputs(1024, 4, 5))
    counters = ("F32_LAUNCHES", "SPLIT_IN_LAUNCHES", "SPLIT_PRE_LAUNCHES")
    before = [getattr(vp, c) for c in counters]
    assert torch.equal(vp.probe_f32(mask, rayf, feat),
                       vp.probe_f32_plain(mask, rayf, feat))
    assert torch.equal(vp.probe_split_in(mask, rayf, feat),
                       vp.probe_split_in_plain(mask, rayf, feat))
    split = (*vp.split_bf16(rayf), *vp.split_bf16(feat))
    assert torch.equal(vp.probe_split_pre(mask, *split),
                       vp.probe_split_pre_plain(mask, *split))
    assert [getattr(vp, c) for c in counters] == before


def test_wrappers_reject_bad_inputs():
    mask, rayf, feat = (torch.from_numpy(a) for a in _inputs(1024, 4, 5))
    bad = [
        (mask.to(torch.int64), rayf, feat),  # mask dtype
        (mask[:4].contiguous(), rayf, feat),  # mask rows
        (mask, rayf[:, :1000].contiguous(), feat),  # R not whole blocks
        (mask, rayf[:15].contiguous(), feat),  # feature rows
        (mask, rayf, feat[:, :1536].contiguous()),  # table vs C
        (mask, rayf.to(torch.float64), feat),  # ray dtype
        (mask, rayf.T.contiguous().T, feat),  # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            vp.probe_f32(*args)
    with pytest.raises(ValueError):  # split_pre takes bf16 only
        vp.probe_split_pre(mask, rayf, rayf, feat, feat)


def test_entry_point_runs_the_script_shapes(capsys):
    assert vp.main(["split_in", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("split_in: built in 0.00s, ran in ")
    assert "512 rays" in line
    mask, rayf, feat = vp.probe_inputs(device="cpu")
    assert mask.shape == (8, 4) and rayf.shape == (16, 512)
    assert feat.shape == (16, 2048) and bool((mask == 1).all())
    out, build_s, _ = vp.run("split_pre", mask, rayf, feat)
    assert build_s == 0.0
    assert torch.equal(out, vp.probe_split_in_plain(mask, rayf, feat))
