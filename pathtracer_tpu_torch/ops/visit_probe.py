"""Visit-arithmetic probes: how should a cluster visit do its arithmetic?

The counterpart of the reference's ``scripts/_probe_compile.py``, whose
three Pallas kernels are K5 (``kern_f32``), K6 (``kern_split_in``) and K7
(``kern_split_pre``). Each computes, for every ray of a (16, R) feature
block, the minimum over the 512 columns of every enabled cluster of the
product ``feat[:, col] . rayf[:, ray]``, starting from 1e9; cluster k is
enabled for the 512-ray block b when ``mask[b % 8, k] > 0``. That is the
product of a cluster visit (ops/csrc/visit.cuh) without its hit predicate:

  probe_f32        the product in f32 (on the card: the CUDA cores);
  probe_split_in   the bf16 hi/lo error split hi*hi + lo*hi + hi*lo, split
                   inside the kernel (on the card: the tensor cores);
  probe_split_pre  the same from operands split beforehand (split_bf16).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/visit_probe.cu``, built at first use; K5 on the CUDA cores, K6 on
``mma.sync``, K7 on ``wgmma`` fed by TMA) and counts the launch in its
own counter (``F32_LAUNCHES``, ``SPLIT_IN_LAUNCHES`` or
``SPLIT_PRE_LAUNCHES``); on a CPU tensor it runs its plain version
(``*_plain``).
The TPU kernels' broadcast (8, R) output was a Mosaic artefact: these return
(R,).

    python -m pathtracer_tpu_torch.ops.visit_probe {f32,split_in,split_pre}

runs one variant at the script's shapes (R = 512, C = 4, all clusters
enabled, uniform inputs from a seed) on the card and prints its build and
run seconds; ``--device cpu`` runs the plain version instead.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from . import _build

RAY_BLOCK = 512  # rays per block: the mask row is block % MASK_ROWS
MASK_ROWS = 8
CLUSTER_COLS = 512
FEAT_ROWS = 16
INIT = 1e9  # the minimum where no cluster is enabled
SCRIPT_RAYS, SCRIPT_CLUSTERS = 512, 4  # the reference script's shapes

VARIANTS = ("f32", "split_in", "split_pre")

# Kernel launches through each wrapper (CUDA tensors only).
F32_LAUNCHES = 0
SPLIT_IN_LAUNCHES = 0
SPLIT_PRE_LAUNCHES = 0


def split_bf16(x: torch.Tensor):
    """bf16 hi/lo error split, x ~= hi + lo, each rounded to nearest even
    (the reference's ops/intersect_cluster.py:split_bf16)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _check(mask, rays, tables, dtype):
    if mask.dtype != torch.int32 or mask.dim() != 2 \
            or mask.shape[0] != MASK_ROWS:
        raise ValueError(f"mask must be int32 ({MASK_ROWS}, C); got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    C = mask.shape[1]
    R = rays[0].shape[-1] if rays[0].dim() == 2 else -1
    if R <= 0 or R % RAY_BLOCK:
        raise ValueError(f"rays must be (16, R) with R a positive multiple "
                         f"of {RAY_BLOCK}; got {tuple(rays[0].shape)}")
    for name, x, shape in ([("rays", x, (FEAT_ROWS, R)) for x in rays]
                           + [("table", x, (FEAT_ROWS, C * CLUSTER_COLS))
                              for x in tables]):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}; got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in (mask, *rays, *tables):
        if x.device != mask.device:
            raise ValueError(f"inputs on {x.device} and {mask.device}")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on cpu or cuda, not {mask.device}")
    return C, R


def _masked_min(mask, R, product) -> torch.Tensor:
    """min over enabled clusters k of product(k).amin(0), from INIT;
    product(k) is the (512, R) f32 product of cluster k's columns."""
    rows = (torch.arange(R, device=mask.device) // RAY_BLOCK) % MASK_ROWS
    enabled = (mask[rows] > 0).T  # (C, R)
    out = torch.full((R,), INIT, dtype=torch.float32, device=mask.device)
    for k in range(mask.shape[1]):
        if bool(enabled[k].any()):
            out = torch.where(enabled[k],
                              torch.minimum(out, product(k).amin(0)), out)
    return out


def _cols(table, k):
    return table[:, k * CLUSTER_COLS:(k + 1) * CLUSTER_COLS]


def probe_f32_plain(mask, rayf, feat) -> torch.Tensor:
    """K5's function in plain PyTorch: (feat_k.T @ rayf).amin(0) in f32
    over the enabled clusters (on the card, with TF32 off)."""
    _check(mask, (rayf,), (feat,), torch.float32)
    return _masked_min(mask, rayf.shape[1],
                       lambda k: _cols(feat, k).T @ rayf)


def _split_product(r_hi, r_lo, f_hi, f_lo, R, mask):
    r_hi, r_lo = r_hi.to(torch.float32), r_lo.to(torch.float32)
    f_hi, f_lo = f_hi.to(torch.float32), f_lo.to(torch.float32)

    def product(k):
        fh, fl = _cols(f_hi, k).T, _cols(f_lo, k).T
        return (fh @ r_hi + fh @ r_lo) + fl @ r_hi

    return _masked_min(mask, R, product)


def probe_split_in_plain(mask, rayf, feat) -> torch.Tensor:
    """K6's function in plain PyTorch: both operands split with
    split_bf16, widened to f32, and the three products summed in the
    kernel's order, hi*hi + lo*hi + hi*lo."""
    _check(mask, (rayf,), (feat,), torch.float32)
    return _split_product(*split_bf16(rayf), *split_bf16(feat),
                          rayf.shape[1], mask)


def probe_split_pre_plain(mask, rayf_hi, rayf_lo, feat_hi,
                          feat_lo) -> torch.Tensor:
    """K7's function in plain PyTorch: probe_split_in_plain from operands
    split beforehand (bf16 hi and lo of rays and table)."""
    _check(mask, (rayf_hi, rayf_lo), (feat_hi, feat_lo), torch.bfloat16)
    return _split_product(rayf_hi, rayf_lo, feat_hi, feat_lo,
                          rayf_hi.shape[1], mask)


def _launch(name, args, C, R):
    """Launches `name`'s kernel on args + a new (R,) output (CUDA only)."""
    fn = getattr(_build.load("visit_probe"), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * (len(args) + 1) + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = args[0].device
    out = torch.empty((R,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(*(x.data_ptr() for x in args), out.data_ptr(), C, R,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def probe_f32(mask, rayf, feat) -> torch.Tensor:
    """K5: (R,) f32 minimum (see probe_f32_plain). CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global F32_LAUNCHES
    C, R = _check(mask, (rayf,), (feat,), torch.float32)
    if mask.device.type == "cpu":
        return probe_f32_plain(mask, rayf, feat)
    out = _launch("probe_f32", (mask, rayf, feat), C, R)
    F32_LAUNCHES += 1
    return out


def probe_split_in(mask, rayf, feat) -> torch.Tensor:
    """K6: (R,) f32 minimum of the split product, split in the kernel (see
    probe_split_in_plain). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    global SPLIT_IN_LAUNCHES
    C, R = _check(mask, (rayf,), (feat,), torch.float32)
    if mask.device.type == "cpu":
        return probe_split_in_plain(mask, rayf, feat)
    out = _launch("probe_split_in", (mask, rayf, feat), C, R)
    SPLIT_IN_LAUNCHES += 1
    return out


def probe_split_pre(mask, rayf_hi, rayf_lo, feat_hi, feat_lo) -> torch.Tensor:
    """K7: (R,) f32 minimum of the split product from split operands (see
    probe_split_pre_plain). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    global SPLIT_PRE_LAUNCHES
    args = (mask, rayf_hi, rayf_lo, feat_hi, feat_lo)
    C, R = _check(mask, args[1:3], args[3:5], torch.bfloat16)
    if mask.device.type == "cpu":
        return probe_split_pre_plain(*args)
    if feat_hi.data_ptr() % 16 or feat_lo.data_ptr() % 16:
        raise ValueError("the split tables must be 16-byte aligned (the "
                         "kernel's TMA copies read them)")
    out = _launch("probe_split_pre", args, C, R)
    SPLIT_PRE_LAUNCHES += 1
    return out


def probe_inputs(seed: int = 0, device="cuda"):
    """The script's inputs at its shapes (R = 512, C = 4): an all-ones
    (8, C) mask and uniform [0, 1) (16, R) rays and (16, C*512) table from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    rayf = torch.from_numpy(rng.random((FEAT_ROWS, SCRIPT_RAYS), np.float32))
    feat = torch.from_numpy(rng.random(
        (FEAT_ROWS, SCRIPT_CLUSTERS * CLUSTER_COLS), np.float32))
    mask = torch.ones((MASK_ROWS, SCRIPT_CLUSTERS), dtype=torch.int32)
    return mask.to(device), rayf.to(device), feat.to(device)


def run(variant: str, mask, rayf, feat):
    """One probe of `variant` on (mask, rayf, feat), splitting beforehand for
    split_pre; returns ((R,) minimum, build seconds, run seconds). The
    build is nvcc's first-use build of csrc/visit_probe.cu (0 on the CPU or
    once built); the run is the call and, on the card, a synchronise."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant}")
    cuda = mask.device.type == "cuda"
    build_s = 0.0
    if cuda:
        t0 = time.perf_counter()
        _build.load("visit_probe")
        build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    if variant == "f32":
        out = probe_f32(mask, rayf, feat)
    elif variant == "split_in":
        out = probe_split_in(mask, rayf, feat)
    else:
        out = probe_split_pre(mask, *split_bf16(rayf), *split_bf16(feat))
    if cuda:
        torch.cuda.synchronize(mask.device)
    return out, build_s, time.perf_counter() - t1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.ops.visit_probe",
        description="Build and run one visit-arithmetic probe.")
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, the default) or cpu (the plain "
                         "version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "version")
    inputs = probe_inputs(device=device)
    out, build_s, run_s = run(args.variant, *inputs)
    print(f"{args.variant}: built in {build_s:.2f}s, ran in {run_s:.4f}s "
          f"on {device} ({out.shape[0]} rays, min {out.min().item():.6g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
