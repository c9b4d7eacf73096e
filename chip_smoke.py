"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA cluster kernel from the repository's sources, holds it
against its plain PyTorch version at the main path's shapes, renders the
two golden scenes and compares them with ``tests/golden``, renders the
``bench`` preset at its full 1024x1024 through the kernel and times it.
Every phase either passes or raises; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all passed. There is no CPU
path: without a CUDA device the script fails at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.camera import tiled_pixel_ids
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.scene import builder

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
KERNEL_SOURCE = "pathtracer_tpu_torch/ops/csrc/intersect_cluster.cu"
REPLACES = "pathtracer_tpu/ops/intersect_cluster.py:211"
CHECK_PIXELS = 256 * 1024  # rays per query in the kernel-vs-plain phase
T_RTOL, T_ATOL = 4e-3, 2e-4  # the reference's cluster-vs-brute t bar
MAT_AGREE = 0.999


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_scene(cfg: RenderConfig, device):
    scene = builder.build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    return prepare_accel(scene, cfg).to(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load("intersect_cluster")
    rec = _build.BUILDS["intersect_cluster"]
    print(f"[build] intersect_cluster.cu: nvcc {rec['seconds']:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s total")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] ptxas: {line.strip()}")


def record_main_path_queries(scene, cfg, pixel_ids):
    """The (cand, count, tnear, rayf) the main path hands to cluster_hit for
    bounce 0: its closest-hit query and its NEE shadow query."""
    calls = []
    real = ic.cluster_hit

    def recording(cand, count, tnear, rayf, feat):
        calls.append((cand, count, tnear, rayf))
        return real(cand, count, tnear, rayf, feat)

    ic.cluster_hit = recording
    try:
        wavefront.trace_sample(scene.geometry, scene.materials, scene.camera,
                               scene.lights, cfg.replace(max_depth=1),
                               pixel_ids, 0)
    finally:
        ic.cluster_hit = real
    return calls


def phase_kernel_vs_plain(scene, cfg, device) -> dict:
    feat = scene.geometry.cl_feat
    slot_nm = scene.geometry.cl_slot_nm
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                          device=device)[:CHECK_PIXELS]
    before = ic.LAUNCHES
    queries = record_main_path_queries(scene, cfg, ids)
    check(len(queries) == 2, f"bounce 0 made {len(queries)} cluster "
          "queries, expected 2 (closest hit + shadow)")
    check(ic.LAUNCHES == before + 2, "main-path queries launched the kernel")
    out = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for name, (cand, count, tnear, rayf) in zip(("closest", "shadow"),
                                                queries):
        n0 = ic.LAUNCHES
        t_k, s_k, v_k = ic.cluster_hit(cand, count, tnear, rayf, feat)
        torch.cuda.synchronize()
        check(ic.LAUNCHES == n0 + 1, "cluster_hit launched the kernel")
        t_p, s_p, v_p = ic.cluster_hit_plain(cand, count, tnear, rayf, feat)
        hit_k, hit_p = s_k >= 0, s_p >= 0
        check(torch.equal(hit_k, hit_p), f"{name}: hit masks differ in "
              f"{int((hit_k != hit_p).sum())} rays")
        torch.testing.assert_close(t_k[hit_k], t_p[hit_p], rtol=T_RTOL,
                                   atol=T_ATOL)
        mat_k = slot_nm[s_k[hit_k].long(), 3]
        mat_p = slot_nm[s_p[hit_p].long(), 3]
        agree = (mat_k == mat_p).float().mean().item() if hit_k.any() else 1.0
        check(agree >= MAT_AGREE, f"{name}: material agreement {agree}")
        err = (t_k[hit_k] - t_p[hit_p]).abs().max().item() \
            if hit_k.any() else 0.0
        ms = cuda_ms(lambda: ic.cluster_hit(cand, count, tnear, rayf, feat),
                     20)
        plain_ms = cuda_ms(
            lambda: ic.cluster_hit_plain(cand, count, tnear, rayf, feat), 3)
        n_rays = rayf.shape[1]
        print(f"[kernel] {name} query: {n_rays} rays in {cand.shape[0]} "
              f"blocks, {int(hit_k.sum())} hits, visits/block kernel "
              f"{v_k.float().mean().item():.2f} plain "
              f"{v_p.float().mean().item():.2f}; hit masks equal, t max abs "
              f"err {err:.3g}, t bit-equal "
              f"{bool(torch.equal(t_k, t_p))}, material agreement "
              f"{agree:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def phase_goldens(device) -> None:
    mesh = builder.procedural_bunny(2)
    cases = [
        # (name, scene, cfg, rtol, atol) — the reference's own bars:
        # cluster vs jnp engine (tests/unit/test_cluster.py) and engine
        # vs oracle (tests/oracle/test_engine.py).
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh),
         RenderConfig(width=32, height=32, spp=4, max_depth=4, rr_start=2,
                      scene="cornell_mesh", use_bvh=True, backend="cluster",
                      compact=True), 2e-3, 2e-3),
        ("config1_64", builder.cornell_spheres(),
         RenderConfig(width=64, height=64, spp=4, max_depth=1,
                      scene="cornell_spheres", use_bvh=False), 1e-3, 5e-4),
    ]
    for name, scene, cfg, rtol, atol in cases:
        if cfg.use_bvh:
            scene = with_bvh(scene)
        scene = prepare_accel(scene, cfg).to(device)
        img = pt.render(scene, cfg).cpu().numpy()
        golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
        bad = ~np.isclose(img, golden, rtol=rtol, atol=atol)
        bad_px = bad.any(-1).mean()
        print(f"[golden] {name}: max abs diff "
              f"{np.abs(img - golden).max():.3g}, pixels outside "
              f"rtol={rtol} atol={atol}: {bad_px:.3g}")
        check(np.isfinite(img).all(), f"{name}: finite image")
        check(bad_px <= 1e-4, f"{name}: {bad_px} of pixels outside the bar")


def phase_main_path(device, card: str) -> int:
    cfg = pt.PRESETS["bench"]
    t0 = time.perf_counter()
    scene = bench_scene(cfg, device)
    print(f"[main] bench scene: {scene.geometry.tri_v0.shape[0]} triangles, "
          f"{scene.geometry.cl_lo.shape[0]} clusters, host build "
          f"{time.perf_counter() - t0:.2f} s")
    ic.LAUNCHES = 0
    img = pt.render(scene, cfg)
    torch.cuda.synchronize()
    launches = ic.LAUNCHES
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), "image shape")
    check(bool(torch.isfinite(img).all()), "finite image")
    check(bool((img >= 0).all()), "non-negative image")
    mean = img.mean().item()
    check(mean > 0.0, "image mean above 0")
    check(launches == 2 * cfg.max_depth,
          f"{launches} kernel launches, expected {2 * cfg.max_depth}")
    print(f"[main] render(bench) {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth}: mean {mean:.6f}, {launches} kernel launches")

    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    args = (scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
            ids, 0)
    wavefront.trace_sample(*args, with_stats=True)
    torch.cuda.synchronize()
    rates, secs = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n = wavefront.trace_sample(*args, with_stats=True)
        n = int(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        secs.append(dt)
        rates.append(n / dt)
    print(f"[main] trace_sample(bench, tiled, with_stats): {n} useful rays, "
          f"frame s {[round(s, 6) for s in secs]}, median "
          f"{statistics.median(rates):.1f} useful rays/s on {card}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); this check runs on the "
                         "GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build()
    with torch.inference_mode():
        k1 = phase_kernel_vs_plain(bench_scene(pt.PRESETS["bench"], device),
                                   pt.PRESETS["bench"], device)
        phase_goldens(device)
        launches = phase_main_path(device, card)
    print(json.dumps({"kernels": [{
        "name": "cluster_hit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
