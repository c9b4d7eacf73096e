"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the two CUDA kernels (cluster and pair) and the native BVH builder
from the repository's sources, all at once. Holds each kernel against its
plain PyTorch version at its main path's shapes, renders the golden scenes
through the cluster and the grid routes and compares them with
``tests/golden``, then drives the two main paths at full size: the
``bench`` preset (cornell_mesh, cluster route, K1) and ``config5``
(big_mesh, 2M triangles, grid route, K2), each rendered and timed. Every
phase either passes or raises; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all passed. There is no CPU
path: without a CUDA device the script fails at once.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.accel import native
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.camera import tiled_pixel_ids
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.ops import intersect_grid as ig
from pathtracer_tpu_torch.scene import builder

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
KERNELS = {
    # name: (CUDA source, the TPU kernel it replaces)
    "cluster_hit": ("pathtracer_tpu_torch/ops/csrc/intersect_cluster.cu",
                    "pathtracer_tpu/ops/intersect_cluster.py:211"),
    "pair_hit": ("pathtracer_tpu_torch/ops/csrc/intersect_pair.cu",
                 "pathtracer_tpu/ops/intersect_grid.py:279"),
}
CHECK_PIXELS = 256 * 1024  # rays per query in the kernel-vs-plain phases
T_RTOL, T_ATOL = 4e-3, 2e-4  # the reference's cluster-vs-brute t bar
MAT_AGREE = 0.999
GRID_BAR = 2e-3  # the reference's grid-vs-jnp render bar: |d| <= a + a|ref|
GRID_BAD_PIXELS = 0.002  # ... on all but this share of pixels


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
    """nvcc for each kernel source and g++ for the native BVH builder, all
    started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(_build.load, "intersect_cluster"),
                pool.submit(_build.load, "intersect_pair"),
                pool.submit(native.load)]
        for job in jobs:
            job.result()
    print(f"[build] all sources: {time.perf_counter() - t0:.2f} s wall")
    for name in ("intersect_cluster", "intersect_pair"):
        rec = _build.BUILDS[name]
        print(f"[build] {name}.cu: nvcc {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] ptxas: {line.strip()}")
    print(f"[build] native/bvh_builder.cpp: g++ "
          f"{native.BUILD['seconds']:.2f} s")


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


def compare_hits(name, t_k, s_k, t_p, s_p, slot_nm) -> float:
    """Kernel vs plain results: equal hit masks, t within the bar, materials
    agreeing; returns the max abs t error over hits."""
    hit_k, hit_p = s_k >= 0, s_p >= 0
    check(torch.equal(hit_k, hit_p), f"{name}: hit masks differ in "
          f"{int((hit_k != hit_p).sum())} entries")
    torch.testing.assert_close(t_k[hit_k], t_p[hit_p], rtol=T_RTOL,
                               atol=T_ATOL)
    if not hit_k.any():
        return 0.0
    mat_k = slot_nm[s_k[hit_k].long(), 3]
    mat_p = slot_nm[s_p[hit_p].long(), 3]
    agree = (mat_k == mat_p).float().mean().item()
    check(agree >= MAT_AGREE, f"{name}: material agreement {agree}")
    return (t_k[hit_k] - t_p[hit_p]).abs().max().item()


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
        err = compare_hits(name, t_k, s_k, t_p, s_p, slot_nm)
        ms = cuda_ms(lambda: ic.cluster_hit(cand, count, tnear, rayf, feat),
                     20)
        plain_ms = cuda_ms(
            lambda: ic.cluster_hit_plain(cand, count, tnear, rayf, feat), 3)
        print(f"[kernel] cluster_hit {name} query: {rayf.shape[1]} rays in "
              f"{cand.shape[0]} blocks, {int((s_k >= 0).sum())} hits, "
              f"visits/block kernel {v_k.float().mean().item():.2f} plain "
              f"{v_p.float().mean().item():.2f}; hit masks equal, t max abs "
              f"err {err:.3g}, t bit-equal {bool(torch.equal(t_k, t_p))}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def record_pair_queries(scene, cfg, pixel_ids):
    """The pair-kernel inputs of stage A (the first pair phase) of the main
    path's bounce-0 closest-hit and NEE shadow queries: (offsets, cand,
    pair_ray, rayf, pair_block), rayf as it was at the call."""
    calls, firsts = [], []
    real_hit, real_grid = ig.pair_hit, ig.closest_hit_grid

    def recording_grid(*args, **kw):
        firsts.append(len(calls))
        return real_grid(*args, **kw)

    def recording_hit(offsets, cand, pair_ray, rayf, feat, pair_block):
        calls.append((offsets, cand, pair_ray, rayf.clone(), pair_block))
        return real_hit(offsets, cand, pair_ray, rayf, feat, pair_block)

    ig.pair_hit, ig.closest_hit_grid = recording_hit, recording_grid
    try:
        wavefront.trace_sample(scene.geometry, scene.materials, scene.camera,
                               scene.lights, cfg.replace(max_depth=1),
                               pixel_ids, 0)
    finally:
        ig.pair_hit, ig.closest_hit_grid = real_hit, real_grid
    return [calls[i] for i in firsts]


def phase_pair_vs_plain(scene, cfg, device) -> dict:
    feat = scene.geometry.cl_feat
    slot_nm = scene.geometry.cl_slot_nm
    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                          device=device)[:CHECK_PIXELS]
    queries = record_pair_queries(scene, cfg, ids)
    check(len(queries) == 2, f"bounce 0 made {len(queries)} grid queries, "
          "expected 2 (closest hit + shadow)")
    out = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for name, (offsets, cand, pair_ray, rayf, pb) in zip(
            ("closest", "shadow"), queries):
        args = (offsets, cand, pair_ray, rayf, feat, pb)
        n0 = ig.LAUNCHES
        t_k, s_k, v_k = ig.pair_hit(*args)
        torch.cuda.synchronize()
        check(ig.LAUNCHES == n0 + 1, "pair_hit launched the kernel")
        t_p, s_p, v_p = ig.pair_hit_plain(*args)
        err = compare_hits(name, t_k, s_k, t_p, s_p, slot_nm)
        check(torch.equal(v_k, v_p), f"{name}: visits per block differ")
        ms = cuda_ms(lambda: ig.pair_hit(*args), 10)
        plain_ms = cuda_ms(lambda: ig.pair_hit_plain(*args), 1)
        print(f"[kernel] pair_hit {name} query, stage A: "
              f"{rayf.shape[1]} rays, {pair_ray.shape[0]} pairs in "
              f"{v_k.shape[0]} blocks of {pb}, {int((s_k >= 0).sum())} "
              f"hits, visits/block mean {v_k.float().mean().item():.2f} "
              f"max {int(v_k.max())}; hit masks equal, t max abs err "
              f"{err:.3g}, t bit-equal {bool(torch.equal(t_k, t_p))}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def check_golden(name, img, rtol, atol) -> float:
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    check(np.isfinite(img).all(), f"{name}: finite image")
    bad_px = (~np.isclose(img, golden, rtol=rtol, atol=atol)).any(-1).mean()
    print(f"[golden] {name}: max abs diff {np.abs(img - golden).max():.3g}, "
          f"pixels outside rtol={rtol} atol={atol}: {bad_px:.3g}")
    return bad_px


def phase_goldens(device) -> None:
    """The golden scenes through the cluster route (the reference's
    cluster-vs-jnp and engine-vs-oracle bars) and through the grid route at
    axis 8 (the reference's grid-vs-jnp bar)."""
    mesh = builder.procedural_bunny(2)
    c3 = RenderConfig(width=32, height=32, spp=4, max_depth=4, rr_start=2,
                      scene="cornell_mesh", use_bvh=True, backend="cluster",
                      compact=True)
    c2 = RenderConfig(width=48, height=48, spp=2, max_depth=1,
                      scene="cornell_mesh", use_bvh=True, backend="grid")
    cases = [
        # (name, scene, cfg, rtol, atol, share of pixels allowed outside)
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh), c3, 2e-3, 2e-3,
         1e-4),
        ("config1_64", builder.cornell_spheres(),
         RenderConfig(width=64, height=64, spp=4, max_depth=1,
                      scene="cornell_spheres", use_bvh=False), 1e-3, 5e-4,
         1e-4),
        ("config3_32", builder.cornell_mesh(mesh_tris=mesh),
         c3.replace(backend="grid", compact=False), GRID_BAR, GRID_BAR,
         GRID_BAD_PIXELS),
        ("config2_48", builder.cornell_mesh(mesh_tris=mesh), c2, GRID_BAR,
         GRID_BAR, GRID_BAD_PIXELS),
    ]
    for name, scene, cfg, rtol, atol, allowed in cases:
        if cfg.use_bvh:
            scene = with_bvh(scene)
        scene = prepare_accel(scene, cfg, grid_axis=8).to(device)
        n1, n2 = ic.LAUNCHES, ig.LAUNCHES
        img = pt.render(scene, cfg).cpu().numpy()
        print(f"[golden] {name} backend={cfg.backend}: "
              f"{ic.LAUNCHES - n1} cluster_hit and {ig.LAUNCHES - n2} "
              "pair_hit launches")
        bad_px = check_golden(name, img, rtol, atol)
        check(bad_px <= allowed, f"{name}: {bad_px} of pixels outside the "
              "bar")


def phase_main_path(device, card: str) -> int:
    cfg = pt.PRESETS["bench"]
    t0 = time.perf_counter()
    scene = bench_scene(cfg, device)
    print(f"[main] bench scene: {scene.geometry.tri_v0.shape[0]} triangles, "
          f"{scene.geometry.cl_lo.shape[0]} clusters, host build "
          f"{time.perf_counter() - t0:.2f} s")
    ic.LAUNCHES = 0
    ig.LAUNCHES = 0
    img = pt.render(scene, cfg)
    torch.cuda.synchronize()
    launches, pair_launches = ic.LAUNCHES, ig.LAUNCHES
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), "image shape")
    check(bool(torch.isfinite(img).all()), "finite image")
    check(bool((img >= 0).all()), "non-negative image")
    mean = img.mean().item()
    check(mean > 0.0, "image mean above 0")
    check(launches == 2 * cfg.max_depth,
          f"{launches} kernel launches, expected {2 * cfg.max_depth}")
    check(pair_launches == 0, f"bench launched pair_hit {pair_launches} "
          "times")
    print(f"[main] render(bench) {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth}: mean {mean:.6f}, {launches} cluster_hit "
          "launches, 0 pair_hit launches")

    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    args = (scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
            ids, 0)
    time_frames("bench", args, 5, card)
    return launches


def time_frames(name, args, n_frames, card) -> None:
    """Median useful rays/s of n_frames trace_sample(with_stats=True) runs
    after one warm-up, each bracketed by synchronize(); peak memory."""
    wavefront.trace_sample(*args, with_stats=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, secs = [], []
    for _ in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n = wavefront.trace_sample(*args, with_stats=True)
        n = int(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        secs.append(dt)
        rates.append(n / dt)
    print(f"[main] trace_sample({name}, tiled, with_stats): {n} useful "
          f"rays, frame s {[round(x, 6) for x in secs]}, median "
          f"{statistics.median(rates):.1f} useful rays/s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"on {card}")


def config5_scene(cfg, device):
    """build_scene -> with_bvh -> prepare_accel -> the card, timed."""
    t = [time.perf_counter()]
    scene = builder.build_scene(cfg.scene)
    t.append(time.perf_counter())
    scene = with_bvh(scene)
    t.append(time.perf_counter())
    scene = prepare_accel(scene, cfg)
    t.append(time.perf_counter())
    scene = scene.to(device)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    g = scene.geometry
    cs = g.gr_cell_start
    n_clusters = int(cs[-1])
    print(f"[main] config5 scene: {g.tri_v0.shape[0]} triangles, grid axis "
          f"{ig.grid_axis(g)}, {n_clusters} clusters, "
          f"{(cs[1:] > cs[:-1]).float().mean().item():.4f} of cells "
          f"occupied, max {int((cs[1:] - cs[:-1]).max())} clusters per "
          f"cell, feature table {g.cl_feat.numel() * 4 / 1e6:.1f} MB on the "
          f"card; host build s: big_mesh {t[1] - t[0]:.2f}, native BVH "
          f"{t[2] - t[1]:.2f}, grid tables {t[3] - t[2]:.2f}, to card "
          f"{t[4] - t[3]:.2f}")
    return scene


def grid_stats_frame(args):
    """One trace_sample with every grid query's stats recorded."""
    infos = []
    real = ig.closest_hit_grid

    def recording(g, o, d, **kw):
        t, n, m, info = real(g, o, d, stats=True, **kw)
        infos.append((o.shape[0], kw.get("first_steps"), info))
        return t, n, m

    ig.closest_hit_grid = recording
    try:
        wavefront.trace_sample(*args, with_stats=True)
    finally:
        ig.closest_hit_grid = real
    return infos


def phase_config5(scene, device, card: str) -> int:
    cfg = pt.PRESETS["config5"]
    ic.LAUNCHES = 0
    ig.LAUNCHES = 0
    t0 = time.perf_counter()
    img = pt.render(scene, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, cluster_launches = ig.LAUNCHES, ic.LAUNCHES
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), "image shape")
    check(bool(torch.isfinite(img).all()), "finite image")
    check(bool((img >= 0).all()), "non-negative image")
    mean = img.mean().item()
    check(mean > 0.0, "image mean above 0")
    check(launches > 0, "config5 never launched pair_hit")
    check(cluster_launches == 0, f"config5 launched cluster_hit "
          f"{cluster_launches} times")
    print(f"[main] render(config5) {cfg.width}x{cfg.height} depth "
          f"{cfg.max_depth}: mean {mean:.6f}, {launches} pair_hit launches, "
          f"0 cluster_hit launches, {seconds:.3f} s (first frame)")

    ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width, device=device)
    args = (scene.geometry, scene.materials, scene.camera, scene.lights, cfg,
            ids, 0)
    for i, (n_rays, first, info) in enumerate(grid_stats_frame(args)):
        print(f"[main] config5 query {i} (bounce {i // 2}, "
              f"{('closest', 'shadow')[i % 2]}, first_steps {first}): "
              f"{n_rays} rays, {info['live_after_phase0']} live entering "
              f"the eras, {info['eras']} eras of <= {info['era_rays']} rays, "
              f"{info['visits']} pair-kernel visits")
    time_frames("config5", args, 3, card)
    return launches


def kernel_entry(name, launches, k) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"]}


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
        k1_launches = phase_main_path(device, card)
        scene = config5_scene(pt.PRESETS["config5"], device)
        k2 = phase_pair_vs_plain(scene, pt.PRESETS["config5"], device)
        k2_launches = phase_config5(scene, device, card)
    print(json.dumps({"kernels": [
        kernel_entry("cluster_hit", k1_launches, k1),
        kernel_entry("pair_hit", k2_launches, k2),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
