"""Sharded scaling benchmark: useful rays/s per GPU of whole sharded frames
(the reference's ``scripts/scaling_pod.py`` with ``scaling_cpu.py``
folded in).

    # one process per GPU of this host (torchrun sets rank and world):
    torchrun --standalone --nproc_per_node N \\
        -m pathtracer_tpu_torch.parallel.scaling --scene big_mesh --grad \\
        --single-chip-ref R

    # explicit process-group flags, one command per process:
    python -m pathtracer_tpu_torch.parallel.scaling \\
        --coordinator host0:29500 --num-processes 2 --process-id $ID ...

    # smoke mode without a card: N gloo ranks on the CPU, one host
    python -m pathtracer_tpu_torch.parallel.scaling --cpu-ranks 2 \\
        --scene cornell_spheres --width 32 --height 32 --depth 2 --budget 2

The image's pixels are sharded over every rank (parallel/mesh.py), with the
scene replicated; with ``--grad`` each frame is a sharded train step
(forward, backward, all-reduce, Adam update). Timing as ``bench_torch.py``:
one untimed warm-up frame, then frames timed one by one until ``--budget``
seconds have passed and at least MIN_FRAMES were timed; the ranks agree
after each frame whether to go on. The rays of a frame are its useful
rays (live path segments + candidate shadow rays) over every spp sample
of every rank's real pixels, counted once with the engine's counter.

Rank 0 prints one JSON line, the last line of standard output:
    {"metric": ..., "value": N, "unit": "rays/s", "scaling_eff": x}
``value`` is rays/s per rank; ``scaling_eff`` is value over
``--single-chip-ref`` (the single-GPU rays/s of the same frame), else
null. Each run but smoke mode appends a row to ``bench_metrics_torch.jsonl``
at the repository root, with the card's name. Ranks that share one card
measure the overhead of sharding, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..accel.auto import prepare_accel
from ..accel.build import with_bvh
from ..config import PRESETS
from ..engine.wavefront import trace_sample
from ..scene.builder import build_scene
from ..utils.logging import log, log_json
from ..utils.profiling import device_barrier
from . import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS_PATH = os.path.join(ROOT, "bench_metrics_torch.jsonl")
MIN_FRAMES = 5
MAX_FRAMES = 10_000
SMOKE_TIMEOUT_S = 600.0  # smoke mode: set-up and warm-up, beyond --budget


def _rank_main(fn, rank, n_ranks, backend, init, timeout, results, args):
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group(backend, init_method=init,
                                world_size=n_ranks, rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            value = fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, value))


def spawn_ranks(fn, n_ranks: int, args=(), backend: str = "gloo",
                timeout: float = 120.0) -> list:
    """Run fn(rank, *args) in n_ranks new processes of one host, joined in
    one process group (a ``file://`` rendezvous in a fresh temporary
    directory; LOCAL_RANK is the rank); returns their values in rank
    order.

    fn must be importable by name and return a picklable value holding no
    tensors (numpy arrays, numbers, strings). Raises with the rank's
    traceback when a rank fails, and when the ranks have not all returned
    within `timeout` seconds; every rank still running then is killed.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, n_ranks, backend, init, timeout,
                                   results, args))
                 for rank in range(n_ranks)]
        try:
            for p in procs:
                p.start()
            values = {}
            while len(values) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{n_ranks - len(values)} of {n_ranks} ranks did "
                        f"not finish within {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in values and p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"ranks {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n"
                                       f"{value}")
                values[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [values[r] for r in range(n_ranks)]


def frame_rays(scene, cfg, mesh) -> int:
    """Useful rays of one frame: every spp sample of every rank's real
    (not padding) pixels, summed over the mesh."""
    ids, _ = pmesh._padded_ids(cfg, mesh.size)
    per = ids.shape[0] // mesh.size
    mine = ids[mesh.rank * per:min((mesh.rank + 1) * per, cfg.n_pixels)]
    g, mats, cam, lights = (scene.geometry, scene.materials, scene.camera,
                            scene.lights)
    with torch.inference_mode():
        n = torch.zeros((), dtype=torch.int64, device=mesh.device)
        for s in range(cfg.spp):
            _, k = trace_sample(g, mats, cam, lights, cfg,
                                mine.to(mesh.device), s, with_stats=True)
            n = n + k
    return int(mesh.all_reduce(n.clone()))


def time_frames(run_once, budget: float, mesh) -> list:
    """Seconds of frames timed one by one until `budget` seconds have
    passed and at least MIN_FRAMES were timed; the ranks stop together."""
    samples = []
    deadline = time.perf_counter() + budget
    while True:
        t0 = time.perf_counter()
        run_once()
        samples.append(time.perf_counter() - t0)
        done = (len(samples) >= MAX_FRAMES
                or (len(samples) >= MIN_FRAMES
                    and time.perf_counter() >= deadline))
        flag = torch.tensor([float(done)], device=mesh.device)
        if mesh.all_reduce(flag).item() > 0:
            return samples


def run(args, device, smoke: bool) -> str | None:
    """The benchmark on this rank; rank 0 returns the JSON line."""
    mesh = pmesh.make_mesh(device=device)
    cfg = PRESETS["bench"].replace(scene=args.scene, width=args.width,
                                   height=args.height, max_depth=args.depth)
    if args.backend:
        cfg = cfg.replace(backend=args.backend)
    t0 = time.perf_counter()
    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    scene = prepare_accel(scene, cfg).to(mesh.device)
    build_s = time.perf_counter() - t0

    if args.grad:
        target = torch.zeros((cfg.height, cfg.width, 3))
        step = pmesh.make_train_step(scene, cfg, target, mesh)
        mats = scene.materials

        def run_once():
            nonlocal mats
            loss, mats = step(mats)
            device_barrier(loss)
    else:
        def run_once():
            device_barrier(pmesh.render_sharded(scene, cfg, mesh))

    t0 = time.perf_counter()
    run_once()
    kind = (torch.cuda.get_device_name(mesh.device)
            if mesh.device.type == "cuda" else "cpu")
    log("scaling warmed up", secs=round(time.perf_counter() - t0, 3),
        build_secs=round(build_s, 3), ranks=mesh.size, scene=cfg.scene,
        backend=cfg.backend, grad=args.grad, device=kind)
    samples = time_frames(run_once, args.budget, mesh)
    rays = frame_rays(scene, cfg, mesh)
    secs = sum(samples)
    per_rank = rays * len(samples) / max(secs, 1e-12) / mesh.size
    eff = per_rank / args.single_chip_ref if args.single_chip_ref else None
    log("scaling measured", frames=len(samples), secs=round(secs, 3),
        rays_per_frame=rays,
        frame_secs_median=round(sorted(samples)[len(samples) // 2], 6))
    config = (f"{cfg.scene} {cfg.width}x{cfg.height} {cfg.spp}spp "
              f"depth{cfg.max_depth} backend={cfg.backend} "
              f"sharded={mesh.size}ranks"
              + (" grad=train-step" if args.grad else ""))
    if smoke:
        log("scaling smoke mode: metrics row suppressed")
    else:
        log_json(METRICS_PATH, config=config, chips=mesh.size,
                 rays_per_s_per_chip=round(per_rank, 1),
                 scaling_eff=round(eff, 4) if eff is not None else None,
                 device=kind, frames=len(samples), secs=round(secs, 3),
                 rays_per_frame=rays)
    if mesh.rank != 0:
        return None
    return json.dumps({
        "metric": f"rays/s/gpu sharded ({config} on {kind})",
        "value": round(per_rank, 1),
        "unit": "rays/s",
        "scaling_eff": round(eff, 4) if eff is not None else None,
    })


def _smoke_rank(rank, args):
    torch.set_num_threads(1)
    return run(args, "cpu", smoke=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pathtracer_tpu_torch.parallel.scaling")
    ap.add_argument("--scene", default="big_mesh")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--backend", default=None,
                    choices=["jnp", "pallas", "cluster", "stream", "grid"],
                    help="default: the bench preset's (auto-routed)")
    ap.add_argument("--budget", type=float, default=60.0)
    ap.add_argument("--grad", action="store_true",
                    help="time sharded train steps (forward, backward, "
                    "all-reduce, Adam update) instead of forward renders")
    ap.add_argument("--single-chip-ref", type=float, default=None,
                    help="single-GPU rays/s to compute scaling_eff against")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (with --num-processes)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cpu-ranks", type=int, default=0,
                    help="smoke mode: N gloo ranks on the CPU of this host; "
                    "writes no metrics row")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card of each rank's "
                    "LOCAL_RANK)")
    args = ap.parse_args(argv)

    if args.cpu_ranks:
        lines = spawn_ranks(_smoke_rank, args.cpu_ranks, args=(args,),
                            timeout=args.budget + SMOKE_TIMEOUT_S)
        print(lines[0])
        return 0
    cpu = torch.device(args.device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device; pass --device "
                 "cpu or --cpu-ranks N to run on the CPU")
    pmesh.initialize_distributed(args.coordinator, args.num_processes,
                                 args.process_id,
                                 backend="gloo" if cpu else None)
    line = run(args, args.device, smoke=False)
    if line is not None:
        print(line)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
