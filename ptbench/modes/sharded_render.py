"""Sharded frames over several cards: `parallel/mesh.py:render_sharded`.

Rank 0 (the process the benchmark starts) starts one process per further
card, all joined in one process group (NCCL; a `file://` rendezvous under
the run's TMPDIR). Every rank holds the whole scene and traces a
contiguous quarter of the row-major pixel ids; the (H, W, 3) image is
all-gathered on every rank every frame. Frame i renders sample 0 under the
sampler seed (seed + i) mod 2^31, so every frame is a new image; it ends
in a device barrier on each rank, and rank 0 tells the others after each
frame whether the window goes on. Useful rays are every rank's, counted by
the engine. The traced run profiles each rank and reports the rank with
the most busy time. The check holds `check_pixels` pixels drawn from the
seed of the gathered image, in the first frame, one drawn from the first
`check_within` and the last, to the reference's render, on rank 0 once the
ranks have parted.

Params: check_pixels, check_within, trace_frames, pixel_atol, pixel_rtol,
ref_block.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.parallel import mesh as pmesh

from .. import check, flow, harness, program, trace
from ..flow import sync

RANK_TIMEOUT_S = 300


class Mode:
    def __init__(self, run):
        self.plan(run)
        self.scene, run.scene_build_s = program.build(
            program.render_config(run.config, 0), self.dev,
            lambda: sync(self.dev))
        self.mesh = pmesh.make_mesh(device=self.dev)
        self.counter = program.RayCounter(wavefront, "trace_sample", self.dev)

    def plan(self, run) -> None:
        """What the mode needs besides the program's state."""
        self.run = run
        self.dev = torch.device(run.device)
        self.n = program.render_config(run.config, 0).n_pixels

    def start(self, seed: int) -> None:
        p = self.run.params
        self.seed = seed % (2 ** 31)
        g = torch.Generator().manual_seed(seed)
        self.rows = torch.randperm(self.n, generator=g)[
            :p["check_pixels"]].to(self.dev)
        mid = 2 + int(torch.randint(max(1, p["check_within"] - 1), (1,),
                                    generator=g))
        self.check_at = {1, mid}
        self.kept = {}
        self.last = None

    def frame_seed(self, i: int) -> int:
        return (self.seed + i) % (2 ** 31)

    def frame(self, i: int) -> int:
        cfg = program.render_config(self.run.config, self.frame_seed(i))
        img = pmesh.render_sharded(self.scene, cfg, self.mesh)
        if self.mesh.rank == 0:
            rows = img.reshape(-1, 3)[self.rows]
            if i in self.check_at:
                self.kept[i] = rows
            self.last = (i, rows)
        sync(self.dev)
        return 0

    def outputs(self) -> dict:
        out = dict(self.kept)
        out[self.last[0]] = self.last[1]
        return out

    def free(self) -> None:
        self.counter.close()
        self.scene = self.last = None

    def numbers(self, outputs: dict, ref) -> dict:
        p = self.run.params
        ids = self.rows.to(ref.device)
        prog = torch.cat([outputs[i].to(ref.device) for i in sorted(outputs)])
        want = torch.cat([ref.pixels(self.frame_seed(i), 0, ids,
                                     p["ref_block"])
                          for i in sorted(outputs)])
        return {"bad_px_share": check.bad_share(
            prog.float(), want, p["pixel_atol"], p["pixel_rtol"])}

    def control(self, ref, low) -> dict:
        p = self.run.params
        ids = self.rows.to(ref.device)
        got = {i: low.pixels(self.frame_seed(i), 0, ids, p["ref_block"])
               for i in sorted(self.check_at | {p["check_within"] + 1})}
        return self.numbers(got, ref)


def window(run, mode) -> None:
    """The timed window, on rank 0's clock: after each frame rank 0 tells
    the others whether it goes on."""
    go = torch.ones(1, dtype=torch.int32, device=mode.dev)

    def go_on(more: bool) -> bool:
        go.fill_(int(more))
        dist.broadcast(go, 0)
        return bool(int(go))

    harness.window(run, lambda i: mode.frame(i + 1), go_on)


def spawn(script, argv: list, world: int) -> list:
    """Ranks 1 .. world - 1: `script` with `argv` and --rank, in the
    checkout; they print no result (their logs go to standard error)."""
    return [subprocess.Popen([sys.executable, script, *argv, "--rank",
                              str(r)], cwd=harness.ROOT,
                             stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def join(rank: int, world: int, rendezvous: str, dev) -> None:
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{rendezvous}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


def main(run, args):
    world = int(run.config["chips"])
    dev = torch.device(run.device)
    procs = []
    rendezvous = args.rendezvous
    if run.rank == 0:
        rendezvous = os.path.join(tempfile.gettempdir(),
                                  f"ptbench-rendezvous-{os.getpid()}")
        argv = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--rendezvous", rendezvous]
        if args.fault:
            argv += ["--fault", args.fault]
        if dev.type == "cpu":
            argv += ["--device", "cpu", "--overrides",
                     json.dumps(run.overrides)]
        procs = spawn(os.path.join(harness.HERE, "run.py"), argv, world)
    try:
        join(run.rank, world, rendezvous, dev)
        return _ranked(run, dev, world)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            try:
                p.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if run.rank == 0 and os.path.exists(rendezvous):
            os.unlink(rendezvous)


def _ranked(run, dev, world):
    entries = harness.cell_metrics(harness.benchmark(), run.name, run.trace)
    mods = [harness.load_module("metrics", m["name"]) for m in entries]
    mode = flow.set_up(run, Mode)
    mode.counter.take()
    dist.barrier()
    if run.rank == 0:
        run.setup_s = time.perf_counter() - run.t_start
    flow.measure(run, mode, mods, timed=lambda: window(run, mode))
    rays = mode.counter.count.clone()
    dist.all_reduce(rays)
    run.rays = int(rays)
    if run.rank == 0 and not run.trace:
        harness.log_steps(run)
    mine = {"peak": flow.peak_memory(dev),
            "summary": run.summary.data if run.summary else None}
    every = [None] * world
    dist.all_gather_object(every, mine)
    if run.rank != 0:
        return None
    run.memory_peak_bytes = max(r["peak"] for r in every)
    if run.trace:
        busiest = max(every, key=lambda r: r["summary"]["busy_s"])
        data = dict(busiest["summary"])
        data["busy_s_mean"] = sum(r["summary"]["busy_s"]
                                  for r in every) / world
        run.summary = trace.Summary(data)
    harness.log(f"{run.name} {run.attempted} frames, {run.rays} rays, "
                f"peak {run.memory_peak_bytes} bytes on the fullest card")
    outputs = mode.outputs()
    dist.destroy_process_group()
    flow.free(mode)
    flow.judge(run, mode, outputs)
    metrics = harness.metric_values(run, entries)
    return harness.result(run, metrics, flow.device_kind(dev), world)
