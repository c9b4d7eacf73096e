"""Readings behind the limits of a cell's check, on the card.

    python3 ptbench/limits.py --workload <cell> --seeds 1,2,...
        [--frames N] [--faults answer,half_batch] [--fault-seeds a,b,c]
        [--control-seeds a,b,c] [--control-only]

In one process (one per card for a cell on several cards): the program's
set-up once, then for each seed the mode's start, frames 0..N and the
check's numbers against the reference (the sound readings); the same with
each named fault planted (ptbench/faults.py); and the control: the
reference in bfloat16 put in the program's place, over the samples a run
of that seed checks. Prints one JSON line per reading. A benchmark run
never runs this; PERF.md gives the readings each limit was set from.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

# The checkout's root in place of this script's directory, whose module
# names (trace, stats, ...) would shadow others.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from ptbench import harness  # noqa: E402

harness.set_cache_dirs()

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ptbench import check, faults, flow  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="ptbench/limits.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--frames", type=int, default=None,
                    help="frames after the warm frame (default: the "
                    "cell's check_within + 1)")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--control-only", action="store_true",
                    help="only the control: no program, one card (the "
                    "render modes, whose plan() needs no program)")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def emit(kind, seed, numbers, t0):
    print(json.dumps({"kind": kind, "seed": seed, **numbers,
                      "seconds": time.perf_counter() - t0}), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    run = harness.Run(args.workload, 0, 0.0, False, T_START)
    dev = torch.device("cuda", args.rank)
    torch.cuda.set_device(dev)
    run.device, run.rank = dev, args.rank
    Mode = harness.load_module("modes", run.cell["mode"]).Mode
    world = int(run.config["chips"])
    sharded = world > 1 and not args.control_only
    procs = []
    if sharded:
        from ptbench.modes import sharded_render

        rendezvous = args.rendezvous
        if args.rank == 0:
            rendezvous = os.path.join(tempfile.gettempdir(),
                                      f"ptbench-limits-{os.getpid()}")
            procs = sharded_render.spawn(
                __file__, (argv or sys.argv[1:]) + ["--rendezvous",
                                                    rendezvous], world)
        sharded_render.join(run.rank, world, rendezvous, dev)
    try:
        readings(run, Mode, args, sharded)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            p.wait()
    return 0


def readings(run, Mode, args, sharded) -> None:
    frames = args.frames
    if frames is None:
        frames = int(run.params.get("check_within", 0)) + 1
    low = None
    if args.control_only:
        if not hasattr(Mode, "plan"):
            raise SystemExit(f"ptbench/limits.py: --control-only needs a "
                             f"mode with plan(); {run.cell['mode']!r} has "
                             f"none")
        mode = Mode.__new__(Mode)
        mode.plan(run)
    else:
        mode = Mode(run)
    ref = check.Reference(run.config, run.device) if run.rank == 0 else None

    def one(kind, seed):
        t0 = time.perf_counter()
        mode.start(seed)
        for i in range(frames + 1):
            mode.frame(i)
        flow.sync(run.device)
        if ref is not None:
            emit(kind, seed, mode.numbers(mode.outputs(), ref), t0)
        if sharded:
            dist.barrier()

    if not args.control_only:
        for seed in args.seeds:
            one("program", seed)
        for name in filter(None, args.faults.split(",")):
            with faults.planted(name):
                for seed in args.fault_seeds:
                    one(name, seed)
    if ref is not None and args.control_seeds:
        low = check.Reference(run.config, run.device, torch.bfloat16)
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            mode.start(seed)
            emit("control_bf16", seed, mode.control(ref, low), t0)
    if ref is not None:
        harness.log(f"card: {flow.device_kind(run.device)}; "
                    f"peak {flow.peak_memory(run.device)} bytes")


if __name__ == "__main__":
    sys.exit(main())
