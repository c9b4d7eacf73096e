"""The benchmark of pathtracer_tpu_torch on NVIDIA GPUs.

    python3 ptbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

Runs one cell of BENCHMARK.json (ptbench/workloads/<cell>.json on
ptbench/configs/<config>.json) from the root of a checkout and prints one
JSON line, the last line of standard output: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last the numbers compared
with their limits (checks), which also end standard error.

A run: set-up (the program's scene build and upload, the mode's own
set-up, one untimed warm frame), then frames or steps back to back for
--seconds (--trace 0), or `trace_frames` of them under the profiler with
spans around the program's layers (--trace 1); the device's peak memory;
then the program's state is freed and the reference checks what the timed
path produced. Standard error also says where each rank may run and the
collector's passes in its window (ptbench/host.py). A cell on more than
one card starts one process per card (this process is rank 0). Without as
many CUDA devices as the cell asks for, it exits with an error and prints
no result; so it does if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root in place of this script's directory, whose module
# names (trace, stats, ...) would shadow others.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from ptbench import faults, harness, host  # noqa: E402

harness.set_cache_dirs()

import torch  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="ptbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by rank 0 for the ranks it starts.
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    # Breaks the timed path on purpose (ptbench/faults.py), for the tests
    # and the limits' readings; never set by a benchmark run.
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    # A test's CPU ranks (never rank 0, which prints the result): the
    # device and the shrunk cell of rank 0.
    ap.add_argument("--device", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--overrides", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, device=None, overrides=None) -> int:
    """One run. `device` and `overrides` (tests only) skip the look for
    cards and run there, on a cell shrunk by harness.Run's overrides."""
    args = parse(argv)
    if args.device is not None:
        if args.rank == 0:
            harness.log("--device is for the ranks a test's rank 0 starts")
            return 2
        device = torch.device(args.device)
        overrides = json.loads(args.overrides)
        torch.set_num_threads(2)
    run = harness.Run(args.workload, args.seed, args.seconds, args.trace,
                      T_START if argv is None else time.perf_counter(),
                      overrides=overrides)
    chips = int(run.config["chips"])
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                        f"this machine has {have}")
            return 2
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    run.device = device
    run.rank = args.rank
    harness.log(f"{args.workload} rank {args.rank}: {host.placement()}")
    mode = harness.load_module("modes", run.cell["mode"])
    with faults.planted(args.fault):
        out = mode.main(run, args)
    if out is None:  # a rank other than 0
        return 0
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
