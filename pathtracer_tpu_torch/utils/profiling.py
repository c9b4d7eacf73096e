"""Tracing and timing helpers (the reference's ``utils/profiling.py``).

  * `trace(dir)` — context manager around `torch.profiler` (CPU and, where
    there is a card, CUDA activity) that writes a Chrome trace into `dir`;
  * `device_barrier(x)` — waits for the device that holds `x`, then
    fetches one element to the host: PyTorch returns before the card has
    finished, so timing code ends every timed region with it;
  * `Timer` — wall-clock timer using the barrier;
  * `device_kernel_times(fn, reps)` — each device kernel's device time and
    launches over reps profiled runs of fn;
  * `card_line()` — the card's name and power limit as nvidia-smi gives
    them, written beside every number measured on the card;
  * `span(name, args=None)` — a context manager that names a stretch of
    the port's host code ``pt.<name>`` on the profiler's timeline, so the
    device operations launched inside it and the device's idle time while
    it is open can be read from the trace. Only a running profiler
    (`torch.profiler.profile`, `trace`, `device_kernel_times`) records
    it: a profiler is the switch. With none running, `span` checks that
    and returns a shared no-op context, with no record, clock read, string
    formatting, allocation or device work. `args` (a str, a number or a
    dict) tells spans of one name apart; the profiler's trace keeps no
    record's arguments, so they go into the recorded name:
    ``pt.<name>[<args>]``, a dict as ``key=value`` pairs joined by commas;
  * `host_read(where)` — ``span("read", where)``, placed around a
    statement that already blocks on the device (a `nonzero`, an `int()`
    of a device tensor): it names the read and never adds one.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np
import torch


def device_barrier(x) -> float:
    """Force completion of everything `x` depends on; returns one scalar."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.detach().reshape(-1)[0].item())
    return float(np.asarray(x).reshape(-1)[0])


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region; yields the profiler, writes
    ``<host>_<pid>.<time>.pt.trace.json`` into log_dir at exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


class Timer:
    """with Timer() as t: ... t.barrier(result); print(t.seconds)"""

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.seconds = None
        return self

    def barrier(self, x):
        device_barrier(x)
        self.seconds = time.perf_counter() - self.t0
        return self.seconds

    def __exit__(self, *exc):
        if self.seconds is None:
            self.seconds = time.perf_counter() - self.t0
        return False


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12)


def device_kernel_times(fn, reps: int = 1) -> dict:
    """Runs fn() reps times under torch.profiler (CPU and CUDA activity,
    then a synchronise) and returns {kernel name: [device ms, launches]}
    summed over the runs; empty where no device kernel ran."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot = out.setdefault(e.name, [0.0, 0])
            tot[0] += e.device_time_total / 1e3
            tot[1] += 1
    return out


_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """``pt.<name>`` (``pt.<name>[<args>]``) while a profiler records;
    otherwise a shared no-op context (module docstring)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    if args is not None:
        if isinstance(args, dict):
            args = ",".join(f"{k}={v}" for k, v in args.items())
        name = f"{name}[{args}]"
    return torch.profiler.record_function("pt." + name)


def host_read(where: str):
    """The span ``pt.read[<where>]`` around a statement that already waits
    for the device; it adds no read or synchronisation of its own."""
    return span("read", where)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
