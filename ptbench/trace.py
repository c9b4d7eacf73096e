"""Spans around the program's layers, the profiler over a traced window,
and the reduction of its trace to device time per span.

Spans are opened from the benchmark's own code: each `spans/<name>.json`
names functions of the program ({"targets": [[module, attribute], ...]},
a dotted attribute for a method) that are wrapped, for the traced window
only, in `torch.profiler.record_function("ptb.<name>")` where the program
looks them up. A device operation belongs to every span that was open on the host
when it was launched: its launch is found through the profiler's
correlation id. Busy time is the union of the device operations'
intervals inside the window; the idle gaps between them are named by the
innermost span open on the host at the middle of each gap.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import tempfile
import time

import torch

from .harness import HERE

PREFIX = "ptb."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # of a device operation's name in the breakdown


def span_specs() -> dict:
    out = {}
    for path in sorted((HERE / "spans").glob("*.json")):
        with open(path) as f:
            out[path.stem] = json.load(f)
    return out


def _resolve(module, dotted):
    owner = importlib.import_module(module)
    *path, attr = dotted.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, attr


@contextlib.contextmanager
def spans():
    """Every span of spans/*.json wrapped for the duration."""
    undo = []
    try:
        for name, spec in span_specs().items():
            for module, dotted in spec["targets"]:
                owner, attr = _resolve(module, dotted)
                fn = getattr(owner, attr)

                def wrapped(*a, _fn=fn, _name=PREFIX + name, **k):
                    with torch.profiler.record_function(_name):
                        return _fn(*a, **k)

                functools.update_wrapper(wrapped, fn)
                setattr(owner, attr, wrapped)
                undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


def capture(frames, n_frames: int, sync) -> "Summary":
    """Profiles frames() (n_frames frames or steps) with the spans on; the
    window ends in sync()."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with spans(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            t0 = time.perf_counter()
            frames()
            sync()
            window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="ptbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Summary.from_events(events, window_s, n_frames)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _stacks_at(points, spans_):
    """For each host time in `points` (sorted), the names of the spans open
    there, outermost first. Spans of one thread nest."""
    bounds = []
    for i, (s, e, _) in enumerate(spans_):
        bounds.append((s, 0, i))
        bounds.append((e, 2, i))
    bounds += [(t, 1, j) for j, t in enumerate(points)]
    bounds.sort()
    open_, out = [], [()] * len(points)
    for _, kind, i in bounds:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        else:
            out[i] = tuple(spans_[k][2] for k in open_)
    return out


class Summary:
    """Device time of a traced window, per span stack and per operation."""

    def __init__(self, data: dict):
        self.data = data

    @classmethod
    def from_events(cls, events, window_s, n_frames):
        launch_ts, ops, spans_ = {}, [], []
        win = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            args = ev.get("args") or {}
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat in LAUNCH_CATS and "correlation" in args:
                launch_ts[args["correlation"]] = ts
            elif cat in DEVICE_CATS:
                ops.append((ev["name"], ts, ts + dur, args.get("correlation")))
            elif cat == "user_annotation" and \
                    str(ev["name"]).startswith(PREFIX):
                name = ev["name"][len(PREFIX):]
                if name == "window":
                    win = (ts, ts + dur)
                else:
                    spans_.append((ts, ts + dur, name))
        if win is None:
            raise RuntimeError("the trace holds no window span")
        ops = [o for o in ops if o[2] > win[0] and o[1] < win[1]]
        if not ops:
            raise RuntimeError("no device operation ran in the traced "
                               "window: the profiler saw no device activity")
        # Span stack of each operation at its launch.
        launched = [launch_ts.get(c) for _, _, _, c in ops]
        known = sorted((t, k) for k, t in enumerate(launched) if t is not None)
        stacks = [("(no launch record)",)] * len(ops)
        for (_, k), st in zip(known, _stacks_at([t for t, _ in known],
                                                spans_)):
            stacks[k] = st
        stack_ms, op_ms = {}, {}
        for (name, s, e, _), st in zip(ops, stacks):
            ms = (min(e, win[1]) - max(s, win[0])) / 1e3
            stack_ms[st] = stack_ms.get(st, 0.0) + ms
            op_ms[name] = op_ms.get(name, 0.0) + ms
        busy = _union([(max(s, win[0]), min(e, win[1]))
                       for _, s, e, _ in ops])
        gaps, edges = [], [win[0]]
        for s, e in busy:
            edges += [s, e]
        edges.append(win[1])
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        gap_names = _stacks_at(sorted((a + b) / 2 for a, b in gaps), spans_)
        gap_s = {}
        for (a, b), st in zip(sorted(gaps, key=lambda g: (g[0] + g[1]) / 2),
                              gap_names):
            key = st[-1] if st else "(outside spans)"
            gap_s[key] = gap_s.get(key, 0.0) + (b - a) / 1e6
        return cls({
            "window_s": window_s,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "n_frames": n_frames,
            "stack_ms": [[list(k), v] for k, v in stack_ms.items()],
            "op_ms": op_ms,
            "gap_s": gap_s,
            "unattributed_ops": sum(t is None for t in launched),
        })

    # Readers' queries, per frame (or step) of the window, in ms.
    def span_ms(self, name: str) -> float:
        return sum(ms for st, ms in self.data["stack_ms"] if name in st) \
            / self.data["n_frames"]

    def self_ms(self, name: str, exclude=()) -> float:
        return sum(ms for st, ms in self.data["stack_ms"]
                   if name in st and not set(exclude) & set(st)) \
            / self.data["n_frames"]

    def op_ms(self, match) -> float:
        """Device ms per frame of the operations whose name satisfies
        match(name)."""
        return sum(ms for op, ms in self.data["op_ms"].items()
                   if match(op)) / self.data["n_frames"]

    @property
    def busy_s(self) -> float:
        return self.data["busy_s"]

    @property
    def window_s(self) -> float:
        return self.data["window_s"]

    @property
    def busy_s_mean(self) -> float:
        return self.data.get("busy_s_mean", self.data["busy_s"])

    def breakdown(self) -> dict:
        ops = sorted(self.data["op_ms"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.data["gap_s"].items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], ms / 1e3] for n, ms in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
