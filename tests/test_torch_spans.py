"""The port's program spans (utils/profiling.py: span, host_read), on the
CPU.

With no profiler running a span is a shared no-op that never reaches
record_function; under a profiler the `pt.` spans nest as the layers do
(frame > bounce > query > route > phases > reads) and carry their
arguments in their names; the image does not change by a bit; and the
benchmark's reduction of a trace (ptbench/trace.py) reads the same
numbers whether the trace holds the program's spans or not.
"""

import json

import pytest
import torch
import torch.distributed as dist

from pathtracer_tpu_torch import render
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import PRESETS
from pathtracer_tpu_torch.diff import render as dr
from pathtracer_tpu_torch.ops import intersect_grid as ig
from pathtracer_tpu_torch.parallel.mesh import Mesh
from pathtracer_tpu_torch.scene import builder
from pathtracer_tpu_torch.utils import profiling
from ptbench import harness
from ptbench.trace import Summary

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _scene(route: str):
    """(scene, cfg): the bench frame (cluster route) or a config-5 frame
    (grid route) on big_mesh at 3,000 triangles, small."""
    if route == "grid":
        cfg = PRESETS["config5"].replace(width=24, height=24)
        scene = builder.big_mesh(n_target=3000)
    else:
        cfg = PRESETS["bench"].replace(width=16, height=16)
        scene = builder.build_scene(cfg.scene)
        if route != "cluster":
            cfg = cfg.replace(width=8, height=8, backend=route)
    return prepare_accel(with_bvh(scene), cfg), cfg


@pytest.fixture(scope="module")
def scenes():
    return {r: _scene(r) for r in ("cluster", "grid")}


def _profiled(fn):
    """fn() under a CPU profiler: (its result, the pt. spans as
    (start, end, name without the prefix), by start)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name[3:])
                   for e in prof.events() if e.name.startswith("pt."))
    return out, spans


@pytest.fixture(scope="module")
def frames(scenes):
    """Per route: the image rendered plainly, then under a CPU profiler,
    and the profiled frame's spans."""
    out = {}
    for route, (scene, cfg) in scenes.items():
        plain = render(scene, cfg, device="cpu")
        traced, spans = _profiled(lambda: render(scene, cfg, device="cpu"))
        out[route] = (plain, traced, spans)
    return out


class _Recorder:
    """A stand-in profiler for the walks whose many small operations make
    torch.profiler slow on the CPU: it reports itself as running and
    records each span's enter and exit on a counter."""

    def __init__(self, monkeypatch):
        self.spans, self.clock = [], 0
        rec = self

        class record_function:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                rec.clock += 1
                self.start = rec.clock

            def __exit__(self, *exc):
                rec.clock += 1
                rec.spans.append((self.start, rec.clock, self.name[3:]))

        monkeypatch.setattr(torch._C._autograd, "_profiler_enabled",
                            lambda: True)
        monkeypatch.setattr(torch.profiler, "record_function",
                            record_function)


def _nest(spans):
    """Each span's path: the names of the spans that hold it, outermost
    first, then its own. Spans of one thread nest."""
    out, open_ = [], []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while open_ and open_[-1][0] <= s:
            open_.pop()
        open_.append((e, name))
        out.append(tuple(n for _, n in open_))
    return out


def _name(key):
    return key.split("[", 1)[0]


def _arg(key):
    return key.split("[", 1)[1][:-1]


class _Raises:
    def __init__(self, *a, **k):
        raise AssertionError("record_function called with no profiler")


@pytest.mark.parametrize("what", ["cluster", "grid", "grad"])
def test_no_profiler_never_calls_record_function(monkeypatch, scenes, what):
    monkeypatch.setattr(torch.profiler, "record_function", _Raises)
    assert profiling.span("frame", 3) is profiling.span("x") \
        is profiling.host_read("y")
    scene, cfg = scenes["cluster" if what == "grad" else what]
    if what == "grad":
        loss, g = dr.grad_render(scene, cfg.replace(width=8, height=8,
                                                    max_depth=2))
        assert bool(torch.isfinite(g.albedo).all())
    else:
        img = render(scene, cfg, device="cpu")
        assert bool(torch.isfinite(img).all())
    with pytest.raises(AssertionError):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.span("frame")


@pytest.mark.parametrize("route", ["cluster", "grid"])
def test_image_bit_identical_under_profiler(frames, route):
    plain, traced, spans = frames[route]
    assert spans and torch.equal(plain, traced)


def _frame_checks(paths, cfg):
    """What every route's frame shares: one frame, its bounces in order,
    one sampler span per draw, a hit and a shadow query per bounce."""
    names = [p[-1] for p in paths]
    assert [n for n in names if _name(n) == "frame"] == ["frame[0]"]
    bounces = [p for p in paths if _name(p[-1]) == "bounce"]
    assert [p[-1] for p in bounces] == [f"bounce[{b}]"
                                        for b in range(cfg.max_depth)]
    assert all(p == ("frame[0]", p[-1]) for p in bounces)
    samplers = [p for p in paths if p[-1] == "sampler"]
    assert len(samplers) == 1 + cfg.max_depth
    assert samplers[0] == ("frame[0]", "sampler")
    assert all(_name(p[-2]) == "bounce" for p in samplers[1:])
    queries = [p for p in paths if _name(p[-1]) == "query"]
    assert all(len(p) == 3 and _name(p[1]) == "bounce" for p in queries)
    assert [_arg(p[-1]) for p in queries] == ["hit", "shadow"] \
        * cfg.max_depth


def test_grid_frame_spans_nest(scenes, frames):
    cfg = scenes["grid"][1]
    paths = _nest(frames["grid"][2])
    _frame_checks(paths, cfg)
    grids = [p for p in paths if p[-1] == "grid"]
    assert len(grids) == 2 * cfg.max_depth
    assert all(_name(p[-2]) == "query" for p in grids)
    where = {"stage_a": {"grid"}, "era": {"grid"},
             "dda": {"grid", "grid.stage_a", "grid.era"},
             "bin": {"grid.stage_a", "grid.era"},
             "k2": {"grid.stage_a", "grid.era"},
             "combine": {"grid.stage_a", "grid.era"}}
    reads = {"phase.nonzero": "grid.bin", "bin.nonzero": "grid.bin",
             "bin.total": "grid.bin", "window.nonzero": "grid.dda",
             "era.width": "grid.dda", "era.live": {"grid", "grid.era"}}
    seen = set()
    for p in paths:
        n = _name(p[-1])
        if n.startswith("grid."):
            assert _name(p[-2]) in where[n[5:]], p
        if n == "read":
            seen.add(_arg(p[-1]))
            parent = reads[_arg(p[-1])]
            assert _name(p[-2]) in ({parent} if isinstance(parent, str)
                                    else parent), p
            assert "grid" in p
    assert {"phase.nonzero", "bin.nonzero", "bin.total", "era.live",
            "window.nonzero"} <= seen
    # The phases in order within each stage A and era, with the eras of
    # each call numbered from 0 and the rays each takes.
    for i, p in enumerate(paths):
        if _name(p[-1]) in ("grid.stage_a", "grid.era"):
            kids = [q[-1] for q in paths[i + 1:]
                    if q[:len(p)] == p and len(q) == len(p) + 1]
            # A phase with no pair ends after its binning.
            assert [k for k in kids if k != "read[era.live]"] in (
                ["grid.dda", "grid.bin"],
                ["grid.dda", "grid.bin", "grid.k2", "grid.combine"]), kids
    for i, p in enumerate(paths):
        if p[-1] == "grid":
            eras = [q[-1] for q in paths[i + 1:]
                    if q[:len(p)] == p and len(q) == len(p) + 1
                    and _name(q[-1]) == "grid.era"]
            args = [dict(kv.split("=") for kv in _arg(e).split(","))
                    for e in eras]
            assert [int(a["era"]) for a in args] == list(range(len(eras)))
            assert all(int(a["rays"]) > 0 for a in args)
    assert any(_name(p[-1]) == "grid.era" for p in paths)


def test_grid_step_windows_mark_the_width_read(scenes):
    """Without occupied windows (config 5's own setting) an era reads its
    DDA length from the card: the era.width read, inside the era's DDA."""
    scene, _ = scenes["grid"]
    g = scene.geometry
    gen = torch.Generator().manual_seed(0)
    o = torch.rand((512, 3), generator=gen) * 0.9 + 0.05
    d = torch.nn.functional.normalize(torch.randn((512, 3), generator=gen),
                                      dim=1)
    plain = ig.closest_hit_grid(g, o, d, occupied_windows=False)
    out, spans = _profiled(lambda: ig.closest_hit_grid(
        g, o, d, occupied_windows=False))
    assert all(torch.equal(a, b) for a, b in zip(plain, out))
    widths = [p for p in _nest(spans) if p[-1] == "read[era.width]"]
    assert widths and all(tuple(map(_name, p[-3:-1]))
                          == ("grid.era", "grid.dda") for p in widths)


def test_cluster_frame_spans_nest(scenes, frames):
    cfg = scenes["cluster"][1]
    paths = _nest(frames["cluster"][2])
    _frame_checks(paths, cfg)
    clusters = [i for i, p in enumerate(paths) if p[-1] == "cluster"]
    assert len(clusters) == 2 * cfg.max_depth
    for i in clusters:
        p = paths[i]
        assert _name(p[-2]) == "query"
        kids = [q[-1] for q in paths[i + 1:]
                if q[:len(p)] == p and len(q) == len(p) + 1]
        assert kids == ["cluster.cull", "cluster.k1", "cluster.decode"]
    compacts = [p for p in paths if p[-1] == "compact"]
    assert len(compacts) == cfg.max_depth - 1
    assert all(_name(p[-2]) == "bounce" for p in compacts)
    assert not any(_name(p[-1]) == "read" for p in paths)


@pytest.mark.parametrize("route", ["bvh", "stream"])
def test_other_routes_one_span_per_query(monkeypatch, route):
    scene, cfg = _scene("jnp" if route == "bvh" else "stream")
    rec = _Recorder(monkeypatch)
    render(scene, cfg.replace(max_depth=2), device="cpu")
    paths = _nest(rec.spans)
    mine = [p for p in paths if p[-1] == route]
    assert len(mine) == 4 and all(_name(p[-2]) == "query" for p in mine)


def test_backward_and_gather_spans(scenes):
    scene, cfg = scenes["cluster"]
    cfg = cfg.replace(width=8, height=8, max_depth=2)
    _, spans = _profiled(lambda: dr.grad_render(scene, cfg))
    paths = _nest(spans)
    assert [p for p in paths if p[-1] == "backward"] == [("backward",)]
    assert [p[-1] for p in paths if len(p) == 1] == ["frame[0]", "backward"]
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = Mesh(group=dist.group.WORLD, rank=0, size=1, device=CPU)
        x = torch.arange(6.0).reshape(3, 2)
        out, spans = _profiled(lambda: mesh.all_gather(x))
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, x)
    assert [s[2] for s in spans] == ["gather"]


# ---- the benchmark's reduction (ptbench/trace.py) on a synthetic trace --

def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


BASE = [
    ev("user_annotation", "ptb.window", 0, 1000),
    ev("user_annotation", "ptb.frame", 10, 800),
    ev("user_annotation", "ptb.grid_query", 90, 300),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=2),
    ev("cuda_runtime", "cudaLaunchKernel", 500, 5, correlation=4),
    ev("cuda_runtime", "cudaLaunchKernel", 900, 5, correlation=3),
    ev("cuda_runtime", "cudaMemcpyAsync", 345, 10),
    ev("kernel", "elementwise", 30, 100, correlation=1),
    ev("kernel", "pair_hit_kernel(args)", 400, 300, correlation=2),
    ev("gpu_memcpy", "Memcpy DtoD", 720, 20, correlation=4),
    ev("kernel", "sort", 910, 50, correlation=3),
]
PROGRAM = [
    ev("user_annotation", "pt.frame[0]", 12, 788),
    ev("user_annotation", "pt.bounce[0]", 16, 384),
    ev("user_annotation", "pt.query[hit]", 90, 300),
    ev("user_annotation", "pt.grid", 95, 285),
    ev("user_annotation", "pt.grid.era[era=0,rays=64]", 100, 270),
    ev("user_annotation", "pt.read[era.live]", 340, 20),
    ev("user_annotation", "pt.bounce[1]", 420, 370),
]
READERS = ("device_idle_pct", "device_idle_pct.grid", "frame_self_ms",
           "frame_self_ms.grid", "grid_query_ms", "sampler_ms",
           "sampler_ms.grid", "cluster_query_ms", "backward_ms",
           "collective_ms")


class _Run:
    def __init__(self, summary):
        self.summary = summary


def _read(name, summary):
    return harness.load_module("metrics", name).read(_Run(summary))


@pytest.mark.parametrize("n_frames", [1, 2])
def test_benchmark_summary_ignores_program_spans(n_frames):
    """A traced run of the port holds its `pt.` spans among the benchmark's
    `ptb.` ones: the Summary, its breakdown and every reader of it come
    out the same to the byte, so the traced metrics keep their meaning."""
    # The program's events among the benchmark's, whose order they keep.
    events = BASE[:3] + PROGRAM + BASE[3:]
    old = Summary.from_events(BASE, 0.001, n_frames)
    new = Summary.from_events(events, 0.001, n_frames)
    assert json.dumps(old.data) == json.dumps(new.data)
    assert json.dumps(old.breakdown()) == json.dumps(new.breakdown())
    got = {name: _read(name, new) for name in READERS}
    assert got == {name: _read(name, old) for name in READERS}
    assert got["grid_query_ms"] == pytest.approx(0.3 / n_frames)


def test_read_marks_counts_the_grid_reads(scenes):
    """checks.py [11]'s count on the CPU, where no call synchronises: the
    pt.read spans of a small config-5 frame inside pt.grid, by name."""
    from pathtracer_tpu_torch import checks

    scene, cfg = scenes["grid"]
    m = checks.read_marks(scene, cfg.replace(width=12, height=12))
    assert m["reads"] > 0 and sum(m["named"].values()) == m["reads"]
    assert set(m["named"]) <= {"phase.nonzero", "bin.nonzero", "bin.total",
                               "window.nonzero", "era.width", "era.live"}
    assert (m["syncs"], m["elsewhere"], m["where"]) == (0, 0, {})
