"""The end-to-end arithmetic on synthetic frame times, and the trace
reduction on a synthetic profiler trace."""

import pytest

from ptbench import harness, stats
from ptbench.trace import Summary


class FakeRun:
    def __init__(self, step_s, rays, window_s):
        self.step_s, self.rays, self.window_s = step_s, rays, window_s


def test_p95_of_all_frames():
    times = [0.130] * 180 + [0.140] * 19 + [0.5]
    assert stats.percentile(times, 95) == pytest.approx(0.140)
    run = FakeRun(times, 10, 1.0)
    p95 = harness.load_module("metrics", "frame_s_p95").read(run)
    assert p95 == pytest.approx(0.140)


def test_one_stall_moves_the_tail_not_the_median():
    base = [0.1 + 0.001 * (i % 10) for i in range(200)]
    stalled = base[:-1] + [3.0]
    assert stats.percentile(stalled, 95) == pytest.approx(
        stats.percentile(base, 95))
    assert stats.percentile(stalled, 50) == stats.percentile(base, 50)


def test_rate_is_over_the_whole_window():
    times = [0.1] * 99 + [2.0]          # one stall in the window
    run = FakeRun(times, 100 * 1_000_000, sum(times))
    rate = harness.load_module("metrics", "rays_per_s").read(run)
    assert rate == pytest.approx(100e6 / 11.9)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


TRACE = [
    ev("user_annotation", "ptb.window", 0, 1000),
    ev("user_annotation", "ptb.frame", 10, 800),
    ev("user_annotation", "ptb.cluster_query", 100, 200),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=2),
    ev("cuda_runtime", "cudaLaunchKernel", 900, 5, correlation=3),
    ev("kernel", "elementwise", 30, 100, correlation=1),
    ev("kernel", "cluster_hit_kernel(args)", 400, 300, correlation=2),
    ev("kernel", "sort", 910, 50, correlation=3),
]


def test_window_follows_go_on():
    run = FakeRun([], 0, None)
    run.seconds = 60.0
    said = []

    def go_on(more):
        said.append(more)
        return len(said) < 3

    harness.window(run, lambda i: 10 + i, go_on)
    assert said == [True, True, True]
    assert (run.attempted, run.rays, len(run.step_s)) == (3, 33, 3)


@pytest.mark.parametrize("name", ["rays_per_s", "device_idle_pct",
                                  "frame_self_ms", "sampler_ms"])
def test_grid_twin_reads_as_its_base(name):
    # The first launch inside a sampler span as well.
    events = TRACE + [ev("user_annotation", "ptb.sampler", 18, 10)]
    s = Summary.from_events(events, 0.001, 1)
    run = FakeRun([0.1] * 10, 7_000_000, 1.0)
    run.summary = s
    twin = harness.load_module("metrics", f"{name}.grid").read(run)
    base = harness.load_module("metrics", name).read(run)
    assert twin == base and twin is not None


def test_trace_summary_spans_busy_and_gaps():
    events = TRACE
    s = Summary.from_events(events, 0.001, 1)
    assert s.span_ms("frame") == pytest.approx(0.4)
    assert s.span_ms("cluster_query") == pytest.approx(0.3)
    assert s.self_ms("frame", ("cluster_query",)) == pytest.approx(0.1)
    assert s.op_ms(lambda n: "cluster_hit" in n) == pytest.approx(0.3)
    assert s.busy_s == pytest.approx(450e-6)
    gaps = dict(s.breakdown()["idle_gaps"])
    # 130..400 has its middle inside the query span; 0..30 and 700..910
    # inside the frame span; 960..1000 in the window only.
    assert gaps["cluster_query"] == pytest.approx(270e-6)
    assert gaps["frame"] == pytest.approx((30 + 210) * 1e-6)
    assert gaps["(outside spans)"] == pytest.approx(40e-6)
    idle = harness.load_module("metrics", "device_idle_pct")

    class R:
        summary = s

    assert idle.read(R) == pytest.approx(100 * (1 - 0.45))
