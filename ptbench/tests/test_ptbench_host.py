"""What the harness says of its own process: its allowed CPUs, and the
collector's passes in the window."""

import gc
import os
import re

from ptbench import flow, host


def test_placement_names_the_allowed_cpus():
    cpus = sorted(os.sched_getaffinity(0))
    assert host.placement() == f"allowed CPUs {len(cpus)}: {cpus}"


class StubRun:
    trace = False
    seconds = 0.05
    name, rank = "stub.render", 0

    def __init__(self):
        self.step_s, self.rays, self.window_s, self.attempted = [], 0, None, 0


class StubMode:
    """Makes garbage in cycles, as the program's frames do, and a
    generation-0 pass in every frame."""

    def __init__(self):
        self.enabled = []

    def frame(self, i):
        a = []
        a.append(a)
        gc.collect(0)
        self.enabled.append(gc.isenabled())
        return 1


def test_window_counts_the_collector_and_leaves_it_on(capsys):
    run, mode = StubRun(), StubMode()
    before = len(gc.callbacks)
    flow.measure(run, mode, [])
    assert run.attempted == len(mode.enabled) >= 1 and all(mode.enabled)
    assert len(gc.callbacks) == before and gc.isenabled()
    said = re.search(r"stub.render rank 0 collector passes in the window "
                     r"by generation \[(\d+), (\d+), (\d+)\], ([0-9.]+) s",
                     capsys.readouterr().err)
    assert said and int(said[1]) >= run.attempted


def test_collector_counts_passes_by_generation():
    with host.Collector() as c:
        gc.collect(1)
    assert c.passes == [0, 1, 0] and c.seconds[1] >= 0.0
    assert "by generation [0, 1, 0]" in c.describe()
