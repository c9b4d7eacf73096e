"""What the benchmark's own process sees of its host, on standard error.

The bench frames are paced by the host's launches, so a run's rate follows
the host. Each rank logs the CPUs it may run on and the collector's passes
in its window, so that a later spread can be read against them. It changes
neither.
"""

from __future__ import annotations

import gc
import os
import time


def placement() -> str:
    """The CPUs this process may run on."""
    cpus = sorted(os.sched_getaffinity(0))
    return f"allowed CPUs {len(cpus)}: {cpus}"


class Collector:
    """Counts the collector's passes in the window, by generation, with
    their seconds, and leaves the collector as it is."""

    def __init__(self):
        self.passes = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = None

    def _watch(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.passes[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._watch)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._watch)

    def describe(self) -> str:
        return (f"collector passes in the window by generation "
                f"{self.passes}, {sum(self.seconds):.4f} s")
