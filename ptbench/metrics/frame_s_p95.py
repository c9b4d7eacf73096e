"""The 95th percentile of the wall times of all frames (or fit steps) of
the window, each ended by a device barrier."""

from ptbench.stats import percentile


def read(run):
    return percentile(run.step_s, 95) if run.step_s else None
