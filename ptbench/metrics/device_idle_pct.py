"""Share of the traced window's wall time in which no operation ran on the
device (on several cards, the card with the most busy time)."""


def read(run):
    s = run.summary
    return None if s is None else 100.0 * (1.0 - s.busy_s / s.window_s)
