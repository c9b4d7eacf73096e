"""Device ms per frame of the operations launched inside closest_hit_grid
(ops/intersect_grid.py: DDA, eras, binning and K2)."""


def read(run):
    s = run.summary
    ms = None if s is None else s.span_ms("grid_query")
    return ms or None
