"""Device ms per frame of the operations launched inside closest_hit_bvh
(ops/traverse_bvh.py: K4, hit_from_index's gathers and the sphere merge)."""


def read(run):
    s = run.summary
    ms = None if s is None else s.span_ms("bvh_query")
    return ms or None
