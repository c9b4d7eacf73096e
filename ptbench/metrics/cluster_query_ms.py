"""Device ms per frame of the operations launched inside closest_hit_cluster
(ops/intersect_cluster.py: the glue and K1)."""


def read(run):
    s = run.summary
    ms = None if s is None else s.span_ms("cluster_query")
    return ms or None
