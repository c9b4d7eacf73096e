"""Device ms per frame of the operations launched inside trace_sample
(engine/wavefront.py, engine/shading.py, engine/camera.py, the coherence
sort) but outside its sampler and query spans."""

EXCLUDE = ("sampler", "cluster_query", "grid_query")


def read(run):
    s = run.summary
    if s is None or not s.span_ms("frame"):
        return None
    return s.self_ms("frame", EXCLUDE)
