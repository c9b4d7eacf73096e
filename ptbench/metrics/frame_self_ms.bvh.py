"""Device ms per frame of the operations launched inside trace_sample but
outside its sampler, BVH query and compaction spans: the frame loop and
shading of the BVH route with compaction. None where the compaction is no
span of its own (a program without compact_rays), so that the reading
never holds it."""

EXCLUDE = ("sampler", "bvh_query", "compact")


def read(run):
    s = run.summary
    if s is None or not s.span_ms("frame") or not s.span_ms("compact"):
        return None
    return s.self_ms("frame", EXCLUDE)
