"""Device ms per frame of the operations launched inside compact_rays
(engine/wavefront.py: the coherence key, the stable argsort, the (N, 16)
packed-row cat and gather and the unpacking), the stream compaction after
every bounce but the last. None where the program has no compact_rays."""


def read(run):
    s = run.summary
    ms = None if s is None else s.span_ms("compact")
    return ms or None
