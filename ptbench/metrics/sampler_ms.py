"""Device ms per frame of the operations launched inside the sampler's
calls (sampling/rng.py: pixel_jitter, bounce_uniforms)."""


def read(run):
    s = run.summary
    ms = None if s is None else s.span_ms("sampler")
    return ms or None
