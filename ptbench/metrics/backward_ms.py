"""Device ms per fit step of the operations launched while torch.autograd.grad
runs (diff/render.py, ops/boundary.py, autograd through engine/shading.py)."""


def read(run):
    s = run.summary
    ms = None if s is None else s.span_ms("backward")
    return ms or None
