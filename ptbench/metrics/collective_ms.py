"""Device ms per frame of the NCCL kernels (parallel/mesh.py's
all-gather of the image)."""


def read(run):
    s = run.summary
    ms = None if s is None else s.op_ms(lambda name: "nccl" in name.lower())
    return ms or None
