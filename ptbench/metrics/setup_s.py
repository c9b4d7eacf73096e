"""Seconds from the start of the run's process to the first timed frame:
CUDA start, the host scene build, the upload, the mode's set-up and the
warm frame (and, in a run that builds them, the kernel builds)."""


def read(run):
    return run.setup_s
