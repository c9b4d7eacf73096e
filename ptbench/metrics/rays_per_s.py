"""Useful rays (live path segments + candidate shadow rays, the engine's
count) of every frame or step of the window, on every card, over the
window's wall time."""


def read(run):
    return run.rays / run.window_s if run.window_s else None
