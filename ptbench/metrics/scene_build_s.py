"""Host clock around build_scene -> with_bvh -> prepare_accel ->
.to(device), synchronised (scene/builder.py, accel/*.py)."""


def read(run):
    return run.scene_build_s
