"""K4's triangle tests per lane over the traced frames: the tests and the
lanes that closest_hit_bvh adds to ops/traverse_bvh.py's STATS while the
profiler records (every lane of every query, the dead lanes too, which
the walk still walks). None where the program keeps no such counter."""

import importlib


def read(run):
    tb = importlib.import_module("pathtracer_tpu_torch.ops.traverse_bvh")
    take = getattr(tb, "take_stats", None)
    if run.summary is None or take is None:
        return None
    stats = take()
    if stats is None:
        return None
    lanes, _, tests = stats.tolist()
    return tests / lanes if lanes else None
