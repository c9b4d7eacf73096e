"""K4's share of its roofline: the least time of the work that the traced
frames' closest_hit_bvh queries need (ptbench/tri_work.py: the tests of
every triangle whose own box their segments cross, which any exact walk
over boxes makes) over K4's device time in those frames
(ops/csrc/traverse_bvh.cu, kernel bvh_hit_kernel).

The queries are recorded only where closest_hit_bvh takes the shadow
bound t_max, which work.Recorder hands on; a program whose query takes
none is not recorded, and the share is not read."""

import importlib
import inspect

from ptbench import tri_work

MODULE = "pathtracer_tpu_torch.ops.traverse_bvh"
KERNEL = "bvh_hit_kernel"


def _record():
    fn = importlib.import_module(MODULE).closest_hit_bvh
    if "t_max" not in inspect.signature(fn).parameters:
        return None
    return (MODULE, "closest_hit_bvh")


RECORD = _record()


def read(run):
    s = run.summary
    if s is None or RECORD is None or RECORD not in run.recorded:
        return None
    kernel_ms = s.op_ms(lambda name: KERNEL in name)
    if not kernel_ms:
        return None
    bound = tri_work.bound_ms(run.recorded[RECORD].calls) \
        / s.data["n_frames"]
    return 100.0 * bound / kernel_ms
