"""K1's share of its roofline: the least time of the work that the traced
frames' closest_hit_cluster queries need (ptbench/work.py: the tests of
every cluster their segments cross, counted from their rays, answers and
the scene's cluster table) over K1's device time in those frames
(ops/csrc/intersect_cluster.cu, kernel cluster_hit_kernel)."""

RECORD = ("pathtracer_tpu_torch.ops.intersect_cluster", "closest_hit_cluster")
KERNEL = "cluster_hit_kernel"


def read(run):
    s = run.summary
    if s is None or RECORD not in run.recorded:
        return None
    kernel_ms = s.op_ms(lambda name: KERNEL in name)
    if not kernel_ms:
        return None
    bound = run.recorded[RECORD].bound_ms() / s.data["n_frames"]
    return 100.0 * bound / kernel_ms
