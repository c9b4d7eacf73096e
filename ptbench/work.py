"""The work a closest-hit query needs, counted from its inputs, its answers
and the scene, and the least time the card could do it in.

Whatever implements the query, a ray whose answer is t must test every
triangle of every cluster whose box the segment [T_MIN, min(t, t_max)]
crosses: one of them might lie nearer. So the work of a query is those
(ray, triangle) tests, and its bytes are each live ray's inputs read once
(o, d, t_max: 28 bytes), each answer written once (t, normal, material:
20 bytes) and the geometry of each such triangle (36 bytes: v0, e1, e2)
once per query. The clusters are the scene's cluster table (cl_lo, cl_hi,
cl_map), the same table for every route. Queries of over SAMPLE_RAYS live
rays are counted on a fixed sample of that many (drawn from a generator
seeded with 0) and the tests scaled by live / sampled; the distinct
clusters of the sample stand for the query's, which can only count bytes
low.

The least time of a query is the larger of its bytes at the card's memory
rate and its tests at the rate of the cheapest exact form the card has:
the bf16 hi/lo split product on the tensor cores, 240 operations per test,
with 6 float32 operations of epilogue on the CUDA cores. The peaks are
NVIDIA's published H100 SXM figures (dense), frozen here.
"""

from __future__ import annotations

import torch

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
TC_OPS_PER_TEST = 240
F32_OPS_PER_TEST = 6
RAY_IN_BYTES = 28
RAY_OUT_BYTES = 20
TRI_BYTES = 36
T_MIN = 1e-4
T_FAR = 1e8
SAMPLE_RAYS = 1 << 16
CLUSTER_CHUNK = 1 << 22  # (ray, cluster) slab tests per chunk


def cluster_tris(geom) -> torch.Tensor:
    """Triangles of each cluster of the scene's table (padding excluded)."""
    C = geom.cl_lo.shape[0]
    return (geom.cl_map.reshape(C, -1) >= 0).sum(dim=1).to(torch.int64)


def crossed(lo, hi, o, d, t_end):
    """(R, C) bool: does the segment o + s d, s in [T_MIN, t_end], cross
    each box [lo, hi]?"""
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(t0, t1).amax(dim=2)
    far = torch.maximum(t0, t1).amin(dim=2)
    return (near <= far) & (far >= T_MIN) & (near <= t_end[:, None])


def query_work(geom, o, d, t_max, t) -> dict:
    """Tests and bytes one query (rays o, d, t_max; answers t) needs."""
    dev = o.device
    t_end = t.float() if t_max is None else torch.minimum(t.float(),
                                                          t_max.float())
    live = t_end > T_MIN if t_max is None else t_max.float() > T_MIN
    t_end = torch.clamp(t_end, max=T_FAR)
    idx = torch.nonzero(live).squeeze(1)
    n_live = idx.numel()
    if n_live == 0:
        return {"tests": 0.0, "bytes": 0.0}
    if n_live > SAMPLE_RAYS:
        g = torch.Generator(device="cpu").manual_seed(0)
        pick = torch.randperm(n_live, generator=g)[:SAMPLE_RAYS]
        idx = idx[pick.to(dev)]
    tris = cluster_tris(geom)
    lo, hi = geom.cl_lo.float(), geom.cl_hi.float()
    C = lo.shape[0]
    per = max(1, CLUSTER_CHUNK // C)
    tests = 0
    seen = torch.zeros(C, dtype=torch.bool, device=dev)
    for s in range(0, idx.numel(), per):
        k = idx[s:s + per]
        x = crossed(lo, hi, o[k].float(), d[k].float(), t_end[k])
        tests += int((x.to(torch.int64) * tris[None]).sum())
        seen |= x.any(dim=0)
    tests = tests * n_live / idx.numel()
    n_bytes = n_live * (RAY_IN_BYTES + RAY_OUT_BYTES) \
        + int(tris[seen].sum()) * TRI_BYTES
    return {"tests": float(tests), "bytes": float(n_bytes)}


def bound_ms(work: dict) -> float:
    """Least milliseconds of `work` on the card."""
    return 1e3 * max(work["bytes"] / PEAK_BYTES,
                     work["tests"] * TC_OPS_PER_TEST / PEAK_BF16,
                     work["tests"] * F32_OPS_PER_TEST / PEAK_F32)


class Recorder:
    """Keeps the inputs and answers of every call of a query function while
    it is installed, to count their work afterwards."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.calls = []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.attr)

        def recording(geom, o, d, t_max=None, **kw):
            out = fn(geom, o, d, t_max=t_max, **kw)
            self.calls.append((geom, o, d, t_max, out[0]))
            return out

        setattr(self.module, self.attr, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)
        return False

    def bound_ms(self) -> float:
        """The summed least time of every recorded call, in ms."""
        return sum(bound_ms(query_work(*c)) for c in self.calls)
