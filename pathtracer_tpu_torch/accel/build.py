"""Host-side BVH builder → flat SoA arrays with stackless skip links.

The reference's numpy median-split builder, unchanged: depth-first preorder
where a box hit advances the cursor to i+1 and a miss (or a finished leaf)
jumps to ``skip[i]``; triangles are reordered so every leaf owns a
contiguous range. The triangle order it produces is the order every later
table (clusters, lights) is built on, so it must equal the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.traverse_bvh import pack_tables
from ..scene.model import Scene


@dataclasses.dataclass
class FlatBVH:
    lo: np.ndarray  # (N, 3) f32
    hi: np.ndarray  # (N, 3) f32
    first: np.ndarray  # (N,) i32: leaf → first triangle; interior → unused
    count: np.ndarray  # (N,) i32: 0 interior, >0 leaf size
    skip: np.ndarray  # (N,) i32: cursor on miss / after leaf
    order: np.ndarray  # (T,) i32: new→old triangle permutation


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              max_leaf: int = 4) -> FlatBVH:
    """Build the flat skip-link BVH over triangles (v0, v0+e1, v0+e2)."""
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    T = len(v0)
    if T == 0:
        z3 = np.zeros((0, 3), np.float32)
        z1 = np.zeros((0,), np.int32)
        return FlatBVH(z3, z3, z1, z1, z1, z1)

    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    centroid = (tri_lo + tri_hi) * 0.5

    lo_l, hi_l, first_l, count_l, skip_l = [], [], [], [], []
    order: list[int] = []

    # Iterative DFS; a frame is ("node", tri_ids) to emit a subtree or
    # ("skip", node_idx) to patch the skip pointer once it is emitted.
    stack: list[tuple[str, object]] = [("node", np.arange(T, dtype=np.int64))]
    while stack:
        kind, payload = stack.pop()
        if kind == "skip":
            skip_l[payload] = len(lo_l)
            continue
        ids = payload
        my = len(lo_l)
        lo_l.append(tri_lo[ids].min(0))
        hi_l.append(tri_hi[ids].max(0))
        first_l.append(0)
        count_l.append(0)
        skip_l.append(-1)
        stack.append(("skip", my))
        if len(ids) <= max_leaf:
            first_l[my] = len(order)
            count_l[my] = len(ids)
            order.extend(int(i) for i in ids)
            continue
        c = centroid[ids]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            mid = len(ids) // 2
            left, right = ids[:mid], ids[mid:]
        else:
            part = np.argsort(c[:, axis], kind="stable")
            mid = len(ids) // 2
            left, right = ids[part[:mid]], ids[part[mid:]]
        # Push right first so left (near side on the axis) is emitted at i+1.
        stack.append(("node", right))
        stack.append(("node", left))

    return FlatBVH(
        lo=np.asarray(lo_l, np.float32),
        hi=np.asarray(hi_l, np.float32),
        first=np.asarray(first_l, np.int32),
        count=np.asarray(count_l, np.int32),
        skip=np.asarray(skip_l, np.int32),
        order=np.asarray(order, np.int32),
    )


# Above this many triangles `with_bvh(engine="auto")` switches to the native
# binned-SAH builder (accel/native.py), as the reference does.
AUTO_NATIVE_THRESHOLD = 100_000


def with_bvh(scene: Scene, max_leaf: int = 4, engine: str = "auto") -> Scene:
    """Scene with triangles reordered by leaf and BVH arrays attached.

    engine: "numpy" (median split), "native" (the C++ binned-SAH builder of
    accel/native.py) or "auto" (numpy up to AUTO_NATIVE_THRESHOLD triangles,
    native above). Unlike the reference, "auto" never falls back to numpy
    when the native library cannot be built: it raises, since the fallback
    gives another triangle order. Light triangle indices are remapped
    through the permutation, and the BVH is also packed for the walks of
    ops/traverse_bvh.py (pack_tables: skip-link nodes, child pairs and
    triangles).
    """
    if engine not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown BVH engine {engine!r}")
    g = scene.geometry
    n_tris = int(g.tri_v0.shape[0])
    v0 = g.tri_v0.cpu().numpy()
    e1 = g.tri_e1.cpu().numpy()
    e2 = g.tri_e2.cpu().numpy()
    if engine == "native" or (engine == "auto"
                              and n_tris > AUTO_NATIVE_THRESHOLD):
        from .native import build_bvh_native

        bvh = build_bvh_native(v0, e1, e2, max_leaf)
    else:
        bvh = build_bvh(v0, e1, e2, max_leaf)
    perm = bvh.order  # new position i holds old triangle perm[i]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    v0, e1, e2 = v0[perm], e1[perm], e2[perm]
    nodes, pairs, tris = pack_tables(bvh.lo, bvh.hi, bvh.first, bvh.count,
                                     bvh.skip, v0, e1, e2)
    g2 = g.replace(
        tri_v0=v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_n=g.tri_n.cpu().numpy()[perm],
        tri_mat=g.tri_mat.cpu().numpy()[perm],
        bvh_lo=bvh.lo,
        bvh_hi=bvh.hi,
        bvh_first=bvh.first,
        bvh_count=bvh.count,
        bvh_skip=bvh.skip,
        bvh_nodes=nodes,
        bvh_tris=tris,
        bvh_pairs=pairs,
    )
    tri_idx = inv[scene.lights.tri_idx.cpu().numpy()].astype(np.int32)
    return scene.replace(geometry=g2,
                         lights=scene.lights.replace(tri_idx=tri_idx))


def _slice_bounds(start, stop, n):
    """numpy's bounds of `a[start:stop]` on an axis of length n, elementwise
    (negative ends count from the end; both clipped to 0..n)."""
    start = np.where(start < 0, start + n, start).clip(0, n)
    stop = np.where(stop < 0, stop + n, stop).clip(0, n)
    return start, np.maximum(start, stop)


def check_invariants(bvh: FlatBVH, n_tris: int, max_leaf: int = 4) -> None:
    """Structural invariants of a skip-link BVH; raises AssertionError on a
    violation: every triangle in exactly one leaf, skip links forward and
    at most to the end sentinel, leaf counts <= max_leaf, the leaf ranges
    covering the reordered triangle array, and each interior node's box
    containing its children i + 1 and skip[i + 1] to 1e-6.

    The reference's check (pathtracer_tpu/accel/build.py:check_invariants)
    with the same verdict, vectorised: its per-node loops would take tens
    of seconds on config 5's 1.3M-node tree.
    """
    n = len(bvh.lo)
    assert len(bvh.order) == n_tris
    assert np.array_equal(np.sort(bvh.order), np.arange(n_tris)), (
        "every triangle in exactly one leaf")
    assert (bvh.skip > np.arange(n)).all() and (bvh.skip <= n).all()
    leaf = bvh.count > 0
    assert (bvh.count[leaf] <= max_leaf).all()
    # Each leaf covers order[first:first + count] (the sum in the arrays'
    # own dtype, as the reference's); an interval count of the covers.
    first = bvh.first[leaf]
    start, stop = _slice_bounds(first.astype(np.int64),
                                (first + bvh.count[leaf]).astype(np.int64),
                                n_tris)
    delta = np.zeros(n_tris + 1, np.int64)
    np.add.at(delta, start, 1)
    np.add.at(delta, stop, -1)
    assert (np.cumsum(delta)[:n_tris] > 0).all(), (
        "leaf ranges cover the reordered triangle array")
    # Interior node i's children are i + 1 and skip[i + 1].
    inner = np.nonzero(bvh.count == 0)[0]
    left = inner + 1
    assert (left < n).all()
    right = bvh.skip[left]
    assert (right < n).all()
    for child in (left, right):
        assert (bvh.lo[inner] <= bvh.lo[child] + 1e-6).all()
        assert (bvh.hi[inner] >= bvh.hi[child] - 1e-6).all()
