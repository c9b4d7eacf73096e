"""BVH closest hit: a near-first walk over child pairs as a hand-written
CUDA kernel.

The counterpart of the reference's ``ops/traverse_pallas.py``. The TPU
kernel walks the BVH's skip links with one cursor shared by a 512-ray
block, because Mosaic cannot gather per lane. On Hopper each thread walks
its own ray (``csrc/traverse_bvh.cu``) over a table of child pairs, near
child first, with a short per-thread stack. Both compute what
accel/traverse.py computes: per ray the closest Möller–Trumbore t over the
triangles of the leaves it reaches, and that triangle. Only the visit
order differs from the skip-link walk, so only a tie between equal t (or a
triangle on a box face that the culling reaches otherwise) may pick
another triangle.

The kernel reads the BVH from tables packed once per scene by
``pack_tables`` (accel/build.py:with_bvh stores them on the Geometry as
``bvh_nodes``, ``bvh_pairs`` and ``bvh_tris``):

  bvh_nodes (N, 8) f32: [lo(3), skip, hi(3), first * 8 + count], the two
      int words stored as their int32 bits: the skip-link walk's arrays,
      read by the plain version ``bvh_hit_plain``;
  bvh_pairs (E, 16) f32: one 64-byte entry per interior node, holding both
      children as [lo(3), word, hi(3), 0] each; a child's word is its
      leaf word first * 8 + count, or entry * 8 for an interior child.
      Entry 0 is a pseudo-entry whose first child is the root (whose word
      is 8 or the root leaf's) and whose second child is a box no ray hits
      (+inf corners, word 0); its last word holds the tree's depth, which
      the walk's stack must fit (STACK_DEPTH);
  bvh_tris (T, 12) f32: [v0(3), e1(3), e2(3), 0, 0, 0].

Both builders emit depth-first preorder, so interior node i has its left
child at i + 1 and its right child at skip[i + 1], and the pair table is
derived from the skip-link arrays alone.

A leaf's word alone says how many triangles it holds (at most 7), and all
of them are tested, by the kernel and both plain walks. ``max_leaf``, the
reference's bound on the triangles tested per leaf, is kept as an
argument for parity: None (the default) or a value no smaller than the
table's largest leaf; a smaller one raises ValueError
(accel/traverse.py:leaf_bound) rather than skip triangles, as the
reference does.

On a CPU tensor ``bvh_hit`` runs ``bvh_hit_plain`` (the reference's
skip-link walk, accel/traverse.py:walk); on a CUDA tensor it launches the
kernel or raises. ``bvh_hit_ordered_plain`` is the kernel's walk in plain
PyTorch (the same visit order, pushes, pops and culls), which the kernel
equals bit for bit: t, triangle and per-block counts. The tests and
chip_smoke.py use it; the main path never does.

``closest_hit_bvh`` is the engine's query on this route. It takes the
shadow bound ``t_max`` that every route takes, and does not use it yet:
the walk runs to the closest hit, which the route contract allows (a hit
at t >= t_max may read as a miss, or as the hit). Its span is
``pt.bvh[rays=<lanes>]``. While a profiler records (the switch of
utils/profiling.py:span), it also adds the query's lanes and the walk's
per-block visits and triangle tests to ``STATS``, an int64 tensor (lanes,
visits, tests) on the query's device, with no host read; ``take_stats``
returns the counts and resets them. With no profiler it counts nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as C
from ..accel.traverse import (
    CHUNK,
    box_hit,
    hit_from_index,
    leaf_bound,
    mt_test,
    slab,
    walk,
)
from ..utils.profiling import recording, span
from . import _build
from .boundary import no_gradient
from .intersect_cluster import _safe_inverse

NODE_WORDS = 8
PAIR_WORDS = 16
TRI_WORDS = 12
MAX_LEAF_COUNT = 7  # count lives in the low 3 bits of the leaf word
BVH_BLOCK = 256  # rays per CUDA block; counts are summed per block
STACK_DEPTH = 64  # entries of the walk's per-ray stack (traverse_bvh.cu)

# Kernel launches through bvh_hit (CUDA tensors only).
LAUNCHES = 0
# (lanes, visits, tests) of closest_hit_bvh's queries while a profiler
# records (module docstring); None until the first such query.
STATS: torch.Tensor | None = None


def _tree_depth(count, skip):
    """Per node, the number of interior ancestors: a node j lies inside
    interior node i's subtree exactly when i < j < skip[i]."""
    n = len(count)
    inner = np.nonzero(count == 0)[0]
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, inner + 1, 1)
    np.add.at(delta, skip[inner], -1)
    return np.cumsum(delta)[:n]


def _pack_pairs(lo, hi, first, count, skip):
    """The child-pair table (module docstring) of a checked DFS tree."""
    n = len(lo)
    inner = np.nonzero(count == 0)[0]
    leaf = count > 0
    # A leaf's subtree is itself; an interior node's is itself, its left
    # child's subtree and its right child's, which ends where its own ends.
    right = skip[np.minimum(inner + 1, n - 1)]
    if (skip[0] != n or (leaf & (skip != np.arange(n) + 1)).any()
            or (inner + 1 >= n).any() or (right >= skip[inner]).any()
            or (skip[np.minimum(right, n - 1)] != skip[inner]).any()):
        raise ValueError("the BVH is not a binary tree in depth-first "
                         "preorder")
    depth = int(_tree_depth(count, skip).max())
    if depth > STACK_DEPTH:
        raise ValueError(f"the BVH is {depth} levels deep; the walk's stack "
                         f"holds {STACK_DEPTH}")
    if (len(inner) + 1) * 8 >= 2 ** 31:
        raise ValueError(f"{len(inner)} interior nodes overflow the packed "
                         "child word")
    entry = np.zeros(n, np.int64)
    entry[inner] = np.arange(1, len(inner) + 1)
    word = np.where(leaf, first * 8 + count, entry * 8)
    pairs = np.zeros((len(inner) + 1, PAIR_WORDS), np.float32)
    bits = pairs.view(np.int32)
    for half, child in ((0, inner + 1), (8, right)):
        pairs[1:, half:half + 3] = lo[child]
        pairs[1:, half + 4:half + 7] = hi[child]
        bits[1:, half + 3] = word[child]
    pairs[0, 0:3], pairs[0, 4:7] = lo[0], hi[0]
    bits[0, 3] = word[0]
    pairs[0, 8:11] = pairs[0, 12:15] = np.inf
    bits[0, 7] = depth
    return pairs


def pack_tables(lo, hi, first, count, skip, v0, e1, e2):
    """(bvh_nodes, bvh_pairs, bvh_tris) numpy tables from the skip-link
    arrays (see the module docstring). Raises on links the kernels cannot
    walk: a count above 7, a leaf outside the triangles, a skip that does
    not move forward (the skip-link walk's termination), a tree that is
    not binary in depth-first preorder, or one deeper than STACK_DEPTH."""
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    hi = np.asarray(hi, np.float32).reshape(-1, 3)
    n = len(lo)
    if n == 0:  # no BVH: nothing to walk
        return (np.zeros((0, NODE_WORDS), np.float32),
                np.zeros((0, PAIR_WORDS), np.float32),
                np.zeros((0, TRI_WORDS), np.float32))
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    skip = np.asarray(skip, np.int64)
    v0 = np.asarray(v0, np.float32).reshape(-1, 3)
    tris = np.zeros((len(v0), TRI_WORDS), np.float32)
    tris[:, 0:3] = v0
    tris[:, 3:6] = np.asarray(e1, np.float32).reshape(-1, 3)
    tris[:, 6:9] = np.asarray(e2, np.float32).reshape(-1, 3)
    leaf = count > 0
    if ((count < 0).any() or (count > MAX_LEAF_COUNT).any()
            or (leaf & ((first < 0) | (first + count > len(tris)))).any()):
        raise ValueError("BVH leaves must hold 0..7 triangles inside the "
                         "triangle table")
    if len(tris) * 8 >= 2 ** 31:
        raise ValueError(f"{len(tris)} triangles overflow the packed leaf "
                         "word")
    if ((skip <= np.arange(n)) | (skip > n)).any():
        raise ValueError("BVH skip links must point forward, at most to the "
                         "end sentinel")
    nodes = np.zeros((n, NODE_WORDS), np.float32)
    nodes[:, 0:3] = lo
    nodes[:, 4:7] = hi
    words = nodes.view(np.int32)
    words[:, 3] = skip
    words[:, 7] = np.where(leaf, first * 8 + count, 0)
    return nodes, _pack_pairs(lo, hi, first, count, skip), tris


def unpack_tables(nodes, tris):
    """The walk's arrays (lo, hi, first, count, skip, v0, e1, e2) from the
    packed tables."""
    skip = nodes[:, 3].contiguous().view(torch.int32)
    leaf = nodes[:, 7].contiguous().view(torch.int32)
    return (nodes[:, 0:3], nodes[:, 4:7], leaf >> 3, leaf & 7, skip,
            tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])


def _check_inputs(tables, o, d):
    for name, x, width in (*tables, ("o", o, 3), ("d", d, 3)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != width:
            raise ValueError(f"{name} must be float32 (n, {width}); got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(x.shape[0] == 0 for _, x, _ in tables):
        raise ValueError("empty BVH tables: build the scene with "
                         "accel.build.with_bvh")
    if d.shape[0] != o.shape[0]:
        raise ValueError(f"o and d differ in length: {o.shape[0]} vs "
                         f"{d.shape[0]}")


def _block_sums(per_ray):
    pad = (-per_ray.shape[0]) % BVH_BLOCK
    v = torch.cat([per_ray, per_ray.new_zeros((pad,))])
    return v.reshape(-1, BVH_BLOCK).sum(dim=1).to(torch.int32)


def largest_leaf(pairs) -> int:
    """The largest leaf count in a pair table: the low 3 bits of its child
    words (an interior child's word is a multiple of 8)."""
    words = pairs[:, [3, 11]].contiguous().view(torch.int32)
    return int((words & 7).max())


def bvh_hit_plain(nodes, tris, o, d, max_leaf: int | None = None,
                  chunk: int = CHUNK):
    """The function's plain version: the reference's skip-link walk, with
    every triangle of a leaf tested.

    Args:
      nodes, tris: the packed tables (module docstring).
      o, d: (R, 3) f32 ray origins and directions.
      max_leaf: None, or at least the table's largest leaf (leaf_bound).
      chunk: rays per walk chunk (changes only memory and time).

    Returns (t, tri, visits, tests): (R,) f32 closest t (T_FAR on a miss),
    (R,) i32 triangle index (-1 on a miss), and per 256-ray block
    ((ceil(R / 256),) i32) the nodes visited and the triangles tested.
    """
    _check_inputs((("bvh_nodes", nodes, NODE_WORDS),
                   ("bvh_tris", tris, TRI_WORDS)), o, d)
    t, tri, visits, tests = walk(*unpack_tables(nodes, tris), o, d,
                                 max_leaf, chunk)
    return t, tri, _block_sums(visits), _block_sums(tests)


def _ordered_chunk(pairs, tris, o, d, n_test, seen):
    R = o.shape[0]
    dev = o.device
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    last_tri = v0.shape[0] - 1
    inv_d = _safe_inverse(d)
    rows = torch.arange(R, device=dev)
    word = torch.zeros((R,), dtype=torch.int64, device=dev)  # entry 0
    t_best = torch.full((R,), C.T_FAR, dtype=torch.float32, device=dev)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    visits = torch.zeros((R,), dtype=torch.int32, device=dev)
    tests = torch.zeros((R,), dtype=torch.int32, device=dev)
    stack_w = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((R, STACK_DEPTH), dtype=torch.float32, device=dev)
    sp = torch.zeros((R,), dtype=torch.int64, device=dev)
    live = torch.ones((R,), dtype=torch.bool, device=dev)
    while bool(live.any()):
        inner = live & (word & 7 == 0)
        leaf = live & ~inner
        # Interior: one entry tests both children.
        e = torch.where(inner, word >> 3, 0)
        ent = pairs[e]
        visits += inner.to(torch.int32)
        tn_l, tf_l = slab(ent[:, 0:3], ent[:, 4:7], o, inv_d)
        tn_r, tf_r = slab(ent[:, 8:11], ent[:, 12:15], o, inv_d)
        hit_l = inner & box_hit(tn_l, tf_l, t_best)
        hit_r = inner & box_hit(tn_r, tf_r, t_best)
        w_l = ent[:, 3].contiguous().view(torch.int32).to(torch.int64)
        w_r = ent[:, 11].contiguous().view(torch.int32).to(torch.int64)
        right_first = tn_r < tn_l  # ties: the left child first
        push = hit_l & hit_r
        far_w = torch.where(right_first, w_l, w_r)
        far_t = torch.where(right_first, tn_l, tn_r)
        at = torch.where(push, sp, 0)
        stack_w[rows, at] = torch.where(push, far_w, stack_w[rows, at])
        stack_t[rows, at] = torch.where(push, far_t, stack_t[rows, at])
        sp += push.to(torch.int64)
        near_w = torch.where(push & right_first, w_r,
                             torch.where(hit_l, w_l, w_r))
        word = torch.where(hit_l | hit_r, near_w, word)
        # Leaf: its triangles, then a pop.
        first, cnt = word >> 3, word & 7
        for k in range(n_test):
            idx = torch.clamp(first + k, max=last_tri)
            valid = leaf & (k < cnt)
            t, ok = mt_test(v0, e1, e2, idx, o, d)
            tests += valid.to(torch.int32)
            if seen is not None:
                seen[1][idx[valid]] = True
            # Strict: ties keep the earlier hit.
            better = valid & ok & (t < t_best)
            t_best = torch.where(better, t, t_best)
            best = torch.where(better, idx, best)
        if seen is not None:
            seen[0][e[inner]] = True
        # Pop until an entry nearer than the best hit, or the stack is empty.
        pop = (inner & ~(hit_l | hit_r)) | leaf
        while True:
            from_stack = pop & (sp > 0)
            if not bool(from_stack.any()):
                break
            sp -= from_stack.to(torch.int64)
            top = torch.clamp(sp, min=0)
            take = from_stack & (stack_t[rows, top] < t_best)
            word = torch.where(take, stack_w[rows, top], word)
            pop &= ~take
        live &= ~pop
    return t_best, best.to(torch.int32), visits, tests


def bvh_hit_ordered_plain(pairs, tris, o, d, max_leaf: int | None = None,
                          chunk: int = CHUNK, seen=None):
    """The kernel's walk in plain PyTorch, for the tests and chip_smoke.py.

    Per ray, from entry 0: an interior word fetches its entry (one visit)
    and slab-tests both children, culled against the best t; if both hit,
    it descends into the one with the smaller tnear (the left one on a
    tie) and pushes the other with its tnear; if one hits, it descends
    into it. A leaf word tests its count of triangles in order, keeping a
    strictly nearer t. After a leaf, or an entry with no child
    hit, it pops until an entry whose tnear is below the best t; an empty
    stack ends the walk.

    Args as bvh_hit_plain's, with the pair table for the node table;
    `seen`, if given, is a pair of bool tensors (E,) and (T,) in which the
    entries fetched and the triangles tested are set.

    Returns (t, tri, visits, tests) as bvh_hit_plain, the visits counting
    entry fetches (the root test included).
    """
    _check_inputs((("bvh_pairs", pairs, PAIR_WORDS),
                   ("bvh_tris", tris, TRI_WORDS)), o, d)
    depth = int(pairs[0, 7].view(torch.int32))
    if depth > STACK_DEPTH:
        raise ValueError(f"the BVH is {depth} levels deep; the walk's stack "
                         f"holds {STACK_DEPTH}")
    n_test = leaf_bound(largest_leaf(pairs), max_leaf)
    R = o.shape[0]
    if R == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=o.device)
        return o.new_zeros((0,)), empty, empty, empty
    parts = [_ordered_chunk(pairs, tris, o[s:s + chunk], d[s:s + chunk],
                            n_test, seen)
             for s in range(0, R, chunk)]
    t, tri, visits, tests = (torch.cat(x) for x in zip(*parts))
    return t, tri, _block_sums(visits), _block_sums(tests)


def _kernel():
    fn = _build.load("traverse_bvh").bvh_hit_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bvh_hit(nodes, pairs, tris, o, d, max_leaf: int | None = None):
    """Closest triangle of every ray by the BVH walk, every triangle of a
    leaf tested; `max_leaf` is None or at least the table's largest leaf
    (leaf_bound; checking an explicit value reads the table on the host).

    CPU tensors run the plain version, the reference's skip-link walk
    (bvh_hit_plain, on `nodes`). CUDA tensors launch the near-first pair
    walk (on `pairs`; it equals bvh_hit_ordered_plain bit for bit), built
    at first use, on the current stream, one thread per ray, and count the
    launch in LAUNCHES; a failed launch raises. Returns (t, tri, visits,
    tests) as bvh_hit_plain. An autograd boundary (ops/boundary.py): no
    gradient flows back.
    """
    return no_gradient(_bvh_hit, nodes, pairs, tris, o, d, max_leaf)


def _bvh_hit(nodes, pairs, tris, o, d, max_leaf: int | None = None):
    global LAUNCHES
    _check_inputs((("bvh_nodes", nodes, NODE_WORDS),
                   ("bvh_pairs", pairs, PAIR_WORDS),
                   ("bvh_tris", tris, TRI_WORDS)), o, d)
    dev = o.device
    if dev.type == "cpu":
        return bvh_hit_plain(nodes, tris, o, d, max_leaf)
    if dev.type != "cuda":
        raise ValueError(f"bvh_hit runs on cpu or cuda, not {dev}")
    if max_leaf is not None:
        leaf_bound(largest_leaf(pairs), max_leaf)
    if pairs.data_ptr() % 64 or tris.data_ptr() % 16:
        raise ValueError("bvh_pairs must be 64-byte and bvh_tris 16-byte "
                         "aligned")
    R = o.shape[0]
    n_blocks = -(-R // BVH_BLOCK)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    visits = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    tests = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    if R == 0:
        return t, tri, visits, tests
    launch = _kernel()
    with torch.cuda.device(dev):
        err = launch(
            pairs.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
            t.data_ptr(), tri.data_ptr(), visits.data_ptr(),
            tests.data_ptr(), tris.shape[0], R,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh_hit kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, tri, visits, tests


def take_stats() -> torch.Tensor | None:
    """The (lanes, visits, tests) counted into STATS since the last call
    (None if no query was counted); STATS starts again from zero."""
    global STATS
    out, STATS = STATS, None
    return out


def _count(lanes: int, visits, tests) -> None:
    global STATS
    if STATS is None or STATS.device != visits.device:
        # A normal tensor even under inference mode (render's), so that a
        # query outside it can still add to it.
        with torch.inference_mode(False):
            STATS = torch.zeros((3,), dtype=torch.int64,
                                device=visits.device)
    STATS[0] += lanes
    STATS[1:] += torch.stack((visits.sum(dtype=torch.int64),
                              tests.sum(dtype=torch.int64)))


def closest_hit_bvh(geom, o, d, max_leaf: int | None = None, *,
                    t_max=None):
    """Closest hit through the BVH kernel (triangles) + brute spheres; the
    engine/intersect.py:brute contract (t == T_FAR on a miss).

    `t_max` ((R,) f32 or None) is the route contract's shadow bound: it is
    accepted and not yet used, so a hit at t >= t_max reads as that hit.
    While a profiler records, the query's lanes, visits and tests are added
    to STATS (module docstring)."""
    if (geom.bvh_nodes.shape[0] != geom.bvh_lo.shape[0]
            or geom.bvh_pairs.shape[0] == 0):
        raise ValueError("the Geometry's packed BVH tables do not match its "
                         "BVH: build it with accel.build.with_bvh")
    with span("bvh", {"rays": o.shape[0]}):
        t, tri, visits, tests = bvh_hit(geom.bvh_nodes, geom.bvh_pairs,
                                        geom.bvh_tris, o.contiguous(),
                                        d.contiguous(), max_leaf)
        if recording():
            _count(o.shape[0], visits, tests)
        return hit_from_index(geom, o, d, t, tri)
