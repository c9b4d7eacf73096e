"""BVH closest hit: the skip-link walk as a hand-written CUDA kernel.

The counterpart of the reference's ``ops/traverse_pallas.py``. The TPU
kernel walks the BVH with one cursor shared by a 512-ray block, because
Mosaic cannot gather per lane; on Hopper each thread walks its own ray
with its own cursor (``csrc/traverse_bvh.cu``). Both compute what
accel/traverse.py computes: per ray the closest t and its triangle, in the
same visit order and with the same tie-breaks.

The kernel reads the BVH from two tables packed once per scene by
``pack_tables`` (accel/build.py:with_bvh stores them on the Geometry as
``bvh_nodes`` and ``bvh_tris``), so that a node is two 16-byte loads and a
triangle three:

  bvh_nodes (N, 8) f32: [lo(3), skip, hi(3), first * 8 + count], the two
      int words stored as their int32 bits;
  bvh_tris (T, 12) f32: [v0(3), e1(3), e2(3), 0, 0, 0].

On a CPU tensor ``bvh_hit`` runs ``bvh_hit_plain``, which unpacks the
tables and runs accel/traverse.py:walk; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.traverse import CHUNK, hit_from_index, walk
from . import _build
from .boundary import no_gradient

NODE_WORDS = 8
TRI_WORDS = 12
MAX_LEAF_COUNT = 7  # count lives in the low 3 bits of the leaf word
BVH_BLOCK = 256  # rays per CUDA block; visits are summed per block

# Kernel launches through bvh_hit (CUDA tensors only).
LAUNCHES = 0


def pack_tables(lo, hi, first, count, skip, v0, e1, e2):
    """(bvh_nodes, bvh_tris) numpy tables from the skip-link arrays (see
    the module docstring). Raises on links the kernel cannot walk: a count
    above 7, a leaf outside the triangles, or a skip that does not move
    forward (the walk's termination)."""
    lo = np.asarray(lo, np.float32).reshape(-1, 3)
    n = len(lo)
    if n == 0:  # no BVH: nothing to walk
        return (np.zeros((0, NODE_WORDS), np.float32),
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
    nodes[:, 4:7] = np.asarray(hi, np.float32).reshape(-1, 3)
    words = nodes.view(np.int32)
    words[:, 3] = skip
    words[:, 7] = np.where(leaf, first * 8 + count, 0)
    return nodes, tris


def unpack_tables(nodes, tris):
    """The walk's arrays (lo, hi, first, count, skip, v0, e1, e2) from the
    packed tables."""
    skip = nodes[:, 3].contiguous().view(torch.int32)
    leaf = nodes[:, 7].contiguous().view(torch.int32)
    return (nodes[:, 0:3], nodes[:, 4:7], leaf >> 3, leaf & 7, skip,
            tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])


def _check_inputs(nodes, tris, o, d):
    for name, x, width in (("bvh_nodes", nodes, NODE_WORDS),
                           ("bvh_tris", tris, TRI_WORDS), ("o", o, 3),
                           ("d", d, 3)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != width:
            raise ValueError(f"{name} must be float32 (n, {width}); got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodes.shape[0] == 0 or tris.shape[0] == 0:
        raise ValueError("empty BVH tables: build the scene with "
                         "accel.build.with_bvh")
    if d.shape[0] != o.shape[0]:
        raise ValueError(f"o and d differ in length: {o.shape[0]} vs "
                         f"{d.shape[0]}")


def _block_sums(visits):
    pad = (-visits.shape[0]) % BVH_BLOCK
    v = torch.cat([visits, visits.new_zeros((pad,))])
    return v.reshape(-1, BVH_BLOCK).sum(dim=1).to(torch.int32)


def bvh_hit_plain(nodes, tris, o, d, max_leaf: int = 4, chunk: int = CHUNK):
    """Plain PyTorch version of the BVH kernel's contract.

    Args:
      nodes, tris: the packed tables (module docstring).
      o, d: (R, 3) f32 ray origins and directions.
      max_leaf: triangles tested per leaf at most (the reference's 4).
      chunk: rays per walk chunk (changes only memory and time).

    Returns (t, tri, visits): (R,) f32 closest t (T_FAR on a miss), (R,)
    i32 triangle index (-1 on a miss), (ceil(R / 256),) i32 nodes visited
    by the rays of each 256-ray block.
    """
    _check_inputs(nodes, tris, o, d)
    t, tri, visits = walk(*unpack_tables(nodes, tris), o, d, max_leaf, chunk)
    return t, tri, _block_sums(visits)


def _kernel():
    fn = _build.load("traverse_bvh").bvh_hit_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bvh_hit(nodes, tris, o, d, max_leaf: int = 4):
    """Closest triangle of every ray by the BVH walk (see bvh_hit_plain).

    CPU tensors run the plain version. CUDA tensors launch the CUDA kernel
    (built at first use) on the current stream, one thread per ray, and
    count the launch in LAUNCHES; a failed launch raises.
    An autograd boundary (ops/boundary.py): no gradient flows back.
    """
    return no_gradient(_bvh_hit, nodes, tris, o, d, max_leaf)


def _bvh_hit(nodes, tris, o, d, max_leaf: int = 4):
    global LAUNCHES
    _check_inputs(nodes, tris, o, d)
    dev = o.device
    if dev.type == "cpu":
        return bvh_hit_plain(nodes, tris, o, d, max_leaf)
    if dev.type != "cuda":
        raise ValueError(f"bvh_hit runs on cpu or cuda, not {dev}")
    if not 1 <= max_leaf <= MAX_LEAF_COUNT:
        raise ValueError(f"max_leaf must be in 1..7; got {max_leaf}")
    if nodes.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("bvh_nodes and bvh_tris must be 16-byte aligned")
    R = o.shape[0]
    n_blocks = -(-R // BVH_BLOCK)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    visits = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    if R == 0:
        return t, tri, visits
    launch = _kernel()
    with torch.cuda.device(dev):
        err = launch(
            nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
            t.data_ptr(), tri.data_ptr(), visits.data_ptr(), nodes.shape[0],
            tris.shape[0], R, max_leaf,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh_hit kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, tri, visits


def closest_hit_bvh(geom, o, d, max_leaf: int = 4):
    """Closest hit through the BVH kernel (triangles) + brute spheres; the
    engine/intersect.py:brute contract (t == T_FAR on a miss)."""
    if geom.bvh_nodes.shape[0] != geom.bvh_lo.shape[0]:
        raise ValueError("the Geometry's packed BVH tables do not match its "
                         "BVH: build it with accel.build.with_bvh")
    t, tri, _ = bvh_hit(geom.bvh_nodes, geom.bvh_tris, o.contiguous(),
                        d.contiguous(), max_leaf)
    return hit_from_index(geom, o, d, t, tri)
