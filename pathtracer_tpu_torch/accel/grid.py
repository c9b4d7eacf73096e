"""Uniform-grid tables for the per-ray DDA intersector (host-side numpy).

The reference's ``accel/grid.py``, array for array. Triangles are binned
into a uniform AXIS^3 grid over the scene box, each triangle DUPLICATED into
every cell its slightly inflated AABB overlaps, so any cell a ray marches
through holds every triangle the ray could hit there. Each cell's triangles
are chunked into <= 128-slot clusters with the feature columns of
accel/clusters.py, and clusters are laid out in morton cell order: one cell
is one contiguous cluster-id range (`cell_start`), and neighbouring cells sit
in neighbouring ranges. ops/intersect_grid.py walks these tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..scene.model import Scene
from .clusters import (
    CLUSTER_TRIS,
    FEAT_ROWS,
    cluster_tables,
    slot_nm_table,
    split_table,
)

# Inflation of triangle AABBs when assigning to cells, relative to the cell
# size: a hit point within fp error of a cell boundary must find its
# triangle in both adjacent cells.
_TRI_PAD_REL = 1e-3
# Grid box inflation so boundary triangles are strictly interior.
_BOX_PAD_REL = 1e-4


@dataclasses.dataclass
class GridSet:
    lo: np.ndarray  # (C, 3) f32 cluster AABB min (cell-chunk boxes)
    hi: np.ndarray  # (C, 3) f32
    feat: np.ndarray  # (16, C*512) f32 feature columns
    tri_map: np.ndarray  # (C*128,) i32 padded slot -> original tri id
    cell_start: np.ndarray  # (AXIS^3 + 1,) i32 morton cell -> cluster range
    grid_lo: np.ndarray  # (3,) f32 grid box min
    cell_size: np.ndarray  # (3,) f32 per-axis cell extent
    axis: int


def morton3_np(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
               bits: int) -> np.ndarray:
    """Interleave 3 x `bits` coordinate bits into a morton id (numpy)."""
    m = np.zeros_like(ix, dtype=np.int64)
    for b in range(bits):
        m |= ((ix >> b) & 1).astype(np.int64) << (3 * b)
        m |= ((iy >> b) & 1).astype(np.int64) << (3 * b + 1)
        m |= ((iz >> b) & 1).astype(np.int64) << (3 * b + 2)
    return m


def pick_axis(n_tris: int) -> int:
    """Cells per axis: the smallest of 4, 8, 16, 32 with at most 4000
    triangles per cell, else 32. This is the reference's rule, kept so that
    both packages build the same grid; its thresholds were tuned on the
    reference's TPU and are not re-measured for the port yet."""
    for axis in (4, 8, 16, 32):
        if n_tris <= 4000 * axis ** 3:
            return axis
    return 32


def build_grid(v0, e1, e2, axis: int | None = None) -> GridSet:
    """Bin triangles into the grid and emit morton-ordered cluster tables."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    T = len(v0)
    if axis is None:
        axis = pick_axis(T)
    bits = max(1, int(axis - 1).bit_length())
    if not (axis == 1 << bits or axis == 1):
        raise ValueError(f"grid axis must be a power of two; got {axis}")
    G = axis ** 3
    if T == 0:
        return GridSet(
            lo=np.zeros((0, 3), np.float32),
            hi=np.zeros((0, 3), np.float32),
            feat=np.zeros((FEAT_ROWS, 0), np.float32),
            tri_map=np.zeros((0,), np.int32),
            cell_start=np.zeros((G + 1,), np.int32),
            grid_lo=np.zeros((3,), np.float32),
            cell_size=np.ones((3,), np.float32),
            axis=axis,
        )
    p1 = v0 + e1
    p2 = v0 + e2
    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    scene_lo = tri_lo.min(0)
    scene_hi = tri_hi.max(0)
    ext = np.maximum(scene_hi - scene_lo, 1e-6)
    pad = _BOX_PAD_REL * ext
    grid_lo = (scene_lo - pad).astype(np.float32)
    cell = ((ext + 2 * pad) / axis).astype(np.float32)

    # Cell coordinate span per triangle, inflated (see module docstring).
    tpad = _TRI_PAD_REL * cell
    c_lo = np.clip(
        np.floor((tri_lo - tpad - grid_lo) / cell).astype(np.int64),
        0, axis - 1,
    )
    c_hi = np.clip(
        np.floor((tri_hi + tpad - grid_lo) / cell).astype(np.int64),
        0, axis - 1,
    )
    span = c_hi - c_lo + 1

    # (cell, tri) pair expansion: triangles spanning <= 2 cells per axis
    # (nearly all) go vectorized over the 8 corner offsets, the rare large
    # spanners (walls, floor) one by one.
    pair_cell: list[np.ndarray] = []
    pair_tri: list[np.ndarray] = []
    small = (span <= 2).all(axis=1)
    idx_small = np.nonzero(small)[0]
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                off = np.array([dx, dy, dz])
                ok = (c_lo[idx_small] + off <= c_hi[idx_small]).all(axis=1)
                ids = idx_small[ok]
                cc = c_lo[ids] + off
                pair_cell.append(morton3_np(cc[:, 0], cc[:, 1], cc[:, 2],
                                            bits))
                pair_tri.append(ids)
    for t in np.nonzero(~small)[0]:
        xs = np.arange(c_lo[t, 0], c_hi[t, 0] + 1)
        ys = np.arange(c_lo[t, 1], c_hi[t, 1] + 1)
        zs = np.arange(c_lo[t, 2], c_hi[t, 2] + 1)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        pair_cell.append(morton3_np(gx.ravel(), gy.ravel(), gz.ravel(),
                                    bits))
        pair_tri.append(np.full((gx.size,), t, np.int64))
    cells = np.concatenate(pair_cell)
    tris = np.concatenate(pair_tri)
    order = np.argsort(cells, kind="stable")
    cells = cells[order]
    tris = tris[order]

    # Chunk each cell's triangle list into <= 128-slot clusters; clusters
    # inherit morton cell order, so a cell is a contiguous cluster range.
    bounds = np.searchsorted(cells, np.arange(G + 1))
    groups: list[np.ndarray] = []
    cell_start = np.zeros((G + 1,), np.int32)
    for g in range(G):
        cell_start[g] = len(groups)
        s, e = bounds[g], bounds[g + 1]
        for k in range(s, e, CLUSTER_TRIS):
            groups.append(tris[k: min(k + CLUSTER_TRIS, e)])
    cell_start[G] = len(groups)

    cs = cluster_tables(groups, v0, e1, e2)
    return GridSet(
        lo=cs.lo, hi=cs.hi, feat=cs.feat, tri_map=cs.tri_map,
        cell_start=cell_start, grid_lo=grid_lo, cell_size=cell,
        axis=axis,
    )


def with_grid(scene: Scene, axis: int | None = None) -> Scene:
    """Scene with uniform-grid cluster tables attached to its Geometry.

    The grid's clusters fill the cl_* fields (they are a valid cluster
    decomposition: a duplicated triangle is idempotent under the closest-hit
    min), plus the gr_* DDA tables. Super-cluster tables described the
    previous decomposition and are cleared.
    """
    g = scene.geometry
    gs = build_grid(g.tri_v0.cpu().numpy(), g.tri_e1.cpu().numpy(),
                    g.tri_e2.cpu().numpy(), axis)
    g2 = g.replace(
        cl_lo=gs.lo, cl_hi=gs.hi, cl_feat=gs.feat, cl_map=gs.tri_map,
        cl_feat_split=split_table(gs.feat),
        gr_cell_start=gs.cell_start, gr_lo=gs.grid_lo, gr_cell=gs.cell_size,
        cl_slot_nm=slot_nm_table(gs.tri_map, g.tri_n.cpu().numpy(),
                                 g.tri_mat.cpu().numpy()),
        su_lo=np.zeros((0, 3), np.float32),
        su_hi=np.zeros((0, 3), np.float32),
        cl_super=np.zeros((0,), np.int32),
    )
    return scene.replace(geometry=g2)


def check_grid_invariants(gs: GridSet, tri_lo: np.ndarray,
                          tri_hi: np.ndarray) -> None:
    """Structural invariants; raises AssertionError on a violation."""
    G = gs.axis ** 3
    assert gs.cell_start.shape == (G + 1,)
    assert (np.diff(gs.cell_start) >= 0).all()
    n_clusters = int(gs.cell_start[-1])
    assert gs.feat.shape[1] == n_clusters * 512
    assert gs.tri_map.shape == (n_clusters * CLUSTER_TRIS,)
    T = len(tri_lo)
    seen = np.zeros((T,), bool)
    seen[gs.tri_map[gs.tri_map >= 0]] = True
    assert seen.all(), "every triangle appears in >= 1 cell"
    # Every triangle covers every cell its (un-inflated) box overlaps.
    cell = gs.cell_size
    bits = max(1, int(gs.axis - 1).bit_length())
    rng = np.random.default_rng(0)
    sample = rng.choice(T, size=min(T, 200), replace=False)
    slot_cluster = np.arange(len(gs.tri_map)) // CLUSTER_TRIS
    # cluster -> morton cell (inverse of the cell_start ranges)
    cl_cell = np.searchsorted(gs.cell_start, np.arange(n_clusters),
                              side="right") - 1
    for t in sample:
        c_lo = np.clip(np.floor((tri_lo[t] - gs.grid_lo) / cell), 0,
                       gs.axis - 1).astype(np.int64)
        c_hi = np.clip(np.floor((tri_hi[t] - gs.grid_lo) / cell), 0,
                       gs.axis - 1).astype(np.int64)
        slots = np.nonzero(gs.tri_map == t)[0]
        have = set(cl_cell[slot_cluster[slots]].tolist())
        for x in range(c_lo[0], c_hi[0] + 1):
            for y in range(c_lo[1], c_hi[1] + 1):
                for z in range(c_lo[2], c_hi[2] + 1):
                    m = int(morton3_np(np.int64(x), np.int64(y),
                                       np.int64(z), bits))
                    assert m in have, (t, (x, y, z))
