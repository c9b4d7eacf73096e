"""Per-ray DDA grid intersection: the large-scene (config 5) intersector.

The reference's ``ops/intersect_grid.py`` in two parts:

  glue (plain PyTorch): every ray marches the uniform grid of accel/grid.py
      front to back (`dda_cells`, Amanatides-Woo in lockstep); its next few
      cells become (ray, cell) PAIRS, sorted by cell so that each block of
      consecutive pairs shares a few morton-adjacent cells. A block's
      candidate list is the concatenation of its distinct cells' cluster
      ranges. Pair results min-combine back to rays, and a ray retires
      once its best hit is nearer than its next cell's entry. One
      phase at full width (stage A) covers every ray's first cells; the
      rays still live then continue in eras over their next cells.

  fine test (`pair_hit`): per block of pairs, every cluster of the block's
      candidate list is tested against every pair of the block, with no
      early exit, on the split table (``Geometry.cl_feat_split``): each
      visit's product is the reference's bf16 hi/lo split, as its kernel
      computes it. On a CUDA tensor this launches the hand-written kernel
      in ``csrc/intersect_pair.cu``; on a CPU tensor it runs
      `pair_hit_plain`.

Where the reference is shaped by jit and the TPU, the port is eager: the
DDA scan is a Python loop over 3*axis steps; phases drop the pairs of cells
a ray does not have instead of padding them; an era takes exactly the live
rays, up to a capacity that bounds memory, instead of a fixed ladder size;
each block's candidates are one CSR list walked in one launch instead of
K-candidate rounds through an (8, K) window; and there is no packed
``start << 15 | len`` gather or feature-row gather mode.

Exactness: accel/grid.py duplicates every triangle into every cell its
inflated box overlaps, the DDA enumerates every cell a ray crosses within
[T_MIN, t_max] in order of entry, and a ray retires only when its best hit
lies before the (conservatively shrunk) entry of the next cell, so every
nearer triangle was in a cell already walked. All per-ray arithmetic is
elementwise (the ray features are built once per call), so no knob (stage-A
width, era width, ladder, occupied windows, pair-block width) changes t,
and the normal and material change only where two different triangles tie
at exactly equal t. Rays with t_max <= 2*T_MIN are no-ops (the engine's
dead-lane form).
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..engine.intersect import merge_spheres
from ..utils.profiling import host_read, span
from . import _build
from .boundary import no_gradient
from .intersect_cluster import (
    RAY_FEATS,
    _FEAT_USED,
    check_bulk_aligned,
    check_table,
    decode_winner,
    ray_features,
    visit_split_plain,
)

# Entry distance of invalid DDA steps (finite, far above any real t).
_ENTRY_INF = 3.0e37
# Conservative margin on entry distances: a computed entry can exceed the
# true one by fp rounding; shrinking it can only add work.
_ENTRY_REL = 1.0 - 1e-4
_ENTRY_ABS = 1e-6
# Cells per era (the reference's default era width) and cells of the
# full-width first phase (stage A). Both are performance knobs.
PHASE_STEPS = 4
FIRST_STEPS = 4
# Pairs per kernel block (the kernel gives each 64 pairs a warp), a
# multiple of 32 up to 512. pair_candidates and the kernel wrappers take
# PAIR_BLOCK by default; closest_hit_grid adapts the width per phase
# (_auto_pair_block). The reference's (1024,) ladder was measured on its
# TPU; these widths are the port's choice, not yet tuned on the H100.
PAIR_BLOCK = 512
_MIN_PAIR_BLOCK = 32
_MAX_PAIR_BLOCK = 512

# Kernel launches through pair_hit (CUDA tensors only).
LAUNCHES = 0


def pack_occupancy(cell_start: torch.Tensor) -> torch.Tensor:
    """(n_cells+1,) cluster-range starts -> (ceil(n/32),) i32 bitmask.

    Bit c%32 of word c//32 is 1 iff cell c has a non-empty cluster range.
    Words with bit 31 set are negative (two's complement); arithmetic
    shifts still read every bit exactly.
    """
    occ = (cell_start[1:] > cell_start[:-1]).to(torch.int64)
    pad = (-occ.shape[0]) % 32
    if pad:
        occ = torch.cat([occ, occ.new_zeros((pad,))])
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    words = (occ.reshape(-1, 32) << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


def grid_axis(geom) -> int:
    """Cells per axis, inferred from the gr_cell_start table length."""
    G = int(geom.gr_cell_start.shape[0]) - 1
    axis = round(G ** (1.0 / 3.0))
    if axis ** 3 != G:
        raise ValueError(f"gr_cell_start holds {G} cells, not a cube")
    return axis


def _morton3(ix, iy, iz, bits: int):
    m = torch.zeros_like(ix)
    for b in range(bits):
        m = m | (((ix >> b) & 1) << (3 * b))
        m = m | (((iy >> b) & 1) << (3 * b + 1))
        m = m | (((iz >> b) & 1) << (3 * b + 2))
    return m


def dda_cells(o, d, t_max, grid_lo, cell, axis: int,
              length: int | None = None, occ_words=None):
    """Lockstep 3D-DDA: each ray's cells front to back, all rays at once.

    Returns (cells, entry), both (S, R) with S = 3*axis (or `length`, the
    first steps only):
      cells: i32 morton cell ids, -1 past the ray's last cell
      entry: f32 distance at which the ray enters that cell (_ENTRY_INF for
             invalid steps; nondecreasing along S)
    With `occ_words` (a pack_occupancy bitmask) it also returns oidx (S, R)
    i32: the index of step s's cell among the ray's occupied cells, or -1
    for invalid and empty-cell steps.

    A ray contributes cells only while entry < t_max; rays with
    t_max <= 2*T_MIN contribute none. Every output is elementwise in
    (o, d, t_max), so a ray gets the same bits in any batch. The operations
    run in the reference's order (1/d, then (lo - o)*inv, the probe nudge,
    then the floor), so cells equal the reference's.
    """
    S = 3 * axis if length is None else length
    bits = max(1, int(axis - 1).bit_length())
    tiny = 1e-20
    dd = torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / dd
    grid_hi = grid_lo + cell * axis
    t0 = (grid_lo[None, :] - o) * inv
    t1 = (grid_hi[None, :] - o) * inv
    t_en = torch.clamp(torch.minimum(t0, t1).max(dim=-1).values, min=C.T_MIN)
    t_ex = torch.maximum(t0, t1).min(dim=-1).values
    tm = t_max.to(torch.float32)
    alive = (t_ex >= t_en) & (t_en < tm) & (tm > 2 * C.T_MIN)

    # Probe a point strictly inside the first cell. The nudge is capped by a
    # quarter of the fastest per-axis cell crossing, so a far origin cannot
    # push the probe past the entry cell.
    dt = (cell[None, :] * inv).abs()  # (R, 3) per-axis crossing time
    dt_min = dt.min(dim=-1).values
    t_probe = t_en + torch.minimum(t_en * 1e-6 + 1e-7, 0.25 * dt_min)
    p = o + d * t_probe[:, None]
    c = torch.clamp(
        torch.floor((p - grid_lo[None, :]) / cell[None, :]).to(torch.int32),
        0, axis - 1,
    )  # (R, 3)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    nxt = c + (d >= 0).to(torch.int32)
    t_next = (grid_lo[None, :] + nxt.to(torch.float32) * cell[None, :]
              - o) * inv  # (R, 3)

    t_cur = t_en
    occ_cnt = torch.zeros_like(c[:, 0])
    cells, entries, oidxs = [], [], []
    for _ in range(S):
        m = _morton3(c[:, 0], c[:, 1], c[:, 2], bits)
        cells.append(torch.where(alive, m, -1))
        entries.append(torch.where(alive, t_cur, _ENTRY_INF))
        if occ_words is not None:
            word = occ_words[(m >> 5).to(torch.int64)]
            is_occ = alive & (((word >> (m & 31)) & 1) == 1)
            oidxs.append(torch.where(is_occ, occ_cnt, -1))
            occ_cnt = occ_cnt + is_occ.to(torch.int32)
        # Advance to the nearest axis boundary; ties go to the lowest axis,
        # one axis at a time (the skipped diagonal neighbour is covered by
        # the triangle box inflation). The reference's cumsum(is_min) == 1
        # written out for 3 axes: a scan over a width-3 axis took 27% of
        # the config-5 frame's device time on the H100.
        t_step = t_next.min(dim=-1).values
        m0, m1, m2 = (t_next <= t_step[:, None]).unbind(dim=-1)
        adv = torch.stack([m0, m1 & ~m0, m2 & ~(m0 | m1)], dim=-1) \
            .to(torch.int32)
        c = c + step * adv
        t_next = t_next + dt * adv.to(torch.float32)
        out = ((c < 0) | (c >= axis)).any(dim=-1)
        alive = alive & ~out & (t_step < tm)
        t_cur = t_step
    outs = (torch.stack(cells), torch.stack(entries))
    if occ_words is not None:
        outs = outs + (torch.stack(oidxs),)
    return outs


def _window(cells, entry, oidx, ptr, width: int):
    """Each ray's occupied cells [ptr, ptr+width) from a full DDA:
    (R, width) cells and entries, -1 / _ENTRY_INF past the end."""
    R = ptr.shape[0]
    rel = oidx - ptr[None, :]
    with host_read("window.nonzero"):
        s, r = torch.nonzero((oidx >= 0) & (rel >= 0) & (rel < width),
                             as_tuple=True)
    cw = torch.full((R, width), -1, dtype=torch.int32, device=ptr.device)
    ew = torch.full((R, width), _ENTRY_INF, dtype=torch.float32,
                    device=ptr.device)
    cw[r, rel[s, r]] = cells[s, r]
    ew[r, rel[s, r]] = entry[s, r]
    return cw, ew


def _step_window(cells, entry, ptr, width: int):
    """Each ray's DDA steps [ptr, ptr+width): (R, width) cells and entries,
    -1 / _ENTRY_INF past the computed steps."""
    L = cells.shape[0]
    cols = ptr[:, None].to(torch.int64) + torch.arange(
        width, dtype=torch.int64, device=ptr.device)[None, :]
    ok = cols < L
    idx = torch.clamp(cols, max=L - 1)
    cw = torch.where(ok, cells.T.gather(1, idx), -1)
    ew = torch.where(ok, entry.T.gather(1, idx), _ENTRY_INF)
    return cw, ew


def pair_candidates(cell_s: torch.Tensor, cell_start: torch.Tensor,
                    pair_block: int = PAIR_BLOCK):
    """CSR candidate lists of the blocks of cell-sorted pairs.

    Block b holds sorted pairs [b*pair_block, (b+1)*pair_block). Its list is
    the concatenation, in pair order, of the cluster ranges of its distinct
    cells (the first pair of each run of equal cells). Returns (offsets,
    cand): (Bp+1,) i32 with block b's list at cand[offsets[b]:offsets[b+1]],
    and the (N,) i32 cluster ids.
    """
    P = cell_s.shape[0]
    dev = cell_s.device
    Bp = -(-P // pair_block)
    i = torch.arange(P, device=dev)
    first = i % pair_block == 0
    first[1:] |= cell_s[1:] != cell_s[:-1]
    with host_read("bin.nonzero"):
        seg_pos = torch.nonzero(first).squeeze(1)
    seg_cell = cell_s[seg_pos].to(torch.int64)
    seg_start = cell_start[seg_cell].to(torch.int64)
    seg_len = cell_start[seg_cell + 1].to(torch.int64) - seg_start
    block_total = torch.zeros((Bp,), dtype=torch.int64, device=dev)
    block_total.index_add_(0, seg_pos // pair_block, seg_len)
    offsets = torch.cat([block_total.new_zeros((1,)),
                         torch.cumsum(block_total, dim=0)])
    with host_read("bin.total"):
        total = int(offsets[-1])
    seg_first = torch.cumsum(seg_len, dim=0) - seg_len
    cand = torch.repeat_interleave(seg_start - seg_first, seg_len,
                                   output_size=total) \
        + torch.arange(total, device=dev)
    return offsets.to(torch.int32), cand.to(torch.int32)


def _check_pair_inputs(offsets, cand, pair_ray, rayf, feat, pair_block):
    """Raises ValueError on malformed inputs; feat is the split table."""
    if not (_MIN_PAIR_BLOCK <= pair_block <= _MAX_PAIR_BLOCK
            and pair_block % 32 == 0):
        raise ValueError(f"pair_block must be a multiple of 32 in "
                         f"[{_MIN_PAIR_BLOCK}, {_MAX_PAIR_BLOCK}]; got "
                         f"{pair_block}")
    for name, x, dtype, dim in (("offsets", offsets, torch.int32, 1),
                                ("cand", cand, torch.int32, 1),
                                ("pair_ray", pair_ray, torch.int32, 1),
                                ("rayf", rayf, torch.float32, 2)):
        if x.dtype != dtype or x.dim() != dim:
            raise ValueError(f"{name} must be {dim}-d {dtype}; got {x.dtype} "
                             f"{tuple(x.shape)}")
    P = pair_ray.shape[0]
    if offsets.shape[0] != -(-P // pair_block) + 1:
        raise ValueError(f"offsets must hold ceil({P}/{pair_block})+1 "
                         f"entries; got {offsets.shape[0]}")
    if rayf.shape[0] != RAY_FEATS or (P and rayf.shape[1] == 0):
        raise ValueError(f"rayf must be ({RAY_FEATS}, R) with R >= 1; got "
                         f"{tuple(rayf.shape)}")
    check_table(feat)
    for name, x in (("offsets", offsets), ("cand", cand),
                    ("pair_ray", pair_ray), ("rayf", rayf), ("feat", feat)):
        if x.device != rayf.device:
            raise ValueError(f"{name} is on {x.device}, rayf on {rayf.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pair_hit_plain(offsets, cand, pair_ray, rayf, feat,
                   pair_block: int = PAIR_BLOCK, chunk_blocks: int = 256):
    """Plain PyTorch version of the pair kernel's contract.

    Args:
      offsets: (Bp+1,) i32 CSR offsets, Bp = ceil(P / pair_block): block b
        (pairs [b*pair_block, (b+1)*pair_block)) walks cand[offsets[b]:
        offsets[b+1]].
      cand: (N,) i32 cluster ids.
      pair_ray: (P,) i32 column of each pair's ray in rayf.
      rayf: (11, R) f32 per-ray features; row 10 is each ray's current best
        t, the pair's initial bound.
      feat: (C, 512, 32) bf16 split table: each visit is the split product
        (intersect_cluster.visit_split_plain).

    Returns (t, slot, visits): (P,) f32 best t per pair (row 10 of its ray
    where nothing nearer), (P,) i32 winning padded slot cid*128 + row or -1,
    (Bp,) i32 clusters tested per block. Every pair of a block tests every
    cluster of the block's list; ties keep the lower row, then the earlier
    visit.
    """
    _check_pair_inputs(offsets, cand, pair_ray, rayf, feat, pair_block)
    return pair_walk_plain(offsets, cand, pair_ray, rayf, feat,
                           visit_split_plain, pair_block, chunk_blocks)


def pair_walk_plain(offsets, cand, pair_ray, rayf, by_cluster, visit,
                    pair_block: int = PAIR_BLOCK, chunk_blocks: int = 256):
    """pair_hit_plain's walk with the visit `visit` over `by_cluster`, the
    table indexed by cluster id that it takes (see
    intersect_cluster.walk_candidates_plain); inputs are not checked."""
    dev = rayf.device
    P = pair_ray.shape[0]
    Bp = offsets.shape[0] - 1
    n_clusters = by_cluster.shape[0]
    count = (offsets[1:] - offsets[:-1]).to(torch.int64)
    ray = torch.clamp(pair_ray.to(torch.int64), 0, rayf.shape[1] - 1)
    ray = torch.cat([ray, ray.new_zeros((Bp * pair_block - P,))])
    rays = rayf[:_FEAT_USED, ray].T.reshape(Bp, pair_block, _FEAT_USED)
    t_best = rayf[_FEAT_USED, ray].reshape(Bp, pair_block).clone()
    best = torch.full((Bp, pair_block), -1, dtype=torch.int32, device=dev)
    start = offsets[:-1].to(torch.int64)
    last = max(cand.shape[0] - 1, 0)
    for b0 in range(0, Bp, chunk_blocks):
        b1 = min(Bp, b0 + chunk_blocks)
        nc = count[b0:b1]
        for k in range(int(nc.max())):
            pos = torch.clamp(start[b0:b1] + k, max=last)
            cid = torch.clamp(cand[pos].to(torch.int64), 0, n_clusters - 1)
            visit(rays[b0:b1], by_cluster[cid], cid, k < nc, t_best[b0:b1],
                  best[b0:b1])
    return (t_best.reshape(-1)[:P], best.reshape(-1)[:P],
            count.to(torch.int32))


def _kernel():
    fn = _build.load("intersect_pair").pair_hit_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pair_hit(offsets, cand, pair_ray, rayf, feat,
             pair_block: int = PAIR_BLOCK):
    """Closest hit of every (ray, cell) pair over its block's candidate
    list (see pair_hit_plain), on the split table `feat`
    (Geometry.cl_feat_split).

    CPU tensors run the plain version. CUDA tensors launch the CUDA kernel
    (built at first use) on the current stream, one CTA of a warp per 64
    pairs per pair block, and count the launch in LAUNCHES; a failed
    launch raises.
    An autograd boundary (ops/boundary.py): no gradient flows back.
    """
    return no_gradient(_pair_hit, offsets, cand, pair_ray, rayf, feat,
                       pair_block)


def _pair_hit(offsets, cand, pair_ray, rayf, feat,
              pair_block: int = PAIR_BLOCK):
    global LAUNCHES
    _check_pair_inputs(offsets, cand, pair_ray, rayf, feat, pair_block)
    dev = rayf.device
    if dev.type == "cpu":
        return pair_hit_plain(offsets, cand, pair_ray, rayf, feat, pair_block)
    if dev.type != "cuda":
        raise ValueError(f"pair_hit runs on cpu or cuda, not {dev}")
    P = pair_ray.shape[0]
    Bp = offsets.shape[0] - 1
    t = torch.empty((P,), dtype=torch.float32, device=dev)
    slot = torch.empty((P,), dtype=torch.int32, device=dev)
    visits = torch.empty((Bp,), dtype=torch.int32, device=dev)
    if Bp == 0:
        return t, slot, visits
    check_bulk_aligned(feat)
    launch = _kernel()
    with torch.cuda.device(dev):
        err = launch(
            offsets.data_ptr(), cand.data_ptr(), pair_ray.data_ptr(),
            rayf.data_ptr(), feat.data_ptr(), t.data_ptr(), slot.data_ptr(),
            visits.data_ptr(), Bp, pair_block, P, feat.shape[0],
            rayf.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_hit kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, slot, visits


def _auto_pair_block(n_pairs: int, n_cells: int) -> int:
    """Pair-block width for a phase: the largest power of two within
    [32, 512] not above the mean pairs per cell. Every pair of a block
    tests every cluster of every cell the block straddles, so a block much
    wider than a cell's pairs multiplies the work; a dense phase (config
    5's stage A: ~8k pairs per cell) takes the full 512."""
    target = n_pairs // max(n_cells, 1)
    pb = _MIN_PAIR_BLOCK
    while pb * 2 <= min(target, _MAX_PAIR_BLOCK):
        pb *= 2
    return pb


def _phase(cellsW, ray_ids, rayf, idx_best, cell_start, feat,
           pair_block: int | None):
    """One pair phase over rays `ray_ids` and their cells `cellsW` (Rx, W),
    -1 for none. Updates the rays' best t (rayf row 10) and slot
    (idx_best) in place; returns the pair kernel's visit total."""
    Rx, W = cellsW.shape
    flat = cellsW.reshape(-1)
    with span("grid.bin"):
        with host_read("phase.nonzero"):
            # Ray-major pair positions.
            pos = torch.nonzero(flat >= 0).squeeze(1)
        if pos.numel() == 0:
            return 0
        if pair_block is None:
            pair_block = _auto_pair_block(pos.numel(),
                                          cell_start.shape[0] - 1)
        cell_s, order = torch.sort(flat[pos], stable=True)
        pos_s = pos[order]
        pair_ray = ray_ids[pos_s // W].to(torch.int32)
        offsets, cand = pair_candidates(cell_s, cell_start, pair_block)
    with span("grid.k2"):
        t_pair, slot_pair, visits = pair_hit(offsets, cand, pair_ray, rayf,
                                             feat, pair_block)
    with span("grid.combine"):
        # Min-combine pair results back to rays: scatter to the dense
        # (Rx, W) pair grid (positions are unique), then a row min; ties
        # take the largest slot among equal t (the reference's rule).
        t_rw = torch.full((Rx * W,), C.T_FAR, dtype=torch.float32,
                          device=flat.device)
        idx_rw = torch.full((Rx * W,), -1, dtype=torch.int32,
                            device=flat.device)
        t_rw[pos_s] = t_pair
        idx_rw[pos_s] = slot_pair
        t_rw = t_rw.reshape(Rx, W)
        idx_rw = idx_rw.reshape(Rx, W)
        t_from = t_rw.min(dim=1).values
        idx_from = torch.where(t_rw == t_from[:, None], idx_rw, -1) \
            .max(dim=1).values
        t_best = rayf[_FEAT_USED]
        t_old = t_best[ray_ids]
        improved = (t_from < t_old) & (idx_from >= 0)
        t_best[ray_ids] = torch.where(improved, t_from, t_old)
        idx_best[ray_ids] = torch.where(improved, idx_from,
                                        idx_best[ray_ids])
        return visits.to(torch.int64).sum()


def _ladder_sizes(R: int, ladder, staged: bool) -> list[int]:
    if ladder is None:
        ladder = (4, 16) if staged else (2, 8, 32)
    ladder = tuple(ladder)
    if not ladder or any(not isinstance(v, int) or v < 1 for v in ladder) \
            or list(ladder) != sorted(ladder):
        raise ValueError("ladder must be a nonempty nondecreasing tuple of "
                         f"positive int divisors; got {ladder!r}")
    return [max(1, R // div) for div in ladder]


def closest_hit_grid(geom, o, d, t_max=None,
                     first_steps: int = FIRST_STEPS,
                     era_steps: int = PHASE_STEPS,
                     ladder: tuple[int, ...] | None = None,
                     occupied_windows: bool | None = None,
                     pair_block: int | None = None,
                     stats: bool = False):
    """Closest hit through the grid tables: (t, n_geom, mat), t == T_FAR on
    a miss (the engine/intersect.py:brute contract).

    t_max: optional (R,) per-ray bound; hits at t >= t_max[i] may read as
    misses, hits strictly nearer are found; rays with t_max <= 2*T_MIN are
    no-ops. Needs grid tables (accel/grid.py:with_grid).

    Performance knobs, none of which changes the result (module docstring):
      first_steps: cells of the full-width first phase (stage A); 0 skips
        it (ladder-only mode, for calls where most lanes are dead).
      era_steps: cells per era.
      ladder: era capacities as divisors of R, nondecreasing: an era takes
        the first R // ladder[i] live rays, and the ladder moves to level
        i+1 once the live rays fit it (default (4, 16), or (2, 8, 32)
        without stage A).
      occupied_windows: windows count occupied cells only, skipping empty
        ones (default: on when the grid has fewer than 8 clusters per
        cell).
      pair_block: pairs per kernel block (default: per phase, by
        _auto_pair_block).
    stats=True also returns a dict: eras, live_after_phase0, n_phases,
    era_rays (the first level's capacity) and visits (pair-kernel cluster
    visits of the call).
    """
    if geom.gr_cell_start.shape[0] <= 1:
        raise ValueError("no grid tables: call accel.auto.prepare_accel "
                         "(or accel.grid.with_grid) first")
    We = era_steps
    if We < 1 or first_steps < 0:
        raise ValueError(f"need era_steps >= 1 and first_steps >= 0; got "
                         f"{We}, {first_steps}")
    with span("grid"):
        return _walk(geom, o, d, t_max, first_steps, We, ladder,
                     occupied_windows, pair_block, stats)


def _walk(geom, o, d, t_max, first_steps, We, ladder, occupied_windows,
          pair_block, stats):
    """closest_hit_grid's walk (its arguments checked)."""
    axis = grid_axis(geom)
    dev = o.device
    R = o.shape[0]
    S = 3 * axis
    n_cells = axis ** 3
    grid_lo, grid_cell = geom.gr_lo, geom.gr_cell
    cell_start = geom.gr_cell_start
    feat = geom.cl_feat_split
    n_clusters = feat.shape[0]
    t_cap = (torch.full((R,), C.T_FAR, dtype=torch.float32, device=dev)
             if t_max is None else t_max.to(torch.float32))
    # Row 10 carries each ray's current best t: the pair kernel's initial
    # bound, updated in place by every phase.
    rayf = ray_features(o, d, t_cap)
    t_best = rayf[_FEAT_USED]
    idx_best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if occupied_windows is None:
        occupied_windows = n_clusters < 8 * n_cells
    ow = pack_occupancy(cell_start) if occupied_windows else None
    dda = dict(grid_lo=grid_lo, cell=grid_cell, axis=axis, occ_words=ow)

    # ---- stage A: one phase over every ray's first W0 cells ----
    W0 = min(first_steps, S)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    every = torch.arange(R, device=dev)
    if W0 > 0:
        with span("grid.stage_a"):
            with span("grid.dda"):
                if ow is not None:
                    cells0, entry0, oidx0 = dda_cells(o, d, t_cap, **dda)
                    cellsA, entryA = _window(cells0, entry0, oidx0,
                                             torch.zeros_like(idx_best),
                                             W0 + 1)
                    done0 = cellsA[:, 0] < 0  # no occupied cell at all
                    cellsW0 = torch.where(done0[:, None], -1, cellsA[:, :W0])
                    next_cell0 = cellsA[:, W0]
                    next_entry0 = entryA[:, W0]
                else:
                    L0 = min(W0 + 1, S)
                    cells0, entry0 = dda_cells(o, d, t_cap, length=L0, **dda)
                    # No cells: missed grid or dead lane.
                    done0 = cells0[0] < 0
                    cellsW0 = torch.where(done0[:, None], -1, cells0[:W0].T)
                    if L0 > W0:
                        next_cell0 = cells0[W0]
                        next_entry0 = entry0[W0]
                    else:  # W0 covers the whole grid: nothing can remain
                        next_cell0 = torch.full_like(idx_best, -1)
                        next_entry0 = torch.full_like(t_best, _ENTRY_INF)
            visits = visits + _phase(cellsW0, every, rayf, idx_best,
                                     cell_start, feat, pair_block)
            resolved0 = t_best <= next_entry0 * _ENTRY_REL - _ENTRY_ABS
            done = done0 | (next_cell0 < 0) | resolved0
    else:
        # Dead lanes and grid misses only; a ray whose path holds no
        # occupied cell retires after its first era.
        with span("grid.dda"):
            done = dda_cells(o, d, t_cap, length=1, **dda)[0][0] < 0
    ptr = torch.full((R,), W0, dtype=torch.int32, device=dev)

    # ---- stage B: eras over the live rays ----
    sizes = _ladder_sizes(R, ladder, W0 > 0)
    n_phases = -(-S // We)
    with host_read("era.live"):
        live = torch.nonzero(~done).squeeze(1)
    live_a = live.numel()
    # Every era advances each ray it takes by We cells, and a ray retires
    # after at most n_phases eras, so this bound is never reached by a
    # correct walk.
    max_eras = live_a * n_phases + 1
    level = 0
    eras = 0
    while live.numel():
        if eras >= max_eras:
            raise RuntimeError(f"grid era walk did not finish in {max_eras} "
                               "eras")
        while level + 1 < len(sizes) and live.numel() <= sizes[level + 1]:
            level += 1
        sel = live[:sizes[level]]
        with span("grid.era", {"era": eras, "rays": sel.shape[0]}):
            o_s, d_s, tm_s = o[sel], d[sel], t_cap[sel]
            ptr_s = ptr[sel]
            with span("grid.dda"):
                if ow is not None:
                    cells_e, entry_e, oidx_e = dda_cells(o_s, d_s, tm_s,
                                                         **dda)
                    cellsW_p, entryW_p = _window(cells_e, entry_e, oidx_e,
                                                 ptr_s, We + 1)
                else:
                    with host_read("era.width"):
                        L = min(S, int(ptr_s.max()) + We + 1)
                    cells_e, entry_e = dda_cells(o_s, d_s, tm_s, length=L,
                                                 **dda)
                    cellsW_p, entryW_p = _step_window(cells_e, entry_e,
                                                      ptr_s, We + 1)
            visits = visits + _phase(cellsW_p[:, :We].contiguous(), sel,
                                     rayf, idx_best, cell_start, feat,
                                     pair_block)
            resolved = (t_best[sel]
                        <= entryW_p[:, We] * _ENTRY_REL - _ENTRY_ABS)
            done[sel] = (cellsW_p[:, We] < 0) | resolved
            ptr[sel] = ptr_s + We
            eras += 1
            with host_read("era.live"):
                live = torch.nonzero(~done).squeeze(1)

    t_out, n_best, m_best = decode_winner(geom, idx_best, t_best)
    t_out, n_best, m_best = merge_spheres(geom, o, d, t_out, n_best, m_best)
    if stats:
        with host_read("stats.visits"):
            visits = int(visits)
        info = {"eras": eras, "live_after_phase0": live_a,
                "n_phases": n_phases, "era_rays": sizes[0],
                "visits": visits}
        return t_out, n_best, m_best, info
    return t_out, n_best, m_best
