"""Scene data model: frozen dataclasses of tensors.

Field for field the reference's ``scene/model.py`` (same names, shapes and
order), with two differences: ``Geometry.cl_feat`` is the float32
``(16, C*512)`` feature table, not the reference's bf16 ``[hi; hi; lo]``
stack, which existed only to fit the TPU's matrix unit
(accel/clusters.py:stack_feat_bf16 rebuilds it for comparisons); and
``Geometry`` ends with four fields of its own, all derived from the
carried arrays and packed once per scene for a kernel: ``bvh_nodes``,
``bvh_tris`` and ``bvh_pairs``, the BVH packed for its walks
(ops/traverse_bvh.py), and ``cl_feat_split``, the feature table as bf16
hi/lo split columns for the stream and pair kernels
(accel/clusters.py:split_table).

Builders work in numpy and wrap the result once with :func:`_tensors`; every
dataclass has a ``.to(device)`` that moves all of its tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class _TensorFields:
    """``.to(device)`` and ``.replace(**kw)`` for a dataclass of tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def replace(self, **kw):
        return dataclasses.replace(self, **_tensors(kw))


def _tensors(fields: dict) -> dict:
    """numpy arrays / scalars -> CPU tensors (tensors pass through)."""
    out = {}
    for k, v in fields.items():
        if not isinstance(v, (torch.Tensor, _TensorFields)):
            v = torch.from_numpy(np.array(v, copy=True))
        out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class Geometry(_TensorFields):
    """Static scene geometry as flat SoA tensors.

    Triangle i is (v0[i], v0[i]+e1[i], v0[i]+e2[i]); `tri_n` is the unit
    geometric normal. The BVH arrays are the stackless skip-link layout of
    accel/build.py (empty = no BVH). The cluster tables (accel/clusters.py)
    group triangles into 128-slot padded clusters with one box each;
    `cl_map` maps slots to triangle ids (-1 padding) and `cl_slot_nm` holds
    the pre-joined per-slot [n(3), mat, valid, pad(3)] rows of the winner
    decode. The grid tables (accel/grid.py) map each morton cell of a
    uniform grid to a contiguous cluster range; the super-cluster tables
    (accel/clusters.py:build_supers) group clusters for the stream route's
    per-ray cull. `bvh_nodes`/`bvh_tris`/`bvh_pairs` hold the BVH, its
    triangles and its child pairs as ops/traverse_bvh.py:pack_tables lays
    them out (empty without a BVH).
    `cl_feat_split` holds `cl_feat`'s used rows as accel/clusters.py:
    split_table packs them, one 32 KB block per cluster.
    """

    tri_v0: torch.Tensor  # (T, 3) f32
    tri_e1: torch.Tensor  # (T, 3) f32
    tri_e2: torch.Tensor  # (T, 3) f32
    tri_n: torch.Tensor  # (T, 3) f32, unit geometric normal
    tri_mat: torch.Tensor  # (T,) i32
    sph_c: torch.Tensor  # (S, 3) f32 sphere centers
    sph_r: torch.Tensor  # (S,) f32 radii
    sph_mat: torch.Tensor  # (S,) i32
    bvh_lo: torch.Tensor  # (N, 3) f32 AABB min
    bvh_hi: torch.Tensor  # (N, 3) f32 AABB max
    bvh_first: torch.Tensor  # (N,) i32
    bvh_count: torch.Tensor  # (N,) i32 0 = internal, >0 = leaf size
    bvh_skip: torch.Tensor  # (N,) i32 next cursor on miss / after leaf
    mat_type: torch.Tensor  # (M,) i32 constants.MAT_*
    mat_ior: torch.Tensor  # (M,) f32
    cl_lo: torch.Tensor  # (C, 3) f32 cluster AABB min
    cl_hi: torch.Tensor  # (C, 3) f32 cluster AABB max
    cl_feat: torch.Tensor  # (16, C*512) f32 feature columns
    cl_map: torch.Tensor  # (C*128,) i32 padded slot -> tri index
    su_lo: torch.Tensor  # (S, 3) f32 super AABB min
    su_hi: torch.Tensor  # (S, 3) f32 super AABB max
    cl_super: torch.Tensor  # (C,) i32 cluster -> super id
    gr_cell_start: torch.Tensor  # (AXIS^3 + 1,) i32
    gr_lo: torch.Tensor  # (3,) f32 grid box min
    gr_cell: torch.Tensor  # (3,) f32 per-axis cell size
    cl_slot_nm: torch.Tensor  # (C*128, 8) f32
    bvh_nodes: torch.Tensor  # (N, 8) f32 packed nodes
    bvh_tris: torch.Tensor  # (T, 12) f32 packed triangles (0 rows: no BVH)
    bvh_pairs: torch.Tensor  # (E, 16) f32 child-pair entries
    cl_feat_split: torch.Tensor  # (C, 512, 32) bf16 split feature columns


@dataclasses.dataclass(frozen=True)
class Materials(_TensorFields):
    albedo: torch.Tensor  # (M, 3) f32 in [0, 1]
    emission: torch.Tensor  # (M, 3) f32 radiance, >= 0


@dataclasses.dataclass(frozen=True)
class Camera(_TensorFields):
    """Pinhole camera. `fov_y` is the vertical field of view in radians."""

    position: torch.Tensor  # (3,) f32
    look_at: torch.Tensor  # (3,) f32
    up: torch.Tensor  # (3,) f32
    fov_y: torch.Tensor  # () f32


@dataclasses.dataclass(frozen=True)
class Lights(_TensorFields):
    """Emissive-surface table for next-event estimation.

    Uniform-by-area sampling over the concatenation [triangle lights...,
    sphere lights...] (triangles first): `cdf` is the normalized cumulative
    area, `total_area` turns the per-area pdf into the estimator weight.
    """

    tri_idx: torch.Tensor  # (Lt,) i32 indices into Geometry triangles
    sph_idx: torch.Tensor  # (Ls,) i32 indices into Geometry spheres
    cdf: torch.Tensor  # (Lt+Ls,) f32 normalized cumulative area
    total_area: torch.Tensor  # () f32
    background: torch.Tensor  # (3,) f32 environment radiance on ray miss


@dataclasses.dataclass(frozen=True)
class Scene(_TensorFields):
    geometry: Geometry
    materials: Materials
    camera: Camera
    lights: Lights


def make_geometry(
    tri_verts: np.ndarray,
    tri_mat: np.ndarray,
    sph_c: np.ndarray | None = None,
    sph_r: np.ndarray | None = None,
    sph_mat: np.ndarray | None = None,
    mat_type: np.ndarray | None = None,
    mat_ior: np.ndarray | None = None,
) -> Geometry:
    """Build a Geometry (without BVH or clusters) from (T, 3, 3) vertices.

    mat_type/mat_ior are per-material-id tables; omitted, every material is
    Lambertian with ior 1.5.
    """
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-20)
    if sph_c is None:
        sph_c = np.zeros((0, 3), np.float32)
        sph_r = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)
    tri_mat = np.asarray(tri_mat, np.int32)
    sph_mat_a = np.asarray(sph_mat, np.int32).reshape(-1)
    n_mats = int(max(tri_mat.max(initial=-1), sph_mat_a.max(initial=-1))) + 1
    if mat_type is None:
        mat_type = np.zeros((n_mats,), np.int32)
    if mat_ior is None:
        mat_ior = np.full((n_mats,), 1.5, np.float32)
    empty3 = np.zeros((0, 3), np.float32)
    empty1i = np.zeros((0,), np.int32)
    return Geometry(**_tensors(dict(
        tri_v0=v0.astype(np.float32),
        tri_e1=e1.astype(np.float32),
        tri_e2=e2.astype(np.float32),
        tri_n=n.astype(np.float32),
        tri_mat=tri_mat,
        sph_c=np.asarray(sph_c, np.float32).reshape(-1, 3),
        sph_r=np.asarray(sph_r, np.float32).reshape(-1),
        sph_mat=sph_mat_a,
        bvh_lo=empty3,
        bvh_hi=empty3,
        bvh_first=empty1i,
        bvh_count=empty1i,
        bvh_skip=empty1i,
        mat_type=np.asarray(mat_type, np.int32).reshape(-1),
        mat_ior=np.asarray(mat_ior, np.float32).reshape(-1),
        cl_lo=empty3,
        cl_hi=empty3,
        cl_feat=np.zeros((16, 0), np.float32),
        cl_map=empty1i,
        su_lo=empty3,
        su_hi=empty3,
        cl_super=empty1i,
        gr_cell_start=empty1i,
        gr_lo=np.zeros((3,), np.float32),
        gr_cell=np.ones((3,), np.float32),
        cl_slot_nm=np.zeros((0, 8), np.float32),
        bvh_nodes=np.zeros((0, 8), np.float32),
        bvh_tris=np.zeros((0, 12), np.float32),
        bvh_pairs=np.zeros((0, 16), np.float32),
        cl_feat_split=torch.zeros((0, 512, 32), dtype=torch.bfloat16),
    )))


def triangle_areas(geom: Geometry) -> np.ndarray:
    e1 = geom.tri_e1.cpu().numpy()
    e2 = geom.tri_e2.cpu().numpy()
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def make_lights(geom: Geometry, materials: Materials,
                background=(0.0, 0.0, 0.0)) -> Lights:
    """Derive the NEE light table from emissive materials.

    Triangles and analytic spheres with emissive materials both become
    lights, sampled uniformly by area over the union (triangle lights
    first in the cdf).
    """
    emission = materials.emission.cpu().numpy()
    tri_mat = geom.tri_mat.cpu().numpy()
    emissive = emission.sum(-1) > 0.0
    idx = np.nonzero(emissive[tri_mat])[0].astype(np.int32)
    sph_mat = geom.sph_mat.cpu().numpy()
    sidx = (np.nonzero(emissive[sph_mat])[0].astype(np.int32)
            if sph_mat.size else np.zeros((0,), np.int32))
    t_areas = (triangle_areas(geom)[idx] if idx.size
               else np.zeros((0,), np.float64))
    s_areas = (4.0 * np.pi * geom.sph_r.cpu().numpy()[sidx] ** 2
               if sidx.size else np.zeros((0,), np.float64))
    areas = np.concatenate([t_areas, s_areas])
    background = np.asarray(background, np.float32)
    if areas.size == 0:
        return Lights(**_tensors(dict(
            tri_idx=np.zeros((0,), np.int32),
            sph_idx=np.zeros((0,), np.int32),
            cdf=np.zeros((0,), np.float32),
            total_area=np.float32(0.0),
            background=background,
        )))
    total = float(areas.sum())
    cdf = np.cumsum(areas / total).astype(np.float32)
    cdf[-1] = 1.0
    return Lights(**_tensors(dict(
        tri_idx=idx,
        sph_idx=sidx,
        cdf=cdf,
        total_area=np.float32(total),
        background=background,
    )))
