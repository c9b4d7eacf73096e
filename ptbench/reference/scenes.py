"""The benchmark's own description of the scenes it renders, frozen here.

Each scene is rebuilt from its definition (the unit Cornell box, its
light, the bunny mesh read from the committed OBJ, the 2M-triangle grid of
deformed icospheres), independently of the program's scene builder, so the
reference holds the program's host build to the same triangles. The
definitions are those of the path tracer's published presets; the bunny
file is checked against the hash it had when this was written.

A scene here is a plain dict of float32/int32 tensors on the host:
tri (T, 3, 3) vertices in the definition's order, tri_mat (T,),
albedo / emission (M, 3), light_tri (L,) ids of the emissive triangles in
triangle order, light_cdf (L,), light_area (), camera position / look_at /
up / fov_y, background (3,), mat_type (M,) (all Lambertian here) and
mat_ior (M,).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

BUNNY_PATH = os.path.join("assets", "bunny.obj")
BUNNY_SHA256 = (
    "8966457030573964f6218fa092951b962e91f72af7f90d3aa5b7735e88750c12")

WHITE, RED, GREEN, LIGHT, SPHERE_A, SPHERE_B, MESH = range(7)
ALBEDO = np.array([
    [0.73, 0.73, 0.73], [0.63, 0.065, 0.05], [0.14, 0.45, 0.091],
    [0.78, 0.78, 0.78], [0.85, 0.85, 0.85], [0.30, 0.40, 0.80],
    [0.75, 0.71, 0.68],
], np.float32)
EMISSION = np.zeros((7, 3), np.float32)
EMISSION[LIGHT] = [14.0, 13.0, 11.0]
CAMERA = dict(position=[0.5, 0.5, -1.4], look_at=[0.5, 0.5, 0.5],
              up=[0.0, 1.0, 0.0], fov_y=0.69)


def _quad(p0, p1, p2, p3):
    p = [np.asarray(x, np.float32) for x in (p0, p1, p2, p3)]
    return np.stack([np.stack([p[0], p[1], p[2]]),
                     np.stack([p[0], p[2], p[3]])])


def walls(light_lo=0.325, light_hi=0.675):
    """The box [0,1]^3 open toward the camera at -z, normals inward, and
    the area light just below the ceiling, emitting downward."""
    y = 0.9995
    quads = [
        (_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]), WHITE),
        (_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]), WHITE),
        (_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1]), WHITE),
        (_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]), RED),
        (_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]), GREEN),
        (_quad([light_lo, y, light_lo], [light_hi, y, light_lo],
               [light_hi, y, light_hi], [light_lo, y, light_hi]), LIGHT),
    ]
    return (np.concatenate([q for q, _ in quads]),
            np.concatenate([np.full(2, m, np.int32) for _, m in quads]))


def read_obj(path: str) -> np.ndarray:
    """(T, 3, 3) triangles of an OBJ's `v` and `f` lines, polygons fanned."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                tris += [(idx[0], idx[k], idx[k + 1])
                         for k in range(1, len(idx) - 1)]
    return np.asarray(verts, np.float32)[np.asarray(tris, np.int64)]


def bunny(root: str) -> np.ndarray:
    path = os.path.join(root, BUNNY_PATH)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != BUNNY_SHA256:
        raise RuntimeError(f"{path} is not the mesh this benchmark was "
                           f"defined on (sha256 {digest})")
    return read_obj(path)


def place(tri: np.ndarray, scale: float, center) -> np.ndarray:
    """Scale a mesh, stand it on the floor at `center`, centred in x, z."""
    tri = tri * np.float32(scale)
    p = tri.reshape(-1, 3)
    lo, hi = p.min(0), p.max(0)
    offset = np.asarray(center, np.float32) - np.array([0.0, lo[1], 0.0],
                                                       np.float32)
    offset[0] -= (lo[0] + hi[0]) / 2
    offset[2] -= (lo[2] + hi[2]) / 2
    return tri + offset


def icosphere(subdiv: int) -> np.ndarray:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        tri = verts[faces]
        m01, m12, m20 = (tri[:, 0] + tri[:, 1], tri[:, 1] + tri[:, 2],
                         tri[:, 2] + tri[:, 0])
        flat = np.concatenate([
            np.stack([tri[:, 0], m01 / 2, m20 / 2], 1),
            np.stack([m01 / 2, tri[:, 1], m12 / 2], 1),
            np.stack([m20 / 2, m12 / 2, tri[:, 2]], 1),
            np.stack([m01 / 2, m12 / 2, m20 / 2], 1),
        ]).reshape(-1, 3)
        flat /= np.linalg.norm(flat, axis=1, keepdims=True)
        verts = flat
        faces = np.arange(len(flat)).reshape(-1, 3)
    return verts[faces].astype(np.float32)


def lumpy(subdiv: int) -> np.ndarray:
    """The deformed icosphere every big_mesh instance copies."""
    p = icosphere(subdiv).astype(np.float64).reshape(-1, 3)
    r = (1.0
         + 0.18 * np.sin(3.1 * p[:, 0] + 1.3) * np.cos(2.7 * p[:, 1])
         + 0.12 * np.sin(4.3 * p[:, 2] + 0.7) * np.cos(3.9 * p[:, 0] + 2.1)
         + 0.08 * np.sin(7.1 * p[:, 1] + 4.2))
    p = p * r[:, None]
    p[:, 1] *= 1.15
    return p.reshape(-1, 3, 3).astype(np.float32)


def big_mesh_tris(n_target: int) -> np.ndarray:
    """About n_target triangles: a grid of lumpy icospheres, each sized
    and placed from numpy's generator seeded with 0."""
    base = lumpy(3)
    n_inst = max(1, n_target // len(base))
    side = int(np.ceil(n_inst ** (1.0 / 3.0)))
    rng = np.random.default_rng(0)
    out = []
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if len(out) >= n_inst:
                    break
                c = np.array([0.12 + 0.76 * (ix + 0.5) / side,
                              0.05 + 0.80 * (iy + 0.5) / side,
                              0.12 + 0.76 * (iz + 0.5) / side], np.float32)
                s = np.float32(0.25 / side) * (0.7 + 0.6 * rng.random())
                out.append(base * s + c)
    return np.concatenate(out)


def build(name: str, root: str, n_target: int = 2_000_000) -> dict:
    """The scene `name` (cornell_mesh or big_mesh) as host tensors; `root`
    is the checkout holding the bunny OBJ."""
    wall_tris, wall_mats = walls()
    if name == "cornell_mesh":
        mesh = place(bunny(root), 0.22, [0.5, 0.0, 0.55])
    elif name == "big_mesh":
        mesh = big_mesh_tris(n_target)
    else:
        raise ValueError(f"no reference definition of scene {name!r}")
    tri = np.concatenate([wall_tris, mesh]).astype(np.float32)
    tri_mat = np.concatenate([wall_mats,
                              np.full(len(mesh), MESH, np.int32)])
    # NEE table: emissive triangles in triangle order, uniform by area.
    light = np.nonzero(EMISSION.sum(-1)[tri_mat] > 0.0)[0]
    e1 = tri[light, 1] - tri[light, 0]
    e2 = tri[light, 2] - tri[light, 0]
    area = (0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)).astype(
        np.float64)
    total = float(area.sum())
    cdf = np.cumsum(area / total).astype(np.float32)
    cdf[-1] = 1.0
    t = torch.from_numpy
    return dict(
        tri=t(tri), tri_mat=t(tri_mat), albedo=t(ALBEDO.copy()),
        emission=t(EMISSION.copy()), light_tri=t(light.astype(np.int64)),
        light_cdf=t(cdf), light_area=torch.tensor(total, dtype=torch.float32),
        background=torch.zeros(3, dtype=torch.float32),
        mat_type=torch.zeros(len(ALBEDO), dtype=torch.int64),
        mat_ior=torch.full((len(ALBEDO),), 1.5, dtype=torch.float32),
        **{k: torch.tensor(v, dtype=torch.float32)
           for k, v in CAMERA.items()},
    )
