"""Minimal OBJ mesh loader (reference R8's bunny path, SURVEY.md §2.1).

Supports the subset hobby-tracer assets use: `v` positions and `f` faces
(triangles or polygons, fan-triangulated), with 1-based, negative, and
`v/vt/vn` style indices. Normals/materials in the file are ignored — the
renderer derives geometric normals and scenes assign material ids.

Returns a (T, 3, 3) float32 triangle array compatible with
scene/builder.py:cornell_mesh(mesh_tris=...).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str) -> np.ndarray:
    verts: list[list[float]] = []
    tris: list[tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    s = token.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    v = np.asarray(verts, np.float32)
    return v[np.asarray(tris, np.int64)]


def normalize_to_unit(tri: np.ndarray) -> np.ndarray:
    """Center the mesh and scale its longest AABB side to 1."""
    p = tri.reshape(-1, 3)
    lo, hi = p.min(0), p.max(0)
    scale = 1.0 / max(float((hi - lo).max()), 1e-12)
    center = (lo + hi) / 2.0
    return ((tri - center) * scale).astype(np.float32)
