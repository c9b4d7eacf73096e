"""Builtin scenes (the reference's ``scene/builder.py``, array for array).

* ``cornell_spheres`` — Cornell box + two analytic spheres (config 1).
* ``cornell_specular``, ``cornell_biglight``, ``cornell_sphlight`` — the
  material, MIS and sphere-light variants.
* ``cornell_mesh``    — Cornell box + the bunny mesh (configs 2/3 and the
  benchmark scene), loaded from ``assets/bunny.obj``.
* ``big_mesh``        — the 2M-triangle config-5 scene (grid backend).

Conventions: the box is the unit cube [0,1]^3, open toward the camera at
-z; quad windings make geometric normals face the interior; emission is
one-sided (front face only).
"""

from __future__ import annotations

import os

import numpy as np

from .. import constants as C
from .model import (
    Camera,
    Materials,
    Scene,
    _tensors,
    make_geometry,
    make_lights,
)

# Material table indices.
WHITE, RED, GREEN, LIGHT, SPHERE_A, SPHERE_B, MESH = range(7)


def _default_albedo_emission() -> tuple[np.ndarray, np.ndarray]:
    albedo = np.array(
        [
            [0.73, 0.73, 0.73],  # WHITE walls/floor/ceiling
            [0.63, 0.065, 0.05],  # RED left wall
            [0.14, 0.45, 0.091],  # GREEN right wall
            [0.78, 0.78, 0.78],  # LIGHT surface albedo
            [0.85, 0.85, 0.85],  # SPHERE_A
            [0.30, 0.40, 0.80],  # SPHERE_B
            [0.75, 0.71, 0.68],  # MESH
        ],
        np.float32,
    )
    emission = np.zeros((7, 3), np.float32)
    emission[LIGHT] = [14.0, 13.0, 11.0]
    return albedo, emission


def default_materials() -> Materials:
    albedo, emission = _default_albedo_emission()
    return Materials(**_tensors(dict(albedo=albedo, emission=emission)))


def _quad(p0, p1, p2, p3):
    """Two CCW triangles (p0,p1,p2), (p0,p2,p3); normal by right-hand rule."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def _box_quads(light_lo: float, light_hi: float):
    return [
        # floor y=0, normal +y
        (_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0]), WHITE),
        # ceiling y=1, normal -y
        (_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]), WHITE),
        # back wall z=1, normal -z
        (_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1]), WHITE),
        # left wall x=0, normal +x
        (_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]), RED),
        # right wall x=1, normal -x
        (_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]), GREEN),
        # area light just below the ceiling, normal -y (emits downward)
        (
            _quad(
                [light_lo, 0.9995, light_lo],
                [light_hi, 0.9995, light_lo],
                [light_hi, 0.9995, light_hi],
                [light_lo, 0.9995, light_hi],
            ),
            LIGHT,
        ),
    ]


def _walls(light_lo: float = 0.325, light_hi: float = 0.675):
    """(T,3,3) triangles + (T,) material ids for the box walls + light."""
    quads = _box_quads(light_lo, light_hi)
    tris = np.concatenate([q for q, _ in quads])
    mats = np.concatenate([np.full(len(q), m, np.int32) for q, m in quads])
    return tris, mats


def default_camera() -> Camera:
    return Camera(**_tensors(dict(
        position=np.array([0.5, 0.5, -1.4], np.float32),
        look_at=np.array([0.5, 0.5, 0.5], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32),
        fov_y=np.float32(0.69),  # ~39.5 degrees vertical
    )))


def _scene(geom, albedo, emission, background) -> Scene:
    materials = Materials(**_tensors(dict(albedo=albedo, emission=emission)))
    return Scene(
        geometry=geom,
        materials=materials,
        camera=default_camera(),
        lights=make_lights(geom, materials, background),
    )


_SPHERES = dict(
    sph_c=np.array([[0.3, 0.18, 0.45], [0.72, 0.14, 0.65]], np.float32),
    sph_r=np.array([0.18, 0.14], np.float32),
    sph_mat=np.array([SPHERE_A, SPHERE_B], np.int32),
)


def cornell_spheres(background=(0.0, 0.0, 0.0)) -> Scene:
    """Config 1 scene: Cornell box walls + two analytic spheres."""
    tris, mats = _walls()
    geom = make_geometry(tris, mats, **_SPHERES)
    return _scene(geom, *_default_albedo_emission(), background)


def cornell_sphlight(background=(0.0, 0.0, 0.0)) -> Scene:
    """Cornell box lit by the quad light plus an emissive sphere."""
    tris, mats = _walls()
    geom = make_geometry(
        tris,
        mats,
        sph_c=np.array([[0.35, 0.2, 0.5], [0.75, 0.75, 0.55]], np.float32),
        sph_r=np.array([0.2, 0.08], np.float32),
        sph_mat=np.array([SPHERE_A, SPHERE_B], np.int32),
    )
    albedo, emission = _default_albedo_emission()
    emission[SPHERE_B] = [10.0, 9.0, 8.0]
    return _scene(geom, albedo, emission, background)


def cornell_specular(background=(0.0, 0.0, 0.0)) -> Scene:
    """Cornell box with a mirror sphere (SPHERE_A) and a glass one (SPHERE_B,
    ior 1.5); the walls stay Lambertian."""
    tris, mats = _walls()
    mat_type = np.zeros((7,), np.int32)
    mat_type[SPHERE_A] = C.MAT_SPEC
    mat_type[SPHERE_B] = C.MAT_REFR
    geom = make_geometry(tris, mats, mat_type=mat_type, **_SPHERES)
    albedo, emission = _default_albedo_emission()
    albedo[SPHERE_A] = [0.95, 0.95, 0.95]
    albedo[SPHERE_B] = [0.99, 0.99, 0.99]
    return _scene(geom, albedo, emission, background)


def cornell_biglight(background=(0.0, 0.0, 0.0)) -> Scene:
    """Cornell spheres with a near-ceiling-sized light (the MIS scene);
    emission is scaled by the area ratio so total power matches
    cornell_spheres."""
    tris, mats = _walls(0.05, 0.95)
    geom = make_geometry(tris, mats, **_SPHERES)
    albedo, emission = _default_albedo_emission()
    emission[LIGHT] = emission[LIGHT] * (0.35**2 / 0.9**2)
    return _scene(geom, albedo, emission, background)


def _icosphere(subdiv: int) -> np.ndarray:
    """Unit icosphere → (T,3,3) triangle array."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        tri = verts[faces]  # (F, 3, 3)
        m01 = tri[:, 0] + tri[:, 1]
        m12 = tri[:, 1] + tri[:, 2]
        m20 = tri[:, 2] + tri[:, 0]
        new_tris = np.concatenate(
            [
                np.stack([tri[:, 0], m01 / 2, m20 / 2], 1),
                np.stack([m01 / 2, tri[:, 1], m12 / 2], 1),
                np.stack([m20 / 2, m12 / 2, tri[:, 2]], 1),
                np.stack([m01 / 2, m12 / 2, m20 / 2], 1),
            ]
        )
        flat = new_tris.reshape(-1, 3)
        flat /= np.linalg.norm(flat, axis=1, keepdims=True)
        verts = flat
        faces = np.arange(len(flat)).reshape(-1, 3)
    return verts[faces].astype(np.float32)


def procedural_bunny(subdiv: int = 4) -> np.ndarray:
    """A lumpy deformed icosphere (subdiv=4 → 5120 triangles), the mesh that
    ``assets/bunny.obj`` stores."""
    tri = _icosphere(subdiv).astype(np.float64)
    p = tri.reshape(-1, 3)
    r = (
        1.0
        + 0.18 * np.sin(3.1 * p[:, 0] + 1.3) * np.cos(2.7 * p[:, 1])
        + 0.12 * np.sin(4.3 * p[:, 2] + 0.7) * np.cos(3.9 * p[:, 0] + 2.1)
        + 0.08 * np.sin(7.1 * p[:, 1] + 4.2)
    )
    p = p * r[:, None]
    p[:, 1] *= 1.15
    return p.reshape(tri.shape).astype(np.float32)


def _place_mesh(tri: np.ndarray, scale: float, center) -> np.ndarray:
    """Scale a unit-ish mesh and drop it so its min-y sits on the floor."""
    tri = tri * np.float32(scale)
    lo = tri.reshape(-1, 3).min(0)
    offset = np.asarray(center, np.float32) - np.array(
        [0.0, lo[1], 0.0], np.float32
    )
    offset[0] -= (tri.reshape(-1, 3).min(0)[0] + tri.reshape(-1, 3).max(0)[0]) / 2
    offset[2] -= (tri.reshape(-1, 3).min(0)[2] + tri.reshape(-1, 3).max(0)[2]) / 2
    return tri + offset


def _bunny_asset() -> np.ndarray:
    """The committed bunny OBJ via the loader; procedural fallback."""
    path = os.path.join(
        os.path.dirname(__file__), "..", "..", "assets", "bunny.obj"
    )
    if os.path.exists(path):
        from .obj import load_obj

        return load_obj(path)
    return procedural_bunny(4)


def cornell_mesh(background=(0.0, 0.0, 0.0),
                 mesh_tris: np.ndarray | None = None) -> Scene:
    """Cornell box + a triangle mesh (no spheres); `mesh_tris` substitutes
    another mesh (scene/obj.py)."""
    walls, wall_mats = _walls()
    if mesh_tris is None:
        mesh_tris = _bunny_asset()
    mesh_tris = _place_mesh(mesh_tris, 0.22, [0.5, 0.0, 0.55])
    tris = np.concatenate([walls, mesh_tris])
    mats = np.concatenate(
        [wall_mats, np.full(len(mesh_tris), MESH, np.int32)]
    )
    geom = make_geometry(tris, mats)
    return _scene(geom, *_default_albedo_emission(), background)


def big_mesh(n_target: int = 2_000_000, background=(0.0, 0.0, 0.0)) -> Scene:
    """Config 5 scene: about `n_target` triangles (1,999,372 by default), a
    grid of deformed icospheres (1280 triangles each) inside the Cornell
    box, sized and placed from a seeded numpy generator."""
    base = procedural_bunny(3)
    per = len(base)
    n_inst = max(1, n_target // per)
    side = int(np.ceil(n_inst ** (1.0 / 3.0)))
    rng = np.random.default_rng(0)
    instances = []
    count = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if count >= n_inst:
                    break
                c = np.array(
                    [
                        0.12 + 0.76 * (ix + 0.5) / side,
                        0.05 + 0.80 * (iy + 0.5) / side,
                        0.12 + 0.76 * (iz + 0.5) / side,
                    ],
                    np.float32,
                )
                s = np.float32(0.25 / side) * (0.7 + 0.6 * rng.random())
                instances.append(base * s + c)
                count += 1
    walls, wall_mats = _walls()
    mesh = np.concatenate(instances)
    tris = np.concatenate([walls, mesh])
    mats = np.concatenate([wall_mats, np.full(len(mesh), MESH, np.int32)])
    geom = make_geometry(tris, mats)
    return _scene(geom, *_default_albedo_emission(), background)


_BUILDERS = {
    "cornell_spheres": cornell_spheres,
    "cornell_specular": cornell_specular,
    "cornell_biglight": cornell_biglight,
    "cornell_sphlight": cornell_sphlight,
    "cornell_mesh": cornell_mesh,
    "big_mesh": big_mesh,
}


def build_scene(name: str, **kw) -> Scene:
    if name not in _BUILDERS:
        raise ValueError(f"unknown scene {name!r}; have {sorted(_BUILDERS)}")
    return _BUILDERS[name](**kw)
