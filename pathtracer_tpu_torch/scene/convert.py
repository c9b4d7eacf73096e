"""Carry a scene given as numpy arrays into the port.

``scene_from_arrays`` takes the four parts of a scene as dicts of numpy
arrays keyed by the reference's dataclass field names (for example
``{f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}``
on the reference's Geometry, Materials, Camera and Lights), so that both
packages compute on the very same scene.

The reference stores its cluster feature table as a bf16 ``[hi; hi; lo]``
stack (48 rows). The port keeps the float32 table it was rounded from: it
is rebuilt here from the carried triangles and ``cl_map``, and its bf16
stack must equal the carried table bit for bit, or the conversion raises.
The port's own packed tables are derived: ``bvh_nodes``, ``bvh_pairs``
and ``bvh_tris`` from the carried BVH and triangle arrays,
``cl_feat_split`` from the rebuilt feature table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.clusters import (
    CLUSTER_TRIS,
    cluster_tables,
    split_table,
    stack_feat_bf16,
)
from ..ops.traverse_bvh import pack_tables
from .model import Camera, Geometry, Lights, Materials, Scene, _tensors


def _part(cls, arrays: dict):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} arrays lack {sorted(missing)}")
    return cls(**_tensors({
        n: arrays[n] if isinstance(arrays[n], torch.Tensor)
        else np.asarray(arrays[n]) for n in names}))


def _feat_from_carried(geometry: dict) -> np.ndarray:
    cl_map = np.asarray(geometry["cl_map"], np.int32)
    carried = np.asarray(geometry["cl_feat"])
    n_clusters = len(cl_map) // CLUSTER_TRIS
    slots = cl_map.reshape(n_clusters, CLUSTER_TRIS)
    groups = [row[row >= 0].astype(np.int64) for row in slots]
    feat = cluster_tables(groups, geometry["tri_v0"], geometry["tri_e1"],
                          geometry["tri_e2"]).feat
    if carried.dtype.itemsize != 2 or carried.shape != (3 * feat.shape[0],
                                                        feat.shape[1]):
        raise ValueError(
            f"cl_feat must be the (48, {feat.shape[1]}) bf16 stack; got "
            f"{carried.dtype} {carried.shape}"
        )
    stack = stack_feat_bf16(torch.from_numpy(feat)).view(torch.int16)
    if not np.array_equal(stack.numpy().view(np.uint16),
                          carried.view(np.uint16)):
        raise ValueError("carried cl_feat differs from the bf16 stack of the "
                         "table rebuilt from its triangles and cl_map")
    return feat


def scene_from_arrays(geometry: dict, materials: dict, camera: dict,
                      lights: dict, device="cpu") -> Scene:
    """A port Scene on `device` from the reference's arrays (see module
    docstring); raises if the carried feature table does not match."""
    geometry = dict(geometry)
    geometry["cl_feat"] = _feat_from_carried(geometry)
    geometry["cl_feat_split"] = split_table(geometry["cl_feat"])
    (geometry["bvh_nodes"], geometry["bvh_pairs"],
     geometry["bvh_tris"]) = pack_tables(
        *(geometry[k] for k in ("bvh_lo", "bvh_hi", "bvh_first", "bvh_count",
                                "bvh_skip", "tri_v0", "tri_e1", "tri_e2")))
    scene = Scene(
        geometry=_part(Geometry, geometry),
        materials=_part(Materials, materials),
        camera=_part(Camera, camera),
        lights=_part(Lights, lights),
    )
    return scene.to(device)
