"""Backend-aware acceleration-table preparation.

Builds the host-side tables a RenderConfig's backend needs, with the
reference's routing: a scene whose cluster table is above the cluster
route's bound (ops/intersect_cluster.py:routes_to_cluster, the reference's
bound, kept so the same scenes take the same route in both packages) gets
grid tables instead, and engine/wavefront.py:_intersector sends it to the
grid intersector.
"""

from __future__ import annotations

from ..config import RenderConfig
from ..ops.intersect_cluster import routes_to_cluster
from ..scene.model import Scene
from .clusters import CLUSTER_TRIS, with_clusters
from .grid import with_grid


def prepare_accel(scene: Scene, cfg: RenderConfig,
                  grid_axis: int | None = None) -> Scene:
    """Attach the accel tables `cfg.backend` needs (host-side numpy).

    backend="cluster": dense cluster tables when they are within the cluster
        route's bound, else grid tables.
    backend="stream": cluster and super-cluster tables, at any size (the
        explicit choice of the stream route).
    backend="grid": uniform-grid tables (`grid_axis` overrides pick_axis).
    backend="jnp"/"pallas": nothing beyond the BVH built upstream.
    """
    if cfg.backend == "stream":
        return with_clusters(scene)
    if cfg.backend == "grid":
        return with_grid(scene, axis=grid_axis)
    if cfg.backend != "cluster":
        return scene
    # ceil(T/128) is a lower bound on the cluster count, so a failing
    # estimate is definitive and skips the cluster build.
    n_tris = int(scene.geometry.tri_v0.shape[0])
    if not routes_to_cluster(-(-n_tris // CLUSTER_TRIS)):
        return with_grid(scene, axis=grid_axis)
    clustered = with_clusters(scene)
    if not routes_to_cluster(int(clustered.geometry.cl_lo.shape[0])):
        return with_grid(scene, axis=grid_axis)
    return clustered
