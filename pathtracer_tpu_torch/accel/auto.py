"""Backend-aware acceleration-table preparation.

Builds the host-side tables a RenderConfig's backend needs. Only the
cluster route is ported: where the reference would send a scene to its grid
or streaming kernel (a cluster table above its routing bound, or
backend="grid"/"stream"), this raises NotImplementedError, so the same
scenes reach the cluster kernel in both packages.
"""

from __future__ import annotations

from ..config import RenderConfig
from ..ops.intersect_cluster import routes_to_cluster
from ..scene.model import Scene
from .clusters import CLUSTER_TRIS, with_clusters


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1)"
    )


def prepare_accel(scene: Scene, cfg: RenderConfig) -> Scene:
    """Attach the accel tables `cfg.backend` needs (host-side numpy).

    backend="cluster": dense cluster tables. backend="jnp"/"pallas": nothing
    beyond the BVH built upstream. backend="grid"/"stream", and cluster
    scenes the reference would route to its grid, raise.
    """
    if cfg.backend in ("grid", "stream"):
        raise _not_ported(f'backend="{cfg.backend}"')
    if cfg.backend != "cluster":
        return scene
    # ceil(T/128) is a lower bound on the cluster count.
    n_tris = int(scene.geometry.tri_v0.shape[0])
    if not routes_to_cluster(-(-n_tris // CLUSTER_TRIS)):
        raise _not_ported("the large-scene grid route")
    scene = with_clusters(scene)
    if not routes_to_cluster(int(scene.geometry.cl_lo.shape[0])):
        raise _not_ported("the large-scene grid route")
    return scene
