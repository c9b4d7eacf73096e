"""Render configuration (field for field the reference's ``config.py``).

One frozen, hashable dataclass holds every render parameter; the named
presets in :data:`PRESETS` are the reference's five milestone configs and
the ``bench`` preset, so a preset name means the same render in both
packages.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    Attributes:
      width, height: image resolution in pixels.
      spp: samples per pixel.
      max_depth: number of path segments traced from the camera
        (1 = direct lighting only: primary hit + next-event estimation).
      rr_start: bounce index at which Russian roulette termination begins.
        ``rr_start >= max_depth`` disables RR.
      seed: base seed of the counter-based threefry sampler. All randomness
        in a render is a pure function of (seed, pixel_id, spp_idx, bounce).
      scene: name of a builtin scene preset (see scene/builder.py).
      spp_chunk: samples accumulated per step; 0 means all spp in one pass.
      use_bvh: build the flat BVH (its triangle order and root box are used
        by every backend; "jnp" and "pallas" walk it).
      backend: "cluster" (the hand-written CUDA cluster intersector,
        ops/intersect_cluster.py; scenes above its bound go to the grid),
        "grid" (per-ray DDA over a uniform grid with the CUDA pair kernel,
        ops/intersect_grid.py), "stream" (the cluster walk in K-candidate
        rounds with the CUDA stream kernel, ops/intersect_stream.py), or
        "jnp" and "pallas" (both the BVH walk with the CUDA BVH kernel,
        ops/traverse_bvh.py; brute force when use_bvh is off).
      compact: stream-compact (coherence-sort) the ray buffer between
        bounces.
      mis: multiple importance sampling (power heuristic) between NEE and
        cosine-BSDF sampling at diffuse vertices.
    """

    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 1
    rr_start: int = 2
    seed: int = 0
    scene: str = "cornell_spheres"
    spp_chunk: int = 0
    use_bvh: bool = True
    backend: str = "jnp"
    compact: bool = False
    mis: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))


PRESETS: dict[str, RenderConfig] = {
    # 1. Cornell box, analytic spheres, diffuse BRDF, 1 bounce, 1spp 256x256.
    "config1": RenderConfig(
        width=256, height=256, spp=1, max_depth=1, scene="cornell_spheres",
        use_bvh=False,
    ),
    # 2. Triangle-mesh Cornell (bunny) with flat BVH, direct light.
    "config2": RenderConfig(
        width=256, height=256, spp=1, max_depth=1, scene="cornell_mesh",
        use_bvh=True,
    ),
    # 3. Multi-bounce GI (4 bounces) with NEE + Russian roulette, 64spp.
    "config3": RenderConfig(
        width=256, height=256, spp=64, max_depth=4, rr_start=2,
        scene="cornell_mesh", use_bvh=True, spp_chunk=16,
    ),
    # 4. Differentiable pass: material gradients (diff/render.py).
    "config4": RenderConfig(
        width=128, height=128, spp=4, max_depth=2, scene="cornell_spheres",
        use_bvh=False,
    ),
    # 5. 2M-triangle scene on the grid backend.
    "config5": RenderConfig(
        width=1024, height=1024, spp=1, max_depth=4, scene="big_mesh",
        use_bvh=True, spp_chunk=1, backend="grid",
    ),
    # The benchmark path: 1spp 1024x1024 Cornell mesh, cluster backend,
    # coherence compaction on.
    "bench": RenderConfig(
        width=1024, height=1024, spp=1, max_depth=4, rr_start=2,
        scene="cornell_mesh", use_bvh=True, backend="cluster",
        compact=True,
    ),
}
