"""What the benchmark takes from the program: its preset, its scene build
and its ray counter. Every other module here reaches the program only
through the functions it times."""

from __future__ import annotations

import time

import torch

from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.scene.builder import build_scene


def render_config(config: dict, seed: int, **override) -> RenderConfig:
    """The configuration's preset with the run's sampler seed."""
    return RenderConfig(**{**config["preset"], "seed": seed, **override})


def build(cfg: RenderConfig, device, sync) -> tuple:
    """(scene on `device`, seconds): build_scene -> with_bvh ->
    prepare_accel -> .to(device), ended by sync()."""
    t0 = time.perf_counter()
    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    scene = prepare_accel(scene, cfg).to(device)
    sync()
    return scene, time.perf_counter() - t0


class RayCounter:
    """Installs, on `module.attr` (a reference to the engine's
    trace_sample), a version that asks trace_sample for its useful rays and
    adds them to a device counter, returning the radiance alone."""

    def __init__(self, module, attr: str, device):
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.module, self.attr = module, attr
        fn = self.fn = getattr(module, attr)

        def counting(*args, **kw):
            rad, n = fn(*args, with_stats=True, **kw)
            self.count += n
            return rad

        setattr(module, attr, counting)

    def close(self) -> None:
        """Puts the program's function back."""
        setattr(self.module, self.attr, self.fn)

    def take(self) -> int:
        """The rays counted since the last take (synchronises)."""
        n = int(self.count)
        self.count.zero_()
        return n
