"""pathtracer_tpu_torch: the path tracer ported to PyTorch and CUDA.

The port of ``pathtracer_tpu`` for one NVIDIA H100, module for module
(the same layout, so each counterpart is easy to find). It imports torch
and numpy, never JAX. The intersection hot loops are hand-written CUDA
kernels (ops/csrc/), built with nvcc at first use; every kernel has a plain
PyTorch version that CPU tensors run.
"""

from .config import PRESETS, RenderConfig
from .scene.builder import build_scene

__all__ = ["PRESETS", "RenderConfig", "build_scene", "render"]


def render(scene, cfg, materials=None):
    """Render a scene with the wavefront engine → (H, W, 3) tensor on the
    scene's device."""
    from .engine.wavefront import render as _render

    return _render(scene, cfg, materials=materials)
