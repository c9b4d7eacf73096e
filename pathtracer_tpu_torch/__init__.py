"""pathtracer_tpu_torch: the path tracer ported to PyTorch and CUDA.

The port of ``pathtracer_tpu`` for one NVIDIA H100, module for module
(the same layout, so each counterpart is easy to find). It imports torch
and numpy, never JAX. The intersection hot loops are hand-written CUDA
kernels (ops/csrc/), built with nvcc at first use; every kernel has a plain
PyTorch version that CPU tensors run.

The entry points render and grad_render run on the card: they move the
scene to ``device``, which is CUDA unless the caller passes ``"cpu"``, and
raise when there is no CUDA device. The host builders (scene/, accel/)
return CPU tensors.
"""

import torch

from .config import PRESETS, RenderConfig
from .scene.builder import build_scene

__all__ = ["PRESETS", "RenderConfig", "build_scene", "render", "grad_render"]


def _device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return device


def render(scene, cfg, materials=None, device=None):
    """Render a scene with the wavefront engine → (H, W, 3) tensor on
    `device` (default: the card)."""
    from .engine.wavefront import render as _render

    device = _device(device)
    if materials is not None:
        materials = materials.to(device)
    return _render(scene.to(device), cfg, materials=materials)


def grad_render(scene, cfg, loss_fn=None, target=None, device=None):
    """(loss, grads) of an image loss w.r.t. the scene's materials, on
    `device` (default: the card); grads is a Materials of tensors."""
    from .diff.render import grad_render as _grad_render

    device = _device(device)
    if target is not None:
        target = torch.as_tensor(target, device=device)
    return _grad_render(scene.to(device), cfg, loss_fn=loss_fn,
                        target=target)
