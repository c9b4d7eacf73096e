"""Differentiable rendering: grads of pixel radiance w.r.t. materials (the
reference's ``diff/render.py``).

Reverse-mode gradients of an image loss w.r.t. the Materials (albedo,
emission) and, through emission, light brightness. The detach policy lives
in engine/wavefront.py:trace_sample, as in the reference:

  * intersection outputs (t, normal, hit id) carry no gradient: the
    kernels sit behind ops/boundary.py, and t and the normal are detached;
  * the NEE geometric term (cosines, 1/d^2, area, MIS weight) is detached;
  * Russian-roulette continuation probabilities and the MIS weights of
    emissive hits are detached;
  * grads flow through the emission rows of primary hits, the
    multiplicative albedo throughput chain and the NEE product
    albedo * emission_light.

Functions follow the scene's device; the package's grad_render chooses it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderConfig
from ..engine.wavefront import trace_sample
from ..scene.model import Materials, Scene
from ..utils.profiling import span


def render_image(scene: Scene, cfg: RenderConfig, materials: Materials,
                 pixel_ids: torch.Tensor | None = None):
    """Differentiable full render → (H, W, 3) on the scene's device; given
    `pixel_ids` (absolute row-major ids on that device), the (N, 3)
    radiance of those pixels instead.

    With spp > 1 each sample is checkpointed: the backward pass recomputes
    it, so memory stays that of one sample (the sampler is keyed by
    absolute ids, so the recompute is exact).
    """
    dev = scene.geometry.tri_v0.device
    ids = pixel_ids
    if ids is None:
        ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=dev)
    args = (scene.geometry, materials, scene.camera, scene.lights, cfg, ids)
    if cfg.spp == 1:
        acc = trace_sample(*args, 0)
    else:
        acc = torch.zeros((ids.shape[0], 3), dtype=torch.float32, device=dev)
        for i in range(cfg.spp):
            acc = acc + checkpoint(trace_sample, *args, i,
                                   use_reentrant=False)
    img = acc / float(cfg.spp)
    if pixel_ids is not None:
        return img
    return img.reshape(cfg.height, cfg.width, 3)


def default_loss(img, target):
    return torch.mean((img - target) ** 2)


def value_and_grad(f, materials: Materials):
    """(f(materials), d f / d materials) for a scalar f; the grads come
    back as a Materials of tensors (zeros where f does not depend)."""
    leaves = Materials(
        albedo=materials.albedo.detach().clone().requires_grad_(True),
        emission=materials.emission.detach().clone().requires_grad_(True),
    )
    value = f(leaves)
    with span("backward"):
        grads = torch.autograd.grad(value, (leaves.albedo, leaves.emission),
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, (leaves.albedo, leaves.emission))]
    return value.detach(), Materials(albedo=grads[0], emission=grads[1])


def loss_and_grad(scene: Scene, cfg: RenderConfig, materials: Materials,
                  target, loss_fn=default_loss):
    """(loss, grads-w.r.t.-materials) for an image loss against target."""
    return value_and_grad(
        lambda mats: loss_fn(render_image(scene, cfg, mats), target),
        materials)


def grad_render(scene: Scene, cfg: RenderConfig, loss_fn=None, target=None):
    """Grads of the scene's own materials.

    With no target, differentiates the mean pixel radiance (or
    loss_fn(img)); with a target, an image loss against it (loss_fn, by
    default the MSE).
    """
    if target is None:
        def f(mats):
            img = render_image(scene, cfg, mats)
            return torch.mean(img) if loss_fn is None else loss_fn(img)

        return value_and_grad(f, scene.materials)
    return loss_and_grad(scene, cfg, scene.materials, target,
                         loss_fn or default_loss)
