"""The reference of the material fit: full-frame MSE, its gradient, Adam.

It follows the fit a user runs (render the frame, the mean squared error
against a target rendered with the scene's own materials, the gradient
w.r.t. albedo and emission, one Adam step at the stated learning rate) with
`reference/tracer.py`, in blocks of pixels so that the graph of one block
is alive at a time. Adam is written out here (Kingma and Ba, with the
defaults the fit states). Nothing of the program is used.
"""

from __future__ import annotations

import torch

from . import tracer


def target_image(geo, scene, cfg, seed, ids, block):
    """The target: the frame rendered with the scene's own materials."""
    return tracer.render_blocks(geo, scene, cfg, seed, 0, ids,
                                scene["albedo"].to(ids.device),
                                scene["emission"].to(ids.device), block)


def loss_and_grad(geo, scene, cfg, seed, ids, target, albedo, emission,
                  block):
    """(loss, d loss / d albedo, d loss / d emission) of the frame `ids`
    (one sample, spp index 0) against `target` (len(ids), 3)."""
    a = albedo.detach().clone().requires_grad_(True)
    e = emission.detach().clone().requires_grad_(True)
    denom = float(ids.shape[0] * 3)
    loss = torch.zeros((), dtype=torch.float64, device=ids.device)
    for s in range(0, ids.shape[0], block):
        img = tracer.render(geo, scene, cfg, seed, 0, ids[s:s + block], a, e)
        part = ((img - target[s:s + block]) ** 2).sum() / denom
        part.backward()
        loss += part.detach().double()
    return float(loss), a.grad.detach(), e.grad.detach()


class Adam:
    """Adam on a list of tensors: m, v moments and bias correction."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params = [p.detach().clone() for p in params]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0

    def step(self, grads):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, m, v, g in zip(self.params, self.m, self.v, grads):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def follow(geo, scene, cfg, seed, ids, albedo0, emission0, lr, n_steps,
           block):
    """The first n_steps steps of the fit from (albedo0, emission0).

    Returns the losses, the first step's gradients and the parameters
    after n_steps, as {"loss": [...], "grad": [albedo, emission],
    "params": [albedo, emission]}."""
    target = target_image(geo, scene, cfg, seed, ids, block)
    opt = Adam([albedo0, emission0], lr)
    losses, first = [], None
    for _ in range(n_steps):
        loss, ga, ge = loss_and_grad(geo, scene, cfg, seed, ids, target,
                                     opt.params[0], opt.params[1], block)
        losses.append(loss)
        if first is None:
            first = [ga, ge]
        opt.step([ga, ge])
    return {"loss": losses, "grad": first, "params": opt.params}
