"""The material fit users run, step after step on one card.

Set-up renders the target with the scene's own materials and starts Adam
(`cli.adam`, learning rate `lr`) from albedo perturbed by N(0, `perturb`)
drawn from the seed, clipped to [0.05, 0.95]. A step is
`diff/render.py:loss_and_grad` (the MSE of the full frame against the
target) and the optimizer's step, ended by a device barrier; its useful
rays are the forward rays the engine counts. Set-up drives the fit
through its first `first_steps` steps, the window's own call, and keeps
their losses, the first gradient as Adam holds it after one step (its
first moment over 1 - beta1) and the parameters after the steps; the
window goes on from there with the same optimizer. The check follows the
same steps with the reference: `loss_gap`, `grad_gap`, `change_gap`.

Params: perturb, lr, first_steps, trace_frames, ref_block.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracer_tpu_torch.cli import adam
from pathtracer_tpu_torch.diff import render as dr
from pathtracer_tpu_torch.scene.model import Materials

from .. import check, program
from ..flow import single, sync


class Mode:
    def __init__(self, run):
        self.run = run
        self.dev = torch.device(run.device)
        cfg = program.render_config(run.config, 0)
        self.scene, run.scene_build_s = program.build(
            cfg, self.dev, lambda: sync(self.dev))
        self.counter = program.RayCounter(dr, "trace_sample", self.dev)

    def start(self, seed: int) -> None:
        p = self.run.params
        self.seed = seed % (2 ** 31)
        self.cfg = program.render_config(self.run.config, self.seed)
        mats = self.scene.materials
        with torch.no_grad():
            self.target = dr.render_image(self.scene, self.cfg, mats)
        albedo = mats.albedo.cpu().numpy()
        rng = np.random.default_rng(seed)
        albedo = np.clip(albedo + rng.normal(0.0, p["perturb"], albedo.shape),
                         0.05, 0.95).astype(np.float32)
        self.start_params = [torch.from_numpy(albedo).to(self.dev),
                             mats.emission.detach().clone()]
        self.params = [x.clone().requires_grad_(True)
                       for x in self.start_params]
        self.opt = adam(self.params, p["lr"])
        losses, grad = [], None
        for k in range(p["first_steps"]):
            losses.append(float(self.step()))
            if k == 0:
                # A step that kept no state got no gradient.
                b1 = self.opt.param_groups[0]["betas"][0]
                grad = [self.opt.state.get(x, {}).get(
                    "exp_avg", torch.zeros_like(x)).detach() / (1.0 - b1)
                    for x in self.params]
        self.first = {"loss": losses, "grad": grad,
                      "params": [x.detach().clone() for x in self.params]}
        self.counter.take()

    def step(self):
        mats = Materials(albedo=self.params[0].detach(),
                         emission=self.params[1].detach())
        loss, grads = dr.loss_and_grad(self.scene, self.cfg, mats,
                                       self.target)
        self.params[0].grad = grads.albedo
        self.params[1].grad = grads.emission
        self.opt.step()
        return loss

    def frame(self, i: int) -> int:
        self.step()
        return self.counter.take()

    def outputs(self) -> dict:
        return self.first

    def free(self) -> None:
        self.counter.close()
        self.scene = self.target = None

    def numbers(self, outputs: dict, ref) -> dict:
        p = self.run.params
        ids = torch.arange(self.cfg.n_pixels, dtype=torch.int64,
                           device=ref.device)
        start = [x.to(ref.device) for x in self.start_params]
        want = ref.fit(self.seed, ids, start[0], start[1], p["lr"],
                       len(outputs["loss"]), p["ref_block"])
        got = {"loss": outputs["loss"],
               "grad": [x.to(ref.device) for x in outputs["grad"]],
               "params": [x.to(ref.device) for x in outputs["params"]]}
        return check.fit_numbers(got, want, start)

    def control(self, ref, low) -> dict:
        p = self.run.params
        ids = torch.arange(self.cfg.n_pixels, dtype=torch.int64,
                           device=ref.device)
        start = [x.to(ref.device) for x in self.start_params]
        got = low.fit(self.seed, ids, start[0], start[1], p["lr"],
                      p["first_steps"], p["ref_block"])
        return self.numbers(got, ref)


def main(run, args):
    return single(run, Mode)
