"""The numbers that decide `correct`, each compared with its limit in the
cell's file, and the reference runs behind them."""

from __future__ import annotations

import statistics

import torch

from .harness import ROOT
from .reference import fit as ref_fit
from .reference import scenes, tracer


def bad_share(prog: torch.Tensor, ref: torch.Tensor, atol: float,
              rtol: float) -> float:
    """Share of pixels with a channel off the reference by more than
    atol + rtol * |ref| (a non-finite value is off)."""
    ok = ((prog - ref).abs() <= atol + rtol * ref.abs()).all(dim=1)
    return float((~ok).double().mean())


def ref_config(preset: dict) -> dict:
    if preset.get("mis"):
        raise ValueError("the reference has no MIS path")
    return {k: preset[k] for k in ("width", "height", "max_depth",
                                   "rr_start")}


class Reference:
    """The reference's scene on `device`, in `dtype`."""

    def __init__(self, config: dict, device, dtype=torch.float32):
        self.scene = scenes.build(config["preset"]["scene"], str(ROOT))
        self.geo = tracer.Geometry(self.scene, device, dtype)
        self.cfg = ref_config(config["preset"])
        self.device = device

    def pixels(self, seed: int, spp: int, ids: torch.Tensor,
               block: int) -> torch.Tensor:
        s = self.scene
        return tracer.render_blocks(self.geo, s, self.cfg, seed, spp, ids,
                                    s["albedo"].to(self.device),
                                    s["emission"].to(self.device), block)

    def fit(self, seed, ids, albedo0, emission0, lr, n_steps, block):
        return ref_fit.follow(self.geo, self.scene, self.cfg, seed, ids,
                              albedo0, emission0, lr, n_steps, block)


def leaf_gap(prog: list, ref: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's.
    Leaves whose reference norm is under a thousandth of the median
    leaf's (nought to rounding) are left out."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = statistics.median(rn)
    gaps = [abs(p - r) / max(r, med) for p, r in zip(pn, rn)
            if r >= 1e-3 * med]
    return max(gaps) if gaps else float("nan")


def fit_numbers(prog: dict, ref: dict, start: list) -> dict:
    """loss_gap, grad_gap, change_gap of the program's first steps (prog:
    loss, grad, params as ref_fit.follow returns them) against the
    reference's, both from the parameters `start`."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["loss"], ref["loss"]))
    change_p = [a - b for a, b in zip(prog["params"], start)]
    change_r = [a - b for a, b in zip(ref["params"], start)]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(change_p, change_r)}
