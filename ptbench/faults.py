"""Faults planted in the program's timed path, to show that the check
catches them (`--fault <name>`, used by the tests and by limits.py; a
benchmark run never sets it). Each patches the program in this process:

  answer      every 32nd ray's radiance altered where trace_sample makes it
  half_batch  half of the rays left out: trace_sample renders the first
              half of its ids (zeros for the rest); the fit's loss is the
              mean over the first half of the frame's rows
  unchanged   the fit's optimizer step returns its state unchanged
  exchange    the all-gather between ranks left out: each rank takes its
              own slice for every rank's
"""

from __future__ import annotations

import contextlib

import torch

_UNDO: list = []


def _patch(owner, attr, new) -> None:
    _UNDO.append((owner, attr, getattr(owner, attr)))
    setattr(owner, attr, new)


def _answer():
    from pathtracer_tpu_torch.engine import wavefront

    real = wavefront.trace_sample

    def altered(*args, **kw):
        out = real(*args, **kw)
        rad = out[0] if isinstance(out, tuple) else out
        bad = rad.clone()
        bad[::32] = bad[::32] * 1.5 + 0.05
        return (bad,) + tuple(out[1:]) if isinstance(out, tuple) else bad

    _patch(wavefront, "trace_sample", altered)


def _half_batch():
    from pathtracer_tpu_torch.diff import render as dr
    from pathtracer_tpu_torch.engine import wavefront

    real = wavefront.trace_sample

    def half(geometry, materials, camera, lights, cfg, pixel_ids, spp_idx,
             with_stats=False):
        n = pixel_ids.shape[0]
        out = real(geometry, materials, camera, lights, cfg,
                   pixel_ids[:n // 2], spp_idx, with_stats=with_stats)
        rad = out[0] if with_stats else out
        rad = torch.cat([rad, rad.new_zeros((n - n // 2, 3))])
        return (rad, out[1]) if with_stats else rad

    _patch(wavefront, "trace_sample", half)
    real_loss = dr.loss_and_grad

    def half_mean(img, target):
        rows = img.shape[0] // 2
        return torch.mean((img[:rows] - target[:rows]) ** 2)

    def loss_and_grad(scene, cfg, materials, target, loss_fn=None):
        return real_loss(scene, cfg, materials, target, loss_fn=half_mean)

    _patch(dr, "loss_and_grad", loss_and_grad)


def _unchanged():
    _patch(torch.optim.Adam, "step", lambda self, closure=None: None)


def _exchange():
    from pathtracer_tpu_torch.parallel import mesh

    def local_only(self, x):
        return torch.cat([x] * self.size)

    _patch(mesh.Mesh, "all_gather", local_only)


FAULTS = {"answer": _answer, "half_batch": _half_batch,
          "unchanged": _unchanged, "exchange": _exchange}


def apply(name) -> None:
    if name is not None:
        FAULTS[name]()


@contextlib.contextmanager
def planted(name):
    """The fault `name` for the duration, then the program as it was."""
    mark = len(_UNDO)
    apply(name)
    try:
        yield
    finally:
        while len(_UNDO) > mark:
            owner, attr, old = _UNDO.pop()
            setattr(owner, attr, old)
