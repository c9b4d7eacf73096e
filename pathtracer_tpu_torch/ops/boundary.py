"""The kernels' autograd boundary.

Every intersection kernel of the reference sits behind a ``jax.custom_vjp``
whose backward returns zero cotangents (``ops/intersect_cluster.py:278``,
``intersect_grid.py:380``, ``intersect_stream.py:148``,
``traverse_pallas.py:218``): hits are piecewise constant in everything a
gradient is taken of. Here that boundary is one ``torch.autograd.Function``
around each wrapper, with non-differentiable outputs and no gradient to any
input. The plain versions cross the same boundary on the CPU.
"""

from __future__ import annotations

import torch


class _NoGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *args):
        ctx.n_inputs = 1 + len(args)
        out = fn(*args)
        ctx.mark_non_differentiable(*out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * ctx.n_inputs


def no_gradient(fn, *args):
    """fn(*args), a tuple of tensors, as outputs that carry no gradient."""
    return _NoGradient.apply(fn, *args)
