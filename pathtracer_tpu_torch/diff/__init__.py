"""Differentiable rendering: gradients of an image loss w.r.t. materials."""
