"""Counter-based Threefry-2x32 draws of the path tracer, frozen here.

A plain copy of the sampler's arithmetic as ``jax.random`` defines it
(partitionable threefry, ``fold_in`` chains ending in the absolute pixel
id, the mantissa fill of ``uniform``). The benchmark's reference draws its
own numbers with it, so it never reads the program's sampler; the draws
equal the program's bit for bit when both are right.

Every uniform is a function of (seed, spp_idx, stream, pixel_id, slot):
stream is the bounce index, or JITTER_TAG for the sub-pixel jitter. The
bounce slots are LIGHT_SEL ... FRESNEL_U. 32-bit words live in int64
tensors, masked back to 32 bits after each operation.
"""

from __future__ import annotations

import torch

LIGHT_SEL, LIGHT_U1, LIGHT_U2, BSDF_U1, BSDF_U2, RR_U, FRESNEL_U = range(7)
N_DRAWS = 7
JITTER_TAG = 0x3779B1

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32: key (k0, k1), counter (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _fold_in(key, data):
    return threefry2x32(key[0], key[1], 0, data)


def uniforms(seed: int, spp_idx: int, stream: int, pixel_ids: torch.Tensor,
             n: int) -> torch.Tensor:
    """(len(pixel_ids), n) float32 uniforms in [0, 1)."""
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    key = (0, seed & _M32)
    key = _fold_in(key, int(spp_idx) & _M32)
    key = _fold_in(key, int(stream) & _M32)
    k0, k1 = _fold_in(key, pixel_ids.to(torch.int64) & _M32)
    counter = torch.arange(n, dtype=torch.int64, device=pixel_ids.device)
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], 0, counter[None, :])
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
