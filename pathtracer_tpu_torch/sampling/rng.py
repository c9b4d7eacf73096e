"""Counter-based threefry sampler, bit-exact with ``jax.random``.

Every uniform is a pure function of (seed, spp_idx, bounce, pixel_id, slot),
computed with Threefry-2x32 through a fold_in chain that ends in the
absolute pixel id, exactly as the reference's ``sampling/rng.py`` does with
``jax.random`` (partitionable threefry: ``uniform(key, (n,))`` draws word
``i`` from the counter pair ``(0, i)`` and xors the two output words).

torch has no uint32 shifts on the CPU, so the 32-bit words live in int64
tensors and every operation masks back to 32 bits. The same functions take
Python ints, which is how the scalar part of the chain (seed, spp, tag) is
computed without launching anything.

Draw layout per (spp_idx, bounce), fixed at N_DRAWS slots:

    0: light-triangle selection      3: BSDF u1 (cosine r^2)
    1: light barycentric u1          4: BSDF u2 (cosine phi)
    2: light barycentric u2          5: Russian-roulette u
    6: Fresnel reflect/refract u (dielectrics)
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

(LIGHT_SEL, LIGHT_U1, LIGHT_U2, BSDF_U1, BSDF_U2, RR_U,
 FRESNEL_U) = range(7)
N_DRAWS = 7

_JITTER_TAG = 0x3779B1  # distinct stream tag for pixel jitter
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 of counter words (x0, x1) under key (k0, k1).

    Arguments are Python ints or int64 tensors holding uint32 values; they
    broadcast against each other. Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the pair (0, seed)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return 0, seed & _M32


def fold_in(key, data):
    """``jax.random.fold_in``: the key hashed with the counter (0, data)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    return threefry2x32(key[0], key[1], 0, data)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> f32 in [0, 1) by jax.random.uniform's mantissa fill."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _stream_key(seed, spp_idx, tag):
    return fold_in(fold_in(prng_key(seed), spp_idx), tag)


def _per_pixel(key, pixel_ids: torch.Tensor, n: int) -> torch.Tensor:
    """(len(pixel_ids), n) uniforms; row i depends only on pixel_ids[i]."""
    k0, k1 = fold_in(key, pixel_ids)
    counter = torch.arange(n, dtype=torch.int64, device=pixel_ids.device)
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], 0, counter[None, :])
    return _bits_to_unit_float(y0 ^ y1)


def pixel_jitter(seed, spp_idx, pixel_ids: torch.Tensor) -> torch.Tensor:
    """(N, 2) uniforms in [0,1) for sub-pixel camera-ray jitter.

    pixel_ids are absolute row-major ids (y * width + x), any integer dtype,
    read as uint32.
    """
    with span("sampler"):
        return _per_pixel(_stream_key(seed, spp_idx, _JITTER_TAG),
                          pixel_ids, 2)


def bounce_uniforms(seed, spp_idx, bounce, pixel_ids: torch.Tensor
                    ) -> torch.Tensor:
    """(N, N_DRAWS) uniforms for one bounce of the given pixels' paths."""
    with span("sampler"):
        return _per_pixel(_stream_key(seed, spp_idx, bounce), pixel_ids,
                          N_DRAWS)
