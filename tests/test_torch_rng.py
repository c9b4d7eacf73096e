"""The port's threefry sampler against jax.random: bit for bit.

Every fixed-seed comparison between the two packages rests on this, so the
bar is equality of the f32 bit patterns, across seeds, spp indices,
bounces and pixel ids on both sides of 2^31.
"""

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.sampling import rng as ref_rng
from pathtracer_tpu_torch.sampling import rng

torch.set_num_threads(2)


def _ids(seed: int, n: int = 300) -> np.ndarray:
    r = np.random.default_rng(seed)
    edge = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                    np.uint32)
    return np.concatenate([edge, r.integers(0, 2 ** 32, n, dtype=np.uint32)])


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _port_ids(ids: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(ids.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, -5])
@pytest.mark.parametrize("spp_idx", [0, 3])
def test_bounce_uniforms_bit_equal(seed, spp_idx):
    ids = _ids(seed + 17)
    for bounce in range(4):
        ref = ref_rng.bounce_uniforms(seed, spp_idx, bounce, ids)
        got = rng.bounce_uniforms(seed, spp_idx, bounce, _port_ids(ids))
        assert got.dtype == torch.float32
        assert got.shape == (len(ids), rng.N_DRAWS)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("spp_idx", [0, 1, 5])
def test_pixel_jitter_bit_equal(seed, spp_idx):
    ids = _ids(seed)
    ref = ref_rng.pixel_jitter(seed, spp_idx, ids)
    got = rng.pixel_jitter(seed, spp_idx, _port_ids(ids))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("seed,data", [(0, 0), (42, 7), (-1, 2 ** 32 - 1),
                                       (2 ** 31 - 1, 0x3779B1)])
def test_key_and_fold_in_equal_jax(seed, data):
    ref = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    got = rng.fold_in(rng.prng_key(seed), data)
    assert [int(w) for w in got] == ref.tolist()
    assert list(rng.prng_key(seed)) == np.asarray(
        jax.random.key_data(jax.random.PRNGKey(seed))).tolist()


def test_tensor_and_int_paths_agree():
    """The scalar (Python int) and tensor forms of threefry give the same
    words, so the scalar key chain may be computed on the host."""
    k = rng.prng_key(9)
    data = [0, 5, 2 ** 31 + 3, 2 ** 32 - 1]
    as_ints = [rng.fold_in(k, x) for x in data]
    t0, t1 = rng.fold_in(k, torch.tensor(data, dtype=torch.int64))
    assert [(int(a), int(b)) for a, b in zip(t0, t1)] == as_ints


def test_uniforms_in_unit_interval():
    u = rng.bounce_uniforms(0, 0, 0, torch.arange(4096))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
