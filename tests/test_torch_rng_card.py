"""On the card: the sampler kernel (ops/csrc/threefry.cu) against the plain
int64 version (sampling/rng.py:_per_pixel_plain), bit for bit as f32 bit
patterns, and a full bench frame through it against the same frame drawn
by the plain version. Skips without a CUDA device. The file imports no JAX,
so on a machine without it run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_rng_card.py -q
"""

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.sampling import rng
from pathtracer_tpu_torch.scene.builder import build_scene

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")

EDGE = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]
SEEDS = [0, 1, 123456, -5, 2 ** 31 - 1]
SPP = [0, 3, 2 ** 31 - 1]
STREAMS = ["jitter", 0, 1, 2, 3]  # pixel_jitter, bounce_uniforms' bounces


def _ids(n: int, seed: int) -> np.ndarray:
    """n uint32 ids: the edge ids first, then seeded random ones."""
    r = np.random.default_rng(seed & 0xFFFFFFFF)
    ids = np.concatenate([np.array(EDGE, np.uint32),
                          r.integers(0, 2 ** 32, max(n - len(EDGE), 0),
                                     dtype=np.uint32)])
    return ids[:n]


def _forms(ids: np.ndarray, card) -> list:
    """The ids on the card as int64, as int32 (ids >= 2^31 wrapped) and as
    a non-contiguous int64 view."""
    as64 = torch.from_numpy(ids.astype(np.int64)).to(card)
    as32 = torch.from_numpy(ids.astype(np.int32)).to(card)
    strided = torch.stack([as64, as64 + 1], dim=1)[:, 0]
    assert not strided.is_contiguous() or len(ids) <= 1
    return [as64, as32, strided]


def _draw(stream, seed, spp, ids):
    if stream == "jitter":
        return rng.pixel_jitter(seed, spp, ids)
    return rng.bounce_uniforms(seed, spp, stream, ids)


def _plain(stream, seed, spp, ids):
    tag = rng._JITTER_TAG if stream == "jitter" else stream
    n = 2 if stream == "jitter" else rng.N_DRAWS
    return rng._per_pixel_plain(rng._stream_key(seed, spp, tag), ids, n)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _check(seed, ids, card, want_of):
    """Every spp index and stream, every form of the ids: one launch per
    call and the plain version's bits."""
    for spp in SPP:
        for stream in STREAMS:
            want = want_of(stream, spp)
            for form in _forms(ids, card):
                n0 = rng.SAMPLER_LAUNCHES
                got = _draw(stream, seed, spp, form)
                assert got.dtype == torch.float32 and got.device == card
                assert got.shape == want.shape
                assert rng.SAMPLER_LAUNCHES == n0 + (len(ids) > 0)
                assert torch.equal(_bits(got), _bits(want.to(card))), (
                    seed, spp, stream, form.dtype, len(ids))


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_equals_plain_at_full_width(seed):
    """2^20 + 17 seeded ids after the edge ids; the plain version run on
    the card's int64 tensors."""
    card = torch.device("cuda", 0)
    ids = _ids(len(EDGE) + 2 ** 20 + 17, seed)
    as64 = torch.from_numpy(ids.astype(np.int64)).to(card)
    _check(seed, ids, card,
           lambda stream, spp: _plain(stream, seed, spp, as64))


@pytest.mark.card
@pytest.mark.parametrize("n_ids", [0, 1, 255, 256, 257])
def test_kernel_equals_plain_on_the_host(n_ids):
    """Around the block width (256) and empty: against the plain version
    on the CPU, every seed."""
    card = torch.device("cuda", 0)
    for seed in SEEDS:
        ids = _ids(n_ids, seed)
        host = torch.from_numpy(ids.astype(np.int64))
        _check(seed, ids, card,
               lambda stream, spp: _plain(stream, seed, spp, host))


@pytest.mark.card
def test_bench_frame_through_the_kernel(monkeypatch):
    """A full bench frame launches the kernel 5 times (the jitter and 4
    bounces), and its image equals, bit for bit, the same frame drawn by
    the plain version on the host and moved to the card."""
    card = torch.device("cuda", 0)
    cfg = pt.PRESETS["bench"]
    scene = build_scene(cfg.scene)
    if cfg.use_bvh:
        scene = with_bvh(scene)
    scene = prepare_accel(scene, cfg).to(card)
    with torch.inference_mode():
        n0 = rng.SAMPLER_LAUNCHES
        img = pt.render(scene, cfg)
        torch.cuda.synchronize()
        assert rng.SAMPLER_LAUNCHES == n0 + 1 + cfg.max_depth == n0 + 5

        def plain_on_host(key, pixel_ids, n):
            return rng._per_pixel_plain(key, pixel_ids.cpu(), n).to(
                pixel_ids.device)

        monkeypatch.setattr(rng, "_per_pixel", plain_on_host)
        plain = pt.render(scene, cfg)
        torch.cuda.synchronize()
    assert rng.SAMPLER_LAUNCHES == n0 + 5
    assert img.shape == (cfg.height, cfg.width, 3)
    assert torch.equal(_bits(img), _bits(plain))
