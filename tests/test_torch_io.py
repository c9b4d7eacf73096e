"""The port's framebuffer I/O (io/framebuffer.py) against the reference's.

The same seeded image goes through both packages: tonemap and the .npy
dump are bit-equal, the PNG file is byte-equal through Pillow and decodes
to the same pixels through the port's own encoder (used where Pillow is
missing), and an accumulator checkpoint saved by either package loads
through the other's load_accumulator unchanged.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from pathtracer_tpu.io import framebuffer as ref_fb
from pathtracer_tpu_torch.io import framebuffer as fb


@pytest.fixture
def image():
    """Linear radiance with values below 0 and above 1 (both clamp)."""
    rng = np.random.default_rng(7)
    return (rng.random((12, 20, 3)) * 1.4 - 0.2).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_tonemap_bit_equal(image, as_tensor):
    src = torch.from_numpy(image) if as_tensor else image
    for gamma in (2.2, 1.0):
        out = fb.tonemap(src, gamma)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref_fb.tonemap(image, gamma))


def test_write_png_byte_equal(image, tmp_path):
    fb.write_png(str(tmp_path / "port.png"), torch.from_numpy(image))
    ref_fb.write_png(str(tmp_path / "ref.png"), image)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "ref.png").read_bytes()


def test_write_png_without_pillow(image, tmp_path, monkeypatch):
    """Without Pillow the port's zlib encoder writes a PNG that decodes to
    the reference's pixels."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    fb.write_png(str(tmp_path / "port.png"), image)
    monkeypatch.undo()
    ref_fb.write_png(str(tmp_path / "ref.png"), image)
    with Image.open(tmp_path / "port.png") as port, \
            Image.open(tmp_path / "ref.png") as ref:
        assert port.mode == ref.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def test_write_npy_bit_equal(image, tmp_path):
    fb.write_npy(str(tmp_path / "port.npy"), torch.from_numpy(image))
    ref_fb.write_npy(str(tmp_path / "ref.npy"), image)
    assert (tmp_path / "port.npy").read_bytes() == \
        (tmp_path / "ref.npy").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_loads_across_packages(image, tmp_path, writer):
    accum = image.reshape(-1, 3) * 7.0
    meta = {"cfg": '{"spp": 8}', "note": "resumable"}
    path = str(tmp_path / "ck.npz")
    if writer == "port":
        fb.save_accumulator(path, torch.from_numpy(accum), 7, meta)
        acc, spp_done, got_meta = ref_fb.load_accumulator(path)
    else:
        ref_fb.save_accumulator(path, accum, 7, meta)
        acc, spp_done, got_meta = fb.load_accumulator(path)
    assert acc.dtype == np.float32
    np.testing.assert_array_equal(acc, accum)
    assert spp_done == 7 and got_meta == meta
    # The same layout: the reference's keys, dtypes and no pickles.
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == ["accum", "meta", "spp_done"]
        assert z["spp_done"].dtype == np.int64
