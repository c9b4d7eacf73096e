"""Framebuffer output: accumulate → tonemap → PNG/npy, plus resume files
(the reference's ``io/framebuffer.py``).

Linear-radiance images are written as .npy, display images as
gamma-encoded PNG, and long renders checkpoint the (accumulated radiance,
sample count) pair so they can resume exactly: samples are keyed by spp
index, so a resumed render adds the same samples in the same order.

Every function takes a tensor on any device or an array; tensors come to
the host here and nowhere earlier. The checkpoint is the reference's
``.npz`` layout (``accum`` f32, ``spp_done`` int64, ``meta`` a JSON string,
read with ``allow_pickle=False``), so each package resumes the other's.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tonemap(img, gamma: float = 2.2) -> np.ndarray:
    """Linear radiance → uint8 sRGB-ish display image (clamp + gamma)."""
    img = np.clip(np.asarray(to_host(img), np.float32), 0.0, 1.0)
    img = img ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (one IDAT, no row
    filter): the encoder used where Pillow is not installed."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)],
                          axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path: str, img, gamma: float = 2.2) -> None:
    """Write a linear-radiance (H, W, 3) image as PNG: through Pillow, as
    the reference does, or through the zlib encoder above without it."""
    rgb = tonemap(img, gamma)
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(_png_bytes(rgb))
        return
    Image.fromarray(rgb).save(path)


def write_npy(path: str, img) -> None:
    np.save(path, np.asarray(to_host(img), np.float32))


def save_accumulator(path: str, accum, spp_done: int,
                     meta: dict | None = None) -> None:
    """Checkpoint a partially accumulated render (resumable)."""
    np.savez(
        path,
        accum=np.asarray(to_host(accum), np.float32),
        spp_done=np.int64(spp_done),
        meta=json.dumps(meta or {}),
    )


def load_accumulator(path: str):
    """Returns (accum, spp_done, meta) from save_accumulator output."""
    z = np.load(path, allow_pickle=False)
    return z["accum"], int(z["spp_done"]), json.loads(str(z["meta"]))
