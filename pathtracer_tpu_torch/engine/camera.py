"""Primary-ray generation (the reference's ``engine/camera.py``)."""

from __future__ import annotations

import torch


def tiled_pixel_ids(band_start: int, n: int, width: int, tile_w: int = 32,
                    tile_h: int = 16, device=None) -> torch.Tensor:
    """Pixel ids of a row-major band, reordered so consecutive rays form
    (tile_w x tile_h) screen tiles: a 512-ray cull block is then one compact
    tile instead of a scanline strip. Falls back to arange when the band is
    not tile-aligned. Returns int64 ids.
    """
    j = torch.arange(n, dtype=torch.int64, device=device)
    if width % tile_w or n % (width * tile_h):
        return band_start + j
    per_tile = tile_w * tile_h
    tiles_per_row = width // tile_w
    tile_id = j // per_tile
    within = j - tile_id * per_tile
    v = within // tile_w
    u = within - v * tile_w
    ty = tile_id // tiles_per_row
    tx = tile_id - ty * tiles_per_row
    return band_start + (ty * tile_h + v) * width + tx * tile_w + u


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return v / n[..., None]


def camera_rays(camera, width: int, height: int, jitter: torch.Tensor,
                pixel_ids: torch.Tensor):
    """Rays for the given absolute pixel ids (row-major y*width+x).

    jitter: (N, 2) in [0,1); pixel_ids: (N,) integer. Returns (o, d), each
    (N, 3) float32, on the ids' device.
    """
    pos = camera.position
    w = _normalize(camera.look_at - pos)
    u = _normalize(torch.linalg.cross(camera.up, w))
    v = torch.linalg.cross(w, u)
    half_h = torch.tan(camera.fov_y / 2.0)
    half_w = half_h * (width / height)

    pixel_ids = pixel_ids.to(torch.int64)
    ys = pixel_ids // width
    xs = pixel_ids - ys * width
    sx = ((xs + jitter[:, 0]) / width) * 2.0 - 1.0
    sy = 1.0 - ((ys + jitter[:, 1]) / height) * 2.0
    d = (
        w[None, :]
        + sx[:, None] * (half_w * u)[None, :]
        + sy[:, None] * (half_h * v)[None, :]
    )
    d = _normalize(d)
    o = pos.expand_as(d).contiguous()
    return o, d
