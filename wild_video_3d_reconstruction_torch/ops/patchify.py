"""Bilinear patch extraction from channel-last feature maps.

Counterpart of the JAX package's `ops/patchify.py`: gather a
(2R+2)x(2R+2) neighbourhood at floor(coord), zero outside the map, and
blend the four integer shifts into (2R+1)^2 patches. Runs once per frame
over M patch centres, so a plain gather is enough.
"""

from __future__ import annotations

import torch


def patchify(fmap, coords, radius):
    """fmap [H, W, C], coords [M, 2] (x, y) -> [M, C, 2R+1, 2R+1]."""
    H, W, C = fmap.shape
    D = 2 * radius + 2
    x0 = torch.floor(coords[:, 0])
    y0 = torch.floor(coords[:, 1])
    dx = (coords[:, 0] - x0)[:, None, None, None]
    dy = (coords[:, 1] - y0)[:, None, None, None]

    off = torch.arange(D, device=fmap.device) - radius
    ys = y0[:, None].long() + off[None, :]
    xs = x0[:, None].long() + off[None, :]
    in_y = (ys >= 0) & (ys < H)
    in_x = (xs >= 0) & (xs < W)
    grid = fmap[ys.clamp(0, H - 1)[:, :, None], xs.clamp(0, W - 1)[:, None, :]]
    mask = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    grid = torch.where(mask, grid, torch.zeros((), dtype=grid.dtype,
                                               device=grid.device))

    d = 2 * radius + 1
    out = ((1 - dy) * (1 - dx) * grid[:, :d, :d]
           + (1 - dy) * dx * grid[:, :d, 1:]
           + dy * (1 - dx) * grid[:, 1:, :d]
           + dy * dx * grid[:, 1:, 1:])
    return out.permute(0, 3, 1, 2)


def avg_pool2d(x, k):
    """k x k average pooling with stride k on [H, W, C] or [N, H, W, C]."""
    if k == 1:
        return x
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, c = x.shape
    x = x[:, :h - h % k, :w - w % k]
    x = x.reshape(n, h // k, k, w // k, k, c).mean(dim=(2, 4))
    return x[0] if squeeze else x
