"""VONet: patch extraction and the recurrent update (the VO model).

Counterpart of the JAX package's `models/vonet.py`: P=3 patches at RES=4,
DIM=384 context features and 128-channel matching features.

  VONet          the two stride-4 encoders and the update operator
  encode_frame   both encoders on one frame -> channel-last maps
  select_patches random or gradient-biased centres (or the caller's)
  gather_patches imap / gmap / colour / (x, y, d) patch gathers
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.patchify import avg_pool2d, patchify
from .extractor import BasicEncoder4
from .update import UpdateOperator

P = 3
RES = 4
DIM = 384
FDIM = 128


class VONet(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        self.fnet = BasicEncoder4(FDIM, "instance", generator)
        self.inet = BasicEncoder4(DIM, "none", generator)
        self.update = UpdateOperator(P, generator)


def init_vonet(seed=0):
    """A CPU VONet with weights drawn from `seed` (Kaiming-normal convs,
    torch-default linears)."""
    return VONet(torch.Generator().manual_seed(seed)).eval()


class FrameFeatures(NamedTuple):
    fmap: torch.Tensor    # [H/4, W/4, 128] matching features (already /4)
    imap: torch.Tensor    # [H/4, W/4, 384] context features (already /4)


def normalize_image(image):
    """uint8 [H, W, 3] (BGR) -> float in [-0.5, 1.5]."""
    return 2.0 * (image.float() / 255.0) - 0.5


@torch.no_grad()
def encode_frame(net: VONet, image, compute_dtype=torch.bfloat16):
    """image [H, W, 3] uint8 -> FrameFeatures at 1/4 resolution, scaled
    by 1/4."""
    x = normalize_image(image).permute(2, 0, 1)[None].to(compute_dtype)
    fmap = net.fnet(x) / 4.0
    imap = net.inet(x) / 4.0
    return FrameFeatures(fmap[0].permute(1, 2, 0), imap[0].permute(1, 2, 0))


def image_gradient_map(image):
    """Pooled luminance-gradient magnitude [(H-1)//4, (W-1)//4]."""
    norm = normalize_image(image)
    gray = ((norm + 0.5) * (255.0 / 2)).sum(dim=-1)
    dx = gray[:-1, 1:] - gray[:-1, :-1]
    dy = gray[1:, :-1] - gray[:-1, :-1]
    g = torch.sqrt(dx * dx + dy * dy)
    return avg_pool2d(g[..., None], 4)[..., 0]


def select_patches(generator, M, h, w, gradient_map=None, oversample=3,
                   coords=None, device="cpu"):
    """M patch centres on the 1/4-resolution grid, float [M, 2] (x, y).

    Uniform integers in [1, w-1) x [1, h-1), or with a gradient map the
    top-M of `oversample` * M such draws by pooled gradient. `coords`
    given by the caller are returned as they are (the parity tests feed
    the JAX run's draws, since jax.random cannot be reproduced here).
    """
    if coords is not None:
        return torch.as_tensor(np.array(coords, dtype=np.float32),
                               device=device)
    n = M if gradient_map is None else oversample * M
    x = torch.randint(1, w - 1, (n,), generator=generator,
                      device=generator.device).to(device)
    y = torch.randint(1, h - 1, (n,), generator=generator,
                      device=generator.device).to(device)
    if gradient_map is not None:
        gh, gw = gradient_map.shape
        score = gradient_map[y.clamp(0, gh - 1), x.clamp(0, gw - 1)]
        top = torch.argsort(score, stable=True)[-M:]
        x, y = x[top], y[top]
    return torch.stack([x, y], dim=-1).float()


def gather_patches(feats: FrameFeatures, image, coords):
    """(imap [M, 384], gmap [M, 128, P, P], clr [M, 3] RGB 0..255,
    patches [M, 3, P, P] of (x, y, inverse depth = 1))."""
    M = coords.shape[0]
    imap_p = patchify(feats.imap.float(), coords, 0)[:, :, 0, 0]
    gmap_p = patchify(feats.fmap.float(), coords, P // 2)

    norm = normalize_image(image)
    clr = patchify(norm, RES * (coords + 0.5), 0)[:, :, 0, 0]
    clr = (clr[:, [2, 1, 0]] + 0.5) * (255.0 / 2)

    offs = torch.arange(P, dtype=torch.float32, device=coords.device) - P // 2
    px = (coords[:, None, None, 0] + offs[None, None, :]).expand(M, P, P)
    py = (coords[:, None, None, 1] + offs[None, :, None]).expand(M, P, P)
    pd = torch.ones((M, P, P), dtype=torch.float32, device=coords.device)
    patches = torch.stack([px, py, pd], dim=1)
    return (imap_p.to(feats.imap.dtype), gmap_p.to(feats.fmap.dtype), clr,
            patches)
