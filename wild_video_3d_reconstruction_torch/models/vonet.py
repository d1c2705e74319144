"""VONet: patch extraction and the recurrent update (the VO model).

Counterpart of the JAX package's `models/vonet.py`: P=3 patches at RES=4,
DIM=384 context features and 128-channel matching features.

  VONet          the two stride-4 encoders and the update operator
  encode_frame   both encoders on one frame -> channel-last maps
  select_patches random, gradient-biased, mask-constrained or keypoint
                 centres (or the caller's): `draw_centres` on the host,
                 then `top_by_gradient`, `top_by_mask` or
                 `top_keypoints` (over `keypoint_response_map`) on the
                 frame's device
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


def _box_sum5(x):
    """5x5 window sums of [H, W] with zeros outside (the JAX package's
    `reduce_window(add, (5, 5), "SAME")`), as shifted adds: no
    convolution, so no TF32."""
    H, W = x.shape
    p = torch.nn.functional.pad(x, (2, 2, 2, 2))
    rows = p[:, 0:W] + p[:, 1:W + 1] + p[:, 2:W + 2] + p[:, 3:W + 3] + \
        p[:, 4:W + 4]
    return rows[0:H] + rows[1:H + 1] + rows[2:H + 2] + rows[3:H + 3] + \
        rows[4:H + 4]


def keypoint_response_map(image):
    """Shi-Tomasi (min-eigenvalue) corner response on the 1/4 grid with
    3x3 non-max suppression, the weight-free keypoint selector of the JAX
    package. image [H, W, 3] uint8 -> [(H-1)//4, (W-1)//4], zero at
    non-maxima."""
    img = image.float()
    gray = img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299
    gx = torch.zeros_like(gray)
    gx[:, 1:-1] = 0.5 * (gray[:, 2:] - gray[:, :-2])
    gy = torch.zeros_like(gray)
    gy[1:-1, :] = 0.5 * (gray[2:, :] - gray[:-2, :])
    sxx, syy, sxy = _box_sum5(gx * gx), _box_sum5(gy * gy), _box_sum5(gx * gy)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    resp = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    resp = avg_pool2d(resp[:-1, :-1, None], 4)[..., 0]
    pooled = torch.nn.functional.max_pool2d(resp[None, None], 3, stride=1,
                                            padding=1)[0, 0]
    return torch.where(resp >= pooled, resp, 0.0)


def top_keypoints(keypoint_map, M, h, w, fallback):
    """The M strongest responses of keypoint_map as centres [M, 2] (x, y)
    clipped to [1, w-2] x [1, h-2], strongest first (ties: the lower flat
    index first, as `lax.top_k`); a slot whose response is not positive
    takes that slot's centre of fallback [M, 2]."""
    gw = keypoint_map.shape[1]
    score, idx = torch.sort(keypoint_map.reshape(-1), descending=True,
                            stable=True)
    score, idx = score[:M], idx[:M]
    cx = (idx % gw).clamp(1, w - 2).float()
    cy = torch.div(idx, gw, rounding_mode="floor").clamp(1, h - 2).float()
    ok = score > 0
    return torch.stack([torch.where(ok, cx, fallback[:, 0]),
                        torch.where(ok, cy, fallback[:, 1])], dim=-1)


def top_by_mask(cand, jitter, M, mask):
    """The M centres of cand [n, 2] whose full-resolution pixel the mask
    [H, W] (True = static, usable) keeps, chosen at random among them by
    jitter [n] in [0, 1): the top M of `kept + 1e-3 * jitter`, in
    ascending order of it."""
    mh, mw = mask.shape
    x, y = cand[:, 0].long(), cand[:, 1].long()
    ok = mask[(RES * y).clamp(0, mh - 1), (RES * x).clamp(0, mw - 1)]
    score = ok.float() + 1e-3 * jitter
    return cand[torch.argsort(score, stable=True)[-M:]]


def draw_centres(generator, n, h, w):
    """n uniform integer centres in [1, w-1) x [1, h-1), float [n, 2]
    (x, y) on the generator's device (the x draws, then the y draws)."""
    x = torch.randint(1, w - 1, (n,), generator=generator,
                      device=generator.device)
    y = torch.randint(1, h - 1, (n,), generator=generator,
                      device=generator.device)
    return torch.stack([x, y], dim=-1).float()


def top_by_gradient(cand, M, gradient_map):
    """The M centres of cand [n, 2] with the largest pooled gradient, in
    ascending order of it (a stable sort: ties keep their draw order)."""
    gh, gw = gradient_map.shape
    x, y = cand[:, 0].long(), cand[:, 1].long()
    score = gradient_map[y.clamp(0, gh - 1), x.clamp(0, gw - 1)]
    return cand[torch.argsort(score, stable=True)[-M:]]


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
    cand = draw_centres(generator, n, h, w).to(device)
    return cand if gradient_map is None else \
        top_by_gradient(cand, M, gradient_map)


def gather_patches(feats: FrameFeatures, image, coords):
    """(imap [M, 384], gmap [M, 128, P, P], clr [M, 3] RGB 0..255,
    patches [M, 3, P, P] of (x, y, inverse depth = 1))."""
    M = coords.shape[0]
    imap_p = patchify(feats.imap.float(), coords, 0)[:, :, 0, 0]
    gmap_p = patchify(feats.fmap.float(), coords, P // 2)

    norm = normalize_image(image)
    clr = patchify(norm, RES * (coords + 0.5), 0)[:, :, 0, 0]
    clr = (clr.flip(-1) + 0.5) * (255.0 / 2)          # BGR -> RGB

    offs = torch.arange(P, dtype=torch.float32, device=coords.device) - P // 2
    px = (coords[:, None, None, 0] + offs[None, None, :]).expand(M, P, P)
    py = (coords[:, None, None, 1] + offs[None, :, None]).expand(M, P, P)
    pd = torch.ones((M, P, P), dtype=torch.float32, device=coords.device)
    patches = torch.stack([px, py, pd], dim=1)
    return (imap_p.to(feats.imap.dtype), gmap_p.to(feats.fmap.dtype), clr,
            patches)
