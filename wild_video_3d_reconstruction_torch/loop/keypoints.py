"""Keypoint detection, description and matching for loop closure.

Counterpart of the JAX package's `loop/keypoints.py`:

  detect    Shi-Tomasi corners (the structure tensor's smaller eigenvalue
            over a 5x5 box), a (2r+1)^2 max-pool NMS, an 8 px border, the
            top K by response (ties to the lower pixel index, as
            `jax.lax.top_k`: a stable descending sort, since `torch.topk`
            promises no order among ties and NMS leaves many zeros), and a
            1-D quadratic sub-pixel offset per axis
  describe  L2-normalised bilinear samples of the /4 matching features at
            the keypoints (`ops/patchify.py`)
  match     mutual nearest neighbours of the descriptor similarities with
            a ratio test (`torch.argmax` takes the first maximum, as
            `jnp.argmax`)

Every function runs on the device of its inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.patchify import patchify


def _box_filter(x, k):
    """Separable k x k box filter on [H, W] with edge padding, summed in
    the JAX package's order."""
    pad = k // 2
    H, W = x.shape
    xpad = F.pad(x[None, None], (0, 0, pad, pad), mode="replicate")[0, 0]
    xv = sum(xpad[i:i + H] for i in range(k)) / k
    xpad = F.pad(xv[None, None], (pad, pad, 0, 0), mode="replicate")[0, 0]
    return sum(xpad[:, i:i + W] for i in range(k)) / k


def detect(image, num_keypoints=1024, nms_radius=4):
    """Shi-Tomasi corners of image [H, W, 3] uint8 (a tensor). Returns
    (xy [K, 2] fp32 full-resolution, score [K]); weak or padded slots
    score 0."""
    g = image.float().mean(dim=-1)
    gx = F.pad(0.5 * (g[:, 2:] - g[:, :-2]), (1, 1, 0, 0))
    gy = F.pad(0.5 * (g[2:, :] - g[:-2, :]), (0, 0, 1, 1))
    Ixx = _box_filter(gx * gx, 5)
    Iyy = _box_filter(gy * gy, 5)
    Ixy = _box_filter(gx * gy, 5)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    raw = 0.5 * (tr - torch.sqrt((tr * tr - 4 * det).clamp(min=0.0)))

    # NMS: keep the maxima of a (2r+1)^2 window (-inf outside the image)
    k = 2 * nms_radius + 1
    pooled = F.max_pool2d(raw[None, None], k, stride=1,
                          padding=nms_radius)[0, 0]
    resp = torch.where((raw >= pooled) & (raw > 1e-3), raw, 0.0)
    H, W = resp.shape
    border = 8
    yy = torch.arange(H, device=resp.device)[:, None]
    xx = torch.arange(W, device=resp.device)[None, :]
    resp = torch.where((yy >= border) & (yy < H - border) &
                       (xx >= border) & (xx < W - border), resp, 0.0)

    score, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    score, idx = score[:num_keypoints], idx[:num_keypoints]
    xi = idx % W
    yi = idx // W

    # sub-pixel: a quadratic through the unsuppressed response per axis
    def peak_offset(m, p, c):
        denom = m - 2.0 * c + p
        off = torch.where(denom.abs() > 1e-9, 0.5 * (m - p) / denom, 0.0)
        return off.clamp(-0.5, 0.5)

    c = raw[yi, xi]
    dx = peak_offset(raw[yi, (xi - 1).clamp(min=0)],
                     raw[yi, (xi + 1).clamp(max=W - 1)], c)
    dy = peak_offset(raw[(yi - 1).clamp(min=0), xi],
                     raw[(yi + 1).clamp(max=H - 1), xi], c)
    xy = torch.stack([xi.float() + dx, yi.float() + dy], dim=-1)
    return xy, score


def describe(fmap, xy, scale=4.0):
    """Descriptors [K, C] from fmap [H/4, W/4, C] at full-resolution
    keypoints xy [K, 2]."""
    desc = patchify(fmap.float(), xy / scale, 0)[:, :, 0, 0]
    return desc / torch.linalg.norm(desc, dim=-1,
                                    keepdim=True).clamp(min=1e-8)


def match(desc0, desc1, valid0, valid1, ratio=0.95):
    """Mutual nearest neighbours with a ratio test. Returns (idx0 [K0],
    idx1 [K0], ok [K0]): keypoint k of set 0, its best in set 1, and
    whether the pair is accepted."""
    sim = desc0.float() @ desc1.float().T
    sim = torch.where(valid0[:, None] & valid1[None, :], sim, -2.0)
    best1 = torch.argmax(sim, dim=1)
    best0 = torch.argmax(sim, dim=0)
    k0 = torch.arange(sim.shape[0], device=sim.device)
    mutual = best0[best1] == k0
    top2 = torch.topk(sim, 2, dim=1).values
    ok = mutual & (top2[:, 1] < ratio * top2[:, 0]) & (top2[:, 0] > 0.0) & \
        valid0
    return k0, best1, ok
