"""Dense per-pixel geometry (the DROID-style engine's operations).

Counterpart of the JAX package's `ops/dense.py`, on tensors of one
device (the device of the inputs):

  iproj_dense          disparity maps -> homogeneous points (x_n, y_n, 1, d)
  projmap              dense reprojection coordinates and validity of
                       frames ii into frames jj
  frame_distance       mean-flow keyframe distance, blended with the
                       translation-only flow by beta
  depth_filter         multi-view support counts of one frame's disparities
  dense_ba             Gauss-Newton over a stride-s pixel grid through the
                       sparse BA (`ba.gauss_newton._bundle_adjust_impl`)
  corr_volume          all-pairs feature correlation (fp32 product)
  corr_pyramid         average-pooled target pyramid
  corr_index           bilinear (2r+1)^2 window of each source pixel
  corr_lookup_pyramid  those windows over every level

Decided differences from the JAX package:

* `dense_ba` accumulates each grid patch's depth blocks through the BA's
  per-patch edge table (`per_patch_cap`: the most edges any frame is the
  source of) instead of the one-hot [E*M, n*M] product the JAX call
  builds with the cap unset: the same sums, without a table that reaches
  16 GB at 384x512 and 24 frames.
* `frame_distance` indexes the disparities once (`projmap(poses, disps,
  ...)`); the JAX function indexes them twice (`projmap(poses, disps[ii],
  ...)` indexes again by ii, clamped), which agrees only for one edge,
  the only way the dense VO calls it.

No Pallas kernel stands behind any of them: plain PyTorch. The
correlation product runs in fp32, as the JAX `preferred_element_type`
(PyTorch's default matmul precision on the card has no TF32).
"""

from __future__ import annotations

import torch

from ..ba.gauss_newton import BAConfig, _bundle_adjust_impl
from . import lie


def _grid(ht, wd, device, dtype=torch.float32):
    """(x, y) pixel grids [ht, wd]."""
    x = torch.arange(wd, dtype=dtype, device=device)
    y = torch.arange(ht, dtype=dtype, device=device)
    return x[None, :].expand(ht, wd), y[:, None].expand(ht, wd)


def iproj_dense(disps, intrinsics):
    """Back-project disparity maps: [N, H, W] -> [N, H, W, 4]."""
    _, ht, wd = disps.shape
    fx, fy, cx, cy = intrinsics.unbind(-1)
    x, y = _grid(ht, wd, disps.device, disps.dtype)
    X = ((x - cx) / fx).expand(disps.shape)
    Y = ((y - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def projmap(poses, disps, intrinsics, ii, jj):
    """Dense reprojection of frames ii (disps [N, H, W]) into frames jj.

    Returns (coords [E, H, W, 2], valid [E, H, W] fp32)."""
    X0 = iproj_dense(disps[ii], intrinsics)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    X1 = lie.se3_act4(Gij[:, None, None, :], X0)
    Z = X1[..., 2]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    d = 1.0 / Z.clamp(min=0.1)
    coords = torch.stack([fx * X1[..., 0] * d + cx,
                          fy * X1[..., 1] * d + cy], dim=-1)
    return coords, (Z > 0.2).float()


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3):
    """Mean-flow distance [E] of frames ii to frames jj (the keyframe
    metric): beta x the full flow + (1 - beta) x the flow with the
    rotations removed, each averaged over the valid pixels."""
    ht, wd = disps.shape[-2:]
    x, y = _grid(ht, wd, disps.device, disps.dtype)
    base = torch.stack([x, y], dim=-1)
    poses_t = poses.clone()
    poses_t[:, 3:7] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=poses.device)

    def mean_flow(c, v):
        f = torch.linalg.norm(c - base, dim=-1)
        return (f * v).sum((-2, -1)) / v.sum((-2, -1)).clamp(min=1.0)

    full = mean_flow(*projmap(poses, disps, intrinsics, ii, jj))
    tonly = mean_flow(*projmap(poses_t, disps, intrinsics, ii, jj))
    return beta * full + (1 - beta) * tonly


def depth_filter(poses, disps, intrinsics, ix, thresh=0.1):
    """Support counts [H, W] of frame ix's disparities: the other frames
    whose disparity at the reprojected pixel (rounded) agrees with the
    reprojected inverse depth within thresh."""
    n, ht, wd = disps.shape
    X0 = iproj_dense(disps[ix][None].expand(n, ht, wd), intrinsics)
    Gij = lie.se3_mul(poses, lie.se3_inv(poses[ix])[None])    # [n, 7]
    X1 = lie.se3_act4(Gij[:, None, None, :], X0)              # [n, H, W, 4]
    Z = X1[..., 2]
    Zc = Z.clamp(min=0.1)
    d_proj = X1[..., 3] / Zc
    fx, fy, cx, cy = intrinsics.unbind(-1)
    u = fx * X1[..., 0] / Zc + cx
    v = fy * X1[..., 1] / Zc + cy
    ui = torch.round(u).long().clamp(0, wd - 1)
    vi = torch.round(v).long().clamp(0, ht - 1)
    j = torch.arange(n, device=disps.device)[:, None, None]
    d_obs = disps[j, vi, ui]
    ok = ((d_obs - d_proj).abs() < thresh) & (Z > 0.2) & (u >= 0) & \
        (u < wd) & (v >= 0) & (v < ht) & (j != ix)
    return ok.float().sum(0)


def dense_problem(poses, disps, intrinsics, targets, weights, ii, jj,
                  stride=8):
    """The dense solve as a sparse BA problem: every stride-s pixel of
    every frame becomes a 3x3 patch of its disparity; an edge (i, j)
    gives one factor per grid pixel of frame i, its target and weight
    sampled from the dense fields [E, H, W, 2].

    Returns (patches [n*M, 3, 3, 3], target [E*M, 2], weight [E*M, 2],
    ii, jj, kk [E*M], valid [E*M], (gy, gx) [M])."""
    n, ht, wd = disps.shape
    dev = disps.device
    ys = torch.arange(stride // 2, ht, stride, device=dev)
    xs = torch.arange(stride // 2, wd, stride, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    M = gy.shape[0]

    offs = torch.arange(3, device=dev) - 1
    px = (gx[:, None, None] + offs[None, None, :]).to(disps.dtype)
    py = (gy[:, None, None] + offs[None, :, None]).to(disps.dtype)
    px, py = px.expand(M, 3, 3), py.expand(M, 3, 3)
    pd = disps[:, gy, gx][:, :, None, None].expand(n, M, 3, 3)
    patches = torch.stack([px.expand(n, M, 3, 3), py.expand(n, M, 3, 3),
                           pd], dim=2).reshape(n * M, 3, 3, 3)

    E = ii.shape[0]
    kk = (ii[:, None] * M + torch.arange(M, device=dev)[None, :]).reshape(-1)
    tgt = targets[:, gy, gx, :].reshape(E * M, 2)
    wgt = weights[:, gy, gx, :].reshape(E * M, 2)
    valid = torch.ones(E * M, dtype=torch.bool, device=dev)
    return (patches, tgt, wgt, ii.repeat_interleave(M),
            jj.repeat_interleave(M), kk, valid, (gy, gx))


def dense_ba(poses, disps, intrinsics, targets, weights, ii, jj,
             t0, t1, stride=8, iterations=2, lam=1e-4, alpha=0.0,
             disps_sens=None):
    """Dense bundle adjustment over a stride-s pixel grid.

    poses [N, 7] w2c; disps [N, H, W]; targets / weights [E, H, W, 2];
    ii / jj [E]; the poses [t0, t1) are free (host integers). alpha > 0
    blends the solved disparities towards disps_sens. fp64 inputs solve
    in fp64. Returns (poses, disps) updated, new tensors."""
    n = disps.shape[0]
    patches, tgt, wgt, ii_e, jj_e, kk, valid, (gy, gx) = dense_problem(
        poses, disps, intrinsics, targets, weights, ii, jj, stride)
    M = gy.shape[0]
    cap = int(torch.bincount(ii.long()).max()) if ii.numel() else 1
    cfg = BAConfig(window=int(t1 - t0), patch_slots=n * M,
                   iterations=iterations, per_patch_cap=cap)
    poses, patches = _bundle_adjust_impl(
        poses, patches, intrinsics, tgt, wgt, lam, ii_e, jj_e, kk, valid,
        t0, t1, 0, cfg)
    disps_out = disps.clone()
    disps_out[:, gy, gx] = patches.reshape(n, M, 3, 3, 3)[:, :, 2, 1, 1]
    if alpha > 0 and disps_sens is not None:
        disps_out = (1 - alpha) * disps_out + alpha * disps_sens
    return poses, disps_out


# ---------------------------------------------------------------------------
# RAFT-style correlation lookup
# ---------------------------------------------------------------------------

def corr_volume(fmap1, fmap2):
    """All-pairs correlation of channel-last maps [N, h1, w1, C] and
    [N, h2, w2, C] -> [N, h1, w1, h2, w2] = <f1, f2> / sqrt(C), fp32."""
    N, h1, w1, C = fmap1.shape
    h2, w2 = fmap2.shape[1], fmap2.shape[2]
    a = fmap1.reshape(N, h1 * w1, C).float()
    b = fmap2.reshape(N, h2 * w2, C).float()
    v = torch.bmm(a, b.transpose(1, 2))
    return (v / C ** 0.5).reshape(N, h1, w1, h2, w2)


def corr_pyramid(volume, num_levels=4):
    """Average-pool the target dims by 2 per level."""
    N, h1, w1 = volume.shape[:3]
    out = [volume]
    v = volume
    for _ in range(num_levels - 1):
        h2, w2 = v.shape[3] // 2, v.shape[4] // 2
        v = v.reshape(N, h1, w1, h2, 2, w2, 2).mean(dim=(4, 6))
        out.append(v)
    return out


def corr_index(volume, coords, radius):
    """Bilinear (2r+1)^2 window sampling of each source pixel's slice of
    volume [N, h1, w1, h2, w2] around coords [N, 2, h1, w1] (x, y in the
    target grid of this level), zero outside the target. Returns [N, rd,
    rd, h1, w1] with out[n, i, j, y, x] the value at (x0 - r + i,
    y0 - r + j)."""
    N, h1, w1, h2, w2 = volume.shape
    rd = 2 * radius + 1
    x0, y0 = coords[:, 0], coords[:, 1]
    xf, yf = torch.floor(x0), torch.floor(y0)
    dx = (x0 - xf)[..., None, None]
    dy = (y0 - yf)[..., None, None]

    offs = torch.arange(rd + 1, device=volume.device) - radius
    shape = (N, h1, w1, rd + 1, rd + 1)
    xs = (xf.long()[..., None, None] + offs).expand(shape)
    ys = (yf.long()[..., None, None] + offs[:, None]).expand(shape)
    inb = (xs >= 0) & (xs < w2) & (ys >= 0) & (ys < h2)
    flat = ys.clamp(0, h2 - 1) * w2 + xs.clamp(0, w2 - 1)
    win = torch.gather(volume.reshape(N, h1, w1, h2 * w2), 3,
                       flat.reshape(N, h1, w1, -1)).reshape(shape)
    win = torch.where(inb, win, 0.0)                      # [.., j(y), i(x)]
    out = ((1 - dx) * (1 - dy) * win[..., :rd, :rd]
           + dx * (1 - dy) * win[..., :rd, 1:]
           + (1 - dx) * dy * win[..., 1:, :rd]
           + dx * dy * win[..., 1:, 1:])
    return out.permute(0, 4, 3, 1, 2)


def corr_lookup_pyramid(pyramid, coords, radius):
    """Every level sampled at coords / 2^l, windows concatenated:
    [N, L * rd * rd, h1, w1]."""
    outs = [corr_index(vol, coords / 2.0 ** lvl, radius)
            for lvl, vol in enumerate(pyramid)]
    N, _, _, h1, w1 = outs[0].shape
    return torch.cat([o.reshape(N, -1, h1, w1) for o in outs], dim=1)
