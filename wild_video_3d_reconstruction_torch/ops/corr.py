"""Patch correlation lookup (the hot op of the update loop).

For every edge e with patch features g = gmap[kk[e]] and target feature map
F = fmap[jj[e]]:

    corr[e, p, dy, dx] = <g[:, p], F[floor(y_p)+dy-R, floor(x_p)+dx-R, :]>

over a (2R+2)x(2R+2) window (zero outside the map), blended bilinearly to
(2R+1)^2 and emitted in the layout the update network reads: per level
(dx, dy, pi, pj), levels stacked last, [E, 882] for R = 3 and 2 levels.

  * `patch_corr_pyramid`: the plain version (gather + einsum, chunked over
    edges), counterpart of the JAX package's `ops/corr.py`. It computes in
    fp32 from the stored feature values.
  * `corr_lookup`: the wrapper the SLAM path calls. On CPU tensors it runs
    the plain version; on CUDA tensors it launches the exact Hopper kernel
    of `csrc/corr.cu` (both pyramid levels in one launch) or raises.

The blend weights are fp32 in both versions. (The JAX plain version casts
them to the feature dtype, bf16 under mixed precision.)
"""

from __future__ import annotations

import torch

from . import _native

LEVELS = (1, 4)
RADIUS = 3


def _corr_level_chunk(gmap, fmap_flat, H, W, radius, coords, kk, jj, valid):
    e, P = coords.shape[0], coords.shape[1]
    D = 2 * radius + 2
    C = gmap.shape[1]
    dev = coords.device

    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    dx = coords[..., 0] - x0
    dy = coords[..., 1] - y0

    off = torch.arange(D, device=dev) - radius
    ys = y0.long()[..., None] + off                        # [e, P, P, D]
    xs = x0.long()[..., None] + off
    in_b = ((ys[..., :, None] >= 0) & (ys[..., :, None] < H) &
            (xs[..., None, :] >= 0) & (xs[..., None, :] < W))
    flat = (jj.long() * (H * W))[:, None, None, None, None] + \
        ys.clamp(0, H - 1)[..., :, None] * W + xs.clamp(0, W - 1)[..., None, :]
    win = fmap_flat[flat.reshape(-1)].reshape(e, P * P, D * D, C).float()
    g = gmap[kk.long()].permute(0, 2, 3, 1).reshape(e, P * P, C, 1).float()
    c_full = torch.matmul(win, g).reshape(e, P, P, D, D)
    c_full = torch.where(in_b, c_full, 0.0)

    d = 2 * radius + 1
    dxe = dx[..., None, None]
    dye = dy[..., None, None]
    out = ((1 - dxe) * (1 - dye) * c_full[..., :d, :d]
           + dxe * (1 - dye) * c_full[..., :d, 1:]
           + (1 - dxe) * dye * c_full[..., 1:, :d]
           + dxe * dye * c_full[..., 1:, 1:])             # [e,P,P,dy,dx]
    out = out * valid[:, None, None, None, None]
    return out.permute(0, 4, 3, 1, 2)                      # (dx, dy, pi, pj)


def patch_corr_level(gmap, fmap, coords, kk, jj, radius=RADIUS, valid=None,
                     chunk=2048):
    """One level over all edges: gmap [Ek, C, P, P], fmap [F, H, W, C],
    coords [E, P, P, 2] at this level's scale -> [E, 2R+1, 2R+1, P, P]."""
    E = coords.shape[0]
    F, H, W, C = fmap.shape
    valid = torch.ones(E, device=coords.device) if valid is None else \
        valid.float()
    fmap_flat = fmap.reshape(F * H * W, C)
    outs = [_corr_level_chunk(gmap, fmap_flat, H, W, radius,
                              coords[s:s + chunk], kk[s:s + chunk],
                              jj[s:s + chunk], valid[s:s + chunk])
            for s in range(0, E, chunk)]
    return torch.cat(outs) if outs else coords.new_zeros(
        (0, 2 * radius + 1, 2 * radius + 1) + tuple(coords.shape[1:3]))


def patch_corr_pyramid(gmap, pyramid, coords, kk, jj, radius=RADIUS,
                       valid=None, levels=LEVELS, chunk=2048):
    """Multi-level plain correlation: [E, L * (2R+1)^2 * P * P] fp32 with
    index order (dx, dy, pi, pj, level)."""
    E = coords.shape[0]
    outs = [patch_corr_level(gmap, fmap, coords / s, kk, jj, radius=radius,
                             valid=valid, chunk=chunk)
            for fmap, s in zip(pyramid, levels)]
    return torch.stack(outs, dim=-1).reshape(E, -1)


def corr_lookup(gmap, pyramid, coords, kk, jj, valid, chunk=2048):
    """[E, 882] correlation feature: the plain version for CPU tensors,
    the Hopper kernel (`csrc/corr.cu`) for CUDA tensors.

    gmap [S, 128, 3, 3] and pyramid (fmap1 [F, H1, W1, 128],
    fmap2 [F, H2, W2, 128]) in bf16 or fp32; coords [E, 3, 3, 2] fp32 at
    level-1 scale; kk in [0, S) and jj in [0, F); valid [E] bool.
    """
    fmap1, fmap2 = pyramid
    if not coords.is_cuda:
        return patch_corr_pyramid(gmap, pyramid, coords, kk, jj,
                                  valid=valid, chunk=chunk)
    E = coords.shape[0]
    if gmap.shape[1:] != (128, 3, 3) or fmap1.shape[-1] != 128 or \
            fmap2.shape[-1] != 128 or tuple(coords.shape[1:]) != (3, 3, 2):
        raise ValueError("corr_lookup: the kernel takes 128 channels and "
                         "3x3 patches")
    coords = coords.float().contiguous()
    kk32 = kk.to(torch.int32).contiguous()
    jj32 = jj.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    feat = (torch.bfloat16, torch.float32)
    _native.require_cuda("corr_lookup", gmap, fmap1, fmap2, coords, kk32,
                         jj32, valid, dtypes=(feat, (gmap.dtype,),
                                              (gmap.dtype,)))
    out = torch.empty((E, 882), dtype=torch.float32, device=coords.device)
    if E == 0:
        return out
    err = _native.lib().wv3d_corr_pyramid(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        coords.data_ptr(), kk32.data_ptr(), jj32.data_ptr(),
        valid.data_ptr(), out.data_ptr(), E, fmap1.shape[1], fmap1.shape[2],
        fmap2.shape[1], fmap2.shape[2], int(gmap.dtype == torch.bfloat16),
        _native.stream_ptr(coords.device))
    _native.check_launch("wv3d_corr_pyramid", err)
    _native.LAUNCHES["corr_pyramid"] += 1
    return out
