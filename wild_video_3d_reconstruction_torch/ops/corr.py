"""Patch correlation lookup (the hot op of the update loop).

For every edge e with patch features g = gmap[kk[e]] and target feature map
F = fmap[jj[e]]:

    corr[e, p, dy, dx] = <g[:, p], F[floor(y_p)+dy-R, floor(x_p)+dx-R, :]>

over a (2R+2)x(2R+2) window (zero outside the map), blended bilinearly to
(2R+1)^2 and emitted in the layout the update network reads: per level
(dx, dy, pi, pj), levels stacked last, [E, 882] for R = 3 and 2 levels.

  * `patch_corr_pyramid`: the plain version (gather + einsum, chunked over
    the valid edges), counterpart of the JAX package's `ops/corr.py`. It
    computes in fp32 from the stored feature values.
  * `corr_lookup`: the wrapper the SLAM path calls. On CPU tensors it runs
    the plain version; on CUDA tensors it launches the exact Hopper
    correlation body of `csrc/corr_box.cu` (both pyramid levels in one
    launch) or raises. With fused=True it takes the region route of
    `ops/corr_region.py` (`PALLAS_FUSED`), which launches the same body and
    also returns the region spill flags.
  * `box_plan`: the kernel's choice, per edge and level, of the pixels it
    takes from the staged box and those it takes per pixel from the map
    (the result does not depend on it; `chip_smoke.py` reports the share).

The blend weights are fp32 in both versions. (The JAX plain version casts
them to the feature dtype, bf16 under mixed precision.) Rows of invalid
edges are zero. (The JAX plain version multiplies them by 0, so coordinates
that are not finite give NaN there; the SLAM path zeroes the coordinates
of invalid edges before the lookup, so the two agree on it.)
"""

from __future__ import annotations

import torch

from . import _native

LEVELS = (1, 4)
RADIUS = 3
BOX = 12               # csrc/corr_box.cu: staging capacity, positions a side
COORD_LIM = 1e6        # coordinates are clamped here before floor


def _corr_level_chunk(gmap, fmap_flat, H, W, radius, coords, kk, jj):
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
    # index_select: the same rows as advanced indexing, in less time
    win = torch.index_select(fmap_flat, 0, flat.reshape(-1)) \
        .reshape(e, P * P, D * D, C).float()
    g = torch.index_select(gmap, 0, kk.long()).permute(0, 2, 3, 1) \
        .reshape(e, P * P, C, 1).float()
    c_full = torch.matmul(win, g).reshape(e, P, P, D, D)
    c_full = torch.where(in_b, c_full, 0.0)

    d = 2 * radius + 1
    dxe = dx[..., None, None]
    dye = dy[..., None, None]
    out = ((1 - dxe) * (1 - dye) * c_full[..., :d, :d]
           + dxe * (1 - dye) * c_full[..., :d, 1:]
           + (1 - dxe) * dye * c_full[..., 1:, :d]
           + dxe * dye * c_full[..., 1:, 1:])             # [e,P,P,dy,dx]
    return out.permute(0, 4, 3, 1, 2)                      # (dx, dy, pi, pj)


def patch_corr_level(gmap, fmap, coords, kk, jj, radius=RADIUS, valid=None,
                     chunk=2048):
    """One level over all edges: gmap [Ek, C, P, P], fmap [F, H, W, C],
    coords [E, P, P, 2] at this level's scale -> [E, 2R+1, 2R+1, P, P]."""
    E = coords.shape[0]
    F, H, W, C = fmap.shape
    d = 2 * radius + 1
    out = coords.new_zeros((E, d, d) + tuple(coords.shape[1:3]))
    # invalid rows are zero: only the valid ones are computed
    rows = torch.arange(E, device=coords.device) if valid is None else \
        torch.nonzero(valid).reshape(-1)
    fmap_flat = fmap.reshape(F * H * W, C)
    for s in range(0, rows.shape[0], chunk):
        r = rows[s:s + chunk]
        out[r] = _corr_level_chunk(gmap, fmap_flat, H, W, radius, coords[r],
                                   kk[r], jj[r])
    return out


def patch_corr_pyramid(gmap, pyramid, coords, kk, jj, radius=RADIUS,
                       valid=None, levels=LEVELS, chunk=2048):
    """Multi-level plain correlation: [E, L * (2R+1)^2 * P * P] fp32 with
    index order (dx, dy, pi, pj, level)."""
    E = coords.shape[0]
    outs = [patch_corr_level(gmap, fmap, coords / s, kk, jj, radius=radius,
                             valid=valid, chunk=chunk)
            for fmap, s in zip(pyramid, levels)]
    return torch.stack(outs, dim=-1).reshape(E, -1)


def window_starts(coords):
    """Window starts (ys, xs) [e, 9] of coords [e, 3, 3, 2] at a level's
    scale, as the kernels compute them: NaN and +-inf clamped to
    +-COORD_LIM before the floor."""
    e = coords.shape[0]
    c = torch.nan_to_num(coords, nan=COORD_LIM, posinf=COORD_LIM,
                         neginf=-COORD_LIM).clamp(-COORD_LIM, COORD_LIM)
    ys = torch.floor(c[..., 1]).long().reshape(e, 9) - RADIUS
    xs = torch.floor(c[..., 0]).long().reshape(e, 9) - RADIUS
    return ys, xs


def box_plan(coords, H, W):
    """The correlation kernel's plan for one level (`csrc/corr_box.cu`):
    coords [e, 3, 3, 2] at the level's scale, map H x W ->
    (cls [e, 9]: 0 window off the map, 1 taken from the staged box, 2
    taken per pixel from the map; box [e, 4]: y0, x0, h, w of the staged
    box, all 0 when no window overlaps the map).

    The box origin is the least window start of the pixels that overlap
    the map; a pixel is in the box when its window lies within BOX x BOX
    positions from there; the staged box is the union of those windows."""
    D = 2 * RADIUS + 2
    ys, xs = window_starts(coords)
    on = (ys > -D) & (ys < H) & (xs > -D) & (xs < W)
    big = torch.iinfo(torch.long).max
    y0 = torch.where(on, ys, big).min(1).values
    x0 = torch.where(on, xs, big).min(1).values
    inbox = on & (ys - y0[:, None] <= BOX - D) & (xs - x0[:, None] <= BOX - D)
    cls = torch.where(inbox, 1, torch.where(on, 2, 0))
    any_on = on.any(1)
    h = torch.where(inbox, ys + D, y0[:, None]).max(1).values - y0
    w = torch.where(inbox, xs + D, x0[:, None]).max(1).values - x0
    box = torch.stack([y0, x0, h, w], 1)
    return cls, torch.where(any_on[:, None], box, 0)


class KernelArgs:
    """The correlation kernels' common arguments, checked and in the
    types their C entry points take."""

    def __init__(self, name, gmap, pyramid, coords, kk, jj, valid):
        fmap1, fmap2 = pyramid
        if gmap.shape[1:] != (128, 3, 3) or fmap1.shape[-1] != 128 or \
                fmap2.shape[-1] != 128 or tuple(coords.shape[1:]) != (3, 3, 2):
            raise ValueError(f"{name}: the kernel takes 128 channels and "
                             "3x3 patches")
        self.gmap, self.fmap1, self.fmap2 = gmap, fmap1, fmap2
        self.coords = coords.float().contiguous()
        self.kk = kk.to(torch.int32).contiguous()
        self.jj = jj.to(torch.int32).contiguous()
        self.valid = valid.to(torch.bool).contiguous()
        feat = (torch.bfloat16, torch.float32)
        _native.require_cuda(name, gmap, fmap1, fmap2, self.coords, self.kk,
                             self.jj, self.valid,
                             dtypes=(feat, (gmap.dtype,), (gmap.dtype,)))

    def pointers(self):
        return (self.gmap.data_ptr(), self.fmap1.data_ptr(),
                self.fmap2.data_ptr(), self.coords.data_ptr(),
                self.kk.data_ptr(), self.jj.data_ptr(), self.valid.data_ptr())

    def sizes(self):
        """E, the maps' sizes, the feature type and the stream."""
        return (self.coords.shape[0], self.fmap1.shape[1],
                self.fmap1.shape[2], self.fmap2.shape[1], self.fmap2.shape[2],
                int(self.gmap.dtype == torch.bfloat16),
                _native.stream_ptr(self.coords.device))


def corr_lookup(gmap, pyramid, coords, kk, jj, valid, chunk=2048,
                fused=False, variant="x32"):
    """[E, 882] correlation feature.

    gmap [S, 128, 3, 3] and pyramid (fmap1 [F, H1, W1, 128],
    fmap2 [F, H2, W2, 128]) in bf16 or fp32; coords [E, 3, 3, 2] fp32 at
    level-1 scale; kk in [0, S) and jj in [0, F); valid [E] bool.

    Unfused: the plain version (in blocks of `chunk` edges) for CPU
    tensors, the correlation body of `csrc/corr_box.cu` for CUDA tensors.
    fused=True: the region route of `variant` (`ops/corr_region.py`, whose
    plain version blocks by its own `CHUNK`), which computes the same
    function.
    """
    if fused:
        from .corr_region import region_corr_pyramid
        return region_corr_pyramid(gmap, pyramid, coords, kk, jj, valid,
                                   variant)
    if not coords.is_cuda:
        return patch_corr_pyramid(gmap, pyramid, coords, kk, jj,
                                  valid=valid, chunk=chunk)
    a = KernelArgs("corr_lookup", gmap, pyramid, coords, kk, jj, valid)
    E = a.coords.shape[0]
    out = torch.empty((E, 882), dtype=torch.float32, device=coords.device)
    if E == 0:
        return out
    err = _native.lib().wv3d_corr_pyramid(*a.pointers(), out.data_ptr(),
                                          *a.sizes())
    _native.check_launch("wv3d_corr_pyramid", err)
    _native.LAUNCHES["corr_pyramid"] += 1
    return out
