"""Region correlation: the fused-correlation route (`PALLAS_FUSED: true`).

The same function as `ops/corr.py:patch_corr_pyramid` (the [E, 882]
feature, exact for any patch spread), computed the way the JAX package's
fused TPU kernels compute it. For every edge and pyramid level one region
of the target map covers the 8x8 windows of the patch's nine pixels:

  * x32: 16 rows x 32 columns, the x origin rounded down to a multiple of
    16 (in the JAX package's padded frame, PAD = 8 columns to the left,
    so that both packages split pixels alike); `_corr_fused_kernel`;
  * x16: 16 rows x 16 columns at the exact minimum window start;
    `_corr_fused_kernel4`.

The region is read with zeros off the map, the surfaces
S[p, y, x] = <g_p, region[y, x]> are formed, each pixel's 8x8 window is
selected at its offset in the region and blended bilinearly to 7x7. A
pixel whose window does not fit the region but overlaps the map (the TPU
kernels zero it) takes the spill path: its window is computed directly
from the map. The region geometry decides only which pixels spill.

  * `region_corr_pyramid`: the entry point. `fused=True` runs one launch
    of the correlation body of `csrc/corr_box.cu` (which replaces #4, x32,
    and #5, x16; it stages its own box, so the region geometry decides
    only the spill flags); `fused=False, extract="kernel"` (x16) runs the
    split pair: the surfaces producer of `csrc/corr_box.cu` (#2 on the
    split route, `_surfaces4`) writes the raw x16 surfaces to device
    memory, then the extract of `csrc/corr_region.cu` selects the windows
    (#6, `_extract_kernel4`).
  * `region_surfaces`, `region_extract`, `region_corr_fused`: the kernel
    wrappers. On CPU tensors they run the plain versions below; when any
    tensor is on the card they launch their kernel or raise.
  * `region_surfaces_plain`, `region_extract_plain`: the plain versions,
    in fp32 from the stored feature values; the fused plain version is
    their composition.

The spill count (edges with a spilled pixel at either level) is the
counterpart of the JAX package's `return_clip_count`.
"""

from __future__ import annotations

import torch

from . import _native
from .corr import LEVELS, RADIUS, KernelArgs, window_starts

RH = 16                        # region rows
REGION_W = {"x32": 32, "x16": 16}
WIN = 2 * RADIUS + 2           # raw window side (8)
PAD = 8                        # the JAX package's map padding (x32 phase)
NP = 9                         # patch pixels
CHUNK = 512                    # edges per block of the plain versions


def geometry(coords, variant, H, W):
    """Region geometry of one level: coords [e, 3, 3, 2] at the level's
    scale -> window starts ys, xs [e, 9], region origin oy, ox [e], and
    the masks fits (window inside the region) and spill (outside it but
    overlapping the map) [e, 9]."""
    ys, xs = window_starts(coords)
    oy = ys.min(1).values
    ox = xs.min(1).values
    if variant == "x32":
        ox = torch.div(ox + PAD, 16, rounding_mode="floor") * 16 - PAD
    fits = (ys - oy[:, None] <= RH - WIN) & \
        (xs - ox[:, None] <= REGION_W[variant] - WIN)
    over = (ys > -WIN) & (ys < H) & (xs > -WIN) & (xs < W)
    return ys, xs, oy, ox, fits, over & ~fits


def _rect(fmap, jj, y0, x0, h, w):
    """fmap[jj][y0:y0+h, x0:x0+w] for each row of jj/y0/x0, zero off the
    map -> [n, h, w, C] fp32."""
    F, H, W, C = fmap.shape
    dev = y0.device
    ys = y0[:, None] + torch.arange(h, device=dev)
    xs = x0[:, None] + torch.arange(w, device=dev)
    inb = ((ys >= 0) & (ys < H))[:, :, None] & \
        ((xs >= 0) & (xs < W))[:, None, :]
    flat = (jj.long() * (H * W))[:, None, None] + \
        ys.clamp(0, H - 1)[:, :, None] * W + xs.clamp(0, W - 1)[:, None, :]
    reg = fmap.reshape(-1, C)[flat.reshape(-1)].reshape(-1, h, w, C).float()
    return torch.where(inb[..., None], reg, 0.0)


def _patch_features(gmap, kk):
    """gmap[kk] as [e, 9, C] fp32 (pixel-major)."""
    g = gmap[kk.long()]
    return g.reshape(g.shape[0], g.shape[1], NP).transpose(1, 2).float()


def _check_route(variant, fused, extract):
    if variant not in REGION_W:
        raise ValueError(f"variant must be 'x32' or 'x16', got {variant!r}")
    if fused and extract is not None:
        raise ValueError("extract= selects the split path: pass fused=False")
    if not fused and (extract != "kernel" or variant != "x16"):
        raise ValueError("the split path is x16 with extract='kernel'")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _surfaces_chunk(g, fmap, c, jj, variant):
    F, H, W, C = fmap.shape
    _, _, oy, ox, _, _ = geometry(c, variant, H, W)
    reg = _rect(fmap, jj, oy, ox, RH, REGION_W[variant])   # [e, RH, RW, C]
    return torch.einsum("epc,eyxc->epyx", g, reg)


def _extract_chunk(S, g, fmap, c, jj, variant):
    """Windows from surfaces S [e, 9, RH, RW], spill windows from the map,
    the bilinear blend -> ([e, 7(dx), 7(dy), 3, 3], spill [e, 9])."""
    e = c.shape[0]
    F, H, W, C = fmap.shape
    RW = REGION_W[variant]
    ys, xs, oy, ox, fits, spill = geometry(c, variant, H, W)
    dev = c.device
    ry = (ys - oy[:, None]).clamp(0, RH - WIN)
    rx = (xs - ox[:, None]).clamp(0, RW - WIN)
    ar = torch.arange(WIN, device=dev)
    idx = (ry[..., None, None] + ar[:, None]) * RW + \
        (rx[..., None, None] + ar[None, :])                # [e, 9, 8, 8]
    win = S.reshape(e, NP, RH * RW).gather(2, idx.reshape(e, NP, -1))
    win = torch.where(fits[..., None], win, 0.0).reshape(e, NP, WIN, WIN)
    ei, pi = spill.nonzero(as_tuple=True)
    if ei.numel():
        rect = _rect(fmap, jj[ei], ys[ei, pi], xs[ei, pi], WIN, WIN)
        win[ei, pi] = torch.einsum("nabc,nc->nab", rect, g[ei, pi])
    x = c[..., 0].reshape(e, NP)
    y = c[..., 1].reshape(e, NP)
    dx = (x - torch.floor(x))[..., None, None]
    dy = (y - torch.floor(y))[..., None, None]
    d = WIN - 1
    out = ((1 - dx) * (1 - dy) * win[..., :d, :d]
           + dx * (1 - dy) * win[..., :d, 1:]
           + (1 - dx) * dy * win[..., 1:, :d]
           + dx * dy * win[..., 1:, 1:])                    # [e, 9, dy, dx]
    return out.reshape(e, 3, 3, d, d).permute(0, 4, 3, 1, 2), spill


def region_surfaces_plain(gmap, pyramid, coords, kk, jj, valid,
                          variant="x16"):
    """[E, 2, 9, RH, RW] fp32 surfaces of both levels (zero for invalid
    edges)."""
    E = coords.shape[0]
    out = coords.new_zeros((E, len(LEVELS), NP, RH, REGION_W[variant]))
    for s0 in range(0, E, CHUNK):
        sl = slice(s0, s0 + CHUNK)
        g = _patch_features(gmap, kk[sl])
        for li, (fmap, s) in enumerate(zip(pyramid, LEVELS)):
            out[sl, li] = _surfaces_chunk(g, fmap, coords[sl] / s, jj[sl],
                                          variant)
    return torch.where(valid.bool()[:, None, None, None, None], out, 0.0)


def region_extract_plain(surf, gmap, pyramid, coords, kk, jj, valid,
                         variant="x16"):
    """Window selection, spill pixels and blend from surfaces
    [E, 2, 9, RH, RW] -> ([E, 882] fp32, spilled edges [E] bool)."""
    E = coords.shape[0]
    out = coords.new_zeros((E, 882))
    spilled = torch.zeros(E, dtype=torch.bool, device=coords.device)
    for s0 in range(0, E, CHUNK):
        sl = slice(s0, s0 + CHUNK)
        g = _patch_features(gmap, kk[sl])
        levels = []
        for li, (fmap, s) in enumerate(zip(pyramid, LEVELS)):
            o, sp = _extract_chunk(surf[sl, li].float(), g, fmap,
                                   coords[sl] / s, jj[sl], variant)
            levels.append(o)
            spilled[sl] |= sp.any(1)
        out[sl] = torch.stack(levels, -1).reshape(-1, 882)
    valid = valid.bool()
    return torch.where(valid[:, None], out, 0.0), spilled & valid


def region_corr_plain(gmap, pyramid, coords, kk, jj, valid, variant):
    """The fused route's plain version: ([E, 882] fp32, spilled [E])."""
    parts = []
    for s0 in range(0, max(coords.shape[0], 1), CHUNK):
        sl = slice(s0, s0 + CHUNK)
        args = (gmap, pyramid, coords[sl], kk[sl], jj[sl], valid[sl])
        surf = region_surfaces_plain(*args, variant=variant)
        parts.append(region_extract_plain(surf, *args, variant=variant))
    out, spilled = zip(*parts)
    return torch.cat(out), torch.cat(spilled)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def region_corr_fused(gmap, pyramid, coords, kk, jj, valid, variant):
    """([E, 882] fp32, spilled [E] bool): the plain version for CPU
    tensors, the correlation body (`csrc/corr_box.cu`) with the spill
    flags of `variant`'s region for CUDA tensors."""
    if not _native.on_cuda(gmap, *pyramid, coords):
        return region_corr_plain(gmap, pyramid, coords, kk, jj, valid,
                                 variant)
    name = f"wv3d_corr_region_fused_{variant}"
    a = KernelArgs(name, gmap, pyramid, coords, kk, jj, valid)
    E = a.coords.shape[0]
    out = torch.empty((E, 882), dtype=torch.float32, device=coords.device)
    spill = torch.empty(E, dtype=torch.uint8, device=coords.device)
    if E == 0:
        return out, spill.bool()
    err = getattr(_native.lib(), name)(*a.pointers(), out.data_ptr(),
                                       spill.data_ptr(), *a.sizes())
    _native.check_launch(name, err)
    _native.LAUNCHES[f"corr_region_fused_{variant}"] += 1
    return out, spill.bool()


def region_surfaces(gmap, pyramid, coords, kk, jj, valid):
    """x16 surfaces [E, 2, 9, 16, 16] fp32 (zero for invalid edges): the
    plain version for CPU tensors, the surfaces producer of
    `csrc/corr_box.cu` for CUDA ones."""
    if not _native.on_cuda(gmap, *pyramid, coords):
        return region_surfaces_plain(gmap, pyramid, coords, kk, jj, valid)
    name = "wv3d_corr_region_surfaces_x16"
    a = KernelArgs(name, gmap, pyramid, coords, kk, jj, valid)
    E = a.coords.shape[0]
    surf = torch.empty((E, len(LEVELS), NP, RH, REGION_W["x16"]),
                       dtype=torch.float32, device=coords.device)
    if E == 0:
        return surf
    err = _native.lib().wv3d_corr_region_surfaces_x16(
        *a.pointers(), surf.data_ptr(), *a.sizes())
    _native.check_launch(name, err)
    _native.LAUNCHES["corr_region_surfaces"] += 1
    return surf


def check_surfaces(name, surf, E):
    """Raise unless surf is the extract kernel's input: x16 surfaces
    [E, 2, 9, 16, 16] in fp32."""
    want = (E, len(LEVELS), NP, RH, REGION_W["x16"])
    if tuple(surf.shape) != want:
        raise ValueError(f"{name}: surfaces of shape {tuple(surf.shape)}, "
                         f"expected {want}")
    if surf.dtype != torch.float32:
        raise TypeError(f"{name}: surfaces of dtype {surf.dtype}, expected "
                        "torch.float32")


def region_extract(surf, gmap, pyramid, coords, kk, jj, valid):
    """([E, 882] fp32, spilled [E] bool) from x16 surfaces: the plain
    version for CPU tensors, the extract kernel for CUDA ones."""
    if not _native.on_cuda(surf, gmap, *pyramid, coords):
        return region_extract_plain(surf, gmap, pyramid, coords, kk, jj,
                                    valid)
    name = "wv3d_corr_region_extract_x16"
    a = KernelArgs(name, gmap, pyramid, coords, kk, jj, valid)
    E = a.coords.shape[0]
    check_surfaces(name, surf, E)
    _native.require_cuda(name, surf, a.coords)
    out = torch.empty((E, 882), dtype=torch.float32, device=coords.device)
    # the kernel writes the flags as bytes 0 and 1, a bool tensor's storage
    spill = torch.empty(E, dtype=torch.bool, device=coords.device)
    if E == 0:
        return out, spill
    err = _native.lib().wv3d_corr_region_extract_x16(
        surf.data_ptr(), *a.pointers(), out.data_ptr(), spill.data_ptr(),
        *a.sizes())
    _native.check_launch(name, err)
    _native.LAUNCHES["corr_region_extract"] += 1
    return out, spill


def region_corr_pyramid(gmap, pyramid, coords, kk, jj, valid, variant,
                        fused=True, extract=None, return_spill_count=False):
    """[E, 882] fp32 correlation feature through the region route.

    gmap [S, 128, 3, 3] and pyramid (fmap1 [F, H1, W1, 128],
    fmap2 [F, H2, W2, 128]) in bf16 or fp32; coords [E, 3, 3, 2] fp32 at
    level-1 scale; kk in [0, S), jj in [0, F); valid [E] bool.
    fused=True: one kernel per call (x32 or x16). fused=False,
    extract="kernel" (x16 only): the surfaces kernel, then the extract
    kernel. With return_spill_count, also the number of valid edges that
    took the spill path at either level.
    """
    _check_route(variant, fused, extract)
    if fused:
        out, spill = region_corr_fused(gmap, pyramid, coords, kk, jj,
                                       valid, variant)
    else:
        surf = region_surfaces(gmap, pyramid, coords, kk, jj, valid)
        out, spill = region_extract(surf, gmap, pyramid, coords, kk, jj,
                                    valid)
    if return_spill_count:
        return out, int(spill.sum())
    return out
