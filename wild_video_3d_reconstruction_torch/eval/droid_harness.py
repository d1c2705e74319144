"""The DROID-style dense visual odometry and its flow providers.

Counterpart of the JAX package's `eval/droid_harness.py`, on one device:

  lk_flow / lk_flow_pyramid  coarse-to-fine Lucas-Kanade of grid points
                             (5x5 windows, Gauss-Newton on brightness
                             constancy), reprojection-seeded
  CorrFlow                   the learned-feature flow: the VONet matching
                             features of both frames, each grid point's
                             correlation map against the whole target map
                             (fp32), its average-pooled pyramid, and a
                             coarse-to-fine quadratic peak search through
                             `ops.dense.corr_index` windows
  DenseVO                    the dense frontend: every frame tracked by
                             `ops.dense.dense_ba` over a sliding window on
                             flow targets, the second-newest keyframe
                             evicted when `frame_distance` falls below
                             kf_thresh

Decided difference (R12 in ROADMAP.md): the JAX `CorrFlow` keys its
encoder cache by `id(img)`, and `DenseVO` passes it fresh views of its
image buffer, whose ids CPython reuses, so a lookup can return another
frame's features. The port keys the cache by the frame's identity, a
counter kept beside `DenseVO`'s buffers (`DenseVO.frame_ids`, shifted
with them on eviction).

`network` (a `VONet`, a `.pth` path, the JAX package's parameter tree,
or None for weights drawn from seed 0, which is not the JAX package's
`init_vonet(PRNGKey(0))`) serves the "corr" flow. The TUM protocol
(`run_tum`, `main`) waits for the evaluation harness (`eval/harness.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.convert import as_vonet
from ..models.vonet import encode_frame
from ..ops import dense as dops
from ..ops import lie
from ..ops.patchify import patchify


# ---------------------------------------------------------------------------
# classical flow: Lucas-Kanade on grid points
# ---------------------------------------------------------------------------

GRAY_WEIGHTS = (0.114, 0.587, 0.299)       # B, G, R


def _gray(img):
    """uint8 [H, W, 3] BGR -> fp32 luminance [H, W]: the JAX package's
    fp32 dot as XLA computes it on the CPU, a chain of fused
    multiply-adds (each product and sum exact in fp64, one rounding)."""
    x = img.double()
    g = None
    for c in range(3):
        w = float(np.float32(GRAY_WEIGHTS[c]))
        g = x[..., c] * w if g is None else x[..., c] * w + g.double()
        g = g.float()
    return g


def _pyr(g, levels=3):
    out = [g]
    for _ in range(levels - 1):
        h, w = out[-1].shape
        out.append(out[-1].reshape(h // 2, 2, w // 2, 2).mean((1, 3)))
    return out


def _bilinear(im, x, y):
    h, w = im.shape
    x0 = torch.floor(x).long().clamp(0, w - 2)
    y0 = torch.floor(y).long().clamp(0, h - 2)
    fx, fy = x - x0, y - y0
    return ((1 - fx) * (1 - fy) * im[y0, x0] + fx * (1 - fy) * im[y0, x0 + 1]
            + (1 - fx) * fy * im[y0 + 1, x0] + fx * fy * im[y0 + 1, x0 + 1])


def lk_flow(g_i, g_j, x0, y0, flow_init, iters=6):
    """Flow [M, 2] of points (x0, y0) [M] from gray g_i to g_j [H, W] on
    one level, refined from flow_init [M, 2] by iters Gauss-Newton steps
    over 5x5 windows."""
    win = torch.arange(-2, 3, dtype=torch.float32, device=g_i.device)
    wy, wx = torch.meshgrid(win, win, indexing="ij")
    wx, wy = wx.reshape(-1), wy.reshape(-1)
    px = x0[:, None] + wx[None, :]
    py = y0[:, None] + wy[None, :]
    t = _bilinear(g_i, px, py)

    flow = flow_init
    for _ in range(iters):
        qx = px + flow[:, None, 0]
        qy = py + flow[:, None, 1]
        s = _bilinear(g_j, qx, qy)
        gx = _bilinear(g_j, qx + 0.5, qy) - _bilinear(g_j, qx - 0.5, qy)
        gy = _bilinear(g_j, qx, qy + 0.5) - _bilinear(g_j, qx, qy - 0.5)
        r = s - t
        a11 = (gx * gx).sum(1) + 1e-3
        a12 = (gx * gy).sum(1)
        a22 = (gy * gy).sum(1) + 1e-3
        b1 = (gx * r).sum(1)
        b2 = (gy * r).sum(1)
        det = a11 * a22 - a12 * a12
        dx = (a22 * b1 - a12 * b2) / det
        dy = (a11 * b2 - a12 * b1) / det
        flow = flow - torch.stack([dx, dy], -1)
    return flow


def lk_flow_pyramid(img_i, img_j, x0, y0, flow_init, levels=3):
    """Coarse-to-fine LK of uint8 frames [H, W, 3]: flow [M, 2] at full
    resolution."""
    gi, gj = _pyr(_gray(img_i), levels), _pyr(_gray(img_j), levels)
    flow = flow_init / 2.0 ** (levels - 1)
    for lvl in range(levels - 1, -1, -1):
        sc = 2.0 ** lvl
        flow = lk_flow(gi[lvl], gj[lvl], x0 / sc, y0 / sc, flow)
        if lvl:
            flow = flow * 2.0
    return flow


# ---------------------------------------------------------------------------
# correlation-lookup flow
# ---------------------------------------------------------------------------

def _box3(f):
    """3x3 mean over the feature grid (zeros outside), the map-wide mean
    removed and each cell L2-normalised (NCC conditioning)."""
    h, w = f.shape[:2]
    s = torch.nn.functional.pad(f, (0, 0, 1, 1, 1, 1))
    f = sum(s[dy:dy + h, dx:dx + w] for dy in range(3)
            for dx in range(3)) / 9.0
    f = f - f.mean(dim=(0, 1), keepdim=True)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True).clamp(min=1e-6)


def _quad_offset(vm1, v0, vp1):
    """Sub-cell peak offset of a parabola through three samples."""
    den = vm1 - 2 * v0 + vp1
    sharp = den.abs() > 1e-6
    off = 0.5 * (vm1 - vp1) / torch.where(sharp, den, 1.0)
    return torch.where(sharp, off, 0.0).clamp(-0.5, 0.5)


class CorrFlow:
    """Flow of grid points (gx, gy) [M] over learned features and the
    `corr_index` lookup. Encoded frames are cached by the caller's key
    (a frame's identity); a call without keys encodes both frames."""

    FEATURE_STRIDE = 4.0
    CACHE = 16

    def __init__(self, net, gx, gy, radius=3, levels=3, iters=2):
        self.net = net
        self.gx, self.gy = gx, gy
        self.radius = radius
        self.levels = levels
        self.iters = iters
        self._cache = {}

    def _feat(self, img, key):
        if key is None:
            return encode_frame(self.net, img, torch.float32).fmap
        if key not in self._cache:
            if len(self._cache) > self.CACHE:
                self._cache.clear()
            self._cache[key] = encode_frame(self.net, img,
                                            torch.float32).fmap
        return self._cache[key]

    def __call__(self, img_i, img_j, seed_xy, key_i=None, key_j=None):
        return self.flow(self._feat(img_i, key_i), self._feat(img_j, key_j),
                         seed_xy)

    def flow(self, fmap_i, fmap_j, seed_xy):
        """Full-resolution flow [M, 2] of the grid from fmap_i to fmap_j
        (channel-last /4 maps), seeded at seed_xy [M, 2]."""
        fs = self.FEATURE_STRIDE
        r, rd = self.radius, 2 * self.radius + 1
        fmap_i, fmap_j = _box3(fmap_i), _box3(fmap_j)
        M = self.gx.shape[0]
        pts = torch.stack([self.gx, self.gy], -1) / fs
        f_pts = patchify(fmap_i, pts, 0)[:, :, 0, 0]                # [M, C]
        C = f_pts.shape[-1]
        h, w = fmap_j.shape[:2]
        vol = (f_pts @ fmap_j.reshape(-1, C).T / C ** 0.5).reshape(
            1, M, 1, h, w)
        pyr = dops.corr_pyramid(vol, num_levels=self.levels)
        est = seed_xy / fs
        dgrid = torch.arange(rd, dtype=torch.float32,
                             device=vol.device) - r
        em = torch.arange(M, device=vol.device)
        for lvl in range(self.levels - 1, -1, -1):
            for _ in range(self.iters):
                c = (est / 2.0 ** lvl).T.reshape(1, 2, M, 1)
                win = dops.corr_index(pyr[lvl], c, r)[0, :, :, :, 0]
                win = win.permute(2, 0, 1)                # [M, i(x), j(y)]
                flat = win.reshape(M, -1)
                p = torch.argmax(flat, dim=1)
                px, py = p // rd, p % rd
                pxc, pyc = px.clamp(1, rd - 2), py.clamp(1, rd - 2)
                sx = _quad_offset(win[em, pxc - 1, py], win[em, pxc, py],
                                  win[em, pxc + 1, py])
                sy = _quad_offset(win[em, px, pyc - 1], win[em, px, pyc],
                                  win[em, px, pyc + 1])
                dx = dgrid[px] + torch.where(px == pxc, sx, 0.0)
                dy = dgrid[py] + torch.where(py == pyc, sy, 0.0)
                # a flat or out-of-reach window has no peak
                ok = flat[em, p] > flat.mean(dim=1) + 1e-6
                step = torch.stack([torch.where(ok, dx, 0.0),
                                    torch.where(ok, dy, 0.0)], -1)
                est = est + step * 2.0 ** lvl
        return (est - pts) * fs


# ---------------------------------------------------------------------------
# dense VO
# ---------------------------------------------------------------------------

class DenseVO:
    """Dense visual odometry over `ops.dense`: each new frame starts at
    the previous pose and disparity; a window of the last `window` frames
    (edges |a - b| <= 2) is optimised by `dense_ba` on flow targets from
    the flow provider; the second-newest keyframe is evicted when its
    `frame_distance` to its successor is below kf_thresh.

    flow: "corr" (CorrFlow over `network`) or "lk"; flow_fn(img_i, img_j,
    seed_xy) replaces both. Buffers live on `device`: cuda unless the
    caller asks for the CPU."""

    def __init__(self, ht, wd, intrinsics, buffer=256, stride=8,
                 kf_thresh=2.4, window=6, flow_fn=None, flow="corr",
                 network=None, device="cuda"):
        dev = torch.device(device)
        self.device = dev
        self.ht, self.wd = ht, wd
        self.stride = stride
        self.window = window
        self.kf_thresh = kf_thresh
        self.intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                                    device=dev)
        self.poses = lie.se3_identity((buffer,), device=dev)
        self.disps = torch.full((buffer, ht, wd), 0.5, device=dev)
        self.images = torch.zeros((buffer, ht, wd, 3), dtype=torch.uint8,
                                  device=dev)
        self.frame_ids = np.zeros(buffer, np.int64)   # input counter
        self.tstamps = []
        self.n = 0
        self.seen = 0

        ys = torch.arange(stride // 2, ht, stride, device=dev)
        xs = torch.arange(stride // 2, wd, stride, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        self.gx = gx.reshape(-1).float()
        self.gy = gy.reshape(-1).float()

        self.corr = None
        self.flow_fn = flow_fn
        if flow_fn is None and flow == "corr":
            net = as_vonet(network).to(dev).eval()
            self.corr = CorrFlow(net, self.gx, self.gy)
        elif flow_fn is None:
            self.flow_fn = self._lk

    def _lk(self, img_i, img_j, seed_xy):
        flow0 = seed_xy - torch.stack([self.gx, self.gy], -1)
        return lk_flow_pyramid(img_i, img_j, self.gx, self.gy, flow0)

    def _pair_flow(self, i, j, seed):
        if self.corr is not None:
            return self.corr(self.images[i], self.images[j], seed,
                             int(self.frame_ids[i]), int(self.frame_ids[j]))
        return self.flow_fn(self.images[i], self.images[j], seed)

    def _reproj_seed(self, i, j):
        idx = torch.tensor([i], device=self.device)
        jdx = torch.tensor([j], device=self.device)
        coords, _ = dops.projmap(self.poses[:self.n], self.disps[:self.n],
                                 self.intr, idx, jdx)
        return coords[0][self.gy.long(), self.gx.long()]

    def __call__(self, tstamp, image):
        n = self.n
        self.images[n] = torch.as_tensor(image, device=self.device)
        self.frame_ids[n] = self.seen
        self.seen += 1
        self.tstamps.append(tstamp)
        self.n = n + 1
        if n == 0:
            return
        self.poses[n] = self.poses[n - 1]
        self.disps[n] = self.disps[n - 1]
        self._optimize()

        # after tracking: evict the second-newest keyframe when it moved
        # less than kf_thresh of mean flow from its successor
        n = self.n
        if n >= 8:
            pair = torch.tensor([[n - 3], [n - 2]], device=self.device)
            d = float(dops.frame_distance(self.poses[:n], self.disps[:n],
                                          self.intr, pair[0], pair[1])[0])
            if d < self.kf_thresh:
                k = n - 2
                for buf in (self.images, self.poses, self.disps):
                    buf[k:n - 1] = buf[k + 1:n].clone()
                self.frame_ids[k:n - 1] = self.frame_ids[k + 1:n]
                del self.tstamps[k]
                self.n = n - 1

    def _optimize(self, iters=2):
        n = self.n
        t0 = max(n - self.window, 0)
        pairs = [(a, b) for a in range(t0, n) for b in range(t0, n)
                 if a != b and abs(a - b) <= 2]
        ii = torch.tensor([a for a, _ in pairs], device=self.device)
        jj = torch.tensor([b for _, b in pairs], device=self.device)

        # flow targets on the stride grid -> dense target / weight fields
        E = len(pairs)
        tgt = torch.zeros((E, self.ht, self.wd, 2), device=self.device)
        wgt = torch.zeros((E, self.ht, self.wd, 2), device=self.device)
        gx, gy = self.gx.long(), self.gy.long()
        base = torch.stack([self.gx, self.gy], -1)
        for e, (i, j) in enumerate(pairs):
            flow = self._pair_flow(i, j, self._reproj_seed(i, j))
            tgt[e, gy, gx] = base + flow
            wgt[e, gy, gx] = 1.0

        poses, disps = dops.dense_ba(
            self.poses[:n], self.disps[:n], self.intr, tgt, wgt, ii, jj,
            t0=max(t0, 1), t1=n, stride=self.stride, iterations=iters)
        self.poses[:n] = poses
        self.disps[:n] = disps

    def terminate(self):
        """(poses c2w [n, 7] numpy, timestamps [n] float64)."""
        c2w = lie.se3_inv(self.poses[:self.n]).cpu().numpy()
        return c2w, np.asarray(self.tstamps, np.float64)
