"""The image operations of the self-calibration's frame selection.

The JAX package selects calibration frames with OpenCV
(`init/colmap_init.py:select_keyframes`), on the host. The port computes
the same quantities with PyTorch on the frames' device, so the frames a
run already holds on the card are selected there, with no copy back and
no host image library (the card's machine does have OpenCV 4.13, whose
calls would run on the host CPU; ROADMAP R14):

  bgr_to_gray     `cv2.cvtColor(img, COLOR_BGR2GRAY)` bit for bit: the
                  15-bit fixed-point weights (3735, 19235, 9798), rounded
  laplacian_var   `cv2.Laplacian(gray, CV_64F).var()`: the 3x3 ksize-1
                  kernel, BORDER_REFLECT_101, float64
  resize_linear   `cv2.resize(img, None, fx=s, fy=s)` of uint8 frames
                  bit for bit (INTER_LINEAR: half-pixel centres, clamped
                  edges, OpenCV's fixed-point weights and rounding)
  farneback_flow  `cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3,
                  15, 3, 5, 1.2, 0)`: OpenCV's algorithm
                  (`modules/video/src/optflowgf.cpp`) step by step

Farneback's flow, as OpenCV computes it: a pyramid of `levels` + 1
levels at scale 0.5 (fewer where a side would drop below 32 px), each
level the full frame blurred with a Gaussian of sigma (1/scale - 1) / 2
and resized bilinearly; at each level both frames' quadratic polynomial
expansion (n = 5, sigma = 1.2: a separable Gaussian-weighted filter bank,
the vertical pass in fp32, the horizontal in fp64, replicated edges), the
per-pixel displacement matrices against the flow so far (`_matrices`,
with OpenCV's border weights), and `iters` Jacobi steps of a 15x15 box
filter (fp64 sums) and a 2x2 solve per pixel. Filters are shifted adds,
never convolutions, so no TF32 enters on the card. The result is not
bitwise OpenCV's (sums in other orders); the tests hold it to OpenCV's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MIN_SIZE = 32                    # OpenCV's smallest pyramid side
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
# cv2.getGaussianKernel's fixed tables for sigma <= 0
_SMALL_GAUSS = {1: [1.0], 3: [0.25, 0.5, 0.25],
                5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                    0.03125]}


def bgr_to_gray(img):
    """uint8 [H, W, 3] BGR -> uint8 [H, W], equal to OpenCV's."""
    x = img.to(torch.int32)
    y = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798
         + 16384) >> 15
    return y.to(torch.uint8)


def laplacian_var(gray):
    """Variance (float64, a 0-d tensor) of the ksize-1 Laplacian of
    [H, W] with reflect-101 edges."""
    g = gray.double()
    p = F.pad(g[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    lap = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * g
    return lap.var(unbiased=False)


def _linear_taps(n_out, n_in, scale, device):
    """Source index pairs and 11-bit fixed-point weights of cv2's
    INTER_LINEAR along one axis: x = (d + 0.5) / scale - 0.5 in fp32,
    clamped at both ends."""
    d = torch.arange(n_out, dtype=torch.float64, device=device)
    sx = ((d + 0.5) * (1.0 / scale) - 0.5).float()
    x0 = torch.floor(sx)
    f = sx - x0
    x0 = x0.long()
    low = x0 < 0
    high = x0 >= n_in - 1
    f = torch.where(low | high, 0.0, f)
    x0 = torch.where(low, 0, torch.where(high, n_in - 1, x0))
    a0 = torch.round((1 - f) * 2048).long()
    a1 = torch.round(f * 2048).long()
    return x0, (x0 + 1).clamp(max=n_in - 1), a0, a1


def resize_linear(img, scale):
    """`cv2.resize(img, None, fx=scale, fy=scale)` of uint8 [H, W, C]
    (INTER_LINEAR), bit for bit: the output side is round(side * scale);
    each row blended with 11-bit weights, then the rows with OpenCV's
    vectorised fixed-point rounding."""
    H, W = img.shape[:2]
    h, w = round(H * scale), round(W * scale)
    y0, y1, b0, b1 = _linear_taps(h, H, scale, img.device)
    x0, x1, a0, a1 = _linear_taps(w, W, scale, img.device)
    S = img.long()
    D = S[:, x0] * a0[:, None] + S[:, x1] * a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((b0 * (D[y0] >> 4)) >> 16) + ((b1 * (D[y1] >> 4)) >> 16)
           + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def _gauss_taps(ksize, sigma):
    """cv2.getGaussianKernel(ksize, sigma) as fp32 values (a list)."""
    if sigma <= 0 and ksize in _SMALL_GAUSS:
        k = np.asarray(_SMALL_GAUSS[ksize], np.float64)
    else:
        sigma = sigma if sigma > 0 else ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
        x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
        k = np.exp(-0.5 * x * x / (sigma * sigma))
        k /= k.sum()
    return [float(v) for v in k.astype(np.float32)]


def _sep_filter(x, taps, mode):
    """Separable filter of fp32 [H, W] by the 1-D `taps` (odd length),
    rows then columns, with `mode` ("reflect" = reflect-101, or
    "replicate") edges, as shifted adds."""
    r = len(taps) // 2
    H, W = x.shape
    p = F.pad(x[None, None], (0, 0, r, r), mode=mode)[0, 0]
    v = sum(t * p[i:i + H] for i, t in enumerate(taps))
    p = F.pad(v[None, None], (r, r, 0, 0), mode=mode)[0, 0]
    return sum(t * p[:, i:i + W] for i, t in enumerate(taps))


def _poly_setup(n, sigma):
    """OpenCV's `FarnebackPrepareGaussian`: the fp32 tap vectors g, x g,
    x^2 g over [-n, n] and the entries (ig11, ig03, ig33, ig55) of the
    inverse moment matrix."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)
    gd = g.astype(np.float64)
    gg = gd[:, None] * gd[None, :]                     # [y, x]
    xx = x[None, :] ** 2
    yy = x[:, None] ** 2
    G = np.zeros((6, 6))
    G[0, 0] = gg.sum()
    G[1, 1] = (gg * xx).sum()
    G[3, 3] = (gg * xx * xx).sum()
    G[5, 5] = (gg * xx * yy).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    iG = np.linalg.inv(G)
    return g, xg, xxg, (iG[1, 1], iG[0, 3], iG[3, 3], iG[5, 5])


def poly_expansion(img, n=5, sigma=1.2):
    """OpenCV's `FarnebackPolyExp` of fp32 [H, W] -> [5, H, W] fp32: the
    y and x linear, y^2, x^2 and xy coefficients of each pixel's
    Gaussian-weighted quadratic fit (replicated edges)."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_setup(n, sigma)
    H, W = img.shape
    p = F.pad(img[None, None], (0, 0, n, n), mode="replicate")[0, 0]
    row0 = img * float(g[n])
    row1 = torch.zeros_like(img)
    row2 = torch.zeros_like(img)
    for k in range(1, n + 1):
        up, dn = p[n - k:n - k + H], p[n + k:n + k + H]
        s = up + dn
        row0 = row0 + float(g[n + k]) * s
        row1 = row1 + float(xg[n + k]) * (dn - up)
        row2 = row2 + float(xxg[n + k]) * s
    rows = F.pad(torch.stack([row0, row1, row2])[None].double(),
                 (n, n, 0, 0), mode="replicate")[0]
    c = rows[:, :, n:n + W]
    b1 = c[0] * float(g[n])
    b3 = c[1] * float(g[n])
    b5 = c[2] * float(g[n])
    b2 = b4 = b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        lo, hi = rows[:, :, n - k:n - k + W], rows[:, :, n + k:n + k + W]
        s0 = hi[0] + lo[0]
        b1 = b1 + s0 * float(g[n + k])
        b4 = b4 + s0 * float(xxg[n + k])
        b2 = b2 + (hi[0] - lo[0]) * float(xg[n + k])
        b3 = b3 + (hi[1] + lo[1]) * float(g[n + k])
        b6 = b6 + (hi[1] - lo[1]) * float(xg[n + k])
        b5 = b5 + (hi[2] + lo[2]) * float(g[n + k])
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55]).float()


def _border_scale(n, device):
    """OpenCV's weights of the 5 pixels nearest each edge."""
    s = np.ones(n, np.float32)
    for i, b in enumerate(_BORDER[:n]):
        s[i] *= b
        s[n - 1 - i] *= b
    return torch.from_numpy(s).to(device)


def _matrices(R0, R1, flow):
    """OpenCV's `FarnebackUpdateMatrices`: [5, H, W] fp32 (G11, G12, G22,
    h1, h2) of each pixel's displacement system against R1 sampled at
    the pixel moved by flow [2, H, W] (x, y)."""
    _, H, W = R0.shape
    dev = R0.device
    dx, dy = flow[0], flow[1]
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    fx, fy = xs + dx, ys + dy
    x1f, y1f = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1f, fy - y1f
    x1, y1 = x1f.long(), y1f.long()
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    xa, ya = x1.clamp(0, W - 2), y1.clamp(0, H - 2)
    a00 = (1 - fx) * (1 - fy)
    a01 = fx * (1 - fy)
    a10 = (1 - fx) * fy
    a11 = fx * fy
    r = (a00 * R1[:, ya, xa] + a01 * R1[:, ya, xa + 1]
         + a10 * R1[:, ya + 1, xa] + a11 * R1[:, ya + 1, xa + 1])
    r2 = torch.where(inside, r[0], 0.0)
    r3 = torch.where(inside, r[1], 0.0)
    r4 = torch.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = torch.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = torch.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    scale = _border_scale(H, dev)[:, None] * _border_scale(W, dev)[None, :]
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3])


def _box(M, size):
    """size x size box mean of [C, H, W] with replicated edges, summed in
    fp64 (OpenCV's running sums)."""
    m = size // 2
    _, H, W = M.shape
    p = F.pad(M[None].double(), (m, m, m, m), mode="replicate")[0]
    c = F.pad(p.cumsum(1), (0, 0, 1, 0))
    v = c[:, size:size + H] - c[:, :H]
    c = F.pad(v.cumsum(2), (1, 0))
    return (c[:, :, size:size + W] - c[:, :, :W]) / (size * size)


def _solve(M, winsize):
    """OpenCV's `FarnebackUpdateFlow_Blur`: the flow [2, H, W] (x, y)
    that solves each pixel's box-filtered 2x2 system."""
    g11, g12, g22, h1, h2 = _box(M, winsize)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet]).float()


def pyramid_levels(ht, wd, levels=3, pyr_scale=0.5):
    """OpenCV's level count: the coarsest level k <= levels whose sides
    stay at least MIN_SIZE."""
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale
        if wd * scale < MIN_SIZE or ht * scale < MIN_SIZE:
            return k
    return levels


def farneback_flow(prev, nxt, pyr_scale=0.5, levels=3, winsize=15,
                   iters=3, poly_n=5, poly_sigma=1.2):
    """Dense flow [H, W, 2] fp32 (x, y) from uint8 gray [H, W] prev to
    nxt, on their device (OpenCV's flags 0: no initial flow, box
    window)."""
    H, W = prev.shape
    frames = (prev.float(), nxt.float())
    flow = None
    for k in range(pyramid_levels(H, W, levels, pyr_scale), -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(int(round(sigma * 5)) | 1, 3)
        h, w = round(H * scale), round(W * scale)
        taps = _gauss_taps(ksize, sigma)
        R = []
        for img in frames:
            I = _sep_filter(img, taps, "reflect")
            if (h, w) != (H, W):
                I = F.interpolate(I[None, None], size=(h, w),
                                  mode="bilinear", align_corners=False)[0, 0]
            R.append(poly_expansion(I, poly_n, poly_sigma))
        if flow is None:
            flow = torch.zeros((2, h, w), device=prev.device)
        else:
            flow = F.interpolate(flow[None], size=(h, w), mode="bilinear",
                                 align_corners=False)[0] / pyr_scale
        M = _matrices(R[0], R[1], flow)
        for i in range(iters):
            flow = _solve(M, winsize)
            if i < iters - 1:
                M = _matrices(R[0], R[1], flow)
    return flow.permute(1, 2, 0).contiguous()

