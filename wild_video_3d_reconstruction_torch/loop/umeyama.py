"""Sim(3) point-set alignment: Umeyama (1991) and a vectorised RANSAC,
numpy only.

The port's copy of the JAX package's `loop/umeyama.py`: the trajectory
metrics align with `umeyama_alignment`; the loop closure fits a measured
Sim(3) with `ransac_umeyama`, all hypotheses solved in one batched 3x3 SVD.
The one difference: `ransac_umeyama` draws its samples from the caller's
`np.random.Generator` (the JAX package's takes a seed or fresh entropy).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, eps=None):
    """Least-squares Sim(3) between column point sets x, y [m, n].

    Returns (R, t, s) with y ~ s R x + t, or (None, None, None) when the
    covariance is rank deficient (Umeyama 1991)."""
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = ((x - mean_x[:, None]) ** 2).sum() / n
    cov = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov)
    eps = np.finfo(d.dtype).eps if eps is None else eps
    if np.count_nonzero(d > eps) < m - 1:
        return None, None, None
    s_mat = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0:
        s_mat[m - 1, m - 1] = -1
    R = u @ s_mat @ v
    c = np.trace(np.diag(d) @ s_mat) / sigma_x
    t = mean_y - c * (R @ mean_x)
    return R, t, c


def _batched_umeyama(xs, ys):
    """xs, ys: [B, 3, k] sample sets -> R [B,3,3], t [B,3], s [B], ok [B]."""
    B, m, k = xs.shape
    mx = xs.mean(axis=2, keepdims=True)
    my = ys.mean(axis=2, keepdims=True)
    xc = xs - mx
    yc = ys - my
    sigma_x = (xc ** 2).sum(axis=(1, 2)) / k
    cov = np.einsum("bik,bjk->bij", yc, xc) / k
    u, d, v = np.linalg.svd(cov)
    ok = (d > 1e-12).sum(axis=1) >= m - 1
    det = np.linalg.det(u) * np.linalg.det(v)
    s_mat = np.tile(np.eye(m), (B, 1, 1))
    s_mat[det < 0, m - 1, m - 1] = -1
    R = u @ s_mat @ v
    s = np.einsum("bii->b", d[..., None] * s_mat) / np.maximum(sigma_x, 1e-12)
    t = my[:, :, 0] - s[:, None] * np.einsum("bij,bj->bi", R, mx[:, :, 0])
    return R, t, s, ok & (sigma_x > 1e-12)


def ransac_umeyama(src_points, dst_points, rng, iterations=400,
                   threshold=0.5):
    """RANSAC Sim(3) fit of dst ~ s R src + t over [n, 3] point sets, the
    minimal samples drawn from rng (an `np.random.Generator`).

    Returns (R, t, s, num_inliers)."""
    n = src_points.shape[0]
    if n < 3:
        return None, None, None, 0
    idx = np.stack([rng.choice(n, 3, replace=False)
                    for _ in range(iterations)])
    xs = np.transpose(src_points[idx], (0, 2, 1))       # [B, 3, 3]
    ys = np.transpose(dst_points[idx], (0, 2, 1))
    R, t, s, ok = _batched_umeyama(xs, ys)

    # score every hypothesis against every point
    proj = np.einsum("bij,nj->bni", R * s[:, None, None], src_points) + \
        t[:, None, :]
    dist = np.linalg.norm(proj - dst_points[None], axis=-1)  # [B, n]
    inl = (dist < threshold) & ok[:, None]
    counts = inl.sum(axis=1)
    best = int(np.argmax(counts))
    if counts[best] < 3:
        return None, None, None, 0
    mask = inl[best]
    Rb, tb, sb = umeyama_alignment(src_points[mask].T, dst_points[mask].T)
    if Rb is None:
        return None, None, None, 0
    return Rb, tb, sb, int(counts[best])


def reduce_edges(flow_mag, ii, jj, max_num_edges, nms, min_sep=30):
    """Greedy low-flow edge proposal with NMS over the source index: edges
    (i, j) with j - i >= min_sep in ascending flow, each suppressing the
    sources within nms of it for its target. Returns [K, 2] int64."""
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    flow_mag = np.asarray(flow_mag)
    if ii.size == 0:
        return np.zeros((0, 2), np.int64)
    Ni, Nj = ii.max() + 1, jj.max() + 1
    ignore = np.zeros((Ni, Nj), bool)
    out = []
    for idx in np.argsort(flow_mag):
        if len(out) >= max_num_edges:
            break
        i, j, mag = ii[idx], jj[idx], flow_mag[idx]
        if (j - i) < min_sep or mag >= 1000 or ignore[i, j]:
            continue
        out.append((i, j))
        lo, hi = max(0, i - nms), min(Ni, i + nms + 1)
        ignore[lo:hi, j] = True
    return np.asarray(out, np.int64).reshape(-1, 2)
