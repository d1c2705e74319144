"""Sim(3) point-set alignment (Umeyama 1991), numpy only.

The port's copy of `umeyama_alignment` from the JAX package's
`loop/umeyama.py`, which the trajectory metrics need. The rest of that
module (RANSAC) belongs to loop closure (ROADMAP Queue 1 item 12).
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
