"""Two-view epipolar estimators (numpy, run once at start-up).

The port's copy of the JAX package's `init/epipolar.py`, with the same
arithmetic and the same `np.random.default_rng(seed)` draws, so its
results are bitwise the JAX package's: one 8-point RANSAC skeleton
serves the essential matrix (normalized camera coordinates: the
geometric bootstrap and the self-calibration's degenerate fallback) and
the fundamental matrix (pixel coordinates: the focal self-calibration),
with cheirality pose recovery, midpoint triangulation and the Bougnoux
closed-form focal.
"""

from __future__ import annotations

import numpy as np


def _sampson(F, h0, h1):
    """Squared Sampson distance of h1^T F h0 = 0 per correspondence, of
    one model F [3, 3] -> [N] or of a stack [K, 3, 3] -> [K, N]."""
    Fx0 = h0 @ np.swapaxes(F, -1, -2)
    Ftx1 = h1 @ F
    num = np.sum(h1 * Fx0, -1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + \
        Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / np.maximum(den, 1e-12)


def _ransac_eight_point(p0, p1, fit, sq_thresh, iters, seed):
    """Shared RANSAC loop: sample 8, fit, score by Sampson, refit on the
    best inlier set. `fit(idx)` returns a 3x3 model for h1^T M h0 = 0 of
    the correspondences idx [m], or a stack of them for idx [K, 8]. The
    iters samples are drawn one by one, as the JAX package draws them,
    then fitted and scored at once: the first sample with the most
    inliers wins, as in its loop."""
    N = len(p0)
    if N < 8:
        raise ValueError(f"need at least 8 correspondences, got {N}")
    rng = np.random.default_rng(seed)
    h0 = np.concatenate([p0, np.ones((N, 1))], 1)
    h1 = np.concatenate([p1, np.ones((N, 1))], 1)
    if iters <= 0:
        return None, None, h0, h1

    idx = np.stack([rng.choice(N, 8, replace=False) for _ in range(iters)])
    inl = _sampson(fit(idx), h0, h1) < sq_thresh               # [iters, N]
    k = int(np.argmax(inl.sum(1)))
    best_in = inl[k]
    best = fit(idx[k])
    if best_in.sum() >= 8:
        best = fit(np.where(best_in)[0])
        best_in = _sampson(best, h0, h1) < sq_thresh
    return best, best_in, h0, h1


def essential_ransac(x1n, x2n, iters=500, thresh=1e-3, seed=0):
    """RANSAC normalized 8-point essential matrix.

    x1n/x2n: [N, 2] matched points in *normalized camera* coordinates.
    Returns (E [3, 3], inlier mask [N]) maximizing Sampson-distance
    inliers under squared threshold `thresh`.
    """
    x1n = np.asarray(x1n, float)
    x2n = np.asarray(x2n, float)
    N = len(x1n)
    h1 = np.concatenate([x1n, np.ones((N, 1))], 1)
    h2 = np.concatenate([x2n, np.ones((N, 1))], 1)

    def fit(idx):
        a1, a2 = h1[idx], h2[idx]
        A = (a2[..., :, None] * a1[..., None, :]).reshape(*idx.shape, 9)
        _, _, Vt = np.linalg.svd(A)
        E = Vt[..., -1, :].reshape(*idx.shape[:-1], 3, 3)
        # project to the essential manifold: singular values (1, 1, 0)
        U, _, Vt = np.linalg.svd(E)
        return U @ np.diag([1.0, 1.0, 0.0]) @ Vt

    E, inl, _, _ = _ransac_eight_point(x1n, x2n, fit, thresh, iters, seed)
    return E, inl


def fundamental_ransac(p0, p1, iters=300, thresh=1.0, seed=0):
    """RANSAC normalized 8-point fundamental matrix (pixel coords).

    Returns (F, inlier mask) under Sampson distance `thresh` (pixels)."""
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    N = len(p0)
    h0 = np.concatenate([p0, np.ones((N, 1))], 1)
    h1 = np.concatenate([p1, np.ones((N, 1))], 1)

    def norm_T(p):
        c = p.mean(-2)
        s = np.sqrt(2) / (np.mean(np.linalg.norm(p - c[..., None, :],
                                                 axis=-1), -1) + 1e-9)
        T = np.zeros(p.shape[:-2] + (3, 3))
        T[..., 0, 0] = T[..., 1, 1] = s
        T[..., 0, 2] = -s * c[..., 0]
        T[..., 1, 2] = -s * c[..., 1]
        T[..., 2, 2] = 1.0
        return T

    def fit(idx):
        T0, T1 = norm_T(p0[idx]), norm_T(p1[idx])
        a0 = h0[idx] @ np.swapaxes(T0, -1, -2)
        a1 = h1[idx] @ np.swapaxes(T1, -1, -2)
        A = (a1[..., :, None] * a0[..., None, :]).reshape(*idx.shape, 9)
        _, _, Vt = np.linalg.svd(A)
        F = Vt[..., -1, :].reshape(*idx.shape[:-1], 3, 3)
        U, S, Vt = np.linalg.svd(F)
        D = np.zeros(S.shape[:-1] + (3, 3))
        D[..., 0, 0], D[..., 1, 1] = S[..., 0], S[..., 1]
        F = U @ D @ Vt                                # rank-2 projection
        return np.swapaxes(T1, -1, -2) @ F @ T0

    F, inl, _, _ = _ransac_eight_point(p0, p1, fit, thresh ** 2, iters,
                                       seed)
    return F, inl


def triangulate_midpoint(R, t, x1n, x2n):
    """Midpoint triangulation in frame-1 coordinates.

    Camera 1 at origin; camera 2 with x2 = R x1 + t. Rays: d1 = [x1n, 1],
    d2 = R^T [x2n, 1] from center c2 = -R^T t. Returns [N, 3] points.
    """
    N = x1n.shape[0]
    d1 = np.concatenate([x1n, np.ones((N, 1))], 1)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.concatenate([x2n, np.ones((N, 1))], 1) @ R   # rows: R^T d
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    c2 = -R.T @ t
    # solve for the closest points along the two rays
    b = np.sum(d1 * d2, 1)
    rhs1 = d1 @ c2
    rhs2 = d2 @ c2
    den = np.maximum(1.0 - b * b, 1e-12)
    t1 = (rhs1 - b * rhs2) / den
    t2 = (b * rhs1 - rhs2) / den
    p = d1 * t1[:, None]
    q = c2[None, :] + d2 * t2[:, None]
    return 0.5 * (p + q)


def recover_pose(E, x1n, x2n):
    """Resolve the four (R, t) decompositions of E by cheirality voting.

    Returns (R, t_unit, pts3d_frame1) for the winning hypothesis, where
    x2 = R x1 + t and |t| = 1.
    """
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]
    best = None
    for R, t in cands:
        X = triangulate_midpoint(R, t, x1n, x2n)
        z2 = X @ R.T[:, 2] + t[2]          # depth in camera 2
        score = int(np.sum((X[:, 2] > 0) & (z2 > 0)))
        if best is None or score > best[0]:
            best = (score, R, t, X)
    _, R, t, X = best
    return R, t, X


def focal_from_fundamental(F, p0, p1):
    """Bougnoux closed-form focal estimates (f0, f1) from a fundamental
    matrix and the two principal points (Bougnoux ICCV'98; the same
    formula COLMAP uses for two-view focal bootstrap). Returns NaN for a
    degenerate (negative f^2) geometry."""
    def f2(F, pa, pb):
        ea = np.asarray(pa, float)
        eb = np.asarray(pb, float)
        p_a = np.array([ea[0], ea[1], 1.0])
        p_b = np.array([eb[0], eb[1], 1.0])
        # left epipole e_b: F^T e_b = 0
        _, _, Vt = np.linalg.svd(F.T)
        e_b = Vt[-1]
        ex = np.array([[0, -e_b[2], e_b[1]],
                       [e_b[2], 0, -e_b[0]],
                       [-e_b[1], e_b[0], 0]])
        II = np.diag([1.0, 1.0, 0.0])
        num = -(p_b @ ex @ II @ F @ p_a) * (p_b @ F @ p_a)
        den = p_b @ ex @ II @ F @ II @ F.T @ p_b
        return num / den if abs(den) > 1e-12 else np.nan

    v0 = f2(F, p0, p1)
    v1 = f2(F.T, p1, p0)
    f0 = np.sqrt(v0) if np.isfinite(v0) and v0 > 0 else np.nan
    f1 = np.sqrt(v1) if np.isfinite(v1) and v1 > 0 else np.nan
    return f0, f1
