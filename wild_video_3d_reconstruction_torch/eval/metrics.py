"""Trajectory metrics: timestamp association, Sim(3) alignment, ATE, RPE.

The port's copy of the JAX package's `eval/metrics.py`: the same
functions and protocols (the evo-free ATE of `evaluation/dpvo_eva_tum.py`
with Sim(3) Umeyama alignment, RPE over a frame delta, the KITTI relative
errors, the TUM and EuRoC ground-truth loaders). The relative poses go
through the port's `ops/lie.py` in float64 (the JAX package runs them at
its default precision).
"""

from __future__ import annotations

import numpy as np
import torch

from ..loop.umeyama import umeyama_alignment
from ..ops import lie


def associate(t_a, t_b, max_diff=0.02):
    """Nearest-timestamp association; returns index pairs (ia, ib)."""
    ia, ib = [], []
    order = np.argsort(t_b)
    t_b_sorted = np.asarray(t_b)[order]
    for i, ta in enumerate(np.asarray(t_a)):
        j = np.searchsorted(t_b_sorted, ta)
        best, bestd = None, max_diff
        for cand in (j - 1, j):
            if 0 <= cand < len(t_b_sorted):
                d = abs(t_b_sorted[cand] - ta)
                if d <= bestd:
                    best, bestd = cand, d
        if best is not None:
            ia.append(i)
            ib.append(order[best])
    return np.asarray(ia, int), np.asarray(ib, int)


def align_trajectory(est_xyz, gt_xyz, correct_scale=True):
    """Umeyama alignment est -> gt; returns aligned est and (R, t, s)."""
    R, t, s = umeyama_alignment(est_xyz.T, gt_xyz.T)
    if R is None:
        return est_xyz, (np.eye(3), np.zeros(3), 1.0)
    if not correct_scale:
        s = 1.0
    aligned = (s * (R @ est_xyz.T)).T + t
    return aligned, (R, t, s)


def ate_rmse(est_poses, est_t, gt_poses, gt_t, max_diff=0.08,
             correct_scale=True):
    """Absolute trajectory error (RMSE of translation after Sim3 alignment).

    est_poses/gt_poses: [N, 7] c2w (x y z qx qy qz qw); returns (rmse, n)."""
    ia, ib = associate(est_t, gt_t, max_diff)
    if len(ia) < 3:
        return float("inf"), 0
    est = np.asarray(est_poses)[ia, :3]
    gt = np.asarray(gt_poses)[ib, :3]
    aligned, _ = align_trajectory(est, gt, correct_scale)
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), len(ia)


def _relative_log(est_a, est_b, gt_a, gt_b):
    """log((est_a^-1 est_b)^-1 (gt_a^-1 gt_b)) in float64, [6]."""
    ea, eb, ga, gb = (torch.as_tensor(np.asarray(p, np.float64))
                      for p in (est_a, est_b, gt_a, gt_b))
    de = lie.se3_mul(lie.se3_inv(ea), eb)
    dg = lie.se3_mul(lie.se3_inv(ga), gb)
    return lie.se3_log(lie.se3_mul(lie.se3_inv(de), dg)).numpy()


def rpe(est_poses, gt_poses, delta=1):
    """Relative pose error (translation, rotation deg) over index delta."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = min(len(est), len(gt)) - delta
    terr, rerr = [], []
    for i in range(n):
        rel = _relative_log(est[i], est[i + delta], gt[i], gt[i + delta])
        terr.append(np.linalg.norm(rel[:3]))
        rerr.append(np.degrees(np.linalg.norm(rel[3:])))
    return float(np.sqrt(np.mean(np.square(terr)))), \
        float(np.sqrt(np.mean(np.square(rerr))))


def kitti_rel_err(est_poses, gt_poses,
                  lengths=(100, 200, 300, 400, 500, 600, 700, 800)):
    """KITTI-protocol relative errors: translation (%) and rotation
    (deg/m) averaged over all sub-sequences of the given path lengths.
    est/gt: [N, 7] c2w, associated 1:1. Returns (t_rel_percent,
    r_rel_deg_per_m, n_subseq)."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = min(len(est), len(gt))
    dist = np.zeros(n)
    dist[1:] = np.cumsum(np.linalg.norm(np.diff(gt[:n, :3], axis=0),
                                        axis=1))

    t_errs, r_errs, cnt = [], [], 0
    for first in range(0, n - 1, max(1, n // 100)):
        for L in lengths:
            # first index at least L meters down the ground-truth path
            last = np.searchsorted(dist, dist[first] + L)
            if last >= n:
                continue
            rel = _relative_log(est[first], est[last], gt[first], gt[last])
            t_errs.append(np.linalg.norm(rel[:3]) / L * 100.0)
            r_errs.append(np.degrees(np.linalg.norm(rel[3:])) / L)
            cnt += 1
    if not cnt:
        return float("nan"), float("nan"), 0
    return float(np.mean(t_errs)), float(np.mean(r_errs)), cnt


def ate_scale(est_poses, est_t, gt_poses, gt_t, max_diff=0.08):
    """ATE with explicit similarity-scale report, the
    `evaluate_ate_scale.py` protocol: returns (rmse, scale, n)."""
    ia, ib = associate(est_t, gt_t, max_diff)
    if len(ia) < 3:
        return float("inf"), 1.0, 0
    est = np.asarray(est_poses)[ia, :3]
    gt = np.asarray(gt_poses)[ib, :3]
    aligned, (_, _, s) = align_trajectory(est, gt, correct_scale=True)
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), float(s), len(ia)


def load_tum_groundtruth(path):
    """TUM groundtruth.txt: `t x y z qx qy qz qw` (c2w)."""
    data = np.loadtxt(path, comments="#")
    return data[:, 1:8], data[:, 0]


def load_euroc_groundtruth(path):
    """EuRoC state_groundtruth_estimate0/data.csv -> (poses c2w, tstamps s).

    CSV layout: t[ns], p_xyz, q_wxyz, ... ; quaternion reordered to xyzw."""
    data = np.loadtxt(path, delimiter=",", comments="#")
    t = data[:, 0] / 1e9
    pos = data[:, 1:4]
    q_wxyz = data[:, 4:8]
    q_xyzw = q_wxyz[:, [1, 2, 3, 0]]
    return np.concatenate([pos, q_xyzw], axis=1), t
