"""Training losses: the reprojected patch flow and the relative pose
geodesic.

Counterpart of the JAX package's `train/loss.py` (the published DPVO
recipe): the flow error of the supervised edges' patch centres, and the
SE3 log error of consecutive relative poses, summed over the unrolled
steps with weights gamma^(n - s - 1).
"""

from __future__ import annotations

import torch

from ..ops import lie


def flow_loss(step_out):
    c = step_out["coords"][..., 1, 1, :]
    g = step_out["coords_gt"][..., 1, 1, :]
    v = step_out["valid"]
    d = c - g
    # double-where: masked rows are replaced before the norm, so its
    # non-differentiable point at 0 cannot poison the backward pass
    d = torch.where(v[..., None] > 0, d, 1.0)
    err = torch.sqrt((d * d).sum(-1) + 1e-12)
    return (v * err).sum() / torch.clamp(v.sum(), min=1.0)


def pose_loss(step_out, w_rot=10.0):
    """Geodesic error of consecutive relative poses."""
    P_est = step_out["poses"]
    P_gt = step_out["poses_gt"]
    dG_est = lie.se3_mul(P_est[1:], lie.se3_inv(P_est[:-1]))
    dG_gt = lie.se3_mul(P_gt[1:], lie.se3_inv(P_gt[:-1]))
    err = lie.se3_log(lie.se3_mul(dG_est, lie.se3_inv(dG_gt)))
    t_err = torch.linalg.norm(err[:, :3], dim=-1)
    r_err = torch.linalg.norm(err[:, 3:], dim=-1)
    return (t_err + w_rot * r_err).mean()


def total_loss(traj, gamma=0.9, w_flow=0.1, w_pose=1.0):
    """(loss, metrics): the weighted sum over the steps; metrics hold the
    last step's flow and pose losses and the total."""
    n = len(traj)
    loss = 0.0
    metrics = {}
    for s, out in enumerate(traj):
        w = gamma ** (n - s - 1)
        fl = flow_loss(out)
        pl = pose_loss(out)
        loss = loss + w * (w_flow * fl + w_pose * pl)
        if s == n - 1:
            metrics = {"flow_loss": fl, "pose_loss": pl}
    metrics["loss"] = loss
    return loss, metrics
