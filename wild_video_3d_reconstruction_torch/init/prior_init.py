"""Scene bootstrap from external depth and pose priors.

Counterpart of the JAX package's `init/prior_init.py`: dense metric
depths and camera-to-world poses of the first frames (from the geometric
bootstrap, MASt3R, COLMAP or an RGB-D sensor) written into a `DPVO`'s
state, so tracking starts metrically anchored.

Both functions write the state's tensors in place (`index_copy_`,
`copy_`): captured CUDA graphs hold those storages (`slam/graphs.py`).
"""

from __future__ import annotations

import torch

from ..models.vonet import RES
from ..ops import lie


@torch.no_grad()
def init_from_prior(slam, depths, poses_c2w, indices):
    """Set the patch depths (the median prior depth under each patch's
    3x3 pixels, as inverse depth, in `patches` and `patches_est`) and the
    poses of the given keyframe slots.

    depths [N, H, W] metric depth at full resolution, poses_c2w [N, 4, 4]
    camera-to-world matrices, both indexed by slot."""
    st = slam.state
    dev = st.poses.device
    M = slam.cfg.PATCHES_PER_FRAME
    w2c = lie.se3_inv(lie.se3_from_matrix(
        torch.as_tensor(poses_c2w, dtype=torch.float32, device=dev)))
    for idx in indices:
        depth = torch.as_tensor(depths[idx], dtype=torch.float32,
                                device=dev)
        H, W = depth.shape
        sl = slice(idx * M, (idx + 1) * M)
        rows = st.patches[sl]
        px = (rows[:, 0] * RES).long().clamp(0, W - 1)
        py = (rows[:, 1] * RES).long().clamp(0, H - 1)
        med = depth[py, px].reshape(M, -1).median(dim=1).values
        rows[:, 2] = (1.0 / med.clamp(min=1e-6))[:, None, None]
        st.patches_est[sl] = rows
        st.poses[idx] = w2c[idx]


@torch.no_grad()
def anchor_first_frame(slam):
    """Re-anchor every pose of the state so that slot 0 is the identity."""
    poses = slam.state.poses
    inv0 = lie.se3_inv(poses[0]).expand_as(poses)
    poses.copy_(lie.se3_mul(poses, inv0))
