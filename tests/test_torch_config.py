"""The port's DPVO runs every config value of the JAX package, and accepts
those that change no result.

loop_enabled: true builds the long-term loop closure (its parity with the
JAX package is in `tests/test_torch_loop.py`); PATCH_SELECTOR: keypoints
(`slam/steps.py:87`) and
ENABLE_GLOBAL_BA (`slam/dpvo.py:555`, with USE_DISTANCE_EDGES and
DISTANCE_THRESH read only by its global BA) are ported: DPVO runs with
them (their parity with the JAX package is in
`tests/test_torch_depth_mask.py`, `tests/test_torch_wild_loops.py` and
`tests/test_torch_global_ba.py`).
"""

import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig

SMALL = dict(BUFFER_SIZE=32, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
             OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
             MEM=12)


def test_loop_enabled_constructs_and_terminates():
    """loop_enabled: true attaches the loop closure, which logs a VLAD
    descriptor per steady frame (desc_log [LOG_CAP, DESC_DIM]), drains
    them every LC_INTERVAL frames and commits every keyframe at
    terminate; a run with it cannot be checkpointed."""
    from wild_video_3d_reconstruction_torch.slam.checkpoint import save_slam

    cfg = DPVOConfig(**SMALL, loop_enabled=True, LC_INTERVAL=2,
                     MOTION_PROBE_THRESH=-1.0, MIXED_PRECISION=False)
    slam = DPVO(cfg, None, 48, 64, device="cpu")
    assert slam.loop_closure is not None
    assert tuple(slam.state.desc_log.shape) == (cfg.LOG_CAP, cfg.DESC_DIM)
    rng = np.random.default_rng(0)
    big = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in range(14):
            slam(t, big[2 * t:2 * t + 48, 3 * t:3 * t + 64].copy(),
                 [40.0, 40.0, 32.0, 24.0])
        with pytest.raises(NotImplementedError, match="loop closure"):
            save_slam(slam, "unused")
        poses, _ = slam.terminate()
    finally:
        torch.set_num_threads(n)
    assert poses.shape == (14, 7) and np.isfinite(poses).all()
    assert slam._events_consumed == 4
    assert slam.loop_closure.retrieval.stored[:slam.n_host].all()


def test_config_values_that_change_no_result_are_accepted():
    cfg = DPVOConfig(**SMALL, PIPELINE_CHUNK=4, EDGE_TIERS=3,
                     PALLAS_CORR=False, PALLAS_HYBRID_BUDGET=64)
    slam = DPVO(cfg, None, 48, 64, device="cpu")
    assert slam.cfg.EDGE_TIERS == 3 and not slam.is_initialized


def test_keypoint_patch_selector_runs():
    """PATCH_SELECTOR: keypoints tracks through the warm-up, the bootstrap
    and steady frames; its centres are the image's corner maxima."""
    cfg = DPVOConfig(**SMALL, PATCH_SELECTOR="keypoints",
                     MOTION_PROBE_THRESH=-1.0, MIXED_PRECISION=False)
    slam = DPVO(cfg, None, 48, 64, device="cpu")
    rng = np.random.default_rng(0)
    big = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in range(13):
            slam(t, big[2 * t:2 * t + 48, 3 * t:3 * t + 64].copy(),
                 [40.0, 40.0, 32.0, 24.0])
        poses, _ = slam.terminate()
    finally:
        torch.set_num_threads(n)
    assert slam.is_initialized and np.isfinite(poses).all()
    assert poses.shape == (13, 7)


def test_global_ba_constructs_and_terminates(capsys):
    """ENABLE_GLOBAL_BA: true sizes the feature rings to the buffer and
    runs global BA over every keyframe at terminate, before the
    trajectory."""
    cfg = DPVOConfig(**SMALL, ENABLE_GLOBAL_BA=True, MOTION_PROBE_THRESH=-1.0,
                     MIXED_PRECISION=False)
    slam = DPVO(cfg, None, 48, 64, device="cpu")
    assert slam.state.fmap1.shape[0] == cfg.BUFFER_SIZE
    rng = np.random.default_rng(0)
    big = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in range(12):
            slam(t, big[2 * t:2 * t + 48, 3 * t:3 * t + 64].copy(),
                 [40.0, 40.0, 32.0, 24.0])
        poses, _ = slam.terminate()
    finally:
        torch.set_num_threads(n)
    assert f"Global BA over {slam.n} keyframes" in capsys.readouterr().out
    assert poses.shape == (12, 7) and np.isfinite(poses).all()
