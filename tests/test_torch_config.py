"""The port's DPVO refuses the config values whose behaviour it does not
have yet, and accepts those that change no result.

The JAX package changes its result for PATCH_SELECTOR (`slam/steps.py:87`),
ENABLE_GLOBAL_BA (`slam/dpvo.py:555`, with USE_DISTANCE_EDGES read only by
its global BA) and loop_enabled (`demo.py:67`); until the port has them,
`DPVO(cfg)` raises instead of running as if they were at their defaults.
"""

import pytest

from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig

SMALL = dict(BUFFER_SIZE=32, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
             OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
             MEM=12)


@pytest.mark.parametrize("key, value", [("PATCH_SELECTOR", "keypoints"),
                                        ("ENABLE_GLOBAL_BA", True),
                                        ("loop_enabled", True)])
def test_unported_config_value_raises(key, value):
    cfg = DPVOConfig(**SMALL, **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        DPVO(cfg, None, 48, 64, device="cpu")


def test_config_values_that_change_no_result_are_accepted():
    cfg = DPVOConfig(**SMALL, PIPELINE_CHUNK=4, EDGE_TIERS=3,
                     PALLAS_CORR=False, PALLAS_HYBRID_BUDGET=64)
    slam = DPVO(cfg, None, 48, 64, device="cpu")
    assert slam.cfg.EDGE_TIERS == 3 and not slam.is_initialized
