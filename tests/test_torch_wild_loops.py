"""Whole loops with the wild-video inputs, the port against the JAX
package, with the trained weights.

The rendered wild input (`eval/synth_ate.py:wild_sequence` at 48x64: a
walk with a moving occluder, its mask and the world's metric depth) runs
through the JAX DPVO and the port's DPVO on the CPU (the tiny fp32
config of `tests/test_torch_slam.py`, the JAX DPVO with an fp32 state and
the port's edge rows), the port fed the JAX run's draws:

* depth + mask on every frame: the prior and BA's depth anchors, the
  scale alignment once initialized, the mask-constrained selection;
* `PATCH_SELECTOR: keypoints` on the images alone.

Tolerances as the slice's (`test_slice_trajectory_matches_jax`): poses
within 1e-2 absolute, the same keyframe drops and timestamps.
"""

import jax
import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

from test_torch_slam import HT, TINY, TOL_TRAJ, WD, one_thread
from test_torch_synth_ate import jax_raw_draws, jax_run
from test_torch_weights import WEIGHTS, exporter

N_FRAMES = 15
M = TINY["PATCHES_PER_FRAME"]


@pytest.fixture(scope="module")
def wild():
    images, _, intr, depths, masks = tsynth_ate.wild_sequence(
        0, frames=N_FRAMES, ht=HT, wd=WD, fx=40.0, fy=40.0)
    return images, intr, depths, masks


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, exporter.restore())


@pytest.mark.parametrize("kind", ["depth_mask", "keypoints"])
def test_wild_loop_matches_jax(params, wild, kind):
    images, intr, depths, masks = wild
    extra = dict(PATCH_SELECTOR="keypoints") if kind == "keypoints" else {}
    inputs = list(zip(depths, masks)) if kind == "depth_mask" else None
    jp, jt, js = jax_run(params, (images, intr), JConfig(**TINY, **extra),
                         inputs)

    draws = jax_raw_draws(N_FRAMES, M, HT // 4, WD // 4,
                          "mask" if kind == "depth_mask" else "random")
    ts = TDPVO(TConfig(**TINY, **extra), str(WEIGHTS), HT, WD,
               device="cpu")
    with one_thread():
        for t in range(N_FRAMES):
            depth, mask = inputs[t] if inputs else (None, None)
            ts(t, images[t], intr, depth=depth, mask=mask, **draws[t])
        tp, tt = ts.terminate()
    assert np.isfinite(tp).all() and tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, atol=TOL_TRAJ, rtol=0)
    np.testing.assert_array_equal(tt, jt)
    assert sorted(ts.delta) == sorted(js.delta)
    if kind == "depth_mask":
        # the priors anchored BA: the live patches carry them
        n = int(ts.state.n_frames)
        est = ts.state.patches_est[:n * M, 2, 1, 1]
        assert (est > 0).all()
