"""The whole loop with the trained weights on a rendered walk, against the
JAX package.

`eval/synth_ate.py`'s protocol (48x64, 16 patches, `DEPTH_INIT:
median`, the motion probe stubbed) over the first FRAMES frames of the
seed-0 walk, with `weights/vonet_synth_tpu_r3_step2000.pth`. The JAX
DPVO runs it with the orbax restore of the same checkpoint; the port's
`synth_ate.run` runs it on the CPU fed the JAX run's draws (its patch
centres and inverse depths from the state key, `jax_raw_draws`), both
in fp32 (the JAX DPVO with an fp32 state, ROADMAP R6), the port on one
CPU thread with its edge tiers on (exact: dead rows are inert in every
stage, `tests/test_torch_steady.py`), which cuts its plain correlation to
the live prefix of the edge table. The protocol's warm-up appends 2880
edge rows before the bootstrap's retirement, past the JAX package's
table of 2048 (`edge_capacity`), whose writes then land clamped on its
last rows (ROADMAP R4); the port's table holds them
(`slam/state.py:edge_rows`), so the JAX state gets the port's rows.

Tolerances: poses within 1e-2 absolute, as
`test_torch_slam.py::test_slice_trajectory_matches_jax` (fp32 rounding
of the encoders amplified by the bootstrap and the steady BA rounds);
the same keyframe drops; the Sim(3) ATE within 1e-3 and the identity
floor within 1e-6 (the same fp32 ground truth through two se3_inv).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.slam import state as tstate
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_tpu.eval import metrics as jmetrics
from wild_video_3d_reconstruction_tpu.ops import lie as jlie
from wild_video_3d_reconstruction_tpu.slam import DPVO as JDPVO
from wild_video_3d_reconstruction_tpu.slam import state as jstate
from wild_video_3d_reconstruction_tpu.train import synth as jsynth
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

from test_torch_slam import TOL_TRAJ, one_thread
from test_torch_weights import WEIGHTS, exporter

FRAMES = 20
HT, WD = 48, 64
# the JAX package's `eval/synth_ate.py:run` config, in fp32
PROTOCOL = dict(BUFFER_SIZE=max(FRAMES + 8, 64), PATCHES_PER_FRAME=16,
                REMOVAL_WINDOW=8, OPTIMIZATION_WINDOW=6, PATCH_LIFETIME=5,
                KEYFRAME_INDEX=2, MEM=16, GRADIENT_BIAS=False,
                PALLAS_CORR=False, CORR_CHUNK=1024, DEPTH_INIT="median",
                MOTION_PROBE_THRESH=-1.0)
TOL_ATE = 1e-3
TOL_FLOOR = 1e-6


def jax_raw_draws(n, M, h, w, kind="random", seed=0):
    """Per frame, the draws the JAX DPVO takes from its state key
    (`insert_frame` with key=None, then `select_patches`), as keyword
    arguments of the port's `DPVO.__call__`: the raw centre draws
    (`cand`; 4M with `jitter` for the mask selection, else M) and the
    inverse depths; the port runs the selection on them."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        rng, k_sel, k_depth = jax.random.split(rng, 3)
        kx, ky, kr = jax.random.split(k_sel, 3)
        m = 4 * M if kind == "mask" else M
        x = jax.random.randint(kx, (m,), 1, w - 1)
        y = jax.random.randint(ky, (m,), 1, h - 1)
        draw = dict(cand=np.stack([np.asarray(x), np.asarray(y)], -1)
                    .astype(np.float32),
                    inv_depths=np.asarray(jax.random.uniform(k_depth, (M,))))
        if kind == "mask":
            draw["jitter"] = np.asarray(jax.random.uniform(kr, (m,)))
        out.append(draw)
    return out


EDGE_KEYS = ("ii", "jj", "kk", "valid", "net", "target", "weight")


def jax_state(cfg, rows):
    """The JAX DPVO's initial state in fp32 with an edge table of `rows`
    rows (the port's `edge_rows`, R4)."""
    st = jstate.init_state(cfg, HT, WD, feat_dtype=jnp.float32, seed=0)
    grow = {}
    for k in EDGE_KEYS:
        a = getattr(st, k)
        pad = jnp.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
        grow[k] = jnp.concatenate([a, pad])
    return st._replace(**grow)


def jax_run(params, frames, cfg, inputs=None):
    """The JAX DPVO over rendered frames with an fp32 state and the port's
    edge rows; inputs: per frame (depth, mask) or None. Returns (poses
    c2w, tstamps, DPVO)."""
    js = JDPVO(cfg, params, HT, WD, seed=0)
    js.state = jax_state(cfg, tstate.edge_rows(cfg))
    images, intr = frames
    for t in range(len(images)):
        depth, mask = inputs[t] if inputs else (None, None)
        js(t, images[t], depth, mask, intrinsics=intr)
    poses, tstamps = js.terminate()
    return poses, tstamps, js


def jax_ate(est, tstamps, poses_gt_w2c):
    """ATE, n and floor as the JAX package's `synth_ate.run` scores them."""
    n = len(poses_gt_w2c)
    gt = np.asarray(jlie.se3_inv(jnp.asarray(poses_gt_w2c)))
    t_gt = np.arange(n, dtype=np.float64)
    ate, k = jmetrics.ate_rmse(est, tstamps, gt, t_gt)
    ident = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (n, 1))
    floor, _ = jmetrics.ate_rmse(ident, t_gt, gt, t_gt)
    return ate, k, floor


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, exporter.restore())


@pytest.fixture(scope="module")
def runs(params):
    images, poses_gt, intr = jsynth.render_sequence(0, frames=FRAMES)
    jp, jt, js = jax_run(params, (images, intr),
                         JConfig(**PROTOCOL, MIXED_PRECISION=False))
    draws = jax_raw_draws(FRAMES, 16, HT // 4, WD // 4)
    mp = pytest.MonkeyPatch()
    mp.setattr(tsteps, "TIER_ON_CPU", True)
    mp.setattr(tsteps, "TIER_MIN_EDGES", 0)
    try:
        with one_thread():
            port = tsynth_ate.run(str(WEIGHTS), frames=FRAMES, device="cpu",
                                  draws=draws,
                                  cfg_overrides=dict(MIXED_PRECISION=False))
    finally:
        mp.undo()
    return dict(jp=jp, jt=jt, js=js, port=port,
                jate=jax_ate(jp, jt, poses_gt))


def test_protocol_config_is_the_jax_packages():
    cfg = tsynth_ate.config(FRAMES)
    for k, v in PROTOCOL.items():
        assert getattr(cfg, k) == v, k


def test_trained_loop_poses_match_jax(runs):
    port, jp = runs["port"], runs["jp"]
    assert port["poses"].shape == jp.shape == (FRAMES, 7)
    np.testing.assert_allclose(port["poses"], jp, atol=TOL_TRAJ, rtol=0)
    assert port["n_keyframes"] == runs["js"].n_host
    assert port["n_keyframes"] < FRAMES      # trained weights drop frames


def test_trained_loop_ate_matches_jax(runs):
    port = runs["port"]
    ate, n, floor = runs["jate"]
    assert port["n_aligned"] == n == FRAMES
    assert abs(port["ate_rmse"] - ate) <= TOL_ATE
    assert abs(port["ate_floor_identity"] - floor) <= TOL_FLOOR
    assert port["ate_rmse"] < port["ate_floor_identity"]
