"""Global BA, the map and the DPVO diagnostics, the port against the JAX
package, on one state.

The JAX DPVO tracks 16 frames of the SLAM smoke test's drifting texture in
`sync_mode` with the configuration of its own global-BA test
(`tests/test_global_ba.py`: ENABLE_GLOBAL_BA, USE_DISTANCE_EDGES,
DISTANCE_THRESH 1e6, MEM 64, BUFFER_SIZE 64, over the tiny fp32 config of
`tests/test_torch_slam.py`). Its state and host bookkeeping are carried
into a port DPVO with the same weights, so tracking drift does not enter,
and each function runs on both:

  * `_pair_distance_matrix`: within TOL_DIST relative (float32 means of
    the same flows, summed in another order);
  * `propose_edges`: the same frame edges, in the same order;
  * `run_global_ba` (one update-operator pass, 2 Gauss-Newton steps):
    poses and the trajectory through the delta chain after it within
    TOL_GBA absolute (the single-step tolerance of
    `tests/test_torch_slam.py`, 1e-4), patch inverse depths (up to about
    10) within TOL_GBA absolute plus TOL_GBA relative;
  * `geo_consistency_check` and `save_inlier_ratio_record`: equal ratios
    and equal files;
  * `points_and_colors`: the same selection, colours equal, points within
    TOL_POINTS relative;
  * `terminate_keyframe`: equal timestamps, poses within 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.slam import global_ba as tgba
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.slam import DPVO as JDPVO
from wild_video_3d_reconstruction_tpu.slam import global_ba as jgba
from wild_video_3d_reconstruction_tpu.slam import state as jstate
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

from test_torch_slam import (HT, INTR, TINY, WD, one_thread, snapshot,
                             synthetic_frames, to_port_state)

GBA = dict(TINY, ENABLE_GLOBAL_BA=True, USE_DISTANCE_EDGES=True,
           DISTANCE_THRESH=1e6, MEM=64, BUFFER_SIZE=64)
N_FRAMES = 16
TOL_DIST = 1e-4
TOL_GBA = 1e-4
TOL_POINTS = 1e-5
HOST = ("counter", "n_host", "is_initialized", "_init_counter")


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JConfig(**GBA), TConfig(**GBA)
    params = jvonet.init_vonet(jax.random.PRNGKey(0))
    js = JDPVO(jcfg, params, HT, WD, seed=0, sync_mode=True)
    js.state = jstate.init_state(jcfg, HT, WD, feat_dtype=jnp.float32,
                                 seed=0)
    for t, img in enumerate(synthetic_frames(N_FRAMES)):
        js(t, img, intrinsics=INTR)
    return jcfg, tcfg, params, js


def carried(pair):
    """(JAX DPVO, port DPVO) on the same state: a copy of the fixture's
    JAX run and a port DPVO given its state and bookkeeping."""
    jcfg, tcfg, params, js = pair
    jcopy = copy.copy(js)
    jcopy.delta = dict(js.delta)
    jcopy.tstamps = js.tstamps.copy()
    ts = TDPVO(tcfg, jax.tree.map(np.asarray, params), HT, WD,
               device="cpu", sync_mode=True)
    ts.state = to_port_state(snapshot(js.state), tcfg)
    ts.runner.state = ts.state
    for k in HOST:
        setattr(ts, k, getattr(js, k))
    ts.tstamps = js.tstamps.copy()
    ts.tlist = list(js.tlist)
    return jcopy, ts


def test_pair_distances_match_jax(pair):
    jcfg, tcfg, _, js = pair
    n = js.n
    n_cap = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 4)
    want = np.asarray(jax.jit(lambda s: jgba._pair_distance_matrix(
        jcfg, s, n_cap))(js.state))[:n, :n]
    _, ts = carried(pair)
    with one_thread():
        got = tgba._pair_distance_matrix(tcfg, ts.state, n).numpy()
    assert got.shape == (n, n) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL_DIST,
                               atol=TOL_DIST * np.abs(want).max())


def test_propose_edges_match_jax(pair):
    jcfg, tcfg, _, js = pair
    jcopy, ts = carried(pair)
    ji, jj = jgba.propose_edges(jcfg, jcopy)
    with one_thread():
        ti, tj = tgba.propose_edges(tcfg, ts)
    n = js.n
    assert len(ti) == (n - 1) + (n - 1) * (n - 2) // 2   # every pair
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)


def test_global_ba_matches_jax(pair):
    """run_global_ba on both, then the trajectory through the delta chain
    (what terminate returns after it)."""
    jcfg, tcfg, _, js = pair
    jcopy, ts = carried(pair)
    ts.delta = {t: (t0, torch.tensor(np.asarray(dP, np.float32)))
                for t, (t0, dP) in jcopy.delta.items()}
    n, M = js.n, jcfg.PATCHES_PER_FRAME
    before = np.asarray(js.state.poses[:n])
    jgba.run_global_ba(jcfg, jcopy)
    with one_thread():
        info = tgba.run_global_ba(tcfg, ts)
    assert info == (n, (n - 1) + (n - 1) * (n - 2) // 2,
                    ((n - 1) + (n - 1) * (n - 2) // 2) * M)
    jp, tp = np.asarray(jcopy.state.poses[:n]), ts.state.poses[:n].numpy()
    assert np.isfinite(tp).all() and np.abs(tp - before).max() > 1e-3
    np.testing.assert_allclose(tp, jp, atol=TOL_GBA, rtol=0)
    np.testing.assert_allclose(ts.state.patches[:n * M].numpy(),
                               np.asarray(jcopy.state.patches[:n * M]),
                               atol=TOL_GBA, rtol=TOL_GBA)
    # the JAX terminate without a second global BA
    jcopy.cfg = jcfg.merge_from_dict({"ENABLE_GLOBAL_BA": False})
    jtraj, jt = jcopy.terminate()
    ttraj, tt = ts.trajectory()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ttraj, jtraj, atol=TOL_GBA, rtol=0)


def test_geo_consistency_and_inlier_record_match_jax(pair, tmp_path):
    jcopy, ts = carried(pair)
    n = jcopy.n
    for q, f in ((n - 2, n - 3), (n - 1, n - 2), (n - 3, n - 5)):
        assert ts.geo_consistency_check(q, f) == \
            jcopy.geo_consistency_check(q, f)
    rj = jcopy.save_inlier_ratio_record(str(tmp_path / "jax"))
    rt = ts.save_inlier_ratio_record(str(tmp_path / "port"))
    assert rt == rj and len(rt) > 0
    for name in ("inlier_ratio_record.txt", "time_stamp.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_points_and_colors_match_jax(pair):
    jcopy, ts = carried(pair)
    jpts, jclr = jcopy.points_and_colors()
    with one_thread():
        tpts, tclr = ts.points_and_colors()
    assert tpts.shape == jpts.shape and tpts.shape[0] > 0
    assert tpts.dtype == np.float32 and tclr.dtype == np.uint8
    np.testing.assert_array_equal(tclr, jclr)
    np.testing.assert_allclose(tpts, jpts, rtol=TOL_POINTS,
                               atol=TOL_POINTS * np.abs(jpts).max())


def test_terminate_keyframe_matches_jax(pair):
    jcopy, ts = carried(pair)
    jp, jt = jcopy.terminate_keyframe()
    tp, tt = ts.terminate_keyframe()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
