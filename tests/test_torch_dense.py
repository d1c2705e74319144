"""Port parity: the dense DROID-style engine.

The port's `ops/dense.py`, `eval/droid_harness.py`, `BasicEncoder8` and
`coords_grid_with_index` against the JAX package's on the same seeded
inputs (JAX on the CPU):

* every `ops/dense.py` function within 1e-5 relative, `depth_filter`'s
  counts exact; `dense_ba` within 1e-4 of the JAX one, and its per-patch
  table path within 1e-5 of the port's one-hot path;
* `basic_encoder8` within 1e-4 (the JAX draws carried across),
  `coords_grid_with_index` exact;
* `CorrFlow` on `tests/test_corr_index.py`'s shifted pair (1e-3 px), and
  `DenseVO` with flows "lk" and "corr" (the trained weights) over 10
  frames at 64x96, each frame from the JAX engine's state: the same
  keyframe decisions, the same dense BA call, the flow targets within
  1e-3 px, and the JAX BA result as close to the port's fp64 solution
  as the port's fp32 one is (R15). The JAX side gets a
  `CorrFlow` without its encoder cache (R12, shown by
  `test_corr_flow_cache_keys_by_frame_not_by_id`: the JAX cache serves
  one frame's features for another).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from wild_video_3d_reconstruction_torch.ba import gauss_newton as tba
from wild_video_3d_reconstruction_torch.eval import droid_harness as tdroid
from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.models import convert as tconvert
from wild_video_3d_reconstruction_torch.models import extractor as textractor
from wild_video_3d_reconstruction_torch.ops import dense as tdense
from wild_video_3d_reconstruction_torch.ops import lie as tlie
from wild_video_3d_reconstruction_torch.ops import projective as tproj
from wild_video_3d_reconstruction_tpu.eval import droid_harness as jdroid
from wild_video_3d_reconstruction_tpu.models import extractor as jextractor
from wild_video_3d_reconstruction_tpu.ops import dense as jdense
from wild_video_3d_reconstruction_tpu.ops import projective as jproj

from test_torch_loop import WEIGHTS, jax_tree

REL = 1e-5
N, HT, WD = 4, 24, 32
VO_HT, VO_WD, VO_FRAMES = 64, 96, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CPU work on one thread, beside the other test workers: torch's,
    and numpy's BLAS (whose thread pool, on a loaded machine, took 9 s
    for one focal estimate that takes 0.3 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def scene():
    """N frames' w2c poses near the identity, disparities in [0.2, 1]."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.05, (N, 6)).astype(np.float32)
    xi[0] = 0
    poses = tlie.se3_exp(torch.from_numpy(xi)).numpy()
    disps = rng.uniform(0.2, 1.0, (N, HT, WD)).astype(np.float32)
    intr = np.array([30.0, 30.0, WD / 2, HT / 2], np.float32)
    return poses, disps, intr


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_iproj_projmap_match_jax(scene):
    poses, disps, intr = scene
    _close(tdense.iproj_dense(*_t(disps, intr)),
           jdense.iproj_dense(*_j(disps, intr)))
    ii, jj = np.array([0, 1, 2, 3, 1]), np.array([1, 0, 3, 2, 3])
    (c_t, v_t), (c_j, v_j) = (tdense.projmap(*_t(poses, disps, intr, ii, jj)),
                              jdense.projmap(*_j(poses, disps, intr, ii, jj)))
    _close(c_t, c_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("pair", [(0, 1), (2, 1), (3, 0)])
def test_frame_distance_matches_jax(scene, pair):
    """One edge, the way the dense VO calls it (the JAX function indexes
    the disparities twice, which agrees only for one edge)."""
    poses, disps, intr = scene
    ii, jj = np.array([pair[0]]), np.array([pair[1]])
    _close(tdense.frame_distance(*_t(poses, disps, intr, ii, jj)),
           jdense.frame_distance(*_j(poses, disps, intr, ii, jj)))


@pytest.mark.parametrize("ix", [0, 2])
def test_depth_filter_counts_match_jax(scene, ix):
    poses, disps, intr = scene
    # neighbours that see frame ix's disparities: consistent copies
    disps = np.repeat(disps[ix:ix + 1], N, 0)
    got = tdense.depth_filter(*_t(poses, disps, intr), ix, thresh=0.05)
    ref = jdense.depth_filter(*_j(poses, disps, intr), ix, thresh=0.05)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.max() > 0


@pytest.fixture(scope="module")
def ba_inputs(scene):
    poses, disps, intr = scene
    rng = np.random.default_rng(1)
    ii = np.array([0, 1, 1, 2, 2, 3, 0, 3], np.int32)
    jj = np.array([1, 0, 2, 1, 3, 2, 2, 1], np.int32)
    coords, _ = tdense.projmap(*_t(poses, disps, intr, ii, jj))
    targets = coords.numpy() + rng.normal(0, 0.5, coords.shape).astype(
        np.float32)
    weights = rng.uniform(0.2, 1.0, targets.shape).astype(np.float32)
    disps0 = np.clip(disps + rng.normal(0, 0.05, disps.shape), 0.1,
                     None).astype(np.float32)
    return poses, disps0, intr, targets, weights, ii, jj


def test_dense_ba_matches_jax(ba_inputs):
    poses, disps, intr, tgt, wgt, ii, jj = ba_inputs
    p_t, d_t = tdense.dense_ba(*_t(poses, disps, intr, tgt, wgt, ii, jj),
                               t0=1, t1=N, stride=4, iterations=2)
    p_j, d_j = jdense.dense_ba(*_j(poses, disps, intr, tgt, wgt, ii, jj),
                               t0=1, t1=N, stride=4, iterations=2)
    _close(p_t, p_j, 1e-4)
    _close(d_t, d_j, 1e-4)
    assert not np.array_equal(d_t.numpy(), disps)


@pytest.mark.parametrize("iterations,rel", [(1, 1e-5), (2, 1e-4)])
def test_dense_ba_table_path_equals_one_hot(ba_inputs, iterations, rel):
    """The per-patch edge table (cap = the most edges sharing a source
    frame) sums what the one-hot [E*M, n*M] product sums: one
    Gauss-Newton step within 1e-5; the second step, relinearised at
    poses that differ in the last bits, within 1e-4 (it read 1.2e-5 on
    the poses and 1.3e-4 on the depths)."""
    poses, disps, intr, tgt, wgt, ii, jj = ba_inputs
    P, D, I, T, Wt, ii_t, jj_t = _t(poses, disps, intr, tgt, wgt, ii, jj)
    patches, t_e, w_e, ii_e, jj_e, kk, valid, (gy, _) = \
        tdense.dense_problem(P, D, I, T, Wt, ii_t.long(), jj_t.long(),
                             stride=4)
    out = {}
    for cap in (None, int(np.bincount(ii).max())):
        cfg = tba.BAConfig(window=N - 1, patch_slots=N * gy.shape[0],
                           iterations=iterations, per_patch_cap=cap)
        out[cap] = tba._bundle_adjust_impl(P, patches, I, t_e, w_e, 1e-4,
                                           ii_e, jj_e, kk, valid, 1, N, 0,
                                           cfg)
    (p1, x1), (p2, x2) = out.values()
    _close(p2, p1.numpy(), rel)
    _close(x2, x1.numpy(), rel)


def test_corr_ops_match_jax():
    rng = np.random.default_rng(2)
    f1 = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    f2 = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    v_t = tdense.corr_volume(*_t(f1, f2))
    v_j = jdense.corr_volume(*_j(f1, f2))
    _close(v_t, v_j)
    pyr_t = tdense.corr_pyramid(v_t, 3)
    pyr_j = jdense.corr_pyramid(jnp.asarray(v_t.numpy()), 3)
    for a, b in zip(pyr_t, pyr_j):
        _close(a, b)
    coords = rng.uniform(-3, 10, (2, 2, 8, 12)).astype(np.float32)
    _close(tdense.corr_index(v_t, torch.from_numpy(coords), 3),
           jdense.corr_index(jnp.asarray(v_t.numpy()), jnp.asarray(coords),
                             3))
    _close(tdense.corr_lookup_pyramid(pyr_t, torch.from_numpy(coords), 2),
           jdense.corr_lookup_pyramid([jnp.asarray(p.numpy())
                                       for p in pyr_t],
                                      jnp.asarray(coords), 2))


def test_coords_grid_with_index_and_basic_encoder8_match_jax():
    rng = np.random.default_rng(3)
    d = rng.uniform(0, 1, (2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tproj.coords_grid_with_index(torch.from_numpy(d)).numpy(),
        np.asarray(jproj.coords_grid_with_index(jnp.asarray(d))))

    params = jax.tree.map(np.asarray, jextractor.init_basic_encoder8(
        jax.random.PRNGKey(0), 96))
    net = tconvert.jax_params_to_torch(
        params, textractor.BasicEncoder8(96, "instance"))
    x = rng.uniform(-0.5, 1.5, (2, 32, 48, 3)).astype(np.float32)
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = jextractor.basic_encoder8(params, jnp.asarray(x), "instance")
    assert got.shape == (2, 4, 6, 96)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    assert textractor.init_basic_encoder8(96, "none")(
        torch.zeros(1, 3, 16, 16)).shape == (1, 96, 2, 2)


# ---------------------------------------------------------------------------
# flow providers and the dense VO
# ---------------------------------------------------------------------------

@functools.cache
def trained():
    return tconvert.as_vonet(WEIGHTS), jax_tree(WEIGHTS)


class FreshCorrFlow(jdroid.CorrFlow):
    """The JAX CorrFlow without its id-keyed encoder cache (R12)."""

    def _feat(self, img):
        return self._encode(jnp.asarray(img))


def _shift_pair():
    """tests/test_corr_index.py's textured pair, shifted -8 px in x."""
    import cv2

    rng = np.random.default_rng(0)
    big = cv2.GaussianBlur(
        rng.integers(0, 255, (VO_HT + 32, VO_WD + 32, 3)).astype(np.uint8),
        (0, 0), 1.0)
    return (np.ascontiguousarray(big[8:8 + VO_HT, 8:8 + VO_WD]),
            np.ascontiguousarray(big[8:8 + VO_HT, 16:16 + VO_WD]))


def test_corr_flow_matches_jax_on_a_shift():
    img_i, img_j = _shift_pair()
    ys, xs = np.meshgrid(np.arange(16, VO_HT - 16, 8),
                         np.arange(16, VO_WD - 16, 8), indexing="ij")
    gx = xs.reshape(-1).astype(np.float32)
    gy = ys.reshape(-1).astype(np.float32)
    net, params = trained()
    seed = np.stack([gx, gy], -1)
    got = tdroid.CorrFlow(net, *_t(gx, gy))(*_t(img_i, img_j, seed)).numpy()
    ref = np.asarray(FreshCorrFlow(params, *_j(gx, gy))(
        img_i, img_j, jnp.asarray(seed)))
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert abs(np.median(got[:, 0]) + 8.0) < 2.0


def test_corr_flow_cache_keys_by_frame_not_by_id():
    """R12: fed fresh views of a buffer of frames, the JAX cache returns
    a frame's features for another frame's view whenever CPython reuses
    the freed view's id; the port's cache, keyed by frame identity,
    never does."""
    frames = np.stack(list(tsynth_ate.wild_sequence(
        0, frames=4, ht=32, wd=48, fx=30.0, fy=30.0)[0]))
    gx = jnp.asarray([16.0])
    gy = jnp.asarray([16.0])
    _, params = trained()
    jcf = jdroid.CorrFlow(params, gx, gy)
    fresh = {k: np.asarray(jcf._encode(jnp.asarray(frames[k])))
             for k in range(len(frames))}
    wrong = 0
    for a in range(len(frames)):
        for b in range(len(frames)):
            fa = np.asarray(jcf._feat(frames[a]))     # a fresh view each
            fb = np.asarray(jcf._feat(frames[b]))
            wrong += not np.array_equal(fa, fresh[a])
            wrong += not np.array_equal(fb, fresh[b])
    assert wrong > 0

    net, _ = trained()
    tcf = tdroid.CorrFlow(net, *_t(np.asarray(gx), np.asarray(gy)))
    buf = torch.from_numpy(frames)
    for a in range(len(frames)):
        for b in range(len(frames)):
            for k in (a, b):
                got = tcf._feat(buf[k], k)
                np.testing.assert_allclose(got.numpy(), fresh[k], atol=1e-4)


@pytest.fixture(scope="module")
def vo_frames():
    images, _, intr, _, _ = tsynth_ate.wild_sequence(
        0, frames=VO_FRAMES, ht=VO_HT, wd=VO_WD, fx=60.0, fy=60.0)
    return list(images), np.asarray(intr, np.float32)


def _recorder(calls, key, fn, to_np):
    """fn, recording each call's inputs (copied before the call), keyword
    arguments and outputs as numpy under calls[key]."""
    def call(*args, **kw):
        inputs = [to_np(a) for a in args]
        out = fn(*args, **kw)
        calls[key] = (inputs, kw, [to_np(o) for o in out])
        return out
    return call


def _pose_errors(a, b):
    """Largest |a - b| of the quaternions and of the translations."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d[:, 3:].max(), d[:, :3].max()


@pytest.mark.parametrize("flow", ["lk", "corr"])
def test_dense_vo_matches_jax(vo_frames, flow, monkeypatch):
    """Both engines over the same 10 frames, the port's buffers set to the
    JAX engine's before each frame, every frame checked in three parts:

    * the dense BA call: the same edges, window, stride and iterations,
      on the same poses and disparities;
    * the flow targets of every edge: "corr" within 1e-3 px at every grid
      point (read 2.4e-4); "lk" within 1e-3 px at all but 2% of them (the
      JAX LK itself moves up to 13 px at 8 of 1344 points when its seeds
      move by 1e-5 px: near-singular 2x2 systems at the image border);
    * the port's dense BA on the JAX call's inputs against the JAX result.
      Its fp64 solve stands for the exact solution: the JAX fp32 result
      lies no further from it than 3x the port's fp32 result does, plus
      1e-4 (quaternions) or 1e-4 x the largest translation (the largest
      ratio read 2.1). A port BA that took no step or half a step misses
      this by far on every frame whose fp32 error is small; "lk" frames
      read fp32 errors of 3e-5 (quaternions) and 9e-4 (translations)
      against a frame's motion of 4e-3 and 2e-2. The "corr" run leaves
      the scale free, sends half the disparities to their 1e-4 floor and
      runs off to translations of 35: at its frame 6 both fp32 results
      lie 0.03 (quaternions) and 0.12-0.18 (translations) from the fp64
      one, and 0.003 and 0.09 from each other (R15).

    The keyframe decisions are the same at every frame."""
    images, intr = vo_frames
    net, params = trained()
    kw = dict(buffer=16, stride=8, window=6, kf_thresh=2.4)
    tvo = tdroid.DenseVO(VO_HT, VO_WD, intr, flow=flow, network=net,
                         device="cpu", **kw)
    jvo = jdroid.DenseVO(VO_HT, VO_WD, intr, flow="lk", **kw)
    if flow == "corr":
        jvo.flow_fn = FreshCorrFlow(params, jvo.gx, jvo.gy)
    calls = {}
    monkeypatch.setattr(tdroid.dops, "dense_ba", _recorder(
        calls, "port", tdense.dense_ba, lambda x: x.numpy().copy()))
    monkeypatch.setattr(jdroid.dops, "dense_ba", _recorder(
        calls, "jax", jdense.dense_ba, np.array))
    for t, img in enumerate(images):
        n = jvo.n
        tvo.poses[:n] = torch.from_numpy(jvo.poses[:n])
        tvo.disps[:n] = torch.from_numpy(jvo.disps[:n])
        calls.clear()
        tvo(t, img)
        jvo(t, img)
        assert tvo.n == jvo.n, t
        if t == 0:
            continue
        (a_t, kw_t, _), (a_j, kw_j, (p_j, _)) = calls["port"], calls["jax"]
        assert kw_t == kw_j, t
        for k in (0, 1, 4, 5, 6):      # poses, disps, weights, ii, jj
            np.testing.assert_array_equal(a_t[k], a_j[k], err_msg=str(t))

        on = a_j[4][..., 0] > 0
        d = np.abs(a_t[3] - a_j[3])[on].max(-1)
        if flow == "corr":
            assert d.max() <= 1e-3, (t, d.max())
        else:
            assert np.mean(d > 1e-3) <= 0.02, (t, np.sort(d)[-10:])

        ins = [torch.from_numpy(a) for a in a_j]
        ins[5], ins[6] = ins[5].long(), ins[6].long()
        p32 = tdense.dense_ba(*ins, **kw_j)[0].numpy()
        p64 = tdense.dense_ba(*[x.double() if x.is_floating_point() else x
                                for x in ins], **kw_j)[0].numpy()
        port_q, port_t = _pose_errors(p32, p64)
        jax_q, jax_t = _pose_errors(p_j, p64)
        scale = max(1.0, float(np.abs(p64[:, :3]).max()))
        assert jax_q <= 3 * port_q + 1e-4, (t, jax_q, port_q)
        assert jax_t <= 3 * port_t + 1e-4 * scale, (t, jax_t, port_t)
    p_t, ts_t = tvo.terminate()
    _, ts_j = jvo.terminate()
    np.testing.assert_array_equal(ts_t, ts_j)
    assert np.isfinite(p_t).all() and tvo.n < VO_FRAMES
    assert list(tvo.frame_ids[:tvo.n]) == [int(t) for t in ts_t]
