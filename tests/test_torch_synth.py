"""The port's synthetic world, trajectory metrics and Umeyama alignment
against the JAX package's.

* `train/synth.py` is a numpy-only copy: for the same seeds the images,
  poses, disparities, occluder masks and the full-resolution depth
  (`_PlaneWorld._surface`) are bitwise equal (tolerance 0).
* `eval/metrics.py` and `loop/umeyama.py` on random trajectories: the
  numpy functions within 1e-9; `rpe` and `kitti_rel_err`, whose relative
  poses go through the Lie groups (the port's torch `ops/lie.py` in
  float64, the JAX package's `ops/lie.py` run here with x64 enabled so
  both are float64), within 1e-9 as well.
"""

import jax
import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.eval import metrics as tmetrics
from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.loop import umeyama as tumeyama
from wild_video_3d_reconstruction_torch.train import synth as tsynth
from wild_video_3d_reconstruction_tpu.eval import metrics as jmetrics
from wild_video_3d_reconstruction_tpu.loop import umeyama as jumeyama
from wild_video_3d_reconstruction_tpu.train import synth as jsynth

TOL = 1e-9


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ["walk", "orbit", "outback", "multiloop"])
def test_render_sequence_is_bitwise_the_jax_packages(path):
    kw = dict(frames=6, ht=48, wd=64, path=path)
    _equal(tsynth.render_sequence(3, **kw), jsynth.render_sequence(3, **kw))


@pytest.mark.parametrize("harden", [False, True])
def test_render_clip_is_bitwise_the_jax_packages(harden):
    for seed in range(4):        # harden draws an occluder on ~half
        kw = dict(frames=4, ht=48, wd=64, n_planes=2, harden=harden)
        _equal(tsynth.render_clip(np.random.default_rng(seed), **kw),
               jsynth.render_clip(np.random.default_rng(seed), **kw))


def test_occluder_mask_and_depth_are_bitwise_the_jax_packages():
    """render(occ=) -> (image, disp4, mask) and _surface's depth zk."""
    worlds = [m._PlaneWorld(np.random.default_rng(5), 48, 64, 40.0, 40.0,
                            n_planes=3) for m in (tsynth, jsynth)]
    tex = jsynth._texture(np.random.default_rng(6), 48, 48, octaves=3)
    R = jsynth._so3_exp(np.array([0.02, -0.03, 0.01]))
    t = np.array([0.1, -0.05, 0.2])
    occ = ((0.1, 0.0, 1.4), 0.3, tex)
    outs = [w.render(R, t, occ=occ, gain=1.1, bias=-3.0) for w in worlds]
    _equal(outs[0], outs[1])
    assert 0.0 < outs[0][2].mean() < 1.0            # the disc is in view
    _equal(*(w._surface(R, t, w.rays) for w in worlds))


def test_wild_sequence_depth_and_mask_are_the_worlds():
    """The wild input's depth is the world's zk at each frame's pose and
    its mask the occluder's: True off the disc, where its image equals the
    plain render."""
    frames = 5
    images, poses, intr, depths, masks = tsynth_ate.wild_sequence(
        0, frames=frames, ht=48, wd=64, fx=40.0, fy=40.0)
    clean, poses0, intr0 = jsynth.render_sequence(0, frames=frames)
    np.testing.assert_array_equal(poses, poses0)
    np.testing.assert_array_equal(intr, intr0)
    assert depths.dtype == np.float32 and masks.dtype == bool
    assert (depths > 0).all() and np.isfinite(depths).all()
    assert 0.0 < masks.mean() < 1.0
    # off the disc the image is the plain render of the (float32) pose
    off = np.abs(images.astype(int) - clean.astype(int)).max(-1)[masks]
    assert (off <= 1).all()


@pytest.mark.parametrize("stride", [2, 4])
def test_wild_sequence_stride_renders_every_strideth_frame(stride):
    """wild_sequence(frames=F, stride=s) is wild_sequence(frames=F * s) at
    frames 0, s, 2s, ...: its walk, its world's texture scale and the
    occluder's drift are those of F * s frames (tolerance 0)."""
    kw = dict(ht=48, wd=64, fx=40.0, fy=40.0)
    got = tsynth_ate.wild_sequence(0, frames=3, stride=stride, **kw)
    want = tsynth_ate.wild_sequence(0, frames=3 * stride, **kw)
    for name, a, b in zip(("images", "poses", "intrinsics", "depths",
                           "masks"), got, want):
        b = b if name == "intrinsics" else b[::stride]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_texture_blocked_by_rows_is_the_jax_packages():
    """The port blends the texture in blocks of rows; over more rows than
    one block it gives the JAX package's texture bit for bit."""
    h = 2 * tsynth._TEXTURE_ROWS + 37
    _equal(tsynth._texture(np.random.default_rng(7), h, 24),
           jsynth._texture(np.random.default_rng(7), h, 24))


def _trajectory(rng, n):
    t = np.cumsum(rng.normal(0, 0.3, (n, 3)), 0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([t, q], 1)


@pytest.fixture
def trajectories():
    rng = np.random.default_rng(0)
    gt = _trajectory(rng, 40)
    est = gt.copy()
    est[:, :3] = 0.7 * gt[:, :3] + rng.normal(0, 0.05, (40, 3)) + 1.0
    est[:, 3:] += rng.normal(0, 0.02, (40, 4))
    est[:, 3:] /= np.linalg.norm(est[:, 3:], axis=1, keepdims=True)
    return est, gt


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=TOL)


def test_umeyama_alignment_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 30))
    R = jsynth._so3_exp(np.array([0.3, -0.2, 0.5]))
    y = 1.7 * R @ x + np.array([[0.5], [-1.0], [2.0]]) + \
        rng.normal(0, 0.01, (3, 30))
    for a, b in zip(tumeyama.umeyama_alignment(x, y),
                    jumeyama.umeyama_alignment(x, y)):
        _close(a, b)
    flat = np.zeros((3, 10))
    flat[0] = np.arange(10.0)
    assert tumeyama.umeyama_alignment(flat, flat)[0] is None
    assert jumeyama.umeyama_alignment(flat, flat)[0] is None


def test_ate_metrics_match_jax(trajectories):
    est, gt = trajectories
    t = np.arange(40, dtype=np.float64)
    t_est = t[::2] + 0.01
    for fn, args in (("ate_rmse", (est[::2], t_est, gt, t)),
                     ("ate_scale", (est[::2], t_est, gt, t)),
                     ("associate", (t_est, t, 0.02))):
        for a, b in zip(getattr(tmetrics, fn)(*args),
                        getattr(jmetrics, fn)(*args)):
            _close(a, b)
    a, ra = tmetrics.align_trajectory(est[:, :3], gt[:, :3])
    b, rb = jmetrics.align_trajectory(est[:, :3], gt[:, :3])
    _close(a, b)
    for x, y in zip(ra, rb):
        _close(x, y)
    assert tmetrics.ate_rmse(est[:2], t[:2], gt, t) == (float("inf"), 0)


def test_relative_metrics_match_jax(trajectories):
    est, gt = trajectories
    with jax.enable_x64(True):
        want_rpe = jmetrics.rpe(est, gt, delta=3)
        want_kitti = jmetrics.kitti_rel_err(est, gt, lengths=(1.0, 2.0, 4.0))
    _close(tmetrics.rpe(est, gt, delta=3), want_rpe)
    got = tmetrics.kitti_rel_err(est, gt, lengths=(1.0, 2.0, 4.0))
    assert got[2] == want_kitti[2] > 0
    _close(got[:2], want_kitti[:2])


def test_groundtruth_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    tum = tmp_path / "groundtruth.txt"
    rows = np.concatenate([np.arange(5.0)[:, None], rng.normal(size=(5, 7))],
                          1)
    np.savetxt(tum, rows, header="t x y z qx qy qz qw")
    euroc = tmp_path / "data.csv"
    rows = np.concatenate([np.arange(5.0)[:, None] * 1e9,
                           rng.normal(size=(5, 16))], 1)
    np.savetxt(euroc, rows, delimiter=",", header="t,...")
    for fn, path in (("load_tum_groundtruth", tum),
                     ("load_euroc_groundtruth", euroc)):
        for a, b in zip(getattr(tmetrics, fn)(path),
                        getattr(jmetrics, fn)(path)):
            np.testing.assert_array_equal(a, b)
