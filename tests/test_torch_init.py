"""Port parity: camera self-calibration and the geometric bootstrap.

The port's `init/` against the JAX package's on the same seeded inputs:

* epipolar estimators, `estimate_focal`, `_essential_residual` and
  `calibration_confidence` on `tests/test_colmap_init.py`'s synthetic
  pairs: equal within 1e-9 relative (numpy copies, the same draws);
* the cv2 counterparts of `init/farneback.py` against cv2 itself (the
  test imports cv2; the port never does): `bgr_to_gray` and
  `resize_linear` bitwise, `laplacian_var` within 1e-9 relative,
  `farneback_flow` on wild frames at 96x128 and 384x512 with the mean
  magnitude within 2% and the median endpoint difference under 0.1 px
  (R14);
* `select_keyframes` and `run_colmap_initialization` on a 96x128 image
  directory with the trained weights: the same files, focal within 1%,
  the same predicted error; the degenerate fallback (R13) on a
  pure-rotation scene: the same coarse-grid focal or a neighbour;
* `lk_flow_pyramid` (1e-4 px), `track_grid`, `geometric_initialization`
  from given tracks (1e-6) and from images (1e-3);
* `init_from_prior` + `anchor_first_frame` on a port `DPVO`'s state after
  6 frames against the JAX functions on the same arrays (1e-6), the
  storages written in place;
* the demo without `--calib` on the CPU.
"""

import json
import types
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from wild_video_3d_reconstruction_torch import demo as tdemo
from wild_video_3d_reconstruction_torch.eval import droid_harness as tdroid
from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.init import colmap_init as tci
from wild_video_3d_reconstruction_torch.init import epipolar as tepi
from wild_video_3d_reconstruction_torch.init import farneback as tfb
from wild_video_3d_reconstruction_torch.init import mast3r_init as tmi
from wild_video_3d_reconstruction_torch.init import prior_init as tpi
from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig
from wild_video_3d_reconstruction_tpu.eval import droid_harness as jdroid
from wild_video_3d_reconstruction_tpu.init import colmap_init as jci
from wild_video_3d_reconstruction_tpu.init import epipolar as jepi
from wild_video_3d_reconstruction_tpu.init import mast3r_init as jmi
from wild_video_3d_reconstruction_tpu.init import prior_init as jpi

from test_colmap_init import H, W, _pairs
from test_torch_loop import WEIGHTS, jax_tree
from test_torch_slam import TINY

cv2 = pytest.importorskip("cv2")
REL = 1e-9
SEL_H, SEL_W = 96, 128
SEL_F = 80.0
SEL_FRAMES = 12


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


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max())


# ---------------------------------------------------------------------------
# epipolar geometry and the focal estimate (numpy copies)
# ---------------------------------------------------------------------------

def test_epipolar_estimators_match_jax():
    (p0, p1), *_ = _pairs(0.61 * W)
    F_t, inl_t = tepi.fundamental_ransac(p0, p1, seed=3)
    F_j, inl_j = jepi.fundamental_ransac(p0, p1, seed=3)
    _close(F_t, F_j)
    np.testing.assert_array_equal(inl_t, inl_j)
    _close(tepi.focal_from_fundamental(F_t, (W / 2, H / 2), (W / 2, H / 2)),
           jepi.focal_from_fundamental(F_j, (W / 2, H / 2), (W / 2, H / 2)))

    x0 = (p0 - [W / 2, H / 2]) / (0.61 * W)
    x1 = (p1 - [W / 2, H / 2]) / (0.61 * W)
    E_t, ein_t = tepi.essential_ransac(x0, x1, iters=200, seed=1)
    E_j, ein_j = jepi.essential_ransac(x0, x1, iters=200, seed=1)
    _close(E_t, E_j)
    np.testing.assert_array_equal(ein_t, ein_j)
    for a, b in zip(tepi.recover_pose(E_t, x0[ein_t], x1[ein_t]),
                    jepi.recover_pose(E_j, x0[ein_j], x1[ein_j])):
        _close(a, b)


@pytest.mark.parametrize("f_over_w,seed", [(0.61, 0), (0.9, 0), (1.6, 1)])
def test_focal_residual_and_confidence_match_jax(f_over_w, seed):
    pairs = _pairs(f_over_w * W, seed=seed)
    f_t = tci.estimate_focal(pairs, (H, W))
    f_j = jci.estimate_focal(pairs, (H, W))
    _close(f_t, f_j)
    f, cx, cy = f_t
    for scale in (0.9, 1.0, 1.1):
        _close(tci._essential_residual(pairs, scale * f, cx, cy),
               jci._essential_residual(pairs, scale * f, cx, cy))
    c_t = tci.calibration_confidence(pairs, f, cx, cy, (H, W))
    c_j = jci.calibration_confidence(pairs, f, cx, cy, (H, W))
    assert c_t == c_j


def _rotation_pairs(f_gt, n_frames=4, n_pts=300, noise=0.3, seed=0):
    """Matches of a camera that only rotates (no baseline)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(2, 12, n_pts)], -1)
    projs = []
    for k in range(n_frames):
        a, b = 0.05 * k, 0.02 * k
        Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]])
        Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
        Xc = X @ (Rx @ Ry).T
        u = Xc[:, 0] / Xc[:, 2] * f_gt + W / 2 + rng.normal(0, noise, n_pts)
        v = Xc[:, 1] / Xc[:, 2] * f_gt + H / 2 + rng.normal(0, noise, n_pts)
        ok = (u > 0) & (u < W) & (v > 0) & (v < H)
        projs.append((np.stack([u, v], -1), ok))
    return [(p0[o0 & o1], p1[o0 & o1])
            for (p0, o0), (p1, o1) in zip(projs[:-1], projs[1:])]


@pytest.mark.parametrize("f_over_w", [0.7, 1.2])
def test_degenerate_fallback_picks_the_cv2_grid_focal(f_over_w):
    """R13: the 8-point essential RANSAC + recover_pose scoring of the
    focal grid against the JAX package's cv2 5-point scoring, on a
    pure-rotation scene of three pairs: the same coarse-grid focal or a
    neighbour. (Neither score peaks at the true focal: a rotation alone
    leaves the essential-matrix support flat in f. Both pick the grid's
    smallest focal here; on two of these pairs they did not agree.)"""
    pairs = _rotation_pairs(f_over_w * W)
    grid = np.linspace(0.5, 2.5, 21) * W
    f_t, s_t = tci._score_focal_grid(pairs, grid, W / 2, H / 2)
    f_j, s_j = jci._score_focal_grid(pairs, grid, W / 2, H / 2)
    i_t, i_j = int(np.argmin(np.abs(grid - f_t))), \
        int(np.argmin(np.abs(grid - f_j)))
    assert abs(i_t - i_j) <= 1, (f_t, f_j)
    assert s_t > 0 and s_j > 0


# ---------------------------------------------------------------------------
# the cv2 counterparts
# ---------------------------------------------------------------------------

def test_bgr_to_gray_is_cv2_bit_for_bit_and_laplacian_var():
    # every BGR colour once: the low three bytes of 0 .. 2^24 - 1
    every = np.arange(1 << 24, dtype="<u4").view(np.uint8).reshape(
        4096, 4096, 4)[..., :3]
    np.testing.assert_array_equal(
        tfb.bgr_to_gray(torch.from_numpy(every)).numpy(),
        cv2.cvtColor(every, cv2.COLOR_BGR2GRAY))
    rng = np.random.default_rng(0)
    for shape in ((37, 53), (96, 128)):
        g = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = cv2.Laplacian(g, cv2.CV_64F).var()
        got = float(tfb.laplacian_var(torch.from_numpy(g)))
        assert abs(got - ref) <= REL * ref


@pytest.mark.parametrize("hw", [(480, 640), (601, 777), (1080, 1920)])
def test_resize_linear_is_cv2_bit_for_bit(hw):
    rng = np.random.default_rng(1)
    img = cv2.GaussianBlur(rng.integers(0, 256, hw + (3,), dtype=np.uint8),
                           (5, 5), 1.0)
    scale = 512.0 / max(hw)
    np.testing.assert_array_equal(
        tfb.resize_linear(torch.from_numpy(img), scale).numpy(),
        cv2.resize(img, None, fx=scale, fy=scale))


def _gray_pair(ht, wd, a, b):
    f = 320.0 * wd / 512
    imgs = tsynth_ate.wild_sequence(0, frames=b + 1, ht=ht, wd=wd, fx=f,
                                    fy=f)[0]
    return [cv2.cvtColor(imgs[k], cv2.COLOR_BGR2GRAY) for k in (a, b)]


@pytest.mark.parametrize("ht,wd,a,b", [(96, 128, 0, 1), (96, 128, 0, 3),
                                       (384, 512, 0, 1)])
def test_farneback_matches_cv2(ht, wd, a, b):
    """R14: the mean flow magnitude within 2% where it exceeds 0.5 px,
    the median endpoint difference under 0.1 px."""
    g0, g1 = _gray_pair(ht, wd, a, b)
    ref = cv2.calcOpticalFlowFarneback(g0, g1, None, 0.5, 3, 15, 3, 5, 1.2,
                                       0)
    got = tfb.farneback_flow(torch.from_numpy(g0),
                             torch.from_numpy(g1)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    m_ref = np.linalg.norm(ref, axis=2).mean()
    m_got = np.linalg.norm(got, axis=2).mean()
    assert m_ref > 0.5
    assert abs(m_got - m_ref) <= 0.02 * m_ref, (m_got, m_ref)
    assert np.median(np.linalg.norm(got - ref, axis=2)) < 0.1


# ---------------------------------------------------------------------------
# frame selection and the calibration entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """SEL_FRAMES rendered wild frames at 96x128 (fx = fy = 80) as PNGs."""
    root = tmp_path_factory.mktemp("calib_scene")
    images = tsynth_ate.wild_sequence(0, frames=SEL_FRAMES, ht=SEL_H,
                                      wd=SEL_W, fx=SEL_F, fy=SEL_F)[0]
    for t, img in enumerate(images):
        cv2.imwrite(str(root / f"{t:04d}.png"), img)
    return root, images


@pytest.mark.parametrize("kw", [dict(), dict(skip=2, max_frames=4)])
def test_select_keyframes_match_jax(image_dir, kw):
    root, images = image_dir
    got = tci.select_keyframes(root, device="cpu", **kw)
    assert got == jci.select_keyframes(root, **kw)
    assert len(got) >= 2
    skip = kw.get("skip", 0)
    assert [str(root / f"{i + skip:04d}.png") for i in tci.select_frames(
        images[skip:], kw.get("max_frames", 50), device="cpu")] == got


@pytest.fixture(scope="module")
def colmap_runs(image_dir, tmp_path_factory):
    root, _ = image_dir
    out = {}
    for name, fn, params in (
            ("jax", jci.run_colmap_initialization, jax_tree(WEIGHTS)),
            ("port", tci.run_colmap_initialization, WEIGHTS)):
        path = tmp_path_factory.mktemp(f"calib_{name}")
        kw = dict(device="cpu") if name == "port" else {}
        calib = fn(str(root), path=str(path), params=params, **kw)
        out[name] = (calib, json.loads(
            (path / "calib_confidence.json").read_text()),
            np.loadtxt(path / "estimated_calib.txt"))
    return out


def test_run_colmap_initialization_matches_jax(colmap_runs):
    (c_t, conf_t, file_t), (c_j, conf_j, _) = colmap_runs["port"], \
        colmap_runs["jax"]
    assert c_t.shape == (4,)
    assert abs(c_t[0] - c_j[0]) <= 0.01 * c_j[0], (c_t, c_j)
    np.testing.assert_array_equal(c_t[2:], c_j[2:])
    assert conf_t["predicted_err_pct"] == conf_j["predicted_err_pct"]
    assert conf_t["method"] == "two-view"
    np.testing.assert_array_equal(file_t, c_t)


def test_demo_without_calib_writes_the_calibration(image_dir, tmp_path):
    root, _ = image_dir
    opts = []
    for k, v in TINY.items():
        opts += [k, str(v)]
    tdemo.main(["--imagedir", str(root), "--network", str(WEIGHTS),
                "--config", "configs/fast.yaml", "--stride", "1",
                "--path", str(tmp_path), "--save_trajectory",
                "--device", "cpu", "--buffer", "64", "--opts", *opts])
    calib = np.loadtxt(tmp_path / "estimated_calib.txt")
    conf = json.loads((tmp_path / "calib_confidence.json").read_text())
    assert calib.shape == (4,) and np.isfinite(calib).all()
    np.testing.assert_array_equal(calib[2:], [SEL_W / 2, SEL_H / 2])
    assert conf["predicted_err_pct"] > 0
    traj = np.loadtxt(tmp_path / "saved_trajectories" / f"{root.stem}.txt")
    assert traj.shape == (SEL_FRAMES, 8) and np.isfinite(traj).all()


# ---------------------------------------------------------------------------
# LK tracks and the geometric bootstrap
# ---------------------------------------------------------------------------

def test_lk_flow_pyramid_matches_jax(image_dir):
    _, images = image_dir
    rng = np.random.default_rng(0)
    x0 = rng.uniform(8, SEL_W - 8, 64).astype(np.float32)
    y0 = rng.uniform(8, SEL_H - 8, 64).astype(np.float32)
    f0 = rng.normal(0, 1, (64, 2)).astype(np.float32)
    got = tdroid.lk_flow_pyramid(torch.from_numpy(images[0]),
                                 torch.from_numpy(images[2]),
                                 torch.from_numpy(x0), torch.from_numpy(y0),
                                 torch.from_numpy(f0)).numpy()
    ref = np.asarray(jdroid.lk_flow_pyramid(
        jnp.asarray(images[0]), jnp.asarray(images[2]), jnp.asarray(x0),
        jnp.asarray(y0), jnp.asarray(f0)))
    # 1e-4 px but for rounding carried through the coarse levels: 63 of
    # these 64 points within 4.5e-5 px, one at 2.85e-4 px
    err = np.abs(got - ref).max(1)
    assert (err <= 1e-4).mean() >= 0.95 and err.max() <= 1e-3, err


@pytest.fixture(scope="module")
def tracks(image_dir):
    _, images = image_dir
    frames = list(images[:6])
    return frames, tmi.track_grid(frames, device="cpu"), \
        jmi.track_grid(frames)


def test_track_grid_matches_jax(tracks):
    _, (g_t, tr_t, ok_t), (g_j, tr_j, ok_j) = tracks
    np.testing.assert_array_equal(g_t, g_j)
    both = ok_t & ok_j
    assert (ok_t != ok_j).mean() < 0.01
    np.testing.assert_allclose(tr_t[both], tr_j[both], atol=1e-4)
    assert ok_t[1:].mean() > 0.5


def test_geometric_initialization_matches_jax(tracks):
    frames, trk, _ = tracks
    intr = np.array([SEL_F, SEL_F, SEL_W / 2, SEL_H / 2])
    d_t, p_t = tmi.geometric_initialization(
        None, intr, tracks=trk, image_size=(SEL_H, SEL_W), device="cpu")
    d_j, p_j = jmi.geometric_initialization(
        None, intr, tracks=trk, image_size=(SEL_H, SEL_W))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6, atol=1e-6)

    d_t, p_t = tmi.mast3r_initialization(frames, intr, device="cpu")
    d_j, p_j = jmi.mast3r_initialization(frames, intr)
    np.testing.assert_allclose(p_t, p_j, atol=1e-3)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(p_t[0], np.eye(4))


# ---------------------------------------------------------------------------
# priors written into the state
# ---------------------------------------------------------------------------

class _JaxState(NamedTuple):
    patches: jnp.ndarray
    patches_est: jnp.ndarray
    poses: jnp.ndarray


def test_bootstrap_into_state_in_place_matches_jax(image_dir, tracks):
    """A port DPVO after 6 warm-up frames takes the geometric bootstrap
    (`bootstrap_slam`); the JAX functions get the same state arrays and
    the same depths and poses."""
    _, images = image_dir
    frames = tracks[0]
    cfg = DPVOConfig(**TINY)
    intr = np.array([SEL_F, SEL_F, SEL_W / 2, SEL_H / 2])
    slam = DPVO(cfg, None, SEL_H, SEL_W, device="cpu")
    for t, img in enumerate(frames):
        slam(t, img, intr)
    assert slam.n == len(frames) and not slam.is_initialized
    st = slam.state
    before = _JaxState(*(jnp.asarray(getattr(st, k).numpy().copy())
                         for k in _JaxState._fields))
    ptrs = {k: getattr(st, k).data_ptr() for k in _JaxState._fields}

    depths, poses_c2w = tmi.bootstrap_slam(slam, frames, intr, device="cpu")
    assert {k: getattr(st, k).data_ptr() for k in _JaxState._fields} == ptrs
    assert slam.state is st

    jslam = types.SimpleNamespace(state=before, cfg=cfg)
    jpi.init_from_prior(jslam, depths, poses_c2w, range(len(frames)))
    jpi.anchor_first_frame(jslam)
    for k in _JaxState._fields:
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(jslam.state, k)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.poses[0].numpy(), [0, 0, 0, 0, 0, 0, 1],
                               atol=1e-6)
    M = cfg.PATCHES_PER_FRAME
    np.testing.assert_array_equal(st.patches_est[:len(frames) * M].numpy(),
                                  st.patches[:len(frames) * M].numpy())

    # init_from_prior alone: the written slots are the median prior depth
    tpi.init_from_prior(slam, depths, poses_c2w, [2])
    rows = st.patches[2 * M:3 * M]
    px = (rows[:, 0] * 4).long().clamp(0, SEL_W - 1)
    py = (rows[:, 1] * 4).long().clamp(0, SEL_H - 1)
    med = np.median(depths[2][py.numpy(), px.numpy()].reshape(M, -1), 1)
    np.testing.assert_allclose(rows[:, 2, 0, 0].numpy(), 1 / med, rtol=1e-6)
    assert {k: getattr(st, k).data_ptr() for k in _JaxState._fields} == ptrs
