"""Port parity: the TartanAir reader (`train/data.py`).

Both packages' readers on one tiny TartanAir-layout directory (one scene,
24 frames of 96x128 random BGR PNGs, random depth .npy, a pose_left.txt
walking along NED x; written as the JAX package's
`tests/test_train_data.py` writes it, with one NaN depth pixel and a
turning walk so the graph is not symmetric):

* the scenes' remapped poses equal; `flow_distance_matrix` within 1e-4
  relative (fp32 SE(3) algebra on both sides, in another order);
* with one `np.random.default_rng` seed, the sampled frames and the
  jittered images equal (bitwise), `poses_w2c` and `disps4` within 1e-5;
* `batches`' shapes and `dataset_factory`;
* ROADMAP R25: both readers leave the intrinsics at calib_read()'s
  [320, 320, 320, 240] after resizing to image_size.
"""

import numpy as np
import pytest

import cv2

from wild_video_3d_reconstruction_torch.train import data as tdata
from wild_video_3d_reconstruction_tpu.train import data as jdata

N_FRAMES = 24
KW = dict(n_frames=4, fmin=0.5, fmax=500.0, image_size=(64, 96))


@pytest.fixture(scope="module")
def tartan_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tartan")
    scene = root / "env" / "env" / "Easy" / "P001"
    (scene / "image_left").mkdir(parents=True)
    (scene / "depth_left").mkdir(parents=True)
    rng = np.random.default_rng(0)
    poses = []
    for i in range(N_FRAMES):
        img = rng.integers(0, 255, (96, 128, 3), np.uint8)
        cv2.imwrite(str(scene / "image_left" / f"{i:06d}.png"), img)
        depth = rng.uniform(4.0, 8.0, (96, 128)).astype(np.float32)
        if i == 3:
            depth[5, 7] = np.nan
        np.save(scene / "depth_left" / f"{i:06d}.npy", depth)
        # NED pose layout before the remap: (x, y, z, qx, qy, qz, qw)
        a = 0.05 * i
        poses.append([0.2 * i, 0.03 * i * i, 0.01 * i, 0.0, 0.0,
                      np.sin(a / 2), np.cos(a / 2)])
    np.savetxt(scene / "pose_left.txt", np.asarray(poses, float),
               delimiter=" ")
    return str(root)


@pytest.fixture(scope="module")
def readers(tartan_root):
    return (tdata.TartanAirDataset(tartan_root, **KW),
            jdata.TartanAirDataset(tartan_root, **KW))


def test_scenes_and_flow_graph_match_jax(readers):
    t, j = readers
    assert len(t.scenes) == len(j.scenes) == 1
    ts, js = t.scenes[0], j.scenes[0]
    assert ts.images == js.images and ts.depths == js.depths
    np.testing.assert_array_equal(ts.poses, js.poses)
    np.testing.assert_array_equal(ts.intrinsics, js.intrinsics)
    Dt, Dj = ts.graph["dist"], js.graph["dist"]
    assert Dt.shape == Dj.shape == (N_FRAMES, N_FRAMES)
    assert np.array_equal(np.isinf(Dt), np.isinf(Dj))
    fin = np.isfinite(Dj)
    assert (Dj[fin] > 0).sum() > 200
    np.testing.assert_allclose(Dt[fin], Dj[fin], rtol=1e-4, atol=0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sampled_clips_match_jax(readers, seed):
    t, j = readers
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        it, pt, dt, kt = t.sample_clip(rt)
        ij, pj, dj, kj = j.sample_clip(rj)
        assert it.dtype == ij.dtype == np.uint8
        assert np.array_equal(it, ij)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(kt, kj)
    assert rt.random() == rj.random()             # the same draws taken


def test_intrinsics_unscaled_after_resize_r25(readers):
    """ROADMAP R25: `_resize` scales the frames to image_size (96x128 ->
    64x96 here; TartanAir's 640x480 -> 512x384 in training) but not the
    intrinsics, in both readers: they stay calib_read()'s, for 640x480."""
    t, j = readers
    images, _, disps, intr = t.sample_clip(np.random.default_rng(4))
    assert images.shape == (4, 64, 96, 3) and disps.shape == (4, 16, 24)
    expect = np.array([320.0, 320.0, 320.0, 240.0], np.float32)
    np.testing.assert_array_equal(intr, expect)
    np.testing.assert_array_equal(
        j.sample_clip(np.random.default_rng(4))[3], expect)


def test_batches_and_factory(tartan_root):
    ds = tdata.dataset_factory(["tartan"], tartan_root, **KW)
    assert isinstance(ds, tdata.TartanAirDataset)
    batch = next(ds.batches(batch_size=2, steps=1))
    assert batch["images"].shape == (2, 4, 64, 96, 3)
    assert batch["poses"].shape == (2, 4, 7)
    assert batch["disps"].shape == (2, 4, 16, 24)
    assert batch["intrinsics"].shape == (2, 4)
    assert np.all(batch["disps"] > 0)
    assert 0.5 < np.quantile(batch["disps"], 0.98) < 3.0
    ref = next(jdata.dataset_factory(["tartan"], tartan_root, **KW)
               .batches(batch_size=2, steps=1))
    assert np.array_equal(batch["images"], ref["images"])
