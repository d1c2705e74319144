"""The port's frame readers and the demo's wild-video inputs.

* `io/stream.py` against the JAX package's readers on the same files:
  image directories with depth (`.npy`) and mask directories, cropped to
  a multiple of 16, depth clipped at 10x its median, stride and skip;
  videos at half resolution. Every yielded value equal (tolerance 0).
* `Prefetcher` yields the stream in order and raises a reader's error.
* The demo CLI with `--depthdir` and `--maskdir`, and on a video file,
  writes a trajectory with a row per frame, on the CPU.
"""

import numpy as np
import pytest

from wild_video_3d_reconstruction_torch import demo as tdemo
from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.io import export as texport
from wild_video_3d_reconstruction_torch.io import stream as tstream
from wild_video_3d_reconstruction_tpu.io import stream as jstream

from test_torch_slam import TINY, one_thread

cv2 = pytest.importorskip("cv2")
CALIB = np.array([40.0, 40.0, 32.0, 24.0])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """13 rendered wild frames (70x100, not multiples of 16) with their
    metric depth (one outlier per frame) and occluder masks."""
    root = tmp_path_factory.mktemp("scene")
    images, _, _, depths, masks = tsynth_ate.wild_sequence(
        0, frames=13, ht=70, wd=100, fx=44.0, fy=44.0)
    for d in ("rgb", "depth", "mask"):
        (root / d).mkdir()
    for t in range(len(images)):
        cv2.imwrite(str(root / "rgb" / f"{t:04d}.png"), images[t])
        depth = depths[t].copy()
        depth[0, 0] = 1e6             # the 10x-median clip removes it
        np.save(root / "depth" / f"{t:04d}.npy", depth)
        cv2.imwrite(str(root / "mask" / f"{t:04d}.png"),
                    masks[t].astype(np.uint8) * 255)
    return root


def _same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y) == 5
        for u, v in zip(x, y):
            if u is None or v is None:
                assert u is None and v is None
            else:
                u, v = np.asarray(u), np.asarray(v)
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kw", [dict(), dict(stride=2, skip=1),
                                dict(skip=2, end=9)])
def test_image_frames_match_jax(scene, kw):
    args = (scene / "rgb", scene / "depth", scene / "mask", CALIB)
    got = list(tstream.image_frames(*args, **kw))
    _same(got, list(jstream.image_frames(*args, **kw)))
    t, img, depth, mask, _ = got[0]
    assert img.shape == (64, 96, 3) and depth.shape == mask.shape == (64, 96)
    assert mask.dtype == bool and depth.max() < 1e6
    assert [str(p) for p in tstream.list_images(scene / "rgb", **kw)] == \
        [str(p) for p in jstream.list_images(scene / "rgb", **kw)]


def test_image_frames_without_depth_and_mask_match_jax(scene, tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text(" ".join(map(str, CALIB)) + " 0.01 -0.002 0 0\n")
    got = list(tstream.image_frames(scene / "rgb", calib=str(calib)))
    _same(got, list(jstream.image_frames(scene / "rgb", calib=str(calib))))
    assert got[0][2] is None and got[0][3] is None


@pytest.fixture(scope="module")
def video(scene):
    path = scene / "clip.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (128, 96))
    images = tsynth_ate.wild_sequence(1, frames=13, ht=96, wd=128, fx=80.0,
                                      fy=80.0)[0]
    for img in images:
        writer.write(img)
    writer.release()
    return path


@pytest.mark.parametrize("kw", [dict(), dict(stride=2, skip=1)])
def test_video_frames_match_jax(video, kw):
    calib = CALIB * 2
    got = list(tstream.video_frames(video, calib, **kw))
    _same(got, list(jstream.video_frames(video, calib, **kw)))
    assert got[0][1].shape == (48, 64, 3)
    np.testing.assert_array_equal(got[0][4], CALIB)


def test_prefetcher_yields_in_order_and_raises_reader_errors(scene):
    gen = tstream.image_frames(scene / "rgb", scene / "depth", None, CALIB)
    out = list(tstream.Prefetcher(gen, maxsize=2))
    _same(out, list(tstream.image_frames(scene / "rgb", scene / "depth",
                                         None, CALIB)))

    def broken():
        yield 0, np.zeros((16, 16, 3), np.uint8), None, None, CALIB
        raise OSError("decode failed")

    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        list(tstream.Prefetcher(broken()))


def _demo(tmp_path, source, *extra):
    calib = tmp_path / "calib.txt"
    calib.write_text(" ".join(map(str, CALIB)) + "\n")
    opts = []
    for k, v in TINY.items():
        opts += [k, str(v)]
    with one_thread():
        tdemo.main(["--imagedir", str(source), "--calib", str(calib),
                    "--config", "configs/fast.yaml", "--stride", "1",
                    "--path", str(tmp_path / "out"), "--save_trajectory",
                    "--device", "cpu", "--buffer", "64", *extra,
                    "--opts", *opts])
    poses, ts = texport.load_trajectory_tum_format(
        tmp_path / "out" / "saved_trajectories" / f"{source.stem}.txt")
    return poses, ts


def test_demo_cli_with_depth_and_mask_dirs(scene, tmp_path):
    poses, ts = _demo(tmp_path, scene / "rgb", "--depthdir",
                      str(scene / "depth"), "--maskdir", str(scene / "mask"))
    assert poses.shape == (13, 7) and np.isfinite(poses).all()
    np.testing.assert_array_equal(ts, np.arange(13))


def test_demo_cli_on_a_video(video, tmp_path):
    poses, _ = _demo(tmp_path, video)
    assert poses.shape == (13, 7) and np.isfinite(poses).all()
