"""The port's export files are the JAX package's, byte for byte.

From the same arrays (a trajectory of 7 poses, 50 points with colours),
both packages write: the TUM trajectory, binary and ASCII PLY, the COLMAP
text and binary sparse models and nerfstudio's `transforms.json`
(`save_output_for_colmap`). Every file is compared byte for byte
(tolerance 0: the world-to-camera poses go through the two packages'
float32 `se3_inv`, which give the same bits). Each package's readers then
read the port's files back to what was written.
"""

import json

import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.io import colmap_model as tcolmap
from wild_video_3d_reconstruction_torch.io import export as texport
from wild_video_3d_reconstruction_tpu.io import colmap_model as jcolmap
from wild_video_3d_reconstruction_tpu.io import export as jexport


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(7, 7)).astype(np.float32)
    poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=1, keepdims=True)
    tstamps = np.arange(7, dtype=np.float64) * 2
    points = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    return poses, tstamps, points, colors


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("binary", [True, False])
def test_ply_is_the_jax_packages(arrays, tmp_path, binary):
    _, _, points, colors = arrays
    texport.save_ply(tmp_path / "t.ply", points, colors, binary=binary)
    jexport.save_ply(tmp_path / "j.ply", points, colors, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    pts, clr = texport.load_ply(tmp_path / "t.ply", return_colors=True)
    np.testing.assert_array_equal(pts, points)
    np.testing.assert_array_equal(clr, colors)


def test_tum_trajectory_is_the_jax_packages(arrays, tmp_path):
    poses, tstamps, _, _ = arrays
    texport.save_trajectory_tum_format(poses, tstamps, tmp_path / "t.txt")
    jexport.save_trajectory_tum_format(poses, tstamps, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_colmap_models_and_transforms_are_the_jax_packages(arrays,
                                                            tmp_path):
    poses, tstamps, points, colors = arrays
    args = (poses, tstamps, points, colors, 40.0, 41.0, 32.0, 24.0, 48, 64)
    texport.save_output_for_colmap(tmp_path / "port", *args)
    jexport.save_output_for_colmap(tmp_path / "jax", *args)
    port, jax_ = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax_) == [
        "cameras.txt", "colmap/sparse/0/cameras.bin",
        "colmap/sparse/0/images.bin", "colmap/sparse/0/points3D.bin",
        "images.txt", "points3D.txt", "transforms.json"]
    for name in port:
        assert port[name] == jax_[name], name
    # read back: both formats give the written model
    text = tcolmap.read_model(tmp_path / "port")
    binary = tcolmap.read_model(tmp_path / "port" / "colmap/sparse/0")
    jtext = jcolmap.read_text(tmp_path / "port")
    for cams, ims, pts in (text, binary, jtext):
        assert cams[1].model == "PINHOLE" and cams[1].width == 64
        np.testing.assert_array_equal(cams[1].params, [40.0, 41.0, 32.0,
                                                       24.0])
        assert len(ims) == 7 and len(pts) == 50
        np.testing.assert_array_equal(
            np.stack([pts[i + 1].xyz for i in range(50)]), points)
        np.testing.assert_array_equal(
            np.stack([pts[i + 1].rgb for i in range(50)]), colors)
    for a, b in zip(text[1].values(), binary[1].values()):
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        assert a.name == b.name
    frames = json.loads(port["transforms.json"])["frames"]
    assert len(frames) == 7


def test_camera_intrinsics_json_matches_jax():
    for model, params in (("PINHOLE", [40.0, 41.0, 32.0, 24.0]),
                          ("OPENCV", [40.0, 41.0, 32.0, 24.0, 0.1, -0.01,
                                      1e-3, 2e-3]),
                          ("SIMPLE_RADIAL_FISHEYE", [40.0, 32.0, 24.0, 0.1])):
        tcam = tcolmap.Camera(1, model, 64, 48, np.array(params))
        jcam = jcolmap.Camera(1, model, 64, 48, np.array(params))
        assert texport.camera_intrinsics_json(tcam) == \
            jexport.camera_intrinsics_json(jcam)
    with pytest.raises(ValueError):
        texport.camera_intrinsics_json(
            tcolmap.Camera(1, "FOV", 64, 48, np.zeros(5)))


def test_plot_trajectory_writes_a_file(arrays, tmp_path):
    pytest.importorskip("matplotlib")
    poses = arrays[0]
    out = texport.plot_trajectory(poses, gt_poses=poses, title="t",
                                  filename=str(tmp_path / "traj.pdf"))
    assert (tmp_path / "traj.pdf").stat().st_size > 0 and out
