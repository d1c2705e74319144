"""Saving a run and resuming it (`slam/checkpoint.py`), and the demo's
output flags, on the CPU.

A run saved between two frames and resumed in a new DPVO continues bit
for bit (tolerance 0), as `tests/test_checkpoint.py` holds for the JAX
package: the same trajectory, timestamps, keyframe drops and state. The
patch centres and depths are drawn from the state's generator, so the
resume also restores its state. Three ways through the steady frames:
the steady step one frame at a time, in chunks of 4 (the save dispatches
a partial chunk first), and `sync_mode`. The warm-up and the bootstrap are
the same in all three, so one run through them is saved once (a module
fixture) and each case starts from it.

The demo CLI on a tiny image directory with `--save_reconstruction
--export_colmap --save_trajectory --checkpoint_every 4 --timeit`, then
again with `--resume` from its last checkpoint: the resumed run writes
the same trajectory, PLY and COLMAP files, byte for byte. `--viz` (no
Rerun installed: PLY and trajectory snapshots) and `--plot` write their
files.
"""

import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch import demo as tdemo
from wild_video_3d_reconstruction_torch.io import export as texport
from wild_video_3d_reconstruction_torch.models.vonet import init_vonet
from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.slam.checkpoint import (load_slam,
                                                                save_slam)
from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig

from test_torch_slam import HT, INTR, TINY, WD, one_thread, synthetic_frames

N, SPLIT = 13, 11
BOOT = DPVO.WARMUP        # frames through the bootstrap


@pytest.fixture(scope="module")
def bootstrapped(tmp_path_factory):
    """A run through its warm-up and bootstrap, saved."""
    path = tmp_path_factory.mktemp("boot")
    with one_thread():
        a = DPVO(DPVOConfig(**TINY), network=init_vonet(0), ht=HT, wd=WD,
                 device="cpu")
        for t, img in enumerate(synthetic_frames(BOOT)):
            a(t, img, INTR)
    assert a.is_initialized and a.counter == BOOT
    save_slam(a, path)
    return path


@pytest.mark.parametrize("mode", ["steady", "chunk4", "sync"])
def test_resume_is_bit_exact(tmp_path, mode, bootstrapped):
    cfg = DPVOConfig(**TINY, PIPELINE_CHUNK=4 if mode == "chunk4" else 1)
    frames = synthetic_frames(N)
    # the same weights; the resumed DPVO's own generator starts elsewhere
    kw = dict(network=init_vonet(0), device="cpu", sync_mode=mode == "sync")
    with one_thread():
        a = load_slam(DPVO(cfg, ht=HT, wd=WD, seed=2, **kw), bootstrapped)
        for t in range(BOOT, SPLIT):
            a(t, frames[t], INTR)
        save_slam(a, tmp_path / "ckpt")
        b = load_slam(DPVO(cfg, ht=HT, wd=WD, seed=1, **kw),
                      tmp_path / "ckpt")
        assert (b.counter, b.n_host, b.is_initialized) == \
            (a.counter, a.n_host, a.is_initialized)
        for t in range(SPLIT, N):
            a(t, frames[t], INTR)
            b(t, frames[t], INTR)
        pa, ta = a.terminate()
        pb, tb = b.terminate()
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(pa, pb)
    assert sorted(a.delta) == sorted(b.delta) and len(a.delta) > 0
    for k in ("poses", "patches", "ii", "jj", "kk", "valid", "net",
              "counts", "log"):
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k


def test_load_refuses_another_config(tmp_path):
    a = DPVO(DPVOConfig(**TINY), None, HT, WD, device="cpu")
    save_slam(a, tmp_path)
    other = DPVOConfig(**dict(TINY, PATCHES_PER_FRAME=4))
    with pytest.raises(ValueError, match="same config"):
        load_slam(DPVO(other, None, HT, WD, device="cpu"), tmp_path)


@pytest.fixture(scope="module")
def imagedir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("demo")
    (root / "images").mkdir()
    for t, img in enumerate(synthetic_frames(13)):
        cv2.imwrite(str(root / "images" / f"{t:04d}.png"), img)
    (root / "calib.txt").write_text(" ".join(map(str, INTR)) + "\n")
    return root


def _demo(root, out, *flags):
    opts = []
    for k, v in TINY.items():
        opts += [k, str(v)]
    with one_thread():
        tdemo.main(["--imagedir", str(root / "images"), "--calib",
                    str(root / "calib.txt"), "--config", "configs/fast.yaml",
                    "--stride", "1", "--path", str(out), "--device", "cpu",
                    "--buffer", "64", *flags, "--opts", *opts])


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "slam_ckpt" not in p.parts}


def test_demo_outputs_and_resume(imagedir, tmp_path):
    full, resumed = tmp_path / "full", tmp_path / "resumed"
    outputs = ("--save_reconstruction", "--export_colmap",
               "--save_trajectory")
    _demo(imagedir, full, *outputs, "--checkpoint_every", "4", "--timeit")
    poses, ts = texport.load_trajectory_tum_format(
        full / "saved_trajectories" / "images.txt")
    assert poses.shape == (13, 7) and np.isfinite(poses).all()
    pts, clr = texport.load_ply(full / "images.ply", return_colors=True)
    assert pts.shape[0] > 0 and clr.dtype == np.uint8
    assert (full / "colmap_images" / "transforms.json").is_file()
    assert (full / "config.yaml").is_file()
    # the last checkpoint was taken before frame 12
    _demo(imagedir, resumed, *outputs, "--resume", str(full / "slam_ckpt"))
    got, want = _files(resumed), _files(full)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_demo_viz_and_plot(imagedir, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    _demo(imagedir, tmp_path, "--viz", "--plot", "--loop_enabled")
    assert "LC COUNT: 0" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert list((tmp_path / "viz").glob("map_*.ply"))
    assert list((tmp_path / "viz").glob("traj_*.txt"))
    assert (tmp_path / "trajectory_plots" / "images.pdf").is_file()


@pytest.mark.parametrize("flags", [("--checkpoint_every", "4"),
                                   ("--resume", "missing")])
def test_demo_refuses_checkpoints_with_loop(imagedir, tmp_path, flags):
    """A loop closure's database and images are not in a checkpoint: the
    demo refuses the combination before it reads a frame."""
    with pytest.raises(NotImplementedError, match="loop closure"):
        _demo(imagedir, tmp_path, "--loop_enabled", *flags)
    assert not (tmp_path / "slam_ckpt").exists()
