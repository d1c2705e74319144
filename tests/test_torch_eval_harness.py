"""The evaluation harness in the port (`eval/harness.py`, `run_tum` of
`eval/droid_harness.py`, `utils/datasets.py`) against the JAX package's,
on the CPU.

* `evaluate` ("tum" and "euroc") on fabricated dataset directories in the
  JAX test's layouts (`tests/test_harness_protocol.py`: TUM `rgb/<t>.png`
  + `groundtruth.txt`, EuRoC `mav0/cam0/data/<t_ns>.png` (8-bit gray
  here, as EuRoC's cameras write them) + the state CSV), 16 frames of a
  rendered walk at 48x64, the calibration tables patched to the
  renderer's camera with zero distortion (so both packages still call
  `cv2.undistort`), the trained weights on both sides (the JAX tree
  carried from the `.pth`), the JAX run's draws fed to the port, both in
  fp32 with the port's edge rows (ROADMAP R4, R6): the per-scene ATE
  within TOL_ATE (as `test_torch_synth_ate.py`);
* the streams unpatched at the datasets' own sizes (480x640 colour,
  480x752 gray): frames, timestamps and intrinsics bitwise the JAX
  streams', the undistortion remapping the content; a 16-bit PNG read
  through `io/stream.py` (cv2, as in the JAX package) bitwise;
* R23: `run_tum` in both packages over the same trajectory (the dense
  engine stubbed by one that returns the ground truth with a known
  offset): the JAX number is the median over (rmse, n), the port's the
  rmse;
* the registry: entries, `get` with `expandvars`, the two-level YAML
  reader against `yaml.safe_load`, `load_registry_yaml` in both
  packages, and `run_multi_scenes` calling each package's `demo.run`
  with the same arguments by name.
"""

import dataclasses
import inspect

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from wild_video_3d_reconstruction_torch import demo as tdemo
from wild_video_3d_reconstruction_torch.eval import droid_harness as tdroid
from wild_video_3d_reconstruction_torch.eval import harness as tharness
from wild_video_3d_reconstruction_torch.io import stream as tstream
from wild_video_3d_reconstruction_torch.slam import state as tstate
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.utils import config as tconfig
from wild_video_3d_reconstruction_torch.utils import datasets as tdatasets
from wild_video_3d_reconstruction_tpu import demo as jdemo
from wild_video_3d_reconstruction_tpu.eval import droid_harness as jdroid
from wild_video_3d_reconstruction_tpu.eval import harness as jharness
from wild_video_3d_reconstruction_tpu.io import stream as jstream
from wild_video_3d_reconstruction_tpu.ops import lie as jlie
from wild_video_3d_reconstruction_tpu.slam import dpvo as jdpvo
from wild_video_3d_reconstruction_tpu.train.synth import render_sequence
from wild_video_3d_reconstruction_tpu.utils import datasets as jdatasets

from test_torch_loop import jax_tree
from test_torch_slam import one_thread
from test_torch_synth_ate import jax_raw_draws, jax_state
from test_torch_weights import WEIGHTS

FRAMES = 16
HT, WD = 48, 64
SMALL = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
             OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
             MEM=12, GRADIENT_BIAS=False, CORR_CHUNK=512, PALLAS_CORR=False,
             MOTION_PROBE_THRESH=-1.0, MIXED_PRECISION=False)
TOL_ATE = 1e-3


@pytest.fixture(scope="module")
def rendered():
    images, w2c, intr = render_sequence(3, frames=FRAMES, ht=HT, wd=WD,
                                        path="walk")
    c2w = np.asarray(jlie.se3_inv(jnp.asarray(w2c)), np.float64)
    return np.asarray(images), c2w, np.asarray(intr, np.float64)


@pytest.fixture(scope="module")
def params():
    return jax_tree(WEIGHTS)


def write_tum(root, images, c2w):
    scene = root / "rgbd_dataset_freiburg1_synth"
    (scene / "rgb").mkdir(parents=True)
    tstamps = 100.0 + np.arange(len(images), dtype=np.float64)
    for t in range(len(images)):
        cv2.imwrite(str(scene / "rgb" / f"{tstamps[t]:.6f}.png"),
                    images[t][..., ::-1])
    np.savetxt(scene / "groundtruth.txt",
               np.concatenate([tstamps[:, None], c2w], axis=1),
               header="t x y z qx qy qz qw")
    return scene


def write_euroc(root, images, c2w):
    scene = root / "MH_99_synth"
    data = scene / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    gt_dir = scene / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    t_ns = (100.0 + np.arange(len(images), dtype=np.float64)) * 1e9
    for t in range(len(images)):
        gray = cv2.cvtColor(images[t][..., ::-1], cv2.COLOR_BGR2GRAY)
        cv2.imwrite(str(data / f"{int(t_ns[t])}.png"), gray)
    q_wxyz = c2w[:, [6, 3, 4, 5]]
    rows = np.concatenate([t_ns[:, None], c2w[:, :3], q_wxyz], axis=1)
    np.savetxt(gt_dir / "data.csv", rows, delimiter=",",
               header="t,px,py,pz,qw,qx,qy,qz")
    return scene


def jax_fp32_state(monkeypatch):
    """The JAX DPVO with an fp32 state of the port's edge rows (R4, R6)."""
    orig = jdpvo.DPVO.__init__

    def patched(self, cfg, *a, **kw):
        orig(self, cfg, *a, **kw)
        self.state = jax_state(cfg, tstate.edge_rows(tconfig.DPVOConfig(
            **{k: getattr(cfg, k) for k in SMALL})))

    monkeypatch.setattr(jdpvo.DPVO, "__init__", patched)


@pytest.mark.parametrize("dataset", ["tum", "euroc"])
def test_evaluate_matches_jax(dataset, tmp_path, rendered, params,
                              monkeypatch):
    images, c2w, intr = rendered
    writer = write_tum if dataset == "tum" else write_euroc
    scene = writer(tmp_path, images, c2w)
    table = "TUM_FR1_CALIB" if dataset == "tum" else "EUROC_CALIB"
    zeros = np.zeros(len(getattr(jharness, table)) - 4)
    for mod in (jharness, tharness):
        monkeypatch.setattr(mod, table, np.concatenate([intr, zeros]))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(SMALL))

    jax_fp32_state(monkeypatch)
    ref = jharness.evaluate(dataset, tmp_path, params, str(cfg), trials=1,
                            stride=1, scenes=[scene.name])
    monkeypatch.setattr(tsteps, "TIER_ON_CPU", True)
    monkeypatch.setattr(tsteps, "TIER_MIN_EDGES", 0)
    draws = jax_raw_draws(FRAMES, SMALL["PATCHES_PER_FRAME"], HT // 4,
                          WD // 4)
    with one_thread():
        out = tharness.evaluate(dataset, tmp_path, str(WEIGHTS), str(cfg),
                                trials=1, stride=1, scenes=[scene.name],
                                device="cpu", draws=draws)
    assert list(out) == list(ref) == [scene.name]
    assert np.isfinite(out[scene.name])
    assert abs(out[scene.name] - ref[scene.name]) <= TOL_ATE, (out, ref)


def _same_frames(got, ref):
    assert len(got) == len(ref) > 0
    for (t0, i0, k0), (t1, i1, k1) in zip(got, ref):
        assert t0 == t1
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(k0, k1)


def test_real_calibration_streams_match_jax(tmp_path):
    """tum_stream / euroc_stream unpatched at the datasets' sizes."""
    rng = np.random.default_rng(0)
    tum = tmp_path / "rgbd_dataset_freiburg1_mini"
    (tum / "rgb").mkdir(parents=True)
    for i in range(3):
        img = rng.integers(0, 255, (480, 640, 3), np.uint8)
        cv2.imwrite(str(tum / "rgb" / f"13050312{i:02d}.531102.png"), img)
    got = list(tharness.tum_stream(tum, stride=1))
    _same_frames(got, list(jharness.tum_stream(tum, stride=1)))
    t0, img0, intr0 = got[0]
    assert img0.shape == (480, 640, 3) and img0.dtype == np.uint8
    assert t0 == pytest.approx(1305031200.531102)
    raw = cv2.imread(str(sorted((tum / "rgb").glob("*.png"))[0]))
    assert np.abs(img0.astype(int) - raw.astype(int)).mean() > 1.0

    eur = tmp_path / "MH_mini"
    (eur / "mav0" / "cam0" / "data").mkdir(parents=True)
    for i in range(3):
        img = rng.integers(0, 255, (480, 752), np.uint8)
        cv2.imwrite(str(eur / "mav0" / "cam0" / "data" /
                        f"14036367991281{i}0000.png"), img)
    got = list(tharness.euroc_stream(eur, stride=2))
    _same_frames(got, list(jharness.euroc_stream(eur, stride=2)))
    assert len(got) == 2 and got[0][1].shape == (480, 752, 3)
    np.testing.assert_allclose(got[0][2], jharness.EUROC_CALIB[:4])


def test_sixteen_bit_png_frames_read_through_cv2(tmp_path):
    """A PNG kind `io/png.py` does not decode goes to cv2.imread, as every
    PNG does in the JAX package."""
    rng = np.random.default_rng(1)
    d = tmp_path / "rgb"
    d.mkdir()
    for i in range(2):
        cv2.imwrite(str(d / f"{i:04d}.png"),
                    rng.integers(0, 65535, (32, 48, 3), np.uint16))
    calib = [40.0, 40.0, 24.0, 16.0]
    got = list(tstream.image_frames(d, calib=calib))
    ref = list(jstream.image_frames(d, calib=calib))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == np.uint8


class _GroundTruthVO:
    """Stands in for DenseVO in both packages: returns the ground truth of
    the frames it saw with a per-frame jitter along x, which leaves a
    known positive ATE."""

    gt = None

    def __init__(self, ht, wd, intr, *a, **kw):
        self.tstamps = []

    def __call__(self, t, img):
        self.tstamps.append(t)

    def terminate(self):
        ts = np.asarray(self.tstamps, np.float64)
        idx = np.searchsorted(self.gt[1], ts)
        poses = self.gt[0][idx].copy()
        poses[:, 0] += 0.05 * np.sin(np.arange(len(ts)))
        return poses, ts


def test_run_tum_median_of_rmse_not_of_the_count(tmp_path, rendered,
                                                  monkeypatch):
    """R23: the JAX run_tum appends metrics.ate_rmse's (rmse, n) tuple and
    takes np.median over it: with one trial (rmse + n) / 2."""
    images, c2w, _ = rendered
    scene = write_tum(tmp_path, images, c2w)
    from wild_video_3d_reconstruction_tpu.eval import metrics as jmetrics
    _GroundTruthVO.gt = (c2w, 100.0 + np.arange(FRAMES, dtype=np.float64))
    monkeypatch.setattr(jdroid, "DenseVO", _GroundTruthVO)
    monkeypatch.setattr(tdroid, "DenseVO", _GroundTruthVO)
    for mod in (jharness, tharness):
        monkeypatch.setattr(mod, "TUM_FR1_CALIB", np.array(
            [40.0, 40.0, 32.0, 24.0, 0, 0, 0, 0, 0]))
    ref = jdroid.run_tum(str(tmp_path), scenes=[scene.name], stride=1)
    out = tdroid.run_tum(str(tmp_path), scenes=[scene.name], stride=1,
                         device="cpu")
    vo = _GroundTruthVO(HT, WD, None)
    for t in 100.0 + np.arange(FRAMES):
        vo(t, None)
    rmse, n = jmetrics.ate_rmse(*vo.terminate(), c2w,
                                100.0 + np.arange(FRAMES))
    assert n == FRAMES and 0 < rmse < 0.1
    assert out[scene.name] == pytest.approx(rmse, rel=1e-12)
    assert ref[scene.name] == pytest.approx((rmse + n) / 2, rel=1e-12)


def test_run_tum_tracks_a_tum_directory(tmp_path, rendered, monkeypatch):
    """The port's run_tum end to end on the CPU with the LK flow and a
    frame cap, like the JAX test's `frames=`."""
    images, c2w, intr = rendered
    scene = write_tum(tmp_path, images, c2w)
    monkeypatch.setattr(tharness, "TUM_FR1_CALIB",
                        np.concatenate([intr, np.zeros(5)]))
    with one_thread():
        out = tdroid.run_tum(str(tmp_path), scenes=[scene.name], stride=1,
                             frames=6, device="cpu", flow="lk", buffer=16)
    assert np.isfinite(out[scene.name])


REGISTRY = """# a registry of two sequences
seq_a:
  imagedir: /data/a/images   # the frames
  calib: calib/euroc.txt
  skip: 10
  end: null
  stride: 2
  config: "configs/fast.yaml"
  clips: [[0, 100], [100, 250]]
  notes: 'walk: quoted # not a comment'
seq_b:
  imagedir: ${WILD_SEQ_ROOT}/b
  depthdir: ~
  end: 2700
"""


def test_registry_entries_and_get_match_jax(monkeypatch):
    assert {k: dataclasses.asdict(v) for k, v in tdatasets.DATASETS.items()
            if k in jdatasets.DATASETS} == \
        {k: dataclasses.asdict(v) for k, v in jdatasets.DATASETS.items()}
    monkeypatch.setenv("WILD_DATA_ROOT", "/mnt/wild")
    for name in ("he_01", "lund", "euroc_mh01"):
        assert dataclasses.asdict(tdatasets.get(name)) == \
            dataclasses.asdict(jdatasets.get(name))
    assert tdatasets.get("he_01").imagedir.startswith("/mnt/wild/")
    with pytest.raises(KeyError, match="unknown dataset"):
        tdatasets.get("no_such_sequence")


def test_two_level_yaml_reader_matches_yaml(tmp_path, monkeypatch):
    assert tconfig.parse_two_level_yaml(REGISTRY) == yaml.safe_load(REGISTRY)
    for bad in ("a: 1\n", "a:\n  b: {c: 1}\n", "a:\n  b: |\n",
                "a:\n  b: 1\n    c: 2\n", "  b: 1\n"):
        with pytest.raises(ValueError):
            tconfig.parse_two_level_yaml(bad)
    path = tmp_path / "datasets.yaml"
    path.write_text(REGISTRY)
    monkeypatch.setattr(tdatasets, "DATASETS", dict(tdatasets.DATASETS))
    monkeypatch.setattr(jdatasets, "DATASETS", dict(jdatasets.DATASETS))
    tdatasets.load_registry_yaml(path)
    jdatasets.load_registry_yaml(path)
    monkeypatch.setenv("WILD_SEQ_ROOT", "/seq")
    for name in ("seq_a", "seq_b"):
        assert dataclasses.asdict(tdatasets.get(name)) == \
            dataclasses.asdict(jdatasets.get(name))
    assert tdatasets.get("seq_b").imagedir == "/seq/b"


def test_run_multi_scenes_calls_demo_run_by_name(monkeypatch):
    """The JAX driver calls its demo.run positionally (imagedir, depthdir,
    maskdir, calib); the port's run takes (imagedir, calib, ...,
    depthdir=, maskdir=): bound to their signatures, the two calls name
    the same values."""
    calls = {}

    def recorder(key, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            args = dict(bound.arguments)
            args.pop("cfg")
            calls[key] = args
            return key
        return rec

    monkeypatch.setattr(jdemo, "run", recorder("jax", jdemo.run))
    monkeypatch.setattr(tdemo, "run", recorder("port", tdemo.run))
    ds = dict(name="multi_probe", imagedir="/x/images", calib="calib/a.txt",
              depthdir="/x/depth", maskdir="/x/mask", skip=3, end=40,
              stride=2, config="configs/fast.yaml")
    monkeypatch.setattr(tdatasets, "DATASETS", dict(tdatasets.DATASETS))
    monkeypatch.setattr(jdatasets, "DATASETS", dict(jdatasets.DATASETS))
    tdatasets.register(tdatasets.Dataset(**ds))
    jdatasets.register(jdatasets.Dataset(**ds))
    assert tdatasets.run_multi_scenes(["multi_probe"], network="n",
                                      out_root="/o") == {"multi_probe":
                                                         "port"}
    jdatasets.run_multi_scenes(["multi_probe"], network="n", out_root="/o")
    shared = set(calls["jax"]) & set(calls["port"])
    for key in ("network", "imagedir", "calib", "depthdir", "maskdir",
                "stride", "skip", "end", "path", "save_trajectory",
                "export_colmap"):
        assert key in shared
        assert calls["port"][key] == calls["jax"][key], key
    assert calls["port"]["path"] == "/o/multi_probe"
