"""Dataset evaluation harnesses (TUM-RGBD fr1 and EuRoC).

The port's copy of the JAX package's `eval/harness.py`, the reference's
`evaluation/dpvo_eva_tum.py` / `dpvo_eva_euroc.py` protocol: each scene
streamed from disk with its dataset's undistortion, N trials of the
port's `DPVO` (on the card unless the CPU is asked for), terminate and
interpolate, the Sim(3)-aligned ATE RMSE, the per-scene median of the
trials and a final table.

Frames are PNGs, read through `io/png.py` (bitwise `cv2.imread`, so an
EuRoC gray PNG comes back as three equal channels) and undistorted by
`io/stream.py:read_image`, which imports cv2 for `cv2.undistort`.

Run (from the repository root):

    python -m wild_video_3d_reconstruction_torch.eval.harness tum \
        --datapath /data/TUM-RGBD \
        --network weights/vonet_synth_tpu_r3_step2000.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import atexit
import os
from pathlib import Path

import numpy as np

from ..io import stream
from ..utils.config import load_config, resource_path
from . import metrics

TUM_FR1_SCENES = [
    "rgbd_dataset_freiburg1_360", "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_desk2", "rgbd_dataset_freiburg1_floor",
    "rgbd_dataset_freiburg1_plant", "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_rpy", "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg1_xyz",
]
EUROC_SCENES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]

# TUM freiburg1 intrinsics + distortion (public calibration)
TUM_FR1_CALIB = np.array([517.3, 516.5, 318.6, 255.3,
                          0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
EUROC_CALIB = np.array([458.654, 457.296, 367.215, 248.375,
                        -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])


def _frames(files, calib, stamp):
    """(t, undistorted BGR image cropped to a multiple of 16, fx fy cx cy)
    for each file."""
    for f in files:
        img = stream.read_image(f, calib)
        h, w, _ = img.shape
        img = img[:h - h % 16, :w - w % 16]
        yield stamp(f), img, np.array(calib[:4])


def tum_stream(scenedir, stride=1):
    """Undistorted TUM rgb stream, cropped to a multiple of 16."""
    files = sorted((Path(scenedir) / "rgb").glob("*.png"))[::stride]
    return _frames(files, TUM_FR1_CALIB, lambda f: float(f.stem))


def euroc_stream(scenedir, stride=1):
    """Undistorted EuRoC cam0 stream (gray PNGs read as colour), cropped
    to a multiple of 16; timestamps from nanoseconds to seconds."""
    files = sorted((Path(scenedir) / "mav0" / "cam0" / "data").glob(
        "*.png"))[::stride]
    return _frames(files, EUROC_CALIB, lambda f: float(f.stem) / 1e9)


def run_scene(cfg, network, frames, device="cuda", draws=None):
    """Track one stream with a new `DPVO`; returns (poses c2w [T, 7],
    timestamps [T]). draws: per frame, keyword arguments of
    `DPVO.__call__` that replace its draws (the parity tests feed the
    JAX run's)."""
    from ..slam import DPVO

    slam = None
    tmap = []
    for t, img, intr in frames:
        if slam is None:
            ht, wd, _ = img.shape
            slam = DPVO(cfg, network, ht, wd, device=device)
        tmap.append(t)
        slam(len(tmap) - 1, img, intr,
             **(draws[len(tmap) - 1] if draws else {}))
    slam.refine(12)
    poses, counters = slam.terminate()
    tstamps = np.asarray(tmap)[counters.astype(int)]
    return poses, tstamps


def evaluate(dataset, datapath, network, config, trials=1, stride=2,
             scenes=None, device="cuda", log=print, draws=None):
    """{scene: median ATE RMSE of the trials} over the scenes of
    `datapath` (missing ones are skipped); a run interrupted mid-way
    prints what it measured at exit (the reference's partial dump,
    `evaluation/dpvo_eva_euroc.py:83-109`). network: as `DPVO` takes it;
    draws: as `run_scene` takes them, for every trial."""
    cfg = load_config(config)
    if dataset == "tum":
        scenes = scenes or TUM_FR1_SCENES
        stream_fn, gt_fn, gt_file = tum_stream, \
            metrics.load_tum_groundtruth, "groundtruth.txt"
    else:
        scenes = scenes or EUROC_SCENES
        stream_fn, gt_fn = euroc_stream, metrics.load_euroc_groundtruth
        gt_file = "mav0/state_groundtruth_estimate0/data.csv"

    results = {}

    def _dump_partial():
        if results:
            log("\n=== partial results (interrupted) ===")
            for scene, err in results.items():
                log(f"{scene:45s} {err:.4f}")
    atexit.register(_dump_partial)

    for scene in scenes:
        scenedir = Path(datapath) / scene
        if not scenedir.exists():
            log(f"skipping missing scene {scene}")
            continue
        gt_poses, gt_t = gt_fn(scenedir / gt_file)
        errs = []
        for trial in range(trials):
            poses, tstamps = run_scene(cfg, network,
                                       stream_fn(scenedir, stride), device,
                                       draws)
            err, n = metrics.ate_rmse(poses, tstamps, gt_poses, gt_t)
            errs.append(err)
            log(f"{scene} trial {trial}: ATE {err:.4f} ({n} assoc)")
        results[scene] = float(np.median(errs))

    atexit.unregister(_dump_partial)
    log("\n=== results (ATE RMSE, median of trials) ===")
    for scene, err in results.items():
        log(f"{scene:45s} {err:.4f}")
    if results:
        log(f"{'MEAN':45s} {np.mean(list(results.values())):.4f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["tum", "euroc"])
    ap.add_argument("--datapath", required=True)
    ap.add_argument("--network", default="checkpoints/dpvo.pth",
                    help="DPVO-layout .pth (missing: weights from seed 0)")
    ap.add_argument("--config", default="configs/tum.yaml")
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    network = resource_path(args.network)
    network = network if os.path.exists(network) else None
    return evaluate(args.dataset, args.datapath, network,
                    resource_path(args.config), args.trials, args.stride,
                    args.scenes, args.device)


if __name__ == "__main__":
    main()
