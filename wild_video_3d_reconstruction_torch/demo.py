"""CLI demo: `python -m wild_video_3d_reconstruction_torch.demo`.

Takes the flags of the JAX package's demo. It streams an image directory,
runs the VO loop and the final refinement, and writes the TUM trajectory.
The parts of the JAX demo that the port does not have yet (video input,
depth and mask inputs, loop closure, visualisation, PLY / COLMAP export,
SLAM checkpoints, calibration without a calib file) raise
NotImplementedError when asked for.
"""

from __future__ import annotations

import argparse
import os
from itertools import chain
from pathlib import Path

import numpy as np

IMG_EXTS = ("*.png", "*.jpeg", "*.jpg")


def int_or_none(value):
    if value.lower() == "none":
        return None
    return int(value)


def image_frames(imagedir, calib, stride=1, skip=0, end=None):
    """Yield (t, image BGR uint8, intrinsics [4]) from an image directory:
    undistorted when the calib has distortion terms, cropped to a multiple
    of 16."""
    import cv2

    calib = np.asarray(calib, dtype=np.float64)
    fx, fy, cx, cy = calib[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    files = sorted(chain.from_iterable(Path(imagedir).glob(e)
                                       for e in IMG_EXTS))
    files = files[skip:end:stride]
    for t, imfile in enumerate(files):
        image = cv2.imread(str(imfile), cv2.IMREAD_COLOR)
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])
        h, w, _ = image.shape
        yield t, image[:h - h % 16, :w - w % 16], np.array([fx, fy, cx, cy])


def run(cfg, network, imagedir, calib, stride=1, skip=0, end=None,
        path="./output", save_trajectory=False, device="cuda", seed=0):
    """Run VO over the images of `imagedir`; returns (poses c2w [T, 7],
    tstamps)."""
    from .io import export
    from .slam import DPVO

    if not os.path.isdir(imagedir):
        raise NotImplementedError("video input is not ported yet; pass an "
                                  "image directory")
    calib = np.loadtxt(calib, delimiter=" ") if isinstance(calib, str) \
        else calib
    slam = None
    for t, image, intrinsics in image_frames(imagedir, calib, stride, skip,
                                             end):
        if slam is None:
            ht, wd, _ = image.shape
            slam = DPVO(cfg, network, ht, wd, seed=seed, device=device)
        slam(t, image, intrinsics)

    slam.refine(12)
    poses, tstamps = slam.terminate()

    if save_trajectory:
        out = Path(path) / "saved_trajectories"
        out.mkdir(exist_ok=True, parents=True)
        export.save_trajectory_tum_format(
            poses, tstamps, out / f"{Path(imagedir).stem}.txt")
    return poses, tstamps


_NOT_PORTED = ("depthdir", "maskdir", "viz", "rerun", "loop_enabled",
               "save_reconstruction", "export_colmap", "plot", "resume",
               "checkpoint_every", "timeit")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--network", type=str,
                        default="checkpoints/dpvo.pth")
    parser.add_argument("--imagedir", type=str, required=True)
    parser.add_argument("--depthdir", type=str, default=None)
    parser.add_argument("--maskdir", type=str, default=None)
    parser.add_argument("--calib", type=str, default=None)
    parser.add_argument("--path", type=str, default="./output")
    parser.add_argument("--buffer", type=int, default=2048)
    parser.add_argument("--config", default="configs/default.yaml")
    parser.add_argument("--stride", type=int, default=2)
    parser.add_argument("--skip", type=int, default=0)
    parser.add_argument("--end", type=int_or_none, default=None)
    parser.add_argument("--timeit", action="store_true")
    parser.add_argument("--viz", action="store_true")
    parser.add_argument("--rerun", action="store_true")
    parser.add_argument("--loop_enabled", action="store_true")
    parser.add_argument("--save_reconstruction", action="store_true")
    parser.add_argument("--save_trajectory", action="store_true")
    parser.add_argument("--export_colmap", action="store_true")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--set_seed", type=int, default=0)
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--opts", nargs="+", default=[])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda unless 'cpu' is asked for")
    args = parser.parse_args(argv)

    asked = [k for k in _NOT_PORTED if getattr(args, k)]
    if asked:
        raise NotImplementedError(
            f"not ported yet: --{', --'.join(asked)}")
    if args.calib is None:
        raise NotImplementedError("calibration without --calib is not "
                                  "ported yet")

    from .utils.config import load_config, resource_path

    config = resource_path(args.config)
    cfg = load_config(config if os.path.exists(config) else None)
    cfg = cfg.merge_from_dict({"BUFFER_SIZE": args.buffer})
    if args.opts:
        cfg = cfg.merge_from_list(args.opts)
    print(cfg.dump())

    network = resource_path(args.network)
    if not os.path.exists(network):
        print(f"WARNING: checkpoint {args.network} not found; using weights "
              f"drawn from seed {args.set_seed}")
        network = None
    run(cfg, network, args.imagedir, resource_path(args.calib),
        stride=args.stride, skip=args.skip, end=args.end, path=args.path,
        save_trajectory=args.save_trajectory, device=args.device,
        seed=args.set_seed)


if __name__ == "__main__":
    main()
