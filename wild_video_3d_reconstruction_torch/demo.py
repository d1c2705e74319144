"""CLI demo: `python -m wild_video_3d_reconstruction_torch.demo`.

Takes the flags of the JAX package's demo. It streams an image directory
(with optional depth and mask directories) or a video file through
`io/stream.py`, runs the VO loop and the final refinement, and writes the
TUM trajectory. The parts of the JAX demo that the port does not have yet
(loop closure, visualisation, PLY / COLMAP export, SLAM checkpoints,
calibration without a calib file) raise NotImplementedError when asked
for.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np


def int_or_none(value):
    if value.lower() == "none":
        return None
    return int(value)


def run(cfg, network, imagedir, calib, stride=1, skip=0, end=None,
        path="./output", save_trajectory=False, device="cuda", seed=0,
        sync_mode=False, depthdir=None, maskdir=None):
    """Run VO over the images of `imagedir` (with the depth maps of
    `depthdir` and the masks of `maskdir`) or over the video file
    `imagedir`; returns (poses c2w [T, 7], tstamps). sync_mode: the
    synchronous steady path (`slam.dpvo`)."""
    import torch

    from .io import export, stream
    from .slam import DPVO

    calib = np.loadtxt(calib, delimiter=" ") if isinstance(calib, str) \
        else calib
    gen = stream.image_frames(imagedir, depthdir, maskdir, calib, stride,
                              skip, end) if os.path.isdir(imagedir) else \
        stream.video_frames(imagedir, calib, stride, skip)
    reader = stream.Prefetcher(gen, maxsize=8,
                               pin=torch.device(device).type == "cuda")
    slam = None
    for t, image, depth, mask, intrinsics in reader:
        if slam is None:
            ht, wd, _ = image.shape
            slam = DPVO(cfg, network, ht, wd, seed=seed, device=device,
                        sync_mode=sync_mode)
        slam(t, image, intrinsics, depth=depth, mask=mask)
    if slam is None:
        raise ValueError(f"no frames in {imagedir}")

    slam.refine(12)
    poses, tstamps = slam.terminate()

    if save_trajectory:
        out = Path(path) / "saved_trajectories"
        out.mkdir(exist_ok=True, parents=True)
        export.save_trajectory_tum_format(
            poses, tstamps, out / f"{Path(imagedir).stem}.txt")
    return poses, tstamps


# the JAX demo's flags the port does not have yet: loop closure (ROADMAP
# Queue 1 item 12), visualisation and the map's export (item 21), SLAM
# checkpoints (item 11), timing (item 17)
_NOT_PORTED = ("viz", "rerun", "loop_enabled", "save_reconstruction",
               "export_colmap", "plot", "resume", "checkpoint_every",
               "timeit")


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
    parser.add_argument("--sync_mode", action="store_true",
                        help="steady frames eagerly with the keyframe "
                             "decision on the host, instead of the fixed-"
                             "shape step (CUDA graph replays on the card)")
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
        seed=args.set_seed, sync_mode=args.sync_mode,
        depthdir=args.depthdir, maskdir=args.maskdir)


if __name__ == "__main__":
    main()
