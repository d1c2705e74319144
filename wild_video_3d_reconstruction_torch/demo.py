"""CLI demo: `python -m wild_video_3d_reconstruction_torch.demo`.

Takes the flags of the JAX package's demo and runs its steps in its
order: it streams an image directory (with optional depth and mask
directories) or a video file through `io/stream.py`, tracks every frame
(`--checkpoint_every N` saves the run every N frames, `--resume DIR`
continues a saved one; `--viz` / `--rerun` log the map as it grows, in
`sync_mode`; `--timeit` times each frame), runs the final refinement,
then writes the outputs asked for: the map as PLY (`--save_reconstruction`),
the TUM trajectory (`--save_trajectory`), a plot of it (`--plot`, needs
matplotlib) and a COLMAP model with nerfstudio's `transforms.json`
(`--export_colmap`). `--loop_enabled` (or `loop_enabled: true` in the
config) adds the long-term loop closure, its VLAD centres fitted first on
24 evenly spaced images of an image directory (the frames then stay in
pageable host memory: the loop closure keeps its keyframes); it cannot be
combined with `--checkpoint_every` or `--resume`, which raise before the
first frame (the JAX checkpoint saves the loop's state). Calibration
without a calib file is not ported yet and raises NotImplementedError.
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
        sync_mode=False, depthdir=None, maskdir=None, timeit=False,
        save_reconstruction=False, export_colmap=False, plot=False,
        viz=False, rerun=False, checkpoint_every=0, resume=None,
        loop_enabled=False):
    """Run VO over the images of `imagedir` (with the depth maps of
    `depthdir` and the masks of `maskdir`) or over the video file
    `imagedir`, and write the outputs asked for under `path`; returns
    (poses c2w [T, 7], tstamps, (points [K, 3], colors [K, 3])).
    sync_mode: the synchronous steady path (`slam.dpvo`), also taken with
    viz or rerun. loop_enabled: the loop closure (also with the config's
    loop_enabled)."""
    import torch

    from .io import export, stream
    from .slam import DPVO
    from .slam.checkpoint import load_slam, save_slam
    from .utils.timer import Timer, timing_summary

    calib = np.loadtxt(calib, delimiter=" ") if isinstance(calib, str) \
        else calib
    loop = loop_enabled or cfg.loop_enabled
    if loop and (checkpoint_every or resume):
        raise NotImplementedError(
            "a run with the loop closure cannot be saved or resumed: its "
            "retrieval database and keyframe images are not part of a "
            "checkpoint")
    if loop:
        # one network for the centre fitting and the run
        from .models.convert import (jax_params_to_torch,
                                     load_reference_checkpoint)
        from .models.vonet import VONet, init_vonet
        cfg = cfg.merge_from_dict({"loop_enabled": True})
        network = network if isinstance(network, VONet) else \
            load_reference_checkpoint(network) if isinstance(network, str) \
            else init_vonet(seed) if network is None else \
            jax_params_to_torch(network)
    gen = stream.image_frames(imagedir, depthdir, maskdir, calib, stride,
                              skip, end) if os.path.isdir(imagedir) else \
        stream.video_frames(imagedir, calib, stride, skip)
    reader = stream.Prefetcher(
        gen, maxsize=8, pin=torch.device(device).type == "cuda" and not loop)
    slam = None
    visualizer = None
    n_seen = 0
    for t, image, depth, mask, intrinsics in reader:
        if slam is None:
            ht, wd, _ = image.shape
            vlad = None
            if loop:
                vlad = _fitted_vlad(cfg, network, imagedir, calib, stride,
                                    skip, end, device)
            slam = DPVO(cfg, network, ht, wd, seed=seed, device=device,
                        sync_mode=sync_mode or viz or rerun, vlad=vlad)
            if viz or rerun:
                from .utils.viz import Visualizer
                visualizer = Visualizer(slam, path=f"{path}/viz",
                                        use_rerun=rerun)
            if resume:
                load_slam(slam, resume)
                print(f"resumed from {resume} at frame {slam.counter}")
        n_seen += 1
        if resume and n_seen <= slam.counter:
            continue                     # frames the checkpoint covers
        if checkpoint_every and slam.counter and \
                slam.counter % checkpoint_every == 0:
            save_slam(slam, f"{path}/slam_ckpt")
        with Timer("SLAM", enabled=timeit,
                   sync=(lambda: slam.state.poses) if timeit else None):
            slam(t, image, intrinsics, depth=depth, mask=mask)
        if visualizer is not None and slam.is_initialized and t % 4 == 0:
            visualizer.update(image=image)
    if slam is None:
        raise ValueError(f"no frames in {imagedir}")

    for _ in range(12):
        slam.refine(1)

    points, colors = slam.points_and_colors()
    poses, tstamps = slam.terminate()
    if timeit:
        timing_summary()

    Path(path).mkdir(parents=True, exist_ok=True)
    name = Path(imagedir).stem
    if save_reconstruction:
        export.save_ply(Path(path) / f"{name}.ply", points, colors)
        print(f"Saved {path}/{name}.ply")
    if save_trajectory:
        out = Path(path) / "saved_trajectories"
        out.mkdir(exist_ok=True, parents=True)
        export.save_trajectory_tum_format(poses, tstamps, out / f"{name}.txt")
    if plot:
        Path(f"{path}/trajectory_plots").mkdir(exist_ok=True, parents=True)
        export.plot_trajectory(poses, title=f"DPVO Trajectory for {name}",
                               filename=f"{path}/trajectory_plots/{name}.pdf")
    if export_colmap:
        fx, fy, cx, cy = np.asarray(calib)[:4]
        export.save_output_for_colmap(
            f"{path}/colmap_{name}", poses, tstamps, points, colors,
            fx, fy, cx, cy, slam.ht, slam.wd)
        with open(f"{path}/config.yaml", "w") as f:
            f.write(cfg.dump())
    return poses, tstamps, (points, colors)


def _fitted_vlad(cfg, net, imagedir, calib, stride, skip, end, device):
    """The loop closure's VLAD centres fitted on the features (of the
    VONet net) of 24 evenly spaced images of an image directory, or None
    (default centres) for a video or with an hloc NetVLAD checkpoint."""
    if cfg.NETVLAD_CHECKPOINT or not os.path.isdir(imagedir):
        return None
    from .io import stream
    from .loop.netvlad import VLADDescriptor, fit_centers_from_images

    files = stream.list_images(imagedir, stride, skip, end)
    k = min(24, len(files))
    picks = [files[int(i * len(files) / k)] for i in range(k)]
    imgs = [im for im in (stream.read_image(f, calib) for f in picks)
            if im is not None]
    if not imgs:
        return None
    return VLADDescriptor(centers=fit_centers_from_images(
        net.to(device).eval(), imgs))


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
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="save the run every N frames")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume from a slam_ckpt directory")
    parser.add_argument("--opts", nargs="+", default=[])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda unless 'cpu' is asked for")
    parser.add_argument("--sync_mode", action="store_true",
                        help="steady frames eagerly with the keyframe "
                             "decision on the host, instead of the fixed-"
                             "shape step (CUDA graph replays on the card)")
    args = parser.parse_args(argv)

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
        depthdir=args.depthdir, maskdir=args.maskdir, timeit=args.timeit,
        save_reconstruction=args.save_reconstruction,
        export_colmap=args.export_colmap, plot=args.plot, viz=args.viz,
        rerun=args.rerun, checkpoint_every=args.checkpoint_every,
        resume=args.resume, loop_enabled=args.loop_enabled)


if __name__ == "__main__":
    main()
