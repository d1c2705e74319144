"""Full-SLAM trajectory accuracy on a rendered synthetic sequence.

The port's `eval/synth_ate.py`: the JAX package's protocol, on the
port's tracker. `DPVO` (the demo's code path) runs over a
`train/synth.py` walk (48x64, 60 frames, 16 patches, `DEPTH_INIT:
median`, the motion probe stubbed) with known ground-truth poses, and
the Sim(3)-aligned ATE RMSE is reported beside the floor an identity
trajectory scores against the same ground truth.

Run (from the repository root):

    python -m wild_video_3d_reconstruction_torch.eval.synth_ate \
        --network weights/vonet_synth_tpu_r3_step2000.pth [--device cpu]

`--network` takes a DPVO-layout `.pth` (none: weights drawn from seed 0);
`--device` is `cuda` unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import lie
from ..slam import DPVO
from ..train.synth import (_PlaneWorld, _pose7, _so3_exp, _texture,
                           render_sequence)
from ..utils.config import DPVOConfig
from . import metrics


def config(frames, probe_stub=True, **overrides):
    """The protocol's tracker config (the JAX package's `synth_ate.run`)."""
    return DPVOConfig(
        BUFFER_SIZE=max(frames + 8, 64), PATCHES_PER_FRAME=16,
        REMOVAL_WINDOW=8, OPTIMIZATION_WINDOW=6, PATCH_LIFETIME=5,
        KEYFRAME_INDEX=2, MEM=16, GRADIENT_BIAS=False, PALLAS_CORR=False,
        CORR_CHUNK=1024, DEPTH_INIT="median",
        MOTION_PROBE_THRESH=-1.0 if probe_stub else 2.0, **overrides)


def ate_against(est_c2w, tstamps, poses_gt_w2c):
    """(ATE RMSE, frames aligned, identity floor) of camera-to-world poses
    est [T, 7] against ground-truth world-to-camera poses [T, 7]."""
    frames = len(poses_gt_w2c)
    gt_c2w = lie.se3_inv(torch.as_tensor(poses_gt_w2c)).numpy()
    t_gt = np.arange(frames, dtype=np.float64)
    ate, n = metrics.ate_rmse(est_c2w, tstamps, gt_c2w, t_gt)
    ident = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (frames, 1))
    floor, _ = metrics.ate_rmse(ident, t_gt, gt_c2w, t_gt)
    return float(ate), int(n), float(floor)


def _rotation(q):
    """Rotation matrix of a unit quaternion [x, y, z, w]."""
    x, y, z, w = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _walk(seed, frames, ht, wd, fx, fy):
    """`render_sequence`'s world and walk poses [T, 7] (path "walk") with
    its draws in its order, without rendering the frames."""
    rng = np.random.default_rng(seed)
    world = _PlaneWorld(rng, ht, wd, fx, fy, tex_scale=3 + 2 * (frames // 25),
                        n_planes=3)
    poses = np.zeros((frames, 7), np.float32)
    Rk, tk = np.eye(3), np.zeros(3)
    vel = rng.normal(size=3)
    vel *= rng.uniform(0.03, 0.1) / np.linalg.norm(vel)
    for k in range(frames):
        poses[k] = _pose7(Rk, tk)
        dR = _so3_exp(rng.normal(0, 0.015, 3))
        Rk = dR @ Rk
        tk = dR @ tk + rng.normal(0, 0.03, 3) + vel
    return world, poses


def wild_sequence(seed=0, frames=40, ht=384, wd=512, fx=320.0, fy=320.0,
                  path="walk", stride=1):
    """The wild-video input over `render_sequence`'s world and trajectory:
    each frame rendered with an independently moving occluder disc
    (`_PlaneWorld.render(occ=)`, which gives the mask: True = static),
    and the world's full-resolution metric depth (`_PlaneWorld._surface`)
    as the depth prior. The disc rides 1.4 units in front of the camera,
    15% of the view's width in radius, and drifts across the view.

    stride: the sequence of frames * stride steps (its world, walk and
    occluder drift) of which every stride-th frame is rendered, so
    `wild_sequence(frames=F, stride=s)` equals `wild_sequence(frames=F * s)`
    at frames 0, s, 2s, ...: stride times the motion per frame.
    Returns (images [T, H, W, 3] uint8, poses_w2c [T, 7], intrinsics [4],
    depths [T, H, W] fp32, masks [T, H, W] bool)."""
    steps = frames * stride
    if path == "walk":
        world, poses = _walk(seed, steps, ht, wd, fx, fy)
    else:
        _, poses, _ = render_sequence(seed, frames=steps, ht=ht, wd=wd,
                                      fx=fx, fy=fy, path=path)
        # the same world: render_sequence draws it first from this seed
        world = _PlaneWorld(np.random.default_rng(seed), ht, wd, fx, fy,
                            tex_scale=3 + 2 * (steps // 25), n_planes=3)
    poses = poses[::stride].copy()
    rng = np.random.default_rng(seed + 1)
    zo = 1.4
    span = zo / fx * wd
    rad = 0.15 * span
    start = np.array([rng.uniform(-0.2, 0.2) * span,
                      rng.uniform(-0.1, 0.1) * span, zo])
    drift = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.4, 0.4), 0.0])
    drift *= span / max(steps, 1)
    tex = _texture(rng, 48, 48, octaves=3)
    images = np.zeros((frames, ht, wd, 3), np.uint8)
    depths = np.zeros((frames, ht, wd), np.float32)
    masks = np.zeros((frames, ht, wd), bool)
    for k in range(frames):
        R, t = _rotation(poses[k, 3:]), poses[k, :3].astype(np.float64)
        centre = -R.T @ t + start + k * stride * drift
        images[k], _, masks[k] = world.render(R, t, occ=(centre, rad, tex))
        depths[k] = world._surface(R, t, world.rays)[1]
    return images, poses, world.intrinsics(), depths, masks


def run(network=None, frames=60, ht=48, wd=64, seed=0, probe_stub=True,
        path="walk", slam_seed=0, focal_err=0.0, device="cuda", draws=None,
        cfg_overrides=None):
    """Track the rendered sequence of `seed` and score it. network: as
    `DPVO` takes it; draws: per frame, keyword arguments of `DPVO.__call__`
    that replace its draws (the parity tests feed the JAX run's);
    cfg_overrides: config values over the protocol's."""
    images, poses_gt_w2c, intr = render_sequence(seed, frames=frames,
                                                 ht=ht, wd=wd, path=path)
    cfg = config(frames, probe_stub, **(cfg_overrides or {}))
    slam = DPVO(cfg, network, ht, wd, seed=slam_seed, device=device)

    # calibration-error injection: the tracker is fed focals off by
    # (1 + focal_err) while rendering and ground truth use the true camera
    intr_fed = np.asarray(intr, np.float64).copy()
    intr_fed[:2] *= (1.0 + focal_err)

    for t in range(frames):
        slam(t, images[t], intr_fed, **(draws[t] if draws else {}))
    est, tstamps = slam.terminate()
    ate, n, floor = ate_against(est, tstamps, poses_gt_w2c)
    return {"ate_rmse": ate, "ate_floor_identity": floor, "n_aligned": n,
            "n_keyframes": int(slam.n_host), "poses": est}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", type=str, default=None,
                    help="DPVO-layout .pth (default: weights from seed 0)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--path", choices=["walk", "orbit"], default="walk")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; cuda unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    results = []
    for i in range(args.trials):
        r = run(network=args.network, frames=args.frames, seed=args.seed + i,
                path=args.path, device=args.device)
        r.pop("poses")
        results.append(r)
    out = {
        "metric": "synth_ate",
        "path": args.path,
        "network": args.network or "random",
        "device": args.device,
        "ate_rmse_median": float(np.median([r["ate_rmse"]
                                            for r in results])),
        "trials": results,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
