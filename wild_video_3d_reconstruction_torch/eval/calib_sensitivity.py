"""Calibration error -> end-to-end ATE sensitivity sweep.

The port's copy of the JAX package's `eval/calib_sensitivity.py`.
`init/colmap_init.py`'s self-calibration carries a 2-15% focal-error
envelope; this driver maps it to a downstream cost: it tracks rendered
scenes with the tracker fed focals off by 0/2/5/10/15% (ground truth and
rendering keep the true camera, `eval/synth_ate.py`) and reports the
Sim(3) ATE per error level.

`--oracle` replaces the update network by ground-truth flow targets
(`run_oracle`), so the ATE isolates the geometric cost of the focal
error. The oracle is installed as `slam/steps.py:_run_update_net` before
the `DPVO` is built, so the steady step's CUDA graphs capture it, and it
reads nothing back to the host; it counts its own executions on the
device (`Oracle.calls`), graph replays included.

Run (from the repository root):

    python -u -m wild_video_3d_reconstruction_torch.eval.calib_sensitivity \
        [--network weights/vonet_synth_tpu_r3_step2000.pth] [--trials 2] \
        [--oracle] [--markdown PATH] [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import synth_ate

LEVELS = (0.0, 0.02, 0.05, 0.10, 0.15)
SCENES = (("walk_s0", dict(path="walk", seed=0)),
          ("orbit_s0", dict(path="orbit", seed=0)))


class Oracle:
    """`steps._run_update_net` with the network replaced by ground-truth
    flow: each edge's target is its patch centre transferred with the true
    intrinsics, the ground-truth poses and the renderer's inverse depth
    (at the /4 grid the tracker uses), weight 1 on live edges. Device
    tensors only, so a CUDA graph can capture it; `calls` (a device
    counter) rises by one at every execution, replays included."""

    def __init__(self, gt_w2c, disps, intr_true, frames, ht, wd, device):
        dev = torch.device(device)
        self.frames, self.ht, self.wd = frames, ht, wd
        self.gt = torch.as_tensor(gt_w2c, dtype=torch.float32, device=dev)
        self.disps = torch.as_tensor(disps, dtype=torch.float32, device=dev)
        self.intr = torch.as_tensor(np.asarray(intr_true, np.float32) / 4.0,
                                    device=dev)
        self.calls = torch.zeros((), dtype=torch.long, device=dev)

    def __call__(self, cfg, net, state, net_e, ii, jj, kk, valid, n,
                 nbr=None, agg_order=None, shard=None):
        # per-row targets: nothing to reduce across a shard's rows
        from ..ops import projective as pops

        coords = pops.transform(state.poses, state.patches,
                                state.intrinsics, ii, jj, kk)
        coords = torch.where(valid[:, None, None, None], coords, 0.0)
        xy = state.patches[kk][:, :2, 1, 1].float()      # [E, 2], /4 grid
        gx = xy[:, 0].long().clamp(0, self.wd // 4 - 1)
        gy = xy[:, 1].long().clamp(0, self.ht // 4 - 1)
        d_true = self.disps[ii.clamp(0, self.frames - 1), gy, gx]
        E = ii.shape[0]
        patches_gt = torch.cat(
            [xy[:, :, None, None].expand(E, 2, 3, 3),
             d_true[:, None, None, None].expand(E, 1, 3, 3)], dim=1)
        gt_full = torch.zeros(state.poses.shape, dtype=torch.float32,
                              device=self.gt.device)
        gt_full[:self.frames] = self.gt
        intr_full = self.intr[None].expand(state.poses.shape[0], 4)
        target = pops.transform(gt_full, patches_gt, intr_full, ii, jj,
                                torch.arange(E, device=ii.device))[:, 1, 1]
        delta = target - coords[:, 1, 1, :].float()
        weight = torch.ones_like(delta) * valid[:, None]
        self.calls.add_(1)
        return net_e, delta, weight, coords


def oracle_config(frames):
    """The oracle's tracker config (the JAX package's `run_oracle`; its
    motion probe, stubbed there to pass, is skipped)."""
    from ..utils.config import DPVOConfig

    return DPVOConfig(
        BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=frames + 2,
        OPTIMIZATION_WINDOW=frames + 2, PATCH_LIFETIME=10,
        KEYFRAME_INDEX=2, KEYFRAME_THRESH=0.0, MEM=24,
        GRADIENT_BIAS=False, CORR_CHUNK=512, PALLAS_CORR=False,
        MOTION_PROBE_THRESH=-1.0)


def run_oracle(focal_err, frames=18, seed=0, device="cuda", draws=None,
               record=None):
    """Oracle-flow SLAM rollout with miscalibrated intrinsics: the
    geometric cost of feeding BA focals off by (1 + focal_err), with no
    network noise. Targets are in pixels and so independent of the
    calibration; only the back-projections inside BA and the reprojection
    use the wrong focals. draws: per frame, keyword arguments of
    `DPVO.__call__` that replace its draws; record: a dict that gets the
    oracle's device count of executions ("oracle_calls") and its Python
    calls ("oracle_traced")."""
    from ..ops import lie
    from ..slam import DPVO, steps
    from ..train.synth import render_clip
    from . import metrics

    ht, wd = 96, 128
    rng = np.random.default_rng(seed)
    images, gt_w2c, disps, intr_true = render_clip(
        rng, frames=frames, ht=ht, wd=wd, fx=wd * 0.6, fy=wd * 0.6,
        n_planes=3)
    oracle = Oracle(gt_w2c, disps, intr_true, frames, ht, wd, device)
    traced = [0]

    def run_update_net(*a, **kw):
        traced[0] += 1
        return oracle(*a, **kw)

    orig = steps._run_update_net
    steps._run_update_net = run_update_net
    try:
        slam = DPVO(oracle_config(frames), None, ht, wd, seed=0,
                    device=device)
        intr_fed = np.asarray(intr_true, np.float64).copy()
        intr_fed[:2] *= (1.0 + focal_err)
        for t in range(frames):
            slam(t, images[t], intr_fed, **(draws[t] if draws else {}))
        slam.refine(40)
        poses_c2w, tstamps = slam.terminate()
    finally:
        steps._run_update_net = orig
    if record is not None:
        record["oracle_calls"] = int(oracle.calls)
        record["oracle_traced"] = traced[0]
    gt_c2w = lie.se3_inv(torch.as_tensor(gt_w2c)).numpy()
    ate, _ = metrics.ate_rmse(poses_c2w, tstamps, gt_c2w,
                              np.arange(frames, dtype=float))
    return float(ate)


def run_sweep(params=None, frames=60, trials=2, levels=LEVELS,
              scenes=SCENES, log=print, device="cuda", draws=None,
              **run_kw):
    """{scene: {level: median ATE of the trials}}; params: the network as
    `DPVO` takes it; draws(slam_seed) and run_kw as `synth_suite`'s."""
    out = {}
    for sname, skw in scenes:
        row = {}
        for e in levels:
            runs = [synth_ate.run(params, frames=frames, slam_seed=s,
                                  focal_err=e, device=device,
                                  draws=draws(s) if draws else None,
                                  **skw, **run_kw)
                    for s in range(trials)]
            med = float(np.median([r["ate_rmse"] for r in runs]))
            row[f"{e:.2f}"] = med
            log(f"{sname:9s} focal_err {e:4.0%}: ATE median {med:.4f} "
                f"(floor {runs[0]['ate_floor_identity']:.3f})")
        out[sname] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default=None,
                    help="DPVO-layout .pth (default: weights from seed 0)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--oracle", action="store_true",
                    help="oracle-flow mode: isolates the geometric cost "
                         "of focal error (no network noise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    if args.oracle:
        table = {}
        for e in LEVELS:
            ates = [run_oracle(e, seed=s, device=args.device)
                    for s in range(args.trials)]
            table[f"{e:.2f}"] = float(np.median(ates))
            print(f"oracle focal_err {e:4.0%}: ATE median "
                  f"{table[f'{e:.2f}']:.4f}  (trials {ates})")
        out = {"metric": "calib_sensitivity_ate_oracle",
               "levels": list(LEVELS), "table": table}
        print(json.dumps(out))
        return out

    from ..models.convert import as_vonet

    params = as_vonet(args.network) if args.network else None
    table = run_sweep(params=params, frames=args.frames, trials=args.trials,
                      device=args.device)
    out = {"metric": "calib_sensitivity_ate", "levels": list(LEVELS),
           "params": args.network or "random", "table": table}
    print(json.dumps(out))
    if args.markdown:
        lines = ["| scene | " + " | ".join(f"{e:.0%}" for e in LEVELS)
                 + " |", "|---" * (len(LEVELS) + 1) + "|"]
        for s, row in table.items():
            lines.append("| " + s + " | " +
                         " | ".join(f"{row[f'{e:.2f}']:.4f}"
                                    for e in LEVELS) + " |")
        with open(args.markdown, "w") as f:
            f.write("\n".join(lines) + "\n")
    return out


if __name__ == "__main__":
    main()
