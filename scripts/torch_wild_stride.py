"""Choose the wild scene that keeps keyframes: its stride and seed.

    python scripts/torch_wild_stride.py [--strides 4 6 8] [--seeds 0]
        [--frames 40] [--device cpu|cuda] [--workers N] [--global-ba]
        [--keyframe-thresh T [T ...]] [--out FILE]

For each seed and stride s, renders
`eval/synth_ate.py:wild_sequence(seed, stride=s)` at 384x512 (fx = 320;
`--workers` scenes at a time in processes of their own) and tracks it
with the port's DPVO at configs/default.yaml with the trained weights,
the world's depth as the prior and the occluder's mask on every frame,
with the shipped motion probe threshold unless `--probe-thresh` sets
another; on the CPU through the card's edge tiers (exact: dead rows are
inert), on the card replayed as CUDA graphs. `--global-ba` runs it as
`chip_smoke.py`'s `slam_default_wild_keep` does (ENABLE_GLOBAL_BA, a
64-frame buffer) and adds the ATE after global BA. `--keyframe-thresh`
tracks each scene once per KEYFRAME_THRESH given (default: the
config's): a scene that still keeps a frame at a threshold above the
shipped one keeps one whatever rounding moves its flow metric by less
than that margin (a frame dropped instead is followed by a larger
metric, the anchor frame unchanged).
Prints first the flow metric's quantity from the ground truth (the
world's depth and poses) between input frames k and k + 2, what a
tracker that kept every frame would measure; then, per steady frame, the
flow metric over 2 against KEYFRAME_THRESH (the decision: keep at or
above it), the live edges and the tier of `steps.edge_tiers` on the card
that the next frame takes; then one JSON line per scene with the probe's
median flow delta per warm-up frame, the keyframe share, the flow metric
of each kept frame and the largest of a dropped one, the tiers and the
ATE. `--out` sends the per-frame lines to a file instead.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wild_video_3d_reconstruction_torch.eval import synth_ate  # noqa: E402
from wild_video_3d_reconstruction_torch.slam import DPVO, steps  # noqa: E402
from wild_video_3d_reconstruction_torch.slam.state import \
    edge_rows  # noqa: E402
from wild_video_3d_reconstruction_torch.utils.config import \
    load_config  # noqa: E402

WEIGHTS = str(ROOT / "weights" / "vonet_synth_tpu_r3_step2000.pth")
HT, WD = 384, 512


def gt_flow(poses_w2c, depths, intr, a, b):
    """The flow metric's quantity from the ground truth: the mean over a
    grid of pixels of frame a of 0.5 * |full flow| + 0.5 * |flow of the
    relative translation alone| into frame b, in 1/4-resolution pixels
    (the world's depth; NaN where a point falls behind frame b)."""
    fx, fy, cx, cy = np.asarray(intr, np.float64)
    v, u = np.mgrid[2:HT:16, 2:WD:16].astype(np.float64)
    z = depths[a][2:HT:16, 2:WD:16].astype(np.float64)
    Xa = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    Ra = synth_ate._rotation(poses_w2c[a, 3:])
    Rb = synth_ate._rotation(poses_w2c[b, 3:])
    ta, tb = poses_w2c[a, :3].astype(np.float64), \
        poses_w2c[b, :3].astype(np.float64)
    Rab = Rb @ Ra.T
    tab = tb - Rab @ ta

    def pix(X):
        return np.stack([fx * X[..., 0] / X[..., 2] + cx,
                         fy * X[..., 1] / X[..., 2] + cy], -1) / 4

    p0, p1, p2 = pix(Xa), pix(Xa @ Rab.T + tab), pix(Xa + tab)
    f = 0.5 * np.linalg.norm(p1 - p0, axis=-1) + \
        0.5 * np.linalg.norm(p2 - p0, axis=-1)
    return float(np.mean(np.where((Xa @ Rab.T + tab)[..., 2] > 0.2, f,
                                  np.nan)))


def render(seed, stride, frames):
    t0 = time.perf_counter()
    scene = synth_ate.wild_sequence(seed, frames=frames, ht=HT, wd=WD,
                                    fx=320.0, fy=320.0, stride=stride)
    return scene, time.perf_counter() - t0


def track(seed, stride, frames, cfg, scene, render_s, device, log):
    t0 = time.perf_counter()
    images, poses_gt, intr, depths, masks = scene
    # what a tracker that kept every frame would measure: frames k, k + 2
    gt = [0.5 * (gt_flow(poses_gt, depths, intr, k, k + 2) +
                 gt_flow(poses_gt, depths, intr, k + 2, k))
          for k in range(frames - 2)]
    log(dict(seed=seed, stride=stride, keyframe_thresh=cfg.KEYFRAME_THRESH,
             gt_flow_over_2_frames_k_k2=gt))
    slam = DPVO(cfg, WEIGHTS, HT, WD, device=device)
    probes = []
    probe = steps.motion_probe

    def recorded(*a):
        v = probe(*a)
        probes.append(float(v))
        return v

    steps.motion_probe = recorded
    tiers = steps.edge_tiers(cfg, edge_rows(cfg), "cuda")
    per_frame = []
    try:
        for t in range(frames):
            slam(t, images[t], intr, depth=depths[t], mask=masks[t])
            if slam.is_initialized and slam._init_counter <= t:
                row = slam.state.log[int(slam.state.log_idx) - 1]
                ne = int(slam.state.n_edges)
                # the tier the next frame takes: live edges plus one append
                f = dict(seed=seed, stride=stride,
                         keyframe_thresh=cfg.KEYFRAME_THRESH, frame=t,
                         flow_over_2=float(row[8]) / 2,
                         kept=bool(row[0] < 0.5), live_edges=ne,
                         tier_next=steps.choose_tier(
                             tiers, ne + steps.appended_rows(cfg)),
                         seconds=time.perf_counter() - t0)
                per_frame.append(f)
                log(f)
    finally:
        steps.motion_probe = probe
    poses, tstamps = slam.trajectory()
    ate, _, floor = synth_ate.ate_against(poses, tstamps, poses_gt)
    poses, tstamps = slam.terminate()
    ate_gba = synth_ate.ate_against(poses, tstamps, poses_gt)[0] \
        if cfg.ENABLE_GLOBAL_BA else None
    kept = [f["flow_over_2"] for f in per_frame if f["kept"]]
    dropped = [f["flow_over_2"] for f in per_frame if not f["kept"]]
    out = dict(seed=seed, stride=stride, frames=frames, device=device,
               render_s=render_s, track_s=time.perf_counter() - t0,
               probe_per_warmup_frame=probes,
               probe_thresh=cfg.MOTION_PROBE_THRESH, parked=len(slam.parked),
               steady_frames=len(per_frame), kept=len(kept),
               keyframe_share_steady=len(kept) / max(len(per_frame), 1),
               kept_frames=[f["frame"] for f in per_frame if f["kept"]],
               flow_over_2_kept=kept,
               flow_over_2_dropped_max=max(dropped, default=None),
               keyframe_thresh=cfg.KEYFRAME_THRESH, tiers_on_card=tiers,
               tier_frames={str(t): sum(f["tier_next"] == t
                                        for f in per_frame) for t in tiers},
               ate=ate, ate_after_global_ba=ate_gba, ate_floor=floor)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    steps.TIER_ON_CPU = True
    ap = argparse.ArgumentParser()
    ap.add_argument("--strides", type=int, nargs="+", default=[4, 6, 8])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--workers", type=int, default=1,
                    help="scenes rendered at a time, each in its process")
    ap.add_argument("--global-ba", action="store_true",
                    help="ENABLE_GLOBAL_BA with a 64-frame buffer")
    ap.add_argument("--keyframe-thresh", type=float, nargs="+", default=None,
                    help="KEYFRAME_THRESH values (default: the config's)")
    ap.add_argument("--probe-thresh", type=float, default=None,
                    help="MOTION_PROBE_THRESH (default: the config's)")
    ap.add_argument("--out", default=None,
                    help="file for the per-frame lines (default: stdout)")
    args = ap.parse_args(argv)
    opts = {}
    if args.probe_thresh is not None:
        opts["MOTION_PROBE_THRESH"] = args.probe_thresh
    if args.global_ba:
        opts.update(ENABLE_GLOBAL_BA=True, BUFFER_SIZE=64)
    cfg = load_config("configs/default.yaml", **opts)
    scenes = [(seed, s) for seed in args.seeds for s in args.strides]
    sink = open(args.out, "a") if args.out else sys.stdout

    def log(d):
        sink.write(json.dumps(d) + "\n")
        sink.flush()

    # the renders run in processes forked before the card is touched
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(max(args.workers, 1)) as pool:
        rendered = [pool.apply_async(render, (seed, s, args.frames))
                    for seed, s in scenes]
        for (seed, s), r in zip(scenes, rendered):
            scene, render_s = r.get()
            for th in args.keyframe_thresh or [cfg.KEYFRAME_THRESH]:
                track(seed, s, args.frames,
                      cfg.merge_from_dict({"KEYFRAME_THRESH": th}), scene,
                      render_s, args.device, log)
    if args.out:
        sink.close()


if __name__ == "__main__":
    main()
