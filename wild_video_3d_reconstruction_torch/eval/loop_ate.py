"""The loop closure's effect on a trajectory: the revisit gap with the
loop closure off and on.

Counterpart of the JAX package's `eval/loop_ate.py`. On an out-and-back
sequence frames t and T - t see the same view, and on a multi-lap world
frames t and t - lap_len do: a drift-free trajectory puts each such pair
at one position. The revisit gap (`revisit_gap`, `revisit_gap_lap`) is
the median distance between the pairs over the trajectory's extent;
closures should shrink it. Worlds: a 2-D pan over a random texture
(`build_frames`), or rendered (`train/synth.py:render_sequence`,
"outback" with --render, "multiloop" with --multiloop).

    python -m wild_video_3d_reconstruction_torch.eval.loop_ate \\
        [--frames 48] [--size 96 128] [--render | --multiloop] \\
        [--network weights/vonet_synth_tpu_r3_step2000.pth] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_frames(T, shift, ht, wd, seed=0):
    """T frames panning over a random texture, out for T/2 frames and
    back: frame t and T - t are the same crop."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 255, size=(ht + 8, wd + shift * (T // 2) + 8, 3),
                       dtype=np.uint8)
    frames = []
    for t in range(T):
        k = t if t < T // 2 else T - t
        frames.append(np.ascontiguousarray(big[:ht, shift * k:
                                               shift * k + wd]))
    return frames


def revisit_gap(poses, tstamps, T):
    """Median ||p(t) - p(T - t)|| / extent over the revisit pairs."""
    tmap = {int(t): p for p, t in zip(poses, tstamps)}
    gaps = []
    for t in range(T // 2 + 2, T):
        a, b = tmap.get(t), tmap.get(T - t)
        if a is None or b is None:
            continue
        gaps.append(np.linalg.norm(a[:3] - b[:3]))
    extent = max(np.linalg.norm(poses[:, :3], axis=1).max(), 1e-9)
    return float(np.median(gaps) / extent) if gaps else float("nan")


def revisit_gap_lap(poses, tstamps, lap_len):
    """Median ||p(t) - p(t - lap_len)|| / extent (multi-lap worlds: frames
    t and t - lap_len share one waypoint)."""
    tmap = {int(t): p for p, t in zip(poses, tstamps)}
    gaps = []
    for t in sorted(tmap):
        a, b = tmap.get(t), tmap.get(t - lap_len)
        if a is None or b is None:
            continue
        gaps.append(np.linalg.norm(a[:3] - b[:3]))
    extent = max(np.linalg.norm(poses[:, :3], axis=1).max(), 1e-9)
    return float(np.median(gaps) / extent) if gaps else float("nan")


def run(frames, intr, ht, wd, loop, lc_kw, network=None, cfg_kw=None,
        device="cuda", vlad=None):
    """One run keeping every frame (KEYFRAME_THRESH 0, the motion probe
    off, 8 patches a frame as the JAX package's driver); returns (poses
    c2w, tstamps, (closures applied, closures consistent))."""
    from ..slam import DPVO
    from ..utils.config import load_config

    cfg = load_config(None, BUFFER_SIZE=len(frames) + 8, loop_enabled=loop,
                      PATCHES_PER_FRAME=8, KEYFRAME_THRESH=0.0,
                      MOTION_PROBE_THRESH=-1.0, **(cfg_kw or {}),
                      **(lc_kw if loop else {}))
    slam = DPVO(cfg, network, ht, wd, seed=0, device=device, vlad=vlad)
    for t, img in enumerate(frames):
        slam(t, img, intr)
    poses, tstamps = slam.terminate()
    lc = slam.loop_closure
    return poses, tstamps, (lc.lc_count, lc.lc_consistent) if lc else (0, 0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--shift", type=int, default=10)
    ap.add_argument("--size", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--retr-thresh", type=float, default=0.8)
    ap.add_argument("--render", action="store_true",
                    help="the rendered out-and-back world instead of the "
                         "2-D pan")
    ap.add_argument("--multiloop", action="store_true",
                    help="the rendered multi-lap world (frames // 125 laps, "
                         "at least 2), gap over lap revisits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="world seeds from --seed on; medians over them")
    ap.add_argument("--network", type=str, default=None,
                    help="a DPVO .pth checkpoint (default: weights from a "
                         "seed)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    ht, wd = args.size
    # the skip window: retrieval ignores the smooth neighbourhood
    skip = args.frames // 2 - 4 if args.render else max(8, args.frames // 5)
    lc_kw = {"LOOP_RETR_THRESH": args.retr_thresh,
             "LOOP_CLOSE_WINDOW_SIZE": 1, "LC_INTERVAL": 8,
             "LOOP_SKIP_WINDOW": skip}
    if args.multiloop:
        laps = max(args.frames // 125, 2)
        lap_len = args.frames // laps
        lc_kw["LOOP_SKIP_WINDOW"] = lap_len // 2

    rows = []
    for seed in range(args.seed, args.seed + args.seeds):
        cfg_kw = {}
        if args.render or args.multiloop:
            from ..train.synth import render_sequence
            images, _, intr4 = render_sequence(
                seed, frames=args.frames, ht=ht, wd=wd,
                path="multiloop" if args.multiloop else "outback",
                n_planes=3)
            frames = [images[t] for t in range(args.frames)]
            intr = np.asarray(intr4, np.float64)
            # small rendered frames: fewer inliers, a wider triplet
            cfg_kw = {"DEPTH_INIT": "median", "MEM": 16,
                      "LOOP_MIN_INLIERS": 12, "LOOP_KP_STRIDE": 4}
        else:
            frames = build_frames(args.frames, args.shift, ht, wd, seed=seed)
            intr = np.array([wd * 0.8, wd * 0.8, wd / 2, ht / 2])

        def gap(p, t):
            return revisit_gap_lap(p, t, lap_len) if args.multiloop else \
                revisit_gap(p, t, args.frames)

        p0, t0, _ = run(frames, intr, ht, wd, False, {},
                        network=args.network, cfg_kw=cfg_kw,
                        device=args.device)
        p1, t1, n_lc = run(frames, intr, ht, wd, True, lc_kw,
                           network=args.network, cfg_kw=cfg_kw,
                           device=args.device)
        rows.append({"seed": seed, "no_loop": gap(p0, t0),
                     "with_loop": gap(p1, t1),
                     "closures_applied": int(n_lc[0]),
                     "closures_consistent": int(n_lc[1])})
        print(json.dumps({"metric": "revisit_gap_seed", **rows[-1]}),
              flush=True)

    g0 = float(np.median([r["no_loop"] for r in rows]))
    g1 = float(np.median([r["with_loop"] for r in rows]))
    print(json.dumps({
        "metric": "revisit_gap_median_rel", "device": args.device,
        "render": bool(args.render), "multiloop": bool(args.multiloop),
        "no_loop": g0, "with_loop": g1,
        "closures_applied": sum(r["closures_applied"] for r in rows),
        "improvement": g0 - g1, "seeds": len(rows)}))


if __name__ == "__main__":
    main()
