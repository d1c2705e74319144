"""What the loop closure measures and does on the two-lap world, per
triplet stride (LOOP_KP_STRIDE).

    python scripts/torch_loop_stride.py [--strides 1 2 4] [--frames 96]
        [--device cuda|cpu] [--out FILE]

Renders `train/synth.py:render_sequence(0, path="multiloop")` at 384x512
(fx = 320; two laps, frame t and t + lap and, inside a lap, t and lap - t
at one waypoint, so a closure's true relative pose is the identity up to
the map's scale drift) and tracks it with the port's DPVO at
configs/default.yaml with the trained weights, every frame kept, as
`chip_smoke.py`'s `loop_multilap` does: once with the loop closure off,
then once per stride with it on (VLAD centres fitted on 24 frames,
replayed as CUDA graphs on the card, eagerly on the CPU). Prints one JSON
line per run: the revisit gap over lap pairs, the Sim(3) ATE and its
identity floor, each candidate's outcome and each fitted Sim3 (inliers,
scale, |t|, rotation): the farther the fit from the identity, the more a
closure moves a trajectory that was right.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wild_video_3d_reconstruction_torch.eval import synth_ate  # noqa: E402
from wild_video_3d_reconstruction_torch.eval.loop_ate import \
    revisit_gap_lap  # noqa: E402
from wild_video_3d_reconstruction_torch.loop.netvlad import (  # noqa: E402
    VLADDescriptor, fit_centers_from_images)
from wild_video_3d_reconstruction_torch.models.convert import \
    load_reference_checkpoint  # noqa: E402
from wild_video_3d_reconstruction_torch.slam import DPVO  # noqa: E402
from wild_video_3d_reconstruction_torch.train.synth import \
    render_sequence  # noqa: E402
from wild_video_3d_reconstruction_torch.utils.config import \
    load_config  # noqa: E402

WEIGHTS = str(ROOT / "weights" / "vonet_synth_tpu_r3_step2000.pth")
HT, WD = 384, 512


def run(images, poses_gt, intr, net, vlad, stride, lap, device):
    loop = stride is not None
    cfg = load_config(
        str(ROOT / "configs" / "default.yaml"), KEYFRAME_THRESH=0.0,
        BUFFER_SIZE=len(images) + 8, MOTION_PROBE_THRESH=0.0,
        loop_enabled=loop, LC_INTERVAL=8, LOOP_CLOSE_WINDOW_SIZE=1,
        LOOP_RETR_THRESH=0.8, LOOP_SKIP_WINDOW=lap // 2,
        LOOP_KP_STRIDE=stride or 1)
    slam = DPVO(cfg, net, HT, WD, seed=0, device=device, vlad=vlad)
    t0 = time.perf_counter()
    for t, img in enumerate(images):
        slam(t, img, intr)
    poses, tstamps = slam.terminate()
    ate, _, floor = synth_ate.ate_against(poses, tstamps, poses_gt)
    lc = slam.loop_closure
    return dict(loop=loop, kp_stride=stride, seconds=time.perf_counter() - t0,
                revisit_gap_lap=revisit_gap_lap(poses, tstamps, lap),
                ate_rmse=ate, ate_floor_identity=floor,
                events=[list(e) for e in lc.events] if lc else [],
                measured_sim3=lc.measured if lc else [])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strides", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    t0 = time.perf_counter()
    images, poses_gt, intr = render_sequence(
        0, frames=args.frames, ht=HT, wd=WD, fx=320.0, fy=320.0,
        path="multiloop", n_planes=3)
    render_s = time.perf_counter() - t0
    lap = args.frames // 2
    net = load_reference_checkpoint(WEIGHTS, device=args.device)
    step = args.frames / 24
    vlad = VLADDescriptor(centers=fit_centers_from_images(
        net, [images[int(i * step)] for i in range(24)]))
    head = dict(device=args.device, frames=args.frames, render_s=render_s)
    if args.device != "cpu":
        import subprocess
        head["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        head["card"] = torch.cuda.get_device_name(0)
    lines = [json.dumps(head)]
    print(lines[-1], flush=True)
    for stride in [None] + args.strides:
        lines.append(json.dumps(run(images, poses_gt, intr, net, vlad,
                                    stride, lap, args.device)))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
