"""Where a steady-state frame's time goes, on one NVIDIA GPU.

    python -m wild_video_3d_reconstruction_torch.profile_frames \
        [--config configs/default.yaml] [--frames 24] [--out DIR]

Drives DPVO on 384x512 synthetic frames (the drifting texture of
`chip_smoke.py`, weights drawn from seed 0, the motion gate accepting
every frame) through warm-up and bootstrap, then measures steady-state
frames two ways:

* stage times: the host clock around each stage of `frame_step`, with a
  device synchronisation at both ends of the stage (so the stages add up
  to the frame and include the launch overhead of eager PyTorch);
* a torch.profiler trace of the same frames without those
  synchronisations: device time by kernel, and the device's busy share of
  the traced wall time.

Prints one JSON object per config and, with --out, writes it there with
the top 25 kernels. Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from .slam import DPVO
from .slam import steps
from .utils.config import load_config

HT, WD = 384, 512
STAGES = ("insert_frame", "append_edges", "update_op", "corr_lookup",
          "update_forward", "_bundle_adjust_impl", "keyframe_and_log")


def synthetic_frames(n, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, size=(HT * 2, WD * 2, 3)).astype(np.uint8)
    return [big[4 * t % HT:4 * t % HT + HT, 6 * t % WD:6 * t % WD + WD].copy()
            for t in range(n)]


@contextlib.contextmanager
def stage_timers(totals):
    """Wrap the steps' stage functions with synchronised host timers;
    nested stages are subtracted from the stage around them."""
    saved = {name: getattr(steps, name) for name in STAGES}
    stack = []

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            stack.append(0.0)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            inner = stack.pop()
            totals[name] += dt - inner
            if stack:
                stack[-1] += dt
            return out
        return timed

    for name, fn in saved.items():
        setattr(steps, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(steps, name, fn)


def profile(config, n_frames, out_dir):
    cfg = load_config(config, MOTION_PROBE_THRESH=0.0)
    frames = synthetic_frames(n_frames)
    intr = np.array([320.0, 320.0, WD / 2, HT / 2])
    slam = DPVO(cfg, None, HT, WD, seed=0, device="cuda")
    t = 0
    while not slam.is_initialized:
        slam(t, frames[t], intr)
        t += 1
    steady = frames[t:]
    half = len(steady) // 2
    torch.cuda.synchronize()

    # pass 1: synchronised stage times
    totals = defaultdict(float)
    with stage_timers(totals):
        t0 = time.perf_counter()
        for i, img in enumerate(steady[:half]):
            slam(t + i, img, intr)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    n1 = half
    stage_ms = {k: 1e3 * v / n1 for k, v in totals.items()}
    stage_ms["other"] = 1e3 * wall1 / n1 - sum(stage_ms.values())

    # pass 2: profiler trace, no synchronisation inside the frames
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n2 = len(steady) - half
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i, img in enumerate(steady[half:]):
            slam(t + half + i, img, intr)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    # device-side events only: the CPU-side aten ops carry the device time
    # of the kernels they launch as well, which would count it twice
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        kernels.append((ev.key, dev_us / 1e3 / n2, ev.count / n2))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    frame_ms = 1e3 * wall2 / n2
    result = dict(
        config=config, HxW=[HT, WD], patches=cfg.PATCHES_PER_FRAME,
        device=torch.cuda.get_device_name(0),
        steady_frames_timed=n1, steady_frames_traced=n2,
        n_edges=slam.state.n_edges,
        frame_ms_synchronised=1e3 * wall1 / n1, stage_ms=stage_ms,
        frame_ms_traced=frame_ms, device_ms_per_frame=device_ms,
        device_busy_share=device_ms / frame_ms if frame_ms else None,
        kernels_per_frame=sum(k[2] for k in kernels),
        top_kernels=[dict(name=k[0][:120], ms_per_frame=k[1],
                          launches_per_frame=k[2]) for k in kernels[:25]])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(config))[0]
        with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
            json.dump(result, f, indent=1)
    short = {k: v for k, v in result.items() if k != "top_kernels"}
    short["top_kernels"] = result["top_kernels"][:8]
    print(json.dumps(short), flush=True)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", action="append",
                        help="config file(s); default.yaml and fast.yaml "
                             "when none is given")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--out", default=None,
                        help="directory for the full JSON (not written "
                             "without it)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for config in args.config or ["configs/default.yaml",
                                  "configs/fast.yaml"]:
        profile(config, args.frames, args.out)


if __name__ == "__main__":
    main()
