"""Where a steady-state frame's time goes, on one NVIDIA GPU.

    python -m wild_video_3d_reconstruction_torch.profile_frames \
        [--config configs/default.yaml] [--frames 40] [--out DIR] [--fused]
        [--graphs] [--network weights/vonet_synth_tpu_r3_step2000.pth]
        [--synth]

Drives DPVO on 384x512 synthetic frames (the drifting texture of
`chip_smoke.py`; with --synth the rendered wild input of
`eval/synth_ate.py:wild_sequence`, the world's depth as the prior and a
moving occluder's mask on every frame; the motion gate accepting every
frame) with the weights of --network (a DPVO-layout
`.pth`; none: drawn from seed 0) through warm-up, bootstrap and the first
steady frame, then measures the steady frames after it in passes:

* untimed by stages: the host clock over the frames with no
  synchronisation inside (`frame_ms`, `fps`);
* eager (`sync_mode=True`, the default here) only: stage times, the host
  clock around each stage of the synchronous step with a device
  synchronisation at both ends of the stage (so the stages add up to the
  frame and include the launch overhead of eager PyTorch);
* a torch.profiler trace of the same kind of frames without those
  synchronisations: device time by kernel, kernels per frame and the
  device's busy share of the traced wall time.

With --graphs the steady frames replay CUDA graphs (DPVO's default
path; the first steady frame captures them) and the untraced pass also
reports the gap the host leaves on the device between two replays
(`replay_gap_ms`, CUDA events around each replay: the end of one replay
to the start of the next, the next frame's input upload included).

Prints one JSON object per config (with the device time of every kernel
of the port's own `csrc/`, and per source file the device time its kernels
cover, overlapping kernels counted once) and, with --out, writes it there
with the top 25 kernels. --fused runs each config with `PALLAS_FUSED: true`
(the fused entry of the same correlation body, with the region spill
flags). Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .eval import synth_ate
from .slam import DPVO
from .slam import steps
from .slam.graphs import graph_label
from .utils.config import load_config

HT, WD = 384, 512
CSRC = Path(__file__).resolve().parent / "csrc"
STAGES = ("insert_frame", "append_edges", "update_op", "corr_lookup",
          "update_forward", "_bundle_adjust_impl", "flow_metric",
          "keyframe_shift", "retire_and_compact")


def synthetic_frames(n, seed=0):
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, size=(HT * 2, WD * 2, 3)).astype(np.uint8)
    return [big[4 * t % HT:4 * t % HT + HT, 6 * t % WD:6 * t % WD + WD].copy()
            for t in range(n)]


def port_kernel_sources():
    """{kernel function name: source file} of the port's own kernels, read
    from the `__global__` declarations of csrc/*.cu."""
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                      r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    return {name: src.name for src in sorted(CSRC.glob("*.cu"))
            for name in decl.findall(src.read_text())}


def port_kernel(key, sources):
    """The port kernel a profiler key names (its kernels live in an
    anonymous namespace at the top level), or None."""
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]", key)
    return m.group(1) if m and m.group(1) in sources else None


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms: kernels of one
    source that overlap on the device (a programmatic dependent launch)
    count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


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


def profile(config, n_frames, out_dir, fused=False, graphs=False,
            network=None, synth=False):
    if synth:
        frames, _, _, depths, masks = synth_ate.wild_sequence(
            0, frames=n_frames, ht=HT, wd=WD, fx=320.0, fy=320.0)
    else:
        frames = synthetic_frames(n_frames)
        depths = masks = [None] * n_frames
    cfg = load_config(config, MOTION_PROBE_THRESH=0.0, PALLAS_FUSED=fused)
    intr = np.array([320.0, 320.0, WD / 2, HT / 2])
    slam = DPVO(cfg, network, HT, WD, seed=0, device="cuda",
                sync_mode=not graphs)

    def track(i):
        slam(i, frames[i], intr, depth=depths[i], mask=masks[i])

    t = 0
    while not slam.is_initialized:
        track(t)
        t += 1
    track(t)                          # the first steady frame (captures)
    t += 1
    steady = n_frames - t
    n_pass = steady // (2 if graphs else 3)
    torch.cuda.synchronize()

    def run(first, count):
        t0 = time.perf_counter()
        for i in range(first, first + count):
            track(t + i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # pass 0: the host clock alone
    gaps0 = len(slam.runner.gaps_ms()) if graphs else 0
    wall0 = run(0, n_pass)
    gaps = slam.runner.gaps_ms()[gaps0:] if graphs else []
    done = n_pass

    # pass 1 (eager): synchronised stage times
    stage_ms, wall1 = None, None
    if not graphs:
        totals = defaultdict(float)
        with stage_timers(totals):
            wall1 = run(done, n_pass)
        stage_ms = {k: 1e3 * v / n_pass for k, v in totals.items()}
        stage_ms["other"] = 1e3 * wall1 / n_pass - sum(stage_ms.values())
        done += n_pass

    # pass 2: profiler trace, no synchronisation inside the frames
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n2 = steady - done
    with torch.profiler.profile(activities=acts) as prof:
        wall2 = run(done, n2)
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
    sources = port_kernel_sources()
    spans = defaultdict(list)
    for ev in prof.events():
        name = port_kernel(ev.name, sources)
        if ev.device_type == torch.autograd.DeviceType.CUDA and name:
            spans[sources[name]].append((ev.time_range.start,
                                         ev.time_range.end))
    frame_ms = 1e3 * wall2 / n2
    runner = slam.runner
    slam.terminate()                  # replays the event log: keyframes
    result = dict(
        config=config, fused=fused, variant=cfg.PALLAS_VARIANT, HxW=[HT, WD],
        patches=cfg.PATCHES_PER_FRAME, graphs=graphs,
        weights=network or "random, seed 0",
        input="wild: depth + mask" if synth else "drifting texture",
        device=torch.cuda.get_device_name(0),
        steady_frames_timed=n_pass, steady_frames_traced=n2,
        n_edges=int(slam.state.n_edges), keyframes=slam.n_host,
        keyframe_share_steady=1.0 - (len(slam.delta) - len(slam.parked))
        / (steady + 1),
        frame_ms=1e3 * wall0 / n_pass, fps=n_pass / wall0,
        replay_gap_ms_median=statistics.median(gaps) if gaps else None,
        replay_gap_ms_mean=statistics.mean(gaps) if gaps else None,
        replays_per_tier={graph_label(k): v
                          for k, v in runner.replays.items()},
        frame_ms_synchronised=1e3 * wall1 / n_pass if wall1 else None,
        stage_ms=stage_ms,
        frame_ms_traced=frame_ms, device_ms_per_frame=device_ms,
        device_busy_share=device_ms / frame_ms if frame_ms else None,
        kernels_per_frame=sum(k[2] for k in kernels),
        top_kernels=[dict(name=k[0][:120], ms_per_frame=k[1],
                          launches_per_frame=k[2]) for k in kernels[:25]],
        port_kernels=[dict(name=port_kernel(k[0], sources), ms_per_frame=k[1],
                           launches_per_frame=k[2]) for k in kernels
                      if port_kernel(k[0], sources)],
        port_busy_ms_per_frame={src: busy_ms(iv) / n2
                                for src, iv in sorted(spans.items())})
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(config))[0] + \
            ("_fused" if fused else "") + ("_synth" if synth else "") + \
            ("_graphs" if graphs else "_sync")
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
    parser.add_argument("--frames", type=int, default=40)
    parser.add_argument("--out", default=None,
                        help="directory for the full JSON (not written "
                             "without it)")
    parser.add_argument("--fused", action="store_true",
                        help="run with PALLAS_FUSED: true")
    parser.add_argument("--graphs", action="store_true",
                        help="steady frames through CUDA graph replay "
                             "(DPVO's default) instead of sync_mode")
    parser.add_argument("--network", default=None,
                        help="DPVO-layout .pth (default: weights drawn "
                             "from seed 0)")
    parser.add_argument("--synth", action="store_true",
                        help="the rendered wild input with depth and mask "
                             "instead of the drifting texture")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for config in args.config or ["configs/default.yaml",
                                  "configs/fast.yaml"]:
        profile(config, args.frames, args.out, fused=args.fused,
                graphs=args.graphs, network=args.network, synth=args.synth)


if __name__ == "__main__":
    main()
