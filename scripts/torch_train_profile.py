"""Where a training step's time goes on the card.

    python scripts/torch_train_profile.py [--steps 5] [--full]

Runs the one-device training step of the PyTorch port
(`parallel/train_step.py:build_train_step`) from a seed-0 VONet on
`make_world_batch` clips: `eval/learn_synth.py`'s recipe by default
(TrainConfig(6, 8, 3), batch 4, 48x64), with --full `trainer.train`'s
TrainConfig(8, 32, 8), batch 4, on 384x512 clips of `render_clip`
(fx = fy = 320). Three warm-up steps, then --steps timed steps (host clock
around synchronised steps), then `torch.profiler` over two steps: the
kernel launches (`cudaLaunchKernel` calls), the device time (the CUDA self
time of every kernel) and the ops that take the most host time. Prints
the card's name and power limit, then one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wild_video_3d_reconstruction_torch.models.vonet import init_vonet
    from wild_video_3d_reconstruction_torch.parallel import train_step as tts
    from wild_video_3d_reconstruction_torch.train.forward import TrainConfig
    from wild_video_3d_reconstruction_torch.train.synth import (
        make_world_batch, render_clip)

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.full:
        tc, ht, wd = TrainConfig(frames=8, patches=32, steps=8), 384, 512
        rng = np.random.default_rng(0)
        clips = [render_clip(rng, frames=8, ht=ht, wd=wd, fx=320.0,
                             fy=320.0) for _ in range(4)]
        batch = {k: np.stack([c[i] for c in clips]) for i, k in enumerate(
            ("images", "poses", "disps", "intrinsics"))}
    else:
        tc, ht, wd = TrainConfig(frames=6, patches=8, steps=3), 48, 64
        batch = make_world_batch(0, 4, tc, ht=ht, wd=wd)
    net = init_vonet(0).to(dev)
    step = tts.build_train_step(net, tc, tts.make_optimizer(
        net.parameters(), lr=3e-4, steps=100), dev)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        step(batch, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(batch, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    host_ms = sum(e.self_cpu_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:10]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": tc._asdict(), "batch": 4, "HxW": [ht, wd],
        "ms_per_step": times, "ms_per_step_median": float(np.median(times)),
        "profiled_steps": 2, "launches_per_step": launches / 2,
        "device_ms_per_step": device_ms / 2,
        "host_self_ms_per_step": host_ms / 2,
        "top_host_ops": [[e.key, e.count / 2, e.self_cpu_time_total / 2e3]
                         for e in top]}), flush=True)


if __name__ == "__main__":
    main()
