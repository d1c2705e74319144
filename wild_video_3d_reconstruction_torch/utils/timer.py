"""Wall-clock timing of named sections (the demo's `--timeit`) and traces.

Counterpart of the JAX package's `utils/timer.py`. A `Timer` section on
the card ends with `torch.cuda.synchronize` of the device its `sync`
tensor lies on (the JAX package fetches a value of it), so the time
covers the work the section queued; `start_profile` / `stop_profile`
trace through `torch.profiler` (the JAX package's `jax.profiler`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

_ALL_TIMES = defaultdict(list)
_PROFILE = {}


class Timer:
    def __init__(self, name, enabled=True, sync=None):
        """sync: a tensor, or a callable that returns one, whose device is
        synchronised before the section's time is taken."""
        self.name = name
        self.enabled = enabled
        self.sync = sync

    def __enter__(self):
        if self.enabled:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if self.sync is not None:
                target = self.sync() if callable(self.sync) else self.sync
                if target.is_cuda:
                    torch.cuda.synchronize(target.device)
            elapsed = 1000.0 * (time.perf_counter() - self.start)
            _ALL_TIMES[self.name].append(elapsed)
            print(f"{self.name} {elapsed:.2f}ms")


def timing_summary():
    """Print n, mean, median and total per section; returns the times."""
    for name, times in _ALL_TIMES.items():
        arr = np.asarray(times)
        print(f"[{name}] n={len(arr)} mean={arr.mean():.2f}ms "
              f"median={np.median(arr):.2f}ms total={arr.sum() / 1000:.2f}s")
    return dict(_ALL_TIMES)


def reset_timers():
    _ALL_TIMES.clear()


def start_profile(logdir="output/torch_trace"):
    """Start a `torch.profiler` trace of the host and, when there is a
    card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _PROFILE.update(prof=prof, logdir=logdir)
    return logdir


def stop_profile():
    """Stop the trace and write it as `trace.json` (Chrome trace format)
    under the directory start_profile was given; returns its path."""
    prof = _PROFILE.pop("prof")
    prof.stop()
    out = Path(_PROFILE.pop("logdir"))
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    return out / "trace.json"
