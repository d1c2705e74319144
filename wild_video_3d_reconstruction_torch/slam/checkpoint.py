"""Save a SLAM run between two frames and resume it.

Counterpart of the JAX package's `slam/checkpoint.py`. The device state
is one set of fixed-shape tensors (`slam/state.py`), so a checkpoint is
one `torch.save` of them (the counters `state.counts` and the event log
`state.log` included), the state of the CPU generator the patch draws
come from (`steps.draw_inputs`), and the host bookkeeping of `DPVO`. A
run resumed from it continues bit for bit: the same draws, the same
state. The graphs of the steady step are not saved; the resumed run
captures them again at its first steady frame.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

FILE = "slam.pt"

# DPVO's host bookkeeping: the attributes that the next frame and
# terminate read
HOST = ("counter", "tlist", "n_host", "parked", "is_initialized",
        "_init_counter", "_events_dispatched", "_events_consumed")


def save_slam(slam, path):
    """Write the run of `slam` (a DPVO) to the directory `path`, after
    dispatching its staged frames."""
    slam._flush_pending()
    state = {f.name: getattr(slam.state, f.name).cpu()
             for f in dataclasses.fields(slam.state) if f.name != "rng"}
    host = {k: getattr(slam, k) for k in HOST}
    host["tlist"] = [float(t) for t in slam.tlist]
    host["parked"] = [int(t) for t in slam.parked]
    host["tstamps"] = torch.from_numpy(slam.tstamps.copy())
    host["delta"] = {int(t): (int(t0), torch.as_tensor(dP).float().cpu())
                     for t, (t0, dP) in slam.delta.items()}
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    torch.save({"state": state, "rng": slam.state.rng.get_state(),
                "host": host}, p / FILE)
    return p / FILE


def load_slam(slam, path):
    """Restore the run saved in `path` into `slam`, a DPVO built with the
    same config and image size that has seen no frame. Returns slam."""
    data = torch.load(Path(path) / FILE, map_location="cpu",
                      weights_only=True)
    for name, saved in data["state"].items():
        dst = getattr(slam.state, name)
        if dst.shape != saved.shape or dst.dtype != saved.dtype:
            raise ValueError(
                f"checkpoint {path}: state.{name} is {tuple(saved.shape)} "
                f"{saved.dtype}, this run's {tuple(dst.shape)} {dst.dtype}: "
                "not the same config and image size")
        dst.copy_(saved)
    slam.state.rng.set_state(data["rng"])
    host = data["host"]
    for k in HOST:
        setattr(slam, k, host[k])
    slam.tstamps = host["tstamps"].numpy().astype(np.int64)
    slam.delta = {t: (t0, dP) for t, (t0, dP) in host["delta"].items()}
    slam._pending, slam._pending_sig = [], None
    slam.runner.invalidate()
    return slam
