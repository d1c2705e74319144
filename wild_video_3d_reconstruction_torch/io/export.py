"""Trajectory export in TUM format.

Counterpart of the TUM writer and reader of the JAX package's
`io/export.py`. Poses are camera-to-world [N, 7] in the
(tx ty tz qx qy qz qw) layout that `DPVO.terminate` returns.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_trajectory_tum_format(poses_c2w, tstamps, filename):
    """One line per pose: `t x y z qx qy qz qw`."""
    with Path(filename).open("w") as f:
        for t, p in zip(tstamps, np.asarray(poses_c2w)):
            vals = " ".join(f"{v:.9f}" for v in p)
            f.write(f"{t} {vals}\n")
    return filename


def load_trajectory_tum_format(filename):
    data = np.loadtxt(filename, ndmin=2)
    return data[:, 1:8], data[:, 0]
