"""NeRF training over prepared clips (nerfstudio CLI orchestration).

The port's copy of the JAX package's `nerf/train.py`, itself the
reference's `nerf_train/nerf_train.py:11-86`: shells out to `ns-train
nerfacto` over prepared dataset clips. Without nerfstudio it trains the
in-repo field (`nerf/train_native.py`, on the card) or, with
native_fallback=False, says where the prepared data is.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path


def run_ns_train(data_path, max_iterations=30000, eval_mode="interval",
                 eval_interval=8, vis="tensorboard", method="nerfacto",
                 native_fallback=True, device="cuda"):
    """Run one `ns-train` job; returns True on success.

    When nerfstudio is not installed, trains the in-repo instant-NGP
    field (`nerf/train_native.py`, on `device`) on the same
    transforms.json data."""
    if shutil.which("ns-train") is None:
        if native_fallback:
            print("ns-train not found — training with the native NGP "
                  f"field on {data_path}.")
            from . import train_native
            images, c2ws, intrs, conv = \
                train_native.load_transforms(data_path)
            steps = min(max_iterations, 4000)
            train_native.train(images, c2ws, intrs, conv, steps=steps,
                               device=device)
            return True
        print("ns-train not found — install nerfstudio to train NeRFs. "
              f"Prepared data is ready at {data_path}.")
        return False
    command = [
        "ns-train", method,
        "--data", str(data_path),
        "--max-num-iterations", str(max_iterations),
        "--vis", vis,
        "nerfstudio-data",
        "--eval-mode", eval_mode,
        "--eval-interval", str(eval_interval),
    ]
    print("Running:", " ".join(command))
    proc = subprocess.run(command, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-2000:])
        print(proc.stderr[-2000:])
        return False
    return True


def train_clips(base_dir, pattern="**/transforms.json", **kwargs):
    """Batch training over prepared clip directories
    (`nerf_train/nerf_train.py:69-82`): trains every directory holding a
    transforms.json under `base_dir`, e.g. the `select_{s}_{e}/ours/`
    layout written by `prepare.prepare_clips`."""
    base_dir = Path(base_dir)
    results = {}
    for tf in sorted(base_dir.glob(pattern)):
        results[str(tf.parent.relative_to(base_dir))] = \
            run_ns_train(tf.parent, **kwargs)
    return results
