"""Export the trained VONet checkpoint as a PyTorch `.pth` for the port.

    JAX_PLATFORMS=cpu python scripts/torch_export_weights.py   # repo root

Restores the orbax checkpoint `checkpoints/synth_tpu_r3_step2000` (the
JAX package's `train.trainer.load_checkpoint`, against the tree of
`init_vonet(PRNGKey(0))`) and writes it in the DPVO `.pth` layout with
`train.trainer.export_torch_checkpoint` to
`weights/vonet_synth_tpu_r3_step2000.pth`, which the port loads with
`DPVO(cfg, network=<path>)` (`models.convert.load_reference_checkpoint`).
It imports the JAX package, so it lives here and not in the port. Prints
one JSON line: the file, its size, the tensor and parameter counts.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHECKPOINT = ROOT / "checkpoints" / "synth_tpu_r3_step2000"
OUT = ROOT / "weights" / "vonet_synth_tpu_r3_step2000.pth"


def restore(checkpoint=CHECKPOINT):
    """The checkpoint's parameter tree (jax arrays)."""
    import jax

    from wild_video_3d_reconstruction_tpu.models.vonet import init_vonet
    from wild_video_3d_reconstruction_tpu.train.trainer import \
        load_checkpoint

    return load_checkpoint(str(checkpoint), init_vonet(jax.random.PRNGKey(0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=str(CHECKPOINT))
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from wild_video_3d_reconstruction_tpu.train.trainer import \
        export_torch_checkpoint

    params = restore(args.checkpoint)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    export_torch_checkpoint(params, str(out))
    leaves = jax.tree.leaves(params)
    print(json.dumps({"out": str(out.relative_to(ROOT)) if out.is_relative_to(
        ROOT) else str(out), "bytes": out.stat().st_size,
        "tensors": len(leaves),
        "parameters": int(sum(np.asarray(x).size for x in leaves))}))


if __name__ == "__main__":
    main()
