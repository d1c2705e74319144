"""Held-out learn_synth errors of the trained checkpoint, JAX and port.

    JAX_PLATFORMS=cpu python scripts/torch_learn_synth_checkpoint.py

Evaluates the checkpoint `checkpoints/synth_tpu_r3_step2000` (orbax,
restored as `scripts/torch_export_weights.py` restores it) with the JAX
package's `eval/learn_synth.py:evaluate`, and its `.pth` export
`weights/vonet_synth_tpu_r3_step2000.pth` with the port's `evaluate` on
the CPU, on the same held-out clips (`make_world_batch(10_000 + i)`, the
learn_synth defaults: 8 clips, 6 frames, 8 patches, 3 steps, 48x64).
The two packages draw their patches, depths and dropout differently
(ROADMAP R18), so the two readings are two draws of one protocol, not a
parity check. Prints one JSON line. It imports the JAX package, so it
lives here and not in the port; `chip_smoke.py` prints the JAX reading
beside the card's (`JAX_CHECKPOINT_EPE`).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

WEIGHTS = ROOT / "weights" / "vonet_synth_tpu_r3_step2000.pth"


def main():
    from torch_export_weights import restore

    from wild_video_3d_reconstruction_torch.eval import learn_synth as tls
    from wild_video_3d_reconstruction_torch.models.convert import \
        load_reference_checkpoint
    from wild_video_3d_reconstruction_torch.train.forward import \
        TrainConfig as TTC
    from wild_video_3d_reconstruction_tpu.eval import learn_synth as jls
    from wild_video_3d_reconstruction_tpu.train.forward import \
        TrainConfig as JTC
    from wild_video_3d_reconstruction_tpu.train.synth import \
        make_world_batch

    jtc = JTC(frames=6, patches=8, steps=3)
    held_out = [make_world_batch(10_000 + i, 1, jtc) for i in range(8)]
    t0 = time.perf_counter()
    jax_res = jls.evaluate(restore(), held_out, jtc)
    t1 = time.perf_counter()
    port_res = tls.evaluate(load_reference_checkpoint(WEIGHTS), held_out,
                            TTC(frames=6, patches=8, steps=3), "cpu")
    t2 = time.perf_counter()
    print(json.dumps({"jax": jax_res, "port_cpu": port_res,
                      "jax_s": t1 - t0, "port_s": t2 - t1}))


if __name__ == "__main__":
    main()
