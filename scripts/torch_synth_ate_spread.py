"""How far rounding alone moves the synthetic ATE of the port, on the CPU.

    python scripts/torch_synth_ate_spread.py [--frames 60] [--device cpu]

Runs `eval/synth_ate.run` (48x64, the seed-0 walk, the trained weights
`weights/vonet_synth_tpu_r3_step2000.pth`, the same draws: torch seed 0)
once per (feature precision, CPU threads) pair: bf16 (the protocol) and
fp32 features, 1, 2, 3 and 6 threads. Only the order of the sums
changes between threads, only the rounding of the features between
precisions; the spread of the ATE over these runs is what `chip_smoke.py`
may expect between the card and the CPU (`TOL_ATE_CARD_CPU`). One JSON
line per run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wild_video_3d_reconstruction_torch.eval import synth_ate  # noqa: E402

WEIGHTS = str(ROOT / "weights" / "vonet_synth_tpu_r3_step2000.pth")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 3, 6])
    ap.add_argument("--precision", nargs="+", default=["bf16", "fp32"])
    args = ap.parse_args(argv)
    for precision in args.precision:
        for threads in args.threads:
            torch.set_num_threads(threads)
            t0 = time.perf_counter()
            r = synth_ate.run(WEIGHTS, frames=args.frames, device="cpu",
                              cfg_overrides=dict(
                                  MIXED_PRECISION=precision == "bf16"))
            r.pop("poses")
            print(json.dumps(dict(r, precision=precision, threads=threads,
                                  seconds=time.perf_counter() - t0)),
                  flush=True)


if __name__ == "__main__":
    main()
