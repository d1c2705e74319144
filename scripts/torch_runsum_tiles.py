"""Tile and load depth of the port's run-sum kernel, measured on one card.

    python scripts/torch_runsum_tiles.py      # from the repository root

`wild_video_3d_reconstruction_torch/csrc/runsum.cu` cuts the rows into
tiles of kTile rows, each thread keeping kUnroll 16-byte row loads in
flight. This script builds copies of the source with kTile = 64, 128, 256
and kUnroll = 8, 16 into build/runsum_tiles/, holds each against the plain
version (within chip_smoke.py's TOL_RUNSUM_REL, every row of a run holding
the bitwise same total) and times it with chip_smoke.py's `time_ms` and
`back_to_back_ms` on chip_smoke.py's run-sum inputs (E = 55 296,
D = 768, runs of 1-28 rows, a 15% sentinel run). One JSON line per
variant; needs CUDA.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_variants  # noqa: E402
from wild_video_3d_reconstruction_torch.ops import _native  # noqa: E402
from wild_video_3d_reconstruction_torch.ops import segment as tseg  # noqa: E402

OUT = ROOT / "build" / "runsum_tiles"
VARIANTS = [(t, u) for t in (64, 128, 256) for u in (8, 16)]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.phase_env()
    src = (kernel_variants.CSRC / "runsum.cu").read_text()
    fns = kernel_variants.build(
        {(t, u): kernel_variants.set_constants(src, {"kTile": t,
                                                     "kUnroll": u})
         for t, u in VARIANTS}, "wv3d_runsum", OUT)
    fes, seg = cs.runsum_inputs(torch.Generator().manual_seed(0))
    E, D = fes.shape
    ref = tseg.run_segment_sum_sorted_plain(fes, seg)
    first = tseg.run_first_rows(seg)
    out = torch.empty_like(fes)
    stream = _native.stream_ptr(fes.device)
    for (tile, unroll), (fn, ptxas) in fns.items():
        head = torch.empty((-(-E // tile), D), device=fes.device)
        tail = torch.empty_like(head)

        def launch():
            _native.check_launch(f"runsum {tile}/{unroll}", fn(
                fes.data_ptr(), seg.data_ptr(), out.data_ptr(),
                head.data_ptr(), tail.data_ptr(), E, D, stream))
        out.fill_(float("nan"))
        launch()
        torch.cuda.synchronize()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        same = bool(torch.equal(out, out[first]))
        if not rel <= cs.TOL_RUNSUM_REL or not same:
            sys.exit(f"runsum {tile}/{unroll} disagrees with the plain "
                     f"version: {rel}, bitwise within runs {same}")
        print(json.dumps(dict(
            card=card, kernel="runsum", E=E, D=D, tile=tile, unroll=unroll,
            rel_err=rel, ms=cs.time_ms(launch),
            ms_back_to_back=cs.back_to_back_ms(launch), ptxas=ptxas)),
            flush=True)


if __name__ == "__main__":
    main()
