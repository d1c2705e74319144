"""Staging capacity of the port's correlation body, measured on one card.

    python scripts/torch_corr_box_capacity.py      # from the repository root

`wild_video_3d_reconstruction_torch/csrc/corr_box.cu` stages a box of at
most kBox x kBox positions per edge and level; the capacity sets its shared
memory and so how many blocks share an SM. This script builds copies of the
source with kBox = 16, 13 and 12 (3, 4 and 5 blocks per SM for bf16) into
build/corr_box_capacity/, holds each against the plain version and times
its unfused entry at chip_smoke.py's default-config (E = 55 296) and
fast-config (E = 7 168) shapes, on compact patches and on patches spread
12 px. One JSON line per case; needs CUDA.
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
from wild_video_3d_reconstruction_torch.ops import corr as tcorr  # noqa: E402

OUT = ROOT / "build" / "corr_box_capacity"
BLOCKS_PER_SM = {16: 3, 13: 4, 12: 5}   # bf16 blocks that fit an SM's smem


def build_variants():
    src = (kernel_variants.CSRC / "corr_box.cu").read_text()
    bounds = f"? {BLOCKS_PER_SM[tcorr.BOX]}\n"
    if bounds not in src:
        raise RuntimeError("corr_box.cu no longer has the lines this script "
                           "edits")
    fns = kernel_variants.build(
        {box: kernel_variants.set_constants(src, {"kBox": box})
         .replace(bounds, f"? {blocks}\n")
         for box, blocks in BLOCKS_PER_SM.items()},
        "wv3d_corr_pyramid", OUT)
    return {box: fn for box, (fn, _) in fns.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.phase_env()
    fns = build_variants()
    gen = torch.Generator().manual_seed(0)
    for shapes, M, E in (("default", 384, cs.E_KERNEL),
                         ("fast", 48, cs.E_FAST)):
        for spread in (1.0, 6.0):
            gmap, f1, f2, coords, kk, jj, valid = cs.corr_inputs(
                gen, M=M, E=E, spread=spread)
            pyr = (f1, f2)
            ref = tcorr.patch_corr_pyramid(
                gmap, pyr, coords, kk, jj, valid=valid, chunk=4096)
            a = tcorr.KernelArgs("corr_box_capacity", gmap, pyr, coords, kk,
                                 jj, valid)
            out = torch.empty((E, 882), device=coords.device)
            for box, fn in fns.items():
                def launch():
                    _native.check_launch(f"kBox = {box}", fn(
                        *a.pointers(), out.data_ptr(), *a.sizes()))
                launch()
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                if not err <= cs.TOL_CORR_ABS:
                    sys.exit(f"kBox = {box} disagrees with the plain version: "
                             f"{err}")
                print(json.dumps(dict(
                    card=card, shapes=shapes, E=E, pixel_spacing_px=spread,
                    box=box, blocks_per_sm=BLOCKS_PER_SM[box],
                    per_pixel_share=cs.per_pixel_share(pyr, coords, valid)
                    if box == tcorr.BOX else None,
                    max_abs_err=err, ms=cs.time_ms(launch))), flush=True)
            del ref, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
