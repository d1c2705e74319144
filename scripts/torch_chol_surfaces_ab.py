"""The Cholesky solve and the split route's surfaces producer against the
kernels of another tree, and where their time goes, on one card.

    python scripts/torch_chol_surfaces_ab.py --parent DIR   # from the repo root

DIR is a checkout of the tree to compare with (for instance the parent
commit unpacked with `git archive` into a git-ignored directory). The
script builds DIR's `csrc/chol.cu` and `csrc/corr_region.cu`, whose C
entries `wv3d_chol_solve` and `wv3d_corr_region_surfaces_x16` take this
tree's arguments, and copies of this tree's `csrc/chol.cu` and
`csrc/corr_box.cu` changed as `CHOL_VARIANTS` and `SURFACE_VARIANTS` say
(other block shapes; stages, loads or stores taken out; the map loads
skipping L1; the edges in list order), one `nvcc` each, started together
(`scripts/kernel_variants.py`), into build/chol_surfaces_ab/. Shapes
are `chip_smoke.py`'s: Cholesky D = 54, 72, 256 from `spd_system`;
surfaces at E = 55 296 on compact and 6 px spread patches, the edges in
random order and grouped by target frame. Every kernel that computes the
whole function is held against its plain version; a variant with a part
taken out is only timed. Each is timed through its C entry with the same
host work, the two trees in the order other, this, this, other: per
launch (`chip_smoke.time_ms`), back to back (`back_to_back_ms`) and, for
the Cholesky, as a CUDA graph (`graph_ms`, device time alone; not for the
other tree, whose launcher sets a function attribute on every launch).
One JSON line per reading; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_variants  # noqa: E402
from wild_video_3d_reconstruction_torch.ops import _native  # noqa: E402
from wild_video_3d_reconstruction_torch.ops import chol as tchol  # noqa: E402
from wild_video_3d_reconstruction_torch.ops import corr_region as tregion  # noqa: E402,E501
from wild_video_3d_reconstruction_torch.ops.corr import KernelArgs  # noqa: E402,E501

OUT = ROOT / "build" / "chol_surfaces_ab"
ORDER = ("other", "this", "this", "other")

# {name: (constants to set, [(text, replacement)], computes the function)}
SURFACE_VARIANTS = {
    "warps4_blocks3": (dict(kSurfWarps=4, kSurfMinBlocks=3), [], True),
    "warps4_blocks4": (dict(kSurfWarps=4, kSurfMinBlocks=4), [], True),
    "warps16_blocks1": (dict(kSurfWarps=16, kSurfMinBlocks=1), [], True),
    "tiles2": (dict(kSurfTiles=2), [], True),
    "loads_skip_l1": ({}, [("@p ld.global.nc.v4.u32",
                            "@p ld.global.nc.L1::no_allocate.v4.u32")], True),
    "list_order": ({}, [("order_s[rank] = ", "order_s[i] = ")], True),
    "no_stores": ({}, [("__stcs(plane + p * (kRPos / 4)",
                        "if (oy[l] == -123456789) __stcs(plane + p * (kRPos / 4)"
                        )], False),
    "no_loads": ({}, [("b[ti][kp] = ldg16_if(src + 4 * kp, in);",
                       "b[ti][kp] = make_uint4(x, y, kp, q + in);")], False),
}
CHOL_VARIANTS = {
    "load_only": [("  load_system<kThreads>(S, y, L, v, D, t);\n"
                   "  __syncthreads();\n",
                   "  load_system<kThreads>(S, y, L, v, D, t);\n"
                   "  if (D > 0) return;\n")],
    "no_backward": [("  // Backward, per panel from the last",
                     "  if (D > 0) return;\n"
                     "  // Backward, per panel from the last")],
    "no_lookahead_factor": [
        ("      factor_diagonal(L, blk, col, rinv, t0, min(kNB, D - t0), "
         "lane);\n", "")],
}


def edit(src, consts, subs):
    src = kernel_variants.set_constants(src, consts)
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def build(parent):
    """{kernel: {tree or variant: (C entry, ptxas lines)}}."""
    csrc = Path(parent) / "wild_video_3d_reconstruction_torch" / "csrc"
    box = (kernel_variants.CSRC / "corr_box.cu").read_text()
    chol = (kernel_variants.CSRC / "chol.cu").read_text()
    surfaces = {"other": (csrc / "corr_region.cu").read_text()}
    surfaces.update({k: edit(box, c, s)
                     for k, (c, s, _) in SURFACE_VARIANTS.items()})
    chols = {"other": (csrc / "chol.cu").read_text()}
    chols.update({k: edit(chol, {}, s) for k, s in CHOL_VARIANTS.items()})
    fns = {"chol_solve": kernel_variants.build(chols, "wv3d_chol_solve",
                                               OUT / "chol"),
           "corr_region_surfaces": kernel_variants.build(
               surfaces, "wv3d_corr_region_surfaces_x16", OUT / "surfaces")}
    lib = _native.lib()
    fns["chol_solve"]["this"] = (lib.wv3d_chol_solve, [])
    fns["corr_region_surfaces"]["this"] = (
        lib.wv3d_corr_region_surfaces_x16, [])
    return fns


def report(card, **kw):
    print(json.dumps(dict(card=card, **kw)), flush=True)


def chol_ab(card, fns, gen):
    for D in cs.CHOL_DIMS:
        S, y = cs.spd_system(gen, D)
        ref = tchol.chol_solve_small_plain(S, y)
        x = torch.empty_like(y)
        for tree in (*ORDER[:2], *CHOL_VARIANTS, *ORDER[2:]):
            fn = fns[tree][0]

            def launch():
                _native.check_launch(tree, fn(
                    S.data_ptr(), y.data_ptr(), x.data_ptr(), D,
                    _native.stream_ptr(S.device)))
            x.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            whole = tree not in CHOL_VARIANTS
            if whole and not torch.allclose(x, ref, rtol=cs.TOL_CHOL_RTOL,
                                            atol=cs.TOL_CHOL_ATOL):
                sys.exit(f"chol ({tree}) disagrees with its plain version at "
                         f"D = {D}")
            report(card, kernel="chol_solve", D=D, tree=tree,
                   max_abs_err=(x - ref).abs().max().item() if whole
                   else None,
                   ms=cs.time_ms(launch),
                   ms_back_to_back=cs.back_to_back_ms(launch),
                   ms_cuda_graph=cs.graph_ms(launch) if tree != "other"
                   else None)


def surfaces_ab(card, fns, gen):
    for spread in (1.0, 6.0):
        gmap, f1, f2, coords, kk, jj, valid = cs.corr_inputs(
            gen, spread=spread)
        order = jj.argsort(stable=True)
        inputs = {"random": (coords, kk, jj, valid),
                  "grouped_by_frame": tuple(
                      a[order].contiguous() for a in (coords, kk, jj, valid))}
        for edges, (c, k, j, v) in inputs.items():
            if spread != 1.0 and edges != "random":
                continue
            a = KernelArgs("surfaces_ab", gmap, (f1, f2), c, k, j, v)
            ref = tregion.region_surfaces_plain(gmap, (f1, f2), c, k, j, v)
            surf = torch.empty_like(ref)
            for tree in (*ORDER[:2], *SURFACE_VARIANTS, *ORDER[2:]):
                fn = fns[tree][0]

                def launch():
                    _native.check_launch(tree, fn(
                        *a.pointers(), surf.data_ptr(), *a.sizes()))
                surf.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                whole = tree not in SURFACE_VARIANTS or \
                    SURFACE_VARIANTS[tree][2]
                err = (surf - ref).abs().max().item() if whole else None
                if whole and not err <= cs.TOL_CORR_ABS:
                    sys.exit(f"surfaces ({tree}) disagree with the plain "
                             f"version: {err}")
                report(card, kernel="corr_region_surfaces", E=cs.E_KERNEL,
                       pixel_spacing_px=spread, edges=edges, tree=tree,
                       ptxas=fns[tree][1], max_abs_err=err,
                       ms=cs.time_ms(launch),
                       ms_back_to_back=cs.back_to_back_ms(launch))
            del ref, surf
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the tree to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.phase_env()
    fns = build(args.parent)
    report(card, this_tree_ptxas=[
        ln.strip() for ln in _native.BUILD_INFO.get("log", "").splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln])
    gen = torch.Generator().manual_seed(0)
    chol_ab(card, fns["chol_solve"], gen)
    surfaces_ab(card, fns["corr_region_surfaces"], gen)


if __name__ == "__main__":
    main()
