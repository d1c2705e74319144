"""The correlation backward (`csrc/corr_grad.cu`) against other builds of
it, on one card.

    git show <commit>:wild_video_3d_reconstruction_torch/csrc/corr_grad.cu \
        > build/corr_grad_other.cu        # e.g. an earlier design
    python scripts/torch_corr_grad_ab.py [--other build/corr_grad_other.cu ...]

Builds, one `nvcc` each and all together (into build/corr_grad_ab/), this
tree's source; copies of it with kEdgesPerBlock = 2, 4 and 16; two copies
with a part taken out to show where the time goes (`no_box_flush`: the box
path's reductions into grad_fmap never issued, their sums still computed;
`scalar_reductions`: each 16-byte reduction as four scalar fp32 atomics);
and, with --other, other sources with the same C entry. Inputs:
chip_smoke.py's training shape (`train_corr_inputs`: E = 2048, 1792 live,
fp32 maps [8, 96, 128, 128] and [8, 24, 32, 128]), and the same edges with
the patch pixels 6 px apart, so that the pixels' windows leave the 12 x 12
box and take the per-pixel path. Each build is held against the plain
version (1e-5 of each gradient's largest magnitude; not the builds with a
part taken out) and timed through its C entry with the three zero fills of
the wrapper: per launch (`time_ms`) and back to back, in the order other,
this, the rest, this, other (reversed), after the zero fills alone. One
JSON line per build and input; needs CUDA.
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
from wild_video_3d_reconstruction_torch.ops import corr as tcorr  # noqa: E402

OUT = ROOT / "build" / "corr_grad_ab"
ENTRY = "wv3d_corr_pyramid_backward"
BOX_FLUSH = ("          if (mrow >= 0)\n"
             "            red_add_v4(gF + static_cast<size_t>(mrow) * kC + "
             "4 * lane, s);\n")
RED_V4 = ('  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\\n" '
          '::"l"(\n')


def sources(other):
    src = (kernel_variants.CSRC / "corr_grad.cu").read_text()
    a = src.find(RED_V4)
    if BOX_FLUSH not in src or a < 0:
        raise RuntimeError("corr_grad.cu no longer has the lines this "
                           "script edits")
    b = src.index(': "memory");\n', a) + len(': "memory");\n')
    scalar = src[:a] + ("  atomicAdd(p, v.x);\n  atomicAdd(p + 1, v.y);\n"
                        "  atomicAdd(p + 2, v.z);\n  atomicAdd(p + 3, v.w);\n"
                        ) + src[b:]
    out = {"this": src}
    for n in (2, 4, 16):
        out[f"edges_per_block_{n}"] = kernel_variants.set_constants(
            src, {"kEdgesPerBlock": n})
    # the flush never taken (mrow is -1 or a map row), its products kept
    out["no_box_flush"] = src.replace(BOX_FLUSH, BOX_FLUSH.replace(
        "mrow >= 0", "mrow == INT_MIN"))
    out["scalar_reductions"] = scalar
    for path in other:
        out[f"other:{Path(path).stem}"] = Path(path).read_text()
    return out


def spread_inputs(inputs, spacing):
    """The same edges with the patch pixels `spacing` px apart."""
    gmap, f1, f2, coords, kk, jj, valid = inputs
    centre = coords[:, 1:2, 1:2]
    off = torch.arange(3.0, device=coords.device) - 1
    grid = torch.stack(torch.meshgrid(off, off, indexing="ij")[::-1], -1)
    return (gmap, f1, f2, (centre + spacing * grid).contiguous(), kk, jj,
            valid)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", nargs="*", default=[],
                    help="other corr_grad.cu sources to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = cs.phase_env()
    built = kernel_variants.build(sources(args.other), ENTRY, OUT)
    others = [k for k in built if k.startswith("other:")]
    order = others + ["this"] + [
        k for k in built if k != "this" and k not in others] + ["this"] + \
        others[::-1]
    base = cs.train_corr_inputs(torch.Generator().manual_seed(0))
    for name, inputs in (("training", base),
                         ("pixels_6px_apart", spread_inputs(base, 6.0))):
        gmap, f1, f2, coords, kk, jj, valid = inputs
        pyr = (f1, f2)
        go = torch.randn(coords.shape[0], 882,
                         generator=torch.Generator().manual_seed(1)).to(cs.DEV)
        plain = tcorr.corr_pyramid_backward_plain(go, gmap, pyr, coords, kk,
                                                  jj, valid)
        a = tcorr.KernelArgs(name, gmap, pyr, coords, kk, jj, valid)
        sizes = a.sizes()
        grads = [torch.zeros_like(t) for t in (gmap, f1, f2)]
        plan = cs.backward_plan_shares(pyr, coords, valid)

        def zero_fills():
            for g in grads:
                g.zero_()

        print(json.dumps(dict(
            card=card, inputs=name, build="zero_fills_only",
            ms=cs.time_ms(zero_fills),
            ms_back_to_back=cs.back_to_back_ms(zero_fills))), flush=True)
        for key in order:
            fn, ptxas = built[key]

            def launch():
                for g in grads:
                    g.zero_()
                _native.check_launch(key, fn(
                    go.data_ptr(), *a.pointers(),
                    *(g.data_ptr() for g in grads), *sizes[:5], sizes[6]))

            launch()
            torch.cuda.synchronize()
            rel = {n: (g - p).abs().max().item() / p.abs().max().item()
                   for n, g, p in zip(("gmap", "fmap1", "fmap2"), grads,
                                      plain)}
            exact = key not in ("no_box_flush",)
            if exact and not max(rel.values()) <= cs.TOL_CORR_GRAD_REL:
                sys.exit(f"{key} disagrees with the plain version on {name}: "
                         f"{rel}")
            print(json.dumps(dict(
                card=card, inputs=name, build=key, plan=plan,
                rel_err=rel, checked=exact, ptxas=ptxas,
                ms=cs.time_ms(launch),
                ms_back_to_back=cs.back_to_back_ms(launch))), flush=True)
        del plain, grads
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
