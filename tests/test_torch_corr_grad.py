"""Port parity of the correlation's adjoint: the plain backward
(`ops/corr.py:corr_pyramid_backward_plain`) against `jax.vjp` of the JAX
package's plain `ops/corr.py:patch_corr_pyramid`, for the gradients of
gmap and both maps; and a numpy mirror of the backward kernel's schedule
(`csrc/corr_grad.cu`: the forward's box rule, dc per box position, one
flush per covered in-map box position, the per-pixel path for the pixels
that do not fit the box) against the same plain backward.

Tolerance: each gradient within 1e-5 of its largest magnitude, the
kernel's own tolerance on the card (`chip_smoke.py` TOL_CORR_GRAD_REL):
fp32 sums of the same products in another order. Tiny sizes (16
channels, a 24 x 32 map): the kernel itself runs only on the card
(`tests/test_torch_kernels_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import corr as tcorr
from wild_video_3d_reconstruction_torch.train.forward import all_pairs_edges
from wild_video_3d_reconstruction_tpu.ops import corr as jcorr

TOL_REL = 1e-5
S, F, H, W, C = 24, 4, 24, 32, 16
CASES = ("compact_inside", "straddle_edge", "off_map",
         "box_beyond_capacity", "invalid_nan", "kk_major_shared")


def _patches(rng, cx, cy, spread):
    """coords [E, 3, 3, 2] of 3x3 patches centred at (cx, cy), the
    pixels 1 px apart plus a jitter of `spread` px."""
    E = cx.shape[0]
    off = np.arange(3) - 1.0
    jit = spread * rng.uniform(-0.5, 0.5, size=(E, 3, 3, 2))
    x = cx[:, None, None] + off[None, None, :] + jit[..., 0]
    y = cy[:, None, None] + off[None, :, None] + jit[..., 1]
    return np.stack([x, y], -1).astype(np.float32)


def make_case(case, seed=0, E=64):
    """(gmap, (fmap1, fmap2), coords, kk, jj, valid, grad_out) in numpy."""
    rng = np.random.default_rng(seed)
    gmap = rng.normal(size=(S, C, 3, 3)).astype(np.float32)
    pyr = (rng.normal(size=(F, H, W, C)).astype(np.float32),
           rng.normal(size=(F, H // 4, W // 4, C)).astype(np.float32))
    kk = rng.integers(0, S, E)
    jj = rng.integers(0, F, E)
    valid = rng.random(E) > 0.1
    spread = 0.5
    if case in ("compact_inside", "invalid_nan"):
        cx = rng.uniform(8.0, W - 8.0, E)
        cy = rng.uniform(8.0, H - 8.0, E)
    elif case == "straddle_edge":
        # centres within 3 px of the border, inside or out
        cx = np.where(rng.random(E) < 0.5, rng.uniform(-3.0, 3.0, E),
                      rng.uniform(W - 3.0, W + 3.0, E))
        cy = rng.uniform(-3.0, H + 3.0, E)
    elif case == "off_map":
        # half of the patches 12-30 px off the map (off at level 1, on at
        # level 2 for the nearer ones), the rest anywhere on it
        cx = rng.uniform(-3.0, W + 3.0, E)
        cy = rng.uniform(-3.0, H + 3.0, E)
        far = rng.random(E) < 0.5
        cx = np.where(far, -rng.uniform(12.0, 30.0, E), cx)
    elif case == "box_beyond_capacity":
        # pixels 6 px apart: window starts up to 12 apart at level 1, past
        # the 12 x 12 box
        cx = rng.uniform(0.0, W, E)
        cy = rng.uniform(0.0, H, E)
        spread = 12.0
    else:                                   # kk_major_shared
        # the training order: every patch of F frames into every frame,
        # the F edges of a patch next to each other, i == j dropped; 4
        # patches a frame, so E = 64 as in the other cases
        _, jj_t, kk_t, keep = all_pairs_edges(F, E // F ** 2)
        kk, jj, valid = kk_t.numpy(), jj_t.numpy(), keep.numpy()
        E = kk.shape[0]
        cx = rng.uniform(-3.0, W + 3.0, E)
        cy = rng.uniform(-3.0, H + 3.0, E)
    coords = _patches(rng, cx, cy, spread)
    if case == "invalid_nan":
        bad = np.nonzero(~valid)[0]
        coords[bad] = np.nan
        coords[bad[::2], 0, 0] = (1e7, -1e7)
    grad_out = rng.normal(size=(E, 882)).astype(np.float32)
    return gmap, pyr, coords, kk, jj, valid, grad_out


def jax_vjp(gmap, pyr, coords, kk, jj, valid, grad_out):
    """(grad_gmap, grad_fmap1, grad_fmap2) from jax.vjp of the JAX plain
    correlation. Its rows of invalid edges are multiplied by 0, so NaN
    coordinates there would give NaN products: they get zeros, as the SLAM
    path gives them (the port's rows of invalid edges contribute nothing
    whatever their coordinates)."""
    coords = np.where(valid[:, None, None, None], coords, 0.0)

    def f(g, f1, f2):
        return jcorr.patch_corr_pyramid(g, (f1, f2), jnp.asarray(coords),
                                        jnp.asarray(kk), jnp.asarray(jj),
                                        valid=jnp.asarray(valid))

    _, vjp = jax.vjp(f, jnp.asarray(gmap), *map(jnp.asarray, pyr))
    return [np.asarray(g) for g in vjp(jnp.asarray(grad_out))]


def port_plain(gmap, pyr, coords, kk, jj, valid, grad_out):
    t = torch.from_numpy
    grads = tcorr.corr_pyramid_backward_plain(
        t(grad_out), t(gmap), tuple(map(t, pyr)), t(coords), t(kk), t(jj),
        t(valid))
    return [g.numpy() for g in grads]


def kernel_schedule(gmap, pyr, coords, kk, jj, valid, grad_out):
    """The backward kernel's schedule in numpy, edge by edge and level by
    level: dc from the grad_out row at index ((dx * 7 + dy) * 9 + p) * 2 +
    l; the box plan of `box_plan`; each in-box pixel's dc placed at its box
    positions, summed over the pixels per position into the box gradient
    (added once per covered in-map position) and against the staged box
    (zero off the map) into grad_gmap; each per-pixel pixel straight from
    the map."""
    g_out = np.zeros_like(gmap)
    f_out = [np.zeros_like(f) for f in pyr]
    a, b = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    for l, (fmap, s) in enumerate(zip(pyr, tcorr.LEVELS)):
        Hl, Wl = fmap.shape[1:3]
        cl = torch.from_numpy(coords / s)
        cls, box = (x.numpy() for x in tcorr.box_plan(cl, Hl, Wl))
        ys, xs = (x.numpy() for x in tcorr.window_starts(cl))
        xy = (coords / np.float32(s)).reshape(-1, 9, 2)
        frac = xy - np.floor(xy)
        for e in np.nonzero(valid)[0]:
            row = grad_out[e]
            g = gmap[kk[e]].reshape(C, 9)
            dc = np.zeros((9, 8, 8), np.float32)
            for p in range(9):
                fx, fy = frac[e, p]

                def go(oy, ox):
                    inside = (oy >= 0) & (oy < 7) & (ox >= 0) & (ox < 7)
                    i = ((ox.clip(0, 6) * 7 + oy.clip(0, 6)) * 9 + p) * 2 + l
                    return np.where(inside, row[i], 0.0)

                dc[p] = ((1 - fx) * (1 - fy) * go(a, b) +
                         fx * (1 - fy) * go(a, b - 1) +
                         (1 - fx) * fy * go(a - 1, b) +
                         fx * fy * go(a - 1, b - 1))
            y0, x0, h, w = box[e]
            by, bx = np.meshgrid(y0 + np.arange(h), x0 + np.arange(w),
                                 indexing="ij")
            on = (by >= 0) & (by < Hl) & (bx >= 0) & (bx < Wl)
            staged = np.where(on[..., None],
                              fmap[jj[e], by.clip(0, Hl - 1),
                                   bx.clip(0, Wl - 1)], 0.0)
            dc_box = np.zeros((9, h, w), np.float32)
            covered = np.zeros((h, w), bool)
            for p in np.nonzero(cls[e] == 1)[0]:
                ry, rx = ys[e, p] - y0, xs[e, p] - x0
                dc_box[p, ry:ry + 8, rx:rx + 8] = dc[p]
                covered[ry:ry + 8, rx:rx + 8] = True
            g_out[kk[e]] += np.einsum("phw,hwc->cp", dc_box, staged) \
                .reshape(C, 3, 3)
            covered &= on
            flush = np.einsum("phw,cp->hwc", dc_box, g)
            np.add.at(f_out[l], (jj[e], by[covered], bx[covered]),
                      flush[covered])
            for p in np.nonzero(cls[e] == 2)[0]:
                wy, wx = ys[e, p] + a, xs[e, p] + b
                inm = (wy >= 0) & (wy < Hl) & (wx >= 0) & (wx < Wl)
                feats = fmap[jj[e], wy[inm], wx[inm]]
                g_out[kk[e]].reshape(C, 9)[:, p] += dc[p][inm] @ feats
                np.add.at(f_out[l], (jj[e], wy[inm], wx[inm]),
                          dc[p][inm][:, None] * g[:, p])
    return [g_out, *f_out]


def assert_close_rel(out, ref, what):
    for o, r, name in zip(out, ref, ("gmap", "fmap1", "fmap2")):
        assert np.isfinite(o).all(), (what, name)
        scale = np.abs(r).max()
        assert scale > 0, (what, name)
        err = np.abs(o - r).max()
        assert err <= TOL_REL * scale, (what, name, err / scale)


def _plan_counts(coords, valid):
    """Per level, the valid pixels in the box, per pixel and off the map."""
    counts = []
    for fmap_hw, s in zip(((H, W), (H // 4, W // 4)), tcorr.LEVELS):
        cls, _ = tcorr.box_plan(torch.from_numpy(coords / s), *fmap_hw)
        cls = cls[torch.from_numpy(valid)]
        counts.append([int((cls == i).sum()) for i in (1, 2, 0)])
    return counts


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case):
    """The port's plain adjoint against jax.vjp of the JAX plain
    correlation, within 1e-5 of each gradient's largest magnitude; each
    case covers what it names (the box plan's classes)."""
    args = make_case(case)
    assert_close_rel(port_plain(*args), jax_vjp(*args), case)
    (box1, pp1, off1), (box2, pp2, off2) = _plan_counts(args[2], args[5])
    assert box1 > 0 and box2 > 0
    if case == "box_beyond_capacity":
        assert pp1 > 0
    if case == "off_map":
        assert off1 > 0
    if case in ("compact_inside", "kk_major_shared"):
        assert pp1 == pp2 == 0
    if case == "kk_major_shared":
        kk, valid = args[3], args[5]
        assert (np.diff(kk) == 0).sum() == kk.shape[0] - kk.shape[0] // F
        assert not valid.all()


@pytest.mark.parametrize("case", CASES)
def test_kernel_schedule_matches_plain(case):
    """The backward kernel's schedule (box and per-pixel paths, dc
    indexed from the grad_out row as the kernel reads it) against the plain
    adjoint, within 1e-5 of each gradient's largest magnitude."""
    args = make_case(case, seed=1)
    assert_close_rel(kernel_schedule(*args), port_plain(*args), case)


def test_invalid_rows_contribute_nothing_whatever_their_coords():
    """Rows of invalid edges with NaN and huge coordinates give the same
    gradients, bit for bit, as the same rows with zero coordinates."""
    gmap, pyr, coords, kk, jj, valid, grad_out = make_case("invalid_nan")
    assert np.isnan(coords[~valid]).any()
    zeroed = np.where(valid[:, None, None, None], coords, 0.0) \
        .astype(np.float32)
    a = port_plain(gmap, pyr, coords, kk, jj, valid, grad_out)
    b = port_plain(gmap, pyr, zeroed, kk, jj, valid, grad_out)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
