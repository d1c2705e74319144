"""Port parity: the plain patch correlation against the JAX package's
`ops/corr.py` (and its loop oracle), and the kernel wrapper's routing.

Tolerance 1e-4 absolute: fp32 dot products of 16-64 channels at unit
scale, summed in another order. The Hopper kernel itself is compared with
the plain version on the card (`test_torch_kernels_cuda.py`; `chip_smoke.py`
does the same at full size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops import corr as tcorr
from wild_video_3d_reconstruction_tpu.ops import corr as jcorr


def make_case(seed, E=96, S=24, F=4, H=12, W=16, C=16, spread=2.0):
    """Edges with patches anywhere from inside to beyond the border."""
    rng = np.random.default_rng(seed)
    gmap = rng.normal(size=(S, C, 3, 3)).astype(np.float32)
    fmap1 = rng.normal(size=(F, H, W, C)).astype(np.float32)
    fmap2 = rng.normal(size=(F, H // 4, W // 4, C)).astype(np.float32)
    cx = rng.uniform(-3.0, W + 3.0, size=E)
    cy = rng.uniform(-3.0, H + 3.0, size=E)
    off = np.arange(3) - 1.0
    jit = spread * rng.uniform(-0.5, 0.5, size=(E, 3, 3, 2))
    x = cx[:, None, None] + off[None, None, :] + jit[..., 0]
    y = cy[:, None, None] + off[None, :, None] + jit[..., 1]
    coords = np.stack([x, y], -1).astype(np.float32)
    kk = rng.integers(0, S, E)
    jj = rng.integers(0, F, E)
    valid = rng.random(E) > 0.1
    return gmap, (fmap1, fmap2), coords, kk, jj, valid


def to_t(gmap, pyr, coords, kk, jj, valid):
    t = torch.from_numpy
    return (t(gmap), tuple(t(f) for f in pyr), t(coords), t(kk), t(jj),
            t(valid))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunk", [32, 4096])
def test_plain_pyramid_matches_jax(seed, chunk):
    gmap, pyr, coords, kk, jj, valid = make_case(seed)
    ref = np.asarray(jcorr.patch_corr_pyramid(
        jnp.asarray(gmap), tuple(map(jnp.asarray, pyr)), jnp.asarray(coords),
        jnp.asarray(kk), jnp.asarray(jj), valid=jnp.asarray(valid)))
    out = tcorr.patch_corr_pyramid(*to_t(gmap, pyr, coords, kk, jj, valid)[:5],
                                   valid=torch.from_numpy(valid),
                                   chunk=chunk)
    assert out.shape == (coords.shape[0], 882) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_plain_level_matches_loop_oracle():
    gmap, pyr, coords, kk, jj, _ = make_case(3, E=12)
    ref = jcorr.patch_corr_naive(gmap, pyr[0], coords, kk, jj)
    out = tcorr.patch_corr_level(torch.from_numpy(gmap),
                                 torch.from_numpy(pyr[0]),
                                 torch.from_numpy(coords),
                                 torch.from_numpy(kk), torch.from_numpy(jj))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_lookup_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    case = to_t(*make_case(4))
    before = dict(_native.LAUNCHES)
    out = tcorr.corr_lookup(*case[:5], case[5])
    ref = tcorr.patch_corr_pyramid(*case[:5], valid=case[5])
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert _native.LAUNCHES == before


def test_lookup_bf16_features_on_cpu():
    """bf16 features (mixed precision) are computed in fp32 from the
    stored values: equal to the fp32 version on the rounded features."""
    gmap, pyr, coords, kk, jj, valid = to_t(*make_case(5, C=128))
    g16 = gmap.to(torch.bfloat16)
    p16 = tuple(f.to(torch.bfloat16) for f in pyr)
    out = tcorr.corr_lookup(g16, p16, coords, kk, jj, valid)
    ref = tcorr.patch_corr_pyramid(g16.float(), tuple(f.float() for f in p16),
                                   coords, kk, jj, valid=valid)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)



def _box_plan_loop(coords, H, W, box, D=8):
    """Loop oracle of the correlation kernel's staging plan at one level."""
    cls_all, box_all = [], []
    for c in coords.reshape(coords.shape[0], 9, 2):
        def start(v):
            v = 1e6 if np.isnan(v) else min(max(float(v), -1e6), 1e6)
            return int(np.floor(v)) - 3
        ys = [start(y) for _, y in c]
        xs = [start(x) for x, _ in c]
        on = [-D < y < H and -D < x < W for y, x in zip(ys, xs)]
        if not any(on):
            cls_all.append([0] * 9)
            box_all.append([0, 0, 0, 0])
            continue
        y0 = min(y for y, o in zip(ys, on) if o)
        x0 = min(x for x, o in zip(xs, on) if o)
        inb = [o and y - y0 <= box - D and x - x0 <= box - D
               for y, x, o in zip(ys, xs, on)]
        cls_all.append([1 if i else (2 if o else 0) for i, o in zip(inb, on)])
        # the least starts may come from two pixels, neither in the box
        y1 = max([y + D for y, i in zip(ys, inb) if i] + [y0])
        x1 = max([x + D for x, i in zip(xs, inb) if i] + [x0])
        box_all.append([y0, x0, y1 - y0, x1 - x0])
    return np.array(cls_all), np.array(box_all)


@pytest.mark.parametrize("seed, spread", [(0, 1.0), (1, 6.0), (2, 12.0),
                                          (3, 30.0)])
def test_box_plan_matches_loop_oracle(seed, spread):
    """`box_plan` (the plain mirror of the correlation kernel's choice of
    staged and per-pixel windows) against a loop oracle, at both levels,
    with patches from compact to beyond the staging capacity, off the map,
    NaN and huge."""
    _, pyr, coords, *_ = make_case(seed, E=200, spread=spread)
    coords[:5] = np.nan
    coords[5:8, 1, 1] = (1e7, -1e7)
    for fmap, s in zip(pyr, tcorr.LEVELS):
        H, W = fmap.shape[1:3]
        cls, box = tcorr.box_plan(torch.from_numpy(coords / s), H, W)
        ref_cls, ref_box = _box_plan_loop(coords / s, H, W, tcorr.BOX)
        np.testing.assert_array_equal(cls.numpy(), ref_cls)
        np.testing.assert_array_equal(box.numpy(), ref_box)
        assert (box[:, 2:] <= tcorr.BOX).all()


def test_plain_pyramid_invalid_rows_are_zero():
    """Rows of invalid edges are zero even where the coordinates are not
    finite (the kernel writes zeros there without reading them)."""
    gmap, pyr, coords, kk, jj, valid = make_case(6)
    coords[valid] = np.where(np.isnan(coords[valid]), 0.0, coords[valid])
    coords[~valid] = np.nan
    out = tcorr.patch_corr_pyramid(*to_t(gmap, pyr, coords, kk, jj, valid)[:5],
                                   valid=torch.from_numpy(valid))
    assert not bool(out[torch.from_numpy(~valid)].any())
    assert bool(torch.isfinite(out).all())
