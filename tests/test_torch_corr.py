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

