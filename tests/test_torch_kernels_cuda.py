"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; they skip without a card. This file imports nothing of JAX,
so that it also runs where JAX is not installed. There `tests/conftest.py`
(which imports jax) cannot load, so run it with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops import corr as tcorr
from wild_video_3d_reconstruction_torch.ops import segment as tseg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card")
    return torch.device("cuda")


def corr_case(seed, E=4096, S=512, F=8, H=96, W=128, C=128, spread=6.0):
    """Edges with patches from inside to beyond the border of the map."""
    rng = np.random.default_rng(seed)
    gmap = rng.normal(size=(S, C, 3, 3)).astype(np.float32)
    fmaps = (rng.normal(size=(F, H, W, C)).astype(np.float32),
             rng.normal(size=(F, H // 4, W // 4, C)).astype(np.float32))
    cx = rng.uniform(-3.0, W + 3.0, size=E)
    cy = rng.uniform(-3.0, H + 3.0, size=E)
    off = np.arange(3) - 1.0
    jit = spread * rng.uniform(-0.5, 0.5, size=(E, 3, 3, 2))
    x = cx[:, None, None] + off[None, None, :] + jit[..., 0]
    y = cy[:, None, None] + off[None, :, None] + jit[..., 1]
    coords = np.stack([x, y], -1).astype(np.float32)
    return (gmap, fmaps, coords, rng.integers(0, S, E), rng.integers(0, F, E),
            rng.random(E) > 0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_corr_kernel_matches_plain(cuda_device, dtype):
    """csrc/corr.cu against the plain version on the same stored feature
    values, within 1e-2 absolute (fp32 sums of 128 products, other
    order)."""
    gmap, fmaps, coords, kk, jj, valid = corr_case(0)
    g = torch.from_numpy(gmap).to(cuda_device, dtype)
    pyr = tuple(torch.from_numpy(f).to(cuda_device, dtype) for f in fmaps)
    c, k, j, v = (torch.from_numpy(a).to(cuda_device)
                  for a in (coords, kk, jj, valid))
    n0 = _native.LAUNCHES["corr_pyramid"]
    out = tcorr.corr_lookup(g, pyr, c, k, j, v)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["corr_pyramid"] == n0 + 1
    ref = tcorr.patch_corr_pyramid(g, pyr, c, k, j, valid=v)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)


def test_corr_kernel_rejects_what_it_cannot_take(cuda_device):
    gmap, fmaps, coords, kk, jj, valid = corr_case(1, E=64, C=64)
    g = torch.from_numpy(gmap).to(cuda_device)
    pyr = tuple(torch.from_numpy(f).to(cuda_device) for f in fmaps)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (coords, kk, jj, valid)]
    with pytest.raises(ValueError):
        tcorr.corr_lookup(g, pyr, *args)        # 64 channels, not 128


@pytest.mark.parametrize("tail", [0, 8000])
def test_runsum_kernel_matches_plain(cuda_device, tail):
    """csrc/runsum.cu against the plain version: runs of 1..28 rows
    across the kernel's 64-row tiles, with and without a long trailing
    run (the sentinel run of invalid rows); within 1e-5 of the largest
    total (fp32 sums in another order)."""
    rng = np.random.default_rng(2)
    E, D = 55296, 768
    seg = np.repeat(np.arange(E), rng.integers(1, 29, E))[:E]
    if tail:
        seg[-tail:] = seg[-tail - 1] + 1
    fes = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    fes = fes.to(cuda_device)
    seg = torch.from_numpy(seg).to(cuda_device)
    n0 = _native.LAUNCHES["runsum"]
    out = tseg.run_segment_sum_sorted(fes, seg)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["runsum"] == n0 + 1
    ref = tseg.run_segment_sum_sorted_plain(fes, seg)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()
    # every row of a run holds the bitwise same total
    start = torch.ones(E, dtype=torch.bool, device=cuda_device)
    start[1:] = seg[1:] != seg[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    first = torch.zeros(int(run[-1]) + 1, dtype=torch.long,
                        device=cuda_device)
    first[run.flip(0)] = torch.arange(E - 1, -1, -1, device=cuda_device)
    assert torch.equal(out, out[first[run]])
