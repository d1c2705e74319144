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
from wild_video_3d_reconstruction_torch.ops import chol as tchol
from wild_video_3d_reconstruction_torch.ops import corr as tcorr
from wild_video_3d_reconstruction_torch.ops import corr_region as tregion
from wild_video_3d_reconstruction_torch.ops import segment as tseg

pytestmark = pytest.mark.cuda

TOL_CORR_ABS = 1e-2


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
    """csrc/corr_box.cu (unfused entry) against the plain version on the
    same stored feature values, within 1e-2 absolute (fp32 sums of 128
    products, other order)."""
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


def check_runsum(out, ref, seg):
    """Within 1e-5 of the largest total (fp32 sums in another order), and
    every row of a run holds the bitwise same total."""
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1e-30)
    assert torch.equal(out, out[tseg.run_first_rows(seg)])


def run_runsum(fes, seg):
    n0 = _native.LAUNCHES["runsum"]
    out = tseg.run_segment_sum_sorted(fes, seg)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["runsum"] == n0 + 1
    check_runsum(out, tseg.run_segment_sum_sorted_plain(fes, seg), seg)


@pytest.mark.parametrize("tail", [0, 8000])
def test_runsum_kernel_matches_plain(cuda_device, tail):
    """csrc/runsum.cu against the plain version: runs of 1..28 rows
    across the kernel's tiles, with and without a long trailing run (the
    sentinel run of invalid rows); within 1e-5 of the largest total (fp32
    sums in another order), bitwise equal totals within a run."""
    rng = np.random.default_rng(2)
    E, D = 55296, 768
    seg = np.repeat(np.arange(E), rng.integers(1, 29, E))[:E]
    if tail:
        seg[-tail:] = seg[-tail - 1] + 1
    fes = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    run_runsum(fes.to(cuda_device), torch.from_numpy(seg).to(cuda_device))


RUNSUM_CASES = ("run_is_one_tile", "runs_cross_one_boundary",
                "runs_cross_several_boundaries", "rows_not_whole_tiles",
                "one_row", "sentinel_at_end", "sentinel_at_start",
                "narrow_rows")


def runsum_case(case, seed=11):
    """(fes [E, D], seg [E]) of one of the run-sum kernel's edge cases, at
    its tile of wv3d_runsum_tile() rows."""
    rng = np.random.default_rng(seed)
    T = _native.lib().wv3d_runsum_tile()
    E, D = 64 * T, 768
    lens = rng.integers(1, 29, E)
    if case == "run_is_one_tile":
        lens = np.full(E, T)                       # runs = tiles exactly
    elif case == "runs_cross_one_boundary":
        lens = rng.integers(T // 2 + 1, T + T // 2, E)
    elif case == "runs_cross_several_boundaries":
        lens = rng.integers(2 * T + 1, 5 * T, E)
    elif case == "rows_not_whole_tiles":
        E = 64 * T - 37
    elif case == "one_row":
        E = 1
    elif case == "narrow_rows":
        D = 36                                     # part of a column block
    seg = np.repeat(np.arange(E), lens[:E])[:E]
    if case == "sentinel_at_end":
        seg[-8000:] = seg[-8001] + 1
    elif case == "sentinel_at_start":
        # the key of rows before the first valid row in
        # segment_softmax_weighted_sum_runsum
        seg[:8000] = -1
    fes = rng.normal(size=(E, D)).astype(np.float32)
    return fes, seg


@pytest.mark.parametrize("case", RUNSUM_CASES)
def test_runsum_kernel_edge_cases(cuda_device, case):
    """The run-sum's tile boundaries and long runs, against the plain
    version with the tolerance and bitwise check above."""
    fes, seg = runsum_case(case)
    run_runsum(torch.from_numpy(fes).to(cuda_device),
               torch.from_numpy(seg).to(cuda_device))


def test_runsum_kernel_rejects_what_it_cannot_take(cuda_device):
    fes = torch.zeros(64, 6, device=cuda_device)
    seg = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):              # D not a multiple of 4
        tseg.run_segment_sum_sorted(fes, seg)
    with pytest.raises(ValueError):              # one key short
        tseg.run_segment_sum_sorted(torch.zeros(64, 8, device=cuda_device),
                                    seg[:63])
    with pytest.raises(ValueError):              # keys on the CPU
        tseg.run_segment_sum_sorted(torch.zeros(64, 8, device=cuda_device),
                                    seg.cpu())
    with pytest.raises(ValueError):              # rows not 16-byte aligned
        tseg.run_segment_sum_sorted(
            torch.zeros(65 * 8, device=cuda_device)[1:513].view(64, 8), seg)


def _to_dev(case, dev, dtype):
    gmap, fmaps, coords, kk, jj, valid = case
    return (torch.from_numpy(gmap).to(dev, dtype),
            tuple(torch.from_numpy(f).to(dev, dtype) for f in fmaps),
            *(torch.from_numpy(a).to(dev) for a in (coords, kk, jj, valid)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["x32", "x16"])
@pytest.mark.parametrize("spread", [1.0, 12.0])
def test_region_fused_kernel_matches_plain(cuda_device, dtype, variant,
                                           spread):
    """csrc/corr_box.cu through the fused entries (#4 x32, #5 x16) against
    the plain region version and the exact oracle, within 1e-2 absolute
    (fp32 sums of 128 products, other order), with and without spilled
    pixels; the spill flags agree exactly."""
    g, pyr, c, k, j, v = _to_dev(corr_case(3, spread=spread), cuda_device,
                                 dtype)
    key = f"corr_region_fused_{variant}"
    n0 = _native.LAUNCHES[key]
    out, spill = tregion.region_corr_fused(g, pyr, c, k, j, v, variant)
    torch.cuda.synchronize()
    assert _native.LAUNCHES[key] == n0 + 1
    ref, ref_spill = tregion.region_corr_plain(g, pyr, c, k, j, v, variant)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)
    assert torch.equal(spill, ref_spill)
    assert bool(spill.any()) == (spread > 8)
    exact = tcorr.patch_corr_pyramid(g, pyr, c, k, j, valid=v)
    torch.testing.assert_close(out, exact, rtol=0, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_region_split_kernels_match_plain(cuda_device, dtype):
    """The split x16 pair: the surfaces producer (csrc/corr_box.cu, #2 on
    the split route) against the plain surfaces, the extract kernel (#6)
    against the plain extract on the same surfaces, both within 1e-2
    absolute; spilled edges included."""
    g, pyr, c, k, j, v = _to_dev(corr_case(4, spread=12.0), cuda_device,
                                 dtype)
    n0 = (_native.LAUNCHES["corr_region_surfaces"],
          _native.LAUNCHES["corr_region_extract"])
    surf = tregion.region_surfaces(g, pyr, c, k, j, v)
    out, spill = tregion.region_extract(surf, g, pyr, c, k, j, v)
    torch.cuda.synchronize()
    assert (_native.LAUNCHES["corr_region_surfaces"],
            _native.LAUNCHES["corr_region_extract"]) == (n0[0] + 1, n0[1] + 1)
    ref_surf = tregion.region_surfaces_plain(g, pyr, c, k, j, v)
    torch.testing.assert_close(surf, ref_surf, rtol=0, atol=1e-2)
    ref, ref_spill = tregion.region_extract_plain(surf, g, pyr, c, k, j, v)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-2)
    assert torch.equal(spill, ref_spill) and bool(spill.any())


EXTRACT_CASES = ("spill_level0_only", "spill_level1_only", "invalid_edges",
                 "map_border")


def extract_case(case, seed=13):
    """Inputs of one of the extract kernel's edge cases (numpy), on 96x128
    and 24x32 maps."""
    if case == "spill_level0_only":
        # pixels jittered by up to 5 px: windows up to 12 apart at level 1
        # (some spill), at most 4 apart at level 2 (all fit)
        return corr_case(seed, E=1024, spread=10.0)
    if case == "invalid_edges":
        gmap, fmaps, coords, kk, jj, _ = corr_case(seed, E=1024,
                                                   spread=10.0)
        valid = np.random.default_rng(seed).random(1024) > 0.5
        return gmap, fmaps, coords, kk, jj, valid
    if case == "map_border":
        # 1003 edges (not a multiple of the edges per block), centres
        # within 4 px of a border at level 1, compact or spread
        gmap, fmaps, coords, kk, jj, valid = corr_case(seed, E=1003,
                                                       spread=1.0)
        rng = np.random.default_rng(seed)
        E = coords.shape[0]
        near = lambda n, hi: np.where(rng.random(n) < 0.5,
                                      rng.uniform(-4, 4, n),
                                      rng.uniform(hi - 4, hi + 4, n))
        cx = np.where(rng.random(E) < 0.5, near(E, 128),
                      rng.uniform(0, 128, E))
        cy = np.where(rng.random(E) < 0.5, near(E, 96),
                      rng.uniform(0, 96, E))
        spread = np.where(rng.random(E) < 0.5, 1.0, 6.0)
        off = np.arange(3) - 1.0
        x = cx[:, None, None] + spread[:, None, None] * off[None, None, :]
        y = cy[:, None, None] + spread[:, None, None] * off[None, :, None]
        x = x + rng.uniform(-0.5, 0.5, (E, 3, 3))
        y = y + rng.uniform(-0.5, 0.5, (E, 3, 3))
        return (gmap, fmaps, np.stack([x, y], -1).astype(np.float32), kk, jj,
                valid)
    # spill_level1_only: eight pixels left of the map at level 1 (windows
    # off it), one right of it; at level 2 all nine overlap the map and
    # the right one lies 36 columns from the others, past the region
    gmap, fmaps, coords, kk, jj, valid = corr_case(seed, E=1024)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-15.9, -4.1, size=coords.shape[:3])
    x[:, 2, 2] = rng.uniform(128 + 3.1, 128 + 3.9, size=coords.shape[0])
    y = rng.uniform(8.0, 88.0, size=coords.shape[:3])
    return gmap, fmaps, np.stack([x, y], -1).astype(np.float32), kk, jj, valid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", EXTRACT_CASES)
def test_region_extract_edge_cases(cuda_device, case, dtype):
    """The extract kernel (#6) against the plain extract on the same
    surfaces and against the fused plain version, within 1e-2 absolute
    (fp32 sums of 128 products, other order), with equal spill flags; the
    case's spill pattern is checked on the geometry."""
    g, pyr, c, k, j, v = _to_dev(extract_case(case), cuda_device, dtype)
    surf = tregion.region_surfaces(g, pyr, c, k, j, v)
    n0 = _native.LAUNCHES["corr_region_extract"]
    out, spill = tregion.region_extract(surf, g, pyr, c, k, j, v)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["corr_region_extract"] == n0 + 1
    ref, ref_spill = tregion.region_extract_plain(surf, g, pyr, c, k, j, v)
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL_CORR_ABS)
    assert torch.equal(spill, ref_spill)
    full, _ = tregion.region_corr_plain(g, pyr, c, k, j, v, "x16")
    torch.testing.assert_close(out, full, rtol=0, atol=TOL_CORR_ABS)
    vb = v.bool()
    spills = [bool(tregion.geometry(c[vb] / s, "x16", f.shape[1],
                                    f.shape[2])[5].any())
              for f, s in zip(pyr, tcorr.LEVELS)]
    if case == "spill_level0_only":
        assert spills == [True, False]
    elif case == "spill_level1_only":
        assert spills == [False, True]
    elif case == "invalid_edges":
        assert not bool(out[~vb].any()) and not bool(spill[~vb].any())
        assert bool(spill.any())


SURF_CASES = ("map_edges", "map_smaller_than_region", "invalid_edges",
              "ragged_E", "one_edge")


def surfaces_case(case, seed=17):
    """Inputs of one of the surfaces producer's edge cases (numpy)."""
    if case == "map_smaller_than_region":
        # 12x16 and 3x4 maps: every region leaves the map
        return corr_case(seed, E=512, H=12, W=16, spread=3.0)
    if case == "ragged_E":
        # not a multiple of the edges per block
        return corr_case(seed, E=1003, spread=3.0)
    if case == "one_edge":
        return corr_case(seed, E=1, spread=3.0)
    gmap, fmaps, coords, kk, jj, valid = corr_case(seed, E=1024, spread=1.0)
    if case == "invalid_edges":
        return gmap, fmaps, coords, kk, jj, \
            np.random.default_rng(seed).random(1024) > 0.5
    # map_edges: a quarter of the edges each with centres within 3 px of
    # the top, bottom, left and right border (regions 5-11 rows or columns
    # off the map at level 1), compact patches
    rng = np.random.default_rng(seed)
    E, H, W = 1024, 96, 128
    side = np.arange(E) % 4
    near = rng.uniform(-3.0, 3.0, E)
    cy = np.where(side == 0, near, np.where(side == 1, H + near,
                                            rng.uniform(8, H - 8, E)))
    cx = np.where(side == 2, near, np.where(side == 3, W + near,
                                            rng.uniform(8, W - 8, E)))
    off = np.arange(3) - 1.0
    x = cx[:, None, None] + off[None, None, :]
    y = cy[:, None, None] + off[None, :, None]
    coords = np.stack(np.broadcast_arrays(x, y), -1).astype(np.float32)
    return gmap, fmaps, coords, kk, jj, valid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SURF_CASES)
def test_region_surfaces_edge_cases(cuda_device, case, dtype):
    """The surfaces producer (csrc/corr_box.cu, #2 on the split route)
    against the plain surfaces, within 1e-2 absolute on bf16 features
    (tensor-core sums of 128 exact products, other order) and 1e-4 on
    fp32 (fp32 FMAs); invalid edges give exactly zero planes; the extract
    on these surfaces equals the fused plain version within 1e-2."""
    g, pyr, c, k, j, v = _to_dev(surfaces_case(case), cuda_device, dtype)
    n0 = _native.LAUNCHES["corr_region_surfaces"]
    surf = tregion.region_surfaces(g, pyr, c, k, j, v)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["corr_region_surfaces"] == n0 + 1
    tol = TOL_CORR_ABS if dtype == torch.bfloat16 else 1e-4
    ref = tregion.region_surfaces_plain(g, pyr, c, k, j, v)
    torch.testing.assert_close(surf, ref, rtol=0, atol=tol)
    vb = v.bool()
    assert not bool(surf[~vb].any())
    out, _ = tregion.region_extract(surf, g, pyr, c, k, j, v)
    full, _ = tregion.region_corr_plain(g, pyr, c, k, j, v, "x16")
    torch.testing.assert_close(out, full, rtol=0, atol=TOL_CORR_ABS)
    if case == "map_edges":
        H, W = pyr[0].shape[1:3]
        _, _, oy, ox, _, _ = tregion.geometry(c, "x16", H, W)
        side = torch.arange(c.shape[0], device=c.device) % 4
        off = torch.stack([oy < 0, oy + 16 > H, ox < 0, ox + 16 > W], 1)
        assert bool(off.gather(1, side[:, None]).all())


def test_region_map_smaller_than_region(cuda_device):
    """A 3x4 level-2 map (the tiny slice's) is smaller than either region:
    zeros off the map, exact against the oracle in fp32."""
    g, pyr, c, k, j, v = _to_dev(corr_case(5, E=512, H=12, W=16, spread=3.0),
                                 cuda_device, torch.float32)
    exact = tcorr.patch_corr_pyramid(g, pyr, c, k, j, valid=v)
    for variant in ("x32", "x16"):
        out = tregion.region_corr_pyramid(g, pyr, c, k, j, v, variant)
        torch.testing.assert_close(out, exact, rtol=0, atol=1e-4)
    out = tregion.region_corr_pyramid(g, pyr, c, k, j, v, "x16", fused=False,
                                      extract="kernel")
    torch.testing.assert_close(out, exact, rtol=0, atol=1e-4)


def test_region_kernels_reject_what_they_cannot_take(cuda_device):
    g, pyr, c, k, j, v = _to_dev(corr_case(1, E=64, C=64), cuda_device,
                                 torch.float32)
    with pytest.raises(ValueError):              # 64 channels, not 128
        tregion.region_corr_pyramid(g, pyr, c, k, j, v, "x16")
    g, pyr, c, k, j, v = _to_dev(corr_case(1, E=64), cuda_device,
                                 torch.float32)
    with pytest.raises(ValueError):              # coords on the CPU
        tregion.region_corr_pyramid(g, pyr, c.cpu(), k, j, v, "x32")
    with pytest.raises(ValueError):              # surfaces on the CPU
        tregion.region_extract(torch.zeros(64, 2, 9, 16, 16), g, pyr, c, k,
                               j, v)
    n = 64 * 2 * 9 * 16 * 16
    surf = torch.zeros(n + 1, device=cuda_device)[1:].view(64, 2, 9, 16, 16)
    with pytest.raises(ValueError):              # surfaces not 16-byte aligned
        tregion.region_extract(surf, g, pyr, c, k, j, v)


BOX_CASES = ("box_at_capacity", "box_beyond_capacity", "mixed_box_per_pixel",
             "one_edge", "ragged_blocks", "tiny_map", "nan_and_huge",
             "all_invalid")


def _coords_from_offsets(rng, base, off, scale):
    """coords [E, 3, 3, 2] at level-1 scale whose window starts at the
    level of `scale` are base + off (base [E, 2] as (y, x), off [E, 3, 3, 2]
    integers as (y, x)); fractions drawn inside a pixel."""
    frac = rng.uniform(0.1, 0.9, size=off.shape) * scale
    yx = (base[:, None, None, :] + off) * scale + frac
    return np.ascontiguousarray(yx[..., ::-1]).astype(np.float32)


def box_case(case, seed=7):
    """Inputs of one case of the correlation body's edge cases (numpy)."""
    rng = np.random.default_rng(seed)
    if case in ("one_edge", "ragged_blocks"):
        # 1003 edges: not a multiple of the kernel's edges per block (a
        # power of two), so the last block takes fewer edges
        E = 1 if case == "one_edge" else 1003
        return corr_case(seed, E=E, spread=3.0)
    if case == "tiny_map":
        # /16 map 3x4 (the tiny slice's), smaller than the staged box
        return corr_case(seed, E=512, H=12, W=16, spread=3.0)
    gmap, fmaps, coords, kk, jj, valid = corr_case(seed, E=256, spread=1.0)
    E = coords.shape[0]
    if case in ("box_at_capacity", "box_beyond_capacity"):
        # window starts spread BOX - 8 apart (a BOX x BOX box) at level 1
        # for the first half of the edges and at level 2 for the second;
        # the last pixel one further in x for the case beyond the capacity
        span = tcorr.BOX - 8
        grid = np.array([0, span // 2, span])
        off = np.zeros((E, 3, 3, 2), dtype=np.int64)
        off[..., 0] = grid[None, :, None]
        off[..., 1] = grid[None, None, :]
        off[:, 2, 2, 1] = span + (case == "box_beyond_capacity")
        half = E // 2
        base1 = np.stack([rng.integers(4, 96 - 20, half),
                          rng.integers(4, 128 - 20, half)], -1)
        base2 = np.stack([rng.integers(0, 24 - 16, E - half),
                          rng.integers(0, 32 - 17, E - half)], -1)
        coords = np.concatenate([
            _coords_from_offsets(rng, base1 + 3, off[:half], 1.0),
            _coords_from_offsets(rng, base2 + 3, off[half:], 4.0)])
    elif case == "mixed_box_per_pixel":
        # every other edge spread 12 px: staged and per-pixel edges mixed
        # in one launch, and in one block
        wide = corr_case(seed, E=E, spread=12.0)[2]
        coords[1::2] = wide[1::2]
    elif case == "nan_and_huge":
        coords = coords.copy()
        coords[0:16] = np.nan                    # whole edges
        coords[16:32, 1, 2, 0] = np.nan          # one pixel's x
        coords[32:48] = 1e7
        coords[48:64] = -1e7
        coords[64:80, 0, 0] = (1e7, -1e7)        # one pixel far off
    elif case == "all_invalid":
        valid = np.zeros(E, dtype=bool)
    return gmap, fmaps, coords, kk, jj, valid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry", ["unfused", "x32", "x16"])
@pytest.mark.parametrize("case", BOX_CASES)
def test_corr_box_edge_cases(cuda_device, case, entry, dtype):
    """The one correlation body (csrc/corr_box.cu) through each of its
    three entry points against the exact plain version, within 1e-2
    absolute (NaN where the plain version has NaN), and with the spill
    flags of the plain region version; the staging plan of each geometric
    case is checked with `box_plan`."""
    g, pyr, c, k, j, v = _to_dev(box_case(case), cuda_device, dtype)
    key = "corr_pyramid" if entry == "unfused" else \
        f"corr_region_fused_{entry}"
    n0 = _native.LAUNCHES[key]
    if entry == "unfused":
        out, spill = tcorr.corr_lookup(g, pyr, c, k, j, v), None
    else:
        out, spill = tregion.region_corr_fused(g, pyr, c, k, j, v, entry)
    torch.cuda.synchronize()
    assert _native.LAUNCHES[key] == n0 + 1
    exact = tcorr.patch_corr_pyramid(g, pyr, c, k, j, valid=v)
    torch.testing.assert_close(out, exact, rtol=0, atol=TOL_CORR_ABS,
                               equal_nan=True)
    if spill is not None:
        _, ref_spill = tregion.region_corr_plain(g, pyr, c, k, j, v, entry)
        assert torch.equal(spill, ref_spill)
    half = c.shape[0] // 2
    plans = [tcorr.box_plan(c.cpu() / s, f.shape[1], f.shape[2])
             for f, s in zip(pyr, tcorr.LEVELS)]
    if case in ("box_at_capacity", "box_beyond_capacity"):
        for li, rows in ((0, slice(0, half)), (1, slice(half, None))):
            cls, box = plans[li]
            assert (box[rows, 2:] == tcorr.BOX).all()
            beyond = (cls[rows] == 2).any(1)
            assert bool(beyond.all()) == (case == "box_beyond_capacity")
    elif case == "mixed_box_per_pixel":
        per_pixel = (plans[0][0] == 2).any(1)
        assert bool(per_pixel[1::2].any()) and not bool(per_pixel[0::2].any())
    elif case == "all_invalid":
        assert not bool(out.any())



TOL_CORR_GRAD_REL = 1e-5
GRAD_CASES = ("spread", "box_at_capacity", "box_beyond_capacity",
              "mixed_box_per_pixel", "one_edge", "ragged_blocks", "tiny_map",
              "nan_and_huge_invalid", "all_invalid")


def grad_case(case):
    """A backward case: the correlation body's edge cases, the NaN ones
    on invalid rows only (the rows the training forward drops)."""
    if case == "spread":
        return corr_case(3, E=2048, spread=3.0)
    if case != "nan_and_huge_invalid":
        return box_case(case)
    gmap, fmaps, coords, kk, jj, valid = box_case("nan_and_huge")
    valid = valid.copy()
    valid[0:32] = False                  # the rows with NaN coordinates
    return gmap, fmaps, coords, kk, jj, valid


@pytest.mark.parametrize("case", GRAD_CASES)
def test_corr_backward_kernel_matches_autograd(cuda_device, case):
    """csrc/corr_grad.cu through corr_lookup's autograd Function against
    autograd through the plain version, fp32: each gradient within 1e-5
    of its largest magnitude (fp32 atomics add in the order the warps
    arrive; the plain version sums in another order)."""
    g, pyr, c, k, j, v = _to_dev(grad_case(case), cuda_device,
                                 torch.float32)
    rng = np.random.default_rng(1)
    go = torch.from_numpy(rng.normal(size=(c.shape[0], 882))
                          .astype(np.float32)).to(cuda_device)
    leaves = [t.clone().requires_grad_() for t in (g, *pyr)]
    n0 = _native.LAUNCHES["corr_pyramid_backward"]
    out = tcorr.corr_lookup(leaves[0], tuple(leaves[1:]), c, k, j, v)
    out.backward(go)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["corr_pyramid_backward"] == n0 + 1
    ref = tcorr.corr_pyramid_backward_plain(go, g, pyr, c, k, j, v)
    for leaf, r in zip(leaves, ref):
        assert torch.isfinite(leaf.grad).all()
        err = (leaf.grad - r).abs().max().item()
        assert err <= TOL_CORR_GRAD_REL * r.abs().max().item(), (case, err)
    if case == "all_invalid":
        assert not any(bool(leaf.grad.any()) for leaf in leaves)


def test_corr_gradient_rejects_what_it_cannot_take(cuda_device):
    """Coordinates that need a gradient, and bf16 features that need one,
    raise; bf16 features without one (the SLAM path) still run; a kernel
    with no backward raises on an input that needs a gradient."""
    g, pyr, c, k, j, v = _to_dev(corr_case(0, E=64), cuda_device,
                                 torch.float32)
    with pytest.raises(ValueError, match="coords"):
        tcorr.corr_lookup(g, pyr, c.clone().requires_grad_(), k, j, v)
    gb = g.to(torch.bfloat16).requires_grad_()
    pyr_b = tuple(f.to(torch.bfloat16) for f in pyr)
    with pytest.raises(TypeError, match="fp32"):
        tcorr.corr_lookup(gb, pyr_b, c, k, j, v)
    out = tcorr.corr_lookup(gb.detach(), pyr_b, c, k, j, v)
    assert out.shape == (64, 882) and not out.requires_grad
    fes = torch.zeros(64, 768, device=cuda_device, requires_grad=True)
    seg = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="gradient"):
        tseg.run_segment_sum_sorted(fes, seg)

@pytest.mark.parametrize("d", [1, 2, 7, 8, 9, 15, 16, 17, 33, 54, 72, 100,
                               128, 255, 256])
def test_chol_kernel_matches_plain(cuda_device, d):
    """csrc/chol.cu against cholesky_ex + cholesky_solve on the card, with
    the tolerance of the JAX package's chol test (rtol 2e-4, atol 2e-5),
    across the edges of its 16-column panels (ragged last panels)."""
    rng = np.random.default_rng(d)
    A = rng.normal(size=(d, d)).astype(np.float32)
    S = torch.from_numpy(A @ A.T + d * np.eye(d, dtype=np.float32))
    y = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    S, y = S.to(cuda_device), y.to(cuda_device)
    n0 = _native.LAUNCHES["chol_solve"]
    x = tchol.chol_solve_small(S, y)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["chol_solve"] == n0 + 1
    torch.testing.assert_close(x, tchol.chol_solve_small_plain(S, y),
                               rtol=2e-4, atol=2e-5)
    bad = tchol.chol_solve_small(-torch.eye(d, device=cuda_device), y)
    assert torch.isnan(bad).all()


def test_chol_kernel_rejects_what_it_cannot_take(cuda_device):
    with pytest.raises(ValueError):              # D > 256
        tchol.chol_solve_small(torch.eye(257, device=cuda_device),
                               torch.ones(257, device=cuda_device))
    with pytest.raises(ValueError):              # y on the CPU
        tchol.chol_solve_small(torch.eye(8, device=cuda_device),
                               torch.ones(8))


def test_chol_kernel_ill_conditioned(cuda_device):
    """An SPD S with condition number 1e4 (eigenvalues 1 .. 1e4): the
    kernel and the plain version each lie within about kappa * 2^-24 of the
    exact solution, so within 2 kappa 2^-24 (1.2e-3) of the largest |x| of
    each other; the kernel's residual is that of a backward-stable
    solve, below 1e-5 of |S| |x|."""
    rng = np.random.default_rng(23)
    d = 72
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    S64 = (Q * np.logspace(0, 4, d)) @ Q.T
    S = torch.from_numpy(((S64 + S64.T) / 2).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    x = tchol.chol_solve_small(S.to(cuda_device), y.to(cuda_device))
    ref = tchol.chol_solve_small_plain(S.to(cuda_device), y.to(cuda_device))
    torch.cuda.synchronize()
    kappa = float(np.linalg.cond(S.double().numpy()))
    assert 0.5e4 < kappa < 2e4
    tol = 2 * kappa * 2.0 ** -24 * ref.abs().max().item()
    assert (x - ref).abs().max().item() <= tol
    xd, Sd = x.double().cpu(), S.double()
    resid = (Sd @ xd - y.double()).norm() / (
        torch.linalg.matrix_norm(Sd, 2) * xd.norm())
    assert resid.item() < 1e-5


def not_spd(kind):
    """A symmetric S that is not SPD, by where its first non-positive
    pivot falls (as tests/test_torch_chol.py builds them): -I, 0, a
    negative last pivot of the first panel, a zero pivot at the last index
    only, a negative pivot at the first and at the last column of the
    second panel."""
    if kind == "minus-identity":
        return -torch.eye(16)
    if kind == "zero":
        return torch.zeros(16, 16)
    if kind == "last-pivot":
        return torch.diag(torch.cat([torch.ones(15), -torch.ones(1)]))
    d = 72 if kind == "zero-last-pivot" else 40
    rng = np.random.default_rng(d)
    A = rng.normal(size=(d, d)).astype(np.float32)
    S = torch.from_numpy(A @ A.T + d * np.eye(d, dtype=np.float32))
    if kind == "zero-last-pivot":
        S[-1, :] = 0.0
        S[:, -1] = 0.0
    else:
        k = {"negative-panel-first": 16, "negative-panel-last": 31}[kind]
        S[k, k] = -S[k, k]
    return S


@pytest.mark.parametrize("kind", ["minus-identity", "zero", "last-pivot",
                                  "zero-last-pivot", "negative-panel-first",
                                  "negative-panel-last"])
def test_chol_kernel_not_spd_gives_nan(cuda_device, kind):
    """A non-positive pivot anywhere makes all of x NaN, as in the plain
    version."""
    S = not_spd(kind)
    x = tchol.chol_solve_small(S.to(cuda_device),
                               torch.ones(S.shape[0], device=cuda_device))
    assert torch.isnan(x).all()


def _replayed(fn):
    """(eager result, result of a CUDA graph of fn replayed twice, the
    launches the capture recorded, LAUNCHES before and after the replays):
    the wrappers' counts come from `_native.captured_launches` and
    `_native.add_launches`, as the frame step's graphs count them."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(_native.LAUNCHES)
    with _native.captured_launches() as rec, torch.cuda.graph(graph):
        out = fn()
    assert _native.LAUNCHES == before        # capturing launches nothing
    for _ in range(2):
        graph.replay()
        _native.add_launches(rec)
    torch.cuda.synchronize()
    return eager, out, rec, before, dict(_native.LAUNCHES)


@pytest.mark.parametrize("entry", ["corr_pyramid", "corr_region_fused_x32",
                                   "corr_region_fused_x16"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_corr_body_replayed_from_a_graph(cuda_device, entry, dtype):
    """The correlation body (csrc/corr_box.cu) through each entry, captured
    in a CUDA graph (its shared-memory attributes set once per process,
    before the capture) and replayed: within 1e-6 of its eager launch, the
    same spill flags, one launch counted per replay."""
    g, pyr, c, k, j, v = _to_dev(corr_case(5, spread=12.0), cuda_device,
                                 dtype)
    if entry == "corr_pyramid":
        def fn():
            return tcorr.corr_lookup(g, pyr, c, k, j, v), None
    else:
        def fn():
            return tregion.region_corr_fused(g, pyr, c, k, j, v, entry[-3:])
    (e_out, e_spill), (g_out, g_spill), rec, before, after = _replayed(fn)
    torch.testing.assert_close(g_out, e_out, rtol=0, atol=1e-6)
    if e_spill is not None:
        assert torch.equal(g_spill, e_spill) and bool(e_spill.any())
    assert rec[entry] == 1 and sum(rec.values()) == 1
    assert after[entry] == before[entry] + 2


def test_runsum_replayed_from_a_graph(cuda_device):
    """The run-sum (csrc/runsum.cu, its second pass a programmatic
    dependent launch, a programmatic edge in the graph) replayed from a
    CUDA graph: bitwise its eager launch, every row of a run holding the
    bitwise same total, one launch counted per replay."""
    rng = np.random.default_rng(7)
    E, D = 55296, 768
    seg = np.repeat(np.arange(E), rng.integers(1, 29, E))[:E]
    seg[-8000:] = seg[-8001] + 1
    fes = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32)).to(
        cuda_device)
    seg_t = torch.from_numpy(seg).to(cuda_device, torch.int32)
    eager, out, rec, before, after = _replayed(
        lambda: tseg.run_segment_sum_sorted(fes, seg_t))
    assert torch.equal(out, eager)
    assert torch.equal(out, out[tseg.run_first_rows(seg_t)])
    assert rec["runsum"] == 1 and sum(rec.values()) == 1
    assert after["runsum"] == before["runsum"] + 2


def test_depth_mask_step_replayed_matches_sync_mode(cuda_device):
    """The steady step with a depth prior and a mask on every frame
    (graphs keyed by the (depth, mask, descriptors) signature) replayed
    on the card,
    against `sync_mode` on the card over the same rendered wild frames:
    poses within 1e-4 (chip_smoke.py's TOL_GRAPH_SYNC; BA's card sums are
    fp64, so they read equal there), the same keyframe drops."""
    from wild_video_3d_reconstruction_torch.eval import synth_ate
    from wild_video_3d_reconstruction_torch.slam import DPVO
    from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig

    ht, wd = 48, 64
    images, _, intr, depths, masks = synth_ate.wild_sequence(
        0, frames=16, ht=ht, wd=wd, fx=40.0, fy=40.0)
    cfg = DPVOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
                     OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3,
                     KEYFRAME_INDEX=2, MEM=12, GRADIENT_BIAS=False,
                     MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0)
    out = {}
    for sync in (False, True):
        slam = DPVO(cfg, None, ht, wd, device="cuda", sync_mode=sync)
        for t in range(len(images)):
            slam(t, images[t], intr, depth=depths[t], mask=masks[t])
        out[sync] = (slam.terminate()[0], sorted(slam.delta),
                     dict(slam.runner.replays))
    replays = out[False][2]
    assert sum(replays.values()) == 6 and not out[True][2]
    assert {sig for _, sig in replays} == {(True, True, False)}
    np.testing.assert_allclose(out[False][0], out[True][0], rtol=0,
                               atol=1e-4)
    assert out[False][1] == out[True][1]


def _wild_pair(ht, wd):
    from wild_video_3d_reconstruction_torch.eval import synth_ate

    images = synth_ate.wild_sequence(0, frames=3, ht=ht, wd=wd,
                                     fx=320.0 * wd / 512,
                                     fy=320.0 * wd / 512)[0]
    return images[0], images[2]


@pytest.mark.parametrize("hw", [(96, 128), (384, 512)])
def test_farneback_on_the_card_matches_the_cpu(cuda_device, hw):
    """`init/farneback.py` on the card against the CPU: gray bitwise,
    flow within 1e-3 px (fp32 filter sums in other orders), Laplacian
    variance within 1e-9 relative."""
    from wild_video_3d_reconstruction_torch.init import farneback as tfb

    a, b = (torch.from_numpy(x) for x in _wild_pair(*hw))
    g = [tfb.bgr_to_gray(x) for x in (a, b)]
    gc = [tfb.bgr_to_gray(x.to(cuda_device)) for x in (a, b)]
    for x, y in zip(g, gc):
        assert torch.equal(x, y.cpu())
    ref = tfb.farneback_flow(*g)
    got = tfb.farneback_flow(*gc).cpu()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)
    lv, lc = float(tfb.laplacian_var(g[0])), float(tfb.laplacian_var(gc[0]))
    assert abs(lv - lc) <= 1e-9 * lv


def test_lk_and_dense_ba_on_the_card_match_the_cpu(cuda_device):
    """`track_grid` (LK of a stride-8 grid over 4 frames): ok shares
    within 1%, the points tracked on both within 1e-3 px (99%; the rest
    are ill-conditioned windows, where fp32 rounding moves LK by up to
    0.2 px), and one `dense_ba` call (1e-3: fp32 sums in other orders;
    1e-9 in fp64) on the card against the CPU."""
    from wild_video_3d_reconstruction_torch.eval import synth_ate
    from wild_video_3d_reconstruction_torch.init import mast3r_init as tmi
    from wild_video_3d_reconstruction_torch.ops import dense as tdense
    from wild_video_3d_reconstruction_torch.ops import lie as tlie

    frames = list(synth_ate.wild_sequence(0, frames=4, ht=96, wd=128,
                                          fx=80.0, fy=80.0)[0])
    _, tr_c, ok_c = tmi.track_grid(frames, device=cuda_device)
    _, tr_h, ok_h = tmi.track_grid(frames, device="cpu")
    assert abs(ok_c.mean() - ok_h.mean()) <= 0.01
    both = ok_c & ok_h
    err = np.linalg.norm(tr_c[both] - tr_h[both], axis=-1)
    assert (err <= 1e-3).mean() >= 0.99 and np.median(err) < 1e-4, err.max()

    rng = np.random.default_rng(0)
    n, ht, wd = 4, 24, 32
    xi = rng.normal(0, 0.05, (n, 6)).astype(np.float32)
    xi[0] = 0
    poses = tlie.se3_exp(torch.from_numpy(xi))
    disps = torch.from_numpy(rng.uniform(0.2, 1.0, (n, ht, wd)).astype(
        np.float32))
    intr = torch.tensor([30.0, 30.0, wd / 2, ht / 2])
    ii = torch.tensor([0, 1, 1, 2, 2, 3, 0, 3])
    jj = torch.tensor([1, 0, 2, 1, 3, 2, 2, 1])
    coords, _ = tdense.projmap(poses, disps, intr, ii, jj)
    tgt = coords + torch.from_numpy(rng.normal(0, 0.5, coords.shape).astype(
        np.float32))
    wgt = torch.from_numpy(rng.uniform(0.2, 1.0, tgt.shape).astype(
        np.float32))
    args = (poses, disps, intr, tgt, wgt, ii, jj)
    p_ref, d_ref = tdense.dense_ba(*args, t0=1, t1=n, stride=4)
    p_got, d_got = tdense.dense_ba(*(t.to(cuda_device) for t in args),
                                   t0=1, t1=n, stride=4)
    torch.testing.assert_close(p_got.cpu(), p_ref, rtol=0, atol=1e-3)
    torch.testing.assert_close(d_got.cpu(), d_ref, rtol=0, atol=1e-3)
    # in fp64 the summation orders no longer show: the same function
    args64 = [t.double() if t.is_floating_point() else t for t in args]
    p_ref, d_ref = tdense.dense_ba(*args64, t0=1, t1=n, stride=4)
    p_got, d_got = tdense.dense_ba(*(t.to(cuda_device) for t in args64),
                                   t0=1, t1=n, stride=4)
    torch.testing.assert_close(p_got.cpu(), p_ref, rtol=0, atol=1e-9)
    torch.testing.assert_close(d_got.cpu(), d_ref, rtol=0, atol=1e-9)
