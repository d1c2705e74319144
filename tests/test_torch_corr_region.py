"""Port parity: the region correlation route (`PALLAS_FUSED`) on the CPU.

`ops/corr_region.py`'s plain versions against the port's exact
`patch_corr_pyramid`, the JAX package's exact `ops/corr.py` and its fused
and split Pallas kernels, which run here in interpret mode as the JAX
package's own tests run them.

Tolerances: 1e-4 of the largest |reference| against the exact versions
(fp32 products of 128 channels summed in another order); 2e-2 of it
against the Pallas kernels, which round the features and the surfaces to
bf16 (the tolerance of `tests/test_pallas_corr.py`), compared only on
inputs where the JAX clip count is 0 (the TPU kernels zero the windows of
clipped pixels, which the port computes).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops import corr as tcorr
from wild_video_3d_reconstruction_torch.ops import corr_region as tregion
from wild_video_3d_reconstruction_tpu.ops import corr as jcorr
from wild_video_3d_reconstruction_tpu.ops import pallas_corr

TOL_EXACT = 1e-4
TOL_PALLAS = 2e-2
ROUTES = [("x32", True, None), ("x16", True, None), ("x16", False, "kernel")]
ROUTE_IDS = ["fused-x32", "fused-x16", "split-x16"]


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels in interpret mode, with 8-edge blocks: the
    blocking changes how the kernels tile the edges, not what they
    compute, and keeps the interpreted per-edge loops short."""
    orig = pallas_corr.pl.pallas_call
    monkeypatch.setattr(pallas_corr.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_corr, "EB", 8)


def make_case(seed, E=32, S=32, F=2, H=32, W=48, C=128, spacing=1.0,
              jitter=1.0, margin=-3.0):
    """Edges whose 3x3 patch pixels lie `spacing` px apart (plus a uniform
    jitter of +-jitter/2), centres from `margin` px inside the map (a
    negative margin reaches past the border)."""
    rng = np.random.default_rng(seed)
    gmap = rng.normal(size=(S, C, 3, 3)).astype(np.float32)
    fmap1 = rng.normal(size=(F, H, W, C)).astype(np.float32)
    fmap2 = rng.normal(size=(F, H // 4, W // 4, C)).astype(np.float32)
    cx = rng.uniform(margin, W - margin, size=E)
    cy = rng.uniform(margin, H - margin, size=E)
    off = spacing * (np.arange(3) - 1.0)
    jit = jitter * rng.uniform(-0.5, 0.5, size=(E, 3, 3, 2))
    x = cx[:, None, None] + off[None, None, :] + jit[..., 0]
    y = cy[:, None, None] + off[None, :, None] + jit[..., 1]
    coords = np.stack([x, y], -1).astype(np.float32)
    kk = rng.integers(0, S, E)
    jj = rng.integers(0, F, E)
    valid = rng.random(E) > 0.1
    return gmap, (fmap1, fmap2), coords, kk, jj, valid


def to_t(case):
    gmap, pyr, coords, kk, jj, valid = case
    t = torch.from_numpy
    return (t(gmap), tuple(t(f) for f in pyr), t(coords), t(kk), t(jj),
            t(valid))


def region(case, variant, fused, extract, **kw):
    return tregion.region_corr_pyramid(*to_t(case), variant, fused=fused,
                                       extract=extract, **kw)


@functools.lru_cache(maxsize=None)
def jax_pallas_cached(seed, case_kw, **kw):
    return jax_pallas(make_case(seed, **dict(case_kw)), **kw)


def jax_pallas(case, **kw):
    gmap, pyr, coords, kk, jj, valid = case
    out, clips = pallas_corr.patch_corr_pyramid_pallas(
        jnp.asarray(gmap), tuple(map(jnp.asarray, pyr)), jnp.asarray(coords),
        jnp.asarray(kk), jnp.asarray(jj), valid=jnp.asarray(valid),
        return_clip_count=True, **kw)
    return np.asarray(out), int(clips)


def jax_exact(case):
    gmap, pyr, coords, kk, jj, valid = case
    return np.asarray(jcorr.patch_corr_pyramid(
        jnp.asarray(gmap), tuple(map(jnp.asarray, pyr)), jnp.asarray(coords),
        jnp.asarray(kk), jnp.asarray(jj), valid=jnp.asarray(valid)))


def rel_err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("variant,fused,extract", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("spacing,spills", [(1.0, False), (6.0, True)],
                         ids=["bounded", "spread"])
def test_region_matches_port_oracle(variant, fused, extract, spacing,
                                    spills):
    """Equal to the port's exact patch_corr_pyramid in fp32 for patches
    that fit the region and for patches spread past 8 px, which take the
    spill path."""
    case = make_case(0, spacing=spacing)
    out, n_spill = region(case, variant, fused, extract,
                          return_spill_count=True)
    t = to_t(case)
    ref = tcorr.patch_corr_pyramid(*t[:5], valid=t[5])
    assert out.shape == (32, 882) and out.dtype == torch.float32
    assert rel_err(out, ref) <= TOL_EXACT
    assert (n_spill > 0) == spills


@pytest.mark.parametrize("variant", ["x32", "x16"])
def test_fused_matches_jax_fused_kernel(interpret, variant):
    """Against the JAX fused Pallas kernel (#4 x32, #5 x16) on bounded
    spread, where it clips nothing; the port spills nothing either."""
    case = make_case(1, margin=6.0)
    ref, clips = jax_pallas(case, fused=True, variant=variant)
    assert clips == 0
    out, n_spill = region(case, variant, True, None, return_spill_count=True)
    assert n_spill == 0
    assert rel_err(out, ref) <= TOL_PALLAS


def test_split_matches_jax_extract_kernel(interpret):
    """The split x16 path against the JAX surfaces + `_extract_kernel4`
    route (#6)."""
    case = make_case(2, margin=6.0)
    ref, clips = jax_pallas(case, variant="x16", extract="pallas")
    assert clips == 0
    out = region(case, "x16", False, "kernel")
    assert rel_err(out, ref) <= TOL_PALLAS


@pytest.mark.parametrize("variant,fused,extract", ROUTES, ids=ROUTE_IDS)
def test_exact_where_jax_fused_clips(interpret, variant, fused, extract):
    """On spread patches the JAX fused kernel clips edges (zeroed windows);
    the port equals the JAX package's exact ops/corr.py there, and its
    spill count equals the JAX clip count (interior edges: both packages
    split pixels alike)."""
    case_kw = (("spacing", 4.0), ("jitter", 3.0), ("margin", 8.0))
    case = make_case(3, **dict(case_kw))
    _, clips = jax_pallas_cached(3, case_kw, fused=True, variant=variant)
    assert clips > 0
    out, n_spill = region(case, variant, fused, extract,
                          return_spill_count=True)
    assert rel_err(out, jax_exact(case)) <= TOL_EXACT
    assert n_spill == clips


@pytest.mark.parametrize("variant,fused,extract", ROUTES, ids=ROUTE_IDS)
def test_valid_mask_and_dead_rows(variant, fused, extract):
    """Invalid edges give zero rows and no spill, as on the SLAM path,
    where their coordinates are zeroed."""
    gmap, pyr, coords, kk, jj, valid = make_case(4, spacing=6.0)
    valid[::2] = False
    coords[~valid] = 0.0
    case = (gmap, pyr, coords, kk, jj, valid)
    out, n_spill = region(case, variant, fused, extract,
                          return_spill_count=True)
    out = out.numpy()
    assert np.all(out[~valid] == 0)
    assert np.abs(out[valid]).max(axis=1).min() > 0
    assert 0 < n_spill <= valid.sum()
    t = to_t(case)
    ref = tcorr.patch_corr_pyramid(*t[:5], valid=t[5])
    assert rel_err(out, ref) <= TOL_EXACT


@pytest.mark.parametrize("variant,fused,extract", ROUTES, ids=ROUTE_IDS)
def test_map_edges_and_map_smaller_than_region(variant, fused, extract):
    """Region origins that clip at both edges of the map (centres up to
    6 px outside it), a 3x4 level-2 map smaller than either region, and a
    1e7 px coordinate: exact in fp32."""
    gmap, pyr, coords, kk, jj, valid = make_case(
        5, H=12, W=16, spacing=2.0, jitter=2.0, margin=-6.0)
    coords[0, 0, 0] = (1e7, -1e7)
    case = (gmap, pyr, coords, kk, jj, valid)
    out = region(case, variant, fused, extract)
    t = to_t(case)
    ref = tcorr.patch_corr_pyramid(*t[:5], valid=t[5])
    assert rel_err(out, ref) <= TOL_EXACT
    assert rel_err(out, jax_exact(case)) <= TOL_EXACT


@pytest.mark.parametrize("variant", ["x32", "x16"])
def test_lookup_fused_takes_plain_route_on_cpu(variant):
    """corr_lookup(fused=True) on CPU tensors is the region route's plain
    version, launches nothing, and agrees with the unfused lookup."""
    gmap, pyr, coords, kk, jj, valid = to_t(make_case(6, spacing=3.0))
    before = dict(_native.LAUNCHES)
    out = tcorr.corr_lookup(gmap, pyr, coords, kk, jj, valid, fused=True,
                            variant=variant)
    assert _native.LAUNCHES == before
    ref = tregion.region_corr_pyramid(gmap, pyr, coords, kk, jj, valid,
                                      variant)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    unfused = tcorr.corr_lookup(gmap, pyr, coords, kk, jj, valid)
    assert rel_err(out, unfused) <= TOL_EXACT


def test_bf16_features_computed_from_stored_values():
    """bf16 features (mixed precision) are computed in fp32 from the
    stored values, as the exact plain version computes them."""
    gmap, pyr, coords, kk, jj, valid = to_t(make_case(7, spacing=6.0))
    g16 = gmap.to(torch.bfloat16)
    p16 = tuple(f.to(torch.bfloat16) for f in pyr)
    for variant, fused, extract in ROUTES:
        out = tregion.region_corr_pyramid(g16, p16, coords, kk, jj, valid,
                                          variant, fused=fused,
                                          extract=extract)
        ref = tcorr.patch_corr_pyramid(g16.float(),
                                       tuple(f.float() for f in p16),
                                       coords, kk, jj, valid=valid)
        assert rel_err(out, ref) <= TOL_EXACT


def test_split_surfaces_are_the_region_products():
    """The split path's surfaces are <g_p, fmap[oy + y, ox + x]> over the
    16x16 region at the exact origin, zero off the map and for invalid
    edges."""
    gmap, pyr, coords, kk, jj, valid = to_t(make_case(8, E=6, margin=-2.0))
    surf = tregion.region_surfaces(gmap, pyr, coords, kk, jj, valid)
    assert surf.shape == (6, 2, 9, 16, 16)
    for e in range(6):
        for li, (fmap, s) in enumerate(zip(pyr, (1, 4))):
            c = coords[e] / s
            oy = int(torch.floor(c[..., 1]).min()) - 3
            ox = int(torch.floor(c[..., 0]).min()) - 3
            F, H, W, C = fmap.shape
            ref = torch.zeros(9, 16, 16)
            for y in range(16):
                for x in range(16):
                    if 0 <= oy + y < H and 0 <= ox + x < W:
                        ref[:, y, x] = gmap[kk[e]].reshape(C, 9).T @ \
                            fmap[jj[e], oy + y, ox + x]
            ref = ref if valid[e] else torch.zeros_like(ref)
            torch.testing.assert_close(surf[e, li], ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(variant="x64"),
                                dict(variant="x32", fused=False,
                                     extract="kernel"),
                                dict(variant="x16", fused=False),
                                dict(variant="x16", extract="kernel")])
def test_route_arguments_are_checked(kw):
    with pytest.raises(ValueError):
        tregion.region_corr_pyramid(*to_t(make_case(9, E=4)), **kw)


def test_extract_surfaces_are_checked():
    """The extract kernel takes x16 surfaces [E, 2, 9, 16, 16] in fp32."""
    tregion.check_surfaces("extract", torch.zeros(5, 2, 9, 16, 16), 5)
    with pytest.raises(ValueError):              # one edge short
        tregion.check_surfaces("extract", torch.zeros(4, 2, 9, 16, 16), 5)
    with pytest.raises(ValueError):              # x32 surfaces
        tregion.check_surfaces("extract", torch.zeros(5, 2, 9, 16, 32), 5)
    with pytest.raises(TypeError):               # bf16 surfaces
        tregion.check_surfaces("extract", torch.zeros(
            5, 2, 9, 16, 16, dtype=torch.bfloat16), 5)


def jax_surfaces4(gmap, fmap, coords, kk, jj, eb=8):
    """The JAX x16 surfaces kernel `_surfaces4` (#2 on the split route) on
    one level, called as `patch_corr_pyramid_pallas` calls it (padded map,
    frame buckets, the clamped origin): (surfaces [E, 9, 256] fp32 from
    its bf16 output, origin (oy, ox) [E, 2] in map coordinates)."""
    P, RSH, RSW, RSW4 = (pallas_corr.PAD, pallas_corr.RSH, pallas_corr.RSW,
                         pallas_corr.RSW4)
    E = coords.shape[0]
    S, C = gmap.shape[:2]
    F, H, W, _ = fmap.shape
    pad_h = max(P, RSH - (H + P))
    pad_w = max(P, RSW - (W + P))
    pad_w += -(W + P + pad_w) % 16
    fmap_pad = jnp.pad(jnp.asarray(fmap, jnp.bfloat16),
                       ((0, 0), (P, pad_h), (P, pad_w), (0, 0)))
    Hp, Wp = H + P + pad_h, W + P + pad_w
    ys = np.floor(coords[..., 1]).astype(np.int32).reshape(E, 9) - 3 + P
    xs = np.floor(coords[..., 0]).astype(np.int32).reshape(E, 9) - 3 + P
    oy = np.clip(ys.min(1), 0, Hp - RSH)
    ox = np.clip(xs.min(1), 0, Wp - RSW4)
    ox16 = np.clip(ox // 16 * 16, 0, (Wp - RSW) // 16 * 16)
    origin = jnp.asarray(np.concatenate(
        [np.stack([oy, ox16, ox - ox16], -1), np.zeros((1, 3))]), jnp.int32)
    n_slots = -(-E // eb) * eb + (F + 1) * eb
    slot_edge, slot_of_edge, block_meta = pallas_corr._bucket_by_frame(
        jnp.asarray(jj, jnp.int32), F, n_slots, eb=eb)
    g = np.moveaxis(gmap, 1, -1).reshape(S, 9, C)
    g = jnp.asarray(np.pad(g, ((0, 1), (0, 7), (0, 0))), jnp.bfloat16)
    kk_pad = jnp.concatenate([jnp.asarray(kk, jnp.int32),
                              jnp.full((1,), S, jnp.int32)])
    surf = pallas_corr._surfaces4(fmap_pad, block_meta, origin[slot_edge],
                                  g[kk_pad[slot_edge]], n_slots)
    surf = np.asarray(surf.astype(jnp.float32))[np.asarray(slot_of_edge)]
    return surf, np.stack([oy, ox], -1) - P


@pytest.mark.parametrize("side", ["top", "bottom", "left", "right"])
def test_surfaces_match_jax_surfaces4(interpret, side):
    """`region_surfaces` on the CPU against the JAX surfaces kernel in
    interpret mode, on regions partly off the map at one side (5-8 of
    their 16 rows or columns at level 1). bf16-valued features: the JAX
    kernel's one rounding is its bf16 output, within TOL_PALLAS of the
    largest |surface|. JAX clamps the origin to its padded map: the
    (edge, level) pairs it moved are not compared (at level 1 none is; at
    the 8x12 level 2, all of the bottom case's)."""
    gmap, (f1, f2), coords, kk, jj, _ = make_case(10, E=8)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    gmap, f1, f2 = bf(gmap), bf(f1), bf(f2)
    H, W = f1.shape[1:3]
    rng = np.random.default_rng(11)
    lo = {"top": -2.0, "left": -2.0, "bottom": H - 6.0, "right": W - 6.0}
    near = rng.uniform(lo[side], lo[side] + 2.0, size=8)
    inner = rng.uniform(8.0, min(H, W) - 8.0, size=8)
    cx, cy = (near, inner) if side in ("left", "right") else (inner, near)
    off = np.arange(3) - 1.0
    coords = np.stack(np.broadcast_arrays(
        cx[:, None, None] + off[None, None, :],
        cy[:, None, None] + off[None, :, None]), -1).astype(np.float32)
    valid = np.ones(8, bool)
    surf = tregion.region_surfaces(*to_t((gmap, (f1, f2), coords, kk, jj,
                                          valid))).numpy()
    for li, (fmap, s) in enumerate(((f1, 1), (f2, 4))):
        ref, origin = jax_surfaces4(gmap, fmap, coords / s, kk, jj)
        ys, xs, oy, ox, _, _ = tregion.geometry(
            torch.from_numpy(coords / s), "x16", *fmap.shape[1:3])
        same = (origin[:, 0] == oy.numpy()) & (origin[:, 1] == ox.numpy())
        if li == 0:
            assert same.all()
            edge = {"top": oy < 0, "left": ox < 0, "bottom": oy + 16 > H,
                    "right": ox + 16 > W}[side]
            assert bool(edge.all())
        if same.any():
            out = surf[same, li].reshape(-1, 9, 256)
            assert np.abs(out - ref[same]).max() <= \
                TOL_PALLAS * np.abs(ref[same]).max()
