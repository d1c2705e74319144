"""Port parity: the two SoftAgg forms that no path takes (the member-table
and the sorted-cumsum forms of the JAX package's `ops/segment.py`) and
`update_forward` with a per-patch `kk_table`, against the JAX package.

The table form sums over axis 1 in another order than the JAX one, so
it is held to 1e-5 absolute on softmax-weighted means of unit-scale
values, as `test_torch_segment.py` holds the other forms. The sorted
form's cumulative sums lose digits at the segment differences in both
packages, so it is held to twice the JAX form's own distance from an
fp64 oracle (see its test). `update_forward` with a table is held to
`test_torch_slam.py`'s TOL_STEP on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ba import gauss_newton as tgn
from wild_video_3d_reconstruction_torch.models import convert as tconvert
from wild_video_3d_reconstruction_torch.models import update as tupdate
from wild_video_3d_reconstruction_torch.ops import segment as tseg
from wild_video_3d_reconstruction_tpu.ba import gauss_newton as jgn
from wild_video_3d_reconstruction_tpu.models import update as jupdate
from wild_video_3d_reconstruction_tpu.models.vonet import init_vonet
from wild_video_3d_reconstruction_tpu.ops import segment as jseg

from test_torch_segment import jax_args, make_case, torch_args
from test_torch_slam import TOL_STEP

TOL = 1e-5
CAP = 24          # make_case's runs are shorter than 20 rows


def table_of(seg, S, valid):
    """The JAX package's per-segment edge table of the case, and the
    port's built by its own `_group_by_patch`."""
    okq = valid & (seg < S)
    jt = np.asarray(jgn._group_by_patch(jnp.asarray(seg, jnp.int32),
                                        jnp.asarray(okq), S, CAP))
    tt = tgn._group_by_patch(torch.from_numpy(seg), torch.from_numpy(okq),
                             S, CAP).numpy()
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1])
def test_table_form_matches_jax(seed):
    f, g, seg, S, order, valid = make_case(seed)
    jt, tt = table_of(seg, S, valid)
    np.testing.assert_array_equal(tt, jt)
    ref = np.asarray(jseg.segment_softmax_weighted_sum_table(
        jnp.asarray(f), jnp.asarray(g), jnp.asarray(jt),
        jnp.asarray(seg, jnp.int32), jnp.asarray(valid)))
    t = torch.from_numpy
    out = tseg.segment_softmax_weighted_sum_table(
        t(f), t(g), t(jt), t(seg), t(valid)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    # the same reduction as the scatter oracle on valid rows
    exact = tseg.segment_softmax_weighted_sum_exact(
        t(f), t(g), t(seg), S, t(valid)).numpy()
    np.testing.assert_allclose(out[valid], exact[valid], atol=TOL, rtol=0)
    assert not out[~valid].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_form_matches_jax(seed):
    """The cumulative sums over all 1024 rows lose digits to cancellation
    at the segment differences (up to 9e-4 against an fp64 oracle in the
    JAX form itself), and the two packages sum in other orders. So the
    port's form is held to twice the JAX form's own largest distance from
    the fp64 oracle, and their median difference to TOL."""
    case = make_case(seed)
    f, g, seg, S, order, valid = case
    ref = np.asarray(jseg.segment_softmax_weighted_sum_sorted(
        *jax_args(*case)))
    out = tseg.segment_softmax_weighted_sum_sorted(
        *torch_args(*case)).numpy()
    t = torch.from_numpy
    exact = tseg.segment_softmax_weighted_sum_exact(
        t(f).double(), t(g).double(), t(seg), S, t(valid)).numpy()
    err_jax = np.abs(ref[valid] - exact[valid]).max()
    err_port = np.abs(out[valid] - exact[valid]).max()
    assert err_port <= 2 * err_jax, (err_port, err_jax)
    assert np.median(np.abs(out - ref)) <= TOL
    assert not out[~valid].any() and not ref[~valid].any()


def test_update_forward_with_kk_table_matches_jax():
    """update_forward with kk_table (the `_soft_agg` table branch) on
    random inputs and JAX's `init_vonet(PRNGKey(0))` carried across."""
    params = jax.tree.map(np.asarray, init_vonet(jax.random.PRNGKey(0)))
    net_t = tconvert.jax_params_to_torch(params)
    rng = np.random.default_rng(0)
    E, P, S = 300, 3, 40
    net = rng.normal(size=(E, 384)).astype(np.float32)
    inp = rng.normal(size=(E, 384)).astype(np.float32)
    corr = rng.normal(size=(E, 2 * 49 * P * P)).astype(np.float32)
    kk = rng.integers(0, S, E)
    jj = rng.integers(0, 10, E)
    valid = rng.random(E) > 0.1
    kk_seg = np.where(valid, kk, S)
    ij_seg = np.where(valid, (kk // 4) * 11 + jj, 121)
    ix, jx = map(np.array, jseg.neighbors(jnp.asarray(kk), jnp.asarray(jj),
                                          valid=jnp.asarray(valid)))
    table, _ = table_of(kk_seg, S, valid)
    ref = jupdate.update_forward(
        params["update"], *map(jnp.asarray, (
            net, inp, corr, kk_seg, ij_seg, ix, jx, valid)), S + 1, 122,
        kk_table=jnp.asarray(table))
    t = torch.from_numpy
    with torch.no_grad():
        out = tupdate.update_forward(
            net_t.update, t(net), t(inp), t(corr), t(kk_seg), t(ij_seg),
            t(ix).long(), t(jx).long(), t(valid), S + 1, 122,
            kk_table=t(table))
        plain = tupdate.update_forward(
            net_t.update, t(net), t(inp), t(corr), t(kk_seg), t(ij_seg),
            t(ix).long(), t(jx).long(), t(valid), S + 1, 122)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_STEP,
                                   rtol=0)
    # the table branch was taken and agrees with the one-hot form
    for a, b in zip(out, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL_STEP,
                                   rtol=0)
