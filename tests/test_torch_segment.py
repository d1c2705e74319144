"""Port parity: SoftAgg segment reductions, neighbour links and compaction
against the JAX package's `ops/segment.py`, and the run-sum wrapper.

The JAX run-sum goes through its Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU. Tolerance 1e-5 absolute on
softmax-weighted means of unit-scale values (fp32 sums in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops import segment as tseg
from wild_video_3d_reconstruction_tpu.ops import pallas_segsum
from wild_video_3d_reconstruction_tpu.ops import segment as jseg


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pallas_segsum.pl.pallas_call
    monkeypatch.setattr(pallas_segsum.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def make_case(seed, E=1024, D=32, S=300, max_run=20, invalid_frac=0.15):
    """Segment ids drawn as bounded runs in arbitrary edge order; some
    rows invalid; `order` sorts by where(valid, seg, S)."""
    rng = np.random.default_rng(seed)
    seg = np.empty(E, np.int64)
    i, s = 0, 0
    while i < E:
        n = int(rng.integers(1, max_run))
        seg[i:i + n] = min(s, S - 1)
        i += n
        s += 1
    seg = seg[rng.permutation(E)]
    valid = rng.random(E) >= invalid_frac
    f = rng.normal(size=(E, D)).astype(np.float32)
    g = rng.normal(size=(E, D)).astype(np.float32)
    order = np.argsort(np.where(valid, seg, S), kind="stable")
    return f, g, seg, S, order, valid


def jax_args(f, g, seg, S, order, valid):
    return (jnp.asarray(f), jnp.asarray(g), jnp.asarray(seg, jnp.int32), S,
            jnp.asarray(order, jnp.int32), jnp.asarray(valid))


def torch_args(f, g, seg, S, order, valid):
    t = torch.from_numpy
    return t(f), t(g), t(seg), S, t(order), t(valid)


@pytest.mark.parametrize("seed", [0, 1])
def test_runsum_matches_jax_kernel_and_scatter(seed, interpret_mode):
    case = make_case(seed)
    f, g, seg, S, order, valid = jax_args(*case)
    ref_run = np.asarray(jseg.segment_softmax_weighted_sum_runsum(
        f, g, seg, S + 1, order, valid=valid))
    ref_sc = np.asarray(jseg.segment_softmax_weighted_sum(
        f, g, seg, S + 1, valid=valid))
    f, g, seg, S, order, valid = torch_args(*case)
    out = tseg.segment_softmax_weighted_sum_runsum(f, g, seg, S + 1, order,
                                                   valid=valid).numpy()
    np.testing.assert_allclose(out, ref_run, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, ref_sc, atol=1e-5, rtol=0)


def test_runsum_with_interleaved_invalid_rows():
    """Invalid rows sorted in among a segment's valid rows (as the BA
    table sort leaves dead rows of the edge table) must not split it."""
    f, g, seg, S, _, valid = make_case(2)
    order = np.argsort(seg, kind="stable")       # ignores validity
    f, g, seg, S, order, valid = torch_args(f, g, seg, S, order, valid)
    out = tseg.segment_softmax_weighted_sum_runsum(f, g, seg, S + 1, order,
                                                   valid=valid)
    ref = tseg.segment_softmax_weighted_sum(f, g, seg, S + 1, valid=valid)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("form", ["dense", "scatter", "exact"])
def test_softagg_forms_match_jax(form):
    case = make_case(3, E=512, S=60)
    f, g, seg, S, _, valid = jax_args(*case)
    jfn = {"dense": jseg.segment_softmax_weighted_sum_dense,
           "scatter": jseg.segment_softmax_weighted_sum,
           "exact": jseg.segment_softmax_weighted_sum_exact}[form]
    tfn = {"dense": tseg.segment_softmax_weighted_sum_dense,
           "scatter": tseg.segment_softmax_weighted_sum,
           "exact": tseg.segment_softmax_weighted_sum_exact}[form]
    ref = np.asarray(jfn(f, g, seg, S, valid=valid))
    f, g, seg, S, _, valid = torch_args(*case)
    out = tfn(f, g, seg, S, valid=valid).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("max_run", [3, 200, 5000])
def test_run_segment_sum_plain_exact(max_run):
    """Run totals for runs shorter and longer than the TPU kernel's
    128-row band (the port sums every run exactly)."""
    rng = np.random.default_rng(4)
    E = 8192
    lens = rng.integers(1, max_run, E)
    seg = np.repeat(np.arange(E), lens)[:E]
    fes = rng.normal(size=(E, 8))
    out = tseg.run_segment_sum_sorted_plain(torch.from_numpy(fes),
                                            torch.from_numpy(seg)).numpy()
    totals = np.zeros((E, 8))
    np.add.at(totals, seg, fes)
    np.testing.assert_allclose(out, totals[seg], rtol=1e-5, atol=1e-4)


def test_run_segment_sum_wrapper_on_cpu():
    rng = np.random.default_rng(5)
    fes = torch.from_numpy(rng.normal(size=(512, 16)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 40, 512)))
    before = dict(_native.LAUNCHES)
    out = tseg.run_segment_sum_sorted(fes, seg)
    torch.testing.assert_close(out, tseg.run_segment_sum_sorted_plain(
        fes, seg), rtol=0, atol=0)
    assert _native.LAUNCHES == before


def test_run_segment_sum_matches_jax_kernel_on_short_runs(interpret_mode):
    """Where every run is shorter than the TPU kernel's band, the port's
    exact run totals equal the banded sums of the Pallas kernel."""
    rng = np.random.default_rng(6)
    E = 1024
    seg = np.repeat(np.arange(E), rng.integers(1, 28, E))[:E]
    fes = rng.normal(size=(E, 16)).astype(np.float32)
    ref = np.asarray(pallas_segsum.run_segment_sum_sorted(
        jnp.asarray(fes), jnp.asarray(seg, jnp.int32)))
    out = tseg.run_segment_sum_sorted(torch.from_numpy(fes),
                                      torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_neighbors_match_jax(seed):
    rng = np.random.default_rng(seed)
    E = 400
    kk = rng.integers(0, 50, E)
    jj = rng.integers(0, 20, E)
    valid = rng.random(E) > 0.2
    ix_j, jx_j = jseg.neighbors(jnp.asarray(kk), jnp.asarray(jj),
                                valid=jnp.asarray(valid))
    ix_t, jx_t = tseg.neighbors(torch.from_numpy(kk), torch.from_numpy(jj),
                                valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ix_t.numpy(), np.asarray(ix_j))
    np.testing.assert_array_equal(jx_t.numpy(), np.asarray(jx_j))


def test_neighbors_from_sorted_match_jax_and_neighbors():
    """Links from the BA table's sort (dead rows interleaved) equal the
    JAX ones and `neighbors` on table-ordered edges."""
    rng = np.random.default_rng(2)
    E, S = 600, 40
    kk = np.sort(rng.integers(0, S + 5, E))[rng.permutation(E)]
    jj = np.zeros(E, np.int64)
    for k in np.unique(kk):                  # ascending jj per patch
        m = np.flatnonzero(kk == k)
        jj[m] = np.sort(rng.integers(0, 30, m.size))
    valid = rng.random(E) > 0.2
    key = np.where(kk < S, kk, S)
    order = np.argsort(key, kind="stable")
    ix_j, jx_j = jseg.neighbors_from_sorted(
        jnp.asarray(order, jnp.int32), jnp.asarray(key[order]),
        jnp.asarray(valid[order]), S)
    t = torch.from_numpy
    ix_t, jx_t = tseg.neighbors_from_sorted(t(order), t(key[order]),
                                            t(valid[order]), S)
    np.testing.assert_array_equal(ix_t.numpy(), np.asarray(ix_j))
    np.testing.assert_array_equal(jx_t.numpy(), np.asarray(jx_j))
    ix_n, jx_n = tseg.neighbors(t(kk), t(jj), valid=t(valid & (kk < S)))
    np.testing.assert_array_equal(ix_t.numpy(), ix_n.numpy())
    np.testing.assert_array_equal(jx_t.numpy(), jx_n.numpy())


def test_compact_valid_matches_jax():
    valid = np.random.default_rng(3).random(777) > 0.4
    perm_j, n_j = jseg.compact_valid(jnp.asarray(valid))
    perm_t, n_t = tseg.compact_valid(torch.from_numpy(valid))
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    assert int(n_t) == int(n_j) == valid.sum()

