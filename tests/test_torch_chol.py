"""Port parity: `ops/chol.py:chol_solve_small` on the CPU (its plain
version) against the JAX package's Pallas `chol_solve_small` in interpret
mode and against scipy, with the tolerances of `tests/test_pallas_chol.py`
(rtol 2e-4, atol 2e-5: fp32 factorisations in another summation order).
The kernel (`csrc/chol.cu`) is held against the plain version on the card
in `tests/test_torch_kernels_cuda.py` and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops import chol as tchol
from wild_video_3d_reconstruction_tpu.ops.pallas_chol import \
    chol_solve_small as jchol


def spd(d, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d)).astype(np.float32)
    S = A @ A.T + d * np.eye(d, dtype=np.float32)
    return S, rng.normal(size=(d,)).astype(np.float32)


# panel edges of the kernel's 16-column blocking (csrc/chol.cu): ragged
# last panels, one-column and exactly-one-panel systems
DIMS = [1, 2, 7, 8, 9, 15, 16, 17, 33, 54, 72, 100, 128, 255, 256]


@pytest.mark.parametrize("d", DIMS)
def test_matches_jax_kernel_and_scipy(d):
    S, y = spd(d, d)
    before = dict(_native.LAUNCHES)
    x = tchol.chol_solve_small(torch.from_numpy(S), torch.from_numpy(y))
    assert _native.LAUNCHES == before          # CPU: the plain version
    assert x.shape == (d,) and x.dtype == torch.float32
    ref = scipy.linalg.cho_solve(scipy.linalg.cho_factor(
        S.astype(np.float64), lower=True), y.astype(np.float64))
    np.testing.assert_allclose(x.numpy(), ref, rtol=2e-4, atol=2e-5)
    jx = np.asarray(jchol(jnp.asarray(S), jnp.asarray(y), interpret=True))
    np.testing.assert_allclose(x.numpy(), jx, rtol=2e-4, atol=2e-5)


def not_spd(kind):
    """A symmetric S that is not SPD, by where its first non-positive
    pivot falls: -I, 0, a negative last pivot of the first panel, a zero
    pivot at the last index only (row and column 71 of an SPD matrix set
    to 0), a negative pivot at the first and at the last column of the
    second panel (that diagonal entry of an SPD matrix negated)."""
    if kind == "minus-identity":
        return -np.eye(16, dtype=np.float32)
    if kind == "zero":
        return np.zeros((16, 16), np.float32)
    if kind == "last-pivot":
        return np.diag(np.r_[np.ones(15), -1.0]).astype(np.float32)
    if kind == "zero-last-pivot":
        S, _ = spd(72, 1)
        S[-1, :] = S[:, -1] = 0.0
        return S
    S, _ = spd(40, 2)
    k = {"negative-panel-first": 16, "negative-panel-last": 31}[kind]
    S[k, k] = -S[k, k]
    return S


NOT_SPD = ["minus-identity", "zero", "last-pivot", "zero-last-pivot",
           "negative-panel-first", "negative-panel-last"]


@pytest.mark.parametrize("kind", NOT_SPD)
def test_not_spd_gives_nan(kind):
    """Not SPD gives NaN in every entry of x, in the port as in the JAX
    kernel."""
    S = not_spd(kind)
    y = np.ones(S.shape[0], np.float32)
    x = tchol.chol_solve_small(torch.from_numpy(S), torch.from_numpy(y))
    assert torch.isnan(x).all()
    jx = np.asarray(jchol(jnp.asarray(S), jnp.asarray(y), interpret=True))
    assert np.isnan(jx).all()


def test_rejects_what_it_cannot_take():
    with pytest.raises(ValueError):              # D > 256
        tchol.chol_solve_small(torch.eye(257), torch.ones(257))
    with pytest.raises(ValueError):              # y of the wrong length
        tchol.chol_solve_small(torch.eye(8), torch.ones(7))
