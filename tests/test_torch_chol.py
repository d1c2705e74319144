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


@pytest.mark.parametrize("d", [8, 72, 128, 256])
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


@pytest.mark.parametrize("S", [-np.eye(16, dtype=np.float32),
                               np.zeros((16, 16), np.float32),
                               np.diag(np.r_[np.ones(15), -1.0]).astype(
                                   np.float32)],
                         ids=["minus-identity", "zero", "last-pivot"])
def test_not_spd_gives_nan(S):
    """Not SPD gives NaN, as the JAX kernel does (on -I: all of x)."""
    y = np.ones(16, np.float32)
    x = tchol.chol_solve_small(torch.from_numpy(S), torch.from_numpy(y))
    assert torch.isnan(x).all()
    jx = np.asarray(jchol(jnp.asarray(S), jnp.asarray(y), interpret=True))
    assert not np.isfinite(jx).all()


def test_rejects_what_it_cannot_take():
    with pytest.raises(ValueError):              # D > 256
        tchol.chol_solve_small(torch.eye(257), torch.ones(257))
    with pytest.raises(ValueError):              # y of the wrong length
        tchol.chol_solve_small(torch.eye(8), torch.ones(7))
