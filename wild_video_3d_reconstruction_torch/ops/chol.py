"""Cholesky solve of one small SPD system, the counterpart of the JAX
package's `ops/pallas_chol.py:chol_solve_small`.

S [D, D] and y [D], D <= 256, solved in fp32; the result is NaN where S is
not SPD. On CPU tensors the plain version (`torch.linalg.cholesky_ex`, then
`torch.cholesky_solve`, NaN where the factorisation failed); on CUDA
tensors the kernel of `csrc/chol.cu` or an error.

No path of the port calls it: the port's BA factorises with
`torch.linalg.cholesky_ex` (`ba/gauss_newton.py`), as the JAX package's BA
solves with `jax.scipy` and leaves this kernel to its own tests.
"""

from __future__ import annotations

import torch

from . import _native

MAX_D = 256


def _check(S, y):
    D = S.shape[0]
    if S.shape != (D, D) or y.shape != (D,) or not 0 < D <= MAX_D:
        raise ValueError(f"chol_solve_small: S [D, D] and y [D] with "
                         f"0 < D <= {MAX_D}, got {tuple(S.shape)} and "
                         f"{tuple(y.shape)}")


def chol_solve_small_plain(S, y):
    _check(S, y)
    L, info = torch.linalg.cholesky_ex(S.float())
    x = torch.cholesky_solve(y.float()[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def chol_solve_small(S, y):
    """x [D] fp32 with S x = y: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if not _native.on_cuda(S, y):
        return chol_solve_small_plain(S, y)
    _check(S, y)
    if S.dtype != torch.float32 or not S.is_contiguous():
        S = S.float().contiguous()
    if y.dtype != torch.float32 or not y.is_contiguous():
        y = y.float().contiguous()
    _native.require_cuda("chol_solve_small", S, y)
    x = torch.empty_like(y)
    err = _native.lib().wv3d_chol_solve(S.data_ptr(), y.data_ptr(),
                                        x.data_ptr(), S.shape[0],
                                        _native.stream_ptr(S.device))
    _native.check_launch("wv3d_chol_solve", err)
    _native.LAUNCHES["chol_solve"] += 1
    return x
