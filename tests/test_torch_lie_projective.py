"""Port parity: SE3/SO3 Lie ops and projective geometry against the JAX
package, on the same numpy inputs, in fp32 and fp64.

Tolerances: 1e-5 (fp32) / 1e-10 (fp64) absolute on unit-scale group
values; the two packages evaluate the same closed forms, so only rounding
order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import lie as tlie
from wild_video_3d_reconstruction_torch.ops import projective as tpops
from wild_video_3d_reconstruction_tpu.ops import lie as jlie
from wild_video_3d_reconstruction_tpu.ops import projective as jpops

DTYPES = {"fp32": (np.float32, 1e-5), "fp64": (np.float64, 1e-10)}


def tangents(rng, n, dim, dtype):
    """Random tangents at unit scale, small scale (the Taylor branches)
    and exactly zero."""
    x = rng.normal(size=(n, dim))
    x[: n // 4] *= 1e-5
    x[n // 4: n // 4 + 2] = 0.0
    return x.astype(dtype)


def both(fn_j, fn_t, *args):
    with jax.enable_x64(True):
        out_j = np.asarray(fn_j(*[jnp.asarray(a) for a in args]))
    out_t = fn_t(*[torch.from_numpy(np.array(a)) for a in args]).numpy()
    return out_j, out_t


def _se3(rng, n, dtype):
    with jax.enable_x64(True):
        return np.asarray(jlie.se3_exp(jnp.asarray(tangents(rng, n, 6,
                                                            dtype))))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op", ["so3_exp", "so3_log", "se3_exp", "se3_log",
                                "se3_inv", "se3_mul", "se3_act", "se3_act4",
                                "se3_adj", "se3_adjT", "se3_retr"])
def test_lie_op_matches_jax(op, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    n = 64
    if op == "so3_exp":
        args = (tangents(rng, n, 3, dtype),)
    elif op == "so3_log":
        with jax.enable_x64(True):
            args = (np.asarray(jlie.so3_exp(jnp.asarray(
                tangents(rng, n, 3, dtype)))),)
    elif op == "se3_exp":
        args = (tangents(rng, n, 6, dtype),)
    elif op in ("se3_log", "se3_inv"):
        args = (_se3(rng, n, dtype),)
    elif op == "se3_mul":
        args = (_se3(rng, n, dtype), _se3(rng, n, dtype))
    elif op == "se3_act":
        args = (_se3(rng, n, dtype), rng.normal(size=(n, 3)).astype(dtype))
    elif op == "se3_act4":
        args = (_se3(rng, n, dtype), rng.normal(size=(n, 4)).astype(dtype))
    elif op in ("se3_adj", "se3_adjT"):
        args = (_se3(rng, n, dtype), rng.normal(size=(n, 6)).astype(dtype))
    else:
        args = (_se3(rng, n, dtype), tangents(rng, n, 6, dtype))
    out_j, out_t = both(getattr(jlie, op), getattr(tlie, op), *args)
    assert out_t.dtype == dtype
    np.testing.assert_allclose(out_t, out_j, atol=tol, rtol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_lie_identities(dt):
    """exp/log round trip and X X^-1 = I in the port itself."""
    dtype, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    xi = torch.from_numpy(tangents(rng, 64, 6, dtype))
    X = tlie.se3_exp(xi)
    torch.testing.assert_close(tlie.se3_log(X), xi, atol=100 * tol, rtol=0)
    ident = tlie.se3_log(tlie.se3_mul(X, tlie.se3_inv(X)))
    torch.testing.assert_close(ident, torch.zeros_like(xi), atol=100 * tol,
                               rtol=0)


def make_scene(seed, n_frames=5, n_patches=24, P=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        poses = np.asarray(jlie.se3_exp(jnp.asarray(
            (0.1 * rng.normal(size=(n_frames, 6))).astype(dtype))))
    xy = rng.uniform(10.0, 90.0, size=(n_patches, 2, 1, 1))
    off = np.stack(np.meshgrid(np.arange(P) - P // 2, np.arange(P) - P // 2,
                               indexing="xy"), 0)
    xy = xy + off[None]
    d = np.broadcast_to(rng.uniform(0.2, 2.0, size=(n_patches, 1, 1, 1)),
                        (n_patches, 1, P, P))
    patches = np.concatenate([xy, d], axis=1).astype(dtype)
    intr = np.tile(np.array([[80.0, 80.0, 64.0, 48.0]]),
                   (n_frames, 1)).astype(dtype)
    ii = rng.integers(0, n_frames, n_patches)
    jj = (ii + 1) % n_frames
    kk = np.arange(n_patches)
    return poses, patches, intr, ii, jj, kk


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_transform_values_and_jacobians(dt):
    dtype, tol = DTYPES[dt]
    scene = make_scene(2, dtype=dtype)
    with jax.enable_x64(True):
        x_j, v_j, (Ji_j, Jj_j, Jz_j) = jpops.transform(
            *map(jnp.asarray, scene), jacobian=True)
        x_j, v_j, Ji_j, Jj_j, Jz_j = map(np.asarray,
                                         (x_j, v_j, Ji_j, Jj_j, Jz_j))
    x_t, v_t, (Ji_t, Jj_t, Jz_t) = tpops.transform(*_t(*scene),
                                                   jacobian=True)
    # pixel-scale values (focal 80): relative tolerance
    for a, b in ((x_t, x_j), (v_t, v_j), (Ji_t, Ji_j), (Jj_t, Jj_j),
                 (Jz_t, Jz_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=10 * tol,
                                   atol=10 * tol)


@pytest.mark.parametrize("kw", [{}, {"depth": True}, {"valid": True},
                                {"tonly": True}])
def test_transform_variants(kw):
    scene = make_scene(3)
    out_j = jpops.transform(*map(jnp.asarray, scene), **kw)
    out_t = tpops.transform(*_t(*scene), **kw)
    if isinstance(out_j, tuple):
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-4)
    else:
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=1e-5, atol=1e-4)


def test_flow_mag_matches_jax():
    scene = make_scene(4)
    fm_j = np.asarray(jpops.flow_mag(*map(jnp.asarray, scene), beta=0.5))
    fm_t = tpops.flow_mag(*_t(*scene), beta=0.5).numpy()
    np.testing.assert_allclose(fm_t, fm_j, rtol=1e-5, atol=1e-4)

