"""The port's Lie groups beyond what the VO path uses (quaternion <->
matrix, SE3 matrices and scaling, RxSO3, Sim3) and the class wrappers of
`ops/groups.py`, against the JAX package's `ops/lie.py`.

Every function on the same numpy inputs (made from a seed) in fp32 on both
sides, within 1e-5 absolute; the identities of `tests/test_lie.py` in
fp64 on the port (exp/log round trips at general, small and zero
tangents, inverses, associativity, act against the matrix, the matrix /
quaternion round trip, Sim3 scale composition); `torch.func.jacfwd`
against central finite differences (fp64, 1e-6), at zero too, where the
Taylor branches must keep the Jacobian finite. The loop closure's PGO
differentiates through these functions under `torch.func.vmap`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.ops import groups as tgroups
from wild_video_3d_reconstruction_torch.ops import lie as tlie
from wild_video_3d_reconstruction_tpu.ops import groups as jgroups
from wild_video_3d_reconstruction_tpu.ops import lie as jlie

TOL_JAX = 1e-5
TOL_FD = 1e-6

GROUPS = {   # exp, log, inv, mul, tangent dim
    "so3": ("so3_exp", "so3_log", "quat_conj", "quat_mul", 3),
    "se3": ("se3_exp", "se3_log", "se3_inv", "se3_mul", 6),
    "rxso3": ("rxso3_exp", "rxso3_log", "rxso3_inv", "rxso3_mul", 4),
    "sim3": ("sim3_exp", "sim3_log", "sim3_inv", "sim3_mul", 7),
}


def tangent(seed, dim, batch=16, scale=1.0, dtype=np.float32):
    return (scale * np.random.default_rng(seed).normal(size=(batch, dim))
            ).astype(dtype)


def port(name, *args):
    out = getattr(tlie, name)(*(torch.from_numpy(np.array(a))
                                for a in args))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else \
        out.numpy()


def ref(name, *args):
    out = getattr(jlie, name)(*(jnp.asarray(a) for a in args))
    return tuple(map(np.asarray, out)) if isinstance(out, tuple) else \
        np.asarray(out)


def close(a, b, tol=TOL_JAX):
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("scale", [1.0, 1e-4, 0.0])
def test_group_ops_match_jax(group, scale):
    """exp, log, inv and mul at general, small and zero tangents."""
    exp, log, inv, mul, dim = GROUPS[group]
    x = tangent(0, dim, scale=scale)
    y = tangent(1, dim, scale=scale)
    X, Y = ref(exp, x), ref(exp, y)
    close(port(exp, x), X)
    close(port(log, X), ref(log, X))
    close(port(inv, X), ref(inv, X))
    close(port(mul, X, Y), ref(mul, X, Y))


def test_actions_matrices_and_embeddings_match_jax():
    x7, x6 = tangent(2, 7), tangent(3, 6)
    S, T = ref("sim3_exp", x7), ref("se3_exp", x6)
    R5 = ref("rxso3_exp", tangent(4, 4))
    p = tangent(5, 3)
    p4 = np.concatenate([p, tangent(6, 1)], axis=1)
    for name, args in (("sim3_act", (S, p)), ("sim3_act4", (S, p4)),
                       ("sim3_matrix", (S,)), ("sim3_retr", (S, x7)),
                       ("rxso3_act", (R5, p)), ("se3_matrix", (T,)),
                       ("se3_to_sim3", (T,)), ("sim3_to_se3", (S,)),
                       ("se3_normalize", (T * 1.1,)),
                       ("quat_to_matrix", (T[:, 3:],)),
                       ("se3_from_matrix", (ref("se3_matrix", T),)),
                       ("matrix_to_quat", (ref("quat_to_matrix", T[:, 3:]),))):
        close(port(name, *args), ref(name, *args))
    s = np.linspace(0.5, 2.0, 16).astype(np.float32)
    close(port("se3_scale", T, s), ref("se3_scale", T, s))
    close(tlie.se3_scale(torch.from_numpy(T), 2.0).numpy(),
          np.asarray(jlie.se3_scale(jnp.asarray(T), 2.0)))
    close(tlie.se3_to_sim3(torch.from_numpy(T), 1.5).numpy(),
          np.asarray(jlie.se3_to_sim3(jnp.asarray(T), 1.5)))
    close(tlie.sim3_identity((3,)).numpy(),
          np.asarray(jlie.sim3_identity((3,))))
    # the Sim3 W coefficients, each Taylor branch
    phi = np.concatenate([tangent(7, 3), tangent(8, 3, scale=1e-8)])
    sig = np.concatenate([tangent(9, 1, scale=1e-8), tangent(10, 1)])
    for a, b in zip(port("_sim3_W_terms", phi, sig),
                    ref("_sim3_W_terms", phi, sig)):
        close(a, b)


# ------------------------------------------------ identities (fp64, port)

def t64(seed, dim, batch=32, scale=1.0):
    return torch.from_numpy(tangent(seed, dim, batch, scale, np.float64))


@pytest.mark.parametrize("group", list(GROUPS))
def test_identities(group):
    exp, log, inv, mul, dim = (getattr(tlie, n) if isinstance(n, str) else n
                               for n in GROUPS[group])
    for scale, tol in ((1.0, 1e-8), (1e-5, 1e-10)):
        x = t64(0, dim, scale=scale)
        torch.testing.assert_close(log(exp(x)), x, atol=tol, rtol=0)
    z = torch.zeros(4, dim, dtype=torch.float64)
    torch.testing.assert_close(log(exp(z)), z, atol=1e-12, rtol=0)
    X = exp(t64(1, dim))
    torch.testing.assert_close(log(mul(X, inv(X))),
                               torch.zeros(32, dim, dtype=torch.float64),
                               atol=1e-8, rtol=0)
    a, b, c = (exp(t64(2 + i, dim)) for i in range(3))
    torch.testing.assert_close(mul(mul(a, b), c), mul(a, mul(b, c)),
                               atol=1e-8, rtol=0)


def test_act_matches_matrix_and_quat_roundtrip():
    p = t64(9, 3, batch=8)
    for exp, act, matrix, dim in ((tlie.se3_exp, tlie.se3_act,
                                   tlie.se3_matrix, 6),
                                  (tlie.sim3_exp, tlie.sim3_act,
                                   tlie.sim3_matrix, 7)):
        X = exp(t64(10, dim, batch=8))
        T = matrix(X)
        want = torch.einsum("bij,bj->bi", T[:, :3, :3], p) + T[:, :3, 3]
        torch.testing.assert_close(act(X, p), want, atol=1e-8, rtol=0)
    q = tlie.so3_exp(t64(11, 3, batch=64))
    q2 = tlie.matrix_to_quat(tlie.quat_to_matrix(q))
    torch.testing.assert_close((q * q2).sum(-1).abs(),
                               torch.ones(64, dtype=torch.float64),
                               atol=1e-8, rtol=0)


def test_sim3_scale_composition():
    xi = torch.zeros(7, dtype=torch.float64)
    xi[6] = 0.5
    X = tgroups.Sim3.exp(xi)
    assert np.isclose(float((X * X).data[7]), np.exp(1.0))
    p = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    torch.testing.assert_close(X * p, np.exp(0.5) * p, atol=1e-10, rtol=0)


# ---------------------------------------------------- jacfwd vs differences

def central_diff(f, x, h=1e-6):
    cols = []
    for k in range(x.shape[-1]):
        e = torch.zeros_like(x)
        e[k] = h
        cols.append((f(x + e) - f(x - e)) / (2 * h))
    return torch.stack(cols, dim=-1)


@pytest.mark.parametrize("group", ["so3", "se3", "sim3"])
def test_jacfwd_matches_finite_differences(group):
    exp, log, _, mul, dim = (getattr(tlie, n) if isinstance(n, str) else n
                             for n in GROUPS[group])
    x = t64(12, dim, batch=1, scale=0.5)[0]
    y = exp(t64(13, dim, batch=1, scale=0.5)[0])

    def roundtrip(t):
        return log(mul(exp(t), y))

    for f in (exp, roundtrip):
        for at in (x, torch.zeros(dim, dtype=torch.float64)):
            J = torch.func.jacfwd(f)(at)
            assert torch.isfinite(J).all()
            torch.testing.assert_close(J, central_diff(f, at), atol=TOL_FD,
                                       rtol=0)


def test_pgo_residual_jacobian_under_vmap_at_zero():
    """The PGO's per-edge residual Jacobians through vmap(jacfwd) are
    finite at the identity and equal finite differences."""
    def r(a, b):
        return tlie.sim3_log(tlie.sim3_mul(tlie.sim3_exp(a),
                                           tlie.sim3_inv(tlie.sim3_exp(b))))
    z = torch.zeros(3, 7, dtype=torch.float64)
    Ji, Jj = torch.func.vmap(torch.func.jacfwd(r, argnums=(0, 1)))(z, z)
    eye = torch.eye(7, dtype=torch.float64).expand(3, 7, 7)
    torch.testing.assert_close(Ji, eye, atol=TOL_FD, rtol=0)
    torch.testing.assert_close(Jj, -eye, atol=TOL_FD, rtol=0)


def test_class_wrappers_match_jax():
    x, y = tangent(14, 6), tangent(15, 6)
    p = tangent(16, 3)
    TX, TY = tgroups.SE3.exp(torch.from_numpy(x)), \
        tgroups.SE3.exp(torch.from_numpy(y))
    JX, JY = jgroups.SE3.exp(jnp.asarray(x)), jgroups.SE3.exp(jnp.asarray(y))
    close((TX * TY).data.numpy(), np.asarray((JX * JY).data))
    close((TX * torch.from_numpy(p)).numpy(), np.asarray(JX * jnp.asarray(p)))
    close(TX.retr(torch.from_numpy(y)).data.numpy(),
          np.asarray(JX.retr(jnp.asarray(y)).data))
    close(TX.matrix().numpy(), np.asarray(JX.matrix()))
    close(tgroups.SE3.Identity(16).data.numpy(),
          np.asarray(jgroups.SE3.Identity(16).data))
    close((TX * TX.inv()).data.numpy(), tgroups.SE3.Identity(16).data.numpy())
    S = tgroups.Sim3.from_se3(TX, 2.0)
    close(S.data.numpy(), np.asarray(jgroups.Sim3.from_se3(JX, 2.0).data))
    close(tgroups.stack([S, S]).data.numpy(),
          np.asarray(jgroups.stack([jgroups.Sim3.from_se3(JX, 2.0)] * 2)
                     .data))
    R = tgroups.RxSO3.exp(torch.from_numpy(tangent(17, 4)))
    JR = jgroups.RxSO3.exp(jnp.asarray(tangent(17, 4)))
    close(R.matrix().numpy(), np.asarray(JR.matrix()))
    close((R * torch.from_numpy(p)).numpy(), np.asarray(JR * jnp.asarray(p)))
    assert S[1:3].shape == (2,)
