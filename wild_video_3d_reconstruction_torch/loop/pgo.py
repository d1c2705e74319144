"""Sim(3) pose-graph optimisation, the loop closure's back end.

Counterpart of the JAX package's `loop/pgo.py`: residuals
r_e = Log(C_e * Exp(G_i) * Exp(G_j)^-1) over log-coordinate Sim(3)
variables, each edge's two 7x7 Jacobians from one
`torch.func.vmap(torch.func.jacfwd(...))` on the poses' device, and a
Levenberg-Marquardt loop on the host with a scipy sparse normal-equation
solve (a chain and a few loop edges: the solve is microseconds).

Everything runs in float64, where the JAX package runs fp32 (ROADMAP R10):
the Sim(3) exp/log coefficients of `ops/lie.py:_sim3_W_terms` cancel
catastrophically for small rotations and scales above the Taylor cut
(theta ~ 1e-2, sigma ~ 1e-4), and in fp32 their Jacobians are off by up
to 10 against float64 on the synthetic loop of `tests/test_loop.py`, so
two fp32 implementations (XLA's, PyTorch's; or the card's and the
CPU's) land 1e-3 apart from rounding alone. The result is returned in
float64.

`perform_updates_device` is the dense variant that runs the whole LM loop
on the device (`torch.linalg.solve` on the [7n, 7n] system, the accept
test a `torch.where`: no host read inside the loop), for graphs of up to a
few hundred poses.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..ops import lie


def _f64(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                           device=device)


def _edge_residual(C, Gi, Gj):
    """r = Log(C * Exp(Gi) * Exp(Gj)^-1); C: [E, 8] Sim3, G*: [E, 7]."""
    return lie.sim3_log(lie.sim3_mul(C, lie.sim3_mul(
        lie.sim3_exp(Gi), lie.sim3_inv(lie.sim3_exp(Gj)))))


def _edge_residual_and_jac(C, Gi, Gj):
    """(r [E, 7], dr/dGi [E, 7, 7], dr/dGj [E, 7, 7])."""
    def one(c, gi, gj):
        def f(a, b):
            return _edge_residual(c, a, b)
        Ji, Jj = torch.func.jacfwd(f, argnums=(0, 1))(gi, gj)
        return f(gi, gj), Ji, Jj

    return torch.func.vmap(one)(C, Gi, Gj)


def _solve_normal_equations(Ji, Jj, iii, jjj, resid, n, ep, lm, freen=-1):
    """Sparse Gauss-Newton step: (J^T J + lm diag + ep I) d = -J^T r, only
    the first freen poses free when freen >= 0."""
    r = resid.shape[0]
    rows = np.repeat(np.arange(r * 7), 14)
    cols_i = iii[:, None, None] * 7 + np.tile(np.arange(7), (r, 7, 1))
    cols_j = jjj[:, None, None] * 7 + np.tile(np.arange(7), (r, 7, 1))
    cols = np.concatenate([cols_i.reshape(r, 7, 7),
                           cols_j.reshape(r, 7, 7)], axis=2).reshape(-1)
    vals = np.concatenate([np.asarray(Ji), np.asarray(Jj)],
                          axis=2).reshape(-1)
    J = sp.csr_matrix((vals, (rows, cols)), shape=(7 * r, 7 * n))
    b = -(J.T @ np.asarray(resid).reshape(-1))
    A = (J.T @ J).tocsc()
    A = A + sp.diags(A.diagonal() * lm) + ep * sp.eye(7 * n)
    if freen >= 0:
        k = 7 * freen
        delta = np.zeros(7 * n)
        delta[:k] = spla.spsolve((A[:k, :k] + 1e-10 * sp.eye(k)).tocsc(),
                                 b[:k])
    else:
        delta = spla.spsolve(A + 1e-10 * sp.eye(7 * n), b)
    return delta.reshape(n, 7)


def _graph(poses_c2w, loop_constants, loop_ii, loop_jj, device):
    """The variables Log(w2c) [n, 7] and the edges: the sequential
    odometry constants C = T_j T_i^-1 for (i, j = i - 1), then the loops."""
    c2w = _f64(poses_c2w, device)
    n = c2w.shape[0]
    w2c = lie.sim3_inv(lie.se3_to_sim3(c2w))
    kk = np.arange(1, n)
    ll = kk - 1
    dSij = lie.sim3_mul(w2c[ll], lie.sim3_inv(w2c[kk]))
    constants = torch.cat([dSij, _f64(loop_constants, device)
                           .reshape(-1, 8)], dim=0)
    iii = np.concatenate([kk, np.asarray(loop_ii, np.int64)])
    jjj = np.concatenate([ll, np.asarray(loop_jj, np.int64)])
    return lie.sim3_log(w2c), constants, iii, jjj


def perform_updates(poses_c2w, loop_constants, loop_ii, loop_jj, iters=30,
                    ep=0.0, lmbda=1e-6, freen=-1, device="cpu"):
    """LM over the Sim(3) pose graph, the residuals and Jacobians on
    `device`, the sparse solves on the host.

    poses_c2w [n, 7] SE3 camera-to-world; loop_constants [L, 8] measured
    Sim3 (j <- i, world-to-camera); loop_ii / loop_jj [L]. Returns the
    camera-to-world Sim3 poses [n, 8] (numpy float64)."""
    n = np.asarray(poses_c2w).shape[0]
    G, constants, iii, jjj = _graph(poses_c2w, loop_constants, loop_ii,
                                    loop_jj, device)
    Ginv = G.cpu().numpy()
    ti = torch.as_tensor(iii, device=device)
    tj = torch.as_tensor(jjj, device=device)
    history = []
    for itr in range(iters):
        Gd = _f64(Ginv, device)
        r, Ji, Jj = _edge_residual_and_jac(constants, Gd[ti], Gd[tj])
        r = r.cpu().numpy()
        history.append(float(np.square(r).mean()))
        delta = _solve_normal_equations(Ji.cpu().numpy(), Jj.cpu().numpy(),
                                        iii, jjj, r, n, ep, lmbda, freen)
        G_tmp = Ginv + delta
        Gt = _f64(G_tmp, device)
        r_new = _edge_residual(constants, Gt[ti], Gt[tj]).cpu().numpy()
        if float(np.square(r_new).mean()) < history[-1]:
            Ginv = G_tmp
            lmbda /= 2
        else:
            lmbda *= 2
        if history[-1] < 1e-5 and itr >= 4 and \
                history[-5] / max(history[-1], 1e-30) < 1.5:
            break
    return lie.sim3_inv(lie.sim3_exp(_f64(Ginv, device))).cpu().numpy()


def run_pgo(poses_w2c, loop_constants, loop_ii, loop_jj, iters=30,
            device="cpu"):
    """A PGO round with the gauge fix: the result re-anchored so that the
    first pose past the loops is unchanged; returns the first
    safe_i = max(loop_ii) + 1 camera-to-world Sim3 poses [safe_i, 8]."""
    poses_c2w = lie.se3_inv(_f64(poses_w2c, device)).cpu().numpy()
    final = _f64(perform_updates(poses_c2w, loop_constants, loop_ii,
                                 loop_jj, iters=iters, device=device),
                 device)
    safe_i = int(np.max(loop_ii)) + 1
    anchor = lie.se3_to_sim3(_f64(poses_c2w, device))[safe_i]
    correction = lie.sim3_mul(anchor, lie.sim3_inv(final[safe_i]))
    final = lie.sim3_mul(correction.expand_as(final), final)
    return final[:safe_i].cpu().numpy()


def _device_lm(Ginv, constants, iii, jjj, n, iters=30, ep=0.0,
               lmbda0=1e-6):
    """iters LM steps on the dense normal equations, on the device of the
    inputs, each accepted where it lowers the mean squared residual."""
    f64 = dict(dtype=torch.float64, device=Ginv.device)
    oh_i = torch.nn.functional.one_hot(iii, n).to(**f64)        # [E, n]
    oh_j = torch.nn.functional.one_hot(jjj, n).to(**f64)
    lmbda = torch.tensor(lmbda0, **f64)
    eye = torch.eye(7 * n, **f64)
    for _ in range(iters):
        r, Ji, Jj = _edge_residual_and_jac(constants, Ginv[iii], Ginv[jjj])
        cost = r.square().mean()
        Hii = torch.einsum("ea,erc,erd,eb->acbd", oh_i, Ji, Ji, oh_i)
        Hij = torch.einsum("ea,erc,erd,eb->acbd", oh_i, Ji, Jj, oh_j)
        Hjj = torch.einsum("ea,erc,erd,eb->acbd", oh_j, Jj, Jj, oh_j)
        H = (Hii + Hij + Hij.permute(2, 3, 0, 1) + Hjj).reshape(7 * n, 7 * n)
        g = (torch.einsum("ea,erc,er->ac", oh_i, Ji, r)
             + torch.einsum("ea,erc,er->ac", oh_j, Jj, r)).reshape(7 * n)
        H = H + torch.diag(lmbda * H.diagonal() + ep)
        delta = torch.linalg.solve(H + eye * 1e-8, -g).reshape(n, 7)
        G_try = Ginv + delta
        better = _edge_residual(constants, G_try[iii],
                                G_try[jjj]).square().mean() < cost
        Ginv = torch.where(better, G_try, Ginv)
        lmbda = torch.where(better, lmbda * 0.5, lmbda * 2.0)
    return Ginv


def perform_updates_device(poses_c2w, loop_constants, loop_ii, loop_jj,
                           iters=30, ep=0.0, lmbda=1e-6, device="cuda"):
    """`perform_updates` with the whole LM loop on `device` (same inputs
    and output)."""
    n = np.asarray(poses_c2w).shape[0]
    G, constants, iii, jjj = _graph(poses_c2w, loop_constants, loop_ii,
                                    loop_jj, device)
    G = _device_lm(G, constants, torch.as_tensor(iii, device=device),
                   torch.as_tensor(jjj, device=device), n, iters=iters,
                   ep=ep, lmbda0=lmbda)
    return lie.sim3_inv(lie.sim3_exp(G)).cpu().numpy()
