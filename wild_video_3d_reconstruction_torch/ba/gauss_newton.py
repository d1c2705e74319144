"""Gauss-Newton bundle adjustment with a Schur complement.

Counterpart of the JAX package's `ba/gauss_newton.py`: per-edge
reprojection residuals with analytic 2x6 pose and 2x1 inverse-depth
Jacobians, the robust mask, the dense pose Hessian and pose/depth coupling
blocks (the depth blocks through a per-patch edge table), the mu*L depth
prior, the Schur complement over the diagonal depth block, a Cholesky
solve whose failure gives a zero step, the per-iteration depth-step clamp,
and the retractions with the inference kernel's depth rules (or the
training BA's clamp, `depth_clamp="train"`).

The pose window [t0, t1) and the first live patch id m_base are host
integers or 0-d tensors on the device (the steady frame step passes them
so, as the JAX package traces them): the retractions run over the static
`window` / `patch_slots` extents with masks, dead slots scattered into a
sentinel row, so no shape depends on them. `_bundle_adjust_impl` returns
new pose and patch tensors and leaves its inputs as they were. It solves
in fp32, or in fp64 when the poses come in fp64 (the parity checks take
that as the exact solution of an ill-conditioned problem). It is
differentiable end to end (the training forward backpropagates through
it into the flow targets and weights): the in-place writes are
`index_copy_` into fresh tensors, which autograd records.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie


class BAConfig(NamedTuple):
    window: int          # pose-window capacity (>= t1 - t0)
    patch_slots: int     # distinct-patch capacity
    iterations: int = 2
    min_depth: float = 0.2
    max_residual: float = 128.0
    bounds_margin: float = 64.0
    ep: float = 1.0      # diagonal epsilon added to the Schur system
    lm: float = 1e-4     # multiplicative diagonal damping on S
    # max live edges per patch: the depth blocks accumulate through a
    # [patch_slots, cap] edge table; None uses a dense one-hot instead
    per_patch_cap: int | None = None
    prior_mu: float = 2.0
    # per-iteration trust region on the inverse-depth step (None: off)
    depth_step_clamp: float | None = 1.0
    # depth retraction rule: "cuda" = the inference kernel's (d > 20 ->
    # 1.0, floor 1e-4); "train" = the training BA's clamp(1e-3, 10.0)
    depth_clamp: str = "cuda"


def _group_by_patch(q, okq, M_, cap, order=None):
    """Per-patch edge table [M_, cap] of edge ids (E where empty), from
    one stable sort by where(okq, q, M_) (or the caller's `order`)."""
    E = q.shape[0]
    key = torch.where(okq, q, M_)
    if order is None:
        order = torch.argsort(key, stable=True)
    q_sorted = key[order].contiguous()
    ar = torch.arange(M_, device=q.device, dtype=q_sorted.dtype)
    starts = torch.searchsorted(q_sorted, ar)
    idx = starts[:, None] + torch.arange(cap, device=q.device)[None, :]
    idxc = idx.clamp(0, max(E - 1, 0))
    ok = (idx < E) & (q_sorted[idxc] == ar[:, None])
    return torch.where(ok, order[idxc], E)


def _edge_system(poses, patches, intr, target, ii, jj, kk, cfg: BAConfig):
    """r [E, 2], Ji/Jj [E, 2, 6], Jz [E, 2] and the robust mask [E]."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pc = patches[kk, :, 1, 1]
    X0 = torch.stack([(pc[:, 0] - cx) / fx, (pc[:, 1] - cy) / fy,
                      torch.ones_like(pc[:, 0]), pc[:, 2]], dim=-1)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    X1 = lie.se3_act4(Gij, X0)
    X, Y, Z, W = X1.unbind(-1)

    safeZ = torch.where(Z.abs() > 1e-6, Z, 1e-6)
    x1 = fx * (X / safeZ) + cx
    y1 = fy * (Y / safeZ) + cy
    r = target - torch.stack([x1, y1], dim=-1)

    m = cfg.bounds_margin
    mask = ((torch.linalg.norm(r, dim=-1) < cfg.max_residual)
            & (Z > cfg.min_depth)
            & (x1 > -m) & (y1 > -m) & (x1 < 2 * cx + m) & (y1 < 2 * cy + m)
            & torch.isfinite(r).all(-1))

    d = torch.where(Z >= cfg.min_depth, 1.0 / safeZ, 0.0)
    d2 = d * d
    o = torch.zeros_like(d)
    Jx = torch.stack([fx * W * d, o, -fx * X * W * d2,
                      -fx * X * Y * d2, fx * (1 + X * X * d2), -fx * Y * d],
                     -1)
    Jy = torch.stack([o, fy * W * d, -fy * Y * W * d2,
                      fy * (-1 - Y * Y * d2), fy * X * Y * d2, fy * X * d],
                     -1)
    Jj = torch.stack([Jx, Jy], dim=1)
    Ji = -lie.se3_adjT(Gij[:, None, :], Jj)
    tij = Gij[:, :3]
    Jz = torch.stack([fx * (tij[:, 0] * d - tij[:, 2] * X * d2),
                      fy * (tij[:, 1] * d - tij[:, 2] * Y * d2)], dim=-1)
    # a non-finite edge must not reach the Hessian (NaN * 0 = NaN)
    m2, m3 = mask[:, None], mask[:, None, None]
    r = torch.where(m2, torch.nan_to_num(r), 0.0)
    Ji = torch.where(m3, torch.nan_to_num(Ji), 0.0)
    Jj = torch.where(m3, torch.nan_to_num(Jj), 0.0)
    Jz = torch.where(m2, torch.nan_to_num(Jz), 0.0)
    return r, Ji, Jj, Jz, mask.to(poses.dtype)


def _scatter_rows(values, index, ok, n):
    """[n, ...] sums of values[e] at index[e] over the rows with ok. On
    the card they accumulate in fp64: index_add_'s atomics add in the
    order the threads arrive, which in fp64 no longer shows in the fp32
    result, so a run repeats (and a replayed graph matches the eager
    step)."""
    acc = torch.float64 if values.is_cuda else values.dtype
    out = torch.zeros((n + 1,) + tuple(values.shape[1:]), dtype=acc,
                      device=values.device)
    out.index_add_(0, torch.where(ok, index, n), values.to(acc))
    return out[:n].to(values.dtype)


def _gn_iteration(poses, patches, intr, target, weight, lam, ii, jj, kk,
                  valid, t0, t1, m_base, cfg: BAConfig, patches_est=None,
                  patch_table=None):
    W_, M_ = cfg.window, cfg.patch_slots
    dev = poses.device

    r, Ji, Jj, Jz, mask = _edge_system(poses, patches, intr, target,
                                       ii, jj, kk, cfg)
    w = weight * (mask * valid)[:, None]

    li = ii - t0
    lj = jj - t0
    oki = (li >= 0) & (li < (t1 - t0)) & (li < W_)
    okj = (lj >= 0) & (lj < (t1 - t0)) & (lj < W_)
    q = kk - m_base
    okq = (q >= 0) & (q < M_)

    wJi = w[:, :, None] * Ji
    wJj = w[:, :, None] * Jj
    wJz = w * Jz

    Bii = torch.einsum("eri,erj->eij", wJi, Ji).reshape(-1, 36)
    Bij = torch.einsum("eri,erj->eij", wJi, Jj).reshape(-1, 36)
    Bjj = torch.einsum("eri,erj->eij", wJj, Jj).reshape(-1, 36)
    Pii = _scatter_rows(Bii, li * W_ + li, oki, W_ * W_)
    Pij = _scatter_rows(Bij, li * W_ + lj, oki & okj, W_ * W_)
    Pjj = _scatter_rows(Bjj, lj * W_ + lj, okj, W_ * W_)
    # Bji[e] = Bij[e]^T at the transposed pair (lj, li)
    Pji = Pij.reshape(W_, W_, 6, 6).permute(1, 0, 3, 2).reshape(W_ * W_, 36)
    B = (Pii + Pij + Pji + Pjj).reshape(W_, W_, 6, 6).permute(0, 2, 1, 3) \
        .reshape(6 * W_, 6 * W_)

    Eik = torch.einsum("er,eri->ei", wJz, Ji)
    Ejk = torch.einsum("er,eri->ei", wJz, Jj)
    cu = torch.stack([(wJz * Jz).sum(-1), (wJz * r).sum(-1), mask * valid],
                     -1)
    iw = torch.arange(W_, device=dev)
    if cfg.per_patch_cap is not None:
        table = patch_table if patch_table is not None else \
            _group_by_patch(q, okq, M_, cfg.per_patch_cap)
        vals = torch.cat([cu, Eik, Ejk], dim=-1)
        vals = torch.cat([vals, vals.new_zeros((1, vals.shape[1]))])
        minus1 = li.new_full((1,), -1)
        li_m = torch.cat([torch.where(oki, li, -1), minus1])
        lj_m = torch.cat([torch.where(okj, lj, -1), minus1])
        g = vals[table]                                       # [M, cap, 15]
        accu = g[..., :3].sum(1)
        C, u, touched_cnt = accu[:, 0], accu[:, 1], accu[:, 2]
        ohi_t = (li_m[table][..., None] == iw).to(g.dtype)
        ohj_t = (lj_m[table][..., None] == iw).to(g.dtype)
        Em_m = (torch.einsum("mcw,mcd->mwd", ohi_t, g[..., 3:9])
                + torch.einsum("mcw,mcd->mwd", ohj_t, g[..., 9:15]))
        Em = Em_m.permute(1, 2, 0).reshape(6 * W_, M_)
    else:
        oh_i = ((li[:, None] == iw) & oki[:, None]).to(w.dtype)
        oh_j = ((lj[:, None] == iw) & okj[:, None]).to(w.dtype)
        tmp = (oh_i[:, :, None] * Eik[:, None, :]
               + oh_j[:, :, None] * Ejk[:, None, :]).reshape(-1, W_ * 6)
        oh_q = ((q[:, None] == torch.arange(M_, device=dev)) &
                okq[:, None]).to(w.dtype)
        Em = tmp.T @ oh_q
        CU = oh_q.T @ cu
        C, u, touched_cnt = CU[:, 0], CU[:, 1], CU[:, 2]
    vi = torch.einsum("er,eri->ei", w * r, Ji)
    vj = torch.einsum("er,eri->ei", w * r, Jj)
    v = (_scatter_rows(vi, li, oki, W_) + _scatter_rows(vj, lj, okj, W_)
         ).reshape(6 * W_)

    Nk = patches.shape[0]
    if patches_est is not None:
        # depth prior mu * L: patches with a positive prior disparity are
        # pulled towards it
        mu = cfg.prior_mu
        slots = (m_base + torch.arange(M_, device=dev)).clamp(0, Nk - 1)
        d_est = patches_est[slots, 2, 0, 0]
        d_cur = patches[slots, 2, 0, 0]
        L = (d_est > 0).to(C.dtype)
        C = C + mu * L
        u = u - mu * L * (d_cur - d_est)

    Q = 1.0 / (C + lam)
    EQ = Em * Q[None, :]
    S = B - EQ @ Em.T
    y = v - EQ @ u
    diag = torch.diagonal(S)
    S = S + torch.diag(cfg.lm * diag + cfg.ep)

    # a failed factorisation (S not positive definite) or a non-finite
    # solution gives a zero step: the poses and depths stay as they were
    Lc, info = torch.linalg.cholesky_ex(S)
    dX = torch.cholesky_solve(y[:, None], Lc)[:, 0]
    ok = (info == 0) & torch.isfinite(dX).all()
    dX = torch.where(ok, dX, 0.0)
    dZ = Q * (u - Em.T @ dX)
    dZ = torch.where(ok & torch.isfinite(dZ), dZ, 0.0)
    if cfg.depth_step_clamp is not None:
        dZ = dZ.clamp(-cfg.depth_step_clamp, cfg.depth_step_clamp)

    # pose retraction over [t0, t1): dead window slots go to a sentinel row
    # (clamped duplicates would otherwise race with live writes)
    N = poses.shape[0]
    slot = torch.arange(W_, device=dev)
    live = (slot < t1 - t0) & (t0 + slot < N)
    gidx = torch.where(live, (t0 + slot).clamp(0, N - 1), N)
    src = poses[gidx.clamp(max=N - 1)]
    upd = lie.se3_retr(src, dX.reshape(W_, 6))
    poses = torch.cat([poses, poses.new_zeros(1, 7)]).index_copy_(
        0, gidx, torch.where(live[:, None], upd, src))[:N]

    # depth retraction of the patches that have observations
    slots = m_base + torch.arange(M_, device=dev)
    plive = (touched_cnt > 0) & (slots >= 0) & (slots < Nk)
    pidx = torch.where(plive, slots.clamp(0, Nk - 1), Nk)
    d_old = patches[pidx.clamp(max=Nk - 1), 2]
    d_new = d_old[:, 0, 0] + dZ
    if cfg.depth_clamp == "train":
        d_new = d_new.clamp(1e-3, 10.0)
    else:
        # the inference kernel's rule: d > 20 -> 1.0, floor 1e-4
        d_new = torch.where(d_new > 20.0, 1.0, d_new).clamp(min=1e-4)
    d_new = torch.where(plive, d_new, d_old[:, 0, 0])
    patches = torch.cat([patches, patches.new_zeros((1,) + patches.shape[1:])])
    patches[:, 2].index_copy_(0, pidx, d_new[:, None, None].expand_as(d_old))
    patches = patches[:Nk]
    return poses, patches


def _bundle_adjust_impl(poses, patches, intrinsics, target, weight, lam,
                        ii, jj, kk, valid, t0, t1, m_base, cfg: BAConfig,
                        patches_est=None, patch_table=None):
    """cfg.iterations Gauss-Newton steps.

    poses [N, 7] (w2c), patches [Nk, 3, P, P], intrinsics [4] shared,
    target / weight [E, 2], ii / jj / kk [E], valid [E]; t0, t1 (the free
    pose window) and m_base (first live patch id) are host integers or 0-d
    tensors on the device.
    Returns (poses, patches).
    """
    dt = torch.float64 if poses.dtype == torch.float64 else torch.float32
    poses, patches, valid = poses.to(dt), patches.to(dt), valid.to(dt)
    ii, jj, kk = ii.long(), jj.long(), kk.long()
    if patches_est is not None:
        patches_est = patches_est.to(dt)
    if patch_table is None and cfg.per_patch_cap is not None:
        q = kk - m_base
        okq = (q >= 0) & (q < cfg.patch_slots)
        patch_table = _group_by_patch(q, okq, cfg.patch_slots,
                                      cfg.per_patch_cap)
    for _ in range(cfg.iterations):
        poses, patches = _gn_iteration(
            poses, patches, intrinsics, target, weight, lam, ii, jj, kk,
            valid, t0, t1, m_base, cfg, patches_est=patches_est,
            patch_table=patch_table)
    return poses, patches
