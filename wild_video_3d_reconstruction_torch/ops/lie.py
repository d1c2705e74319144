"""Lie-group operations (SO3, SE3, RxSO3, Sim3) on tensors.

Same layouts and conventions as the JAX package's `ops/lie.py`:

  SO3   data[..., 4] = (qx, qy, qz, qw)
  SE3   data[..., 7] = (tx, ty, tz, qx, qy, qz, qw)   tangent (tau, phi)
  RxSO3 data[..., 5] = (qx, qy, qz, qw, s)            tangent (phi, sigma)
  Sim3  data[..., 8] = (tx, ty, tz, qx, qy, qz, qw, s)
                                                tangent (tau, phi, sigma)

Hamilton quaternions acting as X' = R X + t; the adjoint follows lietorch,
Ad = [[R, [t]x R], [0, R]]. Every function broadcasts over leading batch
dimensions and keeps the Taylor branches near the identity, selected with
`torch.where` so that no branch divides by zero. The functions are pure
(no in-place writes, no host reads, no branch on a value), so the loop
closure's pose-graph optimisation differentiates through them with
`torch.func.jacfwd` under `torch.func.vmap`; the `where` over safe operands
keeps those derivatives finite at the identity.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _safe_sqrt(x):
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)


def quat_mul(q1, q2):
    """Hamilton product q1 * q2, (x, y, z, w) layout."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q, p):
    """Rotate 3-vectors p by unit quaternions q."""
    v = q[..., :3]
    w = q[..., 3:4]
    uv = 2.0 * _cross(v, p)
    return p + w * uv + _cross(v, uv)


def quat_to_matrix(q):
    """Unit quaternions -> 3x3 rotation matrices."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """3x3 rotation matrices -> unit quaternions (x, y, z, w), w >= 0: of
    the four candidates, the one with the largest |component| (the first
    on a tie, as `jnp.argmax`)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    q_abs = _safe_sqrt(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    # candidates in (w, x, y, z) order, each scaled by its q_abs component
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01],
                    -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20],
                    -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21],
                    -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2],
                    -1),
    ], dim=-2)
    cand = cand / (2.0 * q_abs[..., None].clamp(min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    wxyz = torch.gather(cand, -2, idx)[..., 0, :]
    wxyz = torch.where(wxyz[..., :1] < 0, -wxyz, wxyz)
    return torch.cat([wxyz[..., 1:], wxyz[..., :1]], dim=-1)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_exp(phi):
    """Rotation vector -> unit quaternion, with the Taylor branch."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    imag_t = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_t = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    safe_theta = torch.where(small, 1.0, theta)
    imag_b = torch.sin(0.5 * safe_theta) / safe_theta
    real_b = torch.cos(0.5 * safe_theta)
    imag = torch.where(small, imag_t, imag_b)
    real = torch.where(small, real_t, real_b)
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q):
    """Unit quaternion -> rotation vector."""
    v = q[..., :3]
    w = q[..., 3:4]
    n_sq = (v * v).sum(-1, keepdim=True)
    n = _safe_sqrt(n_sq)
    small = n < _EPS
    safe_n = torch.where(small, 1.0, n)
    safe_w = torch.where(w.abs() < 1e-8, 1e-8, w)
    factor_b = 2.0 * torch.atan2(n, w) / safe_n
    factor_t = 2.0 / safe_w * (1.0 - n_sq / (3.0 * safe_w * safe_w))
    return torch.where(small, factor_t, factor_b) * v


def so3_left_jacobian_terms(phi):
    """(a, b) with V = I + a [phi]x + b [phi]x^2, Taylor guarded."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    small = theta < 1e-4
    safe_sq = torch.where(small, 1.0, theta_sq)
    safe_t = torch.where(small, 1.0, theta)
    a_b = (1.0 - torch.cos(safe_t)) / safe_sq
    b_b = (safe_t - torch.sin(safe_t)) / (safe_t * safe_sq)
    a_t = 0.5 - theta_sq / 24.0
    b_t = 1.0 / 6.0 - theta_sq / 120.0
    return torch.where(small, a_t, a_b), torch.where(small, b_t, b_b)


def so3_inv_left_jacobian_coeff(phi):
    """c with V^-1 = I - 1/2 [phi]x + c [phi]x^2, Taylor guarded."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    small = theta < 1e-4
    safe_sq = torch.where(small, 1.0, theta_sq)
    safe_t = torch.where(small, 1.0, theta)
    half = 0.5 * safe_t
    cot = torch.cos(half) / torch.where(small, 1.0, torch.sin(half))
    c_b = (1.0 - half * cot) / safe_sq
    c_t = 1.0 / 12.0 + theta_sq / 720.0
    return torch.where(small, c_t, c_b)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    data = torch.zeros(tuple(batch_shape) + (7,), dtype=dtype, device=device)
    data[..., 6].fill_(1.0)     # a kernel (a CUDA graph cannot copy 1.0 in)
    return data


def se3_exp(xi):
    """Tangent (tau, phi) -> SE3 data."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    a, b = so3_left_jacobian_terms(phi)
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([tau + a * c1 + b * c2, q], dim=-1)


def se3_log(X):
    t, q = X[..., :3], X[..., 3:7]
    phi = so3_log(q)
    c = so3_inv_left_jacobian_coeff(phi)
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    return torch.cat([t - 0.5 * c1 + c * c2, phi], dim=-1)


def se3_inv(X):
    t, q = X[..., :3], X[..., 3:7]
    qinv = quat_conj(q)
    return torch.cat([-quat_rotate(qinv, t), qinv], dim=-1)


def se3_mul(X1, X2):
    t1, q1 = X1[..., :3], X1[..., 3:7]
    t2, q2 = X2[..., :3], X2[..., 3:7]
    return torch.cat([t1 + quat_rotate(q1, t2), quat_mul(q1, q2)], dim=-1)


def se3_act(X, p):
    """Act on 3-points: R p + t."""
    return quat_rotate(X[..., 3:7], p) + X[..., :3]


def se3_act4(X, p4):
    """Act on homogeneous points (x, y, z, w): (R v + w t, w)."""
    v, w = p4[..., :3], p4[..., 3:4]
    return torch.cat([quat_rotate(X[..., 3:7], v) + w * X[..., :3], w],
                     dim=-1)


def se3_adj(X, a):
    """Adjoint action Ad_X a."""
    t, q = X[..., :3], X[..., 3:7]
    at, aw = a[..., :3], a[..., 3:6]
    Raw = quat_rotate(q, aw)
    return torch.cat([quat_rotate(q, at) + _cross(t, Raw), Raw], dim=-1)


def se3_adjT(X, a):
    """Transposed adjoint Ad_X^T a = (R^T a_t, R^T (a_w - t x a_t))."""
    t, q = X[..., :3], X[..., 3:7]
    qinv = quat_conj(q)
    at, aw = a[..., :3], a[..., 3:6]
    return torch.cat([quat_rotate(qinv, at),
                      quat_rotate(qinv, aw - _cross(t, at))], dim=-1)


def se3_retr(X, xi):
    """Retraction exp(xi) * X (left-multiplied update)."""
    return se3_mul(se3_exp(xi), X)


def _homogeneous(R, t):
    """[..., 3, 3] and [..., 3] -> [..., 4, 4] with the row (0, 0, 0, 1)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_matrix(X):
    """SE3 data -> 4x4 homogeneous matrices."""
    return _homogeneous(quat_to_matrix(X[..., 3:7]), X[..., :3])


def se3_from_matrix(T):
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])],
                     dim=-1)


def se3_scale(X, s):
    """Scale the translation by s (a number or a tensor of the batch
    shape)."""
    s = torch.as_tensor(s, dtype=X.dtype, device=X.device)
    s = s[..., None] if s.ndim > 0 else s
    return torch.cat([X[..., :3] * s, X[..., 3:7]], dim=-1)


def se3_normalize(X):
    """Renormalize the quaternion part."""
    q = X[..., 3:7]
    return torch.cat([X[..., :3], q / torch.linalg.norm(q, dim=-1,
                                                        keepdim=True)],
                     dim=-1)


# ---------------------------------------------------------------------------
# RxSO3 (rotation and scale)
# ---------------------------------------------------------------------------

def rxso3_exp(phisig):
    return torch.cat([so3_exp(phisig[..., :3]), torch.exp(phisig[..., 3:4])],
                     dim=-1)


def rxso3_log(X):
    return torch.cat([so3_log(X[..., :4]), torch.log(X[..., 4:5])], dim=-1)


def rxso3_inv(X):
    return torch.cat([quat_conj(X[..., :4]), 1.0 / X[..., 4:5]], dim=-1)


def rxso3_mul(X1, X2):
    return torch.cat([quat_mul(X1[..., :4], X2[..., :4]),
                      X1[..., 4:5] * X2[..., 4:5]], dim=-1)


def rxso3_act(X, p):
    return X[..., 4:5] * quat_rotate(X[..., :4], p)


# ---------------------------------------------------------------------------
# Sim(3): data (t, q, s), tangent (tau, phi, sigma); the loop closure's
# pose graph
# ---------------------------------------------------------------------------

def sim3_identity(batch_shape=(), dtype=torch.float32, device=None):
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(batch_shape) + (8,)).clone()


def _sim3_W_terms(phi, sigma):
    """(A, B, C) of W = C I + A [phi]x + B [phi]x^2, the Sim3 exp's
    translation map (Sophus' closed forms), with the Taylor branches for
    small sigma, small theta and both."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    s = torch.exp(sigma)

    small_sig = sigma.abs() < _EPS
    small_th = theta < _EPS
    both = small_sig & small_th
    safe_sig = torch.where(small_sig, 1.0, sigma)
    safe_th = torch.where(small_th, 1.0, theta)
    safe_th_sq = safe_th * safe_th

    C = torch.where(small_sig, 1.0 + 0.5 * sigma + sigma * sigma / 6.0,
                    (s - 1.0) / safe_sig)
    sin_t, cos_t = torch.sin(safe_th), torch.cos(safe_th)

    # sigma and theta general
    a_gen = s * sin_t
    b_gen = s * cos_t
    denom = torch.where(both, 1.0, safe_sig * safe_sig + safe_th_sq)
    A_gen = (a_gen * safe_sig + (1.0 - b_gen) * safe_th) / (safe_th * denom)
    B_gen = (C - ((b_gen - 1.0) * safe_sig + a_gen * safe_th) / denom) / \
        safe_th_sq
    # sigma ~ 0
    A_s0 = (1.0 - cos_t) / safe_th_sq
    B_s0 = (safe_th - sin_t) / (safe_th_sq * safe_th)
    # theta ~ 0
    A_t0 = ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig)
    B_t0 = (s * (0.5 * safe_sig * safe_sig - safe_sig + 1.0) - 1.0) / (
        safe_sig * safe_sig * safe_sig)
    # both small
    A_00 = 0.5 + sigma / 6.0
    B_00 = 1.0 / 6.0 + sigma / 24.0

    A = torch.where(both, A_00, torch.where(
        small_sig, A_s0, torch.where(small_th, A_t0, A_gen)))
    B = torch.where(both, B_00, torch.where(
        small_sig, B_s0, torch.where(small_th, B_t0, B_gen)))
    return A, B, C


def sim3_exp(xi):
    """Tangent (tau, phi, sigma) -> Sim3 data."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    A, B, C = _sim3_W_terms(phi, sigma)
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([C * tau + A * c1 + B * c2, so3_exp(phi),
                      torch.exp(sigma)], dim=-1)


def sim3_log(X):
    """Sim3 data -> tangent: W's inverse a I + b [phi]x + c [phi]x^2 in the
    algebra span{I, P, P^2} (P = [phi]x, P^3 = -theta^2 P), its
    coefficients solved from (A, B, C) and theta^2."""
    t, q, s = X[..., :3], X[..., 3:7], X[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(s)
    A, B, C = _sim3_W_terms(phi, sigma)
    th2 = (phi * phi).sum(-1, keepdim=True)
    a = 1.0 / C
    m11 = C - th2 * B
    m12 = -th2 * A
    m21 = A
    m22 = C - th2 * B
    det = m11 * m22 - m12 * m21
    safe_det = torch.where(det.abs() < 1e-12, 1.0, det)
    r1 = -A * a
    r2 = -B * a
    b = (r1 * m22 - m12 * r2) / safe_det
    c = (m11 * r2 - r1 * m21) / safe_det
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    return torch.cat([a * t + b * c1 + c * c2, phi, sigma], dim=-1)


def sim3_inv(X):
    t, q, s = X[..., :3], X[..., 3:7], X[..., 7:8]
    qinv = quat_conj(q)
    sinv = 1.0 / s
    return torch.cat([-sinv * quat_rotate(qinv, t), qinv, sinv], dim=-1)


def sim3_mul(X1, X2):
    t1, q1, s1 = X1[..., :3], X1[..., 3:7], X1[..., 7:8]
    t2, q2, s2 = X2[..., :3], X2[..., 3:7], X2[..., 7:8]
    return torch.cat([t1 + s1 * quat_rotate(q1, t2), quat_mul(q1, q2),
                      s1 * s2], dim=-1)


def sim3_act(X, p):
    return X[..., 7:8] * quat_rotate(X[..., 3:7], p) + X[..., :3]


def sim3_act4(X, p4):
    v, w = p4[..., :3], p4[..., 3:4]
    return torch.cat([X[..., 7:8] * quat_rotate(X[..., 3:7], v)
                      + w * X[..., :3], w], dim=-1)


def sim3_matrix(X):
    return _homogeneous(quat_to_matrix(X[..., 3:7]) * X[..., 7:8, None],
                        X[..., :3])


def sim3_retr(X, xi):
    return sim3_mul(sim3_exp(xi), X)


def se3_to_sim3(X, s=None):
    """Embed SE3 into Sim3 with scale s (default 1)."""
    one = torch.ones_like(X[..., :1]) if s is None else torch.broadcast_to(
        torch.as_tensor(s, dtype=X.dtype, device=X.device), X[..., :1].shape)
    return torch.cat([X[..., :7], one], dim=-1)


def sim3_to_se3(X):
    """Drop the scale (the translation is left as it is)."""
    return X[..., :7]
