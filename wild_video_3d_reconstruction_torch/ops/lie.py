"""SO(3) and SE(3) operations on tensors (the pieces the VO path uses).

Same layouts and conventions as the JAX package's `ops/lie.py`:

  SO3   data[..., 4] = (qx, qy, qz, qw)
  SE3   data[..., 7] = (tx, ty, tz, qx, qy, qz, qw)   tangent (tau, phi)

Hamilton quaternions acting as X' = R X + t; the adjoint follows lietorch,
Ad = [[R, [t]x R], [0, R]]. Every function broadcasts over leading batch
dimensions and keeps the Taylor branches near the identity, selected with
`torch.where` so that no branch divides by zero.
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
    data[..., 6] = 1.0
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
