"""Projective geometry over patch graphs.

Counterpart of the JAX package's `ops/projective.py`, same conventions:
world-to-camera SE3 poses, patches as [..., 3, P, P] grids of
(x, y, inverse depth) at 1/RES resolution, homogeneous back-projection
(x_n, y_n, 1, d), and the analytic centre-pixel Jacobians for a
left-multiplicative pose perturbation.
"""

from __future__ import annotations

import torch

from . import lie

MIN_DEPTH = 0.2


def iproj(patches, intrinsics):
    """patches [E, 3, P, P], intrinsics [E, 4] -> X [E, P, P, 4]."""
    x, y, d = patches[:, 0], patches[:, 1], patches[:, 2]
    fx, fy, cx, cy = [intrinsics[:, i, None, None] for i in range(4)]
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                       dim=-1)


def proj(X, intrinsics, depth=False):
    """X [E, P, P, 4] -> pixels [E, P, P, 2] (3 with inverse depth)."""
    Z = X[..., 2]
    fx, fy, cx, cy = [intrinsics[:, i, None, None] for i in range(4)]
    d = 1.0 / Z.clamp(min=0.1)
    px = fx * (d * X[..., 0]) + cx
    py = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([px, py, d], dim=-1)
    return torch.stack([px, py], dim=-1)


def relative_poses(poses, ii, jj):
    """G_ij = pose_j * pose_i^-1."""
    return lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))


def transform(poses, patches, intrinsics, ii, jj, kk, depth=False,
              valid=False, jacobian=False, tonly=False):
    """Reproject patch kk from frame ii into frame jj.

    poses [N, 7], patches [Nk, 3, P, P], intrinsics [N, 4], ii/jj/kk [E].
    With jacobian=True also returns the centre-pixel Jacobians
    (Ji [E, 2, 6], Jj [E, 2, 6], Jz [E, 2, 1]).
    """
    X0 = iproj(patches[kk], intrinsics[ii])
    Gij = relative_poses(poses, ii, jj)
    if tonly:
        ident_q = torch.zeros_like(Gij[:, 3:7])
        ident_q[:, 3].fill_(1.0)
        Gij = torch.cat([Gij[:, :3], ident_q], dim=-1)

    X1 = lie.se3_act4(Gij[:, None, None, :], X0)
    x1 = proj(X1, intrinsics[jj], depth=depth)

    if jacobian:
        P = X1.shape[1]
        Xc = X1[:, P // 2, P // 2, :]
        X, Y, Z, H = Xc.unbind(-1)
        o = torch.zeros_like(H)
        fx, fy = intrinsics[jj, 0], intrinsics[jj, 1]
        big = Z.abs() > MIN_DEPTH
        d = torch.where(big, 1.0 / torch.where(big, Z, 1.0), 0.0)
        Ja = torch.stack([
            H, o, o, o, Z, -Y,
            o, H, o, -Z, o, X,
            o, o, H, Y, -X, o,
            o, o, o, o, o, o,
        ], dim=-1).reshape(-1, 4, 6)
        Jp = torch.stack([
            fx * d, o, -fx * X * d * d, o,
            o, fy * d, -fy * Y * d * d, o,
        ], dim=-1).reshape(-1, 2, 4)
        Jj = Jp @ Ja
        Ji = -lie.se3_adjT(Gij[:, None, :], Jj)
        tcol = torch.cat([Gij[:, :3], torch.ones_like(H)[:, None]], dim=-1)
        Jz = Jp @ tcol[..., None]
        return x1, (Z > MIN_DEPTH).to(x1.dtype), (Ji, Jj, Jz)

    if valid:
        return x1, (X1[..., 2] > MIN_DEPTH).to(x1.dtype)
    return x1


def point_cloud(poses, patches, intrinsics, ix):
    """Patches lifted to homogeneous world points [Nk, P, P, 4]
    (camera-to-world): divide xyz by the 4th (inverse-depth) component
    for metric points."""
    X0 = iproj(patches, intrinsics[ix])
    Ginv = lie.se3_inv(poses[ix])
    return lie.se3_act4(Ginv[:, None, None, :], X0)


def flow_mag(poses, patches, intrinsics, ii, jj, kk, beta=0.3):
    """Blended full / translation-only flow magnitude [E, P, P]."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1 = transform(poses, patches, intrinsics, ii, jj, kk)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1.0 - beta) * flow2


def coords_grid_with_index(d):
    """d [N, H, W] -> [N, 3, H, W]: each pixel's (x, y) stacked with d
    (the JAX package's `coords_grid_with_index`)."""
    n, h, w = d.shape
    x = torch.arange(w, dtype=d.dtype, device=d.device)
    y = torch.arange(h, dtype=d.dtype, device=d.device)
    return torch.stack([x.expand(n, h, w), y[:, None].expand(n, h, w), d],
                       dim=1)
