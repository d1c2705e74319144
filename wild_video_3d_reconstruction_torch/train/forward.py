"""Differentiable training forward (BA in the loop).

Counterpart of the JAX package's `train/forward.py`: encode a clip in
fp32, select and gather patches with their ground-truth disparities, build
the all-pairs edge set over the clip (kk-major, as the reference), and
unroll `steps` update + bundle-adjustment iterations, collecting the
(coords, coords_gt, valid, poses, poses_gt) supervision of each.

As in the JAX package the window is the whole clip and the reference's
10% edge dropout is a random edge mask drawn per step; the Gauss-Newton
solve is `ba/gauss_newton.py`'s, with the training bounds (+-64 px), the
training epsilon and the training depth clamp. Poses and patches are
detached at the top of each step, so the correlation's coordinates carry
no gradient; the hidden state is not.

The random draws (patch centres, initial inverse depths, the dropout
masks) come from a `torch.Generator`, in that order; they differ from
the JAX package's `jax.random` draws (ROADMAP R18), so the parity tests
inject `patch_coords` / `init_depths` and set `edge_dropout=0`. A CPU
generator gives the same draws to a run on the card and on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ba.gauss_newton import BAConfig, _bundle_adjust_impl
from ..models.update import update_forward
from ..models.vonet import (DIM, P, RES, FrameFeatures, draw_centres,
                            encode_frames, gather_patches)
from ..ops import projective as pops
from ..ops.corr import corr_lookup
from ..ops.patchify import avg_pool2d
from ..ops.segment import neighbors


class TrainConfig(NamedTuple):
    frames: int = 8          # clip length (window)
    patches: int = 8         # patches per frame
    steps: int = 4           # unrolled update iterations
    edge_dropout: float = 0.1
    ba_iters: int = 2
    ba_ep: float = 10.0      # Schur-system epsilon of the training BA
    self_edges: bool = False  # include i == j edges (no supervision)


def to_device(t, device):
    """t on device; a host tensor bound for the card goes through pinned
    memory without blocking (a pageable copy would wait for the stream's
    queued work)."""
    device = torch.device(device)
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _as_tensor(x, device, dtype=torch.float32):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return to_device(t.to(dtype), device)


def clip_draws(generator, tc: TrainConfig, h4, w4, device, draw_coords=True,
               draw_depths=True):
    """One clip's random draws, in the generator's order: the patch
    centres of each frame (x then y, `draw_centres`), the initial inverse
    depths in [0, 1), then per step one uniform per edge for the dropout.
    Returns (coords [T, M, 2] or None, d0 [T * M] or None, keep masks
    [steps, E] bool) on device, moved there in one copy."""
    T, M = tc.frames, tc.patches
    E = T * M * T
    parts = []
    if draw_coords:
        parts.append(torch.stack([draw_centres(generator, M, h4, w4)
                                  for _ in range(T)]).reshape(-1))
    if draw_depths:
        parts.append(torch.rand(T * M, generator=generator,
                                device=generator.device))
    parts.append(torch.rand(tc.steps * E, generator=generator,
                            device=generator.device))
    flat = to_device(torch.cat(parts), device)
    coords = d0 = None
    if draw_coords:
        coords, flat = flat[:T * M * 2].reshape(T, M, 2), flat[T * M * 2:]
    if draw_depths:
        d0, flat = flat[:T * M], flat[T * M:]
    keep = flat.reshape(tc.steps, E) < 1.0 - tc.edge_dropout
    return coords, d0, keep


def all_pairs_edges(T, M, self_edges=False, device="cpu"):
    """(ii, jj, kk, keep) [T * M * T]: every patch into every frame of the
    clip, kk-major (the reference's order); keep drops i == j unless
    self_edges."""
    src = torch.arange(T, device=device).repeat_interleave(M)
    ii = src[:, None].expand(T * M, T).reshape(-1)
    jj = torch.arange(T, device=device).repeat(T * M)
    kk = torch.arange(T * M, device=device).repeat_interleave(T)
    keep = torch.ones_like(ii, dtype=torch.bool) if self_edges else ii != jj
    return ii, jj, kk, keep


def vonet_training_forward(net, images, poses_gt, disps, intrinsics,
                           generator, tc: TrainConfig, patch_coords=None,
                           init_depths=None):
    """The per-step supervision dicts of one clip.

    images [T, H, W, 3] uint8, poses_gt [T, 7] w2c, disps [T, H/4, W/4]
    ground-truth disparity at feature scale, intrinsics [4] at full
    resolution, all on the network's device; generator draws the patch
    centres (unless patch_coords [T, M, 2] is given), the initial inverse
    depths (unless init_depths [T * M]) and the dropout masks.
    """
    dev = images.device
    T, M = tc.frames, tc.patches
    poses_gt = _as_tensor(poses_gt, dev)
    disps = _as_tensor(disps, dev)
    intrinsics = _as_tensor(intrinsics, dev)

    feats = encode_frames(net, images)
    h4, w4 = feats.fmap.shape[1], feats.fmap.shape[2]
    coords, d0, drops = clip_draws(generator, tc, h4, w4, dev,
                                   patch_coords is None, init_depths is None)
    if patch_coords is not None:
        coords = _as_tensor(patch_coords, dev)
    if init_depths is not None:
        d0 = _as_tensor(init_depths, dev)
    gathered = [gather_patches(FrameFeatures(feats.fmap[t], feats.imap[t]),
                               images[t], coords[t], disps[t])
                for t in range(T)]
    imap_flat = torch.cat([g[0] for g in gathered])            # [T*M, DIM]
    gmap_flat = torch.cat([g[1] for g in gathered]).contiguous()
    patches_gt = torch.cat([g[3] for g in gathered])            # [T*M,3,P,P]
    fmap1 = feats.fmap.contiguous()
    fmap2 = avg_pool2d(feats.fmap, 4).contiguous()

    # random initial inverse depths (the reference's `net.py:224-225`)
    patches = torch.cat([patches_gt[:, :2],
                         d0[:, None, None, None].expand(T * M, 1, P, P)], 1)

    ii, jj, kk, keep = all_pairs_edges(T, M, tc.self_edges, dev)
    E = ii.shape[0]
    intr4 = intrinsics / RES
    intr_frames = intr4[None].expand(T, 4)
    poses = torch.zeros((T, 7), device=dev)
    poses[:, 6] = 1.0                                          # identity
    net_e = torch.zeros((E, DIM), device=dev)
    ba_cfg = BAConfig(window=T, patch_slots=T * M, iterations=tc.ba_iters,
                      bounds_margin=64.0, per_patch_cap=T, ep=tc.ba_ep,
                      depth_clamp="train")
    nbr_ix, nbr_jx = neighbors(kk, jj, valid=keep)
    ij_seg = ii * T + jj
    dij = (ii - jj).abs()
    traj = []
    for step in range(tc.steps):
        poses = poses.detach()
        patches = patches.detach()
        valid_e = keep & drops[step]

        coords_e = pops.transform(poses, patches, intr_frames, ii, jj, kk)
        corr = corr_lookup(gmap_flat, (fmap1, fmap2), coords_e, kk, jj,
                           valid_e)
        net_e, delta, weight = update_forward(
            net.update, net_e, imap_flat[kk], corr, kk, ij_seg, nbr_ix,
            nbr_jx, valid_e, T * M, T * T)

        target = coords_e[:, P // 2, P // 2, :] + delta
        weight = weight * valid_e[:, None]
        poses, patches = _bundle_adjust_impl(
            poses, patches, intr4, target, weight, 1e-4, ii, jj, kk,
            valid_e.float(), 1, T, 0, ba_cfg)

        coords_est = pops.transform(poses, patches, intr_frames, ii, jj, kk)
        coords_gt, valid_gt, _ = pops.transform(
            poses_gt, patches_gt, intr_frames, ii, jj, kk, jacobian=True)
        sup = valid_e & (dij > 0) & (dij <= 2)
        traj.append({"coords": coords_est, "coords_gt": coords_gt,
                     "valid": sup.float() * valid_gt, "poses": poses,
                     "poses_gt": poses_gt})
    return traj
