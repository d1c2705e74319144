"""Global bundle adjustment over all keyframes, at terminate.

Counterpart of the JAX package's `slam/global_ba.py`: pairwise keyframe
distances from the bidirectional mean flow magnitude, sequential edges
plus distance edges (or a fixed long-range pattern), one update-operator
pass over the patch edges of those frame pairs and a Gauss-Newton solve
over every keyframe but the first.

It needs `ENABLE_GLOBAL_BA`, which sizes the feature rings to the whole
buffer (`DPVOConfig.pmem`), so every keyframe's features are still there.
As in the JAX package, the patch edges are padded to a multiple of 8192
rows and the frames to the `n_bucket` power of two.

The pass correlates through `ops/corr.py:corr_lookup` (unfused): on the
card the correlation body of `csrc/corr_box.cu`, on the CPU its plain
version; both are exact, as the JAX pass's `patch_corr_pyramid`. Its kk
SoftAgg takes the scatter form: the sequential and distance edges
interleave, so a patch's rows are not one sorted run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ba.gauss_newton import BAConfig, _bundle_adjust_impl
from ..models.update import update_forward
from ..models.vonet import DIM, P
from ..ops import projective as pops
from ..ops.corr import corr_lookup
from ..ops.segment import neighbors
from .steps import feat_dtype

EDGE_PAD = 8192


def _pair_distance_matrix(cfg, state, n):
    """[n, n] bidirectional mean flow magnitude (beta = 0.5) between the
    first n keyframes: D[i, j] = (F[i, j] + F[j, i]) / 2, F[i, j] the
    mean flow of frame i's patches reprojected into frame j."""
    M = cfg.PATCHES_PER_FRAME
    dev = state.poses.device
    f = torch.arange(n, device=dev)
    ii = f.repeat_interleave(n * M)                       # [n * n * M]
    jj = f.repeat_interleave(M).repeat(n)
    kk = ii * M + torch.arange(M, device=dev).repeat(n * n)
    fm = pops.flow_mag(state.poses, state.patches, state.intrinsics, ii, jj,
                       kk, beta=0.5)
    D = fm.reshape(n, n, -1).mean(-1)
    return 0.5 * (D + D.T)


def propose_edges(cfg, slam, max_edges=512):
    """Frame edges (ii, jj) as numpy arrays: (i, i + 1) for every
    keyframe, then the pairs j >= i + 2 under DISTANCE_THRESH in order of
    distance (ties by i, then j), at most max_edges of them; or, without
    USE_DISTANCE_EDGES, i -> [i + 10, i + 20) for every 5th i."""
    n = slam.n
    D = _pair_distance_matrix(cfg, slam.state, n).cpu().numpy()
    ii = list(range(n - 1))
    jj = list(range(1, n))
    if cfg.USE_DISTANCE_EDGES:
        cand = sorted((D[i, j], i, j) for i in range(n)
                      for j in range(i + 2, n)
                      if np.isfinite(D[i, j]) and
                      D[i, j] < cfg.DISTANCE_THRESH)
        for _, i, j in cand[:max_edges]:
            ii.append(i)
            jj.append(j)
    else:
        for i in range(0, n, 5):
            for j in range(i + 10, min(i + 20, n)):
                ii.append(i)
                jj.append(j)
    return np.asarray(ii), np.asarray(jj)


def run_global_ba(cfg, slam, iterations=2, max_edges=512):
    """One update-operator pass and a Gauss-Newton solve over the proposed
    edges, written into slam.state's poses and patches. Returns (keyframes,
    frame edges, patch edges), or None when there is nothing to do."""
    if not cfg.ENABLE_GLOBAL_BA:
        return None
    slam._replay_log()
    n = slam.n
    if n < 2:
        return None
    M = cfg.PATCHES_PER_FRAME
    ii_f, jj_f = propose_edges(cfg, slam, max_edges)
    print(f"Global BA over {n} keyframes, {len(ii_f)} frame edges")

    E = len(ii_f) * M
    E_pad = -(-E // EDGE_PAD) * EDGE_PAD
    dev = slam.state.poses.device

    def patch_edges(a):
        return torch.from_numpy(np.pad(a, (0, E_pad - E))).to(dev)

    ii = patch_edges(np.repeat(ii_f, M))
    jj = patch_edges(np.repeat(jj_f, M))
    kk = patch_edges((ii_f[:, None] * M + np.arange(M)).reshape(-1))
    valid = torch.arange(E_pad, device=dev) < E
    n_bucket = 1 << max(int(np.ceil(np.log2(max(n + 1, 2)))), 4)
    per_patch_cap = int(np.bincount(ii_f).max()) + 1
    poses, patches = global_pass(cfg, slam.net, slam.state, ii, jj, kk,
                                 valid, n, n_bucket, iterations,
                                 per_patch_cap)
    slam.state.poses.copy_(poses)
    slam.state.patches.copy_(patches)
    return n, len(ii_f), E


def global_pass(cfg, net, state, ii, jj, kk, valid, n, n_bucket, iterations,
                per_patch_cap):
    """(poses, patches) after the update operator and `iterations`
    Gauss-Newton steps over the patch edges (ii, jj, kk, valid), the
    poses [1, n) free."""
    M = cfg.PATCHES_PER_FRAME
    pmem = cfg.pmem
    fd = feat_dtype(cfg)
    E = ii.shape[0]

    coords = pops.transform(state.poses, state.patches, state.intrinsics,
                            ii, jj, kk)
    coords = torch.where(valid[:, None, None, None], coords, 0.0)
    kk_slot = kk % (M * pmem)
    corr = corr_lookup(state.gmap, (state.fmap1, state.fmap2),
                       coords.float(), kk_slot, jj % pmem, valid,
                       chunk=cfg.CORR_CHUNK)
    ctx = state.imap[kk_slot]
    kk_seg = torch.where(valid, kk, n_bucket * M)
    ij_seg = torch.where(valid, ii * n_bucket + jj, n_bucket * n_bucket)
    nbr_ix, nbr_jx = neighbors(kk, jj, valid=valid)
    net_e = torch.zeros((E, DIM), dtype=fd, device=ii.device)
    with torch.no_grad():
        _, delta, weight = update_forward(
            net.update, net_e, ctx.to(fd), corr.to(fd), kk_seg, ij_seg,
            nbr_ix, nbr_jx, valid, n_bucket * M + 1,
            n_bucket * n_bucket + 1)
    target = coords[:, P // 2, P // 2, :].float() + delta.float()
    weight = weight.float() * valid[:, None]
    ba_cfg = BAConfig(window=n_bucket, patch_slots=n_bucket * M,
                      iterations=iterations, per_patch_cap=per_patch_cap)
    return _bundle_adjust_impl(
        state.poses, state.patches, state.intrinsics[0], target, weight,
        1e-4, ii, jj, kk, valid, 1, n, 0, ba_cfg)
