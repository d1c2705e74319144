"""Per-frame SLAM steps over the fixed-capacity state.

Counterpart of the JAX package's `slam/steps.py`, run eagerly:

  insert_frame        encoders + patch selection + buffer writes + motion
                      model
  motion_probe        trial update on the newest M edges -> median flow
  append_edges        forward + backward factors of the newest frame
  update_op           reproject -> correlate -> update operator -> 2
                      Gauss-Newton iterations
  flow_metric         keyframe flow magnitude between two frames
  keyframe_shift      keyframe eviction: buffer shift, edge renumbering
  retire_and_compact  age-based edge retirement + stable compaction
  keyframe_and_log    flow metric -> keyframe decision -> retirement
  frame_step          insert + track + keyframe for one steady-state frame

The state is updated in place (the JAX package threads new arrays; here
that would copy every buffer each frame). Frame and edge counts are host
integers, so the edge table is sliced to its used prefix, rounded up to a
multiple of 512 rows, instead of the JAX package's static prefix tiers:
rows past `n_edges` are dead and inert in every stage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ba.gauss_newton import BAConfig, _bundle_adjust_impl, _group_by_patch
from ..models import vonet
from ..models.update import update_forward
from ..models.vonet import DIM, P, RES
from ..ops import lie
from ..ops import projective as pops
from ..ops.corr import corr_lookup
from ..ops.patchify import avg_pool2d
from ..ops.segment import compact_valid, neighbors, neighbors_from_sorted
from .state import SLAMState

# the run-sum kernel serves the kk-SoftAgg when the sliced edge table is a
# whole number of these rows (the JAX package's `n_rows % 512 == 0`), on
# the card; tests set RUNSUM_ON_CPU to run the same path through the
# kernel's plain version
RUNSUM_ROWS = 512
RUNSUM_ON_CPU = False


def feat_dtype(cfg):
    return torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32


def _median(x):
    """Median that averages the two middle values (as numpy and JAX do)."""
    return torch.quantile(x.reshape(-1).float(), 0.5)


# ---------------------------------------------------------------------------
# frame insertion
# ---------------------------------------------------------------------------

def insert_frame(cfg, net, state: SLAMState, image, intrinsics, fac,
                 initialized=False, coords=None, depths=None):
    """Insert the frame at slot n = state.n_frames (not yet accepted).

    image [H, W, 3] uint8 and intrinsics [4] (full resolution) on the
    state's device; fac is the motion model's timestamp ratio. coords
    [M, 2] and depths [M] given by the caller replace the random patch
    centres and inverse depths (drawn from state.rng otherwise).
    """
    M = cfg.PATCHES_PER_FRAME
    n = state.n_frames
    dev = state.poses.device
    fd = feat_dtype(cfg)

    feats = vonet.encode_frame(net, image, fd)
    h4, w4 = feats.fmap.shape[0], feats.fmap.shape[1]
    gbias = vonet.image_gradient_map(image) if cfg.GRADIENT_BIAS else None
    coords = vonet.select_patches(state.rng, M, h4, w4, gradient_map=gbias,
                                  coords=coords, device=dev)
    imap_p, gmap_p, clr, patches = vonet.gather_patches(feats, image, coords)

    # patch inverse-depth initialization: uniform random per patch, or the
    # median of the last 3 frames' depths ("median")
    if depths is not None:
        d0 = torch.as_tensor(np.array(depths, dtype=np.float32), device=dev)
    elif initialized and cfg.DEPTH_INIT == "median":
        lo = max(n - 3, 0) * M
        d0 = _median(state.patches[lo:lo + 3 * M, 2]).expand(M)
    else:
        d0 = torch.rand(M, generator=state.rng).to(dev)
    patches[:, 2] = d0[:, None, None]

    # damped-linear motion extrapolation
    if n > 1:
        P1, P2 = state.poses[n - 1], state.poses[n - 2]
        xi = cfg.MOTION_DAMPING * fac * lie.se3_log(
            lie.se3_mul(P1, lie.se3_inv(P2)))
        state.poses[n] = lie.se3_mul(lie.se3_exp(xi), P1)
    elif n > 0:
        state.poses[n] = state.poses[n - 1]

    slot = n % cfg.pmem
    rows = slice(n * M, (n + 1) * M)
    srows = slice(slot * M, (slot + 1) * M)
    state.patches[rows] = patches
    state.patches_est[rows] = 0.0
    state.intrinsics[n] = intrinsics.float() / RES
    state.colors[n] = clr.clamp(0, 255).to(torch.uint8)
    state.imap[srows] = imap_p.to(fd)
    state.gmap[srows] = gmap_p.to(fd)
    state.fmap1[slot] = feats.fmap.to(fd)
    state.fmap2[slot] = avg_pool2d(feats.fmap, 4).to(fd)
    return state


# ---------------------------------------------------------------------------
# the update network over an edge list
# ---------------------------------------------------------------------------

def _run_update_net(cfg, net, state: SLAMState, net_e, ii, jj, kk, valid, n,
                    nbr=None, agg_order=None):
    """reproject -> correlate -> update operator; returns
    (net', delta, weight, coords)."""
    M = cfg.PATCHES_PER_FRAME
    pmem = cfg.pmem
    fd = feat_dtype(cfg)

    coords = pops.transform(state.poses, state.patches, state.intrinsics,
                            ii, jj, kk)
    coords = torch.where(valid[:, None, None, None], coords, 0.0)
    kk_slot = kk % (M * pmem)
    corr = corr_lookup(state.gmap, (state.fmap1, state.fmap2), coords.float(),
                       kk_slot, jj % pmem, valid, chunk=cfg.CORR_CHUNK,
                       fused=cfg.PALLAS_FUSED, variant=cfg.PALLAS_VARIANT)
    ctx = state.imap[kk_slot]

    # bounded segment ids of the SoftAgg groups
    FW = cfg.frame_window
    fb = max(n - (FW - 1), 0)
    kk_seg = (kk - fb * M).clamp(0, cfg.patch_slots)
    kk_seg = torch.where(valid, kk_seg, cfg.patch_slots)
    li = (ii - fb).clamp(0, FW)
    lj = (jj - fb).clamp(0, FW)
    ij_seg = torch.where(valid, li * (FW + 1) + lj, (FW + 1) * (FW + 1))

    nbr_ix, nbr_jx = nbr if nbr is not None else \
        neighbors(kk, jj, valid=valid)
    with torch.no_grad():
        net2, delta, weight = update_forward(
            net.update, net_e.to(fd), ctx.to(fd), corr.to(fd), kk_seg,
            ij_seg, nbr_ix, nbr_jx, valid, cfg.patch_slots + 1,
            (FW + 1) * (FW + 1) + 1, kk_order=agg_order)
    return net2, delta, weight, coords


def motion_probe(cfg, net, state: SLAMState):
    """Median flow-delta magnitude of trial edges from the previous
    frame's patches into the current (not yet accepted) frame."""
    M = cfg.PATCHES_PER_FRAME
    n = state.n_frames
    dev = state.poses.device
    kk = n * M - M + torch.arange(M, device=dev)
    jj = torch.full((M,), n, device=dev)
    ii = kk // M
    valid = torch.ones(M, dtype=torch.bool, device=dev)
    net_e = torch.zeros((M, DIM), dtype=feat_dtype(cfg), device=dev)
    _, delta, _, _ = _run_update_net(cfg, net, state, net_e, ii, jj, kk,
                                     valid, n)
    return _median(torch.linalg.norm(delta.float(), dim=-1))


# ---------------------------------------------------------------------------
# edge lifecycle
# ---------------------------------------------------------------------------

def append_edges(cfg, state: SLAMState):
    """Append forward + backward factors for the newly accepted frame
    c = n_frames - 1: patches of frames [n-r, c) -> c, and patches of c ->
    frames [n-r, n)."""
    M = cfg.PATCHES_PER_FRAME
    r = cfg.PATCH_LIFETIME
    n = state.n_frames
    c = n - 1
    dev = state.poses.device

    A_f = (r - 1) * M
    kk_f = M * c - A_f + torch.arange(A_f, device=dev)
    ii_f = torch.div(kk_f, M, rounding_mode="floor")
    jj_f = torch.full((A_f,), c, device=dev)
    ok_f = (kk_f >= M * max(n - r, 0)) & (kk_f >= 0)

    tvals = n - r + torch.arange(r, device=dev)
    kk_b = (M * c + torch.arange(M, device=dev))[:, None].expand(M, r)
    kk_b = kk_b.reshape(-1)
    jj_b = tvals[None, :].expand(M, r).reshape(-1)
    ii_b = torch.div(kk_b, M, rounding_mode="floor")
    ok_b = jj_b >= 0

    A = A_f + M * r
    cur = state.n_edges
    if cur + A > state.ii.shape[0]:
        raise RuntimeError(f"edge table full ({cur} + {A} rows > "
                           f"{state.ii.shape[0]})")
    rows = slice(cur, cur + A)
    state.ii[rows] = torch.cat([ii_f, ii_b]).clamp(min=0)
    state.jj[rows] = torch.cat([jj_f, jj_b]).clamp(min=0)
    state.kk[rows] = torch.cat([kk_f, kk_b]).clamp(min=0)
    state.valid[rows] = torch.cat([ok_f, ok_b])
    state.net[rows] = 0
    state.target[rows] = 0.0
    state.weight[rows] = 0.0
    state.n_edges = cur + A
    return state


def retire_and_compact(cfg, state: SLAMState):
    """Drop edges whose source left the removal window, then stable-
    compact the used prefix of the table."""
    M = cfg.PATCHES_PER_FRAME
    n = state.n_frames
    ne = state.n_edges
    sl = slice(0, ne)
    keep = state.valid[sl] & (torch.div(state.kk[sl], M, rounding_mode="floor")
                              >= n - cfg.REMOVAL_WINDOW)
    perm, n_valid = compact_valid(keep)
    for name in ("ii", "jj", "kk", "net", "target", "weight"):
        a = getattr(state, name)
        a[sl] = a[sl][perm]
    state.valid[sl] = keep[perm]
    state.n_edges = int(n_valid)
    return state


def _rows_used(state):
    """Rows of the edge table an update runs over: n_edges rounded up to
    a multiple of RUNSUM_ROWS, within the capacity."""
    E = state.ii.shape[0]
    return min(-(-state.n_edges // RUNSUM_ROWS) * RUNSUM_ROWS, E)


# ---------------------------------------------------------------------------
# the optimization inner loop
# ---------------------------------------------------------------------------

def update_op(cfg, net, state: SLAMState, t0, lam=None):
    """One update: network + 2 Gauss-Newton iterations over the free
    poses [t0, n). lam overrides the depth damping (default 1e-4)."""
    M = cfg.PATCHES_PER_FRAME
    n = state.n_frames
    m_base = max(n - (cfg.patch_window_frames - 1), 0) * M
    ba_cfg = BAConfig(window=cfg.ba_window, patch_slots=cfg.patch_slots,
                      iterations=2, per_patch_cap=2 * cfg.PATCH_LIFETIME + 2,
                      depth_step_clamp=cfg.DEPTH_STEP_CLAMP or None)
    n_rows = _rows_used(state)
    sl = slice(0, n_rows)
    ii, jj, kk, valid = state.ii[sl], state.jj[sl], state.kk[sl], \
        state.valid[sl]

    # BA patch-table membership "okq_prefix": patch slots of the BA window
    # on real table rows (< n_edges). ONE stable sort serves the BA table,
    # the neighbour links and the run-sum SoftAgg.
    q = kk - m_base
    okq = (q >= 0) & (q < cfg.patch_slots)
    okp = okq & (torch.arange(n_rows, device=kk.device) < state.n_edges)
    key = torch.where(okp, q, cfg.patch_slots)
    order = torch.argsort(key, stable=True)
    table = _group_by_patch(q, okp, cfg.patch_slots, ba_cfg.per_patch_cap,
                            order=order)
    nbr = neighbors_from_sorted(order, key[order], valid[order],
                                cfg.patch_slots)
    # the same sort serves the kk-SoftAgg as run-sums when every live edge
    # is a table member: only then are a patch's live rows one run under
    # it. (Not so while the bootstrap spans more frames than the patch
    # window, where the SoftAgg ids clamp the older patches into segment
    # 0; the one-hot / scatter forms then keep the exact sums.)
    agg_order = None
    if n_rows % RUNSUM_ROWS == 0 and (kk.is_cuda or RUNSUM_ON_CPU) and \
            not bool((valid & ~okp).any()):
        agg_order = order

    net2, delta, weight, coords = _run_update_net(
        cfg, net, state, state.net[sl], ii, jj, kk, valid, n, nbr=nbr,
        agg_order=agg_order)
    target = coords[:, P // 2, P // 2, :].float() + delta.float()
    weight = weight.float() * valid[:, None]
    poses, patches = _bundle_adjust_impl(
        state.poses, state.patches, state.intrinsics[0], target, weight,
        1e-4 if lam is None else lam, ii, jj, kk, valid, t0, n, m_base,
        ba_cfg, patches_est=state.patches_est, patch_table=table)
    state.net[sl] = net2.to(state.net.dtype)
    state.target[sl] = target
    state.weight[sl] = weight
    state.poses = poses
    state.patches = patches
    return state


def flow_metric(cfg, state: SLAMState, i, j):
    """Bidirectional mean flow magnitude between frames i and j over the
    live edges connecting them (beta = 0.5), reprojected on a compacted
    buffer of at most 4M edges. Returns a 0-d tensor."""
    M = cfg.PATCHES_PER_FRAME
    B = 4 * M
    ne = state.n_edges
    dev = state.ii.device
    if ne == 0:
        return torch.zeros((), device=dev)
    sl = slice(0, ne)
    ii, jj, valid = state.ii[sl], state.jj[sl], state.valid[sl]
    m_fwd = (ii == i) & (jj == j) & valid
    m_rev = (ii == j) & (jj == i) & valid
    m = m_fwd | m_rev
    r = torch.cumsum(m.long(), 0) - 1
    pos = torch.where(m & (r < B), r, B)
    buf = torch.full((B + 1,), ne, dtype=torch.long, device=dev)
    buf[pos] = torch.arange(ne, device=dev)
    buf = buf[:B]
    ok = buf < ne
    bc = buf.clamp(0, ne - 1)
    fm = pops.flow_mag(state.poses, state.patches, state.intrinsics,
                       ii[bc], jj[bc], state.kk[sl][bc],
                       beta=0.5).mean(dim=(1, 2))

    def masked_mean(w):
        w = w.float()
        return (fm * w).sum() / w.sum().clamp(min=1.0)

    return masked_mean(m_fwd[bc] & ok) + masked_mean(m_rev[bc] & ok)


# ---------------------------------------------------------------------------
# keyframe eviction
# ---------------------------------------------------------------------------

def keyframe_shift(cfg, state: SLAMState):
    """Evict keyframe k = n - KEYFRAME_INDEX: drop its edges, renumber the
    newer ones, shift the KEYFRAME_INDEX - 1 newest frames one slot down.
    Returns (state, dP) with dP = pose_k * pose_{k-1}^-1."""
    M = cfg.PATCHES_PER_FRAME
    pmem = cfg.pmem
    KI = cfg.KEYFRAME_INDEX
    n = state.n_frames
    k = n - KI

    dP = lie.se3_mul(state.poses[k], lie.se3_inv(state.poses[k - 1]))

    newer = state.ii > k
    state.valid &= ~((state.ii == k) | (state.jj == k))
    state.kk = torch.where(newer, state.kk - M, state.kk)
    state.ii = torch.where(newer, state.ii - 1, state.ii)
    state.jj = torch.where(state.jj > k, state.jj - 1, state.jj)

    def shift_rows(a, pf):
        a[k * pf:(k + KI - 1) * pf] = a[(k + 1) * pf:(k + KI) * pf].clone()

    def shift_ring(a, ps):
        for i in range(KI - 1):
            src = (k + i + 1) % pmem
            dst = (k + i) % pmem
            a[dst * ps:(dst + 1) * ps] = a[src * ps:(src + 1) * ps]

    shift_rows(state.poses, 1)
    shift_rows(state.patches, M)
    shift_rows(state.patches_est, M)
    shift_rows(state.intrinsics, 1)
    shift_rows(state.colors, 1)
    shift_ring(state.imap, M)
    shift_ring(state.gmap, M)
    shift_ring(state.fmap1, 1)
    shift_ring(state.fmap2, 1)
    state.n_frames = n - 1
    return state, dP


def keyframe_and_log(cfg, state: SLAMState):
    """Flow metric -> keyframe decision -> retirement. Returns (state,
    event) with event = (removed, dP [7], flow metric, nan_flag), the
    record `DPVO` keeps for the trajectory's delta chain."""
    n = state.n_frames
    mm = float(flow_metric(cfg, state, n - cfg.KEYFRAME_INDEX - 1,
                           n - cfg.KEYFRAME_INDEX + 1))
    removed = mm / 2.0 < cfg.KEYFRAME_THRESH
    if removed:
        state, dP = keyframe_shift(cfg, state)
    else:
        dP = lie.se3_identity((), device=state.poses.device)
    k = max(state.n_frames - cfg.KEYFRAME_INDEX, 0)
    nan_flag = bool(torch.isnan(state.poses[k]).any())
    state = retire_and_compact(cfg, state)
    return state, (removed, dP.cpu(), mm, nan_flag)


def track_and_keyframe(cfg, net, state: SLAMState):
    state = append_edges(cfg, state)
    t0 = max(state.n_frames - cfg.OPTIMIZATION_WINDOW, 1)
    state = update_op(cfg, net, state, t0)
    return keyframe_and_log(cfg, state)


def frame_step(cfg, net, state: SLAMState, image, intrinsics, fac,
               coords=None, depths=None):
    """insert + track + keyframe for one steady-state frame; returns
    (state, event) as `keyframe_and_log`."""
    state = insert_frame(cfg, net, state, image, intrinsics, fac,
                         initialized=True, coords=coords, depths=depths)
    state.n_frames += 1
    return track_and_keyframe(cfg, net, state)
