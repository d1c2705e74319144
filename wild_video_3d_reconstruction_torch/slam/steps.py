"""Per-frame SLAM steps over the fixed-capacity state.

Counterpart of the JAX package's `slam/steps.py`:

  insert_frame        encoders + patch selection (random, gradient, mask,
                      keypoints) + the depth prior + buffer writes +
                      motion model
  motion_probe        trial update on the newest M edges -> median flow
  append_edges        forward + backward factors of the newest frame
  update_op           reproject -> correlate -> update operator -> 2
                      Gauss-Newton iterations
  flow_metric         keyframe flow magnitude between two frames
  compute_points      world points of every patch slot (the map)
  keyframe_shift      keyframe eviction: buffer shift, edge renumbering
  retire_and_compact  age-based edge retirement + stable compaction
  keyframe_and_log    flow metric -> on-device keyframe decision -> event
                      log row -> retirement
  frame_step          insert + track + keyframe for one steady-state frame
  chunk_step          frame_step over K staged frames
  track_step          append + update + flow metric; the host takes the
                      keyframe decision (`DPVO(sync_mode=True)`)

The state is updated in place (the JAX package threads new arrays; here
that would copy every buffer each frame, and a CUDA graph replays reads
and writes at fixed addresses). The counters are device scalars
(`state.counts`), so `frame_step` reads nothing back to the host: every
shape in it is static, the keyframe branch is a predicated copy, and it
replays as a CUDA graph (`slam.graphs`). The O(E) stages run over a
static prefix of the edge table, a tier of `edge_tiers` (the JAX
package's `_run_tiered`): `n_rows` names it; the caller picks the
smallest tier holding the frame's edges (`rows_for`, which reads the edge
count, or `DPVO` from its one read between frames). Rows past
`n_edges` are dead and inert in every stage.
"""

from __future__ import annotations

from typing import NamedTuple

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

# the run-sum kernel serves the kk-SoftAgg when the edge prefix is a whole
# number of these rows (the JAX package's `n_rows % 512 == 0`), on the
# card; tests set RUNSUM_ON_CPU to run the same path through the kernel's
# plain version
RUNSUM_ROWS = 512
RUNSUM_ON_CPU = False

# edge-prefix tiers (the JAX package's `_run_tiered`): fractions of the
# config's edge capacity, rounded up to 1024 rows, the last tier the whole
# table. Tiering engages from TIER_MIN_EDGES rows on, and on the CPU only
# when a test sets TIER_ON_CPU (as `tests/test_tiering.py` does for JAX).
TIER_FRACS = {2: (40, 100), 3: (33, 45, 100)}
TIER_MIN_EDGES = 4096
TIER_ON_CPU = False


def feat_dtype(cfg):
    return torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32


def _median(x, dim=None):
    """Median that averages the two middle values (as numpy and JAX do),
    of all of x or along dim; NaN where a NaN is in it."""
    x = x.float()
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.quantile(x, 0.5, dim=dim, interpolation="midpoint")


def _relu(x):
    """max(x, 0) of a host integer or a device scalar."""
    return x.clamp(min=0) if torch.is_tensor(x) else max(x, 0)


def _div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _row(a, i):
    """a[i] for a device scalar i, as a gather (indexing with a 0-d tensor
    may read it back to the host)."""
    return a.index_select(0, i.reshape(1))[0]


class FrameInputs(NamedTuple):
    """What one steady frame brings to `frame_step`, on the state's device:
    image [H, W, 3] uint8, intrinsics [4] fp32 (full resolution), fac 0-d
    fp32 (the motion model's timestamp ratio), cand [n, 2] fp32 patch
    centres drawn on the host (`candidates`), given 0-d bool (cand[:M] are
    the caller's centres: no selection), inv_depths [M] fp32 inverse-depth
    draws, jitter [n] fp32 (the mask selection's random order, else None),
    depth [H, W] fp32 metric depth prior or None, mask [H, W] bool (True =
    static, usable) or None. Which of the last three are present is the
    frame's signature (`signature`)."""
    image: torch.Tensor
    intrinsics: torch.Tensor
    fac: torch.Tensor
    cand: torch.Tensor
    given: torch.Tensor
    inv_depths: torch.Tensor
    jitter: torch.Tensor | None = None
    depth: torch.Tensor | None = None
    mask: torch.Tensor | None = None


def signature(depth, mask):
    """(has depth, has mask): the frame's kind of input, which fixes the
    shapes of its FrameInputs (the JAX package jits one step per kind)."""
    return depth is not None, mask is not None


def candidates(cfg, has_mask):
    """(n, jitter): the host's centre draws per frame and whether the mask
    selection's jitter is drawn. Keypoints: M fallback centres; gradient
    bias: 3M (the mask then only scales the depth prior); a mask: 4M and
    their jitter; else M (the JAX package's `select_patches`)."""
    M = cfg.PATCHES_PER_FRAME
    if cfg.PATCH_SELECTOR == "keypoints":
        return M, False
    if cfg.GRADIENT_BIAS:
        return 3 * M, False
    if has_mask:
        return 4 * M, True
    return M, False


def _f32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def draw_inputs(cfg, state: SLAMState, ht, wd, coords=None, inv_depths=None,
                cand=None, jitter=None, has_mask=False):
    """The host draws of one frame from state.rng, as CPU tensors:
    (cand [n, 2], given, inv_depths [M], jitter [n] or None), n and the
    jitter as `candidates` says. The parity tests replace draws with the
    JAX run's: coords [M, 2] are the centres themselves (no selection);
    cand [n, 2] and jitter [n] the raw draws the selection runs on;
    inv_depths [M] the inverse depths."""
    M = cfg.PATCHES_PER_FRAME
    n, with_jitter = candidates(cfg, has_mask)
    given = coords is not None
    if given:
        c = torch.zeros(n, 2)
        c[:M] = _f32(coords)
    elif cand is not None:
        c = _f32(cand).reshape(n, 2)
    else:
        c = vonet.draw_centres(state.rng, n, ht // RES, wd // RES)
    j = None
    if with_jitter:
        j = _f32(jitter).reshape(n) if jitter is not None else \
            torch.rand(n, generator=state.rng)
    d = _f32(inv_depths) if inv_depths is not None else \
        torch.rand(M, generator=state.rng)
    return c, torch.tensor(given), d, j


# ---------------------------------------------------------------------------
# edge-prefix tiers
# ---------------------------------------------------------------------------

def edge_tiers(cfg, E, device):
    """The static prefix sizes the O(E) stages run over, ascending; the
    last is the whole table of E rows."""
    on_cpu = torch.device(device).type == "cpu"
    if (on_cpu and not TIER_ON_CPU) or E < TIER_MIN_EDGES or \
            cfg.EDGE_TIERS <= 1:
        return (E,)
    fracs = TIER_FRACS.get(cfg.EDGE_TIERS, (40, 100))
    cap = cfg.edge_capacity
    return tuple(sorted({E if f >= 100 else
                         min((cap * f // 100 + 1023) // 1024 * 1024, E)
                         for f in fracs}))


def choose_tier(tiers, n_edges):
    """The smallest tier holding n_edges rows (the JAX package's cond
    `n_edges <= t`)."""
    return next((t for t in tiers if n_edges <= t), tiers[-1])


def rows_for(cfg, state: SLAMState):
    """The tier of the state's current edge count, read on the host: for
    the eager callers (warm-up, bootstrap, `sync_mode`, tests)."""
    tiers = edge_tiers(cfg, state.ii.shape[0], state.ii.device)
    return choose_tier(tiers, int(state.n_edges))


def appended_rows(cfg):
    """Rows one `append_edges` adds: (r - 1) M forward + r M backward."""
    return (2 * cfg.PATCH_LIFETIME - 1) * cfg.PATCHES_PER_FRAME


# ---------------------------------------------------------------------------
# frame insertion
# ---------------------------------------------------------------------------

def select_centres(cfg, image, inputs: FrameInputs, h, w):
    """The frame's M patch centres on the 1/4 grid (h x w) from the host's
    draws: keypoints win over everything, then the gradient bias, then the
    mask (used for selection only without the gradient bias); the
    caller's centres (inputs.given) go in as they are."""
    M = cfg.PATCHES_PER_FRAME
    cand = inputs.cand
    if cfg.PATCH_SELECTOR == "keypoints":
        top = vonet.top_keypoints(vonet.keypoint_response_map(image), M, h,
                                  w, cand[:M])
    elif cfg.GRADIENT_BIAS:
        top = vonet.top_by_gradient(cand, M, vonet.image_gradient_map(image))
    elif inputs.mask is not None:
        top = vonet.top_by_mask(cand, inputs.jitter, M, inputs.mask)
    else:
        return cand
    return torch.where(inputs.given, cand[:M], top)


def depth_prior(cfg, state: SLAMState, patches, depth, mask, initialized):
    """Per-patch inverse depth from the metric depth map [H, W]: 1 / the
    median of its samples at the patch's 3x3 full-resolution pixels.
    Once initialized and with a mask, the map is first scaled to the
    current map scale (the median inverse depth of the last 3 frames'
    patches over the median depth of the masked-in pixels). An all-masked
    frame gives NaN, as in the JAX package."""
    M = cfg.PATCHES_PER_FRAME
    depth_f = depth.float()
    if initialized and mask is not None:
        rows = _relu(state.n_frames - 3) * M + \
            torch.arange(3 * M, device=depth_f.device)
        s = _median(state.patches[rows, 2])
        ref_med = torch.nanquantile(
            torch.where(mask, depth_f, float("nan")).reshape(-1), 0.5,
            interpolation="midpoint")
        depth_f = (1.0 / s.clamp(min=1e-6)) / ref_med.clamp(min=1e-6) * \
            depth_f
    H, W = depth_f.shape
    px = (patches[:, 0] * RES).long().clamp(0, W - 1)
    py = (patches[:, 1] * RES).long().clamp(0, H - 1)
    med = _median(depth_f[py, px].reshape(M, -1), dim=1)
    return 1.0 / med.clamp(min=1e-6)


def insert_frame(cfg, net, state: SLAMState, inputs: FrameInputs,
                 initialized=False):
    """Insert the frame at slot n = state.n_frames (not yet accepted)."""
    M = cfg.PATCHES_PER_FRAME
    n = state.n_frames
    dev = state.poses.device
    fd = feat_dtype(cfg)
    image = inputs.image

    feats = vonet.encode_frame(net, image, fd)
    coords = select_centres(cfg, image, inputs, feats.fmap.shape[0],
                            feats.fmap.shape[1])
    imap_p, gmap_p, clr, patches = vonet.gather_patches(feats, image, coords)

    # patch inverse-depth initialization: the frame's draws, or the median
    # of the last 3 frames' depths ("median"), or the depth prior; with a
    # prior the patches are also BA's depth anchors (patches_est)
    d0 = inputs.inv_depths
    if initialized and cfg.DEPTH_INIT == "median":
        rows = _relu(n - 3) * M + torch.arange(3 * M, device=dev)
        d0 = _median(state.patches[rows, 2]).expand(M)
    if inputs.depth is not None:
        d0 = depth_prior(cfg, state, patches, inputs.depth, inputs.mask,
                         initialized)
    patches[:, 2] = d0[:, None, None]

    # damped-linear motion extrapolation
    P1 = _row(state.poses, _relu(n - 1))
    P2 = _row(state.poses, _relu(n - 2))
    xi = cfg.MOTION_DAMPING * inputs.fac * lie.se3_log(
        lie.se3_mul(P1, lie.se3_inv(P2)))
    pred = lie.se3_mul(lie.se3_exp(xi), P1)
    new_pose = torch.where(n > 1, pred,
                           torch.where(n > 0, P1, _row(state.poses, n)))

    n1 = n.reshape(1)
    rows = n * M + torch.arange(M, device=dev)
    slot = n1 % cfg.pmem
    srows = slot * M + torch.arange(M, device=dev)
    state.poses.index_copy_(0, n1, new_pose[None])
    state.patches.index_copy_(0, rows, patches)
    if inputs.depth is not None:
        state.patches_est.index_copy_(0, rows, patches)
    else:
        state.patches_est.index_fill_(0, rows, 0.0)
    state.intrinsics.index_copy_(0, n1,
                                 (inputs.intrinsics.float() / RES)[None])
    state.colors.index_copy_(0, n1, clr.clamp(0, 255).to(torch.uint8)[None])
    state.imap.index_copy_(0, srows, imap_p.to(fd))
    state.gmap.index_copy_(0, srows, gmap_p.to(fd))
    state.fmap1.index_copy_(0, slot, feats.fmap.to(fd)[None])
    state.fmap2.index_copy_(0, slot, avg_pool2d(feats.fmap, 4).to(fd)[None])
    return state


# ---------------------------------------------------------------------------
# the update network over an edge list
# ---------------------------------------------------------------------------

def _run_update_net(cfg, net, state: SLAMState, net_e, ii, jj, kk, valid, n,
                    nbr=None, agg_order=None):
    """reproject -> correlate -> update operator; returns
    (net', delta, weight, coords). n: the frame count, a host integer or
    a device scalar."""
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

    # bounded segment ids of the SoftAgg groups, from the device frame
    # base fb
    FW = cfg.frame_window
    fb = _relu(n - (FW - 1))
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
    jj = torch.zeros(M, dtype=torch.long, device=dev) + n
    ii = _div(kk, M)
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
    c = n_frames - 1 at row n_edges: patches of frames [n-r, c) -> c, and
    patches of c -> frames [n-r, n). The caller makes sure the rows fit
    (`DPVO` checks before every append)."""
    M = cfg.PATCHES_PER_FRAME
    r = cfg.PATCH_LIFETIME
    n = state.n_frames
    c = n - 1
    dev = state.poses.device

    A_f = (r - 1) * M
    kk_f = M * c - A_f + torch.arange(A_f, device=dev)
    ii_f = _div(kk_f, M)
    jj_f = torch.zeros(A_f, dtype=torch.long, device=dev) + c
    ok_f = (kk_f >= M * _relu(n - r)) & (kk_f >= 0)

    tvals = n - r + torch.arange(r, device=dev)
    kk_b = (M * c + torch.arange(M, device=dev))[:, None].expand(M, r)
    kk_b = kk_b.reshape(-1)
    jj_b = tvals[None, :].expand(M, r).reshape(-1)
    ii_b = _div(kk_b, M)
    ok_b = jj_b >= 0

    A = A_f + M * r
    rows = state.n_edges + torch.arange(A, device=dev)
    state.ii.index_copy_(0, rows, torch.cat([ii_f, ii_b]).clamp(min=0))
    state.jj.index_copy_(0, rows, torch.cat([jj_f, jj_b]).clamp(min=0))
    state.kk.index_copy_(0, rows, torch.cat([kk_f, kk_b]).clamp(min=0))
    state.valid.index_copy_(0, rows, torch.cat([ok_f, ok_b]))
    state.net.index_fill_(0, rows, 0)
    state.target.index_fill_(0, rows, 0.0)
    state.weight.index_fill_(0, rows, 0.0)
    state.n_edges.add_(A)
    return state


def retire_and_compact(cfg, state: SLAMState, n_rows=None):
    """Drop edges whose source left the removal window, then stable-
    compact the first n_rows rows of the table (a tier holding every live
    edge; read from the edge count when not given)."""
    M = cfg.PATCHES_PER_FRAME
    n_rows = rows_for(cfg, state) if n_rows is None else n_rows
    sl = slice(0, n_rows)
    keep = state.valid[sl] & (_div(state.kk[sl], M)
                              >= state.n_frames - cfg.REMOVAL_WINDOW)
    perm, n_valid = compact_valid(keep)
    for name in ("ii", "jj", "kk", "net", "target", "weight"):
        a = getattr(state, name)
        a[sl] = a[sl][perm]
    state.valid[sl] = keep[perm]
    state.n_edges.copy_(n_valid)
    return state


# ---------------------------------------------------------------------------
# the optimization inner loop
# ---------------------------------------------------------------------------

def update_op(cfg, net, state: SLAMState, t0, lam=None, n_rows=None,
              device_gate=False):
    """One update: network + 2 Gauss-Newton iterations over the free
    poses [t0, n) and the first n_rows rows of the edge table (read from
    the edge count when not given). t0: host integer or device scalar;
    lam overrides the depth damping (default 1e-4).

    The run-sum SoftAgg (on the card) needs every live edge to be a member
    of the BA patch table (ROADMAP R5). The eager callers test that on the
    host and take the one-hot / scatter forms where it fails (the
    bootstrap, while it spans more frames than the patch window); with
    device_gate (the steady step, where it always holds after a
    retirement: the live patches are those of frames >= n - 1 -
    REMOVAL_WINDOW, all in the patch window) the run-sum is taken and a
    failure only counts into state.faults, which `DPVO` turns into an
    error."""
    M = cfg.PATCHES_PER_FRAME
    n = state.n_frames
    m_base = _relu(n - (cfg.patch_window_frames - 1)) * M
    ba_cfg = BAConfig(window=cfg.ba_window, patch_slots=cfg.patch_slots,
                      iterations=2, per_patch_cap=2 * cfg.PATCH_LIFETIME + 2,
                      depth_step_clamp=cfg.DEPTH_STEP_CLAMP or None)
    n_rows = rows_for(cfg, state) if n_rows is None else n_rows
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
    # is a table member: only then are a patch's live rows one run under it
    agg_order = None
    if n_rows % RUNSUM_ROWS == 0 and (kk.is_cuda or RUNSUM_ON_CPU):
        outside = (valid & ~okp).any()
        if device_gate:
            agg_order = order
            state.faults.add_(outside.long())
        elif not bool(outside):
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
    state.net[sl] = net2
    state.target[sl] = target
    state.weight[sl] = weight
    state.poses.copy_(poses)
    state.patches.copy_(patches)
    return state


def compute_points(cfg, state: SLAMState):
    """World points [N * M, 3] of every patch slot's centre pixel, computed
    on demand (`DPVO.points_and_colors`): the steady step keeps no point
    buffer."""
    M = cfg.PATCHES_PER_FRAME
    ix = torch.arange(state.patches.shape[0], device=state.patches.device)
    pts = pops.point_cloud(state.poses, state.patches, state.intrinsics,
                           _div(ix, M))
    pc = pts[:, P // 2, P // 2, :]
    w = pc[:, 3:]
    return pc[:, :3] / torch.where(w.abs() > 1e-8, w, 1.0)


def flow_metric(cfg, state: SLAMState, i, j, n_rows=None):
    """Bidirectional mean flow magnitude between frames i and j over the
    live edges connecting them (beta = 0.5), reprojected on a compacted
    buffer of at most 4M edges. Returns a 0-d tensor."""
    M = cfg.PATCHES_PER_FRAME
    B = 4 * M
    n_rows = rows_for(cfg, state) if n_rows is None else n_rows
    dev = state.ii.device
    sl = slice(0, n_rows)
    ii, jj, valid = state.ii[sl], state.jj[sl], state.valid[sl]
    m_fwd = (ii == i) & (jj == j) & valid
    m_rev = (ii == j) & (jj == i) & valid
    m = m_fwd | m_rev
    r = torch.cumsum(m.long(), 0) - 1
    pos = torch.where(m & (r < B), r, B)
    buf = torch.full((B + 1,), n_rows, dtype=torch.long, device=dev)
    buf[pos] = torch.arange(n_rows, device=dev)
    buf = buf[:B]
    ok = buf < n_rows
    bc = buf.clamp(0, n_rows - 1)
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

def keyframe_shift(cfg, state: SLAMState, remove=None, n_rows=None):
    """Evict keyframe k = n - KEYFRAME_INDEX: drop its edges, renumber the
    newer ones, shift the KEYFRAME_INDEX - 1 newest frames one slot down.
    Returns (state, dP) with dP = pose_k * pose_{k-1}^-1.

    remove: a 0-d device bool that predicates every write (the on-device
    keyframe decision: both outcomes run the same fixed sequence of
    copies, a kept frame's copies writing each slab onto itself), or None
    to evict. The edge edits cover the first n_rows rows (read from the
    edge count when not given)."""
    M = cfg.PATCHES_PER_FRAME
    pmem = cfg.pmem
    KI = cfg.KEYFRAME_INDEX
    n = state.n_frames
    k = n - KI
    dev = state.poses.device
    n_rows = rows_for(cfg, state) if n_rows is None else n_rows
    rem = torch.ones((), dtype=torch.bool, device=dev) if remove is None \
        else remove

    dP = lie.se3_mul(_row(state.poses, k),
                     lie.se3_inv(_row(state.poses, k - 1)))

    sl = slice(0, n_rows)
    ii, jj = state.ii[sl], state.jj[sl]
    newer = (ii > k) & rem
    state.valid[sl] &= ~(((ii == k) | (jj == k)) & rem)
    state.kk[sl] = torch.where(newer, state.kk[sl] - M, state.kk[sl])
    state.jj[sl] = torch.where((jj > k) & rem, jj - 1, jj)
    state.ii[sl] = torch.where(newer, ii - 1, ii)

    def move(a, src, dst):
        # a[dst] = a[src] when removing, else a[src] = a[src]; the gather
        # materializes before the (possibly overlapping) write
        a.index_copy_(0, torch.where(rem, dst, src), a[src])

    def shift_rows(a, pf):
        span = torch.arange((KI - 1) * pf, device=dev)
        move(a, (k + 1) * pf + span, k * pf + span)

    def shift_ring(a, ps):
        span = torch.arange(ps, device=dev)
        for i in range(KI - 1):
            move(a, ((k + i + 1) % pmem) * ps + span,
                 ((k + i) % pmem) * ps + span)

    shift_rows(state.poses, 1)
    shift_rows(state.patches, M)
    shift_rows(state.patches_est, M)
    shift_rows(state.intrinsics, 1)
    shift_rows(state.colors, 1)
    shift_ring(state.imap, M)
    shift_ring(state.gmap, M)
    shift_ring(state.fmap1, 1)
    shift_ring(state.fmap2, 1)
    state.n_frames.sub_(rem.long())
    return state, dP


def keyframe_and_log(cfg, state: SLAMState, n_rows=None):
    """Flow metric -> on-device keyframe decision -> event-log row at
    log_idx (removed flag, dP [7], flow metric, NaN flag) -> retirement,
    all over the first n_rows rows of the edge table."""
    KI = cfg.KEYFRAME_INDEX
    n_rows = rows_for(cfg, state) if n_rows is None else n_rows
    n = state.n_frames
    mm = flow_metric(cfg, state, n - KI - 1, n - KI + 1, n_rows)
    remove = (mm / 2.0) < cfg.KEYFRAME_THRESH
    state, dP = keyframe_shift(cfg, state, remove=remove, n_rows=n_rows)
    dP = torch.where(remove, dP, lie.se3_identity((), device=dP.device))
    nan_flag = torch.isnan(_row(state.poses, _relu(state.n_frames - KI))).any()
    entry = torch.cat([remove.float()[None], dP, mm.float()[None],
                       nan_flag.float()[None]])
    state.log.index_copy_(0, state.log_idx.reshape(1), entry[None])
    state.log_idx.add_(1)
    return retire_and_compact(cfg, state, n_rows)


def track_and_keyframe(cfg, net, state: SLAMState, n_rows):
    state = append_edges(cfg, state)
    t0 = (state.n_frames - cfg.OPTIMIZATION_WINDOW).clamp(min=1)
    state = update_op(cfg, net, state, t0, n_rows=n_rows, device_gate=True)
    return keyframe_and_log(cfg, state, n_rows)


def frame_step(cfg, net, state: SLAMState, inputs: FrameInputs, n_rows):
    """insert + track + keyframe for one steady-state frame, with no host
    read: n_rows is the tier holding the edge count after this frame's
    append."""
    state = insert_frame(cfg, net, state, inputs, initialized=True)
    state.n_frames.add_(1)
    return track_and_keyframe(cfg, net, state, n_rows)


def chunk_step(cfg, net, state: SLAMState, chunk, tier_of):
    """`frame_step` over the frames of `chunk` (FrameInputs with a leading
    K axis; None where the signature has no such input) in order;
    tier_of(state) gives each frame's tier."""
    for i in range(chunk.image.shape[0]):
        inputs = FrameInputs(*(None if f is None else f[i] for f in chunk))
        state = frame_step(cfg, net, state, inputs, tier_of(state))
    return state


def track_step(cfg, net, state: SLAMState):
    """append factors -> update -> keyframe flow metric, eagerly; returns
    (state, flow metric). The host compares the metric with
    KEYFRAME_THRESH, calls `keyframe_shift` on a drop, then
    `retire_and_compact` (`DPVO(sync_mode=True)`). The JAX package's
    track_step retires before the decision and its keyframe_shift again
    after it; retiring once, after the decision, as `keyframe_and_log`
    does, keeps the steady step's edges (the JAX order retires the edges
    of frame n - 1 - REMOVAL_WINDOW one frame earlier on a drop)."""
    state = append_edges(cfg, state)
    n_rows = rows_for(cfg, state)
    n = state.n_frames
    t0 = max(int(n) - cfg.OPTIMIZATION_WINDOW, 1)
    state = update_op(cfg, net, state, t0, n_rows=n_rows)
    mm = flow_metric(cfg, state, n - cfg.KEYFRAME_INDEX - 1,
                     n - cfg.KEYFRAME_INDEX + 1, n_rows)
    return state, mm
