"""SLAM state (the patch graph) as tensors of fixed capacity.

Counterpart of the JAX package's `slam/state.py`: the same buffers, shapes
and layouts (channel-last feature maps; imap / gmap flattened over
(ring slot, patch) so an edge's row is kk % (M * pmem); patch and pose
buffers indexed by absolute frame id).

The counters live on the state's device, as the JAX package's traced
scalars do: `counts` [4] int64 holds n_frames, n_edges, log_idx and the
steady step's fault count, and `n_frames`, `n_edges`, `log_idx`, `faults`
are 0-d views of it. The steady frame step reads and writes them there,
so it runs with no host read and replays as a CUDA graph; a caller that
needs a count on the host reads it explicitly (`int(state.n_edges)`), and
`DPVO`'s runner copies all four back in one transfer between frames.

`log` [LOG_CAP, 10] fp32 is the JAX package's device event log, one row
per steady frame: (removed flag, dP [7], flow metric, NaN flag);
`DPVO._replay_log` turns it into the host bookkeeping at terminate.
`desc_log` [LOG_CAP, DESC_DIM] bf16 (when `loop_enabled`, else [1, 1]) is
indexed like `log`: the steady step writes each frame's VLAD descriptor
there for the loop closure, which `DPVO._lc_sync` drains every
LC_INTERVAL frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.vonet import DIM, FDIM, P, RES

WARMUP = 10  # accepted frames before initialization
LOG_COLS = 10
N_FRAMES, N_EDGES, LOG_IDX, FAULTS = range(4)


def edge_rows(cfg):
    """Rows of the edge table: the config's `edge_capacity`, raised where
    the warm-up needs more. Every accepted warm-up frame but the last
    appends its (2r-1)M factors twice (see `slam.dpvo`), 2 * WARMUP - 1
    appends before the first retirement; at configs/fast.yaml that is
    19152 rows against a capacity of 17408. (The JAX package's fixed table
    clamps those writes onto its last rows.)"""
    per_append = (2 * cfg.PATCH_LIFETIME - 1) * cfg.PATCHES_PER_FRAME
    warm = (2 * WARMUP - 1) * per_append
    return max(cfg.edge_capacity, -(-warm // 1024) * 1024)


def _count(i):
    def get(self):
        return self.counts[i]

    def set_(self, value):
        self.counts[i] = value

    return property(get, set_)


@dataclass
class SLAMState:
    poses: torch.Tensor          # [N, 7] w2c SE3, fp32
    patches: torch.Tensor        # [N*M, 3, P, P] (x, y, inverse depth)
    patches_est: torch.Tensor    # [N*M, 3, P, P] depth-prior anchors
    intrinsics: torch.Tensor     # [N, 4] fx fy cx cy at 1/RES scale
    colors: torch.Tensor         # [N, M, 3] uint8 RGB
    imap: torch.Tensor           # [pmem*M, DIM]
    gmap: torch.Tensor           # [pmem*M, FDIM, P, P]
    fmap1: torch.Tensor          # [pmem, H/4, W/4, FDIM]
    fmap2: torch.Tensor          # [pmem, H/16, W/16, FDIM]
    ii: torch.Tensor             # [E] source frame
    jj: torch.Tensor             # [E] target frame
    kk: torch.Tensor             # [E] global patch id
    valid: torch.Tensor          # [E] bool
    net: torch.Tensor            # [E, DIM] hidden state
    target: torch.Tensor         # [E, 2] flow targets
    weight: torch.Tensor         # [E, 2] confidences
    counts: torch.Tensor         # [4] int64 n_frames, n_edges, log_idx, faults
    log: torch.Tensor            # [LOG_CAP, 10] fp32 event log
    desc_log: torch.Tensor       # [LOG_CAP, DESC_DIM] bf16 descriptors
    rng: torch.Generator | None = None   # host draws: patches, depths

    # accepted keyframes / used rows of the edge table / next log row /
    # steady frames whose update broke the run-sum's segment rule
    n_frames = _count(N_FRAMES)
    n_edges = _count(N_EDGES)
    log_idx = _count(LOG_IDX)
    faults = _count(FAULTS)


def init_state(cfg, ht, wd, feat_dtype=torch.bfloat16, seed=0,
               device="cpu"):
    """Allocate the full state for images of size (ht, wd)."""
    N = cfg.BUFFER_SIZE
    M = cfg.PATCHES_PER_FRAME
    E = edge_rows(cfg)
    pmem = cfg.pmem
    h4, w4 = ht // RES, wd // RES
    h16, w16 = h4 // 4, w4 // 4

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    poses = z(N, 7)
    poses[:, 6] = 1.0
    return SLAMState(
        poses=poses,
        patches=torch.ones((N * M, 3, P, P), device=device),
        patches_est=z(N * M, 3, P, P),
        intrinsics=z(N, 4),
        colors=z(N, M, 3, dtype=torch.uint8),
        imap=z(pmem * M, DIM, dtype=feat_dtype),
        gmap=z(pmem * M, FDIM, P, P, dtype=feat_dtype),
        fmap1=z(pmem, h4, w4, FDIM, dtype=feat_dtype),
        fmap2=z(pmem, h16, w16, FDIM, dtype=feat_dtype),
        ii=z(E, dtype=torch.long),
        jj=z(E, dtype=torch.long),
        kk=z(E, dtype=torch.long),
        valid=z(E, dtype=torch.bool),
        net=z(E, DIM, dtype=feat_dtype),
        target=z(E, 2),
        weight=z(E, 2),
        counts=z(4, dtype=torch.long),
        log=z(cfg.LOG_CAP, LOG_COLS),
        desc_log=z(*((cfg.LOG_CAP, cfg.DESC_DIM) if cfg.loop_enabled
                     else (1, 1)), dtype=torch.bfloat16),
        rng=torch.Generator().manual_seed(seed),
    )
