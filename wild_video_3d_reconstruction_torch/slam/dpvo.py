"""DPVO: the host-side SLAM loop around the per-frame steps.

Counterpart of the JAX package's `slam/dpvo.py`:

  warm-up     frames are inserted; from the second one on, a motion probe
              may park a frame whose probed flow is below
              MOTION_PROBE_THRESH; each accepted warm-up frame appends its
              factors
  bootstrap   at the WARMUP-th accepted frame: 12 updates over the free
              poses [1, n), then edge retirement
  steady      one `steps.frame_step` per frame; the host keeps the
              keyframe bookkeeping (timestamps, the dropped-frame delta
              chain) as each frame's event comes back
  terminate   the full trajectory through the delta chain, camera-to-world

The warm-up appends factors twice for every accepted frame before the
WARMUP-th: once for the accepted frame and once more on the pre-
initialization branch, exactly as the JAX package does (its
`slam/dpvo.py:294` and `:329-331`). The duplicated (kk, jj) pairs are a
known fault of the reference; the port keeps them so that the bootstrap
matches it, and its tests assert that they are there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.convert import jax_params_to_torch, load_reference_checkpoint
from ..models.vonet import VONet, init_vonet
from ..ops import lie
from ..utils.config import DPVOConfig
from . import steps
from .state import WARMUP, SLAMState, init_state


# Config values whose behaviour the JAX package has and the port does not
# yet: (key, its default, the ROADMAP Queue 1 item that ports it).
# USE_DISTANCE_EDGES is read only by global BA (JAX `slam/global_ba.py:70`),
# so ENABLE_GLOBAL_BA's check covers it. Keys that change no result
# (PIPELINE_CHUNK, EDGE_TIERS, PALLAS_CORR, PALLAS_HYBRID_BUDGET) stay
# accepted.
NOT_PORTED = (("PATCH_SELECTOR", "random", 20),
              ("ENABLE_GLOBAL_BA", False, 11),
              ("loop_enabled", False, 12))


def _check_ported(cfg):
    for key, default, item in NOT_PORTED:
        value = getattr(cfg, key)
        if value != default:
            raise NotImplementedError(
                f"{key}: {value!r} is not ported yet (ROADMAP Queue 1 item "
                f"{item}); the port runs only {key}: {default!r}")


class DPVO:
    WARMUP = WARMUP

    def __init__(self, cfg: DPVOConfig, network=None, ht=480, wd=640,
                 seed=0, device="cuda"):
        """network: a `VONet`, a path to a DPVO `.pth` checkpoint, the JAX
        package's parameter tree (nested dicts of numpy arrays), or None
        for weights drawn from `seed`. device: "cuda" unless the caller
        asks for the CPU."""
        _check_ported(cfg)
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.M = cfg.PATCHES_PER_FRAME
        self.device = torch.device(device)
        if isinstance(network, VONet):
            net = network
        elif isinstance(network, str):
            net = load_reference_checkpoint(network)
        elif network is None:
            net = init_vonet(seed)
        else:
            net = jax_params_to_torch(network)
        self.net = net.to(self.device).eval()
        self.state: SLAMState = init_state(
            cfg, ht, wd, feat_dtype=steps.feat_dtype(cfg), seed=seed,
            device=self.device)

        self.is_initialized = False
        self.counter = 0          # input frames seen
        self.tlist = []           # input timestamps
        self.n_host = 0           # accepted keyframes
        self.parked = []          # input frames parked by the motion probe
        self.tstamps = np.zeros(cfg.BUFFER_SIZE, dtype=np.int64)
        self.delta = {}           # dropped frame -> (anchor frame, dP)

    @property
    def n(self):
        return self.state.n_frames

    def __call__(self, tstamp, image, intrinsics, coords=None, depths=None):
        """Track one frame. image [H, W, 3] uint8 (BGR), intrinsics [4]
        (fx, fy, cx, cy) at full resolution. coords [M, 2] and depths [M]
        replace the random patch centres and inverse depths of this frame
        (the parity tests feed the JAX run's draws)."""
        cfg = self.cfg
        if self.n + 1 >= cfg.BUFFER_SIZE:
            raise RuntimeError("buffer full: increase cfg.BUFFER_SIZE "
                               "(--buffer)")
        self.tlist.append(tstamp)
        # damped-linear timestamp ratio
        *_, a, b, c = [1] * 3 + self.tlist
        fac = float(c - b) / max(float(b - a), 1e-6)
        img = torch.as_tensor(np.asarray(image)).to(self.device)
        intr = torch.as_tensor(np.asarray(intrinsics, dtype=np.float32)) \
            .to(self.device)

        if self.is_initialized:
            self.state, event = steps.frame_step(
                cfg, self.net, self.state, img, intr, fac, coords=coords,
                depths=depths)
            self.counter += 1
            self._record(event)
            return

        self.state = steps.insert_frame(cfg, self.net, self.state, img, intr,
                                        fac, coords=coords, depths=depths)
        self.tstamps[self.n_host] = self.counter
        self.counter += 1

        thresh = cfg.MOTION_PROBE_THRESH
        if self.n_host > 0 and thresh >= 0:
            if float(steps.motion_probe(cfg, self.net, self.state)) < thresh:
                self.parked.append(self.counter - 1)
                self.delta[self.counter - 1] = (
                    self.counter - 2, lie.se3_identity(()))
                return

        # accept the frame and append its factors
        self.state.n_frames += 1
        self.n_host += 1
        self.state = steps.append_edges(cfg, self.state)

        if self.n_host == self.WARMUP:
            self.is_initialized = True
            lam0 = float(cfg.BOOT_LAM0)
            for it in range(12):
                lam = max(lam0 * (0.35 ** it), 1e-4)
                self.state = steps.update_op(cfg, self.net, self.state, 1,
                                             lam=lam)
            self.state = steps.retire_and_compact(cfg, self.state)
        else:
            # pre-initialization: the second append of the same factors
            self.state = steps.append_edges(cfg, self.state)

    def _record(self, event):
        """Host bookkeeping of one tracked frame: its timestamp and, on a
        keyframe eviction, the relative pose of the dropped frame."""
        removed, dP, _, nan_flag = event
        n = self.n_host
        self.tstamps[n] = self.counter - 1
        n += 1
        if removed:
            k = n - self.cfg.KEYFRAME_INDEX
            t0, t1 = int(self.tstamps[k - 1]), int(self.tstamps[k])
            self.delta[t1] = (t0, dP.float())
            self.tstamps[k:n - 1] = self.tstamps[k + 1:n].copy()
            n -= 1
        if nan_flag:
            print(f"WARNING: NaN pose detected near input frame "
                  f"{self.counter - 1}")
        self.n_host = n

    def refine(self, iterations=12):
        """Final refinement updates over the optimization window."""
        for _ in range(iterations):
            t0 = max(self.n - self.cfg.OPTIMIZATION_WINDOW, 1)
            self.state = steps.update_op(self.cfg, self.net, self.state, t0)

    def get_pose(self, traj, t):
        if t in traj:
            return traj[t]
        t0, dP = self.delta[t]
        return lie.se3_mul(dP, self.get_pose(traj, t0))

    def terminate(self):
        """Camera-to-world poses [T, 7] of every input frame (numpy) and
        their timestamps."""
        poses = self.state.poses[:self.n_host].float().cpu()
        traj = {int(self.tstamps[i]): poses[i] for i in range(self.n_host)}
        out = torch.stack([self.get_pose(traj, t)
                           for t in range(self.counter)])
        out = lie.se3_inv(out)
        return out.numpy(), np.array(self.tlist, dtype=np.float64)
