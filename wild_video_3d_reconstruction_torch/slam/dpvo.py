"""DPVO: the host-side SLAM loop around the per-frame steps.

Counterpart of the JAX package's `slam/dpvo.py`:

  warm-up     frames are inserted; from the second one on, a motion probe
              may park a frame whose probed flow is below
              MOTION_PROBE_THRESH; each accepted warm-up frame appends its
              factors
  bootstrap   at the WARMUP-th accepted frame: 12 updates over the free
              poses [1, n), then edge retirement
  steady      one `steps.frame_step` per frame through `graphs.StepRunner`
              (CUDA graph replays on the card, the same step eagerly on
              the CPU): the keyframe decision is taken on the device and
              logged in `state.log`; with PIPELINE_CHUNK = K the frames go
              K at a time, a change of input signature (depth prior,
              mask) flushing the frames before it
  terminate   `_replay_log` turns the event log into the host bookkeeping
              (timestamps, the dropped-frame delta chain); global BA over
              every keyframe when ENABLE_GLOBAL_BA is set
              (`slam/global_ba.py`); then the full trajectory through the
              delta chain, camera-to-world (`trajectory`)

After a run (or between frames) the map and its diagnostics come from the
current state: `points_and_colors`, `normalize`, `geo_consistency_check`,
`save_inlier_ratio_record`, `terminate_keyframe`, `debug_match_figure`.
A run is saved and resumed between frames by `slam/checkpoint.py`.

`sync_mode=True` is the JAX package's synchronous path instead of the
steady one: `steps.track_step` eagerly, then the keyframe decision on the
host, which reads the flow metric back every frame, then the retirement
(after the decision, as in the steady step: see `steps.track_step`).
Warm-up, the motion probe, the bootstrap, `refine` and `terminate` run
eagerly in both modes.

The warm-up appends factors twice for every accepted frame before the
WARMUP-th: once for the accepted frame and once more on the pre-
initialization branch, exactly as the JAX package does (its
`slam/dpvo.py:294` and `:329-331`). The duplicated (kk, jj) pairs are a
known fault of the reference; the port keeps them so that the bootstrap
matches it, and its tests assert that they are there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.convert import jax_params_to_torch, load_reference_checkpoint
from ..models.vonet import VONet, init_vonet
from ..ops import lie
from ..ops import projective as pops
from ..utils.config import DPVOConfig
from . import steps
from .global_ba import run_global_ba
from .graphs import StepRunner, check_faults
from .state import WARMUP, SLAMState, init_state


# Config values whose behaviour the JAX package has and the port does not
# yet: (key, its default, the ROADMAP Queue 1 item that ports it). Keys
# that change no result stay accepted: PIPELINE_CHUNK and EDGE_TIERS
# change how the steady frames are dispatched, PALLAS_CORR and
# PALLAS_HYBRID_BUDGET nothing.
NOT_PORTED = (("loop_enabled", False, 12),)


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
                 seed=0, device="cuda", sync_mode=False):
        """network: a `VONet`, a path to a DPVO `.pth` checkpoint, the JAX
        package's parameter tree (nested dicts of numpy arrays), or None
        for weights drawn from `seed`. device: "cuda" unless the caller
        asks for the CPU. sync_mode: the synchronous steady path (see the
        module)."""
        _check_ported(cfg)
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.M = cfg.PATCHES_PER_FRAME
        self.device = torch.device(device)
        self.sync_mode = bool(sync_mode)
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
        self.runner = StepRunner(cfg, self.net, self.state, ht, wd)

        self.is_initialized = False
        self.counter = 0          # input frames seen
        self.tlist = []           # input timestamps
        self.n_host = 0           # accepted keyframes (replayed)
        self.parked = []          # input frames parked by the motion probe
        self.tstamps = np.zeros(cfg.BUFFER_SIZE, dtype=np.int64)
        self.delta = {}           # dropped frame -> (anchor frame, dP)
        self._init_counter = None     # input frames seen at initialization
        self._events_dispatched = 0   # steady frames handed to the runner
        self._events_consumed = 0     # event-log rows replayed
        self._pending = []            # steady rows awaiting a chunk
        self._pending_sig = None      # their signature (depth, mask)

    @property
    def n(self):
        """Accepted keyframes on the device (a host read)."""
        return int(self.state.n_frames)

    def __call__(self, tstamp, image, intrinsics, depth=None, mask=None,
                 coords=None, inv_depths=None, cand=None, jitter=None):
        """Track one frame. image [H, W, 3] uint8 (BGR), intrinsics [4]
        (fx, fy, cx, cy) at full resolution; depth [H, W] an optional
        metric depth prior, mask [H, W] an optional bool mask (True =
        static, usable), as the JAX package's DPVO takes them.

        Test hooks (the parity tests feed the JAX run's draws, since
        jax.random cannot be reproduced here): coords [M, 2] replace the
        frame's patch centres (no selection), cand [n, 2] and jitter [n]
        the raw centre draws the selection runs on, inv_depths [M] the
        patches' random inverse depths (`steps.draw_inputs`)."""
        cfg = self.cfg
        self.tlist.append(tstamp)
        # damped-linear timestamp ratio
        *_, a, b, c = [1] * 3 + self.tlist
        fac = float(c - b) / max(float(b - a), 1e-6)
        intr_np = np.asarray(intrinsics, dtype=np.float32)
        sig = steps.signature(depth, mask)
        draws = steps.draw_inputs(cfg, self.state, self.ht, self.wd,
                                  coords=coords, inv_depths=inv_depths,
                                  cand=cand, jitter=jitter, has_mask=sig[1])
        depth = None if depth is None else np.asarray(depth, np.float32)
        mask = None if mask is None else np.asarray(mask, bool)

        if self.is_initialized and not self.sync_mode:
            # steady state: the runner checks the buffer, edge table and
            # event log against the counters it reads between frames
            if self._pending and self._pending_sig != sig:
                self._flush_pending()
            self._pending_sig = sig
            self._pending.append(steps.FrameInputs(
                np.asarray(image), intr_np, fac, *draws, depth, mask))
            self.counter += 1
            if len(self._pending) >= self.runner.chunk:
                self._flush_pending()
            return

        if self.n + 1 >= cfg.BUFFER_SIZE:
            raise RuntimeError("buffer full: increase cfg.BUFFER_SIZE "
                               "(--buffer)")
        dev = self.device

        def up(v):
            return None if v is None else torch.as_tensor(v).to(dev)

        inputs = steps.FrameInputs(
            up(np.asarray(image)), up(intr_np),
            torch.tensor(fac, dtype=torch.float32, device=dev),
            *(up(d) for d in draws), up(depth), up(mask))
        self.runner.invalidate()
        self.state = steps.insert_frame(cfg, self.net, self.state, inputs,
                                        initialized=self.is_initialized)
        self.tstamps[self.n_host] = self.counter
        self.counter += 1

        thresh = cfg.MOTION_PROBE_THRESH
        if self.n_host > 0 and not self.is_initialized and thresh >= 0:
            if float(steps.motion_probe(cfg, self.net, self.state)) < thresh:
                self.parked.append(self.counter - 1)
                self.delta[self.counter - 1] = (
                    self.counter - 2, lie.se3_identity(()))
                return

        # accept the frame
        self.state.n_frames.add_(1)
        self.n_host += 1
        if not self.is_initialized:
            self._check_room()
            self.state = steps.append_edges(cfg, self.state)

        if self.n_host == self.WARMUP and not self.is_initialized:
            self.is_initialized = True
            self._init_counter = self.counter
            lam0 = float(cfg.BOOT_LAM0)
            for it in range(12):
                lam = max(lam0 * (0.35 ** it), 1e-4)
                self.state = steps.update_op(cfg, self.net, self.state, 1,
                                             lam=lam)
            self.state = steps.retire_and_compact(cfg, self.state)
        elif self.is_initialized:
            self._track_sync()
        else:
            # pre-initialization: the second append of the same factors
            self._check_room()
            self.state = steps.append_edges(cfg, self.state)

    def _check_room(self):
        """Raise unless one more append_edges fits the edge table (a host
        read: the eager paths only)."""
        E = self.state.ii.shape[0]
        A = steps.appended_rows(self.cfg)
        cur = int(self.state.n_edges)
        if cur + A > E:
            raise RuntimeError(f"edge table full ({cur} + {A} rows > {E})")

    def _track_sync(self):
        """One synchronous tracked frame (the JAX package's `sync_mode`):
        track_step, then the keyframe decision on the host."""
        cfg = self.cfg
        self._check_room()
        self.state, mm = steps.track_step(cfg, self.net, self.state)
        if float(mm) / 2.0 < cfg.KEYFRAME_THRESH:
            k = self.n_host - cfg.KEYFRAME_INDEX
            t0, t1 = int(self.tstamps[k - 1]), int(self.tstamps[k])
            self.state, dP = steps.keyframe_shift(cfg, self.state)
            self.delta[t1] = (t0, dP.float().cpu())
            self.tstamps[k:self.n_host] = \
                self.tstamps[k + 1:self.n_host + 1].copy()
            self.n_host -= 1
        else:
            pose_k = self.state.poses[self.n_host - cfg.KEYFRAME_INDEX]
            if bool(torch.isnan(pose_k).any()):
                raise FloatingPointError("estimated pose is NaN")
        self.state = steps.retire_and_compact(cfg, self.state)

    def _flush_pending(self):
        """Dispatch the staged chunk: K frames in one upload when full, a
        partial tail frame by frame."""
        rows, self._pending = self._pending, []
        if rows:
            self.runner.run(rows)
            self._events_dispatched += len(rows)

    def _replay_events(self, rows, first_event):
        """Replay event-log rows [first_event, first_event + len) into the
        host bookkeeping: timestamps, the eviction delta chain, NaN
        warnings."""
        n = self.n_host
        for e in range(rows.shape[0]):
            c = self._init_counter + first_event + e
            self.tstamps[n] = c
            n += 1
            removed, dP, nan_flag = rows[e, 0], rows[e, 1:8], rows[e, 9]
            if removed > 0.5:
                k = n - self.cfg.KEYFRAME_INDEX
                t0, t1 = int(self.tstamps[k - 1]), int(self.tstamps[k])
                self.delta[t1] = (t0, torch.from_numpy(
                    dP.astype(np.float32)))
                self.tstamps[k:n - 1] = self.tstamps[k + 1:n].copy()
                n -= 1
            if nan_flag > 0.5:
                print(f"WARNING: NaN pose detected near input frame {c}")
        self.n_host = n
        self._events_consumed = first_event + rows.shape[0]

    def _replay_log(self):
        """Bring the host bookkeeping up to the device event log: flush a
        pending chunk, fetch the rows not replayed yet, replay them. Raises
        if a steady frame broke the run-sum SoftAgg's segment rule."""
        if self.sync_mode or self._init_counter is None:
            return
        self._flush_pending()
        self.runner.invalidate()
        _, _, total, faults = self.runner.counts()
        check_faults(faults)
        lo = self._events_consumed
        if total > lo:
            self._replay_events(self.state.log[lo:total].cpu().numpy(), lo)

    def refine(self, iterations=12):
        """Final refinement updates over the optimization window."""
        self._flush_pending()
        self.runner.invalidate()
        for _ in range(iterations):
            t0 = max(self.n - self.cfg.OPTIMIZATION_WINDOW, 1)
            self.state = steps.update_op(self.cfg, self.net, self.state, t0)

    def get_pose(self, traj, t):
        if t in traj:
            return traj[t]
        t0, dP = self.delta[t]
        return lie.se3_mul(dP, self.get_pose(traj, t0))

    def trajectory(self):
        """Camera-to-world poses [T, 7] of every input frame (numpy), the
        dropped frames through the delta chain, and their timestamps."""
        self._replay_log()
        poses = self.state.poses[:self.n_host].float().cpu()
        traj = {int(self.tstamps[i]): poses[i] for i in range(self.n_host)}
        out = torch.stack([self.get_pose(traj, t)
                           for t in range(self.counter)])
        out = lie.se3_inv(out)
        return out.numpy(), np.array(self.tlist, dtype=np.float64)

    def terminate(self):
        """Global BA over every keyframe when ENABLE_GLOBAL_BA is set,
        then `trajectory()`."""
        self._replay_log()
        if self.cfg.ENABLE_GLOBAL_BA:
            run_global_ba(self.cfg, self)
        return self.trajectory()

    # ------------------------------------------------------------ the map
    def points_and_colors(self):
        """The live map: world points [K, 3] and their RGB colours [K, 3]
        uint8 (numpy), recomputed from the current poses and depths; per
        frame only the patches whose inverse depth lies within (1, 4)
        times the frame's median."""
        self._replay_log()
        n, M = self.n, self.M
        m = n * M
        pts = steps.compute_points(self.cfg, self.state)[:m]
        clr = self.state.colors.reshape(-1, 3)[:m]
        d = self.state.patches[:m, 2, 1, 1].reshape(n, M)
        med = steps._median(d, dim=1)[:, None]
        sel = ((d > 1.0 * med) & (d < 4.0 * med)).reshape(-1)
        return pts[sel].cpu().numpy(), clr[sel].cpu().numpy()

    def normalize(self):
        """Scale the map so that its mean inverse depth is 1 and rebase the
        trajectory on the first keyframe; the delta chain of the dropped
        frames is scaled with it."""
        self._replay_log()
        st, n, M = self.state, self.n, self.M
        s = float(st.patches[:n * M, 2].mean())
        st.patches[:n * M, 2] /= s
        st.poses[:n, :3] *= s
        st.poses[:n] = lie.se3_mul(st.poses[:n],
                                   lie.se3_inv(st.poses[0]).expand(n, 7))
        for t, (t0, dP) in list(self.delta.items()):
            dP = dP.clone()
            dP[:3] *= s
            self.delta[t] = (t0, dP)

    def geo_consistency_check(self, query_frame, fixed_frame, thresh=4.0):
        """(query_frame, inlier ratio) of the live edges from query_frame
        into frames <= fixed_frame: the share whose reprojection lies
        within thresh pixels of the network's target and inside the image
        (a margin of one image around it)."""
        self._replay_log()
        st = self.state
        reproj = pops.transform(st.poses, st.patches, st.intrinsics, st.ii,
                                st.jj, st.kk)[:, 1, 1, :]
        m = st.valid & (st.ii == query_frame) & (st.jj <= fixed_frame)
        if not bool(m.any()):
            return query_frame, 0.0
        r = torch.linalg.norm(reproj[m] - st.target[m], dim=-1)
        cx, cy = st.intrinsics[0, 2], st.intrinsics[0, 3]
        xb = (reproj[m, 0] > -cx) & (reproj[m, 0] < 3 * cx)
        yb = (reproj[m, 1] > -cy) & (reproj[m, 1] < 3 * cy)
        return query_frame, float(((r < thresh) & xb & yb).float().mean())

    def save_inlier_ratio_record(self, path):
        """Write the inlier ratios of the newest keyframes
        (`inlier_ratio_record.txt`), the keyframes' timestamps
        (`time_stamp.txt`) and, where matplotlib is installed, a plot of
        the ratios; returns {timestamp: ratio}."""
        self._replay_log()
        os.makedirs(path, exist_ok=True)
        n = self.n_host
        record = {}
        for i in range(max(n - self.cfg.OPTIMIZATION_WINDOW + 2, 1), n + 1):
            _, ratio = self.geo_consistency_check(i, i - 1)
            record[int(self.tstamps[min(i, n - 1)])] = ratio
        with open(f"{path}/inlier_ratio_record.txt", "w") as f:
            for k, v in record.items():
                f.write(f"{k} {v}\n")
        with open(f"{path}/time_stamp.txt", "w") as f:
            for i in range(n):
                f.write(f"{int(self.tstamps[i])}\n")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.plot(list(record), list(record.values()),
                     label="inlier ratio")
            plt.xlabel("frame timestamp")
            plt.ylabel("inlier ratio")
            plt.savefig(f"{path}/inlier_ratio_record.png")
            plt.close()
        except ImportError:
            pass
        return record

    def terminate_keyframe(self):
        """Camera-to-world poses [n, 7] of the keyframes (numpy) and their
        input timestamps."""
        self._replay_log()
        n = self.n_host
        poses = lie.se3_inv(self.state.poses[:n].float()).cpu().numpy()
        return poses, self.tstamps[:n].astype(float)

    def debug_match_figure(self, key_idx, query_num=3, save_path=None):
        """A matplotlib figure of keyframe key_idx's patch centres and their
        reprojections into each of the query_num keyframes before it,
        saved to save_path when given."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._replay_log()
        st, M = self.state, self.M
        coords = pops.transform(st.poses, st.patches, st.intrinsics, st.ii,
                                st.jj, st.kk)[:, 1, 1, :].cpu().numpy()
        ii, jj = st.ii.cpu().numpy(), st.jj.cpu().numpy()
        valid = st.valid.cpu().numpy()
        key_xy = st.patches[key_idx * M:(key_idx + 1) * M, :2, 1, 1] \
            .cpu().numpy() * 4
        fig, axes = plt.subplots(query_num, 1, figsize=(8, 3 * query_num))
        for a, ax in enumerate(np.atleast_1d(axes)):
            tgt = key_idx - a - 1
            sel = valid & (ii == key_idx) & (jj == tgt)
            pts = coords[sel] * 4
            ax.scatter(key_xy[:, 0], key_xy[:, 1], c="red", s=8,
                       label="keyframe patches")
            ax.scatter(pts[:, 0], pts[:, 1], c="blue", s=8,
                       label=f"reprojected into kf {tgt}")
            ax.set_xlim(0, self.wd)
            ax.set_ylim(self.ht, 0)
            ax.legend(loc="upper right", fontsize=6)
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return fig
