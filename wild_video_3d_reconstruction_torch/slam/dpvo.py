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
              (timestamps, the dropped-frame delta chain); the loop
              closure's last attempt; global BA over every keyframe when
              ENABLE_GLOBAL_BA is set (`slam/global_ba.py`); then the full
              trajectory through the delta chain, camera-to-world
              (`trajectory`)

With `loop_enabled` the run carries a `loop/longterm.py`
LongTermLoopClosure (`loop_closure`). Warm-up frames (and every frame in
`sync_mode`) hand it their descriptor and image as they are accepted, and
each frame after them attempts closures. Steady frames write their VLAD
descriptor into `state.desc_log` inside the replayed step
(`enable_descriptors`) and leave their image in `_lc_images`; every
LC_INTERVAL dispatched frames `_lc_sync` requests the newest interval's
event-log and descriptor rows as a copy into pinned host memory (no wait),
replays the interval requested the time before into the loop closure's
callbacks (descriptor, image, evictions, in the order the synchronous path
gives them), then attempts closures: the host runs one interval behind the
card, as in the JAX package.

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
import time

import numpy as np
import torch

from ..loop.longterm import LongTermLoopClosure
from ..models.convert import jax_params_to_torch, load_reference_checkpoint
from ..models.vonet import VONet, init_vonet
from ..ops import lie
from ..ops import projective as pops
from ..utils.config import DPVOConfig
from . import steps
from .global_ba import run_global_ba
from .graphs import StepRunner, check_faults
from .state import WARMUP, SLAMState, init_state


class DPVO:
    WARMUP = WARMUP

    def __init__(self, cfg: DPVOConfig, network=None, ht=480, wd=640,
                 seed=0, device="cuda", sync_mode=False, vlad=None):
        """network: a `VONet`, a path to a DPVO `.pth` checkpoint, the JAX
        package's parameter tree (nested dicts of numpy arrays), or None
        for weights drawn from `seed`. device: "cuda" unless the caller
        asks for the CPU. sync_mode: the synchronous steady path (see the
        module). vlad: the loop closure's `VLADDescriptor` when
        `loop_enabled` (default: centres drawn from seed 7)."""
        self.cfg = cfg
        self.seed = seed
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
        # the loop closure's steady-frame bookkeeping
        self._lc_images = {}          # input counter -> image
        self._lc_pending = None       # a request: (first event, rows,
                                      # descs, event or None)
        self._lc_req_lo = 0           # first event of the next request
        self._lc_slot = 0             # pinned buffer of the next request
        self._lc_host = None          # two pinned (log, desc) buffers
        self.lc_sync_s = 0.0          # seconds in _lc_sync
        self.loop_closure = None
        if cfg.loop_enabled:
            self.loop_closure = LongTermLoopClosure(cfg, self, vlad=vlad)

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
            if self.loop_closure is not None:
                self._lc_images[self.counter] = np.asarray(image)
            self.counter += 1
            if len(self._pending) >= self.runner.chunk:
                self._flush_pending()
            if self.loop_closure is not None and self._events_dispatched \
                    - self._lc_req_lo >= self.cfg.LC_INTERVAL:
                self._lc_sync()
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
        lc = self.loop_closure
        if lc is not None:
            lc(np.asarray(image), self.n_host - 1, self.counter - 1)
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
        if lc is not None and self.is_initialized:
            lc.attempt_loop_closure(self.n_host)

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
            if self.loop_closure is not None:
                self.loop_closure.keyframe(k)
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

    def _replay_events(self, rows, first_event, descs=None):
        """Replay event-log rows [first_event, first_event + len) into the
        host bookkeeping: timestamps, the eviction delta chain, NaN
        warnings; with the loop closure, each frame's descriptor (descs,
        the desc_log rows) and image, then its eviction, in the order the
        synchronous path hands them over."""
        if first_event != self._events_consumed:
            raise RuntimeError(f"event-log rows from {first_event} replayed "
                               f"after {self._events_consumed}")
        lc = self.loop_closure
        n = self.n_host
        for e in range(rows.shape[0]):
            c = self._init_counter + first_event + e
            self.tstamps[n] = c
            n += 1
            if lc is not None:
                lc.add_descriptor(n - 1, descs[e], self._lc_images.pop(c))
            removed, dP, nan_flag = rows[e, 0], rows[e, 1:8], rows[e, 9]
            if removed > 0.5:
                k = n - self.cfg.KEYFRAME_INDEX
                t0, t1 = int(self.tstamps[k - 1]), int(self.tstamps[k])
                self.delta[t1] = (t0, torch.from_numpy(
                    dP.astype(np.float32)))
                self.tstamps[k:n - 1] = self.tstamps[k + 1:n].copy()
                n -= 1
                if lc is not None:
                    lc.keyframe(k)
            if nan_flag > 0.5:
                print(f"WARNING: NaN pose detected near input frame {c}")
        self.n_host = n
        self._events_consumed = first_event + rows.shape[0]

    def _replay_log(self):
        """Bring the host bookkeeping up to the device event log: flush a
        pending chunk, consume the loop closure's requested interval, fetch
        the rows not replayed yet, replay them. Raises if a steady frame
        broke the run-sum SoftAgg's segment rule."""
        if self.sync_mode or self._init_counter is None:
            return
        self._flush_pending()
        self.runner.invalidate()
        _, _, total, faults = self.runner.counts()
        check_faults(faults)
        if self._lc_pending is not None:
            request, self._lc_pending = self._lc_pending, None
            self._lc_consume(request)
        lo = self._events_consumed
        if total > lo:
            descs = self.state.desc_log[lo:total].float().cpu().numpy() \
                if self.loop_closure is not None else None
            self._replay_events(self.state.log[lo:total].cpu().numpy(), lo,
                                descs)
        self._lc_req_lo = self._events_consumed

    # ------------------------------------------------------- loop closure
    def enable_descriptors(self, vlad):
        """Have the steady step log each frame's VLAD descriptor with
        vlad's centres (`LongTermLoopClosure` calls it outside sync_mode),
        growing desc_log to [LOG_CAP, vlad.dim] if it is smaller."""
        if self.is_initialized:
            raise RuntimeError("enable_descriptors after the bootstrap: the "
                               "steady frames before it have no descriptor")
        st = self.state
        if tuple(st.desc_log.shape) != (self.cfg.LOG_CAP, vlad.dim):
            st.desc_log = torch.zeros((self.cfg.LOG_CAP, vlad.dim),
                                      dtype=torch.bfloat16,
                                      device=self.device)
        self.runner.set_centers(vlad.centers)

    def _lc_request(self, lo, hi):
        """Event-log rows [lo, hi) and their descriptors on their way to
        the host, without waiting: copies into one of two pinned buffers
        queued after the work so far, and the event that marks them done
        (on the card); plain copies (on the CPU)."""
        st = self.state
        if not self.runner.graphed:
            return lo, st.log[lo:hi].clone(), st.desc_log[lo:hi].clone(), \
                None
        K = hi - lo
        if self._lc_host is None or self._lc_host[0][0].shape[0] < K:
            self._lc_host = [(torch.empty((K, st.log.shape[1]),
                                          pin_memory=True),
                              torch.empty((K, st.desc_log.shape[1]),
                                          dtype=st.desc_log.dtype,
                                          pin_memory=True))
                             for _ in range(2)]
        log_h, desc_h = self._lc_host[self._lc_slot]
        self._lc_slot ^= 1
        log_h[:K].copy_(st.log[lo:hi], non_blocking=True)
        desc_h[:K].copy_(st.desc_log[lo:hi], non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return lo, log_h[:K], desc_h[:K], ready

    def _lc_consume(self, request):
        """Replay a requested interval (once its copy is done) into the
        host bookkeeping and the loop closure."""
        lo, rows, descs, ready = request
        if ready is not None:
            ready.synchronize()
        self._replay_events(rows.numpy(), lo, descs.float().numpy())

    def _lc_sync(self):
        """Every LC_INTERVAL dispatched steady frames: request the newest
        interval, consume the one requested before, attempt closures."""
        t0 = time.perf_counter()
        lo = self._lc_req_lo
        prev = self._lc_pending
        self._lc_pending = self._lc_request(lo, lo + self.cfg.LC_INTERVAL)
        self._lc_req_lo = lo + self.cfg.LC_INTERVAL
        if prev is not None:
            self._lc_consume(prev)
            self.loop_closure.attempt_loop_closure(self.n_host)
        self.lc_sync_s += time.perf_counter() - t0

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
        """The loop closure's last attempt, global BA over every keyframe
        when ENABLE_GLOBAL_BA is set, then `trajectory()`."""
        self._replay_log()
        if self.loop_closure is not None:
            self.loop_closure.terminate(self.n_host)
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
        input timestamps, after the loop closure's last attempt."""
        self._replay_log()
        if self.loop_closure is not None:
            self.loop_closure.terminate(self.n_host)
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
