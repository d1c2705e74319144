"""Long-term loop closure.

Counterpart of the JAX package's `loop/longterm.py`: VLAD retrieval
(`loop/netvlad.py`, `loop/retrieval.py`), keypoints and matching
(`loop/keypoints.py`), a structure-only triangulation on the shared BA
(`ba/gauss_newton.py` with no free pose), a RANSAC-Umeyama Sim(3) fit
(`loop/umeyama.py`), the Sim(3) pose-graph optimisation (`loop/pgo.py`),
and the write-back that rescales poses, patch depths and the dropped
frames' delta chain.

Per keyframe: a global descriptor and the raw frame (`loop/cache.py`).
When a candidate survives retrieval's repetition check: a 2-D match
pre-gate, 3-D keypoints on the (i-s, i, i+s) and (j-s, j, j+s) triplets,
matched across, a Sim(3) fit, the drift gate, then the PGO.

Two decided differences from the JAX package: the frames are cached raw,
not as JPEG (ROADMAP R8), and RANSAC draws from `self.rng`, a numpy
generator seeded from the run's seed, where the JAX package draws fresh
entropy on every call (R9).

`events` records every candidate the loop closure verified, as
(outcome, i, j): "pre-rejected" (2-D matches), "rejected" (3-D points,
cross matches or inliers), "consistent" (confirmed, not applied) or
"applied"; `measured` each fitted Sim3 (i, j, inliers, scale, |t|,
rotation in degrees); `pgo_seconds` the wall time of each applied PGO.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ba.gauss_newton import BAConfig, _bundle_adjust_impl
from ..models import vonet
from ..ops import lie
from ..ops import projective as pops
from . import keypoints as kp
from .cache import ImageCache
from .netvlad import VLADDescriptor
from .pgo import run_pgo
from .retrieval import Retrieval, make_database
from .umeyama import ransac_umeyama

MIN_NUM_INLIERS = 30
NUM_KPTS = 2048


def drift_gate_consistent(meas, poses_w2c, i, j, gate):
    """Is the measured Sim3 (j <- i, [8]) already explained by the map:
    is the correction it implies within `gate` of the camera path between
    j and i (translation) and in |log scale|? poses_w2c [N, 7].
    Returns (consistent, t_frac, dlog_s)."""
    P = torch.as_tensor(np.asarray(poses_w2c), dtype=torch.float32)
    vo_rel = lie.se3_to_sim3(lie.se3_mul(P[j], lie.se3_inv(P[i])))
    corr = lie.sim3_log(lie.sim3_mul(
        lie.sim3_inv(torch.as_tensor(np.asarray(meas), dtype=torch.float32)),
        vo_rel)).numpy()
    ctrs = lie.se3_inv(P[min(i, j):max(i, j) + 1]).numpy()[:, :3]
    path = float(np.sum(np.linalg.norm(np.diff(ctrs, axis=0), axis=1)))
    t_frac = float(np.linalg.norm(corr[:3])) / max(path, 1e-6)
    ds = abs(float(corr[6]))
    return (t_frac < gate and ds < gate), t_frac, ds


class LongTermLoopClosure:
    def __init__(self, cfg, slam, vlad=None):
        """cfg: the run's DPVOConfig; slam: its DPVO; vlad: a
        VLADDescriptor (default: centres drawn from seed 7)."""
        self.cfg = cfg
        self.slam = slam
        self.vlad = vlad or VLADDescriptor()
        # hloc NetVLAD when a checkpoint is configured, else VLAD over the
        # VO features (computed inside the steady step in async mode)
        if cfg.NETVLAD_CHECKPOINT:
            from .netvlad_hloc import HlocNetVLAD
            self.netvlad = HlocNetVLAD(checkpoint=cfg.NETVLAD_CHECKPOINT,
                                       device=slam.device)
            desc_dim = self.netvlad.dim
        else:
            self.netvlad = None
            desc_dim = self.vlad.dim
        skip = cfg.LOOP_SKIP_WINDOW
        self.retrieval = Retrieval(
            make_database(cfg.RETRIEVAL_BACKEND, desc_dim, skip_window=skip),
            skip_window=skip)
        self.imcache = ImageCache()
        self.rng = np.random.default_rng(slam.seed)
        self.loop_ii = np.zeros(0, np.int64)
        self.loop_jj = np.zeros(0, np.int64)
        self.lc_count = 0
        self.lc_consistent = 0
        self.events = []
        self.measured = []
        self.pgo_seconds = []
        # keypoints and descriptors per keyframe (keys follow the
        # keyframe renumbering; a frame's image never changes)
        self._feat_cache = {}
        self._feat_cache_cap = 96
        if self.netvlad is None and not slam.sync_mode:
            slam.enable_descriptors(self.vlad)

    # ------------------------------------------------------------ per frame
    def _describe(self, image, n):
        if self.netvlad is not None:
            return self.netvlad.extract_image(np.asarray(image))
        return self.vlad.extract(self.slam.state.fmap1[n % self.cfg.pmem])

    def __call__(self, image, n, tstamp):
        """Synchronous ingest (warm-up frames and sync_mode): the frame's
        global descriptor from its feature map in the ring."""
        self.retrieval.add_frame(n, self._describe(image, n))
        self.imcache.add_frame(image, n)

    def add_descriptor(self, n, desc, image):
        """Asynchronous ingest: the descriptor drained from the device's
        `desc_log` (hloc NetVLAD: recomputed from the image)."""
        if self.netvlad is not None and image is not None:
            desc = self.netvlad.extract_image(image)
        self.retrieval.add_frame(n, desc)
        if image is not None:
            self.imcache.add_frame(image, n)

    def keyframe(self, k):
        self.retrieval.keyframe(k)
        self.imcache.keyframe(k)
        self._feat_cache = {(i - 1 if i > k else i): v
                            for i, v in self._feat_cache.items() if i != k}

    def _frame_feats(self, i):
        """Keypoints and descriptors of keyframe i (cached): fp32 features
        of the full-resolution frame, on the run's device."""
        f = self._feat_cache.get(i)
        if f is not None:
            return f
        dev = self.slam.device
        im = torch.as_tensor(self.imcache.load_frames([i])[0], device=dev)
        with torch.no_grad():
            fm = vonet.encode_frame(self.slam.net, im, torch.float32).fmap
        xy, score = kp.detect(im, NUM_KPTS)
        desc = kp.describe(fm, xy)
        f = {"xy": xy.cpu().numpy(), "score": score.cpu().numpy(),
             "desc": desc.cpu().numpy()}
        f["valid"] = f["score"] > 0
        while len(self._feat_cache) >= self._feat_cache_cap:
            self._feat_cache.pop(next(iter(self._feat_cache)))
        self._feat_cache[i] = f
        return f

    def _match(self, d0, d1, v0, v1):
        dev = self.slam.device
        out = kp.match(*(torch.as_tensor(a, device=dev)
                         for a in (d0, d1, v0, v1)))
        return tuple(a.cpu().numpy() for a in out)

    # ------------------------------------------------- keypoint triangulation
    def estimate_3d_keypoints(self, i):
        """Detect, match and triangulate on the (i-s, i, i+s) triplet
        (s = LOOP_KP_STRIDE, narrowed to the frames there are): returns
        (points [K, 3] in frame i's camera, {"xy", "desc"} of the kept
        keypoints), or (empty, None) under 8 triplet trajectories."""
        s = max(1, int(self.cfg.LOOP_KP_STRIDE))
        s = min(s, max(i, 1))
        while s > 1 and not self._have_frame(i + s):
            s -= 1
        feats = [self._frame_feats(x) for x in (i - s, i, i + s)]

        # trajectories across the triplet, anchored on the centre frame
        _, m01, ok01 = self._match(feats[0]["desc"], feats[1]["desc"],
                                   feats[0]["valid"], feats[1]["valid"])
        _, m21, ok21 = self._match(feats[2]["desc"], feats[1]["desc"],
                                   feats[2]["valid"], feats[1]["valid"])
        traj = np.full((NUM_KPTS, 3), -1, np.int64)
        traj[:, 1] = np.arange(NUM_KPTS)
        traj[m01[ok01], 0] = np.where(ok01)[0]
        traj[m21[ok21], 2] = np.where(ok21)[0]
        traj = traj[traj.min(axis=1) >= 0]
        n_tr = len(traj)
        if n_tr < 8:
            print(f"  kp[{i}]: only {n_tr} triplet trajectories")
            return np.zeros((0, 3)), None
        a, b, c = traj.T
        kps0 = feats[0]["xy"][a]
        kps1 = feats[1]["xy"][b]
        kps2 = feats[2]["xy"][c]
        desc1 = feats[1]["desc"][b]

        # a patch graph of the centre frame's keypoints at the median live
        # inverse depth of frame i, observed in frames i - s and i + s
        st = self.slam.state
        M = self.cfg.PATCHES_PER_FRAME
        disp0 = float(np.median(
            st.patches[i * M:(i + 1) * M, 2, 1, 1].cpu().numpy()))
        P = 3
        patches = np.zeros((n_tr, 3, P, P), np.float32)
        patches[:, 0] = kps1[:, 0, None, None]
        patches[:, 1] = kps1[:, 1, None, None]
        patches[:, 2] = disp0
        kk = np.tile(np.arange(n_tr), 2)
        ii = np.ones(2 * n_tr, np.int64)
        jj = np.zeros(2 * n_tr, np.int64)
        jj[n_tr:] = 2
        target = np.concatenate([kps0, kps2], axis=0).astype(np.float32)

        dev = self.slam.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        poses = st.poses[[i - s, i, i + s]].float()
        intr = st.intrinsics[i].float() * 4.0        # full resolution
        # structure only: the pose window [3, 3) is empty
        cfg_ba = BAConfig(window=4, patch_slots=n_tr, iterations=12,
                          per_patch_cap=2)
        ii_t, jj_t, kk_t = t(ii), t(jj), t(kk)
        with torch.no_grad():
            _, patches_out = _bundle_adjust_impl(
                poses, t(patches), intr, t(target), t(np.ones_like(target)),
                1e-3, ii_t, jj_t, kk_t, torch.ones(2 * n_tr, dtype=torch.bool,
                                                   device=dev),
                3, 3, 0, cfg_ba)
            intr3 = intr[None].expand(3, 4)
            coords = pops.transform(poses, patches_out, intr3, ii_t, jj_t,
                                    kk_t)
            X = pops.iproj(patches_out, intr[None].expand(n_tr, 4))
        resid = np.linalg.norm(coords[:, 1, 1, :].cpu().numpy() - target,
                               axis=-1)
        max_resid = np.maximum(resid[:n_tr], resid[n_tr:])
        # keep the well-triangulated points (LOOP_RESID_THRESH px)
        resid_th = float(self.cfg.LOOP_RESID_THRESH)
        mask = max_resid < resid_th
        X = X.cpu().numpy()
        pts = X[:, 1, 1, :3] / np.maximum(X[:, 1, 1, 3:], 1e-8)
        print(f"  kp[{i}]: {n_tr} trajectories, "
              f"{int(mask.sum())} triangulated <{resid_th:g}px "
              f"(resid p25/50/75 = "
              f"{np.percentile(max_resid, 25):.2f}/"
              f"{np.percentile(max_resid, 50):.2f}/"
              f"{np.percentile(max_resid, 75):.2f}px)")
        return pts[mask], {"xy": kps1[mask], "desc": desc1[mask]}

    # ------------------------------------------------------------- closure
    def _have_frame(self, i):
        return self.imcache.has(i)

    def attempt_loop_closure(self, n):
        """Drain retrieval's pending queries, verifying up to 4 candidates
        and stopping at the first applied closure (the PGO changes the
        state the other candidates were found on); then commit the frames
        that can no longer be evicted. A candidate at the newest keyframe
        has no forward frame for its triplet and is retargeted to its
        predecessor."""
        result = False
        budget = 4
        while budget > 0:
            cands = self.retrieval.detect_loop(
                thresh=self.cfg.LOOP_RETR_THRESH,
                num_repeat=self.cfg.LOOP_CLOSE_WINDOW_SIZE)
            if cands is None:
                break
            budget -= 1
            i, j = cands
            while i >= 2 and not self._have_frame(i + 1):
                i -= 1
            if not self._have_frame(i + 1) or i <= j:
                continue
            print(f"Attempting loop closure with ({i}, {j})")
            result = self.close_loop(i, j, n)
            self.lc_count += int(result)
            self.retrieval.found.clear()
            if result:
                self.retrieval.confirm_loop(i, j)
                break
        self.retrieval.save_up_to(n - self.cfg.REMOVAL_WINDOW - 2)
        self.imcache.save_up_to(n - self.cfg.REMOVAL_WINDOW - 1)
        return result

    def _reject(self, kind, i, j, msg):
        print(msg)
        self.events.append((kind, i, j))
        return False

    def close_loop(self, i, j, n):
        """Verify candidate (i, j) and, if it holds and the map does not
        already agree with it, apply the PGO. True when applied."""
        # 2-D pre-gate: fewer mutual matches between the centre frames
        # than the 3-D gate needs cannot pass it (its inliers are a subset)
        min_inl = self.cfg.LOOP_MIN_INLIERS
        if min_inl > 0:
            fi, fj = self._frame_feats(i), self._frame_feats(j)
            _, _, ok2d = self._match(fi["desc"], fj["desc"], fi["valid"],
                                     fj["valid"])
            n2d = int(ok2d.sum())
            if n2d < min_inl:
                return self._reject("pre-rejected", i, j,
                                    f"loop pre-rejected ({i},{j}): {n2d} 2D "
                                    "matches")

        i_pts, i_feat = self.estimate_3d_keypoints(i)
        j_pts, j_feat = self.estimate_3d_keypoints(j)
        if i_feat is None or j_feat is None:
            return self._reject("rejected", i, j,
                                f"loop rejected ({i},{j}): too few "
                                "triplet trajectories")

        # drop far points, relative to each set's median depth
        th_i = 8.0 * max(float(np.median(i_pts[:, 2])), 1e-6) \
            if len(i_pts) else 0.0
        th_j = 8.0 * max(float(np.median(j_pts[:, 2])), 1e-6) \
            if len(j_pts) else 0.0
        isel = (i_pts[:, 2] > 0) & (i_pts[:, 2] < th_i)
        jsel = (j_pts[:, 2] > 0) & (j_pts[:, 2] < th_j)
        i_pts, j_pts = i_pts[isel], j_pts[jsel]
        if i_pts.shape[0] < min_inl or j_pts.shape[0] < min_inl:
            return self._reject("rejected", i, j,
                                f"loop rejected: {i_pts.shape[0]}/"
                                f"{j_pts.shape[0]} near points")

        di = i_feat["desc"][isel]
        dj = j_feat["desc"][jsel]
        i_ind, j_ind, ok = self._match(di, dj, np.ones(len(di), bool),
                                       np.ones(len(dj), bool))
        src = i_pts[i_ind[ok]].astype(np.float64)
        dst = j_pts[j_ind[ok]].astype(np.float64)
        if src.shape[0] < min_inl:
            return self._reject("rejected", i, j,
                                f"loop rejected: {src.shape[0]} "
                                "cross-matches")

        # RANSAC threshold at a tenth of the median depth (scale-free)
        med_d = float(np.median(dst[:, 2]))
        R, t, s, n_inl = ransac_umeyama(src, dst, self.rng, iterations=400,
                                        threshold=max(0.1 * med_d, 1e-6))
        if n_inl < min_inl:
            return self._reject("rejected", i, j,
                                f"loop rejected: {n_inl} inliers")

        # the measured Sim3 (j <- i)
        q = lie.matrix_to_quat(torch.as_tensor(R, dtype=torch.float32))
        meas = np.concatenate([t, q.numpy(), [s]]).astype(np.float32)
        ang = float(np.degrees(np.arccos(
            np.clip((np.trace(R) - 1) / 2, -1, 1))))
        self.measured.append(dict(i=i, j=j, inliers=n_inl, scale=float(s),
                                  t=float(np.linalg.norm(t)), rot_deg=ang))

        # the drift gate: apply only a correction beyond what VO drift over
        # the loop's path explains; a consistent closure is confirmed
        # (retrieval's NMS then suppresses it) but not applied
        st = self.slam.state
        gate = float(self.cfg.LOOP_DRIFT_GATE)
        if gate > 0:
            pos = st.poses[:int(st.n_frames)].cpu().numpy()
            consistent, t_frac, ds = drift_gate_consistent(meas, pos, i, j,
                                                           gate)
            if consistent:
                print(f"loop consistent ({i},{j}): correction "
                      f"|t|/path={t_frac:.4f} |log s|={ds:.4f} below "
                      f"drift gate {gate}; confirmed, not applied")
                self.events.append(("consistent", i, j))
                self.lc_consistent += 1
                self.retrieval.confirm_loop(i, j)
                return False

        print(f"loop accepted ({i},{j}): {n_inl} inliers, "
              f"s={s:.3f} |t|={np.linalg.norm(t):.3f} rot={ang:.1f}deg")
        # every keyframe the device holds (in async mode it runs up to
        # 2 * LC_INTERVAL frames ahead of the replayed count n)
        n = max(n, int(st.n_frames))
        poses_w2c = st.poses[:n].float().cpu()
        Gi = poses_w2c[self.loop_ii]
        Gj = poses_w2c[self.loop_jj]
        prev = lie.se3_to_sim3(lie.se3_mul(Gj, lie.se3_inv(Gi))).numpy()
        constants = np.concatenate([prev.reshape(-1, 8), meas[None]], axis=0)
        self.loop_ii = np.concatenate([self.loop_ii, [i]])
        self.loop_jj = np.concatenate([self.loop_jj, [j]])
        t0 = time.perf_counter()
        final = run_pgo(poses_w2c.numpy(), constants, self.loop_ii,
                        self.loop_jj, device=self.slam.device)
        self.pgo_seconds.append(time.perf_counter() - t0)
        self.apply_pgo_result(final)
        self.events.append(("applied", i, j))
        return True

    def apply_pgo_result(self, final_c2w_sim3):
        """Write the optimised poses back and divide the patch depths by
        their frame's scale, in place (the captured graphs of the steady
        step read the state at fixed addresses), then rescale the delta
        chain."""
        slam = self.slam
        st = slam.state
        dev = st.poses.device
        safe_i = final_c2w_sim3.shape[0]
        final = torch.as_tensor(np.asarray(final_c2w_sim3, np.float32),
                                device=dev)
        M = self.cfg.PATCHES_PER_FRAME
        st.poses[:safe_i] = lie.se3_inv(final[:, :7])
        st.patches[:safe_i * M, 2] /= \
            final[:, 7].repeat_interleave(M)[:, None, None]
        s1 = np.ones(slam.n)
        s1[:safe_i] = np.asarray(final_c2w_sim3)[:, 7]
        self._rescale_deltas(s1)

    def _rescale_deltas(self, s):
        """Scale the translation of each dropped frame's dP by the scale
        of the keyframe its chain ends at."""
        slam = self.slam
        # only the host-replayed timestamps are known (in async mode the
        # device may be frames ahead of the replay)
        n_known = min(len(s), slam.n_host)
        t2s = {int(slam.tstamps[i]): s[i] for i in range(n_known)}
        for t, (t0, dP) in list(slam.delta.items()):
            t_src = t
            while t_src in slam.delta:
                t_src, _ = slam.delta[t_src]
            if t_src in t2s:
                dP2 = torch.as_tensor(dP, dtype=torch.float32).clone()
                dP2[:3] *= float(t2s[t_src])
                slam.delta[t] = (t0, dP2)

    def terminate(self, n):
        """Commit every frame, drain the queries, close the cache."""
        self.retrieval.save_up_to(n - 1)
        self.imcache.save_up_to(n - 1)
        self.attempt_loop_closure(n)
        self.imcache.close()
        print(f"LC COUNT: {self.lc_count}")
