"""The port's fixed-shape steady frame step against the JAX package, at the
SLAM smoke test's tiny size, in fp32, on the CPU.

The steady step keeps its counters on the device, runs its O(E) stages
over a static prefix tier of the edge table, takes the keyframe decision
as predicated copies and logs each frame in `state.log`; `DPVO` replays
that log at terminate. These tests hold it against the JAX package:

  * at forced tiers (the JAX package's TIER_ON_CPU / TIER_MIN_EDGES and
    the port's own flags), `update_op`, `flow_metric` and
    `retire_and_compact` on a captured state equal JAX within 1e-4, and
    the port's untiered step within 1e-5 (the port on one CPU thread, as
    in `tests/test_torch_slam.py`: threaded reductions split other row
    counts in other places). The captured state's edge table
    is grown to 3072 dead-padded rows so that the tiers are real prefixes
    (1024 rows in the port, 2048 in JAX);
  * `keyframe_and_log` takes both branches on captured states and equals
    JAX's state and log row;
  * the event log of the whole slice equals the JAX run's: removed and
    NaN flags exactly, dP within the slice's 1e-2 (absolute, pose units
    as the trajectories) and the flow metric within 1e-2 of itself (a
    mean reprojection magnitude of about 100 px);
  * PIPELINE_CHUNK = 4 equals 1 (trajectory within 5e-4, timestamps and
    edge table equal), with a partial tail;
  * `sync_mode=True` equals the steady path: the same keyframe drops,
    the trajectory within 1e-4;
  * the step reads nothing back to the host;
  * the scene that keeps keyframes on the card (`chip_smoke.py`
    `slam_default_wild_keep`: `eval/synth_ate.py:wild_sequence` at
    KEEP_STRIDE times the walk's motion per frame, depth and mask on every
    frame, the trained weights) at this tiny size, with default.yaml's
    KEYFRAME_THRESH scaled by the width (64 / 512, the flow metric's
    pixels shrink with the image): the JAX run and the port's fed its
    draws take the same decisions, keeps and drops both, with the same
    log rows, the trajectory within the slice's 1e-2.

The JAX run and the port's run are `tests/test_torch_slam.py`'s module
fixture, reused.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.models import vonet as tvonet
from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.slam import graphs as tgraphs
from wild_video_3d_reconstruction_torch.slam import state as tstate
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_torch.utils.config import load_config
from wild_video_3d_reconstruction_tpu.slam import state as jstate
from wild_video_3d_reconstruction_tpu.slam import steps as jsteps
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

from test_torch_slam import (HT, INTR, TINY, TOL_STEP, TOL_TRAJ, WD, _net,
                             host_array, one_thread,
                             run)  # noqa: F401 (the fixture)
from test_torch_synth_ate import jax_raw_draws, jax_run
from test_torch_weights import WEIGHTS, exporter

E_PAD = 3072            # rows of the grown edge table
TOL_UNTIERED = 1e-5
TOL_CHUNK = 5e-4
TOL_SYNC = 1e-4
EDGE_KEYS = ("ii", "jj", "kk", "valid", "net", "target", "weight")
KEEP_STRIDE = 4         # chip_smoke.py's KEEP_STRIDE
KEEP_FRAMES = 18
KEEP_THRESH = 15.0 * WD / 512


@pytest.fixture
def forced_tiers(monkeypatch):
    for mod in (jsteps, tsteps):
        monkeypatch.setattr(mod, "TIER_ON_CPU", True)
        monkeypatch.setattr(mod, "TIER_MIN_EDGES", 0)


def grown(snap, E=E_PAD):
    """A JAX state snapshot with its edge table grown to E rows (dead)."""
    out = dict(snap)
    for k in EDGE_KEYS:
        a = snap[k]
        out[k] = np.concatenate(
            [a, np.zeros((E - a.shape[0],) + a.shape[1:], a.dtype)])
    return out


def jax_state(snap):
    return jstate.SLAMState(**{k: jnp.asarray(v) for k, v in snap.items()})


def port_state(snap, cfg):
    """A JAX state snapshot as the port's SLAMState, with the snapshot's
    own edge-table size."""
    st = tstate.init_state(cfg, HT, WD, feat_dtype=torch.float32)
    for k, dst in vars(st).items():
        if k in EDGE_KEYS:
            setattr(st, k, torch.from_numpy(np.array(snap[k])).to(dst.dtype))
        elif isinstance(dst, torch.Tensor) and k in snap:
            src = torch.from_numpy(host_array(snap[k]))
            dst[:src.shape[0]] = src.to(dst.dtype)
    st.counts.zero_()
    st.n_frames = int(snap["n_frames"])
    st.n_edges = int(snap["n_edges"])
    st.log_idx = int(snap["log_idx"])
    return st


def close(a, b, tol, rows=None):
    a, b = np.asarray(a), np.asarray(b)
    if rows is not None:
        a, b = a[rows], b[rows]
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def test_edge_tiers_of_the_shipped_configs():
    """default.yaml's three tiers and fast.yaml's two, every one a whole
    number of the run-sum's 512-row rule."""
    for path, want in (("configs/default.yaml", (73728, 100352, 221184)),
                       ("configs/fast.yaml", (7168, 19456))):
        cfg = load_config(path)
        E = tstate.edge_rows(cfg)
        tiers = tsteps.edge_tiers(cfg, E, "cuda")
        assert tiers == want
        assert all(t % tsteps.RUNSUM_ROWS == 0 for t in tiers)
        assert tsteps.edge_tiers(cfg, E, "cpu") == (E,)
        assert tsteps.choose_tier(tiers, tiers[0]) == tiers[0]
        assert tsteps.choose_tier(tiers, tiers[0] + 1) == tiers[1]


@pytest.mark.parametrize("step", ["update_op", "flow_metric",
                                  "retire_and_compact"])
def test_tiered_step_matches_jax_and_untiered(run, forced_tiers, step):
    jcfg, tcfg, snap = run["jcfg"], run["tcfg"], grown(run["final"])
    n = int(snap["n_frames"])
    M = jcfg.PATCHES_PER_FRAME
    untiered = tcfg.merge_from_dict({"EDGE_TIERS": 1})
    st, full = port_state(snap, tcfg), port_state(snap, untiered)
    assert tsteps.rows_for(tcfg, st) == 1024 < E_PAD      # a real prefix
    assert tsteps.rows_for(untiered, full) == E_PAD
    assert int(snap["n_edges"]) <= 2048                   # JAX's tier 0
    jst = jax_state(snap)
    if step == "flow_metric":
        i, j = n - 3, n - 1
        a = float(jax.jit(lambda s: jsteps.flow_metric(jcfg, s, i, j))(jst))
        with one_thread():
            b = float(tsteps.flow_metric(tcfg, st, i, j))
            c = float(tsteps.flow_metric(untiered, full, i, j))
        assert abs(b - a) <= TOL_STEP and abs(b - c) <= TOL_UNTIERED
        return
    if step == "update_op":
        t0 = max(n - jcfg.OPTIMIZATION_WINDOW, 1)
        jout = jax.jit(lambda s: jsteps.update_op(jcfg, run["params"], s,
                                                  t0))(jst)
        with one_thread():
            tsteps.update_op(tcfg, _net(run), st, t0)
            tsteps.update_op(untiered, _net(run), full, t0)
    else:
        jst = jst._replace(n_frames=jst.n_frames + 2)
        st.n_frames += 2
        full.n_frames += 2
        jout = jax.jit(lambda s: jsteps.retire_and_compact(jcfg, s))(jst)
        with one_thread():
            tsteps.retire_and_compact(tcfg, st)
            tsteps.retire_and_compact(untiered, full)
    ne = int(st.n_edges)
    assert ne == int(jout.n_edges) == int(full.n_edges)
    v = np.asarray(jout.valid)[:ne]
    for k in ("ii", "jj", "kk", "valid"):
        np.testing.assert_array_equal(getattr(st, k)[:ne].numpy(),
                                      np.asarray(getattr(jout, k))[:ne])
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      getattr(full, k).numpy())
    nf = int(st.n_frames)
    for k, rows in (("poses", nf), ("patches", nf * M)):
        close(getattr(st, k)[:rows], getattr(jout, k)[:rows], TOL_STEP)
        close(getattr(st, k), getattr(full, k), TOL_UNTIERED)
    for k in ("net", "target", "weight"):
        close(getattr(st, k)[:ne], getattr(jout, k)[:ne], TOL_STEP, v)
        close(getattr(st, k)[:ne], getattr(full, k)[:ne], TOL_UNTIERED, v)


@pytest.mark.parametrize("branch", ["remove", "keep"])
def test_keyframe_and_log_branches_match_jax(run, forced_tiers, branch):
    """Both outcomes of the on-device decision on the captured state (the
    threshold pinned to always / never evict): the same state, buffers and
    edge table (the edge edits cover the port's 1024-row tier, JAX's
    whole table), and the same log row."""
    thresh = {"KEYFRAME_THRESH": 1e9 if branch == "remove" else 0.0}
    jcfg = run["jcfg"].merge_from_dict(thresh)
    tcfg = run["tcfg"].merge_from_dict(thresh)
    snap = grown(run["final"])
    jst, st = jax_state(snap), port_state(snap, tcfg)
    row = int(snap["log_idx"])
    jout = jax.jit(lambda s: jsteps.keyframe_and_log(jcfg, s))(jst)
    with one_thread():
        tsteps.keyframe_and_log(tcfg, st)
    for k in ("n_frames", "n_edges", "log_idx"):
        assert int(getattr(st, k)) == int(getattr(jout, k)), k
    assert int(st.n_frames) == int(snap["n_frames"]) - (branch == "remove")
    assert int(st.log_idx) == row + 1
    jrow, trow = np.asarray(jout.log)[row], st.log[row].numpy()
    assert trow[0] == jrow[0] == float(branch == "remove")
    assert trow[9] == jrow[9]
    close(trow[1:9], jrow[1:9], TOL_UNTIERED)
    for k in ("ii", "jj", "kk", "valid", "net", "target", "weight", "poses",
              "patches", "patches_est", "intrinsics", "colors", "imap",
              "gmap", "fmap1", "fmap2"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jout, k)), k)


def test_event_log_matches_jax(run):
    """One log row per steady frame, against the JAX run's."""
    js, ts = run["js"], run["ts"]
    n = int(js.state.log_idx)
    assert int(ts.state.log_idx) == n == ts.counter - ts._init_counter > 0
    jl, tl = np.asarray(js.state.log)[:n], ts.state.log[:n].numpy()
    np.testing.assert_array_equal(tl[:, 0], jl[:, 0])
    np.testing.assert_array_equal(tl[:, 9], jl[:, 9])
    assert tl[:, 0].any() and not tl[:, 0].all()
    close(tl[:, 1:8], jl[:, 1:8], TOL_TRAJ)
    np.testing.assert_allclose(tl[:, 8], jl[:, 8], rtol=TOL_TRAJ, atol=0)
    assert not ts.state.log[n:].any()


def _port_run(run, n_frames, **kw):
    cfg = TConfig(**TINY, **kw.pop("cfg", {}))
    ts = TDPVO(cfg, jax.tree.map(np.asarray, run["params"]), HT, WD, seed=0,
               device="cpu", **kw)
    with one_thread():
        for t, img in enumerate(run["frames"][:n_frames]):
            ts(t, img, INTR, coords=run["draws"][t][0],
               inv_depths=run["draws"][t][1])
    return ts


def test_pipeline_chunk_4_equals_1(run):
    """17 frames: 10 warm-up, one chunk of 4, a tail of 3 that terminate
    dispatches frame by frame."""
    s1 = _port_run(run, 17)
    s4 = _port_run(run, 17, cfg={"PIPELINE_CHUNK": 4})
    assert len(s4._pending) == 3 and s4._events_dispatched == 4
    traj1, ts1 = s1.terminate()
    traj4, ts4 = s4.terminate()
    assert s4._pending == [] and s4._events_dispatched == \
        s1._events_dispatched == 7
    np.testing.assert_array_equal(ts1, ts4)
    np.testing.assert_allclose(traj4, traj1, atol=TOL_CHUNK, rtol=0)
    assert sorted(s1.delta) == sorted(s4.delta)
    assert s1.state.counts.tolist() == s4.state.counts.tolist()
    ne = int(s1.state.n_edges)
    for k in ("ii", "jj", "kk", "valid"):
        assert torch.equal(getattr(s1.state, k)[:ne],
                           getattr(s4.state, k)[:ne])


def test_sync_mode_matches_the_steady_path(run):
    """The synchronous path (track_step, the keyframe decision on the
    host, no event log) against the steady run of the fixture."""
    sync = _port_run(run, len(run["frames"]), sync_mode=True)
    traj, tstamps = sync.terminate()
    ts = run["ts"]
    assert sorted(sync.delta) == sorted(ts.delta) and len(sync.delta) > 0
    np.testing.assert_array_equal(sync.tstamps[:sync.n_host],
                                  ts.tstamps[:ts.n_host])
    np.testing.assert_allclose(traj, run["tp"], atol=TOL_SYNC, rtol=0)
    np.testing.assert_array_equal(tstamps, run["tt"])
    assert int(sync.state.log_idx) == 0


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Every way Python code reads a tensor's value to the host raises."""
    def refuse(name):
        def f(*a, **kw):
            raise AssertionError(f"host read: Tensor.{name}")
        return f
    with monkeypatch.context() as m:
        for name in ("__bool__", "__int__", "__float__", "__index__",
                     "item", "tolist", "numpy", "cpu"):
            m.setattr(torch.Tensor, name, refuse(name))
        yield


def test_frame_step_reads_nothing_back(run, monkeypatch):
    """From insert_frame to the log append and the retirement, the steady
    step reads no tensor value on the host (the eager tier choice before
    it does, once)."""
    tcfg = run["tcfg"]
    st = port_state(run["final"], tcfg)
    n_rows = tsteps.choose_tier(tsteps.edge_tiers(tcfg, 1024, "cpu"),
                                int(st.n_edges) + tsteps.appended_rows(tcfg))
    draws = tsteps.draw_inputs(tcfg, st, HT, WD, *run["draws"][0])
    inputs = tsteps.FrameInputs(
        torch.from_numpy(run["frames"][0]), torch.tensor(INTR).float(),
        torch.tensor(1.0), *draws)
    n0 = int(st.n_frames)
    with no_host_reads(monkeypatch):
        tsteps.frame_step(tcfg, _net(run), st, inputs, n_rows)
    assert int(st.log_idx) == int(run["final"]["log_idx"]) + 1
    assert int(st.n_frames) in (n0, n0 + 1)


def test_given_centres_skip_the_gradient_selection():
    """With GRADIENT_BIAS the step picks the top-M of 3M host draws by
    the frame's pooled gradient, as `select_patches` does; centres the
    caller gives go in as they are."""
    cfg = TConfig(**{**TINY, "GRADIENT_BIAS": True})
    st = tstate.init_state(cfg, HT, WD, feat_dtype=torch.float32)
    image = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (HT, WD, 3), dtype=np.uint8))
    M = cfg.PATCHES_PER_FRAME
    net = tvonet.init_vonet(0)
    want = tvonet.select_patches(torch.Generator().manual_seed(5), M,
                                 HT // 4, WD // 4,
                                 gradient_map=tvonet.image_gradient_map(image))
    given = np.stack([np.arange(M) + 2.0, np.full(M, 3.0)], -1)
    for coords, expect in ((None, want), (given, torch.from_numpy(given))):
        st.rng = torch.Generator().manual_seed(5)
        st.n_frames = 0
        draws = tsteps.draw_inputs(cfg, st, HT, WD, coords=coords)
        assert draws[0].shape == (3 * M, 2)
        tsteps.insert_frame(cfg, net, st, tsteps.FrameInputs(
            image, torch.tensor(INTR).float(), torch.tensor(1.0), *draws))
        centres = st.patches[:M, :2, 1, 1]
        np.testing.assert_array_equal(centres.numpy(),
                                      expect.float().numpy())


def test_runner_checks_the_tables_before_a_frame():
    """The steady dispatch raises, before it runs a frame, when the event
    log or the edge table would overflow."""
    cfg = TConfig(**TINY)
    st = tstate.init_state(cfg, HT, WD, feat_dtype=torch.float32)
    runner = tgraphs.StepRunner(cfg, None, st, HT, WD)
    st.log_idx = cfg.LOG_CAP
    with pytest.raises(RuntimeError, match="event log full"):
        runner._tier_of(st)
    st.log_idx = 0
    st.n_edges = st.ii.shape[0] - tsteps.appended_rows(cfg) + 1
    with pytest.raises(RuntimeError, match="edge table full"):
        runner._tier_of(st)
    st.n_edges = 0
    assert runner._tier_of(st) == st.ii.shape[0]
    st.faults = 1
    with pytest.raises(RuntimeError, match="outside the BA patch table"):
        runner._tier_of(st)


@pytest.fixture(scope="module")
def keep_runs():
    """The keep scene through the JAX DPVO and the port's, fed the JAX
    draws (the mask selection's)."""
    images, _, intr, depths, masks = tsynth_ate.wild_sequence(
        0, frames=KEEP_FRAMES, ht=HT, wd=WD, fx=40.0, fy=40.0,
        stride=KEEP_STRIDE)
    cfg = dict(TINY, KEYFRAME_THRESH=KEEP_THRESH)
    params = jax.tree.map(np.asarray, exporter.restore())
    jp, jt, js = jax_run(params, (images, intr), JConfig(**cfg),
                         list(zip(depths, masks)))
    draws = jax_raw_draws(KEEP_FRAMES, TINY["PATCHES_PER_FRAME"], HT // 4,
                          WD // 4, "mask")
    ts = TDPVO(TConfig(**cfg), str(WEIGHTS), HT, WD, device="cpu")
    with one_thread():
        for t in range(KEEP_FRAMES):
            ts(t, images[t], intr, depth=depths[t], mask=masks[t],
               **draws[t])
        tp, tt = ts.terminate()
    return dict(jp=jp, jt=jt, js=js, tp=tp, tt=tt, ts=ts)


def test_keep_scene_takes_both_branches(keep_runs):
    """Steady frames kept (the keep side of the predicated
    keyframe_shift) and dropped, in both packages."""
    for slam in (keep_runs["js"], keep_runs["ts"]):
        n = int(slam.state.log_idx)
        removed = np.asarray(slam.state.log[:n])[:, 0]
        assert n == KEEP_FRAMES - slam._init_counter
        assert (removed == 0).any() and (removed == 1).any()


def test_keep_scene_matches_jax(keep_runs):
    js, ts = keep_runs["js"], keep_runs["ts"]
    n = int(js.state.log_idx)
    jl, tl = np.asarray(js.state.log)[:n], ts.state.log[:n].numpy()
    np.testing.assert_array_equal(tl[:, 0], jl[:, 0])
    np.testing.assert_array_equal(tl[:, 9], jl[:, 9])
    close(tl[:, 1:8], jl[:, 1:8], TOL_TRAJ)
    np.testing.assert_allclose(tl[:, 8], jl[:, 8], rtol=TOL_TRAJ, atol=0)
    assert sorted(ts.delta) == sorted(js.delta)
    np.testing.assert_array_equal(keep_runs["tt"], keep_runs["jt"])
    np.testing.assert_allclose(keep_runs["tp"], keep_runs["jp"],
                               atol=TOL_TRAJ, rtol=0)
