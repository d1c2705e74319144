"""Port parity for the whole VO slice and its steps, against the JAX
package at the SLAM smoke test's tiny size, in fp32 on both sides.

One module-scoped fixture runs the JAX DPVO (warm-up, bootstrap, steady
state, terminate) with its seeded parameters and frames, and the port's
DPVO on the same frames with those parameters carried across and the JAX
run's patch centres and inverse depths fed in (jax.random cannot be
reproduced in torch). The steps are then compared on states captured from
the JAX run.

Tolerances: the trajectories within 1e-2 absolute (12 bootstrap and 8
steady-state Gauss-Newton rounds amplify fp32 rounding differences of the
encoders, measured at 4.6e-4 with the port on one CPU thread), with
identical keyframe decisions and edge tables; single steps on a captured
state within 1e-4. The port's whole-slice runs use one CPU thread: its
reductions then sum in one order whatever the machine's core count (with
3 threads the same comparison measured 5.3e-3).

The port's runs on the fused-correlation route (`PALLAS_FUSED: true`, x32
and x16 region kernels' plain versions) are held against the same JAX run:
the JAX package computes the correlation with its exact `ops/corr.py` on
the CPU (and with PALLAS_CORR off) whatever PALLAS_FUSED says, and the
port's region route is exact too. Same 1e-2 on the trajectories and the
same keyframe decisions; against the port's own unfused run over the first
12 frames within 1e-3 (the two routes sum the same fp32 products in
another order; later frames cross the BA's clamps at other points).
"""

import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch import demo as tdemo
from wild_video_3d_reconstruction_torch.ba import gauss_newton as tba
from wild_video_3d_reconstruction_torch.io import export as texport
from wild_video_3d_reconstruction_torch.models import convert as tconvert
from wild_video_3d_reconstruction_torch.models import update as tupdate
from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.slam import state as tstate
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.ba import gauss_newton as jba
from wild_video_3d_reconstruction_tpu.models import update as jupdate
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.slam import DPVO as JDPVO
from wild_video_3d_reconstruction_tpu.slam import state as jstate
from wild_video_3d_reconstruction_tpu.slam import steps as jsteps
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

HT, WD = 48, 64
N_FRAMES = 18
INTR = np.array([40.0, 40.0, WD / 2, HT / 2])
# the SLAM smoke test's tiny config, fp32, motion gate off
TINY = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
            OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
            KEYFRAME_THRESH=12.5, MEM=12, GRADIENT_BIAS=False,
            CORR_CHUNK=512, PALLAS_CORR=False, MIXED_PRECISION=False,
            MOTION_PROBE_THRESH=-1.0)
TOL_TRAJ = 1e-2
TOL_STEP = 1e-4
N_PREFIX = 12         # frames of the fused-vs-unfused route comparison
TOL_ROUTES = 1e-3


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def synthetic_frames(n, seed=0):
    """A drifting random texture (as tests/test_slam_smoke.py)."""
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, size=(HT * 2, WD * 2, 3)).astype(np.uint8)
    return [big[4 * t % HT:4 * t % HT + HT, 6 * t % WD:6 * t % WD + WD].copy()
            for t in range(n)]


def jax_draws(n, M, seed=0):
    """The patch centres and inverse depths the JAX run draws from its
    state key, frame by frame (`insert_frame` with key=None)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        rng, k_sel, k_depth = jax.random.split(rng, 3)
        out.append((np.asarray(jvonet.select_patches(k_sel, M, HT // 4,
                                                     WD // 4)),
                    np.asarray(jax.random.uniform(k_depth, (M,)))))
    return out


def snapshot(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def host_array(a):
    """A snapshot array for torch.from_numpy (whose numpy has no bfloat16:
    the JAX state's desc_log is bf16, whose values fp32 holds exactly)."""
    a = np.array(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_port_state(snap, cfg):
    """A JAX state snapshot as the port's SLAMState (CPU, fp32)."""
    st = tstate.init_state(cfg, HT, WD, feat_dtype=torch.float32)
    for f in dataclasses.fields(st):
        if f.name in snap and f.name not in ("n_frames", "n_edges", "rng"):
            src = torch.from_numpy(host_array(snap[f.name]))
            dst = getattr(st, f.name)
            dst[:src.shape[0]] = src.to(dst.dtype)
    st.n_frames = int(snap["n_frames"])
    st.n_edges = int(snap["n_edges"])
    return st


def terminated_copy(ts):
    """Trajectory and keyframe drops of a copy of `ts` terminated now."""
    early = copy.deepcopy(ts)
    return early.terminate()[0], sorted(early.delta)


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = JConfig(**TINY), TConfig(**TINY)
    params = jvonet.init_vonet(jax.random.PRNGKey(0))
    frames = synthetic_frames(N_FRAMES)
    draws = jax_draws(N_FRAMES, jcfg.PATCHES_PER_FRAME)

    js = JDPVO(jcfg, params, HT, WD, seed=0)
    js.state = jstate.init_state(jcfg, HT, WD, feat_dtype=jnp.float32,
                                 seed=0)
    ts = TDPVO(tcfg, jax.tree.map(np.asarray, params), HT, WD, seed=0,
               device="cpu")
    snaps = {}
    for t, img in enumerate(frames):
        js(t, img, intrinsics=INTR)
        with one_thread():
            ts(t, img, INTR, coords=draws[t][0], inv_depths=draws[t][1])
            if t + 1 == N_PREFIX:
                snaps["prefix"] = terminated_copy(ts)
        if t == 8:        # the last warm-up frame before the bootstrap
            snaps["warmup"] = (snapshot(js.state), dataclasses.replace(
                ts.state, ii=ts.state.ii.clone(), jj=ts.state.jj.clone(),
                kk=ts.state.kk.clone(), valid=ts.state.valid.clone(),
                counts=ts.state.counts.clone()))
    jp, jt = js.terminate()
    tp, tt = ts.terminate()
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, js=js, ts=ts,
                jp=jp, tp=tp, jt=jt, tt=tt, snaps=snaps, frames=frames,
                draws=draws, final=snapshot(js.state))


def test_slice_initializes_like_jax(run):
    js, ts = run["js"], run["ts"]
    assert ts.is_initialized and js.is_initialized
    assert ts.counter == js.counter == N_FRAMES
    assert ts.n_host == js.n_host
    assert ts.state.n_frames == int(js.state.n_frames)


def test_slice_keyframe_decisions_match_jax(run):
    js, ts = run["js"], run["ts"]
    assert sorted(ts.delta) == sorted(js.delta)
    assert len(ts.delta) > 0
    np.testing.assert_array_equal(ts.tstamps[:ts.n_host],
                                  js.tstamps[:js.n_host])


def test_slice_trajectory_matches_jax(run):
    jp, tp = run["jp"], run["tp"]
    assert tp.shape == jp.shape == (N_FRAMES, 7)
    assert np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=TOL_TRAJ, rtol=0)
    np.testing.assert_array_equal(run["tt"], run["jt"])


@pytest.fixture(scope="module")
def fused_runs(run):
    """The port's DPVO on the fused-correlation route, x32 and x16, over
    the frames and draws of `run`, with a copy terminated after N_PREFIX
    frames."""
    out = {}
    for variant in ("x32", "x16"):
        cfg = TConfig(**TINY, PALLAS_FUSED=True, PALLAS_VARIANT=variant)
        ts = TDPVO(cfg, jax.tree.map(np.asarray, run["params"]), HT, WD,
                   seed=0, device="cpu")
        with one_thread():
            for t, img in enumerate(run["frames"]):
                ts(t, img, INTR, coords=run["draws"][t][0],
                   inv_depths=run["draws"][t][1])
                if t + 1 == N_PREFIX:
                    prefix = terminated_copy(ts)
        out[variant] = (ts.terminate()[0], sorted(ts.delta), prefix)
    return out


@pytest.mark.parametrize("variant", ["x32", "x16"])
def test_fused_slice_matches_jax(run, fused_runs, variant):
    tp, t_kf, _ = fused_runs[variant]
    assert t_kf == sorted(run["js"].delta)
    assert np.isfinite(tp).all() and tp.shape == (N_FRAMES, 7)
    np.testing.assert_allclose(tp, run["jp"], atol=TOL_TRAJ, rtol=0)


@pytest.mark.parametrize("variant", ["x32", "x16"])
def test_fused_slice_matches_unfused(run, fused_runs, variant):
    fp, f_kf = fused_runs[variant][2]
    up, u_kf = run["snaps"]["prefix"]
    assert f_kf == u_kf
    assert fp.shape == (N_PREFIX, 7)
    np.testing.assert_allclose(fp, up, atol=TOL_ROUTES, rtol=0)


def test_slice_edge_table_matches_jax(run):
    """Same live edges, in the same order, after the last frame."""
    snap, st = run["final"], run["ts"].state
    ne = st.n_edges
    assert ne == int(snap["n_edges"])
    for k in ("ii", "jj", "kk", "valid"):
        np.testing.assert_array_equal(getattr(st, k)[:ne].numpy(),
                                      snap[k][:ne])


def test_warmup_duplicate_edges_exist(run):
    """The warm-up appends each accepted frame's factors twice (the JAX
    package's `slam/dpvo.py:294` and `:329-331`); the port keeps the
    duplicates so that the bootstrap matches, and names them here."""
    jsnap, st = run["snaps"]["warmup"]
    ne = st.n_edges
    assert ne == int(jsnap["n_edges"])
    for k in ("ii", "jj", "kk", "valid"):
        np.testing.assert_array_equal(getattr(st, k)[:ne].numpy(),
                                      jsnap[k][:ne])
    v = st.valid[:ne]
    pairs = list(zip(st.kk[:ne][v].tolist(), st.jj[:ne][v].tolist()))
    n_dup = len(pairs) - len(set(pairs))
    cfg = run["tcfg"]
    per_append = (2 * cfg.PATCH_LIFETIME - 1) * cfg.PATCHES_PER_FRAME
    assert ne == 2 * 9 * per_append        # 9 accepted frames, two each
    assert n_dup > 0 and n_dup == len(pairs) // 2


def test_edge_rows_cover_the_warmup():
    """The table holds the warm-up's doubled appends: tiny and default
    keep the config's capacity; fast.yaml needs more than its 17408."""
    tiny = TConfig(**TINY)
    assert tstate.edge_rows(tiny) == tiny.edge_capacity
    fast = TConfig(PATCHES_PER_FRAME=48, REMOVAL_WINDOW=16,
                   OPTIMIZATION_WINDOW=7, PATCH_LIFETIME=11)
    assert fast.edge_capacity == 17408
    assert tstate.edge_rows(fast) == 19456 >= 19 * 21 * 48


def test_runsum_path_matches_dense_path(run, monkeypatch):
    """The slice through the run-sum SoftAgg (the card's path, here
    through the kernel's plain version) gives the trajectory of the
    one-hot path over the warm-up, the bootstrap and two steady frames
    (each SoftAgg call agrees to about 5e-7; later frames cross the BA's
    clamps and masks at other points, so the run stops before them)."""
    n = 12
    out = {}
    for flag in (False, True):
        monkeypatch.setattr(tsteps, "RUNSUM_ON_CPU", flag)
        ts = TDPVO(run["tcfg"], jax.tree.map(np.asarray, run["params"]),
                   HT, WD, device="cpu")
        with one_thread():
            for t, img in enumerate(run["frames"][:n]):
                ts(t, img, INTR, coords=run["draws"][t][0],
                   inv_depths=run["draws"][t][1])
        out[flag] = (ts.terminate()[0], sorted(ts.delta))
    assert out[True][1] == out[False][1]
    np.testing.assert_allclose(out[True][0], out[False][0], atol=TOL_TRAJ,
                               rtol=0)


# ---------------------------------------------------------------------------
# single steps on captured states
# ---------------------------------------------------------------------------

def _net(run):
    return tconvert.jax_params_to_torch(jax.tree.map(np.asarray,
                                                     run["params"]))


def _jstate(snap):
    return jstate.SLAMState(**{k: jnp.asarray(v) for k, v in snap.items()})


def test_update_forward_on_captured_state(run):
    """reproject -> correlate -> update operator on the final state."""
    cfg, tcfg, snap = run["jcfg"], run["tcfg"], run["final"]
    jst = _jstate(snap)
    n = int(snap["n_frames"])
    args = [jst.net, jst.ii, jst.jj, jst.kk, jst.valid, jst.n_frames]
    jnet, jd, jw, jc = jsteps._run_update_net(cfg, run["params"], jst,
                                              *args)
    st = to_port_state(snap, tcfg)
    tnet, td, tw, tc = tsteps._run_update_net(
        tcfg, _net(run), st, st.net, st.ii, st.jj, st.kk, st.valid, n)
    v = snap["valid"]
    for a, b in ((tc, jc), (tnet, jnet), (td, jd), (tw, jw)):
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v],
                                   atol=TOL_STEP, rtol=0)


def test_update_forward_matches_jax_random_inputs(run):
    """update_forward alone, on SLAM-shaped random inputs with neighbour
    links and both SoftAgg groupings."""
    rng = np.random.default_rng(0)
    E, P = 300, 3
    net = rng.normal(size=(E, 384)).astype(np.float32)
    inp = rng.normal(size=(E, 384)).astype(np.float32)
    corr = rng.normal(size=(E, 2 * 49 * P * P)).astype(np.float32)
    kk = rng.integers(0, 40, E)
    jj = rng.integers(0, 10, E)
    valid = rng.random(E) > 0.1
    kk_seg = np.where(valid, kk, 40)
    ij_seg = np.where(valid, (kk // 4) * 11 + jj, 121)
    from wild_video_3d_reconstruction_tpu.ops.segment import neighbors
    ix, jx = map(np.array, neighbors(jnp.asarray(kk), jnp.asarray(jj),
                                       valid=jnp.asarray(valid)))
    ref = jupdate.update_forward(
        run["params"]["update"], *map(jnp.asarray, (
            net, inp, corr, kk_seg, ij_seg, ix, jx, valid)), 41, 122)
    t = torch.from_numpy
    out = tupdate.update_forward(
        _net(run).update, t(net), t(inp), t(corr), t(kk_seg), t(ij_seg),
        t(ix).long(), t(jx).long(), t(valid), 41, 122)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL_STEP, rtol=0)


def test_bundle_adjust_on_captured_state(run):
    """_bundle_adjust_impl on the final state's edges, targets and
    weights, through the per-patch table and the mu*L prior."""
    cfg, snap = run["jcfg"], run["final"]
    n = int(snap["n_frames"])
    M = cfg.PATCHES_PER_FRAME
    t0 = max(n - cfg.OPTIMIZATION_WINDOW, 1)
    m_base = max(n - (cfg.patch_window_frames - 1), 0) * M
    patches_est = snap["patches_est"].copy()
    patches_est[m_base:m_base + 2 * M, 2] = 0.7     # exercise mu * L
    kw = dict(window=cfg.ba_window, patch_slots=cfg.patch_slots,
              iterations=2, per_patch_cap=2 * cfg.PATCH_LIFETIME + 2)
    jp, jz = jba._bundle_adjust_impl(
        *map(jnp.asarray, (snap["poses"], snap["patches"],
                           snap["intrinsics"][0], snap["target"],
                           snap["weight"])), 1e-4,
        *map(jnp.asarray, (snap["ii"], snap["jj"], snap["kk"],
                           snap["valid"])), t0, n, m_base,
        jba.BAConfig(**kw), patches_est=jnp.asarray(patches_est))
    def t(a):
        return torch.from_numpy(np.array(a))

    tp, tz = tba._bundle_adjust_impl(
        t(snap["poses"]), t(snap["patches"]), t(snap["intrinsics"][0]),
        t(snap["target"]), t(snap["weight"]), 1e-4, t(snap["ii"]),
        t(snap["jj"]), t(snap["kk"]), t(snap["valid"]), t0, n, m_base,
        tba.BAConfig(**kw), patches_est=t(patches_est))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL_STEP,
                               rtol=0)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=TOL_STEP,
                               rtol=0)


def _ba_both(snap, cfg, weight, ba_kw, t0=1):
    n = int(snap["n_frames"])
    M = cfg.PATCHES_PER_FRAME
    m_base = max(n - (cfg.patch_window_frames - 1), 0) * M
    arrays = (snap["poses"], snap["patches"], snap["intrinsics"][0],
              snap["target"], weight)
    edges = (snap["ii"], snap["jj"], snap["kk"], snap["valid"])
    jp, jz = jba._bundle_adjust_impl(
        *map(jnp.asarray, arrays), 1e-4, *map(jnp.asarray, edges), t0, n,
        m_base, jba.BAConfig(**ba_kw))
    def t(a):
        return torch.from_numpy(np.array(a))

    tp, tz = tba._bundle_adjust_impl(
        *map(t, arrays), 1e-4, *map(t, edges), t0, n, m_base,
        tba.BAConfig(**ba_kw))
    return (np.asarray(jp), np.asarray(jz)), (tp.numpy(), tz.numpy())


def test_bundle_adjust_dense_accumulation_matches_jax(run):
    """The capless path (depth blocks through a one-hot over all edges
    instead of the per-patch table). Depths within 1e-4 relative: a
    weakly observed patch's step is scaled by Q = 1 / (C + 1e-4)."""
    cfg, snap = run["jcfg"], run["final"]
    (jp, jz), (tp, tz) = _ba_both(snap, cfg, snap["weight"], dict(
        window=cfg.ba_window, patch_slots=cfg.patch_slots))
    np.testing.assert_allclose(tp, jp, atol=TOL_STEP, rtol=0)
    np.testing.assert_allclose(tz, jz, atol=TOL_STEP, rtol=1e-4)


def test_bundle_adjust_failed_cholesky_gives_zero_step(run):
    """Negative weights make the Schur system indefinite: the
    factorisation fails and both packages keep the poses and depths."""
    cfg, snap = run["jcfg"], run["final"]
    (jp, jz), (tp, tz) = _ba_both(snap, cfg, -1e3 * snap["weight"], dict(
        window=cfg.ba_window, patch_slots=cfg.patch_slots,
        per_patch_cap=2 * cfg.PATCH_LIFETIME + 2))
    np.testing.assert_array_equal(tp, snap["poses"])
    np.testing.assert_array_equal(jp, snap["poses"])
    np.testing.assert_allclose(tz, jz, atol=TOL_STEP, rtol=0)


@pytest.mark.parametrize("step", ["append_edges", "retire_and_compact",
                                  "keyframe_shift", "flow_metric",
                                  "update_op"])
def test_step_on_captured_state(run, step):
    jcfg, tcfg, snap = run["jcfg"], run["tcfg"], run["final"]
    jst = _jstate(snap)
    st = to_port_state(snap, tcfg)
    n = int(snap["n_frames"])
    if step == "flow_metric":
        a = jsteps.flow_metric(jcfg, jst, n - 3, n - 1)
        b = tsteps.flow_metric(tcfg, st, n - 3, n - 1)
        np.testing.assert_allclose(float(b), float(a), rtol=1e-5, atol=1e-5)
        return
    if step == "append_edges":
        jst = jst._replace(n_frames=jst.n_frames + 1)
        st.n_frames += 1
        jout, tout = jsteps.append_edges(jcfg, jst), \
            tsteps.append_edges(tcfg, st)
    elif step == "retire_and_compact":
        jst = jst._replace(n_frames=jst.n_frames + 2)
        st.n_frames += 2
        jout = jsteps.retire_and_compact(jcfg, jst)
        tout = tsteps.retire_and_compact(tcfg, st)
    elif step == "keyframe_shift":
        jout, jdp = jsteps.keyframe_shift(jcfg, jst, retire=False)
        tout, tdp = tsteps.keyframe_shift(tcfg, st)
        np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), atol=1e-6)
    else:
        t0 = max(n - jcfg.OPTIMIZATION_WINDOW, 1)
        jout = jsteps.update_op(jcfg, run["params"], jst, t0)
        tout = tsteps.update_op(tcfg, _net(run), st, t0)
    ne = tout.n_edges
    assert ne == int(jout.n_edges) and tout.n_frames == int(jout.n_frames)
    for k in ("ii", "jj", "kk", "valid"):
        np.testing.assert_array_equal(getattr(tout, k)[:ne].numpy(),
                                      np.asarray(getattr(jout, k))[:ne])
    nf = tout.n_frames
    M = jcfg.PATCHES_PER_FRAME
    for k, rows in (("poses", nf), ("patches", nf * M),
                    ("intrinsics", nf)):
        np.testing.assert_allclose(getattr(tout, k)[:rows].numpy(),
                                   np.asarray(getattr(jout, k))[:rows],
                                   atol=TOL_STEP, rtol=0)
    v = np.asarray(jout.valid)[:ne]
    for k in ("net", "target", "weight"):
        np.testing.assert_allclose(getattr(tout, k)[:ne].numpy()[v],
                                   np.asarray(getattr(jout, k))[:ne][v],
                                   atol=TOL_STEP, rtol=0)


def test_tum_export_roundtrip(run, tmp_path):
    path = tmp_path / "traj.txt"
    texport.save_trajectory_tum_format(run["tp"], run["tt"], path)
    poses, ts = texport.load_trajectory_tum_format(path)
    np.testing.assert_allclose(poses, run["tp"], atol=1e-8)
    np.testing.assert_array_equal(ts, run["tt"])
    first = path.read_text().splitlines()[0].split()
    assert len(first) == 8


def test_demo_cli_writes_trajectory(tmp_path):
    """The demo's CLI on an image directory, on the CPU: a TUM file with
    one row per input frame, with --calib and without it (the camera
    calibrated from the images first)."""
    cv2 = pytest.importorskip("cv2")
    imgdir = tmp_path / "images"
    imgdir.mkdir()
    for t, img in enumerate(synthetic_frames(13)):
        cv2.imwrite(str(imgdir / f"{t:04d}.png"), img)
    calib = tmp_path / "calib.txt"
    calib.write_text(" ".join(map(str, INTR)) + "\n")
    opts = []
    for k, v in TINY.items():
        opts += [k, str(v)]
    tdemo.main(["--imagedir", str(imgdir), "--calib", str(calib),
                "--config", "configs/fast.yaml", "--stride", "1",
                "--path", str(tmp_path / "out"), "--save_trajectory",
                "--device", "cpu", "--buffer", "64", "--opts", *opts])
    poses, ts = texport.load_trajectory_tum_format(
        tmp_path / "out" / "saved_trajectories" / "images.txt")
    assert poses.shape == (13, 7) and np.isfinite(poses).all()
    # without --calib the demo calibrates the camera first
    tdemo.main(["--imagedir", str(imgdir), "--config", "configs/fast.yaml",
                "--stride", "1", "--path", str(tmp_path / "auto"),
                "--save_trajectory", "--device", "cpu", "--buffer", "64",
                "--opts", *opts])
    calib = np.loadtxt(tmp_path / "auto" / "estimated_calib.txt")
    assert calib.shape == (4,) and np.isfinite(calib).all()
    assert (tmp_path / "auto" / "calib_confidence.json").exists()
    poses, _ = texport.load_trajectory_tum_format(
        tmp_path / "auto" / "saved_trajectories" / "images.txt")
    assert poses.shape == (13, 7) and np.isfinite(poses).all()
