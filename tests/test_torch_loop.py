"""The long-term loop closure in the port (`loop/longterm.py`, its hooks in
`slam/dpvo.py`) against the JAX package's, on the CPU.

The scene: two laps of `render_sequence(path="multiloop")` at 96x128 (frame
t and t + LAP see one waypoint), the trained weights
(`weights/vonet_synth_tpu_r3_step2000.pth`, carried back into the JAX
package's parameter tree: the orbax checkpoint it was exported from,
tensor for tensor, `tests/test_torch_weights.py`), every frame kept, fp32
features;
the port gets the JAX run's patch centres and inverse depths and its VLAD
centres (jax.random cannot be reproduced in torch). Both loop closures
cache their keyframes as JPEG-95 (cv2, the same bytes) and find their
keypoints on the decoded frames; the JAX one draws RANSAC samples from
the same numpy generator as the port (R9).

  components   the whole loop's JAX run, its replayed state before
               terminate carried into a new port DPVO and given to a new
               JAX loop closure (one JAX run serves both checks, and its
               final closure reuses the BA and PGO compiled here): the
               3-D keypoints of a frame within 1e-3 relative; close_loop
               on the revisit the run closes, with LOOP_DRIFT_GATE 0: the
               same decision and, after its PGO, poses within 1e-4 and
               patch depths within 1e-4 relative
  whole loop   the asynchronous run (the port eager on the CPU; JAX
               draining its device logs every LC_INTERVAL = 4 frames): the
               same stored descriptor rows (cosine > 0.999), the same
               retrieval pending lists, candidates, closures and counters,
               the trajectory within the slice's 1e-2
  async/sync   the port's asynchronous run against its `sync_mode` run as
               `tests/test_loop_async.py` holds the JAX package's
               (descriptors, cache keys, bookkeeping), at the SLAM smoke
               test's size with weights from a seed
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.loop.netvlad import \
    VLADDescriptor as TVLAD
from wild_video_3d_reconstruction_torch.models.convert import \
    load_reference_checkpoint
from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.train.synth import render_sequence
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.loop import longterm as jlong
from wild_video_3d_reconstruction_tpu.loop.cache import ImageCache
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.slam import DPVO as JDPVO
from wild_video_3d_reconstruction_tpu.slam import state as jstate
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

from test_torch_slam import HT as SMALL_HT, INTR as SMALL_INTR, TINY, \
    WD as SMALL_WD, one_thread, synthetic_frames

WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / \
    "vonet_synth_tpu_r3_step2000.pth"
HT, WD = 96, 128
FRAMES = 24
LAP = FRAMES // 2
CFG = dict(TINY, BUFFER_SIZE=FRAMES + 8, KEYFRAME_THRESH=0.0,
           loop_enabled=True, LOOP_SKIP_WINDOW=LAP // 2,
           LOOP_CLOSE_WINDOW_SIZE=1, LOOP_RETR_THRESH=0.5,
           LOOP_MIN_INLIERS=12, LC_INTERVAL=4)
TOL_POINTS = 1e-3
TOL_PGO = 1e-4
TOL_TRAJ = 1e-2
TOL_DESC_COS = 0.999
RANSAC_SEED = 0           # the port's default: the DPVO seed
PAIR = (LAP - 1, 1)       # the revisit the run closes (on JPEG-95 frames)


def jax_tree(path):
    """A DPVO .pth as the JAX package's parameter tree (nested dicts of
    numpy arrays): `jax_params_to_torch` inverted (OIHW -> HWIO,
    [out, in] -> [in, out], module paths as tree paths)."""
    tree = {}
    for name, t in load_reference_checkpoint(path).state_dict().items():
        a = t.numpy()
        if name.endswith("weight") and a.ndim in (2, 4):
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        *keys, leaf = name.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


@pytest.fixture(scope="module")
def scene():
    images, _, intr = render_sequence(0, frames=FRAMES, ht=HT, wd=WD,
                                      path="multiloop", n_planes=3)
    params = jax_tree(WEIGHTS)
    rng = jax.random.PRNGKey(0)
    draws = []
    for _ in range(FRAMES):
        rng, k_sel, k_depth = jax.random.split(rng, 3)
        draws.append((np.asarray(jvonet.select_patches(
            k_sel, CFG["PATCHES_PER_FRAME"], HT // 4, WD // 4)),
            np.asarray(jax.random.uniform(k_depth,
                                          (CFG["PATCHES_PER_FRAME"],)))))
    return list(images), np.asarray(intr, np.float64), params, draws


def jax_run(scene):
    """The JAX package's asynchronous run with its loop closure (RANSAC
    from the shared generator); returns (slam, lc, recorder). Its cache
    encodes at the commit (`async_encode=False`): the JAX closure checks a
    frame's presence on the encoded bytes, so with its encoder thread the
    candidates it takes hang on that thread's progress; the port checks
    the commit (ROADMAP R8), which is what the synchronous cache shows."""
    images, intr, params, _ = scene
    cfg = JConfig(**CFG)
    slam = JDPVO(cfg, params, HT, WD, seed=0, sync_mode=False)
    slam.state = jstate.init_state(cfg, HT, WD, feat_dtype=jnp.float32,
                                   seed=0)
    lc = jlong.LongTermLoopClosure(cfg, slam)
    lc.imcache = ImageCache(async_encode=False)
    slam.loop_closure = lc
    rec = record(lc)
    for t, img in enumerate(images):
        slam(t, img, intrinsics=intr)
    return slam, lc, rec


def port_run(scene, centers):
    """The port's asynchronous run (eager on the CPU) on the JAX run's
    draws and VLAD centres."""
    images, intr, params, draws = scene
    slam = TDPVO(TConfig(**CFG), params, HT, WD, seed=0, device="cpu",
                 sync_mode=False, vlad=TVLAD(centers=centers))
    rec = record(slam.loop_closure)
    with one_thread():
        for t, img in enumerate(images):
            slam(t, img, intr, coords=draws[t][0], inv_depths=draws[t][1])
    return slam, slam.loop_closure, rec


def record(lc):
    """Wrap the retrieval's detect_loop (its pending list before, the
    candidate after) and close_loop (i, j, result)."""
    rec = {"detect": [], "close": []}
    detect, close = lc.retrieval.detect_loop, lc.close_loop

    def detect_loop(**kw):
        before = [(i, j) for i, _, j in lc.retrieval.pending]
        scores = [s for _, s, _ in lc.retrieval.pending]
        out = detect(**kw)
        rec["detect"].append((before, scores, out))
        return out

    def close_loop(i, j, n):
        out = close(i, j, n)
        rec["close"].append((i, j, out))
        return out

    lc.retrieval.detect_loop = detect_loop
    lc.close_loop = close_loop
    return rec


@pytest.fixture(scope="module", autouse=True)
def shared_ransac(monkeypatch_module):
    """The JAX close_loop's RANSAC draws from a generator seeded as the
    port's (the JAX package's draws fresh entropy on every call)."""
    gen = {}
    ransac = jlong.ransac_umeyama

    def seeded(src, dst, **kw):
        return ransac(src, dst, seed=gen["g"], **kw)

    monkeypatch_module.setattr(jlong, "ransac_umeyama", seeded)
    return gen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


# ------------------------------------------------------------ the runs

@pytest.fixture(scope="module")
def runs(scene, shared_ransac):
    """Both packages' asynchronous runs. Between the JAX run's last frame
    and its terminate, the component checks run on its replayed state,
    which they leave as it was; then both runs terminate, each drawing
    RANSAC samples from a new generator seeded alike."""
    shared_ransac["g"] = np.random.default_rng(RANSAC_SEED)
    js, jlc, jrec = jax_run(scene)
    ts, tlc, trec = port_run(scene, np.asarray(jlc.vlad.centers))
    js._replay_log()                # as terminate does first
    comp = component_checks(scene, js, jlc.vlad, shared_ransac)
    shared_ransac["g"] = np.random.default_rng(RANSAC_SEED)
    jp, _ = js.terminate()
    tp, _ = ts.terminate()
    whole = dict(js=js, jlc=jlc, jrec=jrec, jp=jp, ts=ts, tlc=tlc,
                 trec=trec, tp=tp)
    return whole, comp


def component_checks(scene, js, vlad, shared_ransac):
    """The JAX run's state carried into a new port DPVO; a new loop closure
    on each side (no past loops, the drift gate off) with every frame
    cached; then estimate_3d_keypoints and close_loop on both, on the pair
    that the run's retrieval proposes at terminate (so the JAX run's final
    closure reuses the BA and PGO compiled here). The JAX state and
    delta chain are restored afterwards."""
    images, intr, params, _ = scene
    over = dict(LOOP_DRIFT_GATE=0.0, LOOP_RETR_THRESH=2.0)
    n = js.n_host
    # every frame is a keyframe: keyframe k is input frame k
    np.testing.assert_array_equal(js.tstamps[:n], np.arange(n))
    saved = js.state, dict(js.delta)
    jlc = jlong.LongTermLoopClosure(JConfig(**dict(CFG, **over)), js,
                                    vlad=vlad)
    jlc.imcache = ImageCache(async_encode=False)
    for k in range(n):
        jlc.imcache._encode(k, images[k])
    cfg = TConfig(**dict(CFG, **over))
    ts = TDPVO(cfg, params, HT, WD, seed=0, device="cpu", sync_mode=True,
               vlad=TVLAD(centers=np.asarray(vlad.centers)))
    snap = {k: np.asarray(v) for k, v in js.state._asdict().items()}
    st = ts.state
    for name in ("poses", "patches", "patches_est", "intrinsics", "colors",
                 "imap", "gmap", "fmap1", "fmap2", "ii", "jj", "kk", "valid",
                 "net", "target", "weight"):
        getattr(st, name).copy_(torch.from_numpy(np.array(snap[name])).to(
            getattr(st, name).dtype))
    st.n_frames, st.n_edges = int(snap["n_frames"]), int(snap["n_edges"])
    ts.n_host, ts.counter = js.n_host, js.counter
    ts.tstamps[:] = js.tstamps
    tlc = ts.loop_closure
    for k in range(n):
        tlc.imcache._encode(k, images[k])
    assert tlc.imcache.saved == jlc.imcache.saved      # the same JPEG bytes
    out = {"n": n}
    i, j = PAIR
    with one_thread():
        out["kp"] = (tlc.estimate_3d_keypoints(i),
                     jlc.estimate_3d_keypoints(i))
        shared_ransac["g"] = np.random.default_rng(RANSAC_SEED)
        tlc.rng = np.random.default_rng(RANSAC_SEED)
        before = st.poses.clone()
        out["close"] = (tlc.close_loop(i, j, n), jlc.close_loop(i, j, n))
    out["poses"] = (st.poses[:n].numpy(), np.asarray(js.state.poses[:n]))
    M = cfg.PATCHES_PER_FRAME
    out["depths"] = (st.patches[:n * M, 2].numpy(),
                     np.asarray(js.state.patches[:n * M, 2]))
    out["moved"] = float((st.poses - before).abs().max())
    out["events"] = tlc.events
    js.state, js.delta = saved
    return out


@pytest.fixture(scope="module")
def components(runs):
    return runs[1]


def test_estimate_3d_keypoints_matches_jax(components):
    (tp, tf), (jp, jf) = components["kp"]
    assert tf is not None and jf is not None
    assert tp.shape == jp.shape and tp.shape[0] >= CFG["LOOP_MIN_INLIERS"]
    np.testing.assert_allclose(tp, jp, rtol=TOL_POINTS,
                               atol=TOL_POINTS * np.abs(jp).max())
    np.testing.assert_allclose(tf["xy"], jf["xy"], atol=1e-4, rtol=0)


def test_close_loop_and_pgo_write_back_match_jax(components):
    tr, jr = components["close"]
    assert tr == jr is True
    assert components["events"][-1] == ("applied",) + PAIR
    assert components["moved"] > 0
    tp, jp = components["poses"]
    np.testing.assert_allclose(tp, jp, atol=TOL_PGO, rtol=0)
    td, jd = components["depths"]
    np.testing.assert_allclose(td, jd, rtol=TOL_PGO, atol=0)


# ------------------------------------------------------------ whole loop

@pytest.fixture(scope="module")
def whole(runs):
    return runs[0]


def test_whole_loop_descriptors_match_jax(whole):
    da, db = whole["tlc"].retrieval.db, whole["jlc"].retrieval.db
    stored = np.where(db.has)[0]
    np.testing.assert_array_equal(np.where(da.has)[0], stored)
    assert stored.size >= FRAMES - 2
    for n in stored:
        cos = float(np.dot(da.descs[n], db.descs[n]) /
                    np.linalg.norm(da.descs[n]) / np.linalg.norm(db.descs[n]))
        assert cos > TOL_DESC_COS, (n, cos)
    assert whole["ts"]._events_consumed > 0        # drained during the run


def test_whole_loop_retrieval_and_closures_match_jax(whole):
    t, j = whole["trec"], whole["jrec"]
    assert (PAIR + (True,)) in j["close"]          # the components' pair
    assert [(p, c) for p, _, c in t["detect"]] == \
        [(p, c) for p, _, c in j["detect"]]
    for (_, ts_, _), (_, js_, _) in zip(t["detect"], j["detect"]):
        np.testing.assert_allclose(ts_, js_, atol=1e-3)
    assert t["close"] == j["close"]
    assert len(t["close"]) > 0                     # candidates verified
    tlc, jlc = whole["tlc"], whole["jlc"]
    assert (tlc.lc_count, tlc.lc_consistent) == \
        (jlc.lc_count, jlc.lc_consistent)


def test_whole_loop_trajectory_matches_jax(whole):
    tp, jp = whole["tp"], whole["jp"]
    assert tp.shape == jp.shape == (FRAMES, 7) and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=TOL_TRAJ, rtol=0)


# ------------------------------------------------- async against sync

SMALL = dict(TINY, loop_enabled=True, LC_INTERVAL=2)
N_SMALL = 14          # 4 steady frames: two drains during the run


@functools.cache
def port_small(sync_mode, thresh, n_frames=N_SMALL):
    """The port's run at the SLAM smoke test's size (one run for each set
    of arguments: the pair's asynchronous always-evict run also serves the
    write-back test, which leaves what the pair compares as it was)."""
    cfg = TConfig(**dict(SMALL, KEYFRAME_THRESH=thresh))
    slam = TDPVO(cfg, None, SMALL_HT, SMALL_WD, seed=0, device="cpu",
                 sync_mode=sync_mode)
    with one_thread():
        for t, img in enumerate(synthetic_frames(n_frames)):
            slam(t, img, SMALL_INTR)
        if not sync_mode:
            slam._replay_log()
            slam.loop_closure.attempt_loop_closure(slam.n_host)
    return slam, slam.loop_closure


@pytest.fixture(scope="module", params=[1e9, 0.0],
                ids=["always-evict", "never-evict"])
def pair(request):
    return port_small(False, request.param), port_small(True, request.param)


def test_async_does_not_force_sync(pair):
    (slam, _), _ = pair
    assert slam.sync_mode is False
    assert slam.runner.centers is not None
    assert slam._events_consumed > 0


def test_async_descriptors_match_sync(pair):
    (_, la), (_, lb) = pair
    da, db = la.retrieval.db, lb.retrieval.db
    stored = np.where(da.has)[0]
    np.testing.assert_array_equal(stored, np.where(db.has)[0])
    assert stored.size > 0
    for n in stored:
        assert float(np.dot(da.descs[n], db.descs[n])) > 0.99, n


def test_async_image_cache_matches_sync(pair):
    """The JPEG-95 encodings run in the cache's worker thread: flushed
    first, as `tests/test_loop_async.py` reads the JAX caches."""
    (a, la), (_, lb) = pair
    la.imcache.flush()
    lb.imcache.flush()
    assert set(la.imcache.saved) == set(lb.imcache.saved)
    if not a.delta:
        assert len(la.imcache.saved) > 0
    for n in la.imcache.saved:
        assert la.imcache.saved[n] == lb.imcache.saved[n], n


def test_async_bookkeeping_matches_sync(pair):
    (a, _), (b, _) = pair
    pa, _ = a.terminate()
    pb, _ = b.terminate()
    assert a.n_host == b.n_host
    np.testing.assert_array_equal(a.tstamps[:a.n_host], b.tstamps[:b.n_host])
    assert set(a.delta) == set(b.delta)
    assert pa.shape == (N_SMALL, 7) and np.isfinite(pa).all()


def test_apply_pgo_result_rescales_in_place():
    """A uniform scale of 2 from the PGO keeps the poses and halves the
    depths, writing into the state's own tensors (the captured graphs'
    addresses), as `tests/test_loop_integration.py` holds the JAX one."""
    slam, lc = port_small(False, 1e9)
    n, M = slam.n, slam.M
    ptr = (slam.state.poses.data_ptr(), slam.state.patches.data_ptr())
    poses = slam.state.poses[:n].clone()
    depths = slam.state.patches[:n * M, 2, 1, 1].clone()
    from wild_video_3d_reconstruction_torch.ops import lie
    c2w = lie.se3_inv(poses).numpy()
    lc.apply_pgo_result(np.concatenate([c2w, 2 * np.ones((n, 1))], axis=1))
    assert (slam.state.poses.data_ptr(), slam.state.patches.data_ptr()) \
        == ptr
    torch.testing.assert_close(slam.state.patches[:n * M, 2, 1, 1],
                               depths / 2, rtol=1e-6, atol=0)
    torch.testing.assert_close(slam.state.poses[:n], poses, atol=1e-5,
                               rtol=0)
    assert all(np.isfinite(dP).all() for _, dP in slam.delta.values())

