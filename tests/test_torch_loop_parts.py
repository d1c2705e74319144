"""The loop closure's parts in the port against the JAX package's, on the
same numpy inputs made from seeds.

  ransac_umeyama   one np.random.Generator state for both: the same inlier
                   count, R, t, s within 1e-9 (the same float64 numpy)
  reduce_edges     equal
  keypoints        on two 96x128 rendered frames: detect's positions
                   within 1e-4 px, its scores within 1e-3 relative and the
                   same valid slots; describe within 1e-5; match's pairs
                   and accept flags equal
  vlad_extract     within 1e-5; fit_centers bitwise
  Retrieval        the same pending (i, score, j) lists (scores within
                   1e-6) and candidates through renumbering, deferred
                   saves, NMS and the repetition check
  PGO              perform_updates (its poses relative to the first: an
                   LM with no pose held leaves the global Sim3 to
                   rounding) and run_pgo (which fixes it) on the synthetic
                   loop of `tests/test_loop.py:50` within 1e-4, the JAX
                   package's
                   under `jax.enable_x64` (its first LM step in fp32, the
                   rest in float64; the port runs float64, ROADMAP R10:
                   in fp32 both packages' Jacobians are off by up to 10
                   against float64 there, and their results land 7e-4
                   apart); the dense LM (`perform_updates_device`, here on
                   the CPU) against the host LM as `tests/test_loop.py:245`
                   holds it
  drift gate       equal decisions, its ratios within 1e-5
  dbow             the native backend's best match, score and Hamming
                   pairs equal (the same C++ source)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch import native as tnative
from wild_video_3d_reconstruction_torch.loop import keypoints as tkp
from wild_video_3d_reconstruction_torch.loop import longterm as tlong
from wild_video_3d_reconstruction_torch.loop import netvlad as tvlad
from wild_video_3d_reconstruction_torch.loop import pgo as tpgo
from wild_video_3d_reconstruction_torch.loop import retrieval as tretr
from wild_video_3d_reconstruction_torch.loop import umeyama as tume
from wild_video_3d_reconstruction_torch.ops import lie as tlie
from wild_video_3d_reconstruction_torch.train.synth import render_sequence
from wild_video_3d_reconstruction_tpu import native as jnative
from wild_video_3d_reconstruction_tpu.loop import keypoints as jkp
from wild_video_3d_reconstruction_tpu.loop import longterm as jlong
from wild_video_3d_reconstruction_tpu.loop import netvlad as jvlad
from wild_video_3d_reconstruction_tpu.loop import pgo as jpgo
from wild_video_3d_reconstruction_tpu.loop import retrieval as jretr
from wild_video_3d_reconstruction_tpu.loop import umeyama as jume

TOL_RANSAC = 1e-9
TOL_KP = 1e-4
# the response is the structure tensor's smaller eigenvalue,
# (tr - sqrt(tr^2 - 4 det)) / 2, which cancels: fp32 rounding moves it by
# up to 2.4e-4 relative (measured) where the positions agree within 1e-4
TOL_SCORE = 1e-3
TOL_DESC = 1e-5
TOL_PGO = 1e-4


def random_sim3(rng):
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return R, rng.normal(size=3), float(np.exp(rng.normal() * 0.3))


def test_ransac_umeyama_matches_jax_with_one_generator():
    rng = np.random.default_rng(1)
    R, t, s = random_sim3(rng)
    x = rng.normal(size=(200, 3))
    y = (s * (R @ x.T)).T + t
    out = rng.random(200) < 0.3
    y[out] += rng.normal(size=(out.sum(), 3)) * 5.0
    a = tume.ransac_umeyama(x, y, np.random.default_rng(7), iterations=200,
                            threshold=0.1)
    b = jume.ransac_umeyama(x, y, iterations=200, threshold=0.1,
                            seed=np.random.default_rng(7))
    assert a[3] == b[3] > 100
    for u, v in zip(a[:3], b[:3]):
        np.testing.assert_allclose(u, v, atol=TOL_RANSAC, rtol=0)
    np.testing.assert_allclose(a[0], R, atol=1e-3)
    # fewer than 3 points: nothing to fit
    assert tume.ransac_umeyama(x[:2], y[:2], np.random.default_rng(0))[3] \
        == 0


def test_reduce_edges_matches_jax():
    rng = np.random.default_rng(2)
    ii = rng.integers(0, 60, 300)
    jj = ii + rng.integers(1, 80, 300)
    flow = rng.uniform(0, 50, 300)
    for kw in (dict(max_num_edges=20, nms=3),
               dict(max_num_edges=100, nms=1, min_sep=10)):
        np.testing.assert_array_equal(
            tume.reduce_edges(flow, ii, jj, **kw),
            jume.reduce_edges(flow, ii, jj, **kw))
    assert tume.reduce_edges([], [], [], 5, 2).shape == (0, 2)


@pytest.fixture(scope="module")
def rendered():
    images, _, _ = render_sequence(0, frames=4, ht=96, wd=128, n_planes=3)
    fmap = np.random.default_rng(3).normal(size=(24, 32, 128)) \
        .astype(np.float32)
    return images, fmap


def test_keypoints_match_jax(rendered):
    images, fmap = rendered
    feats = []
    for im in (images[0], images[2]):
        txy, ts = tkp.detect(torch.from_numpy(im), 512)
        jxy, js = jkp.detect(jnp.asarray(im), 512)
        jxy, js = np.asarray(jxy), np.asarray(js)
        np.testing.assert_array_equal(ts.numpy() > 0, js > 0)
        np.testing.assert_allclose(txy.numpy(), jxy, atol=TOL_KP, rtol=0)
        np.testing.assert_allclose(ts.numpy(), js, rtol=TOL_SCORE, atol=0)
        assert (js > 0).sum() > 50
        td = tkp.describe(torch.from_numpy(fmap), txy)
        jd = np.asarray(jkp.describe(jnp.asarray(fmap), jnp.asarray(jxy)))
        np.testing.assert_allclose(td.numpy(), jd, atol=TOL_DESC, rtol=0)
        feats.append((td, ts.numpy() > 0, jd, js > 0))
    (td0, tv0, jd0, jv0), (td1, tv1, jd1, jv1) = feats
    t = tkp.match(td0, td1, torch.from_numpy(tv0), torch.from_numpy(tv1))
    j = jkp.match(jnp.asarray(jd0), jnp.asarray(jd1), jnp.asarray(jv0),
                  jnp.asarray(jv1))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t[2].sum() > 20


def test_vlad_extract_and_fit_centers_match_jax(rendered):
    _, fmap = rendered
    feats = np.random.default_rng(4).normal(size=(3000, 128)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        tvlad.fit_centers(feats, num_clusters=16, seed=0),
        jvlad.fit_centers(feats, num_clusters=16, seed=0))
    centers = tvlad.fit_centers(feats, num_clusters=16, seed=0)
    np.testing.assert_allclose(
        tvlad.vlad_extract(torch.from_numpy(fmap),
                           torch.from_numpy(centers)).numpy(),
        np.asarray(jvlad.vlad_extract(jnp.asarray(fmap),
                                      jnp.asarray(centers))),
        atol=TOL_DESC, rtol=0)
    v = tvlad.VLADDescriptor(centers=centers)
    assert v.dim == 2048 and v.extract(fmap).shape == (2048,)


def _retrieval_script(mod, db):
    """Feed one Retrieval the same frames, evictions, saves and closed
    loops; return its pending lists and candidates along the way."""
    r = mod.Retrieval(db, nms=3, skip_window=4)
    rng = np.random.default_rng(5)
    base = [rng.normal(size=8).astype(np.float32) for _ in range(6)]
    log = []
    for n in range(40):
        # frames revisit the first six places every 12 frames
        desc = base[n % 12] + 0.05 * rng.normal(size=8) if n % 12 < 6 \
            else rng.normal(size=8)
        r.add_frame(n - len([x for x in log if x == "kf"]),
                    desc.astype(np.float32))
        if n % 7 == 3:
            k = max(n - 2 - len([x for x in log if x == "kf"]), 0)
            r.keyframe(k)
            log.append("kf")
        r.save_up_to(n - 3 - len([x for x in log if x == "kf"]))
        log.append(list(r.pending))
        cand = r.detect_loop(thresh=0.3, num_repeat=2 if n > 20 else 1)
        log.append(cand)
        if cand is not None and n % 2:
            r.confirm_loop(*cand)
    return log


def test_retrieval_protocol_matches_jax():
    got = _retrieval_script(tretr, tretr.make_database("vlad", 8))
    want = _retrieval_script(jretr, jretr.make_database("vlad", 8))
    assert len(got) == len(want)
    cands = 0
    for g, w in zip(got, want):
        if isinstance(g, list):
            assert [(i, j) for i, _, j in g] == [(i, j) for i, _, j in w]
            np.testing.assert_allclose([s for _, s, _ in g],
                                       [s for _, s, _ in w], atol=1e-6)
        else:
            assert g == w
            cands += g is not None and g != "kf"
    assert cands > 0
    with pytest.raises(ValueError, match="RETRIEVAL_BACKEND"):
        tretr.make_database("bow", 8)


def test_dbow_backend_matches_jax():
    rng = np.random.default_rng(0)
    base = rng.normal(size=2048).astype(np.float32)
    dbs = (tnative.BinaryRetrieval(rad=4), jnative.BinaryRetrieval(rad=4))
    for i in range(12):
        desc = (base + 0.02 * rng.normal(size=2048).astype(np.float32)
                if i in (0, 10) else rng.normal(size=2048).astype(np.float32))
        for db in dbs:
            db.insert_image(i, desc.reshape(-1, 128))
    for i in range(4, 12):
        (tj, ts, tm), (jj, js, jm) = (db.query(i) for db in dbs)
        assert tj == jj and ts == js
        assert (tm is None) == (jm is None)
        for a, b in zip(tm or (), jm or ()):
            np.testing.assert_array_equal(a, b)
    assert dbs[0].query(10)[0] == 0
    kk, jj = np.array([0, 1, 0, 1, 2]), np.array([3, 2, 1, 0, 1])
    for a, b in zip(tnative.neighbors(kk, jj), jnative.neighbors(kk, jj)):
        np.testing.assert_array_equal(a, b)
    assert tnative.get_lib().edge_capacity(384, 13, 22) == \
        jnative.get_lib().edge_capacity(384, 13, 22)
    # the retrieval protocol over the native database
    retr = tretr.Retrieval(tretr.make_database("dbow", 2048, skip_window=4),
                           nms=2, skip_window=4)
    rng = np.random.default_rng(0)
    base = rng.normal(size=2048).astype(np.float32)
    for i in range(12):
        retr.add_frame(i, base + 0.02 * rng.normal(size=2048)
                       .astype(np.float32) if i in (0, 10) else
                       rng.normal(size=2048).astype(np.float32))
        retr.save_up_to(i)
    assert retr.detect_loop(thresh=0.5, num_repeat=1) == (10, 1)


def synthetic_loop(n, noise, seed):
    """`tests/test_loop.py`'s drifted circle (w2c, fp32), the true relative
    Sim3 between frames (n - 2, 1), its edge, and the true poses."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, n)
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = np.cos(angles)
    xi[:, 1] = np.sin(angles)
    gt = tlie.se3_exp(torch.from_numpy(xi))
    est = [gt[0]]
    for k in range(1, n):
        rel = tlie.se3_mul(gt[k], tlie.se3_inv(gt[k - 1]))
        dn = torch.zeros(6)
        dn[:3] = torch.from_numpy(noise * rng.normal(size=3)).float()
        est.append(tlie.se3_mul(tlie.se3_mul(tlie.se3_exp(dn), rel),
                                est[-1]))
    est = torch.stack(est).numpy()
    i, j = n - 2, 1
    C = tlie.se3_to_sim3(tlie.se3_mul(gt[j], tlie.se3_inv(gt[i]))).numpy()
    return est, C[None], np.array([i]), np.array([j]), gt.numpy()


def test_pgo_matches_jax():
    est, C, ii, jj, gt = synthetic_loop(40, 0.02, 2)
    c2w = tlie.se3_inv(torch.from_numpy(est)).numpy()
    with jax.enable_x64(True):
        want_updates = jpgo.perform_updates(c2w, C, ii, jj)
        want = jpgo.run_pgo(est, C, ii, jj)

    def gauge_free(c2w_sim3):
        x = torch.from_numpy(np.asarray(c2w_sim3, np.float64))
        return tlie.sim3_mul(tlie.sim3_inv(x[:1]).expand_as(x), x).numpy()

    np.testing.assert_allclose(
        gauge_free(tpgo.perform_updates(c2w, C, ii, jj)),
        gauge_free(want_updates), atol=TOL_PGO, rtol=0)
    got = tpgo.run_pgo(est, C, ii, jj)
    assert got.shape == want.shape == (ii[0] + 1, 8)
    np.testing.assert_allclose(got, want, atol=TOL_PGO, rtol=0)
    # the loop's gap at least halves (as tests/test_loop.py holds the JAX
    # PGO)
    fixed = est.copy()
    fixed[:len(got)] = tlie.se3_inv(
        torch.from_numpy(got[:, :7]).float()).numpy()

    def gap(w2c):
        p, g = (tlie.se3_inv(torch.from_numpy(a)).numpy() for a in (w2c, gt))
        return abs(np.linalg.norm(p[ii[0], :3] - p[jj[0], :3]) -
                   np.linalg.norm(g[ii[0], :3] - g[jj[0], :3]))
    assert gap(fixed) < 0.5 * gap(est)


def test_dense_lm_matches_host_lm():
    """As `tests/test_loop.py:245`: both LMs satisfy the loop constraint
    within 0.05 and within 0.05 of each other."""
    est, C, ii, jj, _ = synthetic_loop(24, 0.03, 5)
    c2w = tlie.se3_inv(torch.from_numpy(est)).numpy()
    host = tpgo.perform_updates(c2w, C, ii, jj, iters=25)
    dev = tpgo.perform_updates_device(c2w, C, ii, jj, iters=25,
                                      device="cpu")

    def loop_residual(sim3_c2w):
        w2c = tlie.sim3_inv(torch.from_numpy(sim3_c2w))
        C0 = torch.from_numpy(C[0]).double()
        r = tlie.sim3_log(tlie.sim3_mul(C0, tlie.sim3_mul(
            w2c[ii[0]], tlie.sim3_inv(w2c[jj[0]]))))
        return float(torch.linalg.norm(r))

    rh, rd = loop_residual(host), loop_residual(dev)
    assert rd < 0.05 and abs(rh - rd) < 0.05, (rh, rd)


def test_drift_gate_matches_jax():
    n, i, j = 12, 10, 1
    poses = np.zeros((n, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, 0] = -np.arange(n, dtype=np.float32)
    vo_rel = tlie.se3_to_sim3(tlie.se3_mul(
        torch.from_numpy(poses[j]),
        tlie.se3_inv(torch.from_numpy(poses[i])))).numpy()
    shifted, scaled = vo_rel.copy(), vo_rel.copy()
    shifted[0] += 0.1 * (i - j)
    scaled[7] *= 1.05
    for meas in (vo_rel, shifted, scaled):
        for gate in (0.02, 0.2):
            a = tlong.drift_gate_consistent(meas, poses, i, j, gate)
            b = jlong.drift_gate_consistent(meas, poses, i, j, gate)
            assert a[0] == b[0]
            np.testing.assert_allclose(a[1:], b[1:], atol=1e-5, rtol=0)
    assert tlong.drift_gate_consistent(vo_rel, poses, i, j, 0.02)[0]
    assert not tlong.drift_gate_consistent(shifted, poses, i, j, 0.02)[0]
