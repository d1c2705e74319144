"""The wild-video inputs (depth prior, dynamic mask, keypoint patches) of
the port's frame insertion against the JAX package, on the CPU.

* `insert_frame` on one state captured from a JAX run over the rendered
  wild input (`eval/synth_ate.py:wild_sequence`: a walk with a moving
  occluder, its mask and the world's depth), for depth only, depth +
  mask, mask only and an all-masked frame, initialized and not: the new
  frame's `patches` and `patches_est` rows within 1e-5 relative (the
  prior is 1 / a median of depth samples; the same fp32 arithmetic in
  another order), NaN where JAX gives NaN; the centres exactly.
* The mask selection and the keypoint selection given the JAX draws:
  exactly the JAX centres, in the JAX order. The keypoint response map
  within 1e-4 of its largest value (fp32 window sums in another order),
  and on the rendered frames the port's own map selects the JAX centres.
  Ties among positive responses: the port sorts stably, so the lower flat
  index comes first, as `lax.top_k` documents; a map with ties checks it.
* `PIPELINE_CHUNK: 4` over frames whose signature (depth, mask) changes
  part way equals the eager frame-by-frame run (as
  `tests/test_torch_steady.py` holds chunk 4 = 1, within 5e-4), and every
  chunk it dispatched has one signature.

The whole loops with these inputs are in `tests/test_torch_wild_loops.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.models.convert import \
    jax_params_to_torch
from wild_video_3d_reconstruction_torch.models import vonet as tvonet
from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.slam import graphs as tgraphs
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.slam import steps as jsteps
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

from test_torch_slam import HT, TINY, WD, one_thread, snapshot, to_port_state
from test_torch_steady import TOL_CHUNK
from test_torch_synth_ate import jax_run

N_FRAMES = 13
TOL_PRIOR = 1e-5
TOL_MAP = 1e-4
M = TINY["PATCHES_PER_FRAME"]


@pytest.fixture(scope="module")
def wild():
    images, _, intr, depths, masks = tsynth_ate.wild_sequence(
        0, frames=N_FRAMES + 2, ht=HT, wd=WD, fx=40.0, fy=40.0)
    return images, intr, depths, masks


@pytest.fixture(scope="module")
def captured(wild):
    """A JAX state after N_FRAMES wild frames with depth and mask (the
    bootstrap included), the seed-0 random weights."""
    images, intr, depths, masks = wild
    cfg = JConfig(**TINY)
    params = jvonet.init_vonet(jax.random.PRNGKey(0))
    inputs = list(zip(depths, masks))
    _, _, js = jax_run(params, (images[:N_FRAMES], intr), cfg, inputs)
    return dict(cfg=cfg, params=params, snap=snapshot(js.state))


def key_draws(key, n_cand, jitter):
    """The port's draw arguments for JAX `insert_frame(key=key)`."""
    k_sel, k_depth = jax.random.split(key)
    kx, ky, kr = jax.random.split(k_sel, 3)
    h, w = HT // 4, WD // 4
    x = np.asarray(jax.random.randint(kx, (n_cand,), 1, w - 1))
    y = np.asarray(jax.random.randint(ky, (n_cand,), 1, h - 1))
    out = dict(cand=np.stack([x, y], -1).astype(np.float32),
               inv_depths=np.asarray(jax.random.uniform(k_depth, (M,))))
    if jitter:
        out["jitter"] = np.asarray(jax.random.uniform(kr, (n_cand,)))
    return out


CASES = {
    "depth": (True, False, False),
    "depth_mask": (True, True, False),
    "mask": (False, True, False),
    "all_masked": (True, True, True),
}


@pytest.mark.parametrize("initialized", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_insert_frame_matches_jax(captured, wild, case, initialized):
    has_depth, has_mask, all_masked = CASES[case]
    images, intr, depths, masks = wild
    f = N_FRAMES
    depth = depths[f] if has_depth else None
    mask = None
    if has_mask:
        mask = np.zeros_like(masks[f]) if all_masked else masks[f]
    cfg, snap = captured["cfg"], captured["snap"]
    key = jax.random.PRNGKey(7)

    jst = jsteps.SLAMState(**{k: jnp.asarray(v) for k, v in snap.items()})
    jout = jsteps.insert_frame(
        cfg, captured["params"], jst, jnp.asarray(images[f]),
        jnp.asarray(intr), key, 1.0, None,
        depth=None if depth is None else jnp.asarray(depth),
        mask=None if mask is None else jnp.asarray(mask),
        initialized=initialized)

    tcfg = TConfig(**TINY)
    st = to_port_state(snap, tcfg)
    n_cand, jitter = tsteps.candidates(tcfg, has_mask)
    d = key_draws(key, n_cand, jitter)
    cand, given, inv, jit = tsteps.draw_inputs(
        tcfg, st, HT, WD, cand=d["cand"], jitter=d.get("jitter"),
        inv_depths=d["inv_depths"], has_mask=has_mask)
    net = jax_params_to_torch(jax.tree.map(np.asarray, captured["params"]))
    tsteps.insert_frame(tcfg, net, st, tsteps.FrameInputs(
        torch.from_numpy(images[f]), torch.tensor(intr).float(),
        torch.tensor(1.0), cand, given, inv, jit,
        None if depth is None else torch.from_numpy(depth),
        None if mask is None else torch.from_numpy(mask)),
        initialized=initialized)

    n = int(snap["n_frames"])
    rows = slice(n * M, (n + 1) * M)
    jp = np.asarray(jout.patches)[rows]
    tp = st.patches[rows].numpy()
    np.testing.assert_array_equal(tp[:, :2], jp[:, :2])
    np.testing.assert_allclose(tp, jp, rtol=TOL_PRIOR, atol=0,
                               equal_nan=True)
    je = np.asarray(jout.patches_est)[rows]
    np.testing.assert_allclose(st.patches_est[rows].numpy(), je,
                               rtol=TOL_PRIOR, atol=0, equal_nan=True)
    if has_depth:
        np.testing.assert_array_equal(np.isnan(tp[:, 2]),
                                      np.isnan(jp[:, 2]))
        # an all-masked frame aligns to a NaN scale only once initialized
        assert np.isnan(tp[:, 2]).all() == (all_masked and initialized)
        np.testing.assert_allclose(je, jp, rtol=0, atol=0, equal_nan=True)
    else:
        assert not je.any() and not st.patches_est[rows].any()


def test_mask_selection_matches_jax_given_its_draws(wild):
    masks = wild[3]
    h, w = HT // 4, WD // 4
    for i in range(6):
        mask = masks[i] if i < 5 else np.zeros_like(masks[0])
        key = jax.random.PRNGKey(100 + i)
        want = jvonet.select_patches(key, M, h, w, mask=jnp.asarray(mask))
        kx, ky, kr = jax.random.split(key, 3)
        x = jax.random.randint(kx, (4 * M,), 1, w - 1)
        y = jax.random.randint(ky, (4 * M,), 1, h - 1)
        cand = torch.from_numpy(np.stack([np.asarray(x), np.asarray(y)], -1)
                                .astype(np.float32))
        jit = torch.from_numpy(np.array(jax.random.uniform(kr, (4 * M,))))
        got = tvonet.top_by_mask(cand, jit, M, torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if i < 5:   # every chosen centre is off the occluder when it can be
            ok = mask[4 * got[:, 1].long().numpy(), 4 * got[:, 0].long()
                      .numpy()]
            assert ok.all()


def test_keypoint_map_matches_jax(wild):
    for image in wild[0][:4]:
        want = np.asarray(jvonet.keypoint_response_map(jnp.asarray(image)))
        got = tvonet.keypoint_response_map(torch.from_numpy(image)).numpy()
        assert got.shape == want.shape == ((HT - 1) // 4, (WD - 1) // 4)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL_MAP * np.abs(want).max())


def _jax_keypoints(key, kmap):
    return np.asarray(jvonet.select_patches(
        key, M, HT // 4, WD // 4, keypoint_map=jnp.asarray(kmap)))


def _fallback(key):
    kx, ky, _ = jax.random.split(key, 3)
    x = jax.random.randint(kx, (M,), 1, WD // 4 - 1)
    y = jax.random.randint(ky, (M,), 1, HT // 4 - 1)
    return torch.from_numpy(np.stack([np.asarray(x), np.asarray(y)], -1)
                            .astype(np.float32))


def test_keypoint_selection_matches_jax_given_its_map(wild):
    """The JAX map through the port's selection: the JAX centres exactly,
    on rendered frames, on a map with ties among positive responses, and
    on one with fewer positive responses than slots (fallback)."""
    gh, gw = (HT - 1) // 4, (WD - 1) // 4
    rng = np.random.default_rng(3)
    tied = np.zeros((gh, gw), np.float32)
    tied[rng.integers(0, gh, 12), rng.integers(0, gw, 12)] = 2.0
    tied[0, :3] = 5.0                   # ties at the clipped border too
    sparse = np.zeros((gh, gw), np.float32)
    sparse[4, 5], sparse[7, 2] = 3.0, 1.0
    maps = [np.asarray(jvonet.keypoint_response_map(jnp.asarray(im)))
            for im in wild[0][:3]] + [tied, sparse]
    for i, kmap in enumerate(maps):
        key = jax.random.PRNGKey(200 + i)
        got = tvonet.top_keypoints(torch.from_numpy(kmap), M, HT // 4,
                                   WD // 4, _fallback(key))
        np.testing.assert_array_equal(got.numpy(), _jax_keypoints(key, kmap))


def test_keypoint_selection_on_frames_matches_jax(wild):
    """The port's own map and selection on rendered frames choose the JAX
    centres."""
    cfg = TConfig(**TINY, PATCH_SELECTOR="keypoints")
    for i, image in enumerate(wild[0][:6]):
        key = jax.random.PRNGKey(300 + i)
        want = _jax_keypoints(
            key, jvonet.keypoint_response_map(jnp.asarray(image)))
        inputs = tsteps.FrameInputs(
            torch.from_numpy(image), None, None, _fallback(key),
            torch.tensor(False), None)
        got = tsteps.select_centres(cfg, inputs.image, inputs, HT // 4,
                                    WD // 4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_run_with_signature_changes_matches_eager(wild,
                                                          monkeypatch):
    """PIPELINE_CHUNK 4 over steady frames whose inputs switch between
    none, depth + mask and mask only: equal to chunk 1, and each chunk
    the runner got held one signature."""
    images, intr, depths, masks = wild
    sigs = []
    run = tgraphs.StepRunner.run

    def spy(self, rows):
        sigs.append({tsteps.signature(r.depth, r.mask) for r in rows})
        return run(self, rows)

    monkeypatch.setattr(tgraphs.StepRunner, "run", spy)
    pattern = ["", "", "dm", "dm", "dm", "m", "", "dm"]
    out = {}
    for chunk in (1, 4):
        sigs.clear()
        cfg = TConfig(**TINY, PIPELINE_CHUNK=chunk)
        slam = TDPVO(cfg, None, HT, WD, device="cpu")
        with one_thread():
            for t in range(len(images)):
                kind = pattern[t % len(pattern)] if t >= 10 else "dm"
                slam(t, images[t], intr,
                     depth=depths[t] if "d" in kind else None,
                     mask=masks[t] if "m" in kind else None)
            out[chunk] = (slam.terminate()[0], sorted(slam.delta))
        assert all(len(s) == 1 for s in sigs)
        if chunk == 4:
            # the signature changes flushed the partial chunks
            assert len(sigs) > (len(images) - 10) // 4
    np.testing.assert_allclose(out[4][0], out[1][0], atol=TOL_CHUNK, rtol=0)
    assert out[4][1] == out[1][1]
