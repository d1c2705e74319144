"""The accuracy drivers on rendered worlds in the port (`eval/synth_suite`,
`eval/calib_sensitivity`, `eval/loop_recall`, `eval/matcher_recall`)
against the JAX package's, on the CPU.

The synthetic ATE is chaotic in rounding over 60 frames (PERF.md
section 2), so `run_suite` and `run_sweep` are held on short runs (12
frames) fed the JAX runs' draws (`test_torch_synth_ate.jax_raw_draws`),
with the trained weights on both sides (the JAX tree carried from the
`.pth`), in fp32 with the port's edge rows (ROADMAP R4, R6): per-scene
medians within TOL_ATE and floors within TOL_FLOOR, as
`test_torch_synth_ate.py` holds one run. `run_oracle` (18 frames, no
network) at 0% and 5% focal error, the port fed the JAX run's draws:
within TOL_ORACLE of JAX's, and the JAX pins (< 5e-3 at 0%, < 0.05 at
5%, 5% above 0%). `build_frames` bitwise; loop recall on 20 frames at
48x64 with JAX's `init_vonet(PRNGKey(0))` and its VLAD centres carried
across (random and fitted centres): the same hits; `run_pair` on the
JAX test's seed-1001 pair (delta 6, hardened) with the trained weights:
the same counts, and the JAX pins (recall > 0.85, precision > 0.6).
"""

import contextlib
import inspect
import io
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.eval import calib_sensitivity as tcs
from wild_video_3d_reconstruction_torch.eval import loop_recall as tlr
from wild_video_3d_reconstruction_torch.eval import matcher_recall as tmr
from wild_video_3d_reconstruction_torch.eval import synth_suite as tss
from wild_video_3d_reconstruction_torch.models.convert import as_vonet
from wild_video_3d_reconstruction_torch.slam import state as tstate
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.eval import calib_sensitivity as jcs
from wild_video_3d_reconstruction_tpu.eval import loop_recall as jlr
from wild_video_3d_reconstruction_tpu.eval import matcher_recall as jmr
from wild_video_3d_reconstruction_tpu.eval import synth_suite as jss
from wild_video_3d_reconstruction_tpu.loop.netvlad import \
    VLADDescriptor as JVLAD
from wild_video_3d_reconstruction_tpu.models.vonet import init_vonet
from wild_video_3d_reconstruction_tpu.slam import dpvo as jdpvo
from wild_video_3d_reconstruction_tpu.slam import state as jstate
from wild_video_3d_reconstruction_tpu.slam import steps as jsteps
from wild_video_3d_reconstruction_tpu.train.synth import render_clip
from wild_video_3d_reconstruction_tpu.utils import config as jconfig

from test_torch_loop import jax_tree
from test_torch_slam import one_thread
from test_torch_synth_ate import EDGE_KEYS, jax_raw_draws
from test_torch_weights import WEIGHTS

FRAMES = 12
SCENES = [tss.SCENES[0], tss.SCENES[4]]          # walk_s0, orbit_s0
TOL_ATE = 1e-3
TOL_FLOOR = 1e-6
TOL_ORACLE = 1e-3


@pytest.fixture(scope="module")
def params():
    return jax_tree(WEIGHTS)


@pytest.fixture
def jax_fp32(monkeypatch):
    """The JAX DPVO in fp32 (MIXED_PRECISION off, an fp32 state) with the
    port's edge rows (R4, R6), as the port runs here."""
    cls = jconfig.DPVOConfig

    def fp32_config(**kw):
        return cls(**dict(kw, MIXED_PRECISION=False))

    monkeypatch.setattr(jconfig, "DPVOConfig", fp32_config)
    orig = jdpvo.DPVO.__init__
    sig = inspect.signature(orig)

    def patched(self, *a, **kw):
        orig(self, *a, **kw)
        b = sig.bind(self, *a, **kw)
        b.apply_defaults()
        cfg, ht, wd = b.arguments["cfg"], b.arguments["ht"], \
            b.arguments["wd"]
        rows = tstate.edge_rows(TConfig(**{
            f: getattr(cfg, f) for f in TConfig.__dataclass_fields__}))
        st = jstate.init_state(cfg, ht, wd, feat_dtype=jnp.float32,
                               seed=b.arguments["seed"])
        grow = {}
        for k in EDGE_KEYS:
            a_ = getattr(st, k)
            pad = jnp.zeros((rows - a_.shape[0],) + a_.shape[1:], a_.dtype)
            grow[k] = jnp.concatenate([a_, pad])
        self.state = st._replace(**grow)

    monkeypatch.setattr(jdpvo.DPVO, "__init__", patched)
    monkeypatch.setattr(tsteps, "TIER_ON_CPU", True)
    monkeypatch.setattr(tsteps, "TIER_MIN_EDGES", 0)


def draws_of(M, ht=48, wd=64, frames=FRAMES):
    return lambda s: jax_raw_draws(frames, M, ht // 4, wd // 4, seed=s)


def quiet(*a):
    pass


def test_run_suite_matches_jax(params, jax_fp32):
    ref = jss.run_suite({"trained": params}, frames=FRAMES, trials=1,
                        scenes=SCENES, log=quiet)
    with one_thread():
        out = tss.run_suite({"trained": str(WEIGHTS)}, frames=FRAMES,
                            trials=1, scenes=SCENES, log=quiet,
                            device="cpu", draws=draws_of(16),
                            cfg_overrides=dict(MIXED_PRECISION=False))
    assert list(out["scenes"]) == list(ref["scenes"]) == \
        [s for s, _ in SCENES]
    for s in out["scenes"]:
        a, b = out["scenes"][s]["trained"], ref["scenes"][s]["trained"]
        assert abs(a["ate_median"] - b["ate_median"]) <= TOL_ATE, (s, a, b)
        assert abs(a["floor"] - b["floor"]) <= TOL_FLOOR
        assert a["ate_median"] < a["floor"]
    assert abs(out["mean_trained"] - ref["mean_trained"]) <= TOL_ATE
    assert abs(out["mean_floor"] - ref["mean_floor"]) <= TOL_FLOOR
    md = tss.to_markdown(out, ["trained"])
    assert md.splitlines()[0] == jss.to_markdown(ref, ["trained"]) \
        .splitlines()[0]
    assert len(md.splitlines()) == len(SCENES) + 3


def test_run_sweep_matches_jax(params, jax_fp32):
    levels = (0.0, 0.05)
    ref = jcs.run_sweep(params=params, frames=FRAMES, trials=1,
                        levels=levels, scenes=SCENES[:1], log=quiet)
    with one_thread():
        out = tcs.run_sweep(params=str(WEIGHTS), frames=FRAMES, trials=1,
                            levels=levels, scenes=SCENES[:1], log=quiet,
                            device="cpu", draws=draws_of(16),
                            cfg_overrides=dict(MIXED_PRECISION=False))
    assert list(out) == list(ref)
    for s in out:
        assert list(out[s]) == list(ref[s]) == ["0.00", "0.05"]
        for k in out[s]:
            assert abs(out[s][k] - ref[s][k]) <= TOL_ATE, (s, k, out, ref)


class _OracleShim(types.ModuleType):
    """The JAX `slam/steps.py` module with any function assigned to its
    `_run_update_net` wrapped to take (and drop) the `agg_order` keyword
    that its `update_op` passes: the JAX `run_oracle`'s oracle predates it
    and raises TypeError otherwise (ROADMAP R24)."""

    def __setattr__(self, name, value):
        if name == "_run_update_net" and \
                "agg_order" not in inspect.signature(value).parameters:
            fn = value

            def value(*a, agg_order=None, **kw):
                return fn(*a, **kw)
        super().__setattr__(name, value)


@pytest.mark.parametrize("focal_err", [0.0, 0.05])
def test_run_oracle_matches_jax(focal_err, monkeypatch):
    monkeypatch.setattr(jsteps, "__class__", _OracleShim)
    ref = jcs.run_oracle(focal_err, seed=0)
    draws = jax_raw_draws(18, 8, 96 // 4, 128 // 4, seed=0)
    rec = {}
    with one_thread():
        out = tcs.run_oracle(focal_err, seed=0, device="cpu", draws=draws,
                             record=rec)
    assert abs(out - ref) <= TOL_ORACLE, (out, ref)
    # eager on the CPU: one execution per Python call
    assert rec["oracle_calls"] == rec["oracle_traced"] > 0
    if focal_err == 0.0:
        assert out < 5e-3 and ref < 5e-3
    else:
        assert 5e-3 < out < 0.05


def test_build_frames_bitwise():
    for args in ((20, 24, 48, 64), (80, 24, 192, 256)):
        tf, tgt = tlr.build_frames(*args)
        jf, jgt = jlr.build_frames(*args)
        assert tgt == jgt
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(a, b)


def _jax_loop_recall(argv):
    """The JAX driver's main (a CLI) on argv; its JSON line."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["loop_recall"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            jlr.main()
    finally:
        sys.argv = old
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fit", [False, True])
def test_loop_recall_hits_match_jax(fit):
    T, shift, ht, wd, skip = 20, 24, 48, 64, 4
    argv = ["--frames", str(T), "--shift", str(shift), "--size", str(ht),
            str(wd), "--skip-window", str(skip)] + (["--fit"] if fit else [])
    ref = _jax_loop_recall(argv)
    frames, gt = tlr.build_frames(T, shift, ht, wd)
    params = jax.tree.map(np.asarray, init_vonet(jax.random.PRNGKey(0)))
    centers = None if fit else np.asarray(JVLAD().centers)
    with one_thread():
        out = tlr.run(frames, gt, network=params, fit=fit,
                      skip_window=skip, centers=centers, device="cpu")
    assert out["queries"] == ref["queries"] > 0
    assert out["hits"] == ref["hits"], (out, ref)
    assert out["value"] == ref["value"]


def test_run_pair_matches_jax_on_the_pinned_pair(params):
    rng = np.random.default_rng(1001)
    clip = render_clip(rng, frames=7, ht=96, wd=128, fx=76.8, fy=76.8,
                       n_planes=3, harden=True)
    ref = jmr.run_pair(*clip, 0, 6, jax.tree.map(jnp.asarray, params))
    tclip = tmr.render_pair_clip(1, True, deltas=(6,))
    for a, b in zip(tclip, clip):
        np.testing.assert_array_equal(a, b)
    with one_thread():
        out = tmr.run_pair(*tclip, 0, 6, as_vonet(str(WEIGHTS)).eval())
    for k in ("accepted", "matchable", "correct", "geo_correct"):
        assert out[k] == ref[k], (k, out, ref)
    assert out["matchable"] > 20
    assert out["recall"] > 0.85 and out["precision"] > 0.6, out
