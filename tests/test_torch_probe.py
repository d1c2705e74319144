"""The motion probe with the trained weights at full width, the port against
the JAX package.

Before initialization each warm-up frame after the first is tried on the
previous keyframe's patches (`steps.motion_probe`: one update-operator pass
from a zero hidden state over M trial edges), and a median flow delta
below MOTION_PROBE_THRESH parks the frame. With the trained weights
(`weights/vonet_synth_tpu_r3_step2000.pth`, the orbax checkpoint
`checkpoints/synth_tpu_r3_step2000` on the JAX side) at 384x512 and
configs/default.yaml, the port's probe parked the wild walk's frames
(`eval/synth_ate.py:wild_sequence`) at the shipped threshold of 2.0.

This runs both DPVOs over the first two frames of that walk (fx = 320,
the world's depth as the prior and the occluder's mask, as the card's
wild runs feed them), the port given the JAX run's draws, and holds the
probe of the second frame: the median of an update in bf16, within
TOL_PROBE of each other relative (encoders and update operator both in
bf16 under MIXED_PRECISION, summed in other orders by XLA and by torch),
with the same decision against the threshold. Both park the frame: the
parking is the reference's behaviour (ROADMAP R7).
"""

import jax
import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.eval import synth_ate as tsynth_ate
from wild_video_3d_reconstruction_torch.slam import DPVO as TDPVO
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.utils.config import \
    load_config as tload_config
from wild_video_3d_reconstruction_tpu.slam import DPVO as JDPVO
from wild_video_3d_reconstruction_tpu.utils.config import \
    load_config as jload_config

from test_torch_synth_ate import jax_raw_draws
from test_torch_weights import WEIGHTS, exporter

HT, WD = 384, 512
TOL_PROBE = 1e-2


@pytest.fixture(scope="module")
def probes():
    images, _, intr, depths, masks = tsynth_ate.wild_sequence(
        0, frames=2, ht=HT, wd=WD, fx=320.0, fy=320.0)
    params = jax.tree.map(np.asarray, exporter.restore())
    jcfg = jload_config("configs/default.yaml")
    out = {"jax": [], "port": []}

    js = JDPVO(jcfg, params, HT, WD, seed=0)
    jprobe = js._probe

    def jrecord(state, p):
        v = jprobe(state, p)
        out["jax"].append(float(v))
        return v

    js._probe = jrecord
    for t in range(2):
        js(t, images[t], depths[t], masks[t], intrinsics=intr)

    M = jcfg.PATCHES_PER_FRAME
    draws = jax_raw_draws(2, M, HT // 4, WD // 4, "mask")
    ts = TDPVO(tload_config("configs/default.yaml"), str(WEIGHTS), HT, WD,
               device="cpu")
    mp = pytest.MonkeyPatch()
    tprobe = tsteps.motion_probe

    def trecord(*a):
        v = tprobe(*a)
        out["port"].append(float(v))
        return v

    mp.setattr(tsteps, "motion_probe", trecord)
    try:
        for t in range(2):
            ts(t, images[t], intr, depth=depths[t], mask=masks[t],
               **draws[t])
    finally:
        mp.undo()
    out.update(jcfg=jcfg, js=js, ts=ts)
    return out


def test_probe_matches_jax_at_full_width(probes):
    (j,), (t,) = probes["jax"], probes["port"]
    print(f"motion probe, second wild frame: JAX {j}, port {t}")
    assert np.isfinite(j) and np.isfinite(t)
    assert abs(t - j) <= TOL_PROBE * j


def test_both_park_the_second_wild_frame(probes):
    """The shipped threshold parks the frame on both sides: the same
    decision, recorded as reference behaviour (ROADMAP R7)."""
    thresh = probes["jcfg"].MOTION_PROBE_THRESH
    assert thresh == 2.0
    (j,), (t,) = probes["jax"], probes["port"]
    assert j < thresh and t < thresh
    assert probes["js"].parked == probes["ts"].parked == [1]
