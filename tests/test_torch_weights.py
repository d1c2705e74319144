"""The committed trained weights equal the orbax checkpoint they came from.

`weights/vonet_synth_tpu_r3_step2000.pth` is
`scripts/torch_export_weights.py`'s export of
`checkpoints/synth_tpu_r3_step2000`. The port loads it strictly through
`DPVO(network=<path>)` (`models/convert.py:load_reference_checkpoint`),
and every tensor equals `jax_params_to_torch` of the orbax restore
exactly (tolerance 0: the export only transposes fp32 arrays).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.models.convert import (
    jax_params_to_torch, load_reference_checkpoint)
from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_export_weights as exporter  # noqa: E402

WEIGHTS = ROOT / "weights" / "vonet_synth_tpu_r3_step2000.pth"


@pytest.fixture(scope="module")
def restored():
    import jax
    return jax.tree.map(np.asarray, exporter.restore())


def test_weights_file_is_the_committed_export():
    assert exporter.OUT == WEIGHTS
    assert WEIGHTS.is_file() and WEIGHTS.stat().st_size <= 14_000_000


def test_weights_load_strictly_and_equal_the_checkpoint(restored):
    net = load_reference_checkpoint(str(WEIGHTS))
    ref = jax_params_to_torch(restored)
    got, want = net.state_dict(), ref.state_dict()
    assert got.keys() == want.keys() and len(got) == 94
    assert sum(v.numel() for v in got.values()) == 3_384_324
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_dpvo_takes_the_weights_by_path():
    cfg = DPVOConfig(BUFFER_SIZE=32, PATCHES_PER_FRAME=8, MEM=12)
    slam = DPVO(cfg, str(WEIGHTS), 48, 64, device="cpu")
    want = load_reference_checkpoint(str(WEIGHTS)).state_dict()
    for k, v in slam.net.state_dict().items():
        assert torch.equal(v, want[k]), k
