"""Port parity: config loading, weight carry-over, the encoders and the
per-frame patch gathers, against the JAX package on the same inputs.

Weights are the JAX package's `init_vonet` draws carried across by
`jax_params_to_torch`; everything runs in fp32. Tolerances: 1e-4 absolute
on encoder features (deep fp32 conv stacks, summation order differs),
1e-5 on gathers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.models import convert as tconvert
from wild_video_3d_reconstruction_torch.models import vonet as tvonet
from wild_video_3d_reconstruction_torch.ops import patchify as tpatchify
from wild_video_3d_reconstruction_torch.utils import config as tconfig
from wild_video_3d_reconstruction_tpu.models import convert as jconvert
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.ops import patchify as jpatchify
from wild_video_3d_reconstruction_tpu.utils import config as jconfig


@pytest.fixture(scope="module")
def params():
    p = jvonet.init_vonet(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def net(params):
    return tconvert.jax_params_to_torch(params)


@pytest.mark.parametrize("name", ["default", "fast", "mid", "tum"])
def test_config_files_load_like_jax(name):
    path = f"configs/{name}.yaml"
    t = tconfig.load_config(path)
    j = jconfig.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("pmem", "edge_capacity", "ba_window", "patch_window_frames",
                 "patch_slots", "frame_window"):
        assert getattr(t, prop) == getattr(j, prop)


def test_config_defaults_and_overrides_match_jax():
    t = tconfig.DPVOConfig()
    j = jconfig.DPVOConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    opts = ["PATCHES_PER_FRAME", "96", "MIXED_PRECISION", "false",
            "KEYFRAME_THRESH", "7.5"]
    assert dataclasses.asdict(t.merge_from_list(opts)) == \
        dataclasses.asdict(j.merge_from_list(opts))
    with pytest.raises(KeyError):
        t.merge_from_dict({"NO_SUCH_KEY": 1})


def test_flat_yaml_parser():
    text = ("# comment\nA: 3\nB: 2.5  # trailing\nC: true\nD: x16\n"
            "E: 'quoted # not a comment'\n\nF: null\n")
    assert tconfig.parse_flat_yaml(text) == {
        "A": 3, "B": 2.5, "C": True, "D": "x16",
        "E": "quoted # not a comment", "F": None}
    for bad in ("A:\n  - 1\n", "A: [1, 2]\n", "  A: 1\n", "no colon\n"):
        with pytest.raises(ValueError):
            tconfig.parse_flat_yaml(bad)
    cfg = tconfig.load_config("configs/default.yaml")
    assert tconfig.parse_flat_yaml(cfg.dump())["PATCHES_PER_FRAME"] == 384


def test_convert_roundtrip_names_and_layouts(params, net):
    """Every JAX leaf lands on one module tensor, transposed to torch's
    layout (HWIO -> OIHW, [in, out] -> [out, in])."""
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    ref = jconvert.params_to_state_dict(params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k], v)


def test_reference_checkpoint_loader(tmp_path, params, net):
    """A DPVO-layout `.pth` (patchify.* / module. / downsample.0.)
    loads into the same weights."""
    ref = jconvert.params_to_state_dict(params)
    raw = {}
    for k, v in ref.items():
        k = k.replace("downsample.", "downsample.0.")
        if not k.startswith("update."):
            k = "patchify." + k
        raw["module." + k] = torch.from_numpy(np.array(v))
    raw["module.update.lmbda"] = torch.zeros(1)
    path = tmp_path / "dpvo.pth"
    torch.save(raw, path)
    loaded = tconvert.load_reference_checkpoint(str(path))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v)


def image(seed, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def test_encoders_match_jax(params, net):
    img = image(0)
    f_j = jvonet.encode_frame(params, jnp.asarray(img), jnp.float32)
    f_t = tvonet.encode_frame(net, torch.from_numpy(img), torch.float32)
    assert f_t.fmap.shape == (12, 16, 128) and f_t.imap.shape == (12, 16, 384)
    np.testing.assert_allclose(f_t.fmap.numpy(), np.asarray(f_j.fmap),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(f_t.imap.numpy(), np.asarray(f_j.imap),
                               atol=1e-4, rtol=0)


def test_patchify_matches_jax():
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(12, 16, 8)).astype(np.float32)
    # centres inside, on and beyond the border
    coords = rng.uniform(-3.0, 18.0, size=(40, 2)).astype(np.float32)
    for radius in (0, 1, 3):
        out_j = np.asarray(jpatchify.patchify(jnp.asarray(fmap),
                                              jnp.asarray(coords), radius))
        out_t = tpatchify.patchify(torch.from_numpy(fmap),
                                   torch.from_numpy(coords), radius).numpy()
        np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=0)
    x = rng.normal(size=(13, 17, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tpatchify.avg_pool2d(torch.from_numpy(x), 4).numpy(),
        np.asarray(jpatchify.avg_pool2d(jnp.asarray(x), 4)), atol=1e-6)


def test_gather_patches_matches_jax(params, net):
    img = image(2)
    f_j = jvonet.encode_frame(params, jnp.asarray(img), jnp.float32)
    f_t = tvonet.FrameFeatures(torch.from_numpy(np.array(f_j.fmap)),
                               torch.from_numpy(np.array(f_j.imap)))
    coords = np.asarray(jvonet.select_patches(jax.random.PRNGKey(3), 8, 12,
                                              16))
    out_j = jvonet.gather_patches(f_j, jnp.asarray(img), jnp.asarray(coords))
    c_t = tvonet.select_patches(None, 8, 12, 16, coords=coords)
    out_t = tvonet.gather_patches(f_t, torch.from_numpy(img), c_t)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_select_patches_draws_in_range():
    g = torch.Generator().manual_seed(0)
    c = tvonet.select_patches(g, 64, 12, 16)
    assert c.shape == (64, 2) and c.dtype == torch.float32
    assert (c[:, 0] >= 1).all() and (c[:, 0] < 15).all()
    assert (c[:, 1] >= 1).all() and (c[:, 1] < 11).all()
    grad = tvonet.image_gradient_map(torch.from_numpy(image(4)))
    c2 = tvonet.select_patches(g, 16, 12, 16, gradient_map=grad)
    assert c2.shape == (16, 2)


def test_image_gradient_map_matches_jax():
    img = image(5)
    np.testing.assert_allclose(
        tvonet.image_gradient_map(torch.from_numpy(img)).numpy(),
        np.asarray(jvonet.image_gradient_map(jnp.asarray(img))),
        rtol=1e-5, atol=1e-3)
