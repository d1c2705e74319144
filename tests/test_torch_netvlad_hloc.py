"""The port's hloc NetVLAD (`loop/netvlad_hloc.py`, an nn.Module) against
the JAX package's, with random weights on a 64x64 image.

The parameters are a tree of the shapes of the JAX package's
`init_params`, drawn with its scales from a numpy generator (its
jax.random draw of 14.7M values costs seconds on the CPU), with a narrow
random whitening, [32768, 64] instead of hloc's [32768, 4096] (both
packages take the whitening's width from its matrix), carried into the
port with `from_jax_params`: descriptors within 1e-4 absolute (unit
vectors after 13 fp32 convolutions in two libraries). The JAX forward
runs under one `jax.jit`. hloc's state dict
layout loads as it is: the port's module saved as a state dict (wrapped
in "state_dict", as hloc's checkpoints are) and loaded by path, against
the JAX package's `convert_hloc_state_dict` of the same dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wild_video_3d_reconstruction_torch.loop import netvlad_hloc as tnv
from wild_video_3d_reconstruction_tpu.loop import netvlad_hloc as jnv

TOL = 1e-4
WHITEN = 64


def image():
    return np.random.default_rng(0).integers(0, 256, (64, 64, 3),
                                             dtype=np.uint8)


def jax_params():
    """`jnv.init_params`' tree (its shapes from `jax.eval_shape`), He-scaled
    convolutions and small biases from a numpy generator, and the narrow
    whitening."""
    shapes = jax.eval_shape(lambda: jnv.init_params(jax.random.PRNGKey(0),
                                                    whiten=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        fan_in = int(np.prod(leaf.shape[:-1]))
        scale = (2.0 / fan_in) ** 0.5 if "conv" in name and \
            name.endswith("['w']") else 0.01 if name.endswith("['b']") \
            else 0.05 if "score_proj" in name else 1.0
        return jnp.asarray(rng.normal(size=leaf.shape) * scale, jnp.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    rng = np.random.default_rng(1)
    params["whiten"] = {
        "w": jnp.asarray(rng.normal(size=(jnv.K * jnv.CDIM, WHITEN)) * 0.01,
                         jnp.float32),
        "b": jnp.asarray(rng.normal(size=WHITEN) * 0.01, jnp.float32)}
    return params


_global_descriptor = jax.jit(jnv.global_descriptor)


def jax_descriptor(params, img_bgr):
    return np.asarray(_global_descriptor(
        params, jnp.asarray(img_bgr[..., ::-1].astype(np.float32))))


def test_descriptor_matches_jax():
    params = jax_params()
    net = tnv.from_jax_params(jax.tree.map(np.asarray, params))
    img = image()
    got = net.extract_image(img)
    want = jax_descriptor(params, img)
    assert got.shape == want.shape == (WHITEN,) and net.dim == WHITEN
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # without the whitening: the [K * C] NetVLAD vector
    bare = dict(params)
    bare.pop("whiten")
    net = tnv.from_jax_params(jax.tree.map(np.asarray, bare))
    np.testing.assert_allclose(net.extract_image(img),
                               jax_descriptor(bare, img), atol=TOL, rtol=0)
    assert net.dim == jnv.K * jnv.CDIM


def test_hloc_state_dict_loads(tmp_path):
    net = tnv.HlocNetVLAD(whiten_dim=WHITEN, seed=3, device="cpu")
    sd = net.state_dict()
    torch.save({"state_dict": sd}, tmp_path / "netvlad.pth")
    loaded = tnv.HlocNetVLAD(checkpoint=str(tmp_path / "netvlad.pth"),
                             whiten_dim=WHITEN, device="cpu")
    img = image()
    got = loaded.extract_image(img)
    np.testing.assert_array_equal(got, net.extract_image(img))
    want = jax_descriptor(jnv.convert_hloc_state_dict(sd), img)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
