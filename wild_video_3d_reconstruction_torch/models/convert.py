"""Weight carry-over into the port's `VONet` and encoders.

* `jax_params_to_torch(params_np, net=None)`: the JAX package's parameter
  tree (nested dicts of numpy arrays) -> a `VONet` (or the given module,
  e.g. a `BasicEncoder8` for `basic_encoder8`'s tree) holding those
  weights. Conv weights go HWIO -> OIHW and linear weights [in, out] ->
  [out, in]; the tree paths are the module paths, so every tensor lands
  by name and a missing or extra one raises. It reads numpy only.
* `load_reference_checkpoint(path)`: a published DPVO `.pth` state dict
  (module names `patchify.fnet.*`, `patchify.inet.*`, `update.*`) -> a
  `VONet`, by the JAX package's renaming rules: strip `module.`, drop
  `update.lmbda`, `downsample.0.` -> `downsample.`.
* `as_vonet(network, seed)`: any of those, a `VONet`, or None (weights
  drawn from seed) -> a `VONet`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .vonet import VONet, init_vonet


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten(v, name)
        else:
            yield name, v


def jax_params_to_torch(params_np, net=None):
    """Load a JAX param tree (numpy leaves) into `net` (a new CPU `VONet`
    when None; any module whose parameter paths are the tree's) and
    return it."""
    state = {}
    for name, value in _flatten(params_np):
        arr = np.array(value, dtype=np.float32)
        if name.endswith("weight"):
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)     # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T                          # [in, out] -> [out, in]
        state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    net = VONet() if net is None else net
    net.load_state_dict(state, strict=True)
    return net.eval()


def load_reference_checkpoint(path, device="cpu"):
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    out = {}
    for name, tensor in state.items():
        if "update.lmbda" in name:
            continue
        name = name.replace("module.", "")
        if name.startswith("patchify."):
            name = name[len("patchify."):]
        if not name.startswith(("fnet.", "inet.", "update.")):
            continue
        out[name.replace("downsample.0.", "downsample.")] = tensor.float()
    net = VONet()
    net.load_state_dict(out, strict=True)
    return net.to(device).eval()


def as_vonet(network=None, seed=0):
    """A `VONet` from `network`: a `VONet` (returned as it is), a path to a
    DPVO `.pth` checkpoint, the JAX package's parameter tree, or None for
    weights drawn from `seed`."""
    if isinstance(network, VONet):
        return network
    if isinstance(network, (str, os.PathLike)):
        return load_reference_checkpoint(network)
    if network is None:
        return init_vonet(seed)
    return jax_params_to_torch(network)
