"""Process groups, the (dp, fsdp, tp) device mesh and its sharding rule.

Counterpart of the JAX package's `parallel/mesh.py`. The JAX package
scales training over a `jax.sharding.Mesh` with three axes:

  dp    data parallel over clips
  fsdp  parameter / optimizer sharding over the input dim of large matmuls
  tp    tensor parallel over the output dim of the 384-wide update MLPs
        and the encoders' output channels

Here the mesh is a `torch.distributed` `DeviceMesh` of the same shape,
one rank per device (SPMD: every rank runs the same program), made after
`init_distributed`:

  * `mesh_shape(n)` factors n exactly as the JAX package does: tp = 2 if
    n is even, then fsdp = 2 if the rest is even, then dp;
  * `param_sharding(net, mesh)` is the JAX package's rule, applied to each
    parameter's JAX layout (linear [in, out], conv [kh, kw, cin, cout];
    `models.convert`) and returned in the torch layout, so the same
    parameters come out sharded on the same logical dims;
  * `make_mesh` also flattens fsdp x tp into one "shard" dim, once, and
    `hsdp_mesh(mesh)` is its 2-D ("dp", "shard") slice, the mesh the FSDP
    train step shards over: dp replicated, the parameters sharded over
    the fsdp x tp group (ROADMAP R26: the torch idiom runs tp as more
    data parallelism inside the shard group; the numbers are the same
    mean gradient), each on the dim `shard_dims` reads from the rule;
  * `batch_sharding(batch)` is the rank's contiguous share of a global
    batch's leading axis.

`init_distributed(device)` joins the process group: `nccl` for the card,
`gloo` for the CPU, the rank and world size from torchrun's RANK /
WORLD_SIZE / LOCAL_RANK or from the arguments (the tests' `file://`
stores). Nothing falls back: a card that is missing or a group that
fails to form raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


def _device_type(device):
    return torch.device(device).type


def init_distributed(device="cuda", rank=None, world_size=None,
                     init_method=None, backend=None):
    """Join (or reuse) the default process group for `device`; returns
    (rank, world_size). `nccl` on "cuda" (the rank's card is LOCAL_RANK
    of this host), `gloo` on "cpu"; backend="gloo" with "cuda" takes
    gloo's collectives on CUDA tensors. Without arguments the rank and
    world size come from torchrun's environment and the rendezvous from
    MASTER_ADDR / MASTER_PORT (`env://`)."""
    kind = _device_type(device)
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed: no backend for {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: device 'cuda' asked for, "
                           "but torch.cuda.is_available() is false")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"init_distributed: the process group is "
                               f"{dist.get_backend()}, not {backend}")
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            **({"device_id": torch.device("cuda", local)}
                               if backend == "nccl" else {}))
    return rank, world_size


def mesh_shape(n):
    """(dp, fsdp, tp) of n devices, as the JAX package factors them."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    fsdp = 2 if rem % 2 == 0 else 1
    return rem // fsdp, fsdp, tp


def make_mesh(n_devices=None, device="cuda"):
    """The (dp, fsdp, tp) `DeviceMesh` over the process group's ranks
    (n_devices must be its world size; default: the world size), with
    fsdp x tp flattened into a "shard" dim for `hsdp_mesh`."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if n != dist.get_world_size():
        raise ValueError(f"make_mesh({n}): the process group has "
                         f"{dist.get_world_size()} ranks")
    mesh = init_device_mesh(_device_type(device), mesh_shape(n),
                            mesh_dim_names=AXES)
    mesh["fsdp", "tp"]._flatten("shard")
    return mesh


def hsdp_mesh(mesh):
    """The 2-D ("dp", "shard") mesh of the FSDP train step: dp as it is,
    fsdp x tp flattened (the groups `make_mesh` made)."""
    return mesh["dp", "shard"]


def jax_layout(name, shape):
    """(JAX shape, torch dim of each JAX dim) of a parameter: conv weights
    are HWIO there, linear weights [in, out] (`models.convert`)."""
    shape = tuple(shape)
    if name.endswith("weight") and len(shape) == 4:
        dims = (2, 3, 1, 0)
    elif name.endswith("weight") and len(shape) == 2:
        dims = (1, 0)
    else:
        dims = tuple(range(len(shape)))
    return tuple(shape[d] for d in dims), dims


def jax_rule(shape):
    """The JAX package's PartitionSpec of a parameter of JAX shape
    `shape`, as a tuple of axis names (None: not sharded) or () for
    replicated: big linears (fsdp, tp), wide linears on tp, conv output
    channels on tp."""
    if len(shape) == 2 and shape[0] >= 256 and shape[1] >= 256:
        return ("fsdp", "tp")
    if len(shape) == 2 and shape[1] >= 256:
        return (None, "tp")
    if len(shape) == 4 and shape[3] >= 128:
        return (None, None, None, "tp")
    return ()


def param_sharding(net, mesh=None):
    """{parameter name: its spec in the torch layout}, a tuple with one
    entry per torch dim (a mesh axis name or None), or () where the JAX
    rule replicates it. The mesh names the axes; the rule does not depend
    on its size (as in the JAX package)."""
    if mesh is not None and tuple(mesh.mesh_dim_names) != AXES:
        raise ValueError(f"param_sharding: mesh axes "
                         f"{mesh.mesh_dim_names}, not {AXES}")
    out = {}
    for name, p in net.named_parameters():
        shape, dims = jax_layout(name, p.shape)
        spec = [None] * len(shape)
        for jax_dim, axis in enumerate(jax_rule(shape)):
            spec[dims[jax_dim]] = axis
        out[name] = tuple(spec) if any(spec) else ()
    return out


def shard_dims(net, shard_size):
    """{parameter name: the torch dim the FSDP step shards it on over a
    group of shard_size ranks}: that of the rule's fsdp axis (the input
    dim of the big linears) where shard_size divides it (FSDP2 shards
    other dims than 0 only evenly), else 0. FSDP shards every parameter,
    also those the rule replicates (ROADMAP R26)."""
    out = {}
    for name, spec in param_sharding(net).items():
        d = spec.index("fsdp") if "fsdp" in spec else 0
        out[name] = d if net.get_parameter(name).shape[d] % shard_size \
            == 0 else 0
    return out


def batch_sharding(batch, rank=None, world=None):
    """The rank's contiguous share of every leading axis of `batch` (a
    dict of arrays or tensors): rows [r B / n, (r + 1) B / n). B must
    divide by the world size."""
    rank = dist.get_rank() if rank is None else rank
    world = dist.get_world_size() if world is None else world
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % world:
            raise ValueError(f"batch_sharding: batch {B} does not divide "
                             f"by {world} ranks")
        out[k] = v[rank * B // world:(rank + 1) * B // world]
    return out
