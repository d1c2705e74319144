"""Training loop: steps, logging, checkpoints, on one device or several.

Counterpart of the JAX package's `train/trainer.py`: `Logger` writes
running means every SUM_FREQ steps (JSONL always, tensorboard when it
imports), `train` runs the step of `parallel/train_step.py` over a
dataset's batches. With `n_devices` it runs as one rank of a torchrun
launch (`torchrun --nproc_per_node N`): every rank makes the same
batches from the same seed and takes its share of each, the step is the
FSDP one over `parallel.mesh.make_mesh(N)`, and rank 0 logs and writes
the checkpoints (gathered from the shards on every rank):

    torchrun --nproc_per_node N \
        -m wild_video_3d_reconstruction_torch.train.trainer \
        --data /data/TartanAir --n_devices N

Checkpoints are PyTorch `.pth` state dicts in the reference DPVO layout
(`patchify.fnet.*`, `patchify.inet.*`, `update.*`, `downsample.0.*`),
the layout the JAX package's `models/convert.py:load_torch_checkpoint`
reads and `DPVO(network=)` loads; the port writes no orbax checkpoint
(ROADMAP R17).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..models.convert import load_reference_checkpoint
from ..models.vonet import init_vonet
from ..parallel.train_step import (build_train_step, make_optimizer,
                                   rank_seed)
from .forward import TrainConfig


class Logger:
    """Running means of the metrics every SUM_FREQ steps, as JSONL lines
    in logdir/name/metrics.jsonl (and tensorboard scalars when
    `torch.utils.tensorboard` imports)."""

    SUM_FREQ = 100

    def __init__(self, name, logdir="runs"):
        self.logdir = Path(logdir) / name
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.running = {}
        self.step = 0
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.writer = None
        else:
            self.writer = SummaryWriter(str(self.logdir))

    def push(self, metrics):
        self.step += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.step % self.SUM_FREQ == 0:
            means = {k: v / self.SUM_FREQ for k, v in self.running.items()}
            line = {"step": self.step, **means, "time": time.time()}
            self._jsonl.write(json.dumps(line) + "\n")
            self._jsonl.flush()
            if self.writer:
                for k, v in means.items():
                    self.writer.add_scalar(k, v, self.step)
            print(f"[{self.step}] " + " ".join(
                f"{k}={v:.4f}" for k, v in means.items()), flush=True)
            self.running = {}

    def close(self):
        self._jsonl.close()
        if self.writer:
            self.writer.close()


def reference_state_dict(net):
    """net's parameters as CPU fp32 tensors under the reference DPVO
    names. The shards of a sharded net are gathered first (a collective:
    every rank calls it)."""
    out = {}
    for name, t in net.state_dict().items():
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        if name.startswith(("fnet.", "inet.")):
            name = "patchify." + name
        out[name.replace("downsample.", "downsample.0.")] = \
            t.detach().float().cpu().clone()
    return out


def export_torch_checkpoint(net, path):
    """Save net as a `.pth` in the reference layout; returns path. Under
    a process group every rank calls it (a sharded net is gathered) and
    rank 0 writes."""
    state = reference_state_dict(net)
    if not dist.is_initialized() or dist.get_rank() == 0:
        torch.save(state, path)
    return path


def save_checkpoint(net, path, step):
    """path/step_{step}.pth; returns its path."""
    out = Path(path).absolute()
    out.mkdir(parents=True, exist_ok=True)
    return export_torch_checkpoint(net, out / f"step_{step}.pth")


def load_checkpoint(path, device="cpu"):
    """A VONet from a `.pth` the port (or the reference) wrote."""
    return load_reference_checkpoint(path, device=device)


def train(dataset, steps=240000, batch_size=4, lr=8e-5, name="vonet",
          checkpoint_every=10000, logdir="runs", ckptdir="checkpoints_torch",
          tc=None, device="cuda", seed=0, n_devices=None):
    """The training loop: a VONet from `seed`, AdamW at a constant lr,
    `dataset.batches(batch_size, steps)` (numpy batches in the
    `clip_loss_fn` layout), a checkpoint every checkpoint_every steps.
    With n_devices, as one of n_devices ranks (torchrun's environment, or
    a process group already formed): the same network and batches on
    every rank, the FSDP step over make_mesh(n_devices), draws from a
    generator seeded `rank_seed(1, rank)` (ROADMAP R27), rank 0 logging
    and writing the checkpoints. Returns the trained network (sharded
    across the ranks with n_devices)."""
    tc = tc or TrainConfig(frames=8, patches=32, steps=8)
    rank, mesh = 0, None
    if n_devices is not None:
        from ..parallel.mesh import init_distributed, make_mesh

        rank, world = init_distributed(device)
        if world != n_devices:
            raise ValueError(f"train(n_devices={n_devices}): the process "
                             f"group has {world} ranks")
        mesh = make_mesh(n_devices, device)
    net = init_vonet(seed).to(device)
    step_fn = build_train_step(net, tc, make_optimizer(net.parameters(),
                                                       lr=lr), device,
                               mesh=mesh)
    logger = Logger(name, logdir) if rank == 0 else None
    generator = torch.Generator().manual_seed(rank_seed(1, rank))
    try:
        for i, batch in enumerate(dataset.batches(batch_size, steps)):
            metrics = step_fn(batch, generator)
            if logger:
                logger.push(metrics)
            if (i + 1) % checkpoint_every == 0:
                save_checkpoint(net, ckptdir, i + 1)
    finally:
        if logger:
            logger.close()
    if mesh is not None:
        dist.barrier()
    return net


def main(argv=None):
    """Train on a TartanAir-layout directory (`train/data.py`)."""
    import argparse

    from .data import TartanAirDataset

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--steps", type=int, default=240000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=8e-5)
    ap.add_argument("--name", default="vonet")
    ap.add_argument("--checkpoint_every", type=int, default=10000)
    ap.add_argument("--n_devices", type=int, default=None,
                    help="ranks of a torchrun launch (FSDP); none: one "
                         "device")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    train(TartanAirDataset(a.data), steps=a.steps, batch_size=a.batch,
          lr=a.lr, name=a.name, checkpoint_every=a.checkpoint_every,
          device=a.device, n_devices=a.n_devices)


if __name__ == "__main__":
    main()
