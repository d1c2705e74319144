"""Training loop on one device: steps, logging, checkpoints.

Counterpart of the JAX package's `train/trainer.py`: `Logger` writes
running means every SUM_FREQ steps (JSONL always, tensorboard when it
imports), `train` runs the step of `parallel/train_step.py` over a
dataset's batches. Checkpoints are PyTorch `.pth` state dicts in the
reference DPVO layout (`patchify.fnet.*`, `patchify.inet.*`, `update.*`,
`downsample.0.*`), the layout the JAX package's
`models/convert.py:load_torch_checkpoint` reads and `DPVO(network=)`
loads; the port writes no orbax checkpoint (ROADMAP R17).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from ..models.convert import load_reference_checkpoint
from ..models.vonet import init_vonet
from ..parallel.train_step import build_train_step, make_optimizer
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
    names."""
    out = {}
    for name, t in net.state_dict().items():
        if name.startswith(("fnet.", "inet.")):
            name = "patchify." + name
        out[name.replace("downsample.", "downsample.0.")] = \
            t.detach().float().cpu().clone()
    return out


def export_torch_checkpoint(net, path):
    """Save net as a `.pth` in the reference layout; returns path."""
    torch.save(reference_state_dict(net), path)
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
          tc=None, device="cuda", seed=0):
    """The training loop on one device: a VONet from `seed`, AdamW at a
    constant lr, `dataset.batches(batch_size, steps)` (numpy batches in
    the `clip_loss_fn` layout), a checkpoint every checkpoint_every
    steps. Returns the trained network."""
    tc = tc or TrainConfig(frames=8, patches=32, steps=8)
    net = init_vonet(seed).to(device)
    step_fn = build_train_step(net, tc, make_optimizer(net.parameters(),
                                                       lr=lr), device)
    logger = Logger(name, logdir)
    generator = torch.Generator().manual_seed(1)
    try:
        for i, batch in enumerate(dataset.batches(batch_size, steps)):
            logger.push(step_fn(batch, generator))
            if (i + 1) % checkpoint_every == 0:
                save_checkpoint(net, ckptdir, i + 1)
    finally:
        logger.close()
    return net
