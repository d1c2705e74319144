"""One optimization step of the BA-in-the-loop training, on one device.

Counterpart of the JAX package's `parallel/train_step.py` without its
mesh: `clip_loss_fn` is the batch mean of the clips' losses,
`build_train_step` returns a step that runs the forward, the backward and
the optimizer, and `make_optimizer` is the JAX package's optax chain
written out: global-norm clipping as `optax.clip_by_global_norm`, then
AdamW with decoupled weight decay on every parameter, at a constant rate
or on `optax.warmup_cosine_decay_schedule`. The data-parallel and sharded
versions (DDP, FSDP) wrap `clip_loss_fn` and the optimizer; they come
with the multi-device slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import lie
from ..train.forward import TrainConfig, to_device, vonet_training_forward
from ..train.loss import total_loss


def warmup_cosine_decay(init_value, peak_value, warmup_steps, decay_steps,
                        end_value=0.0):
    """optax's `warmup_cosine_decay_schedule` as a function of the step
    count: linear from init_value to peak_value over warmup_steps, then a
    cosine from peak_value to end_value until decay_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count):
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class ClippedAdamW:
    """Global-norm clipping, then AdamW (betas 0.9 / 0.999, eps 1e-8,
    decoupled weight decay on every parameter), the learning rate of step
    `count` from `schedule`. The update is optax's, in its order of
    operations and in fp32: mu and nu moments, their bias corrections,
    mu_hat / (sqrt(nu_hat) + eps) + wd * p, times -lr, added to p."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, schedule, weight_decay, clip):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def clip_grads(self):
        """Scale every gradient by clip / norm when the global norm is not
        below clip (optax's form: g / norm * clip, no epsilon). Returns
        the norm before clipping (a device scalar: no host read)."""
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        keep = norm < self.clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip))
        return norm

    @torch.no_grad()
    def step(self):
        """Clip, then one AdamW update of the parameters in place. A
        parameter the loss did not reach gets a zero gradient (its weight
        still decays, as in optax). Returns the global gradient norm. The
        step's scalars are fp32 values held as Python floats (no copy to
        the device, so no wait for it)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.clip_grads()
        f32 = np.float32
        neg_lr = float(-f32(self.schedule(self.count)))
        self.count += 1
        bc1 = float(f32(1) - f32(self.B1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.B2) ** f32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.copy_((1 - self.B1) * g + self.B1 * mu)
            nu.copy_((1 - self.B2) * (g * g) + self.B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            u = u + self.weight_decay * p
            p.add_(u * neg_lr)
        return norm


def make_optimizer(params, lr=8e-5, wd=1e-5, clip=10.0, steps=None,
                   warmup_frac=0.05):
    """AdamW with global-norm clipping over `params`. With `steps`, `lr`
    is the peak of a linear warm-up (over warmup_frac of the run, from
    lr / 20) and a cosine decay to lr / 20; without it, constant."""
    if steps is None:
        def schedule(count):
            return lr
    else:
        warmup = max(int(steps * warmup_frac), 1)
        schedule = warmup_cosine_decay(lr / 20, lr, warmup, steps, lr / 20)
    return ClippedAdamW(params, schedule, wd, clip)


def clip_loss_fn(net, batch, generator, tc: TrainConfig, patch_coords=None,
                 init_depths=None):
    """(loss, metrics) over a batch of clips: the means of the clips'
    losses and metrics. batch holds images [B, T, H, W, 3] uint8 on the
    network's device, poses [B, T, 7], disps [B, T, H/4, W/4] and
    intrinsics [B, 4]; patch_coords [B, T, M, 2] and init_depths
    [B, T * M] replace the generator's draws when given."""
    B = batch["images"].shape[0]
    losses, metrics = [], []
    for b in range(B):
        traj = vonet_training_forward(
            net, batch["images"][b], batch["poses"][b], batch["disps"][b],
            batch["intrinsics"][b], generator, tc,
            patch_coords=None if patch_coords is None else patch_coords[b],
            init_depths=None if init_depths is None else init_depths[b])
        loss, m = total_loss(traj)
        losses.append(loss)
        metrics.append(m)
    mean = {k: torch.stack([m[k] for m in metrics]).mean()
            for k in metrics[0]}
    return torch.stack(losses).mean(), mean


def batch_to(batch, device):
    """A numpy or tensor batch as tensors on device (images stay uint8)."""
    return {k: to_device(torch.as_tensor(v), device)
            for k, v in batch.items()}


def build_train_step(net, tc: TrainConfig, optimizer, device="cuda"):
    """step(batch, generator, patch_coords=None, init_depths=None) ->
    metrics (device scalars: loss, flow_loss, pose_loss, grad_norm): the
    forward over the batch, its backward and one optimizer update of
    net's parameters in place. net must already lie on device."""
    net.train()

    def train_step(batch, generator, patch_coords=None, init_depths=None):
        optimizer.zero_grad()
        loss, metrics = clip_loss_fn(net, batch_to(batch, device),
                                     generator, tc, patch_coords,
                                     init_depths)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return train_step


def make_synthetic_batch(generator, batch_size, tc: TrainConfig, ht=48,
                         wd=64):
    """Random clip batch with the training shapes (tests, dry runs), drawn
    from generator on its device."""
    dev = generator.device
    B, T = batch_size, tc.frames
    images = torch.randint(0, 255, (B, T, ht, wd, 3), generator=generator,
                           device=dev).to(torch.uint8)
    xi = 0.01 * torch.randn(B, T, 6, generator=generator, device=dev)
    disps = 0.3 + 1.2 * torch.rand(B, T, ht // 4, wd // 4,
                                   generator=generator, device=dev)
    intr = torch.tensor([40.0, 40.0, wd / 2, ht / 2], device=dev) \
        .expand(B, 4).clone()
    return {"images": images, "poses": lie.se3_exp(xi), "disps": disps,
            "intrinsics": intr}
