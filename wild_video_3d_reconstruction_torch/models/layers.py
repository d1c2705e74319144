"""Layers whose numerics follow the JAX package's `models/layers.py`.

Convolutions and linear layers run in the input's dtype and add their bias
in fp32 before casting back; normalisations take their statistics in fp32.
Parameter names and shapes are PyTorch's (conv weight OIHW, linear weight
[out, in]); `models.convert` carries the JAX package's HWIO / [in, out]
weights across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _GradientClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.where(torch.isnan(g), 0.0, g).clamp(-0.01, 0.01)


class _GradientZero(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), 0.0, g)
        return torch.where(g.abs() > 0.1, 0.0, g)


def gradient_clip(x):
    """Identity; its backward maps NaN to 0, then clamps to [-0.01, 0.01]
    (the JAX package's `gradient_clip`, the reference's GradClip)."""
    return _GradientClip.apply(x)


def gradient_zero(x):
    """Identity; its backward maps NaN to 0, then zeroes every |g| > 0.1
    (the JAX package's `gradient_zero`, the reference's GradZero)."""
    return _GradientZero.apply(x)


class GradientClip(nn.Module):
    """`gradient_clip` as a parameter-free module (inside a Sequential
    head, whose parameter names it leaves as they were)."""

    def forward(self, x):
        return gradient_clip(x)


def _init_linear(layer, generator):
    """torch.nn.Linear's default, U(-1/sqrt(in), 1/sqrt(in)), drawn from
    an explicit generator."""
    bound = 1.0 / layer.in_features ** 0.5
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Conv2d):
    """Symmetric kernel//2 padding (torch semantics), NCHW."""

    def __init__(self, cin, cout, k, stride=1, generator=None):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2)
        # Kaiming-normal fan_out, zero bias (the encoders' initialisation)
        std = (2.0 / (k * k * cout)) ** 0.5
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        out = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                       self.padding)
        return (out.float() + self.bias.float()[:, None, None]).to(x.dtype)


class Linear(nn.Linear):
    def __init__(self, cin, cout, generator=None):
        super().__init__(cin, cout)
        _init_linear(self, generator)

    def forward(self, x):
        out = F.linear(x, self.weight.to(x.dtype))
        return (out.float() + self.bias.float()).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d (no affine, no running stats) on NCHW, fp32 stats."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
