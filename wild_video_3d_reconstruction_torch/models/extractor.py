"""The stride-4 residual CNN encoder (`basic_encoder4`).

Counterpart of the JAX package's `models/extractor.py`: 7x7/2 stem,
two residual stages (the second at stride 2), 1x1 output conv, with
'instance' normalisation for the matching net and 'none' for the context
net. NCHW inside; `models.vonet.encode_frame` returns channel-last maps.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, instance_norm

DIM = 32


def _norm(x, norm_fn):
    if norm_fn == "instance":
        return instance_norm(x)
    if norm_fn == "none":
        return x
    raise NotImplementedError(f"norm_fn={norm_fn}")


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, stride, norm_fn, generator=None):
        super().__init__()
        self.norm_fn = norm_fn
        self.stride = stride
        self.conv1 = Conv2d(cin, cout, 3, stride, generator)
        self.conv2 = Conv2d(cout, cout, 3, 1, generator)
        if stride != 1:
            self.downsample = Conv2d(cin, cout, 1, stride, generator)

    def forward(self, x):
        y = torch.relu(_norm(self.conv1(x), self.norm_fn))
        y = torch.relu(_norm(self.conv2(y), self.norm_fn))
        if self.stride != 1:
            x = _norm(self.downsample(x), self.norm_fn)
        return torch.relu(x + y)


class BasicEncoder4(nn.Module):
    """x [N, 3, H, W] -> [N, output_dim, H/4, W/4]."""

    def __init__(self, output_dim, norm_fn, generator=None):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = Conv2d(3, DIM, 7, 2, generator)
        self.layer1 = nn.Sequential(
            ResidualBlock(DIM, DIM, 1, norm_fn, generator),
            ResidualBlock(DIM, DIM, 1, norm_fn, generator))
        self.layer2 = nn.Sequential(
            ResidualBlock(DIM, 2 * DIM, 2, norm_fn, generator),
            ResidualBlock(2 * DIM, 2 * DIM, 1, norm_fn, generator))
        self.conv2 = Conv2d(2 * DIM, output_dim, 1, 1, generator)

    def forward(self, x):
        x = torch.relu(_norm(self.conv1(x), self.norm_fn))
        x = self.layer2(self.layer1(x))
        return self.conv2(x)
