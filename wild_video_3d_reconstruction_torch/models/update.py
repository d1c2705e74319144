"""The recurrent update operator over patch-graph edges.

Counterpart of the JAX package's `models/update.py`: correlation encoder
MLP -> LayerNorm -> sequential temporal message passing (c1 over the
previous edge of the same patch, then c2 over the next one, reading the
c1-updated state) -> SoftAgg over same-patch and same-frame-pair groups ->
2x (LayerNorm + gated residual) -> flow-delta and confidence heads.
Submodule names follow the JAX parameter tree, so `models.convert` maps
one onto the other name for name.

The two heads end in `gradient_clip` (identity forward; the backward
clamps to [-0.01, 0.01]), as the JAX package's do, so training clips their
gradients and inference computes what it did without them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import (segment_softmax_weighted_sum,
                           segment_softmax_weighted_sum_dense,
                           segment_softmax_weighted_sum_runsum,
                           segment_softmax_weighted_sum_table)
from .layers import GradientClip, LayerNorm, Linear

DIM = 384


def _mlp2(g):
    return nn.Sequential(Linear(DIM, DIM, g), nn.ReLU(), Linear(DIM, DIM, g))


class GatedResidual(nn.Module):
    """x + sigmoid(gate(x)) * res(x)."""

    def __init__(self, g=None):
        super().__init__()
        self.gate = nn.Sequential(Linear(DIM, DIM, g), nn.Sigmoid())
        self.res = _mlp2(g)

    def forward(self, x):
        return x + self.gate(x) * self.res(x)


class SoftAgg(nn.Module):
    """h(sum over the segment of softmax(g(x)) * f(x)), read back per row.

    The per-patch groups take the run-sum path when the caller holds their
    segment sort (`order`), else the member-table form when it holds
    their [S, cap] edge table (`table`); otherwise bounded segment counts
    take the one-hot form and larger ones the scatter form, as in the JAX
    package.
    """

    def __init__(self, g=None):
        super().__init__()
        self.f = Linear(DIM, DIM, g)
        self.g = Linear(DIM, DIM, g)
        self.h = Linear(DIM, DIM, g)

    def forward(self, x, seg_ids, num_segments, valid, order=None,
                table=None):
        f, g = self.f(x), self.g(x)
        if order is not None:
            y = segment_softmax_weighted_sum_runsum(f, g, seg_ids,
                                                    num_segments, order,
                                                    valid=valid)
        elif table is not None:
            y = segment_softmax_weighted_sum_table(f, g, table, seg_ids,
                                                   valid)
        elif num_segments <= 4096:
            y = segment_softmax_weighted_sum_dense(f, g, seg_ids,
                                                   num_segments, valid=valid)
        else:
            y = segment_softmax_weighted_sum(f, g, seg_ids, num_segments,
                                             valid=valid)
        return self.h(y)


class UpdateOperator(nn.Module):
    def __init__(self, patch_size=3, generator=None):
        super().__init__()
        g = generator
        p = patch_size
        self.c1 = _mlp2(g)
        self.c2 = _mlp2(g)
        self.norm = LayerNorm(DIM, eps=1e-3)
        self.agg_kk = SoftAgg(g)
        self.agg_ij = SoftAgg(g)
        self.gru = nn.Sequential(LayerNorm(DIM, eps=1e-3), GatedResidual(g),
                                 LayerNorm(DIM, eps=1e-3), GatedResidual(g))
        self.corr = nn.Sequential(
            Linear(2 * 49 * p * p, DIM, g), nn.ReLU(), Linear(DIM, DIM, g),
            LayerNorm(DIM, eps=1e-3), nn.ReLU(), Linear(DIM, DIM, g))
        self.d = nn.Sequential(nn.ReLU(), Linear(DIM, 2, g), GradientClip())
        self.w = nn.Sequential(nn.ReLU(), Linear(DIM, 2, g), GradientClip())

    def forward(self, net, inp, corr, kk_seg, ij_seg, nbr_ix, nbr_jx, valid,
                num_kk_segments, num_ij_segments, kk_order=None,
                kk_table=None):
        net = net + inp + self.corr(corr)
        net = self.norm(net)

        mask_ix = ((nbr_ix >= 0) & valid).to(net.dtype)[:, None]
        mask_jx = ((nbr_jx >= 0) & valid).to(net.dtype)[:, None]
        # sequential message passing: the c2 gather reads the c1 update
        net = net + self.c1(mask_ix * net[nbr_ix.clamp(min=0)])
        net = net + self.c2(mask_jx * net[nbr_jx.clamp(min=0)])

        net = net + self.agg_kk(net, kk_seg, num_kk_segments, valid,
                                order=kk_order, table=kk_table)
        net = net + self.agg_ij(net, ij_seg, num_ij_segments, valid)
        net = self.gru(net)
        delta = self.d(net)
        weight = torch.sigmoid(self.w(net))
        return net, delta.float(), weight.float()


def update_forward(update, net, inp, corr, kk_seg, ij_seg, nbr_ix, nbr_jx,
                   valid, num_kk_segments, num_ij_segments, kk_table=None,
                   kk_order=None):
    """One update step over all edges -> (net', delta [E, 2], weight
    [E, 2]); the JAX package's `update_forward` with the module in place
    of its parameter tree. kk_table: the per-patch groups' [S, cap] edge
    table (`_group_by_patch`), taken when no kk_order is given."""
    return update(net, inp, corr, kk_seg, ij_seg, nbr_ix, nbr_jx, valid,
                  num_kk_segments, num_ij_segments, kk_order=kk_order,
                  kk_table=kk_table)
