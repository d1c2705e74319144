"""Multi-device inference: the tracked frame's O(E) region sharded on edges.

Counterpart of the JAX package's `parallel/infer_shard.py`. Reprojection,
the correlation pyramid, the update operator and the Gauss-Newton
accumulation are per edge, while the feature maps, poses and patches are
small enough to replicate. The JAX package shards that region with
`shard_map` over a 1-D "edges" mesh; torch has none, so here it is SPMD
with explicit collectives over the mesh's process group, through the
hooks of the one update path (`slam.steps.update_op(shard=)`):

  * every rank holds the whole (replicated) SLAM state;
  * rank r takes the contiguous rows [r E / n, (r + 1) E / n) of the edge
    table, padded with invalid rows to a multiple of n (`EdgeShard.rows`);
  * the correlation runs on the rank's rows through `ops.corr.corr_lookup`
    (on the card: the correlation kernel of `csrc/corr_box.cu`);
  * the update operator's two cross-edge couplings become collectives:
    the neighbour messages read an all-gathered hidden state
    (`all_gather_into_tensor`), and SoftAgg's channel max and segment sums
    are all-reduced (MAX, then SUM). The shard's segment sums are
    `index_add_` scatters (JAX: one-hot matmuls; the run-sum kernel is not
    used here, its runs are those of the whole table);
  * BA adds each rank's partial system through `_bundle_adjust_impl`'s
    `ar=` hook (an all-reduce SUM), so every rank solves the same one and
    the poses and patches stay replicated.

As in the JAX package the BA patch table is shard-local with the global
rows' membership, which equals the global table while no patch overflows
its cap: the sharded path serves post-initialization states only (the
bootstrap's table can overflow). The neighbour links come from
`update_op`'s own sort of the whole table (ROADMAP R28: the JAX sharded
path's `neighbors()` orders the warm-up's duplicate edges, R1, otherwise).
Every function is called by every rank of the mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.corr import RADIUS, corr_lookup
from ..slam import steps


def make_edge_mesh(n_devices=None, device="cuda"):
    """The 1-D ("edges",) `DeviceMesh` over the process group's ranks
    (`parallel.mesh.init_distributed` first)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if n != dist.get_world_size():
        raise ValueError(f"make_edge_mesh({n}): the process group has "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(torch.device(device).type, (n,),
                            mesh_dim_names=("edges",))


def _shard(x, rank, E_loc, fill=0):
    """Rows [rank E_loc, (rank + 1) E_loc) of x, padded with `fill`, in a
    tensor of their own where they do not start x (the kernels take
    16-byte aligned data)."""
    lo, hi = rank * E_loc, (rank + 1) * E_loc
    part = x[lo:min(hi, x.shape[0])]
    if part.shape[0] == E_loc:
        return part.clone() if lo else part
    pad = part.new_full((E_loc - part.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([part, pad])


class EdgeShard:
    """The hooks of `slam.steps.update_op(shard=)` over an edge mesh's
    group: this rank's rows of a table and the collectives that join
    them."""

    def __init__(self, mesh):
        self.group = mesh.get_group()
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def rows(self, x, fill=0):
        """The rank's rows of a table x (E rows, padded with `fill` to a
        multiple of the world size)."""
        return _shard(x, self.rank, -(-x.shape[0] // self.world), fill)

    def gather(self, x, n):
        """The first n rows of every rank's rows x, in rank order."""
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out[:n]

    def gather_rows(self, x, ix):
        """Rows ix (global row ids) of the table whose rank rows are x."""
        return self.gather(x, self.world * x.shape[0])[ix]

    def all_reduce(self, x):
        """x summed over the ranks (BA's `ar=`)."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def soft_agg(self, agg, x, seg_ids, num_segments, valid, **_):
        """SoftAgg (`models.update.SoftAgg`) with its reductions over the
        group: f / g / h and the per-edge exp run on the rank's rows; the
        per-channel max over all valid rows (all-reduce MAX, non-finite ->
        0) shifts the exponent; each segment's sums of exp(g) f and exp(g)
        are shard partials (`index_add_`, in fp64 on the card so that the
        atomics' order does not show) all-reduced in one SUM. Invalid rows
        read 0."""
        f, g = agg.f(x), agg.g(x)
        D = f.shape[1]
        g32 = torch.where(valid[:, None], g.float(), float("-inf"))
        gmax = g32.max(dim=0, keepdim=True).values
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=self.group)
        gmax = torch.where(torch.isfinite(gmax), gmax, 0.0)
        e = torch.where(valid[:, None], torch.exp(g32 - gmax), 0.0)
        acc = torch.float64 if f.is_cuda else torch.float32
        seg = torch.where(valid, seg_ids.long(), num_segments)
        sums = torch.zeros((num_segments + 1, 2 * D), dtype=acc,
                           device=f.device)
        sums.index_add_(0, seg, torch.cat([f.float() * e, e], dim=1).to(acc))
        sums = self.all_reduce(sums).float()
        y = sums[:, :D] / torch.clamp(sums[:, D:], min=1e-12)
        y = torch.where(valid[:, None], y[seg], 0.0)
        return agg.h(y.to(x.dtype))


def sharded_patch_corr(mesh, gmap, pyramid, coords, kk, jj, valid,
                       radius=RADIUS, chunk=512, gather=True):
    """Edge-sharded `corr_lookup`: the same contract and result, each rank
    computing its rows (E padded with invalid rows to a multiple of the
    mesh's size). gather=False returns the rank's rows of the padded
    table."""
    if radius != RADIUS:
        raise ValueError(f"sharded_patch_corr: radius {radius}; the "
                         f"correlation has {RADIUS}")
    shard = EdgeShard(mesh)
    out = corr_lookup(gmap, pyramid, shard.rows(coords, 0.0),
                      shard.rows(kk), shard.rows(jj),
                      shard.rows(valid, False), chunk=chunk)
    return shard.gather(out, coords.shape[0]) if gather else out


@torch.no_grad()
def sharded_update_op(mesh, cfg, net, state, t0, n_rows=None):
    """`slam.steps.update_op` (reproject -> correlate -> update operator
    -> 2 Gauss-Newton iterations over the poses [t0, n)) over the first
    n_rows rows of the edge table, sharded on edges over `mesh`; writes
    the same state on every rank and returns it."""
    return steps.update_op(cfg, net, state, t0, n_rows=n_rows,
                           shard=EdgeShard(mesh))


@torch.no_grad()
def sharded_frame_step(mesh, cfg, net, state, inputs, n_rows):
    """`slam.steps.frame_step` with its update sharded on edges:
    `insert_frame`, `append_edges` and `keyframe_and_log` replicated, in
    place on every rank's state. n_rows: the tier holding the edges after
    the append."""
    return steps.frame_step(cfg, net, state, inputs, n_rows,
                            shard=EdgeShard(mesh))
