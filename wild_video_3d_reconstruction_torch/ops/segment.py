"""Segment operations with static segment counts.

Counterpart of the JAX package's `ops/segment.py`: SoftAgg's
scatter-softmax-sum over bounded segment ids with a validity mask (the
one-hot, scatter, run-sum, member-table and sorted-cumsum forms), the
patch-neighbour links of the update operator, and the stable compaction of
the edge table.

`run_segment_sum_sorted` is the wrapper of the segmented run-sum kernel
(`csrc/runsum.cu`): the plain version for CPU tensors, the kernel for CUDA
tensors.
"""

from __future__ import annotations

import torch

from . import _native


def _global_shift(g32, valid):
    """exp(g - per-channel global max) over valid rows (0 elsewhere)."""
    g32 = torch.where(valid[:, None], g32, float("-inf"))
    gmax = g32.max(dim=0, keepdim=True).values
    gmax = torch.where(torch.isfinite(gmax), gmax, 0.0)
    return torch.where(valid[:, None], torch.exp(g32 - gmax), 0.0)


def _valid(valid, E, device):
    return torch.ones(E, dtype=torch.bool, device=device) if valid is None \
        else valid


def segment_softmax_weighted_sum_dense(f, g, seg_ids, num_segments,
                                       valid=None):
    """One-hot matmul form for bounded segment counts: the same sums as
    the scatter form, with the per-channel global max as the shift."""
    E = f.shape[0]
    valid = _valid(valid, E, f.device)
    onehot = ((seg_ids[:, None] == torch.arange(num_segments,
                                                device=f.device)[None, :])
              & valid[:, None]).float()
    e = _global_shift(g.float(), valid)
    denom = onehot.T @ e
    w = e / torch.clamp(onehot @ denom, min=1e-12)
    y = onehot @ (onehot.T @ (f.float() * w))
    return y.to(f.dtype)


def segment_softmax_weighted_sum(f, g, seg_ids, num_segments, valid=None):
    """softmax(g) within segments (per channel), weighted sum of f, read
    back per row: the scatter form. f, g [E, D]; seg_ids [E] in
    [0, num_segments); invalid rows contribute nothing and read zeros."""
    E, D = f.shape
    valid = _valid(valid, E, f.device)
    e = _global_shift(g.float(), valid)
    fe = torch.cat([f.float() * e, e], dim=1)
    # on the card in fp64, so that the order of index_add_'s atomics does
    # not show in the fp32 sums
    acc = torch.float64 if f.is_cuda else torch.float32
    acc_e = torch.zeros((num_segments, 2 * D), dtype=acc, device=f.device) \
        .index_add_(0, seg_ids.long(), fe.to(acc))[seg_ids.long()].float()
    y = acc_e[:, :D] / torch.clamp(acc_e[:, D:], min=1e-12)
    return torch.where(valid[:, None], y, 0.0).to(f.dtype)


def segment_softmax_weighted_sum_exact(f, g, seg_ids, num_segments,
                                       valid=None):
    """Per-segment max shift (three scatter passes); the oracle."""
    E, D = f.shape
    valid = _valid(valid, E, f.device)
    seg = seg_ids.long()
    g32 = torch.where(valid[:, None], g.float(), float("-inf"))
    seg_max = torch.full((num_segments, D), float("-inf"), device=f.device)
    seg_max = seg_max.scatter_reduce(0, seg[:, None].expand(E, D), g32,
                                     reduce="amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.where(valid[:, None], torch.exp(g32 - seg_max[seg]), 0.0)
    denom = torch.zeros((num_segments, D), device=f.device).index_add_(
        0, seg, e)
    w = e / torch.clamp(denom[seg], min=1e-12)
    y = torch.zeros((num_segments, D), device=f.device).index_add_(
        0, seg, f.float() * w)
    return y[seg].to(f.dtype)


def segment_softmax_weighted_sum_table(f, g, table, seg_ids, valid):
    """SoftAgg's softmax-weighted sum through a per-segment edge table.

    table [S, cap]: each segment's edge ids gathered into a row (E marks
    an empty slot), as `ba/gauss_newton.py:_group_by_patch` builds it.
    Every reduction is over axis 1 of the gathered [S, cap, D] rows, with
    the per-segment max as the shift (the oracle's numerics). f, g
    [E, D]; seg_ids [E] only serve the read-back: rows that are invalid
    or whose segment is >= S read zeros. Off every path, as in the JAX
    package (`slam/steps.py` passes no table)."""
    E, D = f.shape
    S = table.shape[0]
    member = table < E                                    # [S, cap]
    t = table.clamp(0, E - 1).long()
    g_t = torch.where(member[..., None], g.float()[t], float("-inf"))
    m = g_t.max(dim=1).values                             # [S, D]
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(member[..., None], torch.exp(g_t - m[:, None]), 0.0)
    denom = torch.clamp(e.sum(dim=1), min=1e-12)          # [S, D]
    y_seg = (e * (f.float()[t] * member[..., None])).sum(dim=1) / denom
    y_seg = torch.cat([y_seg, y_seg.new_zeros((1, D))])
    sid = torch.where(valid & (seg_ids < S), seg_ids, S).long()
    return y_seg[sid].to(f.dtype)


def segment_softmax_weighted_sum_sorted(f, g, seg_ids, num_segments, order,
                                        valid=None):
    """SoftAgg's softmax-weighted sum through a precomputed segment sort:
    one cumulative sum over the sorted rows and its differences at the
    segment boundaries in place of scatter-adds.

    order [E]: the stable argsort of where(valid & seg < num_segments,
    seg_ids, num_segments), the table sort `slam/steps.py:update_op`
    holds. The shift is the per-channel global max, as in the one-hot
    form. Off every path, as in the JAX package (a measured dead end
    there against the scatter form)."""
    E, D = f.shape
    valid = _valid(valid, E, f.device)
    e = _global_shift(g.float(), valid)                   # [E, D]
    key = torch.where(valid & (seg_ids < num_segments), seg_ids,
                      num_segments).long()
    key_s = key[order]
    bounds = torch.searchsorted(
        key_s, torch.arange(num_segments + 1, device=f.device))

    def seg_sum_sorted(x):
        c = torch.cat([x.new_zeros((1, D)), torch.cumsum(x[order], dim=0)])
        return c[bounds[1:]] - c[bounds[:-1]]             # [S, D]

    denom = seg_sum_sorted(e)
    sid = key.clamp(0, num_segments - 1)
    w = e / torch.clamp(denom[sid], min=1e-12)
    y_seg = seg_sum_sorted(f.float() * w)
    y = torch.where(valid[:, None], y_seg[sid], 0.0)
    return y.to(f.dtype)


def run_segment_sum_sorted_plain(fes, seg_sorted):
    """Per-row run totals of rows whose equal segment ids are contiguous:
    exact for runs of any length, accumulated in fp32."""
    E = seg_sorted.shape[0]
    start = torch.ones(E, dtype=torch.bool, device=fes.device)
    start[1:] = seg_sorted[1:] != seg_sorted[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    sums = torch.zeros((E, fes.shape[1]), dtype=torch.float32,
                       device=fes.device).index_add_(0, run, fes.float())
    return sums[run]


def run_first_rows(seg_sorted):
    """[E] index of the first row of each row's run of equal contiguous
    ids: a run-sum holds one total on every row of a run when out equals
    out[run_first_rows(seg)] bitwise."""
    E = seg_sorted.shape[0]
    start = torch.ones(E, dtype=torch.bool, device=seg_sorted.device)
    start[1:] = seg_sorted[1:] != seg_sorted[:-1]
    first = torch.arange(E, device=seg_sorted.device)
    return torch.cummax(torch.where(start, first, 0), 0).values


def runsum_scratch_rows(fes, seg_sorted, tile):
    """Rows of each of the run-sum kernel's two [rows, D] partial-sum
    scratch arrays, one per tile of `tile` rows (the kernel's
    `wv3d_runsum_tile()`); raises for inputs the kernel does not take: fes
    not [E, D] with D a multiple of 4 (rows of 16-byte loads), seg_sorted
    not [E]."""
    if fes.dim() != 2 or fes.shape[1] % 4:
        raise ValueError(f"run_segment_sum_sorted: fes must be [E, D] with "
                         f"D a multiple of 4, got {tuple(fes.shape)}")
    if tuple(seg_sorted.shape) != (fes.shape[0],):
        raise ValueError(f"run_segment_sum_sorted: seg_sorted of shape "
                         f"{tuple(seg_sorted.shape)} for {fes.shape[0]} rows")
    return -(-fes.shape[0] // tile)


def run_segment_sum_sorted(fes, seg_sorted):
    """fes [E, D] fp32 in segment order, seg_sorted [E] -> [E, D] fp32 run
    totals: the plain version for CPU tensors, the Hopper kernel
    (`csrc/runsum.cu`) for CUDA tensors."""
    if not fes.is_cuda:
        return run_segment_sum_sorted_plain(fes, seg_sorted)
    lib = _native.lib()
    n_tiles = runsum_scratch_rows(fes, seg_sorted, lib.wv3d_runsum_tile())
    E, D = fes.shape
    fes = fes.float().contiguous()
    seg = seg_sorted.to(torch.int32).contiguous()
    _native.require_cuda("run_segment_sum_sorted", fes, seg)
    out = torch.empty_like(fes)
    if E == 0:
        return out
    head = torch.empty((n_tiles, D), dtype=torch.float32, device=fes.device)
    tail = torch.empty_like(head)
    err = lib.wv3d_runsum(
        fes.data_ptr(), seg.data_ptr(), out.data_ptr(), head.data_ptr(),
        tail.data_ptr(), E, D, _native.stream_ptr(fes.device))
    _native.check_launch("wv3d_runsum", err)
    _native.LAUNCHES["runsum"] += 1
    return out


def segment_softmax_weighted_sum_runsum(f, g, seg_ids, num_segments, order,
                                        valid=None):
    """SoftAgg reduction as run-sums over a precomputed segment sort.

    order: [E] ordering under which the valid rows of every segment are
    contiguous, e.g. the okq_prefix BA table sort the SLAM update already
    holds. Invalid rows may sit anywhere under it (the BA sort keys dead
    rows of the table by their patch too, so they interleave with a
    patch's live rows): they contribute zero and take the run key of the
    valid row before them, so they never split a segment's run. Then the
    scatter becomes `run_segment_sum_sorted`, whose output is at once the
    segment total and its per-row read-back. Per-channel global max
    shift, fp32 sums.
    """
    E, D = f.shape
    valid = _valid(valid, E, f.device)
    use = valid & (seg_ids < num_segments)
    e = _global_shift(g.float(), valid)
    fe = torch.where(use[:, None], torch.cat([f.float() * e, e], dim=1), 0.0)
    use_s = use[order]
    key_s = seg_ids[order]
    idx = torch.arange(E, device=f.device)
    prev = torch.cummax(torch.where(use_s, idx, -1), 0).values
    run_key = torch.where(prev >= 0, key_s[prev.clamp(min=0)], -1)
    acc_sorted = run_segment_sum_sorted(fe[order], run_key.to(torch.int32))
    acc_e = torch.empty_like(acc_sorted)
    acc_e[order] = acc_sorted
    y = acc_e[:, :D] / torch.clamp(acc_e[:, D:], min=1e-12)
    return torch.where(valid[:, None], y, 0.0).to(f.dtype)


def neighbors(kk, jj, valid=None):
    """Previous/next edge of the same patch, ordered by jj (insertion
    order breaking ties); -1 where there is none."""
    E = kk.shape[0]
    dev = kk.device
    kk = kk.long()
    jj = jj.long()
    valid = _valid(valid, E, dev)
    kk_key = torch.where(valid, kk, 1 << 30)
    order = torch.argsort(jj, stable=True)
    order = order[torch.argsort(kk_key[order], stable=True)]
    kk_s = kk[order]
    valid_s = valid[order]
    idx = torch.arange(E, device=dev)
    same_prev = (idx > 0) & (kk_s == torch.roll(kk_s, 1)) & valid_s & \
        torch.roll(valid_s, 1)
    same_next = (idx < E - 1) & (kk_s == torch.roll(kk_s, -1)) & valid_s & \
        torch.roll(valid_s, -1)
    prev_sorted = torch.where(same_prev, torch.roll(order, 1), -1)
    next_sorted = torch.where(same_next, torch.roll(order, -1), -1)
    ix = torch.empty(E, dtype=torch.long, device=dev)
    jx = torch.empty(E, dtype=torch.long, device=dev)
    ix[order] = prev_sorted
    jx[order] = next_sorted
    return ix, jx


def compact_valid(valid):
    """Stable permutation moving valid entries to the front, and their
    count: rank arithmetic (two cumsums and one scatter), no sort."""
    E = valid.shape[0]
    vi = valid.long()
    c = torch.cumsum(vi, 0)
    n_valid = c[-1] if E else torch.zeros((), dtype=torch.long)
    pos = torch.where(valid, c - 1, n_valid + torch.cumsum(1 - vi, 0) - 1)
    perm = torch.empty(E, dtype=torch.long, device=valid.device)
    perm[pos] = torch.arange(E, device=valid.device)
    return perm, n_valid


def neighbors_from_sorted(order, key_s, valid_s, key_max):
    """Neighbour links from one stable sort by where(member, patch,
    key_max), scanning past dead rows; same result as `neighbors`."""
    E = order.shape[0]
    dev = order.device
    idx = torch.arange(E, device=dev)
    use = valid_s & (key_s < key_max)
    if E == 0:
        return idx, idx
    pv = torch.cummax(torch.where(use, idx, -1), 0).values
    pv_excl = torch.cat([pv.new_full((1,), -1), pv[:-1]])
    pvc = pv_excl.clamp(0, E - 1)
    ok_prev = use & (pv_excl >= 0) & (key_s[pvc] == key_s)
    prev_sorted = torch.where(ok_prev, order[pvc], -1)
    rn = torch.cummin(torch.flip(torch.where(use, idx, E), (0,)), 0).values
    nx = torch.flip(rn, (0,))
    nx_excl = torch.cat([nx[1:], nx.new_full((1,), E)])
    nxc = nx_excl.clamp(0, E - 1)
    ok_next = use & (nx_excl < E) & (key_s[nxc] == key_s)
    next_sorted = torch.where(ok_next, order[nxc], -1)
    ix = torch.empty(E, dtype=torch.long, device=dev)
    jx = torch.empty(E, dtype=torch.long, device=dev)
    ix[order] = prev_sorted
    jx[order] = next_sorted
    return ix, jx
