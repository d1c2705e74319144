"""The steady-state dispatch: the frame step captured and replayed as CUDA
graphs on the card, run eagerly on the CPU.

`steps.frame_step` has static shapes for a given edge tier and input
signature (`steps.signature`: whether the frame brings a depth prior and
a mask) and reads nothing back to the host, so on the card `StepRunner`
captures it once per tier of `steps.edge_tiers` and signature, all tiers
of a signature the first time a frame of it comes (after one eager
warm-up run per graph on a side stream, the state restored after it; all
graphs share one memory pool, and they replay one at a time on one
stream), and replays the graph of each frame's tier and signature (the
JAX package jits one step per signature). The frame's inputs (image,
intrinsics, motion-model ratio, patch centre draws, inverse depths, and
per signature the mask selection's jitter, the depth map and the mask) go
through pinned staging buffers into static device buffers, one set per
signature, that its graphs read:

  * the host copy of frame t+1 into its pinned buffer waits on the event
    of the last upload from that buffer (two buffers alternate);
  * the upload of frame t+1 into the static buffers is queued on the
    stream after frame t's replay, so it cannot overwrite inputs that
    replay has not consumed;
  * between replays the host reads the state's counters (`state.counts`)
    once, through a pinned buffer and an event: the edge count picks the
    next frame's tier (the JAX package takes it on the device with
    `lax.cond`), and the checks below use all four.

With PIPELINE_CHUNK = K > 1 `DPVO` hands K frames of one signature at
once (a change of signature flushes the frames before it): they are
staged into one pinned buffer and uploaded with one copy per input, then
each replay is preceded by a device copy of its row into the static
buffers. A shorter list (a partial tail) goes frame by frame.

CUDA events around each replay record the replay's device time per tier
(`replay_times`) and the gap the host leaves on the device between two
replays (`gaps_ms`), read once both are done.

A capture that fails raises; nothing falls back to the eager step. The
kernel wrappers count launches only when their Python runs, so the
launches each graph recorded at capture (`_native.captured_launches`) are
added to the counts on each replay.

On the CPU the same `frame_step` (and `steps.chunk_step`) runs eagerly on
the same inputs, with the same tier choice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import _native
from . import steps
from .state import FAULTS, LOG_IDX, N_EDGES, N_FRAMES, SLAMState

def graph_label(key):
    """A graph's key (tier, (has depth, has mask)) as text: "73728", or
    "73728/depth+mask" for a signature with inputs."""
    tier, (depth, mask) = key
    extra = "+".join(n for n, on in (("depth", depth), ("mask", mask)) if on)
    return f"{tier}/{extra}" if extra else str(tier)


def check_faults(faults):
    """Raise when steady frames broke the run-sum SoftAgg's segment rule
    (`steps.update_op`, `state.faults`)."""
    if faults:
        raise RuntimeError(
            f"{faults} steady frames had live edges outside the BA patch "
            "table: the run-sum SoftAgg does not hold for them")


def _state_tensors(state: SLAMState):
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


class StepRunner:
    """Runs steady frames of `steps.frame_step` on `state`, in place."""

    def __init__(self, cfg, net, state: SLAMState, ht, wd):
        self.cfg, self.net, self.state = cfg, net, state
        self.ht, self.wd = ht, wd
        self.device = state.poses.device
        self.graphed = self.device.type == "cuda"
        self.tiers = steps.edge_tiers(cfg, state.ii.shape[0], self.device)
        self.chunk = max(int(cfg.PIPELINE_CHUNK), 1)
        self.graphs = {}            # (tier, signature) -> CUDAGraph
        self.graph_launches = {}    # (tier, signature) -> launches per replay
        self.replays = {}           # (tier, signature) -> replays
        self.host_reads = 0         # counter reads between steady frames
        self.gaps = []              # ms on the device between two replays
        self.replay_times = {}      # (tier, signature) -> ms of each replay
        # True while the eager warm-up before a capture runs (its effects
        # on the state are undone): instrumentation that wraps the steps
        # can skip it
        self.warming_up = False
        self.counts_host = None
        self._counts_ready = None
        if not self.graphed:
            return
        # per signature: static inputs, two pinned buffers (and their K-row
        # counterparts), allocated with the signature's first frame
        self.inputs = {}
        self._pinned, self._pinned_k, self._chunk_dev = {}, {}, {}
        self._uploaded = {}         # (signature, buffer) -> last upload
        self._slot = 0
        self._counts_pinned = torch.zeros(4, dtype=torch.long).pin_memory()
        self.pool = torch.cuda.graph_pool_handle()
        self._gap = None            # (end of a replay, start of the next)
        self._span = None           # (key, start, end) of the last replay
        self._last_end = None

    def _shapes(self, sig):
        """FrameInputs of (shape, dtype), None where signature sig has no
        such input."""
        M = self.cfg.PATCHES_PER_FRAME
        n, jitter = steps.candidates(self.cfg, sig[1])
        hw = (self.ht, self.wd)
        return steps.FrameInputs(
            image=(hw + (3,), torch.uint8), intrinsics=((4,), torch.float32),
            fac=((), torch.float32), cand=((n, 2), torch.float32),
            given=((), torch.bool), inv_depths=((M,), torch.float32),
            jitter=((n,), torch.float32) if jitter else None,
            depth=(hw, torch.float32) if sig[0] else None,
            mask=(hw, torch.bool) if sig[1] else None)

    def _alloc(self, sig, device, k=None, pin=False):
        def one(shape, dtype):
            shape = shape if k is None else (k,) + shape
            t = torch.empty(shape, dtype=dtype, device=device)
            return t.pin_memory() if pin else t
        return steps.FrameInputs(*(None if sd is None else one(*sd)
                                   for sd in self._shapes(sig)))

    def _buffers(self, sig):
        """Allocate signature sig's buffers on its first frame."""
        if sig in self.inputs:
            return
        self.inputs[sig] = self._alloc(sig, self.device)
        self._pinned[sig] = [self._alloc(sig, "cpu", pin=True)
                             for _ in range(2)]
        if self.chunk > 1:
            self._pinned_k[sig] = [self._alloc(sig, "cpu", k=self.chunk,
                                               pin=True) for _ in range(2)]
            self._chunk_dev[sig] = self._alloc(sig, self.device,
                                               k=self.chunk)

    # ------------------------------------------------------------ counters
    def counts(self):
        """The state's counters on the host (n_frames, n_edges, log_idx,
        faults): the copy requested after the last replay, else a fresh
        read (after eager work on the state)."""
        if self._counts_ready is not None:
            self._counts_ready.synchronize()
            self._counts_ready = None
            self.host_reads += 1
            self.counts_host = self._counts_pinned.tolist()
        elif self.counts_host is None:
            self.counts_host = self.state.counts.tolist()
        return self.counts_host

    def invalidate(self):
        """The state changed outside the runner: read the counters anew."""
        if self.graphed and self._counts_ready is not None:
            self._counts_ready.synchronize()
            self._counts_ready = None
        self.counts_host = None

    def _request_counts(self):
        self._counts_pinned.copy_(self.state.counts, non_blocking=True)
        self._counts_ready = torch.cuda.Event()
        self._counts_ready.record()

    # --------------------------------------------------------------- frames
    def run(self, rows):
        """Track the frames of `rows`, each a FrameInputs of host values
        (image [H, W, 3] uint8 numpy, intrinsics [4], fac, then
        `steps.draw_inputs`' draws, depth [H, W] or None, mask [H, W] or
        None) as `DPVO` makes them, all of one signature."""
        sig = steps.signature(rows[0].depth, rows[0].mask)
        if any(steps.signature(r.depth, r.mask) != sig for r in rows):
            raise ValueError("a chunk of frames of more than one signature")
        shapes = self._shapes(sig)
        if not self.graphed:
            chunk = steps.FrameInputs(*(
                None if sd is None else
                torch.stack([torch.as_tensor(v, dtype=sd[1]) for v in col])
                for sd, col in zip(shapes, zip(*rows))))
            steps.chunk_step(self.cfg, self.net, self.state, chunk,
                             self._tier_of)
            self.counts_host = None
            return
        self._buffers(sig)
        if len(rows) == self.chunk > 1:
            staged = self._stage(rows, sig)
            for i in range(len(rows)):
                for dst, src in zip(self.inputs[sig], staged):
                    if dst is not None:
                        dst.copy_(src[i], non_blocking=True)
                self._replay(sig)
        else:
            for row in rows:
                self._stage([row], sig)
                self._replay(sig)

    def _tier_of(self, state):
        """The eager path's tier: read the counters, check, choose."""
        self.counts_host = state.counts.tolist()
        self.host_reads += 1
        return self._checked_tier()

    def _checked_tier(self):
        cfg = self.cfg
        n_frames, n_edges, log_idx, faults = (
            self.counts()[i] for i in (N_FRAMES, N_EDGES, LOG_IDX, FAULTS))
        E = self.state.ii.shape[0]
        need = n_edges + steps.appended_rows(cfg)
        check_faults(faults)
        if n_frames + 1 >= cfg.BUFFER_SIZE:
            raise RuntimeError("buffer full: increase cfg.BUFFER_SIZE "
                               "(--buffer)")
        if log_idx >= self.state.log.shape[0]:
            raise RuntimeError(f"device event log full: increase "
                               f"cfg.LOG_CAP (= {cfg.LOG_CAP}) above the "
                               "input frame count")
        if need > E:
            raise RuntimeError(f"edge table full ({n_edges} + "
                               f"{steps.appended_rows(cfg)} rows > {E})")
        return steps.choose_tier(self.tiers, need)

    def _stage(self, rows, sig):
        """Host rows -> pinned buffer -> device (the static inputs of
        signature sig for one row, its chunk buffer for K). Returns the
        device buffers."""
        k = len(rows)
        slot = self._slot
        self._slot ^= 1
        if self._uploaded.get((sig, slot)) is not None:
            self._uploaded[sig, slot].synchronize()
        if k == 1:
            pinned, dev = self._pinned[sig][slot], self.inputs[sig]
            for buf, v in zip(pinned, rows[0]):
                if buf is not None:
                    buf.copy_(torch.as_tensor(v))
        else:
            pinned, dev = self._pinned_k[sig][slot], self._chunk_dev[sig]
            for i, row in enumerate(rows):
                for buf, v in zip(pinned, row):
                    if buf is not None:
                        buf[i].copy_(torch.as_tensor(v))
        for d, p in zip(dev, pinned):
            if d is not None:
                d.copy_(p, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._uploaded[sig, slot] = ev
        return dev

    def _replay(self, sig):
        tier = self._checked_tier()     # waits for the last replay
        if (tier, sig) not in self.graphs:
            self.capture(sig)
        self._take_gap()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graphs[tier, sig].replay()
        self.replays[tier, sig] = self.replays.get((tier, sig), 0) + 1
        if self._last_end is not None:
            self._gap = (self._last_end, start)
        self._last_end = torch.cuda.Event(enable_timing=True)
        self._last_end.record()
        self._span = ((tier, sig), start, self._last_end)
        _native.add_launches(self.graph_launches[tier, sig])
        self._request_counts()

    def _take_gap(self):
        """Record the gap before the last replay and the last replay's
        time (their events are done once the counters of that replay were
        read)."""
        if self._gap is not None:
            self.gaps.append(self._gap[0].elapsed_time(self._gap[1]))
            self._gap = None
        if self._span is not None:
            key, a, b = self._span
            self.replay_times.setdefault(key, []).append(a.elapsed_time(b))
            self._span = None

    # -------------------------------------------------------------- capture
    def capture(self, sig):
        """Capture the frame step of signature sig once per tier, on the
        current inputs. The state comes out as it went in."""
        for tier in self.tiers:
            self._capture(tier, sig)

    def _capture(self, tier, sig):
        tensors = _state_tensors(self.state)
        saved = [t.clone() for t in tensors]
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        self.warming_up = True
        try:
            with torch.cuda.stream(side):
                steps.frame_step(self.cfg, self.net, self.state,
                                 self.inputs[sig], tier)
        finally:
            self.warming_up = False
        cur.wait_stream(side)
        for t, s in zip(tensors, saved):
            t.copy_(s)
        del saved
        graph = torch.cuda.CUDAGraph()
        with _native.captured_launches() as launches, \
                torch.cuda.graph(graph, pool=self.pool):
            steps.frame_step(self.cfg, self.net, self.state,
                             self.inputs[sig], tier)
        self.graph_launches[tier, sig] = launches
        self.graphs[tier, sig] = graph

    def gaps_ms(self):
        """Device-timeline gaps between consecutive replays (ms): the end of
        one replay to the start of the next, the upload of the next frame's
        inputs and the host's work between frames included."""
        if self._last_end is not None:
            self._last_end.synchronize()
            self._take_gap()
        return list(self.gaps)
