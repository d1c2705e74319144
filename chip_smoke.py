"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels, holds each against its plain PyTorch
version at default-config shapes (the correlation body of both routes also
on patches spread wide enough to take its per-pixel path and the region
spill path), drives the entry points of the kernels that no VO path runs
(the split region pair, the Cholesky solve), then drives the DPVO main path
(warm-up, motion probe, 12-iteration bootstrap, steady-state frames
replayed as CUDA graphs, terminate, TUM export) at configs/default.yaml and
configs/fast.yaml, each unfused and with `PALLAS_FUSED: true`, on 384x512
synthetic frames with weights drawn from a seed; the steady loop after the
first graph replay runs under `torch.cuda.set_sync_debug_mode("error")`.
It checks small runs on the card through graph replay (unfused, fused x32,
fused x16) against the same runs on the CPU and through `sync_mode` on the
card, and the default.yaml graph run against two `sync_mode` runs.

Then the trained weights (`weights/vonet_synth_tpu_r3_step2000.pth`):
they load on the card (`weights`: size, parameters, checksum); the
wild-video path at full width (`slam_default_wild`: default.yaml at
384x512 on the rendered world of `eval/synth_ate.py:wild_sequence` with
its metric depth as the prior and a moving occluder's mask on every
frame, replayed and in `sync_mode`, poses bitwise equal, the Sim(3) ATE
against the ground truth); fast.yaml with keypoint patches on the same
images (`slam_fast_keypoints`); and `eval/synth_ate.run`'s protocol on
the card (`synth_ate_tiny`: the ATE below the identity floor; then the
same protocol cut to SHORT_FRAMES frames on the card and on the CPU with
the same numpy draws, every frame's pose within TOL_SHORT_POSE).

Then a run that keeps keyframes (`slam_default_wild_keep`): the same
walk at KEEP_STRIDE times its motion per frame (`wild_sequence(stride=)`)
at default.yaml with ENABLE_GLOBAL_BA, replayed and in `sync_mode`
(bitwise equal), failing unless steady frames are both kept and dropped
and a replay runs above tier 0; global BA at terminate on both runs'
states through the correlation body of `csrc/corr_box.cu` (the plain
correlation never called, the ATE after it below the floor); the map
(`points_and_colors`) written as PLY and as COLMAP text and binary models
and read back equal; and the replayed run saved at a steady frame after a
keep (`slam/checkpoint.py`), resumed in a new DPVO and finished, its
trajectory bitwise equal to the uninterrupted run's.

Then the loop closure (`loop_multilap`): two laps of a rendered circuit
(`render_sequence(path="multiloop")`, 96 frames at 384x512) at
default.yaml with the trained weights, every frame kept, the loop closure
off (replayed), on (replayed, the VLAD descriptors written inside the
captured step) and on in `sync_mode`; it fails unless the descriptors
drained from the card match the same frames' recomputed ones, every frame
is accounted for once, the trajectories are finite, a candidate reached
verification, every steady frame replayed, `run_pgo` on the card equals
the CPU's and 8 frames replay after a PGO write-back; whether a closure
was applied, the revisit gap and the ATE off and on are printed. The
scenes' host renders run in worker processes from the start.

Then camera initialization and the dense engine, on the same scenes:
the geometric bootstrap (`bootstrap_wild`: `track_grid` on the wild
walk's first 8 frames on the card against the CPU,
`geometric_initialization` with its rotation error, then
`bootstrap_slam` into a default.yaml DPVO after those frames, its
written slots equal to `init_from_prior` on a CPU copy, frame 0 the
identity, the storages unchanged, the run's ATE beside one without it);
the self-calibration of the stride-4 walk on the card against the CPU
(`calib_keep`: the same frames, the focal within 1%) and the wild run
with the estimated intrinsics (`slam_wild_calibrated`, its ATE beside
the true calibration's); the dense engine (`droid_keep`: `DenseVO` over
24 frames of the stride-4 walk, ms per frame, peak memory, ATE; card
against CPU at 96x128 with both flows, each frame from the CPU's state).

Then VONet training on the card: the correlation's backward kernel
(`kernel_corr_backward`, `csrc/corr_grad.cu`) against autograd through
the plain version at the full training shape (T = 8, M = 32, 2048 edges,
fp32 maps of 384x512 frames), with the forward's fp32 instantiation held
against its plain version there too; one training step on the card
against the same step on the CPU (`train_step_card_vs_cpu`: loss, every
parameter's gradient, the parameters after the AdamW step);
`eval/learn_synth.py`'s recipe from a seed-0 network for TRAIN_LS_STEPS
steps (`train_learn_synth`: every loss finite, the held-out EPE falling;
the trained checkpoint's EPE on the same clips beside the JAX package's
reading of it); and `trainer.train`'s default configuration at 384x512
(`train_full`: ms per step, peak memory, the backward kernel's share).

Then the NeRF back half and the whole chain: a rendered 384x512 frame
and a mask through `io/png.py` and back, bitwise (`png_roundtrip`); 3
steps of `nerf/train_native.train` and of `train_refine` (with the
eval-pose alignment) on the card and on the CPU with the same draws
(`nerf_card_vs_cpu`: the losses, the first step's gradients against
their norm, the table gradient twice on the card, the held-out view
after the steps); `train` at its own defaults on `synth_scene(frames=16)`
at 384x512 for 2000 steps (`nerf_native`: PSNR before and after, +3 dB
and above 14 dB required, ms a step, kernels and device ms a step, peak
memory, the hash encoding's forward plus backward and its share of a
step); `eval/recon_e2e.run` at 384x512 over 40 frames of the walk with
the trained weights, the PNG directory read by the demo on the card,
once with the refined trainer and its eval-pose alignment (`recon_e2e`)
and once with the plain one (`recon_e2e_plain`): the ATE below its
identity floor, the transforms.json read back, the held-out PSNR before
and after training on the run's poses (printed: at this width it stays
within 0.1 dB, in the JAX package too), the same NeRF stage on the
ground-truth poses through the same export rising by RECON_GT_GAIN dB
and, refined, the eval-pose-aligned PSNR above the untrained field's;
seconds per stage; and from the refined field (`nerf_render`) a saved and
reloaded checkpoint rendering bitwise the same view, 8 interpolated
views to PNG and a point cloud to PLY, each read back.

Then the evaluation drivers: `eval/harness.py`'s TUM protocol at TUM's
own 480x640 (`harness_tum`: 48 frames of the seed-0 walk rendered in a
worker and written as a TUM-layout directory, `harness.evaluate("tum")`
with configs/tum.yaml and the trained weights, the calibration table
patched to the renderer's camera; the ATE below its identity floor, the
whole run's FPS, the correlation and run-sum kernels launched; then the
same directory streamed with the real TUM fr1 calibration, which must
remap the content), kernels #1 and #3 timed again at that shape
(`kernels_harness_shape`: 480x640 maps, tum.yaml's first edge tier), the
EuRoC protocol on 8-bit gray PNGs at 480x752 with configs/fast.yaml
(`harness_euroc`), the dense engine's `run_tum` on the TUM directory
(`droid_tum`: ms a frame), `synth_suite`'s full protocol (the trained
mean below the floor; then a short run of one scene, the trained column,
on the card and on the CPU with the same numpy draws: every frame's pose
within TOL_SHORT_POSE), the calibration sweep (`calib_sensitivity`: the oracle
at its defaults, captured in the replayed step, 0% below 5e-3, 5% below
0.05 and above 0%, card against CPU; the network sweep, and short runs
at 0% and 5% held card against CPU as the suite's), `loop_recall` and `matcher_recall` on the card
against the CPU, and the demo on a JPEG directory and an .mp4 through
`scripts/torch_cv2_report.py --demo` (`demo_cv2_inputs`: OpenCV's
version and video backend as well).

The kernel counts include the launches of every graph replay. Each VO run
also reports the share of its correlation edge-levels that took the
per-pixel path. Each phase prints one JSON line; the kernel summary and
then the result line come last. Any failure exits non-zero without the
result line; so does a machine without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import faulthandler
import functools
import hashlib
import importlib.util
import io
import json
import multiprocessing
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from wild_video_3d_reconstruction_torch.ba import gauss_newton as tba
from wild_video_3d_reconstruction_torch.eval import calib_sensitivity as tcs
from wild_video_3d_reconstruction_torch.eval import droid_harness as tdroid
from wild_video_3d_reconstruction_torch.eval import harness as tharness
from wild_video_3d_reconstruction_torch.eval import learn_synth
from wild_video_3d_reconstruction_torch.eval import loop_recall as tlr
from wild_video_3d_reconstruction_torch.eval import matcher_recall as tmr
from wild_video_3d_reconstruction_torch.eval import metrics as tmetrics
from wild_video_3d_reconstruction_torch.eval import recon_e2e as trecon
from wild_video_3d_reconstruction_torch.eval import synth_ate
from wild_video_3d_reconstruction_torch.eval import synth_suite as tss
from wild_video_3d_reconstruction_torch.eval.loop_ate import revisit_gap_lap
from wild_video_3d_reconstruction_torch.init import colmap_init as tci
from wild_video_3d_reconstruction_torch.init import farneback as tfb
from wild_video_3d_reconstruction_torch.init import mast3r_init as tmi
from wild_video_3d_reconstruction_torch.init import prior_init as tpi
from wild_video_3d_reconstruction_torch.io import colmap_model, export
from wild_video_3d_reconstruction_torch.io import png as tpng
from wild_video_3d_reconstruction_torch.io import stream as tstream
from wild_video_3d_reconstruction_torch.loop import longterm as tlong
from wild_video_3d_reconstruction_torch.loop import pgo as tpgo
from wild_video_3d_reconstruction_torch.loop.netvlad import (
    VLADDescriptor, fit_centers_from_images, vlad_extract)
from wild_video_3d_reconstruction_torch.models import vonet
from wild_video_3d_reconstruction_torch.models.convert import \
    load_reference_checkpoint
from wild_video_3d_reconstruction_torch.nerf import ngp as tngp
from wild_video_3d_reconstruction_torch.nerf import render as trender
from wild_video_3d_reconstruction_torch.nerf import train_native as tnt
from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops import chol as tchol
from wild_video_3d_reconstruction_torch.ops import corr as tcorr
from wild_video_3d_reconstruction_torch.ops import lie
from wild_video_3d_reconstruction_torch.ops import corr_region as tregion
from wild_video_3d_reconstruction_torch.ops import dense as tdense
from wild_video_3d_reconstruction_torch.ops.corr import (
    LEVELS, box_plan, corr_lookup, patch_corr_pyramid)
from wild_video_3d_reconstruction_torch.ops.segment import (
    run_first_rows, run_segment_sum_sorted, run_segment_sum_sorted_plain)
from wild_video_3d_reconstruction_torch.parallel import train_step as tts
from wild_video_3d_reconstruction_torch.slam import DPVO, steps
from wild_video_3d_reconstruction_torch.slam import global_ba as tgba
from wild_video_3d_reconstruction_torch.slam.checkpoint import (load_slam,
                                                                save_slam)
from wild_video_3d_reconstruction_torch.slam.graphs import graph_label
from wild_video_3d_reconstruction_torch.slam.state import edge_rows
from wild_video_3d_reconstruction_torch.train.forward import (
    TrainConfig, all_pairs_edges)
from wild_video_3d_reconstruction_torch.train.synth import (
    make_world_batch, render_clip, render_sequence)
from wild_video_3d_reconstruction_torch.utils.config import (
    DPVOConfig, load_config)

# the script's own stop, below the 1200 s a run may take (its native
# backstop 30 s later): the whole script reads 584 s on an H100, but its
# CPU-side phases move with its host's CPU, which it shares (one run went
# past 900 s where others read 692-760 s, before the cuts of PERF.md §4)
DEADLINE_S = 1080
T0 = time.perf_counter()


def emit(phase, **kw):
    kw = {"phase": phase, **kw,
          "elapsed_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(kw), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    stop_renders()
    sys.exit(1)


# the background renders (`start_renders`): worker processes to stop on
# every way out
RENDER_POOL = []


def stop_renders():
    for pool in RENDER_POOL:
        # a pool that has shut down holds None in place of its processes
        for proc in list((getattr(pool, "_processes", None) or {}).values()):
            proc.kill()
        pool.shutdown(wait=False, cancel_futures=True)


def _deadline(signum, frame):
    print(f"chip_smoke: deadline of {DEADLINE_S} s reached; stopping",
          file=sys.stderr, flush=True)
    stop_renders()
    os._exit(124)


DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
HT, WD = 384, 512
E_KERNEL = 55296                 # default config's first edge tier (25%)
E_FAST = 7168                    # fast config's steady live edges (~7 k)
TOL_CORR_ABS = 1e-2
TOL_RUNSUM_REL = 1e-5
TOL_SLAM_TINY = 1e-2
TOL_GRAPH_SYNC = 1e-4
TOL_CHOL_RTOL, TOL_CHOL_ATOL = 2e-4, 2e-5   # the JAX package's chol test
CHOL_DIMS = (54, 72, 256)
WEIGHTS = "weights/vonet_synth_tpu_r3_step2000.pth"
WEIGHTS_PARAMETERS = 3384324
WILD_FRAMES = 40
# slam_default_wild_keep: every KEEP_STRIDE-th frame of a walk of
# WILD_FRAMES * KEEP_STRIDE steps (`wild_sequence(stride=)`), the smallest
# of 4, 6, 8 whose steady frames cross KEYFRAME_THRESH on some frames and
# not on others (`scripts/torch_wild_stride.py` on the CPU). The keep does
# not hang on one crossing: the flow metric rises frame by frame from a
# fixed anchor until a keep, and the same scene still keeps a frame with
# the threshold raised by 20% (the script's `--keyframe-thresh` on the
# card, PERF.md section 6). A buffer that holds every frame of the run
# (ENABLE_GLOBAL_BA sizes the rings to it).
KEEP_STRIDE = 4
KEEP_BUFFER = 64
# loop_multilap: two laps of render_sequence(path="multiloop"), every frame
# kept; 96 frames, the least the issue allows: the host renders a 384x512
# frame in about 0.6 s (56 s for the 96 on the build box's CPU), in a
# worker process while the earlier phases run. The buffer holds the run
# and the 8 frames replayed after a PGO write-back.
MULTILAP_FRAMES = 96
MULTILAP_LAP = MULTILAP_FRAMES // 2
MULTILAP_AFTER = 8
TOL_PGO_CARD_CPU = 1e-4
TOL_DESC_COS = 0.99


def time_ms(fn, reps=20, warmup=3):
    """Median of `reps` launches after `warmup`, each timed with CUDA
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, reps=20, warmup=3):
    """Time per call of `reps` calls back to back between two CUDA events.
    Unlike `time_ms`, the host's work in one call overlaps the device's
    work of the one before, so the reading leaves out the host time that
    `time_ms` counts, unless the host is the slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=20):
    """Device time per call: `reps` calls captured in one CUDA graph (the
    wrapper's Python runs only while capturing), the graph replayed
    between two CUDA events; the median of 5 replays, over `reps`."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return time_ms(g.replay, reps=5, warmup=1) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(line, flush=True)
    # fp32 products and convolutions in full fp32 (no TF32) for the
    # comparisons against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=line, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32=False)
    return line


def phase_build():
    _native.build()
    info = dict(_native.BUILD_INFO)
    _native.lib()
    usage = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", nvcc_s=info["seconds"] if info["seconds"] is not None
         else "cached", library=os.path.relpath(info["path"]),
         ptxas=usage)


def corr_inputs(gen, M=384, E=E_KERNEL, spread=1.0, ht=HT, wd=WD):
    """Default-config shapes: pmem=36 ring slots of M=384 patches, /4 and
    /16 maps of a 384x512 frame (or ht x wd), E_KERNEL edges whose 3x3
    patches sit at random centres with a random flow (some reach past the
    border). The patch pixels lie `spread` px apart (1: every window fits
    the region kernels' regions; 6: a 12 px spread, past the regions)."""
    pmem = 36
    h4, w4 = ht // 4, wd // 4

    def randn(*shape):
        return (0.25 * torch.randn(*shape, generator=gen)).to(
            DEV, torch.bfloat16)

    gmap = randn(pmem * M, 128, 3, 3)
    fmap1 = randn(pmem, h4, w4, 128)
    fmap2 = randn(pmem, h4 // 4, w4 // 4, 128)
    cx = torch.rand(E, generator=gen) * (w4 - 2) + 1
    cy = torch.rand(E, generator=gen) * (h4 - 2) + 1
    flow = 4.0 * torch.randn(E, 2, generator=gen)
    off = spread * (torch.arange(3.0) - 1)
    x = (cx + flow[:, 0])[:, None, None] + off[None, None, :]
    y = (cy + flow[:, 1])[:, None, None] + off[None, :, None]
    coords = torch.stack([x.expand(E, 3, 3), y.expand(E, 3, 3)], -1)
    kk = torch.randint(0, pmem * M, (E,), generator=gen)
    jj = torch.randint(0, pmem, (E,), generator=gen)
    valid = torch.rand(E, generator=gen) < 0.95
    return (gmap, fmap1, fmap2, coords.to(DEV).contiguous(),
            kk.to(DEV, torch.int32), jj.to(DEV, torch.int32), valid.to(DEV))


def window_einsum_ms(gmap, pyr, coords, kk, jj):
    """Yardstick for the correlation kernels: the plain version's einsum
    alone, over windows gathered beforehand in the feature dtype (one
    level at a time)."""
    E = coords.shape[0]
    lib_ms = 0.0
    for fmap, s in zip(pyr, (1, 4)):
        F_, H, W, C = fmap.shape
        c = coords / s
        off = torch.arange(8, device=DEV) - 3
        ys = (torch.floor(c[..., 1]).long()[..., None] + off).clamp(0, H - 1)
        xs = (torch.floor(c[..., 0]).long()[..., None] + off).clamp(0, W - 1)
        flat = (jj.long() * H * W)[:, None, None, None, None] + \
            ys[..., :, None] * W + xs[..., None, :]
        win = fmap.reshape(-1, C)[flat.reshape(-1)].reshape(E, 9, 64, C)
        g = gmap[kk.long()].permute(0, 2, 3, 1).reshape(E, 9, C)
        lib_ms += time_ms(lambda: torch.einsum("epwc,epc->epw", win, g),
                          reps=5, warmup=1)
        del win, flat
    torch.cuda.empty_cache()
    return lib_ms


def region_bmm_ms(gmap, pyr, coords, kk, jj):
    """Yardstick for the surfaces producer: one torch.bmm per level of the
    patch features [E, 9, 128] with the 16x16 regions at the x16 origin
    [E, 128, 256], gathered beforehand in the feature dtype (zero off the
    map)."""
    E = coords.shape[0]
    g = gmap[kk.long()].reshape(E, 128, 9).transpose(1, 2).contiguous()
    lib_ms = 0.0
    for fmap, s in zip(pyr, LEVELS):
        F_, H, W, C = fmap.shape
        _, _, oy, ox, _, _ = tregion.geometry(coords / s, "x16", H, W)
        ys = oy[:, None] + torch.arange(tregion.RH, device=DEV)
        xs = ox[:, None] + torch.arange(tregion.REGION_W["x16"], device=DEV)
        inb = ((ys >= 0) & (ys < H))[:, :, None] & \
            ((xs >= 0) & (xs < W))[:, None, :]
        flat = (jj.long() * H * W)[:, None, None] + \
            ys.clamp(0, H - 1)[:, :, None] * W + xs.clamp(0, W - 1)[:, None, :]
        flat = torch.where(inb, flat, F_ * H * W)      # the zero row
        table = torch.cat([fmap.reshape(-1, C), fmap.new_zeros(1, C)])
        reg = table[flat.reshape(-1)].reshape(E, -1, C).transpose(1, 2) \
            .contiguous()
        del flat, table
        lib_ms += time_ms(lambda: torch.bmm(g, reg), reps=5, warmup=1)
        del reg
    torch.cuda.empty_cache()
    return lib_ms


def map_positions(fmap, jj, y0, x0, h, w):
    """Rectangles of h x w positions of fmap [F, H, W, C] at (jj, y0, x0):
    (distinct in-map positions they cover, in-map positions summed over
    the rectangles)."""
    F, H, W, _ = fmap.shape
    dev = fmap.device
    ys = y0[:, None] + torch.arange(h, device=dev)
    xs = x0[:, None] + torch.arange(w, device=dev)
    inb = ((ys >= 0) & (ys < H))[:, :, None] & \
        ((xs >= 0) & (xs < W))[:, None, :]
    flat = (jj.long() * (H * W))[:, None, None] + \
        ys.clamp(0, H - 1)[:, :, None] * W + xs.clamp(0, W - 1)[:, None, :]
    seen = torch.zeros(F * H * W, dtype=torch.bool, device=dev)
    seen[flat[inb]] = True
    return int(seen.sum()), int(inb.sum())


def level_geometry(fmap, coords, s, valid):
    """The x16 region geometry (`corr_region.geometry`) of the valid edges
    at the level of scale s (its window starts hold for either variant)."""
    _, H, W, _ = fmap.shape
    return tregion.geometry(coords[valid] / s, "x16", H, W)


def corr_work(gmap, pyr, coords, kk, jj, valid, *outs):
    """What the correlation function needs on these inputs: (bytes, FLOPs).
    Bytes: the features of the valid edges' patches, the in-map positions
    of their 8x8 windows at both levels (each position once), coords, kk,
    jj and valid, and the outputs. FLOPs: the products over the in-map
    window positions."""
    v = valid.bool()
    es = gmap.element_size()
    n_bytes = kk[v].unique().numel() * gmap[0].numel() * es
    flops = 0.0
    for fmap, s in zip(pyr, (1, 4)):
        ys, xs, *_ = level_geometry(fmap, coords, s, v)
        n_pos, n_prod = map_positions(fmap, jj[v].repeat_interleave(9),
                                      ys.reshape(-1), xs.reshape(-1), 8, 8)
        n_bytes += n_pos * fmap.shape[-1] * es
        flops += 2.0 * n_prod * fmap.shape[-1]
    return n_bytes + nbytes(coords, kk, jj, valid, *outs), flops


def surfaces_work(gmap, pyr, coords, kk, jj, valid, surf):
    """The x16 surfaces' needs: (bytes, FLOPs). The patch features of the
    valid edges, the in-map positions of their 16x16 regions (each once),
    coords/kk/jj/valid and the surfaces; 9 products per in-map region
    position."""
    v = valid.bool()
    es = gmap.element_size()
    n_bytes = kk[v].unique().numel() * gmap[0].numel() * es
    flops = 0.0
    for fmap, s in zip(pyr, (1, 4)):
        _, _, oy, ox, _, _ = level_geometry(fmap, coords, s, v)
        n_pos, n_prod = map_positions(fmap, jj[v], oy, ox, tregion.RH,
                                      tregion.REGION_W["x16"])
        n_bytes += n_pos * fmap.shape[-1] * es
        flops += 2.0 * 9 * n_prod * fmap.shape[-1]
    return n_bytes + nbytes(coords, kk, jj, valid, surf), flops


def extract_work(gmap, pyr, coords, kk, jj, valid, surf, *outs):
    """The x16 extract's needs: (bytes, FLOPs). For each valid edge, level
    and pixel: the 8x8 fp32 surface window if it fits the region; if it
    spills, the pixel's features and the in-map positions of its window in
    the map (each once). Plus coords/kk/jj/valid and the outputs. FLOPs:
    the blend (7 per output value) and the spilled pixels' products."""
    v = valid.bool()
    es = gmap.element_size()
    n_bytes = nbytes(coords, kk, jj, valid, *outs)
    flops = 2.0 * int(v.sum()) * 9 * 49 * 7
    for fmap, s in zip(pyr, (1, 4)):
        ys, xs, _, _, fits, spill = level_geometry(fmap, coords, s, v)
        n_bytes += int(fits.sum()) * 64 * surf.element_size()
        ei, pi = spill.nonzero(as_tuple=True)
        if ei.numel():
            n_pos, n_prod = map_positions(fmap, jj[v][ei], ys[ei, pi],
                                          xs[ei, pi], 8, 8)
            n_g = (kk[v][ei].long() * 9 + pi).unique().numel()
            n_bytes += (n_pos + n_g) * fmap.shape[-1] * es
            flops += 2.0 * n_prod * fmap.shape[-1]
    return n_bytes, flops


def bound(n_bytes, ops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


BOX_SOURCE = "wild_video_3d_reconstruction_torch/csrc/corr_box.cu"


def per_pixel_counts(pyr, coords, valid):
    """(valid edge-levels, those with a pixel on the correlation body's
    per-pixel path), as device tensors (`box_plan`, no host sync)."""
    v = valid.bool()
    n_levels = torch.zeros((), dtype=torch.long, device=coords.device)
    n_per_pixel = torch.zeros_like(n_levels)
    for fmap, s in zip(pyr, LEVELS):
        cls, _ = box_plan(coords / s, fmap.shape[1], fmap.shape[2])
        n_levels += v.sum()
        n_per_pixel += ((cls == 2).any(1) & v).sum()
    return n_levels, n_per_pixel


def per_pixel_share(pyr, coords, valid):
    n_levels, n_per_pixel = per_pixel_counts(pyr, coords, valid)
    return int(n_per_pixel) / max(int(n_levels), 1)


class PerPixelTally:
    """Wraps the frame step's correlation lookup to count, over a VO run,
    the valid edge-levels and those that took the per-pixel path. The
    counts add into two device scalars in place, so a CUDA graph captured
    with the wrapper in place adds them on every replay; the runner's
    eager warm-up before each capture (whose effects it undoes) is not
    counted. The count adds a few small launches per lookup to the timed
    run."""

    def __init__(self, runner):
        self.counts = torch.zeros(2, dtype=torch.long, device=DEV)
        self.saved = steps.corr_lookup
        self.runner = runner

    def __enter__(self):
        def lookup(gmap, pyramid, coords, kk, jj, valid, **kw):
            if not self.runner.warming_up:
                self.counts += torch.stack(
                    per_pixel_counts(pyramid, coords, valid))
            return self.saved(gmap, pyramid, coords, kk, jj, valid, **kw)
        steps.corr_lookup = lookup
        return self

    def __exit__(self, *exc):
        steps.corr_lookup = self.saved

    def summary(self):
        n_levels, n_per_pixel = self.counts.tolist()
        return dict(edge_levels=n_levels, per_pixel_edge_levels=n_per_pixel,
                    per_pixel_share=n_per_pixel / max(n_levels, 1))


def kernel_corr(gen, E=E_KERNEL, ht=HT, wd=WD, phase="kernels"):
    gmap, fmap1, fmap2, coords, kk, jj, valid = corr_inputs(gen, E=E, ht=ht,
                                                            wd=wd)
    E = coords.shape[0]
    pyr = (fmap1, fmap2)
    out = corr_lookup(gmap, pyr, coords, kk, jj, valid)
    torch.cuda.synchronize()
    ref = patch_corr_pyramid(gmap, pyr, coords, kk, jj, valid=valid,
                             chunk=4096)
    err = (out - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(lambda: corr_lookup(gmap, pyr, coords, kk, jj, valid))
    # the same edges processed grouped by target frame (the JAX kernels
    # bucket by frame): does L2 reuse of fmap1 (113 MB here) pay?
    order = jj.argsort(stable=True)
    grouped = (coords[order].contiguous(), kk[order].contiguous(),
               jj[order].contiguous(), valid[order].contiguous())
    ms_grouped = time_ms(lambda: corr_lookup(gmap, pyr, *grouped))
    del grouped
    plain_ms = time_ms(lambda: patch_corr_pyramid(
        gmap, pyr, coords, kk, jj, valid=valid, chunk=4096), reps=3,
        warmup=1)
    lib_ms = window_einsum_ms(gmap, pyr, coords, kk, jj)
    n_bytes, flops = corr_work(gmap, pyr, coords, kk, jj, valid, out)
    row = dict(
        name="corr_pyramid", route="cuda", source=BOX_SOURCE,
        replaces="wild_video_3d_reconstruction_tpu/ops/pallas_corr.py:83, "
                 "wild_video_3d_reconstruction_tpu/ops/pallas_corr.py:123",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(n_bytes, flops, BF16_FLOPS), library_ms=lib_ms)
    emit(phase, E=E, HxW=[ht, wd], rel_err=rel, tol_abs=TOL_CORR_ABS,
         finite=finite, bytes=n_bytes, flops=flops,
         per_pixel_share=per_pixel_share(pyr, coords, valid),
         ms_edges_grouped_by_jj=ms_grouped, **row)
    if not finite or not err <= TOL_CORR_ABS:
        fail(f"corr kernel disagrees with its plain version: max abs err "
             f"{err} > {TOL_CORR_ABS}")
    return row


def runsum_inputs(gen, E=E_KERNEL):
    """[E, 768] fp32 rows sorted into runs of 1..28 rows (the per-patch
    edge cap) with a trailing sentinel run of invalid rows."""
    D = 768
    n_valid = int(E * 0.85)
    lens = torch.randint(1, 29, (E,), generator=gen)
    seg = torch.repeat_interleave(torch.arange(E), lens)[:n_valid]
    n_seg = int(seg[-1]) + 1
    seg = torch.cat([seg, torch.full((E - n_valid,), n_seg)])
    f = torch.randn(E, D // 2, generator=gen)
    e = torch.exp(torch.randn(E, D // 2, generator=gen) - 3.0)
    fes = torch.cat([f * e, e], dim=1)
    return fes.to(DEV), seg.to(DEV, torch.int32)


def kernel_runsum(gen, E=E_KERNEL, phase="kernels"):
    fes, seg = runsum_inputs(gen, E)
    E, D = fes.shape
    out = run_segment_sum_sorted(fes, seg)
    torch.cuda.synchronize()
    ref = run_segment_sum_sorted_plain(fes, seg)
    err = (out - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(lambda: run_segment_sum_sorted(fes, seg))
    ms_b2b = back_to_back_ms(lambda: run_segment_sum_sorted(fes, seg))
    plain_ms = time_ms(lambda: run_segment_sum_sorted_plain(fes, seg))
    # every row of a run holds the bitwise same total as the run's first
    same_in_run = bool(torch.equal(out, out[run_first_rows(seg)]))
    start = torch.ones(E, dtype=torch.bool, device=DEV)
    start[1:] = seg[1:] != seg[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    acc = torch.zeros_like(fes)
    lib_ms = time_ms(lambda: acc.zero_().index_add_(0, run, fes))
    n_bytes = nbytes(fes, seg, out)
    row = dict(
        name="runsum", route="cuda",
        source="wild_video_3d_reconstruction_torch/csrc/runsum.cu",
        replaces="wild_video_3d_reconstruction_tpu/ops/pallas_segsum.py:38",
        max_abs_err=err, ms=ms, ms_back_to_back=ms_b2b, plain_ms=plain_ms,
        # fp32 adds outside the tensor cores
        **bound(n_bytes, E * D, FP32_FLOPS), library_ms=lib_ms)
    emit(phase, E=E, D=D, rel_err=rel, tol_rel=TOL_RUNSUM_REL,
         finite=finite, bitwise_same_total_in_run=same_in_run,
         bytes=n_bytes, **row)
    if not finite or not rel <= TOL_RUNSUM_REL or not same_in_run:
        fail(f"runsum kernel disagrees with its plain version: relative "
             f"err {rel} (tol {TOL_RUNSUM_REL}), bitwise same total in "
             f"every run: {same_in_run}")
    return row


REGION_SOURCE = "wild_video_3d_reconstruction_torch/csrc/corr_region.cu"
PALLAS_CORR = "wild_video_3d_reconstruction_tpu/ops/pallas_corr.py"


def kernel_region_fused(gen, variant, M=384, E=E_KERNEL, shapes="default"):
    """The fused region kernel of `variant` against its plain version, on
    compact patches (no pixel spills) and on patches spread 12 px (the
    spill path). Returns the row of the compact run."""
    name = f"corr_region_fused_{variant}"
    row = None
    for spread in (1.0, 6.0):
        gmap, fmap1, fmap2, coords, kk, jj, valid = corr_inputs(
            gen, M=M, E=E, spread=spread)
        pyr = (fmap1, fmap2)
        args = (gmap, pyr, coords, kk, jj, valid, variant)
        out, spill = tregion.region_corr_fused(*args)
        torch.cuda.synchronize()
        ref, ref_spill = tregion.region_corr_plain(*args)
        err = (out - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        n_spill = int(spill.sum())
        same_spill = bool(torch.equal(spill, ref_spill))
        ms = time_ms(lambda: tregion.region_corr_fused(*args))
        plain_ms = time_ms(lambda: tregion.region_corr_plain(*args), reps=3,
                           warmup=1)
        lib_ms = window_einsum_ms(gmap, pyr, coords, kk, jj) \
            if spread == 1.0 else None
        n_bytes, flops = corr_work(gmap, pyr, coords, kk, jj, valid, out,
                                   spill)
        r = dict(name=name, route="cuda", source=BOX_SOURCE,
                 replaces=f"{PALLAS_CORR}:340" if variant == "x32"
                 else f"{PALLAS_CORR}:157",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 **bound(n_bytes, flops, BF16_FLOPS),
                 library_ms=lib_ms)
        emit("kernels", shapes=shapes, E=E, patches_per_frame=M,
             pixel_spacing_px=spread, spill_edges=n_spill,
             per_pixel_share=per_pixel_share(pyr, coords, valid),
             spill_flags_match_plain=same_spill, tol_abs=TOL_CORR_ABS,
             finite=finite, bytes=n_bytes, flops=flops, **r)
        if not finite or not err <= TOL_CORR_ABS or not same_spill:
            fail(f"{name} disagrees with its plain version: max abs err "
                 f"{err} (tol {TOL_CORR_ABS}), spill flags equal: "
                 f"{same_spill}")
        if (n_spill > 0) != (spread > 1.0):
            fail(f"{name}: {n_spill} spilled edges at {spread} px spacing")
        row = row or r
        del out, ref, spill, ref_spill
        torch.cuda.empty_cache()
    return row


def kernel_region_split(gen):
    """The split x16 pair: the surfaces kernel against the plain surfaces,
    the extract kernel against the plain extract of the same surfaces, and
    the pair against the fused plain version; compact and spread patches.
    Returns the rows of the compact run."""
    rows = None
    for spread in (1.0, 6.0):
        gmap, fmap1, fmap2, coords, kk, jj, valid = corr_inputs(
            gen, spread=spread)
        pyr = (fmap1, fmap2)
        args = (gmap, pyr, coords, kk, jj, valid)
        surf = tregion.region_surfaces(*args)
        out, spill = tregion.region_extract(surf, *args)
        torch.cuda.synchronize()
        err_s = (surf - tregion.region_surfaces_plain(*args)).abs().max()
        ref, ref_spill = tregion.region_extract_plain(surf, *args)
        err_x = (out - ref).abs().max().item()
        full, _ = tregion.region_corr_plain(*args, "x16")
        err_full = (out - full).abs().max().item()
        err_s = err_s.item()
        del ref, full
        n_spill = int(spill.sum())
        same_spill = bool(torch.equal(spill, ref_spill))
        finite = bool(torch.isfinite(out).all() and torch.isfinite(surf).all())
        ms_s = time_ms(lambda: tregion.region_surfaces(*args))
        b2b_s = back_to_back_ms(lambda: tregion.region_surfaces(*args))
        ms_x = time_ms(lambda: tregion.region_extract(surf, *args))
        b2b_x = back_to_back_ms(lambda: tregion.region_extract(surf, *args))
        # the same edges grouped by target frame, the order in which every
        # map the producer reads stays in L2
        order = jj.argsort(stable=True)
        grouped = (gmap, pyr, coords[order].contiguous(),
                   kk[order].contiguous(), jj[order].contiguous(),
                   valid[order].contiguous())
        b2b_s_grouped = back_to_back_ms(
            lambda: tregion.region_surfaces(*grouped))
        del grouped
        # the card's time for writing as many bytes as the surfaces alone
        store_ms = None
        if spread == 1.0:
            scratch = torch.empty_like(surf)
            store_ms = back_to_back_ms(scratch.zero_)
            del scratch
        torch.cuda.empty_cache()
        plain_s = time_ms(lambda: tregion.region_surfaces_plain(*args),
                          reps=3, warmup=1)
        plain_x = time_ms(lambda: tregion.region_extract_plain(surf, *args),
                          reps=3, warmup=1)
        lib_s = region_bmm_ms(gmap, pyr, coords, kk, jj) \
            if spread == 1.0 else None
        b_s, flops_s = surfaces_work(*args, surf)
        b_x, flops_x = extract_work(*args, surf, out, spill)
        r_s = dict(name="corr_region_surfaces", route="cuda",
                   source=BOX_SOURCE, replaces=f"{PALLAS_CORR}:123",
                   max_abs_err=err_s, ms=ms_s, ms_back_to_back=b2b_s,
                   plain_ms=plain_s, **bound(b_s, flops_s, BF16_FLOPS),
                   library_ms=lib_s)
        r_x = dict(name="corr_region_extract", route="cuda",
                   source=REGION_SOURCE, replaces=f"{PALLAS_CORR}:230",
                   max_abs_err=err_x, ms=ms_x, ms_back_to_back=b2b_x,
                   plain_ms=plain_x,
                   **bound(b_x, flops_x, FP32_FLOPS), library_ms=None)
        for r, b, f, extra in (
                (r_s, b_s, flops_s, dict(
                    ms_back_to_back_edges_grouped_by_jj=b2b_s_grouped,
                    ms_back_to_back_zero_fill_surfaces=store_ms,
                    library="torch.bmm over pre-gathered regions")),
                (r_x, b_x, flops_x, {})):
            emit("kernels", shapes="default", E=E_KERNEL,
                 pixel_spacing_px=spread, spill_edges=n_spill,
                 spill_flags_match_plain=same_spill, tol_abs=TOL_CORR_ABS,
                 pair_vs_fused_plain_max_abs_err=err_full, finite=finite,
                 bytes=b, flops=f, surface_bytes=nbytes(surf), **extra, **r)
        if not finite or not max(err_s, err_x, err_full) <= TOL_CORR_ABS \
                or not same_spill:
            fail(f"split region pair disagrees with its plain version: "
                 f"surfaces {err_s}, extract {err_x}, pair {err_full} (tol "
                 f"{TOL_CORR_ABS}), spill flags equal: {same_spill}")
        if (n_spill > 0) != (spread > 1.0):
            fail(f"split region pair: {n_spill} spilled edges at {spread} px "
                 "spacing")
        rows = rows or [r_s, r_x]
        del surf, out
        torch.cuda.empty_cache()
    return rows


def spd_system(gen, D):
    A = torch.randn(D, D, generator=gen)
    S = A @ A.T + D * torch.eye(D)
    return S.to(DEV), torch.randn(D, generator=gen).to(DEV)


def kernel_chol(gen):
    """The Cholesky kernel against cholesky_ex + cholesky_solve at D = 54,
    72 (the [6W, 6W] BA Schur system of the JAX package's note) and 256,
    NaN on S = -I; beside it torch.linalg.solve. Returns the D = 72 row."""
    row = None
    for D in CHOL_DIMS:
        S, y = spd_system(gen, D)
        x = tchol.chol_solve_small(S, y)
        torch.cuda.synchronize()
        ref = tchol.chol_solve_small_plain(S, y)
        err = (x - ref).abs().max().item()
        close = bool(torch.allclose(x, ref, rtol=TOL_CHOL_RTOL,
                                    atol=TOL_CHOL_ATOL))
        nan_ok = bool(torch.isnan(tchol.chol_solve_small(
            -torch.eye(D, device=DEV), y)).all())
        ms = time_ms(lambda: tchol.chol_solve_small(S, y))
        ms_b2b = back_to_back_ms(lambda: tchol.chol_solve_small(S, y))
        ms_dev = graph_ms(lambda: tchol.chol_solve_small(S, y))
        plain_ms = time_ms(lambda: tchol.chol_solve_small_plain(S, y))
        lib_ms = time_ms(lambda: torch.linalg.solve(S, y))
        flops = D ** 3 / 3 + 2 * D ** 2
        r = dict(name="chol_solve", route="cuda",
                 source="wild_video_3d_reconstruction_torch/csrc/chol.cu",
                 replaces="wild_video_3d_reconstruction_tpu/ops/"
                          "pallas_chol.py:37",
                 max_abs_err=err, ms=ms, ms_back_to_back=ms_b2b,
                 plain_ms=plain_ms,
                 **bound(nbytes(S, y, x), flops, FP32_FLOPS),
                 library_ms=lib_ms)
        emit("kernels", D=D, rtol=TOL_CHOL_RTOL, atol=TOL_CHOL_ATOL,
             ms_cuda_graph=ms_dev,
             within_tol=close, nan_on_minus_identity=nan_ok,
             plain="cholesky_ex + cholesky_solve",
             library="torch.linalg.solve", **r)
        if not close or not nan_ok:
            fail(f"chol kernel at D={D}: max abs err {err} (rtol "
                 f"{TOL_CHOL_RTOL}, atol {TOL_CHOL_ATOL}), NaN on -I: "
                 f"{nan_ok}")
        if D == 72:
            row = r
    return row


def phase_entry_points(gen):
    """No VO path runs the split region pair or the Cholesky solve (the
    JAX package reaches them only through its op entry points). Drive
    their entry points once at the shapes above, with the counts at zero,
    and check the result."""
    gmap, fmap1, fmap2, coords, kk, jj, valid = corr_inputs(gen)
    args = (gmap, (fmap1, fmap2), coords, kk, jj, valid)
    S, y = spd_system(gen, 72)
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    out, n_spill = tregion.region_corr_pyramid(
        *args, "x16", fused=False, extract="kernel", return_spill_count=True)
    x = tchol.chol_solve_small(S, y)
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    resid = ((S @ x - y).norm() / y.norm()).item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(x).all())
    emit("entry_points", corr="region_corr_pyramid(variant='x16', "
         "fused=False, extract='kernel')", corr_shape=list(out.shape),
         spill_edges=n_spill, chol="chol_solve_small", D=72,
         relative_residual=resid, finite=finite, launches=launches)
    if not finite or not resid < 1e-4 or out.shape != (E_KERNEL, 882):
        fail("entry points: non-finite result or residual too large")
    for k in ("corr_region_surfaces", "corr_region_extract", "chol_solve"):
        if launches[k] <= 0:
            fail(f"entry points: kernel {k} was not launched")
    return launches


def synthetic_frames(n, seed=0, ht=None, wd=None):
    """A drifting random texture (the SLAM smoke test's input)."""
    ht, wd = ht or HT, wd or WD
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, size=(ht * 2, wd * 2, 3)).astype(np.uint8)
    return [big[4 * t % ht:4 * t % ht + ht, 6 * t % wd:6 * t % wd + wd].copy()
            for t in range(n)]


def phase_slam(name, config, n_frames, expect, fused=False, sync_mode=False,
               wild=None, network=None, inputs="", on_frame=None,
               **overrides):
    """One VO run; fails unless each kernel in `expect` was launched.
    Steady frames replay CUDA graphs (the first one captures them); after
    it the loop runs under `torch.cuda.set_sync_debug_mode("error")`, so
    any synchronising call of the host loop raises, and the one counter
    read per frame between replays (a pinned copy and an event) is
    counted. With sync_mode the steady frames run the synchronous eager
    path instead. Steady FPS is over the frames after the first steady
    one.

    Without `wild`: the drifting random texture, weights drawn from seed
    0 (network None). With wild = `synth_ate.wild_sequence`'s (images,
    poses_w2c, intrinsics, depths, masks): its first n_frames frames with
    `inputs` ("d": the depth prior, "m": the mask) and the Sim(3) ATE
    against its ground truth, which must lie below the identity floor.
    The motion probe runs and accepts every frame; its value on each
    warm-up frame is printed.
    Returns (launches, poses, dropped frames, slam, record)."""
    # MOTION_PROBE_THRESH=0: the motion probe runs on every warm-up frame
    # but accepts it (random weights give no meaningful flow; with the
    # trained weights at 384x512 the shipped 2.0 parked the wild walk's
    # frames until no run initialized within 40 frames)
    overrides = dict(dict(MOTION_PROBE_THRESH=0.0), **overrides)
    if wild is None:
        frames = synthetic_frames(n_frames)
        intr = np.array([320.0, 320.0, WD / 2, HT / 2])
        depths = masks = [None] * n_frames
    else:
        frames, poses_gt, intr, depths, masks = (a[:n_frames] if a.ndim > 1
                                                 else a for a in wild)
        depths = depths if "d" in inputs else [None] * n_frames
        masks = masks if "m" in inputs else [None] * n_frames
    cfg = load_config(config, PALLAS_FUSED=fused, **overrides)
    slam = DPVO(cfg, network, HT, WD, seed=0, device=DEV,
                sync_mode=sync_mode)
    runner = slam.runner
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    t_start = time.perf_counter()
    n_steady0, t_first, first_launch, max_edges, reads0 = None, None, None, \
        0, 0
    t_hooks = 0.0
    probes = []
    probe = steps.motion_probe

    def recorded_probe(*a):
        v = probe(*a)
        probes.append(float(v))
        return v

    steps.motion_probe = recorded_probe
    with PerPixelTally(runner) as tally:
        try:
            for t, img in enumerate(frames):
                if slam.is_initialized and n_steady0 is None:
                    n_steady0 = t
                    t_capture = time.perf_counter()
                slam(t, img, intr, depth=depths[t], mask=masks[t])
                if n_steady0 == t:
                    # the first steady frame (graph mode: the capture) done
                    torch.cuda.synchronize()
                    t_first = time.perf_counter()
                    first_launch = dict(_native.LAUNCHES)
                    reads0 = runner.host_reads
                    if not sync_mode:
                        torch.cuda.set_sync_debug_mode("error")
                # steady frames; graph mode: the counters the runner last
                # read (no read of its own)
                if n_steady0 is not None:
                    max_edges = max(max_edges, int(slam.state.n_edges)
                                    if sync_mode else
                                    (runner.counts_host or [0, 0])[1])
                if on_frame is not None:
                    t_hook = time.perf_counter()
                    on_frame(t, slam)
                    if t_first is not None:     # inside the timed frames
                        t_hooks += time.perf_counter() - t_hook
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            steps.motion_probe = probe
    t_end = time.perf_counter() - t_hooks
    poses, tstamps = slam.trajectory()
    launches = dict(_native.LAUNCHES)
    if n_steady0 is None or t_first is None:
        fail(f"{name}: DPVO never initialized")
    n_timed = n_frames - n_steady0 - 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traj.txt")
        export.save_trajectory_tum_format(poses, tstamps, path)
        back, _ = export.load_trajectory_tum_format(path)
    per_frame = {k: (launches[k] - first_launch[k]) / n_timed
                 for k in launches}
    finite = bool(np.isfinite(poses).all())
    gaps = runner.gaps_ms() if not sync_mode else []
    graph = {} if sync_mode else dict(
        tiers=list(runner.tiers), graphs_captured=len(runner.graphs),
        replays_per_tier={graph_label(k): v
                          for k, v in runner.replays.items()},
        replay_ms_median_per_tier={graph_label(k): statistics.median(v)
                                   for k, v in runner.replay_times.items()},
        counter_reads_per_timed_frame=(runner.host_reads - reads0) / n_timed,
        sync_debug_mode="error after the first steady frame",
        replay_gap_ms_median=statistics.median(gaps) if gaps else None,
        replay_gap_ms_mean=statistics.mean(gaps) if gaps else None,
        launches_per_replay={graph_label(k): v for k, v in
                             runner.graph_launches.items()})
    steady = n_frames - n_steady0
    drops = len(slam.delta) - len(slam.parked)
    accuracy = {}
    if wild is not None:
        ate, n_aligned, floor = synth_ate.ate_against(poses, tstamps,
                                                      poses_gt)
        accuracy = dict(ate_rmse=ate, ate_floor_identity=floor,
                        n_aligned=n_aligned, inputs=inputs or "images")
    record = dict(
        config=config, fused=fused, variant=cfg.PALLAS_VARIANT,
        sync_mode=sync_mode, frames=n_frames, HxW=[HT, WD],
        patches=cfg.PATCHES_PER_FRAME, patch_selector=cfg.PATCH_SELECTOR,
        initialized=slam.is_initialized, keyframes=slam.n_host,
        parked=len(slam.parked), steady_keyframe_drops=drops,
        keyframe_share_steady=1.0 - drops / steady,
        n_edges=int(slam.state.n_edges), max_n_edges=max_edges,
        steady_frames=steady, timed_frames=n_timed,
        fps_steady=n_timed / (t_end - t_first),
        first_steady_frame_s=t_first - t_capture,
        total_s=t_end - t_start, launches=launches,
        launches_per_steady_frame=per_frame, poses_finite=finite,
        correlation=tally.summary(), tum_rows=int(back.shape[0]),
        motion_gate=f"MOTION_PROBE_THRESH={cfg.MOTION_PROBE_THRESH}",
        probe_per_warmup_frame=probes,
        weights="random, seed 0" if network is None else network,
        **accuracy, **graph)
    emit(name, **record)
    if not finite or poses.shape != (n_frames, 7) or \
            back.shape != (n_frames, 7):
        fail(f"{name}: trajectory not finite or of the wrong shape")
    if wild is not None and not accuracy["ate_rmse"] < floor:
        fail(f"{name}: ATE {accuracy['ate_rmse']} not below the identity "
             f"floor {floor}")
    for k in expect:
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was not launched on the main path")
    if not sync_mode and sum(runner.replays.values()) != steady:
        fail(f"{name}: {sum(runner.replays.values())} graph replays for "
             f"{steady} steady frames")
    return launches, poses, sorted(slam.delta), slam, record


def phase_weights():
    """The committed trained weights load on the card: file size,
    parameter count and a checksum of the tensors (sha256 over the fp32
    bytes in state-dict order, read back from the card)."""
    net = load_reference_checkpoint(WEIGHTS, device=DEV)
    sha = hashlib.sha256()
    n_params, total = 0, 0.0
    for name, t in net.state_dict().items():
        n_params += t.numel()
        total += float(t.double().sum())
        sha.update(name.encode())
        sha.update(t.float().cpu().numpy().tobytes())
    on_card = all(t.is_cuda for t in net.state_dict().values())
    emit("weights", path=WEIGHTS, bytes=os.path.getsize(WEIGHTS),
         tensors=len(net.state_dict()), parameters=n_params,
         sha256_fp32_tensors=sha.hexdigest(), sum_of_parameters=total,
         on_card=on_card)
    if n_params != WEIGHTS_PARAMETERS or not on_card or \
            not np.isfinite(total):
        fail(f"weights: {n_params} parameters (expected "
             f"{WEIGHTS_PARAMETERS}), on the card: {on_card}")


def phase_synth_ate_tiny():
    """`eval/synth_ate.run`'s protocol (48x64, 60 frames, walk, seed 0)
    with the trained weights on the card (graph replay); then the same
    protocol cut to SHORT_FRAMES frames on the card and on the CPU with
    the same numpy draws (`_short_card_vs_cpu`). Fails unless the card's
    ATE is finite and below the identity floor and the short runs agree.
    (The 60-frame ATE is chaotic in the rounding of its sums, 0.29-0.93 on
    the CPU with only the thread count changed: PERF.md section 2; so the
    card is held to the CPU pose by pose on the short run instead.)"""
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    card = synth_ate.run(WEIGHTS, frames=60, device=DEV)
    card.pop("poses")
    card = dict(card, seconds=time.perf_counter() - t0,
                launches=dict(_native.LAUNCHES))
    check = _short_card_vs_cpu("synth_ate_tiny", lambda dev, draws: (
        synth_ate.run(WEIGHTS, frames=SHORT_FRAMES, device=dev,
                      draws=draws(0),
                      cfg_overrides=dict(MIXED_PRECISION=False))))
    emit("synth_ate_tiny", protocol="eval/synth_ate.run: 48x64, 60 frames, "
         "walk, seed 0", weights=WEIGHTS, card=card,
         short_card_vs_cpu=check)
    if not np.isfinite(card["ate_rmse"]) or \
            not card["ate_rmse"] < card["ate_floor_identity"]:
        fail(f"synth_ate_tiny: card ATE {card['ate_rmse']} (floor "
             f"{card['ate_floor_identity']})")
    if card["launches"]["corr_pyramid"] <= 0:
        fail("synth_ate_tiny: the card run launched no correlation kernel")
    return card["launches"]


def phase_wild(wild):
    """This slice's path at full width: configs/default.yaml at 384x512
    with the trained weights, the world's depth as the prior and the
    occluder's mask on every frame, replayed and in sync_mode (poses
    bitwise equal: BA's card sums are fp64); then configs/fast.yaml with
    keypoint patches on the same images, replayed. Returns (launches, the
    replayed default.yaml run's record)."""
    expect = ("corr_pyramid", "runsum")
    runs = [phase_slam(name, "configs/default.yaml", WILD_FRAMES, expect,
                       sync_mode=sync, wild=wild, network=WEIGHTS,
                       inputs="dm")
            for name, sync in (("slam_default_wild", False),
                               ("slam_default_wild_sync", True))]
    (_, pg, kfg, *_), (_, ps, kfs, *_) = runs
    same = bool(np.array_equal(pg, ps))
    emit("wild_graph_vs_sync", frames=WILD_FRAMES, poses_bitwise_equal=same,
         max_abs_pose_diff=float(np.abs(pg - ps).max()),
         same_keyframe_drops=kfg == kfs, keyframe_drops=len(kfg))
    if not same or kfg != kfs:
        fail("slam_default_wild: the replayed poses differ from sync_mode")
    runs.append(phase_slam("slam_fast_keypoints", "configs/fast.yaml",
                           WILD_FRAMES, expect, wild=wild, network=WEIGHTS,
                           PATCH_SELECTOR="keypoints"))
    launches = dict.fromkeys(_native.LAUNCHES, 0)
    for run in runs:
        for k, v in run[0].items():
            launches[k] += v
    return launches, runs[0][4]


class CallCount:
    """Within the block, counts the calls of `module.name` and, with
    tally, the valid edge-levels of its correlation lookups and those on
    the per-pixel path (`per_pixel_counts`)."""

    def __init__(self, module, name, tally=False):
        self.module, self.name, self.tally = module, name, tally
        self.saved = getattr(module, name)
        self.calls = 0
        self.counts = torch.zeros(2, dtype=torch.long, device=DEV)

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            if self.tally:
                _, pyramid, coords, _, _, valid = a[:6]
                self.counts += torch.stack(per_pixel_counts(pyramid, coords,
                                                            valid))
            return self.saved(*a, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def phase_global_ba(name, slam, poses_gt, ate_before):
    """Global BA on the VO run's state (`DPVO.terminate`'s first step):
    its keyframes, frame and patch edges, wall time, the correlation
    launches and per-pixel share of its pass, and the ATE after it. Fails
    unless csrc/corr_box.cu launched, the plain correlation was not
    called, the poses are finite and the ATE is below the floor."""
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    with CallCount(tgba, "corr_lookup", tally=True) as lookups, \
            CallCount(tcorr, "patch_corr_pyramid") as plain:
        t0 = time.perf_counter()
        n, frame_edges, patch_edges = tgba.run_global_ba(slam.cfg, slam)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    poses, tstamps = slam.trajectory()
    ate, n_aligned, floor = synth_ate.ate_against(poses, tstamps, poses_gt)
    finite = bool(np.isfinite(poses).all())
    n_levels, n_pp = lookups.counts.tolist()
    emit(name, keyframes=n, frame_edges=frame_edges, patch_edges=patch_edges,
         seconds=seconds, corr_lookups=lookups.calls,
         plain_patch_corr_pyramid_calls=plain.calls, launches=launches,
         correlation=dict(edge_levels=n_levels, per_pixel_edge_levels=n_pp,
                          per_pixel_share=n_pp / max(n_levels, 1)),
         ate_rmse_before=ate_before, ate_rmse_after=ate,
         ate_floor_identity=floor, n_aligned=n_aligned, poses_finite=finite)
    if launches["corr_pyramid"] <= 0 or plain.calls or not finite or \
            not ate < floor:
        fail(f"{name}: corr_box.cu launches {launches['corr_pyramid']}, "
             f"plain correlation calls {plain.calls}, finite poses {finite}, "
             f"ATE {ate} against the floor {floor}")
    return launches, poses, tstamps


def phase_export(slam, poses, tstamps):
    """The map and its files: points_and_colors, PLY written and read back,
    the COLMAP text and binary models written and read back, and the
    frames of transforms.json."""
    pts, clr = slam.points_and_colors()
    fx, fy, cx, cy = (slam.state.intrinsics[0] * 4).tolist()
    w2c = lie.se3_inv(torch.from_numpy(poses.astype(np.float32))).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        export.save_ply(os.path.join(tmp, "map.ply"), pts, clr)
        pts_back, clr_back = export.load_ply(os.path.join(tmp, "map.ply"),
                                             return_colors=True)
        ply_ok = np.array_equal(pts_back, pts) and \
            np.array_equal(clr_back, clr)
        out = export.save_output_for_colmap(
            os.path.join(tmp, "colmap"), poses, tstamps, pts, clr, fx, fy,
            cx, cy, HT, WD)
        models = {"text": colmap_model.read_model(out),
                  "binary": colmap_model.read_model(
                      out / "colmap" / "sparse" / "0")}
        with open(out / "transforms.json") as f:
            n_transforms = len(json.load(f)["frames"])
    same = {}
    for kind, (cams, ims, pts3) in models.items():
        xyz = np.stack([pts3[i + 1].xyz for i in range(len(pts3))])
        rgb = np.stack([pts3[i + 1].rgb for i in range(len(pts3))])
        qt = np.stack([np.concatenate([ims[i + 1].tvec, ims[i + 1].qvec])
                       for i in range(len(ims))])
        same[kind] = bool(
            np.array_equal(cams[1].params, [fx, fy, cx, cy]) and
            np.array_equal(xyz, pts) and np.array_equal(rgb, clr) and
            np.array_equal(qt, np.concatenate(
                [w2c[:, :3], w2c[:, 6:7], w2c[:, 3:6]], 1)))
    emit("export", points=int(pts.shape[0]), ply_read_back_equal=ply_ok,
         colmap_read_back_equal=same, images=len(models["text"][1]),
         transforms_frames=n_transforms)
    if not ply_ok or not all(same.values()) or \
            n_transforms != len(poses) or not len(pts):
        fail("export: a file did not read back to what was written")


def keep_decisions(slam, rec):
    """The replayed run's keyframe decisions from its event log: the flow
    metric over 2 of each steady frame against KEYFRAME_THRESH (kept at
    or above it) and each side's margin, relative to the threshold: the
    least by which a kept frame cleared it, and a dropped one missed it."""
    th = slam.cfg.KEYFRAME_THRESH
    log = slam.state.log[:int(slam.state.log_idx)].cpu().numpy()
    first = rec["frames"] - rec["steady_frames"]
    flow = (log[:, 8] / 2).tolist()
    kept = (log[:, 0] < 0.5).tolist()
    kept_flow = [f for f, k in zip(flow, kept) if k]
    dropped_flow = [f for f, k in zip(flow, kept) if not k]
    emit("wild_keep_decisions", keyframe_thresh=th, first_steady_frame=first,
         flow_over_2=flow, kept_frames=[first + i for i, k in enumerate(kept)
                                        if k],
         flow_over_2_kept=kept_flow,
         margin_kept_min=min(kept_flow, default=th) / th - 1,
         flow_over_2_dropped_max=max(dropped_flow, default=None),
         margin_dropped_min=1 - max(dropped_flow, default=0.0) / th)


def phase_wild_keep(keep):
    """Item 19b on the card: default.yaml at 384x512 with the trained
    weights on the wild walk at KEEP_STRIDE times its motion per frame
    (depth and mask on every frame, ENABLE_GLOBAL_BA), replayed and in
    sync_mode (bitwise equal, before and after global BA); steady frames
    both kept and dropped, replays above tier 0; global BA and the export
    on the replayed run's state; the replayed run saved at a steady frame
    after a keep near the middle, resumed in a new DPVO and finished,
    bitwise equal to the uninterrupted run."""
    expect = ("corr_pyramid", "runsum")
    overrides = dict(ENABLE_GLOBAL_BA=True, BUFFER_SIZE=KEEP_BUFFER)
    saved = {}

    def checkpoint(t, slam):
        # at the first steady frame past the middle once a steady frame
        # was kept (the keyframe count the runner last read, before this
        # frame's replay, no read of its own, has grown past the
        # bootstrap's), with a frame left to resume: a keep that rounding
        # moves a few frames later still saves
        counts = slam.runner.counts_host
        if saved or counts is None or t < WILD_FRAMES // 2 or \
                t > WILD_FRAMES - 2 or counts[0] <= DPVO.WARMUP:
            return
        torch.cuda.set_sync_debug_mode(0)
        save_slam(slam, saved.setdefault("path", tempfile.mkdtemp()))
        saved["frame"] = t
        torch.cuda.set_sync_debug_mode("error")

    runs = {}
    for name, sync in (("slam_default_wild_keep", False),
                       ("slam_default_wild_keep_sync", True)):
        runs[name] = phase_slam(
            name, "configs/default.yaml", WILD_FRAMES, expect,
            sync_mode=sync, wild=keep, network=WEIGHTS, inputs="dm",
            on_frame=None if sync else checkpoint, **overrides)
        r = runs[name][4]
        if not 0 < r["steady_keyframe_drops"] < r["steady_frames"]:
            fail(f"{name}: no steady frame both kept and dropped")
    r = runs["slam_default_wild_keep"][4]
    if not any(v and k.split("/")[0] != str(r["tiers"][0])
               for k, v in r["replays_per_tier"].items()):
        fail("slam_default_wild_keep: no replay above tier 0")
    (lg, pg, kfg, slam, rec), (ls, ps, kfs, slam_s, rec_s) = runs.values()
    keep_decisions(slam, rec)
    poses_gt = keep[1]
    gba_launches, pg_gba, tstamps = phase_global_ba(
        "global_ba", slam, poses_gt, rec["ate_rmse"])
    gba_sync_launches, ps_gba, _ = phase_global_ba(
        "global_ba_sync", slam_s, poses_gt, rec_s["ate_rmse"])
    same = bool(np.array_equal(pg, ps))
    same_gba = bool(np.array_equal(pg_gba, ps_gba))
    emit("wild_keep_graph_vs_sync", frames=WILD_FRAMES,
         poses_bitwise_equal=same, after_global_ba_bitwise_equal=same_gba,
         max_abs_pose_diff=float(np.abs(pg - ps).max()),
         same_keyframe_drops=kfg == kfs, keyframe_drops=len(kfg),
         ate_rmse_before_global_ba=rec["ate_rmse"])
    if not same or not same_gba or kfg != kfs:
        fail("slam_default_wild_keep: the replayed poses differ from "
             "sync_mode")
    phase_export(slam, pg_gba, tstamps)
    if "frame" not in saved:
        fail("slam_default_wild_keep: no steady frame after a keep to save "
             "at")
    # the resumed run: a new DPVO, the checkpoint, the frames after it
    frames, _, intr, depths, masks = keep
    cfg = load_config("configs/default.yaml", MOTION_PROBE_THRESH=0.0,
                      **overrides)
    resumed = load_slam(DPVO(cfg, WEIGHTS, HT, WD, seed=0, device=DEV),
                        saved["path"])
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    for t in range(resumed.counter, WILD_FRAMES):
        resumed(t, frames[t], intr, depth=depths[t], mask=masks[t])
    pr, _ = resumed.trajectory()
    resume_launches = dict(_native.LAUNCHES)
    pr_gba, _ = resumed.terminate()
    shutil.rmtree(saved["path"])
    same_resume = bool(np.array_equal(pr, pg))
    same_resume_gba = bool(np.array_equal(pr_gba, pg_gba))
    emit("checkpoint_resume", saved_at_frame=saved["frame"],
         resumed_frames=WILD_FRAMES - saved["frame"] - 1,
         replays_per_tier={graph_label(k): v
                           for k, v in resumed.runner.replays.items()},
         launches=resume_launches, trajectory_bitwise_equal=same_resume,
         after_global_ba_bitwise_equal=same_resume_gba,
         max_abs_pose_diff=float(np.abs(pr - pg).max()))
    if not same_resume or not same_resume_gba:
        fail("checkpoint_resume: the resumed trajectory differs from the "
             "uninterrupted run's")
    for k in expect:
        if resume_launches[k] <= 0:
            fail(f"checkpoint_resume: kernel {k} was not launched")
    launches = dict.fromkeys(_native.LAUNCHES, 0)
    for run in (lg, ls, gba_launches, gba_sync_launches, resume_launches):
        for k, v in run.items():
            launches[k] += v
    return launches


def phase_graph_vs_sync_default(graph_run, n_frames):
    """default.yaml through graph replay against two synchronous eager runs
    of the same tree: the same keyframe drops; the graph run's poses
    differ from the first eager run's by at most twice as much as the two
    eager runs differ from each other (BA's index_add_ atomics make eager
    runs differ)."""
    expect = ("corr_pyramid", "runsum")
    runs = [phase_slam(f"slam_default_sync_{i}", "configs/default.yaml",
                       n_frames, expect, sync_mode=True) for i in (1, 2)]
    (_, pa, kfa, *_), (_, pb, kfb, *_) = runs
    _, pg, kfg, *_ = graph_run
    eager_diff = float(np.abs(pa - pb).max())
    graph_diff = float(np.abs(pg - pa).max())
    same_kf = kfa == kfb == kfg
    emit("graph_vs_sync_default", frames=n_frames,
         max_abs_pose_diff_eager_vs_eager=eager_diff,
         max_abs_pose_diff_graph_vs_eager=graph_diff,
         tol=2 * eager_diff, same_keyframe_drops=same_kf,
         keyframe_drops=len(kfg))
    if not same_kf or not graph_diff <= 2 * eager_diff:
        fail(f"default.yaml: graph replay differs from sync_mode by "
             f"{graph_diff} (two eager runs: {eager_diff}), same keyframe "
             f"drops: {same_kf}")
    launches = dict.fromkeys(_native.LAUNCHES, 0)
    for run in runs:
        for k, v in run[0].items():
            launches[k] += v
    return launches


def phase_slam_tiny(fused=False, variant="x32", corr_kernel="corr_pyramid"):
    """The VO slice at a tiny size in fp32: on the card through graph
    replay and through sync_mode (kernels), and on the CPU (plain
    versions), same seed and frames. The card's graph run agrees with the
    CPU run within 1e-2 and with the card's sync_mode run (and, unfused,
    its PIPELINE_CHUNK = 4 run) within 1e-4, with the same keyframe drops.
    At 48x64 the /4 map is 3x4, smaller than any region: the region
    kernels' map-edge case."""
    cfg = DPVOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
                     OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3,
                     KEYFRAME_INDEX=2, MEM=12, GRADIENT_BIAS=False,
                     MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0,
                     PALLAS_FUSED=fused, PALLAS_VARIANT=variant)
    ht, wd = 48, 64
    frames = synthetic_frames(14, ht=ht, wd=wd)
    intr = np.array([40.0, 40.0, wd / 2, ht / 2])
    out = {}
    runs = [("graph", "cuda", False, cfg), ("sync", "cuda", True, cfg),
            ("cpu", "cpu", False, cfg)]
    if not fused:
        # PIPELINE_CHUNK: 4 frames staged and uploaded at once, then 4
        # replays (the run's 4 steady frames are one chunk)
        runs.append(("chunk4", "cuda", False,
                     cfg.merge_from_dict({"PIPELINE_CHUNK": 4})))
    for run, dev, sync, run_cfg in runs:
        _native.reset_launch_counts()
        slam = DPVO(run_cfg, None, ht, wd, seed=0, device=dev,
                    sync_mode=sync)
        for t, img in enumerate(frames):
            slam(t, img, intr)
        replays = sum(slam.runner.replays.values())
        out[run] = (slam.terminate()[0], sorted(slam.delta),
                    _native.LAUNCHES[corr_kernel], replays)
    diff = float(np.abs(out["graph"][0] - out["cpu"][0]).max())
    diff_sync = float(np.abs(out["graph"][0] - out["sync"][0]).max())
    same_kf = out["graph"][1] == out["cpu"][1] == out["sync"][1]
    chunk, diff_chunk = {}, 0.0
    if "chunk4" in out:
        diff_chunk = float(np.abs(out["chunk4"][0] - out["graph"][0]).max())
        chunk = dict(max_abs_pose_diff_chunk4_vs_1=diff_chunk,
                     chunk4_replays=out["chunk4"][3])
        same_kf = same_kf and out["chunk4"][1] == out["graph"][1]
    emit("slam_tiny_vs_cpu", fused=fused, variant=variant,
         frames=len(frames), max_abs_pose_diff=diff, tol=TOL_SLAM_TINY,
         max_abs_pose_diff_graph_vs_sync=diff_sync, tol_sync=TOL_GRAPH_SYNC,
         same_keyframe_drops=same_kf, corr_kernel=corr_kernel,
         graph_replays=out["graph"][3], **chunk,
         corr_launches_card=out["graph"][2],
         corr_launches_card_sync=out["sync"][2],
         corr_launches_cpu=out["cpu"][2])
    if not same_kf or not diff <= TOL_SLAM_TINY or \
            not max(diff_sync, diff_chunk) <= TOL_GRAPH_SYNC:
        fail(f"tiny slice (fused={fused}, {variant}) through graph replay "
             f"disagrees with the CPU run ({diff}), sync_mode on the card "
             f"({diff_sync}) or PIPELINE_CHUNK 4 ({diff_chunk}), same "
             f"keyframe drops: {same_kf}")
    if out["graph"][3] <= 0 or out["sync"][3] != 0:
        fail(f"tiny slice (fused={fused}, {variant}): "
             f"{out['graph'][3]} graph replays, {out['sync'][3]} in "
             "sync_mode")
    if min(out["graph"][2], out["sync"][2]) <= 0 or out["cpu"][2] != 0:
        fail(f"tiny slice (fused={fused}, {variant}): {corr_kernel} "
             f"launched {out['graph'][2]} / {out['sync'][2]} times on the "
             f"card and {out['cpu'][2]} on the CPU")


# ---------------------------------------------------------------------------
# camera initialization and the dense engine
# ---------------------------------------------------------------------------

FOCAL_TRUE = 320.0               # the rendered scenes' fx = fy
CALIB_MAX_FRAMES = 30            # run_colmap_initialization's default
TOL_CALIB_FOCAL = 0.01           # card against CPU, relative
BOOT_FRAMES = 8
TOL_TRACK_OK_SHARE = 0.01        # card against CPU
TOL_TRACK_PX = 0.05              # median, points tracked on both
TOL_PRIOR_WRITE = 1e-5           # the card's written slots against the CPU's
DROID_FRAMES = 24
DROID_SMALL = 4                  # the card-against-CPU run at 1/4 size
DROID_SMALL_FRAMES = 8
# the dense engine, card against CPU (each frame from the CPU's state):
# the dense BA on the same inputs in fp64 (poses; translations over the
# scale; read 1.1e-11), the share of flow targets more than 1e-3 px apart
# (LK's near-singular windows; read 1.0%), and the engines' poses: within
# TOL_DROID_ENGINE (x the scale for translations) beyond the two fp32
# solves' distances from the fp64 one (the CPU's read 5.9e-3 on the frame
# where the engines differ by 5.4e-3)
TOL_DROID_FP64 = 1e-9
TOL_DROID_FLOW_SHARE = 0.02
TOL_DROID_ENGINE = 1e-3


def calibrate(frames, device):
    """The self-calibration's steps (`init/colmap_init.py`) over in-memory
    frames on `device`: frame selection, fp32 matching with the trained
    weights, the focal and its confidence. Returns (record, [fx, fy, cx,
    cy])."""
    t0 = time.perf_counter()
    idx = tci.select_frames(frames, max_frames=CALIB_MAX_FRAMES,
                            device=device)
    t1 = time.perf_counter()
    pairs, hw = tci.match_frames([frames[i] for i in idx], WEIGHTS,
                                 device=device)
    t2 = time.perf_counter()
    f, cx, cy = tci.estimate_focal(pairs, hw)
    conf = tci.calibration_confidence(pairs, f, cx, cy, hw)
    t3 = time.perf_counter()
    rec = dict(selected=idx, frames_selected=len(idx), pairs=len(pairs),
               matches_per_pair=[len(p0) for p0, _ in pairs], focal=f,
               cx=cx, cy=cy, focal_rel_err=abs(f - FOCAL_TRUE) / FOCAL_TRUE,
               **conf, select_s=t1 - t0, match_s=t2 - t1,
               estimate_s=t3 - t2, seconds=t3 - t0)
    return rec, np.array([f, f, cx, cy])


def phase_calib_keep(keep):
    """Self-calibration of the stride-4 walk's 40 frames on the card and
    on the CPU: the same frames selected, the card's focal within
    TOL_CALIB_FOCAL of the CPU's. (The stride-1 walk moves about 5 px a
    frame: its consecutive pairs leave the Bougnoux focal undetermined,
    f = 806.7 on the CPU, a flat valley, 15% predicted.) Returns the
    card's intrinsics."""
    frames = keep[0]
    card, intr = calibrate(frames, DEV)
    cpu, _ = calibrate(frames, "cpu")
    g = [tfb.bgr_to_gray(torch.as_tensor(frames[k], device=DEV))
         for k in (0, 1)]
    fb_ms = time_ms(lambda: tfb.farneback_flow(*g), reps=10)
    same = card["selected"] == cpu["selected"]
    rel = abs(card["focal"] - cpu["focal"]) / cpu["focal"]
    emit("calib_keep", scene=f"wild_sequence(stride={KEEP_STRIDE})",
         frames=len(frames), HxW=[HT, WD], focal_true=FOCAL_TRUE, card=card,
         cpu=cpu, same_selection=same, focal_card_vs_cpu_rel=rel,
         tol=TOL_CALIB_FOCAL, farneback_ms_per_pair_card=fb_ms,
         farneback_levels=tfb.pyramid_levels(HT, WD) + 1)
    if not same or not rel <= TOL_CALIB_FOCAL:
        fail(f"calib_keep: selections equal {same}, focal card "
             f"{card['focal']} against CPU {cpu['focal']}")
    return intr


def phase_wild_calibrated(wild, intr, true_record):
    """phase_wild's default.yaml run (depth, mask, replayed) with the
    estimated intrinsics in place of the true ones; its ATE beside the
    true calibration's from this call."""
    est = (wild[0], wild[1], intr, wild[3], wild[4])
    launches, _, _, _, rec = phase_slam(
        "slam_wild_calibrated", "configs/default.yaml", WILD_FRAMES,
        ("corr_pyramid", "runsum"), wild=est, network=WEIGHTS, inputs="dm")
    emit("wild_calibrated_vs_true", intrinsics_estimated=intr.tolist(),
         intrinsics_true=np.asarray(wild[2]).tolist(),
         focal_rel_err=abs(intr[0] - FOCAL_TRUE) / FOCAL_TRUE,
         ate_rmse_calibrated=rec["ate_rmse"],
         ate_rmse_true_calibration=true_record["ate_rmse"],
         ate_floor_identity=rec["ate_floor_identity"])
    return launches


def _rotation_errors_deg(poses_c2w, poses_gt_w2c):
    """Angle between each estimated rotation from frame 0 and the
    ground truth's, in degrees."""
    R = lie.quat_to_matrix(torch.as_tensor(poses_gt_w2c[:, 3:7],
                                           dtype=torch.float64)).numpy()
    out = []
    for k in range(1, len(poses_c2w)):
        est = np.linalg.inv(poses_c2w[k])[:3, :3]
        gt = R[k] @ R[0].T
        c = (np.trace(est @ gt.T) - 1) / 2
        out.append(float(np.degrees(np.arccos(np.clip(c, -1, 1)))))
    return out


def phase_bootstrap_wild(wild):
    """The geometric bootstrap on the wild walk's first BOOT_FRAMES
    frames: `track_grid` on the card against the CPU (ok shares within
    TOL_TRACK_OK_SHARE, median difference of the points tracked on both
    under TOL_TRACK_PX), `geometric_initialization` (rotation error
    against the ground truth printed), then `bootstrap_slam` into a
    default.yaml DPVO that has taken those frames (images only): the
    written slots equal to `init_from_prior` on a CPU copy of the state,
    frame 0 the identity, the state's storages the same; the run goes on
    over the rest, beside one without the bootstrap."""
    frames, poses_gt, intr = wild[0], wild[1], np.asarray(wild[2])
    boot = list(frames[:BOOT_FRAMES])
    tracks, secs = {}, {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        tracks[dev] = tmi.track_grid(boot, device=dev)
        secs[dev] = time.perf_counter() - t0
    (grid, tr_c, ok_c), (_, tr_h, ok_h) = tracks[DEV], tracks["cpu"]
    share_c, share_h = float(ok_c[1:].mean()), float(ok_h[1:].mean())
    both = ok_c & ok_h
    both[0] = False
    med = float(np.median(np.linalg.norm(tr_c[both] - tr_h[both], axis=-1)))
    t0 = time.perf_counter()
    depths, poses_c2w = tmi.geometric_initialization(
        None, intr, tracks=tracks[DEV], image_size=(HT, WD))
    geo_s = time.perf_counter() - t0
    rot = _rotation_errors_deg(poses_c2w, poses_gt[:BOOT_FRAMES])
    emit("track_grid", frames=BOOT_FRAMES, points=int(grid.shape[0]),
         ok_share_card=share_c, ok_share_cpu=share_h,
         median_track_diff_px=med, card_s=secs[DEV], cpu_s=secs["cpu"],
         geometric_initialization_s=geo_s,
         rotation_err_deg_per_frame=rot, rotation_err_deg_max=max(rot))
    if not abs(share_c - share_h) <= TOL_TRACK_OK_SHARE or \
            not med < TOL_TRACK_PX:
        fail(f"track_grid: ok shares card {share_c} CPU {share_h}, median "
             f"track difference {med} px")

    checks = {}

    def bootstrap(t, slam):
        if t != BOOT_FRAMES - 1:
            return
        st = slam.state
        keys = ("patches", "patches_est", "poses")
        ptrs = [getattr(st, k).data_ptr() for k in keys]
        cpu = types.SimpleNamespace(cfg=slam.cfg, state=types.SimpleNamespace(
            **{k: getattr(st, k).cpu().clone() for k in keys}))
        t0 = time.perf_counter()
        d, p = tmi.bootstrap_slam(slam, boot, intr, tracks=tracks[DEV],
                                  image_size=(HT, WD), device=DEV)
        torch.cuda.synchronize()
        checks["bootstrap_slam_s"] = time.perf_counter() - t0
        tpi.init_from_prior(cpu, d, p, range(BOOT_FRAMES))
        tpi.anchor_first_frame(cpu)
        rows = BOOT_FRAMES * slam.M
        diff = max(float((getattr(st, k)[:n].cpu() - getattr(cpu.state, k)[
            :n]).abs().max()) for k, n in zip(keys, (rows, rows,
                                                     BOOT_FRAMES)))
        ident = float((st.poses[0].cpu() - lie.se3_identity()).abs().max())
        checks.update(written_vs_cpu_max_abs=diff,
                      frame0_vs_identity_max_abs=ident,
                      storages_unchanged=ptrs == [getattr(st, k).data_ptr()
                                                  for k in keys])

    runs = {}
    for name, hook in (("slam_wild_bootstrap", bootstrap),
                       ("slam_wild_images", None)):
        runs[name] = phase_slam(name, "configs/default.yaml", WILD_FRAMES,
                                ("corr_pyramid", "runsum"), wild=wild,
                                network=WEIGHTS, on_frame=hook)
    emit("bootstrap_wild", frames=BOOT_FRAMES, **checks,
         tol=TOL_PRIOR_WRITE,
         ate_rmse_bootstrap=runs["slam_wild_bootstrap"][4]["ate_rmse"],
         ate_rmse_without=runs["slam_wild_images"][4]["ate_rmse"],
         ate_floor_identity=runs["slam_wild_images"][4]["ate_floor_identity"])
    if not checks or not checks["storages_unchanged"] or \
            not checks["written_vs_cpu_max_abs"] <= TOL_PRIOR_WRITE or \
            not checks["frame0_vs_identity_max_abs"] <= TOL_PRIOR_WRITE:
        fail(f"bootstrap_wild: {checks}")
    launches = dict.fromkeys(_native.LAUNCHES, 0)
    for run in runs.values():
        for k, v in run[0].items():
            launches[k] += v
    return launches


def _pose_diff(a, b):
    """(largest |a - b| of the quaternions, of the translations)."""
    d = (a.double().cpu() - b.double().cpu()).abs()
    return float(d[:, 3:].max()), float(d[:, :3].max())


def _dense_ba_orders(inputs, kw, cpu32):
    """One frame's dense BA on the CPU engine's exact inputs, solved on
    the card in fp32, in fp64, with the edges in another order and
    through the one-hot path, and in fp64 on the CPU. Returns each pose
    difference named."""
    dev_in = [x.to(DEV) for x in inputs]

    def f64(xs):
        return [x.double() if x.is_floating_point() else x for x in xs]

    card32 = tdense.dense_ba(*dev_in, **kw)[0]
    card64 = tdense.dense_ba(*f64(dev_in), **kw)[0]
    cpu64 = tdense.dense_ba(*f64(inputs), **kw)[0]
    perm = torch.randperm(inputs[5].shape[0],
                          generator=torch.Generator().manual_seed(0))
    permuted = dev_in[:3] + [x[perm.to(DEV)] for x in dev_in[3:]]
    card_perm = tdense.dense_ba(*permuted, **kw)[0]
    prob = tdense.dense_problem(*dev_in, stride=kw["stride"])
    cfg = tba.BAConfig(window=kw["t1"] - kw["t0"],
                       patch_slots=inputs[1].shape[0] * prob[-1][0].shape[0],
                       iterations=kw["iterations"], per_patch_cap=None)
    card_onehot = tba._bundle_adjust_impl(
        dev_in[0], prob[0], dev_in[2], *prob[1:3], 1e-4, *prob[3:7],
        kw["t0"], kw["t1"], 0, cfg)[0]
    return dict(card_vs_cpu=_pose_diff(card32, cpu32),
                card_vs_cpu_fp64=_pose_diff(card64, cpu64),
                card_fp32_vs_fp64=_pose_diff(card32, card64),
                cpu_fp32_vs_fp64=_pose_diff(cpu32, card64),
                card_edges_permuted=_pose_diff(card_perm, card32),
                card_one_hot_vs_table=_pose_diff(card_onehot, card32),
                scale=max(1.0, float(card64[:, :3].abs().max())))


def _droid_small(frames, intr, flow):
    """The dense engine at 1/DROID_SMALL size on the card and on the CPU,
    each frame started from the CPU engine's state. Per frame: the flow
    targets card against CPU, the dense BA on the CPU's exact inputs
    (`_dense_ba_orders`) and the engines' poses. Returns (record, list of
    gate failures)."""
    s = DROID_SMALL
    small = [f.reshape(HT // s, s, WD // s, s, 3).mean((1, 3)).round()
             .astype(np.uint8) for f in frames]
    kw = dict(intrinsics=intr / s, buffer=16, stride=8, window=6,
              kf_thresh=2.4, flow=flow, network=WEIGHTS)
    card = tdroid.DenseVO(HT // s, WD // s, device=DEV, **kw)
    cpu = tdroid.DenseVO(HT // s, WD // s, device="cpu", **kw)
    calls = {}
    dense_ba = tdroid.dops.dense_ba

    def recorded(*args, **kwargs):
        out = dense_ba(*args, **kwargs)
        calls[args[0].device.type] = ([a.clone() for a in args], kwargs,
                                      out[0].clone())
        return out

    frames_rec, bad = [], []
    tdroid.dops.dense_ba = recorded
    try:
        for t, img in enumerate(small):
            card.poses[:cpu.n] = cpu.poses[:cpu.n].to(DEV)
            card.disps[:cpu.n] = cpu.disps[:cpu.n].to(DEV)
            calls.clear()
            card(t, img)
            cpu(t, img)
            if card.n != cpu.n:
                bad.append(f"frame {t}: {card.n} frames kept on the card, "
                           f"{cpu.n} on the CPU")
            if t == 0:
                continue
            (a_c, _, _), (a_h, kw_h, p_h) = calls[DEV.type], calls["cpu"]
            on = a_h[4][..., 0] > 0
            d = (a_c[3].cpu() - a_h[3])[on].abs().amax(-1)
            rec = dict(frame=t, flow_px_max=float(d.max()),
                       flow_share_over_1e3_px=float((d > 1e-3).float()
                                                    .mean()),
                       **_dense_ba_orders(a_h, kw_h, p_h))
            n = min(card.n, cpu.n)
            rec["engine_card_vs_cpu"] = _pose_diff(card.poses[:n],
                                                   cpu.poses[:n])
            frames_rec.append(rec)
    finally:
        tdroid.dops.dense_ba = dense_ba
    for rec in frames_rec:
        t, sc = rec["frame"], rec["scale"]
        q64, t64 = rec["card_vs_cpu_fp64"]
        if not max(q64, t64 / sc) <= TOL_DROID_FP64:
            bad.append(f"frame {t}: dense BA in fp64, card against CPU "
                       f"{rec['card_vs_cpu_fp64']}")
        if not rec["flow_share_over_1e3_px"] <= TOL_DROID_FLOW_SHARE:
            bad.append(f"frame {t}: {rec['flow_share_over_1e3_px']} of the "
                       f"flow targets differ by more than 1e-3 px")
        # beyond each side's fp32 rounding, read against the fp64 solution
        # of the same frame, the engines agree within TOL_DROID_ENGINE
        (qc, tc), (qh, th) = rec["card_fp32_vs_fp64"], rec["cpu_fp32_vs_fp64"]
        q, tr = rec["engine_card_vs_cpu"]
        if not (q <= TOL_DROID_ENGINE + qc + qh and
                tr <= TOL_DROID_ENGINE * sc + tc + th):
            bad.append(f"frame {t}: engine poses card against CPU {q} "
                       f"(quaternions), {tr} (translations), fp32 "
                       f"distances from the fp64 solution "
                       f"{rec['card_fp32_vs_fp64']} (card), "
                       f"{rec['cpu_fp32_vs_fp64']} (CPU)")

    def worst(key):
        return [max(r[key][k] for r in frames_rec) for k in (0, 1)]

    record = dict(kept=cpu.n, same_keyframes=not any("kept" in b
                                                     for b in bad),
                  flow_px_max=max(r["flow_px_max"] for r in frames_rec),
                  flow_share_over_1e3_px_max=max(
                      r["flow_share_over_1e3_px"] for r in frames_rec),
                  scale_max=max(r["scale"] for r in frames_rec),
                  **{f"{k}_q_t": worst(k) for k in (
                      "engine_card_vs_cpu", "card_vs_cpu",
                      "card_vs_cpu_fp64", "card_fp32_vs_fp64",
                      "cpu_fp32_vs_fp64", "card_edges_permuted",
                      "card_one_hot_vs_table")},
                  per_frame=frames_rec)
    return record, bad


def phase_droid_keep(keep):
    """`DenseVO` (flow "corr", the trained weights, stride 8, window 6,
    kf_thresh 2.4) over the first DROID_FRAMES frames of the stride-4
    walk at 384x512 on the card: ATE, floor, frames kept, ms per frame,
    peak device memory; then card against CPU at 1/4 size over
    DROID_SMALL_FRAMES frames with both flows, each frame from the CPU
    engine's state (`_droid_small`): the same keyframe decisions, the
    dense BA in fp64 on the same inputs within TOL_DROID_FP64, the flow
    targets, and the engines' poses within TOL_DROID_ENGINE beyond the
    fp32 rounding of each side."""
    frames, poses_gt = keep[0][:DROID_FRAMES], keep[1][:DROID_FRAMES]
    intr = np.asarray(keep[2], np.float32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vo = tdroid.DenseVO(HT, WD, intr, stride=8, window=6, kf_thresh=2.4,
                        flow="corr", network=WEIGHTS, device=DEV)
    ms = []
    for t, img in enumerate(frames):
        t0 = time.perf_counter()
        vo(t, img)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    c2w, ts = vo.terminate()
    ate, n_aligned, floor = synth_ate.ate_against(c2w, ts, poses_gt)
    small = {flow: _droid_small(frames[:DROID_SMALL_FRAMES], intr, flow)
             for flow in ("lk", "corr")}
    emit("droid_keep", frames=DROID_FRAMES, HxW=[HT, WD], flow="corr",
         stride=8, window=6, kf_thresh=2.4, frames_kept=vo.n,
         ms_per_frame_median=statistics.median(ms[1:]),
         ms_per_frame_mean=statistics.mean(ms[1:]), ms_first_two=ms[:2],
         peak_memory_allocated_bytes=peak, memory_allocated_before=base,
         ate_rmse=ate, ate_floor_identity=floor, n_aligned=n_aligned,
         poses_finite=bool(np.isfinite(c2w).all()),
         card_vs_cpu={f"{flow}_{HT // DROID_SMALL}x{WD // DROID_SMALL}": rec
                      for flow, (rec, _) in small.items()},
         tol_engine=TOL_DROID_ENGINE, tol_fp64=TOL_DROID_FP64,
         tol_flow_share=TOL_DROID_FLOW_SHARE)
    if not np.isfinite(c2w).all():
        fail("droid_keep: poses not finite")
    for flow, (_, bad) in small.items():
        if bad:
            fail(f"droid_keep: card against CPU ({flow}): " + "; ".join(bad))

# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

GRAD_SOURCE = "wild_video_3d_reconstruction_torch/csrc/corr_grad.cu"
# the backward kernel replaces no TPU kernel: XLA differentiates the JAX
# package's plain correlation on its training path
GRAD_REPLACES = ("none: XLA's gradient of "
                 "wild_video_3d_reconstruction_tpu/ops/corr.py:115 "
                 "(patch_corr_pyramid)")
# trainer.train's default TrainConfig(frames=8, patches=32, steps=8)
TRAIN_FULL = TrainConfig(frames=8, patches=32, steps=8)
TRAIN_FULL_BATCH = 4
TRAIN_FULL_STEPS = 3
# eval/learn_synth.py's recipe: TrainConfig(6, 8, steps=3), 48x64,
# batch 4, lr 3e-4 with the one-cycle schedule, 8 held-out clips
TRAIN_LS = TrainConfig(frames=6, patches=8, steps=3)
TRAIN_LS_STEPS = 50
# each gradient of the backward kernel against autograd through the plain
# version, relative to its largest magnitude: fp32 atomics add in the
# order the warps arrive, the plain version sums in another order; the
# forward's fp32 instantiation likewise (fp32 sums of 128 products)
TOL_CORR_GRAD_REL = 1e-5
TOL_CORR_FP32_REL = 1e-5
# train_step_card_vs_cpu: the loss within TOL_TRAIN_LOSS_REL; each
# parameter tensor's gradient within TOL_TRAIN_GRAD_REL of its norm plus
# 1e-6 of the global norm (the gradients that are zero by symmetry are
# rounding noise on both sides); the card's BA sums in fp64, cuDNN and the
# kernels sum in other orders. The first reading (NVIDIA H100 80GB HBM3,
# 700 W): loss 4.1e-7, gradients at most 1.5e-5, median 1.1e-5
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_GRAD_REL = 1e-4
TOL_TRAIN_GRAD_GLOBAL = 1e-6
# the JAX package's own `eval/learn_synth.py:evaluate` of the checkpoint
# checkpoints/synth_tpu_r3_step2000 (the weights' source) on the same
# held-out clips, on the CPU: scripts/torch_learn_synth_checkpoint.py
# (its draws differ from the port's, ROADMAP R18)
JAX_CHECKPOINT_EPE = 0.03382406523451209


def train_corr_inputs(gen):
    """The training forward's correlation at TRAIN_FULL: T = 8 fp32 maps
    of a 384x512 frame (/4 and /16), T * M = 256 patches, the all-pairs
    edges (2048, 1792 live: ii != jj). Patch centres uniform over the map
    and 16 px beyond it (windows on the map, straddling its edge and off
    it), 10% of them a further 200 px off; a random flow."""
    T, M = TRAIN_FULL.frames, TRAIN_FULL.patches
    h4, w4 = HT // 4, WD // 4

    def randn(*shape):
        return (0.25 * torch.randn(*shape, generator=gen)).to(DEV)

    gmap = randn(T * M, 128, 3, 3)
    fmap1 = randn(T, h4, w4, 128)
    fmap2 = randn(T, h4 // 4, w4 // 4, 128)
    _, jj, kk, keep = all_pairs_edges(T, M)
    E = kk.shape[0]
    cx = torch.rand(E, generator=gen) * (w4 + 32) - 16
    cy = torch.rand(E, generator=gen) * (h4 + 32) - 16
    far = torch.rand(E, generator=gen) < 0.1
    cx = torch.where(far, cx + 200.0, cx)
    flow = 2.0 * torch.randn(E, 2, generator=gen)
    off = torch.arange(3.0) - 1
    x = (cx + flow[:, 0])[:, None, None] + off[None, None, :]
    y = (cy + flow[:, 1])[:, None, None] + off[None, :, None]
    coords = torch.stack([x.expand(E, 3, 3), y.expand(E, 3, 3)], -1)
    return (gmap, fmap1, fmap2, coords.to(DEV).contiguous(),
            kk.to(DEV, torch.int32), jj.to(DEV, torch.int32), keep.to(DEV))


def window_classes(pyr, coords, valid):
    """Per level, the shares of the valid edges' pixel windows that lie
    wholly on the map, straddle its edge, or miss it."""
    out = {}
    v = valid.bool()
    for (fmap, s), name in zip(zip(pyr, LEVELS), ("level1", "level2")):
        _, H, W, _ = fmap.shape
        ys, xs = tcorr.window_starts(coords[v] / s)
        inside = (ys >= 0) & (ys + 8 <= H) & (xs >= 0) & (xs + 8 <= W)
        on = (ys > -8) & (ys < H) & (xs > -8) & (xs < W)
        n = ys.numel()
        out[name] = dict(on=int(inside.sum()) / n,
                         straddle=int((on & ~inside).sum()) / n,
                         off=int((~on).sum()) / n)
    return out


def kernel_corr_backward(gen):
    """csrc/corr_grad.cu against autograd through the plain version at the
    full training shape; the forward's fp32 instantiation against its
    plain version on the same inputs."""
    gmap, fmap1, fmap2, coords, kk, jj, valid = train_corr_inputs(gen)
    pyr = (fmap1, fmap2)
    E = coords.shape[0]
    out = corr_lookup(gmap, pyr, coords, kk, jj, valid)
    torch.cuda.synchronize()
    ref = patch_corr_pyramid(gmap, pyr, coords, kk, jj, valid=valid)
    fwd_rel = (out - ref).abs().max().item() / ref.abs().max().item()
    fwd_ms = time_ms(lambda: corr_lookup(gmap, pyr, coords, kk, jj, valid))
    del out, ref
    go = torch.randn(E, 882, generator=gen).to(DEV)

    def launch():
        return tcorr.corr_pyramid_backward(go, gmap, pyr, coords, kk, jj,
                                           valid)

    grads, again = launch(), launch()
    torch.cuda.synchronize()
    plain = tcorr.corr_pyramid_backward_plain(go, gmap, pyr, coords, kk, jj,
                                              valid)
    names = ("gmap", "fmap1", "fmap2")
    rel = {n: (a - b).abs().max().item() / b.abs().max().item()
           for n, a, b in zip(names, grads, plain)}
    abs_err = max((a - b).abs().max().item() for a, b in zip(grads, plain))
    rerun = {n: (a - b).abs().max().item() / b.abs().max().item()
             for n, a, b in zip(names, grads, again)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    ms = time_ms(launch)
    ms_b2b = back_to_back_ms(launch)
    # the plain version's backward alone: autograd through the plain
    # forward, whose graph is built once
    leaves = [t.detach().clone().requires_grad_() for t in (gmap, *pyr)]
    with torch.enable_grad():
        plain_out = patch_corr_pyramid(leaves[0], tuple(leaves[1:]), coords,
                                       kk, jj, valid=valid)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        plain_out, leaves, go, retain_graph=True), reps=5, warmup=1)
    del plain_out, leaves, plain, again
    n_bytes, flops = corr_work(gmap, pyr, coords, kk, jj, valid, *grads)
    n_bytes += int(valid.sum()) * 882 * 4          # grad_out's valid rows
    row = dict(
        name="corr_pyramid_backward", route="cuda", source=GRAD_SOURCE,
        replaces=GRAD_REPLACES, max_abs_err=abs_err, ms=ms,
        ms_back_to_back=ms_b2b, plain_ms=plain_ms,
        # 4 fp32 flops per channel and in-map window position (SIMT)
        **bound(n_bytes, 2 * flops, FP32_FLOPS), library_ms=None)
    emit("kernel_corr_backward", E=E, live_edges=int(valid.sum()),
         fmap1=list(fmap1.shape), fmap2=list(fmap2.shape),
         windows=window_classes(pyr, coords, valid), rel_err=rel,
         tol_rel=TOL_CORR_GRAD_REL, two_calls_rel_diff=rerun, finite=finite,
         bytes=n_bytes, flops=2 * flops, forward_fp32_rel_err=fwd_rel,
         forward_fp32_ms=fwd_ms, tol_forward_fp32_rel=TOL_CORR_FP32_REL,
         **row)
    if not finite or max(rel.values()) > TOL_CORR_GRAD_REL or \
            max(rerun.values()) > TOL_CORR_GRAD_REL:
        fail(f"kernel_corr_backward: relative errors {rel}, two calls "
             f"{rerun} (tol {TOL_CORR_GRAD_REL}), finite {finite}")
    if not fwd_rel <= TOL_CORR_FP32_REL:
        fail(f"kernel_corr_backward: the fp32 forward disagrees with its "
             f"plain version: {fwd_rel} > {TOL_CORR_FP32_REL}")
    return row


def _train_draws(tc, batch_size, ht, wd, seed=0):
    """Injected patch centres [B, T, M, 2] and initial depths [B, T*M]."""
    rng = np.random.default_rng(seed)
    T, M = tc.frames, tc.patches
    coords = np.stack([rng.integers(1, wd // 4 - 1, (batch_size, T, M)),
                       rng.integers(1, ht // 4 - 1, (batch_size, T, M))],
                      -1).astype(np.float32)
    d0 = rng.uniform(0.2, 1.0, (batch_size, T * M)).astype(np.float32)
    return coords, d0


def phase_train_step_card_vs_cpu():
    """One training step (loss, backward, AdamW) on the same batch and
    draws on the card and on the CPU (plain versions)."""
    tc = TRAIN_LS._replace(edge_dropout=0.0)
    batch = make_world_batch(77, 2, tc)
    coords, d0 = _train_draws(tc, 2, 48, 64)
    sides, launches = {}, {}
    p0 = {n: p.detach().double() for n, p in
          vonet.init_vonet(0).named_parameters()}
    for side, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        net = vonet.init_vonet(0).to(dev)
        opt = tts.make_optimizer(net.parameters(), lr=3e-4, steps=100)
        _native.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics = tts.clip_loss_fn(net, tts.batch_to(batch, dev),
                                         torch.Generator(), tc, coords, d0)
        loss.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in net.named_parameters()}
        opt.step()
        moved = {n: p.detach().double().cpu() - p0[n]
                 for n, p in net.named_parameters()}
        seconds = time.perf_counter() - t0
        if side == "card":
            launches = dict(_native.LAUNCHES)
        sides[side] = dict(loss=float(loss.detach()), grads=grads,
                           moved=moved, seconds=seconds,
                           **{k: float(v.detach()) for k, v in
                              metrics.items() if k != "loss"})
    card, cpu = sides["card"], sides["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    total = float(torch.sqrt(sum((g * g).sum() for g in
                                 cpu["grads"].values())))
    rel, bad, noise = {}, [], []
    for n, g in cpu["grads"].items():
        err = float((card["grads"][n] - g).norm())
        rel[n] = err / max(float(g.norm()), 1e-30)
        if float(g.norm()) < TOL_TRAIN_GRAD_GLOBAL * total:
            noise.append(n)
        if err > TOL_TRAIN_GRAD_REL * float(g.norm()) + \
                TOL_TRAIN_GRAD_GLOBAL * total:
            bad.append((n, rel[n]))
    signal_rel = sorted(v for n, v in rel.items() if n not in noise)
    def moved_rel(names):
        err = sum(float(((card["moved"][n] - cpu["moved"][n]) ** 2).sum())
                  for n in names)
        norm = sum(float((cpu["moved"][n] ** 2).sum()) for n in names)
        return (err / norm) ** 0.5

    worst = max((v, n) for n, v in rel.items() if n not in noise)
    emit("train_step_card_vs_cpu", frames=tc.frames, patches=tc.patches,
         steps=tc.steps, batch=2, HxW=[48, 64], edge_dropout=0.0,
         loss_card=card["loss"], loss_cpu=cpu["loss"], loss_rel=loss_rel,
         flow_loss=[card["flow_loss"], cpu["flow_loss"]],
         pose_loss=[card["pose_loss"], cpu["pose_loss"]],
         tensors=len(rel), grad_norm_cpu=total,
         grad_rel_max=worst[0], grad_rel_max_tensor=worst[1],
         grad_rel_median=statistics.median(signal_rel),
         symmetry_zero_tensors=len(noise),
         symmetry_zero_rel_max=max((rel[n] for n in noise), default=0.0),
         adamw_displacement_rel=moved_rel(rel),
         adamw_displacement_rel_without_symmetry_zero=moved_rel(
             [n for n in rel if n not in noise]),
         seconds_card=card["seconds"], seconds_cpu=cpu["seconds"],
         launches=launches, tol_loss_rel=TOL_TRAIN_LOSS_REL,
         tol_grad_rel=TOL_TRAIN_GRAD_REL)
    if not loss_rel <= TOL_TRAIN_LOSS_REL or bad or len(rel) != 94:
        fail(f"train_step_card_vs_cpu: loss rel {loss_rel}, gradients "
             f"beyond tolerance: {bad[:5]}")
    if not launches["corr_pyramid"] or not launches["corr_pyramid_backward"]:
        fail(f"train_step_card_vs_cpu: correlation kernels not launched: "
             f"{launches}")
    return launches


def phase_train_learn_synth():
    """eval/learn_synth.py's recipe on the card from a seed-0 network;
    the trained checkpoint on the same held-out clips."""
    _native.reset_launch_counts()
    res = learn_synth.main(steps=TRAIN_LS_STEPS, batch=4, eval_clips=8,
                           lr=3e-4, seed=0, log_every=10, device=DEV)
    launches = dict(_native.LAUNCHES)
    losses = res["losses"]
    held = learn_synth.held_out_batches(TRAIN_LS)
    ckpt = learn_synth.evaluate(load_reference_checkpoint(WEIGHTS, DEV),
                                held, TRAIN_LS, DEV)
    finite = bool(np.isfinite(losses).all())
    emit("train_learn_synth", steps=TRAIN_LS_STEPS, batch=4,
         frames=TRAIN_LS.frames, patches=TRAIN_LS.patches,
         unrolled=TRAIN_LS.steps, HxW=[48, 64], lr=3e-4,
         loss_every_10=losses[::10], loss_last=losses[-1],
         all_losses_finite=finite, before=res["before"], after=res["after"],
         epe_ratio=res["epe_ratio"],
         ms_per_step=res["train_s"] / TRAIN_LS_STEPS * 1e3,
         launches=launches, checkpoint=WEIGHTS, checkpoint_eval=ckpt,
         jax_checkpoint_epe_cpu=JAX_CHECKPOINT_EPE,
         jax_checkpoint_epe_source="scripts/torch_learn_synth_checkpoint.py")
    if not finite or not res["after"]["epe"] < res["before"]["epe"]:
        fail(f"train_learn_synth: losses finite {finite}, EPE "
             f"{res['before']['epe']} -> {res['after']['epe']}")
    if not launches["corr_pyramid_backward"]:
        fail("train_learn_synth: the backward kernel was not launched")
    return launches


def render_train_clips(seed, n, frames, ht, wd, f):
    """n clips of render_clip at ht x wd with focal f, stacked in the
    training step's batch layout (in a render worker)."""
    rng = np.random.default_rng(seed)
    clips = [render_clip(rng, frames=frames, ht=ht, wd=wd, fx=f, fy=f)
             for _ in range(n)]
    return {k: np.stack([c[i] for c in clips]) for i, k in
            enumerate(("images", "poses", "disps", "intrinsics"))}


def phase_train_full(batch):
    """trainer.train's default configuration at the VO's 384x512: a few
    steps from a seed-0 network, the backward kernel's time in CUDA
    events around each launch."""
    net = vonet.init_vonet(0).to(DEV)
    step = tts.build_train_step(net, TRAIN_FULL, tts.make_optimizer(
        net.parameters(), lr=8e-5), DEV)
    gen = torch.Generator().manual_seed(1)
    events = []
    saved = tcorr.corr_pyramid_backward

    def timed_backward(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = saved(*a, **kw)
        ev[1].record()
        events[-1].append(ev)
        return out

    rows = []
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launch_counts()
    tcorr.corr_pyramid_backward = timed_backward
    try:
        for _ in range(TRAIN_FULL_STEPS):
            events.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            bwd = sum(a.elapsed_time(b) for a, b in events[-1])
            rows.append(dict(ms=ms, loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             backward_kernel_ms=bwd,
                             backward_kernel_launches=len(events[-1])))
    finally:
        tcorr.corr_pyramid_backward = saved
    launches = dict(_native.LAUNCHES)
    later = rows[1:]
    ms_step = statistics.mean(r["ms"] for r in later)
    share = sum(r["backward_kernel_ms"] for r in later) / \
        sum(r["ms"] for r in later)
    finite = all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                 for r in rows)
    emit("train_full", frames=TRAIN_FULL.frames,
         patches=TRAIN_FULL.patches, unrolled=TRAIN_FULL.steps,
         batch=TRAIN_FULL_BATCH, HxW=[HT, WD], fx=320.0,
         edges=TRAIN_FULL.frames ** 2 * TRAIN_FULL.patches, steps=rows,
         ms_first_step=rows[0]["ms"], ms_per_step=ms_step,
         backward_kernel_share=share,
         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, finite=finite)
    if not finite:
        fail(f"train_full: loss or gradient not finite: {rows}")
    if not launches["corr_pyramid"] or not launches["corr_pyramid_backward"]:
        fail(f"train_full: correlation kernels not launched: {launches}")
    return launches


def _timed(fn, *a, **kw):
    """fn(*a, **kw) and its seconds (in a render worker)."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def start_renders():
    """The scenes' host renders, started at once in worker processes (the
    host's numpy would otherwise hold the card idle for minutes): the wild
    walk, its stride-4 keep, the two-lap world, the full-size training
    clips, the NeRF orbit, recon_e2e's walk and the TUM / EuRoC-sized
    walks of the harness. Returns their futures."""
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    RENDER_POOL.append(pool)
    wild = functools.partial(synth_ate.wild_sequence, 0, frames=WILD_FRAMES,
                             ht=HT, wd=WD, fx=320.0, fy=320.0)
    return {
        "wild": pool.submit(_timed, wild),
        "keep": pool.submit(_timed, wild, stride=KEEP_STRIDE),
        "multilap": pool.submit(_timed, render_sequence, 0,
                                frames=MULTILAP_FRAMES, ht=HT, wd=WD,
                                fx=320.0, fy=320.0, path="multiloop",
                                n_planes=3),
        "train": pool.submit(_timed, render_train_clips, 0,
                             TRAIN_FULL_BATCH, TRAIN_FULL.frames, HT, WD,
                             320.0),
        "nerf": pool.submit(_timed, tnt.synth_scene, frames=NERF_FRAMES,
                            ht=HT, wd=WD, fx=320.0, fy=320.0),
        "recon": pool.submit(_timed, render_sequence, 0, frames=RECON_FRAMES,
                             ht=HT, wd=WD, fx=320.0, fy=320.0, path="walk"),
        "tum": pool.submit(_timed, render_sequence, 0, frames=TUM_FRAMES,
                           ht=TUM_HT, wd=TUM_WD, fx=320.0, fy=320.0,
                           path="walk"),
        "euroc": pool.submit(_timed, render_sequence, 0,
                             frames=EUROC_FRAMES, ht=EUROC_HT, wd=EUROC_WD,
                             fx=320.0, fy=320.0, path="walk")}


def multilap_config(loop):
    return load_config(
        "configs/default.yaml", KEYFRAME_THRESH=0.0,
        BUFFER_SIZE=MULTILAP_FRAMES + MULTILAP_AFTER + 8,
        MOTION_PROBE_THRESH=0.0, loop_enabled=loop, LC_INTERVAL=8,
        LOOP_CLOSE_WINDOW_SIZE=1, LOOP_RETR_THRESH=0.8,
        LOOP_SKIP_WINDOW=MULTILAP_LAP // 2)


def run_multilap(name, scene, net, vlad, loop, sync_mode):
    """One run over the two laps; returns (slam, record). Steady frames
    replay CUDA graphs unless sync_mode (no sync-debug mode here: the loop
    closure reads the host copies of the logs it requested, and its
    verification reads back by design)."""
    images, poses_gt, intr = scene
    cfg = multilap_config(loop)
    slam = DPVO(cfg, net, HT, WD, seed=0, device=DEV, sync_mode=sync_mode,
                vlad=vlad)
    lc = slam.loop_closure
    candidates = []
    if lc is not None:
        detect = lc.retrieval.detect_loop

        def counted(**kw):
            out = detect(**kw)
            if out is not None:
                candidates.append(out)
            return out
        lc.retrieval.detect_loop = counted
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    t_start = time.perf_counter()
    n_steady0 = t_first = None
    for t, img in enumerate(images):
        if slam.is_initialized and n_steady0 is None:
            n_steady0 = t
        slam(t, img, intr)
        if n_steady0 == t:
            torch.cuda.synchronize()
            t_first = time.perf_counter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    drained = slam._events_consumed
    logged = int(slam.state.log_idx)
    poses, tstamps = slam.terminate()
    launches = dict(_native.LAUNCHES)
    if n_steady0 is None:
        fail(f"{name}: DPVO never initialized")
    n_timed = MULTILAP_FRAMES - n_steady0 - 1
    ate, n_aligned, floor = synth_ate.ate_against(poses, tstamps, poses_gt)
    kept = {int(t) for t in slam.tstamps[:slam.n_host]}
    dropped = set(slam.delta)
    rec = dict(
        config="configs/default.yaml", loop_enabled=loop,
        sync_mode=sync_mode, frames=MULTILAP_FRAMES, HxW=[HT, WD],
        lap_frames=MULTILAP_LAP, weights=WEIGHTS,
        keyframes=slam.n_host, steady_frames=MULTILAP_FRAMES - n_steady0,
        fps_steady=n_timed / (t_end - t_first), total_s=t_end - t_start,
        revisit_gap_lap=revisit_gap_lap(poses, tstamps, MULTILAP_LAP),
        ate_rmse=ate, ate_floor_identity=floor, n_aligned=n_aligned,
        poses_finite=bool(np.isfinite(poses).all()),
        frames_accounted_once=kept | dropped == set(range(MULTILAP_FRAMES))
        and not kept & dropped, launches=launches)
    if lc is not None:
        events = [list(e) for e in lc.events]
        rec.update(
            descriptors_logged=logged if not sync_mode else 0,
            descriptors_drained_during_run=drained,
            retrieval_candidates=[list(c) for c in candidates],
            closures={k: [e[1:] for e in events if e[0] == k]
                      for k in ("pre-rejected", "rejected", "consistent",
                                "applied")},
            closures_attempted=len(events), measured_sim3=lc.measured,
            lc_count=lc.lc_count,
            pgo_seconds=lc.pgo_seconds, lc_sync_s=slam.lc_sync_s)
    if not sync_mode:
        runner = slam.runner
        rec.update(
            replays_per_tier={graph_label(k): v
                              for k, v in runner.replays.items()},
            replay_ms_median_per_tier={
                graph_label(k): statistics.median(v)
                for k, v in runner.replay_times.items()},
            tiers=list(runner.tiers), graphs_captured=len(runner.graphs))
    emit(name, **rec)
    if not rec["poses_finite"] or poses.shape != (MULTILAP_FRAMES, 7):
        fail(f"{name}: trajectory not finite or of the wrong shape")
    if not rec["frames_accounted_once"]:
        fail(f"{name}: input frames not accounted for exactly once")
    if not sync_mode and sum(slam.runner.replays.values()) != \
            rec["steady_frames"]:
        fail(f"{name}: {sum(slam.runner.replays.values())} replays for "
             f"{rec['steady_frames']} steady frames")
    for k in ("corr_pyramid", "runsum"):
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was not launched")
    return slam, rec


def phase_loop_multilap(scene):
    """Item 12 on the card: default.yaml at 384x512 with the trained
    weights over two laps of one circuit, every frame kept; the loop
    closure off (replayed), on (replayed: the VLAD descriptors written
    inside the captured step, drained every LC_INTERVAL frames) and on in
    sync_mode. Gates: descriptors from the card's desc_log against the
    same frames' recomputed eagerly; frames accounted for once; finite
    trajectories; a candidate verified; every steady frame replayed with
    the loop closure on; run_pgo card = CPU; 8 replayed frames after a
    PGO write-back. Whether a closure is applied is printed, not gated."""
    images, poses_gt, intr = scene
    net = load_reference_checkpoint(WEIGHTS, device=DEV)
    t0 = time.perf_counter()
    step = MULTILAP_FRAMES / 24
    centers = fit_centers_from_images(
        net, [images[int(i * step)] for i in range(24)])
    vlad = VLADDescriptor(centers=centers)
    fit_s = time.perf_counter() - t0
    pgo_calls = []
    run_pgo = tlong.run_pgo

    def recorded(*a, **kw):
        pgo_calls.append(a)
        return run_pgo(*a, **kw)

    tlong.run_pgo = recorded
    try:
        off, rec_off = run_multilap("loop_multilap_off", scene, net, None,
                                    False, False)
        on, rec_on = run_multilap("loop_multilap_on", scene, net, vlad, True,
                                  False)
        on_sync, rec_sync = run_multilap("loop_multilap_on_sync", scene, net,
                                         vlad, True, True)
    finally:
        tlong.run_pgo = run_pgo
    total = dict.fromkeys(_native.LAUNCHES, 0)
    for rec in (rec_off, rec_on, rec_sync):
        for k, v in rec["launches"].items():
            total[k] += v

    # the descriptors the replayed run drained from desc_log against the
    # same frames' features recomputed eagerly (the warm-up frames'
    # descriptors come from the synchronous ingest)
    lc = on.loop_closure
    db = lc.retrieval.db
    cos = []
    fd = steps.feat_dtype(on.cfg)
    centers_dev = torch.as_tensor(centers, device=DEV)
    with torch.no_grad():
        for n in np.where(db.has)[0]:
            c = int(on.tstamps[n])
            if c < on._init_counter:
                continue
            fmap = vonet.encode_frame(
                net, torch.as_tensor(images[c], device=DEV), fd).fmap
            ref = vlad_extract(fmap.float(), centers_dev).cpu().numpy()
            d = db.descs[n]
            cos.append(float(np.dot(ref, d) / np.linalg.norm(ref) /
                             np.linalg.norm(d)))

    # run_pgo on the card and on the CPU: an applied closure's inputs, else
    # one revisit pair's ground-truth Sim3 on the replayed run's poses
    if pgo_calls:
        args, source = pgo_calls[-1], "an applied closure"
    else:
        n = on.n
        i, j = MULTILAP_LAP + MULTILAP_LAP // 2, MULTILAP_LAP // 2
        gt = torch.as_tensor(poses_gt)
        C = lie.se3_to_sim3(lie.se3_mul(gt[j], lie.se3_inv(gt[i])))
        args = (on.state.poses[:n].float().cpu().numpy(),
                C[None].numpy(), np.array([i]), np.array([j]))
        source = f"ground truth of the revisit pair ({i}, {j})"
    t0 = time.perf_counter()
    card = tpgo.run_pgo(*args, device=DEV)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = tpgo.run_pgo(*args, device="cpu")
    pgo_diff = float(np.abs(card - cpu).max())

    # a write-back into the replayed state, then more replayed frames
    graphs_before = set(on.runner.graphs)
    replays_before = sum(on.runner.replays.values())
    lc.apply_pgo_result(card)
    _native.reset_launch_counts()
    for t in range(MULTILAP_AFTER):
        on(MULTILAP_FRAMES + t, images[t], intr)
    after, _ = on.trajectory()
    for k, v in _native.LAUNCHES.items():
        total[k] += v
    replays_after = sum(on.runner.replays.values()) - replays_before
    recaptured = set(on.runner.graphs) != graphs_before
    emit("loop_multilap", frames=MULTILAP_FRAMES, laps=2,
         fit_centres_s=fit_s,
         descriptor_cosine_min=min(cos, default=None),
         descriptors_checked=len(cos), tol_cosine=TOL_DESC_COS,
         revisit_gap_off=rec_off["revisit_gap_lap"],
         revisit_gap_on=rec_on["revisit_gap_lap"],
         revisit_gap_on_sync=rec_sync["revisit_gap_lap"],
         ate_off=rec_off["ate_rmse"], ate_on=rec_on["ate_rmse"],
         ate_on_sync=rec_sync["ate_rmse"],
         ate_floor_identity=rec_off["ate_floor_identity"],
         fps_steady_off=rec_off["fps_steady"],
         fps_steady_on=rec_on["fps_steady"],
         fps_steady_on_sync=rec_sync["fps_steady"],
         closures_applied=rec_on["lc_count"],
         closures_applied_sync=rec_sync["lc_count"],
         pgo_inputs=source, pgo_poses=int(len(args[0])),
         pgo_card_s=card_s, pgo_card_vs_cpu_max_abs=pgo_diff,
         tol_pgo=TOL_PGO_CARD_CPU, frames_after_write_back=MULTILAP_AFTER,
         replays_after_write_back=replays_after,
         graphs_recaptured=recaptured,
         poses_finite_after_write_back=bool(np.isfinite(after).all()))
    if not cos or min(cos) <= TOL_DESC_COS:
        fail(f"loop_multilap: drained descriptors against recomputed ones: "
             f"cosine {min(cos, default=None)} over {len(cos)} frames")
    if not rec_on["closures_attempted"] and not rec_sync["closures_attempted"]:
        fail("loop_multilap: no candidate reached geometric verification")
    if not pgo_diff <= TOL_PGO_CARD_CPU:
        fail(f"loop_multilap: run_pgo on the card and the CPU differ by "
             f"{pgo_diff}")
    if replays_after != MULTILAP_AFTER or not np.isfinite(after).all():
        fail(f"loop_multilap: {replays_after} replays after the write-back, "
             f"finite poses: {bool(np.isfinite(after).all())}")
    return total


# ---------------------------------------------------------------------------
# the NeRF back half and the whole chain (video -> SLAM -> COLMAP -> NeRF)

NERF_SOURCE = "wild_video_3d_reconstruction_torch/nerf/ngp.py"
NERF_FRAMES = 16                 # synth_scene's default, at 384x512
NERF_STEPS = 2000                # train's default
NERF_PROFILE_AT, NERF_PROFILE_STEPS = 1000, 10
RECON_FRAMES = 40
RECON_NERF_STEPS = 400
# recon_e2e at 384x512: the NeRF trained on the SLAM poses of the run
# (ATE about 0.35 against a 1.44 floor) holds its held-out PSNR within
# 0.1 dB of the random field's in both packages (JAX plain 21.562 ->
# 21.697), so that reading is printed, not gated; the gate is the same
# NeRF stage on the ground-truth poses through the same export and
# prepare, whose PSNR must rise by RECON_GT_GAIN dB (read +3.7 refined,
# +1.7 plain), and, for the refined run, the eval-pose-aligned PSNR above
# the random field's.
RECON_GT_GAIN = 1.0
NERF_VIEWS = 8                   # nerf_render's interpolated path
# nerf_card_vs_cpu: 3 steps of each trainer at 48x64 (synth_scene, 6
# frames), batch 1024, the same draws on both devices. Each step's loss
# within TOL_NERF_LOSS_REL of the CPU's, every gradient of the first step
# within TOL_NERF_GRAD_REL of its norm. Adam's eps of 1e-15 sets every
# touched table entry's step to about lr whatever its gradient's size, so
# an entry whose gradient is rounding noise (or that a sample on a cell
# face touches on one device and not the other) ends up to 2 lr a step
# apart: the held-out view rendered after 3 steps agrees within
# TOL_NERF_VIEW, not at rounding.
TOL_NERF_LOSS_REL = 1e-4
TOL_NERF_GRAD_REL = 1e-4
TOL_NERF_VIEW = 5e-2


def _nerf_draws(gen, steps, batch, n_rays, *widths):
    """Per step a ray index [batch] and uniforms [batch, w] per width,
    from a CPU generator (the same numbers for both devices)."""
    return [(torch.randint(0, n_rays, (batch,), generator=gen),
             *[torch.rand((batch, w), generator=gen) for w in widths])
            for _ in range(steps)]


def _rel_errors(card, cpu):
    """Per tensor: max |card - cpu| / ||cpu||."""
    return {k: float((card[k].cpu() - v).abs().max()
                     / max(float(v.norm()), 1e-30)) for k, v in cpu.items()}


def _first_step_grads(field, scene, draws, device, refine):
    """The first step's gradients of every field tensor: the plain
    trainer's loss over its rays, or the refined trainer's renderer
    (coarse + fine, zero appearance) over the same rays."""
    images, c2ws, intrs, conv = scene
    rays, _, _, near, far = tnt.build_rays(images, c2ws, intrs, conv)
    _, train_ids = tnt._holdout(len(images), 8)
    rays = torch.from_numpy(rays[train_ids].reshape(-1, 9))
    f = copy.deepcopy(field).to(device)
    if refine:
        idx, u_c, u_f = draws[0]
    else:
        idx, jitter = draws[0]
    b = rays[idx].to(device)
    if refine:
        rgb, _, _ = tngp.render_rays_hier(
            f, b[:, :3], b[:, 3:6], n_coarse=32, n_fine=32, near=near,
            far=far, app=torch.zeros(len(b), f.app_dim, device=device),
            u_coarse=u_c, u_fine=u_f)
    else:
        rgb, _, _ = tngp.render_rays(f, b[:, :3], b[:, 3:6], n_samples=64,
                                     near=near, far=far, jitter=jitter)
    torch.mean((rgb - b[:, 6:9]) ** 2).backward()
    return {k: p.grad.detach().clone() for k, p in f.named_parameters()}


def _nerf_run(trainer, scene, field, draws, device, **kw):
    """A 3-step run: (per-step losses, report, trained module)."""
    losses = []
    out, rep = trainer(*scene, steps=3, batch=1024, eval_every=3,
                       log=lambda *a: None, device=device,
                       field=copy.deepcopy(field), draws=draws,
                       step_hook=lambda s, loss: losses.append(float(loss)),
                       **kw)
    return losses, rep, out


def phase_nerf_card_vs_cpu():
    """3 steps of `train` and of `train_refine` (with the eval-pose
    alignment, 4 steps) on the card and on the CPU from one field, with
    the same draws; the first step's gradients apart; the table's
    gradient twice on the card (R21: atomic order)."""
    scene = tnt.synth_scene(frames=6, ht=48, wd=64)
    images, _, _, _ = scene
    n, h, w = images.shape[:3]
    gen = torch.Generator().manual_seed(0)
    rec = {}
    for name, refine in (("train", False), ("train_refine", True)):
        field = tngp.NGPField(app_dim=8 if refine else 0,
                              generator=torch.Generator().manual_seed(0))
        n_train = n - 1              # holdout 8: the last view held out
        if refine:
            draws = _nerf_draws(gen, 3, 1024, n_train * h * w, 32, 32)
            align = _nerf_draws(gen, 4, 1024, h * w, 32, 32)
            trainer = functools.partial(tnt.train_refine, eval_align=True,
                                        align_steps=4, align_draws=align)
        else:
            draws = _nerf_draws(gen, 3, 1024, n_train * h * w, 64)
            trainer = tnt.train
        g_cpu = _first_step_grads(field, scene, draws, "cpu", refine)
        g_card = _first_step_grads(field, scene, draws, DEV, refine)
        g_again = _first_step_grads(field, scene, draws, DEV, refine)
        rel = _rel_errors(g_card, g_cpu)
        l_cpu, r_cpu, m_cpu = _nerf_run(trainer, scene, field, draws, "cpu")
        l_card, r_card, m_card = _nerf_run(trainer, scene, field, draws, DEV)
        fc, fg = (m_cpu.field, m_card.field) if refine else (m_cpu, m_card)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
        view = {}
        for tag, f in (("cpu", fc), ("card", fg)):
            tr = (lambda c, s: lambda o, d: (tngp.to_unit(o, c, s), d))(
                r_cpu["center"], r_cpu["scale"])
            view[tag] = tngp.render_image(
                f, scene[1][5], scene[2][5], (h, w),
                n_samples=32 if refine else 64,
                near=r_cpu["near"], far=r_cpu["far"], convention=scene[3],
                scene_transform=tr, hier=refine, n_fine=32,
                app=np.zeros(8, np.float32) if refine else None)[0]
        view_err = float(np.abs(view["card"] - view["cpu"]).max())
        table_err = (fg.table.detach().cpu() - fc.table.detach()).abs()
        rec[name] = dict(
            loss_cpu=l_cpu, loss_card=l_card, loss_max_rel_err=loss_rel,
            grad_rel_err_max=max(rel.values()),
            grad_rel_err_median=statistics.median(rel.values()),
            grad_rel_err_table=rel["table"],
            table_grad_card_repeat_bitwise=bool(torch.equal(
                g_card["table"], g_again["table"])),
            table_grad_card_repeat_max_abs=float(
                (g_card["table"] - g_again["table"]).abs().max()),
            view_max_abs_err=view_err,
            table_share_over_1e_2_lr_apart=float(
                (table_err > 1e-4).float().mean()),
            psnr_cpu=r_cpu["psnr"], psnr_card=r_card["psnr"],
            psnr_aligned_cpu=r_cpu.get("psnr_aligned"),
            psnr_aligned_card=r_card.get("psnr_aligned"))
        ok = (loss_rel <= TOL_NERF_LOSS_REL
              and max(rel.values()) <= TOL_NERF_GRAD_REL
              and view_err <= TOL_NERF_VIEW
              and all(np.isfinite(l_card)))
        if not ok:
            emit("nerf_card_vs_cpu", **rec)
            fail(f"nerf_card_vs_cpu: {name}: loss rel {loss_rel} (tol "
                 f"{TOL_NERF_LOSS_REL}), gradient rel {max(rel.values())} "
                 f"(tol {TOL_NERF_GRAD_REL}), view {view_err} (tol "
                 f"{TOL_NERF_VIEW})")
    emit("nerf_card_vs_cpu", HxW=[h, w], frames=n, steps=3, batch=1024,
         tol_loss_rel=TOL_NERF_LOSS_REL, tol_grad_rel=TOL_NERF_GRAD_REL,
         tol_view=TOL_NERF_VIEW, **rec)


def _device_events(prof):
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), sum(e.device_time for e in evs) / 1e3


def hash_encode_ms(levels=8, table_size=2 ** 14, n=4096 * 64):
    """The hash encoding's forward plus backward at the training shape
    (n points, the table and its gradient), CUDA events."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    field = tngp.NGPField(levels, table_size).to(DEV)
    x = torch.rand((n, 3), generator=gen, device=DEV)
    g = torch.randn((n, levels * 2), generator=gen, device=DEV)

    def fwd_bwd():
        field.table.grad = None
        tngp.hash_encode(x, field.table, field.level_res).backward(g)

    fwd = time_ms(lambda: tngp.hash_encode(x, field.table, field.level_res))
    return time_ms(fwd_bwd), fwd


def phase_nerf_native(scene):
    """`train` at its own defaults (batch 4096, 64 samples, 8 levels,
    table 2^14, max_res 256, hidden 64, lr 1e-2, holdout 8) on
    synth_scene(frames=16) at 384x512 (fx = fy = 320: the field of view of
    its 48x64 default) for NERF_STEPS steps; ms a step,
    device kernels and device ms a step (profiled over
    NERF_PROFILE_STEPS steps), peak memory above what was allocated
    before, the hash encoding's share."""
    losses, marks = [], {}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    stop = NERF_PROFILE_AT + NERF_PROFILE_STEPS

    def mark(s):
        torch.cuda.synchronize()
        marks[s] = time.perf_counter()

    def hook(s, loss):
        losses.append(loss)
        if s in (1, NERF_PROFILE_AT, stop, NERF_STEPS):
            mark(s)
        if s == NERF_PROFILE_AT:
            prof.start()
        elif s == stop:
            prof.stop()

    def log(msg):
        if msg.startswith("init"):
            mark(0)

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, rep = tnt.train(*scene, steps=NERF_STEPS, eval_every=NERF_STEPS,
                       log=log, device=DEV, step_hook=hook)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    losses = torch.stack(losses).cpu().numpy()
    kernels, device_ms = _device_events(prof)
    steps_timed = (NERF_PROFILE_AT - 1) + (NERF_STEPS - stop)
    ms_step = ((marks[NERF_PROFILE_AT] - marks[1])
               + (marks[NERF_STEPS] - marks[stop])) / steps_timed * 1e3
    hash_ms, hash_fwd_ms = hash_encode_ms()
    finite = bool(np.isfinite(losses).all())
    gain = rep["psnr"] - rep["psnr_init"]
    emit("nerf_native", frames=NERF_FRAMES, HxW=[HT, WD], steps=NERF_STEPS,
         batch=4096, samples=64, levels=8, table=2 ** 14, max_res=256,
         psnr_init=rep["psnr_init"], psnr=rep["psnr"], psnr_gain=gain,
         loss_first=float(losses[0]), loss_last=float(losses[-1]),
         all_losses_finite=finite,
         ms_first_step=(marks[1] - marks[0]) * 1e3, ms_per_step=ms_step,
         kernels_per_step=kernels / NERF_PROFILE_STEPS,
         device_ms_per_step=device_ms / NERF_PROFILE_STEPS,
         peak_allocated_gb=peak / 1e9,
         allocated_before_gb=before / 1e9, wall_s=wall,
         hash_encode_fwd_bwd_ms=hash_ms, hash_encode_fwd_ms=hash_fwd_ms,
         hash_encode_share=hash_ms / ms_step, source=NERF_SOURCE)
    if not (finite and gain > 3.0 and rep["psnr"] > 14.0):
        fail(f"nerf_native: PSNR {rep['psnr_init']} -> {rep['psnr']} "
             f"(needs +3 dB and > 14), losses finite {finite}")


def phase_png_roundtrip(frame):
    """A rendered 384x512 frame (BGR) and a mask through write_png /
    read_png, bitwise; and each file read by read_png and by this
    machine's cv2.imread, with either flag (colour as gray, gray as
    colour), bitwise: the decoder's claim to read what cv2 reads."""
    cv2 = tstream.require_cv2("chip_smoke.py:phase_png_roundtrip")
    mask = ((frame[..., 1] > 127) * 255).astype(np.uint8)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, img, flags in (("frame", frame, tpng.IMREAD_COLOR),
                                 ("mask", mask, tpng.IMREAD_GRAYSCALE)):
            path = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            tpng.write_png(path, img)
            t1 = time.perf_counter()
            back = tpng.read_png(path, flags)
            t2 = time.perf_counter()
            out[name] = dict(bitwise_equal=bool(np.array_equal(back, img)),
                             bytes=os.path.getsize(path),
                             write_ms=(t1 - t0) * 1e3,
                             read_ms=(t2 - t1) * 1e3)
            for flag, key in ((tpng.IMREAD_COLOR, "color"),
                              (tpng.IMREAD_GRAYSCALE, "gray")):
                out[name][f"equal_to_cv2_imread_{key}"] = bool(
                    np.array_equal(tpng.read_png(path, flag),
                                   cv2.imread(path, flag)))
    emit("png_roundtrip", HxW=list(frame.shape[:2]),
         cv2_version=cv2.__version__, **out)
    if not all(ok for v in out.values() for k, ok in v.items()
               if k == "bitwise_equal" or k.startswith("equal_to")):
        fail("png_roundtrip: read_png differs from what write_png wrote "
             f"or from cv2.imread: {out}")


def phase_recon_e2e(scene, refine):
    """eval/recon_e2e.run at 384x512 over a pre-rendered walk: the PNG
    directory through the demo on the card, COLMAP, prepare, NeRF; cv2
    blocked (an import of it raises) for the whole run. Then the control
    (`recon_e2e.gt_pose_nerf`): the same NeRF stage on the ground-truth
    poses."""
    workdir = tempfile.mkdtemp(prefix="recon_e2e_")
    _native.reset_launch_counts()
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        rep, field, meta = trecon.run(
            params=WEIGHTS, frames=RECON_FRAMES, ht=HT, wd=WD, seed=0,
            nerf_steps=RECON_NERF_STEPS, workdir=workdir, path="walk",
            refine=refine, device=DEV, fx=320.0, fy=320.0, scene=scene,
            return_field=True)
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    launches = dict(_native.LAUNCHES)
    data = tnt.load_transforms(os.path.join(workdir, "output", "nerf"))
    read_back = len(data[0]) == RECON_FRAMES
    t0 = time.perf_counter()
    rep_gt = trecon.gt_pose_nerf(scene, workdir, refine, RECON_NERF_STEPS,
                                 DEV)
    control = {"psnr_init": rep_gt["psnr_init"], "psnr": rep_gt["psnr"],
               "seconds": time.perf_counter() - t0}
    name = "recon_e2e" if refine else "recon_e2e_plain"
    emit(name, HxW=[HT, WD], cv2_blocked=True,
         cv2_installed=importlib.util.find_spec("cv2") is not None,
         transforms_read_back=read_back, launches=launches,
         gt_pose_control=control,
         **{k: v for k, v in rep.items() if k != "workdir"})
    psnrs = [rep["psnr_init"], rep["psnr"], rep["psnr_aligned"] or 0.0]
    ok = (read_back and np.isfinite(rep["ate_rmse"])
          and rep["ate_rmse"] < rep["ate_floor_identity"]
          and bool(np.isfinite(psnrs).all())
          and control["psnr"] > control["psnr_init"] + RECON_GT_GAIN
          and (not refine or rep["psnr_aligned"] > rep["psnr_init"])
          and launches["corr_pyramid"] and launches["runsum"])
    if not ok:
        fail(f"{name}: transforms read back {read_back}, ATE "
             f"{rep['ate_rmse']} (floor {rep['ate_floor_identity']}), PSNR "
             f"{rep['psnr_init']} -> {rep['psnr']} (aligned "
             f"{rep['psnr_aligned']}), ground-truth poses "
             f"{control['psnr_init']} -> {control['psnr']} (needs +"
             f"{RECON_GT_GAIN}), launches {launches}")
    return launches, field, meta, data, workdir


def phase_nerf_render(params, meta, data, workdir):
    """The refine=True field: save_field -> load_field renders a view
    bitwise equal; render_path over NERF_VIEWS interpolated views to PNG
    (read back); export_pointcloud to a PLY (read back)."""
    images, c2ws, intrs, _ = data
    hw = images.shape[1:3]
    ckpt = os.path.join(workdir, "field")
    trender.save_field(params, meta, ckpt, RECON_NERF_STEPS)
    loaded, meta2 = trender.load_field(ckpt, device=DEV)
    a = trender._render(params.field, meta, c2ws[0], intrs[0], hw, 4096,
                        None)[0]
    b = trender._render(loaded, meta2, c2ws[0], intrs[0], hw, 4096, None)[0]
    same = bool(np.array_equal(a, b)) and meta2 == meta
    path = trender.interpolate_path(c2ws[::5], NERF_VIEWS)
    out_dir = os.path.join(workdir, "renders")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = trender.render_path(loaded, meta, path, intrs[0], hw,
                                 out_dir=out_dir, log=lambda *a: None)
    ms_view = (time.perf_counter() - t0) / NERF_VIEWS * 1e3
    pngs_equal = all(np.array_equal(
        tpng.read_png(os.path.join(out_dir, f"{i:05d}.png"))[..., ::-1],
        frames[i]) for i in range(NERF_VIEWS))
    ply = os.path.join(workdir, "cloud.ply")
    t0 = time.perf_counter()
    n_pts = trender.export_pointcloud(loaded, meta, c2ws[::8], intrs[::8],
                                      hw, ply)
    cloud_s = time.perf_counter() - t0
    pts = export.load_ply(ply)
    cloud_ok = pts.shape == (n_pts, 3) and bool(np.isfinite(pts).all())
    emit("nerf_render", reload_render_bitwise_equal=same, views=NERF_VIEWS,
         HxW=list(hw), ms_per_view=ms_view, pngs_read_back_equal=pngs_equal,
         points=n_pts, pointcloud_views=len(c2ws[::8]), pointcloud_s=cloud_s,
         ply_read_back=cloud_ok)
    if not (same and pngs_equal and cloud_ok and n_pts > 0):
        fail(f"nerf_render: reload equal {same}, PNGs {pngs_equal}, "
             f"PLY {cloud_ok} ({n_pts} points)")


# ---------------------------------------------------------------------------
# the evaluation drivers (eval/harness.py, droid_harness.run_tum,
# synth_suite, calib_sensitivity, loop_recall, matcher_recall) and the cv2
# inputs of the demo
# ---------------------------------------------------------------------------

TUM_HT, TUM_WD, TUM_FRAMES = 480, 640, 48      # TUM fr1's own frame size
EUROC_HT, EUROC_WD, EUROC_FRAMES = 480, 752, 24
DROID_TUM_FRAMES = 16
SUITE_FRAMES, SUITE_TRIALS = 60, 3             # synth_suite's protocol
SWEEP_FRAMES, SWEEP_TRIALS = 60, 2             # calib_sensitivity's
ORACLE_TRIALS = 2
TOL_ORACLE_CARD_CPU = 1e-3
# synth_suite and the calibration sweep, card against CPU: short runs
# (the CPU parity tests' 12 frames, fp32) fed the same patch draws, made
# with numpy; every frame's pose (the largest difference of a component
# of the [T, 7] trajectories) and each run's ATE. Over 60 frames the
# protocol's ATE is chaotic in rounding (PERF.md section 2) and only the
# floor holds it; over 12 the tiny VO's card and CPU poses read 2.3e-5
# apart (slam_tiny_vs_cpu)
SHORT_FRAMES = 12
TOL_SHORT_POSE = 1e-3
TOL_SHORT_ATE = 1e-3
MATCHER_SEEDS = 4
TOL_MATCHER_COUNTS = 0.02                      # card against CPU, relative
TOL_LOOP_HITS = 1                              # card against CPU
# the chip runs' motion-probe convention (ROADMAP R7): the probe runs and
# is printed, its threshold 0, since the trained weights' probe reads
# 0.5-0.7 px whatever the motion and the shipped 2.0 parks every frame
PROBE_OFF = "MOTION_PROBE_THRESH: 0.0\n"


def _probe_config(path, workdir):
    """The config file at path with the chip runs' probe threshold."""
    out = os.path.join(workdir, os.path.basename(path))
    with open(path) as f, open(out, "w") as g:
        g.write(f.read().rstrip("\n") + "\n" + PROBE_OFF)
    return out


def _c2w(poses_w2c):
    return lie.se3_inv(torch.as_tensor(poses_w2c, dtype=torch.float64)) \
        .numpy()


def _floor(gt_c2w, t):
    ident = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (len(t), 1))
    return tmetrics.ate_rmse(ident, t, gt_c2w, t)[0]


def write_tum_scene(root, scene):
    """TUM layout: rgb/<t>.png (BGR) and groundtruth.txt (c2w)."""
    images, poses, intr = scene
    d = os.path.join(root, "rgbd_dataset_freiburg1_synth")
    os.makedirs(os.path.join(d, "rgb"))
    t = 100.0 + np.arange(len(images), dtype=np.float64)
    for k in range(len(images)):
        tpng.write_png(os.path.join(d, "rgb", f"{t[k]:.6f}.png"),
                       np.ascontiguousarray(images[k][..., ::-1]))
    gt = _c2w(poses)
    np.savetxt(os.path.join(d, "groundtruth.txt"),
               np.concatenate([t[:, None], gt], axis=1),
               header="t x y z qx qy qz qw")
    return d, gt, t


def write_euroc_scene(root, scene):
    """EuRoC layout: mav0/cam0/data/<t_ns>.png (8-bit gray) and the state
    CSV (t ns, p xyz, q wxyz)."""
    images, poses, intr = scene
    d = os.path.join(root, "MH_99_synth")
    data = os.path.join(d, "mav0", "cam0", "data")
    gt_dir = os.path.join(d, "mav0", "state_groundtruth_estimate0")
    os.makedirs(data)
    os.makedirs(gt_dir)
    t_ns = (100.0 + np.arange(len(images), dtype=np.float64)) * 1e9
    for k in range(len(images)):
        bgr = torch.from_numpy(np.ascontiguousarray(images[k][..., ::-1]))
        tpng.write_png(os.path.join(data, f"{int(t_ns[k])}.png"),
                       tfb.bgr_to_gray(bgr).numpy())
    gt = _c2w(poses)
    rows = np.concatenate([t_ns[:, None], gt[:, :3], gt[:, [6, 3, 4, 5]]],
                          axis=1)
    np.savetxt(os.path.join(gt_dir, "data.csv"), rows, delimiter=",",
               header="t,px,py,pz,qw,qx,qy,qz")
    return d, gt, t_ns / 1e9


class _Timed:
    """Wraps a module function: its calls' seconds and results."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0, out, a, kw))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _harness(dataset, scene, config, frames, table, writer):
    """harness.evaluate on a rendered scene written in the dataset's
    layout, the calibration table patched to the renderer's camera with
    zero distortion (as the JAX package's harness test does); returns
    (record, scene dir, launches)."""
    workdir = tempfile.mkdtemp(prefix=f"harness_{dataset}_")
    d, gt, t = writer(workdir, scene)
    intr = np.asarray(scene[2], np.float64)
    real = getattr(tharness, table)
    setattr(tharness, table,
            np.concatenate([intr, np.zeros(len(real) - 4)]))
    logged = []
    _native.reset_launch_counts()
    try:
        with _Timed(tharness, "run_scene") as timed:
            res = tharness.evaluate(
                dataset, workdir, WEIGHTS, _probe_config(config, workdir),
                trials=1, stride=1, scenes=[os.path.basename(d)],
                device=DEV, log=lambda *a: logged.append(" ".join(
                    str(x) for x in a)))
    finally:
        setattr(tharness, table, real)
    launches = dict(_native.LAUNCHES)
    seconds = timed.calls[0][0]
    ate = res[os.path.basename(d)]
    floor = _floor(gt, t)
    rec = dict(HxW=list(scene[0].shape[1:3]), frames=frames,
               config=config, probe_thresh=0.0, weights=WEIGHTS,
               ate_rmse=ate, ate_floor_identity=floor,
               run_scene_s=seconds, fps=frames / seconds,
               launches={k: v for k, v in launches.items() if v},
               log=logged[:3])
    ok = (np.isfinite(ate) and ate < floor and launches["corr_pyramid"]
          and launches["runsum"])
    return rec, ok, d, workdir, launches


def phase_harness_tum(scene):
    """This slice's full-width path: harness.evaluate("tum") at 480x640
    with configs/tum.yaml (384 patches) and the trained weights; then the
    same directory streamed unpatched with the real TUM fr1 calibration
    (undistortion must remap the content)."""
    rec, ok, d, workdir, launches = _harness(
        "tum", scene, "configs/tum.yaml", TUM_FRAMES, "TUM_FR1_CALIB",
        write_tum_scene)
    frames = list(tharness.tum_stream(d, stride=1))
    raw = tpng.read_png(os.path.join(d, "rgb", sorted(os.listdir(
        os.path.join(d, "rgb")))[0]))
    changed = float(np.abs(frames[0][1].astype(int) - raw.astype(int))
                    .mean())
    rec["real_calib_stream"] = dict(frames=len(frames),
                                    HxW=list(frames[0][1].shape[:2]),
                                    mean_abs_change=changed)
    emit("harness_tum", **rec)
    if not ok or not changed > 1.0 or len(frames) != TUM_FRAMES:
        fail(f"harness_tum: {rec}")
    return launches, d, workdir


def phase_harness_euroc(scene):
    """harness.evaluate("euroc") on 8-bit gray PNGs at 480x752 with
    configs/fast.yaml."""
    rec, ok, d, workdir, launches = _harness(
        "euroc", scene, "configs/fast.yaml", EUROC_FRAMES, "EUROC_CALIB",
        write_euroc_scene)
    emit("harness_euroc", **rec)
    shutil.rmtree(workdir, ignore_errors=True)
    if not ok:
        fail(f"harness_euroc: {rec}")
    return launches


def phase_droid_tum(d, intr):
    """droid_harness.run_tum on the TUM directory (frames=16 kept), the
    trained weights' "corr" flow, on the card."""
    root, name = os.path.split(d)
    real = tharness.TUM_FR1_CALIB
    tharness.TUM_FR1_CALIB = np.concatenate([intr, np.zeros(5)])
    streamed = [0]
    stream_fn = tharness.tum_stream

    def counted(*a, **kw):
        for item in stream_fn(*a, **kw):
            streamed[0] += 1
            yield item
    tharness.tum_stream = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tdroid.run_tum(root, scenes=[name], stride=1,
                             frames=DROID_TUM_FRAMES, network=WEIGHTS,
                             device=DEV, log=lambda *a: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        tharness.TUM_FR1_CALIB = real
        tharness.tum_stream = stream_fn
    ate = res[name]
    emit("droid_tum", HxW=[TUM_HT, TUM_WD], frames_kept=DROID_TUM_FRAMES,
         frames_streamed=streamed[0], seconds=seconds,
         ms_per_frame=seconds / streamed[0] * 1e3, ate_rmse=ate,
         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not np.isfinite(ate):
        fail(f"droid_tum: ATE {ate}")


def _numpy_draws(frames, M, h, w):
    """draws(slam_seed) for `synth_suite.run_suite` and
    `calib_sensitivity.run_sweep`: per frame, M patch centres on the 1/4
    map (h x w) and their inverse depths, from numpy, the same on every
    device (the DPVO's own draws come from a torch generator on its
    device)."""
    def draws(seed):
        rng = np.random.default_rng(seed)
        return [dict(cand=np.stack([rng.integers(1, w - 1, M),
                                    rng.integers(1, h - 1, M)], -1)
                     .astype(np.float32),
                     inv_depths=rng.random(M, dtype=np.float32))
                for _ in range(frames)]
    return draws


def _short_card_vs_cpu(name, driver):
    """driver(device, draws) on SHORT_FRAMES frames, on the card and on the
    CPU with the same numpy draws and fp32 features: every
    `synth_ate.run` it makes, card against CPU, pose by pose and ATE by
    ATE. Fails unless all lie within TOL_SHORT_POSE and TOL_SHORT_ATE."""
    draws = _numpy_draws(SHORT_FRAMES, 16, 12, 16)   # synth_ate's 48x64, M
    runs, seconds = {}, {}
    for dev in (DEV, "cpu"):
        before = sum(_native.LAUNCHES.values())
        with _Timed(synth_ate, "run") as timed:
            driver(dev, draws)
        runs[dev] = [c[1] for c in timed.calls]
        seconds[str(dev)] = sum(c[0] for c in timed.calls)
    cpu_launches = sum(_native.LAUNCHES.values()) - before
    pose = max(float(np.abs(a["poses"] - b["poses"]).max())
               for a, b in zip(runs[DEV], runs["cpu"]))
    ate = max(abs(a["ate_rmse"] - b["ate_rmse"])
              for a, b in zip(runs[DEV], runs["cpu"]))
    rec = dict(frames=SHORT_FRAMES, runs=len(runs[DEV]),
               ate_card=[r["ate_rmse"] for r in runs[DEV]],
               ate_cpu=[r["ate_rmse"] for r in runs["cpu"]],
               max_abs_pose_diff=pose, tol_pose=TOL_SHORT_POSE,
               max_abs_ate_diff=ate, tol_ate=TOL_SHORT_ATE,
               seconds=seconds, cpu_launches=cpu_launches)
    if len(runs[DEV]) != len(runs["cpu"]) or not runs[DEV] or \
            not pose <= TOL_SHORT_POSE or not ate <= TOL_SHORT_ATE or \
            cpu_launches:
        fail(f"{name}: short runs, card against CPU: {rec}")
    return rec


def phase_synth_suite(net):
    """synth_suite's full protocol on the card: 6 scenes, 3 trials, 60
    frames at 48x64, the random (seed 0) and the trained weights."""
    _native.reset_launch_counts()
    with _Timed(synth_ate, "run") as runs:
        t0 = time.perf_counter()
        out = tss.run_suite({"random": None, "trained": net},
                            frames=SUITE_FRAMES, trials=SUITE_TRIALS,
                            device=DEV, log=lambda *a: None)
        seconds = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    check = _short_card_vs_cpu("synth_suite", lambda dev, draws: (
        tss.run_suite({"trained": WEIGHTS}, frames=SHORT_FRAMES, trials=1,
                      scenes=[tss.SCENES[4]], device=dev,
                      draws=draws, log=lambda *a: None,
                      cfg_overrides=dict(MIXED_PRECISION=False))))
    emit("synth_suite", frames=SUITE_FRAMES, trials=SUITE_TRIALS,
         scenes={s: {c: v["ate_median"] for c, v in row.items()}
                 for s, row in out["scenes"].items()},
         mean_random=out["mean_random"], mean_trained=out["mean_trained"],
         mean_floor=out["mean_floor"], seconds=seconds, runs=len(runs.calls),
         s_per_run=[round(c[0], 3) for c in runs.calls],
         short_card_vs_cpu=check,
         launches={k: v for k, v in launches.items() if v})
    if not out["mean_trained"] < out["mean_floor"] or \
            not launches["corr_pyramid"] or not launches["runsum"]:
        fail(f"synth_suite: trained mean {out['mean_trained']} against the "
             f"floor {out['mean_floor']}, launches {launches}")
    return launches


def phase_calib_sensitivity(net):
    """The oracle sweep at its defaults (5 levels, 2 trials, 96x128, 18
    frames) on the card, the oracle captured in the steady step's CUDA
    graphs (its device count of executions beside its Python calls), 0%
    and 5% also on the CPU; then the network sweep with the trained
    weights (2 scenes, 5 levels, 2 trials, 60 frames)."""
    _native.reset_launch_counts()
    table, calls, card0 = {}, [], {}
    t0 = time.perf_counter()
    for e in tcs.LEVELS:
        ates = []
        for s in range(ORACLE_TRIALS):
            rec = {}
            ates.append(tcs.run_oracle(e, seed=s, device=DEV, record=rec))
            calls.append(rec)
        table[f"{e:.2f}"] = float(np.median(ates))
        card0[f"{e:.2f}"] = ates[0]
    oracle_s = time.perf_counter() - t0
    # a capture records the oracle without running it and each replay runs
    # it, so its executions beyond its Python calls are replays (less
    # one per capture): more than 0 shows that the replays ran the oracle
    replays = sum(r["oracle_calls"] - r["oracle_traced"] for r in calls)
    cpu = {}
    for e in (0.0, 0.05):
        cpu[f"{e:.2f}"] = tcs.run_oracle(e, seed=0, device="cpu")
    with _Timed(synth_ate, "run") as runs:
        t0 = time.perf_counter()
        sweep = tcs.run_sweep(params=net, frames=SWEEP_FRAMES,
                              trials=SWEEP_TRIALS, device=DEV,
                              log=lambda *a: None)
        sweep_s = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    check = _short_card_vs_cpu("calib_sensitivity", lambda dev, draws: (
        tcs.run_sweep(params=WEIGHTS, frames=SHORT_FRAMES, trials=1,
                      levels=(0.05,), scenes=tcs.SCENES[:1],
                      device=dev, draws=draws, log=lambda *a: None,
                      cfg_overrides=dict(MIXED_PRECISION=False))))
    card0 = {k: card0[k] for k in cpu}
    oracle_diff = {k: abs(card0[k] - cpu[k]) for k in cpu}
    emit("calib_sensitivity", oracle=table, oracle_s=oracle_s,
         oracle_executions=sum(r["oracle_calls"] for r in calls),
         oracle_python_calls=sum(r["oracle_traced"] for r in calls),
         oracle_replays_at_least=replays, oracle_seed0_card=card0,
         oracle_seed0_cpu=cpu, oracle_card_cpu_diff=oracle_diff,
         sweep=sweep, sweep_s=sweep_s, weights=WEIGHTS,
         short_card_vs_cpu=check,
         launches={k: v for k, v in launches.items() if v})
    a0, a5 = table["0.00"], table["0.05"]
    if not (a0 < 5e-3 and a5 < 0.05 and a5 > a0 and replays > 0
            and max(oracle_diff.values()) <= TOL_ORACLE_CARD_CPU
            and all(np.isfinite(v) for row in sweep.values()
                    for v in row.values())):
        fail(f"calib_sensitivity: oracle {table} (0% < 5e-3, 5% < 0.05 "
             f"and above 0%), replayed executions {replays}, card - CPU "
             f"{oracle_diff}, sweep {sweep}")
    return launches


def phase_loop_recall():
    """loop_recall at its defaults (80 frames, 192x256, weights from seed
    0), random and fitted centres, on the card and on the CPU."""
    frames, gt = tlr.build_frames(80, 24, 192, 256)
    out = {}
    for fit in (False, True):
        for dev in (DEV, "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = tlr.run(frames, gt, fit=fit, device=dev)
            r["seconds"] = time.perf_counter() - t0
            out[("fit" if fit else "random") + ("_card" if dev is DEV
                                                else "_cpu")] = r
    emit("loop_recall", frames=80, HxW=[192, 256], **out)
    for c in ("random", "fit"):
        card, cpu = out[c + "_card"], out[c + "_cpu"]
        if abs(card["hits"] - cpu["hits"]) > TOL_LOOP_HITS or \
                card["queries"] != cpu["queries"]:
            fail(f"loop_recall ({c} centres): card {card}, CPU {cpu}")


def phase_matcher_recall(net):
    """matcher_recall's sweep with the trained weights (4 seeds, deltas 1,
    3, 6, 10, clean and hardened) on the card and on the CPU, and the
    JAX package's pinned pair (seed 1001, delta 6, hardened)."""
    clips = {(s, h): tmr.render_pair_clip(s, h)
             for s in range(MATCHER_SEEDS) for h in (False, True)}
    cpu_net = load_reference_checkpoint(WEIGHTS).eval()
    out = {}
    for name, n in (("card", net), ("cpu", cpu_net)):
        t0 = time.perf_counter()
        out[name] = tmr.run_sweep(n, seeds=MATCHER_SEEDS, clips=clips,
                                  log=lambda *a: None)
        out[name + "_s"] = time.perf_counter() - t0
    worst = 0.0
    for key, row in out["card"].items():
        for k in ("accepted", "matchable", "correct", "geo_correct"):
            ref = out["cpu"][key][k]
            worst = max(worst, abs(row[k] - ref) / max(ref, 1))
    pinned = tmr.run_pair(*tmr.render_pair_clip(1001, True, deltas=(6,)),
                          0, 6, net)
    emit("matcher_recall", weights=WEIGHTS, seeds=MATCHER_SEEDS,
         card=out["card"], cpu_counts_rel_diff_max=worst,
         card_s=out["card_s"], cpu_s=out["cpu_s"], pinned_pair=pinned)
    if worst > TOL_MATCHER_COUNTS or not (pinned["recall"] > 0.85 and
                                          pinned["precision"] > 0.6):
        fail(f"matcher_recall: card against CPU counts {worst} (tolerance "
             f"{TOL_MATCHER_COUNTS}), pinned pair {pinned}")


def phase_demo_cv2_inputs():
    """The cv2 report (scripts/torch_cv2_report.py --demo): OpenCV's
    version and video backend, a JPEG-95 round trip, an undistortion with
    the TUM fr1 calibration, an .mp4 written and read back; the demo on a
    directory of JPEG frames (with distortion terms in its calibration)
    and on the .mp4, on the card. In this process: a second interpreter
    would spend its start, torch's import and the kernels' load again."""
    spec = importlib.util.spec_from_file_location(
        "torch_cv2_report", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "torch_cv2_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    with contextlib.redirect_stdout(io.StringIO()):
        rep = report.main(["--demo", "--device", "cuda"])
    emit("demo_cv2_inputs", **rep)
    ok = rep["jpeg95"]["encoded"] and rep["mp4"]["frames_read"] == 4 and \
        all(r["finite"] and r["ate_rmse"] < r["ate_floor_identity"]
            for r in rep["demo"].values())
    if not ok:
        fail(f"demo_cv2_inputs: {rep}")


def main():
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    # backstop for a hang inside native code, where no Python handler runs
    faulthandler.dump_traceback_later(DEADLINE_S + 30, exit=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "card")
    phase_env()
    renders = start_renders()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    rows = [kernel_corr(gen), kernel_runsum(gen),
            kernel_region_fused(gen, "x32"),
            kernel_region_fused(gen, "x16"),
            *kernel_region_split(gen), kernel_chol(gen),
            kernel_corr_backward(gen)]
    kernel_region_fused(gen, "x32", M=48, E=E_FAST, shapes="fast")
    phase_slam_tiny()
    phase_slam_tiny(True, "x32", "corr_region_fused_x32")
    phase_slam_tiny(True, "x16", "corr_region_fused_x16")
    total = dict.fromkeys(_native.LAUNCHES, 0)
    for k, v in phase_entry_points(gen).items():
        total[k] += v
    runs = {}
    for name, config, n, fused, corr in (
            ("slam_default", "configs/default.yaml", 40, False,
             "corr_pyramid"),
            ("slam_fast", "configs/fast.yaml", 24, False, "corr_pyramid"),
            ("slam_default_fused", "configs/default.yaml", 40, True,
             "corr_region_fused_x16"),
            ("slam_fast_fused", "configs/fast.yaml", 24, True,
             "corr_region_fused_x32")):
        runs[name] = phase_slam(name, config, n, (corr, "runsum"), fused)
        for k, v in runs[name][0].items():
            total[k] += v
    for k, v in phase_graph_vs_sync_default(runs["slam_default"], 40).items():
        total[k] += v
    phase_weights()
    t0 = time.perf_counter()
    wild, seconds = renders["wild"].result()
    emit("render", frames=WILD_FRAMES, HxW=[HT, WD], fx=320.0,
         seconds=seconds, waited_s=time.perf_counter() - t0,
         masked_share=float(1.0 - wild[4].mean()))
    launches, wild_record = phase_wild(wild)
    for phase in (lambda: launches, phase_synth_ate_tiny,
                  lambda: phase_bootstrap_wild(wild)):
        for k, v in phase().items():
            total[k] += v
    t0 = time.perf_counter()
    keep, seconds = renders["keep"].result()
    emit("render_keep", frames=WILD_FRAMES, stride=KEEP_STRIDE,
         HxW=[HT, WD], fx=320.0, seconds=seconds,
         waited_s=time.perf_counter() - t0,
         masked_share=float(1.0 - keep[4].mean()))
    for k, v in phase_wild_keep(keep).items():
        total[k] += v
    intr = phase_calib_keep(keep)
    for k, v in phase_wild_calibrated(wild, intr, wild_record).items():
        total[k] += v
    del wild
    phase_droid_keep(keep)
    del keep
    for phase in (phase_train_step_card_vs_cpu, phase_train_learn_synth):
        for k, v in phase().items():
            total[k] += v
    t0 = time.perf_counter()
    train_batch, seconds = renders["train"].result()
    emit("render_train", clips=TRAIN_FULL_BATCH, frames=TRAIN_FULL.frames,
         HxW=[HT, WD], fx=320.0, seconds=seconds,
         waited_s=time.perf_counter() - t0)
    for k, v in phase_train_full(train_batch).items():
        total[k] += v
    del train_batch
    t0 = time.perf_counter()
    multilap, seconds = renders["multilap"].result()
    emit("render_multilap", frames=MULTILAP_FRAMES, laps=2,
         path="multiloop", HxW=[HT, WD], fx=320.0, seconds=seconds,
         waited_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    nerf_scene, seconds = renders["nerf"].result()
    emit("render_nerf", frames=NERF_FRAMES, path="orbit", HxW=[HT, WD],
         fx=320.0, seconds=seconds, waited_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    recon_scene, seconds = renders["recon"].result()
    emit("render_recon", frames=RECON_FRAMES, path="walk", HxW=[HT, WD],
         fx=320.0, seconds=seconds, waited_s=time.perf_counter() - t0)
    for k, v in phase_loop_multilap(multilap).items():
        total[k] += v
    del multilap
    phase_png_roundtrip(np.ascontiguousarray(recon_scene[0][0][..., ::-1]))
    phase_nerf_card_vs_cpu()
    phase_nerf_native(nerf_scene)
    del nerf_scene
    for refine in (True, False):
        launches, field, meta, data, workdir = phase_recon_e2e(recon_scene,
                                                               refine)
        for k, v in launches.items():
            total[k] += v
        if refine:
            phase_nerf_render(field, meta, data, workdir)
        shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    tum_scene, seconds = renders["tum"].result()
    emit("render_tum", frames=TUM_FRAMES, path="walk", HxW=[TUM_HT, TUM_WD],
         fx=320.0, seconds=seconds, waited_s=time.perf_counter() - t0)
    launches, tum_dir, tum_workdir = phase_harness_tum(tum_scene)
    for k, v in launches.items():
        total[k] += v
    # kernels #1 and #3 at the harness's shape: 480x640 maps, the first
    # edge tier of tum.yaml, where its steady frames replay
    tum_cfg = load_config("configs/tum.yaml")
    tier = steps.edge_tiers(tum_cfg, edge_rows(tum_cfg), DEV)[0]
    kernel_corr(gen, E=tier, ht=TUM_HT, wd=TUM_WD,
                phase="kernels_harness_shape")
    kernel_runsum(gen, E=tier, phase="kernels_harness_shape")
    phase_droid_tum(tum_dir, np.asarray(tum_scene[2], np.float64))
    shutil.rmtree(tum_workdir, ignore_errors=True)
    del tum_scene
    t0 = time.perf_counter()
    euroc_scene, seconds = renders["euroc"].result()
    stop_renders()
    emit("render_euroc", frames=EUROC_FRAMES, path="walk",
         HxW=[EUROC_HT, EUROC_WD], fx=320.0, seconds=seconds,
         waited_s=time.perf_counter() - t0)
    for k, v in phase_harness_euroc(euroc_scene).items():
        total[k] += v
    del euroc_scene
    net = load_reference_checkpoint(WEIGHTS, device=DEV).eval()
    for phase in (phase_synth_suite, phase_calib_sensitivity):
        for k, v in phase(net).items():
            total[k] += v
    phase_loop_recall()
    phase_matcher_recall(net)
    phase_demo_cv2_inputs()
    for row in rows:
        row["launches"] = total[row["name"]]
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
