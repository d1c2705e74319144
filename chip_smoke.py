"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels, holds each against its plain PyTorch
version at default-config shapes, then drives the DPVO main path (warm-up,
motion probe, 12-iteration bootstrap, steady-state frames, terminate, TUM
export) at configs/default.yaml and configs/fast.yaml on 384x512 synthetic
frames with weights drawn from a seed, and checks a small run on the card
against the same run on the CPU. Each phase prints one JSON line; the
kernel summary and then the result line come last. Any failure exits
non-zero without the result line; so does a machine without CUDA.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from wild_video_3d_reconstruction_torch.io import export
from wild_video_3d_reconstruction_torch.ops import _native
from wild_video_3d_reconstruction_torch.ops.corr import (
    corr_lookup, patch_corr_pyramid)
from wild_video_3d_reconstruction_torch.ops.segment import (
    run_segment_sum_sorted, run_segment_sum_sorted_plain)
from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import (
    DPVOConfig, load_config)

DEADLINE_S = 600
T0 = time.perf_counter()


def emit(phase, **kw):
    kw = {"phase": phase, **kw,
          "elapsed_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(kw), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _deadline(signum, frame):
    print(f"chip_smoke: deadline of {DEADLINE_S} s reached; stopping",
          file=sys.stderr, flush=True)
    os._exit(124)


DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
HT, WD = 384, 512
E_KERNEL = 55296                 # default config's first edge tier (25%)
TOL_CORR_ABS = 1e-2
TOL_RUNSUM_REL = 1e-5
TOL_SLAM_TINY = 1e-2


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


def corr_inputs(gen):
    """Default-config shapes: pmem=36 ring slots of M=384 patches, /4 and
    /16 maps of a 384x512 frame, E_KERNEL edges whose 3x3 patches sit at
    random centres with a random flow (some reach past the border)."""
    pmem, M = 36, 384
    h4, w4 = HT // 4, WD // 4
    E = E_KERNEL

    def randn(*shape):
        return (0.25 * torch.randn(*shape, generator=gen)).to(
            DEV, torch.bfloat16)

    gmap = randn(pmem * M, 128, 3, 3)
    fmap1 = randn(pmem, h4, w4, 128)
    fmap2 = randn(pmem, h4 // 4, w4 // 4, 128)
    cx = torch.rand(E, generator=gen) * (w4 - 2) + 1
    cy = torch.rand(E, generator=gen) * (h4 - 2) + 1
    flow = 4.0 * torch.randn(E, 2, generator=gen)
    off = torch.arange(3.0) - 1
    x = (cx + flow[:, 0])[:, None, None] + off[None, None, :]
    y = (cy + flow[:, 1])[:, None, None] + off[None, :, None]
    coords = torch.stack([x.expand(E, 3, 3), y.expand(E, 3, 3)], -1)
    kk = torch.randint(0, pmem * M, (E,), generator=gen)
    jj = torch.randint(0, pmem, (E,), generator=gen)
    valid = torch.rand(E, generator=gen) < 0.95
    return (gmap, fmap1, fmap2, coords.to(DEV).contiguous(),
            kk.to(DEV, torch.int32), jj.to(DEV, torch.int32), valid.to(DEV))


def kernel_corr(gen):
    gmap, fmap1, fmap2, coords, kk, jj, valid = corr_inputs(gen)
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
    plain_ms = time_ms(lambda: patch_corr_pyramid(
        gmap, pyr, coords, kk, jj, valid=valid, chunk=4096), reps=3,
        warmup=1)
    # yardstick: the plain version's einsum alone, over windows gathered
    # beforehand in the feature dtype (one level at a time)
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
    n_bytes = nbytes(gmap, fmap1, fmap2, coords, kk, jj, valid, out)
    flops = 2.0 * E * 2 * 9 * 64 * 128
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    row = dict(
        name="corr_pyramid", route="cuda",
        source="wild_video_3d_reconstruction_torch/csrc/corr.cu",
        replaces="wild_video_3d_reconstruction_tpu/ops/pallas_corr.py:83, "
                 "wild_video_3d_reconstruction_tpu/ops/pallas_corr.py:123",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms)
    emit("kernels", E=E, rel_err=rel, tol_abs=TOL_CORR_ABS,
         finite=finite, bytes=n_bytes, flops=flops, **row)
    if not finite or not err <= TOL_CORR_ABS:
        fail(f"corr kernel disagrees with its plain version: max abs err "
             f"{err} > {TOL_CORR_ABS}")
    return row


def runsum_inputs(gen):
    """[E_KERNEL, 768] fp32 rows sorted into runs of 1..28 rows (the
    per-patch edge cap) with a trailing sentinel run of invalid rows."""
    E, D = E_KERNEL, 768
    n_valid = int(E * 0.85)
    lens = torch.randint(1, 29, (E,), generator=gen)
    seg = torch.repeat_interleave(torch.arange(E), lens)[:n_valid]
    n_seg = int(seg[-1]) + 1
    seg = torch.cat([seg, torch.full((E - n_valid,), n_seg)])
    f = torch.randn(E, D // 2, generator=gen)
    e = torch.exp(torch.randn(E, D // 2, generator=gen) - 3.0)
    fes = torch.cat([f * e, e], dim=1)
    return fes.to(DEV), seg.to(DEV, torch.int32)


def kernel_runsum(gen):
    fes, seg = runsum_inputs(gen)
    E, D = fes.shape
    out = run_segment_sum_sorted(fes, seg)
    torch.cuda.synchronize()
    ref = run_segment_sum_sorted_plain(fes, seg)
    err = (out - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(lambda: run_segment_sum_sorted(fes, seg))
    plain_ms = time_ms(lambda: run_segment_sum_sorted_plain(fes, seg))
    start = torch.ones(E, dtype=torch.bool, device=DEV)
    start[1:] = seg[1:] != seg[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    acc = torch.zeros_like(fes)
    lib_ms = time_ms(lambda: acc.zero_().index_add_(0, run, fes))
    n_bytes = nbytes(fes, seg, out)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = E * D / 67e12 * 1e3      # fp32 adds outside the tensor cores
    row = dict(
        name="runsum", route="cuda",
        source="wild_video_3d_reconstruction_torch/csrc/runsum.cu",
        replaces="wild_video_3d_reconstruction_tpu/ops/pallas_segsum.py:38",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms)
    emit("kernels", E=E, D=D, rel_err=rel, tol_rel=TOL_RUNSUM_REL,
         finite=finite, bytes=n_bytes, **row)
    if not finite or not rel <= TOL_RUNSUM_REL:
        fail(f"runsum kernel disagrees with its plain version: relative "
             f"err {rel} > {TOL_RUNSUM_REL}")
    return row


def synthetic_frames(n, seed=0, ht=None, wd=None):
    """A drifting random texture (the SLAM smoke test's input)."""
    ht, wd = ht or HT, wd or WD
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 255, size=(ht * 2, wd * 2, 3)).astype(np.uint8)
    return [big[4 * t % ht:4 * t % ht + ht, 6 * t % wd:6 * t % wd + wd].copy()
            for t in range(n)]


def phase_slam(name, config, n_frames):
    # MOTION_PROBE_THRESH=0: the motion probe runs on every warm-up frame
    # but accepts it (random weights give no meaningful flow to gate on)
    cfg = load_config(config, MOTION_PROBE_THRESH=0.0)
    frames = synthetic_frames(n_frames)
    intr = np.array([320.0, 320.0, WD / 2, HT / 2])
    slam = DPVO(cfg, None, HT, WD, seed=0, device="cuda")
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    t_start = time.perf_counter()
    steady_t, steady_launch, max_edges = None, None, 0
    for t, img in enumerate(frames):
        if slam.is_initialized and steady_t is None:
            torch.cuda.synchronize()
            steady_t = time.perf_counter()
            steady_launch = dict(_native.LAUNCHES)
            n_steady0 = t
        slam(t, img, intr)
        max_edges = max(max_edges, slam.state.n_edges)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    poses, tstamps = slam.terminate()
    launches = dict(_native.LAUNCHES)
    if steady_t is None:
        fail(f"{name}: DPVO never initialized")
    n_steady = n_frames - n_steady0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traj.txt")
        export.save_trajectory_tum_format(poses, tstamps, path)
        back, _ = export.load_trajectory_tum_format(path)
    per_frame = {k: (launches[k] - steady_launch[k]) / n_steady
                 for k in launches}
    finite = bool(np.isfinite(poses).all())
    emit(name, config=config, frames=n_frames, HxW=[HT, WD],
         patches=cfg.PATCHES_PER_FRAME, initialized=slam.is_initialized,
         keyframes=slam.n_host, n_edges=slam.state.n_edges,
         max_n_edges=max_edges, steady_frames=n_steady,
         fps_steady=n_steady / (t_end - steady_t),
         total_s=t_end - t_start, launches=launches,
         launches_per_steady_frame=per_frame, poses_finite=finite,
         tum_rows=int(back.shape[0]),
         motion_gate="probe runs; MOTION_PROBE_THRESH=0 accepts every frame",
         weights="random, seed 0")
    if not finite or poses.shape != (n_frames, 7) or \
            back.shape != (n_frames, 7):
        fail(f"{name}: trajectory not finite or of the wrong shape")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{name}: kernel {k} was not launched on the main path")
    return launches


def phase_slam_tiny():
    """The VO slice at a tiny size in fp32 on the card (kernels) and on
    the CPU (plain versions), same seed and frames: trajectories agree."""
    cfg = DPVOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
                     OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3,
                     KEYFRAME_INDEX=2, MEM=12, GRADIENT_BIAS=False,
                     MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0)
    ht, wd = 48, 64
    frames = synthetic_frames(14, ht=ht, wd=wd)
    intr = np.array([40.0, 40.0, wd / 2, ht / 2])
    out = {}
    for dev in ("cuda", "cpu"):
        slam = DPVO(cfg, None, ht, wd, seed=0, device=dev)
        for t, img in enumerate(frames):
            slam(t, img, intr)
        out[dev] = (slam.terminate()[0], sorted(slam.delta))
    diff = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    same_kf = out["cuda"][1] == out["cpu"][1]
    emit("slam_tiny_vs_cpu", frames=len(frames), max_abs_pose_diff=diff,
         tol=TOL_SLAM_TINY, same_keyframe_drops=same_kf)
    if not same_kf or not diff <= TOL_SLAM_TINY:
        fail("tiny slice on the card disagrees with the CPU run")


def main():
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    # backstop for a hang inside native code, where no Python handler runs
    faulthandler.dump_traceback_later(DEADLINE_S + 30, exit=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "card")
    phase_env()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    rows = [kernel_corr(gen), kernel_runsum(gen)]
    phase_slam_tiny()
    total = {}
    for name, config, n in (("slam_default", "configs/default.yaml", 40),
                            ("slam_fast", "configs/fast.yaml", 24)):
        for k, v in phase_slam(name, config, n).items():
            total[k] = total.get(k, 0) + v
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
