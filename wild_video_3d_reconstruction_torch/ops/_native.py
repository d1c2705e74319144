"""Build and load the port's hand-written CUDA kernels.

All sources under `csrc/` are compiled for `sm_90a` into one shared library
with a plain C interface, loaded with `ctypes`: one `nvcc -c` per source,
all started together, then one link. The
build happens at first use, into `build/torch_kernels/` at the repository
root, under a file name that carries a hash of the sources and flags, so an
unchanged tree reuses its library. A missing `nvcc` or a failed build is an
error carrying the compiler's output; nothing falls back to the plain
versions.

Each kernel wrapper counts its launches in `LAUNCHES` (one per wrapper
call that launches its kernel), so a run can show which kernels it went
through. A CUDA graph replays launches without running the wrappers:
`captured_launches` records what a capture's wrapper calls counted (and
takes it back out, since capturing launches nothing), and `add_launches`
adds that record on each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"corr_pyramid": 0, "corr_pyramid_backward": 0, "runsum": 0, "corr_region_fused_x32": 0,
            "corr_region_fused_x16": 0, "corr_region_surfaces": 0,
            "corr_region_extract": 0, "chol_solve": 0}

# the C entry points and their argument types (pointers and the stream as
# c_void_p so that 64-bit addresses are not cut to C ints)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "wv3d_corr_pyramid": [_P] * 8 + [_I] * 6 + [_P],
    "wv3d_corr_pyramid_backward": [_P] * 11 + [_I] * 5 + [_P],
    "wv3d_runsum": [_P] * 5 + [_I] * 2 + [_P],
    "wv3d_runsum_tile": [],
    "wv3d_corr_region_fused_x32": [_P] * 9 + [_I] * 6 + [_P],
    "wv3d_corr_region_fused_x16": [_P] * 9 + [_I] * 6 + [_P],
    "wv3d_corr_region_surfaces_x16": [_P] * 8 + [_I] * 6 + [_P],
    "wv3d_corr_region_extract_x16": [_P] * 10 + [_I] * 6 + [_P],
    "wv3d_chol_solve": [_P] * 3 + [_I] + [_P],
}

_lib = None
_lock = threading.Lock()
BUILD_INFO = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a dict that receives, on exit,
    the launches the wrappers counted during the capture; `LAUNCHES` is
    left as it was before."""
    before = dict(LAUNCHES)
    record = {}
    try:
        yield record
    finally:
        record.update({k: LAUNCHES[k] - v for k, v in before.items()})
        LAUNCHES.update(before)


def add_launches(record):
    """Count one replay of a graph whose capture recorded `record`."""
    for k, v in record.items():
        LAUNCHES[k] += v


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwv3d_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile csrc/*.cu into the hashed library if it is not there yet.
    Returns its path; BUILD_INFO records the compile time (None when the
    library was already built) and the compiler's resource report."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=None, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in _sources():
            obj = os.path.join(objdir, src.stem + ".o")
            cmd = [_nvcc(), *compile_flags, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out_text = proc.communicate()[0]
            log.append(out_text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})\n"
                              f"{out_text}")
        if not failed:
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})\n"
                              f"{proc.stdout}\n{proc.stderr}")
    seconds = time.perf_counter() - t0
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    BUILD_INFO.update(path=str(out), seconds=seconds, log="".join(log))
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def on_cuda(*tensors):
    """True when any tensor lies on the card: its wrapper then launches
    the kernel (or raises on a CPU/CUDA mix), never the plain version."""
    return any(t.is_cuda for t in tensors)


def require_cuda(name, *tensors, dtypes=None):
    """Raise unless every tensor is contiguous on one CUDA device, 16-byte
    aligned and (when given) of an accepted dtype, and none needs a
    gradient: a raw launch records no backward, so it would drop one
    silently (the correlation's gradient goes through its
    `torch.autograd.Function`, `ops/corr.py`)."""
    dev = tensors[0].device
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: an input needs a gradient, and this "
                         "kernel has no backward")
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
    if dtypes is not None:
        for t, ok in zip(tensors, dtypes):
            if ok is not None and t.dtype not in ok:
                raise TypeError(f"{name}: dtype {t.dtype} not in {ok}")


def stream_ptr(device):
    """The current CUDA stream of `device` as a C pointer, through the raw
    accessor that PyTorch's own generated kernels launch with: building a
    `torch.cuda.Stream` object costs a few microseconds of host time per
    launch."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))
