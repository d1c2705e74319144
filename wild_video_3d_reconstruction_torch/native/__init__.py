"""ctypes bindings of the host library `native/graphlib.cpp`.

The library is built with `c++` at first use into `build/host_lib/` at the
repository root (git-ignored), under a file name that carries a hash of
the source, the flags and the build host (the compiler's version, the
machine and its C library), so an unchanged tree on one host reuses it and
a library built on another host is never loaded. A missing
compiler or a failed build raises with the compiler's output: nothing falls
back to Python. This is host code (the loop closure's "dbow" retrieval
backend and a neighbour-link oracle), not a kernel of the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "graphlib.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "host_lib"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "graph_neighbors": ([_i64p, _i64p, ctypes.c_int64, _i64p, _i64p], None),
    "edge_capacity": ([ctypes.c_int64] * 3, ctypes.c_int64),
    "retrieval_create": ([], ctypes.c_void_p),
    "retrieval_destroy": ([ctypes.c_void_p], None),
    "retrieval_insert": ([ctypes.c_void_p, ctypes.c_int32, _u8p,
                          ctypes.c_int64], None),
    "retrieval_query": ([ctypes.c_void_p, _u8p, ctypes.c_int64,
                         ctypes.c_int32, _f32p], ctypes.c_int32),
    "hamming_match": ([_u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
                       ctypes.c_int32, _i32p, _i32p, ctypes.c_int64],
                      ctypes.c_int64),
}


def _compiler():
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++, g++) on PATH: the host "
                           "library native/graphlib.cpp cannot be built")
    return cxx


def library_path(cxx=None):
    """The hashed library's path for this source, these flags and this
    host's compiler, machine and C library."""
    cxx = cxx or _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    for part in (cxx, version, platform.machine(), *platform.libc_ver()):
        h.update(part.encode())
    return BUILD_DIR / f"libgraphlib_{h.hexdigest()[:16]}.so"


def build():
    """Compile graphlib.cpp into the hashed library unless it is there.
    Returns its path."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *FLAGS, str(SOURCE), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the host library failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent build sees all or nothing
    return out


def get_lib():
    """The loaded host library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def neighbors(kk, jj):
    """Per edge, the previous and next edge of the same patch in target
    frame order (stable), -1 where there is none: (ix, jx) int64."""
    kk = np.ascontiguousarray(kk, np.int64)
    jj = np.ascontiguousarray(jj, np.int64)
    if kk.shape != jj.shape or kk.ndim != 1:
        raise ValueError("kk and jj must be 1-d arrays of one length")
    n = len(kk)
    ix = np.empty(n, np.int64)
    jx = np.empty(n, np.int64)
    get_lib().graph_neighbors(_ptr(kk, _i64p), _ptr(jj, _i64p), n,
                              _ptr(ix, _i64p), _ptr(jx, _i64p))
    return ix, jx


def to_binary_codes(desc):
    """Float descriptors [N, D] -> 256-bit LSH sign codes [N, 32] uint8,
    through a fixed random projection (np.random.default_rng(12345)), so
    codes compare across calls."""
    desc = np.asarray(desc, np.float32)
    rng = np.random.default_rng(12345)
    proj = rng.standard_normal((desc.shape[1], 256)).astype(np.float32)
    return np.packbits((desc @ proj) > 0, axis=1)


class BinaryRetrieval:
    """Inverted-file retrieval over binary codes: `insert_image` adds an
    image's descriptors; `query` returns the best match at least `rad`
    images older."""

    def __init__(self, rad=50):
        self.rad = rad
        self.lib = get_lib()
        self.db = self.lib.retrieval_create()
        self.codes = {}

    def insert_image(self, image_id, desc):
        codes = np.ascontiguousarray(to_binary_codes(desc))
        self.codes[image_id] = codes
        self.lib.retrieval_insert(self.db, image_id, _ptr(codes, _u8p),
                                  len(codes))

    def query(self, image_id):
        """(j, score, (idx0, idx1)) of the best match j <= image_id - rad,
        the pairs the mutual-best Hamming matches within 80 bits; (None,
        0.0, None) when there is none."""
        codes = self.codes[image_id]
        score = ctypes.c_float(0)
        j = self.lib.retrieval_query(self.db, _ptr(codes, _u8p), len(codes),
                                     image_id - self.rad,
                                     ctypes.byref(score))
        if j < 0:
            return None, 0.0, None
        cj = self.codes[j]
        idx0 = np.empty(len(codes), np.int32)
        idx1 = np.empty(len(codes), np.int32)
        m = self.lib.hamming_match(_ptr(codes, _u8p), len(codes),
                                   _ptr(cj, _u8p), len(cj), 80,
                                   _ptr(idx0, _i32p), _ptr(idx1, _i32p),
                                   len(codes))
        return int(j), float(score.value), (idx0[:m], idx1[:m])

    def close(self):
        if getattr(self, "db", None):
            self.lib.retrieval_destroy(self.db)
            self.db = None

    def __del__(self):
        self.close()
