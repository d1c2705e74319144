"""Build copies of one of the port's CUDA sources that differ in a few
constants, for the sweeps of `scripts/torch_corr_box_capacity.py` and
`scripts/torch_runsum_tiles.py`. Needs `nvcc`."""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wild_video_3d_reconstruction_torch.ops import _native  # noqa: E402

CSRC = ROOT / "wild_video_3d_reconstruction_torch" / "csrc"


def set_constants(src, consts):
    """src with each `constexpr int NAME = N;` of consts {NAME: value}
    set to value."""
    for name, value in consts.items():
        line = re.compile(rf"constexpr int {name} = \d+;")
        if not line.search(src):
            raise RuntimeError(f"the source no longer defines {name}")
        src = line.sub(f"constexpr int {name} = {value};", src)
    return src


def build(sources, entry, out_dir):
    """sources {key: text of a .cu file}: one `nvcc` per source with the
    port's flags, all started together, into out_dir. Returns {key:
    (ctypes function `entry`, ptxas register and stack lines)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        cu = out_dir / f"variant_{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"libvariant_{i}.so"
        procs[key] = (lib, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = _native._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[key] = (fn, [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "stack frame" in ln])
    return fns
