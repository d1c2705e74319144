"""The port needs nothing that the GPU machine lacks.

In a fresh interpreter with `jax`, `yaml`, `cv2` and the JAX package
blocked, every module of `wild_video_3d_reconstruction_torch` and the
`chip_smoke` module import, the configs load, and a DPVO builds and tracks
frames on the CPU. A static scan of the port's sources backs this up for
lazy imports inside functions.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wild_video_3d_reconstruction_torch"
BLOCKED = ("jax", "jaxlib", "yaml", "cv2", "wild_video_3d_reconstruction_tpu")

SCRIPT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None          # any import of it raises ImportError
import importlib, pkgutil
import numpy as np
import wild_video_3d_reconstruction_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import load_config
for c in ("default", "fast", "mid", "tum"):
    load_config(f"configs/{{c}}.yaml")
cfg = load_config("configs/fast.yaml", BUFFER_SIZE=32, PATCHES_PER_FRAME=8,
                  MIXED_PRECISION=False)
slam = DPVO(cfg, None, 48, 64, device="cpu")
rng = np.random.default_rng(0)
for t in range(3):
    slam(t, rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
         [40.0, 40.0, 32.0, 24.0])
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in {blocked!r} and sys.modules[k])
print("LOADED", loaded, len(names))
"""


def test_port_imports_and_runs_without_jax_yaml_cv2():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("LOADED")]
    assert line and line[0].startswith("LOADED []"), proc.stdout
    assert int(line[0].split()[-1]) >= 20     # every module was imported


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


def test_port_sources_never_import_jax_or_the_jax_package():
    """Also the imports inside functions, which an import alone does not
    run (cv2 only in the demo's image reader)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod, line in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "yaml",
                               "wild_video_3d_reconstruction_tpu"), \
                f"{f.relative_to(ROOT)}:{line} imports {mod}"
            if top == "cv2":
                assert f.name == "demo.py", f"{f}:{line} imports cv2"
