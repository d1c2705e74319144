"""The port needs nothing that the GPU machine lacks.

In a fresh interpreter with `jax`, `yaml`, `cv2` and the JAX package
blocked, every module of `wild_video_3d_reconstruction_torch` and the
`chip_smoke` module import, the configs load, and a DPVO builds and tracks
frames on the CPU, through the steady step (chunked) and `sync_mode`,
with a depth prior and a mask on some frames and with keypoint patches;
the synthetic world renders and the trajectory metrics score it; a run
with global BA saves and loads a checkpoint, terminates and writes its
map as PLY and as a COLMAP model; a run with the loop closure (VLAD
descriptors from the steady step, the native "dbow" retrieval built from
`native/graphlib.cpp`, candidates verified) terminates; the
self-calibration's frame selection (`select_frames`: the Farneback flow
without cv2), the bootstrap's `track_grid` and a 3-frame `DenseVO` (both
flows) run; one training step and one held-out evaluation of
`eval/learn_synth.py` run on the CPU. A
static scan of the port's sources backs this up for lazy imports inside
functions: cv2 only inside the readers of `io/stream.py`.
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
import torch
torch.set_num_threads(1)      # beside the other test workers' threads
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
# the steady step (slam.graphs), its chunked dispatch and sync_mode, with
# depth and masks on some frames, and keypoint patches
from wild_video_3d_reconstruction_torch.eval import synth_ate
images, poses, intr, depths, masks = synth_ate.wild_sequence(
    0, frames=13, ht=48, wd=64, fx=40.0, fy=40.0)
steady = cfg.merge_from_dict(dict(MOTION_PROBE_THRESH=-1.0,
                                  PIPELINE_CHUNK=2, PATCH_LIFETIME=3,
                                  REMOVAL_WINDOW=6, OPTIMIZATION_WINDOW=4,
                                  MEM=12))
for sync, sel in ((False, "random"), (True, "keypoints")):
    slam = DPVO(steady.merge_from_dict(dict(PATCH_SELECTOR=sel)), None, 48,
                64, device="cpu", sync_mode=sync)
    for t in range(13):
        slam(t, images[t], intr, depth=depths[t] if t % 3 else None,
             mask=masks[t] if t % 2 else None)
    est, tstamps = slam.terminate()
    assert est.shape == (13, 7)
    ate, n, floor = synth_ate.ate_against(est, tstamps, poses)
    assert n == 13 and np.isfinite(ate) and floor > 0
# the terminate-time outputs: global BA, the map, PLY / COLMAP files, a
# checkpoint
import tempfile
from wild_video_3d_reconstruction_torch.io import colmap_model, export
from wild_video_3d_reconstruction_torch.slam.checkpoint import (load_slam,
                                                                save_slam)
gba = steady.merge_from_dict(dict(ENABLE_GLOBAL_BA=True, PIPELINE_CHUNK=1))
slam = DPVO(gba, None, 48, 64, device="cpu")
for t in range(12):
    slam(t, images[t], intr)
with tempfile.TemporaryDirectory() as tmp:
    save_slam(slam, tmp)
    load_slam(DPVO(gba, None, 48, 64, device="cpu"), tmp)
    pts, clr = slam.points_and_colors()
    est, tstamps = slam.terminate()
    export.save_ply(tmp + "/map.ply", pts, clr)
    out = export.save_output_for_colmap(tmp + "/colmap", est, tstamps, pts,
                                        clr, 40.0, 40.0, 32.0, 24.0, 48, 64)
    assert len(colmap_model.read_model(out)[1]) == 12
# the loop closure, with the native retrieval backend
from wild_video_3d_reconstruction_torch import native
assert native.neighbors([0, 0], [1, 0])[0].tolist() == [1, -1]
for backend in ("vlad", "dbow"):
    lc_cfg = steady.merge_from_dict(dict(
        loop_enabled=True, LC_INTERVAL=2, PIPELINE_CHUNK=1,
        LOOP_SKIP_WINDOW=3, LOOP_RETR_THRESH=-1e9, LOOP_CLOSE_WINDOW_SIZE=1,
        RETRIEVAL_BACKEND=backend))
    slam = DPVO(lc_cfg, None, 48, 64, device="cpu")
    for t in range(13):
        slam(t, images[t], intr)
    est, _ = slam.terminate()
    assert est.shape == (13, 7) and slam.loop_closure.retrieval.stored.any()
# the self-calibration's frame selection (Farneback, no cv2), the
# geometric bootstrap's LK tracks and the dense engine
from wild_video_3d_reconstruction_torch.eval.droid_harness import DenseVO
from wild_video_3d_reconstruction_torch.init.colmap_init import select_frames
from wild_video_3d_reconstruction_torch.init.mast3r_init import track_grid
assert len(select_frames(images[:6], device="cpu")) >= 2
grid, tracks, ok = track_grid(images[:3], device="cpu")
assert tracks.shape == (3, grid.shape[0], 2) and ok[1:].any()
for flow in ("lk", "corr"):
    vo = DenseVO(48, 64, intr, buffer=8, flow=flow, device="cpu")
    for t in range(3):
        vo(t, images[t])
    est, _ = vo.terminate()
    assert est.shape == (3, 7) and np.isfinite(est).all()
# training: one step of the one-device train step, one evaluation
from wild_video_3d_reconstruction_torch.eval import learn_synth
from wild_video_3d_reconstruction_torch.models.vonet import init_vonet
from wild_video_3d_reconstruction_torch.parallel.train_step import (
    build_train_step, make_optimizer)
from wild_video_3d_reconstruction_torch.train.forward import TrainConfig
from wild_video_3d_reconstruction_torch.train.synth import make_world_batch
tc = TrainConfig(frames=3, patches=2, steps=1)
net = init_vonet(0)
step = build_train_step(net, tc, make_optimizer(net.parameters(), steps=2),
                        "cpu")
m = step(make_world_batch(0, 1, tc, ht=32, wd=32), torch.Generator())
assert np.isfinite(float(m["loss"]))
ev = learn_synth.evaluate(net, [make_world_batch(1, 1, tc, ht=32, wd=32)],
                          tc, "cpu")
assert np.isfinite(ev["epe"])
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
    run (cv2 only inside the functions of `io/stream.py`)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    cv2_lines = set()
    for f in files:
        for mod, line in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "yaml",
                               "wild_video_3d_reconstruction_tpu"), \
                f"{f.relative_to(ROOT)}:{line} imports {mod}"
            if top == "cv2":
                assert f == PKG / "io" / "stream.py", \
                    f"{f}:{line} imports cv2"
                cv2_lines.add(line)
    stream = ast.parse((PKG / "io" / "stream.py").read_text())
    inside = {n.lineno for fn in ast.walk(stream)
              if isinstance(fn, ast.FunctionDef) for n in ast.walk(fn)
              if isinstance(n, ast.Import)}
    assert cv2_lines and cv2_lines <= inside
