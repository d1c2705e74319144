"""The port needs nothing that the GPU machine lacks.

In a fresh interpreter with `jax`, `optax`, `yaml`, `cv2` and the JAX
package blocked, every module of `wild_video_3d_reconstruction_torch` and the
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
`eval/learn_synth.py` run on the CPU; PNG frames write and read back
(`io/png.py`), the NeRF trainers (plain and refined, with the eval-pose
alignment) take two steps, a field saves, loads and renders a path to
PNGs and a point cloud, and `prepare` turns the COLMAP model above into a
transforms.json that `load_transforms` reads; the evaluation drivers run
at tiny sizes (`harness.run_scene`, `synth_suite.run_suite`,
`calib_sensitivity.run_oracle` and `run_sweep`, `loop_recall.run`,
`matcher_recall.run_pair`, the dataset registry read from a YAML file).
The card's machine has OpenCV (4.13), but the port imports it only where
it is used: with cv2 blocked, the loop closure's JPEG keyframe cache and
the harness's undistorting streams raise ImportError naming themselves.
A second interpreter, with cv2 present and the rest still blocked, runs
the loop closure with both retrieval backends to its end (retrieval
forced, keypoints, RANSAC-Umeyama, the Sim(3) PGO, terminate).
A static scan of the port's sources backs this up for lazy imports
inside functions: cv2 only inside functions of `io/stream.py` (its
`require_cv2`, which the JPEG-95 cache and the degenerate focal
fallback call too), `nerf/train_native.py` and `nerf/render.py`
(non-PNG images, mp4).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wild_video_3d_reconstruction_torch"
BLOCKED = ("jax", "jaxlib", "optax", "yaml", "cv2",
           "wild_video_3d_reconstruction_tpu")
CV2_INSIDE = ("io/stream.py", "nerf/train_native.py", "nerf/render.py")

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
    # PNG frames, prepare and the NeRF back half
    from wild_video_3d_reconstruction_torch.io import png
    from wild_video_3d_reconstruction_torch.nerf import prepare
    from wild_video_3d_reconstruction_torch.nerf import render as nrender
    from wild_video_3d_reconstruction_torch.nerf import train_native
    import os
    os.makedirs(tmp + "/images")
    for t in range(12):
        png.write_png(f"{{tmp}}/images/frame_{{t:06d}}.png", images[t])
        assert (png.read_png(f"{{tmp}}/images/frame_{{t:06d}}.png")
                == images[t]).all()
    tf = prepare.generate_nf_transform(out, tmp + "/nerf",
                                       image_dir="../images")
    data = train_native.load_transforms(tmp + "/nerf")
    assert data[0].shape == (12, 48, 64, 3)
    tiny = dict(steps=2, batch=64, levels=2, table_size=2 ** 8, max_res=16,
                eval_every=2, holdout=6, log=lambda *a: None, device="cpu")
    field, rep = train_native.train(*data, n_samples=4, **tiny)
    params, rep = train_native.train_refine(
        *data, n_coarse=4, n_fine=2, app_dim=2, eval_align=True,
        align_steps=1, **tiny)
    assert np.isfinite(rep["psnr_aligned"])
    meta = dict(refine=True, contract=False, levels=2, table_size=2 ** 8,
                max_res=16, app_dim=2, n_train=int(params.app.shape[0]),
                center=np.asarray(rep["center"]).tolist(),
                scale=float(rep["scale"]), near=rep["near"], far=rep["far"],
                convention=data[3], samples=4)
    nrender.save_field(params, meta, tmp + "/field", 2)
    field, meta = nrender.load_field(tmp + "/field", device="cpu")
    frames = nrender.render_path(field, meta, data[1][:2], data[2][0],
                                 (48, 64), out_dir=tmp + "/renders",
                                 log=lambda *a: None)
    assert frames.shape == (2, 48, 64, 3)
    assert nrender.export_pointcloud(field, meta, data[1][:1], data[2][:1],
                                     (48, 64), tmp + "/cloud.ply",
                                     acc_thresh=0.0) == 48 * 64
# the loop closure, with the native retrieval backend: its JPEG-95
# keyframe cache needs cv2, blocked here
from wild_video_3d_reconstruction_torch import native
assert native.neighbors([0, 0], [1, 0])[0].tolist() == [1, -1]
for backend in ("vlad", "dbow"):
    lc_cfg = steady.merge_from_dict(dict(
        loop_enabled=True, LC_INTERVAL=2, PIPELINE_CHUNK=1,
        LOOP_SKIP_WINDOW=3, LOOP_RETR_THRESH=-1e9, LOOP_CLOSE_WINDOW_SIZE=1,
        RETRIEVAL_BACKEND=backend))
    slam = DPVO(lc_cfg, None, 48, 64, device="cpu")
    try:
        for t in range(13):
            slam(t, images[t], intr)
        slam.terminate()
        raise AssertionError("the JPEG cache ran without cv2")
    except ImportError as e:
        assert "loop/cache.py:ImageCache.save_up_to" in str(e), e
    assert slam.loop_closure.retrieval.stored.any()
# the evaluation drivers at tiny sizes
from wild_video_3d_reconstruction_torch.eval import (
    calib_sensitivity, harness, loop_recall, matcher_recall, synth_suite)
from wild_video_3d_reconstruction_torch.utils import datasets
est, ts = harness.run_scene(steady, None, ((100.0 + t, images[t], intr)
                                           for t in range(12)), "cpu")
assert est.shape == (12, 7) and ts[0] == 100.0
out = synth_suite.run_suite({{"random": None}}, frames=10, trials=1,
                            scenes=synth_suite.SCENES[:1],
                            log=lambda *a: None, device="cpu")
assert np.isfinite(out["mean_random"])
assert calib_sensitivity.run_oracle(0.0, frames=10, device="cpu") < 5e-3
sweep = calib_sensitivity.run_sweep(frames=10, trials=1, levels=(0.05,),
                                    scenes=calib_sensitivity.SCENES[:1],
                                    log=lambda *a: None, device="cpu")
assert np.isfinite(sweep["walk_s0"]["0.05"])
frames, gt = loop_recall.build_frames(8, 8, 48, 64)
assert loop_recall.run(frames, gt, skip_window=2, device="cpu")["queries"]
from wild_video_3d_reconstruction_torch.models.convert import as_vonet
clip = matcher_recall.render_pair_clip(0, True, deltas=(2,), ht=48, wd=64)
assert matcher_recall.run_pair(*clip, 0, 2, as_vonet(None))["accepted"] >= 0
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/datasets.yaml", "w") as f:
        f.write("seq:\\n  imagedir: /x\\n  clips: [[0, 4]]\\n")
    datasets.load_registry_yaml(tmp + "/datasets.yaml")
    assert datasets.get("seq").clips == [[0, 4]]
    os.makedirs(tmp + "/s/rgb")
    png.write_png(tmp + "/s/rgb/1.0.png", images[0])
    try:
        next(harness.tum_stream(tmp + "/s"))
        raise AssertionError("undistorted without cv2")
    except ImportError as e:
        assert "io/stream.py:read_image" in str(e), e
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


# the loop closure end to end (retrieval forced, keypoints, RANSAC-Umeyama,
# the Sim(3) PGO, terminate) with cv2 present and the rest still blocked
LOOP_SCRIPT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None          # any import of it raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)      # beside the other test workers' threads
from wild_video_3d_reconstruction_torch import native
from wild_video_3d_reconstruction_torch.eval import synth_ate
from wild_video_3d_reconstruction_torch.slam import DPVO
from wild_video_3d_reconstruction_torch.utils.config import load_config
assert native.neighbors([0, 0], [1, 0])[0].tolist() == [1, -1]
images, poses, intr, depths, masks = synth_ate.wild_sequence(
    0, frames=13, ht=48, wd=64, fx=40.0, fy=40.0)
cfg = load_config("configs/fast.yaml", BUFFER_SIZE=32, PATCHES_PER_FRAME=8,
                  MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0,
                  PATCH_LIFETIME=3, REMOVAL_WINDOW=6, OPTIMIZATION_WINDOW=4,
                  MEM=12)
for backend in ("vlad", "dbow"):
    lc_cfg = cfg.merge_from_dict(dict(
        loop_enabled=True, LC_INTERVAL=2, PIPELINE_CHUNK=1,
        LOOP_SKIP_WINDOW=3, LOOP_RETR_THRESH=-1e9, LOOP_CLOSE_WINDOW_SIZE=1,
        RETRIEVAL_BACKEND=backend))
    slam = DPVO(lc_cfg, None, 48, 64, device="cpu")
    for t in range(13):
        slam(t, images[t], intr)
    est, _ = slam.terminate()
    assert est.shape == (13, 7) and slam.loop_closure.retrieval.stored.any()
    assert slam.loop_closure.imcache.stored.any()   # JPEG-95 keyframes
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in {blocked!r} and sys.modules[k])
print("LOADED", loaded, "cv2" in sys.modules)
"""


def _run(script, blocked):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", script.format(blocked=blocked)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("LOADED")]
    assert line and line[0].startswith("LOADED []"), proc.stdout
    return line[0]


def test_port_imports_and_runs_without_jax_yaml_cv2():
    line = _run(SCRIPT, BLOCKED)
    assert int(line.split()[-1]) >= 20     # every module was imported


def test_port_loop_closure_runs_with_cv2_without_jax_yaml():
    line = _run(LOOP_SCRIPT, tuple(b for b in BLOCKED if b != "cv2"))
    assert line.endswith("True")           # the cache encoded with cv2


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
    run (cv2 only inside functions of the files of CV2_INSIDE)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    cv2_lines = set()
    for f in files:
        for mod, line in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "yaml",
                               "wild_video_3d_reconstruction_tpu"), \
                f"{f.relative_to(ROOT)}:{line} imports {mod}"
            if top == "cv2":
                rel = f.relative_to(PKG).as_posix() if PKG in f.parents \
                    else str(f)
                assert rel in CV2_INSIDE, f"{f}:{line} imports cv2"
                cv2_lines.add((rel, line))
    for rel in CV2_INSIDE:
        tree = ast.parse((PKG / rel).read_text())
        inside = {n.lineno for fn in ast.walk(tree)
                  if isinstance(fn, ast.FunctionDef) for n in ast.walk(fn)
                  if isinstance(n, ast.Import)}
        lines = {line for r, line in cv2_lines if r == rel}
        assert lines and lines <= inside, rel
