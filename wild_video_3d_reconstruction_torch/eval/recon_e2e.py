"""The whole pipeline on a rendered sequence: video -> SLAM -> COLMAP ->
NeRF.

The port's copy of the JAX package's `eval/recon_e2e.py`, the reference's
headline chain (`dpvo_demo.py` -> `plot_utils.save_output_for_COLMAP` ->
`nerf_train/nerf_prepare.py` -> `nerf_train/nerf_train.py`), in process,
on the card by default, over a rendered sequence with known ground truth:

  1. render a multi-plane world sequence to PNG frames on disk
     (`io/png.py`);
  2. run the demo (`demo.run`) over the image directory, the user's
     entry point, with `export_colmap` on;
  3. run the NeRF prepare stage on the exported binary COLMAP model
     (`nerf/prepare.generate_nf_transform`, OpenCV -> OpenGL);
  4. train the native instant-NGP field on the resulting transforms.json
     (`nerf/train_native`) and report its held-out PSNR;
  5. report the SLAM Sim(3) ATE against the renderer's ground truth,
     beside the identity trajectory's (the floor).

Run: python -u -m wild_video_3d_reconstruction_torch.eval.recon_e2e \
         [--params weights/vonet_synth_tpu_r3_step2000.pth] [--frames 40]
Prints one JSON line: {"metric": "recon_e2e", "ate_rmse": ..,
"psnr": .., ...}.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np


def train_nerf(data, refine=True, nerf_steps=400, device="cuda",
               eval_align=True):
    """Stage 4's NeRF on `load_transforms` data: the refined trainer
    (with the eval-pose alignment) or the plain one, at this module's
    settings. Returns (field, report)."""
    from ..nerf import train_native

    if refine:
        return train_native.train_refine(
            *data, steps=nerf_steps, batch=2048, n_coarse=32, n_fine=24,
            table_size=2 ** 13, eval_every=nerf_steps, eval_align=eval_align,
            device=device)
    return train_native.train(
        *data, steps=nerf_steps, batch=2048, n_samples=48,
        table_size=2 ** 13, eval_every=nerf_steps, device=device)


def gt_pose_nerf(scene, workdir, refine=True, nerf_steps=400,
                 device="cuda"):
    """The control for stage 4: `train_nerf` (no alignment) on the PNG
    frames `run` wrote under `workdir` with the renderer's ground-truth
    poses in place of SLAM's, sent through the same COLMAP export,
    prepare and transforms.json. Returns its report."""
    import torch

    from ..io import export
    from ..nerf import prepare, train_native
    from ..ops import lie

    images, poses_w2c, intr = scene
    ht, wd = images.shape[1:3]
    c2w = lie.se3_inv(torch.as_tensor(poses_w2c, dtype=torch.float64))
    fx, fy, cx, cy = [float(v) for v in intr]
    gt = Path(workdir) / "gt"
    model = export.save_output_for_colmap(
        gt / "colmap_images", c2w.numpy(),
        np.arange(len(images), dtype=np.float64), np.zeros((1, 3)),
        np.zeros((1, 3), np.uint8), fx, fy, cx, cy, ht, wd)
    prepare.generate_nf_transform(model, gt / "nerf",
                                  image_dir="../../images")
    return train_nerf(train_native.load_transforms(gt / "nerf"), refine,
                      nerf_steps, device, eval_align=False)[1]


def run(params=None, frames=40, ht=48, wd=64, seed=0, nerf_steps=400,
        workdir=None, path="walk", refine=True, device="cuda", fx=40.0,
        fy=40.0, scene=None, return_field=False):
    """The chain over `render_sequence(seed, frames, ht, wd, fx, fy,
    path)` (or `scene`, that call's output made ahead). `params`: the VO
    weights (a `.pth` path, a VONet, or None for weights from a seed).
    Returns the report (with the seconds of each stage); with
    return_field also the trained `RefinedField` / `NGPField` and its
    `nerf/render.py` metadata."""
    from .. import demo
    from ..io import png
    from ..nerf import prepare, train_native
    from ..train.synth import render_sequence
    from ..utils.config import DPVOConfig
    from . import synth_ate

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="recon_e2e_")
    workdir = Path(workdir)
    imagedir = workdir / "images"
    imagedir.mkdir(parents=True, exist_ok=True)
    seconds = {}

    # 1. render the world to disk exactly as a user's frame dir
    t0 = time.perf_counter()
    images, poses_gt_w2c, intr = scene if scene is not None else \
        render_sequence(seed, frames=frames, ht=ht, wd=wd, fx=fx, fy=fy,
                        path=path)
    for t in range(frames):
        png.write_png(imagedir / f"frame_{t:06d}.png", images[t][..., ::-1])
    seconds["render"] = time.perf_counter() - t0

    # 2. the genuine demo entry point (stride 1; synthetic scenes are
    #    too short to skip frames)
    cfg = DPVOConfig(
        BUFFER_SIZE=max(frames + 8, 64), PATCHES_PER_FRAME=16,
        REMOVAL_WINDOW=8, OPTIMIZATION_WINDOW=6, PATCH_LIFETIME=5,
        KEYFRAME_INDEX=2, MEM=16, GRADIENT_BIAS=False, PALLAS_CORR=False,
        CORR_CHUNK=1024, DEPTH_INIT="median", MOTION_PROBE_THRESH=-1.0)
    out = workdir / "output"
    demo_s = {}
    poses, tstamps, _ = demo.run(
        cfg, params, str(imagedir), np.asarray(intr, np.float64),
        stride=1, path=str(out), save_trajectory=True, export_colmap=True,
        device=device, depthdir=None, maskdir=None, timings=demo_s)
    seconds["vo"], seconds["export"] = demo_s["track"], demo_s["outputs"]

    # 3. the reference's prepare stage over the exported binary model
    t0 = time.perf_counter()
    recon = out / "colmap_images" / "colmap" / "sparse" / "0"
    nerf_dir = out / "nerf"
    prepare.generate_nf_transform(recon, nerf_dir, image_dir="../../images")
    seconds["prepare"] = time.perf_counter() - t0

    # 4. native NGP training on the prepared data; pose refinement is on
    #    by default because the poses come from SLAM, not SfM
    t0 = time.perf_counter()
    data = train_native.load_transforms(nerf_dir)
    field, rep = train_nerf(data, refine, nerf_steps, device)
    seconds["nerf"] = time.perf_counter() - t0

    # 5. trajectory accuracy vs the renderer's ground truth
    t0 = time.perf_counter()
    ate, n, floor = synth_ate.ate_against(poses, tstamps, poses_gt_w2c)
    seconds["eval"] = time.perf_counter() - t0

    report = {"metric": "recon_e2e", "frames": frames,
              "ate_rmse": float(ate), "ate_floor_identity": floor,
              "n_aligned": int(n),
              "psnr_init": rep["psnr_init"], "psnr": rep["psnr"],
              "psnr_aligned": rep.get("psnr_aligned"),
              "refine": bool(refine),
              "pose_delta_rms": rep.get("pose_delta_rms"),
              "nerf_steps": nerf_steps, "workdir": str(workdir),
              "seconds": seconds}
    if not return_field:
        return report
    meta = dict(refine=bool(refine), contract=False, levels=8,
                table_size=2 ** 13, max_res=256,
                app_dim=field.field.app_dim if refine else 0,
                n_train=int(field.app.shape[0]) if refine else 0,
                center=np.asarray(rep["center"]).tolist(),
                scale=float(rep["scale"]), near=float(rep["near"]),
                far=float(rep["far"]), convention=data[3],
                samples=32 if refine else 48)
    return report, field, meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", type=str, default=None,
                    help="VO weights (.pth), e.g. "
                         "weights/vonet_synth_tpu_r3_step2000.pth")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--nerf_steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path", choices=["walk", "orbit"], default="walk")
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--no_refine", action="store_true",
                    help="plain NGP trainer instead of the refined one")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    rep = run(params=args.params, frames=args.frames, seed=args.seed,
              nerf_steps=args.nerf_steps, workdir=args.workdir,
              path=args.path, refine=not args.no_refine, device=args.device)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
