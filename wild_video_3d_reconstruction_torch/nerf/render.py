"""Novel-view rendering and point-cloud export from a trained field.

The port's copy of the JAX package's `nerf/render.py`, the downstream
half of the native trainer (the roles of nerfstudio's ns-render and
ns-export):

- `save_field` / `load_field`: the field's state dict (`.pth`, under
  `step_N/`) plus a sidecar `field_meta.json` with the static field
  config and the scene normalization (center / scale / near / far /
  convention), without which a saved hash grid cannot be re-queried. The
  JAX package writes an orbax checkpoint there; the metadata file is the
  same, key for key.
- `interpolate_path`: a smooth camera path through the training
  keyframes (quaternion slerp, piecewise-linear centers).
- `render_path`: renders a path to PNGs (`io/png.py`) and optionally an
  mp4 (cv2).
- `export_pointcloud`: back-projects rendered depth into a colored
  world-space PLY.

CLI (on the card by default):
    python -m wild_video_3d_reconstruction_torch.nerf.render \
        --ckpt out/field --data out/nerf [--n 60] [--out renders/]
        [--video renders/path.mp4] [--pointcloud out/cloud.ply]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..io import png
from . import ngp

META_NAME = "field_meta.json"
STATE_NAME = "field.pth"


# ---------------------------------------------------------------------------
# checkpoint + metadata


def save_field(params, meta, out_dir, step):
    """Save the state dict of `params` (an `NGPField` or the refined
    trainer's `RefinedField`) as `out_dir/step_{step}/field.pth` and the
    metadata needed to reload and re-query it as
    `out_dir/field_meta.json`; returns the step directory."""
    out_dir = Path(out_dir)
    path = out_dir.absolute() / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.state_dict().items()},
               path / STATE_NAME)
    with open(out_dir / META_NAME, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    return path


def _like_params(meta):
    field = ngp.NGPField(levels=meta["levels"], table_size=meta["table_size"],
                         max_res=meta["max_res"],
                         app_dim=meta.get("app_dim", 0))
    if not meta.get("refine"):
        return field
    return ngp.RefinedField(field, meta["n_train"])


def load_field(ckpt_path, device="cuda"):
    """`ckpt_path` = a step_N dir (or the parent holding step dirs: the
    last step). Returns (field, meta): for a refined checkpoint the
    `NGPField` inside it; meta carries everything else."""
    ckpt_path = Path(ckpt_path)
    if not ckpt_path.name.startswith("step_"):
        steps = sorted(ckpt_path.glob("step_*"),
                       key=lambda p: int(p.name.split("_")[1]))
        if not steps:
            raise FileNotFoundError(f"no step_* checkpoint in {ckpt_path}")
        ckpt_path = steps[-1]
    with open(ckpt_path.parent / META_NAME, encoding="utf-8") as f:
        meta = json.load(f)
    params = _like_params(meta)
    params.load_state_dict(torch.load(ckpt_path / STATE_NAME,
                                      map_location="cpu", weights_only=True))
    params = params.to(device)
    field = params.field if meta.get("refine") else params
    return field, meta


def scene_transform(meta):
    """The world -> field-domain ray transform the field was trained
    with."""
    offset = 0.0 if meta.get("contract") else 0.5
    return lambda o, d: (ngp.to_unit(o, np.asarray(meta["center"],
                                                   np.float64),
                                     float(meta["scale"]), offset), d)


def _unnormalize(meta, pts):
    """Field-domain points -> world coordinates (inverse of
    `scene_transform`; valid outside the contraction mapping since depth
    is measured along the uncontracted normalized ray)."""
    center = np.asarray(meta["center"], np.float64)
    scale = float(meta["scale"])
    if meta.get("contract"):
        return pts / scale + center
    return (pts - 0.5) / scale + center


# ---------------------------------------------------------------------------
# camera paths


def _rotmat_to_quat(R):
    """[3, 3] -> (x, y, z, w), standard Shepperd branch selection."""
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax([m00, m11, m22]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def _quat_to_rotmat(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0, q1, s):
    if np.dot(q0, q1) < 0:
        q1 = -q1
    dot = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if dot > 0.9995:                    # nearly parallel: lerp
        q = q0 + s * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(dot)
    return (np.sin((1 - s) * th) * q0 + np.sin(s * th) * q1) / np.sin(th)


def interpolate_path(c2ws, n_out, loop=False):
    """Smooth [n_out, 4, 4] camera path through the given c2w keyframes:
    slerp on orientations, linear on centers, uniform in keyframe index."""
    c2ws = np.asarray(c2ws, np.float64)
    quats = [_rotmat_to_quat(c[:3, :3]) for c in c2ws]
    cents = [c[:3, 3] for c in c2ws]
    if loop:
        quats.append(quats[0])
        cents.append(cents[0])
    K = len(quats)
    out = []
    for t in np.linspace(0.0, K - 1, n_out, endpoint=not loop):
        i = min(int(np.floor(t)), K - 2)
        s = t - i
        c2w = np.eye(4)
        c2w[:3, :3] = _quat_to_rotmat(_slerp(quats[i], quats[i + 1], s))
        c2w[:3, 3] = (1 - s) * np.asarray(cents[i]) + s * np.asarray(
            cents[i + 1])
        out.append(c2w)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# rendering


def write_image(path, bgr):
    """uint8 BGR to an image file: PNG through `io/png.py`, any other
    format through cv2."""
    if Path(path).suffix.lower() == ".png":
        return png.write_png(path, bgr)
    import cv2

    return cv2.imwrite(str(path), bgr)


def _render(field, meta, c2w, intr, hw, chunk, fine_u, return_acc=False):
    app = (np.zeros((meta["app_dim"],), np.float32)
           if meta.get("refine") else None)
    return ngp.render_image(
        field, c2w, intr, hw, n_samples=meta.get("samples", 64),
        near=meta["near"], far=meta["far"], convention=meta["convention"],
        scene_transform=scene_transform(meta),
        hier=bool(meta.get("refine")), contraction=bool(meta.get("contract")),
        app=app, chunk=chunk, return_acc=return_acc, fine_u=fine_u)


def render_path(field, meta, c2ws, intr, hw, out_dir=None, video=None,
                fps=24, log=print, chunk=4096, fine_u=None):
    """Render every c2w in the path; optionally write PNGs
    (`out_dir/00000.png`, ...) and an mp4 (`video`, needs cv2). Returns
    the [N, H, W, 3] uint8 RGB stack. `fine_u`: the renderer's fine
    uniforms (`ngp.render_image`)."""
    frames = []
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    writer = None
    for i, c2w in enumerate(c2ws):
        img, _ = _render(field, meta, c2w, intr, hw, chunk, fine_u)
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        frames.append(u8)
        bgr = np.ascontiguousarray(u8[..., ::-1])
        if out_dir is not None:
            png.write_png(Path(out_dir) / f"{i:05d}.png", bgr)
        if video is not None:
            import cv2

            if writer is None:
                Path(video).parent.mkdir(parents=True, exist_ok=True)
                writer = cv2.VideoWriter(
                    str(video), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                    (u8.shape[1], u8.shape[0]))
            writer.write(bgr)
        if (i + 1) % 10 == 0 or i + 1 == len(c2ws):
            log(f"rendered {i + 1}/{len(c2ws)} views")
    if writer is not None:
        writer.release()
    return np.asarray(frames)


def export_pointcloud(field, meta, c2ws, intrs, hw, out_path,
                      acc_thresh=0.5, stride=1, max_points=2_000_000,
                      chunk=4096, fine_u=None):
    """Back-project rendered depth from the given views into a colored
    world-space point cloud PLY. Returns the number of points written."""
    from ..io.export import save_ply

    tr = scene_transform(meta)
    pts, cols = [], []
    for c2w, intr in list(zip(c2ws, intrs))[::stride]:
        rgb, depth, acc = _render(field, meta, c2w, intr, hw, chunk, fine_u,
                                  return_acc=True)
        o, d = ngp.camera_rays(c2w, intr, hw, meta["convention"])
        o, d = tr(o.numpy().astype(np.float64), d.numpy().astype(np.float64))
        keep = acc.reshape(-1) > acc_thresh
        p_field = o[keep] + depth.reshape(-1, 1)[keep] * d[keep]
        pts.append(_unnormalize(meta, p_field))
        cols.append((rgb.reshape(-1, 3)[keep] * 255).astype(np.uint8))
    pts = np.concatenate(pts) if pts else np.zeros((0, 3))
    cols = np.concatenate(cols) if cols else np.zeros((0, 3), np.uint8)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, cols = pts[sel], cols[sel]
    save_ply(out_path, pts.astype(np.float32), cols)
    return len(pts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, required=True,
                    help="field checkpoint dir (from train_native --save)")
    ap.add_argument("--data", type=str, default=None,
                    help="transforms.json dir for the camera path; "
                         "--synth uses the synthetic scene's path")
    ap.add_argument("--synth", action="store_true")
    ap.add_argument("--n", type=int, default=60,
                    help="interpolated path length (0 = keyframes as-is)")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--out", type=str, default=None,
                    help="PNG output directory")
    ap.add_argument("--video", type=str, default=None)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--pointcloud", type=str, default=None)
    ap.add_argument("--acc_thresh", type=float, default=0.5)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from . import train_native

    field, meta = load_field(args.ckpt, device=args.device)
    if args.synth or args.data is None:
        images, c2ws, intrs, _ = train_native.synth_scene()
    else:
        images, c2ws, intrs, _ = train_native.load_transforms(args.data)
    hw = images.shape[1:3]

    report = {"metric": "nerf_render", "views": 0, "points": 0}
    if args.out or args.video:
        path = (interpolate_path(c2ws, args.n, loop=args.loop)
                if args.n else c2ws)
        frames = render_path(field, meta, path, intrs[0], hw,
                             out_dir=args.out, video=args.video,
                             fps=args.fps)
        report["views"] = int(len(frames))
    if args.pointcloud:
        report["points"] = int(export_pointcloud(
            field, meta, c2ws, intrs, hw, args.pointcloud,
            acc_thresh=args.acc_thresh, stride=args.stride))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
