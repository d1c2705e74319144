"""Trajectory, point-cloud and sparse-model export.

Counterpart of the JAX package's `io/export.py`, numpy only apart from
the Lie group (`ops/lie.py`): TUM trajectories, binary or ASCII PLY point
clouds, COLMAP text and binary sparse models (`io/colmap_model.py`) and
the nerfstudio `transforms.json`, written byte for byte as the JAX
package writes them from the same arrays.

Poses are camera-to-world [N, 7] in the (tx ty tz qx qy qz qw) layout
that `DPVO.terminate` returns.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..ops import lie
from . import colmap_model


def save_trajectory_tum_format(poses_c2w, tstamps, filename):
    """One line per pose: `t x y z qx qy qz qw`."""
    with Path(filename).open("w") as f:
        for t, p in zip(tstamps, np.asarray(poses_c2w)):
            vals = " ".join(f"{v:.9f}" for v in p)
            f.write(f"{t} {vals}\n")
    return filename


def load_trajectory_tum_format(filename):
    data = np.loadtxt(filename, ndmin=2)
    return data[:, 1:8], data[:, 0]


def save_ply(filename, points, colors=None, binary=True):
    """Minimal PLY writer (replaces plyfile; `dpvo_demo.py:129-135`)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0" if binary
              else "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        colors = np.asarray(colors).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            rec = np.empty(n, dtype=_ply_dtype(has_color))
            rec["x"], rec["y"], rec["z"] = points.T
            if has_color:
                rec["red"], rec["green"], rec["blue"] = colors.T
            rec.tofile(f)
        else:
            for i in range(n):
                row = " ".join(map(str, points[i]))
                if has_color:
                    row += " " + " ".join(map(str, colors[i]))
                f.write((row + "\n").encode())
    return filename


def _ply_dtype(has_color):
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_color:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    return np.dtype(fields)


def load_ply(filename, return_colors=False):
    """Read back a PLY written by `save_ply` (binary or ascii, xyz +
    optional uchar rgb). Returns points [N,3] (and colors [N,3] uint8)."""
    with open(filename, "rb") as f:
        header, has_color, binary, n = [], False, True, 0
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line.startswith("format"):
                binary = "binary" in line
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line == "property uchar red":
                has_color = True
            elif line == "end_header":
                break
        if binary:
            rec = np.fromfile(f, dtype=_ply_dtype(has_color), count=n)
            pts = np.stack([rec["x"], rec["y"], rec["z"]], -1)
            clr = (np.stack([rec["red"], rec["green"], rec["blue"]], -1)
                   if has_color else None)
        else:
            data = np.loadtxt(f, ndmin=2)
            pts = data[:, :3].astype(np.float32)
            clr = data[:, 3:6].astype(np.uint8) if has_color else None
    if return_colors:
        return pts, clr
    return pts


def plot_trajectory(poses_c2w, gt_poses=None, title="", filename="traj.pdf"):
    """2D trajectory plot on the two highest-variance axes
    (`dpvo/plot_utils.py:22-48` without the evo dependency)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = np.asarray(poses_c2w)[:, :3]
    ref = np.asarray(gt_poses)[:, :3] if gt_poses is not None else xyz
    order = np.argsort(np.var(ref, axis=0))
    a1, a2 = order[2], order[1]
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt_poses is not None:
        ax.plot(ref[:, a1], ref[:, a2], "--", color="gray",
                label="Ground Truth")
    ax.plot(xyz[:, a1], xyz[:, a2], "-", color="blue", label="Predicted")
    ax.set_xlabel("xyz"[a1])
    ax.set_ylabel("xyz"[a2])
    ax.set_title(title)
    ax.legend()
    ax.axis("equal")
    fig.savefig(filename, bbox_inches="tight")
    plt.close(fig)
    return filename


def save_output_for_colmap(name, poses_c2w, tstamps, points, colors,
                           fx, fy, cx, cy, H, W, image_names=None,
                           nerfstudio_format=True):
    """COLMAP-compatible sparse reconstruction + optional nerfstudio export.

    Writes the text model in `name/`, the binary model in
    `name/colmap/sparse/0/`, and `name/transforms.json`
    (`dpvo/plot_utils.py:58-115` without external binaries).
    """
    out = Path(name)
    out.mkdir(parents=True, exist_ok=True)

    cameras = {1: colmap_model.Camera(1, "PINHOLE", W, H,
                                      np.array([fx, fy, cx, cy]))}

    w2c = lie.se3_inv(torch.from_numpy(
        np.asarray(poses_c2w, np.float32))).numpy()
    images = {}
    for idx, (p, t) in enumerate(zip(w2c, tstamps), start=1):
        qvec = np.array([p[6], p[3], p[4], p[5]])   # (x,y,z,w) -> (w,x,y,z)
        nm = image_names[idx - 1] if image_names else f"frame_{int(t):06d}.png"
        images[idx] = colmap_model.Image(idx, qvec, p[:3], 1, nm)

    pts = {}
    colors = np.asarray(colors)
    if colors.size and colors.max() <= 1.0 + 1e-6:
        colors = (colors * 255.0)
    for i, (p, c) in enumerate(zip(np.asarray(points), colors), start=1):
        pts[i] = colmap_model.Point3D(i, np.asarray(p),
                                      np.asarray(c).astype(np.uint8))

    colmap_model.write_text(out, cameras, images, pts)
    if nerfstudio_format:
        bin_dir = out / "colmap" / "sparse" / "0"
        colmap_model.write_binary(bin_dir, cameras, images, pts)
        transforms = colmap_to_transforms_json(cameras, images)
        with open(out / "transforms.json", "w") as f:
            json.dump(transforms, f, indent=2)
    return out


# COLMAP camera model -> (single shared focal?, distortion params in COLMAP
# parameter order after f/cx/cy, nerfstudio camera_model). Layouts follow
# colmap/src/base/camera_models.h; the translation mirrors the reference
# formatter (`formatter/colmap_utilis.py:38-222`), which folds every
# perspective model into nerfstudio OPENCV and every fisheye into
# OPENCV_FISHEYE, zero-filling absent coefficients.
_CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (True, (), "OPENCV"),
    "PINHOLE": (False, (), "OPENCV"),
    "SIMPLE_RADIAL": (True, ("k1",), "OPENCV"),
    "RADIAL": (True, ("k1", "k2"), "OPENCV"),
    "OPENCV": (False, ("k1", "k2", "p1", "p2"), "OPENCV"),
    "OPENCV_FISHEYE": (False, ("k1", "k2", "k3", "k4"), "OPENCV_FISHEYE"),
    "SIMPLE_RADIAL_FISHEYE": (True, ("k1",), "OPENCV_FISHEYE"),
    "RADIAL_FISHEYE": (True, ("k1", "k2"), "OPENCV_FISHEYE"),
}


def camera_intrinsics_json(cam):
    """One COLMAP camera -> nerfstudio intrinsics dict (no frames).

    Raises on FULL_OPENCV / FOV / THIN_PRISM_FISHEYE exactly as the
    reference formatter does (`formatter/colmap_utilis.py:140-220`).
    """
    if cam.model not in _CAMERA_MODELS:
        raise ValueError(f"unsupported camera model {cam.model}")
    single_f, dist_names, ns_model = _CAMERA_MODELS[cam.model]
    p = [float(v) for v in cam.params]
    if single_f:
        fx = fy = p[0]
        cx, cy, rest = p[1], p[2], p[3:]
    else:
        (fx, fy, cx, cy), rest = p[:4], p[4:]
    dist = dict.fromkeys(
        ("k1", "k2", "p1", "p2") if ns_model == "OPENCV"
        else ("k1", "k2", "k3", "k4"), 0.0)
    dist.update(zip(dist_names, rest))
    out = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
           "w": int(cam.width), "h": int(cam.height),
           "camera_model": ns_model}
    out.update(dist)
    return out


def colmap_to_transforms_json(cameras, images, frame_range=None):
    """COLMAP model -> nerfstudio transforms dict.

    Camera convention conversion as in the reference formatter
    (`formatter/colmap_utilis.py`, `nerf_train/nerf_prepare.py:105-115`):
    w2c -> c2w, then OpenCV -> OpenGL (flip y/z rows), then axis swap.
    """
    cam = next(iter(cameras.values()))
    intr = camera_intrinsics_json(cam)

    frames = []
    for im in sorted(images.values(), key=lambda x: x.name):
        c2w = np.linalg.inv(im.w2c_matrix())
        c2w[0:3, 1:3] *= -1          # OpenCV -> OpenGL
        c2w = c2w[np.array([1, 0, 2, 3]), :]
        c2w[2, :] *= -1              # world axis convention
        frames.append({
            "file_path": f"images/{im.name}",
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": im.image_id,
        })
    out = dict(intr)
    out["frames"] = frames
    return out
