"""NeRF data preparation: COLMAP sparse model -> nerfstudio transforms.json.

The port's copy of the JAX package's `nerf/prepare.py` (plain Python over
the port's `io/colmap_model.py` and `io/export.py`; its transforms.json is
byte for byte the JAX package's). The reference `NeRFPrepare`
(`nerf_train/nerf_prepare.py:77-160`) without the nerfstudio parsing
dependency:
frame-range slicing [start_idx, end_idx], camera-intrinsic rescaling
(COLMAP may run at 2k while VO runs at 512), OpenCV -> OpenGL conversion
with world-axis swap, missing-frame fill with the first registered pose,
and the applied_transform record nerfstudio expects.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..io import colmap_model


def _camera_out(cam, scale=1.0):
    from ..io.export import colmap_to_transforms_json

    out = colmap_to_transforms_json({1: cam}, {})
    out.pop("frames")
    for k in ("w", "h", "fl_x", "fl_y", "cx", "cy"):
        out[k] = out[k] * scale if k not in ("w", "h") else int(out[k] * scale)
    return out


def _c2w_nerfstudio(qvec, tvec):
    im = colmap_model.Image(0, np.asarray(qvec), np.asarray(tvec), 1, "")
    c2w = np.linalg.inv(im.w2c_matrix())
    c2w[0:3, 1:3] *= -1              # OpenCV -> OpenGL
    c2w = c2w[np.array([0, 2, 1, 3]), :]
    c2w[2, :] *= -1                  # world axis convention
    return c2w


def generate_nf_transform(recon_dir, output_dir, start_idx=0,
                          end_idx=10_000, intrinsic_scale=1.0,
                          image_dir="../../images"):
    """Write transforms.json for the frame range [start_idx, end_idx]."""
    recon_dir = Path(recon_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    cameras, images, _ = colmap_model.read_model(recon_dir)
    single_camera = set(cameras.keys()) == {1}
    out = _camera_out(cameras[1], intrinsic_scale) if single_camera else {}

    frames = []
    for img_id, im in images.items():
        if img_id < start_idx or img_id > end_idx:
            continue
        frames.append({
            "file_path": f"{image_dir}/{im.name}",
            "transform_matrix": _c2w_nerfstudio(im.qvec, im.tvec).tolist(),
            "colmap_im_id": img_id,
        })
        if not single_camera:
            frames[-1].update(_camera_out(cameras[im.camera_id],
                                          intrinsic_scale))

    # fill unregistered frames with the first registered pose
    # (`nerf_prepare.py:138-147`)
    have = {f["colmap_im_id"] for f in frames}
    if frames:
        fallback = min(frames, key=lambda f: f["colmap_im_id"])
        # derive the on-disk naming from a registered image so filled
        # entries point at real files (datasets are not always 06d.png)
        import re
        m = re.fullmatch(r"(.*?)(\d+)(\.[A-Za-z0-9]+)",
                         fallback["file_path"].rsplit("/", 1)[-1])
        if m:
            num_off = int(m.group(2)) - fallback["colmap_im_id"]
            width = len(m.group(2))

            def _name(i):
                return f"{m.group(1)}{i + num_off:0{width}d}{m.group(3)}"
        else:
            def _name(i):
                return f"{i:06d}.png"
        for i in range(max(start_idx, min(have)), max(have)):
            if i not in have:
                frames.append({
                    "file_path": f"{image_dir}/{_name(i)}",
                    "transform_matrix": fallback["transform_matrix"],
                    "colmap_im_id": i,
                })

    out["frames"] = sorted(frames, key=lambda f: f["colmap_im_id"])
    applied = np.eye(4)[:3, :]
    applied = applied[np.array([0, 2, 1]), :]
    applied[2, :] *= -1
    out["applied_transform"] = applied.tolist()

    with open(output_dir / "transforms.json", "w", encoding="utf-8") as f:
        json.dump(out, f, indent=4)
    return output_dir / "transforms.json"


def prepare_clips(recon_dir, output_dir, clips, intrinsic_scale=1.0,
                  image_dir="../../images", variant="ours"):
    """Batch prepare: one transforms.json per [start, end) clip range.

    The reference's `nerf_prepare_batch.py:246-258` loop — each clip of a
    long in-the-wild sequence becomes `select_{s}_{e}/{variant}/` so
    `nerf/train.train_clips` can sweep them. Returns {clip_name: path}.
    """
    out = {}
    for start_idx, end_idx in clips:
        clip_dir = (Path(output_dir) / f"select_{start_idx}_{end_idx}"
                    / variant)
        out[f"select_{start_idx}_{end_idx}"] = generate_nf_transform(
            recon_dir, clip_dir, start_idx=start_idx, end_idx=end_idx,
            intrinsic_scale=intrinsic_scale,
            image_dir=f"../{image_dir}")
    return out
