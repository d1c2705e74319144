"""The whole chain on the CPU: video frames on disk -> the port's
`demo.run` -> COLMAP export -> `prepare` -> NeRF training -> held-out PSNR
and ATE (`eval/recon_e2e.py`), with cv2 blocked (frames are PNGs through
`io/png.py`), at 12 frames of 48x64 and 5 NeRF steps.

Every stage hands off: a pose per frame and a finite ATE, the COLMAP
binary model reads back (12 images, one camera), the transforms.json
covers the sequence and is byte for byte what the JAX package's
`prepare` writes from the port's model, the NeRF PSNRs are finite, the
clip preparation and the training sweep find their clips; the
ground-truth pose control (`gt_pose_nerf`) trains on the same frames
through its own export.
"""

import json
import sys

import numpy as np
import pytest
import torch

from wild_video_3d_reconstruction_torch.eval import recon_e2e
from wild_video_3d_reconstruction_torch.io import colmap_model
from wild_video_3d_reconstruction_torch.nerf import prepare, train
from wild_video_3d_reconstruction_torch.train.synth import render_sequence
from wild_video_3d_reconstruction_tpu.nerf import prepare as jprep

FRAMES = 12


@pytest.mark.parametrize("refine", [True, False])
def test_recon_pipeline_end_to_end(tmp_path, monkeypatch, refine):
    monkeypatch.setitem(sys.modules, "cv2", None)     # import raises
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    scene = render_sequence(0, frames=FRAMES, ht=48, wd=64, path="walk")
    try:
        rep = recon_e2e.run(frames=FRAMES, nerf_steps=5,
                            workdir=str(tmp_path), refine=refine,
                            device="cpu", scene=scene)
        gt = recon_e2e.gt_pose_nerf(scene, tmp_path, refine, 5, "cpu")
    finally:
        torch.set_num_threads(n)
    monkeypatch.delitem(sys.modules, "cv2")
    assert rep["n_aligned"] == FRAMES and rep["refine"] == refine
    assert np.isfinite(rep["ate_rmse"]) and rep["ate_floor_identity"] > 0
    assert set(rep["seconds"]) == {"render", "vo", "export", "prepare",
                                   "nerf", "eval"}
    assert (tmp_path / "images" / "frame_000011.png").exists()
    assert (tmp_path / "output" / "saved_trajectories" /
            "images.txt").exists()

    recon = tmp_path / "output" / "colmap_images" / "colmap" / "sparse" / "0"
    cameras, images, _ = colmap_model.read_model(recon)
    assert len(images) == FRAMES and len(cameras) == 1

    tf = tmp_path / "output" / "nerf" / "transforms.json"
    meta = json.loads(tf.read_text())
    assert sorted(f["colmap_im_id"] for f in meta["frames"]) == \
        list(range(1, FRAMES + 1))
    for k in ("fl_x", "fl_y", "cx", "cy", "w", "h", "applied_transform"):
        assert k in meta
    ref = jprep.generate_nf_transform(recon, tmp_path / "jax_nerf",
                                      image_dir="../../images")
    assert tf.read_bytes() == ref.read_bytes()

    assert np.isfinite(rep["psnr"]) and rep["psnr"] > 5.0
    assert np.isfinite(rep["psnr_init"])
    assert gt["psnr"] > 5.0 and "psnr_aligned" not in gt
    assert json.loads((tmp_path / "gt" / "nerf" / "transforms.json")
                      .read_text())["frames"][0]["file_path"] == \
        "../../images/frame_000000.png"
    if refine:
        assert np.isfinite(rep["psnr_aligned"])
        assert np.isfinite(rep["pose_delta_rms"])
        return
    out = prepare.prepare_clips(recon, tmp_path / "clips",
                                [(1, 6), (6, FRAMES)])
    assert sorted(out) == ["select_1_6", f"select_6_{FRAMES}"]
    assert len(json.loads(out["select_1_6"].read_text())["frames"]) == 6
    res = train.train_clips(tmp_path / "clips", native_fallback=False)
    assert sorted(res) == ["select_1_6/ours", f"select_6_{FRAMES}/ours"]
