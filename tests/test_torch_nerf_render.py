"""The port's `nerf/render.py` and `nerf/prepare.py` against the JAX
package, on the CPU.

* `prepare.generate_nf_transform` writes a transforms.json byte for byte
  the JAX package's from the same COLMAP model (also `prepare_clips`).
* `interpolate_path`: equal to the JAX package's (tolerance 0), and its
  properties (keyframes hit, rotations orthonormal).
* `save_field` / `load_field` round trip (plain and refined; a step
  directory or its parent), tensors equal; the metadata file byte for
  byte what the JAX package writes for the same dict.
* `render_path` and `export_pointcloud` against the JAX functions on the
  same converted field (the renderer's fine uniforms injected): frames
  within 1 of 255 (a rounding step of 1e-6), points 1e-4, colours
  within 1; the PNGs read back equal to the returned frames; the CLI.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from wild_video_3d_reconstruction_torch.io import colmap_model as tcm  # noqa: E402
from wild_video_3d_reconstruction_torch.io import export as texport  # noqa: E402
from wild_video_3d_reconstruction_torch.io import png  # noqa: E402
from wild_video_3d_reconstruction_torch.nerf import ngp as tngp  # noqa: E402
from wild_video_3d_reconstruction_torch.nerf import prepare as tprep  # noqa: E402
from wild_video_3d_reconstruction_torch.nerf import render as trender  # noqa: E402
from wild_video_3d_reconstruction_tpu.nerf import prepare as jprep  # noqa: E402
from wild_video_3d_reconstruction_tpu.nerf import render as jrender  # noqa: E402
from wild_video_3d_reconstruction_tpu.nerf import (  # noqa: E402
    train_native as jtn)

from test_torch_nerf import jax_field, jax_render_u  # noqa: E402


def _model(tmp_path, n=9, missing=(4,)):
    """A COLMAP binary model of n images (some ids left out) written by
    the port's exporter."""
    rng = np.random.default_rng(0)
    poses = np.zeros((n, 7))
    poses[:, :3] = rng.normal(size=(n, 3))
    q = rng.normal(size=(n, 4))
    poses[:, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    keep = [i for i in range(n) if i not in missing]
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (30, 3)).astype(np.uint8)
    out = texport.save_output_for_colmap(
        str(tmp_path / "colmap_x"), poses[keep], np.asarray(keep, float),
        pts, cols, 40.0, 41.0, 32.0, 24.0, 48, 64)
    return out


def test_prepare_transforms_json_byte_identical_to_jax(tmp_path):
    recon = _model(tmp_path)
    a = tprep.generate_nf_transform(recon, tmp_path / "t", start_idx=1,
                                    end_idx=8, intrinsic_scale=0.5)
    b = jprep.generate_nf_transform(recon, tmp_path / "j", start_idx=1,
                                    end_idx=8, intrinsic_scale=0.5)
    assert a.read_bytes() == b.read_bytes()
    ids = [f["colmap_im_id"] for f in json.loads(a.read_text())["frames"]]
    assert ids == sorted(ids) and len(ids) >= 7
    ta = tprep.prepare_clips(recon, tmp_path / "tc", [(1, 4), (4, 9)])
    ja = jprep.prepare_clips(recon, tmp_path / "jc", [(1, 4), (4, 9)])
    assert sorted(ta) == sorted(ja) == ["select_1_4", "select_4_9"]
    for k in ta:
        assert ta[k].read_bytes() == ja[k].read_bytes()


def test_interpolate_path_equals_jax_and_its_properties():
    rng = np.random.default_rng(0)
    keys = []
    for _ in range(4):
        c2w = np.eye(4)
        c2w[:3, :3] = tngp.rodrigues(torch.tensor(
            rng.normal(size=3) * 0.3, dtype=torch.float32)).numpy()
        c2w[:3, 3] = rng.normal(size=3)
        keys.append(c2w)
    path = trender.interpolate_path(keys, 13)
    np.testing.assert_array_equal(path, jrender.interpolate_path(keys, 13))
    assert path.shape == (13, 4, 4)
    np.testing.assert_allclose(path[0], keys[0], atol=1e-9)
    np.testing.assert_allclose(path[-1], keys[-1], atol=1e-9)
    np.testing.assert_allclose(path[4], keys[1], atol=1e-9)
    for c2w in path:
        R = c2w[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
    looped = trender.interpolate_path(keys, 8, loop=True)
    np.testing.assert_array_equal(looped,
                                  jrender.interpolate_path(keys, 8, loop=True))
    assert not np.allclose(looped[-1], keys[-1])


def _meta(refine, center, scale, app_dim=0, n_train=0):
    return dict(refine=refine, contract=False, levels=2, table_size=2 ** 10,
                max_res=32, app_dim=app_dim, n_train=n_train,
                center=np.asarray(center).tolist(), scale=float(scale),
                near=0.02, far=1.8, convention="opencv", samples=8)


@pytest.mark.parametrize("refine", [False, True])
def test_save_load_field_round_trip(tmp_path, refine):
    field = tngp.NGPField(2, 2 ** 10, max_res=32, app_dim=4 if refine else 0,
                          generator=torch.Generator().manual_seed(0))
    params = tngp.RefinedField(field, 3) if refine else field
    if refine:
        with torch.no_grad():
            params.pose_w.normal_()
    meta = _meta(refine, [0.1, 0.2, 0.3], 0.25, 4 if refine else 0,
                 3 if refine else 0)
    step_dir = trender.save_field(params, meta, tmp_path / "f", 8)
    assert step_dir.name == "step_8"
    for path in (tmp_path / "f", step_dir):
        loaded, meta2 = trender.load_field(path, device="cpu")
        assert meta2 == meta
        for k, v in field.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
    # the sidecar is the JAX package's json.dump of the same dict
    (tmp_path / "j").mkdir()
    with open(tmp_path / "j" / trender.META_NAME, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    assert (tmp_path / "f" / trender.META_NAME).read_bytes() == \
        (tmp_path / "j" / trender.META_NAME).read_bytes()
    with pytest.raises(FileNotFoundError):
        trender.load_field(tmp_path / "nothing", device="cpu")


@pytest.mark.parametrize("refine", [False, True])
def test_render_path_and_pointcloud_match_jax(tmp_path, refine):
    images, c2ws, intrs, _ = jtn.synth_scene(seed=3, frames=5, ht=20, wd=24)
    params, static, field = jax_field(levels=2, table_size=2 ** 10,
                                      max_res=32, app_dim=4 if refine else 0)
    meta = _meta(refine, [0.0, 0.0, 1.5], 0.25, 4 if refine else 0,
                 3 if refine else 0)
    hw = images.shape[1:3]
    path = trender.interpolate_path(c2ws[:3], 3)
    ref = jrender.render_path(params, static, meta, path, intrs[0], hw,
                              out_dir=tmp_path / "j", log=lambda *a: None,
                              chunk=256)
    out = trender.render_path(field, meta, path, intrs[0], hw,
                              out_dir=tmp_path / "t", log=lambda *a: None,
                              chunk=256, fine_u=jax_render_u(32, 256))
    assert out.shape == ref.shape == (3, *hw, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref).max() <= 1
    for i in range(3):
        np.testing.assert_array_equal(
            png.read_png(tmp_path / "t" / f"{i:05d}.png")[..., ::-1], out[i])
    nj = jrender.export_pointcloud(params, static, meta, c2ws[:2], intrs[:2],
                                   hw, tmp_path / "j.ply", acc_thresh=0.0,
                                   chunk=256)
    nt = trender.export_pointcloud(field, meta, c2ws[:2], intrs[:2], hw,
                                   tmp_path / "t.ply", acc_thresh=0.0,
                                   chunk=256, fine_u=jax_render_u(32, 256))
    assert nt == nj == 2 * hw[0] * hw[1]
    pj, cj = texport.load_ply(tmp_path / "j.ply", return_colors=True)
    pt, ct = texport.load_ply(tmp_path / "t.ply", return_colors=True)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    assert np.abs(ct.astype(int) - cj).max() <= 1


def test_render_cli(tmp_path):
    field = tngp.NGPField(2, 2 ** 10, max_res=32,
                          generator=torch.Generator().manual_seed(0))
    meta = _meta(False, [0.0, 0.0, 1.5], 0.25)
    trender.save_field(field, meta, tmp_path / "f", 3)
    rep = trender.main([
        "--ckpt", str(tmp_path / "f"), "--synth", "--n", "2",
        "--out", str(tmp_path / "cli"), "--pointcloud",
        str(tmp_path / "cli.ply"), "--stride", "8", "--acc_thresh", "0.0",
        "--device", "cpu"])
    assert rep["views"] == 2 and rep["points"] > 0
    assert (tmp_path / "cli" / "00001.png").exists()
    assert np.isfinite(texport.load_ply(tmp_path / "cli.ply")).all()
