"""Native NeRF trainer (the in-repo `ns-train` equivalent).

The port's copy of the JAX package's `nerf/train_native.py`: it trains
the instant-NGP field of `nerf/ngp.py` on a nerfstudio `transforms.json`
(what `nerf/prepare.py` writes) or on a rendered synthetic scene, on the
card by default:

    python -m wild_video_3d_reconstruction_torch.nerf.train_native \
        --data outputs/scene/nerf  [--steps 2000] [--batch 4096]
    python -m wild_video_3d_reconstruction_torch.nerf.train_native --synth

`train` is the plain trainer, `train_refine` the nerfacto-style one
(hierarchical sampling, per-image appearance, SE(3) pose refinement,
optional contraction, test-time eval-pose alignment). Every
`--eval_every` steps it logs the loss and the held-out PSNR; the last
line is one JSON summary. The draws of each step come from a
`torch.Generator` seeded with `seed`, or are passed in (`draws=`,
`align_draws=`), as the parity tests pass the JAX package's. The JAX
package's ray-batch sharding over a device mesh belongs to multi-device
training and is not here.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..io import png
from . import ngp


def load_transforms(data_dir):
    """Read a nerfstudio transforms.json: (images [N, H, W, 3] float in
    [0, 1], c2ws [N, 4, 4], intrinsics [N, 4], convention). PNG frames
    are decoded by `io/png.py`, other formats by cv2."""
    data_dir = Path(data_dir)
    with open(data_dir / "transforms.json", encoding="utf-8") as f:
        meta = json.load(f)
    images, c2ws, intrs = [], [], []
    for fr in meta["frames"]:
        p = (data_dir / fr["file_path"]).resolve()
        if p.suffix.lower() == ".png":
            img = png.read_png(p, png.IMREAD_COLOR)
        else:
            import cv2

            img = cv2.imread(str(p), cv2.IMREAD_COLOR)
        if img is None:
            continue
        images.append(img[..., ::-1] / 255.0)
        c2ws.append(np.asarray(fr["transform_matrix"], np.float64))
        g = lambda k: fr.get(k, meta.get(k))
        intrs.append([g("fl_x"), g("fl_y"), g("cx"), g("cy")])
    if not images:
        raise FileNotFoundError(f"no readable frames under {data_dir}")
    return (np.asarray(images, np.float32), np.asarray(c2ws),
            np.asarray(intrs, np.float64), "opengl")


def synth_scene(seed=7, frames=16, ht=48, wd=64, fx=40.0, fy=40.0):
    """Rendered multi-plane orbit scene with exact poses (w2c -> c2w).
    The focal lengths default to the renderer's (the JAX package's scene);
    a larger frame keeps the same field of view with fx, fy scaled by its
    width (at 384x512: 320)."""
    from ..train.synth import render_sequence

    images, poses_w2c, intr = render_sequence(seed, frames=frames, ht=ht,
                                              wd=wd, fx=fx, fy=fy,
                                              path="orbit", n_planes=3)
    c2ws = []
    for p in poses_w2c:
        t, q = p[:3], p[3:]
        x, y, z, w = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        c2ws.append(c2w)
    intrs = np.tile(np.asarray(intr, np.float64), (len(images), 1))
    return (images.astype(np.float32) / 255.0, np.asarray(c2ws), intrs,
            "opencv")


def build_rays(images, c2ws, intrs, convention, content_depth=3.0):
    """Flattened, scene-normalized ray dataset [N, 9] = (o, d, rgb),
    plus (center, scale, near, far) of the unit-cube parameterization."""
    h, w = images.shape[1:3]
    # normalize cameras + a content sample along each view axis into the
    # unit cube so the hash grid covers what the rays actually see
    pts = [c[:3, 3] for c in c2ws]
    fwd_sign = -1.0 if convention == "opengl" else 1.0
    for c in c2ws:
        fwd = fwd_sign * c[:3, 2]
        pts.append(c[:3, 3] + content_depth * fwd)
    center, scale = ngp.normalize_scene(np.asarray(pts))

    rays = []
    for img, c2w, intr in zip(images, c2ws, intrs):
        o, d = ngp.camera_rays(c2w, intr, (h, w), convention)
        o = (o.numpy() - center) * scale + 0.5
        rays.append(np.concatenate([o, d.numpy(), img.reshape(-1, 3)],
                                   axis=-1))
    near, far = 0.02, 1.8          # spans the unit cube diagonal
    return np.asarray(rays, np.float32), center, scale, near, far


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-10))


def _holdout(n_imgs, holdout):
    eval_ids = list(range(holdout - 1, n_imgs, holdout)) or [n_imgs - 1]
    return eval_ids, [i for i in range(n_imgs) if i not in eval_ids]


def train(images, c2ws, intrs, convention, steps=2000, batch=4096,
          n_samples=64, levels=8, table_size=2 ** 14, max_res=256,
          lr=1e-2, eval_every=500, holdout=8, seed=0, log=print,
          device="cuda", field=None, draws=None, step_hook=None):
    """Train the plain field; returns (NGPField, report dict).

    Each step samples `batch` training rays and a stratified jitter per
    sample from a generator seeded `seed` on `device`, or takes them from
    `draws` (an iterable of (ray index [batch], jitter [batch,
    n_samples]) per step). `field`: the initial field (default: an
    `NGPField` drawn from a CPU generator seeded `seed`). `step_hook(s,
    loss)` is called after every step with its loss (a device scalar)."""
    all_rays, center, scale, near, far = build_rays(images, c2ws, intrs,
                                                    convention)
    n_imgs = all_rays.shape[0]
    eval_ids, train_ids = _holdout(n_imgs, holdout)
    rays = ngp.as_device(all_rays[train_ids].reshape(-1, 9), device)

    if field is None:
        field = ngp.NGPField(levels, table_size, max_res=max_res,
                             generator=torch.Generator().manual_seed(seed))
    field = field.to(device)
    opt = ngp.make_optimizer(field, lr)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = iter(draws) if draws is not None else None

    def step_fn():
        if draws is None:
            idx = torch.randint(0, rays.shape[0], (batch,), generator=gen,
                                device=device)
            jitter = None
        else:
            idx, jitter = next(draws)
            idx = ngp.as_device(idx, device, torch.long)
        b = rays[idx]
        rgb, _, _ = ngp.render_rays(field, b[:, 0:3], b[:, 3:6], gen,
                                    n_samples=n_samples, near=near, far=far,
                                    jitter=jitter)
        loss = torch.mean((rgb - b[:, 6:9]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    def tr(o, d):
        return ngp.to_unit(o, center, scale), d

    def eval_psnr():
        vals = []
        for i in eval_ids:
            img, _ = ngp.render_image(field, c2ws[i], intrs[i],
                                      images.shape[1:3], n_samples=n_samples,
                                      near=near, far=far,
                                      convention=convention,
                                      scene_transform=tr)
            vals.append(psnr(img, images[i]))
        return float(np.mean(vals))

    psnr0 = eval_psnr()
    log(f"init: held-out PSNR {psnr0:.2f} dB "
        f"({len(train_ids)} train / {len(eval_ids)} eval views)")
    t0 = time.time()
    for s in range(1, steps + 1):
        loss = step_fn()
        if step_hook is not None:
            step_hook(s, loss)
        if s % eval_every == 0 or s == steps:
            p = eval_psnr()
            log(f"step {s}: loss={float(loss):.5f} "
                f"psnr={p:.2f} dB ({time.time() - t0:.0f}s)")
    psnr1 = eval_psnr()
    report = {"metric": "nerf_native", "steps": steps,
              "psnr_init": round(psnr0, 3), "psnr": round(psnr1, 3),
              "train_views": len(train_ids), "eval_views": len(eval_ids),
              "seconds": round(time.time() - t0, 1)}
    return field, {**report, "center": center, "scale": scale,
                   "near": near, "far": far}


def train_refine(images, c2ws, intrs, convention, steps=2000, batch=4096,
                 n_coarse=32, n_fine=32, levels=8, table_size=2 ** 14,
                 max_res=256, lr=1e-2, eval_every=500, holdout=8, seed=0,
                 log=print, app_dim=8, pose_lr=3e-4, pose_reg=0.1,
                 contraction=False, refine_pose=True, content_depth=3.0,
                 eval_align=False, align_steps=60, eval_gauge="interp",
                 device="cuda", field=None, draws=None, align_draws=None,
                 fine_u=None, step_hook=None):
    """The nerfacto-equivalent trainer: hierarchical sampling, per-image
    appearance embeddings, learned SE(3) pose refinement and optional
    unbounded-scene contraction; rays are made inside the step from
    (image, pixel) indices so pose gradients flow.

    Pose refinement matters because upstream poses come from SLAM, not
    SfM. An L2 penalty `pose_reg` anchors the refined poses to the input
    trajectory, and after every update the common-mode pose delta is
    removed (the gauge projection). Held-out views render with a zero
    appearance embedding, from their input poses moved by the
    interpolated deltas of their neighbouring training views
    (eval_gauge="interp", for smooth drift that train and eval views
    share) or from the input poses as they are ("raw", for independent
    per-view noise with trusted eval poses). eval_align=True also scores
    each held-out view after `align_steps` Adam(2e-3) steps of its own
    SE(3) delta against the frozen field (`psnr_aligned`).

    Draws: per step (pixel index [batch], coarse jitter [batch,
    n_coarse], fine uniforms [batch, n_fine]) from a generator seeded
    `seed` on `device`, or from `draws`; per alignment step (pixel index
    [1024] and the same two) from one seeded seed + 1, or from
    `align_draws` (all views' steps in order). `fine_u`: the renderer's
    fine uniforms (`ngp.render_image`). `step_hook(s, mse)` is called
    after every step. Returns (RefinedField, report)."""
    n_imgs, h, w = images.shape[:3]
    eval_ids, train_ids = _holdout(n_imgs, holdout)
    train_ids = np.asarray(train_ids)

    # scene normalization: cameras + a content point per view
    pts = [c[:3, 3] for c in c2ws]
    fwd_sign = -1.0 if convention == "opengl" else 1.0
    for c in c2ws:
        pts.append(c[:3, 3] + content_depth * fwd_sign * c[:3, 2])
    if contraction:
        # cameras + content inside the unit ball; background contracts
        pos = np.asarray(pts, np.float64)
        center = (pos.max(0) + pos.min(0)) / 2.0
        scale = 0.8 / max(float(np.abs(pos - center).max()), 1e-6)
        near, far, offset = 0.02, 64.0, 0.0
    else:
        center, scale = ngp.normalize_scene(np.asarray(pts))
        near, far, offset = 0.02, 1.8, 0.5

    def to_norm(o):
        return ngp.to_unit(o, center, scale, offset)

    f32 = torch.float32
    c2ws_np = np.asarray(c2ws)
    Rs = ngp.as_device(c2ws_np[train_ids, :3, :3], device, f32)
    ts = ngp.as_device(
        np.stack([to_norm(c[:3, 3]) for c in c2ws_np[train_ids]]), device, f32)
    intr_t = ngp.as_device(np.asarray(intrs)[train_ids], device, f32)
    pix = ngp.as_device(images[train_ids].reshape(-1, 3), device, f32)

    n_train = len(train_ids)
    if field is None:
        field = ngp.NGPField(levels, table_size, max_res=max_res,
                             app_dim=app_dim,
                             generator=torch.Generator().manual_seed(seed))
    params = ngp.RefinedField(field, n_train).to(device)
    # pose lr: frozen while the field is still random (joint optimization
    # from a random field lets poses wander), then cosine-decayed
    fp = params.field
    mlp = [p for n, p in fp.named_parameters() if n != "table"]
    opt = ngp.Adam([
        ([fp.table], lr, 0.9, 0.99, 1e-15),
        (mlp + [params.app], lr * 0.3, 0.9, 0.99, 1e-15),
        ([params.pose_w, params.pose_t],
         ngp.pose_schedule(pose_lr, steps, refine_pose), 0.9, 0.999, 1e-8)])
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = iter(draws) if draws is not None else None

    y_sign = -1.0 if convention == "opengl" else 1.0
    z_sign = -1.0 if convention == "opengl" else 1.0

    def make_rays(idx):
        """Per-pixel rays with refined poses (differentiable in them)."""
        ii = idx // (h * w)
        r = idx % (h * w)
        v = (r // w).to(f32) + 0.5
        u = (r % w).to(f32) + 0.5
        fx, fy, cx, cy = [intr_t[ii, k] for k in range(4)]
        dcam = torch.stack([(u - cx) / fx, y_sign * (v - cy) / fy,
                            z_sign * torch.ones_like(u)], -1)
        R = Rs[ii] @ ngp.rodrigues(params.pose_w[ii])
        d = torch.einsum("nij,nj->ni", R, dcam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = ts[ii] + params.pose_t[ii]
        return o, d, pix[idx], params.app[ii]

    def step_fn():
        if draws is None:
            idx = torch.randint(0, n_train * h * w, (batch,), generator=gen,
                                device=device)
            u_c = u_f = None
        else:
            idx, u_c, u_f = next(draws)
            idx = ngp.as_device(idx, device, torch.long)
        o, d, target, app = make_rays(idx)
        rgb, _, _ = ngp.render_rays_hier(
            fp, o, d, gen, n_coarse=n_coarse, n_fine=n_fine, near=near,
            far=far, app=app, contraction=contraction, u_coarse=u_c,
            u_fine=u_f)
        mse = torch.mean((rgb - target) ** 2)
        reg = torch.mean(params.pose_w ** 2) + torch.mean(params.pose_t ** 2)
        opt.zero_grad()
        (mse + pose_reg * reg).backward()
        opt.step()
        # gauge projection: remove the common-mode pose delta each step. A
        # global shift / rotation of all training cameras is invisible to
        # the photometric loss (the field absorbs it) but de-registers the
        # field from the unrefined held-out poses
        with torch.no_grad():
            params.pose_t.sub_(params.pose_t.mean(0))
            params.pose_w.sub_(params.pose_w.mean(0))
        return mse.detach()

    zero_app = np.zeros((app_dim,), np.float32)
    train_pos = {int(t): k for k, t in enumerate(train_ids)}

    def _holdout_correction(i):
        """Held-out view i in the refined gauge: the linear interpolation
        of its neighbouring train views' learned SE(3) deltas."""
        lo = [t for t in train_pos if t < i]
        hi = [t for t in train_pos if t > i]
        a = max(lo) if lo else min(hi)
        b = min(hi) if hi else max(lo)
        al = 0.0 if a == b else (i - a) / float(b - a)
        pw = params.pose_w.detach().cpu().numpy()
        pt = params.pose_t.detach().cpu().numpy()
        wA, wB = pw[train_pos[a]], pw[train_pos[b]]
        tA, tB = pt[train_pos[a]], pt[train_pos[b]]
        return (1 - al) * wA + al * wB, (1 - al) * tA + al * tB

    def render(c2w_i, i, tr):
        img, _ = ngp.render_image(
            fp, c2w_i, intrs[i], (h, w), n_samples=n_coarse, n_fine=n_fine,
            near=near, far=far, convention=convention, scene_transform=tr,
            hier=True, contraction=contraction, app=zero_app, fine_u=fine_u)
        return psnr(img, images[i])

    def rot(wv):
        return ngp.rodrigues(torch.as_tensor(wv, dtype=f32)).numpy()

    def eval_psnr():
        vals = []
        for i in eval_ids:
            if refine_pose and eval_gauge == "interp":
                dw, dt = _holdout_correction(i)
                c2w_i = np.array(c2ws[i], np.float64)
                c2w_i[:3, :3] = c2w_i[:3, :3] @ rot(dw)
                tr = (lambda dt_: lambda o, d: (
                    to_norm(o) + torch.as_tensor(dt_, device=o.device),
                    d))(dt)
            else:
                c2w_i = c2ws[i]
                tr = lambda o, d: (to_norm(o), d)
            vals.append(render(c2w_i, i, tr))
        return float(np.mean(vals))

    psnr0 = eval_psnr()
    log(f"init: held-out PSNR {psnr0:.2f} dB ({n_train} train / "
        f"{len(eval_ids)} eval views, refine={refine_pose}, "
        f"contract={contraction})")
    t0 = time.time()
    for s in range(1, steps + 1):
        mse = step_fn()
        if step_hook is not None:
            step_hook(s, mse)
        if s % eval_every == 0 or s == steps:
            p = eval_psnr()
            log(f"step {s}: mse={float(mse):.5f} psnr={p:.2f} dB "
                f"({time.time() - t0:.0f}s)")
    psnr1 = eval_psnr()

    psnr_al = None
    if eval_align:
        psnr_al = _eval_align(
            fp, images, c2ws, intrs, eval_ids, to_norm, scale,
            (y_sign, z_sign), align_steps, app_dim, seed, device,
            align_draws, render, dict(n_coarse=n_coarse, n_fine=n_fine,
                                      near=near, far=far,
                                      contraction=contraction))
        log(f"eval-pose-aligned held-out PSNR {psnr_al:.2f} dB "
            f"(raw {psnr1:.2f})")

    pw = params.pose_w.detach().cpu().numpy()
    pt = params.pose_t.detach().cpu().numpy()
    pose_mag = float(np.sqrt(np.mean(pw ** 2 + pt ** 2)))
    report = {"metric": "nerf_refine", "steps": steps,
              "psnr_init": round(psnr0, 3), "psnr": round(psnr1, 3),
              "pose_delta_rms": round(pose_mag, 5),
              "train_views": n_train, "eval_views": len(eval_ids),
              "seconds": round(time.time() - t0, 1)}
    if psnr_al is not None:
        report["psnr_aligned"] = round(psnr_al, 3)
    return params, {**report, "center": center, "scale": scale,
                    "near": near, "far": far}


def _eval_align(field, images, c2ws, intrs, eval_ids, to_norm, scale,
                signs, align_steps, app_dim, seed, device, align_draws,
                render, kw):
    """Test-time eval-pose alignment (the nerfstudio eval protocol): with
    correlated SLAM drift the training poses converge to a
    self-consistent but shifted registration, so scoring from raw eval
    poses under-reports the field. Each held-out view optimizes its own
    SE(3) delta [w, t] (Adam 2e-3, 1024 pixels a step) against the frozen
    field, then renders from the moved pose. Only the held-out views'
    pixels go to the device."""
    n_imgs, h, w = images.shape[:3]
    f32 = torch.float32
    y_sign, z_sign = signs
    eidx = np.asarray(eval_ids)
    c2ws_np = np.asarray(c2ws)
    ev_Rs = ngp.as_device(c2ws_np[eidx, :3, :3], device, f32)
    ev_ts = ngp.as_device(
        np.stack([to_norm(c2ws_np[i][:3, 3]) for i in eval_ids]), device, f32)
    ev_intr = ngp.as_device(np.asarray(intrs)[eidx], device, f32)
    pix_all = ngp.as_device(images.reshape(n_imgs, h * w, 3)[eidx], device,
                            f32)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    draws = iter(align_draws) if align_draws is not None else None
    zeros_app = torch.zeros((1024, app_dim), device=device)

    def align_loss(wt, i):
        if draws is None:
            idx = torch.randint(0, h * w, (1024,), generator=gen,
                                device=device)
            u_c = u_f = None
        else:
            idx, u_c, u_f = next(draws)
            idx = ngp.as_device(idx, device, torch.long)
        v = (idx // w).to(f32) + 0.5
        u = (idx % w).to(f32) + 0.5
        fx, fy, cx, cy = [ev_intr[i, k] for k in range(4)]
        dcam = torch.stack([(u - cx) / fx, y_sign * (v - cy) / fy,
                            z_sign * torch.ones_like(u)], -1)
        R = ev_Rs[i] @ ngp.rodrigues(wt[:3])
        d = dcam @ R.T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = (ev_ts[i] + wt[3:]).expand(d.shape)
        rgb, _, _ = ngp.render_rays_hier(field, o, d, gen, app=zeros_app,
                                         u_coarse=u_c, u_fine=u_f, **kw)
        return torch.mean((rgb - pix_all[i, idx]) ** 2)

    vals = []
    tr = lambda o, d: (to_norm(o), d)
    for pos, i in enumerate(eval_ids):
        wt = torch.zeros(6, device=device, requires_grad=True)
        opt = ngp.Adam([([wt], 2e-3, 0.9, 0.999, 1e-8)])
        for _ in range(align_steps):
            wt.grad, = torch.autograd.grad(align_loss(wt, pos), [wt])
            opt.step()
        wtn = wt.detach().cpu().numpy().astype(np.float64)
        c2w_i = np.asarray(c2ws[i], np.float64).copy()
        c2w_i[:3, :3] = c2w_i[:3, :3] @ ngp.rodrigues(
            torch.as_tensor(wtn[:3], dtype=f32)).numpy().astype(np.float64)
        c2w_i[:3, 3] = c2w_i[:3, 3] + wtn[3:] / scale
        vals.append(render(c2w_i, i, tr))
    return float(np.mean(vals))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=str, default=None,
                    help="directory containing transforms.json")
    ap.add_argument("--synth", action="store_true",
                    help="train on a rendered synthetic orbit scene")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--table_log2", type=int, default=14)
    ap.add_argument("--max_res", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--render", type=str, default=None,
                    help="write a rendered held-out view PNG here")
    ap.add_argument("--refine", action="store_true",
                    help="nerfacto-style trainer: hierarchical sampling, "
                         "appearance embeddings, pose refinement")
    ap.add_argument("--contract", action="store_true",
                    help="unbounded-scene contraction (with --refine)")
    ap.add_argument("--app_dim", type=int, default=8)
    ap.add_argument("--pose_lr", type=float, default=3e-4)
    ap.add_argument("--pose_reg", type=float, default=0.1)
    ap.add_argument("--eval_align", action="store_true",
                    help="optimize a per-eval-view SE(3) delta against "
                         "the frozen field before scoring (nerfstudio "
                         "eval protocol); reports psnr_aligned")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.synth or args.data is None:
        data = synth_scene()
    else:
        data = load_transforms(args.data)
    images, c2ws, intrs, conv = data

    if args.refine:
        params, rep = train_refine(
            images, c2ws, intrs, conv, steps=args.steps,
            batch=args.batch, n_coarse=args.samples, levels=args.levels,
            table_size=2 ** args.table_log2, max_res=args.max_res,
            lr=args.lr, eval_every=args.eval_every, app_dim=args.app_dim,
            pose_lr=args.pose_lr, pose_reg=args.pose_reg,
            contraction=args.contract, eval_align=args.eval_align,
            device=args.device)
        field = params.field
    else:
        params, rep = train(images, c2ws, intrs, conv, steps=args.steps,
                            batch=args.batch, n_samples=args.samples,
                            levels=args.levels,
                            table_size=2 ** args.table_log2,
                            max_res=args.max_res, lr=args.lr,
                            eval_every=args.eval_every, device=args.device)
        field = params
    center, scale = rep.pop("center"), rep.pop("scale")
    near, far = rep.pop("near"), rep.pop("far")

    if args.save:
        from .render import save_field

        meta = dict(
            refine=bool(args.refine), contract=bool(args.contract),
            levels=args.levels, table_size=2 ** args.table_log2,
            max_res=args.max_res,
            app_dim=args.app_dim if args.refine else 0,
            n_train=(int(params.app.shape[0]) if args.refine else 0),
            center=np.asarray(center).tolist(), scale=float(scale),
            near=float(near), far=float(far), convention=conv,
            samples=args.samples)
        save_field(params, meta, args.save, args.steps)
        print("saved field params + meta to", args.save)
    if args.render:
        offset = 0.0 if args.refine and args.contract else 0.5
        tr = lambda o, d: (ngp.to_unit(o, center, scale, offset), d)
        img, depth = ngp.render_image(field, c2ws[-1], intrs[-1],
                                      images.shape[1:3],
                                      n_samples=args.samples, near=near,
                                      far=far, convention=conv,
                                      scene_transform=tr,
                                      hier=args.refine,
                                      contraction=args.contract,
                                      app=(np.zeros(args.app_dim,
                                                    np.float32)
                                           if args.refine else None))
        from .render import write_image

        write_image(args.render,
                    (np.clip(img, 0, 1) * 255).astype(np.uint8)[..., ::-1])
        print("wrote", args.render)
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
