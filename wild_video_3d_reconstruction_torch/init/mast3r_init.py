"""MASt3R-style scene bootstrap for the first frames of a sequence.

Counterpart of the JAX package's `init/mast3r_init.py`, with the same two
paths and the same contract (per-frame depth maps and camera-to-world
poses, frame 0 the identity, written into the state by
`prior_init.init_from_prior`):

  mast3r_initialization     the external dust3r / mast3r alignment when
                            those packages are installed (gated import;
                            absent here), else the geometric path
  geometric_initialization  classical and weight-free: `track_grid` (LK
                            of a stride grid from frame 0 into each frame
                            on the frames' device, forward-backward
                            checked), a RANSAC 8-point essential matrix and
                            cheirality-resolved pose per frame
                            (`init/epipolar.py`), midpoint triangulation,
                            pairwise scales chained to the (0, 1) pair,
                            nearest-neighbour densified depth (numpy and
                            scipy on the host, as the JAX package)
  bootstrap_slam            either path into a `DPVO` that has taken the
                            frames, then frame 0 re-anchored

Decided difference R16: only the absence of dust3r / mast3r (ImportError)
leads to the geometric path; any other failure of the external path (on
the card, say) raises, where the JAX package prints it and carries on.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .epipolar import essential_ransac, recover_pose


def _nearest_fill(sparse, mask):
    """Fill the entries of a 2-D field outside mask from the nearest
    entry inside it."""
    if mask.all() or not mask.any():
        return sparse
    from scipy.ndimage import distance_transform_edt
    _, (iy, ix) = distance_transform_edt(~mask, return_indices=True)
    return sparse[iy, ix]


def track_grid(images, stride=8, fb_thresh=1.0, device="cuda"):
    """LK-track a stride grid from frame 0 into every other frame of
    images [K][H, W, 3] uint8 (numpy or tensors), on `device`.

    Returns (grid_xy [M, 2], tracks [K, M, 2], ok [K, M]) as numpy:
    tracks[k] the grid's coordinates in frame k, ok a forward-backward
    consistency and in-bounds mask (frame 0: the identity, all ok)."""
    from ..eval.droid_harness import lk_flow_pyramid

    H, W = images[0].shape[:2]
    ys = np.arange(stride // 2, H, stride, dtype=np.float32)
    xs = np.arange(stride // 2, W, stride, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    M = gx.size
    K = len(images)

    tracks = np.zeros((K, M, 2), np.float32)
    ok = np.zeros((K, M), bool)
    tracks[0] = np.stack([gx, gy], -1)
    ok[0] = True

    x0 = torch.as_tensor(gx, device=device)
    y0 = torch.as_tensor(gy, device=device)
    flow = torch.zeros((M, 2), device=device)
    img0 = torch.as_tensor(images[0], device=device)
    for k in range(1, K):
        imgk = torch.as_tensor(images[k], device=device)
        flow = lk_flow_pyramid(img0, imgk, x0, y0, flow)
        xk = torch.stack([x0, y0], -1) + flow
        # forward-backward check
        back = lk_flow_pyramid(imgk, img0, xk[:, 0], xk[:, 1], -flow)
        fb = (xk + back).cpu().numpy()
        xk = xk.cpu().numpy()
        err = np.linalg.norm(fb - tracks[0], axis=1)
        inb = ((xk[:, 0] >= 1) & (xk[:, 0] < W - 1) &
               (xk[:, 1] >= 1) & (xk[:, 1] < H - 1))
        tracks[k] = xk
        ok[k] = (err < fb_thresh) & inb
    return tracks[0], tracks, ok


def geometric_initialization(images, intrinsics, stride=8, ransac_iters=500,
                             seed=0, tracks=None, image_size=None,
                             device="cuda"):
    """Classical first-frame-anchored bootstrap over the given frames.

    images [K][H, W, 3] uint8, or None when `tracks` (grid_xy, tracks,
    ok), e.g. from `track_grid`, and `image_size` (H, W) are given;
    intrinsics [4] (fx, fy, cx, cy) at full resolution; device: where
    `track_grid` runs.

    Returns (depths [K, H, W] float32, poses_c2w [K, 4, 4] float32) with
    frame 0 the identity and the scale set so that the (0, 1) pair's
    median frame-0 depth is 1."""
    fx, fy, cx, cy = [float(v) for v in np.asarray(intrinsics).reshape(-1)[:4]]
    if tracks is None:
        grid, tr, ok = track_grid(images, stride=stride, device=device)
    else:
        grid, tr, ok = tracks
    if image_size is not None:
        H, W = image_size
    else:
        H, W = images[0].shape[:2]
    K = tr.shape[0]

    def norm(p):
        return np.stack([(p[:, 0] - cx) / fx, (p[:, 1] - cy) / fy], -1)

    x0n_all = norm(grid)

    poses_c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    # per grid point, the frame-0 depth each pair triangulates
    depth0 = np.full((K, grid.shape[0]), np.nan, np.float32)
    pair_R, pair_t = [None] * K, [None] * K
    ref_med = None

    for k in range(1, K):
        m = ok[k]
        if m.sum() < 16:
            raise ValueError(f"too few tracked points into frame {k} "
                             f"({int(m.sum())}) — scene too hard for the "
                             "geometric bootstrap")
        x1n = x0n_all[m]
        x2n = norm(tr[k][m])
        E, inl = essential_ransac(x1n, x2n, iters=ransac_iters,
                                  seed=seed + k)
        R, t, X = recover_pose(E, x1n[inl], x2n[inl])
        z = X[:, 2]
        good = z > 1e-6
        med = float(np.median(z[good])) if good.any() else 1.0
        if ref_med is None:
            ref_med = med
            scale = 1.0
        else:
            # chain this pair's scale to the (0, 1) pair via shared points
            sel = np.where(m)[0][inl]
            prev = depth0[1][sel]
            both = np.isfinite(prev) & good
            ratio = (np.median(prev[both] / np.maximum(z[both], 1e-9))
                     if both.sum() >= 8 else ref_med / med)
            scale = float(ratio)
        d = np.full(int(m.sum()), np.nan, np.float32)
        d[inl] = np.where(good, z * scale, np.nan)
        depth0[k][m] = d
        pair_R[k], pair_t[k] = R, t * scale
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = t * scale
        poses_c2w[k] = np.linalg.inv(w2c)

    # global scale: median frame-0 depth of the (0, 1) pair -> 1
    s = float(np.nanmedian(depth0[1]))
    if not np.isfinite(s) or s <= 0:
        s = 1.0
    depth0 /= s
    for k in range(1, K):
        poses_c2w[k][:3, 3] /= s
        pair_t[k] = pair_t[k] / s

    # densify per-frame depth maps (grid points never an inlier get the
    # global median)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        d0 = np.nanmedian(depth0, axis=0)
    d0_fill = np.where(np.isfinite(d0), d0, np.nanmedian(d0))
    pts0 = np.concatenate([x0n_all * d0_fill[:, None], d0_fill[:, None]], 1)

    depths = np.zeros((K, H, W), np.float32)
    gy = np.clip(grid[:, 1].astype(int), 0, H - 1)
    gx = np.clip(grid[:, 0].astype(int), 0, W - 1)
    sp = np.zeros((H, W), np.float32)
    mk = np.zeros((H, W), bool)
    sp[gy, gx] = d0_fill
    mk[gy, gx] = np.isfinite(d0)
    depths[0] = _nearest_fill(sp, mk)
    for k in range(1, K):
        Xk = pts0 @ pair_R[k].T + pair_t[k][None, :]
        zk = Xk[:, 2]
        uk = np.clip((Xk[:, 0] / np.maximum(zk, 1e-6) * fx + cx).astype(int),
                     0, W - 1)
        vk = np.clip((Xk[:, 1] / np.maximum(zk, 1e-6) * fy + cy).astype(int),
                     0, H - 1)
        sp = np.zeros((H, W), np.float32)
        mk = np.zeros((H, W), bool)
        vis = zk > 1e-6
        sp[vk[vis], uk[vis]] = zk[vis]
        mk[vk[vis], uk[vis]] = True
        depths[k] = _nearest_fill(sp, mk)
    return depths, poses_c2w


def mast3r_initialization(images, intrinsics, **kw):
    """The external alignment when dust3r and mast3r are installed, else
    `geometric_initialization` (the `checkpoint` keyword is the external
    path's alone; `device` serves both). Only their absence (ImportError)
    sends it to the geometric path: any other failure of the external
    path raises (ROADMAP R16)."""
    geo_kw = {k: v for k, v in kw.items() if k != "checkpoint"}
    try:
        return _mast3r_external(images, intrinsics, **kw)
    except ImportError:
        return geometric_initialization(images, intrinsics, **geo_kw)


def _mast3r_external(images, intrinsics, checkpoint=None, device="cuda",
                     **_):
    """First-frame-anchored global alignment with dust3r / mast3r (only
    where those packages exist; every import stays inside, so their
    absence raises ImportError here and nowhere else)."""
    import dust3r  # noqa: F401
    import mast3r  # noqa: F401
    from dust3r.cloud_opt import GlobalAlignerMode, global_aligner
    from dust3r.image_pairs import make_pairs
    from dust3r.inference import inference
    try:                                  # the API moved across releases
        from dust3r.inference import load_model
    except ImportError:
        from dust3r.model import AsymmetricCroCo3DStereo

        def load_model(ckpt, device):
            return AsymmetricCroCo3DStereo.from_pretrained(ckpt).to(device)

    model = load_model(checkpoint, device)
    imgs = _format_mast3r_images(images, device)
    pairs = make_pairs(imgs, scene_graph="complete", prefilter=None,
                       symmetrize=False)
    res = inference(pairs, model, device, batch_size=1)
    scene = global_aligner(res, device=device,
                           mode=GlobalAlignerMode.ModularPointCloudOptimizer)
    with torch.enable_grad():
        scene.compute_global_alignment(init="mst", niter=250,
                                       schedule="cosine", lr=0.01)
    depths = np.stack([d.detach().cpu().numpy()
                       for d in scene.get_depthmaps()])
    poses = np.stack([p.detach().cpu().numpy()
                      for p in scene.get_im_poses()])
    return depths.astype(np.float32), poses.astype(np.float32)


def _format_mast3r_images(images, device):
    """uint8 BGR frames -> the dicts dust3r's loaders produce."""
    out = []
    for i, im in enumerate(images):
        im = np.asarray(im)
        t = torch.from_numpy(np.ascontiguousarray(im[..., ::-1])).float()
        t = (t / 127.5 - 1.0).permute(2, 0, 1)[None].to(device)
        out.append(dict(img=t, true_shape=np.int32([im.shape[:2]]),
                        idx=i, instance=str(i)))
    return out


def bootstrap_slam(slam, images, intrinsics, **kw):
    """The bootstrap of `images` (the frames the DPVO `slam` has taken,
    slot k = frame k) written into its state, then frame 0 re-anchored.
    Returns (depths, poses_c2w)."""
    from .prior_init import anchor_first_frame, init_from_prior

    depths, poses_c2w = mast3r_initialization(images, intrinsics, **kw)
    init_from_prior(slam, depths, poses_c2w, range(len(images)))
    anchor_first_frame(slam)
    return depths, poses_c2w
