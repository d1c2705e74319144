"""Camera self-calibration when no calib file is given.

Counterpart of the JAX package's `init/colmap_init.py`: select sharp,
well-separated frames, match keypoints between consecutive ones, and
recover pinhole intrinsics (focal by the Bougnoux closed form, refined on
the essential-model residual; principal point at the image centre).

  select_frames      greedy selection over in-memory frames on their
                     device: Farneback mean flow (2.0 px at 512-wide
                     scale) since the last selected frame, then the
                     sharpest fraction by Laplacian variance
                     (`init/farneback.py`, the port's counterpart of the
                     JAX package's cv2 calls)
  select_keyframes   the same over an image directory (read through
                     `io/stream.py`), returning file names
  match_frames       fp32 VONet matching features, Shi-Tomasi keypoints
                     and mutual nearest neighbours between consecutive
                     frames (`loop/keypoints.py`), on the frames' device
  estimate_focal, calibration_confidence, _essential_residual
                     numpy copies of the JAX package's
  run_colmap_initialization
                     the entry point: writes `estimated_calib.txt` and
                     `calib_confidence.json` under `path`

When every pair is Bougnoux-degenerate, the focal grid is scored with
cv2's 5-point `findEssentialMat` + `recoverPose`, as in the JAX package
(OpenCV imported there only: the card's machine has 4.13; without it
that fallback raises ImportError).

If pycolmap is installed, its incremental SfM is tried first (a gated
import, as in the JAX package). Decided difference R16: only pycolmap's
absence leads on to the two-view path; a failure inside it raises, where
the JAX package prints it and carries on. Entry points run on cuda unless
the caller asks for the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..io.stream import require_cv2
from .epipolar import focal_from_fundamental, fundamental_ransac
from .farneback import (bgr_to_gray, farneback_flow, laplacian_var,
                        resize_linear)

FLOW_WIDTH = 512.0              # the flow threshold's reference width


def select_frames(frames, max_frames=50, flow_thresh=2.0, sharp_frac=0.75,
                  device="cuda"):
    """Indices of the selected frames of an iterable of uint8 [H, W, 3]
    BGR frames (numpy or tensors), read lazily: a frame is taken when its
    mean Farneback flow from the last taken one, at 512-wide scale,
    exceeds flow_thresh (the first always); taking stops at
    int(max_frames / sharp_frac); then the sharpest sharp_frac are kept,
    in order, at most max_frames."""
    selected = []
    prev_gray = None
    for i, img in enumerate(frames):
        img = torch.as_tensor(img, device=device)
        h, w = img.shape[:2]
        # large frames go down to 512 wide for the flow, never up
        scale = min(1.0, FLOW_WIDTH / max(h, w))
        small = resize_linear(img, scale) if scale < 1.0 else img
        gray = bgr_to_gray(small)
        if prev_gray is None:
            take = True
        else:
            flow = farneback_flow(prev_gray, gray)
            to_512 = (FLOW_WIDTH / max(h, w)) / scale
            take = float(torch.linalg.norm(flow, dim=-1).mean()) * to_512 \
                > flow_thresh
        if take:
            selected.append((i, float(laplacian_var(gray))))
            prev_gray = gray
        if len(selected) >= int(max_frames / sharp_frac):
            break
    if len(selected) > max_frames:
        thresh = np.quantile([s for _, s in selected], 1 - sharp_frac)
        selected = [(i, s) for i, s in selected if s >= thresh][:max_frames]
    return [i for i, _ in selected]


def _read(files):
    from ..io.stream import read_image

    for f in files:
        img = read_image(f)
        if img is None:
            raise OSError(f"cannot read {f}")
        yield img


def select_keyframes(imagedir, skip=0, max_frames=50, flow_thresh=2.0,
                     sharp_frac=0.75, device="cuda"):
    """`select_frames` over the images of a directory: their file names."""
    from ..io.stream import list_images

    files = list_images(imagedir, skip=skip)
    if not files:
        raise FileNotFoundError(f"no images in {imagedir}")
    idx = select_frames(_read(files), max_frames, flow_thresh, sharp_frac,
                        device)
    return [str(files[i]) for i in idx]


def match_frames(images, net=None, max_kpts=1024, device="cuda"):
    """Keypoint matches between consecutive uint8 [H, W, 3] frames,
    cropped to a multiple of 16: ([(p0 [K, 2], p1 [K, 2]) numpy], (h, w)).
    net: a `VONet` (or what `as_vonet` takes): the descriptors are the
    fp32 matching features, meaningful only with trained weights."""
    from ..loop import keypoints as kp
    from ..models.convert import as_vonet
    from ..models.vonet import encode_frame

    net = as_vonet(net).to(device).eval()
    feats = []
    for img in images:
        img = torch.as_tensor(img, device=device)
        h, w = img.shape[:2]
        img = img[:h - h % 16, :w - w % 16]
        fmap = encode_frame(net, img, torch.float32).fmap
        xy, score = kp.detect(img, max_kpts)
        feats.append((xy, score > 0, kp.describe(fmap, xy),
                      tuple(img.shape[:2])))
    pairs = []
    for a, b in zip(feats[:-1], feats[1:]):
        i0, i1, ok = kp.match(a[2], b[2], a[1], b[1])
        pairs.append((a[0][i0[ok]].cpu().numpy(),
                      b[0][i1[ok]].cpu().numpy()))
    return pairs, feats[0][3]


def _match_pairs(frames, params=None, max_kpts=1024, device="cuda"):
    """`match_frames` over image files."""
    return match_frames(_read(frames), params, max_kpts, device)


def _essential_residual(pairs, f, cx, cy):
    """How badly the matches violate the essential (calibrated) model at
    focal f: per pair, the least-squares 8-point E on normalized
    coordinates projected to the essential manifold, its median squared
    Sampson distance in squared pixels, summed over the pairs."""
    total = 0.0
    for p0, p1 in pairs:
        if len(p0) < 12:
            continue
        a0 = (np.asarray(p0, float) - [cx, cy]) / f
        a1 = (np.asarray(p1, float) - [cx, cy]) / f
        h0 = np.concatenate([a0, np.ones((len(a0), 1))], 1)
        h1 = np.concatenate([a1, np.ones((len(a1), 1))], 1)
        A = (h1[:, :, None] * h0[:, None, :]).reshape(len(h0), 9)
        _, _, Vt = np.linalg.svd(A)
        E = Vt[-1].reshape(3, 3)
        U, _, Vt = np.linalg.svd(E)
        E = U @ np.diag([1.0, 1.0, 0.0]) @ Vt
        Ex0 = h0 @ E.T
        Etx1 = h1 @ E
        num = np.sum(h1 * Ex0, 1) ** 2
        den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + \
            Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
        total += float(np.median(num / np.maximum(den, 1e-12))) * f * f
    return total


def estimate_focal(pairs, hw, focal_grid=None, refine=True):
    """(f, cx, cy) from matched pairs: the Bougnoux focal of each pair's
    RANSAC fundamental matrix (median over pairs and both cameras) seeds
    a search over 0.75-1.35 x that value minimizing the essential-model
    residual; when every pair is Bougnoux-degenerate, a coarse and a fine
    focal grid scored by essential-matrix support."""
    h, w = hw
    cx, cy = w / 2.0, h / 2.0

    ests = []
    inlier_pairs = []
    for s, (p0, p1) in enumerate(pairs):
        if len(p0) < 12:
            continue
        F, inl = fundamental_ransac(np.asarray(p0, float),
                                    np.asarray(p1, float), seed=s)
        if F is None or inl.sum() < 10:
            continue
        inlier_pairs.append((np.asarray(p0, float)[inl],
                             np.asarray(p1, float)[inl]))
        f0, f1 = focal_from_fundamental(F, (cx, cy), (cx, cy))
        ests.extend([f for f in (f0, f1) if np.isfinite(f)
                     and 0.2 * max(h, w) < f < 10 * max(h, w)])

    if ests:
        f_est = float(np.median(ests))
        if refine and inlier_pairs:
            grid = f_est * np.geomspace(0.75, 1.35, 31)
            resid = [_essential_residual(inlier_pairs, f, cx, cy)
                     for f in grid]
            f_est = float(grid[int(np.argmin(resid))])
        return f_est, cx, cy

    # degenerate fallback: coarse + fine grid search
    if focal_grid is None:
        focal_grid = np.linspace(0.5, 2.5, 21) * max(h, w)
    best_f, _ = _score_focal_grid(pairs, focal_grid, cx, cy)
    if refine and len(focal_grid) > 1:
        step = focal_grid[1] - focal_grid[0]
        fine = best_f + np.linspace(-1.0, 1.0, 11) * step
        best_f, _ = _score_focal_grid(pairs, fine, cx, cy)
    return best_f, cx, cy


def _score_focal_grid(pairs, focal_grid, cx, cy):
    """(best f, its score) over focal_grid, as the JAX package scores it:
    each pair with at least 10 inliers of cv2's 5-point
    `findEssentialMat` (RANSAC, 1.5 px) at the focal adds the share of
    its matches that `recoverPose` puts in front of both cameras. Needs
    OpenCV; without it, raises ImportError."""
    cv2 = require_cv2("init/colmap_init.py:_score_focal_grid (the "
                      "degenerate focal fallback)")
    best_f, best_score = float(focal_grid[0]), -1.0
    for f in focal_grid:
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        score = 0.0
        for p0, p1 in pairs:
            if len(p0) < 12:
                continue
            p0 = np.asarray(p0, np.float64)
            p1 = np.asarray(p1, np.float64)
            E, inl = cv2.findEssentialMat(p0, p1, K, method=cv2.RANSAC,
                                          prob=0.999, threshold=1.5)
            if E is None or inl is None:
                continue
            if int(inl.sum()) < 10:
                continue
            # cheirality check strengthens the focal signal
            _, R, t, mask = cv2.recoverPose(E, p0, p1, K, mask=inl.copy())
            score += float(mask.sum()) / max(len(p0), 1)
        if score > best_score:
            best_score, best_f = score, float(f)
    return best_f, best_score


def calibration_confidence(pairs, f, cx, cy, hw):
    """The self-calibration's predicted focal-error envelope: 4% at a
    field of view of 55 deg or more, 8% at 45-55, 15% below; raised to at
    least 12% when the essential-model residual rises less than 2% at
    +-8% focal (a flat valley). Returns dict(fov_deg, flatness,
    predicted_err_pct)."""
    h, w = hw
    fov = float(np.degrees(2 * np.arctan(max(h, w) / (2.0 * max(f, 1e-6)))))
    pred = 4.0 if fov >= 55 else (8.0 if fov >= 45 else 15.0)

    flat = None
    scored = [(np.asarray(p0, float), np.asarray(p1, float))
              for p0, p1 in pairs if len(p0) >= 12]
    if scored:
        r0 = _essential_residual(scored, f, cx, cy)
        r_lo = _essential_residual(scored, 0.92 * f, cx, cy)
        r_hi = _essential_residual(scored, 1.08 * f, cx, cy)
        flat = float(max(r_lo, r_hi) / max(r0, 1e-12) - 1.0)
        if flat < 0.02:
            pred = max(pred, 12.0)
    return {"fov_deg": round(fov, 1),
            "flatness": round(flat, 4) if flat is not None else None,
            "predicted_err_pct": pred}


def _try_pycolmap(frames, workdir):
    """Incremental SfM via pycolmap when installed: [fx, fy, cx, cy], or
    None (not installed, no reconstruction, or under 70% of the frames
    registered). A failure inside pycolmap raises (ROADMAP R16)."""
    try:
        import pycolmap
    except ImportError:
        return None
    import shutil
    import tempfile

    tmp = Path(workdir or tempfile.mkdtemp(prefix="sfm_"))
    imgdir = tmp / "images"
    imgdir.mkdir(parents=True, exist_ok=True)
    for f in frames:
        shutil.copy(f, imgdir / Path(f).name)
    db = tmp / "database.db"
    out = tmp / "sparse"
    out.mkdir(exist_ok=True)
    pycolmap.extract_features(db, imgdir)
    pycolmap.match_sequential(db)
    recs = pycolmap.incremental_mapping(db, imgdir, out)
    if not recs:
        return None
    rec = max(recs.values(), key=lambda r: len(r.images))
    if len(rec.images) < 0.7 * len(frames):
        print(f"pycolmap registered {len(rec.images)}/{len(frames)} "
              "frames (<70%) — falling back to focal grid search")
        return None
    cam = next(iter(rec.cameras.values()))
    p = cam.params
    if len(p) == 3:                           # SIMPLE_PINHOLE/SIMPLE_RADIAL
        return np.array([p[0], p[0], p[1], p[2]])
    return np.array(p[:4])


def run_colmap_initialization(imagedir, path=None, skip=0, max_frames=30,
                              params=None, device="cuda"):
    """np.array([fx, fy, cx, cy]) of the camera of `imagedir`'s images.
    params: the VONet weights of the matcher (anything `as_vonet`
    takes; the demo passes its loaded network). Writes
    `estimated_calib.txt` and, after the two-view path,
    `calib_confidence.json` under `path`."""
    frames = select_keyframes(imagedir, skip=skip, max_frames=max_frames,
                              device=device)
    if len(frames) < 2:
        raise RuntimeError("not enough frames with motion for calibration")

    calib = _try_pycolmap(frames, path)
    if calib is not None:
        if path:
            Path(path).mkdir(parents=True, exist_ok=True)
            np.savetxt(Path(path) / "estimated_calib.txt", calib[None])
        return calib

    pairs, hw = _match_pairs(frames, params=params, device=device)
    f, cx, cy = estimate_focal(pairs, hw)
    calib = np.array([f, f, cx, cy])

    # above ~8% predicted focal error the two-view estimate is outside
    # its trustworthy envelope (~0.002 Sim3 ATE per percent)
    conf = calibration_confidence(pairs, f, cx, cy, hw)
    escalate = conf["predicted_err_pct"] >= 8.0
    if escalate:
        print(f"WARNING: auto-calibration outside its trustworthy "
              f"envelope (FOV {conf['fov_deg']} deg, predicted focal "
              f"error ~{conf['predicted_err_pct']:.0f}%; ~0.002 Sim3 ATE "
              f"per %). Install pycolmap or provide --calib for reliable "
              f"results.")
    if path:
        Path(path).mkdir(parents=True, exist_ok=True)
        np.savetxt(Path(path) / "estimated_calib.txt", calib[None])
        (Path(path) / "calib_confidence.json").write_text(json.dumps(
            dict(conf, escalated=bool(escalate), method="two-view")))
    print(f"auto-calibration: fx=fy={f:.1f}, cx={cx:.1f}, cy={cy:.1f} "
          f"(predicted error ~{conf['predicted_err_pct']:.0f}%)")
    return calib
