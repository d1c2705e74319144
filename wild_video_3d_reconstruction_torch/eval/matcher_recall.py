"""Loop-closure keypoint-matcher precision and recall against ground truth.

The port's copy of the JAX package's `eval/matcher_recall.py`. The
reference's loop closure matches DISK keypoints with LightGlue
(`dpvo/loop_closure/long_term.py:45-63,84-89`); this stack ships
Shi-Tomasi corners, descriptors from the VONet matching features and a
mutual-nearest-neighbour matcher with a ratio test (`loop/keypoints.py`).
This driver scores that matcher against exact ground-truth
correspondences on the rendered worlds (analytic depth and known poses
give a closed-form pixel transfer; `harden` adds occluder discs and
exposure jitter), across viewpoint deltas.

Metrics per (delta, harden):
  precision  = correct accepted matches / accepted matches
  recall     = correct accepted matches / matchable ground-truth pairs,
               where a pair exists when an A-keypoint's transfer lands
               within `tol` px of some detected B-keypoint and passes the
               occlusion / depth-consistency check.

Run (from the repository root):

    python -u -m wild_video_3d_reconstruction_torch.eval.matcher_recall \
        [--network weights/vonet_synth_tpu_r3_step2000.pth] [--seeds 4] \
        [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..loop import keypoints as kp
from ..models import vonet
from ..ops import lie
from ..train.synth import render_clip

DELTAS = (1, 3, 6, 10)
TOL = 3.0          # px at full resolution
NKPT = 512


def _transfer(xy, invd, pose_a, pose_b, intr):
    """Project full-res pixels xy [K, 2] of frame a (inverse depth invd)
    into frame b. Returns (xy_b [K, 2], z_b [K])."""
    fx, fy, cx, cy = intr
    X = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy,
                  np.ones(len(xy)), invd], axis=-1)
    Gab = lie.se3_mul(torch.as_tensor(pose_b),
                      lie.se3_inv(torch.as_tensor(pose_a)))
    Xb = lie.se3_act4(Gab.expand(len(xy), 7),
                      torch.as_tensor(X, dtype=torch.float32)).numpy()
    z = Xb[:, 2] / np.maximum(Xb[:, 3], 1e-8)
    xb = fx * Xb[:, 0] / np.maximum(Xb[:, 2], 1e-8) + cx
    yb = fy * Xb[:, 1] / np.maximum(Xb[:, 2], 1e-8) + cy
    return np.stack([xb, yb], axis=-1), z


def run_pair(images, poses, disps, intr, a, b, net, tol=TOL):
    """Score the matcher on the (a, b) frame pair with the `VONet` net
    (on its device). Returns the metric dict."""
    ht, wd = images.shape[1:3]
    dev = next(net.parameters()).device
    feats = []
    with torch.no_grad():
        for t in (a, b):
            img = torch.as_tensor(images[t], device=dev)
            xy, score = kp.detect(img, NKPT)
            fmap = vonet.encode_frame(net, img, torch.float32).fmap
            desc = kp.describe(fmap, xy)
            feats.append(dict(xy=xy.cpu().numpy(), score=score.cpu().numpy(),
                              desc=desc, valid=score > 0))
    fa, fb = feats
    va, vb = (f["valid"].cpu().numpy() for f in feats)

    # ground-truth transfer of frame-a keypoints (disp at /4 grid)
    gx = np.clip((fa["xy"][:, 0] / 4).astype(int), 0, wd // 4 - 1)
    gy = np.clip((fa["xy"][:, 1] / 4).astype(int), 0, ht // 4 - 1)
    invd = disps[a][gy, gx]
    xy_b, z_b = _transfer(fa["xy"], invd, poses[a], poses[b], intr)
    inb = ((xy_b[:, 0] >= 0) & (xy_b[:, 0] < wd)
           & (xy_b[:, 1] >= 0) & (xy_b[:, 1] < ht) & (z_b > 1e-3))
    # occlusion / moving-occluder check: the b-frame depth at the
    # transfer location must agree with the transferred depth
    bx = np.clip((xy_b[:, 0] / 4).astype(int), 0, wd // 4 - 1)
    by = np.clip((xy_b[:, 1] / 4).astype(int), 0, ht // 4 - 1)
    invd_b = disps[b][by, bx]
    vis = inb & va & (np.abs(1.0 / np.maximum(z_b, 1e-6) - invd_b)
                      < 0.15 * np.maximum(invd_b, 1e-6))

    # matchable = a detected b keypoint sits within tol of the transfer
    d2 = np.linalg.norm(xy_b[:, None, :] - fb["xy"][None, :, :], axis=-1)
    d2[:, ~vb] = 1e9
    nearest_b = d2.argmin(axis=1)
    matchable = vis & (d2[np.arange(len(xy_b)), nearest_b] < tol)

    i0, i1, ok = (x.cpu().numpy() for x in kp.match(
        fa["desc"], fb["desc"], fa["valid"], fb["valid"]))
    acc_a, acc_b = i0[ok], i1[ok]
    err = np.linalg.norm(fb["xy"][acc_b] - xy_b[acc_a], axis=-1)
    # precision scores the reprojection error alone among in-bounds
    # transfers (a match that is geometrically right but fails the
    # /4-grid depth gate is not a false positive); the vis gate only
    # shapes the recall denominator (what was matchable)
    geo_ok = (err < tol) & inb[acc_a]
    correct_rec = (err < tol) & vis[acc_a]
    n_acc = int(ok.sum())
    n_matchable = int(matchable.sum())
    n_correct = int(correct_rec.sum())
    return dict(accepted=n_acc, matchable=n_matchable, correct=n_correct,
                geo_correct=int(geo_ok.sum()),
                precision=int(geo_ok.sum()) / max(n_acc, 1),
                recall=n_correct / max(n_matchable, 1))


def render_pair_clip(seed, harden, deltas=DELTAS, ht=96, wd=128):
    """The sweep's clip of seed `seed`: `render_clip` over max(deltas) + 1
    frames with the generator `default_rng(1000 + seed)`."""
    rng = np.random.default_rng(1000 + seed)
    return render_clip(rng, frames=max(deltas) + 1, ht=ht, wd=wd,
                       fx=wd * 0.6, fy=wd * 0.6, n_planes=3, harden=harden)


def run_sweep(net, seeds=4, deltas=DELTAS, ht=96, wd=128, log=print,
              clips=None):
    """{"clean_d1": {...}, ..., "hard_d10": {...}}: the counts summed over
    the seeds, with precision and recall; clips: {(seed, harden): the
    `render_pair_clip` output} made ahead (rendered here otherwise)."""
    out = {}
    for harden in (False, True):
        for d in deltas:
            agg = dict(accepted=0, matchable=0, correct=0, geo_correct=0)
            for s in range(seeds):
                clip = clips[(s, harden)] if clips else \
                    render_pair_clip(s, harden, deltas, ht, wd)
                images, poses, disps, intr = clip
                r = run_pair(images, poses, disps, intr, 0, d, net)
                for k in agg:
                    agg[k] += r[k]
            prec = agg["geo_correct"] / max(agg["accepted"], 1)
            rec = agg["correct"] / max(agg["matchable"], 1)
            key = f"{'hard' if harden else 'clean'}_d{d}"
            out[key] = dict(precision=round(prec, 3), recall=round(rec, 3),
                            **agg)
            log(f"{key:10s} precision {prec:.3f} recall {rec:.3f} "
                f"(acc {agg['accepted']}, matchable {agg['matchable']})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default=None,
                    help="DPVO-layout .pth (default: weights from seed 0)")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    from ..models.convert import as_vonet

    net = as_vonet(args.network).to(torch.device(args.device)).eval()
    table = run_sweep(net, seeds=args.seeds)
    out = {"metric": "lc_matcher_pr", "params": args.network or "random",
           "table": table}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
