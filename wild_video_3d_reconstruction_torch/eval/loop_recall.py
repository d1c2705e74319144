"""Loop-closure retrieval recall on a synthetic revisiting sequence.

The port's copy of the JAX package's `eval/loop_recall.py`: a camera pans
across a large random texture and returns along the same path, so frame
t and frame T - t observe the same crop. Each frame's VLAD descriptor of
the VONet matching features (`loop/netvlad.py`) goes into the database;
recall is the share of returning-half queries whose top-1 hit lies
within +/- `tol` frames of the ground-truth revisit.

Run (from the repository root):

    python -m wild_video_3d_reconstruction_torch.eval.loop_recall \
        [--frames 80] [--shift 24] [--thresh 0.0] [--fit] [--device cpu]

`--network` takes a DPVO-layout `.pth` (default: weights drawn from seed
0, which are not the JAX package's `init_vonet(PRNGKey(0))`); without
`--fit` the VLAD centres are `VLADDescriptor`'s, drawn from a
`torch.Generator` seeded 7. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_frames(T, shift, ht, wd, seed=0):
    """Out-and-back pan: frame t and T-t (t < T/2) share the same crop."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 255, size=(ht + 8, wd + shift * (T // 2) + 8, 3),
                       dtype=np.uint8)
    frames, gt = [], []
    for t in range(T):
        k = t if t < T // 2 else T - t
        x = shift * k
        frames.append(np.ascontiguousarray(big[:ht, x:x + wd]))
        gt.append(T - t if t >= T // 2 else None)
    return frames, gt


def run(frames, gt, network=None, fit=False, thresh=0.0, tol=2,
        skip_window=10, centers=None, device="cuda"):
    """Recall of the revisits `gt` over `frames` ([H, W, 3] uint8 each);
    network: as `as_vonet` takes it; centers: VLAD centres [16, 128]
    (default: fitted on the frames with fit, else `VLADDescriptor`'s)."""
    from ..loop.netvlad import (DescriptorDatabase, VLADDescriptor,
                                fit_centers_from_images)
    from ..models import vonet
    from ..models.convert import as_vonet

    dev = torch.device(device)
    net = as_vonet(network).to(dev).eval()
    if centers is None and fit:
        centers = fit_centers_from_images(net, frames)
    vlad = VLADDescriptor(centers=centers)

    db = DescriptorDatabase(vlad.dim)
    hits, margins, n_q = 0, [], 0
    for t, img in enumerate(frames):
        with torch.no_grad():
            fmap = vonet.encode_frame(net, torch.as_tensor(img, device=dev),
                                      torch.float32).fmap
        db.insert_desc(t, vlad.extract(fmap))
        if gt[t] is None:
            continue
        score, j = db.query_online(t, skip_window, top_k=1)
        n_q += 1
        if j is None or score < thresh:
            continue
        if abs(j - gt[t]) <= tol:
            hits += 1
            margins.append(float(score))

    recall = hits / max(n_q, 1)
    return {
        "metric": "loop_retrieval_recall_top1",
        "value": round(recall, 4),
        "queries": n_q,
        "hits": hits,
        "mean_hit_score": round(float(np.mean(margins)) if margins else 0.0,
                                4),
        "descriptor": ("VLAD-16x128 over fnet features ("
                       + ("k-means-fitted" if fit else "random")
                       + " centers, "
                       + ("given" if network is not None else "random")
                       + " weights)"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--shift", type=int, default=24)
    ap.add_argument("--size", type=int, nargs=2, default=(192, 256))
    ap.add_argument("--thresh", type=float, default=0.0)
    ap.add_argument("--tol", type=int, default=2)
    ap.add_argument("--skip-window", type=int, default=10)
    ap.add_argument("--fit", action="store_true",
                    help="fit VLAD centers on the sequence (spherical "
                         "k-means pre-pass) instead of random centers")
    ap.add_argument("--network", default=None,
                    help="DPVO-layout .pth (default: weights from seed 0)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    ht, wd = args.size
    frames, gt = build_frames(args.frames, args.shift, ht, wd)
    out = run(frames, gt, args.network, args.fit, args.thresh, args.tol,
              args.skip_window, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
