"""Global image descriptors for place recognition (NetVLAD-style VLAD).

Counterpart of the JAX package's `loop/netvlad.py`: a VLAD aggregation over
the VO network's own /4 matching features (`vlad_extract`, also run inside
the steady frame step, `slam/steps.py:insert_frame`), spherical k-means
centres fitted on a sequence (`fit_centers`, a numpy copy, bitwise the
same; `fit_centers_from_images`), and the keyframe-indexed descriptor store
with its centred-cosine query and pickle cache (`DescriptorDatabase`).

`VLADDescriptor()` without centres draws them from a `torch.Generator`
seeded 7 (the JAX package draws from `jax.random.PRNGKey(7)`, which
PyTorch cannot reproduce; pass `centers=` to use others).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


def vlad_extract(fmap, centers):
    """fmap [H, W, C] -> [K*C] L2-normalised VLAD descriptor in fp32:
    soft assignment (16 x cosine, softmax over the K centres), residual
    sums, intra-normalisation, then a global L2."""
    K, C = centers.shape
    x = fmap.reshape(-1, C).float()
    centers = centers.float()
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-8)
    a = torch.softmax(16.0 * (x @ centers.T), dim=-1)        # [N, K]
    # sum_n a[n, k] (x[n] - c[k]) without an [N, K, C] intermediate
    vlad = a.T @ x - a.sum(dim=0)[:, None] * centers          # [K, C]
    vlad = vlad / torch.linalg.norm(vlad, dim=-1,
                                    keepdim=True).clamp(min=1e-8)
    v = vlad.reshape(-1)
    return v / torch.linalg.norm(v).clamp(min=1e-8)


def fit_centers(feats, num_clusters=16, iters=25, seed=0, max_rows=200_000):
    """Spherical k-means over L2-normalised feature rows [N, C], seeded
    k-means++ style from np.random.default_rng(seed). Returns
    [num_clusters, C] unit-norm centres (float32 numpy)."""
    x = np.asarray(feats, np.float32).reshape(-1, np.shape(feats)[-1])
    rng = np.random.default_rng(seed)
    if x.shape[0] > max_rows:
        x = x[rng.choice(x.shape[0], max_rows, replace=False)]
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)
    # greedy far-point picks on cosine distance (the copy keeps the Lloyd
    # loop from writing through a view into x when num_clusters is 1)
    centers = x[rng.integers(x.shape[0])][None].copy()
    for _ in range(num_clusters - 1):
        d = 1.0 - (x @ centers.T).max(axis=1)
        p = np.maximum(d, 0) + 1e-9
        centers = np.concatenate(
            [centers, x[rng.choice(x.shape[0], p=p / p.sum())][None]])
    for _ in range(iters):
        assign = np.argmax(x @ centers.T, axis=1)
        for k in range(num_clusters):
            rows = x[assign == k]
            if rows.shape[0] == 0:           # dead cluster: re-seed far
                d = 1.0 - (x @ centers.T).max(axis=1)
                rows = x[d.argmax()][None]
            c = rows.mean(axis=0)
            centers[k] = c / max(np.linalg.norm(c), 1e-8)
    return centers


def fit_centers_from_images(net, images, num_clusters=16, seed=0,
                            max_images=24):
    """Centres fitted on the fp32 /4 features (`models/vonet.encode_frame`)
    of up to max_images evenly spaced [H, W, 3] uint8 images (each cut to
    a multiple of 16), on the device of `net`."""
    from ..models import vonet

    dev = next(net.parameters()).device
    imgs = list(images)
    if len(imgs) > max_images:
        step = len(imgs) / max_images
        imgs = [imgs[int(i * step)] for i in range(max_images)]
    rows = []
    with torch.no_grad():
        for im in imgs:
            im = np.asarray(im)
            im = im[:im.shape[0] - im.shape[0] % 16,
                    :im.shape[1] - im.shape[1] % 16]
            f = vonet.encode_frame(net, torch.as_tensor(im, device=dev),
                                   torch.float32).fmap
            rows.append(f.reshape(-1, f.shape[-1]).float().cpu().numpy())
    return fit_centers(np.concatenate(rows), num_clusters, seed=seed)


class VLADDescriptor:
    """VLAD pooling over [H, W, C] feature maps with K soft-assigned
    centres: given, or drawn (unit normal rows) from a `torch.Generator`
    seeded `seed`."""

    def __init__(self, num_clusters=16, feat_dim=128, seed=7, centers=None):
        if centers is None:
            gen = torch.Generator().manual_seed(seed)
            centers = torch.randn(num_clusters, feat_dim, generator=gen)
            centers = centers / torch.linalg.norm(centers, dim=-1,
                                                  keepdim=True)
        self.centers = torch.as_tensor(np.asarray(centers, np.float32))
        self.K, self.C = self.centers.shape

    @property
    def dim(self):
        return self.K * self.C

    def extract(self, fmap):
        """A feature map (tensor on any device, or numpy) -> [K*C] numpy."""
        fmap = torch.as_tensor(fmap)
        return vlad_extract(fmap, self.centers.to(fmap.device)).cpu().numpy()


class DescriptorDatabase:
    """Keyframe-indexed global descriptors with dot-product retrieval:
    `insert_desc` / `query_online` with a skip window, and a pickle cache
    keyed by (skip, end, stride)."""

    def __init__(self, dim, capacity=100000, cache_dir=None, cache_key=None,
                 center=True):
        self.descs = np.zeros((capacity, dim), np.float32)
        self.has = np.zeros(capacity, bool)
        self.cache_dir = cache_dir
        self.cache_key = cache_key
        self.center = center

    def insert_desc(self, n, desc):
        self.descs[n] = desc
        self.has[n] = True

    def query_online(self, n, skip_window=50, top_k=1):
        """(score, j) of the best match among the frames older than
        n - skip_window, or (None, None). Scores are centred cosines: the
        mean of the database and the query is subtracted first, since the
        VLAD descriptors of a self-similar scene share a component that
        saturates the raw cosine near 1 for every pair."""
        hi = n - skip_window
        if hi <= 0:
            return None, None
        cand = np.where(self.has[:hi])[0]
        if cand.size == 0:
            return None, None
        q, db = self.descs[n], self.descs[cand]
        if self.center:
            # the mean over the database and the query: a near-empty
            # database self-suppresses instead of saturating
            mu = (db.sum(axis=0) + q) / (cand.size + 1)
            q = q - mu
            db = db - mu
            q = q / max(float(np.linalg.norm(q)), 1e-8)
            db = db / np.maximum(np.linalg.norm(db, axis=1, keepdims=True),
                                 1e-8)
        scores = db @ q
        order = np.argsort(scores)[::-1][:top_k]
        return scores[order[0]], int(cand[order[0]])

    # ---- offline cache -------------------------------------------------
    def cache_path(self):
        if not self.cache_dir or not self.cache_key:
            return None
        skip, end, stride = self.cache_key
        return Path(self.cache_dir) / f"features_{skip}_{end}_{stride}.pkl"

    def save_cache(self):
        p = self.cache_path()
        if p:
            p.parent.mkdir(parents=True, exist_ok=True)
            with open(p, "wb") as f:
                pickle.dump({"descs": self.descs[self.has],
                             "idx": np.where(self.has)[0]}, f)

    def load_cache(self):
        """Load a cache this program wrote (pickle: never a file from
        elsewhere). True when one was there."""
        p = self.cache_path()
        if p and p.exists():
            with open(p, "rb") as f:
                data = pickle.load(f)
            self.descs[data["idx"]] = data["descs"]
            self.has[data["idx"]] = True
            return True
        return False
