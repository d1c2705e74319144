"""Training data pipeline (TartanAir-style RGB-D clips), on the host.

The port's copy of the JAX package's `train/data.py`, a numpy / cv2
re-implementation of the reference readers
(`dpvo/data_readers/{base,tartan,factory,augmentation}.py`):

  * flow-distance frame graph: the mean optical flow between frame pairs
    from depth and relative pose over a subsampled pixel grid (`base.py`
    build_frame_graph); clips walk the graph within [fmin, fmax] of flow,
    preferring frames forward in time (`base.py:98-139`),
  * TartanAir layout: image_left/*.png + depth_left/*.npy + pose_left.txt
    in NED order, remapped to (x, y, z, qx, qy, qz, qw) with translations
    divided by DEPTH_SCALE = 5 (`tartan.py:57-105`),
  * photometric augmentation,
  * disparity normalization by 0.7 * its 98th percentile with the matching
    pose rescale (`base.py:165-167`),
  * numpy batches in `parallel.train_step.clip_loss_fn`'s layout.

The SE(3) algebra is the port's `ops/lie.py` on CPU fp32 tensors, where
the JAX package used its own; with the same `np.random.default_rng` seed
the reader draws the same frames and the same jitter as the JAX one.
cv2 (`imread`, `resize`) is imported inside the functions that read.

Poses are camera-to-world in the dataset; clips come out world-to-camera,
the training graph's convention.

`_resize` repeats a fault of the JAX reader (ROADMAP R25): it resizes the
frames to `image_size` but leaves the intrinsics at `calib_read()`'s
[320, 320, 320, 240] for 640x480 frames.
"""

from __future__ import annotations

import glob
import os.path as osp
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import lie

TARTAN_TEST_SPLIT = ("mono_gt",)   # scene-name fragments held out


def _lie32(fn, *arrays):
    """fn of the port's lie module on CPU fp32 tensors, back as numpy."""
    return fn(*(torch.as_tensor(np.asarray(a, np.float32))
                for a in arrays)).numpy()


@dataclass
class SceneInfo:
    images: list
    depths: list
    poses: np.ndarray          # [N, 7] dataset convention (c2w)
    intrinsics: np.ndarray     # [N, 4]
    graph: dict = field(default_factory=dict)


def flow_distance_matrix(poses_c2w, depths, intrinsics, subsample=16,
                         max_frames=None, read_depth=None):
    """Mean flow magnitude [n, n] between frame pairs up to 12 apart
    (inf beyond): a subsampled depth grid of frame i reprojected into
    frame j (the reference's build_frame_graph, approximated)."""
    n = len(depths) if max_frames is None else min(len(depths), max_frames)
    pts = []
    for i in range(n):
        d = read_depth(depths[i]) if read_depth else depths[i]
        d = d[::subsample, ::subsample]
        H, W = d.shape
        ys, xs = np.mgrid[:H, :W]
        pts.append(np.stack([xs.ravel() * subsample,
                             ys.ravel() * subsample,
                             1.0 / np.maximum(d.ravel(), 1e-3)], -1))
    pts = np.stack(pts)                      # [n, K, 3]

    w2c = _lie32(lie.se3_inv, poses_c2w[:n])
    D = np.full((n, n), np.inf, np.float32)
    K = pts.shape[1]
    fx, fy, cx, cy = intrinsics[0][:4]
    for i in range(n):
        X = np.stack([(pts[i, :, 0] - cx) / fx, (pts[i, :, 1] - cy) / fy,
                      np.ones(K), pts[i, :, 2]], -1)
        for j in range(max(0, i - 12), min(n, i + 13)):
            if i == j:
                D[i, j] = 0
                continue
            Gij = _lie32(lambda a, b: lie.se3_mul(a, lie.se3_inv(b)),
                         w2c[j], w2c[i])
            X1 = _lie32(lie.se3_act4, Gij, X)
            z = np.maximum(X1[:, 2], 0.1)
            u = fx * X1[:, 0] / z + cx
            v = fy * X1[:, 1] / z + cy
            flow = np.sqrt((u - pts[i, :, 0]) ** 2 + (v - pts[i, :, 1]) ** 2)
            D[i, j] = float(np.mean(np.minimum(flow, 250.0)))
    return D


class TartanAirDataset:
    DEPTH_SCALE = 5.0

    def __init__(self, root, n_frames=8, fmin=16.0, fmax=96.0,
                 image_size=(384, 512), aug=True, max_scenes=None):
        self.root = root
        self.n_frames = n_frames
        self.fmin, self.fmax = fmin, fmax
        self.image_size = image_size
        self.aug = aug
        self.scenes = self._build(max_scenes)

    @staticmethod
    def calib_read():
        return np.array([320.0, 320.0, 320.0, 240.0])

    @staticmethod
    def depth_read(path):
        depth = np.load(path) / TartanAirDataset.DEPTH_SCALE
        depth[~np.isfinite(depth)] = 1.0
        return depth

    def _build(self, max_scenes):
        scenes = sorted(glob.glob(osp.join(self.root, "*/*/*/*")))
        if max_scenes:
            scenes = scenes[:max_scenes]
        out = []
        for scene in scenes:
            images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
            if len(images) != len(depths) or len(images) < self.n_frames:
                continue
            poses = np.loadtxt(osp.join(scene, "pose_left.txt"),
                               delimiter=" ")
            # NED -> (x, y, z, qx, qy, qz, qw)
            poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]
            poses[:, :3] /= self.DEPTH_SCALE
            intr = np.tile(self.calib_read()[None], (len(images), 1))
            D = flow_distance_matrix(poses, depths, intr,
                                     read_depth=self.depth_read,
                                     max_frames=min(len(images), 400))
            out.append(SceneInfo(images, depths, poses, intr,
                                 {"dist": D}))
        return out

    # ----------------------------------------------------------- sampling
    def sample_clip(self, rng):
        """Walk the flow graph to assemble an n_frames clip
        (`base.py:98-139`): (images [T, H, W, 3] uint8 BGR, poses_w2c
        [T, 7], disps at 1/4 scale [T, H/4, W/4], intrinsics [4])."""
        import cv2

        scene = self.scenes[rng.integers(len(self.scenes))]
        D = scene.graph["dist"]
        n = D.shape[0]
        ix = int(rng.integers(0, n - 1))
        inds = [ix]
        while len(inds) < self.n_frames:
            cand = np.where((D[ix] > self.fmin) & (D[ix] < self.fmax))[0]
            fwd = cand[cand > ix]
            if len(fwd):
                ix = int(rng.choice(fwd))
            elif ix + 1 < n:
                ix = ix + 1
            elif len(cand):
                ix = int(rng.choice(cand))
            inds.append(ix)

        images, disps = [], []
        for i in inds:
            img = cv2.imread(scene.images[i])
            depth = self.depth_read(scene.depths[i])
            img, depth = self._resize(img, depth)
            images.append(img)
            disps.append(1.0 / np.maximum(depth, 1e-3))
        images = np.stack(images)
        disps = np.stack(disps)
        poses_c2w = scene.poses[inds].astype(np.float32)
        intr = scene.intrinsics[inds][0].astype(np.float32).copy()

        if self.aug:
            images = self._augment_color(images, rng)

        # disparity normalization (`base.py:165-167`)
        s = 0.7 * np.quantile(disps, 0.98)
        disps = disps / s
        poses_c2w = poses_c2w.copy()
        poses_c2w[:, :3] *= s

        poses_w2c = _lie32(lie.se3_inv, poses_c2w)
        # disparities at feature (1/4) scale
        disps4 = disps[:, 1::4, 1::4]
        return (images.astype(np.uint8), poses_w2c,
                disps4.astype(np.float32), intr)

    def _resize(self, img, depth):
        """Frame and depth at image_size. The intrinsics are not scaled
        with them, as in the JAX reader (ROADMAP R25)."""
        import cv2

        H, W = self.image_size
        img = cv2.resize(img, (W, H))
        depth = cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST)
        return img, depth

    @staticmethod
    def _augment_color(images, rng):
        """Photometric jitter (`augmentation.py`)."""
        gain = rng.uniform(0.8, 1.2)
        bias = rng.uniform(-20, 20)
        out = np.clip(images.astype(np.float32) * gain + bias, 0, 255)
        if rng.random() < 0.5:
            # channel shuffle-free saturation jitter
            gray = out.mean(axis=-1, keepdims=True)
            alpha = rng.uniform(0.7, 1.3)
            out = np.clip(gray + alpha * (out - gray), 0, 255)
        return out.astype(np.uint8)

    def batches(self, batch_size, steps, seed=0):
        """Yield train_step-shaped numpy batches, drawn from
        `np.random.default_rng(seed)`."""
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            clips = [self.sample_clip(rng) for _ in range(batch_size)]
            yield {
                "images": np.stack([c[0] for c in clips]),
                "poses": np.stack([c[1] for c in clips]),
                "disps": np.stack([c[2] for c in clips]),
                "intrinsics": np.stack([c[3] for c in clips]),
            }


def dataset_factory(names, root, **kwargs):
    """`data_readers/factory.py` equivalent."""
    registry = {"tartan": TartanAirDataset}
    datasets = [registry[n](root, **kwargs) for n in names]
    return datasets[0] if len(datasets) == 1 else datasets
