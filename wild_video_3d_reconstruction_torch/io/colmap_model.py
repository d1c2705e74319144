"""Self-contained COLMAP sparse-model reader/writer (text + binary).

The port's own copy of the JAX package's `io/colmap_model.py` (numpy
only): the same classes and the same bytes on disk.

The reference shells out to the `colmap model_converter` binary and parses
models via pycolmap/nerfstudio helpers (`dpvo/plot_utils.py:96-115`,
`formatter/colmap_utilis.py`, `nerf_train/nerf_prepare.py`); neither tool is
assumed here, so both COLMAP disk formats (https://colmap.github.io/format.html)
are implemented directly.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
}
MODEL_BY_ID = {v[0]: (k, v[1]) for k, v in CAMERA_MODELS.items()}


@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray        # (qw, qx, qy, qz) world-to-camera
    tvec: np.ndarray        # (tx, ty, tz)
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,),
                                                                     np.int64))

    def w2c_matrix(self):
        w, x, y, z = self.qvec
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.tvec
        return T


@dataclass
class Point3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float = 0.0
    image_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,),
                                                                   np.int64))
    point2D_idxs: np.ndarray = field(default_factory=lambda: np.zeros(
        (0,), np.int64))


# ---------------------------------------------------------------------------
# text format
# ---------------------------------------------------------------------------

def write_text(path, cameras, images, points):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "cameras.txt", "w") as f:
        for c in cameras.values():
            p = " ".join(map(str, c.params.tolist()))
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} {p}\n")
    with open(path / "images.txt", "w") as f:
        for im in images.values():
            q = " ".join(map(str, im.qvec.tolist()))
            t = " ".join(map(str, im.tvec.tolist()))
            f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n")
            obs = " ".join(f"{x} {y} {int(pid)}" for (x, y), pid
                           in zip(im.xys, im.point3D_ids))
            f.write(obs + "\n")
    with open(path / "points3D.txt", "w") as f:
        for pt in points.values():
            xyz = " ".join(map(str, pt.xyz.tolist()))
            rgb = " ".join(map(str, pt.rgb.astype(int).tolist()))
            track = " ".join(f"{int(i)} {int(j)}" for i, j
                             in zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.point3D_id} {xyz} {rgb} {pt.error} {track}\n")


def read_text(path):
    path = Path(path)
    cameras, images, points = {}, {}, {}
    for line in open(path / "cameras.txt"):
        if line.startswith("#") or not line.strip():
            continue
        el = line.split()
        cameras[int(el[0])] = Camera(int(el[0]), el[1], int(el[2]),
                                     int(el[3]),
                                     np.array(list(map(float, el[4:]))))
    lines = [ln for ln in open(path / "images.txt")
             if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        el = lines[i].split()
        im = Image(int(el[0]), np.array(list(map(float, el[1:5]))),
                   np.array(list(map(float, el[5:8]))), int(el[8]),
                   el[9] if len(el) > 9 else "")
        if i + 1 < len(lines) and lines[i + 1].strip():
            obs = lines[i + 1].split()
            xs = np.array(list(map(float, obs[0::3])))
            ys = np.array(list(map(float, obs[1::3])))
            im.xys = np.stack([xs, ys], -1)
            im.point3D_ids = np.array(list(map(int, obs[2::3])))
        images[im.image_id] = im
        i += 2
    p3d = path / "points3D.txt"
    if p3d.exists():
        for line in open(p3d):
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            points[int(el[0])] = Point3D(
                int(el[0]), np.array(list(map(float, el[1:4]))),
                np.array(list(map(float, el[4:7]))), float(el[7]),
                np.array(list(map(int, el[8::2]))),
                np.array(list(map(int, el[9::2]))))
    return cameras, images, points


# ---------------------------------------------------------------------------
# binary format
# ---------------------------------------------------------------------------

def write_binary(path, cameras, images, points):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            model_id, n = CAMERA_MODELS[c.model]
            f.write(struct.pack("<iiQQ", c.camera_id, model_id,
                                c.width, c.height))
            f.write(struct.pack(f"<{n}d", *c.params.tolist()))
    with open(path / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec.tolist()))
            f.write(struct.pack("<3d", *im.tvec.tolist()))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))
    with open(path / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<Q", pt.point3D_id))
            f.write(struct.pack("<3d", *pt.xyz.tolist()))
            f.write(struct.pack("<3B", *pt.rgb.astype(int).tolist()))
            f.write(struct.pack("<d", pt.error))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for i, j in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(i), int(j)))


def read_binary(path):
    path = Path(path)
    cameras, images, points = {}, {}, {}
    with open(path / "cameras.bin", "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            model, n = MODEL_BY_ID[mid]
            params = np.array(struct.unpack(f"<{n}d", f.read(8 * n)))
            cameras[cid] = Camera(cid, model, w, h, params)
    with open(path / "images.bin", "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            (iid,) = struct.unpack("<i", f.read(4))
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (cid,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (npts,) = struct.unpack("<Q", f.read(8))
            data = struct.unpack("<" + "ddq" * npts, f.read(24 * npts))
            xys = np.array(data).reshape(-1, 3)[:, :2] if npts else \
                np.zeros((0, 2))
            pids = np.array(data[2::3], np.int64) if npts else \
                np.zeros((0,), np.int64)
            images[iid] = Image(iid, qvec, tvec, cid, name.decode(),
                                xys, pids)
    pfile = path / "points3D.bin"
    if pfile.exists():
        with open(pfile, "rb") as f:
            (num,) = struct.unpack("<Q", f.read(8))
            for _ in range(num):
                (pid,) = struct.unpack("<Q", f.read(8))
                xyz = np.array(struct.unpack("<3d", f.read(24)))
                rgb = np.array(struct.unpack("<3B", f.read(3)))
                (err,) = struct.unpack("<d", f.read(8))
                (tl,) = struct.unpack("<Q", f.read(8))
                track = struct.unpack("<" + "ii" * tl, f.read(8 * tl))
                points[pid] = Point3D(pid, xyz, rgb, err,
                                      np.array(track[0::2], np.int64),
                                      np.array(track[1::2], np.int64))
    return cameras, images, points


def read_model(path):
    path = Path(path)
    if (path / "cameras.bin").exists():
        return read_binary(path)
    return read_text(path)
