"""Host-side frame streaming (the input pipeline).

The port's copy of the JAX package's `io/stream.py`: globbed image
directories (with optional `.npy` depth and grayscale mask directories)
or video files, optional undistortion, crop to a multiple of 16, depth
clipped at 10x its median. A `Prefetcher` decodes in a daemon thread
into a bounded queue, ahead of the tracker; with `pin=True` it also
copies each image into a pinned torch tensor.

PNG frames and masks are decoded by `io/png.py` (bitwise `cv2.imread`
for 8-bit PNGs); a PNG of another kind (16-bit, palette, interlaced),
JPEG frames, undistortion and video go to OpenCV, as in the JAX package.
OpenCV is imported inside those readers only, so the package imports
without it and an image directory of 8-bit PNGs needs none; a reader
that needs it and does not find it raises ImportError naming itself.
"""

from __future__ import annotations

import queue
import threading
from itertools import chain
from pathlib import Path

import numpy as np

from . import png

IMG_EXTS = ("*.png", "*.jpeg", "*.jpg")
SENTINEL = (-1, None, None, None, None)


def _globbed(directory, exts, skip, end, stride):
    files = sorted(chain.from_iterable(Path(directory).glob(e) for e in exts))
    return files[skip:end:stride] if end is not None else files[skip::stride]


def _calib(calib):
    return np.loadtxt(calib, delimiter=" ") if isinstance(calib, str) \
        else np.asarray(calib)


def list_images(imagedir, stride=1, skip=0, end=None):
    """The image file list a stream over `imagedir` would visit."""
    return _globbed(imagedir, IMG_EXTS, skip, end, stride)


def require_cv2(where):
    """OpenCV, or an ImportError naming `where`, the function that needs
    it (the port imports cv2 only at its points of use)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{where} needs OpenCV (cv2)") from e
    return cv2


def _imread(path, flags):
    """`cv2.imread(path, flags)`: `io/png.py` for the PNGs it decodes
    (8-bit, bitwise cv2's), cv2 for any other file."""
    if Path(path).suffix.lower() == ".png":
        try:
            return png.read_png(path, flags)
        except png.UnsupportedPNG:
            pass
    return require_cv2("io/stream.py:_imread").imread(str(path), flags)


def read_image(imfile, calib=None):
    """One image file as BGR uint8 (None if it cannot be read),
    undistorted when calib [fx, fy, cx, cy, k1, ...] has distortion
    terms."""
    image = _imread(imfile, png.IMREAD_COLOR)
    calib = _calib(calib) if calib is not None else ()
    if image is not None and len(calib) > 4:
        fx, fy, cx, cy = calib[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        image = require_cv2("io/stream.py:read_image").undistort(
            image, K, calib[4:])
    return image


def image_frames(imagedir, depthdir=None, maskdir=None, calib=None,
                 stride=1, skip=0, end=None):
    """Yield (t, image BGR u8, depth|None, mask|None, intrinsics[4])."""
    calib = _calib(calib)
    fx, fy, cx, cy = calib[:4]

    images = _globbed(imagedir, IMG_EXTS, skip, end, stride)
    depths = _globbed(depthdir, ("*.npy",), skip, end, stride) \
        if depthdir else None
    masks = _globbed(maskdir, IMG_EXTS, skip, end, stride) if maskdir else None

    for t, imfile in enumerate(images):
        image = read_image(imfile, calib)
        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]

        depth = None
        if depths:
            depth = np.load(str(depths[t]))[:h - h % 16, :w - w % 16]
            med = np.median(depth[depth > 0])
            depth = np.minimum(depth, 10 * med)
        mask = None
        if masks:
            mask = _imread(masks[t], png.IMREAD_GRAYSCALE)
            mask = mask[:h - h % 16, :w - w % 16].astype(bool)
        yield t, image, depth, mask, np.array([fx, fy, cx, cy])


def video_frames(videopath, calib, stride=1, skip=0):
    """Half-resolution video reader: every stride-th frame after skip,
    undistorted, resized by 0.5 (area), cropped to a multiple of 16."""
    cv2 = require_cv2("io/stream.py:video_frames")
    calib = _calib(calib)
    fx, fy, cx, cy = calib[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    cap = cv2.VideoCapture(str(videopath))
    for _ in range(skip):
        cap.read()
    t = 0
    while True:
        ret = False
        for _ in range(stride):
            ret, image = cap.read()
            if not ret:
                break
        if not ret:
            break
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])
        image = cv2.resize(image, None, fx=0.5, fy=0.5,
                           interpolation=cv2.INTER_AREA)
        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]
        yield t, image, None, None, np.array([fx, fy, cx, cy]) * 0.5
        t += 1
    cap.release()


class Prefetcher:
    """Bounded-queue background reader over any frame generator.

    With pin=True the reader thread also copies each image into a
    page-locked (pinned) torch tensor, so its later copy to the card is
    one DMA; `DPVO` takes it as it takes a numpy image. Pinning needs a
    CUDA build of torch.
    """

    def __init__(self, generator, maxsize=8, pin=False):
        self._q = queue.Queue(maxsize=maxsize)
        self._pin = pin
        self._err = None
        self._thread = threading.Thread(target=self._fill,
                                        args=(generator,), daemon=True)
        self._thread.start()

    @staticmethod
    def _pinned(item):
        import torch

        t, image, depth, mask, intr = item
        image = torch.from_numpy(np.ascontiguousarray(image)).pin_memory()
        return t, image, depth, mask, intr

    def _fill(self, generator):
        try:
            for item in generator:
                if self._pin and item[1] is not None:
                    item = self._pinned(item)
                self._q.put(item)
        except BaseException as e:              # surfaced by __iter__
            self._err = e
        finally:
            self._q.put(SENTINEL)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item[0] < 0:
                if self._err is not None:
                    raise RuntimeError("prefetch thread failed") \
                        from self._err
                return
            yield item
