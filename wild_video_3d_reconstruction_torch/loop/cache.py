"""Keyframe image cache for loop closure.

The port's copy of the JAX package's `loop/cache.py`, the reference's
image cache (`dpvo/loop_closure/retrieval/image_cache.py:15-71`), which
writes JPEG-95 files from a worker: here each committed frame is
JPEG-95-encoded in memory (about 80 KB a 384x512 frame) by one worker
thread, with the same deferred-commit and keyframe-renumbering protocol
(`add_frame`, `keyframe`, `save_up_to`, `load_frames`). The keypoints of
a loop closure are found on the decoded frames, as in the JAX package.
The encoding needs OpenCV, imported where it is used; without it
`save_up_to` and `load_frames` raise ImportError.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..io.stream import require_cv2

JPEG_QUALITY = 95


class ImageCache:
    def __init__(self):
        self.buffer = {}          # slot -> raw image (may still renumber)
        self.saved = {}           # slot -> encoded JPEG bytes
        self.stored = np.zeros(100000, dtype=bool)
        # one worker thread keeps the encoding off the tracking thread
        # (cv2.imencode releases the GIL)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def add_frame(self, image, n):
        self.buffer[n] = image

    def keyframe(self, k):
        tmp = dict(self.buffer)
        self.buffer.clear()
        for n, v in tmp.items():
            if n != k:
                self.buffer[(n - 1) if n > k else n] = v

    def _encode(self, n, img):
        cv2 = require_cv2("loop/cache.py:ImageCache.save_up_to")
        ok, enc = cv2.imencode(
            ".jpg", np.ascontiguousarray(img, np.uint8),
            [int(cv2.IMWRITE_JPEG_QUALITY), JPEG_QUALITY])
        if not ok:
            raise RuntimeError(f"JPEG encoding of frame {n} failed")
        self.saved[n] = enc.tobytes()

    def save_up_to(self, c):
        for n in sorted(self.buffer):
            if n <= c:
                if self.stored[n]:
                    raise RuntimeError(f"frame {n} cached twice")
                # raise here, not in the worker
                require_cv2("loop/cache.py:ImageCache.save_up_to")
                img = self.buffer.pop(n)
                self.stored[n] = True
                self._pending.append(self._pool.submit(self._encode, n, img))

    def has(self, n):
        """Whether frame n is cached: committed (from the commit on, so the
        answer does not hang on the worker's progress) or deferred."""
        return bool(self.stored[n]) or n in self.buffer

    def flush(self):
        for f in self._pending:
            f.result()
        self._pending.clear()

    def load_frames(self, indices):
        """Cached frames -> [len(indices), H, W, 3] uint8 (BGR), decoded;
        frames not committed yet (the wide end of a LOOP_KP_STRIDE > 1
        triplet) come raw from the deferred buffer."""
        self.flush()
        out = []
        for i in indices:
            if i in self.saved:
                cv2 = require_cv2("loop/cache.py:ImageCache.load_frames")
                data = np.frombuffer(self.saved[i], np.uint8)
                out.append(cv2.imdecode(data, cv2.IMREAD_COLOR))
            else:
                out.append(np.asarray(self.buffer[i], np.uint8))
        return np.stack(out)

    def close(self):
        self.flush()
        self.buffer.clear()
        self.saved.clear()
