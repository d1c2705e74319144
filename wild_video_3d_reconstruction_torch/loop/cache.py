"""Keyframe image cache for loop closure.

Counterpart of the JAX package's `loop/cache.py`, with the same
deferred-commit and keyframe-renumbering protocol (`add_frame`, `keyframe`,
`save_up_to`, `load_frames`). The frames are kept raw: the JAX package
JPEG-95-encodes each committed frame with cv2 to save host memory (about
50 KB a frame), which the card's machine cannot (no cv2), and which would
change the pixels the keypoints are detected on. A 384x512 frame is
589 824 bytes, so 1 000 keyframes hold about 590 MB of host memory.
"""

from __future__ import annotations

import numpy as np


class ImageCache:
    def __init__(self):
        self.buffer = {}          # slot -> image (may still renumber)
        self.saved = {}           # slot -> committed image
        self.stored = np.zeros(100000, dtype=bool)

    def add_frame(self, image, n):
        self.buffer[n] = image

    def keyframe(self, k):
        tmp = dict(self.buffer)
        self.buffer.clear()
        for n, v in tmp.items():
            if n != k:
                self.buffer[(n - 1) if n > k else n] = v

    def save_up_to(self, c):
        for n in sorted(self.buffer):
            if n <= c:
                if self.stored[n]:
                    raise RuntimeError(f"frame {n} cached twice")
                self.stored[n] = True
                self.saved[n] = np.ascontiguousarray(self.buffer.pop(n),
                                                     np.uint8)

    def load_frames(self, indices):
        """Cached frames -> [len(indices), H, W, 3] uint8; frames not
        committed yet (the wide end of a LOOP_KP_STRIDE > 1 triplet) come
        from the deferred buffer."""
        return np.stack([self.saved[i] if i in self.saved else
                         np.asarray(self.buffer[i], np.uint8)
                         for i in indices])

    def close(self):
        self.buffer.clear()
        self.saved.clear()
