"""Loop-candidate retrieval protocol (backend-agnostic).

Counterpart of the JAX package's `loop/retrieval.py`: a descriptor buffer
keyed by keyframe index with renumbering on eviction, deferred insertion
(`save_up_to`), per-query NMS against the loops already closed, and the
consecutive-detection repetition check. Two databases: "vlad" (the float
`netvlad.DescriptorDatabase`) and "dbow" (`BinaryDatabase`, the native
binary inverted file of `native/graphlib.cpp`).
"""

from __future__ import annotations

import numpy as np

NMS = 50
SKIP_WINDOW = 50


class BinaryDatabase:
    """The DescriptorDatabase protocol over the native bag-of-binary-words
    retrieval (`native.BinaryRetrieval`): float descriptors are
    LSH-binarised on insert, and scores are inverted-file votes, not
    cosines (set LOOP_RETR_THRESH for them)."""

    def __init__(self, skip_window=SKIP_WINDOW):
        from ..native import BinaryRetrieval

        self.db = BinaryRetrieval(rad=skip_window)

    def insert_desc(self, n, desc):
        self.db.insert_image(n, np.asarray(desc, np.float32)
                             .reshape(-1, 128))

    def query_online(self, n, skip_window=50, top_k=1):
        j, score, _ = self.db.query(n)
        if j is None:
            return None, None
        return score, j


def make_database(backend, dim, skip_window=SKIP_WINDOW, **kw):
    """"vlad" (float dot products) or "dbow" (the native binary inverted
    file)."""
    if backend == "dbow":
        return BinaryDatabase(skip_window=skip_window)
    if backend != "vlad":
        raise ValueError(f"RETRIEVAL_BACKEND {backend!r}: 'vlad' or 'dbow'")
    from .netvlad import DescriptorDatabase

    return DescriptorDatabase(dim, **kw)


class Retrieval:
    def __init__(self, database, nms=NMS, skip_window=SKIP_WINDOW):
        self.db = database
        self.nms = nms
        self.skip_window = skip_window
        self.descriptor_buffer = {}
        self.stored = np.zeros(100000, dtype=bool)
        self.pending = []          # (i, score, j) awaiting detect_loop
        self.prev_loop_closes = []
        self.found = []

    # ---- frame ingest ----------------------------------------------------
    def add_frame(self, n, desc):
        """Buffer the descriptor of keyframe slot n (may still be evicted)."""
        self.descriptor_buffer[n] = desc

    def keyframe(self, k):
        """Slot k was evicted: renumber the buffered (unsaved) slots."""
        tmp = dict(self.descriptor_buffer)
        self.descriptor_buffer.clear()
        for n, v in tmp.items():
            if n != k:
                self.descriptor_buffer[(n - 1) if n > k else n] = v

    def save_up_to(self, c):
        """Slots <= c can no longer be evicted: insert and query them."""
        for n in sorted(self.descriptor_buffer):
            if n <= c:
                if self.stored[n]:
                    raise RuntimeError(f"keyframe {n} stored twice")
                desc = self.descriptor_buffer.pop(n)
                self.db.insert_desc(n, desc)
                self.stored[n] = True
                score, j = self.db.query_online(n, self.skip_window, top_k=1)
                self.pending.append((n, 0.0 if score is None else score, j))

    # ---- loop detection --------------------------------------------------
    def confirm_loop(self, i, j):
        if not i > j:
            raise ValueError(f"a loop ({i}, {j}) must close backwards")
        self.prev_loop_closes.append((i, j))

    def _repetition_check(self, idx, num_repeat):
        """num_repeat consecutive queries detected: the middle one."""
        if len(self.found) < num_repeat:
            return None
        oldest_query = self.found[-num_repeat][0]
        if 1 + idx - oldest_query != num_repeat:
            return None
        i, j = self.found[-num_repeat + num_repeat // 2]
        return (i, max(j, 1))

    def detect_loop(self, thresh, num_repeat=1):
        """Consume pending queries until one passes the score threshold,
        the NMS against closed loops and the repetition check: (i, j), or
        None when the queue runs dry."""
        while self.pending:
            i, score, j = self.pending.pop(0)
            if score < thresh or j is None:
                continue
            dists = [np.square(i - a) + np.square(j - b)
                     for a, b in self.prev_loop_closes]
            if min(dists, default=np.inf) < self.nms ** 2:
                continue
            self.found.append((i, j))
            cand = self._repetition_check(i, num_repeat)
            if cand is not None:
                return cand
        return None
