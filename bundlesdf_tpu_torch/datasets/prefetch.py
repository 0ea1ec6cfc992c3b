"""Background-thread frame prefetcher.

Port of `bundlesdf_tpu/datasets/prefetch.py`. The reference decodes each
frame synchronously on the tracking thread (`run_custom.py:73-99`); here a
worker pool decodes ahead so image IO overlaps device compute (zlib, which
`utils/png.py` decodes with, releases the GIL). Wraps any reader exposing
get_color/get_depth/get_mask/get_occ_mask. As in the JAX package, nothing
on the main path uses it: `run_custom.run_one_video` reads frames in turn.
"""
from __future__ import annotations

import queue
import threading


class PrefetchReader:
    def __init__(self, reader, ahead: int = 4, workers: int = 2):
        self.reader = reader
        self.K = reader.K
        self.id_strs = reader.id_strs
        self._ahead = ahead
        self._cache: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._jobs: queue.Queue = queue.Queue()
        self._next_to_schedule = 0
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(workers)]
        for t in self._threads:
            t.start()
        self._schedule_upto(ahead)

    def __len__(self):
        return len(self.reader)

    def get_video_name(self):
        return self.reader.get_video_name()

    def _load(self, i):
        out = {
            "color": self.reader.get_color(i),
            "depth": self.reader.get_depth(i),
            "mask": self.reader.get_mask(i),
        }
        if hasattr(self.reader, "get_occ_mask"):
            try:
                out["occ_mask"] = self.reader.get_occ_mask(i)
            except Exception:
                out["occ_mask"] = None
        return out

    def _worker(self):
        while True:
            i = self._jobs.get()
            if i is None:
                return
            data = self._load(i)
            with self._cv:
                self._cache[i] = data
                self._cv.notify_all()

    def _schedule_upto(self, upto):
        upto = min(upto, len(self.reader))
        while self._next_to_schedule < upto:
            self._jobs.put(self._next_to_schedule)
            self._next_to_schedule += 1

    def frame(self, i) -> dict:
        """Blocking fetch of frame i; schedules the window ahead."""
        self._schedule_upto(i + 1 + self._ahead)
        with self._cv:
            while i not in self._cache:
                self._cv.wait(timeout=30)
            return self._cache.pop(i)

    def get_color(self, i):
        return self._peek(i)["color"]

    def get_depth(self, i):
        return self._peek(i)["depth"]

    def get_mask(self, i):
        return self._peek(i)["mask"]

    def get_occ_mask(self, i):
        return self._peek(i).get("occ_mask")

    def _peek(self, i):
        """Fetch without evicting (per-field access pattern)."""
        self._schedule_upto(i + 1 + self._ahead)
        with self._cv:
            while i not in self._cache:
                self._cv.wait(timeout=30)
            return self._cache[i]

    def evict(self, i):
        with self._lock:
            self._cache.pop(i, None)

    def close(self):
        for _ in self._threads:
            self._jobs.put(None)
