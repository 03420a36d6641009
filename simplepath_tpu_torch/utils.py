"""Host-side helpers: progress, online stats, stopwatch, checkpoints.

Counterpart of ``simplepath_tpu/utils.py`` (plain Python and numpy, nothing
of PyTorch; the dedup log handler is not ported: nothing uses it):

* ``ProgressBar`` — rate-limited console bar.
* ``RunningStats`` — Welford online mean/variance.
* ``Stopwatch`` — wall clock printed as hh:mm:ss.cc.
* ``save_checkpoint``/``load_checkpoint`` — film + sample-count checkpoints
  for long renders, in the JAX package's ``.npz`` layout (``film_sum``
  float32, ``samples_done`` int64, ``meta`` JSON string), so either package
  resumes the other's.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

__all__ = ["ProgressBar", "RunningStats", "Stopwatch", "format_hms",
           "save_checkpoint", "load_checkpoint"]


class ProgressBar:
    """Rate-limited console progress (redraws at most once a second)."""

    def __init__(self, total: int, label: str = "items", width: int = 50,
                 stream=None, min_interval: float = 1.0):
        self.total = max(total, 1)
        self.label = label
        self.width = width
        self.stream = stream or sys.stderr
        self.min_interval = min_interval
        self._count = 0
        self._last_draw = 0.0
        self._lock = threading.Lock()

    def update(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    def draw(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_draw < self.min_interval:
            return
        self._last_draw = now
        frac = min(self._count / self.total, 1.0)
        filled = int(frac * self.width)
        bar = "*" * filled + "-" * (self.width - filled)
        print(f"\r{int(frac * 100):3d}% |{bar}| {self._count}/{self.total} "
              f"{self.label}", end="", file=self.stream, flush=True)

    def finish(self) -> None:
        self._count = self.total
        self.draw(force=True)
        print(file=self.stream)


class RunningStats:
    """Welford online mean/variance; ``push`` takes arrays and tracks
    elementwise statistics (float64)."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def push(self, x) -> None:
        x = np.asarray(x, np.float64)
        self.n += 1
        delta = x - self._mean
        self._mean = self._mean + delta / self.n
        self._m2 = self._m2 + delta * (x - self._mean)

    def mean(self):
        return self._mean

    def variance(self):
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    def size(self) -> int:
        return self.n


def format_hms(seconds: float) -> str:
    """hh:mm:ss.cc, the reference's elapsed-time format."""
    hh, rem = divmod(int(seconds), 3600)
    mm, ss = divmod(rem, 60)
    cc = int((seconds - int(seconds)) * 100)
    return f"{hh:02d}:{mm:02d}:{ss:02d}.{cc:02d}"


class Stopwatch:
    """Wall-clock stopwatch; ``str()`` is hh:mm:ss.cc."""

    def __init__(self):
        self.start = time.monotonic()
        self.elapsed = None

    def stop(self) -> float:
        self.elapsed = time.monotonic() - self.start
        return self.elapsed

    def __str__(self) -> str:
        return format_hms(self.elapsed if self.elapsed is not None
                          else time.monotonic() - self.start)


def save_checkpoint(path, film_sum: np.ndarray, samples_done: int,
                    meta: dict | None = None) -> None:
    """Save an accumulated (unaveraged) film + spp count; resumable."""
    np.savez(path, film_sum=np.asarray(film_sum, np.float32),
             samples_done=np.int64(samples_done),
             meta=json.dumps(meta or {}))


def load_checkpoint(path):
    """→ (film_sum, samples_done, meta), or None if there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return z["film_sum"], int(z["samples_done"]), json.loads(str(z["meta"]))
