"""Spans and counters inside the port, on the clock of the device trace.

Tracing is off by default.  ``recording()`` turns it on for a block and
returns the record of that block::

    from simplepath_tpu_torch import tracing

    with tracing.recording() as rec:
        render_image_sharded(scene, 1, key, device=device)
    rec.summary()   # {"spans": {name: {count, total_s, self_s, first_s}},
                    #  "counters": {...}, "frames": 1, "orphans": 0}

A span (``span(name, **attrs)``, a context manager) records its name, its
start and end (``time.perf_counter_ns``), the id of its parent span and its
thread, its attributes (``set`` adds more once it is open), and the index of
the ``frame`` span it falls under: each ``frame`` span takes the next index
of its record, and every span inside it shares that index, the pass's
request id.  A span opened on a thread that has none open, as autograd's
device thread opens the spans of a checkpointed bounce it recomputes, takes
as parent the innermost span open on any thread (there: ``train.backward``,
in which the caller is blocked).  ``count(name, n)`` adds to a counter of the
record.  ``register`` makes a dict that a module keeps counting in itself
(the kernel wrappers' ``launch_counts``) a group of this registry: the
summary reports what each of its keys gained during the block.

Off, ``span`` returns one shared no-op context manager and ``count`` returns
at once: a span site costs a function call and a global read, and nothing is
recorded.  Spans named ``wait.*`` (``wait``, and the bounce loop's
``wait.alive`` around its one read of the alive mask) are the only spans
that synchronise, and only while tracing is on: off, no span adds a
synchronise, a reduction or a launch.

While tracing is on and a ``torch.profiler`` profile is recording, each span
also opens ``torch.profiler.record_function("sp.<name>")``, so its interval
sits on the profiler's host timeline, which the profiler aligns with the
device's kernels: a Chrome trace then names each idle stretch of the device
by the innermost ``sp.*`` span open at its start.

The spans and counters the port records, and the metric or operator use
that reads each, are listed in ``PERF.md`` §3.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["span", "count", "wait", "enabled", "recording", "register",
           "Record", "FRAME", "WAIT", "PROFILER_PREFIX"]

FRAME = "frame"
WAIT = "wait."
PROFILER_PREFIX = "sp."

# the record of the innermost recording() block; None while tracing is off
_record: Record | None = None
# the spans open on each thread, innermost last
_local = threading.local()
# counter groups: name → a dict that its module increments itself
_groups: dict[str, dict] = {}


class _Off:
    """The one context manager every span site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def enabled() -> bool:
    return _record is not None


def span(name: str, /, **attrs):
    """A span of the current record (a context manager), or the shared no-op
    one while tracing is off."""
    rec = _record
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current record."""
    rec = _record
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def wait(name: str, device) -> None:
    """While tracing is on: a span ``wait.<name>`` around a synchronise of
    ``device`` (a CUDA device; on another device the span is empty).  Off:
    nothing."""
    if _record is None:
        return
    with _Span(_record, WAIT + name, {}):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def register(group: str, counts: dict) -> dict:
    """Make ``counts`` (str → int, incremented by its module) the counter
    group ``group``; returns the same dict."""
    _groups[group] = counts
    return counts


@contextlib.contextmanager
def recording():
    """Turn spans and counters on for the block → its :class:`Record`.
    Blocks nest: the inner one records alone until it ends."""
    global _record
    outer = _record
    rec = Record()
    _record = rec
    try:
        yield rec
    finally:
        _record = outer
        rec._end_groups()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "thread", "frame", "start",
                 "end", "_rec", "_profiled")

    def __init__(self, rec: Record, name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.end = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        rec, stack = self._rec, _stack()
        with rec._lock:
            up = stack[-1] if stack else (rec._open[-1] if rec._open else None)
            self.id = len(rec.spans)
            rec.spans.append(self)
            rec._open.append(self)
            if self.name == FRAME:
                self.frame = rec.frames
                rec.frames += 1
            else:
                self.frame = up.frame if up is not None else None
        self.parent = up.id if up is not None else None
        self.thread = threading.get_ident()
        stack.append(self)
        self._profiled = None
        if torch.autograd._profiler_enabled():
            self._profiled = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self._profiled.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._profiled is not None:
            self._profiled.__exit__(None, None, None)
        _stack().pop()
        with self._rec._lock:
            self._rec._open.remove(self)
        return False


class Record:
    """The spans and counters of one ``recording()`` block."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.counters: dict[str, int] = {}
        self.frames = 0
        self.thread = threading.get_ident()
        self._open: list[_Span] = []
        self._lock = threading.Lock()
        self._groups_at = {g: dict(c) for g, c in _groups.items()}
        self._gained: dict[str, int] | None = None

    def _end_groups(self) -> None:
        self._gained = self._groups_now()

    def _groups_now(self) -> dict[str, int]:
        out = {}
        for g, c in _groups.items():
            at = self._groups_at.get(g, {})
            out.update({f"{g}.{k}": v - at.get(k, 0) for k, v in c.items()})
        return out

    def closed(self) -> list[_Span]:
        return [s for s in self.spans if s.end is not None]

    def summary(self) -> dict:
        """For each span name its count, total seconds, self seconds (its
        time less the part of it that its child spans cover, on whatever
        thread) and the seconds of its first span; every counter, and what
        each registered group's keys gained in the block (so far, inside
        it); the
        frames opened, and the spans without a parent opened on another
        thread than the block's (orphans)."""
        done = self.closed()
        kids: dict[int, list] = {}
        for s in done:
            if s.parent is not None:
                kids.setdefault(s.parent, []).append((s.start, s.end))
        spans: dict[str, dict] = {}
        orphans = 0
        for s in done:
            dur = s.end - s.start
            covered = sum(e - b for b, e in _union(
                [(max(b, s.start), min(e, s.end)) for b, e in kids.get(s.id, [])]))
            row = spans.setdefault(s.name, dict(count=0, total_s=0.0, self_s=0.0,
                                                first_s=dur * 1e-9))
            row["count"] += 1
            row["total_s"] += dur * 1e-9
            row["self_s"] += (dur - covered) * 1e-9
            orphans += s.parent is None and s.thread != self.thread
        counters = dict(self.counters)
        counters.update(self._groups_now() if self._gained is None
                        else self._gained)
        return dict(spans=spans, counters=counters, frames=self.frames,
                    orphans=orphans)


def _union(iv: list) -> list:
    out: list = []
    for b, e in sorted(iv):
        if e <= b:
            continue
        if out and b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return out
