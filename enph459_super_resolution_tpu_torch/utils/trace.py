"""Tracing / profiling helpers.

The port's counterpart of ``enph459_super_resolution_tpu/utils/trace.py``.
The reference's observability is ad-hoc ``print(time.time())`` deltas
(SURVEY.md §5); here: structured stage timing that persists to JSON
(``utils.timing.StageTimer``), a profiler context that writes a
``torch.profiler`` Chrome trace (host ops, and the card's kernels and
copies where a card is present) viewable in Perfetto or
``chrome://tracing``, where the JAX package captures a ``jax.profiler``
trace, and a tiny JSONL metrics logger shared by the CLIs.

Spans: :func:`span` marks where the program's work happens (``solve`` and
its phases, each column apply, a kernel's build or load, the stages of
``StageTimer``).  Spans are off by default, and then ``span`` costs one
test of a module-level flag and returns one shared object that does
nothing.  :func:`set_spans` turns them on; each closed span is then kept as
a :class:`Span` in a bounded buffer (the oldest dropped and counted when it
is full) until :func:`drain_spans` takes them.  Spans are stamped with
``time.time_ns()``, the clock of the profiler's events (kineto's
``trace_start_ns`` and ``start_ns``: Unix ns), so a device operation can be
put in the span whose host interval holds its launch.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

SPAN_CAPACITY = 1 << 16     # spans the buffer holds by default


class Span(NamedTuple):
    """One closed span: its name, the name of the span it opened inside
    (None at the top), its host interval in Unix ns, and what it noted."""
    name: str
    parent: Optional[str]
    t0_ns: int
    t1_ns: int
    args: Optional[Dict] = None


_SPANS_ON = False
_BUFFER: Deque[Span] = collections.deque(maxlen=SPAN_CAPACITY)
_DROPPED = 0
_LOCK = threading.Lock()
_OPEN = threading.local()   # .stack: the open spans of each thread


class _NoSpan:
    """What :func:`span` returns while spans are off: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def note(self, **args) -> None:
        """Attach ``args`` to the span (nothing while spans are off)."""


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "parent", "t0_ns", "args")

    def __init__(self, name: str):
        self.name, self.args = name, None

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.time_ns()
        _OPEN.stack.pop()
        _keep(Span(self.name, self.parent, self.t0_ns, t1, self.args))
        return None

    def note(self, **args) -> None:
        """Attach ``args`` to the span (its record's ``args``)."""
        self.args = dict(self.args or {}, **args)


def _keep(s: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_BUFFER) == _BUFFER.maxlen:
            _DROPPED += 1
        _BUFFER.append(s)


def span(name: str):
    """A context manager marking a span of the program's work named
    ``name``; ``as`` gives an object whose ``note(**args)`` attaches
    ``args`` to the record.  While spans are off: one shared object that
    does nothing."""
    if not _SPANS_ON:
        return _NO_SPAN
    return _OpenSpan(name)


def set_spans(on: bool, capacity: Optional[int] = None) -> bool:
    """Turn spans on or off; ``capacity`` resizes the buffer (keeping its
    newest spans).  Returns whether they were on."""
    global _SPANS_ON, _BUFFER, _DROPPED
    with _LOCK:
        was = _SPANS_ON
        if capacity is not None and capacity != _BUFFER.maxlen:
            if capacity < 1:
                raise ValueError(f"capacity {capacity}: must be at least 1")
            _DROPPED += max(0, len(_BUFFER) - capacity)
            _BUFFER = collections.deque(_BUFFER, maxlen=capacity)
        _SPANS_ON = bool(on)
    return was


def drain_spans() -> Tuple[List[Span], int]:
    """The spans kept since the last drain, in the order they closed (a
    child before its parent), and how many were dropped from the full
    buffer meanwhile; empties both."""
    global _DROPPED
    with _LOCK:
        out, dropped = list(_BUFFER), _DROPPED
        _BUFFER.clear()
        _DROPPED = 0
    return out, dropped


def _chrome_span_events(spans: List[Span], base_ns: int) -> List[Dict]:
    """``spans`` as complete events of a Chrome trace whose timestamps are
    us after ``base_ns``, on a track of their own."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": "spans",
               "args": {"name": "spans"}}]
    for s in spans:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": "spans", "ts": (s.t0_ns - base_ns) / 1e3,
                       "dur": (s.t1_ns - s.t0_ns) / 1e3,
                       "args": dict(s.args or {}, parent=s.parent)})
    return events


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present), with spans on, and write its Chrome
    trace ``trace_<time>_<pid>.json`` into ``log_dir``, the block's spans on
    a track named ``spans``.  Yields the profiler (None when not
    ``enabled``); the trace's path is its ``trace_path`` once the block has
    ended.  The spans stay in the buffer for :func:`drain_spans`."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    was_on = set_spans(True)
    prof.start()
    t0 = time.time_ns()
    try:
        yield prof
    finally:
        t1 = time.time_ns()
        prof.stop()
        set_spans(was_on)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        prof.trace_path = os.path.join(log_dir,
                                       f"trace_{stamp}_{os.getpid()}.json")
        prof.export_chrome_trace(prof.trace_path)
        with _LOCK:
            inside = [s for s in _BUFFER if s.t0_ns >= t0 and s.t1_ns <= t1]
        with open(prof.trace_path) as fp:
            chrome = json.load(fp)
        # kineto writes ts in us after baseTimeNanoseconds (Unix ns)
        chrome["traceEvents"] += _chrome_span_events(
            inside, int(chrome.get("baseTimeNanoseconds", 0)))
        with open(prof.trace_path, "w") as fp:
            json.dump(chrome, fp)


class MetricsLogger:
    """Append-only JSONL metrics stream with wall-clock stamps."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._t0 = time.time()

    def log(self, record: Dict, **extra) -> None:
        rec = dict(record)
        rec.update(extra)
        rec.setdefault("wall_s", round(time.time() - self._t0, 3))
        with open(self.path, "a") as fp:
            fp.write(json.dumps(rec) + "\n")
