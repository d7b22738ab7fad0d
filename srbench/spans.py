"""Device time of a traced stretch put down to the program's spans
(``utils.trace.span``), in the trace's frame, by span name alone: which
names a metric reads is its reader's business.

A device operation belongs to the innermost span open when the host made
the runtime call that launched it (:attr:`srbench.trace.Op.launch`).
Spans of one thread nest, so the innermost span at each instant is well
defined (:class:`Segments`).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence

from .trace import Span, Trace

# where device time outside every span, or without a launch time, goes
NONE = "none"


class Segments:
    """The innermost span at each instant, for spans that nest: the
    boundaries in order and the span that is innermost from each boundary
    to the next (None outside every span)."""

    def __init__(self, spans: Sequence[Span]):
        # at one instant: ends before starts, and an outer span's start
        # (the longer) before an inner one's
        marks = sorted([(s.start, 1, s.start - s.end, i)
                        for i, s in enumerate(spans)]
                       + [(s.end, 0, 0, i) for i, s in enumerate(spans)])
        self.bounds: List[float] = []
        self.inner: List[Optional[Span]] = []
        stack: List[int] = []
        for t, opens, _, i in marks:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            self.bounds.append(t)
            self.inner.append(spans[stack[-1]] if stack else None)

    def at(self, t: float) -> Optional[Span]:
        """The innermost span open at ``t`` (a span holds [start, end))."""
        k = bisect.bisect_right(self.bounds, t) - 1
        return self.inner[k] if k >= 0 else None


def device_ms_by_span(trace: Trace,
                      match: Optional[Callable[[str], bool]] = None
                      ) -> Optional[Dict[str, float]]:
    """Device time per call, in ms, of the operations whose name ``match``
    takes (every operation without it), by the name of the innermost span
    open at their launch (:data:`NONE` outside every span or without a
    launch time); None where the trace holds no span."""
    if not trace.spans:
        return None
    seg = Segments(trace.spans)
    out: Dict[str, float] = {}
    for o in trace.device:
        if match is not None and not match(o.name):
            continue
        s = seg.at(o.launch[0]) if o.launch else None
        where = s.name if s is not None else NONE
        out[where] = out.get(where, 0.0) + (o.end - o.start) / 1e3 / \
            trace.calls
    return out


def no_launch(trace: Trace) -> int:
    """Device operations of the stretch without a launch time."""
    return sum(o.launch is None for o in trace.device)
