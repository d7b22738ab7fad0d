"""Device activity over a steady stretch of whole calls, read from
``torch.profiler`` in memory, and what the per-layer readers need of it.

The profiler records CUDA activity only: the device's operations and the
CUDA runtime calls the host makes.  Recording every host operator as well
would slow each launch by microseconds, thousands of times a call, and
the device would read idler than it is.  The stretch runs from the start
of the first device operation of its calls (the first call's upload) to
the end of the last (the last call's copy to the host), so it holds the
gaps between its calls but the first's lead-in and the last's tail.  The
program's own kernels are known by the ``__global__`` names of its CUDA
sources.  Each device operation carries the host interval of the CUDA
runtime call that launched it (the runtime event of its correlation id),
and the trace holds the program's spans closed during the stretch, both in
the trace's own frame (us from the profiler's start), so that
:mod:`srbench.spans` can put device time down to the span the host was
in.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import (Callable, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

NAME_CHARS = 200        # a name in the breakdown is cut to this length
TOP = 10                # entries of each breakdown list


class Op(NamedTuple):
    name: str
    start: float        # us from the profiler's start
    end: float
    # a device operation's launch call on the host (us), where the trace
    # holds it
    launch: Optional[Tuple[float, float]] = None


class Span(NamedTuple):
    """One of the program's spans (``utils.trace.Span``) in the trace's
    frame: its name, its parent's name, its host interval in us."""
    name: str
    parent: Optional[str]
    start: float
    end: float


def port_kernels(package_dir: Path) -> List[str]:
    """The ``__global__`` function names of the program's CUDA sources
    (``csrc/*.cu``): the first name called after each ``__global__`` that
    is not ``__launch_bounds__``."""
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            for call in re.finditer(r"\b(\w+)\s*\(", text[m.end():]):
                if call.group(1) != "__launch_bounds__":
                    names.add(call.group(1))
                    break
    return sorted(names)


def _union(ops: Iterable[Op]) -> List[Op]:
    """Disjoint intervals covering ``ops``, in order."""
    out: List[Op] = []
    for op in sorted(ops, key=lambda o: o.start):
        if out and op.start <= out[-1].end:
            if op.end > out[-1].end:
                out[-1] = out[-1]._replace(end=op.end)
        else:
            out.append(Op("", op.start, op.end))
    return out


class Trace:
    """The traced stretch: ``calls`` whole calls from ``start`` to ``end``
    (us), the device's operations and the host's runtime calls inside
    it."""

    def __init__(self, device: Sequence[Op], host: Sequence[Op],
                 start: float, end: float, calls: int,
                 kernels: Sequence[str] = (), spans: Sequence[Span] = ()):
        self.start, self.end, self.calls = start, end, calls
        self.device = [o._replace(start=max(o.start, start),
                                  end=min(o.end, end))
                       for o in device if o.end > start and o.start < end]
        self.host = [o for o in host if o.end > start and o.start < end]
        self.spans = list(spans)
        self._kernel = (re.compile(r"\b(" + "|".join(map(re.escape, kernels))
                                   + r")\b") if kernels else None)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device."""
        return sum(o.end - o.start for o in _union(self.device)) / 1e6

    def port_kernel(self, name: str) -> Optional[str]:
        """The program's kernel that a device operation is, or None."""
        m = self._kernel.search(name) if self._kernel else None
        return m.group(1) if m else None

    def is_aten(self, name: str) -> bool:
        """Whether a device operation is neither a kernel of the program
        nor a copy: a library kernel (``aten_ms``'s operations)."""
        return self.port_kernel(name) is None and not name.startswith(
            "Memcpy")

    def ms_per_call(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device time per call of the operations whose name ``match``
        takes, in ms; None where there is none."""
        hit = [o.end - o.start for o in self.device if match(o.name)]
        return sum(hit) / 1e3 / self.calls if hit else None

    def idle_gaps(self, top: int = TOP) -> List[Op]:
        """The ``top`` longest idle intervals of the device inside the
        stretch, longest first, each named by the innermost host operation
        running at its middle (``no host op`` where none is)."""
        gaps, t = [], self.start
        for busy in _union(self.device) + [Op("", self.end, self.end)]:
            if busy.start > t:
                gaps.append((t, busy.start))
            t = max(t, busy.end)
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) / 2
            over = [o for o in self.host if o.start <= mid <= o.end]
            out.append(Op(min(over, key=lambda o: o.end - o.start).name
                          if over else "no host op", a, b))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, in seconds over the stretch."""
        by_name: dict = {}
        for o in self.device:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:NAME_CHARS], v / 1e6] for k, v in top],
                "idle_gaps": [[g.name[:NAME_CHARS], (g.end - g.start) / 1e6]
                              for g in self.idle_gaps()]}


def from_profiler(prof, calls: int, kernels: Sequence[str],
                  spans: Sequence = ()) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` of CUDA
    activity that held ``calls`` whole calls and nothing else, with the
    program's ``spans`` (``utils.trace.Span``, Unix ns, the clock of
    kineto's events) closed meanwhile.  A device operation's launch is the
    CUDA runtime call (``cu*``) of its correlation id: not CUPTI's own
    host events, which can share it."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        if getattr(e, "is_user_annotation", False):
            continue
        (device if e.device_type == DeviceType.CUDA else host).append(
            (e.id, op))
    if not device:
        raise RuntimeError("the trace holds no device operation")
    runtime = {cid: (o.start, o.end) for cid, o in host
               if cid > 0 and o.name.startswith("cu")}
    ops = [o._replace(launch=runtime.get(cid)) for cid, o in device]
    # the events' us count from kineto's trace start, in Unix ns
    base = prof.profiler.kineto_results.trace_start_ns()
    return Trace(ops, [o for _, o in host], min(o.start for o in ops),
                 max(o.end for o in ops), calls, kernels,
                 [Span(s.name, s.parent, (s.t0_ns - base) / 1e3,
                       (s.t1_ns - base) / 1e3) for s in spans])
