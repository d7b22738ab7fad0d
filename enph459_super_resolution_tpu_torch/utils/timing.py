"""Structured per-stage wall-clock timing (counterpart of
``enph459_super_resolution_tpu/utils/timing.py``) and the host's resident
memory."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class StageTimer:
    """Accumulates named wall-clock stages; ``as_dict`` for metrics JSON."""

    def __init__(self) -> None:
        self._t: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._t[name] = self._t.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self._t)


def rss_mb() -> int:
    """Host resident-set size in MB (logged in the trainers' metrics.jsonl
    so that host memory growth over a long run shows); -1 where
    ``/proc/self/status`` cannot be read."""
    try:
        with open("/proc/self/status") as fp:
            for line in fp:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return -1
