"""Structured per-stage wall-clock timing (counterpart of
``enph459_super_resolution_tpu/utils/timing.py``)."""

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
