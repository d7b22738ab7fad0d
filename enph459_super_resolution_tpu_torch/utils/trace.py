"""Tracing / profiling helpers.

The port's counterpart of ``enph459_super_resolution_tpu/utils/trace.py``.
The reference's observability is ad-hoc ``print(time.time())`` deltas
(SURVEY.md §5); here: structured stage timing that persists to JSON
(``utils.timing.StageTimer``), a profiler context that writes a
``torch.profiler`` Chrome trace (host ops, and the card's kernels and
copies where a card is present) viewable in Perfetto or
``chrome://tracing``, where the JAX package captures a ``jax.profiler``
trace, and a tiny JSONL metrics logger shared by the CLIs.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace
    ``trace_<time>_<pid>.json`` into ``log_dir``.  Yields the profiler (None
    when not ``enabled``); the trace's path is its ``trace_path`` once the
    block has ended."""
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
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        stamp = time.strftime("%Y%m%d_%H%M%S")
        prof.trace_path = os.path.join(log_dir,
                                       f"trace_{stamp}_{os.getpid()}.json")
        prof.export_chrome_trace(prof.trace_path)


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
