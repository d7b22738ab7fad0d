"""Nonzero band entries of a dense 1-D operator, and distinct operators."""

from typing import List, Sequence

import numpy as np

# An entry counts where it can move a float32 result: at least 2^-24 of
# the largest entry of its row.  The spline prefilter's impulse response
# never reaches zero, so a threshold is needed; below it an entry's
# products vanish in a float32 sum.
SHARE = 2.0 ** -24


def nonzeros(m: np.ndarray) -> int:
    """Entries of ``m`` at least ``SHARE`` of their row's largest."""
    a = np.abs(m)
    return int(((a > 0) & (a >= SHARE * a.max(axis=1, keepdims=True))).sum())


def distinct(ops: Sequence[np.ndarray]) -> List[np.ndarray]:
    """``ops`` with repeats (equal entry for entry) left out."""
    out: List[np.ndarray] = []
    for m in ops:
        if not any(u.shape == m.shape and np.array_equal(u, m) for u in out):
            out.append(m)
    return out
