"""K1's share of its roofline, %: the least time the call's row applies
could take (:mod:`srbench.work.k1`) over K1's device time per call."""

from srbench.work import k1

from . import k1_ms


def read(trace, cell):
    ms = k1_ms.read(trace, cell)
    if not ms:
        return None
    return 100.0 * k1.bound_ms(cell.config, cell.traffic, cell.ops) / ms
