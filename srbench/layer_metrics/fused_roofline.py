"""K2 + K3's share of their roofline, %: the least time the call's fused
iterations could take (:mod:`srbench.work.fused`) over their device time
per call."""

from srbench.work import fused

from . import fused_ms


def read(trace, cell):
    ms = fused_ms.read(trace, cell)
    if not ms:
        return None
    return 100.0 * fused.bound_ms(cell.config, cell.traffic, cell.ops) / ms
