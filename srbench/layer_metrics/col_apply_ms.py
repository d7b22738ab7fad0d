"""Device time per call of the library kernels (``aten_ms``'s operations)
launched inside the column applies' span ``col_apply``
(``ops/opmatrix.py BandedOp.col_apply``): gathers, GEMMs, interleaves,
ms."""

from srbench import spans


def read(trace, cell):
    by = spans.device_ms_by_span(trace, trace.is_aten)
    return by.get("col_apply") if by else None
