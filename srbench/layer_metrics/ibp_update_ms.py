"""Device time per call of the library kernels (``aten_ms``'s operations)
launched inside the IBP loop's span ``solve.ibp`` outside ``col_apply``:
the update's elementwise work and the MSE reductions
(``sr/classical.py _banded_update``, ``_rep_mse``), ms."""

from srbench import spans


def read(trace, cell):
    by = spans.device_ms_by_span(trace, trace.is_aten)
    return by.get("solve.ibp") if by else None
