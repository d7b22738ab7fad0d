"""Rate of the frames' upload in the solve entry (``_prepare``), GB/s:
the bytes the program counts per call (``classical._prepare.h2d_bytes``
over ``_prepare.calls``, over the process's calls, which are all alike)
over ``h2d_ms``.  None for a program without these counters."""

from . import h2d_ms


def read(trace, cell):
    from enph459_super_resolution_tpu_torch.sr import classical

    calls = getattr(classical._prepare, "calls", 0)
    sent = getattr(classical._prepare, "h2d_bytes", 0)
    ms = h2d_ms.read(trace, cell)
    if not (calls and sent and ms):
        return None
    return sent / calls / (ms * 1e6)
