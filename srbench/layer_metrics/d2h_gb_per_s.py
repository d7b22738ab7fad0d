"""Rate of the copy of a call's results to the host (``_to_host``), GB/s:
the bytes the program counts per call (``classical._to_host.d2h_bytes``
over ``_prepare.calls``, over the process's calls, which are all alike)
over ``d2h_ms``.  None for a program without these counters."""

from . import d2h_ms


def read(trace, cell):
    from enph459_super_resolution_tpu_torch.sr import classical

    calls = getattr(classical._prepare, "calls", 0)
    back = getattr(classical._to_host, "d2h_bytes", 0)
    ms = d2h_ms.read(trace, cell)
    if not (calls and back and ms):
        return None
    return back / calls / (ms * 1e6)
