"""The port's spans against the profiler on the card.  Needs an NVIDIA
card with the CUDA toolkit; skips without one.  Run on the card with
``python -m pytest --noconftest tests/test_torch_spans_cuda.py -q``.

A small warm banded solve under ``torch.profiler`` (CUDA activity, as the
benchmark records it) with spans on: every device operation has a launch
time (the CUDA runtime call of its correlation id), each launch call lies
inside the innermost span open at its start (spans and kineto on one
clock), every GEMM is launched inside a ``col_apply`` and no K1 launch is,
the upload lies in ``solve.prepare`` and the copy back in
``solve.to_host``.  The copy counters read the frames' float32 bytes and
the results' bytes exactly.
"""

import bisect

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.sr import classical
from enph459_super_resolution_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

SHIFTS = [(0.0, 0.0), (0.5, -0.5), (0.5, 0.5), (-0.5, -0.5), (-0.5, 0.5)]
N_ITER = 4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trace.set_spans(False)
    trace.drain_spans()
    yield
    trace.set_spans(False)
    trace.drain_spans()


def _frames(units=None):
    rng = np.random.default_rng(5)
    shape = (len(SHIFTS), 64, 128) if units is None else (
        units, len(SHIFTS), 64, 128)
    return rng.integers(0, 256, shape).astype(np.float32)


def _innermost(spans, t):
    """The innermost span whose interval [t0, t1) holds ``t``."""
    inside = [s for s in spans if s.t0_ns <= t < s.t1_ns]
    return min(inside, key=lambda s: s.t1_ns - s.t0_ns) if inside else None


def test_launches_fall_inside_their_spans(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    psf = classical.make_gaussian_psf()
    lr = _frames()
    classical.solve(lr, psf, SHIFTS, n_iter=N_ITER)    # warm: packs, build
    trace.set_spans(True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        classical.solve(lr, psf, SHIFTS, n_iter=N_ITER)
    trace.set_spans(False)
    spans, dropped = trace.drain_spans()
    assert dropped == 0
    assert sum(s.name == "col_apply" for s in spans) == \
        len(SHIFTS) + 2 + 2 * len(SHIFTS) * N_ITER
    events = prof.profiler.kineto_results.events()
    runtime = {e.correlation_id(): e for e in events
               if e.device_type() != DeviceType.CUDA
               and e.correlation_id() > 0 and e.name().startswith("cu")}
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    assert device
    lacking = [e.name() for e in device if e.correlation_id() not in runtime]
    assert lacking == []
    starts = sorted(s.t0_ns for s in spans)
    where = {}
    for e in device:
        call = runtime[e.correlation_id()]
        s = _innermost(spans, call.start_ns())
        assert s is not None, e.name()
        assert s.t0_ns <= call.start_ns() and call.end_ns() <= s.t1_ns, (
            e.name(), s.name)
        # no span opens between the launch call's start and its end
        k = bisect.bisect_right(starts, call.start_ns())
        assert k == len(starts) or starts[k] >= call.end_ns()
        where.setdefault(s.name, []).append(e.name())

    def spans_of(match):
        return sorted({span for span, ops in where.items()
                       for n in ops if match(n)})

    # K1: the prologue's 7 row applies and 2 a frame an iteration
    assert sum("banded_rows" in n for ops in where.values()
               for n in ops) == 7 + 2 * len(SHIFTS) * N_ITER
    assert spans_of(lambda n: "banded_rows" in n) == ["solve.ibp",
                                                      "solve.prologue"]
    assert spans_of(lambda n: "gemm" in n.lower()
                    or "xmma" in n.lower()) == ["col_apply"]
    assert spans_of(lambda n: n.startswith("Memcpy HtoD")) == [
        "solve.prepare"]
    assert spans_of(lambda n: n.startswith("Memcpy DtoH")) == [
        "solve.to_host"]


@pytest.mark.parametrize("units", [None, 3])
def test_copy_counters_read_the_bytes_that_cross(cuda, units):
    psf = classical.make_gaussian_psf()
    lr = _frames(units)
    sent = (classical._prepare.h2d_bytes, classical._to_host.d2h_bytes)
    if units is None:
        out = classical.solve(lr, psf, SHIFTS, n_iter=N_ITER)
    else:
        out = classical.solve_batch(lr, psf, SHIFTS, n_iter=N_ITER)
    assert classical._prepare.h2d_bytes - sent[0] == lr.nbytes
    assert classical._to_host.d2h_bytes - sent[1] == sum(
        v.nbytes for v in out.values())
    sent = classical._prepare.h2d_bytes
    classical.solve(torch.as_tensor(_frames(), device="cuda"), psf, SHIFTS,
                    n_iter=1)
    assert classical._prepare.h2d_bytes == sent      # already on the card
