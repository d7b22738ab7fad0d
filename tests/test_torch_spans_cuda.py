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
the results' bytes exactly.  The copy back lands in page-locked memory
(``Device -> Pinned``), one buffer per live result, the device tensors'
bytes exactly.
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


def test_results_land_in_their_own_pinned_buffers(cuda, monkeypatch):
    """Two warm solves of different sessions: each result is its device
    tensors' bytes exactly, the first is untouched by the second (no
    buffer shared between live results), both took the page-locked path,
    and the copy back is a ``Device -> Pinned`` copy in ``solve.to_host``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    psf = classical.make_gaussian_psf()
    sessions = _frames(2)
    body = classical._solve_body
    on_card = []

    def seen(*args, **kwargs):
        """The results ``_to_host`` gets, kept on the card (a copy there
        moves nothing to the host inside the traced call)."""
        out = body(*args, **kwargs)
        on_card.append({k: v.clone() for k, v in out.items()})
        return out

    monkeypatch.setattr(classical, "_solve_body", seen)
    classical.solve(sessions[1], psf, SHIFTS, n_iter=N_ITER)    # warm
    pinned = classical._to_host.pinned_calls
    first = classical.solve(sessions[0], psf, SHIFTS, n_iter=N_ITER)
    kept = {k: v.copy() for k, v in first.items()}
    trace.set_spans(True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = classical.solve(sessions[1], psf, SHIFTS, n_iter=N_ITER)
    trace.set_spans(False)
    spans, _ = trace.drain_spans()
    assert classical._to_host.pinned_calls - pinned == 2
    for k, v in first.items():
        assert v.tobytes() == kept[k].tobytes(), k
    assert not np.array_equal(first["ibp"], second["ibp"])
    for got, dev in zip((first, second), on_card[1:]):
        want = {k: v.cpu().numpy() for k, v in dev.items()}
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.shape == want[k].shape and v.dtype == want[k].dtype
            assert v.flags.writeable
            assert v.tobytes() == want[k].tobytes(), k
    events = prof.profiler.kineto_results.events()
    runtime = {e.correlation_id(): e for e in events
               if e.device_type() != DeviceType.CUDA
               and e.correlation_id() > 0 and e.name().startswith("cu")}
    back = [e for e in events if e.device_type() == DeviceType.CUDA
            and e.name().startswith("Memcpy DtoH")]
    assert [e.name() for e in back] == ["Memcpy DtoH (Device -> Pinned)"]
    launch = runtime[back[0].correlation_id()]
    assert _innermost(spans, launch.start_ns()).name == "solve.to_host"
