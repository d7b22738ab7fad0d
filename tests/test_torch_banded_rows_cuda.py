"""The banded-row CUDA kernel against its plain PyTorch version, on the card.

Needs an NVIDIA card with the CUDA toolkit (``nvcc``); skips without one.
Run on the card with ``python -m pytest tests/test_torch_banded_rows_cuda.py
-q``.  Edge cases the solve meets at small sizes: widths that are no
multiple of the 128-column tile, windows that overhang the input's last
row, short blocks inside rep-tiled operators, and a batch axis; and, for
every band kind (float32, bfloat16, the bf16 splits X3, X6 and X9, tf32 and
its split, f16 with and without an f16 result, bf16 with a bf16 result and
f64), windows of one chunk and of chunk counts no 32-row step divides, odd
widths and unaligned inputs; each kind bit for bit on an exactness probe;
and each kind against a float64 product within its class.  The span
walk's row sub-tiles (F64, X3, X6, X9, TF32X3): packs with empty, short
and staggered sub-tiles, band entries outside the spans (rounded out to the
kind's step) poisoned with NaN (the kernel must not read them), the kernel
equal bit for bit to itself with every span widened to the whole window, a
pack without spans refused, and the SASS: F64 on the f64 tensor cores
(DMMA, no DFMA), X3, X6 and X9 on HMMA and TF32X3 on tf32 HMMA in the span
kernel and in no whole-window kernel.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch._build import (build, library_path,
                                                       load_function,
                                                       nvcc_path)
from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    _ARGTYPES, BF16OUT, F16, F16OUT, F64, KINDS, SUB_ROWS, TF32, TF32X3, X3,
    X6, X9, banded_row_apply, banded_row_apply_reference, pack_banded,
    round_result)
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    BandedOp, shift_op_banded, stuff_shift_op_banded, zoom_op_banded)

pytestmark = pytest.mark.cuda

# f32 sums over windows of up to ~300 taps of inputs in [0, 255): the kernel
# and the plain matmul differ only in summation order.
ATOL = 1e-3
# The other tensor-core kinds (the splits, tf32, f16) and their plain
# versions form the same exact products and sum them in f32 in another
# order: per output they differ by at most this share of sum_k |b_k| |x_k|;
# F64 sums in f64 in both and rounds once to f32 (2^-22).  A kind that
# rounds its result (BF16OUT, F16OUT) gives values of the result type, each
# the rounding of a sum within that share of the plain version's sum.
X3_SHARE = 2.0 ** -17
SHARE = {F64: 2.0 ** -22}
ALL_KINDS = list(KINDS)
KIND_IDS = [{torch.float32: "f32", torch.bfloat16: "bf16"}.get(k, k)
            for k in ALL_KINDS]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ops():
    rng = np.random.default_rng(5)
    taps = tuple(rng.random(7))
    return {
        "fwd_stride": shift_op_banded(768, 1.0, stride=2, n_out=384,
                                      blur_taps=taps),
        "bwd_stuff": stuff_shift_op_banded(200, 2, -1.0, blur_taps=taps),
        "zoom_short": zoom_op_banded(64, 2),
        "shift_ragged": shift_op_banded(300, 0.37),
    }


def _bound(pack, blocks, col_ranges, x):
    """Per output, what the kernel's sum may differ from the plain
    version's by: ``ATOL`` for float32 and bfloat16 bands, else a share of
    sum_k |b_k| |x_k|."""
    if pack.kind in (torch.float32, torch.bfloat16):
        return ATOL
    absolute = pack_banded([np.abs(b) for b in blocks], col_ranges,
                           pack.n_out, pack.n_in, x.device)
    scale = banded_row_apply_reference(absolute, x.abs())
    return SHARE.get(pack.kind, X3_SHARE) * scale


def _within(kind, got, want_sum, bound):
    """``got`` against the plain version's sum before the result's rounding
    (``rounded=False``): within ``bound`` of it, or for a kind that rounds
    its result, a value of the result type between the roundings of
    ``want_sum -+ bound`` (rounding to nearest is monotone)."""
    if KINDS[kind].out is None:
        return bool(((got - want_sum).abs() <= bound).all())
    lo = round_result(kind, want_sum - bound)
    hi = round_result(kind, want_sum + bound)
    return (torch.equal(got, round_result(kind, got))
            and bool(((lo <= got) & (got <= hi)).all()))


@pytest.mark.parametrize("band", ALL_KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("width", [1, 200, 256])
@pytest.mark.parametrize("name", sorted(_ops()))
def test_kernel_matches_plain(cuda, name, width, reps, band):
    base = BandedOp.tiled(BandedOp.from_banded(_ops()[name]), reps)
    op = base.astype_band(band).to(cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0, 255, (2, op.n_in, width)),
                        dtype=torch.float32, device=cuda)
    counter = KINDS[band].counter
    before = getattr(banded_row_apply, counter)
    got = banded_row_apply(op.row_pack, x)
    assert getattr(banded_row_apply, counter) == before + 1
    want = banded_row_apply_reference(op.row_pack, x, rounded=False)
    torch.cuda.synchronize()
    bound = _bound(op.row_pack, base.blocks, base.col_ranges, x)
    assert got.shape == want.shape == (2, op.n_out, width)
    assert _within(band, got, want, bound)
    # 2-D input: no batch axis
    got2 = banded_row_apply(op.row_pack, x[1])
    assert _within(band, got2, want[1], bound if isinstance(bound, float)
                   else bound[1])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    op = BandedOp.from_banded(_ops()["zoom_short"]).to(cuda)
    with pytest.raises(TypeError):
        banded_row_apply(op.row_pack,
                         torch.zeros(64, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        banded_row_apply(op.row_pack, torch.zeros(65, 8, device=cuda))


def _random_pack(true_win, dtype, device, seed=0):
    """A pack of 4 blocks of 128, 37, 128 and 1 rows whose windows are
    ``true_win`` wide (padded to the 16-row chunk), the last one overhanging
    nothing and the third ending at the input's last row; entries in
    [0, 1 / true_win), so the outputs stay within the inputs' range, as the
    solve's operators keep them.  Returns (pack, blocks, col_ranges)."""
    rng = np.random.default_rng(seed)
    rows = [128, 37, 128, 1]
    n_in = 3 * true_win + 11
    lo = [0, true_win // 2, n_in - true_win, 5]
    blocks = [rng.uniform(0, 1.0 / true_win, (r, true_win)) for r in rows]
    ranges = [(a, a + true_win) for a in lo]
    return (pack_banded(blocks, ranges, sum(rows), n_in, device, dtype),
            blocks, ranges)


# Windows of one chunk (5 and 16 rows), and of 3 and 19 chunks, which no
# 32-row step divides; widths below, across and off the 128-column tile,
# odd ones taking the 4-byte copies.
@pytest.mark.parametrize("width", [1, 130, 257, 384])
@pytest.mark.parametrize("true_win", [5, 16, 40, 300])
@pytest.mark.parametrize("dtype", ALL_KINDS, ids=KIND_IDS)
def test_ring_and_tensor_cores_at_ragged_shapes(cuda, dtype, true_win,
                                                width):
    """f32 bands through the cp.async ring (f32 FMA), bf16 and split bands
    on the tensor cores, each against the plain version.  Outputs lie in
    [0, 255): both versions sum the same products (exact for bf16 and the
    split) in f32 in another order, so they differ by a few f32 ulps of 255
    (1.5e-5 each), within ``ATOL`` (the split: ``X3_SHARE``)."""
    pack, blocks, ranges = _random_pack(true_win, dtype, cuda)
    assert pack.bands.shape[1] == -(-true_win // 16) * 16
    assert pack.kind == dtype
    x = torch.as_tensor(
        np.random.default_rng(true_win).uniform(0, 255,
                                                (2, pack.n_in, width)),
        dtype=torch.float32, device=cuda)
    counter = KINDS[dtype].counter
    before = getattr(banded_row_apply, counter)
    got = banded_row_apply(pack, x)
    assert getattr(banded_row_apply, counter) == before + 1
    want = banded_row_apply_reference(pack, x, rounded=False)
    torch.cuda.synchronize()
    bound = _bound(pack, blocks, ranges, x)
    assert got.shape == want.shape == (2, pack.n_out, width)
    assert _within(dtype, got, want, bound)
    # an input view at an offset of one float: the unaligned copy path
    flat = torch.empty(x.numel() + 1, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert _within(dtype, banded_row_apply(pack, view), want, bound)


def test_split_beats_one_bf16_pass(cuda):
    """Against a float64 product the split kernel is within 2^-14 of
    sum_k |b_k| |x_k| per output, the bf16 instantiation only within
    2^-7."""
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(0, 255, (1, 3 * 40 + 11, 300)),
                        dtype=torch.float32, device=cuda)
    for dtype, share in ((X3, 2.0 ** -14), (torch.bfloat16, 2.0 ** -7)):
        pack, blocks, ranges = _random_pack(40, dtype, cuda, seed=4)
        xd = x.double().cpu()
        dense = np.zeros((pack.n_out, pack.n_in))
        r0 = 0
        for b, (lo, hi) in zip(blocks, ranges):
            dense[r0:r0 + b.shape[0], lo:hi] = b
            r0 += b.shape[0]
        want = np.einsum("oh,zhw->zow", dense, xd.numpy())
        scale = np.einsum("oh,zhw->zow", np.abs(dense), np.abs(xd.numpy()))
        got = banded_row_apply(pack, x)
        torch.cuda.synchronize()
        assert (np.abs(got.cpu().double().numpy() - want)
                <= share * scale).all(), dtype


# Each kind against a float64 product: per output within this share of
# sum_k |b_k| |x_k| (the CPU tests' classes, tests/test_torch_precision.py).
CLASS_SHARE = {torch.float32: 2.0 ** -19, torch.bfloat16: 2.0 ** -7,
               BF16OUT: 2.0 ** -6, X3: 2.0 ** -14, X6: 2.0 ** -19,
               X9: 2.0 ** -19, TF32: 2.0 ** -10, TF32X3: 2.0 ** -19,
               F16: 2.0 ** -10, F16OUT: 2.0 ** -9, F64: 2.0 ** -23}


@pytest.mark.parametrize("dtype", ALL_KINDS, ids=KIND_IDS)
def test_each_kind_within_its_class_of_a_float64_product(cuda, dtype):
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.uniform(0, 255, (2, 3 * 40 + 11, 301)),
                        dtype=torch.float32, device=cuda)
    pack, blocks, ranges = _random_pack(40, dtype, cuda, seed=4)
    dense = np.zeros((pack.n_out, pack.n_in))
    r0 = 0
    for b, (lo, hi) in zip(blocks, ranges):
        dense[r0:r0 + b.shape[0], lo:hi] = b.astype(np.float32)
        r0 += b.shape[0]
    xd = x.double().cpu().numpy()
    want = np.einsum("oh,zhw->zow", dense, xd)
    scale = np.einsum("oh,zhw->zow", np.abs(dense), np.abs(xd))
    got = banded_row_apply(pack, x)
    torch.cuda.synchronize()
    assert torch.equal(got, round_result(dtype, got))
    err = np.abs(got.cpu().double().numpy() - want)
    assert (err <= CLASS_SHARE[dtype] * scale).all(), (err / scale).max()


# Band entries and inputs c * 2^e, c one of these: each output is a single
# product, whose parts' products and their sums are exact in float32 under
# every kind, in any order, up to terms below half an ulp that every order
# drops.
PROBE_VALUES = (1 + 2.0 ** -9 + 2.0 ** -18, 1 + 2.0 ** -4)


def _probe(dtype, device, width=130, seed=3):
    """A pack of two blocks (128 and 37 rows, windows of 40) whose rows
    each hold one nonzero entry, and an input [2, 64, width], all of them
    ``c * 2^e`` with c in ``PROBE_VALUES`` and e in [-3, 3]."""
    rng = np.random.default_rng(seed)
    vals = np.asarray(PROBE_VALUES)
    rows, win, n_in = (128, 37), 40, 64
    blocks, ranges = [], []
    for i, r in enumerate(rows):
        b = np.zeros((r, win))
        b[np.arange(r), rng.integers(0, win, r)] = (
            rng.choice(vals, r) * 2.0 ** rng.integers(-3, 4, r))
        blocks.append(b)
        ranges.append((i * (n_in - win), i * (n_in - win) + win))
    x = (rng.choice(vals, (2, n_in, width))
         * 2.0 ** rng.integers(-3, 4, (2, n_in, width)))
    return (pack_banded(blocks, ranges, sum(rows), n_in, device, dtype),
            torch.as_tensor(x, dtype=torch.float32, device=device))


@pytest.mark.parametrize("dtype", ALL_KINDS, ids=KIND_IDS)
def test_each_kind_forms_exactly_its_products(cuda, dtype):
    """On the probe the kernel equals the plain version bit for bit, and
    the plain versions of kinds that form other products or round their
    result differently differ there, so a kernel that took another kind's
    pass list or skipped its rounding would fail.  (X9's three extra
    products lie below a float32 sum's resolution: no float32 result tells
    X9 from X6.)"""
    pack, x = _probe(dtype, cuda)
    got = banded_row_apply(pack, x)
    want = banded_row_apply_reference(pack, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    other = {X3: X6, X6: X3, TF32: TF32X3, TF32X3: TF32, F16: F16OUT,
             F16OUT: F16, torch.bfloat16: BF16OUT, BF16OUT: torch.bfloat16,
             torch.float32: X3, X9: X3, F64: X3}[dtype]
    assert not torch.equal(want, banded_row_apply_reference(
        _probe(other, cuda)[0], x))


def _hand_pack(case, device, seed=6, kind=F64):
    """Packs of a span kind whose sub-tiles the solve's operators seldom
    give:
    ``staggered`` -- a 128-row block whose rows r hold window rows r // 4
    .. + 8 with sub-tiles 2 and 5 zero, an all-zero block of 37 rows and a
    short block of 20 dense rows, windows of 40 (3 chunks); ``one_chunk``
    -- blocks of 128 and 13 rows over windows of 5; ``wide`` -- a 128-row
    band of slope 2 (rows r hold window rows 2r .. 2r + 38, the forward
    operator's shape) over a window of 293, then a block of 1 row."""
    rng = np.random.default_rng(seed)
    if case == "staggered":
        b0 = np.zeros((128, 40))
        for r in range(128):
            b0[r, r // 4:r // 4 + 9] = rng.uniform(0, 1.0 / 9, 9)
        b0[32:48] = b0[80:96] = 0
        blocks = [b0, np.zeros((37, 40)), rng.uniform(0, 1.0 / 40, (20, 40))]
    elif case == "one_chunk":
        blocks = [rng.uniform(0, 0.2, (128, 5)), rng.uniform(0, 0.2, (13, 5))]
    else:
        b0 = np.zeros((128, 293))
        for r in range(128):
            b0[r, 2 * r:2 * r + 39] = rng.uniform(0, 1.0 / 39, 39)
        blocks = [b0, rng.uniform(0, 1.0 / 293, (1, 293))]
    win = blocks[0].shape[1]
    n_in = 2 * win + 7
    ranges = [(i * (win // 2 + 3), i * (win // 2 + 3) + win)
              for i in range(len(blocks))]
    pack = pack_banded(blocks, ranges, sum(b.shape[0] for b in blocks), n_in,
                       device, kind)
    return pack, blocks, ranges


F64_CASES = ("staggered", "one_chunk", "wide")
# the span kinds but F64: the splits on the 128-column tiles
SPAN_SPLIT_KINDS = (X3, X6, X9, TF32X3)
SPAN_KINDS = (F64,) + SPAN_SPLIT_KINDS


def _sub_tiles_at_ragged_pack(cuda, kind, case, width):
    pack, blocks, ranges = _hand_pack(case, cuda, kind=kind)
    x = torch.as_tensor(np.random.default_rng(width).uniform(
        0, 255, (2, pack.n_in, width)), dtype=torch.float32, device=cuda)
    counter = KINDS[kind].counter
    before = getattr(banded_row_apply, counter)
    got = banded_row_apply(pack, x)
    assert getattr(banded_row_apply, counter) == before + 1
    want = banded_row_apply_reference(pack, x)
    torch.cuda.synchronize()
    bound = _bound(pack, blocks, ranges, x)
    assert ((got - want).abs() <= bound).all()
    flat = torch.empty(x.numel() + 1, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert ((banded_row_apply(pack, view) - want).abs() <= bound).all()
    if case == "staggered":
        assert not got[:, 32:48].any() and not got[:, 80:96].any()
        assert not got[:, 128:165].any()


@pytest.mark.parametrize("width", [1, 131, 256])
@pytest.mark.parametrize("case", F64_CASES)
def test_f64_sub_tiles_at_ragged_packs(cuda, case, width):
    """Empty sub-tiles (all-zero rows, an all-zero block, rows past a short
    block's own), a window of one chunk and the forward operator's slope,
    at odd widths (4-byte copies) and aligned ones, with a batch axis and an
    input at an offset of one float: within 2^-22 of sum|b||x| of the
    plain float64 sum; outputs of all-zero rows exactly 0."""
    _sub_tiles_at_ragged_pack(cuda, F64, case, width)


@pytest.mark.parametrize("width", [1, 131, 256])
@pytest.mark.parametrize("case", F64_CASES)
@pytest.mark.parametrize("kind", SPAN_SPLIT_KINDS)
def test_split_sub_tiles_at_ragged_packs(cuda, kind, case, width):
    """As the F64 test, for the splits on the walk (128-column tiles; X3,
    X6 and X9 one k16 step a chunk, TF32X3 two k8 steps): within 2^-17 of
    sum|b||x| of the plain sum."""
    _sub_tiles_at_ragged_pack(cuda, kind, case, width)


def _poisoned(pack):
    """``pack`` with NaN in every entry of every band part outside its
    sub-tile's span rounded out to whole steps of the kind's ``span_k``
    rows: the entries its kernel skips."""
    step = KINDS[pack.kind].span_k
    parts = [part.clone() for part in pack.parts]
    for b, sub in enumerate(pack.spans.tolist()):
        for s, (lo, hi) in enumerate(sub):
            cols = slice(s * SUB_ROWS, (s + 1) * SUB_ROWS)
            for part in parts:
                part[b, :lo // step * step, cols] = float("nan")
                part[b, -(-hi // step) * step:, cols] = float("nan")
    return pack._replace(bands=parts[0], more=tuple(parts[1:]))


def _span_pack(kind, name, reps, cuda):
    """(pack, blocks, col_ranges) of one of ``_ops()`` tiled ``reps``
    times, or of a hand pack (``F64_CASES``), as ``kind``."""
    if name in F64_CASES:
        return _hand_pack(name, cuda, kind=kind)
    base = BandedOp.tiled(BandedOp.from_banded(_ops()[name]), reps)
    return (base.astype_band(kind).to(cuda).row_pack, base.blocks,
            base.col_ranges)


def _reads_no_band_entry_outside_the_spans(cuda, kind, name, reps):
    pack, blocks, ranges = _span_pack(kind, name, reps, cuda)
    poisoned = _poisoned(pack)
    assert all(torch.isnan(part.float()).any() for part in poisoned.parts)
    x = torch.as_tensor(np.random.default_rng(9).uniform(
        0, 255, (2, pack.n_in, 200)), dtype=torch.float32, device=cuda)
    got = banded_row_apply(poisoned, x)
    want = banded_row_apply_reference(pack, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert ((got - want).abs() <= _bound(pack, blocks, ranges, x)).all()


SPAN_PACKS = ([(n, r) for n in sorted(_ops()) for r in (1, 3)]
              + [(c, 1) for c in F64_CASES])


@pytest.mark.parametrize("name,reps", SPAN_PACKS)
def test_f64_reads_no_band_entry_outside_the_spans(cuda, name, reps):
    """Each sub-tile multiplies only the window rows of its span: with
    every band entry outside the spans set to NaN, the kernel's result is
    that of the clean pack's plain version (a NaN it read would spread)."""
    _reads_no_band_entry_outside_the_spans(cuda, F64, name, reps)


@pytest.mark.parametrize("name,reps", SPAN_PACKS)
@pytest.mark.parametrize("kind", SPAN_SPLIT_KINDS)
def test_split_reads_no_band_entry_outside_the_spans(cuda, kind, name, reps):
    """As the F64 test, for the splits on the walk: NaN in every part
    outside the spans rounded out to whole steps (k16 for the bf16 splits,
    k8 for TF32X3)."""
    _reads_no_band_entry_outside_the_spans(cuda, kind, name, reps)


@pytest.mark.parametrize("name,reps", SPAN_PACKS)
@pytest.mark.parametrize("kind", SPAN_KINDS)
def test_span_kernel_equals_its_whole_window_walk(cuda, kind, name, reps):
    """Skipping a step that holds only zero band entries changes no bit:
    the kernel with every sub-tile's span widened to the whole window
    (every step taken, as the whole-window tile takes them) equals the
    kernel on the real spans bit for bit, at a width off the tile and an
    aligned one."""
    pack, _, _ = _span_pack(kind, name, reps, cuda)
    win = pack.bands.shape[1]
    wide = pack._replace(spans=torch.tensor(
        [0, win], dtype=torch.int32, device=cuda).expand_as(
            pack.spans).contiguous())
    rng = np.random.default_rng(10)
    for width in (131, 256):
        x = torch.as_tensor(rng.uniform(-255, 255, (2, pack.n_in, width)),
                            dtype=torch.float32, device=cuda)
        got = banded_row_apply(pack, x)
        assert torch.equal(got, banded_row_apply(wide, x))


@pytest.mark.parametrize("kind", SPAN_KINDS)
def test_span_kinds_refuse_a_pack_without_spans(cuda, kind):
    """No whole-window fallback: the wrapper raises on a span kind's pack
    without spans, and the entry point refuses null or misaligned spans
    (cudaErrorInvalidValue, cudaErrorMisalignedAddress) before any launch."""
    pack, _, _ = _hand_pack("one_chunk", cuda, kind=kind)
    x = torch.zeros(1, pack.n_in, 8, device=cuda)
    counter = KINDS[kind].counter
    before = getattr(banded_row_apply, counter)
    with pytest.raises(ValueError, match="spans"):
        banded_row_apply(pack._replace(spans=None), x)
    assert getattr(banded_row_apply, counter) == before
    out = torch.empty(1, pack.n_out, 8, device=cuda)
    launch = load_function(
        "banded_rows", KINDS[kind].symbol,
        [ctypes.c_void_p] * (len(pack.parts) + 1) + _ARGTYPES)
    meta = pack.meta
    step = meta.stride(0) * meta.element_size()
    for spans, rc in ((0, 1), (pack.spans.data_ptr() + 4, 716)):
        assert launch(
            *(p.data_ptr() for p in pack.parts), spans, meta.data_ptr(),
            meta.data_ptr() + step, meta.data_ptr() + 2 * step, x.data_ptr(),
            out.data_ptr(), pack.bands.shape[0], pack.bands.shape[1],
            pack.n_in, pack.n_out, 8, 1,
            torch.cuda.current_stream().cuda_stream) == rc


def test_f64_kernel_runs_on_the_f64_tensor_cores(cuda):
    """The span kernel's F64 instantiation (both copy paths) issues DMMA and
    no DFMA: the products cannot fall back to the f64 CUDA cores unnoticed.
    Its X3, X6 and X9 instantiations issue HMMA, its TF32X3 ones tf32 HMMA
    and no FFMA; and no whole-window kernel is built for a kind of two or
    three band parts: the split launches run the span walk."""
    build("banded_rows")
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(library_path("banded_rows"))],
                          check=True, capture_output=True, text=True).stdout
    bodies = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        bodies[name.strip()] = body
    span = {n: b for n, b in bodies.items() if "banded_rows_span_kernel" in n}
    f64 = {n: b for n, b in span.items() if "F64Step" in n}
    assert len(f64) == 2, sorted(bodies)
    for name, body in f64.items():
        assert "DMMA" in body, name
        assert "DFMA" not in body, name
    # Mma<__nv_bfloat16, 2 (X3) or 3 parts, reach 1 (X3), 2 (X6) or 4 (X9),
    # 0> in the mangled names
    split = {n: b for n, b in span.items() if "Mma16Step" in n}
    assert len(split) == 6, sorted(span)
    for reach in ("Li2ELi1E", "Li3ELi2E", "Li3ELi4E"):
        assert sum(reach in n for n in split) == 2, sorted(split)
    for name, body in split.items():
        assert "HMMA" in body, name
    # Tf32Step<2, 1, 0> (TF32X3)
    tf32 = {n: b for n, b in span.items() if "Tf32Step" in n}
    assert len(tf32) == 2 and len(span) == 10, sorted(span)
    for name, body in tf32.items():
        assert "Tf32StepILi2ELi1ELi0EE" in name, name
        assert re.search(r"HMMA\.\S*TF32", body), name
        assert "FFMA" not in body, name
    whole = [n for n in bodies if "banded_rows_kernel" in n]
    # the band parts P of each whole-window Mma<E, P, S, R>
    parts = [p for n in whole
             for p in re.findall(r"(?:bfloat16|half|Tf32E)Li(\d)E", n)]
    assert whole and parts and set(parts) == {"1"}, sorted(whole)
