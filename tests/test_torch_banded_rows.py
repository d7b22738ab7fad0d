"""The row pack's sub-tile spans (``RowPack.spans``) on the CPU.

The F64, X3, X6, X9 and TF32X3 instantiations of the banded-row kernel
walk each 128-row block in sub-tiles of ``SUB_ROWS`` rows, each over only
the window rows its span names (rounded out to whole steps of the kind's
``span_k`` rows: 8 for F64 and TF32X3, 16 for the bf16 splits), and copy
only the band rows of the sub-tiles a chunk meets.  These tests hold the
spans to the operators the solve builds at a small size (mono and
rep-tiled, rank-1 and rank-2 PSFs): every nonzero of every band part lies inside its sub-tile's span,
the split packs carry the F64 pack's spans, the span rounded out to whole
steps stays inside the window, and the plain sum over the spans alone
equals the full plain sum bit for bit; the other kinds carry no spans.
The kernel itself is held to them by the card tests
(tests/test_torch_banded_rows_cuda.py).
"""

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.data.sessions import (
    CENTER_SHIFT_FILES)
from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    F64, KINDS, ROWS, SUB_ROWS, TF32X3, X3, X6, X9,
    banded_row_apply_reference, pack_banded, sub_tile_spans)
from enph459_super_resolution_tpu_torch.sr.classical import (
    _host_solve_matrices, make_gaussian_psf)

SHIFTS = tuple(s for _, s in CENTER_SHIFT_FILES)
# LR rows 200: HR 400 = three full blocks and a short one of 16 rows
LR = (200, 24)


def _rank2_psf():
    t = np.arange(-3, 4, dtype=np.float64)

    def g(sigma):
        return np.exp(-t * t / (2.0 * sigma * sigma))

    psf = np.outer(g(1.0), g(1.0)) + 0.3 * np.outer(g(0.6), g(2.0))
    return psf / psf.sum()


def _row_ops():
    """Every row operator of the solve at ``LR``: the zoom, frame 1's
    Shift-and-Add rows and its forward and back-projection rows (each rank
    term of the rank-2 PSF), unbatched and tiled 3 reps."""
    ops = {}
    for psf_name, psf in (("gauss", make_gaussian_psf()),
                          ("rank2", _rank2_psf())):
        for reps in (1, 3):
            mats = _host_solve_matrices(psf, SHIFTS, 2, LR, reps=reps)
            tag = f"{psf_name}_x{reps}"
            if psf_name == "gauss":
                ops[f"zoom_r_{tag}"] = mats["zoom_r"]
                ops[f"saa_r_{tag}"] = mats["saa"][1][0]
            for term, op in enumerate(mats["frames"][1][0]):
                ops[f"fwd_r{term}_{tag}"] = op
            for term, op in enumerate(mats["frames"][1][2]):
                ops[f"bwd_r{term}_{tag}"] = op
    return ops


OPS = _row_ops()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(op, kind=F64):
    return pack_banded(op.blocks, op.col_ranges, op.n_out, op.n_in,
                       torch.device("cpu"), kind)


def _x(op, width=9, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0, 255, (2, op.n_in, width)),
                           dtype=torch.float32)


SPAN_KINDS = (F64, X3, X6, X9, TF32X3)
KIND_IDS = {torch.float32: "f32", torch.bfloat16: "bf16"}


# F64's cases keep the bare op name; the splits' carry their kind
@pytest.mark.parametrize("kind,name", [
    pytest.param(kind, name, id=name if kind == F64 else f"{kind}-{name}")
    for kind in SPAN_KINDS for name in sorted(OPS)])
def test_spans_hold_every_nonzero_and_no_more(kind, name):
    op = OPS[name]
    pack = _pack(op, kind)
    step = KINDS[kind].span_k
    spans = pack.spans.numpy()
    parts = [part.float().numpy() for part in pack.parts]
    n_blk, win, _ = parts[0].shape
    assert spans.shape == (n_blk, ROWS // SUB_ROWS, 2)
    assert spans.dtype == np.int32
    # the spans of the float32 bands, whatever the kind splits them into
    np.testing.assert_array_equal(spans, _pack(op).spans.numpy())
    for b in range(n_blk):
        nrow = int(pack.meta_host[2, b])
        for s in range(ROWS // SUB_ROWS):
            lo, hi = spans[b, s]
            rows = slice(s * SUB_ROWS, (s + 1) * SUB_ROWS)
            k = np.concatenate([np.nonzero(part[b, :, rows])[0]
                                for part in parts])
            if k.size == 0:
                assert lo == hi == 0, (b, s)
                continue
            # every nonzero of every part inside, the first and last of
            # part 0 (the bands rounded to nearest) on its ends
            k0, _ = np.nonzero(parts[0][b, :, rows])
            assert (lo, hi) == (k0.min(), k0.max() + 1), (b, s)
            assert lo <= k.min() and k.max() < hi, (b, s)
            assert 0 <= lo < hi <= win
            # the kernel's whole steps of span_k rows stay in the window
            assert 0 <= lo // step * step <= lo
            assert hi <= -(-hi // step) * step <= win
            assert s * SUB_ROWS < nrow  # rows past the block's own are 0
    # the short last block of each rep leaves sub-tiles with empty spans
    assert (spans[-1] == 0).all(axis=1).sum() >= ROWS // SUB_ROWS - -(
        -int(pack.meta_host[2, -1]) // SUB_ROWS)
    # only the kinds whose kernels read them carry them
    assert _pack(op, torch.float32).spans is None


@pytest.mark.parametrize("kind", list(KINDS),
                         ids=[KIND_IDS.get(k, k) for k in KINDS])
def test_only_the_span_kinds_carry_spans(kind):
    pack = _pack(OPS["fwd_r0_gauss_x3"], kind)
    assert (pack.spans is not None) == (kind in SPAN_KINDS)
    assert (KINDS[kind].span_k > 0) == (kind in SPAN_KINDS)


def _masked(pack, spans, step=1):
    """``pack`` with every entry of every band part outside its sub-tile's
    span (of the F64 pack's ``spans``), rounded out to whole steps of
    ``step`` rows, zeroed."""
    parts = [part.clone() for part in pack.parts]
    for b, sub in enumerate(spans.tolist()):
        for s, (lo, hi) in enumerate(sub):
            cols = slice(s * SUB_ROWS, (s + 1) * SUB_ROWS)
            for part in parts:
                part[b, :lo // step * step, cols] = 0
                part[b, -(-hi // step) * step:, cols] = 0
    return pack._replace(bands=parts[0], more=tuple(parts[1:]))


@pytest.mark.parametrize("kind", [F64, torch.float32, X6, X9, X3, TF32X3],
                         ids=["f64", "f32", "x6", "x9", "x3", "tf32x3"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_plain_sum_over_the_spans_is_the_full_sum(name, kind):
    """Zeroed outside the spans themselves, and outside the spans rounded
    out to the kind's step (the rows its kernel walks)."""
    op = OPS[name]
    pack = _pack(op, kind)
    x = _x(op)
    full = banded_row_apply_reference(pack, x)
    spans = _pack(op).spans
    for step in {1, KINDS[kind].span_k or 1}:
        torch.testing.assert_close(
            banded_row_apply_reference(_masked(pack, spans, step), x), full,
            rtol=0, atol=0)


def test_spans_of_a_hand_made_pack():
    """Blocks of 128, 37 and 20 rows: a staggered band with sub-tiles 2
    and 5 zero, an all-zero block, a dense block; windows of 40 padded to
    48."""
    rng = np.random.default_rng(2)
    b0 = np.zeros((128, 40))
    for r in range(128):
        b0[r, r // 4:r // 4 + 9] = rng.uniform(0.1, 1.0, 9)
    b0[32:48] = 0
    b0[80:96] = 0
    b1 = np.zeros((37, 40))
    b2 = rng.uniform(0.1, 1.0, (20, 40))
    b2[:, :3] = 0
    spans = sub_tile_spans(_pack_bands([b0, b1, b2], 48))
    # rows 16s .. 16s+15 hold window rows 4s .. 4s + 3 + 9
    want0 = [(4 * s, 4 * s + 12) if s not in (2, 5) else (0, 0)
             for s in range(ROWS // SUB_ROWS)]
    assert [tuple(v) for v in spans[0]] == want0
    assert not spans[1].any()
    assert [tuple(v) for v in spans[2]] == [(3, 40)] * 2 + [(0, 0)] * 6


def _pack_bands(blocks, win):
    bands = np.zeros((len(blocks), win, ROWS), np.float32)
    for i, b in enumerate(blocks):
        bands[i, :b.shape[1], :b.shape[0]] = b.T
    return bands
