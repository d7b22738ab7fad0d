"""The banded-row CUDA kernel against its plain PyTorch version, on the card.

Needs an NVIDIA card with the CUDA toolkit (``nvcc``); skips without one.
Run on the card with ``python -m pytest tests/test_torch_banded_rows_cuda.py
-q``.  Edge cases the solve meets at small sizes: widths that are no
multiple of the 128-column tile, windows that overhang the input's last
row, short blocks inside rep-tiled operators, and a batch axis; and, for
every band type (float32, bfloat16 and the split X3), windows of one chunk
and of chunk counts no 32-row step divides, and unaligned inputs.
"""

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    X3, banded_row_apply, banded_row_apply_reference, pack_banded)
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    BandedOp, shift_op_banded, stuff_shift_op_banded, zoom_op_banded)

pytestmark = pytest.mark.cuda

# f32 sums over windows of up to ~300 taps of inputs in [0, 255): the kernel
# and the plain matmul differ only in summation order.
ATOL = 1e-3
# The split (X3) kernel and its plain version form the same exact bf16
# products, three per tap, and sum them in f32 in another order: per output
# they differ by at most this share of sum_k |b_k| |x_k|.
X3_SHARE = 2.0 ** -17
COUNTER = {torch.float32: "launches", torch.bfloat16: "launches_bf16",
           X3: "launches_x3"}


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
    """Per output, what the kernel may differ from the plain version by:
    ``ATOL``, or for the split the share of sum_k |b_k| |x_k|."""
    if pack.kind != X3:
        return ATOL
    absolute = pack_banded([np.abs(b) for b in blocks], col_ranges,
                           pack.n_out, pack.n_in, x.device)
    return X3_SHARE * banded_row_apply_reference(absolute, x.abs())


def _within(got, want, bound):
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("band", [torch.float32, X3], ids=["f32", "x3"])
@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("width", [1, 200, 256])
@pytest.mark.parametrize("name", sorted(_ops()))
def test_kernel_matches_plain(cuda, name, width, reps, band):
    base = BandedOp.tiled(BandedOp.from_banded(_ops()[name]), reps)
    op = base.astype_band(band).to(cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0, 255, (2, op.n_in, width)),
                        dtype=torch.float32, device=cuda)
    before = getattr(banded_row_apply, COUNTER[band])
    got = banded_row_apply(op.row_pack, x)
    assert getattr(banded_row_apply, COUNTER[band]) == before + 1
    want = banded_row_apply_reference(op.row_pack, x)
    torch.cuda.synchronize()
    bound = _bound(op.row_pack, base.blocks, base.col_ranges, x)
    assert got.shape == want.shape == (2, op.n_out, width)
    assert _within(got, want, bound)
    # 2-D input: no batch axis
    got2 = banded_row_apply(op.row_pack, x[1])
    assert _within(got2, want[1], bound if band == torch.float32
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, X3],
                         ids=["f32", "bf16", "x3"])
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
    before = getattr(banded_row_apply, COUNTER[dtype])
    got = banded_row_apply(pack, x)
    assert getattr(banded_row_apply, COUNTER[dtype]) == before + 1
    want = banded_row_apply_reference(pack, x)
    torch.cuda.synchronize()
    bound = _bound(pack, blocks, ranges, x)
    assert got.shape == want.shape == (2, pack.n_out, width)
    assert _within(got, want, bound)
    # an input view at an offset of one float: the unaligned copy path
    flat = torch.empty(x.numel() + 1, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert _within(banded_row_apply(pack, view), want, bound)


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
