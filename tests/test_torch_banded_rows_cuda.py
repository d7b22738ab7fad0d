"""The banded-row CUDA kernel against its plain PyTorch version, on the card.

Needs an NVIDIA card with the CUDA toolkit (``nvcc``); skips without one.
Run on the card with ``python -m pytest tests/test_torch_banded_rows_cuda.py
-q``.  Edge cases the solve meets at small sizes: widths that are no
multiple of the 128-column tile, windows that overhang the input's last
row, short blocks inside rep-tiled operators, and a batch axis.
"""

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    banded_row_apply, banded_row_apply_reference)
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    BandedOp, shift_op_banded, stuff_shift_op_banded, zoom_op_banded)

pytestmark = pytest.mark.cuda

# f32 sums over windows of up to ~300 taps of inputs in [0, 255): the kernel
# and the plain matmul differ only in summation order.
ATOL = 1e-3


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


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("width", [1, 200, 256])
@pytest.mark.parametrize("name", sorted(_ops()))
def test_kernel_matches_plain(cuda, name, width, reps):
    op = BandedOp.tiled(BandedOp.from_banded(_ops()[name]), reps).to(cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0, 255, (2, op.n_in, width)),
                        dtype=torch.float32, device=cuda)
    before = banded_row_apply.launches
    got = banded_row_apply(op.row_pack, x)
    assert banded_row_apply.launches == before + 1
    want = banded_row_apply_reference(op.row_pack, x)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, op.n_out, width)
    assert (got - want).abs().max().item() <= ATOL
    # 2-D input: no batch axis
    got2 = banded_row_apply(op.row_pack, x[1])
    assert (got2 - want[1]).abs().max().item() <= ATOL


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    op = BandedOp.from_banded(_ops()["zoom_short"]).to(cuda)
    with pytest.raises(TypeError):
        banded_row_apply(op.row_pack,
                         torch.zeros(64, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        banded_row_apply(op.row_pack, torch.zeros(65, 8, device=cuda))
