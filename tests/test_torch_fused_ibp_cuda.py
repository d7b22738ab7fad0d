"""The fused IBP kernels (K2, K3) and the bf16 banded-row kernel against
their plain PyTorch versions, on the card.

Needs an NVIDIA card with the CUDA toolkit (``nvcc``); skips without one.
Run on the card with ``python -m pytest --noconftest
tests/test_torch_fused_ibp_cuda.py -q``.  Cases: the port's 64-row /
64-column pack, a wide 128-row / 256-column pack (the TPU's block and
tile, which each CUDA block covers in parts) and a ragged one (LR 96x200:
a short last row block and column tile), one and three reps stacked along
H, float32 and bfloat16 bands; for K1, the bf16 bands on the edge
cases of the f32 kernel's tests (short blocks inside rep-tiled operators,
windows that overhang the input, widths off the 128-column tile).
"""

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    banded_row_apply, banded_row_apply_reference)
from enph459_super_resolution_tpu_torch.ops.fused_ibp import (
    FusedIBP, fused_bwd_update, fused_bwd_update_reference, fused_fwd_err,
    fused_fwd_err_reference)
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    BandedOp, shift_op_banded, stuff_shift_op_banded, zoom_op_banded)
from enph459_super_resolution_tpu_torch.sr.classical import (
    _host_solve_matrices, make_gaussian_psf)

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version differ only in summation order.
# bf16: one ulp of a row product that rounds the other way at 128..255 is
# 1.0, weighted by column taps that sum to ~1, so up to 2.
ATOL = {torch.float32: 1e-3, torch.bfloat16: 2.0}
SHIFTS = ((0.0, 0.0), (0.5, -0.5), (-0.5, 0.5), (0.5, 0.5))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


LAYOUTS = {"port": ((128, 256), 64, 64),
           "wide": ((128, 256), 128, 256),
           "ragged": ((96, 200), 64, 64)}


def _pack(cuda, reps, layout, dtype):
    lr_shape, block, tile = LAYOUTS[layout]
    frames = _host_solve_matrices(make_gaussian_psf(), SHIFTS, 2, lr_shape,
                                  reps=reps)["frames"]
    return FusedIBP.build(frames, cuda, block=block,
                          tile=tile).astype_bands(dtype)


def _inputs(cuda, pack, dtype, seed):
    rng = np.random.default_rng(seed)
    hr = torch.as_tensor(rng.uniform(0, 255, pack.hr_shape),
                         dtype=torch.float32, device=cuda)
    lr = torch.as_tensor(rng.uniform(0, 255, (pack.n_frames,)
                                     + pack.lr_shape),
                         dtype=torch.float32, device=cuda).to(dtype)
    return hr, lr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("reps", [1, 3])
def test_fused_kernels_match_plain(cuda, reps, layout, dtype):
    pack = _pack(cuda, reps, layout, dtype)
    hr, lr = _inputs(cuda, pack, dtype, 7)
    counter = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = (getattr(fused_fwd_err, counter),
              getattr(fused_bwd_update, counter))
    err = fused_fwd_err(pack, hr, lr)
    want_err = fused_fwd_err_reference(pack, hr, lr)
    torch.cuda.synchronize()
    assert err.dtype == dtype and err.shape == lr.shape
    assert (err.float() - want_err.float()).abs().max().item() <= ATOL[dtype]
    # K3 from the same err stack (the plain version's), so it is judged alone
    out = fused_bwd_update(pack, hr, want_err, 0.5 / pack.n_frames,
                           (0.0, 255.0))
    want = fused_bwd_update_reference(pack, hr, want_err,
                                      0.5 / pack.n_frames, (0.0, 255.0))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == hr.shape
    assert (out - want).abs().max().item() <= ATOL[dtype]
    assert bool(torch.isfinite(out).all())
    assert (getattr(fused_fwd_err, counter),
            getattr(fused_bwd_update, counter)) == (before[0] + 1,
                                                    before[1] + 1)


def test_fused_wrappers_refuse_mixed_types(cuda):
    pack = _pack(cuda, 1, "port", torch.bfloat16)
    hr, lr = _inputs(cuda, pack, torch.float32, 1)
    with pytest.raises(TypeError):
        fused_fwd_err(pack, hr, lr)
    with pytest.raises(ValueError):
        fused_fwd_err(pack, hr[:-1], lr.to(torch.bfloat16))


def _k1_ops():
    rng = np.random.default_rng(5)
    taps = tuple(rng.random(7))
    return {
        "fwd_stride": shift_op_banded(768, 1.0, stride=2, n_out=384,
                                      blur_taps=taps),
        "bwd_stuff": stuff_shift_op_banded(200, 2, -1.0, blur_taps=taps),
        "zoom_short": zoom_op_banded(64, 2),
    }


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("width", [1, 200, 256])
@pytest.mark.parametrize("name", sorted(_k1_ops()))
def test_bf16_row_kernel_matches_plain(cuda, name, width, reps):
    op = BandedOp.tiled(BandedOp.from_banded(_k1_ops()[name]), reps)
    op = op.astype_band(torch.bfloat16).to(cuda)
    assert op.row_pack.bands.dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0, 255, (2, op.n_in, width)),
                        dtype=torch.float32, device=cuda)
    before = (banded_row_apply.launches, banded_row_apply.launches_bf16)
    got = banded_row_apply(op.row_pack, x)
    assert (banded_row_apply.launches,
            banded_row_apply.launches_bf16) == (before[0], before[1] + 1)
    want = banded_row_apply_reference(op.row_pack, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    # exact bf16 products summed in f32: only the order differs
    assert (got - want).abs().max().item() <= 1e-3
