"""The fused IBP kernels (K2, K3) and the bf16 banded-row kernel against
their plain PyTorch versions, on the card.

Needs an NVIDIA card with the CUDA toolkit (``nvcc``); skips without one.
Run on the card with ``python -m pytest --noconftest
tests/test_torch_fused_ibp_cuda.py -q``.  Cases: the port's 64-row /
64-column pack, a wide 128-row / 256-column pack (the TPU's block and
tile, which each CUDA block covers in parts) and a ragged one (LR 96x200:
a short last row block and column tile), one and three reps stacked along
H, float32 and bfloat16 bands; the 4-rep rgb pack at full size; a rank-2
PSF, whose frames sum terms from two row operators, and a full-rank one
(more operators than the f32 K3 holds at once); random packs with row
and column windows that are no multiple of 16, run past the input and start
at unaligned columns, with 1 to 8 frames, and LR rows that are no
multiple of 16 bytes; for K1, the bf16 bands on the
edge cases of the f32 kernel's tests (short blocks inside rep-tiled
operators, windows that overhang the input, widths off the 128-column
tile).
"""

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    banded_row_apply, banded_row_apply_reference)
from enph459_super_resolution_tpu_torch.ops.fused_ibp import (
    FusedIBP, fused_bwd_update, fused_bwd_update_reference, fused_fwd_err,
    fused_fwd_err_reference)
from enph459_super_resolution_tpu_torch.data.sessions import \
    CORNER_SHIFTS_LR
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    BandedOp, psf_separable_factors, shift_op_banded, stuff_shift_op_banded,
    zoom_op_banded)
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


def _check_pair(pack, hr, lr, dtype):
    """K2 and K3 (from the plain version's err stack, so each is judged
    alone) against their plain versions; returns the share of elements
    that differ from the plain version (err, out)."""
    err = fused_fwd_err(pack, hr, lr)
    want_err = fused_fwd_err_reference(pack, hr, lr)
    out = fused_bwd_update(pack, hr, want_err, 0.5 / pack.n_frames,
                           (0.0, 255.0))
    want = fused_bwd_update_reference(pack, hr, want_err,
                                      0.5 / pack.n_frames, (0.0, 255.0))
    torch.cuda.synchronize()
    assert err.dtype == dtype and err.shape == lr.shape
    assert out.dtype == torch.float32 and out.shape == hr.shape
    assert bool(torch.isfinite(err.float()).all())
    assert bool(torch.isfinite(out).all())
    d_err = (err.float() - want_err.float()).abs()
    d_out = (out - want).abs()
    assert d_err.max().item() <= ATOL[dtype]
    assert d_out.max().item() <= ATOL[dtype]
    return ((d_err > 0).float().mean().item(),
            (d_out > 0).float().mean().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_kernels_rgb_pack(cuda, dtype):
    """The 4-rep rgb pack at full size: 4 frames, 2 unique row operators."""
    frames = _host_solve_matrices(make_gaussian_psf(), CORNER_SHIFTS_LR, 2,
                                  (768, 1024), reps=4)["frames"]
    pack = FusedIBP.build(frames, cuda).astype_bands(dtype)
    assert tuple(pack.f_bandr.shape[:2]) == (48, 2)
    hr, lr = _inputs(cuda, pack, dtype, 11)
    _check_pair(pack, hr, lr, dtype)


def _rank2_psf():
    """The normalised sum of two outer products of different 1-D
    Gaussians: exactly two separable terms."""
    x = np.arange(7) - 3.0
    a, b = np.exp(-x ** 2 / 2.0), np.exp(-x ** 2 / 8.0)
    psf = np.outer(a, b) + np.outer(b, a)
    return (psf / psf.sum()).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_kernels_rank2_psf(cuda, layout, dtype):
    """Every frame sums terms from two row groups."""
    psf = _rank2_psf()
    assert len(psf_separable_factors(psf)[0]) == 2
    lr_shape, block, tile = LAYOUTS[layout]
    frames = _host_solve_matrices(psf, SHIFTS, 2, lr_shape)["frames"]
    pack = FusedIBP.build(frames, cuda, block=block,
                          tile=tile).astype_bands(dtype)
    assert len(pack.f_entries) == 2 * len(SHIFTS)
    assert len(pack.f_groups) > len(SHIFTS) // 2
    hr, lr = _inputs(cuda, pack, dtype, 12)
    _check_pair(pack, hr, lr, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_kernels_full_rank_psf(cuda, dtype):
    """A random 7x7 PSF of full rank: 7 terms a frame, 21 row and 21 column
    operators, more than the f32 K3 holds at once, so it walks the plan one
    group at a time (and the bf16 kernels their row operators in sets)."""
    rng = np.random.default_rng(3)
    psf = rng.uniform(0.1, 1.0, (7, 7))
    psf = (psf / psf.sum()).astype(np.float32)
    assert len(psf_separable_factors(psf)[0]) == 7
    frames = _host_solve_matrices(psf, SHIFTS, 2, (128, 256))["frames"]
    pack = FusedIBP.build(frames, cuda).astype_bands(dtype)
    assert pack.b_bandr.shape[1] > 7 and len(pack.b_entries) == 28
    hr, lr = _inputs(cuda, pack, dtype, 14)
    _check_pair(pack, hr, lr, dtype)


def _random_side(rng, n_blocks, blk, n_ops, n_in, win, aligned):
    """Window starts and random bands for one side of a random pack: starts
    at any column (or multiples of 8), the last window running past the
    input, band entries zero there; each output's taps sum to ~1."""
    hi = max(n_in - win // 2, 1)
    starts = rng.integers(0, hi, n_blocks)
    if aligned:
        starts = starts // 8 * 8
    starts[-1] = hi if not aligned else hi // 8 * 8
    bands = rng.uniform(0.0, 1.0, (n_blocks, n_ops, blk, win))
    bands /= bands.sum(axis=-1, keepdims=True)
    past = starts[:, None] + np.arange(win)[None, :] >= n_in  # [n, win]
    bands[past[:, None, None, :].repeat(n_ops, 1).repeat(blk, 2)] = 0.0
    return starts.astype(np.int32), bands.astype(np.float32)


def _random_pack(cuda, dtype, n_frames, lr_shape, wins, aligned, seed,
                 terms=1):
    """A pack of random operators for LR ``lr_shape`` -> 2x HR with 64-row
    blocks and 64-column tiles, row/column windows ``wins`` = (forward row,
    forward column, back-projection row, back-projection column), two row
    and two column operators; frame f takes ``terms`` terms."""
    rng = np.random.default_rng(seed)
    h, w = lr_shape
    H, W = 2 * h, 2 * w
    nb_f, nt_f = -(-h // 64), -(-w // 64)
    nb_b, nt_b = -(-H // 64), -(-W // 64)
    arrays = {}
    for name, n, n_in, win in (("f_r", nb_f, H, wins[0]),
                               ("f_c", nt_f, W, wins[1]),
                               ("b_r", nb_b, h, wins[2]),
                               ("b_c", nt_b, w, wins[3])):
        starts, bands = _random_side(rng, n, 64, 2, n_in, win, aligned)
        bands /= terms
        side = "r" if name[-1] == "r" else "c"
        arrays[f"{name[0]}_s{side}"] = torch.as_tensor(starts, device=cuda)
        if side == "c":  # column operators transposed: [nt, n_c, win, tile]
            bands = np.ascontiguousarray(bands.transpose(0, 1, 3, 2))
        arrays[f"{name[0]}_band{side}"] = torch.as_tensor(bands, device=cuda)
    entries = [(f, (f + t) % 2, (f // 2 + t) % 2) for f in range(n_frames)
               for t in range(terms)]
    pack = FusedIBP(arrays, entries, sorted({u for _, u, _ in entries}),
                    entries, n_frames, lr_shape, (H, W))
    return pack.astype_bands(dtype)


RANDOM_CASES = {
    # (frames, LR shape, windows, aligned column starts, terms per frame)
    "k_not_16": (5, (128, 256), (40, 56, 24, 40), True, 1),
    "unaligned": (5, (128, 256), (48, 64, 24, 40), False, 1),
    "unaligned_odd_k": (3, (96, 200), (37, 45, 21, 27), False, 1),
    "frames6": (6, (128, 256), (40, 56, 24, 40), False, 1),
    "frames8": (8, (128, 256), (40, 56, 24, 40), True, 1),
    "frames8_terms2": (8, (64, 128), (40, 56, 24, 40), False, 2),
    "one_frame": (1, (64, 128), (24, 24, 16, 16), False, 1),
    # LR rows of 130 floats, no multiple of 16 bytes: the f32 K3 copies by
    # cp.async where its tensor maps cannot describe err
    "cols_off_16b": (3, (64, 130), (24, 40, 16, 24), False, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(RANDOM_CASES))
def test_fused_kernels_random_packs(cuda, case, dtype):
    n, lr_shape, wins, aligned, terms = RANDOM_CASES[case]
    pack = _random_pack(cuda, dtype, n, lr_shape, wins, aligned, 21, terms)
    starts = torch.cat([pack.f_sc, pack.b_sc]).cpu()
    assert aligned == bool((starts % 8 == 0).all())
    assert int(pack.f_sr[-1]) + wins[0] > pack.hr_shape[0]  # overhangs
    hr, lr = _inputs(cuda, pack, dtype, 13)
    _check_pair(pack, hr, lr, dtype)


# Packs whose hr the f32 K2's tensor map cannot describe, so its chunks
# come by cp.async: HR rows of 258 floats, no multiple of 16 bytes; and
# forward row windows of 300 rows, past the TMA's 256-row box (which also
# take one plan group per set).  (frames, LR shape, windows, aligned
# column starts, terms per frame), as RANDOM_CASES.
STAGING_CASES = {
    "hr_cols_off_16b": (3, (64, 129), (24, 40, 16, 24), False, 1),
    "row_window_over_256": (3, (192, 128), (300, 40, 24, 40), False, 1),
}


@pytest.mark.parametrize("case", sorted(STAGING_CASES))
def test_fused_fwd_f32_cp_async_staging(cuda, case):
    n, lr_shape, wins, aligned, terms = STAGING_CASES[case]
    pack = _random_pack(cuda, torch.float32, n, lr_shape, wins, aligned, 23,
                        terms)
    if case == "hr_cols_off_16b":
        assert pack.hr_shape[1] * 4 % 16 != 0
    else:
        assert pack.f_bandr.shape[-1] > 256
        assert pack.k2_f32_layout()["sets"] == "one group per set"
    hr, lr = _inputs(cuda, pack, torch.float32, 17)
    before = fused_fwd_err.launches
    _check_pair(pack, hr, lr, torch.float32)
    assert fused_fwd_err.launches == before + 1


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
