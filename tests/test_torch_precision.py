"""The port's matmul precisions (``mm_precision``) on the CPU.

JAX's CPU backend ignores precision presets (an einsum at
``BF16_BF16_F32_X3``, ``DEFAULT`` or ``BF16_BF16_F32`` has the error of
``HIGHEST`` there), so against the JAX package these hold the port's split
to the float32 result; the split itself is held against a float64 product.
The port's applies take the plain versions of the kernels on the CPU: the
X3 row apply is three float32 matmuls of the bf16 halves, the same
arithmetic as K1's split instantiation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.signal
import torch

from enph459_super_resolution_tpu.ops import opmatrix as JO
from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    X3, banded_row_apply, pack_banded)
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    MM_PRECISIONS, BandedOp, resolve_mm_precision, shift_op_banded)
from enph459_super_resolution_tpu_torch.sr import classical as TC

SHIFTS = ((+0.5, -0.5), (+0.5, +0.5), (-0.5, -0.5), (-0.5, +0.5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_forward(hr, psf, s, f):
    b = scipy.signal.fftconvolve(hr, psf, mode="same")
    return ndi.shift(b, (s[0] * f, s[1] * f), order=3, mode="nearest")[::f,
                                                                       ::f]


def _frames(seed=7):
    rng = np.random.default_rng(seed)
    x = ndi.gaussian_filter(rng.uniform(0, 255, (64, 80)), 3.0)
    x = (x - x.min()) / (np.ptp(x) + 1e-9) * 255
    x[16:32, 20:26] = 230  # a block edge
    psf = JC.make_gaussian_psf()
    return np.stack([_np_forward(x, psf, s, 2) for s in SHIFTS]).astype(
        np.float32), psf


def _u8(a, b):
    return int(np.abs(TC.to_uint8(a).astype(int)
                      - TC.to_uint8(b).astype(int)).max())


def _jax_solve(frames, psf):
    return {k: np.asarray(v) for k, v in
            JC.solve(jnp.asarray(frames), psf, SHIFTS, n_iter=20).items()}


@pytest.fixture(scope="module")
def highest():
    frames, psf = _frames()
    return frames, psf, TC.solve(frames, psf, SHIFTS, n_iter=20,
                                 device="cpu")


@pytest.mark.parametrize("name", ["BF16_BF16_F32_X3", "HIGH"])
def test_x3_tracks_highest_and_jax(highest, name):
    """The split solve within +-1 uint8 of HIGHEST and of the JAX X3 solve
    (which the JAX CPU backend runs at f32), the MSE history within 1 %."""
    frames, psf, want = highest
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu",
                   mm_precision=name)
    prev = JO._MM_PRECISION
    try:
        JO._MM_PRECISION = JO._resolve_mm_precision("BF16_BF16_F32_X3")
        jax_x3 = _jax_solve(frames, psf)
    finally:
        JO._MM_PRECISION = prev
    for ref in (want, jax_x3):
        for k in ("native", "saa", "ibp"):
            assert _u8(got[k], ref[k]) <= 1, k
        np.testing.assert_allclose(got["mse_history"], ref["mse_history"],
                                   rtol=0.01)
    # the split is not the strict path: the results differ somewhere
    assert not np.array_equal(got["ibp"], want["ibp"])


@pytest.mark.parametrize("name", ["DEFAULT", "BF16_BF16_F32"])
def test_default_is_the_bf16_class(highest, monkeypatch, name):
    """One bf16 pass within +-3 of the port's and JAX's HIGHEST solves, and
    within +-1 of JAX's bf16 band store (which rounds its bands to bf16 on
    the CPU too), MSE history within 1 %."""
    frames, psf, want = highest
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu",
                   mm_precision=name)
    monkeypatch.setenv("SRTPU_BAND_STORE", "f32")
    jax_f32 = _jax_solve(frames, psf)
    monkeypatch.setenv("SRTPU_BAND_STORE", "bf16")
    jax_bf16 = _jax_solve(frames, psf)
    for k in ("native", "saa", "ibp"):
        assert _u8(got[k], want[k]) <= 3, k
        assert _u8(got[k], jax_f32[k]) <= 3, k
        assert _u8(got[k], jax_bf16[k]) <= 1, k
    np.testing.assert_allclose(got["mse_history"], jax_bf16["mse_history"],
                               rtol=0.01)
    # one bf16 pass is the bf16 band store's arithmetic
    bf16 = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu",
                    band_store="bf16")
    np.testing.assert_array_equal(got["ibp"], bf16["ibp"])


def _pack_and_input(kind, seed=3):
    rng = np.random.default_rng(seed)
    op = BandedOp.from_banded(shift_op_banded(
        300, 0.37, stride=2, n_out=150, blur_taps=tuple(rng.random(7))))
    x = rng.uniform(0, 255, (2, 300, 37)).astype(np.float32)
    return op, x, pack_banded(op.blocks, op.col_ranges, op.n_out, op.n_in,
                              "cpu", kind)


def _dense(op):
    m = np.zeros((op.n_out, op.n_in))
    r0 = 0
    for blk, (lo, hi) in zip(op.blocks, op.col_ranges):
        m[r0:r0 + blk.shape[0], lo:hi] = blk
        r0 += blk.shape[0]
    return m


@pytest.mark.parametrize("kind,bound", [(X3, 2.0 ** -14),
                                        (torch.bfloat16, 2.0 ** -7)],
                         ids=["x3", "bf16"])
def test_split_against_a_float64_product(kind, bound):
    """Row and column applies against a float64 product: per output, the
    error is at most ``bound`` of sum_k |b_k| |x_k| (X3: ~2^-16 from the
    dropped lo*lo and x's bits past two halves; one bf16 pass: ~2^-8).  An
    X3 op's column apply is float32, well within its bound."""
    op, x, pack = _pack_and_input(kind)
    m = _dense(op)
    got = banded_row_apply(pack, torch.as_tensor(x)).numpy()
    err = np.abs(got - np.einsum("oh,zhw->zow", m, x.astype(np.float64)))
    scale = np.einsum("oh,zhw->zow", np.abs(m), np.abs(x.astype(np.float64)))
    assert (err <= bound * scale).all(), (err / scale).max()
    # the column apply of the same op
    col = op.astype_band(kind).to("cpu")
    xc = torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 1)))
    got_c = col.col_apply(xc).numpy()
    xt = xc.numpy().astype(np.float64)
    err_c = np.abs(got_c - np.einsum("zwh,oh->zwo", xt, m))
    scale_c = np.einsum("zwh,oh->zwo", np.abs(xt), np.abs(m))
    assert (err_c <= bound * scale_c).all(), (err_c / scale_c).max()


def test_x3_pack_halves():
    """The split pack keeps the k-major layout in two bf16 arrays whose sum
    is the float32 band to 2^-16 of each entry."""
    op, _, pack = _pack_and_input(X3)
    f32 = pack_banded(op.blocks, op.col_ranges, op.n_out, op.n_in, "cpu")
    assert pack.kind == X3 and f32.kind == torch.float32
    assert pack.bands.dtype == pack.bands_lo.dtype == torch.bfloat16
    assert pack.bands.shape == pack.bands_lo.shape == f32.bands.shape
    both = pack.bands.double() + pack.bands_lo.double()
    assert (both - f32.bands.double()).abs().max() <= \
        2.0 ** -16 * f32.bands.double().abs().max()
    np.testing.assert_array_equal(pack.meta_host, f32.meta_host)


def test_precision_names_and_cache_key(highest):
    """Each accepted name maps to a band type; any other raises and lists
    them; a changed precision is a fresh operator tree (the counterpart of
    the JAX ``_compiled_solve`` miss)."""
    assert {resolve_mm_precision(n) for n in MM_PRECISIONS} == {
        torch.float32, torch.bfloat16, X3}
    for bad in ("TENSORFLOAT32", "highest", "F32_F32_F32_X6"):
        with pytest.raises(ValueError, match="BF16_BF16_F32_X3"):
            resolve_mm_precision(bad)
    frames, psf, _ = highest
    with pytest.raises(ValueError):
        TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu",
                 mm_precision="FASTEST")
    TC._device_matrices.cache_clear()
    TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu")
    misses = TC._device_matrices.cache_info().misses
    TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu")
    assert TC._device_matrices.cache_info().misses == misses
    TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu", mm_precision="HIGH")
    assert TC._device_matrices.cache_info().misses == misses + 1
    mats = TC._solve_matrices(psf, SHIFTS, 2, (32, 40), 1,
                              torch.device("cpu"), mm_precision="HIGH")
    assert mats["zoom_r"].band_dtype == X3
    assert mats["frames"][0][1][0].band_dtype == X3


def test_precision_leaves_bf16_bands_alone(highest):
    """The split applies to float32 bands only: under hybrid the bf16 bulk
    operators stay bf16 and the f32 tail takes the split."""
    _, psf, _ = highest
    mats = TC._solve_matrices(psf, SHIFTS, 2, (32, 40), 1,
                              torch.device("cpu"), band_store="hybrid:4",
                              mm_precision="BF16_BF16_F32_X3")
    assert mats["frames_lo"][0][0][0].band_dtype == torch.bfloat16
    assert mats["frames"][0][0][0].band_dtype == X3
    assert mats["saa"][0][0].band_dtype == X3
