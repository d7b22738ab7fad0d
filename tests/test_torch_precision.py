"""The port's matmul precisions (``mm_precision``) on the CPU.

JAX's CPU backend runs some of the 18 names of ``Precision`` and
``DotAlgorithmPreset`` and refuses the others.  Where it runs a name it
ignores a bf16 split (an einsum at ``BF16_BF16_F32_X3``, ``_X6``,
``DEFAULT`` or ``BF16_BF16_F32`` has the error of ``HIGHEST`` there), rounds
operands and result to f16 at ``F16_F16_F16`` and sums in float64 at
``F64_F64_F64``; so against the JAX package these hold each port solve to
JAX's at the same name, and where JAX refuses the name, to the port's own
HIGHEST within the class stated.  Each apply is held against a float64
numpy emulation of its preset.  The port's applies take the plain versions
of the kernels on the CPU: the row apply of a split is float32 matmuls of
its rounded parts, the same arithmetic as K1's instantiation.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.signal
import torch

from enph459_super_resolution_tpu.ops import opmatrix as JO
from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    BF16OUT, F16, F16OUT, F64, KINDS, TF32, TF32X3, X3, X6, X9,
    banded_row_apply, pack_banded)
from enph459_super_resolution_tpu_torch.ops.opmatrix import (
    FLOAT8_PRESETS, MM_PRECISIONS, BandedOp, resolve_mm_precision,
    shift_op_banded)
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


def _jax_solve(frames, psf, name=None):
    """The JAX package's solve, its einsums at the precision ``name`` (None:
    as set).  Its module-wide precision and its solver cache are left as
    found: the JAX package's own tests count that cache's misses at these
    keys."""
    prev = JO._MM_PRECISION
    try:
        if name is not None:
            JO._MM_PRECISION = JO._resolve_mm_precision(name)
        return {k: np.asarray(v) for k, v in
                JC.solve(jnp.asarray(frames), psf, SHIFTS,
                         n_iter=20).items()}
    finally:
        JO._MM_PRECISION = prev
        JC._compiled_solve.cache_clear()


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
    jax_x3 = _jax_solve(frames, psf, "BF16_BF16_F32_X3")
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
    assert len(pack.more) == 1
    assert pack.bands.dtype == pack.more[0].dtype == torch.bfloat16
    assert pack.bands.shape == pack.more[0].shape == f32.bands.shape
    both = pack.bands.double() + pack.more[0].double()
    assert (both - f32.bands.double()).abs().max() <= \
        2.0 ** -16 * f32.bands.double().abs().max()
    np.testing.assert_array_equal(pack.meta_host, f32.meta_host)


def test_precision_names_and_cache_key(highest):
    """Each accepted name maps to a band type; any other raises and lists
    them; a changed precision is a fresh operator tree (the counterpart of
    the JAX ``_compiled_solve`` miss)."""
    assert {resolve_mm_precision(n) for n in MM_PRECISIONS} == {
        torch.float32, torch.bfloat16, X3, X6, X9, TF32, TF32X3, F16, F16OUT,
        BF16OUT, F64} == set(KINDS)
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
    TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu",
             mm_precision="F16_F16_F16")
    assert TC._device_matrices.cache_info().misses == misses + 2
    mats = TC._solve_matrices(psf, SHIFTS, 2, (32, 40), 1,
                              torch.device("cpu"), mm_precision="F16_F16_F16")
    assert mats["zoom_r"].band_dtype == F16OUT
    assert mats["frames"][0][1][0].band_dtype == F16OUT


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


# -- every name of JAX's Precision and DotAlgorithmPreset ---------------------

JAX_NAMES = sorted(
    {n for n in dir(jax.lax.Precision) if n.isupper()}
    | {n for n in dir(jax.lax.DotAlgorithmPreset) if n.isupper()})


def test_every_jax_name_is_known():
    """The 18 names: 14 resolve to a band kind, the 4 float8 presets
    raise; JAX resolves every one of them."""
    assert len(JAX_NAMES) == 18
    assert sorted(set(MM_PRECISIONS) | set(FLOAT8_PRESETS)) == JAX_NAMES
    for name in JAX_NAMES:
        assert JO._resolve_mm_precision(name) is not None


def _jax_einsum(name):
    a = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((96, 32)).astype(np.float32)
    return jnp.einsum("ij,jk->ik", a, b,
                      precision=JO._resolve_mm_precision(name))


@pytest.mark.parametrize("name", FLOAT8_PRESETS)
def test_float8_presets_raise_in_both(name):
    """The float8 presets take float8 operands; the solve's are float32:
    the port refuses them by name, JAX's CPU backend at the product."""
    with pytest.raises(ValueError, match="float8"):
        resolve_mm_precision(name)
    with pytest.raises(ValueError, match="not supported"):
        _jax_einsum(name)


# Each apply against a float64 numpy emulation of its preset: operands
# rounded (or split) as the preset takes them, exact products summed in
# float64, the result rounded as the preset's.  The port sums in float32 in
# another order, within SUM_SHARE of sum_k |b_k| |x_k| (measured: 2^-20.9
# to 2^-21.5); F64 sums in float64 and rounds once to float32, within 2^-23
# (2^-24.0).  A preset that rounds its result (BF16_BF16_BF16,
# F16_F16_F16) may then round to the neighbouring value, one ulp of the
# result type.  Beside it, the class of each kind against the exact float64
# product, as a share of the same sum (measured in brackets): the operand
# rounding (bf16 2^-8, tf32 and f16 2^-11 a side), the dropped products of
# a split, and the result's rounding.
SUM_SHARE = 2.0 ** -19
KIND_CASES = {  # kind: (share within the emulation, class share, out ulp)
    torch.float32: (SUM_SHARE, 2.0 ** -19, 0.0),   # (2^-21.3)
    torch.bfloat16: (SUM_SHARE, 2.0 ** -7, 0.0),   # (2^-8.3)
    BF16OUT: (SUM_SHARE, 2.0 ** -6, 2.0 ** -7),    # (2^-7.5)
    X3: (SUM_SHARE, 2.0 ** -15, 0.0),              # (2^-17.1)
    X6: (SUM_SHARE, 2.0 ** -19, 0.0),              # (2^-20.9)
    X9: (SUM_SHARE, 2.0 ** -19, 0.0),              # (2^-20.9)
    TF32: (SUM_SHARE, 2.0 ** -10, 0.0),            # (2^-11.1)
    TF32X3: (SUM_SHARE, 2.0 ** -19, 0.0),          # (2^-20.9)
    F16: (SUM_SHARE, 2.0 ** -10, 0.0),             # (2^-11.1)
    F16OUT: (SUM_SHARE, 2.0 ** -9, 2.0 ** -10),    # (2^-10.3)
    F64: (2.0 ** -23, 2.0 ** -23, 0.0),            # (2^-24.0)
}


def _np_round(kind, v):
    """float64 holding float32 values, rounded as the kind's operands."""
    v32 = np.asarray(v, dtype=np.float32)
    if kind in (torch.bfloat16, BF16OUT, X3, X6, X9):
        return v32.astype(ml_dtypes.bfloat16).astype(np.float64)
    if kind in (F16, F16OUT):
        return v32.astype(np.float16).astype(np.float64)
    if kind in (TF32, TF32X3):
        bits = v32.view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32).astype(np.float64)
    return v32.astype(np.float64)


def _np_parts(kind, v):
    parts, rest = [], np.asarray(v, dtype=np.float64)
    for p in range(KINDS[kind].parts):
        parts.append(_np_round(kind, rest))
        rest = rest - parts[-1]
    return parts


def _emulate(kind, m, x):
    """``m @ x`` (rows of x) as the preset computes it, in float64."""
    spec = KINDS[kind]
    mp, xp = _np_parts(kind, m), _np_parts(kind, x)
    y = sum(np.einsum("oh,zhw->zow", mp[p], xp[q])
            for p in range(spec.parts) for q in range(spec.parts)
            if p + q <= spec.reach)
    if spec.out == torch.bfloat16:
        return y.astype(np.float32).astype(ml_dtypes.bfloat16).astype(
            np.float64)
    if spec.out == torch.float16:
        return y.astype(np.float16).astype(np.float64)
    return y.astype(np.float32).astype(np.float64) if kind == F64 else y


@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("kind", list(KIND_CASES),
                         ids=[str(k).replace("torch.", "")
                              for k in KIND_CASES])
def test_apply_against_a_float64_emulation(kind, axis):
    op, x, pack = _pack_and_input(kind)
    m = _dense(op)
    if axis == "row":
        got = banded_row_apply(pack, torch.as_tensor(x)).numpy()
    else:  # the same op along the columns: x^T @ m^T, transposed back
        xc = torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 1)))
        got = op.astype_band(kind).to("cpu").col_apply(xc).numpy()
        got = got.transpose(0, 2, 1)
    share, cls, ulp = KIND_CASES[kind]
    scale = np.einsum("oh,zhw->zow", np.abs(m), np.abs(x.astype(np.float64)))
    # a split's column apply is the float32 product (module docstring of
    # ops.opmatrix), within the split's class
    split_col = axis == "col" and KINDS[kind].parts > 1
    want = _emulate(torch.float32 if split_col else kind, m, x)
    err = np.abs(got - want)
    assert (err <= share * scale + ulp * np.abs(want) + 2.0 ** -24).all(), \
        (err / scale).max()
    exact = np.einsum("oh,zhw->zow", m, x.astype(np.float64))
    assert (np.abs(got - exact) <= cls * scale).all(), \
        (np.abs(got - exact) / scale).max()
    if KINDS[kind].out is not None:  # a value of the result type
        rt = ml_dtypes.bfloat16 if kind == BF16OUT else np.float16
        np.testing.assert_array_equal(got.astype(rt).astype(np.float32), got)


@pytest.mark.parametrize("kind", list(KIND_CASES),
                         ids=[str(k).replace("torch.", "")
                              for k in KIND_CASES])
def test_pack_parts_rebuild_the_bands(kind):
    """Each kind's pack: its parts in their storage type, the k-major
    layout and metadata of the float32 pack, and parts that add up to the
    float32 bands within the kind's operand rounding (exactly for X6 and
    X9: three bf16 parts hold 24 significand bits)."""
    op, _, pack = _pack_and_input(kind)
    f32 = pack_banded(op.blocks, op.col_ranges, op.n_out, op.n_in, "cpu")
    spec = KINDS[kind]
    assert pack.kind == kind and len(pack.parts) == spec.parts
    for part in pack.parts:
        assert part.dtype == spec.storage and part.shape == f32.bands.shape
    np.testing.assert_array_equal(pack.meta_host, f32.meta_host)
    total = sum(part.double() for part in pack.parts)
    # nearest rounding to 8 (bf16) or 11 (tf32, f16) significant bits
    share = {torch.bfloat16: 2.0 ** -8, BF16OUT: 2.0 ** -8, X3: 2.0 ** -16,
             TF32: 2.0 ** -11, TF32X3: 2.0 ** -22, F16: 2.0 ** -11,
             F16OUT: 2.0 ** -11}.get(kind, 0.0)
    ref = f32.bands.double()
    # f16 parts: entries under 2^-14 are subnormal (absolute 2^-25)
    floor = 2.0 ** -25 if spec.storage == torch.float16 else 0.0
    assert ((total - ref).abs() <= share * ref.abs() + floor).all()


# Solves at each name (20 iterations, 64x80 LR): where JAX's CPU runs the
# name, within +-1 uint8 and MSE history rtol 1e-3 of JAX's solve at it;
# where it refuses the name, against the port's HIGHEST within the class
# measured on this input (max |uint8 diff| of native, saa, ibp; MSE rtol):
# X9 and TF32_X3 0 and ~5e-7, stated +-1 and 1e-5; TF32 and F16_F16_F32 1
# and 0.37 %, stated +-2 and 1 %; BF16_BF16_BF16 2 and 1.6 %, stated +-3
# and 5 %.  The names JAX runs: X6 and F64 0 off JAX and HIGHEST,
# F16_F16_F16 0 off JAX (1 off HIGHEST).
JAX_RUNS = ("BF16_BF16_F32_X6", "F16_F16_F16", "F64_F64_F64")
JAX_REFUSES = {"BF16_BF16_F32_X9": (1, 1e-5), "TF32_TF32_F32_X3": (1, 1e-5),
               "TF32_TF32_F32": (2, 0.01), "F16_F16_F32": (2, 0.01),
               "BF16_BF16_BF16": (3, 0.05)}


@pytest.mark.parametrize("name", JAX_RUNS)
def test_solve_matches_jax_where_jax_runs_the_name(highest, name):
    frames, psf, _ = highest
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu",
                   mm_precision=name)
    want = _jax_solve(frames, psf, name)
    for k in ("native", "saa", "ibp"):
        assert _u8(got[k], want[k]) <= 1, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)


@pytest.mark.parametrize("name", sorted(JAX_REFUSES))
def test_solve_holds_its_class_where_jax_refuses_the_name(highest, name):
    with pytest.raises(ValueError, match="not supported"):
        _jax_einsum(name)
    frames, psf, want = highest
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu",
                   mm_precision=name)
    tol, rtol = JAX_REFUSES[name]
    for k in ("native", "saa", "ibp"):
        assert _u8(got[k], want[k]) <= tol, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=rtol)
    assert not np.array_equal(got["ibp"], want["ibp"])


@pytest.mark.parametrize("name,kind", [("BF16_BF16_F32_X9", X9),
                                       ("TF32_TF32_F32", TF32),
                                       ("F64_F64_F64", F64)])
def test_hybrid_tail_takes_every_preset(highest, name, kind):
    """Under hybrid the bf16 bulk stays bf16 and the f32 tail, the zoom and
    Shift-and-Add take the preset's kind; bf16 stores ignore it."""
    _, psf, _ = highest
    mats = TC._solve_matrices(psf, SHIFTS, 2, (32, 40), 1,
                              torch.device("cpu"), band_store="hybrid:4",
                              mm_precision=name)
    assert mats["frames_lo"][0][0][0].band_dtype == torch.bfloat16
    assert mats["frames"][0][0][0].band_dtype == kind
    assert mats["saa"][0][1].band_dtype == kind
    bf16 = TC._solve_matrices(psf, SHIFTS, 2, (32, 40), 1,
                              torch.device("cpu"), band_store="bf16",
                              mm_precision=name)
    assert bf16["frames"][0][0][0].band_dtype == torch.bfloat16
