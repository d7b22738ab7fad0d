"""1-D image operators as banded matrices, applied as block matmuls.

Counterpart of ``enph459_super_resolution_tpu/ops/opmatrix.py``.  The host
construction (``_ext_index`` .. ``psf_separable_factors``) is the reference's
float64 numpy code, copied verbatim so that the bands come out entry for
entry identical.  Every 1-D stage of the classical solve -- PSF blur,
cubic-spline prefilter, sub-pixel phase, decimation, zero-stuffing and
SciPy's exact boundary semantics -- is one (n_out, n_in) banded matrix per
axis, applied as ``M_row @ img @ M_col^T``.

:class:`BandedOp` holds the per-128-row-block decomposition on the host
and, after :meth:`BandedOp.to`, two device packs of it:

* the row pack (``ops.banded_rows.pack_banded``) feeds the hand-written
  CUDA kernel ``csrc/banded_rows.cu`` for every row apply on the card and
  its plain PyTorch version for tensors on the CPU;
* the column pack (gathered column windows + transposed blocks) feeds one
  batched ``torch.matmul`` per column apply -- the reference computes the
  column applies outside any kernel too.

:meth:`BandedOp.astype_band` gives the bf16 band store's copy of an op.
Its host blocks stay float32 (numpy has no bf16, and the disk cache holds
float32); the bands become bf16 where the op is bound to the device, and
both applies then follow the reference's bf16 einsums: the operand rounded
to bf16, exact bf16 x bf16 products summed in float32, a float32 result.

Matmul precision (the reference's ``SRTPU_MM_PRECISION``, ``sr.run
--mm-precision``) applies to the applies of float32 bands only, as in the
reference: bf16 bands, the fused kernels and the dense sampling matmuls
ignore it.  Every name of JAX's ``Precision`` and ``DotAlgorithmPreset``
is accepted (:data:`MM_PRECISIONS` maps each to the band kind of
``ops.banded_rows`` that the row applies take, each a K1 instantiation on
the card) except the four ``ANY_F8_*``, which take float8 operands where
the solve's are float32, and raise ``ValueError`` (JAX's CPU backend
refuses them too):

* ``HIGHEST`` (the default) and ``F32_F32_F32`` -- strict float32;
* ``HIGH`` and ``BF16_BF16_F32_X3`` -- the 3-pass bf16 split
  ``hi*hi + hi*lo + lo*hi`` of bands and operand (what XLA runs for
  ``HIGH`` on its TPU); ``BF16_BF16_F32_X6`` and ``_X9`` -- three bf16
  parts, six or nine products; ``TF32_TF32_F32_X3`` -- the 3-pass split
  into tf32 parts.  Their column applies, one library matmul each, stay
  float32: that is within the splits' error bounds;
* ``DEFAULT`` and ``BF16_BF16_F32`` -- one bf16 pass, the class of the
  bf16 band store; ``BF16_BF16_BF16`` the same with each apply's result
  rounded to bf16 (the sum stays float32, where the preset names a bf16
  accumulator); ``TF32_TF32_F32`` -- one tf32 pass; ``F16_F16_F32`` -- one
  f16 pass, ``F16_F16_F16`` with each result rounded to f16 (as JAX's CPU
  backend computes it).  Their column applies round the operands the same
  way, take the float32 matmul of the exact products, and round the result
  alike;
* ``F64_F64_F64`` -- bands and operand widened to float64, the sum in
  float64, each result rounded to float32 (the column apply a float64
  matmul).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .banded_rows import (BF16OUT, F16, F16OUT, F64, KINDS, TF32, TF32X3,
                          X3, X6, X9, RowPack, banded_row_apply,
                          banded_row_apply_reference, pack_banded,
                          round_result)
from .resample import bspline_prefilter_kernel, cubic_bspline_weights
from ..utils.trace import span

# Rows per block of the decomposition, as in the reference: a 128-row
# block's nonzero column window spans ~2*128+43 columns for the stride-2
# forward operators, so the block matmuls do ~12x fewer FLOPs than dense.
BLOCK = 128

# Accepted mm_precision names -> the band kind float32 bands take on the
# device under them (see the module docstring).
MM_PRECISIONS = {"HIGHEST": torch.float32, "F32_F32_F32": torch.float32,
                 "HIGH": X3, "BF16_BF16_F32_X3": X3,
                 "BF16_BF16_F32_X6": X6, "BF16_BF16_F32_X9": X9,
                 "DEFAULT": torch.bfloat16, "BF16_BF16_F32": torch.bfloat16,
                 "BF16_BF16_BF16": BF16OUT,
                 "TF32_TF32_F32": TF32, "TF32_TF32_F32_X3": TF32X3,
                 "F16_F16_F32": F16, "F16_F16_F16": F16OUT,
                 "F64_F64_F64": F64}
# JAX's presets for float8 operands: no band kind of the float32 solve.
FLOAT8_PRESETS = ("ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM",
                  "ANY_F8_ANY_F8_ANY", "ANY_F8_ANY_F8_ANY_FAST_ACCUM")


def resolve_mm_precision(name: str):
    """The band kind float32 bands take at matmul precision ``name`` (a key
    of ``ops.banded_rows.KINDS``); raises ``ValueError`` for a float8
    preset or an unknown name."""
    if name in FLOAT8_PRESETS:
        raise ValueError(f"mm_precision {name!r} takes float8 operands; the "
                         "solve's operands are float32 (JAX's CPU backend "
                         "refuses it too)")
    try:
        return MM_PRECISIONS[name]
    except KeyError:
        raise ValueError(f"mm_precision {name!r}: use one of "
                         f"{', '.join(MM_PRECISIONS)}") from None


def _ext_index(e: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Map extended-signal indices to source indices per SciPy semantics."""
    e = np.asarray(e, dtype=np.int64)
    if mode == "nearest":
        npad = 12  # scipy _prepad_for_spline_filter
        m = n + 2 * npad
        ep = e + npad
        ep = ep % (2 * m)
        ep = np.where(ep >= m, 2 * m - 1 - ep, ep)  # symmetric beyond pre-pad
        return np.clip(ep - npad, 0, n - 1)          # edge pre-pad region
    if mode == "mirror":
        if n == 1:
            return np.zeros_like(e)
        period = 2 * (n - 1)
        ep = np.abs(e) % period
        return np.where(ep >= n, period - ep, ep)
    if mode == "reflect":
        m = 2 * n
        ep = e % m
        return np.where(ep >= n, m - 1 - ep, ep)
    if mode in ("wrap", "grid-wrap"):
        return e % n
    raise ValueError(f"unsupported mode {mode!r}")


class HostBanded:
    """Host-side banded matrix: ``M[i, start[i] + k] = data[i, k]``.

    All nonzero columns of row ``i`` lie in ``[start[i], start[i] + W)``
    with ``0 <= start[i]`` and ``start[i] + W <= n_in``.
    """

    __slots__ = ("data", "start", "n_in")

    def __init__(self, data: np.ndarray, start: np.ndarray, n_in: int):
        self.data = data          # (n_out, W) float64
        self.start = start        # (n_out,) int64
        self.n_in = int(n_in)

    @property
    def shape(self):
        return (self.data.shape[0], self.n_in)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        n_out, w = self.data.shape
        m = np.zeros((n_out, self.n_in), dtype=np.float64)
        rows = np.repeat(np.arange(n_out), w)
        cols = (self.start[:, None] + np.arange(w)[None, :]).ravel()
        m[rows, cols] = self.data.ravel()
        return m.astype(dtype, copy=False)


def band_from_kernel(n_out: int, n_in: int, kernel: np.ndarray, offset: int,
                     mode: Optional[str], stride: int = 1) -> HostBanded:
    """``M[i, map(i*stride + offset + j)] += kernel[j]`` in banded form
    (``mode=None``: zero boundary, taps falling outside are dropped)."""
    kernel = np.asarray(kernel, dtype=np.float64)
    nk = len(kernel)
    rows = np.arange(n_out, dtype=np.int64)
    e = rows[:, None] * stride + offset + np.arange(nk, dtype=np.int64)[None]
    if mode is None:
        valid = (e >= 0) & (e < n_in)
        mapped = np.clip(e, 0, n_in - 1)
    else:
        valid = np.ones(e.shape, dtype=bool)
        mapped = _ext_index(e, n_in, mode)
    # window = span of VALID mapped indices per row (empty rows -> [0, 1));
    # start is clamped so start + width <= n_in holds with the GLOBAL width
    # (rows whose own span is narrower just carry leading zeros)
    big = np.where(valid, mapped, np.iinfo(np.int64).max)
    start = np.minimum(big.min(axis=1), n_in - 1)
    small = np.where(valid, mapped, np.iinfo(np.int64).min)
    hi = np.maximum(small.max(axis=1), 0)
    width = min(max(int((hi - start).max()) + 1, 1), n_in)
    start = np.clip(start, 0, n_in - width)
    data = np.zeros((n_out, width), dtype=np.float64)
    for j in range(nk):
        kj = kernel[j]
        if kj == 0.0:
            continue
        ok = valid[:, j]
        # distinct rows -> no intra-assignment collision; folds across
        # different j accumulate in j order
        data[rows[ok], mapped[ok, j] - start[ok]] += kj
    return HostBanded(data, start, n_in)


def band_compose(a: HostBanded, b: HostBanded) -> HostBanded:
    """``A @ B`` in banded form (requires ``a.n_in == b.shape[0]``);
    accumulates over A's taps in column order."""
    if a.n_in != b.shape[0]:
        raise ValueError(f"compose shape mismatch: {a.shape} @ {b.shape}")
    n_out, wa = a.data.shape
    wb = b.data.shape[1]
    rows_b = a.start[:, None] + np.arange(wa, dtype=np.int64)[None, :]
    sb = b.start[rows_b]                     # (n_out, wa) contributing starts
    c_start = sb.min(axis=1)
    width = int((sb.max(axis=1) - c_start).max()) + wb
    c_start = np.clip(c_start, 0, b.n_in - width)  # global-width overhang
    data = np.zeros((n_out, width), dtype=np.float64)
    rows = np.arange(n_out)
    col_base = np.arange(wb, dtype=np.int64)[None, :]
    for k in range(wa):
        coeff = a.data[:, k]
        ok = coeff != 0.0
        if not ok.any():
            continue
        rb = rows_b[ok, k]
        cols = (sb[ok, k] - c_start[ok])[:, None] + col_base
        data[rows[ok, None], cols] += coeff[ok, None] * b.data[rb]
    return HostBanded(data, c_start, b.n_in)


def band_decimate_cols(a: HostBanded, step: int) -> HostBanded:
    """``A[:, ::step]`` in banded form (zero-stuffed-input composition)."""
    n_out, w = a.data.shape
    n_in2 = (a.n_in - 1) // step + 1
    wc = min(max((w - 1) // step + 1, 1), n_in2)
    # first kept output column; clamped so c0 + wc <= n_in2 (slots before
    # the row's own window read as zero via the validity mask below)
    c0 = np.clip(-(-a.start // step), 0, n_in2 - wc)
    cols = (c0 * step - a.start)[:, None] \
        + np.arange(wc, dtype=np.int64)[None, :] * step
    ok = (cols >= 0) & (cols < w)
    data = np.where(
        ok, a.data[np.arange(n_out)[:, None], np.clip(cols, 0, w - 1)], 0.0)
    return HostBanded(data, c0, n_in2)


def band_transpose(a: HostBanded) -> HostBanded:
    """``A^T`` in banded form (adjoint-solver operators)."""
    n_out, w = a.data.shape
    cols = (a.start[:, None] + np.arange(w, dtype=np.int64)[None, :]).ravel()
    rows = np.repeat(np.arange(n_out, dtype=np.int64), w)
    first = np.full(a.n_in, n_out, dtype=np.int64)
    np.minimum.at(first, cols, rows)
    last = np.full(a.n_in, -1, dtype=np.int64)
    np.maximum.at(last, cols, rows)
    empty = last < 0
    first[empty] = 0
    last[empty] = 0
    wt = min(max(int((last - first).max()) + 1, 1), n_out)
    first = np.clip(first, 0, n_out - wt)  # keep start + width <= n_out
    data = np.zeros((a.n_in, wt), dtype=np.float64)
    data[cols, rows - first[cols]] = a.data.ravel()
    return HostBanded(data, first, n_out)


def _sampling_banded(in_size: int, coords: np.ndarray,
                     mode: str) -> HostBanded:
    """Cubic sampling at ``coords`` (4 taps/row, SciPy out-of-range index
    mapping) in banded form."""
    from .resample import _map_index

    coords = np.asarray(coords, dtype=np.float64)
    j = np.floor(coords).astype(np.int64)
    t = coords - j
    w4 = cubic_bspline_weights(t)            # (n_out, 4)
    idx = j[:, None] - 1 + np.arange(4, dtype=np.int64)[None, :]
    mapped = _map_index(idx, in_size, mode)
    start = mapped.min(axis=1)
    width = min(int((mapped.max(axis=1) - start).max()) + 1, in_size)
    start = np.clip(start, 0, in_size - width)
    data = np.zeros((len(coords), width), dtype=np.float64)
    rows = np.arange(len(coords))
    for k in range(4):  # folds accumulate in k order
        np.add.at(data, (rows, mapped[:, k] - start), w4[:, k])
    return HostBanded(data, start, in_size)


@functools.lru_cache(maxsize=None)
def shift_op_banded(n_in: int, delta: float, mode: str = "nearest",
                    stride: int = 1, n_out: Optional[int] = None,
                    blur_taps: Optional[Tuple[float, ...]] = None,
                    blur_first: bool = True,
                    dtype_name: str = "float32") -> HostBanded:
    """Banded operator for ``decimate(shift(blur(x)))`` (or blur-last)
    along one axis.

    * shift: ``out[i] = spline(x)(i - delta)``, order-3, SciPy 'nearest'
      boundary (reference ``ndi_shift`` semantics).
    * blur_taps: optional correlation taps (odd length, centre-anchored)
      applied with zero boundary, before the shift (forward model) or
      after it (back-projection).
    * stride: output decimation (forward model's ``[::f]``).

    ``dtype_name`` selects the prefilter truncation length (the band stays
    float64 until the device cast).
    """
    h = bspline_prefilter_kernel(dtype_name)
    hw = (len(h) - 1) // 2
    s = -float(delta)
    mfloor = math.floor(s)
    w = cubic_bspline_weights(np.float64(s - mfloor))
    g = np.convolve(h, w)
    offset = (mfloor - 1) - hw

    n_out = n_out if n_out is not None else (n_in - 1) // stride + 1
    if blur_taps is None:
        return band_from_kernel(n_out, n_in, g, offset, mode, stride)

    taps = np.asarray(blur_taps, dtype=np.float64)
    bhw = (len(taps) - 1) // 2
    if blur_first:
        # shift matrix maps blurred -> out; blur matrix maps in -> blurred
        b_shift = band_from_kernel(n_out, n_in, g, offset, mode, stride)
        b_blur = band_from_kernel(n_in, n_in, taps, -bhw, None)
        return band_compose(b_shift, b_blur)
    b_blur = band_from_kernel(n_out, n_out, taps, -bhw, None)
    b_shift = band_from_kernel(n_out, n_in, g, offset, mode, stride)
    return band_compose(b_blur, b_shift)


@functools.lru_cache(maxsize=None)
def stuff_shift_op_banded(n_lr: int, factor: int, delta: float,
                          mode: str = "nearest",
                          blur_taps: Optional[Tuple[float, ...]] = None,
                          dtype_name: str = "float32") -> HostBanded:
    """Banded back-projection operator along one axis:
    ``blur(shift(zero_stuff(err)))``: (n_lr*factor, n_lr)."""
    n_hr = n_lr * factor
    # shift operator on the HR grid (n_hr x n_hr), then keep only the
    # zero-stuffed source columns (every factor-th).  The prefilter is
    # always the float64-truncated FIR here.
    del dtype_name  # part of the cache key only
    b_shift = shift_op_banded(n_hr, delta, mode=mode, blur_taps=blur_taps,
                              blur_first=False, dtype_name="float64")
    return band_decimate_cols(b_shift, factor)


@functools.lru_cache(maxsize=None)
def zoom_op_banded(n_in: int, factor: float, mode: str = "mirror",
                   dtype_name: str = "float32") -> HostBanded:
    """Banded operator for SciPy ``ndimage.zoom(order=3)`` along one axis:
    cubic sampling on the endpoint-aligned grid composed with the spline
    prefilter."""
    from .resample import zoom_coords

    del dtype_name  # cache key only; build is float64
    _, coords = zoom_coords(n_in, factor)
    b_sample = _sampling_banded(n_in, coords, mode)
    h = bspline_prefilter_kernel("float64")
    hw = (len(h) - 1) // 2
    b_pref = band_from_kernel(n_in, n_in, h, -hw, mode)
    return band_compose(b_sample, b_pref)


def psf_separable_factors(psf: np.ndarray, rel_tol: float = 1e-6):
    """SVD factorization of a 2-D PSF into separable rank-1 terms:
    ``(rows[R, kh], cols[R, kw])`` with ``psf ~ sum_k outer(rows[k],
    cols[k])``, truncated below ``rel_tol`` of the leading singular value."""
    psf = np.asarray(psf, dtype=np.float64)
    u, sv, vt = np.linalg.svd(psf)
    keep = sv > sv[0] * rel_tol
    r = int(keep.sum())
    rows = (u[:, :r] * np.sqrt(sv[:r])).T
    cols = (vt[:r, :].T * np.sqrt(sv[:r])).T
    return rows, cols


def _col_operand(kind, v: torch.Tensor) -> torch.Tensor:
    """A column apply's operand (x or the bands) as the kind rounds it: for
    a kind of one pass, its rounding; split kinds and f64 keep float32."""
    spec = KINDS[kind]
    return spec.rounding(v) if spec.parts == 1 else v


class ColPack(NamedTuple):
    """Device form of a :class:`BandedOp` for column applies.

    ``idx[b]`` lists block ``b``'s window of input columns (clamped into
    range; the matching band entries are zero) and ``bands_t[b]`` its
    block transposed and zero-padded to ``BLOCK`` output columns.
    """

    idx: torch.Tensor      # int64 [n_blk, win]
    bands_t: torch.Tensor  # f32 [n_blk, win, BLOCK] (bf16-rounded for bf16)
    n_out: int


class BandedOp:
    """A banded 1-D operator as a static block decomposition.

    ``blocks[i]`` is the dense (rows_i, hi_i - lo_i) float32 sub-matrix of
    output rows ``[128 i, 128 i + rows_i)`` over input columns
    ``col_ranges[i] = (lo_i, hi_i)``.  The host form is plain numpy (it is
    what the disk cache pickles); :meth:`to` binds a copy to a device, and
    the device pack that :meth:`row_apply` or :meth:`col_apply` needs is
    built there on its first use (an op of a solve is only ever applied
    along one axis, so the other pack is never built).  ``band_dtype`` is
    the bands' kind on the device: float32, or after :meth:`astype_band`
    another key of ``ops.banded_rows.KINDS`` (bfloat16, a split, tf32, f16,
    f64 ...).
    """

    # the default also for ops pickled before the field existed: the host
    # disk cache holds float32 ops only
    band_dtype: torch.dtype = torch.float32

    def __init__(self, blocks, col_ranges, n_out: int, n_in: int,
                 band_dtype: torch.dtype = torch.float32):
        self.blocks = [np.asarray(b, dtype=np.float32) for b in blocks]
        self.col_ranges = tuple((int(lo), int(hi)) for lo, hi in col_ranges)
        self.n_out = int(n_out)
        self.n_in = int(n_in)
        self.band_dtype = band_dtype
        self.device: Optional[torch.device] = None
        self._row_pack: Optional[RowPack] = None
        self._col_pack: Optional[ColPack] = None

    @classmethod
    def from_banded(cls, hb: HostBanded) -> "BandedOp":
        """Block decomposition straight from a :class:`HostBanded`:
        per-block windows are trimmed to actually-nonzero columns of the
        float32-cast entries (the reference's ``from_banded``)."""
        n_out = hb.data.shape[0]
        cast = hb.data.astype(np.float32, copy=False)
        blocks, ranges = [], []
        for r0 in range(0, n_out, BLOCK):
            r1 = min(r0 + BLOCK, n_out)
            d = cast[r0:r1]
            s = hb.start[r0:r1]
            nzr, nzc = np.nonzero(d)
            if len(nzr):
                cols_abs = s[nzr] + nzc
                lo, hi = int(cols_abs.min()), int(cols_abs.max()) + 1
            else:
                lo, hi = 0, 1
                cols_abs = nzc
            sub = np.zeros((r1 - r0, hi - lo), dtype=np.float32)
            sub[nzr, cols_abs - lo] = d[nzr, nzc]
            blocks.append(sub)
            ranges.append((lo, hi))
        return cls(blocks, ranges, n_out, hb.n_in)

    @classmethod
    def tiled(cls, op: "BandedOp", r: int) -> "BandedOp":
        """Block-diagonal replication ``diag(op, ..., op)`` (r copies).

        Applying it to ``r`` images concatenated along the row axis equals
        applying ``op`` to each image: each copy keeps its own boundary
        entries.  A base op whose last block is short leaves short blocks
        inside the tiled op; the row pack records each block's first output
        row and row count, so they need no special case.
        """
        if r == 1:
            return op
        blocks = [b for _ in range(r) for b in op.blocks]
        ranges = [(lo + k * op.n_in, hi + k * op.n_in)
                  for k in range(r) for lo, hi in op.col_ranges]
        return cls(blocks, ranges, op.n_out * r, op.n_in * r, op.band_dtype)

    def astype_band(self, dtype) -> "BandedOp":
        """A copy whose bands are of kind ``dtype`` (a key of
        ``ops.banded_rows.KINDS``) on the device, unbound (the reference's
        ``astype_band``).  The cast happens where the copy's packs are
        built; torch rounds to nearest even, as ``ml_dtypes`` does, so the
        device bands equal the reference's bf16 blocks bit for bit."""
        if dtype not in KINDS:
            raise TypeError(f"band kind {dtype} is none of "
                            f"{', '.join(map(str, KINDS))}")
        return BandedOp(self.blocks, self.col_ranges, self.n_out, self.n_in,
                        dtype)

    def to(self, device) -> "BandedOp":
        """A copy of this op bound to ``device`` (no pack built yet)."""
        out = BandedOp(self.blocks, self.col_ranges, self.n_out, self.n_in,
                       self.band_dtype)
        out.device = torch.device(device)
        return out

    def _bound_device(self) -> torch.device:
        if self.device is None:
            raise RuntimeError("BandedOp is not bound to a device: call "
                               ".to(device)")
        return self.device

    @property
    def row_pack(self) -> RowPack:
        """The banded-row kernel's operands on this op's device."""
        if self._row_pack is None:
            self._row_pack = pack_banded(self.blocks, self.col_ranges,
                                         self.n_out, self.n_in,
                                         self._bound_device(),
                                         self.band_dtype)
        return self._row_pack

    @property
    def col_pack(self) -> ColPack:
        """The column apply's gather indices and transposed bands on this
        op's device, float32 (for a kind of one rounded pass -- bf16, tf32,
        f16 -- rounded so, so that the float32 matmul sums their exact
        products; split and f64 kinds keep the float32 bands)."""
        if self._col_pack is None:
            device = self._bound_device()
            n_blk = len(self.blocks)
            win = max(hi - lo for lo, hi in self.col_ranges)
            idx = np.zeros((n_blk, win), dtype=np.int64)
            bands_t = np.zeros((n_blk, win, BLOCK), dtype=np.float32)
            for i, (b, (lo, hi)) in enumerate(zip(self.blocks,
                                                  self.col_ranges)):
                idx[i] = np.minimum(lo + np.arange(win), self.n_in - 1)
                bands_t[i, : hi - lo, : b.shape[0]] = b.T
            bands_t = _col_operand(self.band_dtype,
                                   torch.as_tensor(bands_t, device=device))
            self._col_pack = ColPack(torch.as_tensor(idx, device=device),
                                     bands_t, self.n_out)
        return self._col_pack

    def row_apply(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``self @ x`` along x's row (-2) axis.

        Goes through the banded-row kernel (``ops.banded_rows``), whose
        wrapper launches the CUDA kernel for a CUDA tensor and runs the
        plain version for a CPU tensor.  ``plain=True`` runs the plain
        version on any device (the on-card parity check).
        """
        if plain:
            return banded_row_apply_reference(self.row_pack, x)
        return banded_row_apply(self.row_pack, x)

    def col_apply(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ self^T`` along x's column (-1) axis: gather every block's
        input-column window, one batched matmul over blocks, interleave.
        For a kind of one rounded pass x is rounded the same way first (the
        reference's bf16 einsum, and the tf32 and f16 presets); the products
        are exact and summed in float32, and the result is rounded as the
        kind's is (BF16_BF16_BF16, F16_F16_F16).  Split kinds take the
        float32 matmul, F64 a float64 one (see the module docstring).
        A ``col_apply`` span (``utils.trace.span``)."""
        with span("col_apply"):
            idx, bands_t, n_out = self.col_pack
            wide = KINDS[self.band_dtype].wide
            x = _col_operand(self.band_dtype, x)
            xg = x[..., idx].transpose(-3, -2)              # [..., nb, H, win]
            y = torch.matmul(xg.to(wide), bands_t.to(wide))  # [..., nb, H, B]
            y = y.transpose(-3, -2).reshape(*x.shape[:-1], -1)
            return round_result(self.band_dtype, y[..., :n_out].float())
