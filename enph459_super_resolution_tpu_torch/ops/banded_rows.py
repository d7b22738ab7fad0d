"""Banded row apply: ``out[rows of b] = bands[b] @ x[start_b : start_b + win]``.

Counterpart of ``enph459_super_resolution_tpu/ops/pallas_kernels.py``: the
TPU kernel ``_row_kernel`` (launched by ``_banded_row_pallas``) becomes the
hand-written CUDA kernel ``csrc/banded_rows.cu``.  This module holds

* :func:`pack_banded` -- the kernel's operand layout;
* :func:`banded_row_apply` -- the wrapper: it launches the kernel's
  instantiation for the pack's band kind for a CUDA tensor, runs the plain
  version for a CPU tensor, and raises otherwise.  It counts the launches
  of each instantiation apart, ``banded_row_apply.launches`` (float32
  bands) and ``banded_row_apply.launches_<kind>`` for the others
  (:data:`KINDS`);
* :func:`banded_row_apply_reference` -- the plain PyTorch version, one
  ``bands[b] @ x[start_b : start_b + win]`` per block and product.

The band kinds (the band type a band store or a matmul precision gives the
row applies; ``ops.opmatrix.MM_PRECISIONS`` names them):

* ``torch.float32`` -- strict float32 (the f32 band store, HIGHEST);
* ``torch.bfloat16`` -- the operand rounded to bf16 and the exact bf16 x
  bf16 products summed in float32, as the reference's bf16 einsum with
  ``preferred_element_type=float32`` does (the bf16 band store, DEFAULT);
  :data:`BF16OUT` the same with the result rounded to bf16
  (BF16_BF16_BF16);
* :data:`X3`, :data:`X6`, :data:`X9` -- float32 bands and x split into bf16
  parts, part 0 ``= bf16(v)`` and part p ``= bf16(v - parts before it)``:
  X3 two parts, ``hi*hi + hi*lo + lo*hi`` (HIGH, BF16_BF16_F32_X3; the
  dropped ``lo*lo`` and x's bits past two parts are ~2^-16 of
  ``|b|*|x|``); X6 three parts, the six products whose part indices sum to
  at most 2 (~2^-24); X9 all nine;
* :data:`TF32`, :data:`TF32X3` -- operands rounded to tf32 (nearest, ties
  away from zero, the rule of ``cvt.rna.tf32.f32``): one product, or the
  split ``hi*hi + hi*lo + lo*hi`` of two tf32 parts;
* :data:`F16`, :data:`F16OUT` -- operands rounded to float16, the products
  summed in float32; F16OUT rounds the result to float16 (F16_F16_F32,
  F16_F16_F16);
* :data:`F64` -- float32 bands and x widened to float64, the sum in
  float64, the result rounded to float32 (F64_F64_F64).

The kernels of F64 and the splits X3, X6, X9 and TF32X3 (the kinds whose
:attr:`Kind.span_k` is not 0) walk each block in row sub-tiles of
:data:`SUB_ROWS` rows, each over only the window rows that hold its nonzero
entries (:attr:`RowPack.spans`), rounded out to whole steps of ``span_k``
rows: k8 steps for F64 (DMMA) and TF32X3 (tf32 ``mma.sync`` m16n8k8), one
k16 ``mma.sync`` step a chunk for the bf16 splits.

Products of two bf16, f16 or tf32 values are exact in float32, so the plain
version (float32 matmuls of the rounded parts) and the kernel differ only
in the order of the sum.  The result is float32 every time (rounded to
bf16 or f16 values for BF16OUT and F16OUT).

The pack differs from the TPU one: each block is stored k-major,
``bands[b, k, r]`` (window row ``k``, output row ``r``), so the kernel's
window chunks are contiguous copies; windows are padded only to the kernel's
K-chunk (``K_CHUNK``), not to 128 lanes, and start at the block's first
nonzero column (no 8-row alignment).  Each block carries its own first
output row and row count, so rep-tiled operators whose base op has a short
last block pack like any other.  Window rows past ``n_in`` are masked by
the kernel and sliced off by the plain version; their band entries are 0.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

# The band kinds that are not a torch dtype (see the module docstring).
X3, X6, X9 = "x3", "x6", "x9"
TF32, TF32X3 = "tf32", "tf32x3"
F16, F16OUT, BF16OUT = "f16", "f16out", "bf16out"
F64 = "f64"


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to tf32 (10 stored significand bits): to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _via(dtype):
    def rnd(v: torch.Tensor) -> torch.Tensor:
        return v.to(dtype).float()
    return rnd


def _exact(v: torch.Tensor) -> torch.Tensor:
    return v


class Kind(NamedTuple):
    """How one band kind computes: its CUDA entry point and launch counter,
    the storage type and number of its band parts, the pairs of parts
    ``(p, q)`` with ``p + q <= reach`` it multiplies, the operand rounding,
    the result's rounding (or None), the type the sum is taken in, and the
    window rows of one step of its kernel's span walk (0: the kind takes
    no spans and its kernel walks the whole block window)."""

    symbol: str
    counter: str
    storage: torch.dtype
    parts: int
    reach: int
    rounding: Callable[[torch.Tensor], torch.Tensor]
    out: Optional[torch.dtype] = None
    wide: torch.dtype = torch.float32
    span_k: int = 0  # > 0: the entry point takes RowPack.spans


_BF16 = _via(torch.bfloat16)
_F16 = _via(torch.float16)
KINDS = {
    torch.float32: Kind("banded_rows_launch", "launches", torch.float32, 1,
                        0, _exact),
    torch.bfloat16: Kind("banded_rows_bf16_launch", "launches_bf16",
                         torch.bfloat16, 1, 0, _BF16),
    BF16OUT: Kind("banded_rows_bf16out_launch", "launches_bf16out",
                  torch.bfloat16, 1, 0, _BF16, torch.bfloat16),
    X3: Kind("banded_rows_x3_launch", "launches_x3", torch.bfloat16, 2, 1,
             _BF16, span_k=16),
    X6: Kind("banded_rows_x6_launch", "launches_x6", torch.bfloat16, 3, 2,
             _BF16, span_k=16),
    X9: Kind("banded_rows_x9_launch", "launches_x9", torch.bfloat16, 3, 4,
             _BF16, span_k=16),
    TF32: Kind("banded_rows_tf32_launch", "launches_tf32", torch.float32, 1,
               0, round_tf32),
    TF32X3: Kind("banded_rows_tf32x3_launch", "launches_tf32x3",
                 torch.float32, 2, 1, round_tf32, span_k=8),
    F16: Kind("banded_rows_f16_launch", "launches_f16", torch.float16, 1, 0,
              _F16),
    F16OUT: Kind("banded_rows_f16out_launch", "launches_f16out",
                 torch.float16, 1, 0, _F16, torch.float16),
    F64: Kind("banded_rows_f64_launch", "launches_f64", torch.float32, 1, 0,
              _exact, None, torch.float64, span_k=8),
}
# C signature of the entry points in csrc/banded_rows.cu: one pointer per
# band part (hi first), the spans where the kind takes them, five pointers
# (starts, out_row0, rows, x, out), six ints (n_blk, win, n_in, n_out, W,
# batch) and the stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# Rows of one band block (the kernel's tile height) and the window padding
# unit (the kernel's K-chunk); both are compile-time constants of
# csrc/banded_rows.cu (BM and BK there).
ROWS = 128
K_CHUNK = 16
# Rows of a row sub-tile of the span walk (SUB there; the window rows of
# one step are each kind's ``span_k``, its step body's KS).
SUB_ROWS = 16


def split(v: torch.Tensor, kind) -> Tuple[torch.Tensor, ...]:
    """``v`` (float32) as the parts the kind multiplies, each float32: part
    0 ``= round(v)``, part p ``= round(v - parts before it)`` (every
    difference is exact in float32)."""
    spec = KINDS[kind]
    parts, rest = [], v
    for p in range(spec.parts):
        part = spec.rounding(rest)
        parts.append(part)
        if p + 1 < spec.parts:
            rest = rest - part
    return tuple(parts)


def round_result(kind, y: torch.Tensor) -> torch.Tensor:
    """A float32 result rounded as the kind's result is (BF16OUT, F16OUT),
    else ``y``."""
    out = KINDS[kind].out
    return y if out is None else y.to(out).float()


class RowPack(NamedTuple):
    """Operands of one banded row apply, on one device."""

    bands: torch.Tensor    # [n_blk, win, ROWS]: k-major, 0-padded (part 0)
    meta: torch.Tensor     # i32 [3, n_blk]: window start, first out row, rows
    meta_host: np.ndarray  # the same on the host (the plain version's slices)
    n_out: int
    n_in: int
    kind: object = torch.float32       # the band kind (a key of KINDS)
    more: Tuple[torch.Tensor, ...] = ()  # split kinds: parts 1, 2, ...
    # the span kinds (F64, X3, X6, X9, TF32X3): i32 [n_blk, ROWS // SUB_ROWS,
    # 2], per block and sub-tile the window rows lo <= k < hi holding every
    # nonzero of its rows, (0, 0) if none (:func:`sub_tile_spans` of the
    # float32 bands, so of every split part; the kernel's loop bounds);
    # else None
    spans: Optional[torch.Tensor] = None

    @property
    def parts(self) -> Tuple[torch.Tensor, ...]:
        """Every band part, hi first."""
        return (self.bands,) + self.more


def pack_banded(blocks, col_ranges, n_out: int, n_in: int, device,
                dtype=torch.float32) -> RowPack:
    """Stack a block decomposition into the kernel's layout on ``device``,
    with the bands rounded or split there as the band kind ``dtype`` (a key
    of :data:`KINDS`) takes them, each part in its storage type.

    ``blocks[b]`` covers output rows ``sum(rows of blocks < b)`` onward and
    input columns ``col_ranges[b]``; the shared window is the widest block
    window rounded up to ``K_CHUNK``; each block is stored transposed,
    window row by window row.
    """
    if dtype not in KINDS:
        raise TypeError(f"band kind {dtype} is none of "
                        f"{', '.join(map(str, KINDS))}")
    n_blk = len(blocks)
    rows = np.asarray([b.shape[0] for b in blocks], dtype=np.int32)
    if rows.max() > ROWS:
        raise ValueError(f"block of {rows.max()} rows exceeds {ROWS}")
    if int(rows.sum()) != n_out:
        raise ValueError(f"blocks cover {rows.sum()} rows, op has {n_out}")
    win = max(hi - lo for lo, hi in col_ranges)
    win = -(-win // K_CHUNK) * K_CHUNK
    bands = np.zeros((n_blk, win, ROWS), dtype=np.float32)
    meta = np.zeros((3, n_blk), dtype=np.int32)
    meta[0] = [lo for lo, _ in col_ranges]
    meta[1] = np.concatenate([[0], np.cumsum(rows)[:-1]])
    meta[2] = rows
    for i, (b, (lo, hi)) in enumerate(zip(blocks, col_ranges)):
        bands[i, : hi - lo, : b.shape[0]] = b.T
    storage = KINDS[dtype].storage
    parts = [p.to(storage)
             for p in split(torch.as_tensor(bands, device=device), dtype)]
    spans = (torch.as_tensor(sub_tile_spans(bands), device=device)
             if KINDS[dtype].span_k else None)
    return RowPack(parts[0], torch.as_tensor(meta, device=device), meta,
                   int(n_out), int(n_in), dtype, tuple(parts[1:]), spans)


def sub_tile_spans(bands: np.ndarray) -> np.ndarray:
    """For k-major float32 bands ``[n_blk, win, ROWS]``, per block and run
    of :data:`SUB_ROWS` output rows, the window rows ``lo <= k < hi`` that
    hold all of its nonzero entries, ``(0, 0)`` where it has none: i32
    ``[n_blk, ROWS // SUB_ROWS, 2]``."""
    n_blk, win, _ = bands.shape
    live = (bands != 0).reshape(n_blk, win, ROWS // SUB_ROWS,
                                SUB_ROWS).any(axis=3)
    some = live.any(axis=1)
    lo = live.argmax(axis=1)
    hi = win - live[:, ::-1].argmax(axis=1)
    return np.stack([np.where(some, lo, 0), np.where(some, hi, 0)],
                    axis=-1).astype(np.int32)


def _check(pack: RowPack, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"banded row apply takes float32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != pack.n_in:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match an "
                         f"operator with {pack.n_in} input rows")
    if x.device != pack.bands.device:
        raise ValueError(f"x on {x.device}, operator on {pack.bands.device}")


def banded_row_apply_reference(pack: RowPack, x: torch.Tensor,
                               rounded: bool = True) -> torch.Tensor:
    """Plain PyTorch version: per block and product of a band part with an
    x part (:func:`split`), ``part[b].T @ x_part[start_b : start_b + win]``
    into the block's output rows, summed in float32 (float64 for F64), then
    rounded as the kind's result is (any device).  Products of the rounded
    parts are exact in float32.  ``rounded=False`` leaves out the result's
    rounding (BF16OUT, F16OUT): the float32 sum it rounds."""
    _check(pack, x)
    spec = KINDS[pack.kind]
    bands = [band.to(spec.wide) for band in pack.parts]
    x_parts = [xp.to(spec.wide) for xp in split(x, pack.kind)]
    terms = [(bands[p], x_parts[q]) for p in range(spec.parts)
             for q in range(spec.parts) if p + q <= spec.reach]
    win = pack.bands.shape[1]
    out = x.new_empty(x.shape[:-2] + (pack.n_out, x.shape[-1]))
    for b, (start, row0, nrow) in enumerate(pack.meta_host.T.tolist()):
        acc = None
        for band, xv in terms:
            xs = xv[..., start:start + win, :]   # short at the bottom edge
            term = torch.matmul(band[b, : xs.shape[-2], :nrow].T, xs)
            acc = term if acc is None else acc + term
        out[..., row0:row0 + nrow, :] = acc
    return round_result(pack.kind, out) if rounded else out


def banded_row_apply(pack: RowPack, x: torch.Tensor) -> torch.Tensor:
    """``op @ x`` along x's row (-2) axis; x is ``[..., n_in, W]`` float32.

    A CUDA tensor goes through the CUDA kernel's instantiation for the
    pack's band kind (:attr:`RowPack.kind`), always: there is no shape gate
    and no fallback; a span kind's pack without spans raises.  A CPU tensor
    goes through the plain version.
    """
    if x.device.type == "cpu":
        return banded_row_apply_reference(pack, x)
    if x.device.type != "cuda":
        raise ValueError(f"banded row apply runs on cuda or cpu, not {x.device}")
    _check(pack, x)
    from .._build import load_function

    spec = KINDS[pack.kind]
    if spec.span_k and pack.spans is None:
        raise ValueError(f"a {pack.kind} pack needs its sub-tile spans "
                         "(RowPack.spans, from pack_banded)")
    spans = (pack.spans,) if spec.span_k else ()
    launch = load_function("banded_rows", spec.symbol,
                           [ctypes.c_void_p] * (len(pack.parts) + len(spans))
                           + _ARGTYPES)
    x = x.contiguous()
    lead = x.shape[:-2]
    width = x.shape[-1]
    batch = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = torch.empty(lead + (pack.n_out, width), device=x.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    n_blk, win, _ = pack.bands.shape
    meta = pack.meta
    step = meta.stride(0) * meta.element_size()
    rc = launch(
        *(t.data_ptr() for t in pack.parts + spans), meta.data_ptr(),
        meta.data_ptr() + step, meta.data_ptr() + 2 * step, x.data_ptr(),
        out.data_ptr(), n_blk, win, pack.n_in, pack.n_out, width, batch,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded_rows kernel launch failed: CUDA error {rc}")
    setattr(banded_row_apply, spec.counter,
            getattr(banded_row_apply, spec.counter) + 1)
    return out


for _spec in KINDS.values():
    setattr(banded_row_apply, _spec.counter, 0)
del _spec
