"""Banded row apply: ``out[rows of b] = bands[b] @ x[start_b : start_b + win]``.

Counterpart of ``enph459_super_resolution_tpu/ops/pallas_kernels.py``: the
TPU kernel ``_row_kernel`` (launched by ``_banded_row_pallas``) becomes the
hand-written CUDA kernel ``csrc/banded_rows.cu``.  This module holds

* :func:`pack_banded` -- the kernel's operand layout;
* :func:`banded_row_apply` -- the wrapper: it launches the kernel for a
  CUDA tensor, runs the plain version for a CPU tensor, and raises
  otherwise.  It counts the launches of each instantiation apart:
  ``banded_row_apply.launches`` (float32 bands),
  ``banded_row_apply.launches_bf16`` (bfloat16 bands) and
  ``banded_row_apply.launches_x3`` (split bands);
* :func:`banded_row_apply_reference` -- the plain PyTorch version, one
  ``bands[b] @ x[start_b : start_b + win]`` per block.

Bands are float32 (the strict band store), bfloat16 (the bf16 band store,
and float32 bands at ``mm_precision`` DEFAULT) or :data:`X3`: float32 bands
split into two bf16 halves, ``hi = bf16(b)`` and ``lo = bf16(b - hi)``, for
the 3-pass split of ``mm_precision`` HIGH / BF16_BF16_F32_X3.  With bf16
bands x is rounded to bf16 and the exact bf16 x bf16 products are summed in
float32, as the reference's bf16 einsum with
``preferred_element_type=float32`` does.  With split bands x is split the
same way and ``hi*hi + hi*lo + lo*hi`` is summed in float32 (the dropped
``lo*lo`` and x's bits past its two halves are ~2^-16 of ``|b|*|x|``).
The result is float32 every time.

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
from typing import NamedTuple, Optional

import numpy as np
import torch

# The band type of float32 bands split into bf16 hi and lo halves.
X3 = "x3"

# C signature of banded_rows_launch and banded_rows_bf16_launch in
# csrc/banded_rows.cu: six pointers (bands, starts, out_row0, rows, x, out),
# six ints (n_blk, win, n_in, n_out, W, batch) and the stream;
# banded_rows_x3_launch takes the lo bands after the hi ones.
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_X3 = [ctypes.c_void_p] + _ARGTYPES
_ENTRY = {torch.float32: ("banded_rows_launch", "launches"),
          torch.bfloat16: ("banded_rows_bf16_launch", "launches_bf16"),
          X3: ("banded_rows_x3_launch", "launches_x3")}

# Rows of one band block (the kernel's tile height) and the window padding
# unit (the kernel's K-chunk); both are compile-time constants of
# csrc/banded_rows.cu (BM and BK there).
ROWS = 128
K_CHUNK = 16


class RowPack(NamedTuple):
    """Operands of one banded row apply, on one device."""

    bands: torch.Tensor    # f32 or bf16 [n_blk, win, ROWS]: k-major, 0-padded
    meta: torch.Tensor     # i32 [3, n_blk]: window start, first out row, rows
    meta_host: np.ndarray  # the same on the host (the plain version's slices)
    n_out: int
    n_in: int
    bands_lo: Optional[torch.Tensor] = None  # X3: the lo halves, as bands

    @property
    def kind(self):
        """The band type: torch.float32, torch.bfloat16 or :data:`X3`."""
        return X3 if self.bands_lo is not None else self.bands.dtype


def pack_banded(blocks, col_ranges, n_out: int, n_in: int, device,
                dtype=torch.float32) -> RowPack:
    """Stack a block decomposition into the kernel's layout on ``device``,
    with the bands cast to ``dtype`` (float32 or bfloat16) there, or split
    there into bf16 hi and lo halves (``dtype=X3``).

    ``blocks[b]`` covers output rows ``sum(rows of blocks < b)`` onward and
    input columns ``col_ranges[b]``; the shared window is the widest block
    window rounded up to ``K_CHUNK``; each block is stored transposed,
    window row by window row.
    """
    if dtype not in _ENTRY:
        raise TypeError(f"band dtype {dtype} is none of float32, bfloat16 "
                        "and X3")
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
    bands = torch.as_tensor(bands, device=device)
    meta_dev = torch.as_tensor(meta, device=device)
    if dtype == X3:
        hi = bands.to(torch.bfloat16)
        return RowPack(hi, meta_dev, meta, int(n_out), int(n_in),
                       (bands - hi.float()).to(torch.bfloat16))
    return RowPack(bands.to(dtype), meta_dev, meta, int(n_out), int(n_in))


def _check(pack: RowPack, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"banded row apply takes float32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != pack.n_in:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match an "
                         f"operator with {pack.n_in} input rows")
    if x.device != pack.bands.device:
        raise ValueError(f"x on {x.device}, operator on {pack.bands.device}")


def split_bf16(v: torch.Tensor):
    """``(hi, lo)``: ``hi = bf16(v)`` and ``lo = bf16(v - hi)``, both
    rounded to nearest even (``v - hi`` is exact in float32)."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def banded_row_apply_reference(pack: RowPack, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per block, ``bands[b].T @ x[start_b : start_b +
    win]`` into the block's output rows (any device); with bf16 bands, x
    rounded to bf16 and the products summed in float32; with split bands,
    three float32 matmuls of the bf16 halves (exact products),
    ``hi*hi + hi*lo + lo*hi``."""
    _check(pack, x)
    if pack.kind == X3:
        x_hi, x_lo = split_bf16(x)
        terms = ((pack.bands, x_hi), (pack.bands, x_lo),
                 (pack.bands_lo, x_hi))
    elif pack.kind == torch.bfloat16:
        terms = ((pack.bands, x.to(torch.bfloat16)),)
    else:
        terms = ((pack.bands, x),)
    terms = [(bands.float(), xv.float()) for bands, xv in terms]
    win = pack.bands.shape[1]
    out = x.new_empty(x.shape[:-2] + (pack.n_out, x.shape[-1]))
    for b, (start, row0, nrow) in enumerate(pack.meta_host.T.tolist()):
        acc = None
        for bands, xv in terms:
            xs = xv[..., start:start + win, :]   # short at the bottom edge
            term = torch.matmul(bands[b, : xs.shape[-2], :nrow].T, xs)
            acc = term if acc is None else acc + term
        out[..., row0:row0 + nrow, :] = acc
    return out


def banded_row_apply(pack: RowPack, x: torch.Tensor) -> torch.Tensor:
    """``op @ x`` along x's row (-2) axis; x is ``[..., n_in, W]`` float32.

    A CUDA tensor goes through the CUDA kernel's instantiation for the
    pack's band type (:attr:`RowPack.kind`), always: there is no shape gate
    and no fallback.  A CPU tensor goes through the plain version.
    """
    if x.device.type == "cpu":
        return banded_row_apply_reference(pack, x)
    if x.device.type != "cuda":
        raise ValueError(f"banded row apply runs on cuda or cpu, not {x.device}")
    _check(pack, x)
    from .._build import load_function

    symbol, counter = _ENTRY[pack.kind]
    split = pack.kind == X3
    launch = load_function("banded_rows", symbol,
                           _ARGTYPES_X3 if split else _ARGTYPES)
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
    bands = ((pack.bands.data_ptr(), pack.bands_lo.data_ptr()) if split
             else (pack.bands.data_ptr(),))
    rc = launch(
        *bands, meta.data_ptr(), meta.data_ptr() + step,
        meta.data_ptr() + 2 * step, x.data_ptr(), out.data_ptr(),
        n_blk, win, pack.n_in, pack.n_out, width, batch,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded_rows kernel launch failed: CUDA error {rc}")
    setattr(banded_row_apply, counter, getattr(banded_row_apply, counter) + 1)
    return out


banded_row_apply.launches = 0
banded_row_apply.launches_bf16 = 0
banded_row_apply.launches_x3 = 0
