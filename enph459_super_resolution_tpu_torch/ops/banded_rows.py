"""Banded row apply: ``out[rows of b] = bands[b] @ x[start_b : start_b + win]``.

Counterpart of ``enph459_super_resolution_tpu/ops/pallas_kernels.py``: the
TPU kernel ``_row_kernel`` (launched by ``_banded_row_pallas``) becomes the
hand-written CUDA kernel ``csrc/banded_rows.cu``.  This module holds

* :func:`pack_banded` -- the kernel's operand layout;
* :func:`banded_row_apply` -- the wrapper: it launches the kernel for a
  CUDA tensor, runs the plain version for a CPU tensor, and raises
  otherwise.  It counts the launches of each instantiation apart:
  ``banded_row_apply.launches`` (float32 bands) and
  ``banded_row_apply.launches_bf16`` (bfloat16 bands);
* :func:`banded_row_apply_reference` -- the plain PyTorch version, one
  ``bands[b] @ x[start_b : start_b + win]`` per block.

Bands are float32 (the strict band store) or bfloat16 (the bf16 band
store).  With bf16 bands x is rounded to bf16 and the exact bf16 x bf16
products are summed in float32, as the reference's bf16 einsum with
``preferred_element_type=float32`` does; the result is float32 either way.

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
from typing import NamedTuple

import numpy as np
import torch

# C signature of banded_rows_launch and banded_rows_bf16_launch in
# csrc/banded_rows.cu: six pointers (bands, starts, out_row0, rows, x, out),
# six ints (n_blk, win, n_in, n_out, W, batch) and the stream.
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ENTRY = {torch.float32: ("banded_rows_launch", "launches"),
          torch.bfloat16: ("banded_rows_bf16_launch", "launches_bf16")}

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


def pack_banded(blocks, col_ranges, n_out: int, n_in: int, device,
                dtype=torch.float32) -> RowPack:
    """Stack a block decomposition into the kernel's layout on ``device``,
    with the bands cast to ``dtype`` (float32 or bfloat16) there.

    ``blocks[b]`` covers output rows ``sum(rows of blocks < b)`` onward and
    input columns ``col_ranges[b]``; the shared window is the widest block
    window rounded up to ``K_CHUNK``; each block is stored transposed,
    window row by window row.
    """
    if dtype not in _ENTRY:
        raise TypeError(f"band dtype {dtype} is neither float32 nor bfloat16")
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
    return RowPack(torch.as_tensor(bands, device=device).to(dtype),
                   torch.as_tensor(meta, device=device), meta,
                   int(n_out), int(n_in))


def _check(pack: RowPack, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"banded row apply takes float32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != pack.n_in:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match an "
                         f"operator with {pack.n_in} input rows")
    if x.device != pack.bands.device:
        raise ValueError(f"x on {x.device}, operator on {pack.bands.device}")


def banded_row_apply_reference(pack: RowPack, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per block, ``bands[b].T @ x[start_b : start_b +
    win]`` into the block's output rows (any device); with bf16 bands, x
    rounded to bf16 and the products summed in float32."""
    _check(pack, x)
    bands = pack.bands.float()
    if pack.bands.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
    win = bands.shape[1]
    out = x.new_empty(x.shape[:-2] + (pack.n_out, x.shape[-1]))
    for b, (start, row0, nrow) in enumerate(pack.meta_host.T.tolist()):
        xs = x[..., start:start + win, :]   # short at the bottom edge
        out[..., row0:row0 + nrow, :] = torch.matmul(
            bands[b, : xs.shape[-2], :nrow].T, xs)
    return out


def banded_row_apply(pack: RowPack, x: torch.Tensor) -> torch.Tensor:
    """``op @ x`` along x's row (-2) axis; x is ``[..., n_in, W]`` float32.

    A CUDA tensor goes through the CUDA kernel's instantiation for the
    pack's band type, always: there is no shape gate and no fallback.  A
    CPU tensor goes through the plain version.
    """
    if x.device.type == "cpu":
        return banded_row_apply_reference(pack, x)
    if x.device.type != "cuda":
        raise ValueError(f"banded row apply runs on cuda or cpu, not {x.device}")
    _check(pack, x)
    from .._build import load_function

    symbol, counter = _ENTRY[pack.bands.dtype]
    launch = load_function("banded_rows", symbol, _ARGTYPES)
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
        pack.bands.data_ptr(), meta.data_ptr(), meta.data_ptr() + step,
        meta.data_ptr() + 2 * step, x.data_ptr(), out.data_ptr(),
        n_blk, win, pack.n_in, pack.n_out, width, batch,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded_rows kernel launch failed: CUDA error {rc}")
    setattr(banded_row_apply, counter, getattr(banded_row_apply, counter) + 1)
    return out


banded_row_apply.launches = 0
banded_row_apply.launches_bf16 = 0
