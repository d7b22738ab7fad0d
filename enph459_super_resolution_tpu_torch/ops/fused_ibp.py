"""Fused whole-iteration IBP: every frame's forward error in one launch (K2)
and the back-projection update of all frames in another (K3).

Counterpart of ``enph459_super_resolution_tpu/ops/pallas_fused_ibp.py``:
the TPU kernels ``_fwd_body`` and ``_bwd_body`` become the hand-written CUDA
kernels of ``csrc/fused_ibp.cu``.  This module holds

* :func:`_dedup` and the port's own packers (:func:`_pack_group`), which
  pack straight from the :class:`~.opmatrix.BandedOp` block decompositions
  (no dense frame matrices): uniform row blocks and column tiles of
  ``ROWS`` / ``COLS`` outputs, each with its own input window, trimmed to
  the nonzero columns and padded to ``WIN_ALIGN``; column windows start at
  multiples of ``WIN_ALIGN`` (16 bytes of bf16) wherever the input's width
  allows, so the kernels stage them with 16-byte copies;
* :class:`FusedIBP` (``build``, ``fwd_err``, ``bwd_update``,
  ``astype_bands``; ``strip_tiles`` and ``strip_union``, the column tiles
  one CUDA block of the f32 K3 walks over their union window;
  ``k2_f32_layout``, the threads, ring and sets of the f32 K2's launch)
  and :func:`fused_eligible`;
* the wrappers :func:`fused_fwd_err` / :func:`fused_bwd_update`, which
  launch the kernel for CUDA tensors (counting launches per band type in
  ``.launches`` and ``.launches_bf16``), run the plain version for CPU
  tensors and raise otherwise, and the plain PyTorch versions
  :func:`fused_fwd_err_reference` / :func:`fused_bwd_update_reference`,
  vectorised over every row block and column tile.

Semantics, as in the reference.  K2: ``err[f] = lr[f] - sum over f's terms
of (bandr[u] @ hr_window) @ bandc[c]``, stored in lr's dtype.  K3:
``clip(hr + scale * sum over all terms of (bandr[u] @ err_window[f]) @
bandc[c])``, float32.  With float32 bands everything is float32.  With
bfloat16 bands (the low pack of :meth:`FusedIBP.astype_bands`) lr and err are
bf16, the input window is rounded to bf16, each row product is rounded to
bf16 before its column product, and the exact bf16 x bf16 products are
summed in float32 -- the reference's ``_dot`` with a bf16 operand.  Other
mixes of band and lr types are refused.

The kernels take the TPU's pack too (``convert.fused_ibp_from_arrays``):
any row block and column tile that are multiples of 64, with any window
starts.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# Output rows and columns of one CUDA block (BM and TN in
# csrc/fused_ibp.cu): the port's pack uses them as its row block and column
# tile; any pack's blocks and tiles must be multiples of them.
ROWS = 64
COLS = 64
WIN_ALIGN = 8
MAX_FRAMES = 8  # frames of one K2 launch (MAX_OUT in csrc/fused_ibp.cu)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
# The f32 K3: adjacent 64-column tiles per CUDA block (a strip), row
# products formed at once, chunk width and deepest ring (K3_NT, K3_UNITS,
# KS and K3_MAX_STAGES in csrc/fused_ibp.cu); the f32 K2's deepest ring,
# over chunks of the same width (picked here only: its launch takes the
# layout of :func:`_k2_f32_layout`).
K3_STRIP_TILES = 4
K3_UNITS = 4
K3_CHUNK = 16
K3_MAX_STAGES = 4
K2_MAX_STAGES = 4

# C signatures in csrc/fused_ibp.cu (pointers and the stream as c_void_p).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PACK = [_I, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P]
_FWD_ARGTYPES = _PACK + [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                         ctypes.c_size_t, _P]
_BWD_ARGTYPES = _PACK + [_P, _I, _I, _I, _P, _P, _I, _I, _F, _F, _F, _I, _P]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _same_op(a, b) -> bool:
    return (a.n_out == b.n_out and a.n_in == b.n_in
            and a.col_ranges == b.col_ranges
            and all(np.array_equal(x, y) for x, y in zip(a.blocks, b.blocks)))


def _dedup(ops: Sequence) -> Tuple[List, List[int]]:
    """Unique operators by content; returns (uniques, index per input)
    (the reference's ``_dedup``, on block decompositions)."""
    uniq, idx = [], []
    for op in ops:
        for k, u in enumerate(uniq):
            if _same_op(u, op):
                idx.append(k)
                break
        else:
            idx.append(len(uniq))
            uniq.append(op)
    return uniq, idx


def _sub_blocks(op, size: int):
    """``op``'s output rows in blocks of ``size`` (the last one zero-padded
    where ``size`` does not divide them), each as (lo, hi, sub): the block's
    nonzero input columns [lo, hi) and its dense (size, hi - lo) rows, cut
    from or joined across ``op``'s own blocks."""
    ends = np.cumsum([b.shape[0] for b in op.blocks])
    out = []
    for r0 in range(0, op.n_out, size):
        r1 = r0 + size
        parts = []  # (first row in the block, lo, hi, rows) per op block
        for blk, (lo, _), end in zip(op.blocks, op.col_ranges, ends):
            start = end - blk.shape[0]
            if start >= r1 or end <= r0:
                continue
            rows = blk[max(r0, start) - start: min(r1, end) - start]
            cols = np.nonzero(rows.any(axis=0))[0]
            if len(cols):
                a, b = int(cols[0]), int(cols[-1]) + 1
                parts.append((max(r0, start) - r0, lo + a, lo + b,
                              rows[:, a:b]))
        if not parts:
            out.append((0, 1, np.zeros((size, 1), np.float32)))
            continue
        lo = min(p[1] for p in parts)
        hi = max(p[2] for p in parts)
        sub = np.zeros((size, hi - lo), np.float32)
        for r, a, b, rows in parts:
            sub[r: r + rows.shape[0], a - lo: b - lo] = rows
        out.append((lo, hi, sub))
    return out


def _pack_group(ops: Sequence, size: int,
                start_align: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pack same-shaped operators onto one window grid of ``size``-output
    blocks: ``(starts[n] int32, bands[n, n_ops, size, win] float32)`` with
    ``op_k @ x`` block ``i`` = ``bands[i, k] @ x[starts[i]:starts[i]+win]``.
    The window is the widest union of the ops' nonzero columns over the
    blocks, each union first moved back to a multiple of ``start_align``,
    padded to ``WIN_ALIGN``; a start is moved back where the window would
    run past the input."""
    subs = [_sub_blocks(op, size) for op in ops]
    n_in = ops[0].n_in
    n = len(subs[0])
    los = [min(s[i][0] for s in subs) // start_align * start_align
           for i in range(n)]
    his = [max(s[i][1] for s in subs) for i in range(n)]
    win = _round_up(max(h - lo for h, lo in zip(his, los)), WIN_ALIGN)
    starts = np.asarray([max(0, min(lo, n_in - win)) for lo in los],
                        np.int32)
    bands = np.zeros((n, len(ops), size, win), np.float32)
    for k, s in enumerate(subs):
        for i, (lo, hi, sub) in enumerate(s):
            bands[i, k, :, lo - starts[i]: hi - starts[i]] = sub
    return starts, bands


def fused_eligible(lr_shape, hr_shape, dtype_name: str = "float32") -> bool:
    """The reference's gate: float32 images whose LR and HR rows are
    multiples of 128 and columns multiples of 256 (every reference
    workload conforms)."""
    h, w = lr_shape
    hh, hw = hr_shape
    return (dtype_name == "float32" and h % 128 == 0 and hh % 128 == 0
            and w % 256 == 0 and hw % 256 == 0)


class FusedIBP:
    """Packed per-solve operators driving K2 and K3 on one device.

    ``f_*`` are the forward pack (row blocks over LR rows with windows of
    HR rows; column tiles over LR columns with windows of HR columns),
    ``b_*`` the back-projection pack (HR outputs, LR windows).  ``*_sr`` /
    ``*_sc`` are int32 window starts, ``*_bandr`` ``[nb, n_u, blk, win_r]``
    and ``*_bandc`` ``[nt, n_c, win_c, tile]`` (transposed) the bands,
    float32 or bfloat16.  ``f_entries`` / ``b_entries`` list each
    (frame, row op, column op) term, ``f_groups`` the row ops K2 applies.
    """

    ARRAY_FIELDS = ("f_sr", "f_sc", "f_bandr", "f_bandc",
                    "b_sr", "b_sc", "b_bandr", "b_bandc")

    def __init__(self, arrays: Dict[str, torch.Tensor], f_entries, f_groups,
                 b_entries, n_frames: int, lr_shape, hr_shape):
        for name in self.ARRAY_FIELDS:
            setattr(self, name, arrays[name])
        self.f_entries = tuple(tuple(int(v) for v in e) for e in f_entries)
        self.f_groups = tuple(int(u) for u in f_groups)
        self.b_entries = tuple(tuple(int(v) for v in e) for e in b_entries)
        self.n_frames = int(n_frames)
        self.lr_shape = tuple(int(v) for v in lr_shape)
        self.hr_shape = tuple(int(v) for v in hr_shape)
        self._plans: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._unions: Dict[int, int] = {}
        self._max_cons = max(sum(u == g for _, u, _ in self.f_entries)
                             for g in self.f_groups)
        self._k2 = None

    @classmethod
    def build(cls, frames, device, block: int = ROWS,
              tile: int = COLS) -> "FusedIBP":
        """The pack of a solve's per-frame operators on ``device``.

        ``frames[f] = (fwd_r, fwd_c, bwd_r, bwd_c)``: lists of host
        :class:`~.opmatrix.BandedOp` over the PSF's rank terms, the row
        operators already rep-tiled for a batched solve.  ``block`` and
        ``tile`` must be multiples of ``ROWS`` / ``COLS``; where ``block``
        divides one rep's rows, as at every shape that qualifies, no row
        block straddles a rep and its window stays narrow.  Operators equal
        by content are packed once.
        """
        fr, fc, br, bc, f_entries, b_entries = [], [], [], [], [], []
        for f, (frs, fcs, brs, bcs) in enumerate(frames):
            for t in range(len(frs)):
                f_entries.append((f, len(fr) + t, len(fc) + t))
                b_entries.append((f, len(br) + t, len(bc) + t))
            fr.extend(frs)
            fc.extend(fcs)
            br.extend(brs)
            bc.extend(bcs)
        fr_u, fr_i = _dedup(fr)
        fc_u, fc_i = _dedup(fc)
        br_u, br_i = _dedup(br)
        bc_u, bc_i = _dedup(bc)
        f_entries = [(f, fr_i[u], fc_i[c]) for f, u, c in f_entries]
        b_entries = [(f, br_i[u], bc_i[c]) for f, u, c in b_entries]
        f_groups = sorted({u for _, u, _ in f_entries})

        f_sr, f_bandr = _pack_group(fr_u, block)
        f_sc, f_bandc = _pack_group(fc_u, tile, WIN_ALIGN)
        b_sr, b_bandr = _pack_group(br_u, block)
        b_sc, b_bandc = _pack_group(bc_u, tile, WIN_ALIGN)
        host = {"f_sr": f_sr, "f_sc": f_sc, "f_bandr": f_bandr,
                "f_bandc": f_bandc.transpose(0, 1, 3, 2),
                "b_sr": b_sr, "b_sc": b_sc, "b_bandr": b_bandr,
                "b_bandc": b_bandc.transpose(0, 1, 3, 2)}
        arrays = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                  for k, v in host.items()}
        return cls(arrays, f_entries, f_groups, b_entries, len(frames),
                   (fr[0].n_out, fc[0].n_out), (fr[0].n_in, fc[0].n_in))

    def astype_bands(self, dtype: torch.dtype) -> "FusedIBP":
        """A copy with the four band arrays cast to ``dtype`` on their
        device (starts stay int32).  ``astype_bands(torch.bfloat16)`` is the
        low pack; it takes a bf16 lr stack and gives a bf16 err stack."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"band dtype {dtype} is neither float32 nor "
                            "bfloat16")
        arrays = {n: getattr(self, n).to(dtype) if "band" in n
                  else getattr(self, n) for n in self.ARRAY_FIELDS}
        return FusedIBP(arrays, self.f_entries, self.f_groups,
                        self.b_entries, self.n_frames, self.lr_shape,
                        self.hr_shape)

    @property
    def band_dtype(self) -> torch.dtype:
        return self.f_bandr.dtype

    @property
    def device(self) -> torch.device:
        return self.f_bandr.device

    def fwd_err(self, hr, lr_stack, plain: bool = False):
        """``err[f] = lr[f] - forward_model_f(hr)`` for all frames (K2);
        ``plain=True`` runs the plain version on any device."""
        fn = fused_fwd_err_reference if plain else fused_fwd_err
        return fn(self, hr, lr_stack)

    def bwd_update(self, hr, err_stack, scale: float,
                   clip: Tuple[float, float], plain: bool = False):
        """``clip(hr + scale * sum_f back_project_f(err[f]))`` (K3)."""
        fn = fused_bwd_update_reference if plain else fused_bwd_update
        return fn(self, hr, err_stack, scale, clip)

    def strip_union(self, strip_tiles: int) -> int:
        """The widest union window of the back-projection pack's column
        windows over strips of ``strip_tiles`` adjacent 64-column tiles (the
        f32 K3's CUDA blocks, the last of a row shorter): from the least
        window start of a strip's tiles to the greatest window end."""
        if strip_tiles not in self._unions:
            tile, win = self.b_bandc.shape[-1], self.b_bandc.shape[-2]
            starts = np.repeat(self.b_sc.cpu().numpy().astype(np.int64),
                               tile // COLS)
            self._unions[strip_tiles] = max(
                int(starts[i: i + strip_tiles].max()
                    - starts[i: i + strip_tiles].min()) + win
                for i in range(0, len(starts), strip_tiles))
        return self._unions[strip_tiles]

    def strip_tiles(self) -> int:
        """Tiles per strip the f32 K3's launch takes (the first of
        :func:`_k3_layout`): ``K3_STRIP_TILES`` where no such strip's union
        window is wider than that many tile windows and its layout fits,
        else 1 (the tile's own window), so no pack forms more of a row
        product than one window per tile."""
        return _k3_layout(self)[0]

    def max_consumers(self) -> int:
        """The most terms of K2's plan that share one row operator (the
        consumers of one plan group)."""
        return self._max_cons

    def k2_f32_layout(self) -> Dict[str, object]:
        """What the f32 K2's launch takes (:func:`_k2_layout`): its threads
        (two warps per frame), ring stages, whether the plan runs in one
        set or one group per set, and its shared memory in bytes."""
        whole, _, _, _, stages, total = _k2_layout(self)
        return {"threads": 64 * self.n_frames, "stages": stages,
                "sets": "one" if whole else "one group per set",
                "smem_bytes": total}

    def plan(self, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kernels' term lists on the pack's device: ``groups[g] =
        (input image, row op, first consumer, end)`` and ``cons[q] =
        (column op, output)``.  K2 forms each row product once per unique
        row op of hr; K3 once per term, on the term's frame."""
        if kind not in self._plans:
            if kind == "fwd":
                rows = [(0, u, [(c, f) for f, uu, c in self.f_entries
                                if uu == u]) for u in self.f_groups]
            else:
                rows = [(f, u, [(c, 0)]) for f, u, c in self.b_entries]
            groups, cons = [], []
            for src, u, consumers in rows:
                groups.append((src, u, len(cons), len(cons) + len(consumers)))
                cons.extend(consumers)
            self._plans[kind] = tuple(
                torch.as_tensor(np.asarray(a, np.int32), device=self.device)
                for a in (groups, cons))
        return self._plans[kind]


def _io_dtype(pack: FusedIBP) -> torch.dtype:
    return torch.bfloat16 if pack.band_dtype == torch.bfloat16 \
        else torch.float32


def _check(pack: FusedIBP, hr: torch.Tensor, stack: torch.Tensor,
           name: str) -> None:
    if hr.dtype != torch.float32 or tuple(hr.shape) != pack.hr_shape:
        raise ValueError(f"hr must be float32 {pack.hr_shape}, got "
                         f"{hr.dtype} {tuple(hr.shape)}")
    want = (pack.n_frames,) + pack.lr_shape
    if tuple(stack.shape) != want:
        raise ValueError(f"{name} must be {want}, got {tuple(stack.shape)}")
    if stack.dtype != _io_dtype(pack):
        raise TypeError(f"{name} must be {_io_dtype(pack)} for "
                        f"{pack.band_dtype} bands, got {stack.dtype}")
    for t in (hr, stack):
        if t.device != pack.device:
            raise ValueError(f"tensor on {t.device}, pack on {pack.device}")


def _windows(x: torch.Tensor, sr: torch.Tensor, win_r: int,
             sc: torch.Tensor, win_c: int) -> torch.Tensor:
    """``x[..., sr[i] + a, sc[j] + b]`` as ``[..., nb, nt, win_r, win_c]``;
    positions past the input read its last row or column (the band entries
    there are zero)."""
    n_rows, n_cols = x.shape[-2:]
    dev = x.device
    rows = (sr.long()[:, None] + torch.arange(win_r, device=dev)).clamp(
        max=n_rows - 1)
    cols = (sc.long()[:, None] + torch.arange(win_c, device=dev)).clamp(
        max=n_cols - 1)
    return x[..., rows[:, None, :, None], cols[None, :, None, :]]


def _operand(x: torch.Tensor, low: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if low else x.float()


def _untile(z: torch.Tensor, shape) -> torch.Tensor:
    """``[nb, nt, blk, tile]`` tiles as one ``shape`` image."""
    nb, nt, blk, tile = z.shape
    return z.permute(0, 2, 1, 3).reshape(nb * blk, nt * tile)[
        : shape[0], : shape[1]]


def fused_fwd_err_reference(pack: FusedIBP, hr: torch.Tensor,
                            lr_stack: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 on any device, all row blocks and
    column tiles at once."""
    _check(pack, hr, lr_stack, "lr_stack")
    low = pack.band_dtype == torch.bfloat16
    bandr, bandc = pack.f_bandr.float(), pack.f_bandc.float()
    win = _windows(_operand(hr, low), pack.f_sr, bandr.shape[-1],
                   pack.f_sc, bandc.shape[-2])          # [nb, nt, wr, wc]
    ys = {u: _operand(torch.matmul(bandr[:, None, u], win), low)
          for u in pack.f_groups}                       # [nb, nt, blk, wc]
    z = [None] * pack.n_frames
    for f, u, c in pack.f_entries:
        t = torch.matmul(ys[u], bandc[None, :, c])      # [nb, nt, blk, tile]
        z[f] = t if z[f] is None else z[f] + t
    sim = torch.stack([_untile(t, pack.lr_shape) for t in z])
    return (lr_stack.float() - sim).to(lr_stack.dtype)


def fused_bwd_update_reference(pack: FusedIBP, hr: torch.Tensor,
                               err_stack: torch.Tensor, scale: float,
                               clip: Tuple[float, float]) -> torch.Tensor:
    """Plain PyTorch version of K3 on any device, all row blocks and
    column tiles at once (one loop step per term)."""
    _check(pack, hr, err_stack, "err_stack")
    low = pack.band_dtype == torch.bfloat16
    bandr, bandc = pack.b_bandr.float(), pack.b_bandc.float()
    win = _windows(_operand(err_stack, low), pack.b_sr, bandr.shape[-1],
                   pack.b_sc, bandc.shape[-2])      # [N, nb, nt, wr, wc]
    z = None
    for f, u, c in pack.b_entries:
        y = _operand(torch.matmul(bandr[:, None, u], win[f]), low)
        t = torch.matmul(y, bandc[None, :, c])
        z = t if z is None else z + t
    out = hr + float(scale) * _untile(z, pack.hr_shape)
    return torch.clamp(out, float(clip[0]), float(clip[1]))


def _k3_f32_layout(n_u: int, n_frames: int, n_c: int, win_r: int,
                   win_c: int, union_w: int):
    """The shared-memory layout the f32 K3's launch takes (``k3_pick`` and
    ``k3_layout`` in csrc/fused_ibp.cu): ``(tiles per strip, resident row
    ops, frames, column ops, stages, bytes)``; where none fits
    ``SMEM_LIMIT``, the least of them (which the launch refuses).

    Tiles per strip: ``K3_STRIP_TILES`` where the widest such strip's
    union window ``union_w`` is at most that many column windows, else 1.
    Then, first
    with every row operator, frame and column operator of the plan in one
    set, else one plan group per set, at those tiles and then at 1, the
    deepest ring of ``K3_MAX_STAGES`` down to 2 that fits: the resident row
    operators and the row products of ``K3_UNITS`` groups (both k-major,
    the window padded to 4, rows padded by 4), each stage (128-byte
    aligned) every frame's err chunk and every column operator's chunk for
    the strip's tiles and its mbarrier, each resident row operator's
    nonzero k range for either half of its rows, and the set's tables."""
    kr = _round_up(win_r, 4)
    nt = K3_STRIP_TILES if union_w <= K3_STRIP_TILES * win_c else 1
    for res, frames, cops in ((n_u, n_frames, n_c), (1, 1, 1)):
        for t in dict.fromkeys((nt, 1)):
            for stages in range(K3_MAX_STAGES, 1, -1):
                ring = _round_up(4 * (res * kr + K3_UNITS * K3_CHUNK)
                                 * (ROWS + 4), 128)
                total = (ring + stages * (4 * (frames * kr * K3_CHUNK
                                               + cops * K3_CHUNK * t * COLS)
                                          + 8)
                         + 16 * res + 4 * (res + frames + cops))
                if total <= SMEM_LIMIT:
                    return t, res, frames, cops, stages, total
    return t, res, frames, cops, stages, total


def _k2_f32_layout(n_u: int, n_groups: int, n_c: int, max_cons: int,
                   win_r: int):
    """The shared-memory layout the f32 K2's launch takes: ``(whole,
    resident row ops, row-product slots, column-op slots, stages,
    bytes)``; where none fits ``SMEM_LIMIT``, the least of them (which
    the launch refuses).  The launch is given ``whole``, ``stages`` and
    the bytes, and refuses unless ``k2_layout`` in csrc/fused_ibp.cu
    carves the same bytes.

    First with every row operator, plan group and column operator in one
    set (``whole``), else one plan group per set (one row operator and
    row-product slot, ``max_cons`` column-op slots), the deepest ring of
    ``K2_MAX_STAGES`` down to 2 that fits: the resident row operators
    (k-major, the window padded to 4, rows padded by 4), two buffers of
    one chunk's row products, each stage (128-byte aligned) one hr chunk
    and one chunk of every column-op slot, and its mbarrier, each resident
    row operator's nonzero k range for either half of its rows, the set's
    terms, its row ops and each frame's first term."""
    kr = _round_up(win_r, 4)
    for whole in (True, False):
        res, ysn, cops = (n_u, n_groups, n_c) if whole else (1, 1, max_cons)
        terms = n_groups * max_cons if whole else max_cons
        for stages in range(K2_MAX_STAGES, 1, -1):
            ring = _round_up(4 * (res * kr + 2 * ysn * K3_CHUNK)
                             * (ROWS + 4), 128)
            total = (ring + stages * (4 * (kr + cops * COLS) * K3_CHUNK + 8)
                     + 8 * (2 * res + terms)
                     + 4 * (res + MAX_FRAMES + 1))
            if total <= SMEM_LIMIT:
                return whole, res, ysn, cops, stages, total
    return whole, res, ysn, cops, stages, total


def _k2_layout(pack: FusedIBP):
    """:func:`_k2_f32_layout` of the pack's forward operators and plan,
    worked out once per pack."""
    if pack._k2 is None:
        pack._k2 = _k2_f32_layout(pack.f_bandr.shape[1], len(pack.f_groups),
                                  pack.f_bandc.shape[1],
                                  pack.max_consumers(),
                                  pack.f_bandr.shape[-1])
    return pack._k2


def _smem_bytes(band_dtype: torch.dtype, win_r: int, n_c: int, n_src: int,
                f32_src: bool, n_u: int = 1, win_c: int = 0,
                union_w: int = 0, n_groups: int = 1,
                max_cons: int = 1) -> int:
    """The least dynamic shared memory one CUDA block needs (``layout``,
    ``k2_layout`` and ``k3_layout`` in csrc/fused_ibp.cu).  float32 bands,
    K2 (``f32_src``): the layout of :func:`_k2_f32_layout` for ``n_u`` row
    ops, ``n_groups`` plan groups of at most ``max_cons`` consumers and
    ``n_c`` column ops.  float32 bands, K3: the
    layout of :func:`_k3_f32_layout` for ``n_u`` row ops, ``n_src`` frames
    and ``n_c`` column ops, ``union_w`` the widest strip's union window.
    bfloat16
    bands: one row operator's block resident (the kernel keeps as many as
    fit and walks the window once per set), rows padded to 16 plus 8
    elements, and a ring of stages, each an input chunk and a
    column-operator chunk: K2 two stages, its f32 hr chunk rounded into one
    more bf16 buffer; K3 three, one bf16 chunk per frame, each stage at
    least the 16 KB through which its two warp sets add their sums."""
    if band_dtype == torch.float32 and f32_src:
        return _k2_f32_layout(n_u, n_groups, n_c, max_cons, win_r)[-1]
    if band_dtype == torch.float32:
        return _k3_f32_layout(n_u, n_src, n_c, win_r, win_c,
                              union_w or win_c)[-1]
    kr = _round_up(win_r, 16)
    bc = 2 * n_c * 16 * (COLS + 8)
    if f32_src:
        return 2 * ROWS * (kr + 8) + 2 * kr * 24 + 2 * (4 * kr * 16 + bc)
    return 2 * ROWS * (kr + 8) + 3 * max(2 * n_src * kr * 24 + bc, 16384)


def _k3_union(pack: FusedIBP) -> int:
    """The widest union window of the f32 K3's strips of
    ``K3_STRIP_TILES`` tiles, which its launch takes; 0 for bfloat16
    bands, whose K3 does not."""
    if pack.band_dtype != torch.float32:
        return 0
    return pack.strip_union(K3_STRIP_TILES)


def _k3_layout(pack: FusedIBP):
    """:func:`_k3_f32_layout` of the pack's back-projection operators."""
    n_u, win_r = pack.b_bandr.shape[1], pack.b_bandr.shape[-1]
    n_c, win_c = pack.b_bandc.shape[1], pack.b_bandc.shape[-2]
    return _k3_f32_layout(n_u, pack.n_frames, n_c, win_r, win_c,
                          pack.strip_union(K3_STRIP_TILES))


def _pack_args(pack: FusedIBP, prefix: str, kind: str) -> list:
    sr, sc = getattr(pack, prefix + "_sr"), getattr(pack, prefix + "_sc")
    bandr = getattr(pack, prefix + "_bandr")
    bandc = getattr(pack, prefix + "_bandc")
    nb, n_u, blk, win_r = bandr.shape
    nt, n_c, win_c, tile = bandc.shape
    if blk % ROWS or tile % COLS:
        raise ValueError(f"row block {blk} / column tile {tile} is no "
                         f"multiple of {ROWS} / {COLS}")
    if kind == "fwd":
        smem = _smem_bytes(bandr.dtype, win_r, n_c, 1, True, n_u=n_u,
                           n_groups=len(pack.f_groups),
                           max_cons=pack.max_consumers())
    else:
        smem = _smem_bytes(bandr.dtype, win_r, n_c, pack.n_frames, False,
                           n_u=n_u, win_c=win_c, union_w=_k3_union(pack))
    if smem > SMEM_LIMIT:
        raise ValueError(f"row window {win_r} needs {smem} B of shared "
                         f"memory, more than {SMEM_LIMIT}")
    groups, cons = pack.plan(kind)
    return [int(bandr.dtype == torch.bfloat16), bandr.data_ptr(),
            sr.data_ptr(), nb, n_u, blk, win_r, bandc.data_ptr(),
            sc.data_ptr(), nt, n_c, win_c, tile, groups.data_ptr(),
            groups.shape[0], cons.data_ptr()]


def _launch_target(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _count(fn, pack: FusedIBP) -> None:
    name = ("launches_bf16" if pack.band_dtype == torch.bfloat16
            else "launches")
    setattr(fn, name, getattr(fn, name) + 1)


def fused_fwd_err(pack: FusedIBP, hr: torch.Tensor,
                  lr_stack: torch.Tensor) -> torch.Tensor:
    """K2: ``err[f] = lr[f] - forward_model_f(hr)`` for every frame.

    CUDA tensors go through the kernel, always; CPU tensors through the
    plain version."""
    if not _launch_target(hr, "fused_fwd_err"):
        return fused_fwd_err_reference(pack, hr, lr_stack)
    _check(pack, hr, lr_stack, "lr_stack")
    if pack.n_frames > MAX_FRAMES:
        raise ValueError(f"K2 takes at most {MAX_FRAMES} frames, got "
                         f"{pack.n_frames}")
    from .._build import load_function

    launch = load_function("fused_ibp", "fused_fwd_launch", _FWD_ARGTYPES)
    hr, lr_stack = hr.contiguous(), lr_stack.contiguous()
    err = torch.empty_like(lr_stack)
    h, w = pack.lr_shape
    # the f32 kernel's layout, as picked here (the bf16 kernel ignores it)
    whole, _, _, _, stages, smem = _k2_layout(pack)
    rc = launch(*_pack_args(pack, "f", "fwd"), hr.data_ptr(),
                pack.hr_shape[0], pack.hr_shape[1], lr_stack.data_ptr(),
                err.data_ptr(), pack.n_frames, h, w, pack.max_consumers(),
                int(whole), stages, smem,
                torch.cuda.current_stream(hr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_fwd kernel launch failed: CUDA error {rc}")
    _count(fused_fwd_err, pack)
    return err


def fused_bwd_update(pack: FusedIBP, hr: torch.Tensor,
                     err_stack: torch.Tensor, scale: float,
                     clip: Tuple[float, float]) -> torch.Tensor:
    """K3: ``clip(hr + scale * sum_f back_project_f(err[f]))``.

    CUDA tensors go through the kernel, always; CPU tensors through the
    plain version."""
    if not _launch_target(hr, "fused_bwd_update"):
        return fused_bwd_update_reference(pack, hr, err_stack, scale, clip)
    _check(pack, hr, err_stack, "err_stack")
    from .._build import load_function

    launch = load_function("fused_ibp", "fused_bwd_launch", _BWD_ARGTYPES)
    hr, err_stack = hr.contiguous(), err_stack.contiguous()
    out = torch.empty_like(hr)
    h, w = pack.lr_shape
    rc = launch(*_pack_args(pack, "b", "bwd"), err_stack.data_ptr(),
                pack.n_frames, h, w,
                hr.data_ptr(), out.data_ptr(), pack.hr_shape[0],
                pack.hr_shape[1], float(scale), float(clip[0]),
                float(clip[1]), _k3_union(pack),
                torch.cuda.current_stream(hr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_bwd kernel launch failed: CUDA error {rc}")
    _count(fused_bwd_update, pack)
    return out


for _fn in (fused_fwd_err, fused_bwd_update):
    _fn.launches = 0
    _fn.launches_bf16 = 0
