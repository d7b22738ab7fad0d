"""Classical multi-frame super-resolution: Shift-and-Add + Iterative
Back-Projection on the banded-matmul engine.

Counterpart of ``enph459_super_resolution_tpu/sr/classical.py``: its
banded ``mm`` engine (the ``f32``, ``bf16`` and ``hybrid[:tail]`` band
stores, the fused-iteration engine and the matmul precisions), its ``conv``
engine, the ``ibp`` and ``adjoint`` solvers and ``landweber_refine``.
Reference behavior: ``mono_barcodes/run_sr.py:188-240``:

  * forward model   = PSF blur -> sub-pixel shift -> decimate
  * back-projection = zero-stuff LR error -> inverse shift -> correlate PSF
  * Shift-and-Add   = per-frame cubic zoom + shift, averaged
  * IBP             = n_iter updates ``hr += step * mean_f(bp_f(lr_f -
    fwd_f(hr)))``, clipped to [0, clip_max], with a per-iteration MSE log

Every 1-D stage is a banded matrix built on the host (``ops.opmatrix``);
each row apply runs the banded-row CUDA kernel on the card
(``csrc/banded_rows.cu``), each column apply one batched ``torch.matmul``.
The fused engine (``ops.fused_ibp``, ``csrc/fused_ibp.cu``) runs a whole
IBP iteration as two kernels instead.  There is no ``jit`` here: the IBP
loop is a Python loop whose MSE history stays on the device, and a solve
ends in one device-to-host copy.

A solve marks its phases as spans (``utils.trace.span``; recorded only
while spans are on): ``solve`` around the call (``solve_batch`` too), and
inside it ``solve.prepare`` (the checks and the frames' upload),
``solve.operators`` (the operator tree; on a miss of its in-process cache
``operators.host``, the disk cache or the host build, and
``operators.device``, the upload, packs and fused pack), ``solve.prologue``
(LR mean, zoom, Shift-and-Add), ``solve.ibp`` (the iteration loop) and
``solve.to_host`` (the copy back); each column apply is a ``col_apply``
span.  Three counters are always on: ``_prepare.h2d_bytes``, the bytes the
frames' upload copies to the device (none when they are there already),
with ``_prepare.calls``; ``_to_host.d2h_bytes``, the bytes copied back to
the host; and ``_to_host.pinned_calls``, the calls whose copy back landed
in page-locked host memory (one a call on the card, none on the CPU).

Band stores (``band_store``; the reference's ``SRTPU_BAND_STORE``):

* ``"f32"`` -- strict float32, the contract default (+-1 uint8 of the
  reference).
* ``"bf16"`` -- every operator (zoom and Shift-and-Add too) with bf16
  bands: operands rounded to bf16, exact products summed in float32.
  Parity loosens to +-2.
* ``"hybrid[:tail]"`` -- the first ``n_iter - tail`` IBP iterations on
  bf16 copies of the frame operators, the last ``tail`` (default 16) on
  the float32 ones: the fixed-point iteration contracts the bf16 deviation
  back onto the f32 trajectory (+-1 of f32).  Zoom and Shift-and-Add stay
  float32.

Engine (``fused``; the reference's ``SRTPU_FUSED_IBP``): ``"auto"`` routes
as the reference does on its chip -- the fused kernels for ``bf16`` at
shapes that qualify (:func:`~..ops.fused_ibp.fused_eligible`), the banded
engine for ``f32`` and ``hybrid``.  ``"on"`` takes the fused kernels for
every store (``hybrid``'s f32 tail stays banded, as in the reference) and
raises for a shape they cannot take; ``"off"`` never takes them.

Matmul precision (``mm_precision``; the reference's ``SRTPU_MM_PRECISION``,
names in :data:`~..ops.opmatrix.MM_PRECISIONS`: every name of JAX's
``Precision`` and ``DotAlgorithmPreset`` but the four float8 presets)
applies to the float32-band applies only: ``HIGHEST`` (default) strict,
``HIGH`` / ``BF16_BF16_F32_X3`` the 3-pass bf16 split on the row applies
(K1's split instantiation; the column applies stay float32), ``DEFAULT`` /
``BF16_BF16_F32`` one bf16 pass, and the other presets each on its own K1
instantiation (:mod:`~..ops.opmatrix` lists their arithmetic).  bf16 bands
and the fused kernels ignore it, as in the reference.  The device operator
tree is kept per precision.

Solver (``solver``; the reference's ``SRTPU_SOLVER``): ``"ibp"`` (default,
the reference's heuristic back-projection, step 0.5) or ``"adjoint"``
(true-adjoint Landweber: the back-projection operators are the transposed
forward operators, stable at step 2.0).  The adjoint runs on the banded
engine only: ``fused="auto"`` takes it, ``fused="on"`` raises (the fused
pack bakes the heuristic back-projection), and so does ``engine="conv"``.

Engine (``engine``): ``"mm"`` (default, the banded operators above) or
``"conv"``, the reference's cross-check engine: the same algorithm as
separable correlations and dense sampling matmuls
(:mod:`~..ops.conv`, :mod:`~..ops.resample`), strict f32, one unit at a
time; it runs no hand-written kernel and ignores ``band_store``, ``fused``
and ``mm_precision``, as the reference does.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.conv import conv2d_same, correlate2d_same
from ..ops.fused_ibp import FusedIBP, fused_eligible
from ..ops.opmatrix import (
    BLOCK,
    BandedOp,
    band_transpose,
    psf_separable_factors,
    resolve_mm_precision,
    shift_op_banded,
    stuff_shift_op_banded,
    zoom_op_banded,
)
from ..ops.resample import spline_shift, spline_zoom
from ..utils.trace import span

# Constants shared by all four reference workloads
# (``mono_barcodes/run_sr.py:60-67``).
UPSAMPLE_FACTOR = 2
PSF_SIZE = 7
PSF_SIGMA = 1.0
PSF_HALFWIDTH = 3
IBP_STEP_SIZE = 0.5

# Strict f32 is the contract: operators are cast to float32 and the spline
# prefilter is truncated at float32 epsilon.  The bf16 band stores cast
# these float32 bands on the device.
_DTYPE_NAME = "float32"
FUSED_MODES = ("auto", "on", "off")
SOLVERS = ("ibp", "adjoint")
ENGINES = ("mm", "conv")
_DEFAULT_TAIL = 16


def parse_band_store(band_store: str) -> Tuple[str, int]:
    """``"f32"``, ``"bf16"`` or ``"hybrid[:tail]"`` as (kind, f32 tail
    length); the tail defaults to 16 (the reference's strict setting)."""
    if band_store in ("f32", "bf16"):
        return band_store, 0
    if band_store == "hybrid":
        return "hybrid", _DEFAULT_TAIL
    if band_store.startswith("hybrid:"):
        try:
            return "hybrid", max(0, int(band_store.split(":", 1)[1]))
        except ValueError:
            pass
    raise ValueError(f"band_store {band_store!r}: use 'f32', 'bf16' or "
                     "'hybrid[:tail]'")


def check_config(engine: str = "mm", solver: str = "ibp",
                 band_store: str = "f32", fused: str = "auto",
                 mm_precision: str = "HIGHEST") -> None:
    """Raise ``ValueError`` for an unknown knob value or a combination the
    solve refuses: the adjoint solver on the conv engine or with
    ``fused="on"``.  The conv engine runs strict float32 and ignores the
    banded engine's knobs (band store, fused kernels, matmul precision), as
    the reference does."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: use one of {ENGINES}")
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r}: use one of {SOLVERS}")
    if fused not in FUSED_MODES:
        raise ValueError(f"fused {fused!r}: use one of {FUSED_MODES}")
    parse_band_store(band_store)
    resolve_mm_precision(mm_precision)
    if solver == "adjoint" and engine != "mm":
        raise ValueError("solver 'adjoint' runs on the banded 'mm' engine "
                         f"only (got engine={engine!r})")
    if solver == "adjoint" and fused == "on":
        raise ValueError("solver 'adjoint' runs on the banded engine: the "
                         "fused kernels bake the heuristic back-projection "
                         "(got fused='on')")


def fused_engine_on(fused: str, band_store: str, lr_shape,
                    hr_shape, solver: str = "ibp") -> bool:
    """Whether a solve runs the fused kernels (see the module docstring):
    the reference's ``_fused_engine_on`` as it routes on its chip, except
    that ``fused="on"`` raises for a shape the kernels cannot take or with
    the adjoint solver."""
    check_config(solver=solver, band_store=band_store, fused=fused)
    if solver == "adjoint":
        return False
    kind, _ = parse_band_store(band_store)
    eligible = fused_eligible(lr_shape, hr_shape)
    if fused == "on" and not eligible:
        raise ValueError(f"fused='on': LR {tuple(lr_shape)} -> HR "
                         f"{tuple(hr_shape)} does not qualify for the fused "
                         "kernels (rows a multiple of 128, columns of 256)")
    if fused == "auto":
        return kind == "bf16" and eligible
    return fused == "on"


def make_gaussian_psf(size: int = PSF_SIZE, sigma: float = PSF_SIGMA) -> np.ndarray:
    """Normalized 2-D Gaussian PSF (``mono_barcodes/run_sr.py:135-142``)."""
    hw = size // 2
    y, x = np.mgrid[-hw:hw + 1, -hw:hw + 1].astype(np.float64)
    k = np.exp(-(x * x + y * y) / (2.0 * float(sigma) ** 2))
    return k / k.sum()


def _frame_operator_banded(psf, shift_yx, factor: int, lr_shape,
                           dtype_name: str = _DTYPE_NAME,
                           solver: str = "ibp"):
    """(fwd_row, fwd_col, bwd_row, bwd_col) :class:`HostBanded` lists over
    the PSF's separable rank terms.

    Forward:  sim  = sum_k R_k @ HR @ C_k^T   ==  decimate(shift(conv2d(HR)))
    Backward (solver 'ibp', the reference's heuristic back-projection):
              corr = sum_k Br_k @ ERR @ Bc_k^T
                   ==  correlate2d(shift^{-1}(zero_stuff(ERR)), psf)
    Backward (solver 'adjoint'): Br_k = R_k^T, Bc_k = C_k^T, the true
    adjoint of the forward operator (banded too, at the same cost).
    """
    h_lr, w_lr = lr_shape
    dy, dx = float(shift_yx[0]), float(shift_yx[1])
    rows_u, cols_v = psf_separable_factors(psf)
    fwd_r, fwd_c, bwd_r, bwd_c = [], [], [], []
    for u, v in zip(rows_u, cols_v):
        # forward blur is a true convolution -> correlation taps = flipped
        fwd_r.append(shift_op_banded(
            h_lr * factor, dy * factor, stride=factor, n_out=h_lr,
            blur_taps=tuple(u[::-1]), blur_first=True, dtype_name=dtype_name))
        fwd_c.append(shift_op_banded(
            w_lr * factor, dx * factor, stride=factor, n_out=w_lr,
            blur_taps=tuple(v[::-1]), blur_first=True, dtype_name=dtype_name))
        if solver == "adjoint":
            bwd_r.append(band_transpose(fwd_r[-1]))
            bwd_c.append(band_transpose(fwd_c[-1]))
            continue
        # back-projection correlates with the PSF -> taps unflipped
        bwd_r.append(stuff_shift_op_banded(
            h_lr, factor, -dy * factor, blur_taps=tuple(u),
            dtype_name=dtype_name))
        bwd_c.append(stuff_shift_op_banded(
            w_lr, factor, -dx * factor, blur_taps=tuple(v),
            dtype_name=dtype_name))
    return fwd_r, fwd_c, bwd_r, bwd_c


def forward_model(hr: torch.Tensor, psf, shift_yx, factor: int):
    """HR image -> simulated LR frame on the conv engine: blur, shift by
    ``shift * factor``, decimate (``mono_barcodes/run_sr.py:192-196``); the
    decimation is the shift's output stride."""
    return spline_shift(conv2d_same(hr, psf),
                        (shift_yx[0] * factor, shift_yx[1] * factor),
                        strides=(factor, factor))


def back_project(error_lr: torch.Tensor, psf, shift_yx, factor: int,
                 hr_shape):
    """LR residual -> HR-grid correction on the conv engine
    (``mono_barcodes/run_sr.py:199-209``): zero-stuff onto the HR grid,
    shift by ``-shift * factor``, correlate with the PSF."""
    h, w = error_lr.shape[-2:]
    up = error_lr.new_zeros(error_lr.shape[:-2] + tuple(hr_shape))
    up[..., : h * factor: factor, : w * factor: factor] = error_lr
    shifted = spline_shift(up, (-shift_yx[0] * factor,
                                -shift_yx[1] * factor))
    return correlate2d_same(shifted, psf)


def shift_and_add(lr_stack: torch.Tensor, shifts_yx,
                  factor: int = UPSAMPLE_FACTOR):
    """Cubic zoom of each frame, shifted into registration and averaged
    (``mono_barcodes/run_sr.py:212-218``), on the conv engine."""
    up = spline_zoom(lr_stack, factor)
    acc = None
    for i, (dy, dx) in enumerate(shifts_yx):
        term = spline_shift(up[i], (dy * factor, dx * factor))
        acc = term if acc is None else acc + term
    return acc / lr_stack.shape[0]


def native_upsample(lr_mean: torch.Tensor, factor: int = UPSAMPLE_FACTOR):
    """Cubic-spline zoom of the LR mean (``mono_barcodes/run_sr.py:315``)."""
    return spline_zoom(lr_mean, factor)


def ibp_step(hr, lr_stack, shifts_yx, psf, factor: int, step: float,
             clip=(0.0, 255.0)):
    """One IBP update over all frames on the conv engine; returns (new hr,
    mean MSE)."""
    n = lr_stack.shape[0]
    correction = torch.zeros_like(hr)
    total = hr.new_zeros(())
    for i in range(n):
        err = lr_stack[i] - forward_model(hr, psf, shifts_yx[i], factor)
        total = total + torch.mean(err * err)
        correction += back_project(err, psf, shifts_yx[i], factor,
                                   hr.shape[-2:])
    return torch.clamp(hr + step * correction / n, *clip), total / n


def ibp(lr_stack, shifts_yx, psf, hr_init, factor: int = UPSAMPLE_FACTOR,
        n_iter: int = 80, step: float = IBP_STEP_SIZE, clip=(0.0, 255.0)):
    """Iterative back-projection on the conv engine
    (``mono_barcodes/run_sr.py:221-240``); returns ``(hr, f32[n_iter]
    per-iteration mean MSE)``."""
    errs = hr_init.new_zeros((n_iter,))
    hr = hr_init
    for it in range(n_iter):
        hr, errs[it] = ibp_step(hr, lr_stack, shifts_yx, psf, factor, step,
                                clip)
    return hr, errs


def forward_model_mm(hr: torch.Tensor, mats, plain: bool = False):
    """Simulated LR frame ``sum_k C_k(R_k hr)`` for one frame's operators."""
    fwd_r, fwd_c, _, _ = mats
    sim = None
    for r, c in zip(fwd_r, fwd_c):
        term = c.col_apply(r.row_apply(hr, plain=plain))
        sim = term if sim is None else sim + term
    return sim


def back_project_mm(err: torch.Tensor, mats, plain: bool = False):
    """HR-grid correction ``sum_k Bc_k(Br_k err)`` for one frame's
    operators."""
    _, _, bwd_r, bwd_c = mats
    out = None
    for r, c in zip(bwd_r, bwd_c):
        term = c.col_apply(r.row_apply(err, plain=plain))
        out = term if out is None else out + term
    return out


def _host_solve_matrices(psf, shifts_yx, factor, lr_shape, reps=1,
                         solver="ibp"):
    """Host (numpy) build of one solve config's operators, as
    :class:`BandedOp` block decompositions; ``solver`` picks the frames'
    back-projection operators (:func:`_frame_operator_banded`).

    ``reps > 1`` builds the batched-solve operators: every ROW operator is
    block-diagonally tiled ``reps`` times (:meth:`BandedOp.tiled`) so that
    ``reps`` images concatenated along H solve together with per-rep-exact
    boundaries; column operators are shared unchanged.
    """
    def bc(hb):
        return BandedOp.from_banded(hb)

    def br(hb):
        return BandedOp.tiled(BandedOp.from_banded(hb), reps)

    h_lr, w_lr = lr_shape
    frame_bands = [_frame_operator_banded(psf, s, factor, lr_shape,
                                          solver=solver)
                   for s in shifts_yx]
    return {
        "zoom_r": br(zoom_op_banded(h_lr, factor, dtype_name=_DTYPE_NAME)),
        "zoom_c": bc(zoom_op_banded(w_lr, factor, dtype_name=_DTYPE_NAME)),
        "saa": [(br(shift_op_banded(h_lr * factor, dy * factor,
                                    dtype_name=_DTYPE_NAME)),
                 bc(shift_op_banded(w_lr * factor, dx * factor,
                                    dtype_name=_DTYPE_NAME)))
                for dy, dx in shifts_yx],
        "frames": [tuple([(br if axis % 2 == 0 else bc)(hb) for hb in ops]
                         for axis, ops in enumerate(fr))
                   for fr in frame_bands],
    }


_OP_CACHE_VERSION = 2  # v2: the solver joins the key


def op_cache_dir() -> str:
    """The host operator disk cache: ``$SRTPU_OP_CACHE_DIR``, else
    ``srtorch_opcache_<uid>`` under the temp dir (the reference's knob and
    default, ``/tmp/srtpu_opcache_<uid>``, with the port's own name)."""
    return os.environ.get(
        "SRTPU_OP_CACHE_DIR",
        os.path.join(tempfile.gettempdir(), f"srtorch_opcache_{os.getuid()}"))


def _op_cache_path(psf, shifts_yx, factor, lr_shape, reps,
                   solver="ibp"):
    """Disk-cache file for a host operator build, or None when
    ``SRTPU_OP_CACHE=0`` turns the cache off (the reference's knob).

    The key covers everything that changes the cached contents.  The
    directory is made 0700 and is read only when this uid owns it and no
    one else may write it: pickle runs code on load, so a cache another
    user could have planted is never read (see :func:`_cache_dir_trusted`).
    """
    if os.environ.get("SRTPU_OP_CACHE", "1") == "0":
        return None
    meta = repr((_OP_CACHE_VERSION, psf.shape, str(psf.dtype), shifts_yx,
                 factor, lr_shape, _DTYPE_NAME, reps, BLOCK,
                 solver)).encode()
    key = hashlib.sha256(meta + psf.tobytes()).hexdigest()[:32]
    return os.path.join(op_cache_dir(), f"ops_{key}.pkl")


def _cache_dir_trusted(path: str) -> bool:
    """Only trust a cache directory this uid owns with no group/other
    write access (pickle.load runs arbitrary code)."""
    try:
        st = os.stat(os.path.dirname(path))
    except OSError:
        return False
    return st.st_uid == os.getuid() and not (st.st_mode & 0o022)


def _cached_host_matrices(psf, shifts_yx, factor, lr_shape, reps=1,
                          solver="ibp"):
    """:func:`_host_solve_matrices`, memoized on disk (host numpy only)
    unless the cache is off."""
    path = _op_cache_path(psf, shifts_yx, factor, lr_shape, reps, solver)
    if path is None:
        return _host_solve_matrices(psf, shifts_yx, factor, lr_shape, reps,
                                    solver)
    if os.path.exists(path) and _cache_dir_trusted(path):
        try:
            with open(path, "rb") as fp:
                return pickle.load(fp)
        except Exception:  # noqa: BLE001 -- stale/corrupt entry: rebuild
            pass
    mats = _host_solve_matrices(psf, shifts_yx, factor, lr_shape, reps,
                                solver)
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    if _cache_dir_trusted(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fp:
            pickle.dump(mats, fp, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic against concurrent writers
    return mats


def _map_ops(fn, tree):
    """``fn`` applied to every :class:`BandedOp` of an operator tree."""
    if isinstance(tree, BandedOp):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_ops(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_ops(fn, v) for v in tree)
    raise TypeError(f"unexpected operator tree node {type(tree)}")


def _to_device(tree, device):
    """Every :class:`BandedOp` of an operator tree, bound to ``device``."""
    return _map_ops(lambda op: op.to(device), tree)


def _cast_bf16(tree):
    """Every :class:`BandedOp` of an operator tree with bf16 bands."""
    return _map_ops(lambda op: op.astype_band(torch.bfloat16), tree)


@functools.lru_cache(maxsize=64)
def _device_matrices(psf_bytes, psf_shape, shifts_yx, factor, lr_shape, reps,
                     device, band_store="f32", fused_on=False,
                     precision=torch.float32, solver="ibp"):
    """One solve config's operator tree on ``device``, kept in process (as
    the JAX package keeps ``_compiled_solve``), so a run of many units reads
    the disk cache and uploads each op's pack once per config.

    The tree holds the float32 operators (``zoom_r``, ``zoom_c``, ``saa``,
    ``frames``) and, by band store and engine, as the reference's
    ``_solve_matrices``: ``fused`` (the f32 fused pack) for ``f32`` with the
    fused engine; ``fused_lo`` (the bf16 pack) for ``bf16``/``hybrid`` with
    it; ``frames_lo`` (bf16 frame operators) for ``hybrid`` without it; and
    for ``bf16`` every banded operator cast to bf16.  ``precision`` (the
    band type :func:`~..ops.opmatrix.resolve_mm_precision` gives) then
    applies to the float32-band operators; the fused packs keep theirs.
    ``solver`` picks the frames' back-projection operators.  The host disk
    cache stays float32."""
    psf = np.frombuffer(psf_bytes, dtype=np.float64).reshape(psf_shape)
    with span("operators.host"):
        host = _cached_host_matrices(psf, shifts_yx, factor, lr_shape, reps,
                                     solver)
    kind, _ = parse_band_store(band_store)
    if kind == "bf16":
        host = _cast_bf16(host)
    elif kind == "hybrid" and not fused_on:
        host = dict(host, frames_lo=_cast_bf16(host["frames"]))
    if precision != torch.float32:
        host = _map_ops(lambda op: op.astype_band(precision)
                        if op.band_dtype == torch.float32 else op, host)
    with span("operators.device"):
        mats = _to_device(host, device)
        if fused_on:
            pack = FusedIBP.build(host["frames"], device)
            if kind == "f32":
                mats["fused"] = pack
            else:
                mats["fused_lo"] = pack.astype_bands(torch.bfloat16)
    return mats


def _build_packs(mats) -> None:
    """Build every device pack a solve of ``mats`` reads (the upload a solve
    does at each op's first use): the row pack of each row operator and the
    column pack of each column operator."""
    for key, node in mats.items():
        if key == "zoom_r":
            node.row_pack
        elif key == "zoom_c":
            node.col_pack
        elif key == "saa":
            for r, c in node:
                r.row_pack, c.col_pack
        elif key in ("frames", "frames_lo"):
            for frame in node:
                for axis, ops in enumerate(frame):
                    for op in ops:
                        op.row_pack if axis % 2 == 0 else op.col_pack


def _solve_matrices(psf, shifts_yx, factor, lr_shape, reps, device,
                    band_store="f32", fused="off", mm_precision="HIGHEST",
                    solver="ibp"):
    psf = np.ascontiguousarray(psf, dtype=np.float64)
    h, w = lr_shape
    # one rep's shape decides, as in the reference
    fused_on = fused_engine_on(fused, band_store, (h, w),
                               (h * factor, w * factor), solver)
    return _device_matrices(psf.tobytes(), psf.shape, shifts_yx, factor,
                            lr_shape, reps, device, band_store, fused_on,
                            resolve_mm_precision(mm_precision), solver)


def _rep_mse(err: torch.Tensor, reps: int) -> torch.Tensor:
    """Mean squared error of ``err`` (per rep when ``reps > 1``, reps
    stacked along H); a bf16 err (fused low path) is summed in f32."""
    err = err.float()
    if reps == 1:
        return torch.mean(err * err)
    per = err.reshape((reps, err.shape[-2] // reps) + err.shape[-1:])
    return torch.mean(per * per, dim=(-2, -1))


def _banded_update(hr, lr_stack, frames, step: float, clip, reps: int,
                   plain: bool):
    """One update of the banded engine over every frame, ``hr + step *
    mean_f(bp_f(lr_f - fwd_f(hr)))`` clipped; returns (new hr, the mean MSE
    of the errors before the update)."""
    n = lr_stack.shape[0]
    total = torch.zeros((reps,) if reps > 1 else (), dtype=hr.dtype,
                        device=hr.device)
    correction = torch.zeros_like(hr)
    for i in range(n):
        err = lr_stack[i] - forward_model_mm(hr, frames[i], plain)
        total += _rep_mse(err, reps)
        # in place: saves one HR-sized allocation per frame
        correction += back_project_mm(err, frames[i], plain)
    return torch.clamp(hr + step * correction / n, *clip), total / n


def _solve_body(lr_stack: torch.Tensor, mats, n_iter: int, step: float,
                clip_max: float, reps: int, band_store: str,
                plain: bool) -> Dict:
    """LR mean, native 2x zoom, Shift-and-Add and SAA-seeded IBP on
    ``f32[N, reps*h, w]`` (reps stacked along H); every result stays on
    the device.  The IBP loop follows the reference's lo/hi schedule:
    ``bf16`` runs every iteration on the low operators, ``hybrid`` the
    first ``n_iter - tail`` and then the float32 ones."""
    n = lr_stack.shape[0]
    clip = (0.0, clip_max)

    def rows(op, x):
        return op.row_apply(x, plain=plain)

    with span("solve.prologue"):
        lr_mean = torch.mean(lr_stack, dim=0)
        native = mats["zoom_c"].col_apply(rows(mats["zoom_r"], lr_mean))
        up = mats["zoom_c"].col_apply(rows(mats["zoom_r"], lr_stack))
        saa = sum(c.col_apply(rows(r, up[i]))
                  for i, (r, c) in enumerate(mats["saa"])) / n

    errs = torch.zeros((n_iter,) + ((reps,) if reps > 1 else ()),
                       dtype=saa.dtype, device=saa.device)
    # the low fused pack takes a bf16 lr stack (its err stack is bf16 too);
    # cast once, outside the loop
    lr_lo = (lr_stack.to(torch.bfloat16) if "fused_lo" in mats else None)

    def iterate(kind, obj, hr, its):
        # 'fused': the two whole-iteration kernels over the given pack;
        # 'banded': the banded engine over the given per-frame operators
        for it in its:
            if kind == "banded":
                hr, errs[it] = _banded_update(hr, lr_stack, obj, step, clip,
                                              reps, plain)
                continue
            low = obj.band_dtype == torch.bfloat16
            err = obj.fwd_err(hr, lr_lo if low else lr_stack, plain)
            total = torch.zeros(errs.shape[1:], dtype=hr.dtype,
                                device=hr.device)
            for i in range(n):
                total += _rep_mse(err[i], reps)
            hr = obj.bwd_update(hr, err, step / n, clip, plain)
            errs[it] = total / n
        return hr

    lo_spec = (("fused", mats["fused_lo"]) if "fused_lo" in mats
               else ("banded", mats["frames_lo"]) if "frames_lo" in mats
               else None)
    hi_spec = (("fused", mats["fused"]) if "fused" in mats
               else ("banded", mats["frames"]))
    kind, tail = parse_band_store(band_store)
    with span("solve.ibp"):
        if lo_spec is not None and kind == "hybrid":
            n_lo = n_iter - min(tail, n_iter)
            hr = iterate(*lo_spec, saa, range(n_lo))
            hr = iterate(*hi_spec, hr, range(n_lo, n_iter))
        elif lo_spec is not None:  # 'bf16' on the fused engine: all low
            hr = iterate(*lo_spec, saa, range(n_iter))
        else:
            hr = iterate(*hi_spec, saa, range(n_iter))
    return {"lr_mean": lr_mean, "native": native, "saa": saa, "ibp": hr,
            "mse_history": errs}


def _solve_conv(lr_stack: torch.Tensor, psf, shifts_yx, factor: int,
                n_iter: int, step: float, clip_max: float) -> Dict:
    """The conv engine's solve of one unit ``f32[N, h, w]``, every result on
    the device."""
    lr_mean = torch.mean(lr_stack, dim=0)
    saa = shift_and_add(lr_stack, shifts_yx, factor)
    hr, errs = ibp(lr_stack, shifts_yx, psf, saa, factor, n_iter, step,
                   (0.0, clip_max))
    return {"lr_mean": lr_mean, "native": native_upsample(lr_mean, factor),
            "saa": saa, "ibp": hr, "mse_history": errs}


def _to_host(result: Dict) -> Dict[str, np.ndarray]:
    """All results to the host in ONE device-to-host copy (its bytes
    counted in ``_to_host.d2h_bytes``), as numpy views of one host buffer.

    From the card the copy lands in page-locked memory from PyTorch's
    caching host allocator (counted in ``_to_host.pinned_calls``), which
    the card's DMA engine writes at link speed; a fresh pageable array
    would be mapped and faulted in page by page on every call.  The block
    goes back to the allocator's cache when the caller drops the last of
    the returned arrays, so from the second call on a call reuses one that
    is already pinned and mapped.  The cost: each live result holds its
    own pinned block, its size rounded up to a power of two (256 MiB for
    the 164 MB of results of a 1536 x 2048 session), which the allocator
    keeps for reuse and does not give back to the OS.  On the CPU the
    results are viewed in place.
    """
    keys = list(result)
    flat = torch.cat([result[k].reshape(-1) for k in keys])
    if flat.device.type != "cpu":
        _to_host.d2h_bytes += flat.numel() * flat.element_size()
        _to_host.pinned_calls += 1
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        # No view of the buffer before its copy has landed.
        torch.cuda.current_stream(flat.device).synchronize()
        flat = host
    flat = flat.numpy()
    out, pos = {}, 0
    for k in keys:
        size = result[k].numel()
        out[k] = flat[pos:pos + size].reshape(tuple(result[k].shape))
        pos += size
    return out


_to_host.d2h_bytes = 0
_to_host.pinned_calls = 0


def _prepare(lr, psf, shifts_yx, device):
    """The solve's device, and its inputs as it takes them: the frames as
    float32 on the device (the upload's bytes counted in
    ``_prepare.h2d_bytes``, and the call in ``_prepare.calls``)."""
    _prepare.calls += 1
    device = resolve_device(device) if isinstance(device, str) else device
    if device.type == "cuda":
        # Strict f32: no TF32 in any matmul or convolution of the solve.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    psf = np.asarray(psf, dtype=np.float64)
    shifts_key = tuple((float(dy), float(dx)) for dy, dx in shifts_yx)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    on_device = lr.to(device)
    if on_device is not lr:
        _prepare.h2d_bytes += lr.numel() * lr.element_size()
    return on_device, psf, shifts_key, device


_prepare.calls = 0
_prepare.h2d_bytes = 0


def solve(lr_stack, psf, shifts_yx, factor: int = UPSAMPLE_FACTOR,
          n_iter: int = 80, step: float = IBP_STEP_SIZE,
          clip_max: float = 255.0, device="cuda", band_store: str = "f32",
          fused: str = "auto", plain: bool = False,
          mm_precision: str = "HIGHEST", solver: str = "ibp",
          engine: str = "mm") -> Dict[str, np.ndarray]:
    """Full classical SR solve of one unit.

    Computes everything a reference ``process_session`` rep computes
    (``mono_barcodes/run_sr.py:301-335``): the LR mean, its cubic 2x zoom
    (Native-2x), Shift-and-Add, and SAA-seeded IBP with the MSE history.

    Args:
      lr_stack: ``f32[N, h, w]`` registered LR frames (numpy or torch).
      psf: ``(k, k)`` blur kernel.
      shifts_yx: N ``(dy, dx)`` LR-pixel shifts.
      device: ``"cuda"`` (default) or ``"cpu"``, or a ``torch.device``.
      band_store: ``"f32"`` (default), ``"bf16"`` or ``"hybrid[:tail]"``.
      fused: ``"auto"`` (default), ``"on"`` or ``"off"`` (the engine).
      plain: run every kernel's plain PyTorch version instead of the kernel
        (the on-card parity check of the kernels).
      mm_precision: ``"HIGHEST"`` (default) or another name of
        :data:`~..ops.opmatrix.MM_PRECISIONS` (see the module docstring).
      solver: ``"ibp"`` (default) or ``"adjoint"``.
      engine: ``"mm"`` (default) or ``"conv"``.

    Returns a dict of numpy arrays ``lr_mean, native, saa, ibp,
    mse_history``.
    """
    with span("solve"):
        with span("solve.prepare"):
            check_config(engine, solver, band_store, fused, mm_precision)
            lr, psf, shifts_key, device = _prepare(lr_stack, psf, shifts_yx,
                                                   device)
        if engine == "conv":
            return _to_host(_solve_conv(lr, psf, shifts_key, int(factor),
                                        int(n_iter), float(step),
                                        float(clip_max)))
        lr_shape = tuple(int(v) for v in lr.shape[-2:])
        with span("solve.operators"):
            mats = _solve_matrices(psf, shifts_key, int(factor), lr_shape, 1,
                                   device, band_store, fused, mm_precision,
                                   solver)
        out = _solve_body(lr, mats, int(n_iter), float(step),
                          float(clip_max), 1, band_store, plain)
        with span("solve.to_host"):
            return _to_host(out)


def solve_batch(lr_stacks, psf, shifts_yx, factor: int = UPSAMPLE_FACTOR,
                n_iter: int = 80, step: float = IBP_STEP_SIZE,
                clip_max: float = 255.0, device="cuda",
                band_store: str = "f32", fused: str = "auto",
                plain: bool = False, mm_precision: str = "HIGHEST",
                solver: str = "ibp",
                engine: str = "mm") -> Dict[str, np.ndarray]:
    """Batched solve over R same-shaped units ``f32[R, N, h, w]``; returns
    the :func:`solve` dict with a leading R axis.

    On the ``mm`` engine reps are concatenated along the image ROW axis and
    every row operator is block-diagonally rep-tiled
    (:meth:`BandedOp.tiled`), so the batch runs as the same few large
    applies as one solve, with per-rep-exact boundaries; the fused pack
    rep-tiles its row operators the same way.  The ``conv`` engine solves
    the units one after another (its ``nearest`` boundary taps would leak
    across concatenated reps).  The other arguments are :func:`solve`'s.
    """
    with span("solve"):
        with span("solve.prepare"):
            check_config(engine, solver, band_store, fused, mm_precision)
            lr, psf, shifts_key, device = _prepare(lr_stacks, psf, shifts_yx,
                                                   device)
        r, n, h, w = (int(v) for v in lr.shape)
        fh = factor * h
        if engine == "conv":
            units = [_solve_conv(lr[i], psf, shifts_key, int(factor),
                                 int(n_iter), float(step), float(clip_max))
                     for i in range(r)]
            return _to_host({k: torch.stack([u[k] for u in units])
                             for k in units[0]})
        with span("solve.operators"):
            mats = _solve_matrices(psf, shifts_key, int(factor), (h, w), r,
                                   device, band_store, fused, mm_precision,
                                   solver)
        stacked = lr.transpose(0, 1).reshape(n, r * h, w)
        out = _solve_body(stacked, mats, int(n_iter), float(step),
                          float(clip_max), r, band_store, plain)
        with span("solve.to_host"):
            return _to_host({
                "lr_mean": out["lr_mean"].reshape(r, h, w),
                "native": out["native"].reshape(r, fh, -1),
                "saa": out["saa"].reshape(r, fh, -1),
                "ibp": out["ibp"].reshape(r, fh, -1),
                "mse_history": (out["mse_history"].T if r > 1
                                else out["mse_history"][None]),
            })


def landweber_refine(hr0, lr_stack, psf, shifts_yx,
                     factor: int = UPSAMPLE_FACTOR, n_iter: int = 30,
                     step: float = 2.0, clip_max: float = 255.0,
                     device="cuda", mm_precision: str = "HIGHEST",
                     plain: bool = False):
    """True-adjoint Landweber refinement seeded from ``hr0``, ``hr += step *
    A^T(lr - A hr) / n``, on the banded engine with the adjoint operator set
    (the ``solver="adjoint"`` operators, so both share the caches).  Step
    2.0 is stable: the blur + decimate operator has norm below 1.
    ``plain`` is :func:`solve`'s.

    Returns ``(hr, mse_history[n_iter], final_mse)`` as numpy (one copy to
    the host): ``mse_history[i]`` is the forward fit before update ``i``,
    ``final_mse`` that of the returned estimate.
    """
    with span("landweber_refine"):
        lr, psf, shifts_key, device = _prepare(lr_stack, psf, shifts_yx,
                                               device)
        hr = torch.as_tensor(hr0, dtype=torch.float32).to(device)
        lr_shape = tuple(int(v) for v in lr.shape[-2:])
        frames = _solve_matrices(psf, shifts_key, int(factor), lr_shape, 1,
                                 device, "f32", "auto", mm_precision,
                                 "adjoint")["frames"]
        clip = (0.0, float(clip_max))
        errs = torch.zeros((int(n_iter),), dtype=torch.float32,
                           device=device)
        for it in range(int(n_iter)):
            hr, errs[it] = _banded_update(hr, lr, frames, float(step), clip,
                                          1, plain)
        final = sum(_rep_mse(lr[i] - forward_model_mm(hr, frames[i], plain),
                             1)
                    for i in range(lr.shape[0])) / lr.shape[0]
        out = _to_host({"hr": hr, "mse_history": errs, "final": final})
    return out["hr"], out["mse_history"], float(out["final"])


def to_uint8(img) -> np.ndarray:
    """Reference output quantization: clip to [0, 255] then TRUNCATE
    (``np.clip(...).astype(np.uint8)``, ``mono_barcodes/run_sr.py:339``)."""
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)
