"""Classical multi-frame super-resolution: Shift-and-Add + Iterative
Back-Projection on the banded-matmul engine.

Counterpart of ``enph459_super_resolution_tpu/sr/classical.py`` (its
``mm`` engine and ``ibp`` solver, with the ``f32``, ``bf16`` and
``hybrid[:tail]`` band stores and the fused-iteration engine).  Reference
behavior: ``mono_barcodes/run_sr.py:188-240``:

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
from ..ops.fused_ibp import FusedIBP, fused_eligible
from ..ops.opmatrix import (
    BLOCK,
    BandedOp,
    psf_separable_factors,
    shift_op_banded,
    stuff_shift_op_banded,
    zoom_op_banded,
)

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


def fused_engine_on(fused: str, band_store: str, lr_shape,
                    hr_shape) -> bool:
    """Whether a solve runs the fused kernels (see the module docstring):
    the reference's ``_fused_engine_on`` as it routes on its chip, except
    that ``fused="on"`` raises for a shape the kernels cannot take."""
    if fused not in FUSED_MODES:
        raise ValueError(f"fused {fused!r}: use one of {FUSED_MODES}")
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
                           dtype_name: str = _DTYPE_NAME):
    """(fwd_row, fwd_col, bwd_row, bwd_col) :class:`HostBanded` lists over
    the PSF's separable rank terms.

    Forward:  sim  = sum_k R_k @ HR @ C_k^T   ==  decimate(shift(conv2d(HR)))
    Backward: corr = sum_k Br_k @ ERR @ Bc_k^T
                   ==  correlate2d(shift^{-1}(zero_stuff(ERR)), psf)
    (the reference's heuristic back-projection, solver 'ibp').
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
        # back-projection correlates with the PSF -> taps unflipped
        bwd_r.append(stuff_shift_op_banded(
            h_lr, factor, -dy * factor, blur_taps=tuple(u),
            dtype_name=dtype_name))
        bwd_c.append(stuff_shift_op_banded(
            w_lr, factor, -dx * factor, blur_taps=tuple(v),
            dtype_name=dtype_name))
    return fwd_r, fwd_c, bwd_r, bwd_c


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


def _host_solve_matrices(psf, shifts_yx, factor, lr_shape, reps=1):
    """Host (numpy) build of one solve config's operators, as
    :class:`BandedOp` block decompositions.

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
    frame_bands = [_frame_operator_banded(psf, s, factor, lr_shape)
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


_OP_CACHE_VERSION = 1


def _op_cache_path(psf, shifts_yx, factor, lr_shape, reps) -> str:
    """Disk-cache file for a host operator build.

    The key covers everything that changes the cached contents.  The
    directory is uid-scoped and 0700 under the temp dir: pickle runs code
    on load, so a cache another user could have planted is never read (see
    :func:`_cache_dir_trusted`).
    """
    meta = repr((_OP_CACHE_VERSION, psf.shape, str(psf.dtype), shifts_yx,
                 factor, lr_shape, _DTYPE_NAME, reps, BLOCK)).encode()
    key = hashlib.sha256(meta + psf.tobytes()).hexdigest()[:32]
    cache_dir = os.path.join(tempfile.gettempdir(),
                             f"srtorch_opcache_{os.getuid()}")
    return os.path.join(cache_dir, f"ops_{key}.pkl")


def _cache_dir_trusted(path: str) -> bool:
    """Only trust a cache directory this uid owns with no group/other
    write access (pickle.load runs arbitrary code)."""
    try:
        st = os.stat(os.path.dirname(path))
    except OSError:
        return False
    return st.st_uid == os.getuid() and not (st.st_mode & 0o022)


def _cached_host_matrices(psf, shifts_yx, factor, lr_shape, reps=1):
    """:func:`_host_solve_matrices`, memoized on disk (host numpy only)."""
    path = _op_cache_path(psf, shifts_yx, factor, lr_shape, reps)
    if os.path.exists(path) and _cache_dir_trusted(path):
        try:
            with open(path, "rb") as fp:
                return pickle.load(fp)
        except Exception:  # noqa: BLE001 -- stale/corrupt entry: rebuild
            pass
    mats = _host_solve_matrices(psf, shifts_yx, factor, lr_shape, reps)
    os.makedirs(os.path.dirname(path), mode=0o700, exist_ok=True)
    if _cache_dir_trusted(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fp:
            pickle.dump(mats, fp, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic against concurrent writers
    return mats


def _to_device(tree, device):
    """Every :class:`BandedOp` of an operator tree, bound to ``device``."""
    if isinstance(tree, BandedOp):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    raise TypeError(f"unexpected operator tree node {type(tree)}")


def _cast_bf16(tree):
    """Every :class:`BandedOp` of an operator tree with bf16 bands."""
    if isinstance(tree, BandedOp):
        return tree.astype_band(torch.bfloat16)
    return type(tree)(_cast_bf16(v) for v in tree)


@functools.lru_cache(maxsize=64)
def _device_matrices(psf_bytes, psf_shape, shifts_yx, factor, lr_shape, reps,
                     device, band_store="f32", fused_on=False):
    """One solve config's operator tree on ``device``, kept in process (as
    the JAX package keeps ``_compiled_solve``), so a run of many units reads
    the disk cache and uploads each op's pack once per config.

    The tree holds the float32 operators (``zoom_r``, ``zoom_c``, ``saa``,
    ``frames``) and, by band store and engine, as the reference's
    ``_solve_matrices``: ``fused`` (the f32 fused pack) for ``f32`` with the
    fused engine; ``fused_lo`` (the bf16 pack) for ``bf16``/``hybrid`` with
    it; ``frames_lo`` (bf16 frame operators) for ``hybrid`` without it; and
    for ``bf16`` every banded operator cast to bf16.  The host disk cache
    stays float32."""
    psf = np.frombuffer(psf_bytes, dtype=np.float64).reshape(psf_shape)
    host = _cached_host_matrices(psf, shifts_yx, factor, lr_shape, reps)
    kind, _ = parse_band_store(band_store)
    if kind == "bf16":
        host = {k: _cast_bf16(v) for k, v in host.items()}
    elif kind == "hybrid" and not fused_on:
        host = dict(host, frames_lo=_cast_bf16(host["frames"]))
    mats = _to_device(host, device)
    if fused_on:
        pack = FusedIBP.build(host["frames"], device)
        if kind == "f32":
            mats["fused"] = pack
        else:
            mats["fused_lo"] = pack.astype_bands(torch.bfloat16)
    return mats


def _solve_matrices(psf, shifts_yx, factor, lr_shape, reps, device,
                    band_store="f32", fused="off"):
    psf = np.ascontiguousarray(psf, dtype=np.float64)
    h, w = lr_shape
    # one rep's shape decides, as in the reference
    fused_on = fused_engine_on(fused, band_store, (h, w),
                               (h * factor, w * factor))
    return _device_matrices(psf.tobytes(), psf.shape, shifts_yx, factor,
                            lr_shape, reps, device, band_store, fused_on)


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

    def rep_mse(err):
        err = err.float()  # bf16 err (fused low path): f32 MSE
        if reps == 1:
            return torch.mean(err * err)
        per = err.reshape((reps, err.shape[-2] // reps) + err.shape[-1:])
        return torch.mean(per * per, dim=(-2, -1))

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
            total = torch.zeros(errs.shape[1:], dtype=hr.dtype,
                                device=hr.device)
            if kind == "fused":
                low = obj.band_dtype == torch.bfloat16
                err = obj.fwd_err(hr, lr_lo if low else lr_stack, plain)
                for i in range(n):
                    total += rep_mse(err[i])
                hr = obj.bwd_update(hr, err, step / n, clip, plain)
            else:
                correction = torch.zeros_like(hr)
                for i in range(n):
                    err = lr_stack[i] - forward_model_mm(hr, obj[i], plain)
                    total += rep_mse(err)
                    # in place: saves one HR-sized allocation per frame
                    correction += back_project_mm(err, obj[i], plain)
                hr = torch.clamp(hr + step * correction / n, *clip)
            errs[it] = total / n
        return hr

    lo_spec = (("fused", mats["fused_lo"]) if "fused_lo" in mats
               else ("banded", mats["frames_lo"]) if "frames_lo" in mats
               else None)
    hi_spec = (("fused", mats["fused"]) if "fused" in mats
               else ("banded", mats["frames"]))
    kind, tail = parse_band_store(band_store)
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


def _to_host(result: Dict) -> Dict[str, np.ndarray]:
    """All results to the host in ONE device-to-host copy."""
    keys = list(result)
    flat = torch.cat([result[k].reshape(-1) for k in keys]).cpu().numpy()
    out, pos = {}, 0
    for k in keys:
        size = result[k].numel()
        out[k] = flat[pos:pos + size].reshape(tuple(result[k].shape))
        pos += size
    return out


def _prepare(lr, psf, shifts_yx, device):
    device = resolve_device(device) if isinstance(device, str) else device
    if device.type == "cuda":
        # Strict f32: no TF32 in any matmul or convolution of the solve.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    psf = np.asarray(psf, dtype=np.float64)
    shifts_key = tuple((float(dy), float(dx)) for dy, dx in shifts_yx)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
    return lr, psf, shifts_key, device


def solve(lr_stack, psf, shifts_yx, factor: int = UPSAMPLE_FACTOR,
          n_iter: int = 80, step: float = IBP_STEP_SIZE,
          clip_max: float = 255.0, device="cuda", band_store: str = "f32",
          fused: str = "auto", plain: bool = False) -> Dict[str, np.ndarray]:
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

    Returns a dict of numpy arrays ``lr_mean, native, saa, ibp,
    mse_history``.
    """
    lr, psf, shifts_key, device = _prepare(lr_stack, psf, shifts_yx, device)
    lr_shape = tuple(int(v) for v in lr.shape[-2:])
    mats = _solve_matrices(psf, shifts_key, int(factor), lr_shape, 1, device,
                           band_store, fused)
    return _to_host(_solve_body(lr, mats, int(n_iter), float(step),
                                float(clip_max), 1, band_store, plain))


def solve_batch(lr_stacks, psf, shifts_yx, factor: int = UPSAMPLE_FACTOR,
                n_iter: int = 80, step: float = IBP_STEP_SIZE,
                clip_max: float = 255.0, device="cuda",
                band_store: str = "f32", fused: str = "auto",
                plain: bool = False) -> Dict[str, np.ndarray]:
    """Batched solve over R same-shaped units ``f32[R, N, h, w]``; returns
    the :func:`solve` dict with a leading R axis.

    Reps are concatenated along the image ROW axis and every row operator
    is block-diagonally rep-tiled (:meth:`BandedOp.tiled`), so the batch
    runs as the same few large applies as one solve, with per-rep-exact
    boundaries; the fused pack rep-tiles its row operators the same way.
    ``band_store``, ``fused`` and ``plain`` are :func:`solve`'s.
    """
    lr, psf, shifts_key, device = _prepare(lr_stacks, psf, shifts_yx, device)
    r, n, h, w = (int(v) for v in lr.shape)
    mats = _solve_matrices(psf, shifts_key, int(factor), (h, w), r, device,
                           band_store, fused)
    stacked = lr.transpose(0, 1).reshape(n, r * h, w)
    out = _solve_body(stacked, mats, int(n_iter), float(step),
                      float(clip_max), r, band_store, plain)
    fh = factor * h
    return _to_host({
        "lr_mean": out["lr_mean"].reshape(r, h, w),
        "native": out["native"].reshape(r, fh, -1),
        "saa": out["saa"].reshape(r, fh, -1),
        "ibp": out["ibp"].reshape(r, fh, -1),
        "mse_history": (out["mse_history"].T if r > 1
                        else out["mse_history"][None]),
    })


def to_uint8(img) -> np.ndarray:
    """Reference output quantization: clip to [0, 255] then TRUNCATE
    (``np.clip(...).astype(np.uint8)``, ``mono_barcodes/run_sr.py:339``)."""
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)
