"""The plain reference of a classical SR solve, and its lower-precision
controls.

It follows the upstream algorithm (``mono_barcodes/run_sr.py:188-240``)
as SciPy states it, and imports nothing of the program under test:

* blur             ``scipy.signal.fftconvolve(img, psf, mode="same")``
* forward model    blur -> ``ndi.shift(order=3, mode="nearest")`` by
                   ``shift * f`` -> ``[::f, ::f]``
* back-projection  zero-stuff onto the HR grid -> shift by ``-shift * f``
                   -> ``fftconvolve(., psf[::-1, ::-1], mode="same")``
* Shift-and-Add    per frame ``ndi.zoom(lr, f, order=3)`` then the shift,
                   averaged; native 2x the zoom of the LR mean
* IBP              from the SAA, ``hr = clip(hr + step * mean_f(bp_f(lr_f -
                   fwd_f(hr))), 0, clip)``, the MSE logged before each update

Every stage is linear and separable, so each is written once as a dense
1-D matrix per axis, built from SciPy's own calls on impulses
(:func:`impulse_matrix`), and the solve is plain matrix products in
float64.  A control runs the same products with their operands rounded to
a lower precision (:data:`ARITH`).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import scipy.ndimage as ndi
import torch

# Impulses this far apart share no entry above 0.268^64 of their peak (the
# cubic spline prefilter's impulse response decays as (2 - sqrt 3)^|n|).
SPACING = 128

# The arithmetic of a solve: the reference, and the two controls (the
# program's stated precision with the step below it: TF32 below strict
# float32, fp8 below bf16 operands).
ARITH = ("f64", "tf32", "fp8")


def gaussian_taps(size: int, sigma: float) -> np.ndarray:
    """The 1-D factor ``g`` of the normalized ``size`` x ``size`` Gaussian
    PSF: ``outer(g, g)`` is it (``mono_barcodes/run_sr.py:135-142``)."""
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-x * x / (2.0 * float(sigma) ** 2))
    return g / g.sum()


def psf(cfg: Dict) -> np.ndarray:
    """The configuration's 2-D PSF, the array both sides are given."""
    g = gaussian_taps(cfg["psf"]["size"], cfg["psf"]["sigma"])
    return np.outer(g, g)


def impulse_matrix(fn: Callable[[np.ndarray], np.ndarray], n_in: int,
                   n_out: int, pos: np.ndarray) -> np.ndarray:
    """The matrix ``M`` with ``M @ v == fn(v)`` for a linear 1-D ``fn`` whose
    output ``i`` depends on inputs near ``pos[i]`` only: ``fn`` is applied to
    combs of impulses ``SPACING`` apart, and each output's entry is given to
    the impulse nearest ``pos[i]``."""
    m = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    for c in range(min(SPACING, n_in)):
        comb = np.zeros(n_in)
        comb[c::SPACING] = 1.0
        y = fn(comb)
        j = c + SPACING * np.rint((pos - c) / SPACING).astype(np.int64)
        ok = (j >= 0) & (j < n_in)
        m[rows[ok], j[ok]] = y[ok]
    return m


def shift_matrix(n: int, delta: float) -> np.ndarray:
    """``ndi.shift(v, delta, order=3, mode="nearest")`` as an n x n matrix."""
    return impulse_matrix(
        lambda v: ndi.shift(v, delta, order=3, mode="nearest"), n, n,
        np.clip(np.arange(n) - delta, 0, n - 1))


def zoom_matrix(n: int, factor: int) -> np.ndarray:
    """``ndi.zoom(v, factor, order=3)`` as an (n * factor) x n matrix."""
    n_out = n * factor
    return impulse_matrix(lambda v: ndi.zoom(v, factor, order=3), n, n_out,
                          np.arange(n_out) * (n - 1) / (n_out - 1))


def blur_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """``fftconvolve(v, taps, mode="same")`` (zero outside) as n x n."""
    r = len(taps) // 2
    m = np.zeros((n, n))
    for k, t in enumerate(taps):  # out[i] += taps[k] * v[i + r - k]
        idx = np.arange(max(0, k - r), min(n, n + k - r))
        m[idx, idx + r - k] = t
    return m


def blur_right(a: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """``a @ blur_matrix(a.shape[1], taps)``: ``out[:, c] = sum_k taps[k]
    a[:, c - r + k]``, a correlation along the rows."""
    return ndi.correlate1d(a, taps, axis=1, mode="constant")


def blur_left(taps: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``blur_matrix(b.shape[0], taps) @ b``: ``out[i] = sum_k taps[k]
    b[i + r - k]``, a convolution down the columns."""
    return ndi.convolve1d(b, taps, axis=0, mode="constant")


def axis_operators(n_lr: int, factor: int, taps: np.ndarray,
                   shifts: Sequence[float]) -> Dict[str, list]:
    """One axis's operators, float64: ``fwd[i]`` (n_lr x n_hr) and
    ``bwd[i]`` (n_hr x n_lr) for each frame's shift (LR px), ``saa[i]``
    (n_hr x n_hr), and ``zoom`` (n_hr x n_lr)."""
    n_hr = n_lr * factor
    moved = {}
    for s in shifts:
        for d in (s * factor, -s * factor):
            if d not in moved:
                moved[d] = shift_matrix(n_hr, d)
    # forward: blur (convolution), shift, keep every factor-th row;
    # back-projection: zero-stuff (every factor-th column), shift back,
    # correlate with the taps (a convolution with them reversed)
    fwd = {s: blur_right(moved[s * factor][::factor], taps)
           for s in set(shifts)}
    bwd = {s: blur_left(taps[::-1], moved[-s * factor][:, ::factor])
           for s in set(shifts)}
    return {"fwd": [fwd[s] for s in shifts], "bwd": [bwd[s] for s in shifts],
            "saa": [moved[s * factor] for s in shifts],
            "zoom": zoom_matrix(n_lr, factor)}


def operators(cfg: Dict) -> Dict[str, Dict[str, list]]:
    """Both axes' operators of a configuration (rows: ``y``, columns:
    ``x``), float64 numpy."""
    f = cfg["factor"]
    taps = gaussian_taps(cfg["psf"]["size"], cfg["psf"]["sigma"])
    h, w = cfg["lr_shape"]
    return {"y": axis_operators(h, f, taps, [s[0] for s in cfg["shifts"]]),
            "x": axis_operators(w, f, taps, [s[1] for s in cfg["shifts"]])}


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32's 10 stored significand bits, to
    nearest with ties away from zero."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to float8 e4m3 (3 significand bits)."""
    return v.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


class Arith:
    """The products of one arithmetic: ``f64`` in float64; ``tf32`` and
    ``fp8`` round both operands of every product, then take the exact
    products summed in float32 (TF32 switched off for that sum)."""

    def __init__(self, name: str):
        if name not in ARITH:
            raise ValueError(f"arith {name!r}: use one of {ARITH}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32
        self._round = {"f64": None, "tf32": round_tf32,
                       "fp8": round_fp8}[name]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self._round is None:
            return a @ b
        a, b = self._round(a), self._round(b)
        if not a.is_cuda:
            return a @ b
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def device_operators(ops, arith: str, device) -> Dict[str, Dict[str, list]]:
    """:func:`operators` as tensors of ``arith``'s type on ``device``, the
    column operators transposed (``x @ op.T`` applies them)."""
    dtype = Arith(arith).dtype

    def t(m):
        return torch.as_tensor(np.ascontiguousarray(m), dtype=dtype,
                               device=torch.device(device))

    out = {"y": {}, "x": {}}
    for key in ("fwd", "bwd", "saa"):
        out["y"][key] = [t(m) for m in ops["y"][key]]
        out["x"][key] = [t(m.T) for m in ops["x"][key]]
    out["y"]["zoom"], out["x"]["zoom"] = t(ops["y"]["zoom"]), \
        t(ops["x"]["zoom"].T)
    return out


def solve_unit(frames: np.ndarray, dops, cfg: Dict,
               arith: str = "f64") -> Dict[str, np.ndarray]:
    """One unit ``f32[N, h, w]`` (the uint8 frames as given to the
    program): its LR mean, native 2x zoom, Shift-and-Add, IBP result and
    MSE history, as numpy float64.  ``dops`` is :func:`device_operators`
    of ``cfg`` in ``arith``."""
    a = Arith(arith)
    oy, ox = dops["y"], dops["x"]
    dev = oy["zoom"].device
    n = frames.shape[0]
    lr = torch.as_tensor(frames, dtype=a.dtype, device=dev)

    def both(ry, x, rxt):
        return a.mm(a.mm(ry, x), rxt)

    lr_mean = a.mm(torch.full((1, n), 1.0 / n, dtype=a.dtype, device=dev),
                   lr.reshape(n, -1)).reshape(lr.shape[1:])
    native = both(oy["zoom"], lr_mean, ox["zoom"])
    saa = sum(both(oy["saa"][i], both(oy["zoom"], lr[i], ox["zoom"]),
                   ox["saa"][i]) for i in range(n)) / n
    it = cfg["ibp"]
    mse = torch.zeros(it["iterations"], dtype=a.dtype, device=dev)
    hr = saa
    for k in range(it["iterations"]):
        corr = torch.zeros_like(hr)
        total = torch.zeros((), dtype=a.dtype, device=dev)
        for i in range(n):
            err = lr[i] - both(oy["fwd"][i], hr, ox["fwd"][i])
            total += torch.mean(err * err)
            corr += both(oy["bwd"][i], err, ox["bwd"][i])
        hr = torch.clamp(hr + it["step"] * corr / n, 0.0, it["clip_max"])
        mse[k] = total / n
    return {k: v.double().cpu().numpy() for k, v in
            (("lr_mean", lr_mean), ("native", native), ("saa", saa),
             ("ibp", hr), ("mse_history", mse))}


def solve_call(units: np.ndarray, dops, cfg: Dict,
               arith: str = "f64") -> Dict[str, np.ndarray]:
    """:func:`solve_unit` of each unit of a call ``f32[R, N, h, w]``, each
    result stacked along a leading R axis."""
    outs = [solve_unit(u, dops, cfg, arith) for u in units]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


# Each output of a solve and the name of the number it is judged by.
GAPS = (("lr_mean", "lr_mean_max_abs"), ("native", "native_max_abs"),
        ("saa", "saa_max_abs"), ("ibp", "ibp_max_abs"),
        ("mse_history", "mse_max_rel"))


def gaps(program: Dict[str, np.ndarray],
         reference: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers a call is judged by: the largest absolute gap of each
    image output, and the largest gap of the MSE history relative to the
    reference's.  A missing, misshapen or non-finite output reads
    infinite."""
    out = {}
    for key, name in GAPS:
        ref = reference[key]
        got = program.get(key)
        if got is None or np.shape(got) != ref.shape \
                or not np.isfinite(got).all():
            out[name] = float("inf")
        elif key == "mse_history":
            out[name] = float(np.max(np.abs(got - ref) / np.abs(ref)))
        else:
            out[name] = float(np.max(np.abs(got - ref)))
    return out


def with_units_axis(result: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A program result with a leading unit axis (``solve`` of one unit
    gives none; ``solve_batch`` does)."""
    if result["mse_history"].ndim == 1:
        return {k: v[None] for k, v in result.items()}
    return result
