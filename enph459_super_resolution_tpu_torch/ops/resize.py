"""Keys-cubic image resize (MATLAB ``imresize`` protocol) and the
tensor-shift Keys-cubic samplers of burst simulation and registration.

Counterpart of ``enph459_super_resolution_tpu/ops/resize.py``.  The host
part (:func:`_keys_cubic`, :func:`resize_matrix`) is the reference's float64
numpy code, copied, so the resize matrices come out entry for entry
identical.  :func:`resize` applies them as two float32 matmuls with TF32
off (the reference's ``Precision.HIGHEST``).

The samplers take their shifts as tensors: one ``(dy, dx)`` or one per
image of a batch (``shift_yx[..., 2]`` broadcast against the image's
leading axes), differentiable in the fractional part.  Each Keys tap is a
gather of the image along one axis at indices clamped per image.  The
reference slices an edge-padded array with ``dynamic_slice``, which clamps
an out-of-range start to ``[0, 2 * pad]`` after wrapping a negative one
once, as numpy indexes; that is its boundary rule, so the port wraps and
clamps its starts the same way -- also past :func:`keys_phase_max_shift`,
where both then mis-register alike -- and then clamps each index into the
image (the edge padding).  A batch of bursts
with different shifts is one gather per tap.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import no_tf32


def _keys_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0))


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, antialias: bool = True,
                  dtype_name: str = "float32") -> np.ndarray:
    """(n_out, n_in) MATLAB-imresize-compatible cubic resize matrix."""
    scale = n_out / n_in
    # output pixel centres mapped to input coordinates (pixel-centre grid)
    u = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    if scale < 1.0 and antialias:
        kwidth = 4.0 / scale
        kscale = scale
    else:
        kwidth = 4.0
        kscale = 1.0
    left = np.floor(u - kwidth / 2).astype(np.int64)
    p = int(math.ceil(kwidth)) + 2
    idx = left[:, None] + np.arange(p)[None, :]
    w = _keys_cubic((u[:, None] - idx) * kscale) * kscale
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    # symmetric edge handling
    m = 2 * n_in
    idx_r = idx % m
    idx_r = np.where(idx_r < 0, idx_r + m, idx_r)
    idx_r = np.where(idx_r >= n_in, m - 1 - idx_r, idx_r)
    mtx = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.repeat(np.arange(n_out), p)
    np.add.at(mtx, (rows, idx_r.ravel()), w.ravel())
    return mtx.astype(np.dtype(dtype_name))


def _spatial_axes(img: torch.Tensor):
    """(has a trailing channel axis of size 1/3/4, index of the H axis)."""
    has_c = img.dim() >= 3 and img.shape[-1] in (1, 3, 4)
    return has_c, img.dim() - (3 if has_c else 2)


def resize(img: torch.Tensor, out_shape, antialias: bool = True):
    """Cubic resize of the trailing-2 spatial axes of (..., H, W[, C]).

    NHWC-aware: a trailing channel axis of size 1/3/4 is preserved.
    """
    has_c, h_ax = _spatial_axes(img)
    h_out, w_out = out_shape
    name = str(img.dtype).replace("torch.", "")
    mr = torch.as_tensor(resize_matrix(img.shape[h_ax], h_out, antialias,
                                       name), device=img.device)
    mc = torch.as_tensor(resize_matrix(img.shape[h_ax + 1], w_out, antialias,
                                       name), device=img.device)
    no_tf32(img)
    x = img.movedim((h_ax, h_ax + 1), (-2, -1)) if has_c else img
    out = torch.matmul(torch.matmul(mr, x), mc.T)
    return out.movedim((-2, -1), (h_ax, h_ax + 1)) if has_c else out


def bicubic_degrade(hr: torch.Tensor, scale: int, antialias: bool = True):
    """HR -> LR by 1/scale cubic downsampling (the SR-paper protocol)."""
    _, h_ax = _spatial_axes(hr)
    h, w = hr.shape[h_ax], hr.shape[h_ax + 1]
    if h % scale or w % scale:
        raise ValueError(f"HR dims ({h},{w}) not divisible by scale {scale}")
    return resize(hr, (h // scale, w // scale), antialias)


def bicubic_upsample(lr: torch.Tensor, scale: int):
    """LR -> HR cubic upsampling (no antialias on upsample)."""
    _, h_ax = _spatial_axes(lr)
    h, w = lr.shape[h_ax], lr.shape[h_ax + 1]
    return resize(lr, (h * scale, w * scale))


# ---------------------------------------------------------------------------
# tensor-shift Keys-cubic sampling (burst simulation / registration)
# ---------------------------------------------------------------------------

def _keys_cubic_t(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    ax = torch.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return torch.where(
        ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
        torch.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a,
                    torch.zeros_like(ax)))


def _as_shifts(x: torch.Tensor, shift_yx) -> torch.Tensor:
    return torch.as_tensor(shift_yx, dtype=x.dtype, device=x.device)


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """A per-image scalar ``v[...]`` as ``[..., 1, 1]``, to broadcast
    against an image's leading axes (a 0-d ``v`` stays 0-d)."""
    return v.reshape(v.shape + (1, 1)) if v.dim() else v


def _tap(x: torch.Tensor, start: torch.Tensor, axis: int, pad: int,
         n_out: int, stride: int = 1) -> torch.Tensor:
    """``xp[start + i*stride]`` for ``i < n_out`` along ``axis`` (-2 or -1)
    of ``xp``, ``x`` edge-padded by ``pad``: the reference's
    ``dynamic_slice`` of the padded array, which wraps a negative start
    once (``start + n + 2 * pad``) and then clamps it to ``[0, 2 * pad]``.
    ``start`` is an int64 tensor, one per image of ``x``'s leading axes (or
    one for all)."""
    n = x.shape[axis]
    start = torch.where(start < 0, start + (n + 2 * pad), start)
    start = torch.clamp(start, 0, 2 * pad) - pad
    offs = torch.arange(0, n_out * stride, stride, device=x.device)
    if start.dim() == 0:  # one start for every image: a plain index_select
        return torch.index_select(x, axis, torch.clamp(start + offs, 0,
                                                       n - 1))
    lead = torch.broadcast_shapes(x.shape[:-2], start.shape)
    idx = torch.clamp(start.broadcast_to(lead)[..., None] + offs, 0, n - 1)
    if axis in (-2, x.dim() - 2):
        idx = idx[..., :, None].expand(lead + (n_out, x.shape[-1]))
        return torch.gather(x.expand(lead + x.shape[-2:]), -2, idx)
    idx = idx[..., None, :].expand(lead + (x.shape[-2], n_out))
    return torch.gather(x.expand(lead + x.shape[-2:]), -1, idx)


def _keys_shift_axis(x: torch.Tensor, shift: torch.Tensor, axis: int,
                     pad: int, stride: int = 1) -> torch.Tensor:
    """Shift ``x`` along ``axis`` by ``shift`` (one per image, or one):
    ``out[i] = in[i - shift]``, Keys cubic, nearest boundary,
    |shift| <= pad - 2.  ``stride`` keeps every ``stride``-th output only
    (the same values as slicing the full output)."""
    n = x.shape[axis]
    u = -shift  # sample coordinate offset: out[i] samples in[i + u]
    m = torch.floor(u)
    f = u - m  # fractional part in [0, 1)
    base = m.to(torch.int64) + (pad - 1)  # first tap index in padded array
    n_out = (n + stride - 1) // stride
    out = None
    for j in range(4):
        w = _keys_cubic_t(f - (j - 1)).to(x.dtype)
        tap = _tap(x, base + j, axis, pad, n_out, stride)
        w = _per_image(w)
        out = tap * w if out is None else out + tap * w
    return out


def keys_shift2d(x: torch.Tensor, shift_yx, pad: int = 8,
                 stride: int = 1) -> torch.Tensor:
    """Sub-pixel translate the trailing-2 axes of ``x`` by a tensor
    ``(dy, dx)`` (``shift_yx[..., 2]``: one shift, or one per image of
    ``x``'s leading axes): ``out[y, x] = in[y - dy, x - dx]`` (the
    ``ops.resample.spline_shift`` sign convention), Keys-cubic (a = -0.5)
    interpolation, nearest-edge boundary.  |dy|, |dx| must be <= pad - 2.
    ``stride`` keeps every ``stride``-th row and column of the output (the
    forward model's decimation), computing only those.
    """
    s = _as_shifts(x, shift_yx)
    x = _keys_shift_axis(x, s[..., 0], -2, pad, stride)
    return _keys_shift_axis(x, s[..., 1], -1, pad, stride)


def _keys_phase_window(d: torch.Tensor, factor: int, pad: int):
    """Fractional offset ``d`` -> the shared 5-tap window of all
    ``factor`` phases along one axis: ``(base, [w5 x factor])`` with
    ``out_p[i] = sum_j w5_p[j] * xp[i + base + j]`` on a ``pad``-edge-padded
    axis.  The window is anchored at ``floor(us[0])`` (us ascending,
    ``us[-1] - us[0] < 1``, the polyphase property), so one set of 5 tap
    gathers serves every phase; ``w5_p[j]`` is ``ws[..., p, j]``, one
    weight per element of ``d``."""
    centres = np.array([(p + 0.5) / factor - 0.5 for p in range(factor)])
    us = torch.as_tensor(centres, dtype=d.dtype, device=d.device) - d[..., None]
    b0 = torch.floor(us[..., :1])
    base = b0[..., 0].to(torch.int64) + (pad - 1)
    offs = torch.arange(-1, 4, dtype=d.dtype, device=d.device)
    return base, _keys_cubic_t((us - b0)[..., None] - offs)


def keys_phase_max_shift(pad: int = 6) -> float:
    """Largest |shift| (LR px, per axis) the ``pad``-edge-padded tap window
    of :func:`keys_phase_outputs` supports without clamping.  The clamp of
    the window's start (the reference's ``dynamic_slice`` rule) silently
    mis-registers a shift beyond this bound on the tensor-shift path (the
    static banded and conv paths, 'nearest' extension baked into their
    entries, are unbounded); callers with concrete shifts must validate
    (``sr.fusion.FusionEngine`` does)."""
    return float(pad - 3)


def keys_phase_outputs(lr: torch.Tensor, shift_yx, factor: int,
                       pad: int = 6):
    """The ``factor**2`` polyphase planes of :func:`keys_register_phases`
    as a list of ``(..., h, w)`` tensors in ``p_y * factor + p_x`` order.
    |shift| per axis must stay within :func:`keys_phase_max_shift`
    (``pad - 3`` LR px) or the clamped tap window silently
    mis-registers."""
    s = _as_shifts(lr, shift_yx)
    ny, nx = lr.shape[-2], lr.shape[-1]
    by, wys = _keys_phase_window(s[..., 0], factor, pad)
    bx, wxs = _keys_phase_window(s[..., 1], factor, pad)
    taps = [_tap(lr, by + j, -2, pad, ny) for j in range(5)]
    wys, wxs = wys.to(lr.dtype), wxs.to(lr.dtype)
    outs = []
    for py in range(factor):
        row = sum(_per_image(wys[..., py, j]) * taps[j]
                  for j in range(5))  # (..., ny, nx)
        cols = [_tap(row, bx + k, -1, pad, nx) for k in range(5)]
        for px in range(factor):
            outs.append(sum(_per_image(wxs[..., px, k]) * cols[k]
                            for k in range(5)))
    return outs


def keys_register_phases(lr: torch.Tensor, shift_yx, factor: int,
                         pad: int = 6) -> torch.Tensor:
    """Registered HR-grid resample of an LR frame, computed entirely at LR
    resolution as ``factor**2`` polyphase planes.

    The registered HR image is ``reg[i] = Interp_lr((i + 0.5)/factor - 0.5
    - shift)`` (Keys cubic a = -0.5, the imresize upsample convention of
    :func:`resize_matrix`, composed with a translation by ``shift`` LR px;
    nearest boundary).  Writing ``i = factor*y + p`` splits it into
    ``factor`` phases per axis, each a 4-tap FIR on the LR grid.

    Returns ``(..., h, w, factor*factor)`` with the phase channel ordered
    ``p_y * factor + p_x``, the :func:`~..models.common.pixel_shuffle`
    layout, so ``pixel_shuffle(phases, factor)`` is the registered HR image
    (:func:`phases_to_hr`).
    """
    return torch.stack(keys_phase_outputs(lr, shift_yx, factor, pad),
                       dim=-1)


def phases_to_hr(phases: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., h, w, f*f) polyphase planes -> (..., h*f, w*f) HR image."""
    from ..models.common import pixel_shuffle

    return pixel_shuffle(phases, factor)[..., 0]
