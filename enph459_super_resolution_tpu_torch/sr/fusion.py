"""Burst (multi-frame) fusion SR: registration, simulation, inference.

Counterpart of ``enph459_super_resolution_tpu/sr/fusion.py``.  The
reference's task is multi-frame SR from sub-pixel-shifted bursts
(``mono_barcodes/run_sr.py:212-240`` solves it classically with SAA + IBP);
this module is the learned counterpart's data path:

  * :func:`simulate_burst` -- the blur -> shift -> decimate forward model
    with shifts as tensors (fresh shift jitter and sensor noise every
    training batch) and differentiable end to end.
  * :func:`register_burst` / :func:`register_burst_phases` -- align then
    fuse: each frame resampled onto the HR grid (or its polyphase planes on
    the LR grid) with the known shifts; the network learns what IBP cannot
    express (joint deconvolution, denoising, robustness to residual
    misregistration).  For static shifts the polyphase registration is a
    pair of 5-tap banded operators per frame (:func:`build_register_phase_ops`,
    the banded-row kernel K1 on the card) or one small conv
    (:func:`build_register_phase_conv`, what serving uses).
  * :func:`fuse`, :func:`data_consistency_refine` and
    :class:`FusionEngine`, the product surface of ``sr.run --fusion-run``.

Shapes: a burst is ``[..., N, h, w]`` with shifts ``[..., N, 2]`` (one
burst, or a batch of bursts with their own shifts as one op).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32, resolve_device
from ..ops.conv import conv2d_same
from ..ops.resample import spline_zoom
from ..ops.resize import (_as_shifts, _keys_cubic, keys_phase_outputs,
                          keys_shift2d)

#: The reference's hardcoded 4-corner nominal shift pattern, LR px
#: (``mono_barcodes/run_sr.py:71-77``).
NOMINAL_SHIFTS_4 = ((0.5, 0.5), (0.5, -0.5), (-0.5, 0.5), (-0.5, -0.5))


def register_burst(lr_stack: torch.Tensor, shifts_yx, factor: int):
    """LR burst -> HR-grid registered stack.

    ``f32[..., N, h, w]`` frames and ``[..., N, 2]`` LR-pixel ``(dy, dx)``
    shifts -> ``f32[..., h*factor, w*factor, N]``: each channel one frame
    cubic-spline upsampled and translated into registration (the per-frame
    terms of shift-and-add, kept apart for a network to fuse).
    """
    shifts = _as_shifts(lr_stack, shifts_yx)
    up = spline_zoom(lr_stack, factor)
    return torch.movedim(keys_shift2d(up, shifts * factor), -3, -1)


def register_burst_phases(lr_stack: torch.Tensor, shifts_yx, factor: int):
    """LR burst -> polyphase registered stack, computed entirely at LR.

    ``f32[..., N, h, w]`` + ``[..., N, 2]`` -> ``f32[..., h, w,
    N * factor^2]``: each frame's Keys-cubic registered HR image packed as
    ``factor^2`` LR-grid phase channels (frame-major, phase order the
    ``pixel_shuffle`` layout; ``ops.resize.keys_register_phases``), the
    input of :class:`~..models.zoo.BurstFusionLR`.
    """
    planes = keys_phase_outputs(lr_stack, _as_shifts(lr_stack, shifts_yx),
                                factor)  # ff x [..., N, h, w], all frames
    out = torch.movedim(torch.stack(planes, dim=-1), -4, -2)
    return out.reshape(out.shape[:-2] + (-1,))  # frame-major channels


#: model name -> registration function (the train/serve featurization
#: contract; recorded in each run's config.json as ``model``)
REGISTER_FNS = {
    "burstfusion": register_burst,
    "burstfusion_lr": register_burst_phases,
}


def _keys_phase_taps_np(d: float, factor: int):
    """Host twin of :func:`~..ops.resize._keys_phase_window` for a static
    shift: ``(b0:int, w[factor, 5] f64)`` with
    ``out_p[i] = sum_j w[p, j] * lr[clip(i + b0 - 1 + j)]``."""
    us = [(p + 0.5) / factor - 0.5 - float(d) for p in range(factor)]
    b0 = int(np.floor(us[0]))
    w = np.stack([
        _keys_cubic(np.array([u - b0 - (j - 1) for j in range(5)]))
        for u in us])
    return b0, w


def build_register_phase_ops(shifts_yx, h: int, w: int, factor: int,
                             device="cuda"):
    """Static shifts -> banded registration operators on ``device``, one
    ``(row_ops[factor], col_ops[factor])`` pair per frame: the Keys-cubic
    polyphase registration as 5-tap banded matrices per frame and axis.
    Their row applies run the banded-row kernel K1 on the card.  Entries
    match :func:`register_burst_phases` to f32 tolerance (the same taps,
    another summation order)."""
    from ..ops.opmatrix import BandedOp, band_from_kernel

    device = resolve_device(device) if isinstance(device, str) else device
    ops = []
    for s in np.asarray(shifts_yx, np.float64):
        by, wy = _keys_phase_taps_np(s[0], factor)
        bx, wx = _keys_phase_taps_np(s[1], factor)
        rows = tuple(
            BandedOp.from_banded(
                band_from_kernel(h, h, wy[p], by - 1, "nearest")).to(device)
            for p in range(factor))
        cols = tuple(
            BandedOp.from_banded(
                band_from_kernel(w, w, wx[p], bx - 1, "nearest")).to(device)
            for p in range(factor))
        ops.append((rows, cols))
    return tuple(ops)


def register_burst_phases_banded(lr_stack: torch.Tensor, reg_ops,
                                 plain: bool = False):
    """:func:`register_burst_phases` of one burst ``f32[N, h, w]`` on
    prebuilt static-shift banded operators
    (:func:`build_register_phase_ops`).  ``plain`` runs the row applies'
    plain version on any device."""
    outs = []
    for n, (rows, cols) in enumerate(reg_ops):
        fr = lr_stack[n]
        for rop in rows:
            y = rop.row_apply(fr, plain=plain)
            for cop in cols:
                outs.append(cop.col_apply(y))
    return torch.stack(outs, dim=-1)


def build_register_phase_conv(shifts_yx, factor: int, device="cuda"):
    """Static shifts -> the whole polyphase registration as one small conv
    from N in-channels (frames) to ``N * factor^2`` out-channels (phases,
    frame-major), block-diagonal over frames: each frame's phase plane is a
    separable 5x5 window-anchored stencil on that frame alone.

    Boundary: the Keys registration's 'nearest' index clamp is
    edge-replicate padding, so :class:`RegisterConv` pads with ``replicate``
    and convolves VALID -- exact at every pixel, the image edges included.
    """
    shifts = np.asarray(shifts_yx, np.float64)
    n = len(shifts)
    ff = factor * factor
    taps = [(_keys_phase_taps_np(s[0], factor),
             _keys_phase_taps_np(s[1], factor)) for s in shifts]
    lo_y = min(by - 1 for (by, _), _ in taps)
    hi_y = max(by + 3 for (by, _), _ in taps)
    lo_x = min(bx - 1 for _, (bx, _) in taps)
    hi_x = max(bx + 3 for _, (bx, _) in taps)
    kernel = np.zeros((hi_y - lo_y + 1, hi_x - lo_x + 1, n, n * ff),
                      np.float64)
    for i, ((by, wy), (bx, wx)) in enumerate(taps):
        for py in range(factor):
            for px in range(factor):
                out_c = i * ff + py * factor + px
                ky = by - 1 - lo_y
                kx = bx - 1 - lo_x
                kernel[ky:ky + 5, kx:kx + 5, i, out_c] = np.outer(
                    wy[py], wx[px])
    device = resolve_device(device) if isinstance(device, str) else device
    return RegisterConv(torch.as_tensor(kernel.astype(np.float32),
                                        device=device),
                        (-lo_y, hi_y), (-lo_x, hi_x))


class RegisterConv:
    """Polyphase registration as one conv (see
    :func:`build_register_phase_conv`).  Calling it is the registration:
    ``f32[N, h, w]`` or ``f32[B, N, h, w]`` -> ``f32[h, w, N*ff]`` /
    ``f32[B, h, w, N*ff]``.  ``kernel`` is HWIO, as the reference's."""

    def __init__(self, kernel: torch.Tensor, pads_y, pads_x):
        self.kernel = kernel
        self.weight = kernel.permute(3, 2, 0, 1).contiguous()  # OIHW
        self.pads_y = tuple(int(p) for p in pads_y)
        self.pads_x = tuple(int(p) for p in pads_x)

    def __call__(self, lr_stack: torch.Tensor) -> torch.Tensor:
        squeeze = lr_stack.dim() == 3
        x = lr_stack[None] if squeeze else lr_stack  # (B, N, h, w): NCHW
        no_tf32(x)
        x = F.pad(x, self.pads_x + self.pads_y, mode="replicate")
        out = F.conv2d(x, self.weight.to(x.dtype)).permute(0, 2, 3, 1)
        return out[0] if squeeze else out


def simulate_burst(hr: torch.Tensor, shifts_yx, psf, factor: int,
                   noise_sigma: float = 0.0, generator=None, noise=None):
    """HR scene ``[..., H, W]`` -> LR burst ``[..., N, H/f, W/f]`` via the
    classical forward model.

    blur (PSF) -> translate by ``shift * factor`` HR px (shifts
    ``[..., N, 2]``) -> decimate ``[::factor]`` (only the kept samples are
    computed) -> additive Gaussian read noise, clipped to the sensor's
    0..255 range.  The noise is ``noise_sigma * noise`` with ``noise`` a
    standard-normal tensor of the burst's shape, given or drawn from
    ``generator``; with neither, no noise.
    """
    blurred = conv2d_same(hr, psf)
    shifts = _as_shifts(hr, shifts_yx)
    lr = keys_shift2d(blurred.unsqueeze(-3), shifts * factor, stride=factor)
    if noise is None and generator is not None:
        noise = torch.randn(lr.shape, generator=generator, device=lr.device,
                            dtype=lr.dtype)
    if noise is not None:
        lr = lr + noise_sigma * noise
    return torch.clamp(lr, 0.0, 255.0)


def fuse(model, lr_stack: torch.Tensor, shifts_yx, factor: int,
         register=register_burst) -> torch.Tensor:
    """Full-image burst fusion: register, run the net, clip to range.

    ``register`` produces the net's input stack and must match the
    architecture the run was trained with (:data:`REGISTER_FNS`).  Either
    way the model returns ``sr[B, H, W, 1]``; this returns ``sr[H, W]``.
    """
    stack = register(lr_stack, shifts_yx, factor)
    sr = model(stack[None])[0, ..., 0]
    return torch.clamp(sr, 0.0, 255.0)


def data_consistency_refine(hr: torch.Tensor, lr_stack: torch.Tensor,
                            shifts, psf, factor: int, n_iter: int,
                            step: float = 2.0, clip=(0.0, 255.0)):
    """Landweber data-consistency iterations under the Keys-cubic forward
    model: ``hr += step * A^T(lr - A hr) / n_frames`` with the true adjoint
    ``A^T`` from ``torch.func.vjp``, clipped.  Step 2.0 is spectrally
    stable (the blur + decimate operator has norm below 1)."""
    shifts = _as_shifts(lr_stack, shifts)
    n = lr_stack.shape[0]

    def fwd(h):
        return simulate_burst(h, shifts, psf, factor)

    for _ in range(int(n_iter)):
        sim, vjp_fn = torch.func.vjp(fwd, hr)
        corr, = vjp_fn(lr_stack - sim)
        hr = torch.clamp(hr + step * corr / n, clip[0], clip[1])
    return hr


def _lru_get(cache: OrderedDict, key, cap: int, make):
    """``cache[key]``, made by ``make()`` on a miss; the least recently used
    entry goes once ``cap`` is reached."""
    if key in cache:
        cache.move_to_end(key)
    else:
        while len(cache) >= cap:
            cache.popitem(last=False)
        cache[key] = make()
    return cache[key]


class FusionEngine:
    """The learned burst engine as a product surface
    (``sr.run --fusion-run <dir>``).

    Registers a unit's frames with its calibrated shifts, runs the trained
    net (its EMA weights) and scores the result against the burst under the
    blur -> shift -> decimate forward model the classical IBP minimises, so
    ``metrics.json`` reports the learned and classical engines side by
    side.  Everything lives on ``device`` (``"cuda"`` by default, no
    fallback).

    ``refine=N`` appends N true-adjoint Landweber iterations seeded from
    the net's output (``hr += step * A^T(lr - A hr) / n_frames``, clipped),
    which regains the classical forward-model fit.  ``refine_engine``:
    ``"banded"`` (default) runs them as the port's
    :func:`~.classical.landweber_refine` on the banded adjoint operators
    (the banded-row kernel K1 on the card; its forward model is the
    scipy-exact B-spline one, so ``forward_mse`` is comparable with the
    classical ``final_mse``); ``"vjp"`` runs :func:`data_consistency_refine`
    on the Keys-cubic model.

    ``dtype="bf16"`` runs the trunk's convs in bfloat16 (weights stay
    float32; the residual is added to the float32 base in float32).
    Registration and refinement stay float32.  ``static_register`` (the LR
    arch only) bakes each shift set into a :class:`RegisterConv`; without
    it the LR arch registers with the tensor-shift path, which refuses
    shifts beyond :func:`~..ops.resize.keys_phase_max_shift`.

    A bounded LRU cache holds the per-shift-set registration convs
    (cap 8), so serving with per-unit-varying shifts does not grow without
    bound.
    """

    def __init__(self, run_dir: str, psf=None, refine: int = 0,
                 refine_step: float = 2.0, dtype: str = "f32",
                 refine_engine: str = "banded",
                 static_register: bool = True, device="cuda"):
        from ..train.burst import load_burst_run

        dtypes = {"f32": torch.float32, "float32": torch.float32,
                  "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}
        if dtype not in dtypes:
            raise ValueError(f"dtype must be f32 or bf16, got {dtype!r}")
        if refine_engine not in ("banded", "vjp"):
            raise ValueError(f"refine_engine must be 'banded' or 'vjp', "
                             f"got {refine_engine!r}")
        if refine < 0:
            raise ValueError(f"refine must be >= 0, got {refine}")
        self.device = (resolve_device(device) if isinstance(device, str)
                       else device)
        self.model, self.cfg = load_burst_run(run_dir, dtype=dtypes[dtype],
                                              device=self.device)
        self.register = REGISTER_FNS[self.cfg.get("model", "burstfusion")]
        self.run_dir = run_dir
        self.n_frames = int(self.cfg["frames"])
        self.factor = int(self.cfg["factor"])
        self.dtype = dtypes[dtype]
        self.refine = int(refine)
        self.refine_step = float(refine_step)
        self.refine_engine = refine_engine
        self._psf = psf
        # only the LR (polyphase) arch has a static one-conv twin
        self.static_register = (static_register and
                                self.register is register_burst_phases)
        self._reg_ops: OrderedDict = OrderedDict()  # shifts -> RegisterConv
        self._reg_ops_cap = 8

    def check(self, n_frames: int, factor: int) -> None:
        if (n_frames, factor) != (self.n_frames, self.factor):
            raise ValueError(
                f"fusion run {self.run_dir} was trained for "
                f"{self.n_frames} frames at x{self.factor}; workload has "
                f"{n_frames} frames at x{factor}")

    def register_stack(self, lr_stack: torch.Tensor, shifts_yx):
        """The net's input for one burst on the device: the cached
        one-conv registration of these static shifts, or the tensor-shift
        registration (refused past its tap window for the LR arch)."""
        s_np = np.asarray(shifts_yx, np.float64)
        if self.static_register:
            conv = _lru_get(self._reg_ops, s_np.tobytes(), self._reg_ops_cap,
                            lambda: build_register_phase_conv(
                                s_np, self.factor, self.device))
            return conv(lr_stack)
        if self.register is register_burst_phases:
            from ..ops.resize import keys_phase_max_shift

            bound = keys_phase_max_shift()
            worst = float(np.max(np.abs(s_np)))
            if worst > bound:
                raise ValueError(
                    f"|shift| {worst:.2f} LR px exceeds the tensor-shift "
                    f"registration's tap-window bound ({bound:.0f}); use "
                    f"static_register (one conv, unbounded) for such units")
        return self.register(lr_stack, s_np.astype(np.float32), self.factor)

    @torch.no_grad()
    def net(self, stack: torch.Tensor) -> torch.Tensor:
        """The trained net on a registered stack, clipped: ``sr[H, W]``."""
        return torch.clamp(self.model(stack[None])[0, ..., 0], 0.0, 255.0)

    @torch.no_grad()
    def _mse(self, hr, lr_stack, shifts, psf: np.ndarray) -> float:
        """The Keys-cubic forward model's mean squared residual."""
        sim = simulate_burst(hr, shifts, psf, self.factor)
        return float(torch.mean((lr_stack - sim) ** 2))

    def __call__(self, lr_stack, shifts_yx, psf=None):
        """``[N, h, w]`` burst + N ``(dy, dx)`` shifts ->
        ``(sr, forward_mse, forward_mse_raw)``: ``sr`` as float32 numpy on
        the host, the two MSEs as floats.

        ``forward_mse`` is the mean squared residual of re-imaging the
        (refined, when ``refine > 0``) estimate through the forward model:
        with the banded refine engine the ``final_mse`` of
        :func:`~.classical.landweber_refine` (the classical engine's
        scipy-exact operators), otherwise the Keys-cubic model's.
        ``forward_mse_raw`` is that of the net's output before refinement
        (equal to ``forward_mse`` at ``refine=0``).
        """
        lr = torch.as_tensor(lr_stack, dtype=torch.float32).to(self.device)
        # only the frame count is knowable here; the workload factor is
        # checked by the caller through check() (sr.run and process_unit)
        if int(lr.shape[0]) != self.n_frames:
            raise ValueError(
                f"fusion run {self.run_dir} was trained for "
                f"{self.n_frames} frames; burst has {lr.shape[0]}")
        psf = self._psf if psf is None else psf
        psf_np = np.asarray(psf, np.float32)
        shifts = _as_shifts(lr, shifts_yx)
        sr = self.net(self.register_stack(lr, shifts_yx))
        mse_raw = mse = self._mse(sr, lr, shifts, psf_np)
        if self.refine > 0 and self.refine_engine == "vjp":
            sr = data_consistency_refine(sr, lr, shifts, psf_np, self.factor,
                                         self.refine, self.refine_step)
            mse = self._mse(sr, lr, shifts, psf_np)
        if self.refine > 0 and self.refine_engine == "banded":
            from .classical import landweber_refine

            sr, _, mse = landweber_refine(
                sr, lr, psf,
                tuple(map(tuple, np.asarray(shifts_yx, np.float64))),
                factor=self.factor, n_iter=self.refine,
                step=self.refine_step, device=self.device)
            return sr, mse, mse_raw
        return sr.cpu().numpy(), mse, mse_raw
