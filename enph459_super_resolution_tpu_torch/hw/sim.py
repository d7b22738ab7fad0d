"""Physics simulator implementing the hardware protocols.

The port's counterpart of ``enph459_super_resolution_tpu/hw/sim.py``.  The
reference can only run against its optical bench; this simulator makes
every layer above L1 (calibration, collection, SR, analysis) hermetically
testable (SURVEY.md §4 implication).  The model, parameterized by the
reference's own calibration numbers (BASELINE.md):

  * beam steering: pixel shift = ``gain_px_per_deg * tilt`` per axis plus
    Gaussian jitter whose sigma grows when the commanded settle time is
    below the mechanical time constant (reproducing the settle-time sweep
    and rolling-stability experiments);
  * camera: LR frames rendered from a HR ground-truth scene through the
    classical forward model (PSF blur, sub-pixel shift, decimation — the
    same ops the SR solver inverts), exposure-scaled brightness, optional
    RGGB mosaic for color mode, shot/read noise, uint8 quantization;
  * trigger plumbing: hardware-trigger captures require a GPIO pulse since
    the last frame, mirroring the XPR GPIO0 -> camera Line2 wiring.

The blur, the spline prefilter and the render run on the rig's ``device``
(CUDA unless the caller asks for the CPU); the noise, the mosaic and the
quantization stay host numpy, drawn from the same ``default_rng(seed)``
stream in the same order as the reference, so a port frame differs from
the reference's only by the float32 rounding of the render before the
uint8 truncation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..sr.classical import make_gaussian_psf


def pinhole_scene(shape=(1536 * 2, 2048 * 2), spot_sigma_px: float = 1.4,
                  amplitude: float = 235.0, background: float = 2.0,
                  center=None) -> np.ndarray:
    """HR ground truth for calibration sims: a backlit pinhole (Gaussian
    spot), like the 5 um pinhole in the reference rig."""
    h, w = shape
    cy, cx = center if center is not None else (h / 2.0, w / 2.0)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = background + amplitude * np.exp(
        -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * spot_sigma_px ** 2))
    return img


def knife_edge_scene(shape=(1024, 1280), edge_col: float = 640.0,
                     lo: float = 20.0, hi: float = 220.0) -> np.ndarray:
    """HR ground truth for stability sims: a vertical knife edge."""
    h, w = shape
    xx = np.arange(w, dtype=np.float64)
    row = np.where(xx < edge_col, hi, lo)
    return np.broadcast_to(row, (h, w)).copy()


@dataclasses.dataclass
class SimConfig:
    """Physical model parameters (defaults from the reference calibration:
    ~0.9 px shift at 0.28 deg tilt -> gain ~3.2 px/deg; jitter sigma a few
    1e-3 px when settled, see BASELINE.md rows 5-8).

    Fault injection (SURVEY.md §5: the reference has none; the rebuild uses
    it to exercise every retry/fallback path): ``fault_frame_timeout_rate``
    makes ``capture_raw`` raise TimeoutError stochastically;
    ``fault_empty_burst`` makes the next N ``stream_burst`` calls return
    zero frames (the failure rolling_stability retries on).
    """

    gain_px_per_deg: float = 3.2
    jitter_sigma_px: float = 0.005
    unsettled_jitter_px: float = 0.15
    settle_tau_ms: float = 8.0
    psf_sigma_px: float = 1.0
    psf_size: int = 7
    read_noise: float = 0.8
    shot_noise_scale: float = 0.02
    base_exposure_us: float = 10000.0
    color: bool = False
    lr_shape: Tuple[int, int] = (1536, 2048)
    factor: int = 2  # HR scene super-sampling vs the sensor grid
    seed: int = 0
    fault_frame_timeout_rate: float = 0.0
    fault_empty_burst: int = 0


def spline_tap_weights(d: np.float32) -> Tuple[int, np.ndarray]:
    """Base offset ``m = floor(-d)`` and the 4 cubic B-spline weights of
    ``out(i) = scene(i - d)`` at ``t = -d - m``, in float32 as the
    reference's render computes them (``w2`` closes the partition of
    unity)."""
    f32 = np.float32
    s = -f32(d)
    m = np.floor(s)
    t = s - m
    omt = f32(1.0) - t
    w0 = omt * omt * omt / f32(6.0)
    w1 = f32(2.0 / 3.0) - t * t + f32(0.5) * t * t * t
    w3 = t * t * t / f32(6.0)
    w2 = f32(1.0) - (w0 + w1 + w3)
    return int(m), np.array([w0, w1, w2, w3], dtype=np.float32)


def render_shifted(coeff_padded: torch.Tensor, dy_hr, dx_hr, pad: int,
                   factor: int) -> torch.Tensor:
    """Sample the prefiltered, edge-padded HR scene at a sub-pixel shift
    (``dy_hr``, ``dx_hr`` in HR px, float32) and decimate to the sensor
    grid: the reference's 16-tap sum ``acc + wy[i] * wx[j] * tap`` in the
    same order, evaluated only at the kept rows and columns (``[::factor]``
    of each tap), which is the same arithmetic per output pixel."""
    h_pad, w_pad = coeff_padded.shape
    h_hr, w_hr = h_pad - 2 * pad, w_pad - 2 * pad
    my, wy = spline_tap_weights(dy_hr)
    mx, wx = spline_tap_weights(dx_hr)
    weights = torch.as_tensor(wy[:, None] * wx[None, :],
                              device=coeff_padded.device)
    acc = None
    for i in range(4):
        r0 = pad + my + i - 1
        for j in range(4):
            c0 = pad + mx + j - 1
            term = weights[i, j] * coeff_padded[r0:r0 + h_hr:factor,
                                                c0:c0 + w_hr:factor]
            acc = term if acc is None else acc + term
    return acc


class SimulatedRig:
    """One shared physical state: mirror angles + trigger + clock.

    ``device`` (default ``"cuda"``, raising without a card) holds the
    prefiltered scene and runs each frame's render."""

    def __init__(self, scene: Optional[np.ndarray] = None,
                 config: Optional[SimConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = config or SimConfig()
        h, w = self.cfg.lr_shape
        if scene is None:
            scene = pinhole_scene((h * self.cfg.factor, w * self.cfg.factor))
        self.scene = np.asarray(scene, dtype=np.float32)
        want = (h * self.cfg.factor, w * self.cfg.factor)
        if self.scene.shape != want:
            raise ValueError(
                f"scene shape {self.scene.shape} must be lr_shape x factor "
                f"= {want}")
        self.rng = np.random.default_rng(self.cfg.seed)
        self.angles = (0.0, 0.0)
        self.settled_ms = 1e9  # time since last move (starts settled)
        self.pending_trigger = False
        self._psf = make_gaussian_psf(self.cfg.psf_size, self.cfg.psf_sigma_px)
        self._coeff = None  # prefiltered blurred scene (lazy, per PSF)

    # -- time model: orchestrators call sleep() through the rig ------------
    def sleep(self, seconds: float) -> None:
        self.settled_ms += seconds * 1000.0

    def shift_px(self) -> Tuple[float, float]:
        """Current optical (dy, dx) in sensor px incl. settling jitter."""
        ax, ay = self.angles
        g = self.cfg.gain_px_per_deg
        jitter = self.cfg.jitter_sigma_px + self.cfg.unsettled_jitter_px * \
            np.exp(-self.settled_ms / self.cfg.settle_tau_ms)
        dy = g * ay + self.rng.normal(0, jitter)
        dx = g * ax + self.rng.normal(0, jitter)
        return dy, dx

    _PAD = 8  # spline taps + max supported |shift| on the HR grid

    def _prefiltered(self) -> torch.Tensor:
        """Blur + spline-prefilter the scene once per PSF (edge-padded), on
        the rig's device."""
        from ..ops.conv import conv2d_same, pad_axis
        from ..ops.resample import spline_coefficients

        if self._coeff is None:
            scene = torch.as_tensor(self.scene, device=self.device)
            blurred = conv2d_same(scene, self._psf)
            coeff = spline_coefficients(blurred, mode="nearest")
            pad = self._PAD
            for axis in (0, 1):
                coeff = pad_axis(coeff, axis, pad, pad, "edge")
            self._coeff = coeff
        return self._coeff

    def render(self, exposure_us: float) -> np.ndarray:
        """Render one sensor frame at the current mirror state."""
        dy, dx = self.shift_px()
        f = self.cfg.factor
        if max(abs(dy), abs(dx)) * f > self._PAD - 3:
            raise ValueError(f"simulated shift ({dy:.2f},{dx:.2f}) px "
                             f"exceeds the rig's supported range")
        lr = render_shifted(self._prefiltered(), np.float32(dy * f),
                            np.float32(dx * f), self._PAD, f).cpu().numpy()

        gain = exposure_us / self.cfg.base_exposure_us
        lr = lr * gain
        if self.cfg.color:
            # RGGB mosaic from the gray scene: per-site channel gains so the
            # red plane (``img[0::2, 0::2]``, reference extract_red) carries
            # the scene and the interleaved G/B sites differ realistically
            h, w = lr.shape
            gains = np.empty((h, w))
            gains[0::2, 0::2] = 1.0   # R
            gains[0::2, 1::2] = 0.85  # G
            gains[1::2, 0::2] = 0.85  # G
            gains[1::2, 1::2] = 0.65  # B
            lr = lr * gains
        noise = self.rng.normal(0, self.cfg.read_noise, lr.shape) + \
            self.rng.normal(0, 1.0, lr.shape) * np.sqrt(
                np.maximum(lr, 0)) * self.cfg.shot_noise_scale
        return np.clip(lr + noise, 0, 255).astype(np.uint8)


class SimBeamSteering:
    """``BeamSteering`` protocol backend over a :class:`SimulatedRig`."""

    def __init__(self, rig: SimulatedRig):
        self.rig = rig
        self.trigger_configured = False

    def set_angles(self, x_deg: float, y_deg: float) -> None:
        self.rig.angles = (float(x_deg), float(y_deg))
        self.rig.settled_ms = 0.0

    def set_home(self) -> None:
        self.set_angles(0.0, 0.0)

    def setup_trigger_output(self) -> None:
        self.trigger_configured = True

    def send_trigger_pulse(self, width_us: float = 100.0) -> None:
        if not self.trigger_configured:
            raise RuntimeError("trigger output not configured "
                               "(call setup_trigger_output first)")
        self.rig.pending_trigger = True

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SimCamera:
    """``Camera`` protocol backend over a :class:`SimulatedRig`."""

    def __init__(self, rig: SimulatedRig, hardware_trigger: bool = False,
                 trigger_line: str = "line2"):
        self.rig = rig
        self.hardware_trigger = hardware_trigger
        self.trigger_line = trigger_line
        self.exposure = rig.cfg.base_exposure_us
        self.gain = 0.0
        self._closed = False

    @property
    def is_color(self) -> bool:
        return self.rig.cfg.color

    @property
    def width(self) -> int:
        return self.rig.cfg.lr_shape[1]

    @property
    def height(self) -> int:
        return self.rig.cfg.lr_shape[0]

    def capture_raw(self) -> np.ndarray:
        if self._closed:
            raise RuntimeError("camera closed")
        if self.rig.cfg.fault_frame_timeout_rate > 0 and \
                self.rig.rng.uniform() < self.rig.cfg.fault_frame_timeout_rate:
            raise TimeoutError("camera frame timeout (injected fault)")
        if self.hardware_trigger:
            if not self.rig.pending_trigger:
                raise TimeoutError(
                    "hardware-trigger capture timed out: no GPIO pulse "
                    "received since the last frame")
            self.rig.pending_trigger = False
        return self.rig.render(self.exposure)

    def auto_exposure(self, target_peak: float = 200.0) -> float:
        """One-shot auto exposure: scale so the frame peak hits the target
        (reference ``daheng_camera.py:93-98``)."""
        frame = self.rig.render(self.exposure).astype(np.float64)
        peak = max(frame.max(), 1.0)
        self.exposure = float(np.clip(
            self.exposure * target_peak / peak, 10.0, 1e6))
        return self.exposure

    def stream_burst(self, n_frames: int, callback=None):
        """Max-FPS burst (reference ``allied_vision_camera.py:90-115``)."""
        if self.rig.cfg.fault_empty_burst > 0:
            self.rig.cfg.fault_empty_burst -= 1
            return [], []
        frames, stamps = [], []
        period_ms = max(self.exposure / 1000.0, 1.0)
        for i in range(n_frames):
            self.rig.sleep(period_ms / 1000.0)
            frame = self.rig.render(self.exposure)
            frames.append(frame)
            stamps.append(i * period_ms)
            if callback is not None:
                callback(frame, stamps[-1])
        return frames, stamps

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SimStage:
    """``Stage`` protocol backend: focus quality peaks at ``best_pos_mm``.

    The rendered frame's blur grows with defocus, so the autofocus sweep's
    Laplacian-variance metric reproduces the reference's focus curve
    (``calibration_autofocus/data/autofocus_data.json``: best 369.23 mm).
    A move writes the rig's ``_psf`` and drops its prefiltered scene
    (``_coeff = None``), which the next frame rebuilds on the rig's device.
    """

    def __init__(self, rig: SimulatedRig, best_pos_mm: float = 369.23,
                 depth_of_focus_mm: float = 3.0,
                 travel=(340.0, 400.0)):
        self.rig = rig
        self.best = best_pos_mm
        self.dof = depth_of_focus_mm
        self.travel = travel
        self._pos = travel[0]
        # apply the initial position's defocus (a freshly-homed stage is
        # out of focus; the first frame must show it)
        self.move_absolute(self._pos)

    def _blur(self) -> float:
        return abs(self._pos - self.best) / self.dof

    def move_absolute(self, position_mm: float) -> None:
        if not (self.travel[0] <= position_mm <= self.travel[1]):
            raise ValueError(f"position {position_mm} outside soft limits "
                             f"{self.travel}")
        self._pos = float(position_mm)
        # widen the rig PSF with defocus; invalidate the prefiltered scene
        sigma = np.sqrt(self.rig.cfg.psf_sigma_px ** 2 + self._blur() ** 2)
        self.rig._psf = make_gaussian_psf(
            max(self.rig.cfg.psf_size,
                int(2 * np.ceil(3 * sigma) + 1)), sigma)
        self.rig._coeff = None

    def get_position(self) -> float:
        return self._pos

    def home(self) -> None:
        self.move_absolute(self.travel[0])


class SimStage3Axis:
    """Sim twin of the 3-axis rig (:class:`~.real.ZaberStage`): lockstep-X
    gantry + Y/Z axes, focus axis by name (reference
    ``calibration_autofocus/calibrate_autofocus.py:455-496``; the GUI's
    axis combo defaults to Z, ``:390-392``).

    Only the ``focus_axis`` affects the rendered frames (it drives the
    :class:`SimStage` defocus model); X/Y track positions and enforce
    their own soft limits like the real gantry.  X is a lockstep pair —
    both simulated motors move together and :attr:`lockstep_positions`
    exposes them for drift tests.
    """

    def __init__(self, rig: SimulatedRig, best_pos_mm: float = 369.23,
                 depth_of_focus_mm: float = 3.0, focus_axis: str = "Z",
                 limits=None):
        if focus_axis not in ("X", "Y", "Z"):
            raise ValueError(f"focus_axis must be X/Y/Z, got {focus_axis!r}")
        self.focus_axis = focus_axis
        self.limits = dict(limits or {"X": (0.0, 600.0), "Y": (0.0, 100.0),
                                      "Z": (340.0, 400.0)})
        self._focus = SimStage(rig, best_pos_mm, depth_of_focus_mm,
                               travel=self.limits[focus_axis])
        self._pos = {name: lo for name, (lo, hi) in self.limits.items()}
        self._pos[focus_axis] = self._focus.get_position()
        self._x_motors = [self._pos["X"], self._pos["X"]]  # lockstep pair

    @property
    def axes(self):
        return sorted(self._pos)

    @property
    def lockstep_positions(self):
        return tuple(self._x_motors)

    def move_axis(self, name: str, position_mm: float) -> None:
        lo, hi = self.limits[name]
        if not (lo <= position_mm <= hi):
            raise ValueError(f"axis {name}: position {position_mm} outside "
                             f"soft limits ({lo}, {hi})")
        if name == self.focus_axis:
            self._focus.move_absolute(position_mm)
        self._pos[name] = float(position_mm)
        if name == "X":
            self._x_motors = [float(position_mm)] * 2

    def axis_position(self, name: str) -> float:
        return self._pos[name]

    def home_axis(self, name: str) -> None:
        self.move_axis(name, self.limits[name][0])

    # Stage protocol: drives the focus axis
    def move_absolute(self, position_mm: float) -> None:
        self.move_axis(self.focus_axis, position_mm)

    def get_position(self) -> float:
        return self._pos[self.focus_axis]

    def home(self) -> None:
        self.home_axis(self.focus_axis)
