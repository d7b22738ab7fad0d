"""Real hardware backends over the vendor SDKs (optional imports).

Implements the protocols in ``hw.protocols`` against the same devices the
reference drives (SURVEY.md §2 items 2-4): Daheng camera (gxipy), Allied
Vision camera (VmbPy), Optotune XPR-4C tilt mirror (optoICC +
optoControllerToolbox), and Zaber linear stages.  None of these SDKs ship
in this repo or environment — each backend imports lazily and raises a
clear error naming the missing wheel, so the simulator remains the default
everywhere else.

Behavioral contracts replicated from the reference wrappers:
  * DahengCamera: open-by-serial or first device, SW/HW trigger with
    rising-edge line selection, capture timeout = exposure + 2 s, one-shot
    auto exposure, auto white balance, Bayer detection
    (``api/daheng_camera.py``).
  * AlliedCamera: GENTL path bootstrap, Mono8, single capture +
    ``stream_burst`` max-FPS callback streaming with lock/event and
    relative-ms timestamps (``api/allied_vision_camera.py``).
  * XPRController: connect + reset + go_pro, both channels StaticInput/
    UNITLESS, SmartFilters with 1.5 ms transition, batched ``set_angles``,
    GPIO0 trigger output + us pulse (``api/xpr_controller.py``).
  * ZaberStage: serial connect, 3-axis rig — lockstep-X gantry (fallback
    plain axis 1) + Y (axis 3) / Z (axis 4), per-axis soft limits from
    device settings, named-axis moves, Stage-protocol focus axis
    (``calibration_autofocus/calibrate_autofocus.py:455-496``).

The port's copy of ``enph459_super_resolution_tpu/hw/real.py``: host code,
no device op.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .protocols import TRIGGER_LINE2


def _need(pkg: str, hint: str):
    raise ImportError(
        f"the '{pkg}' SDK is required for this hardware backend ({hint}); "
        f"install the vendor wheel or use the simulator (hw.sim)")


class DahengCamera:
    """Daheng Galaxy camera via gxipy."""

    def __init__(self, serial: Optional[str] = None,
                 hardware_trigger: bool = False,
                 trigger_line: str = TRIGGER_LINE2):
        try:
            import gxipy  # type: ignore
        except ImportError:
            _need("gxipy", "Daheng Galaxy SDK python binding")
        self._gx = gxipy
        self._mgr = gxipy.DeviceManager()
        n, devs = self._mgr.update_device_list()
        if n == 0:
            raise RuntimeError("no Daheng camera found")
        if serial:
            self._cam = self._mgr.open_device_by_sn(serial)
        else:
            self._cam = self._mgr.open_device_by_index(1)
        self.hardware_trigger = hardware_trigger
        self.trigger_line = trigger_line
        self._configure_trigger()
        self._cam.stream_on()

    def _configure_trigger(self):
        gx = self._gx
        cam = self._cam
        cam.TriggerMode.set(gx.GxSwitchEntry.ON)
        if self.hardware_trigger:
            line = {"line0": gx.GxTriggerSourceEntry.LINE0,
                    "line2": gx.GxTriggerSourceEntry.LINE2,
                    "line3": gx.GxTriggerSourceEntry.LINE3}[self.trigger_line]
            cam.TriggerSource.set(line)
            cam.TriggerActivation.set(
                gx.GxTriggerActivationEntry.RISINGEDGE)
        else:
            cam.TriggerSource.set(gx.GxTriggerSourceEntry.SOFTWARE)

    # -- properties ---------------------------------------------------------
    @property
    def exposure(self) -> float:
        return float(self._cam.ExposureTime.get())

    @exposure.setter
    def exposure(self, us: float) -> None:
        self._cam.ExposureTime.set(float(us))

    @property
    def gain(self) -> float:
        return float(self._cam.Gain.get())

    @gain.setter
    def gain(self, db: float) -> None:
        self._cam.Gain.set(float(db))

    @property
    def is_color(self) -> bool:
        # Bayer detection via PixelColorFilter availability/value
        try:
            return bool(self._cam.PixelColorFilter.is_implemented())
        except Exception:
            return False

    @property
    def width(self) -> int:
        return int(self._cam.Width.get())

    @property
    def height(self) -> int:
        return int(self._cam.Height.get())

    # -- capture -------------------------------------------------------------
    def capture_raw(self) -> np.ndarray:
        if not self.hardware_trigger:
            self._cam.TriggerSoftware.send_command()
        timeout_ms = int(self.exposure / 1000.0 + 2000)
        img = self._cam.data_stream[0].get_image(timeout=timeout_ms)
        if img is None:
            raise TimeoutError("camera frame timeout")
        return img.get_numpy_array()

    def capture_rgb(self) -> np.ndarray:
        raw = self.capture_raw()
        try:
            import cv2

            return cv2.cvtColor(raw, cv2.COLOR_BayerRG2RGB)
        except ImportError:
            return raw

    def auto_exposure(self, target_peak: float = 200.0,
                      max_iters: int = 10) -> float:
        """Closed-loop peak-targeted exposure search.

        Intentional redesign, not a port: the reference's Daheng wrapper
        delegates to the camera's one-shot ``ExposureAuto`` feature
        (``api/daheng_camera.py:93-98``), which meters the full frame —
        its beam-shift calibration then layers its OWN closed peak loop on
        top (``calibrate_shift_grid.py:309-329``) because full-frame
        metering under-exposes a pinhole on a dark field.  This wrapper
        implements the peak loop directly so every caller gets the
        calibration-grade behavior and the simulator twin can reproduce it
        deterministically; the one-shot hardware AE remains available on
        the Allied wrapper (``AlliedCamera.auto_exposure``)."""
        for _ in range(max_iters):
            frame = self.capture_raw().astype(np.float64)
            peak = max(frame.max(), 1.0)
            if abs(peak - target_peak) < 10:
                break
            self.exposure = float(np.clip(
                self.exposure * target_peak / peak, 20.0, 1e6))
        return self.exposure

    def auto_white_balance(self) -> None:
        gx = self._gx
        self._cam.BalanceWhiteAuto.set(gx.GxAutoEntry.ONCE)

    def close(self) -> None:
        try:
            self._cam.stream_off()
        finally:
            self._cam.close_device()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AlliedCamera:
    """Allied Vision camera via VmbPy (Mono8)."""

    def __init__(self, gentl_path: Optional[str] = None):
        if gentl_path:
            import os

            os.environ.setdefault("GENICAM_GENTL64_PATH", gentl_path)
        try:
            import vmbpy  # type: ignore
        except ImportError:
            _need("vmbpy", "Allied Vision Vimba X python binding")
        self._vmb = vmbpy.VmbSystem.get_instance()
        self._vmb.__enter__()
        cams = self._vmb.get_all_cameras()
        if not cams:
            raise RuntimeError("no Allied Vision camera found")
        self._cam = cams[0]
        self._cam.__enter__()
        self._cam.set_pixel_format(vmbpy.PixelFormat.Mono8)
        self.exposure = 20000.0
        self.gain = 0.0

    @property
    def is_color(self) -> bool:
        return False

    @property
    def width(self) -> int:
        return int(self._cam.get_feature_by_name("Width").get())

    @property
    def height(self) -> int:
        return int(self._cam.get_feature_by_name("Height").get())

    def capture_raw(self) -> np.ndarray:
        frame = self._cam.get_frame()
        return frame.as_numpy_ndarray()[..., 0]

    capture = capture_raw  # reference method name

    def auto_exposure(self) -> float:
        self._cam.get_feature_by_name("ExposureAuto").set("Once")
        return float(self._cam.get_feature_by_name("ExposureTime").get())

    def stream_burst(self, n_frames: int,
                     callback: Optional[Callable] = None
                     ) -> Tuple[List[np.ndarray], List[float]]:
        """Max-FPS streaming of ``n_frames`` with a frame-callback thread,
        lock-guarded accumulation, completion event, and relative-ms
        timestamps (``api/allied_vision_camera.py:90-115``)."""
        frames: List[np.ndarray] = []
        stamps: List[float] = []
        lock = threading.Lock()
        done = threading.Event()
        t0 = time.perf_counter()

        def on_frame(cam, stream, frame):
            with lock:
                if len(frames) < n_frames:
                    arr = frame.as_numpy_ndarray()[..., 0].copy()
                    ms = (time.perf_counter() - t0) * 1000.0
                    frames.append(arr)
                    stamps.append(ms)
                    if callback is not None:
                        callback(arr, ms)
                    if len(frames) >= n_frames:
                        done.set()
            cam.queue_frame(frame)

        self._cam.start_streaming(on_frame)
        try:
            done.wait(timeout=max(n_frames * 0.1, 30.0))
        finally:
            self._cam.stop_streaming()
        if stamps:
            base = stamps[0]
            stamps = [s - base for s in stamps]
        return frames, stamps

    def close(self) -> None:
        self._cam.__exit__(None, None, None)
        self._vmb.__exit__(None, None, None)


class XPRController:
    """Optotune XPR-4C tilt mirror via optoICC."""

    def __init__(self, port: Optional[str] = None,
                 filter_transition_s: float = 0.0015):
        try:
            import optoICC  # type: ignore
            from optoKummenberg.tools.definitions import UnitType  # type: ignore
        except ImportError:
            _need("optoICC", "Optotune ICC-4C SDK (vendored wheels)")
        self._icc = optoICC.connect(port=port) if port else optoICC.connect()
        self._icc.reset(force=True)
        self._icc.go_pro()
        self._unit = UnitType.UNITLESS
        self._channels = [self._icc.channel[0], self._icc.channel[1]]
        for ch in self._channels:
            ch.SetControlMode(self._unit)  # StaticInput / UNITLESS
            ch.StaticInput.SetAsInput()
        self._setup_smart_filters(filter_transition_s)
        self._trigger_ready = False

    def _setup_smart_filters(self, transition_s: float) -> None:
        try:
            from optoControllerToolbox import SmartFilter  # type: ignore

            for ch in self._channels:
                SmartFilter(ch, transition_time=transition_s).enable()
        except ImportError:
            pass  # filters are an optional smoothing feature

    def set_angles(self, x_deg: float, y_deg: float) -> None:
        self._channels[0].StaticInput.SetValue(float(x_deg))
        self._channels[1].StaticInput.SetValue(float(y_deg))

    def set_home(self) -> None:
        self.set_angles(0.0, 0.0)

    def setup_trigger_output(self) -> None:
        gpio = self._icc.gpio[0]
        gpio.SetAsOutput()
        gpio.SetValue(0)
        self._trigger_ready = True

    def send_trigger_pulse(self, width_us: float = 100.0) -> None:
        if not self._trigger_ready:
            raise RuntimeError("call setup_trigger_output() first")
        gpio = self._icc.gpio[0]
        gpio.SetValue(1)
        time.sleep(width_us / 1e6)
        gpio.SetValue(0)

    def close(self) -> None:
        self.set_home()
        self._icc.disconnect()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ZaberStage:
    """3-axis Zaber rig via zaber_motion, the reference's stage layout
    (``calibration_autofocus/calibrate_autofocus.py:455-496``):

    * **X** — a two-motor gantry driven as ``device.get_lockstep(1)``,
      falling back to plain ``get_axis(1)`` on rigs without a lockstep
      group; limits always read from the *physical* axis 1 (a lockstep
      group has no settings of its own).
    * **Y** — ``get_axis(3)``, **Z** — ``get_axis(4)``.
    * Per-axis soft limits from the device settings ``limit.min`` /
      ``limit.max`` (reference ``:91-96`` ``_get_limit``), falling back
      to (0, 100) mm when a setting is unreadable; ``soft_limits_mm``
      overrides per axis name.

    The :class:`~.protocols.Stage` protocol methods (``move_absolute`` /
    ``get_position`` / ``home``) drive the ``focus_axis`` (default "Z",
    the optical axis), so the autofocus core works unchanged; the named
    API (:meth:`move_axis` etc.) exposes all three.
    """

    AXIS_NUMBERS = {"Y": 3, "Z": 4}

    def __init__(self, port: Optional[str] = None, focus_axis: str = "Z",
                 soft_limits_mm: Optional[dict] = None):
        try:
            from zaber_motion import Units  # type: ignore
            from zaber_motion.ascii import Connection  # type: ignore
        except ImportError:
            _need("zaber_motion", "Zaber stage SDK")
        self._units = Units
        if port:
            self._conn = Connection.open_serial_port(port)
            self._conn.enable_alerts()
            devices = self._conn.detect_devices()
        else:
            self._conn, devices = self._discover(Connection)
        if not devices:
            raise RuntimeError("no Zaber devices found")
        device = devices[0]
        try:
            x_axis = device.get_lockstep(1)
            x_phys = device.get_axis(1)
        except Exception:  # noqa: BLE001 — no lockstep group on this rig
            x_axis = device.get_axis(1)
            x_phys = x_axis
        self._axes = {"X": x_axis}
        self._phys = {"X": x_phys}
        for name, num in self.AXIS_NUMBERS.items():
            ax = device.get_axis(num)
            self._axes[name] = ax
            self._phys[name] = ax
        if focus_axis not in self._axes:
            raise ValueError(f"focus_axis must be one of "
                             f"{sorted(self._axes)}, got {focus_axis!r}")
        self.focus_axis = focus_axis
        self.limits = {}
        for name, phys in self._phys.items():
            self.limits[name] = (self._setting(phys, "limit.min", 0.0),
                                 self._setting(phys, "limit.max", 100.0))
        if soft_limits_mm:
            self.limits.update({k: tuple(v)
                                for k, v in soft_limits_mm.items()})

    def _setting(self, axis, name: str, fallback: float) -> float:
        try:
            return float(axis.settings.get(
                name, self._units.LENGTH_MILLIMETRES))
        except Exception:  # noqa: BLE001 — setting absent on this model
            return fallback

    @property
    def axes(self):
        return sorted(self._axes)

    @staticmethod
    def _discover(Connection):
        """Probe candidate serial ports for a responding Zaber chain.

        zaber_motion has no port scanner of its own (``detect_devices`` is
        a method on an OPEN connection), so enumerate the host's serial
        ports — pyserial's ``list_ports`` when available, /dev globs
        otherwise — and return the first connection whose device chain
        answers."""
        candidates = []
        try:
            from serial.tools import list_ports  # type: ignore

            candidates = [p.device for p in list_ports.comports()]
        except ImportError:
            pass
        if not candidates:
            import glob

            candidates = sorted(glob.glob("/dev/ttyUSB*")
                                + glob.glob("/dev/ttyACM*"))
        for cand in candidates:
            try:
                conn = Connection.open_serial_port(cand)
            except Exception:
                continue
            try:
                devices = conn.detect_devices()
            except Exception:
                conn.close()
                continue
            if devices:
                return conn, devices
            conn.close()
        raise RuntimeError(
            "no Zaber devices found on any serial port "
            f"(probed: {candidates or 'none'}); pass port= explicitly")

    # -- named-axis API (the 3-axis surface) --------------------------------

    def move_axis(self, name: str, position_mm: float) -> None:
        lo, hi = self.limits[name]
        if not (lo <= position_mm <= hi):
            raise ValueError(f"axis {name}: position {position_mm} outside "
                             f"soft limits ({lo}, {hi})")
        self._axes[name].move_absolute(position_mm,
                                       self._units.LENGTH_MILLIMETRES)

    def axis_position(self, name: str) -> float:
        return float(self._axes[name].get_position(
            self._units.LENGTH_MILLIMETRES))

    def home_axis(self, name: str) -> None:
        self._axes[name].home()

    # -- Stage protocol: drives the focus axis ------------------------------

    def home(self) -> None:
        self.home_axis(self.focus_axis)

    def move_absolute(self, position_mm: float) -> None:
        self.move_axis(self.focus_axis, position_mm)

    def get_position(self) -> float:
        return self.axis_position(self.focus_axis)

    def close(self) -> None:
        self._conn.close()
