"""Hardware abstraction protocols.

The port's copy of ``enph459_super_resolution_tpu/hw/protocols.py`` (host
only, no device op).  The reference's L1 layer (``api/__init__.py``)
exposes three device classes (Daheng camera, Allied Vision camera,
Optotune XPR tilt mirror) that the calibration/collection layers drive
directly.  Here those surfaces become structural protocols so every
orchestrator runs identically against real vendor SDKs (``hw.real``,
optional imports) or the physics simulator (``hw.sim``) — the reference
has no simulator and cannot run without the bench hardware (SURVEY.md §4
implication).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

# Trigger source identifiers (reference ``api/daheng_camera.py:7-10``).
TRIGGER_SOFTWARE = "software"
TRIGGER_LINE0 = "line0"
TRIGGER_LINE2 = "line2"
TRIGGER_LINE3 = "line3"


@runtime_checkable
class Camera(Protocol):
    """Frame source (reference ``api/daheng_camera.py``)."""

    exposure: float  # microseconds
    gain: float      # dB

    @property
    def is_color(self) -> bool: ...

    @property
    def width(self) -> int: ...

    @property
    def height(self) -> int: ...

    def capture_raw(self) -> np.ndarray:
        """One frame, raw sensor data (Bayer mosaic for color)."""
        ...

    def auto_exposure(self) -> float:
        """One-shot auto exposure; returns the chosen exposure (us)."""
        ...

    def close(self) -> None: ...


@runtime_checkable
class BurstCamera(Protocol):
    """Max-FPS streaming capture (reference ``api/allied_vision_camera.py:90-115``)."""

    def stream_burst(self, n_frames: int,
                     callback: Optional[Callable] = None
                     ) -> Tuple[List[np.ndarray], List[float]]:
        """Capture ``n_frames`` at max rate; returns (frames, timestamps_ms
        relative to the first frame)."""
        ...


@runtime_checkable
class BeamSteering(Protocol):
    """Tilt mirror (reference ``api/xpr_controller.py``)."""

    def set_angles(self, x_deg: float, y_deg: float) -> None: ...

    def set_home(self) -> None: ...

    def setup_trigger_output(self) -> None: ...

    def send_trigger_pulse(self, width_us: float = 100.0) -> None: ...

    def close(self) -> None: ...


@runtime_checkable
class Stage(Protocol):
    """Linear focus stage (reference Zaber usage,
    ``calibration_autofocus/calibrate_autofocus.py:455-496``)."""

    def move_absolute(self, position_mm: float) -> None: ...

    def get_position(self) -> float: ...

    def home(self) -> None: ...


def get_xpr_angles(tilt_deg: float) -> np.ndarray:
    """Static 4-corner geometry: ``tilt * [[-1,1],[-1,-1],[1,-1],[1,1]]``
    (reference ``api/xpr_controller.py:82-85``)."""
    return float(tilt_deg) * np.array(
        [[-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [1.0, 1.0]])
