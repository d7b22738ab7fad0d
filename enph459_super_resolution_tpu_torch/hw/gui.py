"""Interactive autofocus GUI (optional PyQt5 wrapper).

The port's counterpart of ``enph459_super_resolution_tpu/hw/gui.py``.
Thin UI over the headless core (``hw.autofocus``): live viewfinder with a
drag-select ROI, metric picker, stage jog controls, and a coarse->fine
autofocus sweep with a live focus-curve plot — the reference's
``calibration_autofocus/calibrate_autofocus.py`` PyQt tool re-based on the
hardware protocols, so it drives the simulator or real rig alike.

PyQt5 is an optional dependency (not installed in the CI image); all logic
lives in ``hw.autofocus`` and is tested headlessly — this module only adds
widgets and threads.

Usage:
  python -m enph459_super_resolution_tpu_torch.hw.gui [--sim] [--device cpu]

The simulator renders and the Laplacian focus metric runs on ``--device``
(default ``cuda``; without a card ``main`` exits 2).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

try:
    from PyQt5 import QtCore, QtGui, QtWidgets  # type: ignore

    HAVE_QT = True
except ImportError:
    QtCore = QtGui = QtWidgets = None
    HAVE_QT = False

from ..device import DEVICES
from .autofocus import (DEFAULT_METRIC, FOCUS_METRICS, autofocus_sweep,
                        focus_metric)


def map_widget_rect_to_frame(rect_ltrb, widget_size, pix_size, frame_shape):
    """Map a widget-space selection rect to frame-pixel ROI, or None.

    Pure geometry of the drag-ROI rubber band (reference
    ``calibration_autofocus/calibrate_autofocus.py:108-203``), kept
    Qt-free so it is testable headlessly: the displayed pixmap of size
    ``pix_size`` = (pw, ph) is centered (AlignCenter) inside the widget of
    ``widget_size`` = (W, H); ``rect_ltrb`` = (left, top, right, bottom)
    in widget px.  Returns ``(r0, r1, c0, c1)`` clamped to the
    ``frame_shape`` = (h, w) source frame, or None when degenerate.
    """
    left, top, right, bottom = rect_ltrb
    wi, hi = widget_size
    pw, ph = pix_size
    h, w = frame_shape[:2]
    if pw <= 0 or ph <= 0:
        return None
    offx = (wi - pw) // 2
    offy = (hi - ph) // 2
    sx, sy = w / pw, h / ph
    c0 = int(np.clip((left - offx) * sx, 0, w - 1))
    c1 = int(np.clip((right - offx) * sx, 1, w))
    r0 = int(np.clip((top - offy) * sy, 0, h - 1))
    r1 = int(np.clip((bottom - offy) * sy, 1, h))
    if r1 <= r0 or c1 <= c0:
        return None
    return (r0, r1, c0, c1)


if HAVE_QT:

    class RoiLabel(QtWidgets.QLabel):
        """Viewfinder label with drag-select rubber-band ROI (reference
        ``calibration_autofocus/calibrate_autofocus.py:108-203``).

        Drag a rectangle to select the focus ROI in FRAME coordinates
        (mapped through the aspect-preserving pixmap scaling); a short
        click clears it.  Emits ``roi_changed((r0, r1, c0, c1) | None)``.
        """

        roi_changed = QtCore.pyqtSignal(object)

        def __init__(self):
            super().__init__()
            self.setAlignment(QtCore.Qt.AlignCenter)
            self._band = QtWidgets.QRubberBand(
                QtWidgets.QRubberBand.Rectangle, self)
            self._origin = None
            self._frame_shape = None   # (H, W) of the source frame
            self._pix_size = None      # displayed pixmap size (QSize)

        def set_frame_geometry(self, frame_shape, pix_size):
            self._frame_shape = frame_shape[:2]
            self._pix_size = pix_size

        def mousePressEvent(self, event):
            self._origin = event.pos()
            self._band.setGeometry(QtCore.QRect(self._origin, QtCore.QSize()))
            self._band.show()

        def mouseMoveEvent(self, event):
            if self._origin is not None:
                self._band.setGeometry(
                    QtCore.QRect(self._origin, event.pos()).normalized())

        def mouseReleaseEvent(self, event):
            if self._origin is None:
                return
            rect = QtCore.QRect(self._origin, event.pos()).normalized()
            self._origin = None
            self._band.hide()
            if rect.width() < 5 or rect.height() < 5:
                self.roi_changed.emit(None)  # click = clear ROI
                return
            roi = self._map_to_frame(rect)
            if roi is not None:
                self.roi_changed.emit(roi)

        def _map_to_frame(self, rect):
            """Widget rect -> (r0, r1, c0, c1) in frame pixels, clamped."""
            if self._frame_shape is None or self._pix_size is None:
                return None
            return map_widget_rect_to_frame(
                (rect.left(), rect.top(), rect.right(), rect.bottom()),
                (self.width(), self.height()),
                (self._pix_size.width(), self._pix_size.height()),
                self._frame_shape)

    class CameraThread(QtCore.QThread):
        """Continuous capture loop emitting frames + the live focus metric
        (reference ``calibrate_autofocus.py:208-228``)."""

        frame_ready = QtCore.pyqtSignal(np.ndarray, float)

        def __init__(self, cam, metric_name: str, roi=None, device="cuda"):
            super().__init__()
            self.cam = cam
            self.metric_name = metric_name
            self.roi = roi
            self.device = device
            self.running = True

        def run(self):
            while self.running:
                frame = np.asarray(self.cam.capture_raw())
                metric = focus_metric(self.metric_name, frame, self.roi,
                                      self.device)
                self.frame_ready.emit(frame, metric)
                self.msleep(50)

    class AutofocusWorker(QtCore.QThread):
        progress = QtCore.pyqtSignal(float, float)
        finished_sweep = QtCore.pyqtSignal(dict)

        def __init__(self, cam, stage, start_mm, stop_mm, metric, roi,
                     axis=None, device="cuda"):
            super().__init__()
            self.args = (cam, stage, start_mm, stop_mm)
            self.metric = metric
            self.roi = roi
            self.axis = axis
            self.device = device

        def run(self):
            cam, stage, start, stop = self.args
            res = autofocus_sweep(
                cam, stage, start, stop, metric=self.metric, roi=self.roi,
                progress=lambda p, v: self.progress.emit(p, v),
                axis=self.axis, device=self.device)
            self.finished_sweep.emit(res)

    class AutofocusGUI(QtWidgets.QMainWindow):
        def __init__(self, cam, stage, device="cuda"):
            super().__init__()
            self.cam = cam
            self.stage = stage
            self.device = device
            self.roi = None
            self.setWindowTitle("Autofocus")
            self._build_ui()
            self.cam_thread = CameraThread(cam, DEFAULT_METRIC,
                                           device=device)
            self.cam_thread.frame_ready.connect(self._on_frame)
            self.cam_thread.start()

        def _build_ui(self):
            central = QtWidgets.QWidget()
            layout = QtWidgets.QHBoxLayout(central)
            self.view = RoiLabel()
            self.view.setMinimumSize(480, 360)
            self.view.roi_changed.connect(self._on_roi)
            layout.addWidget(self.view, 2)

            panel = QtWidgets.QVBoxLayout()
            # focus-axis picker on 3-axis rigs (reference
            # calibrate_autofocus.py:390-392 — combo over X/Y/Z, default Z)
            self.axis_box = None
            if hasattr(self.stage, "move_axis"):
                self.axis_box = QtWidgets.QComboBox()
                self.axis_box.addItems(list(self.stage.axes))
                self.axis_box.setCurrentText(
                    getattr(self.stage, "focus_axis", "Z"))
                panel.addWidget(QtWidgets.QLabel("Focus axis"))
                panel.addWidget(self.axis_box)
            self.metric_box = QtWidgets.QComboBox()
            self.metric_box.addItems(list(FOCUS_METRICS))
            self.metric_box.currentTextChanged.connect(self._on_metric)
            panel.addWidget(QtWidgets.QLabel("Focus metric"))
            panel.addWidget(self.metric_box)
            self.metric_label = QtWidgets.QLabel("metric: -")
            panel.addWidget(self.metric_label)
            self.pos_label = QtWidgets.QLabel("stage: -")
            panel.addWidget(self.pos_label)
            self.roi_label = QtWidgets.QLabel("ROI: full frame (drag to set)")
            panel.addWidget(self.roi_label)

            jog = QtWidgets.QHBoxLayout()
            for txt, d in [("-1", -1.0), ("-0.1", -0.1), ("+0.1", 0.1),
                           ("+1", 1.0)]:
                btn = QtWidgets.QPushButton(txt)
                btn.clicked.connect(
                    lambda _, dd=d: self._jog(dd))
                jog.addWidget(btn)
            panel.addLayout(jog)

            self.af_btn = QtWidgets.QPushButton("Autofocus")
            self.af_btn.clicked.connect(self._start_autofocus)
            panel.addWidget(self.af_btn)
            panel.addStretch(1)
            layout.addLayout(panel, 1)
            self.setCentralWidget(central)

        def _axis(self):
            return (self.axis_box.currentText() if self.axis_box is not None
                    else None)

        def _jog(self, delta_mm: float):
            ax = self._axis()
            if ax is not None:
                self.stage.move_axis(
                    ax, self.stage.axis_position(ax) + delta_mm)
                self.pos_label.setText(
                    f"stage {ax}: {self.stage.axis_position(ax):.3f} mm")
            else:
                self.stage.move_absolute(
                    self.stage.get_position() + delta_mm)
                self.pos_label.setText(
                    f"stage: {self.stage.get_position():.3f} mm")

        def _on_metric(self, name: str):
            self.cam_thread.metric_name = name

        def _on_roi(self, roi):
            self.roi = roi
            self.cam_thread.roi = roi
            self.roi_label.setText(
                f"ROI: rows {roi[0]}-{roi[1]}, cols {roi[2]}-{roi[3]}"
                if roi else "ROI: full frame (drag to set)")

        def _on_frame(self, frame: np.ndarray, metric: float):
            self.metric_label.setText(f"metric: {metric:.4g}")
            img = np.ascontiguousarray(frame)
            if img.ndim == 2:
                qimg = QtGui.QImage(img.data, img.shape[1], img.shape[0],
                                    img.strides[0],
                                    QtGui.QImage.Format_Grayscale8)
            else:
                qimg = QtGui.QImage(img.data, img.shape[1], img.shape[0],
                                    img.strides[0],
                                    QtGui.QImage.Format_RGB888)
            pix = QtGui.QPixmap.fromImage(qimg).scaled(
                self.view.size(), QtCore.Qt.KeepAspectRatio)
            if self.roi is not None:
                r0, r1, c0, c1 = self.roi
                sy = pix.height() / img.shape[0]
                sx = pix.width() / img.shape[1]
                painter = QtGui.QPainter(pix)
                painter.setPen(QtGui.QPen(QtGui.QColor(0, 255, 0), 2))
                painter.drawRect(int(c0 * sx), int(r0 * sy),
                                 int((c1 - c0) * sx), int((r1 - r0) * sy))
                painter.end()
            self.view.set_frame_geometry(img.shape, pix.size())
            self.view.setPixmap(pix)

        def _start_autofocus(self):
            self.af_btn.setEnabled(False)
            ax = self._axis()
            if ax is not None:
                lo, hi = self.stage.limits[ax]
            else:
                lo, hi = getattr(self.stage, "travel", (0.0, 100.0))
            self.worker = AutofocusWorker(
                self.cam, self.stage, lo, hi,
                self.metric_box.currentText(), self.roi, axis=ax,
                device=self.device)
            self.worker.finished_sweep.connect(self._af_done)
            self.worker.start()

        def _af_done(self, result: dict):
            self.af_btn.setEnabled(True)
            self.pos_label.setText(
                f"stage: {result['best_pos_mm']:.3f} mm (best)")

        def closeEvent(self, event):
            self.cam_thread.running = False
            self.cam_thread.wait(1000)
            super().closeEvent(event)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Autofocus GUI on the simulator")
    p.add_argument("--sim", action="store_true",
                   help="drive the simulated rig (the only backend here)")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where the simulator renders and the Laplacian "
                        "focus metric runs")
    args, qt_args = p.parse_known_args(
        sys.argv[1:] if argv is None else argv)
    if not HAVE_QT:
        print("PyQt5 is not installed; the autofocus logic is available "
              "headlessly via enph459_super_resolution_tpu_torch.hw.autofocus",
              file=sys.stderr)
        return 2
    from .sim import (SimCamera, SimConfig, SimStage3Axis, SimulatedRig,
                      pinhole_scene)

    try:
        rig = SimulatedRig(scene=pinhole_scene((384, 512)),
                           config=SimConfig(lr_shape=(192, 256)),
                           device=args.device)
    except RuntimeError as exc:  # cuda asked for, no card
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cam = SimCamera(rig)
    stage = SimStage3Axis(rig)  # lockstep-X + Y/Z, focus on Z
    app = QtWidgets.QApplication(sys.argv[:1] + qt_args)
    gui = AutofocusGUI(cam, stage, device=args.device)
    gui.show()
    return app.exec_()


if __name__ == "__main__":
    sys.exit(main())
