"""The port's vendor-SDK wrappers (``hw/real.py``) and GUI core
(``hw/gui.py``) against the JAX package's, on fake SDK modules.

The cases of ``tests/test_real_hw.py`` on the port, with that file's
``types.ModuleType`` stubs installed in ``sys.modules``.  Each case runs
the port's wrapper and then the JAX package's on a fresh fake of the same
device, and the two fakes must end in the same state: the same trigger
configuration, timeouts, exposures, GPIO pulses and stage moves.  The
tests need no vendor SDK and no PyQt5.
"""

import numpy as np
import pytest
from test_real_hw import (_FakeGxCamera, _FakeVmbCamera, _FakeZaberDevice,
                          _install_fake_gxipy, _install_fake_optoicc,
                          _install_fake_vmbpy, _install_fake_zaber)

import enph459_super_resolution_tpu.hw.real as JR
import enph459_super_resolution_tpu_torch.hw.real as TR


def _features(cam) -> dict:
    """Every fake feature's value and history (a gxipy or vmbpy fake)."""
    feats = cam.features if hasattr(cam, "features") else {
        k: v for k, v in vars(cam).items() if hasattr(v, "history")}
    return {k: (v.value, list(v.history)) for k, v in feats.items()}


def _on_both(scenario):
    """``scenario(real_module)`` for the port, then for JAX's; returns
    (port's result, JAX's)."""
    return scenario(TR), scenario(JR)


# --------------------------------------------------------------------------
# Daheng (gxipy)
# --------------------------------------------------------------------------

def test_daheng_sw_trigger_capture_and_timeout_math(monkeypatch):
    def scenario(real):
        cam = _FakeGxCamera()
        _install_fake_gxipy(monkeypatch, cam)
        d = real.DahengCamera()
        assert cam.opened_by == ("index", 1)
        assert cam.TriggerMode.value == "ON"
        assert cam.TriggerSource.value == "SOFTWARE"
        assert "stream_on" in cam.calls
        d.exposure = 500000.0  # 0.5 s
        frame = d.capture_raw()
        assert frame.shape == (48, 64)
        # the software trigger fired; the timeout is exposure + 2 s
        assert cam.TriggerSoftware.history == ["sent"]
        assert cam.data_stream[0].timeouts[-1] == int(500000 / 1000 + 2000)
        d.close()
        assert cam.calls[-2:] == ["stream_off", "close_device"]
        return _features(cam), cam.calls, cam.data_stream[0].timeouts

    got, want = _on_both(scenario)
    assert got == want


def test_daheng_hw_trigger_line_and_timeout_error(monkeypatch):
    def scenario(real):
        cam = _FakeGxCamera()
        _install_fake_gxipy(monkeypatch, cam)
        d = real.DahengCamera(serial="FAKE1", hardware_trigger=True,
                              trigger_line="line2")
        assert cam.opened_by == ("sn", "FAKE1")
        assert cam.TriggerSource.value == "LINE2"
        assert cam.TriggerActivation.value == "RISINGEDGE"
        cam.frames = None  # no frame arrives
        with pytest.raises(TimeoutError):
            d.capture_raw()
        # hardware-trigger mode must NOT send a software trigger
        assert cam.TriggerSoftware.history == []
        return _features(cam), cam.data_stream[0].timeouts

    got, want = _on_both(scenario)
    assert got == want


def test_daheng_auto_exposure_closed_loop(monkeypatch):
    """The peak-targeted loop scales exposure toward the target and stops
    inside the +/-10-count deadband, step for step as JAX's."""
    def scenario(real):
        cam = _FakeGxCamera()
        _install_fake_gxipy(monkeypatch, cam)
        # frame peak proportional to exposure: peak = exposure / 100
        cam.frames = lambda c: np.full(
            (8, 8), min(c.ExposureTime.value / 100.0, 255.0), np.float64)
        d = real.DahengCamera()
        d.exposure = 2000.0  # peak 20, far from target 200
        final = d.auto_exposure(target_peak=200.0)
        assert abs(final / 100.0 - 200.0) < 10
        return final, cam.ExposureTime.history

    got, want = _on_both(scenario)
    assert got == want


# --------------------------------------------------------------------------
# Allied Vision (vmbpy)
# --------------------------------------------------------------------------

def test_allied_capture_and_exposure(monkeypatch):
    def scenario(real):
        cam = _FakeVmbCamera()
        _install_fake_vmbpy(monkeypatch, cam)
        a = real.AlliedCamera()
        assert cam.pixel_format == "Mono8"
        assert (a.width, a.height) == (32, 24)
        frame = a.capture()  # reference method name
        assert frame.shape == (24, 32)  # channel axis stripped
        a.auto_exposure()
        assert cam.features["ExposureAuto"].history == ["Once"]
        a.close()
        assert "cam_exit" in cam.calls and "vmb_exit" in cam.calls
        return frame, _features(cam), cam.calls

    got, want = _on_both(scenario)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_allied_stream_burst_collects_n_with_relative_stamps(monkeypatch):
    def scenario(real):
        cam = _FakeVmbCamera()
        _install_fake_vmbpy(monkeypatch, cam)
        a = real.AlliedCamera()
        seen = []
        frames, stamps = a.stream_burst(5,
                                        callback=lambda f, ms: seen.append(ms))
        assert len(frames) == 5 and len(stamps) == 5 and len(seen) == 5
        assert stamps[0] == 0.0  # relative-ms protocol
        assert all(b >= a_ for a_, b in zip(stamps, stamps[1:]))
        assert "stop_streaming" in cam.calls
        return len(frames), [f.shape for f in frames], cam.calls

    got, want = _on_both(scenario)
    assert got == want


# --------------------------------------------------------------------------
# Optotune XPR (optoICC)
# --------------------------------------------------------------------------

def _icc_state(icc):
    return (icc.calls,
            [(ch.modes, ch.StaticInput.values) for ch in icc.channel],
            icc.gpio[0].log)


def test_xpr_connect_protocol_and_angles(monkeypatch):
    def scenario(real):
        icc = _install_fake_optoicc(monkeypatch)
        x = real.XPRController()
        # reset -> go_pro -> both channels StaticInput/UNITLESS
        assert icc.calls[:2] == [("reset", True), "go_pro"]
        for ch in icc.channel:
            assert ch.modes == ["UNITLESS"] and ch.StaticInput.as_input
        x.set_angles(0.28, -0.28)
        assert icc.channel[0].StaticInput.values[-1] == 0.28
        assert icc.channel[1].StaticInput.values[-1] == -0.28
        x.set_home()
        assert icc.channel[0].StaticInput.values[-1] == 0.0
        x.close()
        assert icc.calls[-1] == "disconnect"
        return _icc_state(icc)

    got, want = _on_both(scenario)
    assert got == want


def test_xpr_gpio_pulse_protocol(monkeypatch):
    def scenario(real):
        icc = _install_fake_optoicc(monkeypatch)
        x = real.XPRController()
        with pytest.raises(RuntimeError, match="setup_trigger_output"):
            x.send_trigger_pulse()
        x.setup_trigger_output()
        x.send_trigger_pulse(width_us=10.0)
        # output mode, idle-low init, then a 1 -> 0 pulse
        assert icc.gpio[0].log == ["output", 0, 1, 0]
        return _icc_state(icc)

    got, want = _on_both(scenario)
    assert got == want


# --------------------------------------------------------------------------
# the GUI's Qt-free core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rect,widget,pix,frame,expected", [
    # widget 200x100, pixmap 100x50 centred -> offsets (50, 25); frame
    # 480x640 -> scale x 6.4, y 9.6
    ((60, 35, 80, 45), (200, 100), (100, 50), (480, 640), (96, 192, 64, 192)),
    # a selection hanging off the pixmap's edge clamps to the frame
    ((0, 0, 300, 200), (200, 100), (100, 50), (480, 640), (0, 480, 0, 640)),
    # a degenerate pixmap
    ((0, 0, 10, 10), (200, 100), (0, 0), (480, 640), None),
    # entirely left of the pixmap: the 1-px frame edge
    ((0, 0, 10, 10), (200, 100), (100, 50), (480, 640), (0, 1, 0, 1)),
    # a colour frame's (h, w, 3) shape; an empty selection
    ((70, 40, 70, 60), (200, 100), (100, 50), (480, 640, 3), None),
], ids=["inside", "clamped", "no_pixmap", "left_edge", "empty"])
def test_gui_roi_mapping_headless(rect, widget, pix, frame, expected):
    """Drag-ROI rubber-band geometry (the Qt-free core of ``hw/gui.py``),
    equal to JAX's."""
    from enph459_super_resolution_tpu.hw.gui import \
        map_widget_rect_to_frame as jax_map
    from enph459_super_resolution_tpu_torch.hw.gui import \
        map_widget_rect_to_frame

    got = map_widget_rect_to_frame(rect, widget, pix, frame)
    assert got == expected
    assert got == jax_map(rect, widget, pix, frame)


def test_gui_main_without_qt_exits_2(capsys):
    """Without PyQt5, ``main`` prints the JAX package's message (naming
    the port's module) and returns 2, with or without ``--device``."""
    from enph459_super_resolution_tpu.hw import gui as jax_gui
    from enph459_super_resolution_tpu_torch.hw import gui

    assert not gui.HAVE_QT
    for argv in ([], ["--sim", "--device", "cpu"], ["--device", "cuda"]):
        assert gui.main(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith("PyQt5 is not installed")
        assert "enph459_super_resolution_tpu_torch.hw.autofocus" in err
    assert jax_gui.main([]) == 2
    want = capsys.readouterr().err
    assert err.replace("_torch", "") == want
    with pytest.raises(SystemExit):
        gui.main(["--device", "tpu"])


# --------------------------------------------------------------------------
# Zaber (zaber_motion): the 3-axis rig
# --------------------------------------------------------------------------

def _zaber_state(dev):
    return ({n: (ax.moves, ax.homed) for n, ax in dev.axes.items()},
            (dev.lockstep.moves, dev.lockstep.homed))


def test_zaber_three_axis_layout_and_limits(monkeypatch):
    """Lockstep X preferred (limits from the PHYSICAL axis 1), Y=axis 3,
    Z=axis 4, limits from device settings with (0, 100) fallback."""
    def scenario(real):
        dev = _FakeZaberDevice(axis_settings={
            1: {"settings": {"limit.min": 5.0, "limit.max": 595.0}},
            3: {"settings": {"limit.min": 0.0, "limit.max": 80.0}},
            4: {"fail_settings": True},  # unreadable -> (0, 100) fallback
        })
        conn = _install_fake_zaber(monkeypatch, dev)
        st = real.ZaberStage(port="/dev/ttyFAKE0")
        assert conn.alerts >= 1
        assert st.axes == ["X", "Y", "Z"]
        assert st.limits["X"] == (5.0, 595.0)
        assert st.limits["Y"] == (0.0, 80.0)
        assert st.limits["Z"] == (0.0, 100.0)
        st.move_axis("X", 10.0)
        assert dev.lockstep.moves == [10.0]
        assert dev.axes[1].moves == []
        st.move_absolute(42.0)
        assert dev.axes[4].moves == [42.0]
        assert st.get_position() == 42.0
        st.home()
        assert dev.axes[4].homed == 1
        with pytest.raises(ValueError, match="soft limits"):
            st.move_axis("Y", 81.0)
        st.close()
        assert conn.closed == 1
        return st.limits, _zaber_state(dev)

    got, want = _on_both(scenario)
    assert got == want


def test_zaber_lockstep_fallback_and_focus_axis(monkeypatch):
    """Rigs without a lockstep group fall back to plain axis 1 for X;
    focus_axis is selectable by name."""
    def scenario(real):
        dev = _FakeZaberDevice(has_lockstep=False)
        _install_fake_zaber(monkeypatch, dev)
        st = real.ZaberStage(port="/dev/ttyFAKE0", focus_axis="X",
                             soft_limits_mm={"X": (0.0, 600.0)})
        st.move_absolute(123.0)
        assert dev.axes[1].moves == [123.0]  # plain axis, no lockstep
        assert st.limits["X"] == (0.0, 600.0)
        with pytest.raises(ValueError, match="focus_axis"):
            real.ZaberStage(port="/dev/ttyFAKE0", focus_axis="Q")
        return st.limits, _zaber_state(dev)

    got, want = _on_both(scenario)
    assert got == want


@pytest.mark.parametrize("sdk,make", [
    ("gxipy", lambda: TR.DahengCamera()),
    ("vmbpy", lambda: TR.AlliedCamera()),
    ("optoICC", lambda: TR.XPRController()),
    ("zaber_motion", lambda: TR.ZaberStage(port="/dev/null")),
])
def test_missing_sdk_names_the_wheel(monkeypatch, sdk, make):
    """Without its SDK each backend raises ImportError naming the wheel,
    JAX's message word for word."""
    import sys

    for name in ("gxipy", "vmbpy", "optoICC", "zaber_motion",
                 "zaber_motion.ascii", "optoKummenberg",
                 "optoKummenberg.tools",
                 "optoKummenberg.tools.definitions"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match=f"'{sdk}' SDK is required") as got:
        make()
    jax_make = {"gxipy": JR.DahengCamera, "vmbpy": JR.AlliedCamera,
                "optoICC": JR.XPRController}.get(sdk)
    if jax_make is None:
        with pytest.raises(ImportError) as want:
            JR.ZaberStage(port="/dev/null")
    else:
        with pytest.raises(ImportError) as want:
            jax_make()
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the autofocus core on the 3-axis sim twin
# --------------------------------------------------------------------------

def test_autofocus_sweep_by_axis_name_on_sim_3axis():
    """The autofocus core drives a named axis of the port's 3-axis sim twin
    and recovers the rig's best focus on it, at JAX's position."""
    from enph459_super_resolution_tpu.hw import sim as JS
    from enph459_super_resolution_tpu.hw.autofocus import \
        autofocus_sweep as jax_sweep
    from enph459_super_resolution_tpu_torch.hw import sim as TS
    from enph459_super_resolution_tpu_torch.hw.autofocus import \
        autofocus_sweep

    limits = {"X": (0.0, 600.0), "Y": (0.0, 100.0), "Z": (350.0, 390.0)}
    results = {}
    for name, pkg, sweep, kw in (("jax", JS, jax_sweep, {}),
                                 ("port", TS, autofocus_sweep,
                                  {"device": "cpu"})):
        cfg = pkg.SimConfig(lr_shape=(96, 128), jitter_sigma_px=0.0,
                            unsettled_jitter_px=0.0, seed=1, read_noise=0.1,
                            shot_noise_scale=0.0)
        rig = pkg.SimulatedRig(
            scene=pkg.pinhole_scene((192, 256), center=(96.0, 128.0)),
            config=cfg, **kw)
        cam = pkg.SimCamera(rig)
        stage = pkg.SimStage3Axis(rig, best_pos_mm=369.23, focus_axis="Z",
                                  limits=limits)
        y_before = stage.axis_position("Y")
        res = sweep(cam, stage, 355.0, 385.0, coarse_points=7,
                    fine_points=5, settle_s=0.0, sleep_fn=lambda s: None,
                    axis="Z", **kw)
        assert res["axis"] == "Z"
        assert abs(res["best_pos_mm"] - 369.23) < 3.0
        assert stage.axis_position("Y") == y_before  # other axes untouched
        stage.move_axis("X", 50.0)
        assert stage.lockstep_positions == (50.0, 50.0)
        with pytest.raises(ValueError, match="multi-axis"):
            sweep(cam, pkg.SimStage(rig), 355.0, 385.0, axis="Z", **kw)
        results[name] = res
    got, want = results["port"], results["jax"]
    assert got["best_pos_mm"] == want["best_pos_mm"]
    assert got["positions"] == want["positions"]
    np.testing.assert_allclose(got["values"], want["values"], rtol=1e-3)
