"""The port's rig layer (``enph459_super_resolution_tpu_torch/hw``) against
the JAX package's, on the CPU.

The cases of ``tests/test_hw.py`` run on the port, and the same small rigs
with the same seeds run through both packages.  The simulator keeps the
reference's ``default_rng(seed)`` stream and its order of draws, so the
shift draws are equal and a frame differs only where the float32 render's
rounding crosses a uint8 truncation boundary: frames within +-1 uint8, on at
most ``FRAME_SHARE`` of the pixels.  Calibration centres and shifts hold to
``CENTRE_ATOL`` px; the collection's ``metadata.json``, ``images.csv`` and
``results.json`` are equal (the runs are given the same timestamp, the only
wall-clock field).  Then the reference project's thesis on the port's
simulated stack: a barcode no single frame resolves decodes from 4-frame
SAA+IBP, through ``solve`` and through ``sr.run``.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

import enph459_super_resolution_tpu.hw as JH
import enph459_super_resolution_tpu_torch.hw as TH

FRAME_SHARE = 1e-3   # pixels of a frame that may differ (by 1) from JAX's
CENTRE_ATOL = 1e-3   # px: calibration centres and shifts against JAX's
EDGE_ATOL = 1e-6     # px: knife-edge positions of the same frames
LAPLACIAN_RTOL = 1e-5
DIGITS = "5901234123457"


def small_cfg(color=False, **kw):
    """``tests/test_hw.py``'s small rig, ``kw`` overriding its fields."""
    cfg = dict(lr_shape=(96, 128), color=color, jitter_sigma_px=0.0,
               unsettled_jitter_px=0.0, seed=1, read_noise=0.1,
               shot_noise_scale=0.0)
    cfg.update(kw)
    return cfg


def rigs(scene=None, color=False, **kw):
    """The same small rig in both packages: (JAX's, the port's on the
    CPU)."""
    cfg = small_cfg(color=color, **kw)
    return (JH.SimulatedRig(scene=scene, config=JH.SimConfig(**cfg)),
            TH.SimulatedRig(scene=scene, config=TH.SimConfig(**cfg),
                            device="cpu"))


def pinhole():
    return JH.pinhole_scene((192, 256), center=(96.0, 128.0))


def smooth_scene(seed, sigma):
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    return ndi.gaussian_filter(rng.uniform(0, 255, (192, 256)), sigma)


def assert_frames_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (what, int(diff.max()))
    assert (diff > 0).mean() <= FRAME_SHARE, (what, float((diff > 0).mean()))


def read_csv(path):
    with open(path) as fp:
        return list(csv.reader(fp))


def assert_csv_close(got_path, want_path, atol):
    """Same rows and columns; numeric cells within ``atol``, the rest
    equal."""
    got, want = read_csv(got_path), read_csv(want_path)
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            try:
                gv, wv = float(g), float(w)
            except ValueError:
                assert g == w
                continue
            assert abs(gv - wv) <= atol, (g_row, w_row)


def assert_tree_close(got, want, atol, path="$"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= atol, (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tilt", [0.1, 0.14391, 0.28])
def test_xpr_corner_geometry(tilt):
    a = TH.get_xpr_angles(tilt)
    np.testing.assert_array_equal(a, JH.get_xpr_angles(tilt))
    np.testing.assert_allclose(
        a, tilt * np.array([[-1, 1], [-1, -1], [1, -1], [1, 1]]))


SCENES = {
    "pinhole": (pinhole, {}),
    "smooth": (lambda: smooth_scene(0, 2.0), {}),
    "knife": (lambda: JH.knife_edge_scene((192, 256), edge_col=128.0), {}),
    "color": (lambda: smooth_scene(4, 1.5), {"color": True}),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frames_match_jax(name):
    """Frames at 16 mirror states, jittered and unsettled, through both
    rigs: the same shift draws (the rng's state is equal after every
    frame) and frames within +-1 uint8."""
    make, kw = SCENES[name]
    rj, rt = rigs(make(), jitter_sigma_px=0.02, unsettled_jitter_px=0.15,
                  read_noise=0.8, shot_noise_scale=0.02, **kw)
    for k in range(16):
        for rig in (rj, rt):
            rig.angles = (0.06 * k - 0.45, 0.3 - 0.05 * k)
            rig.settled_ms = 2.0 * k
        want = rj.render(9000.0 + 500.0 * k)
        got = rt.render(9000.0 + 500.0 * k)
        assert rt.rng.bit_generator.state == rj.rng.bit_generator.state
        assert_frames_close(got, want, (name, k))


def test_render_range_check_raises_as_jax():
    rj, rt = rigs(pinhole())
    for rig in (rj, rt):
        rig.angles = (2.0, 0.0)  # 6.4 LR px: past the padded range
    for rig in (rj, rt):
        with pytest.raises(ValueError, match="supported range"):
            rig.render(10000.0)


def test_sim_camera_shift_physics():
    """Commanded tilt must move the rendered pinhole by gain*tilt px; the
    fitted centres equal JAX's."""
    from enph459_super_resolution_tpu.hw.calibrate import \
        find_pinhole_center as jax_centre
    from enph459_super_resolution_tpu_torch.hw.calibrate import \
        find_pinhole_center

    rj, rt = rigs(pinhole())
    centres = []
    for pkg, rig in ((JH, rj), (TH, rt)):
        xpr = pkg.SimBeamSteering(rig)
        cam = pkg.SimCamera(rig)
        img0 = cam.capture_raw()
        xpr.set_angles(0.5, 0.0)
        rig.sleep(0.1)
        img1 = cam.capture_raw()
        centres.append((img0, img1))
    (j0, j1), (t0, t1) = centres
    cx0, cy0 = find_pinhole_center(t0, crop_radius=12, device="cpu")
    cx1, cy1 = find_pinhole_center(t1, crop_radius=12, device="cpu")
    assert abs((cx1 - cx0) - rt.cfg.gain_px_per_deg * 0.5) < 0.05
    assert abs(cy1 - cy0) < 0.05
    for img, got in ((j0, (cx0, cy0)), (j1, (cx1, cy1))):
        np.testing.assert_allclose(got, jax_centre(img, crop_radius=12),
                                   atol=CENTRE_ATOL)


def test_hw_trigger_requires_pulse():
    rig = rigs()[1]
    xpr = TH.SimBeamSteering(rig)
    cam = TH.SimCamera(rig, hardware_trigger=True)
    with pytest.raises(TimeoutError):
        cam.capture_raw()
    with pytest.raises(RuntimeError):
        xpr.send_trigger_pulse()  # trigger output not configured yet
    xpr.setup_trigger_output()
    xpr.send_trigger_pulse()
    frame = cam.capture_raw()
    assert frame.shape == (96, 128)
    with pytest.raises(TimeoutError):
        cam.capture_raw()  # pulse consumed


def test_sim_stage_moves_rewrite_the_rig_psf():
    """A stage move writes the rig's ``_psf`` and drops ``_coeff``, as
    JAX's does; the defocused PSF equals JAX's."""
    rj, rt = rigs(pinhole())
    sj = JH.SimStage(rj, travel=(350.0, 390.0))
    st = TH.SimStage(rt, travel=(350.0, 390.0))
    for pos in (350.0, 369.23, 381.5):
        rt.render(10000.0)
        assert rt._coeff is not None
        sj.move_absolute(pos)
        st.move_absolute(pos)
        assert rt._coeff is None
        np.testing.assert_allclose(rt._psf, rj._psf, rtol=1e-15, atol=0)
    with pytest.raises(ValueError, match="soft limits"):
        st.move_absolute(391.0)


# ---------------------------------------------------------------------------
# calibration, collection
# ---------------------------------------------------------------------------

def test_find_pinhole_centers_batch_equals_one_at_a_time():
    from enph459_super_resolution_tpu_torch.hw.calibrate import (
        find_pinhole_center, find_pinhole_centers)

    rig = rigs(pinhole(), jitter_sigma_px=0.05)[1]
    imgs = []
    for x in (-0.2, 0.0, 0.25):
        rig.angles = (x, -x)
        imgs.append(rig.render(10000.0))
    batch = find_pinhole_centers(imgs, crop_radius=12, device="cpu")
    alone = [find_pinhole_center(i, crop_radius=12, device="cpu")
             for i in imgs]
    np.testing.assert_allclose(batch, alone, rtol=0, atol=1e-9)


def _calibrate(pkg, rig, out):
    cal = __import__(f"{pkg.__name__}.calibrate", fromlist=["x"])
    kw = {"device": "cpu"} if pkg is TH else {}
    return cal.run_calibration(pkg.SimBeamSteering(rig), pkg.SimCamera(rig),
                               str(out), tilt_min=0.1, tilt_max=0.3,
                               tilt_steps=3, num_repeats=2,
                               sleep_fn=lambda s: rig.sleep(s),
                               save_images=False, **kw)


def test_calibration_round_trip(tmp_path):
    """Calibrate the sim through both packages: the port's shifts.csv slope
    equals the physics gain, and its centres, shifts and results.json equal
    JAX's within ``CENTRE_ATOL``."""
    from enph459_super_resolution_tpu_torch.hw.collect import \
        load_calibration

    rj, rt = rigs(pinhole())
    want = _calibrate(JH, rj, tmp_path / "jax")
    got = _calibrate(TH, rt, tmp_path / "port")
    out = str(tmp_path / "port")
    for f in ("shifts.csv", "centers.csv", "results.json"):
        assert os.path.exists(os.path.join(out, f))
    cal = load_calibration(os.path.join(out, "shifts.csv"))
    # position 5 = (+x, 0): dx should be gain * tilt
    dx, dy = cal[("x", "0.30000", 5)]
    assert abs(dx - rt.cfg.gain_px_per_deg * 0.3) < 0.1
    assert abs(dy) < 0.1

    for f in ("shifts.csv", "centers.csv"):
        assert_csv_close(tmp_path / "port" / f, tmp_path / "jax" / f,
                         CENTRE_ATOL)
    assert_tree_close(got, want, CENTRE_ATOL)
    assert_tree_close(json.loads((tmp_path / "port" / "results.json")
                                 .read_text()),
                      json.loads((tmp_path / "jax" / "results.json")
                                 .read_text()), CENTRE_ATOL)


def _png_pairs(got_dir, want_dir):
    names = sorted(os.path.relpath(os.path.join(d, f), want_dir)
                   for d, _, files in os.walk(want_dir)
                   for f in files if f.endswith(".png"))
    got_names = sorted(os.path.relpath(os.path.join(d, f), got_dir)
                       for d, _, files in os.walk(got_dir)
                       for f in files if f.endswith(".png"))
    assert got_names == names
    return names


def _assert_run_dirs_equal(got_dir, want_dir):
    """Equal results.json, images.csv and every metadata.json; every PNG
    within +-1 uint8 of JAX's."""
    from enph459_super_resolution_tpu_torch.data.io import load_image

    for f in ("results.json", "images.csv"):
        assert (got_dir / f).read_text() == (want_dir / f).read_text(), f
    for name in _png_pairs(got_dir, want_dir):
        assert_frames_close(load_image(str(got_dir / name), np.uint8),
                            load_image(str(want_dir / name), np.uint8), name)
    for meta in want_dir.glob("*/metadata.json"):
        got = got_dir / meta.relative_to(want_dir)
        assert got.read_text() == meta.read_text(), meta


def _collect_hw(pkg, rig, out, **kw):
    col = __import__(f"{pkg.__name__}.collect", fromlist=["x"])
    opts = dict(calibration_csv=None, tilt_min=0.15625, tilt_max=0.15625,
                tilt_steps=1, settling_times_ms=(50.0,), num_repeats=2,
                special_run=False, sleep_fn=lambda s: rig.sleep(s),
                timestamp="testrun")
    opts.update(kw)
    return col.run_hw_triggered(pkg.SimBeamSteering(rig),
                                pkg.SimCamera(rig, hardware_trigger=True),
                                str(out), **opts)


def test_collect_hw_triggered_feeds_sr(tmp_path):
    """Full collection -> SR loader -> solve round trip on the port's
    simulator; the run folder equals JAX's."""
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    rj, rt = rigs(smooth_scene(0, 2.0))
    _collect_hw(JH, rj, tmp_path / "jax")
    res = _collect_hw(TH, rt, tmp_path / "port")
    assert res["camera_type"] == "mono"
    run_dir = tmp_path / "port" / "testrun"
    _assert_run_dirs_equal(run_dir, tmp_path / "jax" / "testrun")
    combos = [d for d in os.listdir(run_dir) if (run_dir / d).is_dir()]
    assert len(combos) == 1
    meta = json.loads((run_dir / combos[0] / "metadata.json").read_text())
    assert set(meta["expected_shifts"]) == {"(-x,+y)", "(+x,+y)",
                                            "(-x,-y)", "(+x,-y)"}

    # tilt 0.15625 * gain 3.2 = exactly 0.5 px -> barcode workload shifts
    units = WORKLOADS["mono_barcodes"].load(str(run_dir / combos[0]))
    assert len(units) == 2  # per-rep
    assert units[0].frames.shape == (4, 96, 128)
    sol = solve(torch.as_tensor(units[0].frames), make_gaussian_psf(),
                units[0].shifts, n_iter=10, device="cpu")
    errs = np.asarray(sol["mse_history"])
    assert errs[-1] < errs[0]  # IBP converges on simulated data


def test_collect_hw_triggered_special_run_matches_jax(tmp_path):
    """The special run's per-corner tilts interpolate the calibration
    (both packages read the same shifts.csv): equal folders."""
    rj, rt = rigs(pinhole())
    _calibrate(JH, rj, tmp_path / "cal")
    csv_path = str(tmp_path / "cal" / "shifts.csv")
    rj, rt = rigs(smooth_scene(2, 1.5))
    want = _collect_hw(JH, rj, tmp_path / "jax", calibration_csv=csv_path,
                       special_run=True, num_repeats=1)
    got = _collect_hw(TH, rt, tmp_path / "port", calibration_csv=csv_path,
                      special_run=True, num_repeats=1)
    assert got["special_run"]["target_shift_px"] == 0.5
    assert len(got["combos"]) == 2
    assert got == want
    _assert_run_dirs_equal(tmp_path / "port" / "testrun",
                           tmp_path / "jax" / "testrun")


def test_sw_triggered_collection(tmp_path):
    from enph459_super_resolution_tpu.hw.collect import \
        run_sw_triggered as jax_sw
    from enph459_super_resolution_tpu_torch.hw.collect import \
        run_sw_triggered

    rj, rt = rigs(pinhole())
    kw = dict(tilt_min=0.1, tilt_max=0.2, tilt_steps=2, num_repeats=1,
              timestamp="swrun")
    want = jax_sw(JH.SimBeamSteering(rj), JH.SimCamera(rj),
                  str(tmp_path / "jax"), sleep_fn=lambda s: rj.sleep(s), **kw)
    res = run_sw_triggered(TH.SimBeamSteering(rt), TH.SimCamera(rt),
                           str(tmp_path / "sw"),
                           sleep_fn=lambda s: rt.sleep(s), **kw)
    # 2 axes x 2 tilts x 1 rep x 9 positions
    assert len(res["images"]) == 36
    run_dir = tmp_path / "sw" / "swrun"
    assert (run_dir / "results.json").exists()
    assert (run_dir / "images.csv").exists()
    assert res == want
    _assert_run_dirs_equal(run_dir, tmp_path / "jax" / "swrun")


def test_color_rig_bayer_path_feeds_rgb_workload(tmp_path):
    """A color rig renders an RGGB mosaic whose red plane carries the
    scene, so the rgb workloads' extract_red loaders work end to end."""
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    rig = rigs(smooth_scene(4, 1.5), color=True)[1]
    cam = TH.SimCamera(rig, hardware_trigger=True)
    assert cam.is_color

    frame = rig.render(rig.cfg.base_exposure_us)
    # red sites brighter than blue sites on average (mosaic applied)
    assert frame[0::2, 0::2].mean() > frame[1::2, 1::2].mean() * 1.2

    res = _collect_hw(TH, rig, tmp_path / "c", tilt_min=0.3125,
                      tilt_max=0.3125, num_repeats=1, timestamp="t")
    assert res["target_shift_px"] == 1.0  # color camera -> full-px target
    combo = os.path.join(str(tmp_path / "c"), "t", res["combos"][0])
    units = WORKLOADS["rgb_barcodes"].load(combo)
    assert units[0].frames.shape == (4, 48, 64)  # red plane = half size


# ---------------------------------------------------------------------------
# stability, autofocus, fault injection
# ---------------------------------------------------------------------------

def _knife_rigs(**kw):
    rj, rt = rigs(JH.knife_edge_scene((192, 256), edge_col=128.0), **kw)
    for rig in (rj, rt):
        rig.cfg.jitter_sigma_px = 0.02
    return rj, rt


def test_stability_on_simulator(tmp_path):
    """``run_stability`` through both packages: the port's summary holds
    the reference's bounds; each frame's edge position equals JAX's for
    the same frame within ``EDGE_ATOL``, and the run's within the effect of
    a +-1 uint8 difference."""
    from enph459_super_resolution_tpu.hw import stability as JS
    from enph459_super_resolution_tpu_torch.hw import stability as TS

    rj, rt = _knife_rigs()
    edge = TS.find_edge_position(TH.SimCamera(rt).capture_raw())
    JH.SimCamera(rj).capture_raw()  # keep the two streams in step
    assert abs(edge - 64.0) < 2.0  # LR grid = HR/2

    runs = {}
    for name, pkg, mod, rig in (("jax", JH, JS, rj), ("port", TH, TS, rt)):
        frames = []
        cam = pkg.SimCamera(rig)
        burst = cam.stream_burst

        def recording_burst(n, callback=None, _burst=burst, _f=frames):
            images, stamps = _burst(n, callback)
            _f.append(np.stack(images))
            return images, stamps

        cam.stream_burst = recording_burst
        summary = mod.run_stability(cam, pkg.SimBeamSteering(rig),
                                    str(tmp_path / name), tilt_deg=0.1,
                                    n_trials=2, num_frames=12,
                                    sleep_fn=lambda s, r=rig: r.sleep(s),
                                    figures=False)
        runs[name] = (summary, frames)
    summary, frames = runs["port"]
    for p in range(4):
        s = summary["positions"][f"pos{p}"]
        assert 0.0 <= s["sigma_mean_px"] < 0.5
    assert (tmp_path / "port" / "stability_trials.csv").exists()

    want_summary, want_frames = runs["jax"]
    assert len(frames) == len(want_frames) == 8
    for got_stack, want_stack in zip(frames, want_frames):
        for g, w in zip(got_stack, want_stack):
            assert_frames_close(g, w)
        np.testing.assert_allclose(TS.find_edge_positions(want_stack),
                                   JS.find_edge_positions(want_stack),
                                   rtol=0, atol=EDGE_ATOL)
        # a pixel one level off moves its column's mean by 1/96 of a
        # level, the crossing by that over the edge's slope (>= 50 levels
        # a px here)
        np.testing.assert_allclose(TS.find_edge_positions(got_stack),
                                   JS.find_edge_positions(want_stack),
                                   rtol=0, atol=np.abs(
                                       got_stack.astype(int) - want_stack)
                                   .sum(axis=(1, 2)).max() / 96 / 50
                                   + EDGE_ATOL)
    assert_tree_close(summary, want_summary, 1e-3)


def test_autofocus_finds_best_focus(tmp_path):
    from enph459_super_resolution_tpu.hw.autofocus import \
        autofocus_sweep as jax_sweep
    from enph459_super_resolution_tpu_torch.hw.autofocus import (
        autofocus_sweep, depth_of_field, save_autofocus_result)

    rj, rt = rigs(pinhole())
    want = jax_sweep(JH.SimCamera(rj),
                     JH.SimStage(rj, best_pos_mm=369.23,
                                 travel=(350.0, 390.0)),
                     350.0, 390.0, coarse_points=9, fine_points=7,
                     sleep_fn=lambda s: rj.sleep(s))
    cam = TH.SimCamera(rt)
    stage = TH.SimStage(rt, best_pos_mm=369.23, travel=(350.0, 390.0))
    res = autofocus_sweep(cam, stage, 350.0, 390.0, coarse_points=9,
                          fine_points=7, sleep_fn=lambda s: rt.sleep(s),
                          device="cpu")
    assert abs(res["best_pos_mm"] - 369.23) < 3.0
    assert abs(stage.get_position() - res["best_pos_mm"]) < 1e-9
    assert res["best_pos_mm"] == want["best_pos_mm"]
    assert res["positions"] == want["positions"]
    np.testing.assert_allclose(res["values"], want["values"], rtol=1e-3)

    dof, span = depth_of_field(res["positions"], res["values"])
    assert span[0] <= 369.23 <= span[1]
    path = save_autofocus_result(res, str(tmp_path / "af"))
    data = json.load(open(path))
    assert "dof_mm" in data


@pytest.mark.parametrize("metric", ["Laplacian Variance", "Peak Intensity",
                                    "Encircled Energy",
                                    "Normalized Variance"])
def test_focus_metrics_match_jax(metric):
    """Each focus metric of the same frames, whole and on an ROI, equals
    JAX's; the Laplacian variance (float32 on the device) within
    ``LAPLACIAN_RTOL``."""
    from enph459_super_resolution_tpu.hw.autofocus import \
        FOCUS_METRICS as JM
    from enph459_super_resolution_tpu_torch.hw.autofocus import focus_metric

    rig = rigs(pinhole(), read_noise=2.0)[1]
    rng = np.random.default_rng(3)
    frames = [rig.render(10000.0),
              rng.integers(0, 256, (64, 80)).astype(np.uint8)]
    for frame in frames:
        for roi in (None, (10, 20, 40, 30), (0, 0, 0, 0)):
            got = focus_metric(metric, frame, roi, device="cpu")
            want = JM[metric](frame, roi)
            np.testing.assert_allclose(got, want, rtol=LAPLACIAN_RTOL)


def test_fault_injection_empty_burst_retry(tmp_path):
    """Injected empty bursts exercise the stability retry path: one empty
    burst is retried and the trial succeeds; two consecutive empty bursts
    hard-fail like the reference (``rolling_stability.py:80-84``); both
    packages alike, edge for edge."""
    from enph459_super_resolution_tpu.hw.stability import \
        run_single_trial as jax_trial
    from enph459_super_resolution_tpu_torch.hw.stability import \
        run_single_trial

    rj, rt = _knife_rigs()
    angles = TH.get_xpr_angles(0.1)
    data = {}
    for name, pkg, trial, rig in (("jax", JH, jax_trial, rj),
                                  ("port", TH, run_single_trial, rt)):
        cam, xpr = pkg.SimCamera(rig), pkg.SimBeamSteering(rig)
        rig.cfg.fault_empty_burst = 1
        data[name] = trial(cam, xpr, angles, num_frames=4,
                           sleep_fn=lambda s, r=rig: r.sleep(s))
        assert len(data[name][0]["edges"]) == 4  # retry recovered
        rig.cfg.fault_empty_burst = 2
        with pytest.raises(RuntimeError, match="0 frames"):
            trial(cam, xpr, angles, num_frames=4,
                  sleep_fn=lambda s, r=rig: r.sleep(s))
        assert rig.cfg.fault_empty_burst == 0
    for p in range(4):
        assert data["port"][p]["timestamps"] == data["jax"][p]["timestamps"]
        assert data["port"][p]["fps"] == data["jax"][p]["fps"]
        np.testing.assert_allclose(data["port"][p]["edges"],
                                   data["jax"][p]["edges"], atol=1e-3)
    assert rt.rng.bit_generator.state == rj.rng.bit_generator.state


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_fault_injection_frame_timeout(rate):
    """Injected frame timeouts: at rate 1 every capture raises; at 0.5 the
    port times out on exactly the captures JAX's does (one rng stream)."""
    rj, rt = rigs()
    outcomes = {}
    for name, pkg, rig in (("jax", JH, rj), ("port", TH, rt)):
        rig.cfg.fault_frame_timeout_rate = rate
        cam = pkg.SimCamera(rig)
        outcomes[name] = []
        for _ in range(12):
            try:
                cam.capture_raw()
                outcomes[name].append("frame")
            except TimeoutError as exc:
                assert "injected" in str(exc)
                outcomes[name].append("timeout")
    assert outcomes["port"] == outcomes["jax"]
    assert ("frame" in outcomes["port"]) == (rate < 1.0)


# ---------------------------------------------------------------------------
# the port's device contract
# ---------------------------------------------------------------------------

def _entry_default_rig(tmp_path):
    return TH.SimulatedRig(scene=pinhole(), config=TH.SimConfig(
        lr_shape=(96, 128)))


def _entry_laplacian(tmp_path):
    from enph459_super_resolution_tpu_torch.hw.autofocus import \
        laplacian_variance

    return laplacian_variance(np.zeros((8, 8), np.uint8))


def _entry_centre(tmp_path):
    from enph459_super_resolution_tpu_torch.hw.calibrate import \
        find_pinhole_center

    return find_pinhole_center(np.zeros((64, 64), np.uint8))


def _entry_calibration(tmp_path):
    from enph459_super_resolution_tpu_torch.hw.calibrate import \
        run_calibration

    rig = rigs(pinhole())[1]
    return run_calibration(TH.SimBeamSteering(rig), TH.SimCamera(rig),
                           str(tmp_path / "cal"), tilt_steps=1,
                           num_repeats=1, sleep_fn=rig.sleep)


def _entry_autofocus(tmp_path):
    from enph459_super_resolution_tpu_torch.hw.autofocus import \
        autofocus_sweep

    rig = rigs(pinhole())[1]
    return autofocus_sweep(TH.SimCamera(rig), TH.SimStage(rig), 340.0,
                           400.0, coarse_points=3, fine_points=3,
                           sleep_fn=rig.sleep)


@pytest.mark.parametrize("entry", [_entry_default_rig, _entry_laplacian,
                                   _entry_centre, _entry_calibration,
                                   _entry_autofocus],
                         ids=lambda f: f.__name__[7:])
def test_rig_entry_points_default_to_cuda(entry, tmp_path):
    """Every rig entry point's device defaults to ``cuda``: without a card
    it raises (no quiet CPU run) and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        entry(tmp_path)
    assert not (tmp_path / "cal").exists()


# ---------------------------------------------------------------------------
# the thesis, end to end on the port's simulator
# ---------------------------------------------------------------------------

def barcode_scene():
    """The geometry of ``tests/test_ean13.py``: one EAN-13 code at 2 HR px
    per module, 96 rows, centred in a flat 235 scene of 192 x 512."""
    from enph459_super_resolution_tpu_torch.eval import ean13

    bc = ean13.render(DIGITS, module_px=2, height_px=96)
    scene = np.full((192, 512), 235.0)
    x0 = (512 - bc.shape[1]) // 2
    scene[48:144, x0:x0 + bc.shape[1]] = bc
    return scene


def conf(img):
    from enph459_super_resolution_tpu_torch.eval import ean13
    from enph459_super_resolution_tpu_torch.eval.decode import \
        decode_confidence

    u8 = np.clip(img, 0, 255).astype(np.uint8)
    return decode_confidence(u8, (0, u8.shape[0], 0, u8.shape[1]),
                             decoder=ean13.decode)


def test_sr_recovers_undecodable_barcode():
    """The reference project's thesis on the port's simulator: the 2x
    bicubic of the LR mean and the native 2x zoom do not decode, 4-frame
    SAA+IBP decodes at confidence 1.0; the digits and confidences equal
    JAX's stack's (``tests/test_ean13.py``), run here on the same frames'
    JAX counterparts."""
    import jax.numpy as jnp

    from enph459_super_resolution_tpu.ops.resize import \
        bicubic_upsample as jax_bicubic
    from enph459_super_resolution_tpu.sr import solve as jax_solve
    from enph459_super_resolution_tpu_torch.ops.resize import \
        bicubic_upsample
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve)

    cfg = dict(lr_shape=(96, 256), jitter_sigma_px=0.002,
               unsettled_jitter_px=0.0, seed=7, read_noise=0.5,
               shot_noise_scale=0.005)
    stacks = {}
    for name, pkg, kw in (("jax", JH, {}), ("port", TH, {"device": "cpu"})):
        rig = pkg.SimulatedRig(scene=barcode_scene(),
                               config=pkg.SimConfig(**cfg), **kw)
        xpr = pkg.SimBeamSteering(rig)
        cam = pkg.SimCamera(rig, hardware_trigger=True)
        xpr.setup_trigger_output()
        frames = []
        for sx, sy in [(-1, 1), (1, 1), (-1, -1), (1, -1)]:
            xpr.set_angles(sx * 0.15625, sy * 0.15625)  # 0.5 px at gain 3.2
            rig.sleep(0.05)
            xpr.send_trigger_pulse()
            frames.append(cam.capture_raw())
        stacks[name] = np.stack(frames)
    for g, w in zip(stacks["port"], stacks["jax"]):
        assert_frames_close(g, w)

    shifts = ((0.5, -0.5), (0.5, 0.5), (-0.5, -0.5), (-0.5, 0.5))
    frames = stacks["port"].astype(np.float32)
    out = solve(torch.as_tensor(frames), make_gaussian_psf(), shifts,
                n_iter=60, device="cpu")
    lr_up = bicubic_upsample(torch.as_tensor(frames.mean(0))[None, :, :,
                                                            None],
                             2)[0, :, :, 0].numpy()
    got = [conf(lr_up), conf(out["native"]), conf(out["ibp"])]
    assert got[0] == (None, 0.0)                  # bicubic: dead
    assert got[1] == (None, 0.0)                  # native-2x: dead
    assert got[2] == (DIGITS, 1.0)                # SAA+IBP: alive

    jf = stacks["jax"].astype(np.float32)
    jout = jax_solve(jnp.asarray(jf), make_gaussian_psf(), shifts, n_iter=60)
    jlr_up = np.asarray(jax_bicubic(jnp.asarray(jf.mean(0))[None, :, :, None],
                                    2))[0, :, :, 0]
    want = [conf(jlr_up), conf(np.asarray(jout["native"])),
            conf(np.asarray(jout["ibp"]))]
    assert got == want


def test_sr_run_decodes_the_collected_barcode(tmp_path):
    """The rig's drive at a small size through the port's entry points:
    calibrate a pinhole rig, collect a barcode rig's hardware-triggered
    run with the special run at the calibration's 0.5 px tilts, fuse every
    unit with ``sr.run --workload mono_barcodes``, decode ``SAA_IBP.png``
    (confidence 1.0) and not the 2x bicubic of the LR mean (default
    SimConfig noise)."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.ops.resize import \
        bicubic_upsample
    from enph459_super_resolution_tpu_torch.sr import run

    lr = (96, 256)
    cal_rig = TH.SimulatedRig(scene=JH.pinhole_scene((192, 512)),
                              config=TH.SimConfig(lr_shape=lr), device="cpu")
    from enph459_super_resolution_tpu_torch.hw.calibrate import \
        run_calibration
    run_calibration(TH.SimBeamSteering(cal_rig), TH.SimCamera(cal_rig),
                    str(tmp_path / "cal"), tilt_min=0.1, tilt_max=0.3,
                    tilt_steps=3, num_repeats=2, settle_ms=50.0,
                    sleep_fn=cal_rig.sleep, save_images=False, device="cpu")
    rig = TH.SimulatedRig(scene=barcode_scene(),
                          config=TH.SimConfig(lr_shape=lr), device="cpu")
    res = _collect_hw(TH, rig, tmp_path / "col", num_repeats=2,
                      special_run=True,
                      calibration_csv=str(tmp_path / "cal" / "shifts.csv"),
                      timestamp="run")
    assert len(res["combos"]) == 2 and res["special_run"] is not None
    rc = run.main(["--workload", "mono_barcodes", "--data-dir",
                   str(tmp_path / "col" / "run"), "--output-dir",
                   str(tmp_path / "out"), "--no-figures", "--device", "cpu"])
    assert rc == 0
    units = sorted(p.parent for p in (tmp_path / "out").rglob("done.flag"))
    assert len(units) == 4
    for unit in units:
        assert conf(load_gray(str(unit / "SAA_IBP.png"))) == (DIGITS, 1.0)
        lr_mean = load_gray(str(unit / "LR_mean.png"))
        up = bicubic_upsample(torch.as_tensor(lr_mean)[None, :, :, None],
                              2)[0, :, :, 0].numpy()
        assert conf(up) == (None, 0.0)


# ---------------------------------------------------------------------------
# the Zaber port scan (hw/real.py, as in tests/test_hw.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["enph459_super_resolution_tpu",
                                 "enph459_super_resolution_tpu_torch"])
def test_zaber_discover_probes_ports(monkeypatch, pkg):
    """ZaberStage._discover scans candidate serial ports and returns the
    first connection whose device chain answers; the port and JAX's probe
    alike."""
    real = __import__(f"{pkg}.hw.real", fromlist=["x"])
    opened, closed = [], []

    class FakeConn:
        def __init__(self, port, devices):
            self.port, self._devices = port, devices

        def detect_devices(self):
            if self._devices is None:
                raise RuntimeError("no response")
            return self._devices

        def close(self):
            closed.append(self.port)

    class FakeConnection:
        table = {"/dev/fake0": [], "/dev/fake2": ["dev"]}

        @staticmethod
        def open_serial_port(port):
            opened.append(port)
            if port == "/dev/fake1":
                raise OSError("busy")
            return FakeConn(port, FakeConnection.table.get(port))

    import glob as glob_mod
    import sys
    monkeypatch.setattr(glob_mod, "glob",
                        lambda pat: ["/dev/fake0", "/dev/fake1"]
                        if "USB" in pat else ["/dev/fake2"])
    monkeypatch.setitem(sys.modules, "serial", None)

    conn, devices = real.ZaberStage._discover(FakeConnection)
    assert conn.port == "/dev/fake2" and devices == ["dev"]
    assert opened == ["/dev/fake0", "/dev/fake1", "/dev/fake2"]
    assert closed == ["/dev/fake0"]


def test_zaber_discover_no_devices(monkeypatch):
    from enph459_super_resolution_tpu_torch.hw.real import ZaberStage

    class FakeConnection:
        @staticmethod
        def open_serial_port(port):
            raise OSError("no such port")

    import glob as glob_mod
    import sys
    monkeypatch.setattr(glob_mod, "glob", lambda pat: ["/dev/fakeX"])
    monkeypatch.setitem(sys.modules, "serial", None)
    with pytest.raises(RuntimeError, match="no Zaber devices"):
        ZaberStage._discover(FakeConnection)
