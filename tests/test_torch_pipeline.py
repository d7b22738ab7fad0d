"""The port's ``sr.run`` CLI against the JAX package's on the same session
directories (``--device cpu`` for the port): the same artifacts within +-1
uint8 for all four workloads (the rgb ones on RGGB mosaics, rgb_cal_target
with its metadata shifts), ``metrics.json`` with the same keys,
``done.flag`` resume, serve mode (``--watch``), and the learned burst
engine (``--fusion-run``): ``fusion.png`` within +-1 uint8 of the JAX CLI's
and ``fusion_forward_mse`` (and ``_raw``) within rtol 1e-4, the JAX run
carried across with ``convert.save_burst_run``."""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from enph459_super_resolution_tpu.sr import run as jax_run
from enph459_super_resolution_tpu_torch.data.io import load_image, save_png
from enph459_super_resolution_tpu_torch.sr import run as torch_run

ARTIFACTS = ("native_2x.png", "SAA.png", "SAA_IBP.png", "shifts.json",
             "metrics.json", "done.flag")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores (a tiny solve
    then takes a minute instead of a fraction of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(rng, shape=(64, 80)):
    return ndi.gaussian_filter(rng.uniform(0, 255, shape), 1.2)


def _noisy(rng, scene):
    return np.clip(scene + rng.normal(0, 1, scene.shape), 0,
                   255).astype(np.uint8)


def _mosaic(rng, scene):
    """An RGGB mosaic whose red plane (even rows and columns) is a noisy
    ``scene`` and whose other sites hold other noise."""
    h, w = scene.shape
    out = rng.uniform(0, 255, (2 * h, 2 * w))
    out[::2, ::2] = scene + rng.normal(0, 1, scene.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


@pytest.fixture()
def sessions(tmp_path):
    """A corner_rep session of 2 reps (batched path) and a center+4
    session, and for the rgb workloads RGGB corner_rep sessions of 2 reps
    (rgb_cal_target's with a metadata.json), each under its own data
    dir."""
    rng = np.random.default_rng(0)
    corner = tmp_path / "corner" / "tiny_mono_session"
    scene = _scene(rng)
    for ci in range(4):
        for ri in range(2):
            save_png(_noisy(rng, scene),
                     str(corner / f"corner{ci}_rep{ri:02d}.png"))
    center = tmp_path / "center" / "cal0"
    for name in ("center.png", "shift_0.png", "shift_1.png", "shift_2.png",
                 "shift_3.png"):
        save_png(_noisy(rng, scene), str(center / name))
    rgb_bar = tmp_path / "rgb_bar" / "tiny_rgb_session"
    rgb_cal = tmp_path / "rgb_cal" / "cal_rgb"
    for sdir in (rgb_bar, rgb_cal):
        for ci in range(4):
            for ri in range(2):
                save_png(_mosaic(rng, scene),
                         str(sdir / f"corner{ci}_rep{ri:02d}.png"))
    # sensor-pixel shifts off the nominal +-1 (LR = sensor / 2)
    meta = {"expected_shifts": {
        label: {"dy_px": dy, "dx_px": dx} for label, (dy, dx) in zip(
            ("(-x,+y)", "(+x,+y)", "(-x,-y)", "(+x,-y)"),
            ((1.1, -0.9), (0.9, 1.2), (-1.0, -1.1), (-0.8, 0.9)))}}
    (rgb_cal / "metadata.json").write_text(json.dumps(meta))
    return {"mono_barcodes": (str(corner.parent), ["tiny_mono_session/rep0",
                                                   "tiny_mono_session/rep1"]),
            "mono_cal_target": (str(center.parent), ["cal0"]),
            "rgb_barcodes": (str(rgb_bar.parent), ["tiny_rgb_session/rep0",
                                                   "tiny_rgb_session/rep1"]),
            "rgb_cal_target": (str(rgb_cal.parent), ["cal_rgb"])}


def _args(workload, data, out):
    return ["--workload", workload, "--data-dir", data, "--output-dir", out,
            "--no-figures"]


@pytest.mark.parametrize("workload", ["mono_barcodes", "mono_cal_target",
                                      "rgb_barcodes", "rgb_cal_target"])
def test_cli_matches_jax_cli(sessions, tmp_path, workload):
    data, units = sessions[workload]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    lr_name = "LR_red_mean.png" if workload.startswith("rgb") \
        else "LR_mean.png"
    assert jax_run.main(_args(workload, data, out_j)) == 0
    assert torch_run.main(_args(workload, data, out_t)
                          + ["--device", "cpu"]) == 0
    for unit in units:
        uj, ut = os.path.join(out_j, unit), os.path.join(out_t, unit)
        for name in ARTIFACTS + (lr_name,):
            assert os.path.exists(os.path.join(ut, name)), (unit, name)
        for name in ("native_2x.png", "SAA.png", "SAA_IBP.png", lr_name):
            a = load_image(os.path.join(uj, name)).astype(int)
            b = load_image(os.path.join(ut, name)).astype(int)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1, (unit, name)
        mj = json.load(open(os.path.join(uj, "metrics.json")))
        mt = json.load(open(os.path.join(ut, "metrics.json")))
        assert set(mj) == set(mt)
        assert mt["hr_shape"] == mj["hr_shape"] == [128, 160]
        np.testing.assert_allclose(mt["mse_history"], mj["mse_history"],
                                   rtol=1e-4)
        sj = json.load(open(os.path.join(uj, "shifts.json")))
        st = json.load(open(os.path.join(ut, "shifts.json")))
        assert sj == st


def test_cli_done_flag_resume_and_force(sessions, tmp_path, capsys):
    data, units = sessions["mono_barcodes"]
    out = str(tmp_path / "torch")
    args = _args("mono_barcodes", data, out) + ["--device", "cpu"]
    assert torch_run.main(args) == 0
    metrics = os.path.join(out, units[0], "metrics.json")
    stamp = os.stat(metrics).st_mtime_ns
    capsys.readouterr()
    assert torch_run.main(args) == 0
    said = capsys.readouterr().out
    assert "0 unit(s) processed" in said and "[skip]" in said
    assert os.stat(metrics).st_mtime_ns == stamp
    assert torch_run.main(args + ["--force", "--no-batch-reps"]) == 0
    assert "2 unit(s) processed" in capsys.readouterr().out
    assert os.stat(metrics).st_mtime_ns != stamp


def test_watch_serve_mode(sessions, tmp_path, monkeypatch, capsys):
    """``--watch``: the existing sessions are served on the first poll; a
    session that fails to load (still being written) is deferred and taken
    once complete; a served session whose listing changes (a late rep) is
    served again, its finished units skipped by their done.flag."""
    import shutil

    data_dir, _ = sessions["mono_barcodes"]
    tiny = os.path.join(data_dir, "tiny_mono_session")
    out = str(tmp_path / "serve_out")
    broken = os.path.join(data_dir, "tiny_mono_session2")
    os.makedirs(broken)
    with open(os.path.join(broken, "corner0_rep00.png"), "wb") as fp:
        fp.write(b"this is not a png")  # collection still writing
    polls = {"n": 0}

    def fake_sleep(_):
        polls["n"] += 1
        if polls["n"] == 1:  # the collector finishes the session
            shutil.rmtree(broken)
            shutil.copytree(tiny, broken)
        elif polls["n"] == 2:  # and appends a third rep to the first one
            src = os.path.join(tiny, "corner0_rep00.png")
            for ci in range(4):
                shutil.copy(src, os.path.join(tiny, f"corner{ci}_rep02.png"))

    monkeypatch.setattr(torch_run.time, "sleep", fake_sleep)
    assert torch_run.main(_args("mono_barcodes", data_dir, out)
                          + ["--device", "cpu", "--watch", "0.01",
                             "--watch-polls", "4"]) == 0
    said = capsys.readouterr().out
    for sess in ("tiny_mono_session", "tiny_mono_session2"):
        for rep in ("rep0", "rep1"):
            assert os.path.exists(os.path.join(out, sess, rep, "done.flag"))
    assert os.path.exists(os.path.join(out, "tiny_mono_session", "rep2",
                                       "done.flag"))
    assert "[defer] tiny_mono_session2" in said
    assert os.path.join("tiny_mono_session", "rep0") + " - already done" \
        in said
    assert "watch done: 5 unit(s) processed over 4 poll(s)" in said


FUSION_CASES = {
    "net_only": [],
    "banded_refine": ["--fusion-refine", "3"],
    "vjp_refine": ["--fusion-refine", "2", "--fusion-refine-engine", "vjp",
                   "--fusion-refine-step", "1.5"],
}


@pytest.fixture(scope="module")
def burst_runs(tmp_path_factory):
    """A JAX burst run (LR arch) and its port copy."""
    from test_torch_fusion import jax_burst_run, port_run_from_jax

    base = tmp_path_factory.mktemp("fusion_runs")
    jdir, tdir = str(base / "jax"), str(base / "port")
    jax_burst_run(jdir)
    port_run_from_jax(jdir, tdir)
    return jdir, tdir


@pytest.mark.parametrize("case", sorted(FUSION_CASES))
def test_cli_fusion_run_matches_jax_cli(sessions, burst_runs, tmp_path,
                                        case):
    data, units = sessions["mono_barcodes"]
    jdir, tdir = burst_runs
    flags = FUSION_CASES[case]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_run.main(_args("mono_barcodes", data, out_j)
                        + ["--fusion-run", jdir] + flags) == 0
    assert torch_run.main(_args("mono_barcodes", data, out_t)
                          + ["--fusion-run", tdir, "--device", "cpu"]
                          + flags) == 0
    for unit in units:
        uj, ut = os.path.join(out_j, unit), os.path.join(out_t, unit)
        a = load_image(os.path.join(uj, "fusion.png")).astype(int)
        b = load_image(os.path.join(ut, "fusion.png")).astype(int)
        assert a.shape == b.shape == (128, 160)
        assert np.abs(a - b).max() <= 1, unit
        mj = json.load(open(os.path.join(uj, "metrics.json")))
        mt = json.load(open(os.path.join(ut, "metrics.json")))
        assert set(mj) == set(mt)
        assert "fusion" in mt["timings_s"]
        keys = ["fusion_forward_mse"] + (["fusion_forward_mse_raw"]
                                         if flags else [])
        assert [k for k in mt if k.startswith("fusion")] == keys
        for k in keys:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4)
        if flags:
            assert mt["fusion_forward_mse"] < mt["fusion_forward_mse_raw"]


def test_cli_fusion_without_a_card_exits_2(sessions, burst_runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    data, _ = sessions["mono_barcodes"]
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        torch_run.main(_args("mono_barcodes", data, str(out))
                       + ["--fusion-run", burst_runs[1]])
    assert exc.value.code == 2
    assert not out.exists()


def test_cli_fusion_factor_check(sessions, burst_runs, tmp_path,
                                 monkeypatch):
    """A workload at another factor than the run's is refused (exit 2)."""
    import dataclasses

    from enph459_super_resolution_tpu_torch.sr import config

    data, _ = sessions["mono_barcodes"]
    monkeypatch.setitem(config.WORKLOADS, "mono_barcodes", dataclasses.replace(
        config.WORKLOADS["mono_barcodes"], upsample_factor=3))
    with pytest.raises(SystemExit) as exc:
        torch_run.main(_args("mono_barcodes", data, str(tmp_path / "o"))
                       + ["--fusion-run", burst_runs[1], "--device", "cpu"])
    assert exc.value.code == 2
