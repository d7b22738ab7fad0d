"""The port's slanted-edge MTF and cal-target analysis
(``eval/slanted_edge.py``, ``eval/cal_target_analysis.py``) against the
JAX package's, on the CPU.

The JAX side runs under ``tests/conftest.py``'s ``jax_enable_x64``: the
edge gradients are float64 in both, so the ESF, MTF and edge angle of a
slanted edge agree within 1e-10 and the HR methods' MTF50/MTF10/contrast
within 1e-8 relative.  The LR mean's bicubic zoom is float32 in both (the
reference casts it so): its pixels carry float32 rounding of two
implementations (7.6e-5 at most here), held at 2e-4 on the 0..255 range,
and the "LR bicubic 2x" numbers (8.7e-8 here) at 1e-6 relative.
"""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi

from enph459_super_resolution_tpu.eval import cal_target_analysis as JCT
from enph459_super_resolution_tpu.eval import slanted_edge as JSE
from enph459_super_resolution_tpu_torch.eval import cal_target_analysis as TCT
from enph459_super_resolution_tpu_torch.eval import slanted_edge as TSE

# the small results directory's geometry (HR px)
GEOMETRY = dict(profile_col=60, roi1_rows=(20, 120), roi2=(130, 250, 110, 250),
                pixel_pitch_um=3.45, upsample=2)
HR_RTOL = 1e-8
LR_RTOL = 1e-6
LR_ATOL = 2e-4  # float32 zoom pixels, 0..255
KEYS = ("mtf50", "mtf10", "mtf50_full", "mtf10_full", "contrast_peak",
        "contrast_mean", "edge_angle_deg", "nyquist")


def make_slanted_edge(h=96, w=96, angle_deg=5.0, blur_sigma=1.2,
                      lo=30.0, hi=220.0):
    """``tests/test_eval.py``'s synthetic slanted step edge."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    m = np.tan(np.radians(angle_deg))
    edge_c = w / 2 + m * (yy - h / 2)
    img = np.where(xx > edge_c, hi, lo)
    return ndi.gaussian_filter(img, blur_sigma)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("angle,noise", [(5.0, 0.0), (-8.0, 0.5),
                                         (84.0, 0.5)])
def test_slanted_edge_esf_and_mtf_match_jax(side, angle, noise):
    """``tests/test_eval.py``'s edge, and noisy edges at other angles (a
    noiseless edge at most angles has gradient magnitudes tied at the
    85th percentile, which rounding of either package's filters splits
    either way)."""
    roi = make_slanted_edge(angle_deg=angle)
    roi = roi + np.random.default_rng(7).normal(0, noise, roi.shape)
    got = TSE.slanted_edge_esf(roi, side=side, device="cpu")
    want = JSE.slanted_edge_esf(roi, side=side)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    assert abs(got[2] - want[2]) < 1e-10
    for g, w in zip(TSE.esf_to_mtf(*got[:2]), JSE.esf_to_mtf(*want[:2])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_slanted_edge_mtf_recovers_the_blur_and_matches_jax():
    sigma = 1.2
    roi = make_slanted_edge(blur_sigma=sigma)
    got = TSE.slanted_edge_mtf(roi, pixel_pitch_mm=1.725e-3, device="cpu")
    want = JSE.slanted_edge_mtf(roi, pixel_pitch_mm=1.725e-3)
    assert sorted(got) == sorted(want)
    for k in ("freq", "mtf", "lsf", "esf_x", "esf_y"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-10)
    assert abs(got["angle_deg"] - want["angle_deg"]) < 1e-10
    freq = got["freq"] * 1.725e-3
    sel = freq <= 0.4
    gauss = np.exp(-2 * (np.pi * sigma * freq) ** 2)
    assert np.max(np.abs(got["mtf"][sel] - gauss[sel])) < 0.08


def test_no_edge_raises_runtime_error_as_jax():
    flat = np.full((64, 64), 100.0)
    with pytest.raises(RuntimeError):
        JSE.slanted_edge_esf(flat)
    with pytest.raises(TSE.EdgeNotFound) as exc:
        TSE.slanted_edge_esf(flat, device="cpu")
    assert isinstance(exc.value, RuntimeError)


def _scene():
    """256 x 256: bars along rows 20:120 at column 60 (the ROI-1 profile),
    one step edge slanted 6 degrees in ROI-2."""
    h = w = 256
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.where(xx > 180 + np.tan(np.radians(6.0)) * (yy - 190), 215.0,
                   35.0)
    bars = np.where((yy // (3 + yy // 40)) % 2, 220.0, 30.0)
    img[10:125, 20:100] = bars[10:125, 20:100]
    return img


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """A results directory as ``sr.run`` writes one: three HR methods of
    growing sharpness and the LR mean at half size."""
    from enph459_super_resolution_tpu_torch.data.io import save_png

    rdir = tmp_path_factory.mktemp("cal") / "unit"
    scene = _scene()
    rng = np.random.default_rng(2)
    for fname, sigma in (("native_2x.png", 1.8), ("SAA.png", 1.4),
                         ("SAA_IBP.png", 1.0)):
        img = ndi.gaussian_filter(scene, sigma) + rng.normal(0, 1.0,
                                                             scene.shape)
        save_png(np.clip(img, 0, 255).astype(np.uint8),
                 str(rdir / fname))
    lr = ndi.gaussian_filter(scene, 1.2)[::2, ::2]
    save_png(np.clip(lr, 0, 255).astype(np.uint8), str(rdir / "LR_mean.png"))
    return str(rdir)


def test_load_results_dir_matches_jax(results_dir):
    got = TCT.load_results_dir(results_dir, device="cpu")
    want = JCT.load_results_dir(results_dir)
    assert list(got) == list(want) == ["LR bicubic 2x", "Native-2x", "SAA",
                                       "SAA+IBP"]
    for name, w in want.items():
        assert got[name].dtype == w.dtype == np.float64
        atol = LR_ATOL if name == "LR bicubic 2x" else 0.0
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


def _close(got, want, name):
    rtol = LR_RTOL if name == "LR bicubic 2x" else HR_RTOL
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   err_msg=f"{name} {k}")
    assert got["freq_unit"] == want["freq_unit"]


def test_analyse_matches_jax(results_dir):
    got = TCT.analyse(results_dir, **GEOMETRY, device="cpu")
    want = JCT.analyse(results_dir, **GEOMETRY)
    assert sorted(got) == sorted(want)
    for k in ("profile_col_hr", "roi1_rows_hr", "roi2_hr", "hr_pitch_mm"):
        assert got[k] == want[k], k
    assert list(got["methods"]) == list(want["methods"])
    for name, rec in want["methods"].items():
        _close(got["methods"][name], rec, name)
        np.testing.assert_allclose(got["methods"][name]["profile"],
                                   rec["profile"], rtol=0, atol=LR_ATOL)
    m = got["methods"]
    assert m["SAA+IBP"]["mtf50"] > m["SAA"]["mtf50"] > m["Native-2x"]["mtf50"]
    assert m["SAA+IBP"]["contrast_peak"] > 0.5


def test_cli_writes_the_jax_analysis_json(results_dir, tmp_path, capsys):
    flags = [results_dir, "--profile-col", "60", "--roi1-rows", "20", "120",
             "--roi2", "130", "250", "110", "250", "--no-figures"]
    out = {}
    for name, mod, extra in (("port", TCT, ["--device", "cpu"]),
                             ("jax", JCT, [])):
        d = tmp_path / name
        assert mod.main([*flags, "--out-dir", str(d), *extra]) == 0
        out[name] = json.loads((d / "analysis.json").read_text())
        assert not (d / "cross_section.png").exists()
    assert "SAA+IBP" in capsys.readouterr().out
    got, want = out["port"], out["jax"]
    assert sorted(got) == sorted(want)
    for name, rec in want["methods"].items():
        assert "profile" not in got["methods"][name]
        _close(got["methods"][name], rec, name)


def test_cli_presets_match_jax():
    assert TCT.PRESETS == JCT.PRESETS
    assert TCT.METHODS == JCT.METHODS


def test_cli_without_a_card_exits_nonzero(results_dir, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    out = tmp_path / "o"
    with pytest.raises(SystemExit) as exc:
        TCT.main([results_dir, "--out-dir", str(out), "--no-figures"])
    assert exc.value.code != 0
    assert not out.exists()
