"""The port's barcode analyses (``eval/decode.py``, ``eval/code128.py``,
``eval/ean13.py``, ``eval/barcode_analysis.py``) against the JAX package's.

All four run on the host in both packages, so every result is held
exactly: rendered images, decoded payloads, the seeded jitter offsets and
every decode-confidence record.  The real-data case runs on this build's
SR outputs checked in under ``artifacts/rgb_barcodes/results/`` (their
``decode_confidence.json`` is the JAX CLI's output, goldened by
``tests/test_code128.py::TestOurSrOutputs``).
"""

import json
import os

import numpy as np
import pytest

from enph459_super_resolution_tpu.eval import barcode_analysis as JBA
from enph459_super_resolution_tpu.eval import code128 as JC
from enph459_super_resolution_tpu.eval import decode as JD
from enph459_super_resolution_tpu.eval import ean13 as JE
from enph459_super_resolution_tpu_torch.eval import barcode_analysis as TBA
from enph459_super_resolution_tpu_torch.eval import code128 as TC
from enph459_super_resolution_tpu_torch.eval import decode as TD
from enph459_super_resolution_tpu_torch.eval import ean13 as TE

OURS = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                    "rgb_barcodes", "results")
SESS_46 = "4_6_mil_color_tilt 0.28256_settle50ms"
DIGITS = "5901234123457"


def _committed():
    with open(os.path.join(OURS, "decode_confidence.json")) as fp:
        return json.load(fp)


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("payload", ["005.0r-018c+015", "ABC 123x",
                                     "0123456789"])
@pytest.mark.parametrize("module_px", [2, 3, 5])
def test_code128_render_decode_round_trip(payload, module_px):
    img = TC.render(payload, module_px=module_px)
    np.testing.assert_array_equal(img, JC.render(payload,
                                                 module_px=module_px))
    for scan in (img, img[:, ::-1]):  # both scan directions
        assert TC.decode(scan) == payload == JC.decode(scan)


@pytest.mark.parametrize("text", ["Wikipedia", "10123456", "A1234567",
                                  "004.0r-006c+049"])
def test_code128_encode_values_equal(text):
    assert TC.encode_values(text) == JC.encode_values(text)


@pytest.mark.parametrize("bad", ["café", ""])
def test_code128_encode_rejects_as_jax(bad):
    with pytest.raises(ValueError):
        JC.encode_values(bad)
    with pytest.raises(ValueError):
        TC.encode_values(bad)


@pytest.mark.parametrize("spread", [1, 2])
def test_code128_ink_spread_and_noise(spread):
    payload = "004.0r-006c+049"
    img = TC.render(payload, module_px=5, ink_spread_px=spread)
    np.testing.assert_array_equal(img, JC.render(payload, module_px=5,
                                                 ink_spread_px=spread))
    assert TC.decode(img) == payload
    rng = np.random.default_rng(spread)
    clean = TC.render("3 mil test", module_px=4)
    noisy = np.clip(clean + rng.normal(0, 12, clean.shape), 0, 255)
    assert TC.decode(noisy) == JC.decode(noisy)


def test_code128_rejects_garbage_and_bad_checksum_as_jax():
    rng = np.random.default_rng(0)
    garbage = rng.uniform(0, 255, (40, 600))
    img = TC.render("HELLO-42", module_px=4)
    img[:, 40 * 4:51 * 4] = 255.0
    for case in (garbage, np.full((40, 600), 128.0), img):
        assert TC.decode(case) == JC.decode(case)
    assert TC.decode(garbage) is None and TC.decode(img) != "HELLO-42"


@pytest.mark.parametrize("module_px", [1, 2, 3, 5])
def test_ean13_render_decode_round_trip(module_px):
    img = TE.render(DIGITS, module_px=module_px)
    np.testing.assert_array_equal(img, JE.render(DIGITS,
                                                 module_px=module_px))
    for scan in (img, img[:, ::-1]):
        assert TE.decode(scan) == DIGITS == JE.decode(scan)


def test_ean13_checksum_bits_and_degraded_decode():
    assert TE.checksum(DIGITS[:12]) == JE.checksum(DIGITS[:12])
    np.testing.assert_array_equal(TE.encode_bits(DIGITS),
                                  JE.encode_bits(DIGITS))
    with pytest.raises(ValueError):
        TE.encode_bits("5901234123450")  # bad check digit, as JAX
    import scipy.ndimage as ndi

    rng = np.random.default_rng(1)
    img = TE.render(DIGITS, module_px=3)
    degraded = np.clip(ndi.gaussian_filter(img, 1.0)
                       + rng.normal(0, 3, img.shape), 0, 255)
    assert TE.decode(degraded) == DIGITS == JE.decode(degraded)
    flat = np.full((60, 300), 128.0)
    assert TE.decode(flat) is None and JE.decode(flat) is None


# --------------------------------------------------------------------------
# the jittered-crop confidence protocol
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_trials,max_jitter,seed", [(25, 2, 42),
                                                      (10, 3, 7)])
def test_jitter_offsets_equal(n_trials, max_jitter, seed):
    got = TD.jitter_offsets(n_trials, max_jitter, seed)
    np.testing.assert_array_equal(got, JD.jitter_offsets(n_trials,
                                                         max_jitter, seed))
    assert got.shape == (n_trials, 2) and np.abs(got).max() <= max_jitter


def test_jittered_crops_and_injected_decoder_equal():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (100, 120)).astype(np.uint8)
    roi = (1, 60, 30, 119)  # jitter runs past two image bounds
    offsets = TD.jitter_offsets()
    for got, want in zip(TD.jittered_crops(img, roi, offsets),
                         JD.jittered_crops(img, roi, offsets)):
        np.testing.assert_array_equal(got, want)

    def fake(crop):
        return "HELLO" if crop.shape[0] >= 59 else None

    assert (TD.decode_confidence(img, roi, decoder=fake)
            == JD.decode_confidence(img, roi, decoder=fake))
    assert TD.HAVE_ZXING == JD.HAVE_ZXING


@pytest.mark.skipif(TD.HAVE_ZXING, reason="zxing-cpp is installed")
def test_zxing_absent_raises_and_cli_refuses(tmp_path, capsys):
    with pytest.raises(ImportError):
        TD.decode(np.zeros((4, 4), np.uint8))
    args = [OURS, "--rois", "rgb", "--decoder", "zxing", "--out",
            str(tmp_path / "o.json"), "--figure", "none"]
    assert TBA.main(args) == JBA.main(args) == 2
    assert not (tmp_path / "o.json").exists()
    assert "zxing-cpp not installed" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the committed real-session SR outputs
# --------------------------------------------------------------------------

def _load_u8(path):
    from enph459_super_resolution_tpu_torch.data.io import load_gray

    return load_gray(path, dtype=np.float64).astype(np.uint8)


def test_payloads_on_committed_outputs_equal_jax_and_json():
    """Every (rep, method, barcode) centre crop decodes to the same
    payload in both packages, and to the committed record's text."""
    want = {(s["session"], r["rep"], r["method"], r["label"]):
            r["decoded_text"]
            for s in _committed()["sessions"] for r in s["records"]}
    files = dict(TBA.METHODS)
    seen = 0
    for (sess, rep, method, label), text in want.items():
        (roi,) = [b["roi"] for b in TBA.RGB_SESSION_ROIS[sess]
                  if b["label"] == label]
        r0, r1, c0, c1 = roi
        crop = _load_u8(os.path.join(OURS, sess, rep,
                                     files[method]))[r0:r1, c0:c1]
        got = TC.decode(crop)
        assert got == text, (sess, rep, method, label)
        if method == "SAA+IBP":  # the JAX decoder is slow on failing crops
            assert JC.decode(crop) == got
        seen += 1
    assert seen == 40


def test_analyse_session_equals_jax_on_one_rep(tmp_path):
    """``analyse_session`` record by record against the JAX function's on
    one rep of the 4/6-mil session, its SAA+IBP output (the JAX decoder
    takes a minute and a half over every method; the CLI test below holds
    them all to the JAX CLI's committed output)."""
    sdir = tmp_path / SESS_46
    (sdir / "rep0").mkdir(parents=True)
    os.symlink(os.path.abspath(os.path.join(OURS, SESS_46, "rep0",
                                            "SAA_IBP.png")),
               sdir / "rep0" / "SAA_IBP.png")
    rois = TBA.RGB_SESSION_ROIS[SESS_46]
    assert rois == JBA.RGB_SESSION_ROIS[SESS_46]
    got = TBA.analyse_session(str(sdir), rois, decoder=TC.decode)
    want = JBA.analyse_session(str(sdir), rois, decoder=JC.decode)
    assert got == want
    assert [(r["label"], r["decoded_text"]) for r in got["records"]] == [
        ("4 mil", "004.0r-006c+049"), ("6 mil", "006.0r-018c+050")]


def test_cli_rgb_code128_reproduces_committed_json(tmp_path, capsys):
    """``barcode_analysis <results> --rois rgb --decoder code128 --figure
    none`` writes the committed ``decode_confidence.json`` exactly: every
    session, rep, method, barcode, payload and 25-trial confidence."""
    out = tmp_path / "decode_confidence.json"
    assert TBA.main([OURS, "--rois", "rgb", "--decoder", "code128",
                     "--out", str(out), "--figure", "none"]) == 0
    assert "004.0r-006c+049" in capsys.readouterr().out
    with open(out) as fp:
        got = json.load(fp)
    assert got == _committed()
    assert sum(len(s["records"]) for s in got["sessions"]) == 40
    assert not (tmp_path / "confidence_vs_pitch.png").exists()


def test_cli_dry_run_equals_jax(tmp_path):
    """``--decoder none`` over the committed outputs, and a ROI file: the
    same JSON as the JAX CLI's."""
    rois = tmp_path / "rois.json"
    rois.write_text(json.dumps({SESS_46: JBA.RGB_SESSION_ROIS[SESS_46]}))
    outs = []
    for mod, name in ((TBA, "t.json"), (JBA, "j.json")):
        assert mod.main([OURS, "--rois", str(rois), "--decoder", "none",
                         "--n-trials", "3", "--out", str(tmp_path / name),
                         "--figure", "none"]) == 0
        outs.append(json.loads((tmp_path / name).read_text()))
    assert outs[0] == outs[1]
    recs = outs[0]["sessions"][0]["records"]
    assert len(recs) == 16 and all(r["confidence"] == 0.0 for r in recs)
