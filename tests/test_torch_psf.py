"""The port's PSF toolkit and CLIs (``psf/toolkit.py``, ``psf/analyze.py``,
``psf/cli.py``) against the JAX package's, on the CPU.

Synthetic Gaussian PSFs (``tests/test_psf.py``'s ``synth_gaussian``) and a
small flat-layout calibration folder the tests write.  The JAX side runs
under ``tests/conftest.py``'s ``jax_enable_x64``, so both compute in
float64 (``find_peak`` in float32 in both).  Tolerances: peaks equal;
radial profiles, MTFs and encircled energy within 1e-10; fit parameters
within 1e-8 relative (40 fixed LM iterations whose accept/reject
decisions near convergence compare sums equal to rounding), the theta
fold equal; every ``summary.json`` number within 1e-8 relative.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from enph459_super_resolution_tpu.psf import analyze as JA
from enph459_super_resolution_tpu.psf import cli as JCLI
from enph459_super_resolution_tpu.psf import toolkit as JT
from enph459_super_resolution_tpu_torch.psf import analyze as TA
from enph459_super_resolution_tpu_torch.psf import cli as TCLI
from enph459_super_resolution_tpu_torch.psf import toolkit as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_PITCH_UM = 3.45
CROP = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_gaussian(rng, h=61, w=61, amp=200.0, x0=30.3, y0=29.6, sx=1.4,
                   sy=0.9, th=0.4, off=2.0, noise=0.5):
    """``tests/test_psf.py``'s synthetic PSF, its noise from ``rng``."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    a = np.cos(th) ** 2 / (2 * sx ** 2) + np.sin(th) ** 2 / (2 * sy ** 2)
    b = -np.sin(2 * th) / (4 * sx ** 2) + np.sin(2 * th) / (4 * sy ** 2)
    c = np.sin(th) ** 2 / (2 * sx ** 2) + np.cos(th) ** 2 / (2 * sy ** 2)
    g = off + amp * np.exp(-(a * (xx - x0) ** 2 + 2 * b * (xx - x0) * (yy - y0)
                             + c * (yy - y0) ** 2))
    return g + rng.normal(0, noise, size=(h, w))


def _psfs(n=6, seed=11):
    rng = np.random.default_rng(seed)
    # theta over both folds, and sigma pairs either way round
    return np.stack([synth_gaussian(rng, x0=30.3 + 0.2 * i, y0=29.6 - 0.1 * i,
                                    sx=1.4 if i % 2 else 0.9,
                                    sy=0.9 if i % 2 else 1.4,
                                    th=-1.3 + 0.55 * i) for i in range(n)])


def test_find_peak_equal():
    rng = np.random.default_rng(1)
    for psf in list(_psfs()) + [rng.uniform(0, 255, (40, 52)),
                                np.pad(_psfs(1)[0], ((3, 9), (0, 14)))]:
        assert TT.find_peak(psf, device="cpu") == JT.find_peak(psf)
    assert TT.find_peak(_psfs(1)[0], smooth_sigma=1.0, device="cpu") == \
        JT.find_peak(_psfs(1)[0], smooth_sigma=1.0)


def test_extract_centre_radial_and_encircled_energy():
    psf = _psfs(1)[0]
    peak = JT.find_peak(psf)
    for sigma in (3.0, None):
        np.testing.assert_array_equal(
            TT.extract_psf(psf, peak, 12, noise_floor_sigma=sigma),
            JT.extract_psf(psf, peak, 12, noise_floor_sigma=sigma))
    assert TT.subpixel_centre(psf) == JT.subpixel_centre(psf)
    for center, rmax in (((19.3, 22.1), 15), (None, None)):
        r_t, p_t = TT.radial_average(psf, center, rmax)
        r_j, p_j = JT.radial_average(psf, center, rmax)
        np.testing.assert_array_equal(r_t, r_j)
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-10)
        np.testing.assert_allclose(TT.encircled_energy(p_t, r_t),
                                   JT.encircled_energy(p_j, r_j),
                                   rtol=0, atol=1e-10)


def test_radial_average_dev_matches_jax_segment_sum():
    import torch

    stack = np.random.default_rng(4).uniform(size=(3, 40, 44))
    got = TT._radial_average_dev(torch.as_tensor(stack), 19.3, 22.1, 15)
    want = jax.vmap(lambda d: JT._radial_average_dev(d, 19.3, 22.1, 15))(
        jnp.asarray(stack))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("pitch", [None, PIXEL_PITCH_UM])
def test_compute_mtf_single_and_batched(pitch):
    psfs = _psfs(4)
    for x in (psfs, psfs[2], np.pad(psfs, ((0, 0), (100, 120), (90, 130)))):
        got = TT.compute_mtf(x, pitch, device="cpu")
        want = JT.compute_mtf(x, pitch)
        for g, w in zip(got[:3], want[:3]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
        assert got[3:] == want[3:]
    f, m = got[0], got[1][0]
    assert TT.mtf_at_fraction(f, m, 0.5) == JT.mtf_at_fraction(f, m, 0.5)


def test_gaussian_fit_batch_and_theta_fold_match_jax():
    psfs = _psfs(6)
    got = TT.fit_gaussian_psf_batch(psfs, device="cpu")
    want = JT.fit_gaussian_psf_batch(psfs)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)
    # the fold: theta in [-pi/4, pi/4), sigmas swapped alike
    assert np.all((got[:, 5] >= -np.pi / 4) & (got[:, 5] < np.pi / 4))
    np.testing.assert_array_equal(got[:, 3] > got[:, 4],
                                  want[:, 3] > want[:, 4])
    np.testing.assert_allclose(np.sort(got[:, 3:5], axis=1),
                               [[0.9, 1.4]] * 6, atol=0.02)


def test_gaussian_fit_single_and_model():
    import torch

    psf = _psfs(1)[0]
    p_t, fit_t = TT.fit_gaussian_psf(psf, device="cpu")
    p_j, fit_j = JT.fit_gaussian_psf(psf)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(fit_t, fit_j, rtol=1e-8, atol=1e-8)
    yy, xx = np.mgrid[:9, :11].astype(np.float64)
    params = np.array([150.0, 5.2, 4.1, 1.3, 0.8, 0.3, 3.0])
    np.testing.assert_allclose(
        TT.gauss2d_model(torch.as_tensor(params), torch.as_tensor(xx),
                         torch.as_tensor(yy)).numpy(),
        np.asarray(JT.gauss2d_model(jnp.asarray(params), jnp.asarray(xx),
                                    jnp.asarray(yy))), rtol=1e-14)


# --------------------------------------------------------------------------
# the CLIs on a small flat-layout calibration folder
# --------------------------------------------------------------------------

def _write_folder(root, positions=3, reps=4, size=121, seed=5):
    """``sweepx_tilt0.28000_repNN_posK.png`` pinhole frames: a Gaussian
    spot (sigma growing with the position) at a jittered centre on a dark
    noisy background."""
    from enph459_super_resolution_tpu_torch.data.io import save_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    for pos in range(positions):
        sigma = 1.1 + 0.2 * pos
        for rep in range(reps):
            cy, cx = size / 2 + rng.uniform(-3, 3, 2)
            img = 6.0 + 220.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                       / (2 * sigma ** 2))
            img += rng.normal(0, 1.5, img.shape)
            save_png(np.clip(img, 0, 255).astype(np.uint8), os.path.join(
                root, f"sweepx_tilt0.28000_rep{rep:02d}_pos{pos}.png"))
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(str(tmp_path_factory.mktemp("psf_flat")))


def _assert_close(got, want, path=""):
    """Every number of two JSON-like trees within 1e-8 relative."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=path)
    else:
        assert got == want, path


def test_parse_and_discover_both_layouts(folder, tmp_path):
    sub = tmp_path / "sweepy_tilt0.02000deg"
    sub.mkdir()
    (sub / "pos4_(0,0).png").write_bytes(b"")
    (sub / "notes.png").write_bytes(b"")
    for root in (folder, str(tmp_path)):
        assert TA.discover_images(root) == JA.discover_images(root)
    assert len(TA.discover_images(folder)) == 12
    (rec,) = TA.discover_images(str(tmp_path))
    assert (rec["sweep_axis"], rec["tilt_angle"], rec["position"]) == (
        "y", 0.02, 4)
    name = "sweepx_tilt0.28000_rep07_pos3.tif"
    assert TA.parse_filename(name) == JA.parse_filename(name)


def test_analyse_position_matches_jax(folder):
    paths = [r["path"] for r in TA.discover_images(folder)
             if r["position"] == 1]
    got = TA.analyse_position(paths, CROP, PIXEL_PITCH_UM, device="cpu")
    want = JA.analyse_position(paths, CROP, PIXEL_PITCH_UM)
    assert sorted(got) == sorted(want) and got["n_images"] == 4
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=1e-8, atol=1e-10, err_msg=k)


def test_analyze_cli_summary_matches_jax(folder, tmp_path, capsys):
    outs = {}
    for name, mod, extra in (("port", TA, ["--device", "cpu"]),
                             ("jax", JA, [])):
        out = str(tmp_path / name)
        assert mod.main([folder, "--pixel-pitch-um", str(PIXEL_PITCH_UM),
                         "--crop-radius", str(CROP), "--output-dir", out,
                         "--no-figures", *extra]) == 0
        with open(os.path.join(out, "summary.json")) as fp:
            outs[name] = json.load(fp)
        with np.load(os.path.join(out, "psf_mtf_by_position_data.npz")) as z:
            outs[name + "_npz"] = {k: z[k] for k in z.files}
    assert "pos2: n=4" in capsys.readouterr().out
    _assert_close(outs["port"], outs["jax"])
    assert sorted(outs["port"]) == ["pos0", "pos1", "pos2"]
    assert sorted(outs["port_npz"]) == sorted(outs["jax_npz"])
    for k, w in outs["jax_npz"].items():
        np.testing.assert_allclose(outs["port_npz"][k], w, rtol=1e-8,
                                   atol=1e-10, err_msg=k)
    # the spot widens with the position, and the fit sees it
    sig = [outs["port"][f"pos{p}"]["sigma_x"] for p in range(3)]
    assert sig[0] < sig[1] < sig[2]


def test_analyse_folder_and_cli_match_jax(folder, tmp_path, capsys):
    paths = sorted(r["path"] for r in TA.discover_images(folder)
                   if r["position"] == 0)
    got = TCLI.analyse_folder(paths, CROP, PIXEL_PITCH_UM, device="cpu")
    want = JCLI.analyse_folder(paths, CROP, PIXEL_PITCH_UM)
    assert sorted(got) == sorted(want) and got["n"] == 4
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=1e-8, atol=1e-10, err_msg=k)
    out = tmp_path / "cli"
    assert TCLI.main([os.path.join(folder, "*_pos0.png"), "--crop-radius",
                      str(CROP), "--pixel-pitch-um", str(PIXEL_PITCH_UM),
                      "--output-dir", str(out), "--no-figures",
                      "--device", "cpu"]) == 0
    assert "n=4  sigma_x=" in capsys.readouterr().out
    with np.load(out / "psf_mtf_data.npz") as z:
        np.testing.assert_allclose(z["params"], want["params"], rtol=1e-8,
                                   atol=1e-10)
    assert not (out / "psf_mtf_summary.png").exists()


@pytest.mark.parametrize("subpixel", [False, True])
def test_aligned_sigma_of_an_undersampled_spot(subpixel, tmp_path):
    """A spot of sigma 0.73 px (the rig's, SURVEY.md), its centre jittered
    by whole pixels or by any sub-pixel amount: ``analyse_position``'s
    per-image sigma equals the JAX function's either way; the cubic-spline
    alignment of a sub-pixel jitter broadens the fitted sigma past 0.02 px
    of the truth in both packages, a whole-pixel jitter keeps it within
    (``chip_smoke.py``'s PSF truth check uses the latter)."""
    from enph459_super_resolution_tpu_torch.data.io import save_png

    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[:121, :121].astype(np.float64)
    paths = []
    for rep in range(4):
        jitter = rng.uniform(-1.5, 1.5, 2)
        cy, cx = 60 + (jitter if subpixel else np.round(jitter))
        img = 8.0 + 200.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                   / (2 * 0.73 ** 2))
        img += rng.normal(0, 0.5, img.shape)
        paths.append(str(tmp_path / f"sweepx_tilt0.28000_rep{rep:02d}_pos4.png"))
        save_png(np.clip(np.round(img), 0, 255).astype(np.uint8), paths[-1])
    got = TA.analyse_position(paths, CROP, PIXEL_PITCH_UM, device="cpu")
    want = JA.analyse_position(paths, CROP, PIXEL_PITCH_UM)
    sig = np.concatenate([got["per_image_sigma_x"], got["per_image_sigma_y"]])
    np.testing.assert_allclose(sig, np.concatenate(
        [want["per_image_sigma_x"], want["per_image_sigma_y"]]), rtol=1e-8)
    err = abs(sig.mean() - 0.73)
    assert (err > 0.02) if subpixel else (err < 0.02), sig


@pytest.mark.parametrize("which", ["analyze", "cli"])
def test_cli_without_a_card_exits_nonzero(which, folder, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    mod = TA if which == "analyze" else TCLI
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        mod.main([folder, "--output-dir", str(out), "--device", "cuda"])
    assert exc.value.code != 0
    assert not out.exists()
    # a library call on the default device raises too (torch built without
    # CUDA raises AssertionError, one with CUDA but no card RuntimeError)
    with pytest.raises((RuntimeError, AssertionError)):
        TT.find_peak(np.zeros((8, 8)))


def test_float32_departure_against_the_jax_cli(folder, tmp_path):
    """The JAX CLI with x64 off (as users run it) computes the radial
    profiles, MTFs and fits in float32; the port in float64.  The largest
    relative difference of any ``summary.json`` number stays below 1e-3
    (it is printed; CHANGES.md records it)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    jax_out = str(tmp_path / "jax32")
    subprocess.run([sys.executable, "-m",
                    "enph459_super_resolution_tpu.psf.analyze", folder,
                    "--pixel-pitch-um", str(PIXEL_PITCH_UM), "--crop-radius",
                    str(CROP), "--output-dir", jax_out, "--no-figures",
                    "--platform", "cpu"], check=True, cwd=REPO, env=env,
                   capture_output=True, timeout=300)
    port_out = str(tmp_path / "port")
    assert TA.main([folder, "--pixel-pitch-um", str(PIXEL_PITCH_UM),
                    "--crop-radius", str(CROP), "--output-dir", port_out,
                    "--no-figures", "--device", "cpu"]) == 0
    got, want = ({k: v for k, v in json.load(open(os.path.join(
        d, "summary.json"))).items()} for d in (port_out, jax_out))
    rel = max(abs(got[p][k] - want[p][k]) / abs(want[p][k])
              for p in want for k in want[p])
    print(f"psf.analyze summary.json, port float64 against the JAX CLI "
          f"float32: max relative difference {rel:.3e}")
    assert 0 < rel < 1e-3
