"""The port's true-adjoint solver and ``landweber_refine`` against the JAX
package on the CPU (``SRTPU_SOLVER=adjoint`` on the JAX side): the
transposed frame operators entry for entry, ``solve`` / ``solve_batch``
within +-1 uint8 (step 2.0), a rank-2 PSF for both solvers, the
quarter-iteration quality of ``tests/test_sr_classical.py`` and the
refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.signal
import torch

from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch.ops.opmatrix import \
    psf_separable_factors
from enph459_super_resolution_tpu_torch.sr import classical as TC
from enph459_super_resolution_tpu_torch.sr import run as torch_run

SHIFTS = ((+0.5, -0.5), (+0.5, +0.5), (-0.5, -0.5), (-0.5, +0.5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_forward(hr, psf, s, f):
    b = scipy.signal.fftconvolve(hr, psf, mode="same")
    return ndi.shift(b, (s[0] * f, s[1] * f), order=3, mode="nearest")[::f,
                                                                       ::f]


def _scene(seed):
    rng = np.random.default_rng(seed)
    x = ndi.gaussian_filter(rng.uniform(0, 255, (64, 80)), 3.0)
    x = (x - x.min()) / (np.ptp(x) + 1e-9) * 255
    x[16:32, 20:26] = 230  # a block edge
    return x


def _frames(psf, seed=3, noise=2.0, scene=None):
    scene = _scene(seed) if scene is None else scene
    rng = np.random.default_rng(seed + 100)
    return np.stack([_np_forward(scene, psf, s, 2)
                     + rng.normal(0, noise, (32, 40))
                     for s in SHIFTS]).astype(np.float32)


def _rank2_psf():
    """A 7x7 PSF of exactly two separable terms, as a measured PSF's SVD
    keeps: a round Gaussian core plus an anisotropic halo."""
    t = np.arange(-3, 4, dtype=np.float64)

    def g(sigma):
        return np.exp(-t * t / (2.0 * sigma * sigma))

    psf = np.outer(g(1.0), g(1.0)) + 0.3 * np.outer(g(0.6), g(2.0))
    return psf / psf.sum()


def _u8(a, b):
    return int(np.abs(TC.to_uint8(a).astype(int)
                      - TC.to_uint8(b).astype(int)).max())


def _jax_solve(monkeypatch, frames, psf, solver, band_store="f32",
               batch=False, **kw):
    monkeypatch.setenv("SRTPU_SOLVER", solver)
    monkeypatch.setenv("SRTPU_BAND_STORE", band_store)
    fn = JC.solve_batch if batch else JC.solve
    return {k: np.asarray(v) for k, v in
            fn(jnp.asarray(frames), psf, SHIFTS, **kw).items()}


@pytest.mark.parametrize("psf_kind", ["gaussian", "rank2"])
def test_adjoint_frame_operators_entry_for_entry(psf_kind):
    psf = JC.make_gaussian_psf() if psf_kind == "gaussian" else _rank2_psf()
    for shift in ((0.5, -0.25), (-0.5, 0.5)):
        got = TC._frame_operator_banded(psf, shift, 2, (40, 56),
                                        solver="adjoint")
        want = JC._frame_operator_banded(psf, shift, 2, (40, 56), "float32",
                                         solver="adjoint")
        for g_ops, w_ops in zip(got, want):
            assert len(g_ops) == len(w_ops) == len(
                psf_separable_factors(psf)[0])
            for g, w in zip(g_ops, w_ops):
                np.testing.assert_array_equal(g.to_dense(), w.to_dense())
    # the backward operators are the forward ones transposed
    fwd_r, fwd_c, bwd_r, bwd_c = got
    for f, b in zip(fwd_r + fwd_c, bwd_r + bwd_c):
        np.testing.assert_array_equal(b.to_dense(), f.to_dense().T)
    # and the host solve set's blocks, rep-tiled too
    for reps in (1, 2):
        jm, _ = JC._host_solve_matrices(psf, SHIFTS, 2, (24, 40), "float32",
                                        reps, solver="adjoint")
        tm = TC._host_solve_matrices(psf, SHIFTS, 2, (24, 40), reps,
                                     solver="adjoint")
        for jf, tf in zip(jm["frames"], tm["frames"]):
            for jops, tops in zip(jf, tf):
                for j, t in zip(jops, tops):
                    assert t.col_ranges == j.col_ranges
                    for a, b in zip(t.blocks, j.blocks):
                        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("band_store", ["f32", "hybrid:8"])
def test_adjoint_solve_matches_jax(monkeypatch, band_store):
    psf = JC.make_gaussian_psf()
    frames = _frames(psf)
    want = _jax_solve(monkeypatch, frames, psf, "adjoint", band_store,
                      n_iter=20, step=2.0)
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, step=2.0, device="cpu",
                   band_store=band_store, solver="adjoint")
    for k in ("lr_mean", "native", "saa", "ibp"):
        assert _u8(got[k], want[k]) <= 1, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)


@pytest.mark.parametrize("band_store", ["f32", "hybrid:8"])
def test_adjoint_solve_batch_matches_jax_and_single(monkeypatch, band_store):
    psf = JC.make_gaussian_psf()
    stacks = np.stack([_frames(psf, seed) for seed in (1, 2)])
    want = _jax_solve(monkeypatch, stacks, psf, "adjoint", band_store,
                      batch=True, n_iter=10, step=2.0)
    got = TC.solve_batch(stacks, psf, SHIFTS, n_iter=10, step=2.0,
                         device="cpu", band_store=band_store,
                         solver="adjoint")
    assert got["ibp"].shape == (2, 64, 80)
    for k in ("native", "saa", "ibp"):
        assert _u8(got[k], want[k]) <= 1, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)
    # per rep, the batched solve is the single solve of that rep
    for r in range(2):
        single = TC.solve(stacks[r], psf, SHIFTS, n_iter=10, step=2.0,
                          device="cpu", band_store=band_store,
                          solver="adjoint")
        np.testing.assert_array_equal(got["ibp"][r], single["ibp"])


def test_adjoint_quality_at_a_quarter_of_the_iterations():
    """20 adjoint iterations at step 2.0 fit the frames as well as 80 IBP
    iterations, at the same truth quality; SAA is solver-independent."""
    psf = JC.make_gaussian_psf()
    scene = _scene(7)
    frames = _frames(psf, 3, scene=scene)
    want = TC.solve(frames, psf, SHIFTS, n_iter=80, device="cpu")
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, step=2.0, device="cpu",
                   solver="adjoint")

    def truth_psnr(img):
        mse = float(np.mean((img[8:-8, 8:-8] - scene[8:-8, 8:-8]) ** 2))
        return 10.0 * np.log10(255.0 ** 2 / mse)

    assert got["mse_history"][-1] <= want["mse_history"][-1] * 1.02
    assert abs(truth_psnr(got["ibp"]) - truth_psnr(want["ibp"])) < 0.15
    np.testing.assert_array_equal(got["saa"], want["saa"])


@pytest.mark.parametrize("solver,band_store,tol", [
    ("ibp", "f32", 1), ("adjoint", "f32", 1), ("ibp", "bf16", 2)])
def test_rank2_psf_solve_matches_jax(monkeypatch, solver, band_store, tol):
    """A full solve with a rank-2 PSF (two separable terms per frame
    operator), for both solvers and the bf16 store, within the mode's
    parity class of the JAX solve."""
    psf = _rank2_psf()
    assert len(psf_separable_factors(psf)[0]) == 2
    frames = _frames(psf, 11, noise=1.0)
    step = 2.0 if solver == "adjoint" else 0.5
    n_iter = 20
    want = _jax_solve(monkeypatch, frames, psf, solver, band_store,
                      n_iter=n_iter, step=step)
    got = TC.solve(frames, psf, SHIFTS, n_iter=n_iter, step=step,
                   device="cpu", band_store=band_store, solver=solver)
    for k in ("native", "saa", "ibp"):
        assert _u8(got[k], want[k]) <= tol, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3 if band_store == "f32" else 0.02)
    assert (np.diff(got["mse_history"]) < 0).all(), "the solve must descend"


def test_rank2_adjoint_fits_like_ibp80():
    psf = _rank2_psf()
    frames = _frames(psf, 11, noise=1.0)
    ibp80 = TC.solve(frames, psf, SHIFTS, n_iter=80, device="cpu")
    adj = TC.solve(frames, psf, SHIFTS, n_iter=20, step=2.0, device="cpu",
                   solver="adjoint")
    assert adj["mse_history"][-1] <= ibp80["mse_history"][-1] * 1.02


def test_landweber_refine_matches_jax():
    psf = JC.make_gaussian_psf()
    frames = _frames(psf, 5)
    seed = TC.solve(frames, psf, SHIFTS, n_iter=1, device="cpu")["saa"]
    hr, hist, final = TC.landweber_refine(seed, frames, psf, SHIFTS,
                                          n_iter=10, device="cpu")
    jhr, jhist, jfinal = JC.landweber_refine(jnp.asarray(seed),
                                             jnp.asarray(frames), psf,
                                             SHIFTS, n_iter=10)
    assert hr.shape == (64, 80) and hist.shape == (10,)
    assert _u8(hr, np.asarray(jhr)) <= 1
    np.testing.assert_allclose(hist, np.asarray(jhist), rtol=1e-3)
    np.testing.assert_allclose(final, float(jfinal), rtol=1e-3)
    # mse_history[i] is taken before update i: the fit descends to final
    assert final < hist[-1] < hist[0]


def test_adjoint_refusals(tmp_path):
    psf = JC.make_gaussian_psf()
    frames = _frames(psf)
    with pytest.raises(ValueError, match="mm"):
        TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu",
                 solver="adjoint", engine="conv")
    with pytest.raises(ValueError, match="fused"):
        TC.solve(frames, psf, SHIFTS, n_iter=2, device="cpu",
                 solver="adjoint", fused="on")
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        torch_run.main(["--workload", "mono_barcodes", "--data-dir",
                        str(tmp_path), "--output-dir", str(out),
                        "--solver", "adjoint", "--engine", "conv",
                        "--device", "cpu"])
    assert exc.value.code == 2
    assert not out.exists()
