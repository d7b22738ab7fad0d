"""The port's classical solve against the JAX package's on the CPU: the
same float32 frames (made with numpy from a seed) through JAX ``solve`` /
``solve_batch`` (banded ``mm`` engine, strict f32) and the port's, whose row
applies take the banded-row kernel's plain version on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch.data.sessions import (
    CENTER_SHIFT_FILES, CORNER_SHIFTS_LR)
from enph459_super_resolution_tpu_torch.sr import classical as TC

SHIFTS = {"corners": CORNER_SHIFTS_LR,
          "center4": tuple(s for _, s in CENTER_SHIFT_FILES)}
# uint8 outputs agree to the reference's parity class (+-1 count: f32 sums
# in another order can cross a truncation boundary); the MSE history to
# f32 round-off accumulated over 80 iterations.
MSE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores (a tiny solve
    then takes a minute instead of a fraction of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(layout, seed, reps=None):
    rng = np.random.default_rng(seed)
    scene = ndi.gaussian_filter(rng.uniform(0, 255, (64, 80)), 1.2)
    n = len(SHIFTS[layout])
    shape = (n,) if reps is None else (reps, n)
    return np.clip(scene + rng.normal(0, 2, shape + scene.shape), 0,
                   255).astype(np.float32)


def _compare(got, want):
    for k in ("lr_mean", "native", "saa", "ibp"):
        assert got[k].shape == want[k].shape, k
        diff = np.abs(TC.to_uint8(got[k]).astype(int)
                      - TC.to_uint8(want[k]).astype(int)).max()
        assert diff <= 1, (k, diff)
    assert got["mse_history"].shape == want["mse_history"].shape
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=MSE_RTOL)


@pytest.mark.parametrize("layout", sorted(SHIFTS))
def test_solve_matches_jax(layout):
    frames = _frames(layout, 0)
    psf = JC.make_gaussian_psf()
    want = {k: np.asarray(v) for k, v in
            JC.solve(jnp.asarray(frames), psf, SHIFTS[layout]).items()}
    got = TC.solve(frames, psf, SHIFTS[layout], device="cpu")
    assert got["ibp"].shape == (128, 160)
    assert got["mse_history"].shape == (80,)
    assert got["mse_history"][-1] < got["mse_history"][0]
    _compare(got, want)


@pytest.mark.parametrize("layout", sorted(SHIFTS))
def test_solve_batch_matches_jax(layout):
    frames = _frames(layout, 1, reps=3)
    psf = JC.make_gaussian_psf()
    want = {k: np.asarray(v) for k, v in
            JC.solve_batch(jnp.asarray(frames), psf,
                           SHIFTS[layout]).items()}
    got = TC.solve_batch(frames, psf, SHIFTS[layout], device="cpu")
    assert got["ibp"].shape == (3, 128, 160)
    assert got["mse_history"].shape == (3, 80)
    _compare(got, want)
    # and each rep of the batch is the single solve of that rep
    single = TC.solve(frames[2], psf, SHIFTS[layout], device="cpu")
    np.testing.assert_allclose(got["ibp"][2], single["ibp"], atol=1e-3)


def test_to_uint8_truncates():
    x = np.array([-3.0, 0.99, 1.0, 254.7, 300.0], dtype=np.float32)
    np.testing.assert_array_equal(TC.to_uint8(x), [0, 0, 1, 254, 255])
    np.testing.assert_array_equal(TC.to_uint8(x), JC.to_uint8(x))


def test_device_operators_kept_in_process(monkeypatch):
    """A second solve of one config reuses the device operator tree: no
    disk-cache read, no pack rebuilt; each op packed only for its axis."""
    reads = []
    orig = TC._cached_host_matrices
    monkeypatch.setattr(TC, "_cached_host_matrices",
                        lambda *a: reads.append(a) or orig(*a))
    TC._device_matrices.cache_clear()
    psf = TC.make_gaussian_psf()
    shifts = ((0.0, 0.0), (0.5, -0.5))
    frames = _frames("corners", 4)[:2, :24, :40]
    first = TC.solve(frames, psf, shifts, n_iter=3, device="cpu")
    mats = TC._solve_matrices(psf, shifts, 2, (24, 40), 1,
                              torch.device("cpu"))
    ops = ([mats["zoom_r"], mats["zoom_c"]]
           + [op for pair in mats["saa"] for op in pair])
    packs = [(op._row_pack, op._col_pack) for op in ops]
    again = TC.solve(frames, psf, shifts, n_iter=3, device="cpu")
    assert len(reads) == 1
    np.testing.assert_array_equal(first["ibp"], again["ibp"])
    # row operators (zoom_r, saa rows) hold only a row pack, column
    # operators only a column pack, and the second solve rebuilt neither
    for i, (op, (row, col)) in enumerate(zip(ops, packs)):
        assert (row is None) == (i % 2 == 1) and (col is None) == (i % 2 == 0)
        assert op._row_pack is row and op._col_pack is col
    for fwd_r, fwd_c, bwd_r, bwd_c in mats["frames"]:
        assert all(op._col_pack is None for op in fwd_r + bwd_r)
        assert all(op._row_pack is None for op in fwd_c + bwd_c)


def test_op_cache_roundtrip_and_untrusted_dir(tmp_path, monkeypatch):
    import os
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    psf = TC.make_gaussian_psf()
    shifts = ((0.0, 0.0), (0.5, 0.5))
    path = TC._op_cache_path(psf, shifts, 2, (24, 40), 1)
    assert path.startswith(str(tmp_path))
    first = TC._cached_host_matrices(psf, shifts, 2, (24, 40))
    assert os.path.exists(path)
    assert os.stat(os.path.dirname(path)).st_mode & 0o777 == 0o700
    again = TC._cached_host_matrices(psf, shifts, 2, (24, 40))
    for a, b in zip(first["zoom_r"].blocks, again["zoom_r"].blocks):
        np.testing.assert_array_equal(a, b)
    # a corrupt entry is rebuilt; a group-writable directory is not read
    with open(path, "wb") as fp:
        fp.write(b"not a pickle")
    rebuilt = TC._cached_host_matrices(psf, shifts, 2, (24, 40))
    assert rebuilt["zoom_c"].n_out == 80
    os.chmod(os.path.dirname(path), 0o770)
    assert not TC._cache_dir_trusted(path)
