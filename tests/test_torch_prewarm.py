"""The port's ``sr.prewarm`` on the CPU: the same warm specs as the JAX
tool, a ``--build-only`` warm that leaves a fresh solve nothing to build
(the ``tests/test_prewarm.py`` contract), and the full warm path."""

import os
import tempfile

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from enph459_super_resolution_tpu.sr import prewarm as JP
from enph459_super_resolution_tpu.sr.config import WORKLOADS as JW
from enph459_super_resolution_tpu_torch.data.io import save_png
from enph459_super_resolution_tpu_torch.sr import classical as TC
from enph459_super_resolution_tpu_torch.sr import prewarm as TP
from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS as TW


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny_session_dir(tmp_path):
    """One corner_rep session of 3 reps at 48x64."""
    rng = np.random.default_rng(0)
    scene = ndi.gaussian_filter(rng.uniform(0, 255, (48, 64)), 1.2)
    sdir = tmp_path / "data" / "tiny_session"
    for ci in range(4):
        for ri in range(3):
            img = np.clip(scene + rng.normal(0, 1, scene.shape), 0,
                          255).astype(np.uint8)
            save_png(img, str(sdir / f"corner{ci}_rep{ri:02d}.png"))
    return str(tmp_path / "data")


@pytest.fixture()
def op_cache(tmp_path, monkeypatch):
    """The op disk cache under this test's own temp dir."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    return TC.op_cache_dir()


def test_warm_specs_equal_jax(tiny_session_dir):
    for name in sorted(TW):
        for reps in ([1], [1, 4], [4, 2, 4]):
            assert TP.warm_specs(TW[name], reps) == \
                JP.warm_specs(JW[name], reps), (name, reps)
    assert TP.warm_specs(TW["rgb_cal_target"], [1, 4]) == []
    for max_batch in (2, 4):
        got = TP.warm_specs(TW["mono_barcodes"], [1], max_batch=max_batch,
                            data_dir=tiny_session_dir)
        assert got == JP.warm_specs(JW["mono_barcodes"], [1],
                                    max_batch=max_batch,
                                    data_dir=tiny_session_dir)
    assert {r for _, _, r in got} == {1, 3}


def test_build_only_fills_the_cache(tiny_session_dir, op_cache, monkeypatch):
    """After a --build-only warm, a process with nothing in memory solves
    from the disk cache alone: the host build is forbidden."""
    rc = TP.main(["--workloads", "mono_barcodes", "--data-dir",
                  tiny_session_dir, "--build-only", "--max-batch", "2",
                  "--device", "cpu"])
    assert rc == 0
    cached = [f for f in os.listdir(op_cache) if f.endswith(".pkl")]
    assert len(cached) == 2  # the reps=1 and reps=2 specs

    TC._device_matrices.cache_clear()

    def boom(*a, **k):
        raise AssertionError("host build ran despite a warm disk cache")

    monkeypatch.setattr(TC, "_host_solve_matrices", boom)
    cfg = TW["mono_barcodes"]
    units = cfg.load(os.path.join(tiny_session_dir, "tiny_session"))
    psf = TC.make_gaussian_psf()
    out = TC.solve(units[0].frames, psf, units[0].shifts, n_iter=3,
                   device="cpu")
    assert np.isfinite(out["mse_history"]).all()
    outb = TC.solve_batch(np.stack([u.frames for u in units[:2]]), psf,
                          units[0].shifts, n_iter=3, device="cpu")
    assert np.isfinite(outb["mse_history"]).all()


def test_build_only_uploads_each_pack_of_its_axis(op_cache):
    cfg = TW["mono_barcodes"]
    TC._device_matrices.cache_clear()
    TP.prewarm_spec(cfg, TC.make_gaussian_psf(), (24, 40),
                    ((0.5, -0.5), (-0.5, 0.5)), 1,
                    build_only=True, device=torch.device("cpu"),
                    band_store="hybrid", fused="auto",
                    mm_precision="HIGHEST", solver="adjoint")
    mats = TC._solve_matrices(TC.make_gaussian_psf(),
                              ((0.5, -0.5), (-0.5, 0.5)), 2, (24, 40), 1,
                              torch.device("cpu"), "hybrid", "auto",
                              "HIGHEST", "adjoint")
    assert mats["zoom_r"]._row_pack is not None
    assert mats["zoom_c"]._col_pack is not None
    for key in ("frames", "frames_lo"):
        for frame in mats[key]:
            for axis, ops in enumerate(frame):
                for op in ops:
                    built = op._row_pack if axis % 2 == 0 else op._col_pack
                    other = op._col_pack if axis % 2 == 0 else op._row_pack
                    assert built is not None and other is None


def test_full_warm_runs_a_solve(tiny_session_dir, op_cache, capsys):
    rc = TP.main(["--workloads", "mono_barcodes", "--data-dir",
                  tiny_session_dir, "--max-batch", "2", "--ibp-iters", "2",
                  "--device", "cpu"])
    assert rc == 0
    said = capsys.readouterr().out
    assert said.count("built+solved") == 2
    assert op_cache in said


def test_prewarm_without_a_card_writes_nothing(tmp_path, op_cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(SystemExit) as exc:
        TP.main(["--workloads", "mono_barcodes", "--build-only"])
    assert exc.value.code == 2
    assert not os.path.exists(op_cache)


# The op disk cache's knobs, as the JAX package's tests hold them
# (tests/test_sr_classical.py::test_op_cache_roundtrip_and_corruption,
# tests/test_prewarm.py): SRTPU_OP_CACHE_DIR moves the cache and
# SRTPU_OP_CACHE=0 turns it off.

ARGS = (((0.5, -0.5), (-0.5, 0.5)), 2, (24, 40))


def test_op_cache_dir_env_roundtrip_and_corruption(tmp_path, monkeypatch):
    """A second build is served from disk, bit for bit; a corrupt entry
    rebuilds."""
    cache_dir = str(tmp_path / "moved")
    monkeypatch.setenv("SRTPU_OP_CACHE_DIR", cache_dir)
    assert TC.op_cache_dir() == cache_dir
    psf = TC.make_gaussian_psf()
    built = []
    orig = TC._host_solve_matrices

    def counting(*a, **k):
        built.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(TC, "_host_solve_matrices", counting)
    first = TC._cached_host_matrices(psf, *ARGS)
    path = TC._op_cache_path(psf, *ARGS, 1)
    assert os.path.dirname(path) == cache_dir and os.path.exists(path)
    assert os.stat(cache_dir).st_mode & 0o777 == 0o700
    again = TC._cached_host_matrices(psf, *ARGS)
    assert len(built) == 1  # the second call was served from disk
    for a, b in zip(first["zoom_r"].blocks, again["zoom_r"].blocks):
        np.testing.assert_array_equal(a, b)

    with open(path, "wb") as fp:
        fp.write(b"corrupt")
    TC._cached_host_matrices(psf, *ARGS)
    assert len(built) == 2  # rebuilt, not crashed


def test_op_cache_off_writes_no_file(tmp_path, monkeypatch, op_cache):
    monkeypatch.setenv("SRTPU_OP_CACHE", "0")
    assert TC._op_cache_path(TC.make_gaussian_psf(), *ARGS, 1) is None
    mats = TC._cached_host_matrices(TC.make_gaussian_psf(), *ARGS)
    assert mats["zoom_c"].n_out == 80
    out = TC.solve(np.zeros((2, 24, 40), np.float32),
                   TC.make_gaussian_psf(), ARGS[0], n_iter=2, device="cpu")
    assert np.isfinite(out["mse_history"]).all()
    assert not os.path.exists(op_cache)


def test_build_only_fills_the_moved_cache(tiny_session_dir, tmp_path,
                                          monkeypatch, op_cache, capsys):
    """``SRTPU_OP_CACHE_DIR`` moves the prewarm's cache: the specs land
    there and nothing under the temp dir; the full warm path reads it."""
    cache_dir = str(tmp_path / "opcache")
    monkeypatch.setenv("SRTPU_OP_CACHE_DIR", cache_dir)
    TC._device_matrices.cache_clear()
    assert TP.main(["--workloads", "mono_barcodes", "--data-dir",
                    tiny_session_dir, "--build-only", "--max-batch", "2",
                    "--device", "cpu"]) == 0
    cached = [f for f in os.listdir(cache_dir) if f.endswith(".pkl")]
    assert len(cached) == 2  # the reps=1 and reps=2 specs
    assert not os.path.exists(op_cache)
    assert cache_dir in capsys.readouterr().out

    TC._device_matrices.cache_clear()

    def boom(*a, **k):
        raise AssertionError("host build ran despite a warm disk cache")

    monkeypatch.setattr(TC, "_host_solve_matrices", boom)
    assert TP.main(["--workloads", "mono_barcodes", "--data-dir",
                    tiny_session_dir, "--max-batch", "2", "--ibp-iters",
                    "2", "--device", "cpu"]) == 0


@pytest.mark.parametrize("name", ["ANY_F8_ANY_F8_F32", "TF32_TF32_F32_X3"])
def test_prewarm_takes_every_precision_but_float8(tiny_session_dir, op_cache,
                                                  capsys, name):
    """``--mm-precision`` takes JAX's names; a float8 preset exits 2."""
    argv = ["--workloads", "mono_barcodes", "--data-dir", tiny_session_dir,
            "--build-only", "--device", "cpu", "--mm-precision", name]
    if name.startswith("ANY_F8"):
        with pytest.raises(SystemExit) as exc:
            TP.main(argv)
        assert exc.value.code == 2
        assert "float8" in capsys.readouterr().err
    else:
        assert TP.main(argv) == 0
