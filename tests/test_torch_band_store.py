"""The port's bf16 and hybrid band stores against the JAX package's, on the
CPU: the bf16 bands, the bf16 row and column applies, and whole solves in
every band store and engine, with the JAX modes set through its environment
knobs as its own tests set them.

Tolerances, in uint8 counts of the outputs: strict f32 and ``hybrid``
(whose f32 tail contracts the bf16 deviation) agree to +-1, the reference's
parity class; ``bf16`` to +-2, since a sum taken in another order can round
a bf16 intermediate the other way (one ulp is 1.0 at 128..255)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.signal
import torch

from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu.sr import run as jax_run
from enph459_super_resolution_tpu_torch.data.io import load_image, save_png
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


def _np_forward(hr, psf, s, f=2):
    """The reference forward model (blur, shift, decimate) in scipy."""
    b = scipy.signal.fftconvolve(hr, psf, mode="same")
    return ndi.shift(b, (s[0] * f, s[1] * f), order=3, mode="nearest")[::f,
                                                                        ::f]


def _scene_frames(kind="smooth", seed=7):
    """LR frames of a 64x80 HR scene (the JAX package's
    tests/test_sr_classical.py fixture and its adversarial scenes)."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        x = ndi.gaussian_filter(rng.uniform(0, 255, (64, 80)), 3.0)
        hr = (x - x.min()) / (np.ptp(x) + 1e-9) * 255
        hr[16:32, 20:26] = 230  # block edge
    elif kind == "nyquist":
        yy, xx = np.meshgrid(np.arange(64), np.arange(80), indexing="ij")
        hr = 127.5 + 120.0 * ((yy + xx) % 2 * 2.0 - 1.0)
    elif kind == "noise":
        hr = rng.uniform(0, 255, (64, 80))
    else:
        hr = np.full((64, 80), 250.0)
        hr[rng.integers(0, 64, 40), rng.integers(0, 80, 40)] = 2.0
    psf = TC.make_gaussian_psf()
    return np.stack([_np_forward(hr, psf, s) for s in SHIFTS]).astype(
        np.float32)


def _jax_solve(monkeypatch, frames, store, fused_env, n_iter, batch=False):
    monkeypatch.setenv("SRTPU_BAND_STORE", store)
    monkeypatch.setenv("SRTPU_FUSED_IBP", fused_env)
    JC._compiled_solve.cache_clear()
    fn = JC.solve_batch if batch else JC.solve
    out = fn(jnp.asarray(frames), JC.make_gaussian_psf(), SHIFTS,
             n_iter=n_iter)
    JC._compiled_solve.cache_clear()
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _u8_diff(a, b) -> int:
    return int(np.abs(TC.to_uint8(a).astype(int)
                      - TC.to_uint8(b).astype(int)).max())


# ---------------------------------------------------------------------------
# the bf16 operators
# ---------------------------------------------------------------------------

def _op_pairs():
    """(port op, JAX op) for the row and column operators of one frame and
    the zoom, from the two packages' host builds of LR 40x48."""
    psf = TC.make_gaussian_psf()
    jmats, _ = JC._host_solve_matrices(psf, SHIFTS, 2, (40, 48), "float32")
    tmats = TC._host_solve_matrices(psf, SHIFTS, 2, (40, 48))
    pairs = {"zoom_r": (tmats["zoom_r"], jmats["zoom_r"]),
             "zoom_c": (tmats["zoom_c"], jmats["zoom_c"])}
    for i, name in enumerate(("fwd_r", "fwd_c", "bwd_r", "bwd_c")):
        pairs[name] = (tmats["frames"][1][i][0], jmats["frames"][1][i][0])
    return pairs


def test_bf16_bands_bit_equal_jax():
    """torch's float32 -> bfloat16 cast rounds to nearest even, as
    ml_dtypes does: the port's device bands are the JAX bf16 blocks."""
    for name, (top, jop) in _op_pairs().items():
        _assert_bands_equal(top.astype_band(torch.bfloat16).to("cpu"),
                            jop.astype_band(jnp.bfloat16), name)


def _assert_bands_equal(top, jlo, name):
    pack = top.row_pack
    assert pack.bands.dtype == torch.bfloat16
    bands = pack.bands.float().numpy()  # k-major: [n_blk, win, ROWS]
    for b, (blk, (lo, hi)) in enumerate(zip(jlo.blocks, jlo.col_ranges)):
        want = np.asarray(blk, np.float32)
        np.testing.assert_array_equal(
            bands[b, :hi - lo, :want.shape[0]].T, want, err_msg=name)


def test_convert_carries_the_bf16_frame_copies():
    """``convert.solve_operators_from_arrays`` takes the reference's bf16
    frame copies (``frames_lo``) as float32 blocks tagged ``band_dtype``:
    they land as bf16 bands equal to the JAX blocks and apply as the port's
    own bf16 copies do."""
    from enph459_super_resolution_tpu.ops.opmatrix import BandedOp as JOp
    from enph459_super_resolution_tpu_torch import convert

    def tree(node, fn):
        if isinstance(node, (list, tuple)):
            return type(node)(tree(v, fn) for v in node)
        return fn(node)

    def as_arrays(op, lo):
        return {"blocks": [np.asarray(b, np.float32) for b in op.blocks],
                "col_ranges": op.col_ranges, "n_out": op.n_out,
                "n_in": op.n_in, **({"band_dtype": "bfloat16"} if lo else {})}

    psf = TC.make_gaussian_psf()
    jmats, _ = JC._host_solve_matrices(psf, SHIFTS, 2, (40, 48), "float32")
    j_lo = tree(jmats["frames"], lambda op: op.astype_band(jnp.bfloat16))
    assert isinstance(j_lo[1][0][0], JOp)
    conv = convert.solve_operators_from_arrays(
        {"frames": tree(jmats["frames"], lambda op: as_arrays(op, False)),
         "frames_lo": tree(j_lo, lambda op: as_arrays(op, True))}, "cpu")
    own_lo = TC._to_device(TC._cast_bf16(TC._host_solve_matrices(
        psf, SHIFTS, 2, (40, 48))["frames"]), "cpu")
    assert conv["frames"][1][0][0].band_dtype == torch.float32
    fwd_r, fwd_c = conv["frames_lo"][1][0][0], conv["frames_lo"][1][1][0]
    assert fwd_r.band_dtype == fwd_c.band_dtype == torch.bfloat16
    _assert_bands_equal(fwd_r, j_lo[1][0][0], "fwd_r")
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(0, 255, (fwd_r.n_in, 48)),
                        dtype=torch.float32)
    torch.testing.assert_close(fwd_r.row_apply(x),
                               own_lo[1][0][0].row_apply(x), rtol=0, atol=0)
    y = torch.as_tensor(rng.uniform(0, 255, (40, fwd_c.n_in)),
                        dtype=torch.float32)
    torch.testing.assert_close(fwd_c.col_apply(y),
                               own_lo[1][1][0].col_apply(y), rtol=0, atol=0)


@pytest.mark.parametrize("axis", ["row", "col"])
def test_bf16_applies_match_jax(axis):
    rng = np.random.default_rng(3)
    for name, (top, jop) in _op_pairs().items():
        if not name.endswith("_r" if axis == "row" else "_c"):
            continue
        lo = top.astype_band(torch.bfloat16).to("cpu")
        jlo = jop.astype_band(jnp.bfloat16)
        shape = (2, top.n_in, 37) if axis == "row" else (2, 37, top.n_in)
        x = rng.uniform(0, 255, shape).astype(np.float32)
        if axis == "row":
            got, want = lo.row_apply(torch.from_numpy(x)), jlo.row_apply(
                jnp.asarray(x))
        else:
            got, want = lo.col_apply(torch.from_numpy(x)), jlo.col_apply(
                jnp.asarray(x))
        assert got.dtype == torch.float32
        # exact bf16 products summed in f32 on both sides: only the order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   err_msg=name)
        # and not the f32 apply: the rounding took place
        f32 = (top.to("cpu").row_apply(torch.from_numpy(x)) if axis == "row"
               else top.to("cpu").col_apply(torch.from_numpy(x)))
        assert (f32 - got).abs().max().item() > 1e-2, name


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store, tol", [("hybrid:8", 1), ("bf16", 2)])
def test_banded_band_store_matches_jax(monkeypatch, store, tol):
    """64x80 HR, 20 iterations: too small for the fused kernels, so both
    packages run their banded engines on the bf16 copies."""
    frames = _scene_frames()
    want = _jax_solve(monkeypatch, frames, store, "auto", 20)
    got = TC.solve(frames, TC.make_gaussian_psf(), SHIFTS, n_iter=20,
                   device="cpu", band_store=store)
    for k in ("native", "saa", "ibp"):
        assert _u8_diff(got[k], want[k]) <= tol, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)
    f32 = TC.solve(frames, TC.make_gaussian_psf(), SHIFTS, n_iter=20,
                   device="cpu")
    if store.startswith("hybrid"):
        # zoom and Shift-and-Add stay on the f32 operators
        np.testing.assert_array_equal(got["saa"], f32["saa"])
        np.testing.assert_array_equal(got["native"], f32["native"])
        assert _u8_diff(got["ibp"], f32["ibp"]) <= 1
    else:
        assert not np.array_equal(got["saa"], f32["saa"])
        assert _u8_diff(got["ibp"], f32["ibp"]) <= 3


@pytest.mark.parametrize("store, fused, jax_env, tol", [
    ("f32", "on", "interpret", 1),
    ("bf16", "auto", "interpret", 2),
    ("hybrid:3", "on", "interpret", 1),
    ("bf16", "off", "0", 2),
    ("hybrid:3", "auto", "0", 1),
])
def test_fused_and_banded_routes_match_jax(monkeypatch, store, fused,
                                           jax_env, tol):
    """LR 128x256, 6 iterations: a shape the fused kernels take.  The JAX
    fused kernels run in interpret mode, the port's as their plain
    versions."""
    frames = np.random.default_rng(1).uniform(0, 255, (4, 128, 256)).astype(
        np.float32)
    want = _jax_solve(monkeypatch, frames, store, jax_env, 6)
    got = TC.solve(frames, TC.make_gaussian_psf(), SHIFTS, n_iter=6,
                   device="cpu", band_store=store, fused=fused)
    for k in ("native", "saa", "ibp"):
        assert _u8_diff(got[k], want[k]) <= tol, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)
    if not store.startswith("bf16"):
        f32 = TC.solve(frames, TC.make_gaussian_psf(), SHIFTS, n_iter=6,
                       device="cpu")
        np.testing.assert_array_equal(got["saa"], f32["saa"])
        assert _u8_diff(got["ibp"], f32["ibp"]) <= 1


def test_fused_bf16_solve_batch_matches_jax(monkeypatch):
    """Two reps stacked along H on the rep-tiled fused pack."""
    frames = np.random.default_rng(2).uniform(0, 255,
                                              (2, 4, 128, 256)).astype(
        np.float32)
    want = _jax_solve(monkeypatch, frames, "bf16", "interpret", 4,
                      batch=True)
    got = TC.solve_batch(frames, TC.make_gaussian_psf(), SHIFTS, n_iter=4,
                         device="cpu", band_store="bf16")
    assert got["ibp"].shape == (2, 256, 512)
    assert got["mse_history"].shape == (2, 4)
    for k in ("native", "saa", "ibp"):
        assert _u8_diff(got[k], want[k]) <= 2, k
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)


@pytest.mark.parametrize("scene", ["nyquist", "noise", "impulses"])
def test_hybrid_holds_on_adversarial_inputs(scene):
    """The hybrid tail's +-1 contract on the inputs where the iteration
    contracts slowest (the JAX package's own adversarial scenes)."""
    frames = _scene_frames(scene)
    psf = TC.make_gaussian_psf()
    want = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu")
    got = TC.solve(frames, psf, SHIFTS, n_iter=20, device="cpu",
                   band_store="hybrid:8")
    assert _u8_diff(got["ibp"], want["ibp"]) <= 1, scene


def test_fused_on_refuses_a_shape_it_cannot_take():
    with pytest.raises(ValueError, match="does not qualify"):
        TC.solve(_scene_frames(), TC.make_gaussian_psf(), SHIFTS, n_iter=2,
                 device="cpu", fused="on")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture()
def corner_session(tmp_path):
    rng = np.random.default_rng(0)
    sdir = tmp_path / "data" / "s0"
    scene = ndi.gaussian_filter(rng.uniform(0, 255, (64, 80)), 1.2)
    for ci in range(4):
        save_png(np.clip(scene + rng.normal(0, 1, scene.shape), 0,
                         255).astype(np.uint8), str(sdir / f"corner{ci}_rep00.png"))
    return str(sdir.parent)


def test_cli_band_store_hybrid_matches_jax_cli(monkeypatch, corner_session,
                                               tmp_path):
    monkeypatch.setenv("SRTPU_BAND_STORE", "f32")  # the JAX CLI sets it
    args = ["--workload", "mono_barcodes", "--data-dir", corner_session,
            "--no-figures", "--band-store", "hybrid"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_run.main(args + ["--output-dir", out_j]) == 0
    assert torch_run.main(args + ["--output-dir", out_t,
                                  "--device", "cpu"]) == 0
    uj, ut = os.path.join(out_j, "s0", "rep0"), os.path.join(out_t, "s0", "rep0")
    for name in ("native_2x.png", "SAA.png", "SAA_IBP.png", "LR_mean.png",
                 "shifts.json", "metrics.json", "done.flag"):
        assert os.path.exists(os.path.join(ut, name)), name
    for name in ("native_2x.png", "SAA.png", "SAA_IBP.png"):
        a = load_image(os.path.join(uj, name)).astype(int)
        b = load_image(os.path.join(ut, name)).astype(int)
        assert np.abs(a - b).max() <= 1, name
    mt = json.load(open(os.path.join(ut, "metrics.json")))
    mj = json.load(open(os.path.join(uj, "metrics.json")))
    np.testing.assert_allclose(mt["mse_history"], mj["mse_history"],
                               rtol=1e-3)


def test_cli_rejects_bad_modes(corner_session, tmp_path):
    base = ["--workload", "mono_barcodes", "--data-dir", corner_session,
            "--output-dir", str(tmp_path / "o"), "--no-figures",
            "--device", "cpu"]
    for bad in (["--band-store", "fp16"], ["--fused-ibp", "1"]):
        with pytest.raises(SystemExit) as exc:
            torch_run.main(base + bad)
        assert exc.value.code != 0
    # 'on' at a shape the fused kernels cannot take is an error, not banded
    with pytest.raises(ValueError, match="does not qualify"):
        torch_run.main(base + ["--fused-ibp", "on"])
