"""The port's spatial sharding (``parallel/mesh.py``, ``parallel/tiled.py``,
``models.infer.tiled_infer_sharded`` and ``sr.run --sp``) on the CPU,
against the JAX package's on its 8 virtual CPU devices and against the
port's own unsharded solves, on the same seeded numpy inputs.

The port's meshes here repeat the CPU device (2-8 tiles in one process);
the JAX meshes take distinct virtual devices.  Tolerances are the JAX
package's own (``tests/test_parallel.py``, ``tests/test_infer.py``,
``tests/test_multidevice_cli.py``): the sharded IBP and adjoint within
``atol 1e-3`` of the HR image over the full array, global edges included,
and ``rtol 1e-5`` of the MSE history; native and SAA ``atol 1e-4``;
models ``rtol 1e-4`` / ``atol 1e-3``; CLI artifacts +-1 uint8 and the MSE
history ``rtol 1e-3``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from enph459_super_resolution_tpu import parallel as JP
from enph459_super_resolution_tpu.models import infer as JI
from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.ops import correlate2d_same as j_corr
from enph459_super_resolution_tpu.parallel import mesh as JM
from enph459_super_resolution_tpu.sr import run as jax_run
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch import parallel as TP
from enph459_super_resolution_tpu_torch.data.io import load_image, save_png
from enph459_super_resolution_tpu_torch.models import infer as TI
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.ops.conv import correlate2d_same
from enph459_super_resolution_tpu_torch.parallel import mesh as TM
from enph459_super_resolution_tpu_torch.parallel import tiled as TT
from enph459_super_resolution_tpu_torch.sr import classical as TC
from enph459_super_resolution_tpu_torch.sr import run as torch_run

SHIFTS = ((+0.5, -0.5), (+0.5, +0.5), (-0.5, -0.5), (-0.5, +0.5))
HR_ATOL, ERRS_RTOL = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axes(layout):
    sph, spw = layout
    return {"sp": sph} if spw == 1 else {"sp": sph, "spw": spw}


def _meshes(layout):
    """(port mesh on the repeated CPU, JAX mesh, sp_axis) for a layout."""
    axes = _axes(layout)
    n = layout[0] * layout[1]
    return (TP.make_mesh(axes, devices=["cpu"] * n),
            JP.make_mesh(axes, devices=jax.devices()[:n]), tuple(axes))


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

def _outcome(fn, arg):
    try:
        return fn(arg)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("spec", [
    "dp=2,tp=2", "dp=2 x sp=2 x tp=2", "dp=2,pp=4", "sp=8", " dp = 2 ,,sp=1",
    "ep=4xdp=2", "cp=2", "dp=2,dp=4", "", "dp", "dp=0", "sp=-1", "dp=two"])
def test_parse_mesh_spec_equals_jax(spec):
    assert _outcome(TM.parse_mesh_spec, spec) == \
        _outcome(JM.parse_mesh_spec, spec)


@pytest.mark.parametrize("spec", [
    4, "8", "4x2", (2, 2), [3, 1], "2X2", " 4 ", "4x2x2", "ax2", "0", "4x0",
    "-1", "3x", "", (1, 2, 3), 0])
def test_parse_sp_spec_equals_jax(spec):
    assert _outcome(TM.parse_sp_spec, spec) == \
        _outcome(JM.parse_sp_spec, spec)


def test_make_mesh_shape_and_device_grid():
    mesh = TP.make_mesh({"sp": 4, "spw": 2},
                        devices=[f"cpu:{i}" for i in range(8)])
    jmesh = JP.make_mesh({"sp": 4, "spw": 2})
    assert mesh.shape == dict(jmesh.shape) == {"sp": 4, "spw": 2}
    assert mesh.axis_names == jmesh.axis_names == ("sp", "spw")
    assert mesh.devices.shape == jmesh.devices.shape == (4, 2)
    assert mesh.devices[2, 1] == torch.device("cpu", 5)
    # no axes: every device on one dp axis, as in the reference
    assert TP.make_mesh(devices=["cpu"] * 3).shape == {"dp": 3}


@pytest.mark.parametrize("axes,n", [({"sp": 4}, 2), ({"sp": 2, "spw": 2}, 8),
                                    ({"dp": 3}, 4)])
def test_make_mesh_count_error_equals_jax(axes, n):
    with pytest.raises(ValueError) as mine:
        TP.make_mesh(axes, devices=["cpu"] * n)
    with pytest.raises(ValueError) as ref:
        JP.make_mesh(axes, devices=jax.devices()[:n])
    assert str(mine.value) == str(ref.value)


def test_make_mesh_repeated_device_list():
    mesh = TP.make_mesh({"sp": 4}, devices=["cpu"] * 4)
    assert list(mesh.devices) == [torch.device("cpu")] * 4
    cuda = TP.make_mesh({"sp": 2, "spw": 2},
                        devices=[torch.device("cuda", 0)] * 4)
    assert set(cuda.devices.flat) == {torch.device("cuda", 0)}


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.make_mesh()
    with pytest.raises(RuntimeError):
        TP.make_mesh({"sp": 1})


def test_sp_mesh_layouts_and_card_count():
    mesh, axes = TM.sp_mesh("2x2", "cpu")
    assert axes == ("sp", "spw") and mesh.shape == {"sp": 2, "spw": 2}
    mesh, axes = TM.sp_mesh(4, torch.device("cpu"))
    assert axes == ("sp",) and list(mesh.devices) == [torch.device("cpu")] * 4
    # cuda takes the first cards only: with fewer than the tiles, the
    # mesh's device-count error (none at all without a card)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {n + 1} devices, have {n}"):
        TM.sp_mesh(n + 1, "cuda")


# ---------------------------------------------------------------------------
# halo_exchange and tiled_apply
# ---------------------------------------------------------------------------

def _jax_exchanged(x, layout, halo, mode):
    """The JAX package's halo_exchange of ``x`` (H then W), stitched."""
    _, jmesh, axes = _meshes(layout)
    spec = P(*axes) if len(axes) == 2 else P(axes[0], None)

    def body(t):
        for k, name in enumerate(axes):
            t = JP.halo_exchange(t, halo, name, k, mode)
        return t

    fn = jax.shard_map(body, mesh=jmesh, in_specs=(spec,), out_specs=spec)
    return np.asarray(fn(jax.device_put(jnp.asarray(x),
                                        NamedSharding(jmesh, spec))))


@pytest.mark.parametrize("layout", [(8, 1), (2, 2), (4, 2)],
                         ids=["sp8", "2x2", "4x2"])
@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_halo_exchange_matches_manual_and_jax(layout, mode):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(64, 16)).astype(np.float32)
    halo = 3
    mesh, _, axes = _meshes(layout)
    devices = TT.tile_devices(mesh, axes)
    dims = tuple(range(len(axes)))
    ext = TT.shard(torch.from_numpy(x), dims, devices)
    for k in dims:
        ext = TP.halo_exchange(ext, halo, k, k, edge_mode=mode)
    got = TT.unshard(ext, dims, "cpu").numpy()

    # manual: tile (i, j) is the window [i*th, i*th + th + 2h) (and the
    # same along W) of the padded image, corners included
    pad = [(halo, halo), (halo, halo) if len(axes) == 2 else (0, 0)]
    xp = (np.pad(x, pad, mode="edge") if mode == "edge"
          else np.pad(x, pad))
    th, tw = 64 // layout[0], 16 // layout[1]
    ew = tw + 2 * halo if len(axes) == 2 else tw
    want = np.block([[xp[i * th: i * th + th + 2 * halo, j * tw: j * tw + ew]
                      for j in range(layout[1])] for i in range(layout[0])])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_exchanged(x, layout, halo, mode))
    # every extended tile is its own tensor: no tile aliases another
    ptrs = [t.data_ptr() for t in ext.flat]
    assert len(set(ptrs)) == len(ptrs)


def test_halo_larger_than_tile_raises():
    mesh, _, axes = _meshes((8, 1))
    tiles = TT.shard(torch.zeros(32, 8), (0,), TT.tile_devices(mesh, axes))
    with pytest.raises(ValueError, match="exceeds tile extent"):
        TP.halo_exchange(tiles, 5, 0, 0)
    with pytest.raises(ValueError, match="not divisible by sp=8"):
        TP.tiled_apply(lambda t: t, torch.zeros(60, 8), mesh, halo=2)
    with pytest.raises(ValueError, match="LR dim 60 not divisible"):
        TP.sharded_ibp(np.zeros((4, 60, 8), np.float32),
                       np.zeros((120, 16), np.float32),
                       TC.make_gaussian_psf(), SHIFTS, mesh, n_iter=1)


@pytest.mark.parametrize("layout", [(8, 1), (2, 2)], ids=["sp8", "2x2"])
@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_tiled_apply_5x5_conv(layout, mode):
    """A local op (5x5 box blur) applied tiled equals the global op: away
    from the global edges for edge-replicated halos, everywhere for zero
    halos (SAME padding is zeros); and it equals JAX's tiled_apply over the
    full array."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, size=(64, 40)).astype(np.float32)
    k = np.full((5, 5), 1.0 / 25.0)
    mesh, jmesh, axes = _meshes(layout)
    got = TP.tiled_apply(lambda t: correlate2d_same(t, k), img, mesh,
                         halo=4, sp_axis=axes, edge_mode=mode).numpy()
    whole = correlate2d_same(torch.from_numpy(img), k).numpy()
    trim = 4 if mode == "edge" else 0
    inner = (slice(trim, 64 - trim),
             slice(trim, 40 - trim) if len(axes) == 2 else slice(None))
    np.testing.assert_allclose(got[inner], whole[inner], atol=1e-4)
    want = np.asarray(JP.tiled_apply(lambda t: j_corr(t, k), jnp.asarray(img),
                                     jmesh, halo=4, sp_axis=axes,
                                     edge_mode=mode))
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# sharded_ibp (IBP and adjoint) and solve_sharded
# ---------------------------------------------------------------------------

LAYOUTS = {"sp4": ((4, 1), (4, 128, 48)), "2x2": ((2, 2), (4, 128, 64)),
           "4x2": ((4, 2), (4, 128, 64))}


def _lrs(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, size=shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _port_sharded(name, solver):
    layout, shape = LAYOUTS[name]
    mesh, _, axes = _meshes(layout)
    lrs = _lrs(shape, 2)
    hr0 = TC.shift_and_add(torch.from_numpy(lrs), SHIFTS, 2)
    hr, errs = TP.sharded_ibp(lrs, hr0, TC.make_gaussian_psf(), SHIFTS, mesh,
                              factor=2, n_iter=6,
                              step=2.0 if solver == "adjoint" else 0.5,
                              halo_lr=28, sp_axis=axes, solver=solver)
    assert hr.device == torch.device("cpu") and hr.shape == (256, shape[2] * 2)
    return hr.numpy(), errs.numpy(), hr0.numpy()


@functools.lru_cache(maxsize=None)
def _jax_sharded(name, solver):
    from enph459_super_resolution_tpu.sr import shift_and_add

    layout, shape = LAYOUTS[name]
    _, jmesh, axes = _meshes(layout)
    lrs = jnp.asarray(_lrs(shape, 2))
    hr0 = shift_and_add(lrs, SHIFTS, 2)
    hr, errs = JP.sharded_ibp(lrs, hr0, TC.make_gaussian_psf(), SHIFTS,
                              jmesh, factor=2, n_iter=6,
                              step=2.0 if solver == "adjoint" else 0.5,
                              halo_lr=28, sp_axis=axes, solver=solver)
    return np.asarray(hr), np.asarray(errs)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sharded_ibp_matches_unsharded(name):
    """FULL-array parity with the port's unsharded conv-engine IBP, global
    edges and corners included."""
    _, shape = LAYOUTS[name]
    got_hr, got_errs, hr0 = _port_sharded(name, "ibp")
    want_hr, want_errs = TC.ibp(torch.from_numpy(_lrs(shape, 2)), SHIFTS,
                                TC.make_gaussian_psf(), torch.from_numpy(hr0),
                                2, n_iter=6, step=0.5)
    np.testing.assert_allclose(got_errs, want_errs.numpy(), rtol=ERRS_RTOL)
    np.testing.assert_allclose(got_hr, want_hr.numpy(), atol=HR_ATOL)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sharded_ibp_matches_jax(name):
    got_hr, got_errs, _ = _port_sharded(name, "ibp")
    want_hr, want_errs = _jax_sharded(name, "ibp")
    np.testing.assert_allclose(got_errs, want_errs, rtol=ERRS_RTOL)
    np.testing.assert_allclose(got_hr, want_hr, atol=HR_ATOL)


@pytest.mark.parametrize("name", ["sp4", "2x2"])
def test_sharded_adjoint_matches_unsharded_adjoint(name):
    """The vjp adjoint of the per-tile patched forward equals the port's
    unsharded adjoint solve (transposed banded operators) over the full
    array."""
    _, shape = LAYOUTS[name]
    got_hr, got_errs, _ = _port_sharded(name, "adjoint")
    want = TC.solve(_lrs(shape, 2), TC.make_gaussian_psf(), SHIFTS, n_iter=6,
                    step=2.0, device="cpu", solver="adjoint")
    np.testing.assert_allclose(got_errs, want["mse_history"], rtol=ERRS_RTOL)
    np.testing.assert_allclose(got_hr, want["ibp"], atol=HR_ATOL)


@pytest.mark.parametrize("name", ["sp4", "2x2"])
def test_sharded_adjoint_matches_jax(name):
    got_hr, got_errs, _ = _port_sharded(name, "adjoint")
    want_hr, want_errs = _jax_sharded(name, "adjoint")
    np.testing.assert_allclose(got_errs, want_errs, rtol=ERRS_RTOL)
    np.testing.assert_allclose(got_hr, want_hr, atol=HR_ATOL)


def test_sharded_ibp_rejects_an_unknown_solver():
    mesh, _, _ = _meshes((4, 1))
    with pytest.raises(ValueError, match="solver 'landweber'"):
        TP.sharded_ibp(np.zeros((4, 64, 8), np.float32),
                       np.zeros((128, 16), np.float32),
                       TC.make_gaussian_psf(), SHIFTS, mesh,
                       solver="landweber")


@pytest.mark.parametrize("engine", ["mm", "conv"])
@pytest.mark.parametrize("name", ["sp4", "4x2"])
def test_solve_sharded_matches_solve(name, engine):
    """Against the port's ``solve`` on each engine.  Native-2x and SAA run
    unsharded on the conv engine, so they are held against the conv
    engine's (the banded engine's differ from both by up to 1.2e-4 of f32
    rounding here, as the JAX package's two engines do); the IBP and its
    MSE history against both."""
    layout, shape = LAYOUTS[name]
    mesh, _, axes = _meshes(layout)
    lrs = _lrs(shape, 5)
    psf = TC.make_gaussian_psf()
    want = TC.solve(lrs, psf, SHIFTS, n_iter=6, device="cpu", engine=engine)
    got = TP.solve_sharded(lrs, psf, SHIFTS, mesh, n_iter=6, halo_lr=28,
                           sp_axis=axes)
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, np.ndarray) for v in got.values())
    if engine == "conv":
        for k in ("lr_mean", "native", "saa"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    np.testing.assert_allclose(got["ibp"], want["ibp"], atol=HR_ATOL)
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=ERRS_RTOL)


# ---------------------------------------------------------------------------
# models.infer.tiled_infer_sharded
# ---------------------------------------------------------------------------

def _models(name):
    if name == "espcn":
        kw = dict(scale=2, channels=3)
        jm, cls = JZ.ESPCN(**kw), TZ.ESPCN
    else:
        kw = dict(scale=2, channels=3, n_resblocks=2, n_feats=8)
        jm, cls = JZ.EDSR(**kw), TZ.EDSR
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((1, 8, 8, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    return jm, params, convert.load_flax_params(cls(device="cpu", **kw), tree)


@pytest.mark.parametrize("name", ["espcn", "edsr"])
def test_tiled_infer_sharded_matches_jax(name):
    jm, params, model = _models(name)
    mesh, jmesh, _ = _meshes((4, 1))
    lr = np.random.default_rng(11).uniform(0, 255, (64, 48, 3)).astype(
        np.float32)
    got = TI.tiled_infer_sharded(model, lr, mesh)
    want = np.asarray(JI.tiled_infer_sharded(jm, params, jnp.asarray(lr),
                                             jmesh))
    assert got.shape == want.shape == (128, 96, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # interior-exact against the whole-image forward; only the halo*scale
    # rows at the two global edges may differ
    with torch.no_grad():
        whole = model(torch.from_numpy(lr)[None])[0].numpy()
    b = TI.receptive_field_radius(model) * 2
    np.testing.assert_allclose(got[b:-b], whole[b:-b], rtol=1e-4, atol=1e-3)
    # a batch axis and uint8 input
    both = TI.tiled_infer_sharded(model, np.stack([lr, lr]).astype(np.uint8),
                                  mesh)
    assert both.shape == (2, 128, 96, 3) and both.dtype == np.float32


# ---------------------------------------------------------------------------
# sr.run --sp
# ---------------------------------------------------------------------------

@pytest.fixture()
def tall_session(tmp_path):
    """One-rep corner session tall enough for sp=2 tiles (128 LR rows), as
    tests/test_multidevice_cli.py makes it."""
    rng = np.random.default_rng(7)
    scene = ndi.gaussian_filter(rng.uniform(0, 255, (128, 64)), 1.2)
    sdir = tmp_path / "data" / "tall_mono_session"
    os.makedirs(sdir)
    for ci in range(4):
        img = np.clip(scene + rng.normal(0, 1, scene.shape), 0,
                      255).astype(np.uint8)
        save_png(img, str(sdir / f"corner{ci}_rep00.png"))
    return str(tmp_path / "data")


def _png(out, f):
    return load_image(os.path.join(out, "tall_mono_session", "rep0",
                                   f)).astype(np.int16)


def _mse(out):
    with open(os.path.join(out, "tall_mono_session", "rep0",
                           "metrics.json")) as fp:
        return json.load(fp)["mse_history"]


@pytest.mark.parametrize("sp", ["2", "2x2"])
def test_sr_run_sp_matches_unsharded_and_jax(tall_session, tmp_path, sp):
    base = ["--workload", "mono_barcodes", "--data-dir", tall_session,
            "--no-figures"]
    out1, out2, jout = (str(tmp_path / d) for d in ("sp1", "sp", "jax"))
    assert torch_run.main(base + ["--output-dir", out1, "--device",
                                  "cpu"]) == 0
    assert torch_run.main(base + ["--output-dir", out2, "--device", "cpu",
                                  "--sp", sp]) == 0
    assert jax_run.main(base + ["--output-dir", jout, "--sp", sp]) == 0
    for f in ("LR_mean.png", "shifts.json", "done.flag"):
        assert os.path.exists(os.path.join(out2, "tall_mono_session",
                                           "rep0", f)), f
    for f in ("native_2x.png", "SAA.png", "SAA_IBP.png"):
        got = _png(out2, f)
        assert np.abs(got - _png(out1, f)).max() <= 1, f
        assert np.abs(got - _png(jout, f)).max() <= 1, f
    np.testing.assert_allclose(_mse(out2), _mse(out1), rtol=1e-3)
    np.testing.assert_allclose(_mse(out2), _mse(jout), rtol=1e-3)


def test_sr_run_sp_adjoint(tall_session, tmp_path):
    """``--solver adjoint`` with ``--sp 2``: the vjp adjoint, 20 iterations
    at step 2.0, within +-1 of the unsharded adjoint solve."""
    base = ["--workload", "mono_barcodes", "--data-dir", tall_session,
            "--no-figures", "--device", "cpu", "--solver", "adjoint"]
    out1, out2 = str(tmp_path / "sp1"), str(tmp_path / "sp2")
    assert torch_run.main(base + ["--output-dir", out1]) == 0
    assert torch_run.main(base + ["--output-dir", out2, "--sp", "2"]) == 0
    assert len(_mse(out2)) == 20
    assert np.abs(_png(out2, "SAA_IBP.png")
                  - _png(out1, "SAA_IBP.png")).max() <= 1
    np.testing.assert_allclose(_mse(out2), _mse(out1), rtol=1e-3)


@pytest.mark.parametrize("sp", ["3x", "0", "4x2x2", "2x0"])
def test_sr_run_bad_sp_exits_2(tall_session, tmp_path, sp, capsys):
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        torch_run.main(["--workload", "mono_barcodes", "--data-dir",
                        tall_session, "--output-dir", str(out), "--device",
                        "cpu", "--sp", sp])
    assert exc.value.code == 2
    assert "sp " in capsys.readouterr().err
    assert not out.exists()


def test_sr_run_sp_on_cuda_without_enough_cards_exits_2(tall_session,
                                                        tmp_path, capsys):
    """No CPU fallback: on a machine with no card the device check fails
    first; with fewer cards than tiles, the mesh's device-count error."""
    n = torch.cuda.device_count()
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        torch_run.main(["--workload", "mono_barcodes", "--data-dir",
                        tall_session, "--output-dir", str(out), "--device",
                        "cuda", "--sp", str(n + 1)])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("is False" in err) if n == 0 else \
        (f"needs {n + 1} devices, have {n}" in err)
    assert not out.exists()
