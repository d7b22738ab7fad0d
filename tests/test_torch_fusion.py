"""The port's burst engine (``sr/fusion.py``, the burst models of
``models/zoo.py``, ``convert.save_burst_run`` and ``train.burst.
load_burst_run``) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both.  Tolerances:

* registration (tensor-shift, banded, conv, batched) and simulation:
  1e-3 absolute on 0..255 in float32 (the reference's own banded-vs-traced
  bound is 2e-3; the port's banded registration is the same banded matrices
  applied by the plain version of the banded-row kernel);
* the burst models on converted flax weights with a random head (so the
  trunk shows): rtol 1e-4 / atol 1e-3 in float32, as the other models;
  in bfloat16 within 0.05 of the residual's span (every conv output rounds
  to 8 significant bits, as PERF.md holds BurstFusionLR bf16);
* the engine: ``sr`` within +-1 uint8 of the JAX engine's and the forward
  MSEs within rtol 1e-4 in float32; bf16 as the models.

JAX runs are written with flax-initialised weights (head randomised, EMA
apart from the parameters) through orbax, as the JAX trainer writes them,
and carried into the port with ``convert.save_burst_run``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.sr import fusion as JF
from enph459_super_resolution_tpu.sr.classical import make_gaussian_psf
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.sr import fusion as TF

ATOL = 1e-3
RTOL_MODEL, ATOL_MODEL = 1e-4, 1e-3
BF16_SHARE = 0.05
SHIFTS = JF.NOMINAL_SHIFTS_4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def flax_burst_params(arch: str, n_feats: int, n_resblocks: int,
                      seed: int = 0, head: float = 0.05):
    """flax-initialised parameters of a burst model with its zero head
    replaced by a random one; returns (flax module, numpy params)."""
    if arch == "lr":
        model = JZ.BurstFusionLR(n_frames=4, factor=2, n_feats=n_feats,
                                 n_resblocks=n_resblocks)
        x = jnp.zeros((1, 8, 8, 16), jnp.float32)
    else:
        model = JZ.BurstFusion(n_frames=4, n_feats=n_feats,
                               n_resblocks=n_resblocks)
        x = jnp.zeros((1, 16, 16, 4), jnp.float32)
    params = _numpy_tree(model.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed + 100)
    h = params["params"]["Conv_1"]
    h["kernel"] = (head * rng.standard_normal(h["kernel"].shape)).astype(
        np.float32)
    h["bias"] = (0.1 * rng.standard_normal(h["bias"].shape)).astype(
        np.float32)
    return model, params


def jax_burst_run(run_dir: str, arch: str = "lr", n_feats: int = 16,
                  n_resblocks: int = 2, seed: int = 0) -> dict:
    """A JAX ``train.burst`` run directory (config.json + orbax ckpt at
    step 3) with flax-initialised weights, a random head, and EMA weights
    that differ from the parameters; returns its config."""
    import orbax.checkpoint as ocp

    from enph459_super_resolution_tpu.train.state import (
        TrainConfig, TrainState, make_optimizer)

    _, params = flax_burst_params(arch, n_feats, n_resblocks, seed)
    _, ema = flax_burst_params(arch, n_feats, n_resblocks, seed + 1)
    tx = make_optimizer(TrainConfig())
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                              tx)
    state = state.replace(
        ema_params=jax.tree_util.tree_map(jnp.asarray, ema),
        step=jnp.asarray(3, jnp.int32))
    mngr = ocp.CheckpointManager(
        os.path.abspath(os.path.join(run_dir, "ckpt")),
        options=ocp.CheckpointManagerOptions(max_to_keep=2))
    mngr.save(3, args=ocp.args.StandardSave(state))
    mngr.wait_until_finished()
    cfg = dict(model={"lr": "burstfusion_lr", "hr": "burstfusion"}[arch],
               frames=4, factor=2, n_feats=n_feats, n_resblocks=n_resblocks,
               noise=2.0, jitter=0.05, lr_patch=12, batch=2, steps=3,
               pool="synthetic", pool_images=10, data_dir=None, tile=None,
               loss="l1", learning_rate=1e-4, seed=seed)
    with open(os.path.join(run_dir, "config.json"), "w") as fp:
        json.dump(cfg, fp)
    return cfg


def port_run_from_jax(jax_dir: str, port_dir: str) -> None:
    """``save_burst_run`` of a JAX run, as the README says to."""
    from enph459_super_resolution_tpu.train.state import \
        restore_checkpoint_numpy

    tree, _ = restore_checkpoint_numpy(os.path.join(jax_dir, "ckpt"))
    with open(os.path.join(jax_dir, "config.json")) as fp:
        cfg = json.load(fp)
    convert.save_burst_run(port_dir, cfg, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run dir, port run dir) of the LR arch."""
    base = tmp_path_factory.mktemp("burst_runs")
    jax_dir, port_dir = str(base / "jax"), str(base / "port")
    jax_burst_run(jax_dir)
    port_run_from_jax(jax_dir, port_dir)
    return jax_dir, port_dir


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def _burst(seed=0, shape=(48, 64)):
    """A burst of 4 frames simulated (numpy-side scene) from a smooth HR
    scene with the nominal shifts, plus the scene."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    hr = ndi.gaussian_filter(rng.uniform(0, 255, shape), 2.0)
    hr = ((hr - hr.min()) / np.ptp(hr) * 200 + 20).astype(np.float32)
    lr = np.asarray(JF.simulate_burst(jnp.asarray(hr), jnp.asarray(
        SHIFTS, jnp.float32), make_gaussian_psf(), 2))
    lr = lr + rng.normal(0, 1.0, lr.shape).astype(np.float32)
    return np.clip(lr, 0, 255).astype(np.float32), hr


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

def test_register_burst_matches_jax():
    lr = _lr((4, 12, 16), 1)
    s = np.asarray(SHIFTS, np.float32) + np.random.default_rng(2).normal(
        0, 0.2, (4, 2)).astype(np.float32)
    want = np.asarray(JF.register_burst(jnp.asarray(lr), jnp.asarray(s), 2))
    got = TF.register_burst(torch.from_numpy(lr), s, 2).numpy()
    assert got.shape == (24, 32, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # a batch of bursts with the same shifts, as the trainer registers
    lrb = _lr((3, 4, 12, 16), 3)
    want = np.asarray(jax.vmap(lambda b: JF.register_burst(
        b, jnp.asarray(s), 2))(jnp.asarray(lrb)))
    got = TF.register_burst(torch.from_numpy(lrb), s, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_register_burst_phases_matches_jax():
    lr = _lr((4, 20, 24), 4)
    s = np.asarray(SHIFTS, np.float32) + np.random.default_rng(5).normal(
        0, 0.3, (4, 2)).astype(np.float32)
    want = np.asarray(JF.register_burst_phases(jnp.asarray(lr),
                                               jnp.asarray(s), 2))
    got = TF.register_burst_phases(torch.from_numpy(lr), s, 2).numpy()
    assert got.shape == (20, 24, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # per-burst shifts in a batch: one op
    lrb = _lr((2, 4, 20, 24), 6)
    sb = np.stack([s, s[::-1]])
    want = np.asarray(jax.vmap(lambda b, t: JF.register_burst_phases(
        b, t, 2))(jnp.asarray(lrb), jnp.asarray(sb)))
    got = TF.register_burst_phases(torch.from_numpy(lrb),
                                   torch.from_numpy(sb), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


REG_CASES = {
    "jittered": (np.asarray(SHIFTS, np.float64)
                 + np.random.default_rng(3).normal(0, 0.3, (4, 2)),
                 (4, 40, 48)),
    "large_shift_edge": (np.asarray([[1.7, -2.3], [-1.1, 2.9]]),
                         (2, 16, 20)),
}


@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_banded_registration_matches_jax(case):
    shifts, shape = REG_CASES[case]
    lr = _lr(shape, 7)
    n, h, w = shape
    want = np.asarray(JF.register_burst_phases_banded(
        jnp.asarray(lr), JF.build_register_phase_ops(shifts, h, w, 2)))
    ops = TF.build_register_phase_ops(shifts, h, w, 2, device="cpu")
    got = TF.register_burst_phases_banded(torch.from_numpy(lr), ops).numpy()
    assert got.shape == (h, w, n * 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    traced = np.asarray(JF.register_burst_phases(
        jnp.asarray(lr), jnp.asarray(shifts, jnp.float32), 2))
    np.testing.assert_allclose(got, traced, rtol=0, atol=2e-3)


@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_conv_registration_matches_jax(case):
    shifts, shape = REG_CASES[case]
    lr = _lr(shape, 8)
    jconv = JF.build_register_phase_conv(shifts, 2)
    tconv = TF.build_register_phase_conv(shifts, 2, device="cpu")
    np.testing.assert_array_equal(tconv.kernel.numpy(),
                                  np.asarray(jconv.kernel))
    assert (tconv.pads_y, tconv.pads_x) == (jconv.pads_y, jconv.pads_x)
    want = np.asarray(jconv(jnp.asarray(lr)))
    got = tconv(torch.from_numpy(lr)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    banded = TF.register_burst_phases_banded(
        torch.from_numpy(lr), TF.build_register_phase_ops(
            shifts, shape[1], shape[2], 2, device="cpu")).numpy()
    np.testing.assert_allclose(got, banded, rtol=0, atol=ATOL)


def test_conv_registration_batched_bursts():
    bursts = _lr((3, 4, 24, 32), 9)
    conv = TF.build_register_phase_conv(SHIFTS, 2, device="cpu")
    got = conv(torch.from_numpy(bursts)).numpy()
    assert got.shape == (3, 24, 32, 16)
    want = np.asarray(JF.build_register_phase_conv(SHIFTS, 2)(
        jnp.asarray(bursts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for b in range(3):
        np.testing.assert_allclose(
            got[b], conv(torch.from_numpy(bursts[b])).numpy(), atol=1e-4)


# --------------------------------------------------------------------------
# simulation
# --------------------------------------------------------------------------

def test_simulate_burst_noise_free_matches_jax():
    hr = _lr((32, 40), 10)
    s = np.asarray(SHIFTS, np.float32) * 1.3
    psf = make_gaussian_psf()
    want = np.asarray(JF.simulate_burst(jnp.asarray(hr), jnp.asarray(s),
                                        psf, 2))
    got = TF.simulate_burst(torch.from_numpy(hr), s, psf, 2).numpy()
    assert got.shape == (4, 16, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_simulate_burst_with_jax_noise_matches_jax():
    """JAX's noise draw injected: the draws apart, the burst is the same
    function (clipping included: sigma 40 pushes samples past 0..255)."""
    hr = _lr((2, 32, 40), 11)
    s = np.random.default_rng(12).uniform(-1, 1, (2, 4, 2)).astype(
        np.float32)
    psf = make_gaussian_psf()
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    want = np.asarray(jax.vmap(lambda h, t, k: JF.simulate_burst(
        h, t, psf, 2, 40.0, k))(jnp.asarray(hr), jnp.asarray(s), keys))
    noise = np.stack([np.asarray(jax.random.normal(k, (4, 16, 20),
                                                   jnp.float32))
                      for k in keys])
    got = TF.simulate_burst(torch.from_numpy(hr), torch.from_numpy(s), psf,
                            2, 40.0, noise=torch.from_numpy(noise)).numpy()
    assert (got == 0).any() and (got == 255).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_data_consistency_refine_matches_jax():
    lr, _ = _burst(13, (32, 40))
    hr0 = np.array(jnp.clip(JF.register_burst(jnp.asarray(lr), jnp.asarray(
        SHIFTS, jnp.float32), 2).mean(-1), 0, 255))
    psf = make_gaussian_psf()
    want = np.asarray(JF.data_consistency_refine(
        jnp.asarray(hr0), jnp.asarray(lr), jnp.asarray(SHIFTS, jnp.float32),
        psf, 2, 3))
    got = TF.data_consistency_refine(torch.from_numpy(hr0),
                                     torch.from_numpy(lr), SHIFTS, psf, 2,
                                     3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not np.allclose(got, hr0)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

MODEL_CASES = {"lr": ((2, 10, 12, 16), TZ.BurstFusionLR, dict(factor=2)),
               "hr": ((2, 20, 24, 4), TZ.BurstFusion, {})}


@pytest.mark.parametrize("arch", sorted(MODEL_CASES))
def test_burst_model_matches_flax_f32_and_bf16(arch):
    shape, cls, kw = MODEL_CASES[arch]
    x = _lr(shape, 14)
    flax_model, params = flax_burst_params(arch, 16, 2)
    want = np.asarray(flax_model.apply(params, jnp.asarray(x)))
    model = cls(n_frames=4, n_feats=16, n_resblocks=2, device="cpu", **kw)
    convert.load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        base = model.shift_and_add(torch.from_numpy(x)).numpy()
    span = np.abs(want - base).max()
    assert span > 1.0  # the random head lets the trunk show
    np.testing.assert_allclose(got, want, rtol=RTOL_MODEL, atol=ATOL_MODEL)

    flax_bf16 = flax_model.clone(dtype=jnp.bfloat16)
    want16 = np.asarray(flax_bf16.apply(params, jnp.asarray(x)))
    model16 = cls(n_frames=4, n_feats=16, n_resblocks=2, device="cpu",
                  dtype=torch.bfloat16, **kw)
    convert.load_flax_params(model16, params)
    assert model16.Conv_0.weight.dtype == torch.float32
    with torch.no_grad():
        got16 = model16(torch.from_numpy(x))
    assert got16.dtype == torch.float32
    assert np.abs(got16.numpy() - want16).max() <= BF16_SHARE * span
    assert np.abs(got16.numpy() - want).max() <= BF16_SHARE * span


def test_zero_head_reproduces_shift_and_add():
    x = _lr((1, 8, 10, 16), 15)
    model = TZ.create_model("burstfusion_lr", n_frames=4, factor=2,
                            n_feats=8, n_resblocks=1, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), model.shift_and_add(torch.from_numpy(x)).numpy(),
        atol=1e-4)
    hr = TZ.create_model("burstfusion", device="cpu")
    assert (hr.n_feats, hr.n_resblocks) == (48, 6)
    assert not hr.Conv_1.weight.abs().sum()


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _u8(a):
    return np.clip(np.asarray(a), 0, 255).astype(np.uint8).astype(int)


ENGINE_CASES = {
    "plain": dict(),
    "banded_refine": dict(refine=3),
    "vjp_refine": dict(refine=2, refine_engine="vjp"),
    "traced_register": dict(static_register=False),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_fusion_engine_matches_jax(runs, case):
    jax_dir, port_dir = runs
    kw = ENGINE_CASES[case]
    lr, _ = _burst(16)
    psf = make_gaussian_psf()
    sr_j, mse_j, raw_j = JF.FusionEngine(jax_dir, **kw)(lr, SHIFTS, psf)
    eng = TF.FusionEngine(port_dir, device="cpu", **kw)
    assert eng.static_register == kw.get("static_register", True)
    sr_t, mse_t, raw_t = eng(lr, SHIFTS, psf)
    assert isinstance(sr_t, np.ndarray) and sr_t.shape == (48, 64)
    assert np.abs(_u8(sr_t) - _u8(sr_j)).max() <= 1
    np.testing.assert_allclose(mse_t, float(mse_j), rtol=1e-4)
    np.testing.assert_allclose(raw_t, float(raw_j), rtol=1e-4)
    if kw.get("refine"):
        assert mse_t < raw_t
    else:
        assert mse_t == raw_t


def test_fusion_engine_bf16_tracks_f32(runs):
    jax_dir, port_dir = runs
    lr, _ = _burst(17)
    psf = make_gaussian_psf()
    sr32, _, _ = TF.FusionEngine(port_dir, device="cpu")(lr, SHIFTS, psf)
    eng = TF.FusionEngine(port_dir, device="cpu", dtype="bf16")
    assert eng.model.Conv_0.compute_dtype == torch.bfloat16
    sr16, _, _ = eng(lr, SHIFTS, psf)
    sr16_j, _, _ = JF.FusionEngine(jax_dir, dtype="bf16")(lr, SHIFTS, psf)
    stack = eng.register_stack(torch.from_numpy(lr), SHIFTS)
    base = eng.model.shift_and_add(stack[None])[0, ..., 0].numpy()
    span = np.abs(sr32 - base).max()
    assert span > 1.0
    assert np.abs(sr16 - sr32).max() <= BF16_SHARE * span
    assert np.abs(sr16 - np.asarray(sr16_j)).max() <= BF16_SHARE * span


def test_fusion_engine_refuses_past_the_tap_window(runs):
    _, port_dir = runs
    lr, _ = _burst(18)
    far = [(3.5, 0.0)] + list(SHIFTS[1:])
    eng = TF.FusionEngine(port_dir, device="cpu", static_register=False)
    with pytest.raises(ValueError, match="tap-window bound"):
        eng(lr, far, make_gaussian_psf())
    # the static conv registration has no bound
    sr, _, _ = TF.FusionEngine(port_dir, device="cpu")(
        lr, far, make_gaussian_psf())
    assert np.isfinite(sr).all()


def test_fusion_engine_caches_are_bounded_lru(runs):
    _, port_dir = runs
    lr, _ = _burst(19, (16, 20))
    eng = TF.FusionEngine(port_dir, device="cpu")
    psfs = [make_gaussian_psf(7, s) for s in (0.8, 0.9, 1.0, 1.1, 1.2)]
    for i in range(10):
        eng(lr, np.asarray(SHIFTS) + 0.01 * i, psfs[i % 5])
    assert len(eng._reg_ops) == eng._reg_ops_cap == 8
    first = next(iter(eng._reg_ops))
    eng(lr, np.frombuffer(first).reshape(4, 2).copy(), psfs[0])  # a hit
    assert next(reversed(eng._reg_ops)) == first
    assert all(isinstance(c, TF.RegisterConv)
               for c in eng._reg_ops.values())


def test_fusion_engine_check_and_options(runs):
    _, port_dir = runs
    eng = TF.FusionEngine(port_dir, device="cpu")
    eng.check(4, 2)
    with pytest.raises(ValueError, match="trained for"):
        eng.check(5, 2)
    with pytest.raises(ValueError, match="trained for"):
        eng.check(4, 3)
    with pytest.raises(ValueError, match="trained for"):
        eng(_lr((3, 8, 8), 0), SHIFTS[:3], make_gaussian_psf())
    for bad in (dict(dtype="fp16"), dict(refine_engine="x"),
                dict(refine=-1)):
        with pytest.raises(ValueError):
            TF.FusionEngine(port_dir, device="cpu", **bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TF.FusionEngine(port_dir)


def test_save_burst_run_of_a_jax_trained_run(tmp_path):
    """A run trained by the JAX trainer, carried across: the port serves
    its EMA weights, equal to the flax model's output."""
    from enph459_super_resolution_tpu.train.burst import (
        load_burst_run as jax_load, train_burst as jax_train)
    from enph459_super_resolution_tpu_torch.train.burst import load_burst_run

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train(steps=2, batch=2, lr_patch=12, pool_images=10, arch="lr",
              n_feats=8, n_resblocks=1, out_dir=jdir, eval_every=2,
              ckpt_every=2)
    port_run_from_jax(jdir, tdir)
    assert os.path.exists(os.path.join(tdir, "ckpt", "2", "state.pt"))
    apply_fn, ema, cfg_j = jax_load(jdir)
    model, cfg = load_burst_run(tdir, device="cpu")
    assert cfg == cfg_j
    assert not any(p.requires_grad for p in model.parameters())
    x = _lr((1, 12, 14, 16), 20)
    want = np.asarray(apply_fn(ema, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_MODEL, atol=ATOL_MODEL)
