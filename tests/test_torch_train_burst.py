"""The port's burst training (``train/state.py``, ``train/data.py``,
``train/burst.py``) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both; each random draw
of the JAX trainer is fed to the port's pure function of its draws.
Tolerances:

* the scene pools are the reference's numpy code from the same seed:
  equal;
* crops: equal (a gather); burst batches: 1e-3 absolute on 0..255;
* a train step from the same parameters and batch: ``loss``, ``psnr`` and
  ``grad_norm`` within rtol 1e-4 (measured <= 3.1e-7); parameters and
  their EMA after 3 steps within 0.01 of the learning rate (Adam divides
  each gradient by its own root mean square, so a float32 rounding
  difference in a gradient near 0 moves an update by a share of the rate;
  measured <= 3.2e-4 lr, with gradient clipping and AdamW's decay);
* ``evaluate_burst`` at noise 0 and jitter 0 (the draws drop out): PSNR
  within 0.01 dB and SSIM within 1e-4.

The port's random stream differs from JAX's for the same seed, so whole
runs are compared only where the draws drop out (``--eval-only`` at noise
and jitter 0); resume is checked against an uninterrupted port run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.train import burst as JB
from enph459_super_resolution_tpu.train import data as JD
from enph459_super_resolution_tpu.train import state as JS
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.train import burst as TB
from enph459_super_resolution_tpu_torch.train import data as TD
from enph459_super_resolution_tpu_torch.train import state as TS

from test_torch_fusion import flax_burst_params, jax_burst_run, \
    port_run_from_jax

LR_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# pools, crops, burst batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(JD.POOL_KINDS))
def test_scene_pools_are_the_reference(kind):
    want = JD.POOL_KINDS[kind](n_images=3, size=64, channels=1, seed=4)
    got = TD.POOL_KINDS[kind](n_images=3, size=64, channels=1, seed=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_image_pool_from_dir_is_the_reference():
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures", "eval_hr")
    for channels in (1, 3):
        want = JD.image_pool_from_dir(fixtures, channels=channels)
        got = TD.image_pool_from_dir(fixtures, channels=channels)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(TB._tile_pool(got, 16)) == len(JB._tile_pool(want, 16))


def test_crop_batch_matches_jax_crops():
    """JAX's crop draws, fed to the port's pure crop."""
    pool = np.random.default_rng(1).uniform(0, 255, (5, 40, 44)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JB._crop_hr_batch(jnp.asarray(pool), key, 20, 16))
    kimg, ky, kx, kf = jax.random.split(key, 4)
    draws = [np.array(jax.random.randint(k, (16,), 0, hi))
             for k, hi in ((kimg, 5), (ky, 21), (kx, 25))]
    flips = np.array(jax.random.bernoulli(kf, shape=(16, 3)))
    assert flips.any(axis=0).all()  # every augmentation is exercised
    got = TB.crop_batch(torch.from_numpy(pool),
                        *(torch.as_tensor(d, dtype=torch.int64)
                          for d in draws),
                        torch.from_numpy(flips), 20).numpy()
    np.testing.assert_array_equal(got, want)
    g = TB.generator("cpu", 0, 17, 1)
    assert TB._crop_hr_batch(torch.from_numpy(pool), g, 20, 4).shape == (
        4, 20, 20)


@pytest.mark.parametrize("arch", sorted(JB.ARCHS))
def test_burst_batch_matches_jax_gen(arch):
    """JAX's shift-jitter and noise draws, fed to ``BurstGen.batch``."""
    from enph459_super_resolution_tpu.sr.classical import make_gaussian_psf

    name = JB.ARCHS[arch]
    psf = make_gaussian_psf()
    hr = np.random.default_rng(2).uniform(0, 255, (3, 48, 48)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    want = JB.make_burst_gen(JB.NOMINAL_SHIFTS_4, 2, psf, 2.0, 0.05,
                             model_name=name)(jnp.asarray(hr), key)
    kj, kn = jax.random.split(key)
    nom = jnp.asarray(JB.NOMINAL_SHIFTS_4, jnp.float32)
    true = nom[None] + 0.05 * jax.random.normal(kj, (3, 4, 2), jnp.float32)
    noise = np.stack([np.asarray(jax.random.normal(k, (4, 24, 24),
                                                   jnp.float32))
                      for k in jax.random.split(kn, 3)])
    gen = TB.BurstGen(TB.NOMINAL_SHIFTS_4, 2, psf, 2.0, 0.05,
                      model_name=name)
    stack, tgt = gen.batch(torch.from_numpy(hr),
                           torch.from_numpy(np.array(true)),
                           torch.from_numpy(noise))
    assert stack.shape == want[0].shape and tgt.shape == want[1].shape
    np.testing.assert_allclose(stack.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(want[1]))
    stack2, _ = gen(torch.from_numpy(hr), TB.generator("cpu", 0, 1))
    assert stack2.shape == stack.shape


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

STEP_CASES = {
    "l1": dict(loss="l1"),
    "l2": dict(loss="l2"),
    "charbonnier": dict(loss="charbonnier"),
    "clip_adamw": dict(loss="l1", grad_clip=0.5, weight_decay=1e-2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """Three steps across an ``lr_halve_every`` boundary (at count 2), from
    the same parameters on the same batches."""
    kw = STEP_CASES[case]
    flax_model, params = flax_burst_params("lr", 8, 2, seed=3)
    cfg_j = JS.TrainConfig(learning_rate=1e-2, lr_halve_every=2, **kw)
    cfg_t = TS.TrainConfig(learning_rate=1e-2, lr_halve_every=2, **kw)
    tx = JS.make_optimizer(cfg_j)
    state_j = JS.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    step_j = jax.jit(JS.make_train_step(flax_model.apply, tx, cfg_j))
    model = TZ.BurstFusionLR(n_frames=4, factor=2, n_feats=8, n_resblocks=2,
                             device="cpu")
    convert.load_flax_params(model, params)
    state_t = TS.TrainState.create(model, cfg_t)
    step_t = TS.make_train_step(cfg_t)
    rng = np.random.default_rng(9)
    for it in range(3):
        x = rng.uniform(0, 255, (2, 6, 7, 16)).astype(np.float32)
        y = rng.uniform(0, 255, (2, 12, 14, 1)).astype(np.float32)
        state_j, m_j = step_j(state_j, jnp.asarray(x), jnp.asarray(y))
        m_t = step_t(state_t, torch.from_numpy(x), torch.from_numpy(y))
        assert sorted(m_t) == sorted(m_j) == ["grad_norm", "loss", "psnr"]
        for k in m_t:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=1e-4, err_msg=f"{k} step {it}")
    assert state_t.step == int(state_j.step) == 3
    assert state_t.optimizer.param_groups[0]["lr"] == 0.5e-2
    want = convert.flax_state_dict(jax.tree_util.tree_map(
        np.asarray, state_j.params))
    want_ema = convert.flax_state_dict(jax.tree_util.tree_map(
        np.asarray, state_j.ema_params))
    for name, p in state_t.params.items():
        lr_tol = LR_SHARE * cfg_t.learning_rate
        assert np.abs(p.detach().numpy() - want[name].numpy()).max() \
            <= lr_tol, name
        assert np.abs(state_t.ema_params[name].numpy()
                      - want_ema[name].numpy()).max() <= lr_tol, name


def test_learning_rate_is_optax_staircase():
    """The rate of update k+1 is optax's schedule at count k (the updates
    before it), not StepLR's one step later."""
    import optax

    cfg = TS.TrainConfig(learning_rate=1.0, lr_halve_every=3)
    sched = optax.exponential_decay(1.0, transition_steps=3, decay_rate=0.5,
                                    staircase=True)
    assert [TS.learning_rate(cfg, c) for c in range(7)] == [
        float(sched(c)) for c in range(7)] == [
        1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.25]
    assert TS.learning_rate(TS.TrainConfig(learning_rate=0.3), 99) == 0.3


def test_checkpoints_keep_the_newest_two(tmp_path):
    model = TZ.BurstFusionLR(n_frames=4, factor=2, n_feats=8, n_resblocks=1,
                             device="cpu")
    state = TS.TrainState.create(model, TS.TrainConfig())
    for step in (1, 2, 3):
        state.step = step
        TS.save_checkpoint(str(tmp_path), state.state_dict())
    assert TS.checkpoint_steps(str(tmp_path)) == [2, 3]
    back = TS.load_checkpoint(str(tmp_path))
    assert back["step"] == 3 and set(back) == {
        "step", "params", "opt_state", "ema_params"}


# --------------------------------------------------------------------------
# evaluation and the trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JB.ARCHS))
def test_evaluate_burst_matches_jax_at_zero_noise(arch):
    flax_model, params = flax_burst_params(arch, 8, 1, seed=5)
    scenes = JD.synthetic_scene_pool(n_images=2, size=64, channels=1, seed=3)
    register = JB.REGISTER_FNS[JB.ARCHS[arch]]
    kw = dict(factor=2, noise_sigma=0.0, jitter_sigma=0.0, n_iter=10,
              refine=2)
    want = JB.evaluate_burst(flax_model.apply, jax.tree_util.tree_map(
        jnp.asarray, params), scenes, register=register, **kw)
    cls = TZ.BurstFusionLR if arch == "lr" else TZ.BurstFusion
    model = cls(n_frames=4, n_feats=8, n_resblocks=1, device="cpu",
                **({"factor": 2} if arch == "lr" else {}))
    convert.load_flax_params(model, params)
    got = TB.evaluate_burst(model, scenes,
                            register=TB.REGISTER_FNS[TB.ARCHS[arch]], **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        tol = 1e-4 if k.startswith("ssim") else 0.01
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def _tiny(out, **kw):
    args = dict(steps=4, batch=2, lr_patch=12, pool_images=10, arch="lr",
                n_feats=8, n_resblocks=1, out_dir=str(out), eval_every=4,
                ckpt_every=2, device="cpu")
    args.update(kw)
    return TB.train_burst(**args)


def test_train_burst_writes_a_complete_run_and_resumes_exactly(tmp_path):
    final = _tiny(tmp_path / "full")
    for name in ("config.json", "metrics.jsonl", "eval.jsonl",
                 "final_eval.json"):
        assert os.path.exists(tmp_path / "full" / name), name
    cfg = json.loads((tmp_path / "full" / "config.json").read_text())
    assert sorted(cfg) == sorted([
        "model", "frames", "factor", "n_feats", "n_resblocks", "noise",
        "jitter", "lr_patch", "batch", "steps", "pool", "pool_images",
        "data_dir", "tile", "loss", "learning_rate", "seed"])
    recs = [json.loads(ln) for ln in
            (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 4]
    assert sorted(recs[0]) == ["grad_norm", "loss", "psnr", "rss_mb",
                               "step", "wall_s"]
    assert final["steps"] == 4 and final["psnr_ibp"] > final["psnr_bicubic"]
    assert TS.checkpoint_steps(str(tmp_path / "full" / "ckpt")) == [2, 4]

    # drop the step-4 checkpoint and resume from step 2: steps 3-4 again
    # (their draws are seeded by the step) give the same state
    ckpt = tmp_path / "full" / "ckpt"
    first = TS.load_checkpoint(str(ckpt), 4)
    import shutil
    shutil.rmtree(ckpt / "4")
    _tiny(tmp_path / "full")
    again = TS.load_checkpoint(str(ckpt), 4)
    for part in ("params", "ema_params"):
        for name in first[part]:
            assert torch.equal(first[part][name], again[part][name]), (
                part, name)
    for key, v in first["opt_state"]["state"].items():
        for k in v:
            assert torch.equal(v[k], again["opt_state"]["state"][key][k])


def test_train_burst_hr_arch_and_load(tmp_path):
    final = _tiny(tmp_path / "hr", arch="hr", steps=2, eval_every=2)
    assert "psnr_fusion" in final
    model, cfg = TB.load_burst_run(str(tmp_path / "hr"), device="cpu")
    assert isinstance(model, TZ.BurstFusion) and cfg["model"] == "burstfusion"
    model16, _ = TB.load_burst_run(str(tmp_path / "hr"),
                                   dtype=torch.bfloat16, device="cpu")
    assert model16.Conv_0.compute_dtype == torch.bfloat16


def test_eval_only_matches_jax_cli(tmp_path, capsys):
    """``--eval-only`` of a JAX run and of its port copy, at noise and
    jitter 0, score the same held-out split alike."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    jax_burst_run(jdir, n_feats=8, n_resblocks=1)
    port_run_from_jax(jdir, tdir)
    flags = ["--eval-only", "--noise", "0", "--jitter", "0",
             "--eval-iters", "10"]
    assert JB.main(["--out", jdir] + flags) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TB.main(["--out", tdir, "--device", "cpu"] + flags) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) and got["n_scenes"] == 2
    for k in want:
        tol = 1e-4 if k.startswith("ssim") else 0.01
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_train_burst_without_a_card_exits_2_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    out = tmp_path / "run"
    for extra in ([], ["--eval-only"]):
        with pytest.raises(SystemExit) as exc:
            TB.main(["--steps", "2", "--out", str(out)] + extra)
        assert exc.value.code == 2
        assert not out.exists()
    with pytest.raises(RuntimeError, match="cuda"):
        TB.train_burst(steps=1, out_dir=str(out))
    assert not out.exists()


def test_default_out_dir_is_the_reference():
    """``train.burst`` writes to ``burst_run`` under the temp dir by
    default, as the JAX package writes ``/tmp/burst_run``: the CLI's parser
    and the function agree."""
    import inspect
    import tempfile

    ref = inspect.signature(JB.train_burst).parameters["out_dir"].default
    assert ref == "/tmp/burst_run"
    want = os.path.join(tempfile.gettempdir(), os.path.basename(ref))
    assert TB.build_parser().get_default("out") == want
    assert inspect.signature(TB.train_burst).parameters["out_dir"].default \
        == want
