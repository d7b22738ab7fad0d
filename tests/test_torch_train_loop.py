"""The port's training loop and evaluator (``train/loop.py``,
``train/evaluate.py``), on the CPU, beside the JAX package's.

Runs are tiny (a few steps, narrow models).  The port's random streams
differ from JAX's for the same seed, so whole runs are compared by what
does not depend on them: the run directory's files and their keys, and
the config.  Tolerances: ``--steps-per-dispatch 5`` against 1 and a
resumed run against an uninterrupted one run the same float32 ops in the
same order, so they are equal bit for bit; the learning test holds JAX's
own thresholds (``tests/test_train_data.py::test_short_training_learns``).
"""

import json
import os

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.train import evaluate as TE
from enph459_super_resolution_tpu_torch.train import loop as TL
from enph459_super_resolution_tpu_torch.train import state as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(out, **kw):
    args = dict(model_name="espcn", scale=2, steps=6, batch=2, lr_patch=12,
                channels=1, out_dir=str(out), eval_every=6, ckpt_every=3,
                device="cpu")
    args.update(kw)
    return TL.train(**args)


def _records(path):
    with open(path) as fp:
        return [json.loads(ln) for ln in fp]


def test_short_training_learns(tmp_path, capsys):
    """JAX's ``test_short_training_learns`` run (ESPCN x2, 300 steps, seed
    1) and its thresholds: the loss drops 4x and the EMA's PSNR does not
    regress.  Its absolute 14 dB for the EMA is a property of flax's
    initial draws: after 300 steps the EMA (decay 0.999) still holds
    0.999**300 = 74 % of the initial weights, and across seeds 1-3 both
    frameworks land between 11.0 and 17.0 dB (JAX's own seed 2: 11.0).
    The port's initial draws are its own, so the EMA is held to 5 dB above
    the untrained model instead, and the trained (raw) weights to within
    1.5 dB of the bicubic baseline."""
    from enph459_super_resolution_tpu_torch.models import ESPCN
    from enph459_super_resolution_tpu_torch.train.data import (
        evaluate_sr, synthetic_scene_pool)

    final = TL.train(model_name="espcn", scale=2, steps=300, batch=8,
                     lr_patch=16, learning_rate=3e-3, channels=1,
                     out_dir=str(tmp_path / "run"), eval_every=150,
                     ckpt_every=300, seed=1, device="cpu")
    assert np.isfinite(final["psnr"])
    lines = _records(tmp_path / "run" / "metrics.jsonl")
    assert [ln["step"] for ln in lines] == [1, 50, 100, 150, 200, 250, 300]
    assert lines[-1]["loss"] < lines[0]["loss"] * 0.25
    evals = _records(tmp_path / "run" / "eval.jsonl")
    assert [e["step"] for e in evals] == [150, 300]
    assert final["psnr"] >= evals[0]["psnr"] - 0.2
    untrained = ESPCN(scale=2, channels=1, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    eval_pool = synthetic_scene_pool(n_images=32, size=192, channels=1,
                                     seed=1)[:4]
    assert final["psnr"] > evaluate_sr(untrained, eval_pool, 2,
                                       device="cpu")["psnr"] + 5.0
    capsys.readouterr()
    assert TE.main(["--run", str(tmp_path / "run"), "--device", "cpu",
                    "--raw"]) == 0
    raw = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert raw["psnr"] > raw["bicubic_psnr"] - 1.5


# --------------------------------------------------------------------------
# every model, with and without --gan
# --------------------------------------------------------------------------

MODELS = {
    "srcnn": {"f1": 8, "f2": 4},
    "espcn": {},
    "fsrcnn": {"d": 8, "s": 4, "m": 1},
    "edsr": {"n_resblocks": 1, "n_feats": 8},
    "rrdbnet": {"nb": 1, "nf": 8, "gc": 4},
}


@pytest.mark.parametrize("gan", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_model_trains_and_evaluates(tmp_path, capsys, model, gan):
    out = tmp_path / "run"
    final = _tiny(out, model_name=model, channels=3, steps=2, eval_every=2,
                  ckpt_every=2, model_kwargs=MODELS[model], gan=gan,
                  pool_images=4)
    assert final["steps"] == 2 and np.isfinite(final["psnr"])
    rec = _records(out / "metrics.jsonl")[-1]
    keys = (["d_loss", "g_gan", "g_loss", "gan_weight", "psnr"] if gan
            else ["grad_norm", "loss", "psnr"])
    assert sorted(rec) == sorted(keys + ["rss_mb", "step", "wall_s"])
    assert all(np.isfinite(rec[k]) for k in keys)
    ck = TS.load_checkpoint(str(out / "ckpt"))
    assert ("g" in ck) == gan
    capsys.readouterr()
    assert TE.main(["--run", str(out), "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["model"] == model and ev["step"] == 2 and ev["n_images"] == 8
    assert np.isfinite(ev["psnr"])


def test_cli_runs_and_writes_the_run(tmp_path, capsys):
    out = tmp_path / "cli"
    assert TL.main(["--device", "cpu", "--model", "edsr", "--scale", "2",
                    "--steps", "3", "--batch", "2", "--lr-patch", "12",
                    "--pool-images", "4", "--model-kwargs",
                    '{"n_resblocks": 1, "n_feats": 8}', "--out",
                    str(out)]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["steps"] == 3
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["model_kwargs"] == {"n_resblocks": 1, "n_feats": 8}
    assert TS.checkpoint_steps(str(out / "ckpt")) == [3]


# --------------------------------------------------------------------------
# resume, cadence, warm start
# --------------------------------------------------------------------------

def _state(path, step=None):
    return TS.load_checkpoint(str(path / "ckpt"), step)


def _equal_states(a, b):
    for part in ("params", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for key, v in a["opt_state"]["state"].items():
        for k in v:
            assert torch.equal(v[k], b["opt_state"]["state"][key][k])


@pytest.mark.parametrize("ragged", [False, True])
def test_resume_continues_to_the_new_step_count_exactly(tmp_path, ragged):
    """A run to 6, resumed to 7, equals a run straight to 7 bit for bit (the
    rate halves every 3 steps in both; the device sampler's batch i is
    seeded by i, and the host sampler, for a ragged data dir, skips the
    crops it drew before the resume)."""
    kw = {}
    if ragged:
        data = tmp_path / "data"
        data.mkdir()
        from enph459_super_resolution_tpu_torch.data.io import save_png
        rng = np.random.default_rng(0)
        for i, (h, w) in enumerate(((40, 44), (52, 40), (48, 48))):
            save_png(rng.integers(0, 256, (h, w), dtype=np.uint8),
                     str(data / f"im{i}.png"))
        kw = dict(data_dir=str(data))
    _tiny(tmp_path / "a", steps=6, **kw)
    _tiny(tmp_path / "a", steps=7, eval_every=7, **kw)
    _tiny(tmp_path / "b", steps=7, eval_every=7, **kw)
    assert [ln["step"] for ln in _records(
        tmp_path / "a" / "metrics.jsonl")] == [1, 6, 7]
    assert TS.checkpoint_steps(str(tmp_path / "a" / "ckpt")) == [6, 7]
    _equal_states(_state(tmp_path / "a"), _state(tmp_path / "b"))
    assert _state(tmp_path / "a")["step"] == 7


def test_steps_per_dispatch_equals_one(tmp_path):
    for k in (1, 5):
        _tiny(tmp_path / f"k{k}", steps=10, eval_every=10, ckpt_every=5,
              steps_per_dispatch=k)
        assert TS.checkpoint_steps(str(tmp_path / f"k{k}" / "ckpt")) == [5,
                                                                         10]
    _equal_states(_state(tmp_path / "k1"), _state(tmp_path / "k5"))
    # the cadence: the first record is the first chunk's end
    assert [ln["step"] for ln in _records(
        tmp_path / "k5" / "metrics.jsonl")] == [5, 10]
    assert [ln["step"] for ln in _records(
        tmp_path / "k1" / "metrics.jsonl")] == [1, 10]


def test_init_from_warm_starts_the_generator(tmp_path):
    pre = tmp_path / "pre"
    _tiny(pre, steps=4, ckpt_every=4, eval_every=4)
    gan = tmp_path / "gan"
    _tiny(gan, steps=2, ckpt_every=1, eval_every=2, gan=True,
          init_from=str(pre), d_every=2, instance_noise=1.0)
    src = _state(pre)
    one = _state(gan, 1)
    decay = TS.TrainConfig().ema_decay
    for k, p in src["params"].items():
        # one Adam update of drift from the pretrain, not a re-init
        assert (one["g"]["params"][k] - p).abs().max() <= 1.01e-4, k
        # the EMA continues the pretrain's
        want = decay * src["ema_params"][k] + (1 - decay) * one["g"][
            "params"][k]
        torch.testing.assert_close(one["g"]["ema_params"][k], want,
                                   rtol=0, atol=1e-6)
    assert one["g"]["opt_state"]["state"][0]["step"] == 1  # fresh Adam
    two = _state(gan, 2)
    assert two["d_opt_state"]["state"][0]["step"] == 1  # step 0 only
    with pytest.raises(FileNotFoundError):
        _tiny(tmp_path / "x", steps=1, gan=True,
              init_from=str(tmp_path / "nonexistent"))


def test_gan_resume_takes_the_balance_from_the_arguments(tmp_path):
    out = tmp_path / "gan"
    _tiny(out, steps=3, gan=True, ckpt_every=3, eval_every=3,
          gan_weight=0.1)
    assert _state(out)["balance"]["gan_weight"] == 0.1
    _tiny(out, steps=6, gan=True, ckpt_every=3, eval_every=6,
          gan_weight=0.0, d_every=3)
    back = _state(out)
    assert back["step"] == 6
    assert back["balance"] == {"gan_weight": 0.0, "d_lr_scale": 1.0,
                               "d_every": 3, "instance_noise": 0.0}
    rec = _records(out / "metrics.jsonl")[-1]
    assert rec["gan_weight"] == 0.0 and rec["step"] == 6


# --------------------------------------------------------------------------
# against the JAX package's run directory
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gan", [False, True])
def test_run_files_and_keys_are_jax(tmp_path, gan):
    from enph459_super_resolution_tpu.train.loop import train as jax_train

    kw = dict(model_name="espcn", scale=2, steps=6, batch=2, lr_patch=12,
              channels=1, eval_every=3, ckpt_every=3, gan=gan)
    jax_train(out_dir=str(tmp_path / "jax"), dp=False, **kw)
    TL.train(out_dir=str(tmp_path / "port"), device="cpu", **kw)
    j, t = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(j)) == sorted(os.listdir(t)) == [
        "ckpt", "config.json", "eval.jsonl", "final_eval.json",
        "metrics.jsonl"]
    assert json.loads((t / "config.json").read_text()) == json.loads(
        (j / "config.json").read_text())
    for name in ("metrics.jsonl", "eval.jsonl"):
        rj, rt = _records(j / name), _records(t / name)
        assert [r["step"] for r in rt] == [r["step"] for r in rj]
        assert [sorted(r) for r in rt] == [sorted(r) for r in rj], name
    fj = json.loads((j / "final_eval.json").read_text())
    ft = json.loads((t / "final_eval.json").read_text())
    assert sorted(ft) == sorted(fj)
    # the same bicubic baseline on the same eval split
    np.testing.assert_allclose(ft["bicubic_psnr"], fj["bicubic_psnr"],
                               rtol=1e-4)
    assert sorted(d for d in os.listdir(j / "ckpt") if d.isdigit()) == \
        [str(s) for s in TS.checkpoint_steps(str(t / "ckpt"))] == ["3", "6"]


# --------------------------------------------------------------------------
# train.evaluate
# --------------------------------------------------------------------------

def test_evaluate_tiled_raw_and_network_interpolation(tmp_path, capsys):
    pre, gan = tmp_path / "pre", tmp_path / "gan"
    _tiny(pre, steps=6, ckpt_every=6)
    _tiny(gan, steps=6, ckpt_every=6, gan=True, init_from=str(pre))

    w_pre, step = TE.load_run_weights(str(pre))
    w_gan, _ = TE.load_run_weights(str(gan))
    assert step == 6
    for a, want in ((0.0, w_pre), (1.0, w_gan)):
        got = TE.interpolate_weights(w_pre, w_gan, a)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    mid = TE.interpolate_weights(w_pre, w_gan, 0.25)
    for k in mid:
        torch.testing.assert_close(mid[k], 0.75 * w_pre[k] + 0.25 * w_gan[k],
                                   rtol=1e-6, atol=1e-7)
    raw, _ = TE.load_run_weights(str(pre), raw=True)
    assert not all(torch.equal(raw[k], w_pre[k]) for k in raw)

    capsys.readouterr()
    outs = {}
    for name, extra in (("plain", []), ("tiled", ["--tiled"]),
                        ("raw", ["--raw"]),
                        ("interp", ["--interp-run", str(gan), "--alpha",
                                    "0.5"])):
        assert TE.main(["--run", str(pre), "--device", "cpu"] + extra) == 0
        outs[name] = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
    assert outs["interp"]["alpha"] == 0.5
    assert outs["raw"]["weights"] == "raw"
    # tiling is exact: the same numbers as the whole-image forward
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(outs["tiled"][k], outs["plain"][k],
                                   rtol=1e-5)
    assert TE.main(["--run", str(tmp_path / "none"), "--device",
                    "cpu"]) == 1


def test_evaluate_srcnn_tiled_on_the_fixtures(tmp_path, capsys):
    out = tmp_path / "srcnn"
    _tiny(out, model_name="srcnn", steps=2, ckpt_every=2, eval_every=2,
          model_kwargs={"f1": 8, "f2": 4})
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures",
                            "eval_hr")
    res = []
    for extra in ([], ["--tiled"]):
        capsys.readouterr()
        assert TE.main(["--run", str(out), "--device", "cpu", "--data-dir",
                        fixtures] + extra) == 0
        res.append(json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1]))
    assert res[0]["n_images"] == 3 and res[0]["model"] == "srcnn"
    np.testing.assert_allclose(res[1]["psnr"], res[0]["psnr"], rtol=1e-5)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--mesh", "dp=2"], ["--model", "edsr_moe"], []],
    ids=["mesh", "edsr_moe", "cuda_without_a_card"])
def test_cli_refusals_exit_2_and_write_nothing(tmp_path, capsys, flags):
    if not flags and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    out = tmp_path / "run"
    device = ["--device", "cpu"] if flags else []
    with pytest.raises(SystemExit) as exc:
        TL.main(["--steps", "2", "--out", str(out)] + flags + device)
    assert exc.value.code == 2
    assert not out.exists()
    err = capsys.readouterr().err
    assert ("Queue 1 item 9" in err) if flags else ("cuda" in err)


def test_evaluate_without_a_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(SystemExit) as exc:
        TE.main(["--run", str(tmp_path)])
    assert exc.value.code == 2
    with pytest.raises(RuntimeError, match="cuda"):
        TL.train(steps=1, out_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()
    with pytest.raises(ValueError, match="Queue 1 item 9"):
        TL.train(steps=1, out_dir=str(tmp_path / "run"), mesh_spec="dp=2",
                 device="cpu")
