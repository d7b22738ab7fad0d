"""The port's training meshes (``parallel/mesh.py``'s ``shard_params_tp``
and ``shard_train_step``, ``parallel/spmd.py``, ``train.loop --mesh``)
against the JAX package's on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh positions are the host repeated (``devices=["cpu"] *
n``).  Parameters are flax's, carried across by ``convert``.
Tolerances: one step against JAX's jitted sharded step differs only in
the order of float32 sums, so the metrics are held at rtol 1e-4 and the
parameters at 2 * lr + 1e-6 (Adam's first step moves a parameter by at
most the rate, so that bounds a flipped update too); the port's mesh
trajectories against its single-device runs are held to the JAX tests'
own bars (``tests/test_multidevice_cli.py``: rtol 2e-4).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu import parallel as JP
from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.train import loop as JL
from enph459_super_resolution_tpu.train import state as JS
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch import parallel as TP
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.parallel import spmd
from enph459_super_resolution_tpu_torch.train import evaluate as TE
from enph459_super_resolution_tpu_torch.train import loop as TL
from enph459_super_resolution_tpu_torch.train import state as TS

MESH_RTOL = 2e-4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (JP.make_mesh(axes, devices=jax.devices()[:n]),
            TP.make_mesh(axes, devices=["cpu"] * n))


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def _records(path):
    with open(path) as fp:
        return [json.loads(ln) for ln in fp]


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------

MODELS = {
    "edsr": (lambda: JZ.EDSR(scale=2, n_resblocks=2, n_feats=16),
             lambda: TZ.EDSR(scale=2, n_resblocks=2, n_feats=16,
                             device="cpu"), (1, 8, 8, 3)),
    "edsr_scan": (lambda: JZ.EDSR(scale=2, n_resblocks=2, n_feats=16,
                                  scan_trunk=True),
                  lambda: TZ.EDSR(scale=2, n_resblocks=2, n_feats=16,
                                  scan_trunk=True, device="cpu"),
                  (1, 8, 8, 3)),
    "disc": (lambda: JZ.VGGStyleDiscriminator(nf=8),
             lambda: TZ.VGGStyleDiscriminator(nf=8, device="cpu"),
             (1, 32, 32, 3)),
    "edsr_moe": (lambda: JZ.EDSRMoE(scale=2, channels=1, n_resblocks=2,
                                    n_feats=16),
                 lambda: TZ.EDSRMoE(scale=2, channels=1, n_resblocks=2,
                                    n_feats=16, device="cpu"),
                 (1, 8, 8, 1)),
}


def _port_name(path) -> str:
    keys = [str(getattr(k, "key", k)) for k in path]
    if keys[0] == "params":
        keys = keys[1:]
    leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_shard_params_tp_splits_the_leaves_jax_splits(name, tp):
    """The same leaves go tp-split as under JAX's ``spec_for`` (the
    output-feature dim divides by tp and is at least 8 * tp), on PyTorch's
    layouts (OIHW dim 0, a stacked leaf's dim 1)."""
    make_jax, make_port, shape = MODELS[name]
    jmesh, tmesh = _meshes({"tp": tp})
    params = make_jax().init(jax.random.PRNGKey(0), jnp.zeros(shape))
    placed = JP.shard_params_tp(params, jmesh, "tp")
    want = {_port_name(path) for path, leaf in
            jax.tree_util.tree_leaves_with_path(placed)
            if "tp" in tuple(leaf.sharding.spec)}
    model = make_port()
    got = TP.shard_params_tp(model, tmesh, "tp")
    assert set(got) == set(dict(model.named_parameters()))
    assert {k for k, s in got.items() if s.sharded} == want
    assert want  # something is split at these widths
    for k, p in model.named_parameters():
        assert spmd.placement_of(p) == got[k]
        if got[k].sharded:
            d = got[k].spec.index("tp")
            assert p.shape[d] % tp == 0 and p.shape[d] >= 8 * tp


def test_batch_sharding_and_replicated_are_placements():
    _, mesh = _meshes({"dp": 2, "tp": 2})
    assert TP.batch_sharding(mesh).spec == ("dp",)
    assert TP.batch_sharding(mesh, "tp").spec == ("tp",)
    assert TP.replicated(mesh).spec == () and not TP.replicated(mesh).sharded
    x = torch.arange(8.0).reshape(4, 2)
    m = TP.batch_sharding(mesh).shard(x)
    assert m.local_shape() == (2, 2) and torch.equal(m.gather(), x)
    with pytest.raises(ValueError, match="not divisible"):
        TP.batch_sharding(mesh).shard(torch.zeros(3, 2))


# --------------------------------------------------------------------------
# one sharded step against JAX's
# --------------------------------------------------------------------------

STEP_MODELS = {
    "espcn": (lambda: JZ.ESPCN(scale=2, channels=3),
              lambda: TZ.ESPCN(scale=2, channels=3, device="cpu")),
    "edsr": (lambda: JZ.EDSR(scale=2, n_resblocks=2, n_feats=16),
             lambda: TZ.EDSR(scale=2, n_resblocks=2, n_feats=16,
                             device="cpu")),
}


# (mesh, model, JAX's step held against): JAX's jitted shard_train_step,
# except for EDSR under dp=2,sp=2,tp=2, where the reference's own sharded
# step departs from its unsharded step on the CPU (grad_norm 129.56
# against 95.00 on these inputs; at sp=2,tp=2 alone the loss too, 171.5
# against 101.5): a fault of the reference's partitioned step (ROADMAP
# Queue 3), so the port is held to the unsharded step there, which every
# other mesh of the reference and of the port reproduces
STEP_CASES = [("dp2_tp2", "espcn", "sharded"), ("dp2_sp2_tp2", "espcn",
                                               "sharded"),
              ("dp2_tp2", "edsr", "sharded"), ("dp2_sp2_tp2", "edsr",
                                               "unsharded")]
AXES = {"dp2_tp2": {"dp": 2, "tp": 2}, "dp2_sp2_tp2": {"dp": 2, "sp": 2,
                                                       "tp": 2}}


@pytest.mark.parametrize("mesh_name,model,against", STEP_CASES)
def test_sharded_step_matches_jax(mesh_name, model, against):
    axes = AXES[mesh_name]
    make_jax, make_port = STEP_MODELS[model]
    jmesh, tmesh = _meshes(axes)
    rng = np.random.default_rng(3)
    lr = rng.uniform(0, 255, (4, 8, 8, 3)).astype(np.float32)
    hr = rng.uniform(0, 255, (4, 16, 16, 3)).astype(np.float32)
    jm = make_jax()
    params = _numpy_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(lr[:1])))
    sp = "sp" if "sp" in axes else None

    cfg = JS.TrainConfig(learning_rate=LR)
    tx = JS.make_optimizer(cfg)
    jstep = JS.make_train_step(jm.apply, tx, cfg)
    if against == "sharded":
        jstate = JS.TrainState.create(
            JP.shard_params_tp(params, jmesh, "tp"), tx)
        jstep = JP.shard_train_step(jstep, jmesh, sp_axis=sp)
    else:
        jstate = JS.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
        jstep = jax.jit(jstep)
    jstate, jmet = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))

    tm = convert.load_flax_params(make_port(), params)
    TP.shard_params_tp(tm, tmesh, "tp")
    tstate = TS.TrainState.create(tm, TS.TrainConfig(learning_rate=LR))
    tstep = TP.shard_train_step(TS.make_train_step(TS.TrainConfig(
        learning_rate=LR)), tmesh, sp_axis=sp)
    tmet = tstep(tstate, torch.from_numpy(lr), torch.from_numpy(hr))

    for k in ("loss", "psnr", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    want = convert.flax_state_dict(_numpy_tree(jstate.params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   atol=2 * LR + 1e-6, rtol=0, err_msg=k)


def test_tp_alone_is_the_unsharded_forward_bit_for_bit():
    """Each tp slice's output channels are the same sums: on the CPU the
    tp=2 step's loss, PSNR and gradient norm equal the one-device step's
    exactly.  The backward adds the two slices' input gradients, which one
    device sums in one go, so the parameters after the step agree to
    float32 rounding of the update (1e-7 here; an update is 1e-4)."""
    _, mesh = _meshes({"tp": 2})
    rng = np.random.default_rng(4)
    lr = torch.from_numpy(rng.uniform(0, 255, (2, 8, 8, 3)).astype(
        np.float32))
    hr = torch.from_numpy(rng.uniform(0, 255, (2, 16, 16, 3)).astype(
        np.float32))
    cfg = TS.TrainConfig(learning_rate=LR)
    out = []
    for meshed in (False, True):
        model = TZ.EDSR(scale=2, n_resblocks=2, n_feats=16, device="cpu")
        step = TS.make_train_step(cfg)
        if meshed:
            TP.shard_params_tp(model, mesh, "tp")
            step = TP.shard_train_step(step, mesh)
        state = TS.TrainState.create(model, cfg)
        out.append((step(state, lr, hr), state.state_dict()))
    (m0, s0), (m1, s1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for k in s0["params"]:
        torch.testing.assert_close(s1["params"][k], s0["params"][k],
                                   rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# train.loop --mesh: trajectories against one device (JAX's three
# test_train_mesh_flag_* cases, to their bars)
# --------------------------------------------------------------------------

def _losses(out, spec, key="loss", **kw):
    TL.train(out_dir=str(out), pool_images=4, dp=False, mesh_spec=spec,
             resume=False, device="cpu", **kw)
    return [r[key] for r in _records(out / "metrics.jsonl")]


def test_train_mesh_flag_dp_sp_tp(tmp_path):
    kw = dict(model_name="espcn", scale=2, channels=3, steps=4, batch=4,
              lr_patch=16, eval_every=4, ckpt_every=4)
    meshed = _losses(tmp_path / "mesh_run", "dp=2,sp=2,tp=2", **kw)
    final = _records(tmp_path / "mesh_run" / "metrics.jsonl")
    assert meshed and all(np.isfinite(meshed))
    assert all(np.isfinite(r["psnr"]) for r in final)
    single = _losses(tmp_path / "single", None, **kw)
    np.testing.assert_allclose(meshed, single, rtol=MESH_RTOL)
    cfg = json.load(open(tmp_path / "mesh_run" / "config.json"))
    assert cfg["mesh"] == "dp=2,sp=2,tp=2"


def test_train_mesh_flag_matches_single_device(tmp_path):
    kw = dict(model_name="espcn", scale=2, channels=1, steps=4, batch=8,
              lr_patch=12, eval_every=4, ckpt_every=4)
    single = _losses(tmp_path / "r1", None, **kw)
    meshed = _losses(tmp_path / "r2", "dp=2,tp=2", **kw)
    np.testing.assert_allclose(meshed, single, rtol=MESH_RTOL)


def test_train_mesh_flag_pp_matches_single_device(tmp_path):
    kw = dict(model_name="edsr", scale=2, channels=3, steps=4, batch=8,
              lr_patch=12, eval_every=4, ckpt_every=4,
              model_kwargs={"n_resblocks": 4, "n_feats": 8,
                            "scan_trunk": True})
    single = _losses(tmp_path / "r1", None, **kw)
    piped = _losses(tmp_path / "r2", "dp=2,pp=4", **kw)
    np.testing.assert_allclose(piped, single, rtol=MESH_RTOL)


def test_pp_mesh_injects_the_scan_trunk_and_records_it(tmp_path):
    """A pp mesh switches EDSR to the stacked layout, as the JAX package
    does, and config.json records it; train.evaluate builds that layout
    from the record and reads the meshed checkpoint on one device."""
    out = tmp_path / "pp"
    TL.train(model_name="edsr", scale=2, channels=3, steps=2, batch=4,
             lr_patch=8, eval_every=2, ckpt_every=2, out_dir=str(out),
             pool_images=4, mesh_spec="pp=2", device="cpu",
             model_kwargs={"n_resblocks": 2, "n_feats": 8})
    cfg = json.load(open(out / "config.json"))
    assert cfg["model_kwargs"]["scan_trunk"] is True
    ckpt = TS.load_checkpoint(str(out / "ckpt"))
    assert ckpt["params"]["trunk.ResBlock_0.Conv_0.weight"].shape == (
        2, 8, 8, 3, 3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TE.main(["--run", str(out), "--device", "cpu"]) == 0
    assert np.isfinite(json.loads(buf.getvalue().splitlines()[-1])["psnr"])


def test_gan_step_under_dp_tp_matches_one_device(tmp_path):
    """Two ``--gan`` steps (the discriminator tp-placed as the generator,
    instance noise drawn whole and split as the batch) follow the
    one-device run."""
    kw = dict(model_name="espcn", scale=2, channels=3, steps=2, batch=4,
              lr_patch=16, eval_every=2, ckpt_every=2, gan=True,
              instance_noise=2.0)
    single = _records_of(tmp_path / "single", None, kw)
    meshed = _records_of(tmp_path / "mesh", "dp=2,tp=2", kw)
    for key in ("g_loss", "d_loss", "g_gan", "psnr"):
        np.testing.assert_allclose([r[key] for r in meshed],
                                   [r[key] for r in single], rtol=MESH_RTOL,
                                   err_msg=key)
    ck = TS.load_checkpoint(str(tmp_path / "mesh" / "ckpt"))
    assert int(ck["d_opt_state"]["state"][0]["step"]) == 2


def _records_of(out, spec, kw):
    TL.train(out_dir=str(out), pool_images=4, dp=False, mesh_spec=spec,
             resume=False, device="cpu", **kw)
    return _records(out / "metrics.jsonl")


# --------------------------------------------------------------------------
# the dispatch: dp=True, resume, refusals
# --------------------------------------------------------------------------

def test_dp_true_with_several_devices_trains_dp(tmp_path, monkeypatch):
    """``dp=True`` over more than one device trains data-parallel over all
    of them (the JAX package's default); the trajectory is one device's."""
    seen = []
    real = TP.shard_train_step

    def spy(step_fn, mesh, *a, **k):
        seen.append(mesh.shape)
        return real(step_fn, mesh, *a, **k)

    monkeypatch.setattr(TP, "shard_train_step", spy)
    kw = dict(model_name="espcn", scale=2, channels=1, steps=2, batch=4,
              lr_patch=12, eval_every=2, ckpt_every=2)
    TL.train(out_dir=str(tmp_path / "dp"), dp=True, devices=["cpu"] * 2,
             device="cpu", pool_images=4, **kw)
    assert seen == [{"dp": 2}]
    TL.train(out_dir=str(tmp_path / "one"), dp=True, device="cpu",
             pool_images=4, **kw)
    assert seen == [{"dp": 2}]  # one device: no mesh
    a = [r["loss"] for r in _records(tmp_path / "dp" / "metrics.jsonl")]
    b = [r["loss"] for r in _records(tmp_path / "one" / "metrics.jsonl")]
    np.testing.assert_allclose(a, b, rtol=MESH_RTOL)


def test_a_meshed_checkpoint_resumes_on_one_device_and_on_the_mesh(
        tmp_path):
    """2 steps then a resume to 4: meshed then one device (a), one device
    then meshed, the tensors placed again (b), one device throughout (c):
    the checkpoints hold whole tensors under the unsharded names, and the
    three trajectories agree."""
    kw = dict(model_name="espcn", scale=2, channels=1, batch=4, lr_patch=12,
              eval_every=2, ckpt_every=2, pool_images=4, device="cpu",
              dp=False)
    mesh = {"mesh_spec": "dp=2,tp=2"}
    for run, first, second in (("a", mesh, {}), ("b", {}, mesh),
                               ("c", {}, {})):
        TL.train(steps=2, out_dir=str(tmp_path / run), **kw, **first)
        if run == "a":
            ck = TS.load_checkpoint(str(tmp_path / "a" / "ckpt"))
            model = TZ.ESPCN(scale=2, channels=1, device="cpu")
            assert {k: v.shape for k, v in ck["params"].items()} == {
                k: v.shape for k, v in model.state_dict().items()}
        TL.train(steps=4, out_dir=str(tmp_path / run), **kw, **second)
    recs = {k: _records(tmp_path / k / "metrics.jsonl") for k in "abc"}
    assert [r["step"] for r in recs["a"]] == [1, 2, 3, 4]
    for k in "ab":
        np.testing.assert_allclose([r["loss"] for r in recs[k]],
                                   [r["loss"] for r in recs["c"]],
                                   rtol=MESH_RTOL)


REFUSALS = {
    "pp_needs_edsr": ("espcn", "dp=2,pp=4", {}, {}),
    "pp_with_gan": ("edsr", "dp=2,pp=4", {"gan": True}, {}),
    "pp_with_tp": ("edsr", "pp=2,tp=2", {}, {}),
    "ep_needs_edsr_moe": ("edsr", "ep=4", {}, {}),
    "ep_with_tp": ("edsr_moe", "ep=2,tp=2", {}, {}),
    "ep_experts_divisible": ("edsr_moe", "ep=4", {}, {"n_experts": 3}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_mesh_refusals_match_jax(case, tmp_path, capsys):
    model, spec, extra, mkw = REFUSALS[case]
    with pytest.raises(ValueError) as want:
        JL.train(model_name=model, steps=1, mesh_spec=spec,
                 model_kwargs=mkw, out_dir=str(tmp_path / "jax"), **extra)
    with pytest.raises(ValueError) as got:
        TL.train(model_name=model, steps=1, mesh_spec=spec,
                 model_kwargs=mkw, out_dir=str(tmp_path / "port"),
                 device="cpu", **extra)
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "port").exists()
    argv = ["--model", model, "--mesh", spec, "--steps", "1", "--out",
            str(tmp_path / "cli"), "--device", "cpu"]
    argv += ["--gan"] if extra.get("gan") else []
    argv += ["--model-kwargs", json.dumps(mkw)] if mkw else []
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        TL.main(argv)
    assert exc.value.code == 2
    assert str(want.value) in capsys.readouterr().err
    assert not (tmp_path / "cli").exists()


def test_mesh_needs_its_devices(tmp_path):
    """An explicit device list shorter than the mesh raises the JAX
    package's count error; nothing is written."""
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        TL.train(steps=1, mesh_spec="dp=2,tp=2", device="cpu",
                 devices=["cpu"] * 2, out_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()


def test_cli_mesh_on_the_cpu_trains(tmp_path, capsys):
    out = tmp_path / "run"
    assert TL.main(["--model", "espcn", "--scale", "2", "--channels", "1",
                    "--steps", "2", "--batch", "4", "--lr-patch", "12",
                    "--pool-images", "4", "--mesh", "dp=2,tp=2",
                    "--device", "cpu", "--out", str(out)]) == 0
    assert [r["step"] for r in _records(out / "metrics.jsonl")] == [1, 2]
    assert json.load(open(out / "config.json"))["mesh"] == "dp=2,tp=2"


# --------------------------------------------------------------------------
# MeshTensor rules the models lean on
# --------------------------------------------------------------------------

def test_mesh_tensor_reductions_reshapes_and_fallback():
    _, mesh = _meshes({"dp": 2, "sp": 2, "tp": 2})
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 8, 6, 5)).astype(np.float32))
    m = spmd.Sharding(mesh, ("dp", "sp")).shard(x)
    assert m.shape == x.shape and m.local_shape() == (2, 4, 6, 5)
    torch.testing.assert_close(torch.mean(m), x.mean())
    torch.testing.assert_close(m.mean(dim=(1, 2)).gather(), x.mean((1, 2)))
    torch.testing.assert_close(m.sum(dim=1, keepdim=True).gather(),
                               x.sum(1, keepdim=True))
    r = m.reshape(4, 8, 6, 5, 1).permute(0, 1, 4, 2, 3)
    assert r.spec[:2] == ("dp", "sp")
    torch.testing.assert_close(r.gather(), x.reshape(4, 8, 6, 5, 1).permute(
        0, 1, 4, 2, 3))
    torch.testing.assert_close(m[:, ::2].gather(), x[:, ::2])  # gathers
    torch.testing.assert_close(m[..., 1:3].gather(), x[..., 1:3])
    torch.testing.assert_close(torch.einsum("bhwc->bc", m), x.sum((1, 2)))
    torch.testing.assert_close((1.0 - 2 * m).gather(), 1.0 - 2 * x)
    torch.testing.assert_close((m + x).gather(), 2 * x)  # plain, whole
    torch.testing.assert_close((m[:, ::1] + m).gather(), 2 * x)  # layouts
    torch.testing.assert_close(m.repeat_interleave(2, dim=1).gather(),
                               x.repeat_interleave(2, dim=1))
    with pytest.raises(ValueError, match="dtype"):
        m.to("cpu")


def test_mesh_tensor_backward_reaches_every_tile_and_weight():
    """Halo rows and tp slices carry gradients back to their owners: the
    gradients of a sharded conv stack equal the unsharded ones, the input's
    and every weight's."""
    _, mesh = _meshes({"dp": 2, "sp": 2, "tp": 2})
    model = TZ.SRCNN(channels=3, f1=16, f2=16, device="cpu")
    TP.shard_params_tp(model, mesh, "tp")
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 255, (2, 12, 10, 3)).astype(np.float32)).requires_grad_(True)
    grads = []
    for sharded in (False, True):
        xin = spmd.Sharding(mesh, ("dp", "sp")).shard(x) if sharded else x
        loss = torch.mean(model(xin) ** 2)
        grads.append(torch.autograd.grad(loss, [x] + list(
            model.parameters())))
    for a, b in zip(*grads):
        # float32 sums in another order: within 1e-5 of each gradient's
        # largest element (6e-7 measured)
        assert float((b - a).abs().max()) <= 1e-5 * float(a.abs().max())


# --------------------------------------------------------------------------
# the dryrun twin
# --------------------------------------------------------------------------

def test_dryrun_multichip_on_8_cpu_positions():
    from enph459_super_resolution_tpu_torch.parallel.dryrun import (
        dryrun_multichip, main)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(8, devices=["cpu"] * 8)
    lines = buf.getvalue().splitlines()
    assert lines[0] == "mesh: dp=2 sp=2 tp=2"
    assert [ln.split(" ok:")[0] for ln in lines[1:]] == [
        "train step", "pipeline step", "moe step", "sharded IBP",
        "sharded adjoint", "2-D sharded IBP", "2-D sharded adjoint",
        "edsr_moe train step"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            main(["8"])
        assert exc.value.code == 2
    with pytest.raises(ValueError, match="have 4"):
        dryrun_multichip(8, devices=["cpu"] * 4)
