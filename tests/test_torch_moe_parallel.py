"""Expert parallelism in the port (``parallel/moe.py``, ``models/zoo.py``'s
EDSRMoE): the expert-split soft-gated MoE against the dense evaluation
(forward and gradients), composed with dp, training its gate and experts;
EDSRMoE against flax's through ``convert``; ``train.loop --model edsr_moe
--mesh dp=2,ep=4`` against the dense run.

Mirrors ``tests/test_moe_parallel.py``.  The port's mesh positions are
the host repeated; the JAX side runs on ``tests/conftest.py``'s 8 virtual
CPU devices.  Tolerances: the split layer adds the same products in
another order, held at 1e-4 (JAX: 1e-5); gradients at JAX's rtol 2e-4,
atol 2e-5; EDSRMoE against flax at the models' bound of
``tests/test_torch_models.py`` (rtol 1e-4, atol 1e-3 at ``rgb_range``
255); the ep run against the dense run at JAX's bars (losses rtol 1e-4,
atol 1e-5; final PSNR atol 1e-3).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.models.common import ResBlock as JResBlock
from enph459_super_resolution_tpu.parallel import make_mesh as j_make_mesh
from enph459_super_resolution_tpu.parallel import moe as JMOE
from enph459_super_resolution_tpu.train import loop as JL
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.models.common import (
    Conv, ResBlock, init_flax_default)
from enph459_super_resolution_tpu_torch.parallel import make_mesh
from enph459_super_resolution_tpu_torch.parallel import moe as TMOE
from enph459_super_resolution_tpu_torch.parallel import spmd
from enph459_super_resolution_tpu_torch.train import loop as TL

FEATS = 8
E = 4
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(
        axes.values()))))


_BLOCK = ResBlock(FEATS)


def _expert(params, u):
    return torch.func.functional_call(_BLOCK, params, (u,))


def _setup(seed=0):
    experts = []
    for e in range(E):
        init_flax_default(_BLOCK, torch.Generator().manual_seed(seed * 10 + e))
        experts.append({n: p.detach().clone()
                        for n, p in _BLOCK.named_parameters()})
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(8, 4, 4, FEATS)).astype(np.float32))
    gates = torch.softmax(torch.from_numpy(rng.normal(
        size=(8, 4, 4, E)).astype(np.float32)), dim=-1)
    return TMOE.stack_experts(experts), gates, x


def _dense(stacked, gates, x):
    ys = torch.stack([_expert({k: v[e] for k, v in stacked.items()}, x)
                      for e in range(E)], dim=-1)  # [B, H, W, C, E]
    return torch.sum(ys * gates[..., None, :], dim=-1)


@pytest.mark.parametrize("axes", [{"ep": 1}, {"ep": 2}, {"ep": 4},
                                  {"dp": 2, "ep": 1}, {"dp": 2, "ep": 2},
                                  {"dp": 2, "ep": 4}],
                         ids=lambda a: "_".join(f"{k}{v}" for k, v in
                                                a.items()))
def test_moe_forward_matches_dense(axes):
    stacked, gates, x = _setup()
    mesh = _mesh(axes)
    placed = TMOE.shard_params_ep(stacked, mesh)
    assert all(s.spec == ("ep",) for s in placed.values())
    with torch.no_grad():
        got = TMOE.moe_apply(_expert, stacked, gates, x, mesh=mesh,
                             dp_axis="dp" if "dp" in axes else None)
        want = _dense(stacked, gates, x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_moe_gradients_match_dense():
    stacked, gates, x = _setup(1)
    stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
    gates = gates.requires_grad_(True)
    mesh = _mesh({"ep": 4})
    tgt = torch.from_numpy(np.random.default_rng(9).normal(
        size=x.shape).astype(np.float32))

    def grads(y):
        return torch.autograd.grad(torch.mean((y - tgt) ** 2),
                                   list(stacked.values()) + [gates])

    g_ep = grads(TMOE.moe_apply(_expert, stacked, gates, x, mesh=mesh))
    g_dense = grads(_dense(stacked, gates, x))
    for got, want in zip(g_ep, g_dense):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_moe_trains_gate_and_experts():
    """Head + gated expert layer + tail trains end to end on a dp x ep
    mesh: the gate's weights move (routing is trained) and the loss
    falls."""
    mesh = _mesh({"dp": 2, "ep": 4})
    stacked, _, _ = _setup(2)
    stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
    head, gate, tail = Conv(1, FEATS, 3), Conv(FEATS, E, 1), Conv(FEATS, 1, 3)
    for i, m in enumerate((head, gate, tail)):
        init_flax_default(m, torch.Generator().manual_seed(i))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(8, 4, 4, 1)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(8, 4, 4, 1)).astype(np.float32))
    params = (list(stacked.values()) + list(head.parameters())
              + list(gate.parameters()) + list(tail.parameters()))
    g0 = [p.detach().clone() for p in gate.parameters()]

    def sgd():
        h = head(x)
        g = torch.softmax(gate(h), dim=-1)
        h = TMOE.moe_apply(_expert, stacked, g, h, mesh=mesh, dp_axis="dp")
        loss = torch.mean((tail(h) - y) ** 2)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, d in zip(params, grads):
                p -= 0.05 * d
        return float(loss.detach())

    l0 = sgd()
    l1 = sgd()
    assert np.isfinite(l0) and l1 < l0
    assert max(float((a - b.detach()).abs().max())
               for a, b in zip(g0, gate.parameters())) > 0


def test_moe_apply_checks_match_jax():
    jmesh = j_make_mesh({"ep": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        JMOE.moe_apply(lambda p, u: u, {"p": jnp.zeros((3,))},
                       jnp.zeros((2, 4, 4, 3)), jnp.zeros((2, 4, 4, FEATS)),
                       mesh=jmesh)
    stacked, _, x = _setup()
    with pytest.raises(ValueError) as got:
        TMOE.moe_apply(_expert, stacked, torch.zeros(8, 4, 4, 3), x,
                       mesh=_mesh({"ep": 4}))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="at least one expert"):
        TMOE.stack_experts([])


def test_moe_apply_matches_jax():
    """JAX's ``moe_apply`` of flax ResBlock experts on its dp x ep mesh and
    the port's, the stacked expert parameters carried by ``convert``."""
    jmesh = j_make_mesh({"dp": 2, "ep": 4}, devices=jax.devices()[:8])
    block = JResBlock(features=FEATS)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 4, 4, FEATS)).astype(np.float32)
    gates = np.array(jax.nn.softmax(rng.normal(size=(8, 4, 4, E)).astype(
        np.float32), axis=-1))
    jstacked = JMOE.stack_experts([block.init(jax.random.PRNGKey(e),
                                              jnp.asarray(x[:1]))
                                   for e in range(E)])
    want = JMOE.moe_apply(block.apply, JMOE.shard_params_ep(jstacked, jmesh),
                          jnp.asarray(gates), jnp.asarray(x), mesh=jmesh,
                          dp_axis="dp")
    stacked = convert.flax_state_dict(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jstacked))
    with torch.no_grad():
        got = TMOE.moe_apply(_expert, stacked, torch.from_numpy(gates),
                             torch.from_numpy(x), mesh=_mesh({"dp": 2,
                                                              "ep": 4}),
                             dp_axis="dp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-4)


# --------------------------------------------------------------------------
# the product surface: EDSRMoE and train.loop --model edsr_moe --mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale,channels", [(2, 1), (4, 3)])
def test_edsr_moe_matches_flax_through_convert(scale, channels):
    """flax's tree (``MoEResBlock_i/gate``, ``MoEResBlock_i/experts``
    stacked ``[E, ...]`` by ``nn.vmap``) loads into the port's EDSRMoE and
    the forwards agree; the default is 8 blocks x 64 features x 4
    experts."""
    jm = JZ.EDSRMoE(scale=scale, channels=channels, n_resblocks=2,
                    n_feats=16)
    x = np.random.default_rng(scale).uniform(
        0, 255, (2, 7, 6, channels)).astype(np.float32)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jm.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = TZ.EDSRMoE(scale=scale, channels=channels, n_resblocks=2,
                       n_feats=16, device="cpu")
    convert.load_flax_params(model, params)
    assert model.MoEResBlock_1.experts.Conv_0.weight.shape == (E, 16, 16, 3,
                                                               3)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    default = TZ.create_model("edsr_moe", device="cpu")
    assert (default.n_resblocks, default.n_feats, default.n_experts) == (
        8, 64, 4)


def test_edsr_moe_ep_split_apply_matches_dense():
    """The model's own forward with its expert stacks placed over ep
    (``shard_params_ep_named``: exactly the 8 expert leaves of 2 blocks)
    computes E/ep experts per position and equals the dense forward."""
    m = TZ.create_model("edsr_moe", scale=2, channels=1, n_resblocks=2,
                        n_feats=8, n_experts=4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (2, 8, 8, 1)).astype(np.float32))
    with torch.no_grad():
        want = m(x)
    mesh = _mesh({"dp": 2, "ep": 4})
    placed = TMOE.shard_params_ep_named(m, mesh, "ep")
    assert sum(s.sharded for s in placed.values()) == 8
    assert all(("experts" in k.split(".")) == s.sharded
               for k, s in placed.items())
    calls = []
    real = TMOE.moe_combine

    def spy(fn, gates, x, axis=None):
        calls.append(axis)
        return real(fn, gates, x, axis)

    TMOE.moe_combine = spy
    try:
        with torch.no_grad():
            got = m(spmd.Sharding(mesh, ("dp",)).shard(x)).gather()
    finally:
        TMOE.moe_combine = real
    assert calls == ["ep", "ep"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_shard_params_ep_named_matches_path_components_exactly():
    """A parameter whose name merely contains the key (``experts_gate``) is
    not expert-split; the reference matches path components exactly."""
    mesh = _mesh({"ep": 2})
    holder = torch.nn.Module()
    holder.experts = torch.nn.Linear(2, 4)
    holder.experts_gate = torch.nn.Linear(4, 2)
    placed = TMOE.shard_params_ep_named(holder, mesh, "ep")
    assert placed["experts.weight"].spec == ("ep",)
    assert placed["experts_gate.weight"].spec == ()


def test_edsr_moe_trains_ep_with_loss_parity(tmp_path):
    """``train.loop --model edsr_moe --mesh dp=2,ep=4`` follows the dense
    one-device trajectory, at JAX's bars."""
    common = dict(model_name="edsr_moe", scale=2, steps=4, batch=4,
                  lr_patch=8, channels=1, eval_every=100, ckpt_every=100,
                  pool_images=8, seed=0, resume=False, device="cpu",
                  model_kwargs={"n_resblocks": 2, "n_feats": 8,
                                "n_experts": 4})
    dense = TL.train(out_dir=str(tmp_path / "dense"), dp=False, **common)
    ep = TL.train(out_dir=str(tmp_path / "ep"), mesh_spec="dp=2,ep=4",
                  **common)

    def losses(d):
        with open(tmp_path / d / "metrics.jsonl") as fp:
            return [json.loads(ln)["loss"] for ln in fp]

    np.testing.assert_allclose(losses("ep"), losses("dense"), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ep["psnr"], dense["psnr"], atol=1e-3)


def test_edsr_moe_ep_step_equals_dense_in_float64():
    """One train step in float64, dense against dp=2,ep=4: the split
    blend is the dense one's math to float64 rounding (the float32 step
    carries float32's rounding of the gated gradients, which the card's
    runs part on; PERF.md)."""
    from enph459_super_resolution_tpu_torch.parallel import shard_train_step
    from enph459_super_resolution_tpu_torch.train import state as TS

    rng = np.random.default_rng(8)
    lr = torch.from_numpy(rng.uniform(0, 255, (4, 8, 8, 3)))
    hr = torch.from_numpy(rng.uniform(0, 255, (4, 32, 32, 3)))
    out = []
    for meshed in (False, True):
        model = TZ.EDSRMoE(scale=4, n_resblocks=2, n_feats=8,
                           device="cpu").double()
        cfg = TS.TrainConfig()
        step = TS.make_train_step(cfg)
        if meshed:
            mesh = _mesh({"dp": 2, "ep": 4})
            TMOE.shard_params_ep_named(model, mesh, "ep")
            step = shard_train_step(step, mesh)
        out.append(step(TS.TrainState.create(model, cfg), lr, hr))
    for k in ("loss", "psnr", "grad_norm"):
        np.testing.assert_allclose(float(out[1][k]), float(out[0][k]),
                                   rtol=1e-12, err_msg=k)


def test_edsr_moe_cli_trains_and_evaluates(tmp_path, capsys):
    """``--model edsr_moe --device cpu`` trains, and train.evaluate builds
    EDSRMoE from the run's config.json."""
    from enph459_super_resolution_tpu_torch.train import evaluate as TE

    out = tmp_path / "run"
    assert TL.main(["--model", "edsr_moe", "--scale", "2", "--channels",
                    "1", "--steps", "2", "--batch", "2", "--lr-patch", "8",
                    "--pool-images", "4", "--model-kwargs",
                    '{"n_resblocks": 1, "n_feats": 8, "n_experts": 2}',
                    "--device", "cpu", "--out", str(out)]) == 0
    capsys.readouterr()
    assert TE.main(["--run", str(out), "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["model"] == "edsr_moe" and np.isfinite(res["psnr"])


@pytest.mark.parametrize("case", ["ep_on_edsr", "experts_not_divisible"])
def test_edsr_moe_ep_rejects_bad_configs(tmp_path, case):
    model, kw = (("edsr", {}) if case == "ep_on_edsr"
                 else ("edsr_moe", {"n_experts": 3}))
    with pytest.raises(ValueError) as want:
        JL.train(model_name=model, steps=1, mesh_spec="ep=4",
                 model_kwargs=kw, out_dir=str(tmp_path / "a"))
    with pytest.raises(ValueError) as got:
        TL.train(model_name=model, steps=1, mesh_spec="ep=4",
                 model_kwargs=kw, out_dir=str(tmp_path / "b"), device="cpu")
    assert str(got.value) == str(want.value)
    assert ("edsr_moe" if case == "ep_on_edsr" else "divisible") in str(
        got.value)


def test_edsr_moe_float32_gradient_error_is_jax_own():
    """EDSRMoE x4 at the card's width (8 x 64, 4 experts; batch 2, LR patch
    24, seed 0, flax's init carried across by ``convert``): each package's
    float32 gradient at init against its own float64 gradient, as the
    worst tensor's max|diff| over that tensor's max|float64|.  The port's
    error is at most 2x JAX's: the float32 trajectory that parts on the
    card is the model's conditioning, which the reference shares (both
    near 4.6 % here, the worst tensor an expert conv)."""
    from enph459_super_resolution_tpu.train.losses import l1_loss as j_l1
    from enph459_super_resolution_tpu_torch.train.losses import l1_loss

    kw = dict(scale=4, channels=3, n_resblocks=8, n_feats=64, n_experts=4)
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 255, (2, 24, 24, 3))
    hr = rng.uniform(0, 255, (2, 96, 96, 3))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), JZ.EDSRMoE(
        **kw).init(jax.random.PRNGKey(0), jnp.asarray(lr[:1], jnp.float32)))

    def jax_grad(dtype):
        m = JZ.EDSRMoE(**kw, dtype=dtype)
        g = jax.jit(jax.grad(lambda p: j_l1(
            m.apply(p, jnp.asarray(lr, dtype)), jnp.asarray(hr, dtype))))(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), params))
        return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
                for k, v in jax.tree_util.tree_flatten_with_path(g)[0]}

    def port_grad(dtype):
        m = convert.load_flax_params(TZ.EDSRMoE(**kw, device="cpu"),
                                     params).to(dtype)
        loss = l1_loss(m(torch.as_tensor(lr, dtype=dtype)),
                       torch.as_tensor(hr, dtype=dtype))
        return {n: g.double().numpy() for (n, _), g in zip(
            m.named_parameters(),
            torch.autograd.grad(loss, list(m.parameters())))}

    def worst(g32, g64):
        return max(float(np.abs(g32[n] - g).max() / np.abs(g).max())
                   for n, g in g64.items())

    jax_err = worst(jax_grad(jnp.float32), jax_grad(jnp.float64))
    port_err = worst(port_grad(torch.float32), port_grad(torch.float64))
    print(f"EDSRMoE float32 gradient error at init: port {port_err:.4%}, "
          f"JAX {jax_err:.4%}")
    assert 0 < jax_err and 0 < port_err
    assert port_err <= 2 * jax_err, (port_err, jax_err)
