"""The port's ESRGAN two-player step (``train/state.py``
``make_gan_train_step``) against the JAX package's, on the CPU.

The same flax-initialised generator (a small RRDBNet) and discriminator go
into both, through ``convert.load_flax_params``; both take the same
batches, made with numpy from a seed, and the port takes the instance
noise that JAX draws from its keys.  Tolerances (the burst trainer's,
``tests/test_torch_train_burst.py``): metrics within rtol 1e-4 at every
step; after 5 steps the generator's parameters, their EMA and the
discriminator's parameters within 0.01 of the learning rate (Adam divides
each gradient by its own root mean square, so a float32 rounding
difference in a gradient near 0 moves an update by a share of the rate).

One exception: RaGAN sees the logits only through differences between
real and fake ones, so a shift common to every logit has no gradient.
That is all of the discriminator's ``Dense_1`` bias, and its ``Dense_0``
bias on the units whose leaky relu takes the same slope on every sample
(JAX's own gradients there: ~1e-7 of the largest, rounding noise), and it
reaches a few elements further back at rounding level too.  Adam turns
such noise into steps of up to the rate, of either sign, in both
frameworks.  So every D element is held to Adam's bound (within 3 x the
sum of D's rates of JAX's), and all D elements outside those two biases
but at most 1 in 100,000 (measured: 1 of 459,668) within 0.01 of the rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.train import losses as JL
from enph459_super_resolution_tpu.train import state as JS
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.train import losses as TL
from enph459_super_resolution_tpu_torch.train import state as TS

LR_SHARE = 0.01
RTOL = 1e-4
NOISE_SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def jax_noise(step: int, shape):
    """JAX's four instance-noise draws of one step, in the port's order
    (G fake, G real, D fake, D real)."""
    key = jax.random.fold_in(jax.random.PRNGKey(NOISE_SEED), step)
    out = []
    for k in jax.random.split(key):
        out += [np.array(jax.random.normal(kk, shape, jnp.float32))
                for kk in jax.random.split(k)]
    return out


def _players(seed=0):
    g = JZ.RRDBNet(scale=2, nb=1, nf=8, gc=4)
    d = JZ.VGGStyleDiscriminator(nf=16)
    g_params = _numpy_tree(g.init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 12, 12, 3))))
    d_params = _numpy_tree(d.init(jax.random.PRNGKey(seed + 1),
                                  jnp.zeros((1, 24, 24, 3))))
    return g, d, g_params, d_params


def _port_state(g_params, d_params, cfg, balance):
    model = TZ.RRDBNet(scale=2, nb=1, nf=8, gc=4, device="cpu")
    convert.load_flax_params(model, g_params)
    disc = TZ.VGGStyleDiscriminator(nf=16, device="cpu")
    convert.load_flax_params(disc, d_params)
    return TS.GANTrainState(TS.TrainState.create(model, cfg), disc,
                            TS.make_optimizer(cfg, disc.parameters()),
                            balance)


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (2, 12, 12, 3)).astype(np.float32),
             rng.uniform(0, 255, (2, 24, 24, 3)).astype(np.float32))
            for _ in range(n)]


CASES = {
    "adam": {},
    "clip_adamw": dict(grad_clip=0.5, weight_decay=1e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_gan_steps_match_jax(case):
    """d_every 2, d_lr_scale 0.5, instance noise 2, lr_halve_every 2 (G's
    rate halves after its 2nd and 4th update, D's after its 2nd)."""
    knobs = dict(gan_weight=0.5, d_lr_scale=0.5, d_every=2,
                 instance_noise=2.0)
    g, d, g_params, d_params = _players()
    kw = dict(learning_rate=1e-3, lr_halve_every=2, **CASES[case])
    cfg_j, cfg_t = JS.TrainConfig(**kw), TS.TrainConfig(**kw)
    g_tx, d_tx = JS.make_optimizer(cfg_j), JS.make_optimizer(cfg_j)
    jp = jax.tree_util.tree_map(jnp.asarray, g_params)
    jd = jax.tree_util.tree_map(jnp.asarray, d_params)
    state_j = JS.GANTrainState(step=jnp.zeros((), jnp.int32),
                               g=JS.TrainState.create(jp, g_tx),
                               d_params=jd, d_opt_state=d_tx.init(jd),
                               balance=JS.GANBalance.create(**knobs))
    step_j = jax.jit(JS.make_gan_train_step(
        g.apply, d.apply, g_tx, d_tx, cfg_j, percep_loss=JL.PerceptualLoss(),
        noise_seed=NOISE_SEED))
    state_t = _port_state(g_params, d_params, cfg_t, TS.GANBalance(**knobs))
    step_t = TS.make_gan_train_step(cfg_t, percep_loss=TL.PerceptualLoss(),
                                    noise_seed=NOISE_SEED)

    d_rates = 0.0
    for it, (lr, hr) in enumerate(_batches(5)):
        d_before = {k: v.clone() for k, v in state_t.disc.state_dict().items()}
        opt_before = state_t.d_updates
        state_j, m_j = step_j(state_j, jnp.asarray(lr), jnp.asarray(hr))
        noise = [torch.from_numpy(n) for n in jax_noise(it, hr.shape)]
        m_t = step_t(state_t, torch.from_numpy(lr), torch.from_numpy(hr),
                     noise)
        assert sorted(m_t) == sorted(m_j) == [
            "d_loss", "g_gan", "g_loss", "gan_weight", "psnr"]
        for k in m_t:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=RTOL, err_msg=f"{k} step {it}")
        if it % 2:  # D skipped: parameters and optimizer state unchanged
            assert state_t.d_updates == opt_before
            for k, v in state_t.disc.state_dict().items():
                assert torch.equal(v, d_before[k]), k
        else:
            assert state_t.d_updates == opt_before + 1
            d_rates += state_t.d_optimizer.param_groups[0]["lr"]

    assert state_t.step == int(state_j.step) == 5
    assert state_t.g.step == int(state_j.g.step) == 5
    assert state_t.d_updates == 3
    # D's last update ran at its own count 2: rate 1e-3 * 0.5 ** 1 * 0.5
    assert state_t.d_optimizer.param_groups[0]["lr"] == 2.5e-4
    assert state_t.g.optimizer.param_groups[0]["lr"] == 2.5e-4
    tol = LR_SHARE * cfg_t.learning_rate
    for got, want in ((state_t.g.params, state_j.g.params),
                      (state_t.g.ema_params, state_j.g.ema_params)):
        want = convert.flax_state_dict(_numpy_tree(want))
        assert sorted(got) == sorted(want)
        for name, v in got.items():
            assert (v.detach() - want[name]).abs().max() <= tol, name
    want = convert.flax_state_dict(_numpy_tree(state_j.d_params))
    n_off = n_all = 0
    for name, v in state_t.disc.named_parameters():
        diff = (v.detach() - want[name]).abs()
        assert diff.max() <= 3 * d_rates, name
        if name not in ("Dense_0.bias", "Dense_1.bias"):
            n_off += int((diff > tol).sum())
            n_all += diff.numel()
    assert n_off <= n_all * 1e-5, (n_off, n_all)


def test_zero_gan_weight_gives_g_no_adversarial_gradient():
    """``gan_weight=0``: G's update is the same whatever the discriminator
    (here its weights scaled by 3), and it is JAX's."""
    g, d, g_params, d_params = _players(seed=2)
    cfg = TS.TrainConfig(learning_rate=1e-3)
    lr, hr = _batches(1, seed=5)[0]
    bal = TS.GANBalance(gan_weight=0.0, instance_noise=1.0)
    noise = [torch.from_numpy(n) for n in jax_noise(0, hr.shape)]
    params = []
    for d_scale in (1.0, 3.0):
        d_tree = jax.tree_util.tree_map(lambda a: a * d_scale, d_params)
        st = _port_state(g_params, d_tree, cfg, bal)
        m = TS.make_gan_train_step(cfg)(st, torch.from_numpy(lr),
                                        torch.from_numpy(hr), noise)
        assert float(m["gan_weight"]) == 0.0 and float(m["g_gan"]) > 0
        params.append({k: v.detach().clone() for k, v in st.g.params.items()})
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k

    cfg_j = JS.TrainConfig(learning_rate=1e-3)
    tx = JS.make_optimizer(cfg_j)
    jp = jax.tree_util.tree_map(jnp.asarray, g_params)
    jd = jax.tree_util.tree_map(jnp.asarray, d_params)
    state_j = JS.GANTrainState(
        step=jnp.zeros((), jnp.int32), g=JS.TrainState.create(jp, tx),
        d_params=jd, d_opt_state=tx.init(jd),
        balance=JS.GANBalance.create(gan_weight=0.0, instance_noise=1.0))
    state_j, _ = jax.jit(JS.make_gan_train_step(
        g.apply, d.apply, tx, tx, cfg_j, noise_seed=NOISE_SEED))(
        state_j, jnp.asarray(lr), jnp.asarray(hr))
    want = convert.flax_state_dict(_numpy_tree(state_j.g.params))
    for k, v in params[0].items():
        assert np.abs(v.numpy() - want[k].numpy()).max() \
            <= LR_SHARE * cfg.learning_rate, k


def test_gan_state_checkpoint_round_trip(tmp_path):
    _, _, g_params, d_params = _players(seed=4)
    cfg = TS.TrainConfig(learning_rate=1e-3)
    bal = TS.GANBalance(d_every=2, instance_noise=1.5)
    st = _port_state(g_params, d_params, cfg, bal)
    step = TS.make_gan_train_step(cfg, noise_seed=1)
    for lr, hr in _batches(3, seed=6):
        step(st, torch.from_numpy(lr), torch.from_numpy(hr))
    path = TS.save_checkpoint(str(tmp_path), st.state_dict())
    assert path.endswith("3/state.pt")
    back = TS.load_checkpoint(str(tmp_path))
    assert sorted(back) == ["balance", "d_opt_state", "d_params", "g",
                            "step"]
    assert sorted(back["g"]) == ["ema_params", "opt_state", "params", "step"]
    fresh = _port_state(g_params, d_params, cfg, TS.GANBalance())
    fresh.load_state_dict(back)
    assert fresh.step == 3 and fresh.d_updates == 2 and fresh.balance == bal
    again = fresh.state_dict()
    for part in ("d_params",):
        for k, v in st.state_dict()[part].items():
            assert torch.equal(v, again[part][k])
    # the next step from the restored state equals the original's
    lr, hr = _batches(1, seed=8)[0]
    m1 = step(st, torch.from_numpy(lr), torch.from_numpy(hr))
    m2 = step(fresh, torch.from_numpy(lr), torch.from_numpy(hr))
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k
