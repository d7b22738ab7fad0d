"""The port's patch samplers and eval harness (``train/data.py``) against
the JAX package's, on the CPU.

Each random draw of the JAX package is fed to the port's pure function of
its draws.  Tolerances: crops are a gather, so equal; the flips and
rotations are a gather too, so the augmented HR patches are equal; the LR
patches come from the port's ``bicubic_degrade`` (the same two f32 matrix
products as JAX's, summed in another order): 1e-3 absolute on 0..255.
``evaluate_sr`` of the same model (flax weights carried over by
``convert.load_flax_params``) on the same pool: every key within rtol
1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.train import data as JD
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.train import data as TD

LR_ATOL = 1e-3
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval_hr")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ragged_pool(channels=3):
    rng = np.random.default_rng(11)
    return [rng.uniform(0, 255, (h, w, channels)).astype(np.float32)
            for h, w in ((40, 52), (57, 44), (48, 48))]


@pytest.mark.parametrize("channels", [1, 3])
def test_patch_sampler_crops_are_jax_crops(channels):
    """``augment=False``: the HR batch is the crops themselves, so JAX's and
    the port's are compared bit for bit over three batches of a ragged
    pool."""
    pool = _ragged_pool(channels)
    cfg_j = JD.PatchConfig(scale=2, lr_patch=10, batch=5, augment=False)
    cfg_t = TD.PatchConfig(scale=2, lr_patch=10, batch=5, augment=False)
    js = JD.PatchSampler(pool, cfg_j, seed=4)
    ts = TD.PatchSampler(pool, cfg_t, seed=4, device="cpu")
    for _ in range(3):
        lr_j, hr_j = next(js)
        lr_t, hr_t = next(ts)
        np.testing.assert_array_equal(hr_t.numpy(), np.asarray(hr_j))
        np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), rtol=0,
                                   atol=LR_ATOL)
    assert hr_t.shape == (5, 20, 20, channels)
    assert lr_t.shape == (5, 10, 10, channels)


def test_patch_sampler_start_skips_batches():
    pool = _ragged_pool()
    cfg = TD.PatchConfig(scale=2, lr_patch=10, batch=3)
    full = TD.PatchSampler(pool, cfg, seed=2, device="cpu")
    batches = [next(full) for _ in range(3)]
    resumed = TD.PatchSampler(pool, cfg, seed=2, device="cpu", start=2)
    lr, hr = next(resumed)
    assert torch.equal(hr, batches[2][1]) and torch.equal(lr, batches[2][0])
    assert not torch.equal(batches[0][1], batches[1][1])


def test_augment_degrade_matches_jax_degrade_batch():
    """JAX's flip and rotation draws, fed to ``augment_degrade``."""
    hr = np.random.default_rng(3).uniform(0, 255, (16, 24, 24, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    lr_j, hr_j = JD._degrade_batch(jnp.asarray(hr), key, 4, True)
    kf, kr = jax.random.split(key)
    flips = np.array(jax.random.bernoulli(kf, shape=(16, 2)))
    rots = np.array(jax.random.bernoulli(kr, shape=(16,)))
    assert flips.any(axis=0).all() and rots.any() and not rots.all()
    lr_t, hr_t = TD.augment_degrade(torch.from_numpy(hr),
                                    torch.from_numpy(flips),
                                    torch.from_numpy(rots), 4)
    np.testing.assert_array_equal(hr_t.numpy(), np.asarray(hr_j))
    np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), rtol=0,
                               atol=LR_ATOL)
    assert lr_t.shape == (16, 6, 6, 3)


def test_device_sampler_crop_matches_jax_device_sample_batch():
    """The indices, offsets, flips and rotations ``_device_sample_batch``
    draws from its key, fed to ``sample_batch``."""
    pool = np.random.default_rng(5).uniform(0, 255, (4, 40, 44, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    lr_j, hr_j = JD._device_sample_batch(jnp.asarray(pool), key, 24, 8, 2,
                                         True)
    kimg, kyx, kdeg = jax.random.split(key, 3)
    idx = np.array(jax.random.randint(kimg, (8,), 0, 4))
    ky, kx = jax.random.split(kyx)
    ys = np.array(jax.random.randint(ky, (8,), 0, 40 - 24 + 1))
    xs = np.array(jax.random.randint(kx, (8,), 0, 44 - 24 + 1))
    kf, kr = jax.random.split(kdeg)
    flips = np.array(jax.random.bernoulli(kf, shape=(8, 2)))
    rots = np.array(jax.random.bernoulli(kr, shape=(8,)))
    lr_t, hr_t = TD.sample_batch(
        torch.from_numpy(pool), *(torch.as_tensor(a, dtype=torch.int64)
                                  for a in (idx, ys, xs)),
        torch.from_numpy(flips), torch.from_numpy(rots), 24, 2)
    np.testing.assert_array_equal(hr_t.numpy(), np.asarray(hr_j))
    np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), rtol=0,
                               atol=LR_ATOL)


def test_make_patch_sampler_routes_and_device_sampler_protocol():
    pool = TD.synthetic_scene_pool(n_images=3, size=64, channels=3)
    cfg = TD.PatchConfig(scale=4, lr_patch=12, batch=4)
    sampler = TD.make_patch_sampler(pool, cfg, device="cpu")
    assert isinstance(sampler, TD.DevicePatchSampler)
    lr, hr = next(sampler)
    assert hr.shape == (4, 48, 48, 3) and lr.shape == (4, 12, 12, 3)
    assert float(hr.max()) <= 255.0 + 1e-3
    lr2, hr2 = next(sampler)
    assert not torch.equal(hr, hr2)
    # every crop is a pool crop, consistently degraded
    from enph459_super_resolution_tpu_torch.ops.resize import bicubic_degrade
    torch.testing.assert_close(bicubic_degrade(hr2, 4), lr2, rtol=0,
                               atol=LR_ATOL)
    # batch i is the same whether a run starts at 0 or resumes at i
    again = TD.make_patch_sampler(pool, cfg, device="cpu", start=1)
    assert torch.equal(next(again)[1], hr2)
    ragged = [pool[0], pool[1][:56]]
    assert isinstance(TD.make_patch_sampler(ragged, cfg, device="cpu"),
                      TD.PatchSampler)
    with pytest.raises(ValueError, match="smaller than HR patch"):
        TD.PatchSampler([pool[0][:40]], cfg, device="cpu")


def _espcn_pair(channels, seed=0):
    jm = JZ.ESPCN(scale=2, channels=channels)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, channels))))
    tm = TZ.ESPCN(scale=2, channels=channels, device="cpu")
    convert.load_flax_params(tm, params)
    return jm, params, tm.eval()


@pytest.mark.parametrize("source", ["synthetic", "fixtures"])
@pytest.mark.parametrize("channels", [1, 3])
def test_evaluate_sr_matches_jax(source, channels):
    pool = (TD.image_pool_from_dir(FIXTURES, channels=channels)
            if source == "fixtures" else
            TD.synthetic_scene_pool(n_images=3, size=64, channels=channels,
                                    seed=2))
    jm, params, tm = _espcn_pair(channels)
    want = JD.evaluate_sr(jm.apply, jax.tree_util.tree_map(jnp.asarray,
                                                           params),
                          pool, 2)
    got = TD.evaluate_sr(tm, pool, 2, device="cpu")
    assert sorted(got) == sorted(want) == sorted(TD.EVAL_KEYS + ("n_images",))
    assert got["n_images"] == want["n_images"] == len(pool)
    for k in TD.EVAL_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_evaluate_sr_shave_and_rgb_metrics_follow_jax():
    """``on_y=False`` scores the first channel; ``shave`` overrides the
    scale's border."""
    pool = TD.synthetic_scene_pool(n_images=2, size=48, channels=3, seed=7)
    jm, params, tm = _espcn_pair(3, seed=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for kw in (dict(on_y=False), dict(shave=5)):
        want = JD.evaluate_sr(jm.apply, jp, pool, 2, **kw)
        got = TD.evaluate_sr(tm, pool, 2, device="cpu", **kw)
        for k in TD.EVAL_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"{k} {kw}")
