"""The port's residual trunk (``ops/trunk.py``, plain version on the CPU)
and fused serving paths (``models/fused.py``) against the JAX package's
flax modules: the ``ResBlock`` chain (as tests/test_pallas_trunk.py's
``_flax_ref`` chains it), ``EDSR.apply`` and ``BurstFusionLR.apply``.

The JAX side runs the flax modules, never ``pallas_trunk``: that kernel's
half-split layout reads zero padding across its seam at packed row npix/2,
so it is no reference (its own tests fail there).  The 12x12 case below is
tall enough to cross that seam.

Tolerances, from the JAX package's tests: f32 ``rtol=atol=2e-5`` for the
trunk (test_pallas_trunk.py:51-52) and ``rtol=1e-4, atol=1e-3`` on the
0..255 output of the serving paths (:98); bf16 against the f32 flax chain
``max|diff| < 0.05 max|want|`` (:78-79).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.models.common import ResBlock
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import fused
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.ops import trunk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_convs(rng, n_convs):
    return [(rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.05,
             rng.standard_normal((64,)).astype(np.float32) * 0.1)
            for _ in range(n_convs)]


def _flax_chain(x, convs, res_scale, relu_only=False):
    """The real flax modules with the given weights: ResBlocks, or
    conv + relu layers."""
    x = jnp.asarray(x)
    if relu_only:
        layer = nn.Conv(64, (3, 3))
        for k, b in convs:
            x = nn.relu(layer.apply({"params": {"kernel": jnp.asarray(k),
                                                "bias": jnp.asarray(b)}}, x))
        return np.asarray(x)
    block = ResBlock(64, res_scale)
    for i in range(0, len(convs), 2):
        x = block.apply({"params": {
            "Conv_0": {"kernel": jnp.asarray(convs[i][0]),
                       "bias": jnp.asarray(convs[i][1])},
            "Conv_1": {"kernel": jnp.asarray(convs[i + 1][0]),
                       "bias": jnp.asarray(convs[i + 1][1])}}}, x)
    return np.asarray(x)


# (name, x shape, convs, res_scale, relu_only)
CASES = [
    ("seam_2x12x12_2blocks", (2, 12, 12, 64), 4, 1.0, False),
    ("9x11_3blocks_res0.1", (1, 9, 11, 64), 6, 0.1, False),
    ("1px_high", (2, 1, 13, 64), 4, 1.0, False),
    ("1px_wide_1px_high", (1, 1, 1, 64), 2, 1.0, False),
    ("relu_only", (1, 7, 10, 64), 3, 1.0, True),
]


def _case(name, shape, n_convs, seed):
    rng = np.random.default_rng(seed)
    convs = _rand_convs(rng, n_convs)
    x = rng.standard_normal(shape).astype(np.float32)
    return convs, x


@pytest.mark.parametrize("name,shape,n_convs,res_scale,relu_only", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_trunk_f32_matches_flax_chain(name, shape, n_convs, res_scale,
                                            relu_only):
    convs, x = _case(name, shape, n_convs, 0)
    want = _flax_chain(x, convs, res_scale, relu_only)
    got = trunk.fused_resblocks(torch.from_numpy(x), convs,
                                res_scale=res_scale, relu_only=relu_only,
                                dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name,shape,n_convs,res_scale,relu_only", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_trunk_bf16_tracks_f32_flax_chain(name, shape, n_convs,
                                                res_scale, relu_only):
    convs, x = _case(name, shape, n_convs, 1)
    want = _flax_chain(x, convs, res_scale, relu_only)
    got = trunk.fused_resblocks(torch.from_numpy(x), convs,
                                res_scale=res_scale, relu_only=relu_only)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert np.abs(got.float().numpy() - want).max() \
        < 0.05 * np.abs(want).max()


def test_pack_trunk_layout():
    convs = _rand_convs(np.random.default_rng(2), 3)
    pack = trunk.pack_trunk(convs)
    assert pack.w.shape == (3, 9, 64, 64) and pack.dtype == torch.bfloat16
    assert pack.b.shape == (3, 64) and pack.b.dtype == torch.float32
    # tap 3*dy + dx, (in, out): the HWIO kernel's [dy, dx]
    k, b = convs[2]
    np.testing.assert_array_equal(
        pack.w[2, 5].float().numpy(),
        torch.from_numpy(k[1, 2]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(pack.b[2].numpy(), b)
    assert trunk.pack_trunk(convs, torch.float32).w.dtype == torch.float32
    with pytest.raises(TypeError):
        trunk.pack_trunk(convs, torch.float16)
    with pytest.raises(ValueError, match="64"):
        trunk.pack_trunk([(np.zeros((3, 3, 32, 32)), np.zeros(32))])


def test_packed_chain_equals_convs_and_counts_no_launch_on_cpu():
    convs, x = _case("", (1, 5, 6, 64), 4, 3)
    before = (trunk.trunk_conv.launches, trunk.trunk_conv.launches_bf16)
    pack = trunk.pack_trunk(convs)
    a = trunk.fused_resblocks_packed(torch.from_numpy(x), pack,
                                     res_scale=0.5)
    b = trunk.fused_resblocks(torch.from_numpy(x), convs, res_scale=0.5)
    assert torch.equal(a, b)
    # by hand: two convs per block, the block input kept for the skip
    h = torch.from_numpy(x).to(torch.bfloat16)
    for i in (0, 2):
        t = trunk.trunk_conv_reference(h, pack, i)
        h = trunk.trunk_conv_reference(t, pack, i + 1, skip=h, res_scale=0.5)
    assert torch.equal(a, h)
    assert (trunk.trunk_conv.launches,
            trunk.trunk_conv.launches_bf16) == before


def test_trunk_refuses_what_it_does_not_take():
    convs, x = _case("", (1, 4, 4, 64), 3, 4)
    pack = trunk.pack_trunk(convs)
    with pytest.raises(ValueError, match="2 convs per block"):
        trunk.fused_resblocks_packed(torch.from_numpy(x), pack)
    with pytest.raises(ValueError, match="64"):
        trunk.trunk_conv(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16),
                         pack, 0)
    with pytest.raises(TypeError):
        trunk.trunk_conv(torch.from_numpy(x), pack, 0)  # f32 x, bf16 pack
    with pytest.raises(IndexError):
        trunk.trunk_conv(torch.from_numpy(x).bfloat16(), pack, 3)
    with pytest.raises(ValueError, match="skip"):
        trunk.trunk_conv(torch.from_numpy(x).bfloat16(), pack, 1,
                         skip=torch.zeros(1, 4, 5, 64, dtype=torch.bfloat16))


def _flax_params(jax_model, x, seed, edit=None):
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    if edit is not None:
        edit(params["params"])
    return params


def _edsr(scale, channels, seed):
    kw = dict(scale=scale, channels=channels, n_resblocks=2, n_feats=64)
    x = np.random.default_rng(seed).uniform(
        0, 255, (1, 10, 12, channels)).astype(np.float32)
    params = _flax_params(JZ.EDSR(**kw), x, seed)
    want = np.asarray(JZ.EDSR(**kw).apply(params, jnp.asarray(x)))
    model = convert.load_flax_params(TZ.EDSR(device="cpu", **kw), params)
    return model, x, want


@pytest.mark.parametrize("scale,channels", [(4, 3), (2, 1), (3, 3)])
def test_edsr_fused_apply_f32_matches_flax(scale, channels):
    model, x, want = _edsr(scale, channels, 4)
    fn = fused.make_edsr_fused_apply(model, dtype=torch.float32)
    got = fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_edsr_fused_apply_bf16_tracks_flax():
    """bf16 serving against the f32 flax model.  Every conv output is
    rounded to bf16 (8 significant bits, relative step 2^-8), and the head's
    output, the trunk and the skip ``t + h`` carry values of up to ~|x - mean|
    ~ 130 whose bf16 step is 0.5-1.0; the final conv sums 576 such values.
    So the bound is a share of the output's range, 0.05 max|want - mean|
    (the trunk's bf16 criterion), not the f32 atol."""
    model, x, want = _edsr(4, 3, 5)
    fn = fused.make_edsr_fused_apply(model)
    got = fn(torch.from_numpy(x)).numpy()
    mean = np.asarray((0.4488, 0.4371, 0.4040), np.float32) * 255.0
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() < 0.05 * np.abs(want - mean).max()


def _random_head(p):
    """BurstFusionLR's zero-initialised head hides the trunk; randomise
    it."""
    rng = np.random.default_rng(9)
    p["Conv_1"]["kernel"] = (rng.standard_normal(
        p["Conv_1"]["kernel"].shape) * 0.05).astype(np.float32)
    p["Conv_1"]["bias"] = (rng.standard_normal(
        p["Conv_1"]["bias"].shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_burst_lr_fused_apply_matches_flax(dtype):
    kw = dict(n_frames=3, factor=2, n_feats=64, n_resblocks=2)
    x = np.random.default_rng(6).uniform(0, 255, (2, 8, 10, 12)).astype(
        np.float32)
    params = _flax_params(JZ.BurstFusionLR(**kw), x, 2, edit=_random_head)
    want = np.asarray(JZ.BurstFusionLR(**kw).apply(params, jnp.asarray(x)))
    model = convert.load_flax_params(TZ.BurstFusionLR(device="cpu", **kw),
                                     params)
    base = model.shift_and_add(torch.from_numpy(x)).numpy()
    assert np.abs(want - base).max() > 1.0  # the trunk shows in the output
    got = fused.make_burst_lr_fused_apply(model, dtype=dtype)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 20, 1)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        # the residual (want - base) is where bf16 rounds: same criterion
        # as the trunk's, on it
        assert np.abs(got - want).max() < 0.05 * np.abs(want - base).max()
