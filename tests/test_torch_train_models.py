"""The port's training models (``models/zoo.py``: RRDBNet, the VGG-style
discriminator, EDSR's ``remat``) and the flax converter's ``Dense`` and
``GroupNorm`` leaves against the JAX package's flax modules, on the CPU.

Each flax model is initialised by flax, its tree is carried into the
port's model by ``convert.load_flax_params``, and both run on the same
inputs, made with numpy from a seed.  Tolerances: the models run in
float32 and differ only in the order of their f32 sums, held at
``rtol=1e-4, atol=1e-3`` (the generator's 0..255 output, the
discriminator's logits); ``remat`` recomputes the same float32 ops, so its
gradients equal the plain model's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import common as TCM
from enph459_super_resolution_tpu_torch.models import infer as TI
from enph459_super_resolution_tpu_torch.models import zoo as TZ

RTOL, ATOL = 1e-4, 1e-3


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


def _pair(jax_model, port_model, x, seed=0):
    params = _numpy_tree(jax_model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x)))
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    convert.load_flax_params(port_model, params)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    return want, got


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("side", [10, 11])
@pytest.mark.parametrize("scale", [2, 4])
def test_rrdbnet_matches_flax(scale, side):
    x = _lr((2, side, side + 1, 3), side)
    want, got = _pair(JZ.RRDBNet(scale=scale, nb=2, nf=16, gc=8),
                      TZ.RRDBNet(scale=scale, nb=2, nf=16, gc=8,
                                 device="cpu"), x, seed=scale)
    assert got.shape == want.shape == (2, side * scale, (side + 1) * scale, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rrdbnet_remat_tree_loads_and_matches_flax():
    """flax names a rematted block ``CheckpointRRDB_i``; so does the port."""
    x = _lr((1, 9, 9, 1), 3)
    want, got = _pair(JZ.RRDBNet(scale=2, channels=1, nb=1, nf=8, gc=4,
                                 remat=True),
                      TZ.RRDBNet(scale=2, channels=1, nb=1, nf=8, gc=4,
                                 remat=True, device="cpu"), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("side", [24, 25])
def test_discriminator_matches_flax(side):
    """Even and odd sides: flax's 'SAME' pads a 4x4 stride-2 conv (1, 1) on
    an even side and (1, 2) on an odd one, at every one of its 4 strided
    convs (25 -> 13 -> 7 -> 4 -> 2)."""
    x = _lr((3, side, side + 2, 3), side)
    want, got = _pair(JZ.VGGStyleDiscriminator(nf=8),
                      TZ.VGGStyleDiscriminator(nf=8, device="cpu"), x, seed=1)
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [7, 8, 9, 10])
def test_strided_conv_pads_as_flax_same(n):
    import flax.linen as fnn

    x = np.random.default_rng(n).standard_normal((1, n, n + 3, 4)).astype(
        np.float32)
    jconv = fnn.Conv(5, (4, 4), strides=(2, 2))
    params = _numpy_tree(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = TCM.Conv(4, 5, 4, stride=2)
    convert.load_flax_params(conv, params)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, -(-n // 2), -(-(n + 3) // 2), 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_group_norm_matches_flax():
    import flax.linen as fnn

    x = np.random.default_rng(2).standard_normal((2, 5, 6, 16)).astype(
        np.float32) * 3 + 1
    jgn = fnn.GroupNorm(num_groups=8)
    params = _numpy_tree(jgn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(3)
    params["params"]["scale"] = rng.standard_normal(16).astype(np.float32)
    params["params"]["bias"] = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jgn.apply(params, jnp.asarray(x)))
    gn = TCM.GroupNorm(8, 16)
    assert gn.eps == 1e-6
    convert.load_flax_params(gn, params)
    with torch.no_grad():
        got = gn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_converter_maps_dense_and_group_norm():
    params = _numpy_tree(JZ.VGGStyleDiscriminator(nf=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    state = convert.flax_state_dict(params)
    k = params["params"]["Dense_0"]["kernel"]  # [in, out]
    assert k.shape == (64, 100)
    assert state["Dense_0.weight"].shape == (100, 64)
    np.testing.assert_array_equal(state["Dense_0.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        state["GroupNorm_2.weight"].numpy(),
        params["params"]["GroupNorm_2"]["scale"])
    assert "GroupNorm_2.scale" not in state
    with pytest.raises(ValueError, match="kernel"):
        convert.flax_state_dict({"Conv_0": {"kernel": np.zeros((3, 3, 3))}})


def test_edsr_remat_gradients_equal_plain():
    g = torch.Generator().manual_seed(5)
    plain = TZ.EDSR(n_resblocks=3, n_feats=16, scale=2, device="cpu",
                    generator=g)
    remat = TZ.EDSR(n_resblocks=3, n_feats=16, scale=2, remat=True,
                    device="cpu")
    remat.load_state_dict({k.replace("ResBlock", "CheckpointResBlock"): v
                           for k, v in plain.state_dict().items()})
    x = torch.from_numpy(_lr((2, 9, 10, 3), 4))
    y = torch.from_numpy(_lr((2, 18, 20, 3), 5))
    grads = []
    for model in (plain, remat):
        model.zero_grad()
        torch.mean(torch.abs(model(x) - y)).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    assert len(grads[0]) == len(grads[1]) == 2 + 2 * 3 * 2 + 2 + 2 + 2
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(plain(x), remat(x))


def test_edsr_remat_tree_is_flax_layout():
    x = _lr((1, 6, 7, 3), 6)
    want, got = _pair(JZ.EDSR(n_resblocks=2, n_feats=16, scale=2, remat=True),
                      TZ.EDSR(n_resblocks=2, n_feats=16, scale=2, remat=True,
                              device="cpu"), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_scan_trunk_is_refused_with_the_roadmap_item():
    """``scan_trunk=True`` builds the stacked layout (``trunk`` leaves
    ``[n, ...]``), and on the unrolled model's weights, stacked, its
    forward equals the unrolled model's.  A scale RRDBNet has no stages
    for is still refused."""
    plain = TZ.EDSR(scale=2, n_resblocks=3, n_feats=16, device="cpu")
    scan = TZ.EDSR(scale=2, n_resblocks=3, n_feats=16, scan_trunk=True,
                   device="cpu")
    assert scan.trunk.ResBlock_0.Conv_0.weight.shape == (3, 16, 16, 3, 3)
    with pytest.raises(ValueError, match="stacked block"):
        scan.blocks()
    sd = plain.state_dict()
    moved = {"head": "Conv_0", "tail_conv": "Conv_1", "out_conv": "Conv_2",
             "upsampler": "Upsampler_0"}
    new = {}
    for k in scan.state_dict():
        top, rest = k.split(".", 1)
        if top == "trunk":
            leaf = rest.split(".", 1)[1]  # ResBlock_0.<leaf>
            new[k] = torch.stack([sd[f"ResBlock_{i}.{leaf}"]
                                  for i in range(3)])
        else:
            new[k] = sd[f"{moved[top]}.{rest}"]
    scan.load_state_dict(new, strict=True)
    x = torch.from_numpy(_lr((2, 6, 7, 3), 4))
    with torch.no_grad():
        torch.testing.assert_close(scan(x), plain(x), rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="scale"):
        TZ.RRDBNet(scale=3, device="cpu")


def test_dense_block_init_is_scaled_he():
    """ESRGAN's 'smaller initialisation' on the dense-block convs (variance
    2 * 0.1**2 / fan_in), lecun_normal elsewhere, GroupNorm scale 1 bias 0."""
    model = TZ.RRDBNet(nb=2, nf=32, gc=16, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    w = torch.cat([getattr(b, f"DenseBlock_{i}").Conv_4.weight.flatten()
                   for b in model.blocks() for i in range(3)])
    fan_in = 32 + 4 * 16
    assert abs(w.std().item() / (0.02 / (9 * fan_in)) ** 0.5 - 1) < 0.03
    head = model.Conv_0.weight
    assert abs(head.std().item() / (1 / 27) ** 0.5 - 1) < 0.1
    disc = TZ.VGGStyleDiscriminator(nf=16, device="cpu")
    assert abs(disc.Dense_0.weight.std().item() / (1 / 128) ** 0.5 - 1) < 0.03
    assert torch.equal(disc.GroupNorm_0.weight, torch.ones(16))
    assert not disc.GroupNorm_0.bias.any() and not disc.Dense_1.bias.any()


def test_rrdbnet_in_the_registry_and_tiling_radius():
    m = TZ.create_model("rrdbnet", scale=2, channels=1, nb=3, nf=8, gc=4,
                        device="cpu")
    assert isinstance(m, TZ.RRDBNet)
    from enph459_super_resolution_tpu.models.infer import \
        receptive_field_radius
    assert TI.receptive_field_radius(m) == receptive_field_radius(
        JZ.create_model("rrdbnet", nb=3)) == 2 + 15 * 3 + 3 + 2


def test_tiled_rrdbnet_equals_whole_image():
    model = TZ.RRDBNet(scale=2, channels=1, nb=1, nf=8, gc=4, device="cpu")
    lr = _lr((60, 70, 1), 8)  # > tile + 2 x halo 22: 2 x 3 tiles
    got = TI.tiled_infer(model, lr, tile=24)
    with torch.no_grad():
        whole = model(torch.from_numpy(lr)[None])[0].numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-3)
