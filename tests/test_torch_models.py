"""The port's model zoo (``models/common.py``, ``models/zoo.py``) and the
flax converter against the JAX package's flax modules, on the CPU.

Each flax model is initialised by flax, its parameter tree is carried into
the port's model by ``convert.load_flax_params``, and both run on the same
inputs, made with numpy from a seed.  Tolerances: ``pixel_shuffle`` is a
pure layout change and must be bit-equal; the models run in float32 and
differ only in the order of their f32 sums, held at ``rtol=1e-4,
atol=1e-3`` on the 0..255 output (tests/test_pallas_trunk.py's EDSR
bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import common as JCM
from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import common as TCM
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


def _pair(jax_model, port_cls, x, seed=0, edit=None, **kwargs):
    """flax-initialised params, optionally edited, loaded into the port's
    model; returns (flax output, port output) as numpy."""
    params = _numpy_tree(jax_model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x)))
    if edit is not None:
        edit(params["params"])
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    model = port_cls(device="cpu", **kwargs)
    convert.load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return want, got


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("c", [1, 3])
def test_pixel_shuffle_is_bit_equal(r, c):
    x = np.random.default_rng(r * 10 + c).standard_normal(
        (2, 5, 6, c * r * r)).astype(np.float32)
    want = np.asarray(JCM.pixel_shuffle(jnp.asarray(x), r))
    got = TCM.pixel_shuffle(torch.from_numpy(x), r).numpy()
    assert got.shape == want.shape == (2, 5 * r, 6 * r, c)
    np.testing.assert_array_equal(got, want)


def test_pixel_shuffle_is_not_torch_order():
    """(r, r, C) grouping: channel (i*r + j)*C + c -> sub-pixel (i, j)."""
    x = torch.arange(12, dtype=torch.float32).reshape(1, 1, 1, 12)
    y = TCM.pixel_shuffle(x, 2)
    assert y[0, 0, 1].tolist() == [3.0, 4.0, 5.0]  # (i, j) = (0, 1), C = 3
    assert not torch.equal(
        y, torch.nn.PixelShuffle(2)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("sign", [-1, 1])
def test_mean_shift_matches_flax(c, sign):
    x = _lr((2, 4, 5, c), c)
    want = np.asarray(JCM.MeanShift(sign=sign, scale=255.0).apply(
        {}, jnp.asarray(x)))
    got = TCM.MeanShift(sign=sign, scale=255.0)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_upsampler_stages():
    assert TCM.upsampler_stages(2) == (2,)
    assert TCM.upsampler_stages(3) == (3,)
    assert TCM.upsampler_stages(4) == (2, 2)
    assert TCM.upsampler_stages(8) == (2, 2, 2)
    with pytest.raises(ValueError):
        TCM.upsampler_stages(5)


@pytest.mark.parametrize("res_scale", [1.0, 0.1])
def test_resblock_matches_flax(res_scale):
    x = np.random.default_rng(3).standard_normal((1, 7, 9, 16)).astype(
        np.float32)
    jb = JCM.ResBlock(16, res_scale)
    params = _numpy_tree(jb.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    want = np.asarray(jb.apply(params, jnp.asarray(x)))
    block = TCM.ResBlock(16, res_scale)
    convert.load_flax_params(block, params)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3])
def test_srcnn_matches_flax(channels):
    x = _lr((2, 14, 11, channels), 1)
    want, got = _pair(JZ.SRCNN(channels=channels), TZ.SRCNN, x,
                      channels=channels)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale,channels", [(2, 3), (3, 1), (4, 1)])
def test_espcn_matches_flax(scale, channels):
    x = _lr((2, 9, 10, channels), 2)
    want, got = _pair(JZ.ESPCN(scale=scale, channels=channels), TZ.ESPCN, x,
                      scale=scale, channels=channels)
    assert got.shape == (2, 9 * scale, 10 * scale, channels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [1, 4])
def test_fsrcnn_matches_flax_with_its_prelu_slopes(m):
    """Each PReLU's scalar slope is carried: the flax tree's slopes are set
    away from their 0.01 init before conversion."""
    def edit(p):
        for i in range(m + 3):
            p[f"PReLU_{i}"]["negative_slope"] = np.float32(0.05 * (i + 1))

    x = _lr((1, 11, 9, 1), 3)
    want, got = _pair(JZ.FSRCNN(scale=2, channels=1, m=m), TZ.FSRCNN, x,
                      edit=edit, scale=2, channels=1, m=m)
    assert got.shape == (1, 22, 18, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_edsr_matches_flax(scale, channels):
    x = _lr((1, 10, 12, channels), 4)
    kw = dict(scale=scale, channels=channels, n_resblocks=2, n_feats=64)
    want, got = _pair(JZ.EDSR(**kw), TZ.EDSR, x, **kw)
    assert got.shape == (1, 10 * scale, 12 * scale, channels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_edsr_res_scale_and_x8_match_flax():
    x = _lr((2, 6, 5, 3), 5)
    kw = dict(scale=8, channels=3, n_resblocks=3, n_feats=16, res_scale=0.1)
    want, got = _pair(JZ.EDSR(**kw), TZ.EDSR, x, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _random_head(p):
    """BurstFusionLR's head conv is zero at init, which hides the trunk;
    give it random weights."""
    rng = np.random.default_rng(9)
    p["Conv_1"]["kernel"] = (rng.standard_normal(
        p["Conv_1"]["kernel"].shape) * 0.05).astype(np.float32)
    p["Conv_1"]["bias"] = (rng.standard_normal(
        p["Conv_1"]["bias"].shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_frames,factor", [(3, 2), (4, 3)])
def test_burst_fusion_lr_matches_flax(n_frames, factor):
    kw = dict(n_frames=n_frames, factor=factor, n_feats=64, n_resblocks=2)
    x = _lr((2, 8, 10, n_frames * factor ** 2), 6)
    want, got = _pair(JZ.BurstFusionLR(**kw), TZ.BurstFusionLR, x,
                      edit=_random_head, **kw)
    assert got.shape == (2, 8 * factor, 10 * factor, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_burst_fusion_lr_zero_head_is_shift_and_add():
    model = TZ.BurstFusionLR(n_frames=2, n_feats=16, n_resblocks=1,
                             device="cpu")
    assert not model.Conv_1.weight.any() and not model.Conv_1.bias.any()
    x = torch.from_numpy(_lr((1, 5, 6, 8), 7))
    with torch.no_grad():
        torch.testing.assert_close(model(x), model.shift_and_add(x))
    with pytest.raises(ValueError, match="phase channels"):
        model(x[..., :7])


def test_default_init_is_flax_lecun_normal():
    g = torch.Generator().manual_seed(4)
    model = TZ.EDSR(n_resblocks=4, device="cpu", generator=g)
    w = torch.cat([b.Conv_0.weight.flatten() for b in model.blocks()])
    std = (1.0 / (9 * 64)) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    assert not any(c.bias.any() for b in model.blocks()
                   for c in (b.Conv_0, b.Conv_1))
    again = TZ.EDSR(n_resblocks=4, device="cpu",
                    generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))


def test_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        TZ.ESPCN()


def test_create_model_and_registry():
    assert set(TZ.MODELS) == {"srcnn", "espcn", "fsrcnn", "edsr",
                              "burstfusion", "burstfusion_lr", "rrdbnet"}
    assert set(TZ.MODELS) <= set(JZ.MODELS)
    m = TZ.create_model("espcn", scale=2, channels=3, device="cpu")
    assert isinstance(m, TZ.ESPCN) and m.scale == 2


def test_converter_maps_names_and_layouts():
    params = JZ.ESPCN(scale=2).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 4, 4, 1)))
    state = convert.flax_state_dict(_numpy_tree(params))
    k = np.asarray(params["params"]["Conv_2"]["kernel"])  # HWIO
    assert state["Conv_2.weight"].shape == (4, 32, 3, 3)  # OIHW
    np.testing.assert_array_equal(state["Conv_2.weight"][1, 5, 2, 0],
                                  k[2, 0, 5, 1])


def test_converter_refuses_scan_layout_and_mismatches():
    x = jnp.zeros((1, 6, 6, 3))
    scan = JZ.EDSR(n_resblocks=2, n_feats=16, scan_trunk=True).init(
        jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="scan-layout"):
        convert.flax_state_dict(_numpy_tree(scan))
    tree = _numpy_tree(JZ.EDSR(n_resblocks=2, n_feats=16).init(
        jax.random.PRNGKey(0), x))
    with pytest.raises(RuntimeError):  # 2 blocks into a 3-block model
        convert.load_flax_params(
            TZ.EDSR(n_resblocks=3, n_feats=16, device="cpu"), tree)
