"""The port's VGG19 feature extractor (``train/vgg.py``) against the JAX
package's, on the CPU, from one seeded torchvision-layout state dict
written to a ``.pth`` (no pretrained weights are fetched).

Both read the same file through their own ``load_torch_vgg19``.
Tolerance: float32 convs summed in another order, ``rtol=1e-4`` and an
absolute ``1e-4`` of the layer's largest feature (He-scaled random weights
keep every layer's features at a similar scale); the perceptual loss's
input gradient, summed back through 16 convs and 4 pools, ``rtol=1e-3``
and an absolute ``1e-3`` of its largest element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.train import vgg as JV
from enph459_super_resolution_tpu_torch.train import vgg as TV
from enph459_super_resolution_tpu_torch.train.losses import PerceptualLoss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_vgg19_state_dict(seed: int = 0):
    """A torchvision ``vgg19`` state dict layout: He-scaled random features
    and one classifier entry (which the loaders drop)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    widths = [w for _, n, w in TV.VGG19_BLOCKS for _ in range(n)]
    for tidx, cout in zip(TV._TORCH_CONV_INDICES, widths):
        sd[f"features.{tidx}.weight"] = torch.from_numpy(rng.normal(
            0, (2.0 / (9 * cin)) ** 0.5, (cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{tidx}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, cout).astype(np.float32))
        cin = cout
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    return sd


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg19.pth"
    torch.save(random_vgg19_state_dict(), path)
    return str(path)


def test_layout_and_constants_are_the_reference():
    assert TV.VGG19_BLOCKS == JV.VGG19_BLOCKS
    assert TV._TORCH_CONV_INDICES == JV._TORCH_CONV_INDICES
    assert TV.conv_names() == JV.conv_names()
    assert TV.IMAGENET_MEAN == JV.IMAGENET_MEAN
    assert TV.IMAGENET_STD == JV.IMAGENET_STD
    model = TV.VGG19Features()
    for name, idx in zip(TV.conv_names(), TV._TORCH_CONV_INDICES):
        assert isinstance(model.features[idx], torch.nn.Conv2d), name
    assert len(model.features) == 37  # torchvision's vgg19().features


@pytest.mark.parametrize("pre_activation", [True, False])
@pytest.mark.parametrize("channels", [3, 1])
def test_features_match_jax(vgg_path, pre_activation, channels):
    layers = ("conv1_1", "conv5_4")
    x = np.random.default_rng(channels).uniform(
        0, 255, (2, 20, 24, channels)).astype(np.float32)
    want = JV.VGG19Features(layers=layers, pre_activation=pre_activation
                            ).apply(JV.load_torch_vgg19(vgg_path),
                                    jnp.asarray(x))
    fn = TV.make_vgg_feature_fn(TV.load_torch_vgg19(vgg_path), layers,
                                pre_activation, device="cpu")
    with torch.no_grad():
        got = fn(torch.from_numpy(x))
    assert [g.shape for g in got] == [tuple(w.shape) for w in want] == [
        (2, 20, 24, 64), (2, 1, 1, 512)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
        if not pre_activation:
            assert g.min() >= 0


def test_perceptual_loss_and_its_gradient_match_jax(vgg_path):
    import jax

    from enph459_super_resolution_tpu.train.losses import \
        PerceptualLoss as JPL

    rng = np.random.default_rng(4)
    sr = rng.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32)
    hr = rng.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32)
    jfeat = JV.make_vgg_feature_fn(JV.load_torch_vgg19(vgg_path))
    want, want_g = jax.value_and_grad(
        lambda a: JPL(jfeat)(a, jnp.asarray(hr)))(jnp.asarray(sr))
    x = torch.from_numpy(sr).requires_grad_(True)
    fn = TV.make_vgg_feature_fn(TV.load_torch_vgg19(vgg_path), device="cpu")
    got = PerceptualLoss(fn)(x, torch.from_numpy(hr))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-4)
    g = np.asarray(want_g)
    np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-3,
                               atol=1e-3 * np.abs(g).max())
    assert not any(p.requires_grad for p in fn.parameters())


def test_unknown_layer_and_missing_weights_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown VGG19 layers"):
        TV.VGG19Features(layers=("conv6_1",))
    path = tmp_path / "partial.pth"
    sd = random_vgg19_state_dict()
    del sd["features.34.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        TV.load_torch_vgg19(str(path))
