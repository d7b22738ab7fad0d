"""The port's tiled full-image inference (``models/infer.py``) against the
JAX package's ``tiled_infer`` with the same converted weights, and against
its own whole-image forward, on the CPU.

Tolerances are tests/test_infer.py's: ``atol=2e-3`` for ESPCN and
``atol=5e-3`` for EDSR on the 0..255 output (float32 sums in another order
on each side); the uint8 output may differ by 1 where a float value sits on
an integer, since both truncate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import infer as JI
from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import infer as TI
from enph459_super_resolution_tpu_torch.models import zoo as TZ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(jax_model, port_cls, seed, **kw):
    params = jax_model.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8, 8, kw["channels"]), jnp.float32))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    return params, convert.load_flax_params(port_cls(device="cpu", **kw),
                                            tree)


@pytest.fixture(scope="module")
def espcn():
    kw = dict(scale=2, channels=3)
    params, model = _models(JZ.ESPCN(**kw), TZ.ESPCN, 0, **kw)
    return JZ.ESPCN(**kw), params, model


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(40, 56, 3), (37, 51, 3)],
                         ids=["40x56", "37x51"])
def test_tiled_espcn_matches_jax(espcn, shape):
    jm, params, model = espcn
    lr = _lr(shape, 21)
    want = JI.tiled_infer(jm, params, jnp.asarray(lr), tile=16)
    got = TI.tiled_infer(model, lr, tile=16)
    assert got.shape == want.shape == (shape[0] * 2, shape[1] * 2, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_tiled_espcn_uint8_within_one(espcn):
    jm, params, model = espcn
    lr = np.floor(_lr((2, 40, 56, 3), 22))  # a batch axis too
    want = JI.tiled_infer(jm, params, jnp.asarray(lr), tile=16,
                          out_dtype=np.uint8)
    got = TI.tiled_infer(model, lr, tile=16, out_dtype=np.uint8)
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 80, 112, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    # a uint8 image uploads as it is and gives the same result
    np.testing.assert_array_equal(
        TI.tiled_infer(model, lr.astype(np.uint8), tile=16,
                       out_dtype=np.uint8), got)


@pytest.mark.parametrize("tile", [16, 8], ids=["whole_image", "tiled"])
def test_tiled_edsr_matches_jax(tile):
    """EDSR 2 x 8 on 32x32: at tile 16 the halo (11) makes it one patch
    (the small-image path); at tile 8 it is cut into 16 tiles."""
    kw = dict(scale=2, channels=3, n_resblocks=2, n_feats=8)
    params, model = _models(JZ.EDSR(**kw), TZ.EDSR, 1, **kw)
    lr = _lr((32, 32, 3), 23)
    want = JI.tiled_infer(JZ.EDSR(**kw), params, jnp.asarray(lr), tile=tile)
    got = TI.tiled_infer(model, lr, tile=tile)
    assert got.shape == want.shape == (64, 64, 3)
    np.testing.assert_allclose(got, want, atol=5e-3)


@pytest.mark.parametrize("tile,batch_tiles", [(16, 8), (12, 3), (10, 4)])
def test_tiled_equals_own_whole_image(espcn, tile, batch_tiles):
    """Clamped windows, ragged edge tiles, and padded tail chunks (12 tiles
    at 8 per chunk, 20 at 3; 24 at 4 has none)."""
    _, _, model = espcn
    lr = _lr((37, 51, 3), 24)
    with torch.no_grad():
        whole = model(torch.from_numpy(lr)[None])[0].numpy()
    got = TI.tiled_infer(model, lr, tile=tile, batch_tiles=batch_tiles)
    np.testing.assert_allclose(got, whole, atol=2e-3)


def test_receptive_field_radius_equals_jax():
    pairs = [(JZ.SRCNN(), TZ.SRCNN), (JZ.ESPCN(), TZ.ESPCN),
             (JZ.FSRCNN(m=2), lambda **k: TZ.FSRCNN(m=2, **k)),
             (JZ.FSRCNN(), TZ.FSRCNN),
             (JZ.EDSR(n_resblocks=2, n_feats=8),
              lambda **k: TZ.EDSR(n_resblocks=2, n_feats=8, **k)),
             (JZ.EDSR(n_feats=8), lambda **k: TZ.EDSR(n_feats=8, **k))]
    for jm, make in pairs:
        assert TI.receptive_field_radius(make(device="cpu")) == \
            JI.receptive_field_radius(jm)
    with pytest.raises(ValueError):
        TI.receptive_field_radius(TZ.BurstFusionLR(n_feats=8, n_resblocks=1,
                                                   device="cpu"))
