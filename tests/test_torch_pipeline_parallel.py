"""Pipeline parallelism in the port (``parallel/pipeline.py``): the GPipe
fill/drain schedule over a pp mesh axis against the sequential
computation (forward and gradients), composed with dp, training a split
model; the scan-trunk EDSR and its pipelined forward; and both against the
JAX package's on the same inputs.

Mirrors ``tests/test_pipeline_parallel.py``.  The port's mesh positions
are the host repeated; the JAX side runs on ``tests/conftest.py``'s 8
virtual CPU devices.  Tolerances: the pipeline runs the stages' very ops
on microbatches, held at 1e-5 (JAX: 0 on one backend); gradients at
JAX's own rtol 2e-4, atol 2e-5; port against JAX at the models' bound
of ``tests/test_torch_models.py`` (rtol 1e-4, atol 1e-3 at ``rgb_range``
255; the residual stacks at 1e-4 on unit-scale inputs), float32 sums in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.models import zoo as JZ
from enph459_super_resolution_tpu.models.common import ResBlock as JResBlock
from enph459_super_resolution_tpu.parallel import make_mesh as j_make_mesh
from enph459_super_resolution_tpu.parallel import pipeline as JPP
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.models import zoo as TZ
from enph459_super_resolution_tpu_torch.models.common import (
    Conv, ResBlock, init_flax_default)
from enph459_super_resolution_tpu_torch.parallel import make_mesh
from enph459_super_resolution_tpu_torch.parallel import pipeline as TPP

FEATS = 8
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


def _run_blocks(params, u):
    """A stage: its ``[k, ...]`` stacked residual blocks in turn."""
    for k in range(next(iter(params.values())).shape[0]):
        u = torch.func.functional_call(
            _BLOCK, {n: v[k] for n, v in params.items()}, (u,))
    return u


def _make_stages(n_stages, blocks_per_stage=2, seed=0):
    per_stage = []
    for s in range(n_stages):
        blocks = []
        for k in range(blocks_per_stage):
            init_flax_default(_BLOCK, torch.Generator().manual_seed(
                seed * 1000 + s * 100 + k))
            blocks.append({n: p.detach().clone()
                           for n, p in _BLOCK.named_parameters()})
        per_stage.append(TPP.stack_stages(blocks))
    return per_stage, TPP.stack_stages(per_stage)


def _sequential(per_stage, x):
    for p in per_stage:
        x = _run_blocks(p, x)
    return x


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_forward_matches_sequential(n_micro):
    pp = 4
    mesh = _mesh({"pp": pp})
    per_stage, stacked = _make_stages(pp)
    x = _x((8, 4, 4, FEATS), 0)
    TPP.shard_params_pp(stacked, mesh)
    with torch.no_grad():
        got = TPP.pipeline_apply(_run_blocks, stacked, x, mesh=mesh,
                                 n_micro=n_micro)
        want = _sequential(per_stage, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_sequential():
    """``backward`` through the pipeline is the backward pipeline: the
    gradients of the stage parameters and of the input equal the
    sequential computation's."""
    pp = 4
    mesh = _mesh({"pp": pp})
    _, stacked = _make_stages(pp, blocks_per_stage=1)
    stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
    x = _x((4, 4, 4, FEATS), 1).requires_grad_(True)
    tgt = _x((4, 4, 4, FEATS), 2)

    def grads(fn):
        loss = torch.mean((fn() - tgt) ** 2)
        return torch.autograd.grad(loss, [x] + list(stacked.values()))

    g_pp = grads(lambda: TPP.pipeline_apply(_run_blocks, stacked, x,
                                            mesh=mesh, n_micro=4))
    g_seq = grads(lambda: _sequential(
        [{k: v[s] for k, v in stacked.items()} for s in range(pp)], x))
    for got, want in zip(g_pp, g_seq):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_pipeline_composes_with_dp():
    mesh = _mesh({"dp": 2, "pp": 4})
    per_stage, stacked = _make_stages(4)
    x = _x((8, 4, 4, FEATS), 2)
    with torch.no_grad():
        got = TPP.pipeline_apply(_run_blocks, stacked, x, mesh=mesh,
                                 n_micro=4, dp_axis="dp")
        want = _sequential(per_stage, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_checks_match_jax():
    """The batch must divide by n_micro, and the microbatch by dp: the
    reference's errors, word for word."""
    jmesh = j_make_mesh({"dp": 2, "pp": 4}, devices=jax.devices()[:8])
    mesh = _mesh({"dp": 2, "pp": 4})
    _, stacked = _make_stages(4, blocks_per_stage=1)
    jstacked = jax.tree.map(jnp.asarray, {"p": 0})
    for b, n_micro in ((6, 4), (8, 8)):
        with pytest.raises(ValueError) as want:
            JPP.pipeline_apply(lambda p, u: u, jstacked,
                               jnp.zeros((b, 4, 4, FEATS)), mesh=jmesh,
                               n_micro=n_micro, dp_axis="dp")
        with pytest.raises(ValueError) as got:
            TPP.pipeline_apply(_run_blocks, stacked,
                               torch.zeros(b, 4, 4, FEATS), mesh=mesh,
                               n_micro=n_micro, dp_axis="dp")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="at least one stage"):
        TPP.stack_stages([])


def test_pipeline_trains_a_split_model():
    """Head + pipelined trunk + tail trains end to end on a dp x pp mesh:
    two SGD steps move the loss down, and every stage's parameters get a
    gradient."""
    mesh = _mesh({"dp": 2, "pp": 4})
    _, stacked = _make_stages(4, blocks_per_stage=1)
    stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
    head, tail = Conv(1, FEATS, 3), Conv(FEATS, 1, 3)
    init_flax_default(head, torch.Generator().manual_seed(0))
    init_flax_default(tail, torch.Generator().manual_seed(1))
    x, y = _x((8, 4, 4, 1), 3), _x((8, 4, 4, 1), 4)
    params = list(stacked.values()) + list(head.parameters()) + list(
        tail.parameters())

    def sgd():
        h = TPP.pipeline_apply(_run_blocks, stacked, head(x), mesh=mesh,
                               n_micro=4, dp_axis="dp")
        loss = torch.mean((tail(h) - y) ** 2)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= 0.05 * g
        return float(loss.detach()), grads

    l0, grads = sgd()
    l1, _ = sgd()
    assert np.isfinite(l0) and l1 < l0
    for g in grads[:len(stacked)]:
        assert all(float(g[s].abs().max()) > 0 for s in range(4))


def test_pipelined_edsr_apply_matches_model_forward():
    """``make_pipelined_edsr_apply`` (the ``train.loop --mesh pp`` forward)
    computes the scan-trunk EDSR's own forward."""
    mesh = _mesh({"dp": 2, "pp": 4})
    model = TZ.EDSR(scale=2, channels=3, n_resblocks=8, n_feats=8,
                    scan_trunk=True, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (8, 6, 6, 3)).astype(np.float32))
    apply = TPP.make_pipelined_edsr_apply(model, mesh, dp_axis="dp")
    placed = TPP.shard_edsr_pp_params(model, mesh)
    assert {k for k, s in placed.items() if s.sharded} == {
        k for k in placed if k.startswith("trunk.")}
    with torch.no_grad():
        want = model(x)
        got = apply(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="scan_trunk"):
        TPP.make_pipelined_edsr_apply(TZ.EDSR(scale=2, n_resblocks=8,
                                              n_feats=8, device="cpu"), mesh)
    with pytest.raises(ValueError, match="not divisible by pp=4"):
        TPP.make_pipelined_edsr_apply(TZ.EDSR(
            scale=2, n_resblocks=6, n_feats=8, scan_trunk=True,
            device="cpu"), mesh)


# --------------------------------------------------------------------------
# against JAX on the same inputs
# --------------------------------------------------------------------------

def test_pipeline_apply_matches_jax():
    """JAX's ``pipeline_apply`` of flax ResBlock stages on its dp x pp mesh
    and the port's, the stacked stage parameters carried by ``convert``."""
    pp = 4
    jmesh = j_make_mesh({"dp": 2, "pp": pp}, devices=jax.devices()[:8])
    mesh = _mesh({"dp": 2, "pp": pp})
    block = JResBlock(features=FEATS)
    x = np.random.default_rng(6).normal(size=(8, 4, 4, FEATS)).astype(
        np.float32)
    stages = [block.init(jax.random.PRNGKey(s), jnp.asarray(x[:1]))
              for s in range(pp)]
    jstacked = JPP.stack_stages(stages)
    want = JPP.pipeline_apply(block.apply, JPP.shard_params_pp(
        jstacked, jmesh), jnp.asarray(x), mesh=jmesh, n_micro=4,
        dp_axis="dp")
    stacked = convert.flax_state_dict(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jstacked))
    assert stacked["Conv_0.weight"].shape == (pp, FEATS, FEATS, 3, 3)

    def stage(p, u):
        return torch.func.functional_call(_BLOCK, p, (u,))

    with torch.no_grad():
        got = TPP.pipeline_apply(stage, stacked, torch.from_numpy(x),
                                 mesh=mesh, n_micro=4, dp_axis="dp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_scan_edsr_matches_flax_through_convert(remat):
    """The flax scan-trunk EDSR's tree (``head``, ``trunk`` stacked
    ``[n, ...]``, ``tail_conv``, ``upsampler``, ``out_conv``) loads into
    the port's, and the two forwards agree; so does the pipelined one."""
    jm = JZ.EDSR(scale=2, channels=3, n_resblocks=4, n_feats=16,
                 scan_trunk=True, remat=remat)
    x = np.random.default_rng(7).uniform(0, 255, (4, 7, 6, 3)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x[:1]))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = TZ.EDSR(scale=2, channels=3, n_resblocks=4, n_feats=16,
                    scan_trunk=True, remat=remat, device="cpu")
    convert.load_flax_params(model, jax.tree.map(
        lambda a: np.asarray(a, np.float32), params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        piped = TPP.make_pipelined_edsr_apply(
            model, _mesh({"dp": 2, "pp": 2}), dp_axis="dp")(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(piped, want, rtol=RTOL, atol=ATOL)
