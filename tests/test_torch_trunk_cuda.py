"""The residual-trunk CUDA kernel (``csrc/trunk.cu``) against its plain
PyTorch version, on the card.

Needs an NVIDIA card with the CUDA toolkit (``nvcc``); skips without one.
Run on the card with ``python -m pytest --noconftest
tests/test_torch_trunk_cuda.py -q``.  Shapes the 16 x 16 tile does not
divide, 1-pixel-wide and 1-pixel-high images, a batch axis, both
epilogues, ``res_scale`` 0.1, 0.5 and 2, ``relu_only`` chains and a
16-block chain; for the bf16 tensor-core kernel also tile counts that its
persistent grid does not divide and an input view at an odd offset.

Tolerances.  float32: the two differ only in the order of their f32 sums,
``<= 1e-4`` on values of order 1.  bfloat16: the same f32 sums, then a
rounding to bf16 that may fall the other way: one bf16 ulp of the larger
magnitude, plus the f32 allowance (near zero a bf16 ulp is smaller than
two f32 sums differ).  The residual epilogue rounds twice, ``act(act(s *
y) + x)``, and a flip of the inner rounding moves the sum by one ulp of
``s * y``, at most 2 ulp of ``max(|out|, |x|)``.
"""

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops import trunk

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ulp_bf16(v):
    m = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _within(got, want, skip=None):
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return d.max().item() <= F32_ATOL
    big = torch.maximum(got.float().abs(), want.float().abs())
    bound = F32_ATOL + _ulp_bf16(big)
    if skip is not None:
        bound = bound + 2 * _ulp_bf16(torch.maximum(big, skip.float().abs()))
    return bool((d <= bound).all())


def _pack(n_convs, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    convs = [(rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.05,
              rng.standard_normal((64,)).astype(np.float32) * 0.1)
             for _ in range(n_convs)]
    return trunk.pack_trunk(convs, dtype, device)


def _x(shape, dtype, device, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape + (64,))
    return torch.as_tensor(x, dtype=torch.float32, device=device).to(dtype)


def _counter(dtype):
    return "launches_bf16" if dtype == torch.bfloat16 else "launches"


SHAPES = [(1, 1, 1), (2, 5, 7), (1, 1, 40), (2, 37, 1), (3, 17, 33),
          (1, 16, 16), (2, 33, 18)]


@pytest.mark.parametrize("res_scale", [1.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_each_epilogue_matches_plain(cuda, dtype, shape, res_scale):
    pack = _pack(2, dtype, cuda)
    x = _x(shape, dtype, cuda)
    name = _counter(dtype)
    before = getattr(trunk.trunk_conv, name)
    t = trunk.trunk_conv(x, pack, 0)
    t_want = trunk.trunk_conv_reference(x, pack, 0)
    # the residual conv from the plain version's t, so it is judged alone
    y = trunk.trunk_conv(t_want, pack, 1, skip=x, res_scale=res_scale)
    y_want = trunk.trunk_conv_reference(t_want, pack, 1, skip=x,
                                        res_scale=res_scale)
    torch.cuda.synchronize()
    assert getattr(trunk.trunk_conv, name) == before + 2
    assert t.dtype == y.dtype == dtype and t.shape == y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())
    assert _within(t, t_want)
    assert _within(y, y_want, skip=x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_relu_only_chain_matches_plain(cuda, dtype):
    pack = _pack(3, dtype, cuda, seed=2)
    x = _x((2, 19, 21), dtype, cuda, seed=3)
    name = _counter(dtype)
    before = getattr(trunk.trunk_conv, name)
    got = trunk.fused_resblocks_packed(x, pack, relu_only=True)
    assert getattr(trunk.trunk_conv, name) == before + 3
    want = x
    for i in range(3):
        step = trunk.trunk_conv(want, pack, i)
        want = trunk.trunk_conv_reference(want, pack, i)
        assert _within(step, want)
    torch.cuda.synchronize()
    assert bool((got.float() >= 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_16_block_chain_tracks_plain(cuda, dtype):
    """32 launches; the per-launch differences compound through the chain,
    so the whole is held to a share of its range: 1e-3 in f32, 2e-2 in
    bf16 (about five bf16 ulps)."""
    pack = _pack(32, dtype, cuda, seed=4)
    x = _x((2, 40, 24), dtype, cuda, seed=5)
    name = _counter(dtype)
    before = getattr(trunk.trunk_conv, name)
    got = trunk.fused_resblocks_packed(x, pack, res_scale=0.1)
    assert getattr(trunk.trunk_conv, name) == before + 32
    want = x
    for i in range(0, 32, 2):
        want = trunk.trunk_conv_reference(
            trunk.trunk_conv_reference(want, pack, i), pack, i + 1,
            skip=want, res_scale=0.1)
    torch.cuda.synchronize()
    share = 1e-3 if dtype == torch.float32 else 2e-2
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= share * scale


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    pack = _pack(2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="64"):
        trunk.trunk_conv(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16,
                                     device=cuda), pack, 0)
    with pytest.raises(TypeError):
        trunk.trunk_conv(torch.zeros(1, 4, 4, 64, device=cuda), pack, 0)
    with pytest.raises(ValueError, match="weights on"):
        trunk.trunk_conv(_x((1, 4, 4), torch.bfloat16, cuda),
                         _pack(2, torch.bfloat16, "cpu"), 0)
    before = trunk.trunk_conv.launches_bf16
    trunk.trunk_conv(_x((1, 4, 4), torch.bfloat16, "cpu"),
                     _pack(2, torch.bfloat16, "cpu"), 0)
    assert trunk.trunk_conv.launches_bf16 == before  # the plain version


# The bf16 kernel's tiles (16 x 16 pixels) are walked by a persistent grid
# of one CTA per SM: shapes whose rows and columns the tile does not divide,
# 1-pixel rows and columns, batches of 1 and 9.
RAGGED = [(1, 1, 255), (9, 17, 1), (1, 255, 17), (9, 17, 255), (1, 1, 1),
          (9, 255, 1)]


@pytest.mark.parametrize("res_scale", [0.5, 2.0])
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_bf16_tensor_cores_at_ragged_shapes(cuda, shape, res_scale):
    """Both epilogues, each judged alone, within one bf16 ulp of the larger
    magnitude plus 1e-4 (two more ulps on the residual launch): the kernel
    and the plain version sum the same exact products in f32 in another
    order, then round to bf16."""
    pack = _pack(2, torch.bfloat16, cuda, seed=6)
    x = _x(shape, torch.bfloat16, cuda, seed=7)
    t = trunk.trunk_conv(x, pack, 0)
    t_want = trunk.trunk_conv_reference(x, pack, 0)
    y = trunk.trunk_conv(t_want, pack, 1, skip=x, res_scale=res_scale)
    y_want = trunk.trunk_conv_reference(t_want, pack, 1, skip=x,
                                        res_scale=res_scale)
    torch.cuda.synchronize()
    assert t.shape == y.shape == x.shape
    assert _within(t, t_want)
    assert _within(y, y_want, skip=x)


@pytest.mark.parametrize("extra", [1, 5])
def test_bf16_tile_count_not_a_multiple_of_the_grid(cuda, extra):
    """sms + extra and 2 * sms + extra tiles: some CTAs of the persistent
    grid take one tile more than others, and stage a next tile that other
    CTAs never have."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pack = _pack(2, torch.bfloat16, cuda, seed=8)
    for tiles in (sms + extra, 2 * sms + extra):
        x = _x((1, 16, 16 * tiles - 3), torch.bfloat16, cuda, seed=tiles)
        for skip in (None, x):
            inp = trunk.trunk_conv_reference(x, pack, 0) if skip is not None \
                else x
            got = trunk.trunk_conv(inp, pack, int(skip is not None),
                                   skip=skip, res_scale=0.25)
            want = trunk.trunk_conv_reference(inp, pack,
                                              int(skip is not None),
                                              skip=skip, res_scale=0.25)
            torch.cuda.synchronize()
            assert _within(got, want, skip=skip)


def test_bf16_input_at_an_odd_offset_is_realigned(cuda):
    """A view that starts 2 bytes into its storage is copied to an aligned
    buffer before the kernel's 16-byte loads; the result is the same."""
    pack = _pack(2, torch.bfloat16, cuda, seed=9)
    x = _x((1, 9, 11), torch.bfloat16, cuda, seed=10)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    got = trunk.trunk_conv(view, pack, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, trunk.trunk_conv(x, pack, 0))
