"""The EDSR residual trunk: 3x3, 64->64 convolutions with a fused epilogue.

Counterpart of ``enph459_super_resolution_tpu/ops/pallas_trunk.py``: the TPU
kernel ``_trunk_kernel`` (launched by ``_trunk_call`` through
``fused_resblocks_packed``) becomes the hand-written CUDA kernel
``csrc/trunk.cu``.  It computes what the TPU kernel is meant to compute,
the chain of ``models/common.py`` ``ResBlock``s (``x + res_scale *
conv(relu(conv(x)))`` with 'SAME' zero padding at every conv), or with
``relu_only`` a chain of conv + ReLU layers.  The TPU kernel itself is not
the yardstick: its half-split packed layout reads zero padding in place of
the neighbours across the seam at packed row ``npix/2``.  This module holds

* :func:`pack_trunk` -- the chain's weights in the kernel's layout, packed
  once per model, off the hot path;
* :func:`trunk_conv` -- the wrapper: one conv layer of the chain with its
  epilogue, one kernel launch for a CUDA tensor, the plain version for a
  CPU tensor.  It counts launches per instantiation:
  ``trunk_conv.launches`` (float32) and ``trunk_conv.launches_bf16``;
* :func:`trunk_conv_reference` -- the plain PyTorch version;
* :func:`fused_resblocks_packed` and :func:`fused_resblocks` -- the chain,
  two launches per residual block (one per conv with ``relu_only``).

Activations are NHWC ``[B, H, W, 64]`` in float32 or bfloat16; the weights
are in the same type and the biases float32.  Products are exact and sums
are float32 (bf16 x bf16 products are exact in f32).  The epilogues round
where the TPU kernel rounds: ``act(relu(acc + b))`` for the first conv of
a block and for every ``relu_only`` conv; ``act(act(res_scale * (acc + b))
+ x)`` for the second, where ``act`` is the rounding to the activation
type and ``x`` the block's input.  In float32 both roundings are
identities.

Not ported: the TPU layout knobs ``band``, ``chunk``, ``g2`` and ``fuse``,
the half-split lane packing, ``wstrip`` and its ``col_off``/``w_glob``
strip mask.  They size the TPU's VMEM slab.  Here each launch takes any
``H, W >= 1`` and any batch; the only gate is 64 features, which the TPU
kernel also requires.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import no_tf32

FEATURES = 64
# Output tile of one CUDA block, rows x columns; compile-time constants of
# csrc/trunk.cu (TH and TW there).
TILE_H = 16
TILE_W = 16

# C signature of trunk_conv_launch and trunk_conv_bf16_launch: five
# pointers (x, w, bias, skip, out), four ints (batch, H, W, skip mode), the
# residual scale and the stream.
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
_ENTRY = {torch.float32: ("trunk_conv_launch", "launches"),
          torch.bfloat16: ("trunk_conv_bf16_launch", "launches_bf16")}


class TrunkPack(NamedTuple):
    """A conv chain's weights on one device, in the kernel's layout."""

    w: torch.Tensor  # [n_conv, 9, 64, 64]: (tap = 3*dy + dx, in, out), dtype
    b: torch.Tensor  # [n_conv, 64] float32

    @property
    def n_conv(self) -> int:
        return self.w.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype


def pack_trunk(convs: Sequence[Tuple[object, object]],
               dtype: torch.dtype = torch.bfloat16, device="cpu") -> TrunkPack:
    """Pack ``[(kernel HWIO [3, 3, 64, 64], bias [64]), ...]`` (numpy or
    tensors), in chain order (conv1, conv2 of each block), once per model.

    HWIO is already the kernel's tap-major ``[9, in, out]`` order; the
    weights are cast to ``dtype`` (float32 or bfloat16) on ``device``.
    """
    if dtype not in _ENTRY:
        raise TypeError(f"trunk dtype {dtype} is neither float32 nor bfloat16")
    if not convs:
        raise ValueError("empty conv chain")
    ws, bs = [], []
    for k, bias in convs:
        k = torch.as_tensor(k).detach().to("cpu", torch.float32)
        if tuple(k.shape) != (3, 3, FEATURES, FEATURES):
            raise ValueError(f"expected [3,3,64,64] kernels, got "
                             f"{tuple(k.shape)}")
        ws.append(k.reshape(9, FEATURES, FEATURES))
        bs.append(torch.as_tensor(bias).detach().to("cpu", torch.float32))
    return TrunkPack(torch.stack(ws).to(device=device, dtype=dtype),
                     torch.stack(bs).to(device))


def _check(x: torch.Tensor, pack: TrunkPack, i: int,
           skip: torch.Tensor | None) -> None:
    if x.dim() != 4 or x.shape[-1] != FEATURES:
        raise ValueError(f"the trunk takes [B, H, W, 64], got "
                         f"{tuple(x.shape)}")
    if x.dtype != pack.dtype:
        raise TypeError(f"activations {x.dtype}, weights {pack.dtype}")
    if x.device != pack.w.device:
        raise ValueError(f"x on {x.device}, weights on {pack.w.device}")
    if not 0 <= i < pack.n_conv:
        raise IndexError(f"conv {i} of a chain of {pack.n_conv}")
    if skip is not None and (skip.shape != x.shape or skip.dtype != x.dtype
                             or skip.device != x.device):
        raise ValueError("skip must match x in shape, type and device")


def trunk_conv_reference(x: torch.Tensor, pack: TrunkPack, i: int,
                         skip: torch.Tensor | None = None,
                         res_scale: float = 1.0) -> torch.Tensor:
    """Plain version of one conv of the chain: ``F.conv2d`` in float32
    (TF32 off) on the operands as stored, then the epilogue with the
    kernel's roundings: ``relu`` when ``skip`` is None, else
    ``act(act(res_scale * y) + skip)``."""
    _check(x, pack, i, skip)
    no_tf32(x)
    w = pack.w[i].float().reshape(3, 3, FEATURES, FEATURES).permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, pack.b[i], padding=1)
    y = y.permute(0, 2, 3, 1)
    if skip is None:
        return torch.relu(y).to(x.dtype).contiguous()
    return ((y * res_scale).to(x.dtype) + skip).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels' vector loads
    need (a fresh allocation is; a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def trunk_conv(x: torch.Tensor, pack: TrunkPack, i: int,
               skip: torch.Tensor | None = None,
               res_scale: float = 1.0) -> torch.Tensor:
    """Conv ``i`` of the chain on ``x`` ``[B, H, W, 64]``, with the relu
    epilogue, or with ``skip`` the residual one; out of place.

    A CUDA tensor goes through the kernel's instantiation for its type,
    always: no shape gate besides the 64 features and no fallback.  A CPU
    tensor goes through the plain version.
    """
    if x.device.type == "cpu":
        return trunk_conv_reference(x, pack, i, skip, res_scale)
    if x.device.type != "cuda":
        raise ValueError(f"trunk conv runs on cuda or cpu, not {x.device}")
    _check(x, pack, i, skip)
    from .._build import load_function

    symbol, counter = _ENTRY[x.dtype]
    launch = load_function("trunk", symbol, _ARGTYPES)
    x = _aligned(x)
    skip = _aligned(skip) if skip is not None else None
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    batch, h, w, _ = x.shape
    rc = launch(x.data_ptr(), pack.w[i].data_ptr(), pack.b[i].data_ptr(),
                skip.data_ptr() if skip is not None else None,
                out.data_ptr(), batch, h, w, int(skip is not None),
                float(res_scale),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trunk kernel launch failed: CUDA error {rc}")
    setattr(trunk_conv, counter, getattr(trunk_conv, counter) + 1)
    return out


trunk_conv.launches = 0
trunk_conv.launches_bf16 = 0


def fused_resblocks_packed(x: torch.Tensor, pack: TrunkPack, *,
                           res_scale: float = 1.0,
                           relu_only: bool = False) -> torch.Tensor:
    """Apply the packed chain to ``x`` ``[B, H, W, 64]`` (any float type;
    computed and returned in the pack's type): ``n_conv / 2`` residual
    blocks, two launches each, or with ``relu_only`` ``n_conv`` conv + ReLU
    layers, one launch each.  Each block's input is kept for its skip."""
    if not relu_only and pack.n_conv % 2:
        raise ValueError("a residual chain holds 2 convs per block, got "
                         f"{pack.n_conv}")
    x = x.to(pack.dtype)
    if relu_only:
        for i in range(pack.n_conv):
            x = trunk_conv(x, pack, i)
        return x
    for i in range(0, pack.n_conv, 2):
        x = trunk_conv(trunk_conv(x, pack, i), pack, i + 1, skip=x,
                       res_scale=res_scale)
    return x


def fused_resblocks(x: torch.Tensor, convs, *, res_scale: float = 1.0,
                    relu_only: bool = False,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`pack_trunk` on ``x``'s device, then the chain (for serving,
    pack once with :func:`pack_trunk` and call
    :func:`fused_resblocks_packed`)."""
    return fused_resblocks_packed(x, pack_trunk(convs, dtype, x.device),
                                  res_scale=res_scale, relu_only=relu_only)
