"""Carry the JAX package's state into the port.

The classical path has no learned weights; its state is the operator set.
These functions take the contents of the JAX package's ``BandedOp``s and
``FusedIBP`` packs as plain numpy arrays (so this module imports nothing of
JAX) and return the port's :class:`~.ops.opmatrix.BandedOp` or
:class:`~.ops.fused_ibp.FusedIBP` on a device.  bf16 exists only on the
device: bf16 arrays are handed over as float32 (exact) and cast back there.

The neural models' state is a flax parameter tree, handed over as nested
dicts of numpy arrays with flax's automatic names; :func:`flax_state_dict`
turns it into a ``state_dict`` of the port's models, whose modules carry
the same names.  :func:`save_burst_run` writes a trained JAX burst run as a
port run (``train.burst.load_burst_run`` serves it).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .ops.fused_ibp import FusedIBP
from .ops.opmatrix import BandedOp


def banded_op_from_arrays(blocks, col_ranges, n_out: int, n_in: int,
                          device, band_dtype=torch.float32) -> BandedOp:
    """The port's op from a JAX ``BandedOp``'s ``blocks`` (as float32
    arrays), ``col_ranges``, ``n_out`` and ``n_in``, with ``band_dtype``
    bands on ``device``."""
    return BandedOp([np.asarray(b, dtype=np.float32) for b in blocks],
                    col_ranges, n_out, n_in, band_dtype).to(device)


def solve_operators_from_arrays(mats: Mapping, device):
    """The port's operator set from the JAX ``_host_solve_matrices`` dict
    (keys ``zoom_r``, ``zoom_c``, ``saa``, ``frames`` and, for the low band
    stores, ``frames_lo``; same nesting), where each ``BandedOp`` is given
    as a mapping with keys ``blocks``, ``col_ranges``, ``n_out``, ``n_in``
    and optionally ``band_dtype`` (``"bfloat16"`` for the reference's bf16
    copies, whose blocks come as float32)."""
    def conv(node):
        if isinstance(node, Mapping) and "blocks" in node:
            dtype = (torch.bfloat16
                     if node.get("band_dtype") == "bfloat16"
                     else torch.float32)
            return banded_op_from_arrays(node["blocks"], node["col_ranges"],
                                         node["n_out"], node["n_in"], device,
                                         dtype)
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        raise TypeError(f"unexpected operator tree node {type(node)}")

    return conv(mats)


def fused_ibp_from_arrays(arrays: Mapping, f_entries, f_groups, b_entries,
                          n_frames: int, lr_shape, hr_shape, device,
                          band_dtype=torch.float32) -> FusedIBP:
    """The port's :class:`FusedIBP` from a JAX ``FusedIBP``: its eight
    arrays (``f_sr``, ``f_sc``, ``f_bandr``, ``f_bandc``, ``b_sr``, ``b_sc``,
    ``b_bandr``, ``b_bandc``; the bands as float32), entries, groups, frame
    count and shapes.  The TPU's 128-row blocks, 256-column tiles and
    aligned windows run on the port's kernels as they are."""
    host = {name: np.asarray(arrays[name],
                             np.int32 if name.endswith(("_sr", "_sc"))
                             else np.float32)
            for name in FusedIBP.ARRAY_FIELDS}
    tensors = {name: torch.as_tensor(v, device=device)
               for name, v in host.items()}
    pack = FusedIBP(tensors, f_entries, f_groups, b_entries, n_frames,
                    lr_shape, hr_shape)
    return pack.astype_bands(band_dtype) if band_dtype != torch.float32 \
        else pack


#: flax kernel -> port weight axes, by rank: a dense [in, out] -> [out,
#: in]; a conv's HWIO -> OIHW, also stacked on a leading dim (the scan
#: trunk's [n, ...], the vmapped experts' [E, ...])
KERNEL_AXES = {2: (1, 0), 4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}


def flax_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (``{"params": ...}`` or its contents) as a
    ``state_dict`` of the port's model of the same architecture.

    ``a/b/kernel`` becomes ``a.b.weight``: a conv's HWIO ``[kh, kw, in,
    out]`` as OIHW (as ``F.conv2d`` takes it), a ``Dense``'s ``[in, out]``
    as ``[out, in]`` (as ``nn.Linear`` holds it).  Stacked conv kernels (a
    scan-layout EDSR's ``trunk``, ``[n, kh, kw, in, out]``; an EDSRMoE's
    ``experts`` from ``nn.vmap``, ``[E, kh, kw, in, out]``) keep their
    leading dim: ``[n, out, in, kh, kw]``.  A ``GroupNorm``'s ``scale``
    becomes ``weight``; ``bias`` and a PReLU's ``negative_slope`` keep
    their names.  A module named in flax by ``name=`` keeps that name: a
    ``ConvBlock``'s ``conv/kernel`` is ``conv.weight`` of
    :class:`~.models.common.ConvBlock`.
    """
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            a = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                if a.ndim not in KERNEL_AXES:
                    raise ValueError(f"{prefix}kernel: expected HWIO (or "
                                     f"stacked HWIO) or [in, out], got "
                                     f"shape {a.shape}")
                out[prefix + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(KERNEL_AXES[a.ndim])))
            elif key == "scale":
                out[prefix + "weight"] = torch.from_numpy(a.copy())
            elif key in ("bias", "negative_slope"):
                out[prefix + key] = torch.from_numpy(a.copy())
            else:
                raise ValueError(f"unexpected flax parameter {prefix}{key}")

    walk(tree, "")
    return out


def load_flax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax parameter tree into ``model`` (on its device), strictly:
    a missing or extra parameter, or a shape that differs, raises."""
    model.load_state_dict(flax_state_dict(tree), strict=True)
    return model


def save_burst_run(out_dir: str, cfg: Mapping, flax_tree: Mapping) -> str:
    """Write a JAX ``train.burst`` run as a port run under ``out_dir``.

    ``cfg`` is the run's ``config.json`` (as a dict); ``flax_tree`` what the
    JAX package's ``train.state.restore_checkpoint_numpy`` returns for the
    run's ``ckpt`` directory (a numpy tree with ``params``,
    ``ema_params``, ``step`` and ``opt_state``; run it where JAX is
    installed).  Writes ``config.json`` and ``ckpt/<step>/state.pt`` with
    the parameters and their EMA as the port model's state dicts.  The
    optimizer state is not carried over (``opt_state`` None: a resumed run
    starts a fresh Adam).  Returns the checkpoint's path.
    """
    from .train.state import save_checkpoint

    step = int(np.asarray(flax_tree.get("step", 0)))
    state = {"step": step,
             "params": flax_state_dict(flax_tree["params"]),
             "ema_params": flax_state_dict(flax_tree["ema_params"]),
             "opt_state": None}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as fp:
        json.dump(dict(cfg), fp, indent=2)
    return save_checkpoint(os.path.join(out_dir, "ckpt"), state)
