"""Carry the JAX package's state into the port.

The classical path has no learned weights; its state is the operator set.
These functions take the contents of the JAX package's ``BandedOp``s as
plain numpy arrays (so this module imports nothing of JAX) and return the
port's :class:`~.ops.opmatrix.BandedOp`, packed on a device.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .ops.opmatrix import BandedOp


def banded_op_from_arrays(blocks, col_ranges, n_out: int, n_in: int,
                          device) -> BandedOp:
    """The port's op from a JAX ``BandedOp``'s ``blocks`` (float32 arrays),
    ``col_ranges``, ``n_out`` and ``n_in``."""
    return BandedOp([np.asarray(b, dtype=np.float32) for b in blocks],
                    col_ranges, n_out, n_in).to(device)


def solve_operators_from_arrays(mats: Mapping, device):
    """The port's operator set from the JAX ``_host_solve_matrices`` dict
    (keys ``zoom_r``, ``zoom_c``, ``saa``, ``frames``, same nesting), where
    each ``BandedOp`` is given as a mapping with keys ``blocks``,
    ``col_ranges``, ``n_out`` and ``n_in``."""
    def conv(node):
        if isinstance(node, Mapping) and "blocks" in node:
            return banded_op_from_arrays(node["blocks"], node["col_ranges"],
                                         node["n_out"], node["n_in"], device)
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        raise TypeError(f"unexpected operator tree node {type(node)}")

    return conv(mats)
