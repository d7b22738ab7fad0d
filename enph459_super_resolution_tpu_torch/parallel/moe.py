"""Expert parallelism: a soft-gated mixture of experts split over an ``ep``
mesh axis.

Counterpart of ``enph459_super_resolution_tpu/parallel/moe.py``.  In an SR
conv stack the natural mixture is spatial: each output pixel blends E
expert branches with per-pixel softmax weights.  Every expert sees the
whole input (dense soft gating: no dispatch, no capacity, no dropped
tokens), so the expert dim is a clean mesh axis: each ep position computes
only its ``E / ep`` experts (a loop over the local slice) on the input
replicated to its device, weights them by its gates, and the partial
blends are added up with one sum onto the output's device (the reference's
``psum``), from where every ep position takes the result.  Gradients reach
the gate and the experts through ``Tensor.to`` and the sum, and a dp axis
composes: each dp position runs its own share of the batch.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from .mesh import Mesh, shard_params_leading
from .spmd import MeshTensor, Sharding, place, placement_of, tree_map


def expert_axis(params: Iterable[torch.Tensor], mesh: Mesh) -> Optional[str]:
    """The mesh axis the experts' leading dim is placed over
    (:func:`shard_params_ep_named`), when ``mesh`` has it (else None: every
    position computes every expert)."""
    for p in params:
        pl = placement_of(p)
        if pl is not None and pl.spec and pl.spec[0] is not None:
            a = pl.spec[0]
            if a in mesh.axis_names and mesh.shape[a] > 1:
                return a
    return None


def moe_combine(expert_fn: Callable, gates: MeshTensor, x: MeshTensor,
                axis: Optional[str] = None) -> MeshTensor:
    """``sum_e gates[..., e:e+1] * expert_fn(e, x)`` over the
    :class:`~.spmd.MeshTensor` ``x``, its ``E`` experts split over
    ``axis`` (None: all of them everywhere).

    ``expert_fn(e, u)`` runs expert ``e`` on ``u``, a
    :class:`~.spmd.MeshTensor` on one ep position's slice of the mesh;
    ``gates`` (``[..., E]``) and ``x`` are replicated over ``axis``.
    """
    e_total = gates.shape[-1]
    if axis is None:
        y = None
        for e in range(e_total):
            term = gates[..., e:e + 1] * expert_fn(e, x)
            y = term if y is None else y + term
        return y
    ep = x.mesh.shape[axis]
    if e_total % ep != 0:
        raise ValueError(f"E={e_total} not divisible by ep={ep}")
    k = e_total // ep
    partials = []
    for j in range(ep):
        xs, gs = x.take(axis, j), gates.take(axis, j)
        y = None
        for e in range(j * k, (j + 1) * k):
            term = gs[..., e:e + 1] * expert_fn(e, xs)
            y = term if y is None else y + term
        partials.append(y)
    # one sum onto the output's device (ep position 0), then every ep
    # position takes it
    out = partials[0]
    cache, tiles = {}, {}
    for pos in out.mesh.positions:
        dev = out.mesh.devices[pos]
        group = [p.tiles[pos] for p in partials]
        key = (dev, *map(id, group))
        if key not in cache:
            cache[key] = sum(t.to(dev) for t in group)
        tiles[pos] = cache[key]
    total = MeshTensor(out.mesh, out.spec, tiles, out.shape)
    return total.broadcast(x.mesh, axis)


def moe_apply(expert_fn: Callable, stacked_params, gates, x, *, mesh: Mesh,
              axis: str = "ep", dp_axis: Optional[str] = None):
    """Soft-gated mixture of experts, expert-split over ``axis``.

    Args:
      expert_fn: ``(params_e, u) -> y`` for one expert (the same
        architecture for all, different weights).
      stacked_params: a tree with the leading expert dim ``E`` on every
        leaf (:func:`stack_experts`).
      gates: ``[B, ..., E]`` per-position mixing weights (softmax upstream;
        the last dim is the expert dim).
      x: ``[B, ...]`` input.  ``gates`` and ``x`` are plain tensors (the
        result is returned plain, on ``x``'s device) or
        :class:`~.spmd.MeshTensor` s on ``mesh`` replicated over ``axis``;
        plain ones are split over ``dp_axis`` when it is given.

    Returns ``sum_e gates[..., e, None] * expert_fn(params_e, x)``, equal
    (to float tolerance) to the dense single-device evaluation.
    """
    e_total = gates.shape[-1]
    ep = mesh.shape[axis]
    if e_total % ep != 0:
        raise ValueError(f"E={e_total} not divisible by ep={ep}")
    plain = isinstance(x, torch.Tensor)
    if plain:
        data = Sharding(mesh, (dp_axis,) if dp_axis else ())
        gates, xm = data.shard(gates), data.shard(x)
    else:
        xm = x
    per_expert = [tree_map(lambda a, e=e: a[e], stacked_params)
                  for e in range(e_total)]
    y = moe_combine(lambda e, u: expert_fn(per_expert[e], u), gates, xm,
                    axis)
    return y.gather(x.device) if plain else y


def stack_experts(expert_params):
    """Stack per-expert parameter trees (dicts of tensors, the same keys)
    along a new leading ``E`` dim."""
    from .pipeline import stack_stages

    if not expert_params:
        raise ValueError("need at least one expert")
    return stack_stages(expert_params)


def shard_params_ep(stacked_params, mesh: Mesh, axis: str = "ep") -> dict:
    """Place stacked expert parameters with the leading dim split over
    ``axis`` (E/ep experts per position), the rest replicated."""
    return shard_params_leading(stacked_params, mesh, axis)


def shard_params_ep_named(params, mesh: Mesh, axis: str = "ep",
                          key: str = "experts") -> dict:
    """Expert-parallel placement of a whole model: parameters whose name
    has ``key`` as a component (the stacked expert modules, e.g.
    ``models.zoo.MoEResBlock``'s ``experts``) get their leading ``[E, ...]``
    dim split over ``axis`` when it divides; everything else (head, tail,
    gates) is replicated.  An exact component match: a parameter named
    e.g. ``experts_gate`` is not expert-split.  The model's MoE blocks then
    compute E/ep experts per position (:func:`moe_combine`).  Returns
    name -> sharding."""
    ep = mesh.shape[axis]
    out = {}
    for name, p in params.named_parameters():
        on_experts = key in name.split(".")
        split = on_experts and p.dim() >= 1 and p.shape[0] % ep == 0
        out[name] = Sharding(mesh, (axis,) if split else ())
        place(p, out[name])
    return out
