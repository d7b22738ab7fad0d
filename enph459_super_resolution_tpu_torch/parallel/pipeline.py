"""Pipeline parallelism: a trunk split into stages over a ``pp`` mesh axis,
run as a GPipe fill/drain schedule.

Counterpart of ``enph459_super_resolution_tpu/parallel/pipeline.py``.  The
reference runs one SPMD program per device (``shard_map`` + ``lax.scan``
over the schedule, ``ppermute`` between stages).  Here one process walks
the schedule: at step ``t`` (of ``n_micro + pp - 1``) stage ``s`` runs
microbatch ``t - s`` on the devices of its pp position, after the previous
stage's output for that microbatch moved there with ``Tensor.to``.
Launches return before the card finishes, so stages on different cards
overlap; ``loss.backward()`` runs the mirrored schedule on its own, and
each stage's parameters (slices of the whole stacked tensors) get their
gradients summed onto the owner.  The bubble share is ``(pp - 1) /
(n_micro + pp - 1)``.

A data-parallel axis composes: the batch is split over ``dp_axis`` and
each dp position pipelines its own share.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .mesh import Mesh, shard_params_leading
from .spmd import MeshTensor, Sharding, place, tree_map


def stack_stages(stage_params: Sequence):
    """Stack per-stage parameter trees (dicts of tensors, the same keys)
    along a new leading ``pp`` dim: leaves ``[pp, ...]``."""
    if not stage_params:
        raise ValueError("need at least one stage")
    first = stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stages([p[k] for p in stage_params]) for k in first}
    return torch.stack(list(stage_params), dim=0)


def _stage(stacked, s: int):
    return tree_map(lambda a: a[s], stacked)


def pipeline_apply(stage_fn: Callable, stacked_params, x, *, mesh: Mesh,
                   axis: str = "pp", n_micro: Optional[int] = None,
                   dp_axis: Optional[str] = None):
    """Apply ``pp`` shape-preserving stages as a GPipe pipeline.

    Args:
      stage_fn: ``(params_s, u) -> u`` with the same input and output
        shapes (e.g. a stack of residual blocks), the same for every stage;
        ``u`` is a :class:`~.spmd.MeshTensor` on the stage's slice of the
        mesh.
      stacked_params: a tree with a leading stage dim ``pp`` on every leaf
        (:func:`stack_stages`); stage ``s`` takes slice ``s``.
      x: ``[B, ...]`` activations, a plain tensor (returned plain, on its
        device) or a :class:`~.spmd.MeshTensor` on ``mesh`` replicated
        over ``axis`` (returned so).  ``B`` divides by ``n_micro``, and the
        microbatch by the dp axis's size when ``dp_axis`` is given.
      n_micro: microbatches (default: the pipeline depth ``pp``).

    Returns the stages' output, equal (to float tolerance) to applying them
    in turn on one device.
    """
    pp = mesh.shape[axis]
    if n_micro is None:
        n_micro = pp
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    if dp_axis and mb % mesh.shape[dp_axis] != 0:
        raise ValueError(f"microbatch {mb} (= batch {b} / n_micro "
                         f"{n_micro}) not divisible by "
                         f"{dp_axis}={mesh.shape[dp_axis]}")
    plain = isinstance(x, torch.Tensor)
    xm = Sharding(mesh, (dp_axis,) if dp_axis else ()).shard(x) if plain \
        else x
    stage_mesh = [mesh.take(axis, s) for s in range(pp)]
    micro = xm.take(axis, 0).split_batch(n_micro)
    params = [_stage(stacked_params, s) for s in range(pp)]
    carry, emitted = {}, []
    for t in range(n_micro + pp - 1):
        for s in range(pp):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            u = micro[m] if s == 0 else \
                carry.pop((s - 1, m)).moved_to(stage_mesh[s])
            out = stage_fn(params[s], u)
            if s == pp - 1:
                emitted.append(out)
            else:
                carry[(s, m)] = out
    # the last stage holds the outputs: every pp position gets them (the
    # reference's psum over pp)
    y = MeshTensor.cat_batch(emitted).broadcast(mesh, axis)
    return y.gather(x.device) if plain else y


def make_pipelined_edsr_apply(model, mesh: Mesh, *, axis: str = "pp",
                              dp_axis: Optional[str] = None,
                              n_micro: Optional[int] = None):
    """Pipelined forward of an ``EDSR(scan_trunk=True)``.

    Returns ``apply(x)`` computing ``model(x)`` with the stacked trunk's
    ``[n_resblocks, ...]`` parameters regrouped into ``pp`` stages of
    ``n_resblocks / pp`` blocks, run by :func:`pipeline_apply` over
    ``axis``; head, tail, upsampler and output conv run replicated.  The
    function of the model's own parameters (the port's modules hold them;
    the reference's ``apply(variables, x)`` takes them): what
    ``train.loop --mesh "dp=..,pp=.."`` trains through, while evaluation
    calls the model itself.
    """
    if not getattr(model, "scan_trunk", False):
        raise ValueError("pipelined apply needs EDSR(scan_trunk=True)")
    pp = mesh.shape[axis]
    if model.n_resblocks % pp != 0:
        raise ValueError(
            f"n_resblocks={model.n_resblocks} not divisible by pp={pp}")
    gsize = model.n_resblocks // pp
    trunk = model.trunk

    def stage_fn(stage_params, u):
        return trunk.run(u, stage_params)

    def apply(x):
        x = h = model.head(model.MeanShift_0(x))
        stacked = {k: v.reshape(pp, gsize, *v.shape[1:])
                   for k, v in trunk.stacked().items()}
        x = pipeline_apply(stage_fn, stacked, x, mesh=mesh, axis=axis,
                           n_micro=n_micro, dp_axis=dp_axis)
        x = model.tail_conv(x) + h
        x = model.out_conv(model.upsampler(x))
        return model.MeanShift_1(x)

    return apply


def shard_edsr_pp_params(model, mesh: Mesh, axis: str = "pp") -> dict:
    """Place an ``EDSR(scan_trunk=True)`` for pipeline parallelism: the
    stacked trunk's leaves get their leading ``[n_resblocks]`` dim split
    over ``axis`` (contiguous block groups, as
    :func:`make_pipelined_edsr_apply` regroups them), everything else
    replicated.  Returns name -> sharding."""
    out = {}
    for name, p in model.named_parameters():
        on_trunk = "trunk" in name.split(".") and p.dim() >= 1
        out[name] = Sharding(mesh, (axis,) if on_trunk else ())
        place(p, out[name])
    return out


def shard_params_pp(stacked_params, mesh: Mesh, axis: str = "pp") -> dict:
    """Place stacked stage parameters with the leading dim split over
    ``axis`` (one stage per pp position), the rest replicated."""
    return shard_params_leading(stacked_params, mesh, axis)
