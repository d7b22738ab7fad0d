"""Device meshes and the CLI's mesh specs.

Counterpart of the spatial half of ``enph459_super_resolution_tpu/
parallel/mesh.py`` (``make_mesh``, ``parse_mesh_spec``, ``parse_sp_spec``).
The reference builds a ``jax.sharding.Mesh`` and lets one program run on
every device of it (single-controller SPMD).  Here a :class:`Mesh` is the
same named grid of devices, held by one Python process that runs each
device's share itself (:mod:`.tiled`): there is no process group, so the
mesh works on one card, across the cards of one host, and on the CPU.

Departure from the reference: an explicit ``devices`` list may name one
device more than once (``make_mesh({"sp": 4}, devices=["cuda"] * 4)``).
The mesh positions that share a device then run one after another on it.
This is how 4 tiles run on one card, and how the CPU tests run 2-8 tiles.

The data- and tensor-parallel shardings (``batch_sharding``,
``replicated``, ``shard_params_tp``, ``shard_params_leading``,
``shard_train_step``) come with the training meshes (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: axis names a mesh spec may use, as in the reference
MESH_AXES = ("dp", "sp", "tp", "pp", "ep")


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    :class:`torch.device` in the mesh's shape, ``axis_names`` names its
    axes in order, and ``shape`` maps each name to its size (as
    ``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a mesh; default is all devices on a 1-D ``dp`` axis.

    Without ``devices`` the mesh takes every CUDA card, and raises when
    there is none (never the CPU).  ``devices`` may list ``torch.device``
    or names such as ``"cuda:1"`` or ``"cpu"``, repeated to put several
    mesh positions on one device.  The product of the axis sizes must equal
    the number of devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card (torch.cuda.is_available() is "
                "False); pass devices=[...] to build a mesh of CPU devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = {"dp": len(devices)}
    names = tuple(axes)
    sizes = tuple(axes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {axes} needs {np.prod(sizes)} devices, "
                         f"have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), names)


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse a CLI mesh spec like ``"dp=2,tp=2"`` or ``"dp=2 x sp=2"``.

    Axis names must come from {dp, sp, tp, pp, ep}; sizes are positive
    ints.  The product must match the device count at :func:`make_mesh`
    time (checked there).
    """
    axes: Dict[str, int] = {}
    for part in spec.replace("x", ",").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"mesh spec entry {part!r} is not name=size")
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in MESH_AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} (use dp/sp/tp/pp/ep)")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r}")
        axes[name] = int(size)
        if axes[name] < 1:
            raise ValueError(f"mesh axis {name}={axes[name]} must be >= 1")
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return axes


def parse_sp_spec(spec) -> Tuple[int, int]:
    """Parse a spatial-sharding spec into ``(sp_h, sp_w)``.

    ``4`` / ``"4"`` -> (4, 1) rows-only strips; ``"4x2"`` -> (4, 2) H x W
    tiles (``sr.run --sp 4x2``).  ``(h, w)`` tuples pass through.
    """
    if isinstance(spec, int):
        h, w = spec, 1
    elif isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(f"sp spec tuple must be (h, w), got {spec!r}")
        h, w = int(spec[0]), int(spec[1])
    else:
        parts = str(spec).lower().split("x")
        if len(parts) > 2 or not all(p.strip().isdigit() for p in parts):
            raise ValueError(
                f"sp spec must be N or NxM (e.g. 8 or 4x2), got {spec!r}")
        h = int(parts[0])
        w = int(parts[1]) if len(parts) == 2 else 1
    if h < 1 or w < 1:
        raise ValueError(f"sp factors must be >= 1, got {h}x{w}")
    return h, w


def sp_mesh(sp, device) -> Tuple[Mesh, Tuple[str, ...]]:
    """The mesh and its spatial axes for ``sr.run --sp`` on ``device``:
    ``{"sp": h}`` (H strips) or ``{"sp": h, "spw": w}`` (H x W tiles) over
    the first ``h * w`` CUDA cards for a CUDA ``device``, or ``h * w``
    times the CPU for the CPU.  Fewer cards than tiles raise
    :func:`make_mesh`'s device-count error (no fallback)."""
    sph, spw = parse_sp_spec(sp)
    device = torch.device(device)
    n = sph * spw
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:n]
    else:
        devices = [device] * n
    axes = {"sp": sph} if spw == 1 else {"sp": sph, "spw": spw}
    return make_mesh(axes, devices=devices), tuple(axes)
