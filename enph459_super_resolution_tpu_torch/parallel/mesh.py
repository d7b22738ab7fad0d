"""Device meshes, the CLI's mesh specs, and the sharded train step.

Counterpart of ``enph459_super_resolution_tpu/parallel/mesh.py``.
The reference builds a ``jax.sharding.Mesh`` and lets one program run on
every device of it (single-controller SPMD).  Here a :class:`Mesh` is the
same named grid of devices, held by one Python process that runs each
device's share itself (:mod:`.tiled`): there is no process group, so the
mesh works on one card, across the cards of one host, and on the CPU.

Departure from the reference: an explicit ``devices`` list may name one
device more than once (``make_mesh({"sp": 4}, devices=["cuda"] * 4)``).
The mesh positions that share a device then run one after another on it.
This is how 4 tiles run on one card, and how the CPU tests run 2-8 tiles.

The training meshes: :func:`batch_sharding` and :func:`replicated` return
a :class:`~.spmd.Sharding` (``NamedSharding``'s counterpart: "dim d over
axis a"); :func:`shard_params_tp` and :func:`shard_params_leading` record
one on each parameter of a model (the tensors stay whole on the mesh's
first device, see :mod:`.spmd`); :func:`shard_train_step` lays a batch out
over dp (and its rows over sp) as a :class:`~.spmd.MeshTensor` and runs
the step on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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
        self._positions = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def positions(self) -> List[Tuple[int, ...]]:
        """Every position's index into ``devices``, in row-major order."""
        if self._positions is None:
            self._positions = list(np.ndindex(*self.devices.shape))
        return self._positions

    @property
    def owner(self) -> torch.device:
        """The first position's device: where whole parameters, plain
        reductions and gathers live."""
        return self.devices.flat[0]

    def axis_index(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def take(self, axis: str, j: int) -> "Mesh":
        """The mesh of the positions at index ``j`` of ``axis``, without
        that axis."""
        k = self.axis_index(axis)
        sub = np.empty(self.devices.shape[:k] + self.devices.shape[k + 1:],
                       dtype=object)
        for pos in np.ndindex(*sub.shape):
            sub[pos] = self.devices[pos[:k] + (j,) + pos[k:]]
        return Mesh(sub, self.axis_names[:k] + self.axis_names[k + 1:])


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


# --------------------------------------------------------------------------
# training meshes
# --------------------------------------------------------------------------

def batch_sharding(mesh: Mesh, axis: str = "dp"):
    """Split the leading (batch) dim over ``axis``, replicate the rest."""
    from .spmd import Sharding

    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh):
    from .spmd import Sharding

    return Sharding(mesh, ())


def _out_dim(module: torch.nn.Module, name: str, p: torch.Tensor) -> int:
    """The dim of ``p`` that holds output features (flax's last axis): an
    OIHW conv weight's O, a ``[out, in]`` dense weight's out, else the last
    (a bias, a norm's scale); stacked leaves ``[n, ...]`` add one in
    front."""
    from ..models.common import Conv, Dense

    if name == "weight" and isinstance(module, Conv):
        return p.dim() - 4
    if name == "weight" and isinstance(module, Dense):
        return p.dim() - 2
    return p.dim() - 1


def _named_leaves(params):
    """``(full name, owning module, local name, tensor)`` of a module's
    parameters, or of a ``{name: tensor}`` mapping (no owning module)."""
    if isinstance(params, torch.nn.Module):
        for mname, mod in params.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                yield (f"{mname}.{pname}" if mname else pname), mod, pname, p
    else:
        from .spmd import tree_leaves

        for name, p in params.items():
            for leaf in tree_leaves(p):
                yield name, None, name.rsplit(".", 1)[-1], leaf


def shard_params_tp(params, mesh: Mesh, axis: str = "tp") -> dict:
    """Tensor-parallel layout: a parameter's output-feature dim is split
    over ``axis`` when it divides by tp and is at least 8 * tp (the JAX
    rule, on PyTorch's layouts: dim 0 of an OIHW conv weight or a dense
    weight, a bias's only dim); every other parameter is replicated.

    ``params`` is a model; each parameter gets its :class:`~.spmd.Sharding`
    recorded (:func:`~.spmd.place`), which the conv and dense layers read
    under a :class:`~.spmd.MeshTensor`.  Returns name -> sharding."""
    from .spmd import Sharding, place

    tp = mesh.shape[axis]
    out = {}
    for name, mod, pname, p in _named_leaves(params):
        spec = ()
        if p.dim() >= 1:
            d = _out_dim(mod, pname, p) if mod is not None else p.dim() - 1
            if p.shape[d] % tp == 0 and p.shape[d] >= tp * 8:
                spec = (None,) * d + (axis,)
        out[name] = Sharding(mesh, spec)
        place(p, out[name])
    return out


def shard_params_leading(stacked_params, mesh: Mesh, axis: str) -> dict:
    """Every parameter's LEADING dim split over ``axis``, the rest
    replicated: the layout of pipeline stages (``[pp, ...]``) and MoE
    experts (``[E, ...]``).  ``stacked_params``: a model or a name ->
    tensor mapping.  Returns name -> sharding."""
    from .spmd import Sharding, place

    out = {}
    for name, _, _, p in _named_leaves(stacked_params):
        out[name] = Sharding(mesh, (axis,))
        place(p, out[name])
    return out


def shard_train_step(step_fn, mesh: Mesh, dp_axis: str = "dp",
                     sp_axis: Optional[str] = None):
    """Run ``step_fn(state, lr, hr) -> metrics`` with the batch split over
    ``dp_axis`` (and, when ``sp_axis`` is given, the patch rows over it:
    each conv exchanges its window's rows between the tiles), as
    :class:`~.spmd.MeshTensor` s; the parameters' layouts are the ones
    recorded on them (replicated by default, tp-split after
    :func:`shard_params_tp`).  Returns ``step(state, lr, hr) -> metrics``;
    ``step.data_sharding`` is the batch's layout."""
    from .spmd import Sharding

    dims = [dp_axis if dp_axis in mesh.shape else None]
    if sp_axis and sp_axis in mesh.shape:
        dims.append(sp_axis)
    data = Sharding(mesh, tuple(dims))

    def step(state, lr, hr):
        return step_fn(state, data.shard(lr), data.shard(hr))

    step.data_sharding = data
    return step
