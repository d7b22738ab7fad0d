"""Sharded tensors of a single-controller mesh: the port's counterpart of
GSPMD's sharded arrays and their ``NamedSharding``.

The reference jits a step with ``in_shardings`` and lets XLA's GSPMD
partition every op of it over the mesh, inserting the collectives
(gradient psums over dp, conv halo exchanges over sp, channel all-gathers
over tp).  Here one Python process holds the mesh (:class:`~.mesh.Mesh`,
whose positions may repeat a device) and a :class:`MeshTensor`: one local
tensor per mesh position, each on that position's device, standing for
one global tensor.  The model's own ``forward`` runs on it unchanged:

* Per-pixel and per-channel ops (arithmetic, activations, ``where``,
  ``softmax`` over channels, reshapes and permutes that keep the sharded
  dims) run tile by tile (:data:`LOCAL_OPS`).  Where several positions hold
  the very same tensors on one device (a replicated axis, or a device
  repeated in the mesh), the op runs once and they share the result.
* A reduction over a sharded dim adds up the tiles' partial sums over the
  global count (the loss and PSNR are the global batch's); a reduction
  over everything returns a plain tensor on the mesh's first device.
* The layers of ``models/common.py`` hand a :class:`MeshTensor` to
  :meth:`MeshTensor.apply_layer`: a conv extends each row tile by the rows
  its window needs from the neighbouring tiles, zeros past the global
  edges ('SAME' padding over the whole image: the per-conv halo exchange
  GSPMD inserts); a conv or dense layer whose weight is placed over a tp
  axis computes each tp position's slice of output channels from the full
  input and joins the slices (the all-gather); a ``GroupNorm`` gathers its
  row tiles first.
* Any other torch function gathers its :class:`MeshTensor` arguments into
  plain tensors on the mesh's first device and runs there: slower, never
  wrong.

Values move between positions by ``Tensor.to``, which is differentiable,
so ``loss.backward()`` runs the backward schedule (halo rows' gradients
back to their owners, the transposed all-gathers) on its own.

Parameters are not split up front: a model keeps whole tensors on the
mesh's first device (its owner; the optimizer, the EMA and the checkpoints
see one tensor per parameter), and a :class:`Sharding` recorded on a
parameter (:func:`place`) says how the layers take it: each position takes
its slice with ``Tensor.to``, whose backward sums the positions'
gradients onto the owner.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import Mesh

_PLACEMENT_ATTR = "_mesh_sharding"

#: the torch functions and Tensor methods the models and losses apply
#: to each element alone: a tile's result is the global result's tile
#: (any other function gathers first)
LOCAL_OPS = frozenset("""
    add sub mul div neg abs square sqrt pow relu tanh leaky_relu softplus
    clamp where ge gt le lt float double detach contiguous clone
    __add__ __radd__ __sub__ __rsub__ __mul__ __rmul__ __truediv__
    __rtruediv__ __neg__ __pow__ __rpow__ __ge__ __gt__ __le__ __lt__
    __abs__
""".split())


class Sharding:
    """How a tensor lies on a mesh: ``spec[d]`` names the mesh axis that
    dim ``d`` is split over in equal contiguous chunks (None: whole); dims
    past the spec are whole; every mesh axis the spec does not name holds
    a replica.  ``Sharding(mesh, ("dp",))`` is ``NamedSharding(mesh,
    P("dp"))``; ``Sharding(mesh, ())`` is ``NamedSharding(mesh, P())``."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        spec = tuple(spec)
        for a in spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} is not an axis of mesh "
                                 f"{mesh.shape}")
        named = [a for a in spec if a is not None]
        if len(named) != len(set(named)):
            raise ValueError(f"spec {spec} names an axis twice")
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"Sharding({self.mesh.shape}, {self.spec})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Sharding) and self.spec == other.spec
                and same_mesh(self.mesh, other.mesh))

    __hash__ = None

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.spec)

    def shard(self, tensor: torch.Tensor) -> "MeshTensor":
        """``tensor`` laid out on the mesh: each position's chunk on its
        device (one copy per device where positions share one)."""
        ndim = tensor.dim()
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-dim tensor")
        spec = _pad(self.spec, ndim)
        for d, a in enumerate(spec):
            if a is not None and tensor.shape[d] % self.mesh.shape[a]:
                raise ValueError(
                    f"dim {d} of size {tensor.shape[d]} not divisible by "
                    f"{a}={self.mesh.shape[a]}")
        cache: dict = {}
        tiles = {}
        for pos in self.mesh.positions:
            dev = self.mesh.devices[pos]
            key = (dev, tuple(pos[self.mesh.axis_index(a)] for a in spec
                              if a is not None))
            if key not in cache:
                cache[key] = _chunk(tensor, self.mesh, spec, pos).to(dev)
            tiles[pos] = cache[key]
        return MeshTensor(self.mesh, spec, tiles, tensor.shape)


def same_mesh(a: Mesh, b: Mesh) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat,
                                                     b.devices.flat)))


def place(tensor: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """Record ``sharding`` on ``tensor`` (a parameter): the layers that take
    it under a :class:`MeshTensor` slice it so.  Returns ``tensor``."""
    setattr(tensor, _PLACEMENT_ATTR, sharding)
    return tensor


def placement_of(tensor: torch.Tensor) -> Optional[Sharding]:
    return getattr(tensor, _PLACEMENT_ATTR, None)


def index_placed(tensor: torch.Tensor, i: int) -> torch.Tensor:
    """``tensor[i]`` (one slice of a stacked parameter), carrying the
    placement of the dims that remain."""
    out = tensor[i]
    pl = placement_of(tensor)
    if pl is not None and len(pl.spec) > 1:
        place(out, Sharding(pl.mesh, pl.spec[1:]))
    return out


def _pad(spec, ndim: int) -> Tuple[Optional[str], ...]:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _chunk(tensor: torch.Tensor, mesh: Mesh, spec, pos) -> torch.Tensor:
    for d, a in enumerate(spec):
        if a is None:
            continue
        n = mesh.shape[a]
        size = tensor.shape[d] // n
        tensor = tensor.narrow(d, pos[mesh.axis_index(a)] * size, size)
    return tensor


def _axis_group(mesh: Mesh, pos, axis: str) -> List[Tuple[int, ...]]:
    """The positions that differ from ``pos`` only along ``axis``, in
    order."""
    k = mesh.axis_index(axis)
    return [pos[:k] + (j,) + pos[k + 1:] for j in range(mesh.shape[axis])]


class MeshTensor:
    """One global tensor held as a tile per mesh position.

    ``shape`` is the global shape and ``spec`` (one entry per dim) names
    the mesh axis each dim is split over; ``tiles[pos]`` is position
    ``pos``'s chunk on ``mesh.devices[pos]``.  Positions along an axis the
    spec does not name hold replicas, which are the very same tensor where
    they share a device.  See the module's docstring for what runs how.
    """

    def __init__(self, mesh: Mesh, spec, tiles: Dict, shape):
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.spec = _pad(spec, len(self.shape))
        self.tiles = tiles

    # -- tensor-like attributes ------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self._first.dtype

    @property
    def device(self) -> torch.device:
        """The mesh's first device: where reductions and gathers land."""
        return self.mesh.owner

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def _first(self) -> torch.Tensor:
        return self.tiles[self.mesh.positions[0]]

    def dim(self) -> int:
        return len(self.shape)

    def size(self, d: Optional[int] = None):
        return self.shape if d is None else self.shape[d]

    def numel(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return (f"MeshTensor(shape={tuple(self.shape)}, spec={self.spec}, "
                f"mesh={self.mesh.shape}, dtype={self.dtype})")

    def local_shape(self) -> torch.Size:
        return self._first.shape

    # -- layout ----------------------------------------------------------
    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first
        device)."""
        device = self.mesh.owner if device is None else torch.device(device)
        dims = [d for d, a in enumerate(self.spec) if a is not None]
        if not dims:
            return self._first.to(device)
        sizes = [self.mesh.shape[self.spec[d]] for d in dims]
        grid = np.empty(sizes, dtype=object)
        for idx in np.ndindex(*sizes):
            pos = [0] * len(self.mesh.axis_names)
            for d, j in zip(dims, idx):
                pos[self.mesh.axis_index(self.spec[d])] = j
            grid[idx] = self.tiles[tuple(pos)].to(device)

        def cat(sub, k):
            if k == len(dims):
                return sub[()] if isinstance(sub, np.ndarray) else sub
            return torch.cat([cat(sub[j], k + 1) for j in range(sizes[k])],
                             dim=dims[k])

        return cat(grid, 0)

    def all_gather(self, dims) -> "MeshTensor":
        """Every position gets the whole of ``dims`` (an int or a sequence)
        on its device: the all-gather."""
        dims = [dims] if isinstance(dims, int) else list(dims)
        out = self
        for d in dims:
            d %= out.ndim
            a = out.spec[d]
            if a is None:
                continue
            mesh, cache, tiles = out.mesh, {}, {}
            for pos in mesh.positions:
                dev = mesh.devices[pos]
                group = [out.tiles[q] for q in _axis_group(mesh, pos, a)]
                key = (dev, *map(id, group))
                if key not in cache:
                    cache[key] = torch.cat([t.to(dev) for t in group], dim=d)
                tiles[pos] = cache[key]
            spec = list(out.spec)
            spec[d] = None
            out = MeshTensor(mesh, spec, tiles, out.shape)
        return out

    def reshard(self, spec) -> "MeshTensor":
        """This tensor with ``spec``: dims newly split are narrowed (no
        communication), dims no longer split are all-gathered."""
        spec = _pad(spec, self.ndim)
        out = self.all_gather([d for d in range(self.ndim)
                               if self.spec[d] is not None
                               and self.spec[d] != spec[d]])
        new = [d for d in range(self.ndim)
               if spec[d] is not None and out.spec[d] is None]
        if not new:
            return out
        mesh, cache, tiles = out.mesh, {}, {}
        only = tuple(spec[d] if d in new else None for d in range(self.ndim))
        for d in new:
            if self.shape[d] % mesh.shape[spec[d]]:
                raise ValueError(f"dim {d} of size {self.shape[d]} not "
                                 f"divisible by {spec[d]}")
        for pos in mesh.positions:
            t = out.tiles[pos]
            key = (id(t), tuple(pos[mesh.axis_index(spec[d])] for d in new))
            if key not in cache:
                # chunk the local tile: its size along d is the global one
                cache[key] = _chunk(t, mesh, only, pos)
            tiles[pos] = cache[key]
        return MeshTensor(mesh, spec, tiles, self.shape)

    def take(self, axis: str, j: int) -> "MeshTensor":
        """The tiles at index ``j`` of ``axis`` (an axis this tensor is
        replicated over), as a tensor on that slice of the mesh."""
        if axis in self.spec:
            raise ValueError(f"take over {axis!r}, which splits dim "
                             f"{self.spec.index(axis)}")
        k = self.mesh.axis_index(axis)
        sub = self.mesh.take(axis, j)
        tiles = {pos: self.tiles[pos[:k] + (j,) + pos[k:]]
                 for pos in sub.positions}
        return MeshTensor(sub, self.spec, tiles, self.shape)

    def broadcast(self, mesh: Mesh, axis: str) -> "MeshTensor":
        """The inverse of :meth:`take`: every position of ``mesh`` along
        ``axis`` gets this tensor's tile on its own device."""
        k = mesh.axis_index(axis)
        cache, tiles = {}, {}
        for pos in mesh.positions:
            dev = mesh.devices[pos]
            t = self.tiles[pos[:k] + pos[k + 1:]]
            key = (id(t), dev)
            if key not in cache:
                cache[key] = t.to(dev)
            tiles[pos] = cache[key]
        return MeshTensor(mesh, self.spec, tiles, self.shape)

    def moved_to(self, mesh: Mesh) -> "MeshTensor":
        """This tensor on ``mesh`` (of the same axes and shape): each tile
        to the device of its position there."""
        cache, tiles = {}, {}
        for pos in mesh.positions:
            dev = mesh.devices[pos]
            t = self.tiles[pos]
            key = (id(t), dev)
            if key not in cache:
                cache[key] = t.to(dev)
            tiles[pos] = cache[key]
        return MeshTensor(mesh, self.spec, tiles, self.shape)

    def split_batch(self, n: int) -> List["MeshTensor"]:
        """``n`` equal pieces along dim 0, each tile split locally (piece
        ``m`` holds rows ``m`` of every position's chunk)."""
        local = self.local_shape()[0]
        if local % n:
            raise ValueError(f"local batch {local} not divisible by {n}")
        parts = _map(lambda t: t.reshape(n, local // n, *t.shape[1:]),
                     (self,), {}, spec=(None,) + self.spec, raw=True)
        shape = (self.shape[0] // n,) + tuple(self.shape[1:])
        return [MeshTensor(self.mesh, self.spec,
                           {p: t[m] for p, t in parts.items()}, shape)
                for m in range(n)]

    @staticmethod
    def cat_batch(parts: Sequence["MeshTensor"]) -> "MeshTensor":
        """The inverse of :meth:`split_batch`."""
        first = parts[0]
        cache, tiles = {}, {}
        for pos in first.mesh.positions:
            group = [p.tiles[pos] for p in parts]
            key = tuple(map(id, group))
            if key not in cache:
                cache[key] = torch.cat(group, dim=0)
            tiles[pos] = cache[key]
        shape = (sum(p.shape[0] for p in parts),) + tuple(first.shape[1:])
        return MeshTensor(first.mesh, first.spec, tiles, shape)

    # -- torch protocol --------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in LOCAL_OPS:
            return _map(func, args, kwargs)
        if name in ("mean", "sum"):
            return _reduce(name, *args, **kwargs)
        if name in ("softmax", "log_softmax", "cat", "concat",
                    "concatenate", "repeat_interleave"):
            return _dim_local(func, name, args, kwargs)
        return _fallback(func, args, kwargs)

    def __getattr__(self, name):
        # Tensor methods not defined here go through the torch protocol
        if name.startswith("_") or not hasattr(torch.Tensor, name):
            raise AttributeError(name)
        method = getattr(torch.Tensor, name)
        return lambda *a, **k: MeshTensor.__torch_function__(
            method, (MeshTensor,), (self,) + a, k)

    def to(self, *args, **kwargs) -> "MeshTensor":
        """A dtype conversion, tile by tile (the tiles stay where they
        are)."""
        for v in list(args) + list(kwargs.values()):
            if isinstance(v, (torch.device, str)):
                raise ValueError("MeshTensor.to takes a dtype; use gather() "
                                 "or moved_to() to change devices")
        return _map(torch.Tensor.to, (self,) + args, kwargs)

    def reshape(self, *shape) -> "MeshTensor":
        shape = tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list, torch.Size)) else tuple(shape)
        shape = _resolve_shape(shape, self.numel())
        spec = _reshape_spec(self.shape, self.spec, shape, self.mesh)
        if spec is None:
            return _fallback(torch.Tensor.reshape, (self, shape), {})
        local = tuple(s // self.mesh.shape[a] if a else s
                      for s, a in zip(shape, spec))
        return _map(lambda t: t.reshape(local), (self,), {}, spec=spec,
                    shape=shape)

    view = reshape

    def permute(self, *dims) -> "MeshTensor":
        dims = tuple(dims[0]) if len(dims) == 1 and isinstance(
            dims[0], (tuple, list)) else tuple(dims)
        dims = tuple(d % self.ndim for d in dims)
        return _map(lambda t: t.permute(dims), (self,), {},
                    spec=tuple(self.spec[d] for d in dims),
                    shape=tuple(self.shape[d] for d in dims))

    def __getitem__(self, index):
        index = index if isinstance(index, tuple) else (index,)
        n_used = sum(1 for i in index if i is not None and i is not Ellipsis)
        if any(isinstance(i, (torch.Tensor, list)) for i in index) or \
                sum(i is Ellipsis for i in index) > 1:
            return _fallback(torch.Tensor.__getitem__, (self, index), {})
        full = []
        for i in index:
            if i is Ellipsis:
                full.extend([slice(None)] * (self.ndim - n_used))
            else:
                full.append(i)
        full.extend([slice(None)] * (self.ndim - sum(
            1 for i in full if i is not None)))
        src = self
        d, spec = 0, []
        for i in full:
            if i is None:
                spec.append(None)
                continue
            if src.spec[d] is not None and i != slice(None):
                src = src.all_gather(d)
            if not isinstance(i, int):
                spec.append(src.spec[d])
            d += 1
        return _map(lambda t: t[tuple(full)], (src,), {}, spec=tuple(spec))

    # -- layers ----------------------------------------------------------
    def apply_layer(self, module) -> "MeshTensor":
        """``module(self)`` for the layers of ``models/common.py`` whose
        math reaches across tiles or whose weight may be placed over tp."""
        from ..models.common import Conv, Dense, GroupNorm

        if isinstance(module, Conv):
            return _conv(self, module)
        if isinstance(module, Dense):
            return _dense(self, module)
        if isinstance(module, GroupNorm):
            return _group_norm(self, module)
        raise TypeError(f"no mesh rule for {type(module).__name__}")


def _binary_dunder(name):
    method = getattr(torch.Tensor, name)

    def op(self, other):
        return _map(method, (self, other), {})

    op.__name__ = name
    return op


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__pow__",
              "__rpow__", "__ge__", "__gt__", "__le__", "__lt__"):
    setattr(MeshTensor, _name, _binary_dunder(_name))
MeshTensor.__neg__ = lambda self: _map(torch.Tensor.__neg__, (self,), {})
MeshTensor.__abs__ = lambda self: _map(torch.Tensor.__abs__, (self,), {})


# --------------------------------------------------------------------------
# the op rules
# --------------------------------------------------------------------------

def _mesh_args(args, kwargs) -> List[MeshTensor]:
    out = []
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, MeshTensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, MeshTensor))
    return out


def _replace(v, pos, dev, ref: MeshTensor, swap):
    if isinstance(v, MeshTensor):
        return swap.get(id(v), v).tiles[pos]
    if isinstance(v, torch.Tensor):
        return _local_plain(v, ref, pos).to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(_replace(x, pos, dev, ref, swap) for x in v)
    return v


def _local_plain(t: torch.Tensor, ref: MeshTensor, pos) -> torch.Tensor:
    """A plain operand against a sharded one: a dim (aligned from the
    right, as broadcasting aligns them) of the global size along a split
    dim is chunked as the sharded operand is; size-1 dims broadcast."""
    off = ref.ndim - t.dim()
    for d, a in enumerate(ref.spec):
        k = d - off
        if a is None or k < 0 or t.shape[k] == 1:
            continue
        if t.shape[k] != ref.shape[d]:
            raise ValueError(f"plain operand of shape {tuple(t.shape)} "
                             f"against sharded {tuple(ref.shape)}")
        n = ref.mesh.shape[a]
        size = t.shape[k] // n
        t = t.narrow(k, pos[ref.mesh.axis_index(a)] * size, size)
    return t


def _map(fn, args, kwargs, spec=None, shape=None, raw=False):
    """``fn`` on every position's tiles, once per distinct set of input
    tiles and device.  The operands' layouts are made to agree first (a
    dim split in one and whole in another is gathered)."""
    mts = _mesh_args(args, kwargs)
    ref = mts[0]
    mesh = ref.mesh
    for m in mts[1:]:
        if not same_mesh(m.mesh, mesh):
            raise ValueError(f"operands on meshes {m.mesh.shape} and "
                             f"{mesh.shape}")
    swap = {}
    if any(m.spec != ref.spec for m in mts):
        ndim = max(m.ndim for m in mts)
        specs = [(None,) * (ndim - m.ndim) + m.spec for m in mts]
        keep = [s[0] if all(x[d] == s[0] for x in specs) else None
                for d, s in enumerate(zip(*specs))]
        for m, s in zip(mts, specs):
            drop = [d - (ndim - m.ndim) for d in range(ndim)
                    if s[d] is not None and keep[d] is None]
            if drop:
                swap[id(m)] = m.all_gather(drop)
        ref = max((swap.get(id(m), m) for m in mts), key=lambda m: m.ndim)
    cache, tiles = {}, {}
    for pos in mesh.positions:
        dev = mesh.devices[pos]
        key = (dev, *(id(swap.get(id(m), m).tiles[pos]) for m in mts))
        if key not in cache:
            cache[key] = fn(*_replace(args, pos, dev, ref, swap),
                            **{k: _replace(v, pos, dev, ref, swap)
                               for k, v in kwargs.items()})
        tiles[pos] = cache[key]
    if raw:
        return tiles
    out = tiles[mesh.positions[0]]
    if not isinstance(out, torch.Tensor):
        return out
    spec = _pad(ref.spec if spec is None else spec, out.dim())
    if shape is None:
        shape = tuple(s * (mesh.shape[a] if a else 1)
                      for s, a in zip(out.shape, spec))
    return MeshTensor(mesh, spec, tiles, shape)


def _fallback(func, args, kwargs):
    """Gather every sharded operand onto the mesh's first device and run
    ``func`` there on plain tensors."""
    def plain(v):
        if isinstance(v, MeshTensor):
            return v.gather()
        if isinstance(v, (list, tuple)):
            return type(v)(plain(x) for x in v)
        return v

    return func(*plain(args), **{k: plain(v) for k, v in kwargs.items()})


def _dim_arg(name, args, kwargs):
    if "dim" in kwargs:
        return kwargs["dim"]
    i = 2 if name == "repeat_interleave" else 1
    return args[i] if len(args) > i else None


def _dim_local(func, name, args, kwargs):
    """An op along one dim: tile by tile unless that dim is split."""
    dim = _dim_arg(name, args, kwargs)
    mts = _mesh_args(args, kwargs)
    if dim is None:
        return _fallback(func, args, kwargs)
    dim %= mts[0].ndim
    if name == "repeat_interleave" and not isinstance(args[1], int):
        return _fallback(func, args, kwargs)
    if name != "repeat_interleave" and any(m.spec[dim] for m in mts):
        return _fallback(func, args, kwargs)
    return _map(func, args, kwargs)


def _reduce(name, m: MeshTensor, dim=None, keepdim=False, dtype=None):
    """``mean`` / ``sum``: over everything, a plain tensor on the mesh's
    first device (the tiles' sums in a fixed order, over the global count);
    over dims, a :class:`MeshTensor` whose split reduced dims add up their
    tiles' partial sums."""
    mesh = m.mesh
    mean = name == "mean"
    if dim is None:
        if not any(m.spec):
            t = m._first
            out = t.mean(dtype=dtype) if mean else t.sum(dtype=dtype)
            return out.to(mesh.owner)
        named = [a for a in m.spec if a is not None]
        reps = [p for p in mesh.positions
                if all(p[mesh.axis_index(a)] == 0
                       for a in mesh.axis_names if a not in named)]
        total = sum(m.tiles[p].sum(dtype=dtype).to(mesh.owner)
                    for p in reps)
        return total / m.numel() if mean else total
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = tuple(sorted(d % m.ndim for d in dims))
    split = [m.spec[d] for d in dims if m.spec[d] is not None]
    if not split:
        return _map(lambda t: (t.mean if mean else t.sum)(
            dim=dims, keepdim=keepdim, **({"dtype": dtype} if dtype else {})),
            (m,), {}, spec=_drop(m.spec, dims, keepdim))
    parts = _map(lambda t: t.sum(dim=dims, keepdim=True,
                                 **({"dtype": dtype} if dtype else {})),
                 (m,), {}, raw=True)
    count = math.prod(m.shape[d] for d in dims)
    cache, tiles = {}, {}
    for pos in mesh.positions:
        dev = mesh.devices[pos]
        group = [pos]
        for a in split:
            group = [q for g in group for q in _axis_group(mesh, g, a)]
        key = (dev, *(id(parts[q]) for q in group))
        if key not in cache:
            total = sum(parts[q].to(dev) for q in group)
            if mean:
                total = total / count
            cache[key] = total if keepdim else total.squeeze(dims)
        tiles[pos] = cache[key]
    spec = _drop(m.spec, dims, keepdim)
    shape = [1 if d in dims else s for d, s in enumerate(m.shape)]
    if not keepdim:
        shape = [s for d, s in enumerate(shape) if d not in dims]
    return MeshTensor(mesh, spec, tiles, shape)


def _drop(spec, dims, keepdim):
    if keepdim:
        return tuple(None if d in dims else a for d, a in enumerate(spec))
    return tuple(a for d, a in enumerate(spec) if d not in dims)


def _resolve_shape(shape, numel: int):
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(numel // known if s == -1 else s for s in shape)
    return tuple(int(s) for s in shape)


def _reshape_spec(old, spec, new, mesh: Mesh):
    """Where each split dim of ``old`` goes under a reshape to ``new``: to
    the dim that starts at the same flat offset and of which it is the
    major part (merged with the dims after it, or split into leading
    pieces).  None where no such dim exists."""
    out = [None] * len(new)
    for d, a in enumerate(spec):
        if a is None:
            continue
        pre = math.prod(old[:d])
        j = next((j for j in range(len(new))
                  if math.prod(new[:j]) == pre), None)
        n = mesh.shape[a]
        if j is None or new[j] % n or not (new[j] % old[d] == 0
                                           or old[d] % new[j] == 0):
            return None
        out[j] = a
    return tuple(out)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _out_axis(weight: torch.Tensor, mesh: Mesh, dim: int = 0):
    """The mesh axis the weight's output-feature dim is placed over, when
    that axis is in ``mesh`` (else None: the layer is replicated)."""
    pl = placement_of(weight)
    if pl is None or len(pl.spec) <= dim:
        return None
    a = pl.spec[dim]
    return a if a in mesh.axis_names and mesh.shape[a] > 1 else None


def _weight_slices(mesh: Mesh, axis, tensors):
    """Per position: each tensor's slice along dim 0 for the position's
    index on ``axis`` (all of it when ``axis`` is None), on its device."""
    cache, out = {}, {}
    for pos in mesh.positions:
        dev = mesh.devices[pos]
        j = pos[mesh.axis_index(axis)] if axis else 0
        key = (dev, j)
        if key not in cache:
            parts = []
            for t in tensors:
                if t is not None and axis:
                    size = t.shape[0] // mesh.shape[axis]
                    t = t.narrow(0, j * size, size)
                parts.append(None if t is None else t.to(dev))
            cache[key] = (j, parts)
        out[pos] = cache[key]
    return out


def _rows(m: MeshTensor, pos, lo: int, hi: int, dev):
    """Global rows ``[lo, hi)`` of the row tiles in ``pos``'s column of
    the mesh, zeros past the global edges, on ``dev``."""
    a = m.spec[1]
    k = m.mesh.axis_index(a)
    h = m.shape[1] // m.mesh.shape[a]
    ref = m.tiles[pos]
    pieces = []
    if lo < 0:
        pieces.append(ref.new_zeros((ref.shape[0], -lo) + tuple(
            ref.shape[2:])).to(dev))
    for j in range(max(lo, 0) // h, (min(hi, m.shape[1]) - 1) // h + 1):
        a0, a1 = max(lo, j * h), min(hi, (j + 1) * h)
        if a1 <= a0:
            continue
        t = m.tiles[pos[:k] + (j,) + pos[k + 1:]]
        pieces.append(t[:, a0 - j * h:a1 - j * h].to(dev))
    if hi > m.shape[1]:
        pieces.append(ref.new_zeros((ref.shape[0], hi - m.shape[1]) + tuple(
            ref.shape[2:])).to(dev))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def _conv(m: MeshTensor, conv) -> MeshTensor:
    """A ``Conv`` on an NHWC :class:`MeshTensor`: rows split over an sp
    axis take their window's rows from the neighbouring tiles (zeros past
    the global edges: the whole image's 'SAME' padding); a weight placed
    over tp gives each tp position its slice of output channels, joined
    after (the all-gather)."""
    if m.spec[2] is not None or m.spec[3] is not None:
        m = m.all_gather([2, 3])
    mesh = m.mesh
    kh = conv.kernel_size[0]
    sh = conv.stride[0]
    rows = m.spec[1]
    H = m.shape[1]
    if rows is not None:
        h = H // mesh.shape[rows]
        if h % sh:
            raise ValueError(f"row tiles of {h} rows for a stride-{sh} conv")
        if conv.same_by_size:
            top = max((-(-H // sh) - 1) * sh + kh - H, 0) // 2
        else:
            top = kh // 2
        below = kh - sh - top
    axis = _out_axis(conv.weight, mesh)
    slices = _weight_slices(mesh, axis, (conv.weight, conv.bias))
    ext_cache, cache, tiles = {}, {}, {}
    for pos in mesh.positions:
        dev = mesh.devices[pos]
        x = m.tiles[pos]
        if rows is not None:
            k = mesh.axis_index(rows)
            r0 = pos[k] * h
            ekey = (dev, pos[k], *(id(m.tiles[pos[:k] + (j,) + pos[k + 1:]])
                                   for j in range(mesh.shape[rows])))
            if ekey not in ext_cache:
                ext_cache[ekey] = _rows(m, pos, r0 - top, r0 + h + below, dev)
            x = ext_cache[ekey]
        j, (w, b) = slices[pos]
        key = (dev, id(x), j)
        if key not in cache:
            cache[key] = conv.conv_nhwc(x, w, b, rows_padded=rows is not None)
        tiles[pos] = cache[key]
    out0 = tiles[mesh.positions[0]]
    ho = -(-H // sh) if conv.same_by_size else H
    shape = (m.shape[0], ho, out0.shape[2], conv.weight.shape[0])
    out = MeshTensor(mesh, (m.spec[0], rows, None, axis), tiles, shape)
    return out.all_gather(3) if axis else out


def _dense(m: MeshTensor, dense) -> MeshTensor:
    """A ``Dense`` on a :class:`MeshTensor`: per position, its tp slice of
    output features, joined after."""
    if m.spec[-1] is not None:
        m = m.all_gather(m.ndim - 1)
    axis = _out_axis(dense.weight, m.mesh)
    slices = _weight_slices(m.mesh, axis, (dense.weight, dense.bias))
    cache, tiles = {}, {}
    for pos in m.mesh.positions:
        dev = m.mesh.devices[pos]
        j, (w, b) = slices[pos]
        x = m.tiles[pos]
        key = (dev, id(x), j)
        if key not in cache:
            cache[key] = dense.linear(x, w, b)
        tiles[pos] = cache[key]
    shape = tuple(m.shape[:-1]) + (dense.weight.shape[0],)
    out = MeshTensor(m.mesh, m.spec[:-1] + (axis,), tiles, shape)
    return out.all_gather(m.ndim - 1) if axis else out


def _group_norm(m: MeshTensor, gn) -> MeshTensor:
    """A ``GroupNorm`` (statistics over H, W and a channel group): the
    split H/W/C dims are gathered first, the result split again."""
    spec = m.spec
    whole = m.all_gather([d for d in range(1, m.ndim) if spec[d]])
    out = _map(lambda t: F.group_norm(
        t.permute(0, 3, 1, 2), gn.num_groups, gn.weight.to(t.device),
        gn.bias.to(t.device), gn.eps).permute(0, 2, 3, 1), (whole,), {})
    return out.reshard(spec)


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree
