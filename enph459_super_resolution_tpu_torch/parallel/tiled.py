"""Spatially-sharded (tiled) image processing with halo exchange.

Counterpart of ``enph459_super_resolution_tpu/parallel/tiled.py``: the
image plane is split over the spatial axes of a :class:`~.mesh.Mesh`, each
tile is extended by overlap halos copied from its neighbours, computed on
its own device, and only its interior is kept.

The reference runs one ``shard_map`` body per device and moves the halos
with ``ppermute``.  Here one Python process holds the whole grid of tiles
(a numpy object array, one tensor per mesh position, each on that
position's device), :func:`halo_exchange` copies each neighbour's edge
slice to the tile's device (a peer copy between cards, a slice copy on one
card), and the per-tile body runs in a loop over the tiles.  Kernels on
different cards overlap, since each launch returns before its card
finishes.  The reference's ``jnp.where(axis_index == edge, ...)`` fixups
are plain Python branches on the tile's grid index.  Every extended tile is
a fresh tensor (``torch.cat``), so no tile is a view of its neighbour.

Consumers:
  * :func:`tiled_apply` -- one-shot tiled evaluation of a shift-invariant
    local op (e.g. a conv-trunk SR model) whose receptive-field radius is
    covered by the halo: exact away from the global edges.
  * :func:`sharded_ibp` -- the classical IBP loop with a per-iteration halo
    refresh.  One iteration's influence radius is bounded (PSF + spline
    kernels), so refreshing the halos at the top of every iteration keeps
    every tile equal to the unsharded solve to float tolerance, the global
    edges included.

Both take a 1-D (rows) or 2-D (rows x columns) spatial mesh: ``sp_axis=
("sp", "spw")`` shards H over ``sp`` and W over ``spw`` (``sr.run --sp
4x2``).  The W exchange ships columns of the already H-extended tiles, so
the corner blocks arrive through the lateral neighbour.

Boundary semantics, as in the reference: :func:`tiled_apply` fills the
global edges' halos by edge replication or zeros (``edge_mode``).
:func:`sharded_ibp` reproduces the unsharded solve's boundary condition at
each stage: zero padding for the PSF convolutions, SciPy-'nearest'
extension of the *blurred* grid for the forward shift, 'nearest' extension
of the *zero-stuffed* error grid for the back-projection shift.  So the
edge tiles patch their halos between stages, H before W, which makes the
corner halo the replicated corner pixel (SciPy's separable 'nearest').
What remains is the 'nearest' extension's switch from replication to
reflection 25 samples past the edge (``ops.resample.spline_shift`` pre-pads
12 edge values, as SciPy and the reference do), which re-enters through
the spline prefilter's tail at |sqrt(3)-2|^25 ~ 1e-15: below f32 epsilon.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.conv import conv2d_same, correlate2d_same
from ..ops.resample import spline_shift
from ..sr.classical import (SOLVERS, _prepare, _to_host, native_upsample,
                            shift_and_add)
from .mesh import Mesh

SpAxes = Union[str, Sequence[str]]


def _sp_tuple(sp_axis: SpAxes) -> Tuple[str, ...]:
    axes = (sp_axis,) if isinstance(sp_axis, str) else tuple(sp_axis)
    if not 1 <= len(axes) <= 2:
        raise ValueError(f"sp_axis must name 1 or 2 mesh axes, got {axes}")
    return axes


def tile_devices(mesh: Mesh, sp_axes: Sequence[str]) -> np.ndarray:
    """The device of each tile: an object array shaped by the sizes of
    ``sp_axes``; a mesh's other axes are taken at position 0."""
    missing = [a for a in sp_axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"mesh {mesh.shape} has no axis {missing}")
    nsp = tuple(mesh.shape[a] for a in sp_axes)
    out = np.empty(nsp, dtype=object)
    for pos in np.ndindex(*nsp):
        idx = [0] * len(mesh.axis_names)
        for name, i in zip(sp_axes, pos):
            idx[mesh.axis_names.index(name)] = i
        out[pos] = mesh.devices[tuple(idx)]
    return out


def shard(x: torch.Tensor, dims: Sequence[int],
          devices: np.ndarray) -> np.ndarray:
    """Split ``x`` evenly along ``dims`` (one per axis of ``devices``) into
    a grid of tiles, each a fresh contiguous tensor on its device."""
    grid = np.empty(devices.shape, dtype=object)
    for pos in np.ndindex(*devices.shape):
        t = x
        for d, i, n in zip(dims, pos, devices.shape):
            size = x.shape[d] // n
            t = t.narrow(d, i * size, size)
        grid[pos] = t.to(device=devices[pos], copy=True,
                         memory_format=torch.contiguous_format)
    return grid


def unshard(tiles: np.ndarray, dims: Sequence[int],
            device) -> torch.Tensor:
    """Stitch a grid of tiles along ``dims`` into one tensor on
    ``device``."""
    def cat(sub: np.ndarray, k: int) -> torch.Tensor:
        if k == len(dims) - 1:
            parts = [t.to(device, non_blocking=True) for t in sub]
        else:
            parts = [cat(sub[i], k + 1) for i in range(sub.shape[0])]
        return torch.cat(parts, dim=dims[k])

    return cat(tiles, 0)


def halo_exchange(tiles: np.ndarray, halo: int, grid_axis: int = 0,
                  axis: int = 0, edge_mode: str = "edge") -> np.ndarray:
    """Extend every tile of the grid with ``halo`` slices along tensor dim
    ``axis`` from each neighbour along grid axis ``grid_axis``; the global
    edges get edge-replicated slices (``edge_mode='edge'``, SciPy-style
    boundary for the classical ops) or zeros (``'zero'``, SAME-conv
    semantics for NN trunks).

    Each tile (..., T, ...) becomes a new tensor (..., halo + T + halo, ...)
    on its own device.  For a 2-D grid call once per grid axis: the second
    exchange ships slices of the already-extended tiles, which carries the
    corner blocks.
    """
    if edge_mode not in ("edge", "zero"):
        raise ValueError(f"edge_mode {edge_mode!r}: use 'edge' or 'zero'")
    n = tiles.shape[grid_axis]
    out = np.empty(tiles.shape, dtype=object)
    for pos in np.ndindex(*tiles.shape):
        x = tiles[pos]
        ax = axis % x.dim()
        size = x.shape[ax]
        if halo > size:
            raise ValueError(
                f"halo ({halo}) exceeds tile extent ({size}) along the "
                f"sharded axis; use fewer devices or a larger image")
        i = pos[grid_axis]

        def neighbour(j: int) -> torch.Tensor:
            p = list(pos)
            p[grid_axis] = j
            return tiles[tuple(p)]

        # the previous tile's bottom rows -> my top halo, the next tile's
        # top rows -> my bottom halo
        if i > 0:
            top = neighbour(i - 1).narrow(ax, size - halo, halo)
            top = top.to(x.device, non_blocking=True)
        elif edge_mode == "zero":
            top = x.new_zeros(x.shape[:ax] + (halo,) + x.shape[ax + 1:])
        else:
            top = _rep_slice(x, 0, halo, ax)
        if i < n - 1:
            bot = neighbour(i + 1).narrow(ax, 0, halo)
            bot = bot.to(x.device, non_blocking=True)
        elif edge_mode == "zero":
            bot = x.new_zeros(x.shape[:ax] + (halo,) + x.shape[ax + 1:])
        else:
            bot = _rep_slice(x, size - 1, halo, ax)
        out[pos] = torch.cat([top, x, bot], dim=ax)
    return out


def tiled_apply(fn: Callable, img, mesh: Mesh, halo: int,
                sp_axis: SpAxes = "sp", axis=-2, out_scale: int = 1,
                edge_mode: str = "edge") -> torch.Tensor:
    """Apply a local op to a spatially-sharded image, exactly.

    Args:
      fn: shift-invariant local function (tile -> tile, same leading dims),
        called on each extended tile on its device; its receptive-field
        radius must be <= ``halo``.  If it upsamples by ``out_scale``,
        output tiles are ``T * out_scale`` tall.
      img: full image (..., H, W); sharded dims divisible by their axis.
      mesh: mesh holding the ``sp_axis`` axes.
      halo: overlap in *input* pixels (same for both axes when 2-D).
      sp_axis: one mesh-axis name (shard ``axis``) or two (shard ``axis``
        and ``axis + 1``: H x W tiling with corner exchange).
      axis: the (first) spatial dim of ``img``.

    Returns the full output, interiors stitched, on the mesh's first
    device.
    """
    sp_axes = _sp_tuple(sp_axis)
    img = torch.as_tensor(img)
    ax0 = axis % img.dim()
    dims = tuple(ax0 + k for k in range(len(sp_axes)))
    for d, name in zip(dims, sp_axes):
        nsp = mesh.shape[name]
        if img.shape[d] % nsp != 0:
            raise ValueError(
                f"dim {d} ({img.shape[d]}) not divisible by {name}={nsp}")
    devices = tile_devices(mesh, sp_axes)
    tiles = shard(img, dims, devices)
    ext = tiles
    for k, d in enumerate(dims):
        ext = halo_exchange(ext, halo, k, d, edge_mode)
    out = np.empty(tiles.shape, dtype=object)
    for pos in np.ndindex(*tiles.shape):
        y = fn(ext[pos])
        for d in dims:
            y = y.narrow(d, halo * out_scale, tiles[pos].shape[d] * out_scale)
        out[pos] = y
    return unshard(out, dims, mesh.devices.flat[0])


def _patch_halos(x: torch.Tensor, halo: int, idx: int, nsp: int, top_blk,
                 bot_blk, axis: int = 0) -> torch.Tensor:
    """Replace the outer ``halo`` slices along ``axis`` with the given
    blocks, but only on the tiles holding a global edge (``idx == 0`` /
    ``idx == nsp - 1``).  Interior tiles keep their exchanged neighbour
    slices untouched."""
    size = x.shape[axis]
    if idx == 0:
        x = torch.cat([top_blk, x.narrow(axis, halo, size - halo)],
                      dim=axis)
    if idx == nsp - 1:
        x = torch.cat([x.narrow(axis, 0, size - halo), bot_blk], dim=axis)
    return x


def _rep_slice(x: torch.Tensor, pos: int, halo: int,
               axis: int = 0) -> torch.Tensor:
    """``halo`` copies of slice ``pos`` along ``axis`` -- SciPy-'nearest'
    edge extension (a broadcast view; the caller's ``cat`` copies it)."""
    sl = x.narrow(axis, pos, 1)
    shape = list(sl.shape)
    shape[axis] = halo
    return sl.expand(shape)


def _interior(x: torch.Tensor, halo: int, ext: Sequence[int]):
    """The interior of an extended tile: ``ext[k]`` slices after ``halo``
    along each of the trailing ``len(ext)`` spatial axes (H, then W)."""
    for k, n in enumerate(ext):
        x = x.narrow(k - 2, halo, n)
    return x


def sharded_ibp(lr_stack, hr_init, psf: np.ndarray, shifts_yx, mesh: Mesh,
                factor: int = 2, n_iter: int = 80, step: float = 0.5,
                halo_lr: int = 32, sp_axis: SpAxes = "sp",
                clip=(0.0, 255.0), solver: str = "ibp"):
    """Classical IBP with the image plane sharded over ``sp_axis``.

    Per iteration and per tile: refresh the HR tile's halo from its
    neighbours (``halo_lr * factor`` rows per side and sharded axis), run
    one IBP update on the extended tile, keep the interior.  One
    iteration's support radius (7x7 PSF + ~19-tap spline-phase kernels,
    twice) is well under ``halo_lr * factor``, so interiors match the
    unsharded solve to float tolerance.  The monitored MSE is the mean over
    each tile's interior, averaged over the tiles (all of one size): the
    unsharded per-iteration MSE.

    ``sp_axis`` may name one mesh axis (H strips) or two (``("sp",
    "spw")``: H x W tiles with corner exchange).

    Global-edge exactness: the unsharded iteration
    (``mono_barcodes/run_sr.py:221-240`` semantics) applies a different
    boundary prior at each stage, so the edge tiles patch their halo slices
    between stages (:func:`_patch_halos`): zeros before the blur, the
    replicated true edge slice of the blurred grid before the forward
    shift, the replicated true edge slice of the stuffed grid before the
    backward shift, and zeros again before the final correlation; patching
    H before W realizes SciPy's separable 'nearest' corner.  The sharded
    solve matches the single-device one over the FULL array, edges and
    corners included.

    ``solver='adjoint'`` replaces the heuristic back-projection with the
    TRUE adjoint of the per-tile patched forward (``torch.func.vjp``; step
    ~2.0 is stable).  An interior HR pixel's adjoint row draws only on LR
    samples within the operator support (much less than the halo), all in
    the extended tile, and each HR pixel is owned by exactly one tile's
    interior, so the interior of the local vjp is the global adjoint,
    edges included (the vjp transposes the same halo patches the forward
    applies).  The vjp seed is the error with the global edges' phantom LR
    samples (beyond the sensor) zeroed.

    Args:
      lr_stack: (N, h, w) registered LR frames (numpy or torch).
      hr_init: (h*factor, w*factor) seed (e.g. SAA output).
      halo_lr: halo in LR pixels (``halo_lr * factor`` on the HR grid).

    Returns (hr, mse_history[n_iter]): tensors on the mesh's first device.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r}: use one of {SOLVERS}")
    shifts_key = tuple((float(a), float(b)) for a, b in shifts_yx)
    psf = np.asarray(psf, dtype=np.float64)
    sp_axes = _sp_tuple(sp_axis)
    ks = range(len(sp_axes))
    nsp = [mesh.shape[a] for a in sp_axes]
    lr_stack = torch.as_tensor(lr_stack)
    hr_init = torch.as_tensor(hr_init)
    n_frames = lr_stack.shape[-3]
    for k in ks:
        dim = lr_stack.shape[-2 + k]
        if dim % nsp[k] != 0:
            raise ValueError(
                f"LR dim {dim} not divisible by {sp_axes[k]}={nsp[k]}")
    halo_hr = halo_lr * factor
    t_lr = [lr_stack.shape[-2 + k] // nsp[k] for k in ks]
    t_hr = [t * factor for t in t_lr]
    dims_lr = [lr_stack.dim() - 2 + k for k in ks]
    dims_hr = [hr_init.dim() - 2 + k for k in ks]
    devices = tile_devices(mesh, sp_axes)
    first = mesh.devices.flat[0]

    lr_ext = shard(lr_stack, dims_lr, devices)
    for k in ks:
        lr_ext = halo_exchange(lr_ext, halo_lr, k, dims_lr[k])
    hr_tiles = shard(hr_init, dims_hr, devices)

    def nearest_patch(x, idx):
        # replicated true-edge slices, H before W: the W pass copies the
        # already-patched rows, making the corner halo the replicated
        # corner pixel (SciPy separable 'nearest')
        for k in ks:
            ax = k - 2
            x = _patch_halos(x, halo_hr, idx[k], nsp[k],
                             _rep_slice(x, halo_hr, halo_hr, ax),
                             _rep_slice(x, halo_hr + t_hr[k] - 1, halo_hr,
                                        ax), axis=ax)
        return x

    def zero_patch(x, halo: int, idx):
        for k in ks:
            if 0 < idx[k] < nsp[k] - 1:
                continue
            ax = k - 2
            z = x.new_zeros(x.shape[:x.dim() + ax] + (halo,)
                            + x.shape[x.dim() + ax + 1:])
            x = _patch_halos(x, halo, idx[k], nsp[k], z, z, axis=ax)
        return x

    def forward(hr_ext, idx):
        # the frames share the blur: the forward shift sees the 'nearest'
        # extension of the blurred grid (its true edge slices replicated
        # into the edge halos)
        blurred = nearest_patch(conv2d_same(hr_ext, psf), idx)
        return torch.stack([spline_shift(blurred, (dy * factor, dx * factor),
                                         strides=(factor, factor))
                            for dy, dx in shifts_key])

    def tile_update(hr_ext, lr_t, idx):
        """(HR correction of the tile's interior, sum over frames of the
        interior MSE)."""
        if solver == "adjoint":
            sims, vjp = torch.func.vjp(lambda h: forward(h, idx), hr_ext)
            err = lr_t - sims
            # the seed covers only LR samples that exist globally: at the
            # global edges the extended tile's halo slices are phantoms
            # (beyond the sensor), and the edge-replication patch would
            # pull their junk error into the edge pixels' adjoint rows
            corr_ext, = vjp(zero_patch(err, halo_lr, idx))
            correction = _interior(corr_ext, halo_hr, t_hr)
        else:
            err = lr_t - forward(hr_ext, idx)
            correction = None
            for i, (dy, dx) in enumerate(shifts_key):
                # heuristic back-projection: zero-stuff the extended error
                # grid, then give the backward shift the 'nearest'
                # extension of the STUFFED grid (solid replicated slices at
                # the global edges); the final correlation's boundary prior
                # is zero padding
                up = err.new_zeros(hr_ext.shape)
                up[..., ::factor, ::factor] = err[i]
                shifted = spline_shift(nearest_patch(up, idx),
                                       (-dy * factor, -dx * factor))
                corr = correlate2d_same(zero_patch(shifted, halo_hr, idx),
                                        psf)
                corr = _interior(corr, halo_hr, t_hr)
                correction = corr if correction is None else correction + corr
        sq = torch.square(_interior(err, halo_lr, t_lr))
        return correction, sq.mean(dim=(-2, -1)).sum()

    errs = torch.zeros((n_iter,), dtype=hr_init.dtype, device=first)
    for it in range(n_iter):
        # zero edge halos: the PSF blur's boundary prior is zero padding
        hr_ext = hr_tiles
        for k in ks:
            hr_ext = halo_exchange(hr_ext, halo_hr, k, dims_hr[k],
                                   edge_mode="zero")
        new = np.empty(hr_tiles.shape, dtype=object)
        mses = []
        for pos in np.ndindex(*hr_tiles.shape):
            correction, mse = tile_update(hr_ext[pos], lr_ext[pos], pos)
            new[pos] = torch.clamp(
                hr_tiles[pos] + step * correction / n_frames, *clip)
            mses.append(mse.to(first, non_blocking=True))
        hr_tiles = new
        errs[it] = torch.stack(mses).mean() / n_frames
    return unshard(hr_tiles, dims_hr, first), errs


def solve_sharded(lr_stack, psf, shifts_yx, mesh: Mesh,
                  factor: int = 2, n_iter: int = 80, step: float = 0.5,
                  halo_lr: int = 32, sp_axis: SpAxes = "sp",
                  solver: str = "ibp"):
    """Full classical solve with the IBP loop spatially sharded.

    Native-2x and SAA are global resampling ops (their endpoint-aligned
    zoom grid is not translation-invariant, see ``ops.resample``), so they
    run unsharded on the mesh's first device, on the conv engine; the
    50-80x iterated IBP is where the compute lives and runs via
    :func:`sharded_ibp`.

    Returns the same dict of numpy arrays as ``sr.classical.solve``.
    """
    lr, psf, shifts_key, _ = _prepare(lr_stack, psf, shifts_yx,
                                      mesh.devices.flat[0])
    lr_mean = torch.mean(lr, dim=0)
    native = native_upsample(lr_mean, factor)
    saa = shift_and_add(lr, shifts_key, factor)
    hr, errs = sharded_ibp(lr, saa, psf, shifts_key, mesh, factor=factor,
                           n_iter=n_iter, step=step, halo_lr=halo_lr,
                           sp_axis=sp_axis, solver=solver)
    return _to_host({"lr_mean": lr_mean, "native": native, "saa": saa,
                     "ibp": hr, "mse_history": errs})
