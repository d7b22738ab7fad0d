"""Full-image neural SR inference: receptive-field-exact tiled execution.

Counterpart of ``enph459_super_resolution_tpu/models/infer.py``
(``receptive_field_radius``, ``tiled_infer`` and ``tiled_infer_sharded``).
A conv stack's output pixel depends only on the inputs within its
receptive field, so splitting the image into tiles extended by a
receptive-field halo and keeping the tile interiors is exact, at a peak
device memory bounded by the tile size.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
from torch import nn


def receptive_field_radius(model: nn.Module) -> int:
    """Conservative receptive-field radius (LR px) of the zoo's trunks."""
    name = type(model).__name__.lower()
    if name == "srcnn":
        return (9 + 5 + 5 - 3) // 2 + 1          # 9
    if name == "espcn":
        return (5 + 3 + 3 - 3) // 2 + 1          # 5
    if name == "fsrcnn":
        m = getattr(model, "m", 4)
        return (5 + 1 + 3 * m + 1 + 9 - 5 + 4) // 2 + 2
    if name == "edsr":
        n = getattr(model, "n_resblocks", 16)
        convs = 2 + 2 * n + 2 + 1  # head + blocks + tail + up convs
        return convs + 2
    if name == "rrdbnet":
        nb = getattr(model, "nb", 23)
        convs = 2 + 15 * nb + 3
        return convs + 2
    raise ValueError(f"unknown model {name}; pass halo explicitly")


def tiled_infer(model: nn.Module, lr, tile: int = 256,
                halo: Optional[int] = None, scale: Optional[int] = None,
                batch_tiles: int = 8, out_dtype=np.float32,
                rgb_range: float = 255.0) -> np.ndarray:
    """SR a full (possibly huge) image by exact overlap-halo tiling, on the
    model's device.

    Args:
      model: a ``models/zoo.py`` model (its weights live in it).
      lr: ``(H, W, C)`` or ``(B, H, W, C)`` array, float or uint8; uint8
        uploads as it is and becomes float32 on the device.
      tile: interior tile size in LR pixels (edge tiles are clamped).
      halo: receptive-field radius override in LR pixels.
      batch_tiles: tiles per batched forward; the ragged tail chunk is
        padded with repeats of its last tile (discarded), so every forward
        has one shape.
      out_dtype: ``np.uint8`` clips to ``[0, rgb_range]`` and truncates on
        the device (the reference's ``to_uint8``) before the copy to the
        host; each tile's interior is cropped on the device too.

    Returns a numpy array ``(H*s, W*s, C)`` (or with the batch axis).
    """
    scale = scale if scale is not None else getattr(model, "scale", 1)
    halo = halo if halo is not None else receptive_field_radius(model)
    device = next(model.parameters()).device
    lr_np = np.asarray(lr)
    squeeze = lr_np.ndim == 3
    if squeeze:
        lr_np = lr_np[None]
    b, h, w, c = lr_np.shape
    ts = tile * scale

    def quantize(x):
        """On the device: uint8 by clip and truncation, else float32 (the
        host casts to ``out_dtype``)."""
        if np.dtype(out_dtype) == np.uint8:
            return x.clamp(0, rgb_range).to(torch.uint8)
        return x

    def forward(x_np):
        x = torch.as_tensor(x_np).to(device).float()
        with torch.no_grad():
            return model(x)

    ext = tile + 2 * halo
    if h <= ext or w <= ext:  # small image: nothing to tile
        out = quantize(forward(lr_np)).cpu().numpy().astype(out_dtype)
        return out[0] if squeeze else out
    ny = math.ceil(h / tile)
    nx = math.ceil(w / tile)

    # Patch windows are CLAMPED into the image (never padded): an edge
    # tile's patch boundary is the true image edge, so the convs' own
    # 'SAME' zero padding applies there exactly as in the whole-image
    # forward; interior cuts are covered by the halo.  The device crop
    # starts at (cy, cx), clamped so that a full tile*scale crop fits in
    # the ext*scale output; the host offset makes up the difference.
    jobs = []  # (y0, x0, t_h, t_w, ys, xs, cy, cx) per tile
    for iy in range(ny):
        for ix in range(nx):
            y0, x0 = iy * tile, ix * tile
            t_h, t_w = min(tile, h - y0), min(tile, w - x0)
            ys = int(np.clip(y0 - halo, 0, h - ext))
            xs = int(np.clip(x0 - halo, 0, w - ext))
            cy = min(y0 - ys, ext - tile) * scale
            cx = min(x0 - xs, ext - tile) * scale
            jobs.append((y0, x0, t_h, t_w, ys, xs, cy, cx))

    out = np.zeros((b, h * scale, w * scale, c), dtype=out_dtype)
    chunk = max(1, min(batch_tiles, len(jobs)))
    for j0 in range(0, len(jobs), chunk):
        batch_jobs = jobs[j0: j0 + chunk]
        padded = batch_jobs + [batch_jobs[-1]] * (chunk - len(batch_jobs))
        patches = np.stack([lr_np[:, ys: ys + ext, xs: xs + ext]
                            for (_, _, _, _, ys, xs, _, _) in padded])
        sr = forward(patches.reshape((-1, ext, ext, c)))
        sr = sr.reshape((chunk, b) + tuple(sr.shape[1:]))
        crops = torch.stack([sr[k, :, cy: cy + ts, cx: cx + ts]
                             for k, (*_, cy, cx) in enumerate(padded)])
        crops = quantize(crops).cpu().numpy()
        for k, (y0, x0, t_h, t_w, ys, xs, cy, cx) in enumerate(batch_jobs):
            oy = (y0 - ys) * scale - cy
            ox = (x0 - xs) * scale - cx
            out[:, y0 * scale: (y0 + t_h) * scale,
                x0 * scale: (x0 + t_w) * scale] = \
                crops[k, :, oy: oy + t_h * scale, ox: ox + t_w * scale]
    return out[0] if squeeze else out


def tiled_infer_sharded(model: nn.Module, lr, mesh,
                        halo: Optional[int] = None,
                        scale: Optional[int] = None,
                        sp_axis: str = "sp") -> np.ndarray:
    """Mesh-sharded variant: the image's H axis is split over the
    ``sp_axis`` tiles of ``mesh`` with one halo exchange
    (:func:`~..parallel.tiled.tiled_apply`), each tile run by a copy of
    ``model`` on its device (the model itself where it already lives).

    Interior-exact vs the whole-image apply; within ``halo * scale`` rows
    of the two GLOBAL image edges the result may differ slightly -- the
    tiles share one shape, so the zero-filled edge halo cannot replicate
    SAME-conv boundary handling through biased nonlinear layers (use
    :func:`tiled_infer` when exact borders matter).

    ``lr`` is ``(H, W, C)`` or ``(B, H, W, C)``, float or uint8; returns a
    float32 numpy array ``(H*s, W*s, C)`` (or with the batch axis).
    """
    from ..parallel.tiled import tiled_apply

    scale = scale if scale is not None else getattr(model, "scale", 1)
    halo = halo if halo is not None else receptive_field_radius(model)
    x = torch.as_tensor(np.asarray(lr)).float()
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    home = next(model.parameters()).device
    replicas = {}

    def fn(tile):
        net = replicas.get(tile.device)
        if net is None:
            net = model if tile.device == home else \
                copy.deepcopy(model).to(tile.device)
            replicas[tile.device] = net
        with torch.no_grad():
            return net(tile)

    out = tiled_apply(fn, x, mesh, halo=halo, axis=1, out_scale=scale,
                      sp_axis=sp_axis, edge_mode="zero")
    out = out.cpu().numpy()
    return out[0] if squeeze else out
