"""The sessions a benchmark run sends: rendered from ``--seed``.

Each session is a capture of one scene, as the rig takes it: the scene at
the HR grid, moved by each frame's nominal shift, blurred by the
configuration's PSF, decimated by the SR factor, given read noise and
stored as uint8.  The nominal shifts are whole HR pixels at these factors
(+-0.5 LR px at 2x), so a move is a crop of a wider canvas.  The scene has
what the rig photographs: smooth shading, bars of random widths (a
barcode) and flat blocks with sharp edges (a calibration target).

Frozen: a later change here changes every cell's inputs.  Everything is
drawn by one ``torch.Generator`` on the run's device, in a few large
calls; the same seed, device and configuration give the same frames.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

MARGIN = 8          # HR px of canvas around the scene, more than any move


def _seed(seed: int, session: int) -> int:
    """A 63-bit generator seed for one session of one run seed."""
    state = np.random.SeedSequence([int(seed), int(session)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _scene(gen: torch.Generator, hh: int, ww: int, device) -> torch.Tensor:
    """One HR scene with margins, float32 in [10, 245]."""
    kw = dict(generator=gen, device=device)
    # smooth shading from a coarse random field
    coarse = torch.rand((1, 1, hh // 64 + 2, ww // 64 + 2), **kw)
    img = F.interpolate(coarse, size=(hh, ww), mode="bicubic",
                        align_corners=True)[0, 0].clamp(0, 1) * 120 + 60
    # a barcode: bars of random widths 2-12 px over a band of rows
    widths = torch.randint(2, 13, (ww // 2,), **kw)
    edges = torch.cumsum(widths, 0)
    col = torch.arange(ww, device=device)
    bar = torch.searchsorted(edges, col, right=True) % 2
    top = int(torch.randint(0, hh // 2, (1,), **kw))
    img[top: top + hh // 3] = torch.where(bar.bool(), 30.0, 225.0)
    # calibration blocks: flat rectangles at random places and levels
    for r in torch.randint(0, 1 << 30, (6, 5), **kw).tolist():
        y0, x0 = r[0] % (hh - hh // 8), r[1] % (ww - ww // 8)
        img[y0: y0 + hh // 8 - r[2] % (hh // 16),
            x0: x0 + ww // 8 - r[3] % (ww // 16)] = 20 + r[4] % 216
    return img.clamp(10, 245)


def render_session(cfg: Dict, seed: int, session: int,
                   device="cpu") -> np.ndarray:
    """One session of ``cfg``: ``f32[U, N, h, w]`` host numpy holding uint8
    values (U units, N frames each), as the session loader gives frames."""
    f = cfg["factor"]
    h, w = cfg["lr_shape"]
    moves = [(s[0] * f, s[1] * f) for s in cfg["shifts"]]
    if any(m != int(m) or abs(m) >= MARGIN for mv in moves for m in mv):
        raise ValueError(f"shifts {cfg['shifts']}: the generator moves by "
                         f"whole HR pixels under {MARGIN}")
    gen = torch.Generator(device=device).manual_seed(_seed(seed, session))
    hh, ww = h * f + 2 * MARGIN, w * f + 2 * MARGIN
    size = cfg["psf"]["size"]
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x * x / (2.0 * cfg["psf"]["sigma"] ** 2))
    g = (g / g.sum()).float().to(device)
    kernel = (g[:, None] * g[None, :])[None, None]
    noise = cfg["read_noise_dn"]
    units = []
    for _ in range(cfg["units_per_session"]):
        scene = _scene(gen, hh, ww, device)
        blurred = F.conv2d(scene[None, None], kernel,
                           padding=size // 2)[0, 0]
        frames = []
        for my, mx in moves:
            # ndi.shift by +m: out[i] = in[i - m]
            y0, x0 = MARGIN - int(my), MARGIN - int(mx)
            frames.append(blurred[y0: y0 + h * f: f, x0: x0 + w * f: f])
        stack = torch.stack(frames)
        stack = stack + noise * torch.randn(stack.shape, generator=gen,
                                            device=device)
        units.append(stack.round().clamp(0, 255).to(torch.uint8))
    return torch.stack(units).float().cpu().numpy()


def render_pool(cfg: Dict, traffic: Dict, seed: int,
                device="cpu") -> List[np.ndarray]:
    """The run's session pool, ``traffic["pool_sessions"]`` sessions."""
    return [render_session(cfg, seed, k, device)
            for k in range(traffic["pool_sessions"])]
