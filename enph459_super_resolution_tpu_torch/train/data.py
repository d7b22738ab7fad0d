"""Neural-SR data pipeline: scene pools, patch samplers, the eval harness.

Counterpart of ``enph459_super_resolution_tpu/train/data.py``.

* The pools (``image_pool_from_dir`` and the procedural pools) are the
  reference's numpy code, drawn from ``default_rng(seed)``: the port's
  pools are the JAX package's, array for array.
* :class:`PatchSampler` crops on the host from ``default_rng(seed)`` in the
  JAX package's call order, so its crops equal JAX's bit for bit for the
  same seed; :class:`DevicePatchSampler` keeps a uniform pool on the device
  and crops there.  Both augment (flips, rot90) and degrade (Keys cubic,
  ``ops.resize.bicubic_degrade``) on the device.
* Every draw of a torch generator (flips, rotations, the device sampler's
  images and offsets) comes from :func:`generator` seeded by the seed and
  the batch's index, beside a pure function of the draws
  (:func:`augment_degrade`, :func:`sample_batch`) that the tests feed the
  JAX package's draws.  Batch ``i`` is the same whether a run starts at 0
  or resumes at ``i``.  The stream differs from JAX's (another generator).
* :func:`evaluate_sr` is the Set5-style protocol, with one read of the
  device at the end.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.resize import bicubic_degrade, bicubic_upsample


def generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` (e.g. the run's seed
    and the step) through numpy's ``SeedSequence``."""
    seed = int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def image_pool_from_dir(path: str, max_images: Optional[int] = None,
                        channels: int = 3) -> List[np.ndarray]:
    """Decode a directory of images to float32 HWC arrays (0..255)."""
    from ..data.io import load_image

    exts = (".png", ".jpg", ".jpeg", ".bmp")
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith(exts))
    if max_images:
        files = files[:max_images]
    pool = []
    for f in files:
        img = load_image(os.path.join(path, f))
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[-1] == 1 and channels == 3:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] >= 3 and channels == 1:
            img = img[:, :, :3].mean(-1, keepdims=True)
        pool.append(img[:, :, :channels].astype(np.float32))
    if not pool:
        raise FileNotFoundError(f"no images in {path}")
    return pool


def synthetic_scene_pool(n_images: int = 32, size: int = 192,
                         channels: int = 3, seed: int = 0
                         ) -> List[np.ndarray]:
    """Procedural scenes: band-limited noise + random boxes/bars/gradients,
    so models have edges and texture to learn (hermetic stand-in for
    DIV2K)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(n_images):
        img = ndi.gaussian_filter(
            rng.uniform(0, 255, (size, size, channels)), (3.0, 3.0, 0))
        img = (img - img.min()) / max(np.ptp(img), 1e-9) * 200 + 20
        for _ in range(rng.integers(4, 10)):
            y, x = rng.integers(0, size - 24, 2)
            h, w = rng.integers(6, 24, 2)
            img[y:y + h, x:x + w] = rng.uniform(0, 255, (1, 1, channels))
        # a few thin bars (barcode-ish high-frequency content)
        for _ in range(rng.integers(2, 5)):
            x = int(rng.integers(0, size - 20))
            period = int(rng.integers(2, 6))
            v = rng.uniform(150, 255)
            for k in range(0, 18, period):
                img[:, x + k: x + k + max(period // 2, 1)] = v
        pool.append(img.astype(np.float32))
    return pool


def natural_scene_pool(n_images: int = 32, size: int = 192,
                       channels: int = 3, seed: int = 0
                       ) -> List[np.ndarray]:
    """Procedural scenes with *natural-image statistics*: 1/f^a spectra,
    occlusion edges, and stochastic fine-grain texture whose energy lives
    above the x4 LR Nyquist.

    The default :func:`synthetic_scene_pool` is deterministic enough that
    an L1-trained model can essentially invert the degradation
    (grad_ratio ~0.97, RESULTS.md) — there is no oversmoothing for an
    adversarial term to undo, so the perception-distortion tradeoff never
    appears.  This pool is built so it must: the high-frequency texture is
    random in phase, the Keys-cubic x4 degradation destroys it, and the
    L1/MMSE-optimal reconstruction is the blurry conditional mean.  A GAN
    term can only recover the texture *statistics*, trading PSNR for
    sharpness — the classic ESRGAN signature.
    """
    rng = np.random.default_rng(seed)
    import scipy.ndimage as ndi

    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    f = np.hypot(fy, fx)
    f[0, 0] = 1.0 / size

    def field(alpha: float) -> np.ndarray:
        spec = (rng.standard_normal((size, size))
                + 1j * rng.standard_normal((size, size))) * f ** (-alpha)
        x = np.fft.ifft2(spec).real
        return (x - x.mean()) / (x.std() + 1e-9)

    pool = []
    for _ in range(n_images):
        base = field(rng.uniform(1.1, 1.6))  # 1/f structure
        # fine-grain texture: band-limited to above the x4 LR Nyquist
        # (|f| > 1/8 cy/HR-px), so decimation by 4 erases it
        hf = rng.standard_normal((size, size))
        hf = np.fft.ifft2(np.fft.fft2(hf) * (f > 0.125)).real
        hf /= hf.std() + 1e-9
        # smoothly varying texture amplitude: matte vs textured regions
        # (sky vs grass), so the model sees both and must decide locally
        amp = ndi.gaussian_filter(rng.uniform(0, 1, (size, size)), 20)
        amp = (amp - amp.min()) / (np.ptp(amp) + 1e-9)
        lum = 120 + 46 * base + 30 * amp ** 2 * hf
        # a few occlusion boundaries: sharp-edged regions with offset shading
        yy, xx = np.mgrid[0:size, 0:size]
        for _ in range(rng.integers(2, 5)):
            cy, cx = rng.uniform(0, size, 2)
            ry, rx = rng.uniform(size / 12, size / 3, 2)
            th = rng.uniform(0, np.pi)
            u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
            v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
            mask = (u / ry) ** 2 + (v / rx) ** 2 < 1
            lum = np.where(mask, lum + rng.uniform(-45, 45), lum)
        img = np.repeat(lum[:, :, None], channels, axis=-1)
        if channels == 3:
            for c in range(3):  # low-frequency chroma
                img[:, :, c] += 12 * field(1.8)
        pool.append(np.clip(img, 0, 255).astype(np.float32))
    return pool


def edges_scene_pool(n_images: int = 32, size: int = 192,
                     channels: int = 3, seed: int = 0
                     ) -> List[np.ndarray]:
    """Procedural *piecewise-smooth* scenes: the Set5-like regime.

    The benchmark images where small SR nets post their literature wins
    (Set5's baby/bird/butterfly) are dominated by smooth shading separated
    by sharp occlusion edges — content whose above-Nyquist energy is
    *deterministic* (edges continue), so a x4 model can genuinely
    reconstruct it.  :func:`synthetic_scene_pool` instead carries
    broadband noise texture and :func:`natural_scene_pool` deliberately
    stochastic fine grain; on both, capacity-starved models (FSRCNN x4)
    can't beat bicubic (RESULTS.md).  This pool isolates the edge regime:
    smooth gradients + overlapping shaded ellipses/half-planes + thin
    curved lines, anti-aliased at ~0.7 px, with NO stochastic texture.
    """
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    pool = []
    for _ in range(n_images):
        # smooth background: low-order ramp + large-scale blobs
        gy, gx = rng.uniform(-40, 40, 2)
        lum = 120 + gy * (yy / size - 0.5) + gx * (xx / size - 0.5)
        lum += ndi.gaussian_filter(rng.uniform(-1, 1, (size, size)), 24) * 90
        # overlapping shaded shapes with sharp boundaries
        for _ in range(rng.integers(8, 16)):
            cy, cx = rng.uniform(0, size, 2)
            ry, rx = rng.uniform(size / 16, size / 3, 2)
            th = rng.uniform(0, np.pi)
            u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
            v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
            if rng.uniform() < 0.25:  # half-plane (straight edge)
                mask = u > 0
            else:  # ellipse
                mask = (u / ry) ** 2 + (v / rx) ** 2 < 1
            sy, sx = rng.uniform(-30, 30, 2)
            shade = (rng.uniform(-70, 70)
                     + sy * (yy - cy) / size + sx * (xx - cx) / size)
            lum = np.where(mask, lum + shade, lum)
        # a few thin curved lines (quadratic strokes)
        for _ in range(rng.integers(2, 6)):
            a, b, c = rng.uniform(-1, 1, 3)
            t = (xx / size - 0.5)
            curve = size * (0.5 + 0.35 * (a * t * t + b * t + c))
            width = rng.uniform(1.0, 2.5)
            d = np.abs(yy - curve)
            lum = np.where(d < width, lum + rng.uniform(-80, 80), lum)
        # optical anti-aliasing: edges get a realistic ~0.7 px width
        lum = ndi.gaussian_filter(lum, 0.7)
        img = np.repeat(lum[:, :, None], channels, axis=-1)
        if channels == 3:
            tint = rng.uniform(0.85, 1.15, 3)
            img = img * tint[None, None, :]
        pool.append(np.clip(img, 0, 255).astype(np.float32))
    return pool


#: procedural pool registry, keyed by the CLIs' ``--pool`` choice
POOL_KINDS = {
    "synthetic": synthetic_scene_pool,
    "natural": natural_scene_pool,
    "edges": edges_scene_pool,
}


# ---------------------------------------------------------------------------
# patch batches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PatchConfig:
    scale: int = 4
    lr_patch: int = 48  # LR patch size; HR patch = lr_patch * scale
    batch: int = 16
    augment: bool = True


def augment_draws(batch: int, gen: torch.Generator):
    """``(flips[B, 2], rots[B])`` booleans, each true with probability 1/2,
    on the generator's device."""
    flips = torch.rand((batch, 2), generator=gen, device=gen.device) < 0.5
    rots = torch.rand((batch,), generator=gen, device=gen.device) < 0.5
    return flips, rots


def augment_degrade(hr: torch.Tensor, flips: torch.Tensor,
                    rots: torch.Tensor, scale: int, augment: bool = True):
    """Square HR patches ``(B, H, H, C)`` -> ``(lr, hr)``: per patch a row
    flip where ``flips[:, 0]``, a column flip where ``flips[:, 1]`` and a
    rot90 where ``rots`` (JAX's ``_degrade_batch`` order), then the Keys
    cubic 1/scale degradation."""
    if augment:
        hr = torch.where(flips[:, 0, None, None, None], hr.flip(1), hr)
        hr = torch.where(flips[:, 1, None, None, None], hr.flip(2), hr)
        hr = torch.where(rots[:, None, None, None],
                         torch.rot90(hr, 1, (1, 2)), hr)
    return bicubic_degrade(hr, scale), hr


def sample_batch(pool: torch.Tensor, idx, ys, xs, flips, rots, hp: int,
                 scale: int, augment: bool = True):
    """``hp`` x ``hp`` crops of ``pool[idx]`` (a ``(P, H, W, C)`` tensor) at
    ``(ys, xs)``, through :func:`augment_degrade`."""
    ar = torch.arange(hp, device=pool.device)
    rows = ys[:, None] + ar
    cols = xs[:, None] + ar
    crops = pool[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    return augment_degrade(crops, flips, rots, scale, augment)


class PatchSampler:
    """Random HR crops from the pool -> ``(lr, hr)`` batches on ``device``.

    The host draws the crops from ``default_rng(seed)`` in the JAX
    package's order (per patch: the image, then y, then x) and gathers them
    with numpy; augmentation and degradation run on the device.  ``start``
    skips that many batches' crop draws (a resumed run).
    """

    def __init__(self, pool: List[np.ndarray], cfg: PatchConfig,
                 seed: int = 0, device="cuda", start: int = 0):
        self.pool = pool
        self.cfg = cfg
        self.seed = seed
        self.device = (resolve_device(device) if isinstance(device, str)
                       else device)
        self.rng = np.random.default_rng(seed)
        hr_patch = cfg.lr_patch * cfg.scale
        for i, img in enumerate(pool):
            if img.shape[0] < hr_patch or img.shape[1] < hr_patch:
                raise ValueError(f"pool image {i} smaller than HR patch "
                                 f"{hr_patch}")
        for _ in range(start):
            self.crop_draws()
        self.count = start

    def crop_draws(self) -> List[Tuple[int, int, int]]:
        """One batch's ``(image, y, x)`` per patch."""
        hp = self.cfg.lr_patch * self.cfg.scale
        out = []
        for _ in range(self.cfg.batch):
            i = int(self.rng.integers(len(self.pool)))
            img = self.pool[i]
            y = int(self.rng.integers(0, img.shape[0] - hp + 1))
            x = int(self.rng.integers(0, img.shape[1] - hp + 1))
            out.append((i, y, x))
        return out

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        return self

    def __next__(self):
        cfg = self.cfg
        hp = cfg.lr_patch * cfg.scale
        crops = np.stack([self.pool[i][y:y + hp, x:x + hp]
                          for i, y, x in self.crop_draws()])
        gen = generator(self.device, self.seed, self.count)
        self.count += 1
        hr = torch.as_tensor(crops, dtype=torch.float32, device=self.device)
        return augment_degrade(hr, *augment_draws(cfg.batch, gen), cfg.scale,
                               cfg.augment)


class DevicePatchSampler:
    """Device-resident variant of :class:`PatchSampler` for uniform-size
    pools (the procedural pools; any same-shaped dataset): the pool uploads
    once, and each batch is drawn, cropped, augmented and degraded on the
    device, so a step moves no image data from the host.  Batch ``i``'s
    draws come from ``generator(device, seed, i)``; ``start`` is the first
    batch's index."""

    def __init__(self, pool: List[np.ndarray], cfg: PatchConfig,
                 seed: int = 0, device="cuda", start: int = 0):
        shapes = {img.shape for img in pool}
        if len(shapes) != 1:
            raise ValueError(f"pool images differ in shape: {shapes}; "
                             "use PatchSampler")
        self.cfg = cfg
        self.seed = seed
        hp = cfg.lr_patch * cfg.scale
        h, w = pool[0].shape[:2]
        if h < hp or w < hp:
            raise ValueError(f"pool images smaller than HR patch {hp}")
        device = (resolve_device(device) if isinstance(device, str)
                  else device)
        self.pool_arr = torch.as_tensor(np.stack(pool), dtype=torch.float32,
                                        device=device)
        self.count = start

    def __iter__(self):
        return self

    def __next__(self):
        cfg = self.cfg
        p, h, w, _ = self.pool_arr.shape
        hp = cfg.lr_patch * cfg.scale
        gen = generator(self.pool_arr.device, self.seed, self.count)
        self.count += 1
        dev = self.pool_arr.device
        idx = torch.randint(0, p, (cfg.batch,), generator=gen, device=dev)
        ys = torch.randint(0, h - hp + 1, (cfg.batch,), generator=gen,
                           device=dev)
        xs = torch.randint(0, w - hp + 1, (cfg.batch,), generator=gen,
                           device=dev)
        return sample_batch(self.pool_arr, idx, ys, xs,
                            *augment_draws(cfg.batch, gen), hp, cfg.scale,
                            cfg.augment)


def make_patch_sampler(pool: List[np.ndarray], cfg: PatchConfig,
                       seed: int = 0, device="cuda", start: int = 0):
    """Device-resident sampler when the pool is uniform-shaped, host
    sampler otherwise."""
    try:
        return DevicePatchSampler(pool, cfg, seed, device, start)
    except ValueError:
        return PatchSampler(pool, cfg, seed, device, start)


# ---------------------------------------------------------------------------
# eval harness (Set5-style protocol)
# ---------------------------------------------------------------------------

EVAL_KEYS = ("psnr", "ssim", "bicubic_psnr", "grad_ratio",
             "bicubic_grad_ratio", "spec_dist", "bicubic_spec_dist")


def evaluate_sr(apply_fn: Callable, pool: List[np.ndarray], scale: int,
                shave: Optional[int] = None, on_y: bool = True,
                max_val: float = 255.0, device="cuda") -> dict:
    """PSNR/SSIM of ``apply_fn(lr) -> sr`` (``[1, h, w, C]`` tensors on
    ``device``) over full images.

    Protocol per the SR literature: LR = Keys-cubic 1/s of the HR (cropped
    to a multiple of s), metrics on the Y channel with an s-pixel border
    shave.  Returns mean psnr/ssim plus the bicubic baseline, ``grad_ratio``
    (mean |grad SR| / mean |grad HR|, a sharpness index: L1-trained SR is
    oversmoothed, < 1) and ``spec_dist`` (log-spectral distance), each for
    the model and for bicubic, and ``n_images``.  The per-image metrics stay
    on the device; one array is read at the end.
    """
    from ..eval.metrics import log_spectral_distance, psnr, ssim, y_channel

    device = resolve_device(device) if isinstance(device, str) else device
    shave = scale if shave is None else shave

    def grad_mag(x):
        gy = x[1:, :-1] - x[:-1, :-1]
        gx = x[:-1, 1:] - x[:-1, :-1]
        return torch.mean(torch.sqrt(gy * gy + gx * gx + 1e-12))

    def prep(x):
        x = torch.clamp(x, 0, max_val)
        x = y_channel(x) if on_y and x.shape[-1] == 3 else x[..., 0]
        return x[shave:-shave, shave:-shave]

    rows = []
    with torch.no_grad():
        for img in pool:
            h = img.shape[0] - img.shape[0] % scale
            w = img.shape[1] - img.shape[1] % scale
            hr = torch.as_tensor(np.ascontiguousarray(img[:h, :w]),
                                 dtype=torch.float32, device=device)
            lr = bicubic_degrade(hr[None], scale)[0]
            sr = apply_fn(lr[None])[0]
            bic = bicubic_upsample(lr[None], scale)[0]
            hr_p, sr_p, bic_p = prep(hr), prep(sr), prep(bic)
            hr_g = grad_mag(hr_p)
            rows.append(torch.stack([
                psnr(sr_p, hr_p, max_val), ssim(sr_p, hr_p, max_val),
                psnr(bic_p, hr_p, max_val), grad_mag(sr_p) / hr_g,
                grad_mag(bic_p) / hr_g, log_spectral_distance(sr_p, hr_p),
                log_spectral_distance(bic_p, hr_p)]))
    vals = torch.stack(rows).mean(dim=0).cpu().numpy()
    out = {k: float(v) for k, v in zip(EVAL_KEYS, vals)}
    out["n_images"] = len(pool)
    return out
