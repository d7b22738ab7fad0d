"""Scene pools for neural SR training (host numpy).

Counterpart of the pool part of ``enph459_super_resolution_tpu/train/data.py``
(``image_pool_from_dir`` and the procedural pools), copied: the pools are
numpy drawn from ``default_rng(seed)``, so the port's pools are the JAX
package's, array for array.  ``PatchSampler``, ``DevicePatchSampler`` and
``evaluate_sr`` come with the ``train.loop`` slice.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


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
