"""PSF/MTF characterization CLI over a folder of PSF images.

Scripted equivalent of ``data_collection/psf_mtf_utils.py``'s ``main()``
(``:197-557``): load all images in a folder, align PSFs to their common
centre of mass, report per-image Gaussian sigma / MTF50 / MTF10 /
encircled-energy stats, save a 3x3 summary figure and an npz dump.

The port's counterpart of ``enph459_super_resolution_tpu/psf/cli.py``:
the device steps run on ``--device`` (CUDA unless ``--device cpu`` is
given; asking for CUDA without a card is an error, never a fallback).
``--no-figures`` skips the summary figure (the reference always draws it;
a machine without matplotlib needs the flag).

Usage:
  python -m enph459_super_resolution_tpu_torch.psf.cli <folder-or-glob> \
      [--pixel-pitch-um 3.45] [--crop-radius 50] [--output-dir out] \
      [--no-figures] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..data.io import load_gray
from ..device import DEVICES, resolve_device
from . import toolkit as tk


def analyse_folder(paths, crop_radius: int = 50,
                   pixel_pitch_um=None, bg_percentile: float = 50.0,
                   noise_floor_sigma=3.0, device="cuda"):
    """One aligned-stack analysis over a flat list of PSF images.

    ``noise_floor_sigma`` defaults to the 3-sigma sparse-noise threshold:
    without it (the reference psf_mtf_utils behavior; pass ``None``),
    residual background noise in the ROI dominates the radial MTF average
    and collapses MTF50 by ~40x on the real pinhole data.  The device
    steps run on ``device``.
    """
    import torch

    from ..ops.resample import spline_shift

    raw = []
    for p in paths:
        img = load_gray(p, dtype=np.float64)
        peak = tk.find_peak(img, device=device)
        psf = tk.extract_psf(img, peak, crop_radius, bg_percentile,
                             noise_floor_sigma=noise_floor_sigma)
        if psf.shape == (2 * crop_radius + 1, 2 * crop_radius + 1):
            raw.append(psf)
    if not raw:
        raise FileNotFoundError("no usable PSF images")

    target = np.array([crop_radius, crop_radius], dtype=np.float64)
    aligned = []
    for psf in raw:
        com = np.array(tk.subpixel_centre(psf))
        aligned.append(np.clip(spline_shift(
            torch.as_tensor(psf, device=device),
            tuple(target - com)).cpu().numpy(), 0, None))
    stack = np.stack(aligned)
    avg = stack.mean(axis=0)

    params = tk.fit_gaussian_psf_batch(stack, device)
    freq, mtfs, _, unit, nyq = tk.compute_mtf(stack, pixel_pitch_um, device)
    mtf50 = np.array([tk.mtf_at_fraction(freq, m, 0.5) for m in mtfs])
    mtf10 = np.array([tk.mtf_at_fraction(freq, m, 0.1) for m in mtfs])

    com = tk.subpixel_centre(avg)
    radii, prof = tk.radial_average(avg, com, crop_radius)
    ee = tk.encircled_energy(prof, radii)
    f_avg, mtf_avg, mtf2d, _, _ = tk.compute_mtf(avg, pixel_pitch_um,
                                                 device)

    return dict(n=len(stack), stack=stack, avg=avg, params=params,
                freq=freq, mtfs=mtfs, mtf50=mtf50, mtf10=mtf10,
                unit=unit, nyquist=nyq, radii=radii, profile=prof, ee=ee,
                mtf_avg=mtf_avg, mtf2d_avg=mtf2d,
                mtf50_avg=tk.mtf_at_fraction(f_avg, mtf_avg, 0.5),
                mtf10_avg=tk.mtf_at_fraction(f_avg, mtf_avg, 0.1))


def save_figure(res, out_path: str) -> None:
    """3x3 summary figure (avg PSF, std, fit residual, radial profile, EE,
    MTF, per-image sigma/MTF histograms)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 3, figsize=(14, 12))
    z = 12
    c = res["avg"].shape[0] // 2
    axes[0, 0].imshow(res["avg"][c - z:c + z, c - z:c + z], cmap="inferno")
    axes[0, 0].set_title(f"avg PSF (n={res['n']})")
    axes[0, 1].imshow(res["stack"].std(0)[c - z:c + z, c - z:c + z],
                      cmap="inferno")
    axes[0, 1].set_title("per-pixel std")
    axes[0, 2].imshow(np.log1p(res["mtf2d_avg"]), cmap="viridis")
    axes[0, 2].set_title("|OTF| (log)")
    axes[1, 0].plot(res["radii"], res["profile"] / max(res["profile"].max(),
                                                       1e-12))
    axes[1, 0].set_title("radial PSF profile")
    axes[1, 1].plot(res["radii"], res["ee"])
    axes[1, 1].set_title("encircled energy")
    axes[1, 2].plot(res["freq"], res["mtfs"].T, alpha=0.2, color="gray")
    axes[1, 2].plot(res["freq"], res["mtf_avg"], color="C3", lw=2)
    axes[1, 2].set_title(f"MTF ({res['unit']})")
    axes[2, 0].hist(res["params"][:, 3], bins=15, alpha=0.7, label="sx")
    axes[2, 0].hist(res["params"][:, 4], bins=15, alpha=0.7, label="sy")
    axes[2, 0].legend()
    axes[2, 0].set_title("Gaussian sigma (px)")
    axes[2, 1].hist(res["mtf50"][np.isfinite(res["mtf50"])], bins=15)
    axes[2, 1].set_title("per-image MTF50")
    axes[2, 2].hist(res["mtf10"][np.isfinite(res["mtf10"])], bins=15)
    axes[2, 2].set_title("per-image MTF10")
    for ax in axes.ravel():
        ax.grid(alpha=0.2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", help="folder or glob of PSF images")
    p.add_argument("--pixel-pitch-um", type=float, default=None)
    p.add_argument("--crop-radius", type=int, default=50)
    p.add_argument("--bg-percentile", type=float, default=50.0)
    p.add_argument("--noise-floor-sigma", type=float, default=3.0,
                   help="sparse-noise threshold in background sigmas "
                        "(0 disables, matching the reference psf_mtf_utils)")
    p.add_argument("--output-dir", default="psf_analysis")
    p.add_argument("--no-figures", action="store_true")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the filters, shifts, FFTs and fits run "
                        "(default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    if os.path.isdir(args.images):
        paths = sorted(
            glob.glob(os.path.join(args.images, "*.png"))
            + glob.glob(os.path.join(args.images, "*.tif*")))
    else:
        paths = sorted(glob.glob(args.images))
    if not paths:
        print(f"no images match {args.images}", file=sys.stderr)
        return 1

    res = analyse_folder(paths, args.crop_radius, args.pixel_pitch_um,
                         args.bg_percentile,
                         args.noise_floor_sigma or None, device)
    os.makedirs(args.output_dir, exist_ok=True)
    np.savez(os.path.join(args.output_dir, "psf_mtf_data.npz"),
             **{k: v for k, v in res.items() if isinstance(v, np.ndarray)})
    if not args.no_figures:
        save_figure(res, os.path.join(args.output_dir,
                                      "psf_mtf_summary.png"))
    ok = np.isfinite(res["params"]).all(axis=1)
    print(f"n={res['n']}  sigma_x={res['params'][ok, 3].mean():.3f}  "
          f"sigma_y={res['params'][ok, 4].mean():.3f}  "
          f"MTF50={res['mtf50_avg']:.2f} {res['unit']}  "
          f"MTF10={res['mtf10_avg']:.2f}")
    print(f"wrote {args.output_dir}/psf_mtf_data.npz"
          + ("" if args.no_figures else " + psf_mtf_summary.png"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
