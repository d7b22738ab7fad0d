"""PSF/MTF characterization grouped by mirror position — CLI + library.

Reproduces ``calibration_psf/analyze_psf_mtf.py``'s analysis pipeline
(grouping by filename, naive vs aligned stacks, per-image radial/EE/MTF
stats, Gaussian fits, combined npz dump) with the per-image loops replaced
by batched device pipelines:

  * all PSFs of a position are aligned with one batched set of spline
    shifts and their MTFs computed by one vmapped FFT;
  * the per-image Gaussian fits run as a single batched LM solve.

The port's counterpart of ``enph459_super_resolution_tpu/psf/analyze.py``:
the device steps run on ``--device`` (CUDA unless ``--device cpu`` is
given; asking for CUDA without a card is an error, never a fallback).

Usage:
  python -m enph459_super_resolution_tpu_torch.psf.analyze <folder> \
      --pixel-pitch-um 3.45 --crop-radius 50 --output-dir results \
      [--no-figures] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np

from ..device import DEVICES, resolve_device
from . import toolkit as tk

_FLAT_RE = re.compile(
    r"sweep([xy])_tilt([\d.]+)_rep(\d+)_pos(\d+)\.(png|tif|tiff|bmp|jpg|jpeg)$",
    re.IGNORECASE)
_SUBDIR_DIR_RE = re.compile(r"sweep([xy])_tilt([\d.]+)deg$", re.IGNORECASE)
_SUBDIR_FILE_RE = re.compile(
    r"pos(\d+)[_(].*\.(png|tif|tiff|bmp|jpg|jpeg)$", re.IGNORECASE)


def parse_filename(path: str) -> Optional[Dict]:
    """Both dataset layouts (``analyze_psf_mtf.py:686-716``): flat
    ``sweepx_tilt0.02000_rep00_pos4.png`` and subfoldered
    ``sweepx_tilt0.02000deg/pos4_(0,0).png``."""
    name = os.path.basename(path)
    dirname = os.path.basename(os.path.dirname(path))
    m = _FLAT_RE.match(name)
    if m:
        return dict(sweep_axis=m.group(1), tilt_angle=float(m.group(2)),
                    repeat=int(m.group(3)), position=int(m.group(4)), path=path)
    m1 = _SUBDIR_DIR_RE.match(dirname)
    m2 = _SUBDIR_FILE_RE.match(name)
    if m1 and m2:
        return dict(sweep_axis=m1.group(1), tilt_angle=float(m1.group(2)),
                    repeat=0, position=int(m2.group(1)), path=path)
    return None


def discover_images(folder: str) -> List[Dict]:
    exts = ("*.png", "*.tif", "*.tiff", "*.bmp", "*.jpg", "*.jpeg")
    paths = []
    for ext in exts:
        paths.extend(glob.glob(os.path.join(folder, ext)))
        paths.extend(glob.glob(os.path.join(folder, "*", ext)))
    records = [parse_filename(p) for p in sorted(set(paths))]
    return [r for r in records if r is not None]


def analyse_position(paths: List[str], crop_radius: int,
                     pixel_pitch_um: Optional[float],
                     bg_percentile: float = 50.0,
                     device="cuda") -> Optional[Dict]:
    """Full PSF/MTF pipeline for one position group
    (``analyze_psf_mtf.py:207-335``), batched on ``device``."""
    import torch

    from ..data.io import load_gray
    from ..ops.resample import spline_shift

    if not paths:
        return None

    raw = []
    for p in paths:
        img = load_gray(p, dtype=np.float64)
        peak = tk.find_peak(img, device=device)
        raw.append(tk.extract_psf(img, peak, crop_radius, bg_percentile))
    shapes = {r.shape for r in raw}
    if len(shapes) > 1:  # peaks near borders give ragged ROIs; drop those
        full = (2 * crop_radius + 1, 2 * crop_radius + 1)
        raw = [r for r in raw if r.shape == full]
        if not raw:
            return None
    raw_stack = np.stack(raw)
    n = raw_stack.shape[0]

    # naive (unaligned) stack: quantifies real shift-jitter blur
    psf_naive = raw_stack.mean(axis=0)

    # CoM alignment: per-image sub-pixel shifts (each shift has its own
    # taps, so loop; each is a cheap 101x101 op)
    target = np.array([crop_radius, crop_radius], dtype=np.float64)
    aligned = []
    for psf in raw:
        com = np.array(tk.subpixel_centre(psf))
        s = target - com
        shifted = spline_shift(torch.as_tensor(psf, device=device),
                               tuple(s)).cpu().numpy()
        aligned.append(np.clip(shifted, 0, None))
    stack = np.stack(aligned)
    psf_avg = stack.mean(axis=0)
    psf_std = stack.std(axis=0) if n > 1 else np.zeros_like(psf_avg)

    # per-image radial profile / EE / MTF (MTF batched on device)
    freq, all_mtf, _, freq_label, nyquist = tk.compute_mtf(
        stack, pixel_pitch_um, device)
    all_radial, all_ee = [], []
    for psf in aligned:
        com = tk.subpixel_centre(psf)
        radii, prof = tk.radial_average(psf, com, crop_radius)
        mx = prof.max()
        all_radial.append(prof / mx if mx > 0 else prof)
        all_ee.append(tk.encircled_energy(prof, radii))
    all_radial = np.array(all_radial)
    all_ee = np.array(all_ee)

    # Gaussian fits: average PSF + the whole stack in one batched solve
    popt, fit_img = tk.fit_gaussian_psf(psf_avg, device)
    per_image = tk.fit_gaussian_psf_batch(stack, device)
    ok = np.all(np.isfinite(per_image), axis=1)
    all_sx, all_sy = per_image[ok, 3], per_image[ok, 4]

    freq_avg, mtf_avg, mtf2d_avg, _, _ = tk.compute_mtf(
        psf_avg, pixel_pitch_um, device)
    freq_naive, mtf_naive, _, _, _ = tk.compute_mtf(
        psf_naive, pixel_pitch_um, device)

    com_avg = tk.subpixel_centre(psf_avg)
    radii_psf, psf_profile_avg = tk.radial_average(psf_avg, com_avg, crop_radius)

    return dict(
        n_images=n,
        psf_avg=psf_avg, psf_std=psf_std, psf_naive=psf_naive,
        psf_fit=fit_img, psf_fit_params=popt,
        com_avg=com_avg, radii_psf=radii_psf,
        psf_profile_avg=psf_profile_avg,
        radial_mean=all_radial.mean(axis=0),
        radial_std=all_radial.std(axis=0) if n > 1 else 0 * all_radial[0],
        freq=freq_avg, mtf=mtf_avg, mtf_2d_avg=mtf2d_avg,
        mtf_mean=all_mtf.mean(axis=0),
        mtf_std=all_mtf.std(axis=0) if n > 1 else 0 * all_mtf[0],
        ee_mean=all_ee.mean(axis=0),
        ee_std=all_ee.std(axis=0) if n > 1 else 0 * all_ee[0],
        mtf50=tk.mtf_at_fraction(freq_avg, mtf_avg, 0.5),
        mtf10=tk.mtf_at_fraction(freq_avg, mtf_avg, 0.1),
        per_image_mtf50=np.array([tk.mtf_at_fraction(freq, m, 0.5)
                                  for m in all_mtf]),
        per_image_mtf10=np.array([tk.mtf_at_fraction(freq, m, 0.1)
                                  for m in all_mtf]),
        per_image_sigma_x=all_sx, per_image_sigma_y=all_sy,
        freq_naive=freq_naive, mtf_naive=mtf_naive,
        mtf50_naive=tk.mtf_at_fraction(freq_naive, mtf_naive, 0.5),
        mtf10_naive=tk.mtf_at_fraction(freq_naive, mtf_naive, 0.1),
        freq_label=freq_label, nyquist=nyquist,
    )


def save_position_figure(res: Dict, pos: int, out_path: str,
                         zoom: int = 12) -> None:
    """Per-position summary figure (``analyze_psf_mtf.py:337-531`` layout:
    PSF/std/fit, radial profile with band, EE, MTF aligned vs naive)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(15, 9))
    c = res["psf_avg"].shape[0] // 2
    sl = slice(c - zoom, c + zoom + 1)
    axes[0, 0].imshow(res["psf_avg"][sl, sl], cmap="inferno")
    axes[0, 0].set_title(f"pos{pos} aligned avg (n={res['n_images']})")
    axes[0, 1].imshow(res["psf_std"][sl, sl], cmap="inferno")
    axes[0, 1].set_title("per-pixel std")
    if res.get("psf_fit") is not None:
        axes[0, 2].imshow((res["psf_avg"] - res["psf_fit"])[sl, sl],
                          cmap="coolwarm")
        p = res["psf_fit_params"]
        axes[0, 2].set_title(f"fit residual (sx={p[3]:.2f} sy={p[4]:.2f})")
    r = res["radii_psf"]
    axes[1, 0].plot(r, res["radial_mean"], color="C0")
    axes[1, 0].fill_between(r, res["radial_mean"] - res["radial_std"],
                            res["radial_mean"] + res["radial_std"],
                            alpha=0.25)
    axes[1, 0].set_title("radial PSF profile")
    axes[1, 1].plot(r, res["ee_mean"], color="C0")
    axes[1, 1].fill_between(r, np.clip(res["ee_mean"] - res["ee_std"], 0, 1),
                            np.clip(res["ee_mean"] + res["ee_std"], 0, 1),
                            alpha=0.25)
    axes[1, 1].set_title("encircled energy")
    axes[1, 2].plot(res["freq"], res["mtf"], color="C0",
                    label=f"aligned (MTF50 {res['mtf50']:.1f})")
    axes[1, 2].plot(res["freq_naive"], res["mtf_naive"], color="C3",
                    ls="--", label=f"naive (MTF50 {res['mtf50_naive']:.1f})")
    axes[1, 2].axvline(res["nyquist"], color="gray", lw=0.8, ls=":")
    axes[1, 2].set_xlim(0, res["nyquist"] * 1.05)
    axes[1, 2].set_title(f"MTF ({res['freq_label']})")
    axes[1, 2].legend(fontsize=7)
    for ax in axes.ravel():
        ax.grid(alpha=0.2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def save_comparison_figure(results_by_pos: Dict[int, Dict],
                           out_path: str) -> None:
    """9-way overlay: naive MTFs (real blur probe), aligned MTFs, and the
    per-position MTF50 bar pair (``analyze_psf_mtf.py:533-634``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    cmap = plt.get_cmap("tab10")
    for pos, res in sorted(results_by_pos.items()):
        axes[0].plot(res["freq_naive"], res["mtf_naive"], lw=1,
                     color=cmap(pos % 10), label=f"pos{pos}")
        axes[1].plot(res["freq"], res["mtf"], lw=1, color=cmap(pos % 10))
    axes[0].set_title("naive-stack MTF (shift-jitter blur)")
    axes[1].set_title("aligned-stack MTF")
    positions = sorted(results_by_pos)
    w = 0.4
    axes[2].bar([p - w / 2 for p in positions],
                [results_by_pos[p]["mtf50_naive"] for p in positions],
                width=w, label="naive")
    axes[2].bar([p + w / 2 for p in positions],
                [results_by_pos[p]["mtf50"] for p in positions],
                width=w, label="aligned")
    axes[2].set_title("MTF50 per position")
    axes[2].set_xlabel("grid position")
    axes[0].legend(fontsize=6, ncol=2)
    axes[2].legend(fontsize=7)
    for ax in axes:
        ax.grid(alpha=0.25)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


_NPZ_KEYS = (
    "n_images psf_avg psf_std psf_naive psf_fit psf_fit_params com_avg "
    "radii_psf psf_profile_avg radial_mean radial_std freq mtf_mean mtf_std "
    "mtf_2d_avg ee_mean ee_std mtf50 mtf10 nyquist per_image_sigma_x "
    "per_image_sigma_y per_image_mtf50 per_image_mtf10 mtf50_naive "
    "mtf10_naive freq_naive mtf_naive"
).split()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("folder")
    p.add_argument("--pixel-pitch-um", type=float, default=None)
    p.add_argument("--crop-radius", type=int, default=50)
    p.add_argument("--bg-percentile", type=float, default=50.0)
    p.add_argument("--output-dir", default="results")
    p.add_argument("--no-figures", action="store_true")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the filters, shifts, FFTs and fits run "
                        "(default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    records = discover_images(args.folder)
    if not records:
        print(f"no matching sweep images in {args.folder}", file=sys.stderr)
        return 1
    positions = sorted({r["position"] for r in records})
    print(f"{len(records)} images across positions {positions}")

    os.makedirs(args.output_dir, exist_ok=True)
    dump = {}
    summary = {}
    by_pos = {}
    for pos in positions:
        paths = [r["path"] for r in records if r["position"] == pos]
        res = analyse_position(paths, args.crop_radius, args.pixel_pitch_um,
                               args.bg_percentile, device)
        if res is None:
            continue
        by_pos[pos] = res
        if not args.no_figures:
            save_position_figure(res, pos, os.path.join(
                args.output_dir, f"psf_mtf_pos{pos}.png"))
        for k in _NPZ_KEYS:
            v = res.get(k)
            if v is not None:
                dump[f"pos{pos}_{k}"] = v
        summary[f"pos{pos}"] = {
            "n": res["n_images"],
            "mtf50": res["mtf50"], "mtf10": res["mtf10"],
            "mtf50_naive": res["mtf50_naive"],
            "sigma_x": float(np.mean(res["per_image_sigma_x"])),
            "sigma_y": float(np.mean(res["per_image_sigma_y"])),
        }
        print(f"pos{pos}: n={res['n_images']} MTF50={res['mtf50']:.2f} "
              f"MTF10={res['mtf10']:.2f} naive MTF50={res['mtf50_naive']:.2f} "
              f"[{res['freq_label']}]")

    if not args.no_figures and by_pos:
        save_comparison_figure(by_pos, os.path.join(
            args.output_dir, "psf_mtf_comparison.png"))
    np.savez(os.path.join(args.output_dir, "psf_mtf_by_position_data.npz"),
             **dump)
    with open(os.path.join(args.output_dir, "summary.json"), "w") as fp:
        json.dump(summary, fp, indent=2)
    print(f"wrote {args.output_dir}/psf_mtf_by_position_data.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
