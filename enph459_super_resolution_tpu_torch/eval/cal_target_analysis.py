"""Cal-target analysis CLI — the scripted, testable version of
``{mono,rgb}_cal_target/analysis.ipynb``.

Given a results directory (``native_2x.png``, ``SAA.png``, ``SAA_IBP.png``,
``LR_mean.png``/``LR_red_mean.png``), computes per method:
  * ROI-1: vertical cross-section profile + Michelson local contrast
    through the bar groups (notebook cells 3-4);
  * ROI-2: slanted-edge ESF/LSF/MTF with MTF50/MTF10 in cycles/mm
    (cells 7-10; HR pitch = sensor pitch / upsample);
and writes ``analysis.json`` + figures.

The port's counterpart of
``enph459_super_resolution_tpu/eval/cal_target_analysis.py``: the LR
mean's bicubic zoom (float32, as the reference's) and the edge gradients
(float64) run on ``--device`` (CUDA unless ``--device cpu`` is given;
asking for CUDA without a card is an error, never a fallback).

Usage:
  python -m enph459_super_resolution_tpu_torch.eval.cal_target_analysis \
      <results/session_dir> [--preset mono_cal_target] [--profile-col 2700] \
      [--roi1-rows 1240 1560] [--roi2 1100 1400 1500 1800] \
      [--pixel-pitch-um 3.45] [--upsample 2] [--no-figures] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

from ..data.io import load_gray
from ..device import DEVICES, resolve_device
from ..psf.toolkit import mtf_at_fraction
from .metrics import local_contrast
from .slanted_edge import EdgeNotFound, esf_to_mtf, slanted_edge_esf

METHODS = [("Native-2x", "native_2x.png"), ("SAA", "SAA.png"),
           ("SAA+IBP", "SAA_IBP.png")]

# The notebooks' hand-picked geometry, verbatim (the ROIs are properties of
# the physical ISO-12233 chart layout in the checked-in captures, so they
# are data, not tunables):
#   mono: ``mono_cal_target/analysis.ipynb`` cell 3 (PROFILE_COL_HR=2700,
#     ROI1 rows 1240:1560), cell 6 (ROI2_LR (950:1050, 1280:1380) -> HR
#     (1900:2100, 2560:2760)), cell 9 (HR pitch = 3.45 um / 2).
#   rgb: ``rgb_cal_target/analysis.ipynb`` cell 4 (col 1350, rows 620:780),
#     cell 7 (ROI2_HR (475:525, 640:690)), cell 10 (red-channel HR pitch =
#     sensor 3.45 um x Bayer 2 / SR 2 = 3.45 um, expressed here as an
#     effective 6.9 um red-LR pitch / 2x upsample).
PRESETS = {
    "mono_cal_target": dict(profile_col=2700, roi1_rows=(1240, 1560),
                            roi2=(1900, 2100, 2560, 2760),
                            pixel_pitch_um=3.45, upsample=2),
    "rgb_cal_target": dict(profile_col=1350, roi1_rows=(620, 780),
                           roi2=(475, 525, 640, 690),
                           pixel_pitch_um=6.9, upsample=2),
}


def load_results_dir(results_dir: str,
                     device="cuda") -> Dict[str, np.ndarray]:
    """HR method images + bicubic-2x of the LR mean as the baseline
    (notebook cell 3); the zoom runs in float32 on ``device``."""
    import torch

    from ..ops.resample import spline_zoom

    out = {}
    lr_name = ("LR_mean.png" if os.path.exists(
        os.path.join(results_dir, "LR_mean.png")) else "LR_red_mean.png")
    lr_mean = load_gray(os.path.join(results_dir, lr_name), dtype=np.float64)
    out["LR bicubic 2x"] = spline_zoom(torch.as_tensor(
        lr_mean, dtype=torch.float32, device=device), 2).cpu().numpy(
    ).astype(np.float64)
    for name, fname in METHODS:
        path = os.path.join(results_dir, fname)
        if os.path.exists(path):
            out[name] = load_gray(path, dtype=np.float64)
    return out


def analyse(results_dir: str, profile_col: int = 2700,
            roi1_rows=(1240, 1560), roi2=(1900, 2100, 2560, 2760),
            pixel_pitch_um: Optional[float] = 3.45, upsample: int = 2,
            contrast_window: int = 16, side: str = "left",
            device="cuda") -> Dict:
    imgs = load_results_dir(results_dir, device)
    hr_pitch_mm = (pixel_pitch_um * 1e-3 / upsample) if pixel_pitch_um else None

    out: Dict = {"results_dir": results_dir, "methods": {},
                 "profile_col_hr": profile_col,
                 "roi1_rows_hr": list(roi1_rows), "roi2_hr": list(roi2),
                 "hr_pitch_mm": hr_pitch_mm}
    r0, r1 = roi1_rows
    e0, e1, c0, c1 = roi2
    for name, img in imgs.items():
        rec: Dict = {}
        if img.shape[0] >= r1 and img.shape[1] > profile_col:
            profile = img[r0:r1, profile_col]
            ct = local_contrast(profile, contrast_window)
            rec["profile"] = profile.tolist()
            rec["contrast_peak"] = float(ct.max())
            rec["contrast_mean"] = float(ct[ct > 0].mean()) if (ct > 0).any() \
                else 0.0
        if img.shape[0] >= e1 and img.shape[1] >= c1:
            try:
                roi = img[e0:e1, c0:c1]
                esf_x, esf_y, angle = slanted_edge_esf(roi, side=side,
                                                       device=device)
                freq, mtf, _ = esf_to_mtf(esf_x, esf_y)
                if hr_pitch_mm:
                    freq_out = freq / hr_pitch_mm
                    nyq = 1.0 / (2.0 * hr_pitch_mm)
                    unit = "cycles/mm"
                else:
                    freq_out, nyq, unit = freq, 0.5, "cycles/px"
                sel = (freq_out >= 0) & (freq_out <= nyq)
                # *_full: the notebooks' summary-table semantics (cell 10/11:
                # ``valid = freq > 0`` with NO Nyquist cap — a crossing above
                # Nyquist is reported, not nan'd); the capped values are the
                # physically meaningful ones.
                full = freq_out > 0
                rec.update(
                    edge_angle_deg=angle,
                    mtf50=mtf_at_fraction(freq_out[sel], mtf[sel], 0.5),
                    mtf10=mtf_at_fraction(freq_out[sel], mtf[sel], 0.1),
                    mtf50_full=mtf_at_fraction(freq_out[full], mtf[full], 0.5),
                    mtf10_full=mtf_at_fraction(freq_out[full], mtf[full], 0.1),
                    nyquist=nyq, freq_unit=unit,
                )
            except EdgeNotFound as exc:  # no detectable edge in ROI
                rec["edge_error"] = str(exc)
        out["methods"][name] = rec
    return out


def save_figures(analysis: Dict, out_dir: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r0, r1 = analysis["roi1_rows_hr"]
    rows = np.arange(r0, r1)
    fig, axes = plt.subplots(1, 2, figsize=(14, 4))
    for i, (name, rec) in enumerate(analysis["methods"].items()):
        if "profile" not in rec:
            continue
        prof = np.asarray(rec["profile"])
        axes[0].plot(rows, prof, lw=0.9, label=name, color=f"C{i}")
        axes[1].plot(rows, local_contrast(prof, 16), lw=0.9, label=name,
                     color=f"C{i}")
    axes[0].set_title("Vertical cross-section")
    axes[1].set_title("Local Michelson contrast")
    for ax in axes:
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "cross_section.png"), dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_dir")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="notebook geometry preset: sets profile-col/"
                        "roi1-rows/roi2/pixel-pitch/upsample to the "
                        "corresponding analysis.ipynb values (explicit "
                        "flags still override)")
    p.add_argument("--profile-col", type=int, default=None)
    p.add_argument("--roi1-rows", type=int, nargs=2, default=None)
    p.add_argument("--roi2", type=int, nargs=4, default=None,
                   help="slanted-edge ROI: r0 r1 c0 c1 (HR px)")
    p.add_argument("--pixel-pitch-um", type=float, default=None)
    p.add_argument("--upsample", type=int, default=None)
    p.add_argument("--side", choices=["left", "right"], default="left")
    p.add_argument("--no-figures", action="store_true")
    p.add_argument("--out-dir", default=None,
                   help="where to write analysis.json/figures "
                        "(default: the results dir)")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the zoom and the edge filters run (default "
                        "cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    base = dict(PRESETS["mono_cal_target"] if args.preset is None
                else PRESETS[args.preset])
    for flag, key in (("profile_col", "profile_col"),
                      ("roi1_rows", "roi1_rows"), ("roi2", "roi2"),
                      ("pixel_pitch_um", "pixel_pitch_um"),
                      ("upsample", "upsample")):
        v = getattr(args, flag)
        if v is not None:
            base[key] = tuple(v) if isinstance(v, list) else v

    analysis = analyse(args.results_dir, base["profile_col"],
                       tuple(base["roi1_rows"]), tuple(base["roi2"]),
                       base["pixel_pitch_um"], base["upsample"],
                       side=args.side, device=device)
    out_dir = args.out_dir or args.results_dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "analysis.json")
    slim = {k: v for k, v in analysis.items()}
    slim["methods"] = {
        m: {k: v for k, v in rec.items() if k != "profile"}
        for m, rec in analysis["methods"].items()}
    with open(path, "w") as fp:
        json.dump(slim, fp, indent=2)
    if not args.no_figures:
        save_figures(analysis, out_dir)

    print(f"{'method':>14s}  {'MTF50':>8s}  {'MTF10':>8s}  {'contrast':>8s}")
    for m, rec in slim["methods"].items():
        print(f"{m:>14s}  {rec.get('mtf50', float('nan')):8.2f}  "
              f"{rec.get('mtf10', float('nan')):8.2f}  "
              f"{rec.get('contrast_peak', float('nan')):8.3f}")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
