"""Offline plotting CLIs for calibration artifacts.

  * ``plot_beam_shifts``  — re-plot a ``shifts.csv`` (grid key + dx/dy vs
    tilt errorbar panels), scripted
    ``calibration_beam_shift/plot_beam_shifts.py``.
  * ``plot_depth_of_field`` — focus curve + usable-DoF shading from an
    ``autofocus_data.json``, scripted
    ``calibration_autofocus/plot_depth_of_field.py``.
  * ``plot_confidence_vs_pitch`` — decode confidence against barcode
    pitch (``eval.barcode_analysis`` draws it).

The port's copy of ``enph459_super_resolution_tpu/utils/plots.py``: host
numpy; matplotlib is imported only inside the plotting functions.

Usage:
  python -m enph459_super_resolution_tpu_torch.utils.plots beam-shifts shifts.csv out.png
  python -m enph459_super_resolution_tpu_torch.utils.plots dof autofocus_data.json out.png
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from collections import defaultdict

import numpy as np


def load_shifts(csv_path: str):
    """shifts.csv -> {axis: {position: (tilts, dx, dxs, dy, dys, label)}}."""
    data = defaultdict(lambda: defaultdict(lambda: ([], [], [], [], [], "")))
    with open(csv_path) as fp:
        for row in csv.DictReader(fp):
            axis = row["sweep_axis"]
            p = int(row["position"])
            rec = data[axis][p]
            rec[0].append(float(row["tilt_angle_deg"]))
            rec[1].append(float(row["dx_mean_px"]))
            rec[2].append(float(row["dx_std_px"]))
            rec[3].append(float(row["dy_mean_px"]))
            rec[4].append(float(row["dy_std_px"]))
            data[axis][p] = rec[:5] + (row["label"],)
    return data


def plot_beam_shifts(csv_path: str, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = load_shifts(csv_path)
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    for col, axis in enumerate(("x", "y")):
        for p, rec in sorted(data.get(axis, {}).items()):
            tilts, dx, dxs, dy, dys, label = rec
            order = np.argsort(tilts)
            t = np.asarray(tilts)[order]
            axes[0, col].errorbar(t, np.asarray(dx)[order],
                                  np.asarray(dxs)[order], ms=3, marker="o",
                                  lw=1, capsize=2, label=f"p{p} {label}")
            axes[1, col].errorbar(t, np.asarray(dy)[order],
                                  np.asarray(dys)[order], ms=3, marker="o",
                                  lw=1, capsize=2)
        axes[0, col].set_title(f"{axis}-sweep: dx vs tilt")
        axes[1, col].set_title(f"{axis}-sweep: dy vs tilt")
        for r in range(2):
            axes[r, col].set_xlabel("tilt (deg)")
            axes[r, col].set_ylabel("shift (px)")
            axes[r, col].grid(alpha=0.3)
    axes[0, 0].legend(fontsize=6, ncol=2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_depth_of_field(json_path: str, out_path: str,
                        threshold_frac: float = 0.5) -> dict:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..hw.autofocus import depth_of_field

    with open(json_path) as fp:
        data = json.load(fp)
    pos = np.asarray(data["positions"], dtype=np.float64)
    val = np.asarray(data["values"], dtype=np.float64)
    order = np.argsort(pos)
    pos, val = pos[order], val[order]
    dof, (lo, hi) = depth_of_field(pos, val, threshold_frac)

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.plot(pos, val, "o-", ms=3, lw=1)
    ax.axvspan(lo, hi, alpha=0.2, color="C2",
               label=f"DoF = {dof:.2f} mm")
    ax.axhline(val.max() * threshold_frac, ls="--", lw=0.8, color="gray")
    best = data.get("best_pos_mm", pos[np.argmax(val)])
    ax.axvline(best, ls=":", lw=0.8, color="C3",
               label=f"best = {best:.2f} mm")
    ax.set_xlabel("stage position (mm)")
    ax.set_ylabel(data.get("metric", "focus metric"))
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return {"dof_mm": dof, "span": (lo, hi), "best_pos_mm": float(best)}


def plot_confidence_vs_pitch(records, out_path: str,
                             pixel_pitch_um: float = 3.45,
                             lr_pitch_factor: int = 2,
                             n_trials: int = 25) -> None:
    """Decode-confidence-vs-barcode-pitch figure with Nyquist overlays
    (reference: ``rgb_barcodes/analysis.ipynb`` cell 14).

    One line per SR method (confidence averaged over reps at each pitch),
    vertical markers at the LR-channel Nyquist pitch (2 LR pixels per bar
    period; LR pitch = ``pixel_pitch_um * lr_pitch_factor`` for the Bayer
    red plane) and the sensor Nyquist pitch, plus a secondary axis in um.

    ``records``: iterables of dicts with keys ``method``, ``pitch_mil``,
    ``confidence`` and optionally ``decoded_text`` (annotated when set).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mil_um = 25.4
    by_method = defaultdict(lambda: defaultdict(list))
    texts = {}
    for r in records:
        by_method[r["method"]][r["pitch_mil"]].append(r["confidence"])
        if r.get("decoded_text"):
            texts[(r["method"], r["pitch_mil"])] = r["decoded_text"]

    fig, ax = plt.subplots(figsize=(8, 5))
    markers = {"Native-2x": "o", "SAA": "s", "SAA+IBP": "^"}
    for i, (method, by_pitch) in enumerate(sorted(by_method.items())):
        pitches = sorted(by_pitch)
        confs = [float(np.mean(by_pitch[p])) for p in pitches]
        ax.plot(pitches, confs, marker=markers.get(method, "o"), ms=7,
                lw=1.6, color=f"C{i}", label=method)
        for p, c in zip(pitches, confs):
            t = texts.get((method, p))
            ax.annotate(f"'{t}'" if t else "x", (p, c), fontsize=6,
                        textcoords="offset points", xytext=(4, 4),
                        color=f"C{i}", alpha=0.7)

    nyq_lr = 2 * pixel_pitch_um * lr_pitch_factor / mil_um
    nyq_sensor = 2 * pixel_pitch_um / mil_um
    ax.axvline(nyq_lr, color="gray", ls="--", alpha=0.6,
               label=f"LR Nyquist ({nyq_lr:.2f} mil)")
    ax.axvline(nyq_sensor, color="lightgray", ls=":", alpha=0.8,
               label=f"sensor Nyquist ({nyq_sensor:.2f} mil)")

    all_pitches = sorted({p for m in by_method.values() for p in m})
    ax.set_xticks(all_pitches)
    ax.set_xlim(left=0)
    ax.set_ylim(-0.05, 1.1)
    top = ax.twiny()
    top.set_xlim(np.asarray(ax.get_xlim()) * mil_um)
    top.set_xlabel("barcode pitch (um)", fontsize=10)
    ax.set_xlabel("barcode pitch (mil)")
    ax.set_ylabel(f"decode confidence (fraction of {n_trials} "
                  "jittered crops decoded)", fontsize=10)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8, loc="lower right")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("beam-shifts")
    b.add_argument("csv_path")
    b.add_argument("out_path")
    d = sub.add_parser("dof")
    d.add_argument("json_path")
    d.add_argument("out_path")
    d.add_argument("--threshold", type=float, default=0.5)
    args = p.parse_args(argv)
    if args.cmd == "beam-shifts":
        plot_beam_shifts(args.csv_path, args.out_path)
        print(f"wrote {args.out_path}")
    else:
        info = plot_depth_of_field(args.json_path, args.out_path,
                                   args.threshold)
        print(f"DoF {info['dof_mm']:.2f} mm, best {info['best_pos_mm']:.2f} "
              f"mm -> {args.out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
