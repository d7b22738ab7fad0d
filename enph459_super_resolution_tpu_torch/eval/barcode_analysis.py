"""Barcode decode-confidence analysis CLI — scripted
``rgb_barcodes/analysis.ipynb``.

For each session's ROI list (barcode crops + pitch in mil, supplied as a
JSON file mirroring the notebook's SESSION_ROIS dict), decodes every SR
method's output with the jittered-crop confidence protocol (25 trials,
+/-2 px, seed 42) and writes a confidence-vs-pitch table + plot.

ROI JSON schema:
  {"<session>": [{"label": "2 mil", "roi": [r0, r1, c0, c1],
                  "pitch_mil": 2}, ...], ...}

Requires the optional zxing-cpp wheel for real decoding; ``--decoder none``
runs the harness without decoding (pipeline dry-run).

The port's copy of ``enph459_super_resolution_tpu/eval/barcode_analysis.py``.
It runs on the host only (PNG decode and the pure-Python decoders), as the
reference's does, so it takes no ``--device``.  ``--figure none`` skips the
figure (``utils.plots.plot_confidence_vs_pitch``), whose matplotlib import
is made only when it is drawn.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

from ..data.io import load_gray
from .decode import HAVE_ZXING, decode_confidence

#: decode targets per rep dir; files absent in a dir are skipped, so the
#: learned engine's output (written only under ``sr.run --fusion-run``)
#: rides the same protocol when present
METHODS = [("Native-2x", "native_2x.png"), ("SAA", "SAA.png"),
           ("SAA+IBP", "SAA_IBP.png"), ("Fusion", "fusion.png")]

#: Corrected ROIs for the reference's real rgb_barcodes sessions
#: (``--rois rgb``).  The notebook's checked-in SESSION_ROIS truncate the
#: barcodes — its "6 mil" ROI ends at col 1640 but the symbol's stop
#: pattern ends at col 1744 (measured on the checked-in SAA_IBP.png), so
#: no decoder can succeed inside it.  These boxes cover start quiet zone
#: through stop for each symbol, measured with ``eval.code128`` on the
#: checked-in rep00 results (HR 1536 x 2048 coordinates, like the
#: notebook's).
RGB_SESSION_ROIS = {
    "2_3_5_mil_color_tilt 0.28256_settle50ms": [
        {"label": "2 mil", "roi": (900, 1260, 380, 950), "pitch_mil": 2},
        {"label": "3 mil", "roi": (900, 1260, 990, 1720), "pitch_mil": 3},
        {"label": "5 mil", "roi": (400, 800, 380, 1540), "pitch_mil": 5},
    ],
    "4_6_mil_color_tilt 0.28256_settle50ms": [
        {"label": "4 mil", "roi": (800, 1200, 600, 1545), "pitch_mil": 4},
        {"label": "6 mil", "roi": (400, 760, 460, 1800), "pitch_mil": 6},
    ],
}


def analyse_session(results_session_dir: str, rois, n_trials: int = 25,
                    max_jitter: int = 2, seed: int = 42,
                    decoder=None) -> Dict:
    """Decode confidence per (rep, method, barcode ROI)."""
    out = {"session": os.path.basename(results_session_dir), "records": []}
    reps = sorted(d for d in os.listdir(results_session_dir)
                  if d.startswith("rep"))
    rep_dirs = ([os.path.join(results_session_dir, r) for r in reps]
                or [results_session_dir])
    for rep_dir in rep_dirs:
        for method, fname in METHODS:
            path = os.path.join(rep_dir, fname)
            if not os.path.exists(path):
                continue
            img = load_gray(path, dtype=np.float64).astype(np.uint8)
            for bc in rois:
                text, conf = decode_confidence(
                    img, tuple(bc["roi"]), n_trials=n_trials,
                    max_jitter=max_jitter, seed=seed, decoder=decoder)
                out["records"].append({
                    "rep": os.path.basename(rep_dir),
                    "method": method,
                    "label": bc["label"],
                    "pitch_mil": bc["pitch_mil"],
                    "decoded_text": text,
                    "confidence": conf,
                })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_dir", help="results/ root containing sessions")
    p.add_argument("--rois", required=True,
                   help="JSON file: {session: [{label, roi, pitch_mil}]}; "
                        "or the literal 'rgb' for the built-in corrected "
                        "boxes of the reference's real rgb_barcodes "
                        "sessions (RGB_SESSION_ROIS)")
    p.add_argument("--n-trials", type=int, default=25)
    p.add_argument("--max-jitter", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default=None,
                   help="output JSON (default: <results_dir>/decode_confidence.json)")
    p.add_argument("--figure", default=None,
                   help="confidence-vs-pitch PNG with Nyquist overlays "
                        "(default: <results_dir>/confidence_vs_pitch.png; "
                        "'none' to skip)")
    p.add_argument("--pixel-pitch-um", type=float, default=3.45,
                   help="sensor pixel pitch for the Nyquist markers")
    p.add_argument("--lr-pitch-factor", type=int, default=2,
                   help="LR pixel pitch / sensor pitch (2 for the Bayer "
                        "red plane, 1 for mono)")
    p.add_argument("--decoder", default="zxing",
                   choices=["zxing", "code128", "ean13", "none"],
                   help="'code128' uses the built-in pure-Python Code 128 "
                        "decoder (eval.code128 — the symbology on the "
                        "reference's real sheets; no native wheel needed); "
                        "'ean13' the EAN-13 one (eval.ean13); 'none' "
                        "dry-runs the harness")
    args = p.parse_args(argv)

    decoder = None
    if args.decoder == "none":
        decoder = lambda img: None  # noqa: E731 — explicit stub
    elif args.decoder == "code128":
        from .code128 import decode as decoder  # noqa: F811
    elif args.decoder == "ean13":
        from .ean13 import decode as decoder  # noqa: F811
    elif not HAVE_ZXING:
        print("ERROR: zxing-cpp not installed; install the 'zxingcpp' wheel "
              "or pass --decoder none for a dry run", file=sys.stderr)
        return 2

    if args.rois == "rgb":
        session_rois = RGB_SESSION_ROIS
    else:
        with open(args.rois) as fp:
            session_rois = json.load(fp)

    results = []
    for session, rois in session_rois.items():
        sdir = os.path.join(args.results_dir, session)
        if not os.path.isdir(sdir):
            print(f"  skip missing session {session}", file=sys.stderr)
            continue
        res = analyse_session(sdir, rois, args.n_trials, args.max_jitter,
                              args.seed, decoder=decoder)
        results.append(res)
        for r in res["records"]:
            print(f"{session} {r['rep']:>5s} {r['method']:>10s} "
                  f"{r['pitch_mil']:>2d} mil: conf={r['confidence']:.2f} "
                  f"text={r['decoded_text']!r}")

    out_path = args.out or os.path.join(args.results_dir,
                                        "decode_confidence.json")
    with open(out_path, "w") as fp:
        json.dump({"n_trials": args.n_trials, "max_jitter": args.max_jitter,
                   "seed": args.seed, "sessions": results}, fp, indent=2)
    print(f"wrote {out_path}")

    if args.figure != "none":
        fig_path = args.figure or os.path.join(args.results_dir,
                                               "confidence_vs_pitch.png")
        records = [r for res in results for r in res["records"]]
        if records:
            from ..utils.plots import plot_confidence_vs_pitch

            plot_confidence_vs_pitch(records, fig_path,
                                     pixel_pitch_um=args.pixel_pitch_um,
                                     lr_pitch_factor=args.lr_pitch_factor,
                                     n_trials=args.n_trials)
            print(f"wrote {fig_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
