"""Session discovery + loading for the three on-disk capture layouts.

Counterpart of ``enph459_super_resolution_tpu/data/sessions.py``.

The reference has four near-identical ``run_sr.py`` scripts, each with its
own loader; here one module handles all layouts (SURVEY.md §2 items 14-17):

  * ``center_shift``  — ``center.png`` + ``shift_{0-3}.png``, hardcoded
    nominal shifts (``mono_cal_target/run_sr.py:60-66``).
  * ``corner_rep``    — ``corner{c}_rep{NN}.png`` flat; per-rep processing
    (barcodes, ``mono_barcodes/run_sr.py:102-127``) or rep-averaged
    (``rgb_cal_target/run_sr.py:98-113``).

Shift sources:

  * hardcoded corner table (±0.5 LR px, ``mono_barcodes/run_sr.py:71-77``)
  * ``metadata.json`` with either ``expected_shifts{label: {dy_px, dx_px}}``
    or ``corners{label: {expected_dy_px, expected_dx_px}}`` schema, sensor
    px halved to red-LR px (``rgb_cal_target/run_sr.py:88-96``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .io import extract_red, load_gray

# Diagonal-corner geometry shared by every 4-corner workload:
# corner index -> label and nominal (dy, dx) shift in LR pixels.
CORNER_LABELS = ("(-x,+y)", "(+x,+y)", "(-x,-y)", "(+x,-y)")
CORNER_SHIFTS_LR = ((+0.5, -0.5), (+0.5, +0.5), (-0.5, -0.5), (-0.5, +0.5))

# center+4 layout: filename -> nominal (dy, dx) in LR pixels.
CENTER_SHIFT_FILES = (
    ("center.png", (0.0, 0.0)),
    ("shift_0.png", (+0.5, -0.5)),
    ("shift_1.png", (+0.5, +0.5)),
    ("shift_2.png", (-0.5, -0.5)),
    ("shift_3.png", (-0.5, +0.5)),
)

_CORNER_REP_RE = re.compile(r"corner(\d+)_rep(\d+)\.png$")


@dataclasses.dataclass
class SessionData:
    """One unit of SR work: a stack of registered LR frames + their shifts."""

    name: str
    rep: Optional[int]  # None when reps were averaged / absent
    frames: np.ndarray  # f32[N, h, w]
    shifts: Tuple[Tuple[float, float], ...]  # (dy, dx) LR px, static


def discover_sessions(data_dir: str) -> List[str]:
    """Sorted session directories under ``data_dir``
    (``mono_barcodes/run_sr.py:374-378``)."""
    return sorted(
        os.path.join(data_dir, d)
        for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d))
    )


def metadata_shifts(meta: Dict, scale: float = 0.5) -> Dict[str, Tuple[float, float]]:
    """Per-corner-label (dy, dx) from either metadata schema, scaled from
    sensor px to LR px (``rgb_cal_target/run_sr.py:88-96``)."""
    out = {}
    if "expected_shifts" in meta:
        for label, s in meta["expected_shifts"].items():
            out[label] = (s["dy_px"] * scale, s["dx_px"] * scale)
    elif "corners" in meta:
        for label, c in meta["corners"].items():
            out[label] = (c["expected_dy_px"] * scale, c["expected_dx_px"] * scale)
    else:
        raise KeyError("metadata.json has neither 'expected_shifts' nor 'corners'")
    return out


def _maybe_red(img: np.ndarray, bayer_red: bool) -> np.ndarray:
    return np.ascontiguousarray(extract_red(img)) if bayer_red else img


def load_center_shift_session(session_dir: str, bayer_red: bool = False,
                              dtype=np.float32) -> SessionData:
    """center.png + shift_{0-3}.png layout; missing frames are skipped with
    a warning, >=2 required (``mono_cal_target/run_sr.py:77-97``)."""
    frames, shifts = [], []
    for fname, (dy, dx) in CENTER_SHIFT_FILES:
        path = os.path.join(session_dir, fname)
        if not os.path.exists(path):
            print(f"  WARNING: {fname} not found, skipping")
            continue
        frames.append(_maybe_red(load_gray(path, dtype), bayer_red))
        shifts.append((dy, dx))
    if len(frames) < 2:
        raise FileNotFoundError(f"need at least 2 frames in {session_dir}")
    return SessionData(
        name=os.path.basename(session_dir),
        rep=None,
        frames=np.stack(frames),
        shifts=tuple(shifts),
    )


def _discover_reps(session_dir: str) -> List[int]:
    reps = set()
    for fname in os.listdir(session_dir):
        m = _CORNER_REP_RE.match(fname)
        if m:
            reps.add(int(m.group(2)))
    return sorted(reps)


def load_corner_rep_sessions(session_dir: str, bayer_red: bool = False,
                             average_reps: bool = False,
                             shifts: Optional[Sequence[Tuple[float, float]]] = None,
                             shift_scale: float = 0.5,
                             dtype=np.float32) -> List[SessionData]:
    """corner{c}_rep{NN}.png layout.

    ``average_reps=False`` yields one :class:`SessionData` per rep
    (barcodes, ``mono_barcodes/run_sr.py:119-130,301``); ``True`` averages
    reps per corner into a single 4-frame unit
    (``rgb_cal_target/run_sr.py:98-113``).

    ``shifts=None`` uses the nominal corner table unless a ``metadata.json``
    with a shift schema exists and ``average_reps`` (cal-target behavior).
    """
    name = os.path.basename(session_dir)
    rep_ids = _discover_reps(session_dir)
    if not rep_ids:
        raise FileNotFoundError(f"no corner*_rep*.png files in {session_dir}")

    if shifts is None:
        meta_path = os.path.join(session_dir, "metadata.json")
        if average_reps and os.path.exists(meta_path):
            with open(meta_path) as fp:
                by_label = metadata_shifts(json.load(fp), scale=shift_scale)
            shifts = tuple(by_label[label] for label in CORNER_LABELS)
        else:
            shifts = CORNER_SHIFTS_LR
    shifts = tuple(tuple(s) for s in shifts)

    from .io import load_gray_batch

    paths = []
    for ci in range(4):
        for ri in rep_ids:
            path = os.path.join(session_dir, f"corner{ci}_rep{ri:02d}.png")
            if not os.path.exists(path):
                raise FileNotFoundError(f"missing {path}")
            paths.append(path)
    decoded = load_gray_batch(paths, dtype)
    frames_by = {}
    for (ci, ri), img in zip(((c, r) for c in range(4) for r in rep_ids),
                             decoded):
        frames_by[(ci, ri)] = _maybe_red(img, bayer_red)

    if average_reps:
        frames = np.stack([
            np.mean([frames_by[(ci, ri)] for ri in rep_ids],
                    axis=0).astype(dtype)
            for ci in range(4)
        ])
        return [SessionData(name=name, rep=None, frames=frames,
                            shifts=shifts)]

    out = []
    for ri in rep_ids:
        frames = np.stack([frames_by[(ci, ri)] for ci in range(4)])
        out.append(SessionData(name=name, rep=ri, frames=frames,
                               shifts=shifts))
    return out
