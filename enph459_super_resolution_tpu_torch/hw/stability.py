"""Mechanical stability characterization (rolling-shutter edge jitter).

Re-implements ``calibration_mech_stability/rolling_stability.py`` against
the hardware protocols: N trials x 4 XPR corner positions x M burst frames;
a knife-edge is located to sub-pixel precision per frame and the per-position
edge jitter sigma quantifies mirror stability.  The per-frame edge locator is
vectorized over the whole burst (one batched reduction instead of a Python
loop over 1000 frames).

The port's copy of ``enph459_super_resolution_tpu/hw/stability.py``: host
numpy; matplotlib is imported only to draw the figures.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List

import numpy as np

from .protocols import BeamSteering, BurstCamera, get_xpr_angles


def find_edge_position(img: np.ndarray) -> float:
    """Sub-pixel knife-edge column: first mid-level crossing of the
    column-mean profile, linearly interpolated
    (``rolling_stability.py:58-67``)."""
    return float(find_edge_positions(np.asarray(img)[None])[0])


def find_edge_positions(stack: np.ndarray) -> np.ndarray:
    """Batched edge locator: (N, H, W[, C]) -> (N,) sub-pixel columns."""
    stack = np.asarray(stack)
    if stack.ndim == 4:
        stack = stack[..., 0]
    prof = stack.astype(np.float64).mean(axis=1)  # (N, W)
    mid = (prof.min(axis=1) + prof.max(axis=1)) / 2.0  # (N,)
    a = prof[:, :-1]
    b = prof[:, 1:]
    m = mid[:, None]
    crossing = ((a <= m) & (b > m)) | ((a >= m) & (b < m))
    any_cross = crossing.any(axis=1)
    first = np.argmax(crossing, axis=1)
    rows = np.arange(stack.shape[0])
    p0 = prof[rows, first]
    p1 = prof[rows, first + 1]
    denom = np.where(p1 - p0 == 0, 1.0, p1 - p0)
    frac = (mid - p0) / denom
    sub = first + frac
    fallback = np.argmin(np.abs(prof - m), axis=1).astype(np.float64)
    return np.where(any_cross, sub, fallback)


def run_single_trial(cam: BurstCamera, xpr: BeamSteering,
                     angles: np.ndarray, num_frames: int = 1000,
                     sleep_fn=time.sleep, retries: int = 1) -> Dict:
    """One trial over the 4 corner positions
    (``rolling_stability.py:70-95``): burst-capture, locate edges, retry
    once on an empty burst then hard-fail."""
    data = {}
    for p in range(4):
        xpr.set_angles(angles[p, 0], angles[p, 1])
        sleep_fn(0.02)
        images, timestamps = cam.stream_burst(num_frames)
        attempts = 0
        while len(images) == 0 and attempts < retries:
            sleep_fn(1.0)
            images, timestamps = cam.stream_burst(num_frames)
            attempts += 1
        if len(images) == 0:
            raise RuntimeError(f"camera returned 0 frames at pos{p}")
        fps = len(images) / max(timestamps[-1] / 1000.0, 1e-9)
        edges = find_edge_positions(np.stack(images))
        data[p] = {"edges": edges.tolist(),
                   "timestamps": list(timestamps), "fps": float(fps)}
    xpr.set_home()
    sleep_fn(0.05)
    return data


def save_stability_figures(all_trials: List[Dict], out_dir: str) -> None:
    """Poster figure set (``rolling_stability.py:97-237``): per-position
    sigma bar chart with across-trial error bars, sigma-vs-trial lines, an
    edge-position timeseries, and the jitter histogram."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = ["#2196F3", "#FF9800", "#4CAF50", "#E91E63"]
    sig = np.array([[float(np.std(tr[p]["edges"])) for p in range(4)]
                    for tr in all_trials])  # (trials, 4)

    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    ax = axes[0, 0]
    ax.bar(range(4), sig.mean(0), yerr=sig.std(0), capsize=4, color=colors)
    ax.set_xticks(range(4), [f"pos{p}" for p in range(4)])
    ax.set_ylabel("edge jitter sigma (px)")
    ax.set_title("mean jitter per position")

    ax = axes[0, 1]
    for p in range(4):
        ax.plot(sig[:, p], "o-", ms=3, color=colors[p], label=f"pos{p}")
    ax.set_xlabel("trial")
    ax.set_ylabel("sigma (px)")
    ax.set_title("jitter per trial")
    ax.legend(fontsize=7)

    ax = axes[1, 0]
    tr0 = all_trials[0]
    for p in range(4):
        e = np.asarray(tr0[p]["edges"])
        ax.plot(tr0[p]["timestamps"], e - e.mean(), lw=0.6,
                color=colors[p], alpha=0.8, label=f"pos{p}")
    ax.set_xlabel("time (ms)")
    ax.set_ylabel("edge - mean (px)")
    ax.set_title("edge position timeseries (trial 0)")
    ax.legend(fontsize=7)

    ax = axes[1, 1]
    for p in range(4):
        devs = np.concatenate([np.asarray(tr[p]["edges"])
                               - np.mean(tr[p]["edges"])
                               for tr in all_trials])
        ax.hist(devs, bins=40, alpha=0.5, color=colors[p], label=f"pos{p}")
    ax.set_xlabel("edge deviation (px)")
    ax.set_title("jitter histogram")
    ax.legend(fontsize=7)

    for ax in axes.ravel():
        ax.grid(alpha=0.25)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "stability_figures.png"), dpi=110)
    plt.close(fig)


def run_stability(cam: BurstCamera, xpr: BeamSteering, out_dir: str,
                  tilt_deg: float = 0.14391, n_trials: int = 10,
                  num_frames: int = 1000, sleep_fn=time.sleep,
                  figures: bool = True) -> Dict:
    """Full stability run + CSV/JSON summaries + poster figures
    (``rolling_stability.py:288-331``)."""
    os.makedirs(out_dir, exist_ok=True)
    angles = get_xpr_angles(tilt_deg)
    all_trials: List[Dict] = []
    for t in range(n_trials):
        all_trials.append(run_single_trial(cam, xpr, angles, num_frames,
                                           sleep_fn))
    if figures:
        save_stability_figures(all_trials, out_dir)

    summary = {"tilt_deg": tilt_deg, "n_trials": n_trials,
               "num_frames": num_frames, "positions": {}}
    rows = []
    for p in range(4):
        sigmas = [float(np.std(tr[p]["edges"])) for tr in all_trials]
        means = [float(np.mean(tr[p]["edges"])) for tr in all_trials]
        fps = [tr[p]["fps"] for tr in all_trials]
        summary["positions"][f"pos{p}"] = {
            "sigma_mean_px": float(np.mean(sigmas)),
            "sigma_std_px": float(np.std(sigmas)),
            "edge_mean_px": float(np.mean(means)),
            "fps_mean": float(np.mean(fps)),
        }
        for t, s in enumerate(sigmas):
            rows.append([t, p, s, means[t], fps[t]])

    with open(os.path.join(out_dir, "stability_summary.json"), "w") as fp:
        json.dump(summary, fp, indent=2)
    with open(os.path.join(out_dir, "stability_trials.csv"), "w",
              newline="") as fp:
        w = csv.writer(fp)
        w.writerow(["trial", "position", "edge_sigma_px", "edge_mean_px",
                    "fps"])
        w.writerows(rows)
    return summary
