"""Session-level SR pipeline: load -> device solve -> artifacts on disk.

Counterpart of ``enph459_super_resolution_tpu/sr/pipeline.py``.  Reproduces
the reference's session workflow (``mono_barcodes/run_sr.py:293-351``): per
session/rep ``native_2x.png``, ``SAA.png``, ``SAA_IBP.png``,
``LR_mean.png``, ``comparison.png``, ``convergence.png`` and an idempotent
``done.flag`` sentinel, plus a ``metrics.json`` with per-stage wall-clock
and the full MSE history.  With a learned burst engine
(:class:`~.fusion.FusionEngine`, ``sr.run --fusion-run``) each unit also
gets ``fusion.png`` and its forward-model MSE, side by side with the
classical engine's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.io import save_png
from ..data.sessions import SessionData
from ..utils.timing import StageTimer
from .classical import solve, solve_batch, to_uint8
from .config import WorkloadConfig


def _unit_out_dir(output_base: str, session: SessionData) -> str:
    out = os.path.join(output_base, session.name)
    if session.rep is not None:
        out = os.path.join(out, f"rep{session.rep}")
    return out


def save_figures(hr_images: Dict[str, np.ndarray], lr_mean: np.ndarray,
                 mse_history: np.ndarray, out_dir: str, title: str) -> None:
    """comparison.png (full view + center crop per method) and
    convergence.png (IBP MSE curve), reference-style.  Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = next(iter(hr_images.values())).shape
    cr = slice(max(h // 2 - 100, 0), h // 2 + 100)
    cc = slice(max(w // 2 - 100, 0), w // 2 + 100)
    n = len(hr_images) + 1
    fig, axes = plt.subplots(2, n, figsize=(4 * n, 8))
    ds = 4
    axes[0, 0].imshow(lr_mean[::ds, ::ds], cmap="gray", interpolation="nearest")
    axes[0, 0].set_title("LR mean", fontsize=9)
    axes[1, 0].imshow(lr_mean[cr, cc][::2, ::2], cmap="gray",
                      interpolation="nearest")
    axes[1, 0].set_title("LR crop", fontsize=8)
    for i, (name, img) in enumerate(hr_images.items(), 1):
        axes[0, i].imshow(img[::ds * 2, ::ds * 2], cmap="gray",
                          interpolation="nearest")
        axes[0, i].set_title(name, fontsize=9)
        axes[1, i].imshow(img[cr, cc], cmap="gray", interpolation="nearest")
        axes[1, i].set_title(name, fontsize=8)
    for ax in axes.ravel():
        ax.axis("off")
    fig.suptitle(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "comparison.png"), bbox_inches="tight",
                dpi=100)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(mse_history, lw=1.5, color="C3")
    ax.set_title("IBP convergence")
    ax.set_xlabel("Iteration")
    ax.set_ylabel("MSE")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "convergence.png"), bbox_inches="tight")
    plt.close(fig)


def process_unit(session: SessionData, psf: np.ndarray, cfg: WorkloadConfig,
                 output_base: str, figures: bool = True,
                 force: bool = False, device="cuda", band_store: str = "f32",
                 fused: str = "auto", mm_precision: str = "HIGHEST",
                 solver: str = "ibp", engine: str = "mm",
                 fusion=None) -> Optional[str]:
    """Run one SR unit (a session or one rep) end to end; ``band_store``,
    ``fused``, ``mm_precision``, ``solver`` and ``engine`` are
    :func:`~.classical.solve`'s.  ``fusion`` (a
    :class:`~.fusion.FusionEngine`) runs after the solve, in the ``fusion``
    stage: ``fusion.png``, ``fusion_forward_mse`` and, when it refines,
    ``fusion_forward_mse_raw``.

    Returns the output dir, or None when skipped via ``done.flag``
    (idempotent resume, ``mono_barcodes/run_sr.py:306-308``).
    """
    out_dir = _unit_out_dir(output_base, session)
    done_flag = os.path.join(out_dir, "done.flag")
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(done_flag) and not force:
        print(f"  [skip] {out_dir} - already done")
        return None

    timer = StageTimer()
    with timer.stage("h2d"):
        frames = torch.as_tensor(session.frames, device=device)
    with timer.stage("solve"):
        result = solve(frames, psf, session.shifts,
                       factor=cfg.upsample_factor,
                       n_iter=cfg.ibp_iterations, step=cfg.ibp_step,
                       device=device, band_store=band_store, fused=fused,
                       mm_precision=mm_precision, solver=solver,
                       engine=engine)
    if fusion is not None:
        fusion.check(int(frames.shape[0]), cfg.upsample_factor)
        with timer.stage("fusion"):
            sr, fwd_mse, fwd_mse_raw = fusion(frames, session.shifts, psf)
            result["fusion"] = sr
            result["fusion_forward_mse"] = float(fwd_mse)
            if fusion.refine > 0:
                result["fusion_forward_mse_raw"] = float(fwd_mse_raw)
    return _write_unit_artifacts(session, result, cfg, output_base, figures,
                                 timer)


def _write_unit_artifacts(session: SessionData, result: Dict,
                          cfg: WorkloadConfig, output_base: str,
                          figures: bool, timer: StageTimer) -> str:
    """Persist one unit's outputs (reference artifact schema + metrics)."""
    out_dir = _unit_out_dir(output_base, session)
    os.makedirs(out_dir, exist_ok=True)
    with timer.stage("save"):
        hr_images = {
            "Native-2x": to_uint8(result["native"]),
            "SAA": to_uint8(result["saa"]),
            "SAA+IBP": to_uint8(result["ibp"]),
        }
        name_map = {"Native-2x": "native_2x", "SAA": "SAA",
                    "SAA+IBP": "SAA_IBP"}
        if "fusion" in result:  # learned burst engine (additive artifact)
            hr_images["Fusion"] = to_uint8(result["fusion"])
            name_map["Fusion"] = "fusion"
        for name, img in hr_images.items():
            save_png(img, os.path.join(out_dir, f"{name_map[name]}.png"))
        save_png(to_uint8(result["lr_mean"]),
                 os.path.join(out_dir, cfg.lr_mean_name))
        with open(os.path.join(out_dir, "shifts.json"), "w") as fp:
            json.dump({"shifts_lr_yx": [list(s) for s in session.shifts],
                       "corner_labels": None if session.rep is None and
                       cfg.layout == "center_shift" else
                       ["(-x,+y)", "(+x,+y)", "(-x,-y)", "(+x,-y)"]}, fp,
                      indent=2)

    if figures:
        with timer.stage("figures"):
            title = f"{cfg.name} SR - {session.name}" + (
                f" rep{session.rep}" if session.rep is not None else "")
            save_figures(hr_images, result["lr_mean"],
                         result["mse_history"], out_dir, title)

    metrics = {
        "workload": cfg.name,
        "session": session.name,
        "rep": session.rep,
        "n_frames": int(session.frames.shape[0]),
        "lr_shape": list(session.frames.shape[1:]),
        "hr_shape": list(result["ibp"].shape),
        "ibp_iterations": cfg.ibp_iterations,
        "final_mse": float(result["mse_history"][-1]),
        "mse_history": [float(v) for v in result["mse_history"]],
        "timings_s": timer.as_dict(),
        "hr_megapixels": float(np.prod(result["ibp"].shape)) / 1e6,
    }
    for key in ("fusion_forward_mse", "fusion_forward_mse_raw"):
        if key in result:
            metrics[key] = result[key]
    with open(os.path.join(out_dir, "metrics.json"), "w") as fp:
        json.dump(metrics, fp, indent=2)

    open(os.path.join(out_dir, "done.flag"), "w").close()
    print(f"  done: {out_dir}  (solve {timer.as_dict().get('solve', 0):.2f}s,"
          f" final MSE {metrics['final_mse']:.4f})")
    return out_dir


def process_session_dir(session_dir: str, psf: np.ndarray, cfg: WorkloadConfig,
                        output_base: str, figures: bool = True,
                        force: bool = False, batch_reps: bool = True,
                        device="cuda", band_store: str = "f32",
                        fused: str = "auto", mm_precision: str = "HIGHEST",
                        solver: str = "ibp", engine: str = "mm") -> int:
    """Load all units in a session directory and process them; with
    ``batch_reps`` (default) same-shaped pending units solve as ONE
    batched device call (:func:`~.classical.solve_batch`) on the ``mm``
    engine (the ``conv`` engine solves them one at a time).  The solve
    options are :func:`~.classical.solve`'s."""
    opts = dict(device=device, band_store=band_store, fused=fused,
                mm_precision=mm_precision, solver=solver, engine=engine)
    t0 = time.time()
    units = cfg.load(session_dir)
    print(f"Session {os.path.basename(session_dir)}: {len(units)} unit(s), "
          f"loaded in {time.time() - t0:.1f}s")

    pending = []
    for unit in units:
        out_dir = _unit_out_dir(output_base, unit)
        if os.path.exists(os.path.join(out_dir, "done.flag")) and not force:
            print(f"  [skip] {out_dir} - already done")
            continue
        pending.append(unit)

    same_shape = len({u.frames.shape for u in pending}) == 1
    same_shifts = len({u.shifts for u in pending}) == 1
    if batch_reps and engine == "mm" and len(pending) > 1 and same_shape \
            and same_shifts:
        return _solve_units_batched(pending, psf, cfg, output_base, figures,
                                    opts)

    n = 0
    for unit in pending:
        if process_unit(unit, psf, cfg, output_base, figures, force=True,
                        **opts) is not None:
            n += 1
    return n


def _solve_units_batched(pending, psf, cfg, output_base, figures,
                         opts) -> int:
    """Solve same-shaped units as ONE device call (``opts``: the solve
    options) and write per-unit artifacts.  Returns the number of units
    whose artifacts were written."""
    timer = StageTimer()
    with timer.stage("solve_batch"):
        batched = solve_batch(np.stack([u.frames for u in pending]), psf,
                              pending[0].shifts,
                              factor=cfg.upsample_factor,
                              n_iter=cfg.ibp_iterations,
                              step=cfg.ibp_step, **opts)
    t_batch = timer.as_dict()["solve_batch"]
    print(f"  batched solve of {len(pending)} unit(s): {t_batch:.2f}s")
    n_written = 0
    for i, unit in enumerate(pending):
        result = {k: v[i] for k, v in batched.items()}
        # fresh per-unit timer: the batch solve is amortized evenly so
        # each metrics.json reports its own share, not the batch total
        unit_timer = StageTimer()
        unit_timer._t["solve"] = t_batch / len(pending)
        unit_timer._t["solve_batch_total"] = t_batch
        _write_unit_artifacts(unit, result, cfg, output_base, figures,
                              unit_timer)
        n_written += 1
    return n_written


def process_workload(session_dirs, psf, cfg, output_base, figures=True,
                     force=False, batch_reps=True, max_batch: int = 4,
                     device="cuda", band_store: str = "f32",
                     fused: str = "auto", mm_precision: str = "HIGHEST",
                     solver: str = "ibp", engine: str = "mm",
                     fusion=None) -> int:
    """Process many sessions with CROSS-SESSION unit batching: every
    pending unit across the workload joins one stream, and runs of
    consecutive units with identical (shape, shifts) solve as single
    batched device calls of up to ``max_batch`` (``mm`` engine; the
    ``conv`` engine, and every unit when the learned burst engine
    ``fusion`` rides along, go one at a time).  The solve options are
    :func:`~.classical.solve`'s."""
    opts = dict(device=device, band_store=band_store, fused=fused,
                mm_precision=mm_precision, solver=solver, engine=engine)
    buffer: list = []
    n_done = 0

    def flush():
        nonlocal buffer, n_done
        if not buffer:
            return
        if len(buffer) == 1 or not batch_reps or engine != "mm" \
                or fusion is not None:
            for u in buffer:
                if process_unit(u, psf, cfg, output_base, figures,
                                force=True, fusion=fusion,
                                **opts) is not None:
                    n_done += 1
        else:
            n_done += _solve_units_batched(buffer, psf, cfg, output_base,
                                           figures, opts)
        buffer = []

    for sdir in session_dirs:
        t0 = time.time()
        units = cfg.load(sdir)
        print(f"Session {os.path.basename(sdir)}: {len(units)} unit(s), "
              f"loaded in {time.time() - t0:.1f}s")
        for unit in units:
            out_dir = _unit_out_dir(output_base, unit)
            if os.path.exists(os.path.join(out_dir, "done.flag")) \
                    and not force:
                print(f"  [skip] {out_dir} - already done")
                continue
            key = (unit.frames.shape, unit.shifts)
            if buffer and key != (buffer[0].frames.shape, buffer[0].shifts):
                flush()
            buffer.append(unit)
            if len(buffer) >= max_batch:
                flush()
    flush()
    return n_done
