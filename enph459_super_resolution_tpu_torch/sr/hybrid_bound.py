"""Derived (not A/B'd) deviation bounds for the hybrid band-store schedule.

Counterpart of ``enph459_super_resolution_tpu/sr/hybrid_bound.py``: numpy
over the port's host band entries, no device code.  The bf16 rounding goes
through torch, which rounds to nearest even as ``ml_dtypes`` does.

The ``band_store="hybrid[:tail]"`` mode runs the bulk of the IBP
fixed-point loop on bf16-stored operators and finishes with an f32 tail
(``sr.classical``).  Round 3 measured tail 16 to be the +/-1-uint8-of-f32
frontier; this module replaces the measured coincidence with quantities
COMPUTED from the checked host band entries (``_frame_operator_banded``):

1. **Per-operator norms and exact bf16 rounding deltas** — the banded
   entries live on the host, so ``||dF||, ||dB||`` are exact matrix norms
   of the actual rounding perturbation, not ``2^-9``-style estimates.

2. **The per-iteration injection bound** ``eps_inf`` — worst case over
   images in [0, 255] of the per-iteration deviation the bf16 operators
   inject (``counts``), via Kronecker norm algebra (the frame operators
   are rank-1 separable for the Gaussian PSF, and 2-D induced norms of
   Kronecker products factor: ``||A (x) B|| = ||A|| ||B||``).

3. **The exact mode spectrum of the f32 iteration map** — the reference's
   4-corner shift pattern is a full per-axis product grid, so

       sum_i B_i F_i  =  S_y (x) S_x,   S_a = B_a(+) F_a(+) + B_a(-) F_a(-)

   EXACTLY (same band entries the solver uploads), and the linear part of
   the IBP update, ``M = I - (step/N) S_y (x) S_x``, has eigenvalues
   ``1 - (step/N) mu_j nu_l`` — computed per axis, no 12.6M-dim problem.

   The computed structural fact (this replaces PERF_NOTES' measured
   "~0.98/iter"): **~3/4 of the modes sit at |lambda| = 1 exactly.**
   All four +/-0.5-LR-px shifts move the HR grid by +/-1 HR px, so every
   frame samples the SAME decimation parity class — three quarters of HR
   Fourier modes are invisible to all frames (per axis: shift +1 and -1
   both land on the odd sublattice, leaving ~1/2 of the axis modes
   unconstrained; jointly 3/4).  On those modes the iteration is the
   identity; there is also no spectral gap above them.  Consequence: a
   worst-case-over-directions tail-contraction theorem CANNOT exist —
   any deviation component in the unobserved subspace survives every f32
   tail iteration.  The honest worst-case guarantee is therefore
   injection-side:

       ||dev||_inf  <=  eps_inf * n_lo        (unconditional; clip is
                                               non-expansive, the tail
                                               injects nothing)

   and the tail's role is to contract the OBSERVED-subspace component,
   for which the derived length is

       T*(rho0, target)  =  ceil( log(target * (1 - rho0) / eps_inf)
                                  / log(rho0) )

   — the tail after which the saturated deviation carried by every mode
   with |lambda| <= rho0 is below ``target`` counts.  T* is far LARGER
   than the measured-sufficient tail 16 (asserted in
   ``tests/test_hybrid_bound.py``): the measured +/-1 is the behavior of
   the actual deterministic rounding injection — incoherent across ~40
   taps and 64 iterations, hence ~30x below the coherent worst case —
   not of a worst-case adversary.  The +/-2 class cap of the pure-bf16
   mode and the +/-1 at hybrid:16 are both consistent with (and bounded
   by) the computed ``eps_inf * n`` ceiling.

Scope: exact for rank-1 PSFs (the reference's Gaussian) and full
product-grid shift patterns (all four workloads' 4-corner sets; the
5-frame mono_cal_target adds a center frame — its ``sum B_i F_i`` gains a
separable ``A_y(0) (x) A_x(0)`` term, and the injection bound still holds
verbatim, only the spectrum helper refuses).  A boundary caveat is
computed, not assumed: the heuristic back-projection equals the true
adjoint in the interior but NOT at the edges (``||S - S^T||`` is reported
as ``asym``), so eigenvalues are taken from the symmetrized ``S`` with the
asymmetry reported alongside.

CLI: ``python -m enph459_super_resolution_tpu_torch.sr.hybrid_bound
[--lr-shape H,W] [--n-lo 64] [--tail 16]`` prints the numbers (the
flagship's are in ``artifacts/hybrid_bound_flagship.json``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .classical import IBP_STEP_SIZE, _frame_operator_banded, \
    make_gaussian_psf

#: the reference's 4-corner nominal pattern (mono_barcodes/run_sr.py:71-77)
CORNER_SHIFTS = ((0.5, 0.5), (0.5, -0.5), (-0.5, 0.5), (-0.5, -0.5))


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def _inf_norm(a: np.ndarray) -> float:
    return float(np.abs(a).sum(axis=1).max())


def _axis_ops(psf, shifts_yx, factor: int, lr_shape) -> Dict:
    """(axis, signed shift value) -> dense 1-D (F, B) from the SAME host
    band entries the solver uploads (rank-1 PSF required)."""
    ops = {}
    for s in shifts_yx:
        fr, fc, br, bc = _frame_operator_banded(
            psf, s, factor, lr_shape, "float64")
        if len(fr) != 1:
            raise ValueError("spectrum/injection analysis requires a "
                             "rank-1 (separable) PSF")
        ops[("y", float(s[0]))] = (fr[0].to_dense(np.float64),
                                   br[0].to_dense(np.float64))
        ops[("x", float(s[1]))] = (fc[0].to_dense(np.float64),
                                   bc[0].to_dense(np.float64))
    return ops


def operator_norms(psf=None, shifts_yx: Sequence = CORNER_SHIFTS,
                   factor: int = 2, lr_shape: Tuple[int, int] = (96, 128)
                   ) -> Dict:
    """Exact per-axis operator norms and bf16 rounding-delta norms."""
    psf = make_gaussian_psf() if psf is None else psf
    ops = _axis_ops(psf, shifts_yx, factor, lr_shape)
    out = {}
    for key, (F, B) in ops.items():
        out[key] = {
            "F_inf": _inf_norm(F), "B_inf": _inf_norm(B),
            "dF_inf": _inf_norm(_bf16_round(F) - F),
            "dB_inf": _inf_norm(_bf16_round(B) - B),
        }
    return out


def injection_bound(psf=None, shifts_yx: Sequence = CORNER_SHIFTS,
                    factor: int = 2,
                    lr_shape: Tuple[int, int] = (96, 128),
                    step: float = IBP_STEP_SIZE,
                    x_max: float = 255.0) -> float:
    """``eps_inf``: worst-case per-iteration bf16 injection, in counts.

    One hybrid-bulk iteration differs from the f32 iteration by

        p = (step/N) sum_i [ dB_i (l_i - F~_i x) + B~_i dF_i x ]

    with ``dF = bf16(F) - F`` etc. the EXACT rounding perturbations.
    Bounded in l_inf over ``l, x in [0, x_max]`` via Kronecker norm
    algebra; the clip at both ends of the update is non-expansive, so
    the deviation recursion obeys ``d_{k+1} <= |lambda|-propagation + p``
    and the unconditional ceiling ``eps_inf * n_lo`` holds regardless of
    the spectrum.
    """
    psf = make_gaussian_psf() if psf is None else psf
    ops = _axis_ops(psf, shifts_yx, factor, lr_shape)
    deltas = {k: (_bf16_round(F) - F, _bf16_round(B) - B)
              for k, (F, B) in ops.items()}
    n = len(shifts_yx)
    eps = 0.0
    for s in shifts_yx:
        Fy, By = ops[("y", float(s[0]))]
        Fx, Bx = ops[("x", float(s[1]))]
        dFy, dBy = deltas[("y", float(s[0]))]
        dFx, dBx = deltas[("x", float(s[1]))]
        nF = _inf_norm(Fy) * _inf_norm(Fx)
        # ||d(A (x) B)|| <= ||dA|| ||B|| + ||A|| ||dB|| + ||dA|| ||dB||
        ndF = (_inf_norm(dFy) * _inf_norm(Fx)
               + _inf_norm(Fy) * _inf_norm(dFx)
               + _inf_norm(dFy) * _inf_norm(dFx))
        ndB = (_inf_norm(dBy) * _inf_norm(Bx)
               + _inf_norm(By) * _inf_norm(dBx)
               + _inf_norm(dBy) * _inf_norm(dBx))
        nB16 = (_inf_norm(_bf16_round(By))
                * _inf_norm(_bf16_round(Bx)))
        resid = x_max * (1.0 + nF + ndF)  # ||l - F~ x||_inf worst case
        eps += (step / n) * (ndB * resid + nB16 * ndF * x_max)
    return float(eps)


def _is_product_grid(shifts_yx) -> bool:
    ys = sorted({float(s[0]) for s in shifts_yx})
    xs = sorted({float(s[1]) for s in shifts_yx})
    grid = {(y, x) for y in ys for x in xs}
    return (len(shifts_yx) == len(grid)
            and {(float(a), float(b)) for a, b in shifts_yx} == grid)


def mode_spectrum(psf=None, shifts_yx: Sequence = CORNER_SHIFTS,
                  factor: int = 2,
                  lr_shape: Tuple[int, int] = (96, 128),
                  step: float = IBP_STEP_SIZE) -> Dict:
    """Eigenvalues of the f32 iteration map ``M = I - (step/N) S_y (x) S_x``
    for full product-grid shift patterns, plus the computed boundary
    asymmetry of ``S`` (the heuristic BP is the true adjoint only in the
    interior; eigenvalues come from the symmetrized ``S``).

    Returns |lambda| percentiles, the non-contracting fraction, and the
    per-axis near-null fractions — the alias-redundancy structure.
    """
    if not _is_product_grid(shifts_yx):
        raise ValueError("mode_spectrum requires a full per-axis product "
                         "grid of shifts (e.g. the 4-corner pattern); got "
                         f"{shifts_yx!r}")
    psf = make_gaussian_psf() if psf is None else psf
    ops = _axis_ops(psf, shifts_yx, factor, lr_shape)
    n = len(shifts_yx)

    def axis_sum(axis):
        vals = sorted({float(s[0 if axis == "y" else 1])
                       for s in shifts_yx})
        S = None
        for v in vals:
            F, B = ops[(axis, v)]
            A = B @ F
            S = A if S is None else S + A
        return S

    out = {}
    lams = []
    for axis in ("y", "x"):
        S = axis_sum(axis)
        asym = float(np.abs(S - S.T).max())
        w = np.linalg.eigvalsh(0.5 * (S + S.T))
        out[f"asym_{axis}"] = asym
        out[f"null_frac_{axis}"] = float((np.abs(w) < 1e-8).mean())
        lams.append(w)
    lam = np.abs(1.0 - (step / n) * np.multiply.outer(*lams)).ravel()
    out["abs_lambda_percentiles"] = {
        str(p): float(np.percentile(lam, p)) for p in (50, 75, 90, 99)}
    out["abs_lambda_max"] = float(lam.max())
    out["frac_ge_0.999"] = float((lam >= 0.999).mean())
    out["frac_ge_0.98"] = float((lam >= 0.98).mean())
    return out


def derived_tail(eps_inf: float, rho0: float = 0.98,
                 target: float = 0.5) -> int:
    """Tail length T* after which every mode with |lambda| <= rho0 carries
    less than ``target`` counts of worst-case deviation.

    A mode of contraction rho saturates at ``eps_inf / (1 - rho)`` during
    the bulk and decays by ``rho^t`` over the tail; the worst sub-rho0
    mode needs ``rho0^T * eps_inf / (1 - rho0) < target``.  (Modes above
    rho0 — including the exactly-unobserved 3/4 — are NOT contracted by
    any tail; their ceiling is the unconditional ``eps_inf * n_lo``.)
    """
    sat = eps_inf / (1.0 - rho0)
    if sat <= target:
        return 0
    return int(math.ceil(math.log(target / sat) / math.log(rho0)))


def report(lr_shape: Tuple[int, int] = (96, 128), n_lo: int = 64,
           tail: int = 16, shifts_yx: Sequence = CORNER_SHIFTS,
           factor: int = 2, step: float = IBP_STEP_SIZE,
           spectrum: bool = True) -> Dict:
    """All computed quantities for one geometry, as one dict."""
    eps = injection_bound(shifts_yx=shifts_yx, factor=factor,
                          lr_shape=lr_shape, step=step)
    out = {
        "lr_shape": list(lr_shape),
        "eps_inf_per_iter": eps,
        "unconditional_bound_counts": eps * n_lo,
        "derived_tail_rho0_0.98_target_0.5": derived_tail(eps, 0.98, 0.5),
        "norms": {f"{k[0]}{k[1]:+g}": v for k, v in operator_norms(
            shifts_yx=shifts_yx, factor=factor,
            lr_shape=lr_shape).items()},
    }
    if spectrum and _is_product_grid(shifts_yx):
        out["spectrum"] = mode_spectrum(shifts_yx=shifts_yx, factor=factor,
                                        lr_shape=lr_shape, step=step)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lr-shape", default="96,128",
                   help="H,W (flagship: 1536,2048 — eig is minutes on one "
                        "core)")
    p.add_argument("--n-lo", type=int, default=64)
    p.add_argument("--tail", type=int, default=16)
    p.add_argument("--no-spectrum", action="store_true",
                   help="skip the eigendecompositions (norms + injection "
                        "only; fast at any size)")
    args = p.parse_args(argv)
    h, w = (int(v) for v in args.lr_shape.split(","))
    res = report((h, w), args.n_lo, args.tail,
                 spectrum=not args.no_spectrum)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
