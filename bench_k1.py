"""Time the banded-row kernel K1's instantiations, and a warm solve at one
matmul precision, on the card.

K1 is ``ops.banded_rows.banded_row_apply``.  The script builds the full-size
mono operators ``chip_smoke.py`` uses (LR 1536x2048, the center+4 shifts),
and for every band kind runs frame 1's row applies (``fwd_r``:
[1, 3072, 4096] in, ``bwd_r``: [1, 1536, 2048] in), ``zoom_r`` on the
5-frame stack and ``saa_r``, holds each against its
plain version (per output within 2^-17 of sum|b||x|, F64 2^-22, as
``chip_smoke.py``'s kernel phase), times it per call and on the device
alone, and prints a digest of its output bytes (two commits whose kernels
agree bit for bit print the same digests); for the kinds on the span walk
(F64, X3, X6, X9, TF32_X3: a pack with ``RowPack.spans``) also the GFLOP
their row sub-tiles perform (``chip_smoke._k1_span_macs`` times the split's
products) and their share of the type's peak.  It then runs warm
mono_cal_target solves (80 iterations, f32 store) at the matmul precision
``--preset``: their K1 launches, ``SAA_IBP``'s largest difference from
HIGHEST's, the median of three warm solves, and one profiled solve, giving
K1's share of the solve's device time.

    python3 bench_k1.py [--repo DIR] [--preset NAME]

``--repo DIR`` imports the port from DIR, a directory inside this
checkout, e.g. an older commit unpacked there by ``git archive``.  To
compare two commits, run parent, change, change, parent in one call.
``--preset`` names the solves' ``mm_precision`` (default F64_F64_F64).
Prints the card's name and power limit, then one JSON object per line.
Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# the span walk's step before kinds carried it (Kind.span_k): F64's k8,
# for a commit whose F64 kind alone had spans
F64_STEP = 8


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(HERE),
                    help="directory in this checkout whose port to import "
                         "(default: this checkout)")
    ap.add_argument("--preset", default="F64_F64_F64",
                    help="mm_precision of the warm solves "
                         "(default: F64_F64_F64)")
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    if not repo.is_relative_to(HERE):
        print(f"bench_k1: --repo {repo} is outside {HERE}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("bench_k1: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    sys.path.insert(0, str(repo))  # the port under test, imported below
    from enph459_super_resolution_tpu_torch.data.sessions import \
        CENTER_SHIFT_FILES
    from enph459_super_resolution_tpu_torch.ops.banded_rows import (
        F64, KINDS, banded_row_apply, banded_row_apply_reference,
        pack_banded)
    from enph459_super_resolution_tpu_torch.ops.opmatrix import \
        MM_PRECISIONS
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    preset = args.preset
    if preset not in MM_PRECISIONS:
        print(f"bench_k1: --preset {preset} is none of "
              f"{', '.join(MM_PRECISIONS)}", file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    full = cs.host_operators()["mono"]
    cases = {"fwd_r": (full["frames"][1][0][0], 1, 4096),
             "bwd_r": (full["frames"][1][2][0], 1, 2048),
             "zoom_r": (full["zoom_r"], 5, 2048),
             "saa_r": (full["saa"][1][0], 1, 4096)}
    rng = np.random.default_rng(cs.SEED)
    for kind in KINDS:
        name = cs._band_name(kind)
        for op_name, (host_op, batch, width) in cases.items():
            op = host_op.astype_band(kind).to(dev)
            pack = op.row_pack
            x = torch.as_tensor(rng.uniform(0, 255, (batch, op.n_in, width)),
                                dtype=torch.float32, device=dev)

            def fn():
                return banded_row_apply(pack, x)

            got = fn()
            want = banded_row_apply_reference(pack, x)
            absolute = pack_banded([np.abs(b) for b in host_op.blocks],
                                   host_op.col_ranges, op.n_out, op.n_in,
                                   dev)
            scale = banded_row_apply_reference(absolute, x)
            torch.cuda.synchronize()
            share = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
            limit = cs.K1_F64_SHARE if kind == F64 else cs.K1_SHARE
            cs.check(bool(torch.isfinite(got).all()),
                     f"{name} {op_name}: non-finite output")
            cs.check(KINDS[kind].out is not None or share <= limit,
                     f"{name} {op_name}: kernel vs plain {share} of "
                     f"sum|b||x| > {limit}")
            row = {"repo": str(repo), "bands": name, "op": op_name,
                   "x": [batch, op.n_in, width],
                   "packed_window": int(pack.bands.shape[1]),
                   "max_rel_err": share,
                   "max_abs_err": (got - want).abs().max().item(),
                   "out_digest": hashlib.sha1(
                       got.cpu().numpy().tobytes()).hexdigest()[:16],
                   "kernel_ms": cs.time_ms(torch, fn, 20),
                   "kernel_device_ms": cs.device_ms(torch, fn, 20),
                   "gflop_nonzeros": 2.0 * cs._nonzeros(host_op) * width
                   * batch / 1e9, "card": card}
            if getattr(pack, "spans", None) is not None:
                spec = KINDS[kind]
                products = sum(1 for a in range(spec.parts)
                               for b in range(spec.parts)
                               if a + b <= spec.reach)
                step = getattr(spec, "span_k", F64_STEP)
                performed = (2.0 * cs._k1_span_macs(pack, step) * width
                             * batch * products)
                peak, _, _ = cs._k1_kind_types(torch, kind, None)
                row["kernel_gflop"] = performed / 1e9
                row["kernel_share_of_peak"] = (
                    performed / (row["kernel_device_ms"] * 1e-3) / peak)
            _emit(row)
            del op, pack, x, got, want, absolute, scale

    cfg = WORKLOADS["mono_cal_target"]
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    shifts = tuple(s for _, s in CENTER_SHIFT_FILES)
    scene = cs._smooth_scene(rng, (1536, 2048))
    frames = torch.as_tensor(np.stack([cs._noisy_u8(rng, scene)
                                       for _ in shifts]), device=dev)
    res, launches, runs, solve_s = cs._warm_solve(
        torch, lr_stack=frames, psf=psf, shifts_yx=shifts, band_store="f32",
        mm_precision=preset)
    highest = solve(frames, psf, shifts, device="cuda")

    def warm_solve():
        torch.cuda.synchronize()
        solve(frames, psf, shifts, device="cuda", mm_precision=preset)
        torch.cuda.synchronize()

    by_kernel = {}
    busy_s, wall_s = cs.phase_profile(
        torch, warm_solve, f"{preset} solve ({repo})", by_kernel)
    k1_ms = sum(t for k, t in by_kernel.items() if "banded_rows" in k)
    _emit({"repo": str(repo), "solve": preset,
           "k1_launches": {k: v for k, v in launches.items()
                           if k.startswith("k1_") and v},
           "ibp_vs_highest_max_diff": cs._u8_diff(res["ibp"],
                                                  highest["ibp"]),
           "solve_s_runs": runs, "solve_s": solve_s,
           "profiled_wall_s": wall_s, "device_busy_ms": busy_s * 1e3,
           "k1_device_ms": k1_ms, "k1_device_share": k1_ms / (busy_s * 1e3),
           "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
