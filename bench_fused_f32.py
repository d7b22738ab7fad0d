"""Time the strict-f32 fused IBP kernels K2 and K3 on the card.

K2 is ``ops.fused_ibp.fused_fwd_err`` and K3 ``fused_bwd_update``, with
float32 bands.  The script runs both at the two packs ``chip_smoke.py``
uses: mono (LR 1536x2048, the center+4 shifts) and rgb (LR 768x1024, four
corner shifts, four reps), holds each against its plain version and times
it per call and on the device alone; for K2 also the layout its launch
takes and the FLOPs it performs, where the port reports them.  It then
runs one warm f32 fused solve of a synthetic mono session (80
iterations), with ``band_store="f32", fused="on"``: it counts that solve's
K2 and K3 launches, takes the median of three warm solves, and profiles
one with ``chip_smoke.phase_profile``, giving each kernel's share of the
solve's device time (K2 is ``fused_fwd_f32_kernel``, or the older
``fused_fwd_kernel``; K3 ``fused_bwd_f32_kernel``).

    python3 bench_fused_f32.py [--repo DIR]

``--repo DIR`` imports the port from DIR, a directory inside this
checkout, e.g. an older commit unpacked there by ``git archive``.  To
compare two commits, run parent, change, change, parent in one call.
Prints the card's name and power limit, then one JSON object per line.
Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(HERE),
                    help="directory in this checkout whose port to import "
                         "(default: this checkout)")
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    if not repo.is_relative_to(HERE):
        print(f"bench_fused_f32: --repo {repo} is outside {HERE}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("bench_fused_f32: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    sys.path.insert(0, str(repo))  # the port under test, imported below
    from enph459_super_resolution_tpu_torch.data.sessions import \
        CENTER_SHIFT_FILES
    from enph459_super_resolution_tpu_torch.ops import fused_ibp as TF
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 3)
    for layout, mats in cs.host_operators().items():
        pack = TF.FusedIBP.build(mats["frames"], dev)
        n = pack.n_frames
        hr = torch.as_tensor(rng.uniform(0, 255, pack.hr_shape),
                             dtype=torch.float32, device=dev)
        lr = torch.as_tensor(rng.uniform(0, 255, (n,) + pack.lr_shape),
                             dtype=torch.float32, device=dev)
        err = TF.fused_fwd_err_reference(pack, hr, lr)
        scale, clip = 0.5 / n, (0.0, 255.0)
        want = TF.fused_bwd_update_reference(pack, hr, err, scale, clip)

        def k2():
            return TF.fused_fwd_err(pack, hr, lr)

        def k3():
            return TF.fused_bwd_update(pack, hr, err, scale, clip)

        for kernel, fn, ref, prefix in (("K2", k2, err, "f"),
                                        ("K3", k3, want, "b")):
            got = fn()
            torch.cuda.synchronize()
            diff = (got - ref).abs().max().item()
            cs.check(bool(torch.isfinite(got).all()),
                     f"non-finite {kernel} output")
            cs.check(diff <= cs.KERNEL_ATOL,
                     f"{layout}: {kernel} vs plain {diff} > {cs.KERNEL_ATOL}")
            row = {"repo": str(repo), "kernel": kernel, "pack": layout,
                   "frames": n,
                   "bandr": list(getattr(pack, prefix + "_bandr").shape),
                   "bandc": list(getattr(pack, prefix + "_bandc").shape),
                   "max_abs_err": diff, "kernel_ms": cs.time_ms(torch, fn, 20),
                   "kernel_device_ms": cs.device_ms(torch, fn, 20),
                   "card": card}
            if kernel == "K3" and hasattr(pack, "strip_tiles"):
                row["strip_tiles"] = pack.strip_tiles()
                row["union_w"] = pack.strip_union(row["strip_tiles"])
            if kernel == "K2" and hasattr(pack, "k2_f32_layout"):
                # a port with the two-warps-per-frame K2
                row["layout"] = pack.k2_f32_layout()
                flops = sum(cs._k2_f32_flops(pack))
                row["kernel_gflop"] = flops / 1e9
                row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
            _emit(row)
        del pack, hr, lr, err, want

    cfg = WORKLOADS["mono_cal_target"]
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    shifts = tuple(s for _, s in CENTER_SHIFT_FILES)
    scene = cs._smooth_scene(rng, (1536, 2048))
    frames = torch.as_tensor(np.stack([cs._noisy_u8(rng, scene)
                                       for _ in shifts]), device=dev)

    def fused_solve():
        torch.cuda.synchronize()
        solve(frames, psf, shifts, device="cuda", band_store="f32",
              fused="on")
        torch.cuda.synchronize()

    before = (TF.fused_fwd_err.launches, TF.fused_bwd_update.launches)
    fused_solve()
    launches = (TF.fused_fwd_err.launches - before[0],
                TF.fused_bwd_update.launches - before[1])
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        fused_solve()
        runs.append(time.perf_counter() - t0)
    by_kernel = {}
    busy_s, _ = cs.phase_profile(torch, fused_solve,
                                 f"f32 fused solve ({repo})", by_kernel)
    k2_ms = sum(t for k, t in by_kernel.items() if "fused_fwd" in k)
    k3_ms = sum(t for k, t in by_kernel.items() if "fused_bwd" in k)
    _emit({"repo": str(repo), "solve": "f32 fused",
           "k2_launches": launches[0], "k3_launches": launches[1],
           "solve_s_runs": runs, "solve_s": sorted(runs)[1],
           "device_busy_ms": busy_s * 1e3, "k2_device_ms": k2_ms,
           "k2_device_share": k2_ms / (busy_s * 1e3),
           "k3_device_ms": k3_ms,
           "k3_device_share": k3_ms / (busy_s * 1e3), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
