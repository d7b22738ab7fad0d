#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs a CUDA card, the CUDA toolkit (``nvcc``) and this repository's
``enph459_super_resolution_tpu_torch`` package; it imports nothing of JAX
or of the JAX package.  Phases, one JSON line each:

1. device -- ``nvidia-smi`` name and power limit, SM count and max clock;
   builds every kernel under ``csrc/`` (one ``nvcc`` per source, all
   started together) and the native PNG codec (``native/``, ``g++``
   against libpng): the codec in use (``libpng``, ``PIL`` or ``zlib``) and,
   where libpng did not build, the compiler's message.
   native -- ``load_gray_batch`` of 20 PNGs of 1536x2048 on the native
   pool of 8 threads and of 1, pixel for pixel equal to PIL's decode, and
   one 3072x4096 frame encoded by ``save_png`` (libpng, zlib level 1) and by
   PIL, both read back equal: the seconds of each (PIL's only, without
   libpng).
2. kernel -- the banded-row kernel K1 against its plain PyTorch version on
   the card at every shape the runs below give it (``zoom_r``, ``saa_r``,
   ``fwd_r``, ``bwd_r`` at LR 1536x2048, and the 4-rep tiled ``zoom_r``,
   ``saa_r``, ``fwd_r``, ``bwd_r`` at LR 768x1024), float32 bands, and its
   bfloat16-band and split (X3: ``mm_precision`` BF16_BF16_F32_X3)
   instantiations, and those of the other presets (X6, X9, TF32, TF32_X3,
   F16_F16_F32, F16_F16_F16, BF16_BF16_BF16, F64), at the full-size
   ``zoom_r``, ``saa_r``, ``fwd_r`` and ``bwd_r``;
   inputs uniform in [0, 255), max|diff| <= 1e-3 and, per output, within
   2^-17 of sum_k |b_k| |x_k| (F64 2^-22): the products are exact and x
   rounds or splits alike in both, so only the summation order differs; a
   kind that rounds its result to bf16 or f16 gives values of that type,
   each the rounding of a sum within that share of the plain sum.  Before
   that, every kind bit for bit against its plain version on an exactness
   probe (``_k1_probe``: one product per output, exact in every order),
   which fails a kind that forms other products or skips its rounding;
   with the kernel's, the plain version's and a dense ``torch.matmul``'s
   (in the preset's type; TF32 on for the tf32 presets, in that timing
   only) times and the card's bound for the same work, at the type's peak
   (f32 CUDA cores, bf16 and f16 989, tf32 494.7, f64 66.9 TFLOP/s), with
   one product per pair of parts a split multiplies: a multiply-add per
   nonzero band entry and column of x (one ``k1_bound`` line gives the
   bound over the 128-row block windows beside it, and per f32 banded
   mono_cal_target solve the sum of the per-op device times times their
   launches, the bound and the time lost over it); for the kinds on the
   span walk (F64, X3, X6, X9, TF32_X3) also the GFLOP their row sub-tiles
   perform (``_k1_span_macs``: 16 rows over each span rounded out to whole
   steps of the kind's ``span_k``, k8 for F64 and TF32_X3 and k16 for the
   bf16 splits, times the split's products) and their rate's share of the
   type's peak (f64 66.9, bf16 989, tf32 494.7 TFLOP/s) on the device
   alone.  The kernel's time is taken twice (CUDA events both): per call
   over calls launched one after another, and on the device alone over
   calls queued behind a device sleep, which leaves out the host's launch
   cost where a call takes longer to enqueue than to run (also for K4
   below).
3. fused -- the fused IBP kernels K2 (forward error of every frame) and K3
   (back-projection update) against their plain versions at the full-size
   mono pack and the 4-rep rgb pack, float32 and bfloat16 bands;
   max|diff| <= 1e-3 for f32 and <= 2.0 for bf16 (a bf16 row product that
   rounds the other way moves by one ulp, 1.0 at 128..255), and the share
   of elements that differ from the plain version at all; with the
   kernel's time (per call, and on the device alone as for K1), the plain
   version's and the unfused step's (K1 + the column applies) times and the
   bound; for the f32 K3 also its tiles per CUDA block (``strip_tiles``)
   and the LR columns of the widest strip's union window (``union_w``);
   for the f32 K2 the layout its launch takes (threads, ring stages, one
   set or one plan group per set) and the FLOPs it performs, with their
   share of the f32 peak.
   No single PyTorch call computes K2 or K3, so they have no library
   time.
4. mono_cal_target at full size -- a synthetic center+4 session (5 x
   1536x2048 -> 3072x4096, 80 IBP iterations) through ``sr.run`` on cuda,
   f32: artifacts, falling MSE, K1's launches against the count the solve's
   structure implies, ``native_2x`` within +-1 of
   ``scipy.ndimage.zoom(order=3)``, ``SAA_IBP`` within +-1 of the same
   solve with the plain versions on the card; warm and cold solve times
   and one profiled solve (device busy time and idle share).
   analyses -- the rig's analyses.  A second synthetic center+4 session
   at the same size, a chart with a dark bar slanted 40 degrees (two step
   edges) inside the mono_cal_target preset's ROI-2 and bars crossing its
   profile column, blurred by the workload's PSF and shifted by
   ``CENTER_SHIFT_FILES`` on the card, through ``sr.run`` (K1's launches as
   above), then
   ``eval.cal_target_analysis --preset mono_cal_target --no-figures`` with
   ``--device cuda`` and ``--device cpu``: MTF50/MTF10 per method and the
   seconds of each, the card within ``ANALYSES_RTOL`` of the host, SAA+IBP's
   MTF50 above Native-2x's.  ``psf.analyze --pixel-pitch-um 3.45
   --no-figures`` of a flat-layout folder of 1536x2048 pinhole frames,
   9 positions of 10 reps and pos4 of 30 (sigma 0.73 px, jittered centres,
   read noise), on cuda and on the host: every ``summary.json`` number
   within ``ANALYSES_RTOL``, pos4's sigma within 0.02 px of the truth, and
   the batched Gaussian fit of pos4's 30 PSFs timed alone on each.
   ``eval.barcode_analysis artifacts/rgb_barcodes/results --rois rgb
   --decoder code128 --figure none``: its records equal the committed
   ``decode_confidence.json``.  No hand-written kernel runs in the three
   CLIs (their launch counts are read and must be 0).
   rig -- the simulated rig (``hw/``) at the sensor's size on the card.
   One pinhole rig on the card and one on the host from the same seed:
   frames within +-1 uint8, the same shift draws, each one's render times.
   ``run_calibration`` of a pinhole rig (``SimConfig()``: LR 1536x2048,
   the 3072x4096 ``pinhole_scene``), 3 tilts x 2 repeats at a 50 ms
   settle, centres fitted on the card: the least-squares gain within 5 %
   of the sim's 3.2 px/deg.  ``run_hw_triggered`` of a barcode rig (flat
   235 holding 3 EAN-13 codes at 2 HR px per module) at 0.15625 deg (0.5
   px), 2 repeats, and the special run at the calibrated tilts; ``sr.run
   --workload mono_barcodes`` of the run (4 units, one batched f32 banded
   solve: K1's launches as ``expected_launches`` implies); every unit's
   ``SAA_IBP.png`` decodes every code at confidence 1.0 through
   ``eval.ean13``, the 2x bicubic of its LR mean none.  The Laplacian
   variance on the card within 1e-5 of the host's; an autofocus sweep on a
   ``SimStage`` within its depth of focus of 369.23 mm; ``run_stability``
   on a knife-edge rig (2 trials x 4 positions x 12 frames); a
   ``utils.trace.device_trace`` of one warm solve whose Chrome trace names
   K1's ``banded_rows_kernel``: the traced K1 device time beside the sum
   of the per-op device times over the same launches.  Seconds of each
   step.
5. mono_bf16 -- the same session through ``sr.run --band-store bf16``
   (auto: the fused kernels): artifacts, launches (K1-bf16 7, K2 80, K3
   80, nothing else), ``SAA_IBP`` within +-2 of the plain-version solve on
   the card and within +-3 of the f32 solve; one profiled bf16 solve.
6. modes -- warm ``solve`` time, HR Mpix/s and launches of every band
   store and engine: f32 (banded, and fused on), bf16 (fused, and fused
   off), hybrid:16 (banded, and fused on); hybrid's ``saa`` bit-identical
   to f32's and its ``SAA_IBP`` within +-1, f32 fused within +-1.
7. rgb_barcodes batched -- 4 corners x 4 reps of 1536x2048 RGGB mosaics
   (768x1024 red planes) through ``sr.run``'s rep-tiled ``solve_batch``,
   f32 and then ``--band-store bf16``: every rep's artifacts, the launch
   counts, and every rep's ``SAA_IBP`` within +-1 (f32) or +-2 (bf16) of
   the batched solve with the plain versions on the card.
8. trunk -- the residual-trunk kernel K4 against its plain version at the
   EDSR shape [8, 256, 256, 64] and the BurstFusionLR shape
   [1, 1536, 2048, 64]: one residual block (the relu launch, then the skip
   launch from the plain version's output, so each is judged alone) in
   float32 and bfloat16, and one ``relu_only`` launch; inputs N(0, 1),
   weights 0.05 N(0, 1).  float32 max|diff| <= 1e-4; bfloat16 within one
   bf16 ulp of the larger magnitude plus 1e-4 (plus two ulps for the
   residual launch's inner rounding).  With the kernel's, the plain
   version's and one cuDNN ``F.conv2d``'s times and the bound.
9. edsr -- EDSR-baseline x4 (16 x 64, RGB, seeded default init) served
   through ``make_edsr_fused_apply``: 4 requests of 8 x 256x256x3 each, in
   bfloat16 and in float32; 32 K4 launches per request; output
   [8, 1024, 1024, 3], finite, against the plain ``EDSR`` module on the
   card; seconds per request, images/s, output Mpix/s; one profiled bf16
   request.
10. burst_lr -- ``make_burst_lr_fused_apply`` (bf16) on BurstFusionLR (4
   frames, x2, 8 x 64, random head) at phases [1, 1536, 2048, 16]: 16 K4
   launches per request, against the plain module; time and HR Mpix/s.
11. tiled -- one 4K frame, LR 540x960x3 -> 2160x3840, through
   ``tiled_infer`` on the EDSR-16 module, against its whole-image forward
   (<= 5e-3).  It runs no hand-written kernel.
12. precision -- warm mono solves at ``mm_precision`` BF16_BF16_F32_X3 and
   DEFAULT (f32 store) and hybrid:16 at X3: launches (X3: K1-x3 807, K1-f32
   0; DEFAULT: K1-bf16 807; hybrid:16 X3: K1-bf16 640 + K1-x3 167),
   ``SAA_IBP`` within +-1 (X3) and +-3 (DEFAULT) of HIGHEST's, solve time
   and HR Mpix/s beside HIGHEST's; one profiled X3 solve.  Then every
   other preset on the f32 store (``NEW_PRESETS``): 807 launches of its own
   K1 instantiation and none of another, ``SAA_IBP`` within its class of
   HIGHEST's (+-1: X6, X9, TF32_X3, F64; +-2: TF32, F16_F16_F32,
   F16_F16_F16; +-3: BF16_BF16_BF16), its warm solve time.
13. adjoint -- ``sr.run --solver adjoint`` on the mono session (20
   iterations, step 2.0): K1-f32 207 launches, a descending MSE history
   whose last value is <= 1.02 x the IBP-80 solve's, and its warm solve
   time; ``landweber_refine`` from the SAA seed (20 iterations: K1-f32 205
   launches, a falling fit, within +-1 of its plain-rows run); then
   ``solve`` with a
   rank-2 PSF, adjoint (407 launches, within +-1 of the plain-rows solve),
   and ibp on the fused bf16 engine (within +-2 of its plain version).
14. conv -- ``solve(engine="conv")`` of the mono session (80 iterations):
   ``SAA_IBP`` within +-1 of the banded engine's, no K1/K2/K3 launch, its
   time.
15. sharded -- ``parallel.solve_sharded`` of the mono session at full size
   as 4 tiles on the one card (a mesh of the card repeated): ``{"sp": 4}``
   and ``{"sp": 2, "spw": 2}`` (80 IBP iterations) against the conv
   engine's solve, and the adjoint (20 iterations, step 2.0) at ``sp=4``
   against the banded adjoint solve: HR within ``SHARDED_ATOL`` over the
   full array, the MSE history within ``SHARDED_RTOL``, every artifact
   within +-1 uint8, no K1-K4 launch; each solve's first and warm seconds
   beside the conv solve's, and one profiled sharded solve of
   ``PROFILED_ITERS`` iterations (its device launches and idle share).
   ``tiled_infer_sharded`` of the 4K frame on the EDSR-16 module as 4
   tiles: within 5e-3 of ``tiled_infer`` away from the ``halo * scale``
   rows at the two global edges.  ``sr.run --sp 2
   --device cuda``: with fewer than 2 cards it exits non-zero with the
   mesh's device-count error and writes no result (no CPU fallback); with
   2 or more, ``SAA_IBP`` within +-1 of ``--sp 1``.
   multicard -- only on a host of 4 or more cards (the script needs one):
   the same solves, ``tiled_infer_sharded`` and ``sr.run --sp 4`` /
   ``--sp 2x2`` with one tile on each of the first 4 cards, held as above.
16. prewarm and watch -- ``sr.prewarm --workloads mono_cal_target --reps 1``
   in a subprocess, into a fresh op cache, exits 0; ``sr.run`` with the
   process's operator trees dropped and the host build forbidden then reads
   that cache; ``sr.run --watch 0.1 --watch-polls 2`` serves the session
   on the first poll and nothing on the second.
17. burst -- the learned burst engine.  ``train_burst`` on cuda at full
   width: BurstFusionLR 64 x 8, batch 16, LR patch 24, pool 64, 200 steps
   (checkpoints at 100 and 200), then BurstFusion 48 x 6 for 20 steps:
   steps/s, bursts/s, the logged losses, the final eval's PSNRs, peak
   memory; every number finite, ``psnr_ibp > psnr_bicubic``, the run
   directory complete; the step-100 checkpoint restores params, EMA and
   optimizer state bit for bit; one train step from it on cuda and on cpu
   agrees (metrics within rtol 1e-4, parameters within 0.01 of the rate).
   Then a mono_barcodes session of 4 corners x 1536x2048 through
   ``sr.run --fusion-run <run> --fusion-refine 10``: its launches are the
   classical solve's (``expected_launches``) plus the refine's 84 K1-f32
   (2 per frame and iteration plus 1 per frame), artifacts,
   ``fusion_forward_mse < fusion_forward_mse_raw``.  Then the engine in
   process: the refine within 1e-3 of ``landweber_refine(plain=True)``
   from the same seed, the banded registration (8 K1 launches)
   within 1e-3 of the conv one and of its plain rows, the bf16 engine
   within 0.05 of the residual's span of the f32 one, a 2-iteration vjp
   refine improves the fit, the engine at 4 x 128x160 on cuda within +-1
   of cpu; the warm time of a unit in f32 and bf16, split into
   registration, trunk and refine per iteration.

18. train -- the SR training loop at full width.  ``train.loop.train``
   on cuda: EDSR-baseline x4 (16 x 64), batch 16, LR patch 48, L1, the
   synthetic pool, 200 steps (checkpoints and evals at 100 and 200), then
   a second call to 300 that resumes at 200: the step-200 checkpoint
   restores bit for bit, ``metrics.jsonl`` reaches 300, the last logged
   loss is below the first, no hand-written kernel runs while training;
   steps/s, HR Mpix/s, peak memory and one profiled step's idle share.
   ``train.evaluate --run <run> --tiled`` exits 0; the EMA weights serve
   through ``make_edsr_fused_apply`` (f32 and bf16) on the run's eval
   split, one image a request: 32 K4 launches per request, within
   ``EDSR_F32_SHARE`` / ``EDSR_BF16_SHARE`` of the output's span of the
   module's forward.  ESRGAN: RRDBNet 23 x 64, gc 32, x4, batch 16, LR
   patch 48, an L1 pretrain of 20 steps, then 20 ``gan=True`` steps from
   it (``init_from``), a seeded random VGG19 ``.pth`` for the perceptual
   term, ``d_every=2``, ``instance_noise=2.0``: finite losses, 10 D
   updates, the generator's EMA continuing the pretrain's, ``train.evaluate
   --interp-run --alpha 0.8`` exits 0; steps/s and peak memory per stage.
   One GAN step at small width (RRDBNet 2 x 16, D nf 16, VGG19 features)
   from the same state and noise on cuda and on cpu: metrics within rtol
   1e-4, the generator's parameters and EMA within 0.01 of the rate, D's
   within 3 rates, and all but 1 in 10,000 of them outside the two Dense
   biases within 0.01 of the rate (RaGAN leaves some of D's gradients at
   rounding level, ``tests/test_torch_gan.py``).
19. mesh_train -- the training meshes of ``parallel/`` at full width,
   the card repeated in the mesh: ``train.loop.train`` of EDSR-baseline x4
   (16 x 64, batch 16, LR patch 48, L1, the synthetic pool, 20 steps, every
   step logged) on one device and under dp=2,tp=2 and dp=2,sp=2,tp=2; the
   scan-trunk EDSR on one device and under dp=2,pp=4 (``train.evaluate``
   then reads that run's checkpoint); 2 GAN steps on one device and under
   dp=2,tp=2; EDSRMoE x4 (8 x 64, 4 experts) dense, dense again and under
   dp=2,ep=4.  Per run: steps/s, peak memory, the device launches and idle
   share of one profiled step, and the largest relative difference of the
   loss trajectory from its one-device run: dp/sp/tp/pp and the GAN within
   rtol 2e-4 (``tests/test_multidevice_cli.py``'s bar); EDSRMoE's bar
   (rtol 1e-4, atol 1e-5, final PSNR atol 1e-3) is recorded, not raised,
   as its float32 gradient on the card parts two dense runs too (its first
   loss must agree within 1e-4), and one float64 step at full width holds
   dp=2,ep=4 to the dense step within 1e-9 (beside it, the float32
   gradient's worst tensor as a share of the float64 one).
   ``dryrun_multichip(8)`` on the card x 8 prints its 8 ``ok:`` lines;
   ``train.loop --mesh dp=2,tp=2
   --device cuda`` with fewer than 4 cards exits 2 and writes nothing; no
   K1-K4 launch.  On a host of 4 or more cards, dp=2,tp=2 (EDSR) and
   dp=2,ep=2 (EDSRMoE) also run with one position per card.

Then the ``kernels`` summary line (every K1 instantiation, K2, K3 and K4
in each type), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero with no result line; so does a run
without a card (exit 2) or of this script alone, without the port's package
beside it (exit 2, with a message on stderr).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "_smoke_work"
SEED = 0
KERNEL_ATOL = 1e-3
BF16_ATOL = 2.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_PEAK = 989e12         # H100 SXM dense bf16 tensor-core rate
TF32_PEAK = 494.7e12        # H100 SXM dense tf32 tensor-core rate (f16 as bf16)
F64_PEAK = 66.9e12          # H100 SXM f64 DMMA rate
# K1 against its plain version per output, as a share of sum_k |b_k| |x_k|:
# both form the same exact products and sum them in float32 in another
# order (F64: in float64, rounded once); the card tests' SHARE and X3_SHARE
K1_SHARE, K1_F64_SHARE = 2.0 ** -17, 2.0 ** -22
# what the span walk's instantiations run on (the kernels line's `design`)
_SUB_TILES = "; 16-row sub-tiles, each over its span of window rows"
K1_SPAN_DESIGNS = {
    "f64": "f64 tensor cores (mma.sync m16n8k8 .f64, DMMA)" + _SUB_TILES,
    "x3": "bf16 tensor cores (mma.sync m16n8k16), 3 products of 2 parts"
          + _SUB_TILES,
    "x6": "bf16 tensor cores (mma.sync m16n8k16), 6 products of 3 parts"
          + _SUB_TILES,
    "x9": "bf16 tensor cores (mma.sync m16n8k16), 9 products of 3 parts"
          + _SUB_TILES,
    "tf32x3": "tf32 tensor cores (mma.sync m16n8k8 .tf32), 3 products of 2 "
              "parts" + _SUB_TILES}
# K1's exactness probe: band entries and inputs c * 2^e with c one of these,
# each output a single product, whose parts' products and their sums are
# exact in float32 under every kind
K1_PROBE_VALUES = (1 + 2.0 ** -9 + 2.0 ** -18, 1 + 2.0 ** -4)
HR_MPIX = 3072 * 4096 / 1e6
TAIL = 16                  # the hybrid store's default f32 tail
TRUNK_F32_ATOL = 1e-4
EDSR_BATCH, EDSR_LR, EDSR_REQUESTS = 8, 256, 4
# fused serving against the f32 module, as shares of the output's span
# max|y - mean| (PERF.md gives the reasons)
EDSR_F32_SHARE = 2e-5
EDSR_BF16_SHARE = 0.05
BURST_PHASES = (1, 1536, 2048, 16)
# a sharded solve against its unsharded twin (tests/test_parallel.py's)
SHARDED_ATOL, SHARDED_RTOL = 1e-3, 1e-5
PROFILED_ITERS = 8         # IBP iterations of the profiled sharded solve


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls queued behind a device
    sleep (CUDA events, after one warm-up call): the host enqueues every
    call while the card still sleeps, so the calls run back to back and the
    host's launch cost, which ``time_ms`` includes where a call takes longer
    to enqueue than to run, drops out.  The sleep grows until it outlasts
    the enqueueing."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the card still slept: all were queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("check failed: the host did not enqueue the calls "
                       "within the device sleep")


def _counters():
    """Every kernel wrapper's launch counter, by kernel and band type."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import \
        banded_row_apply
    from enph459_super_resolution_tpu_torch.ops.fused_ibp import (
        fused_bwd_update, fused_fwd_err)
    from enph459_super_resolution_tpu_torch.ops.trunk import trunk_conv

    from enph459_super_resolution_tpu_torch.ops.banded_rows import KINDS

    # K1: one counter per band kind, "k1_f32", "k1_bf16", "k1_x3", ...
    k1 = {"k1_" + (spec.counter[len("launches_"):] or "f32"):
          (banded_row_apply, spec.counter) for spec in KINDS.values()}
    return {**k1,
            "k2_f32": (fused_fwd_err, "launches"),
            "k2_bf16": (fused_fwd_err, "launches_bf16"),
            "k3_f32": (fused_bwd_update, "launches"),
            "k3_bf16": (fused_bwd_update, "launches_bf16"),
            "k4_f32": (trunk_conv, "launches"),
            "k4_bf16": (trunk_conv, "launches_bf16")}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def expected_launches(band_store: str, fused: bool, rank: int, n: int,
                      n_iter: int, precision: str = "k1_f32") -> dict:
    """Launches of one (batched) solve by kernel: the LR-mean zoom and the
    stack zoom (one batched launch), one Shift-and-Add row apply per frame
    (on the bf16 bands only for ``bf16``), then per IBP iteration either one
    K2 and one K3 launch (fused engine) or, per frame and PSF rank term, one
    forward and one back-projection row apply (banded engine; the same for
    the adjoint solver).  ``hybrid`` runs its last ``TAIL`` iterations
    banded on the f32 bands.  ``precision`` is the K1 instantiation the f32
    bands' applies take: ``k1_f32`` (HIGHEST), ``k1_x3`` (X3), ``k1_bf16``
    (DEFAULT) or another kind's counter (``k1_x6``, ``k1_tf32``, ...)."""
    out = dict.fromkeys(_counters(), 0)
    low = "bf16" if band_store in ("bf16", "hybrid") else "f32"
    out["k1_bf16" if band_store == "bf16" else "k1_f32"] += 2 + n
    n_lo = n_iter - TAIL if band_store == "hybrid" else n_iter
    if fused:
        out[f"k2_{low}"] += n_lo
        out[f"k3_{low}"] += n_lo
    else:
        out[f"k1_{low}"] += n_lo * n * 2 * rank
    out["k1_f32"] += (n_iter - n_lo) * n * 2 * rank
    if precision != "k1_f32":
        out[precision] += out.pop("k1_f32")
        out["k1_f32"] = 0
    return out


def phase_device(torch):
    from enph459_super_resolution_tpu_torch import _build
    from enph459_super_resolution_tpu_torch.data import io
    from enph459_super_resolution_tpu_torch.native import png_loader

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    libpng = png_loader.available()  # builds the native codec with g++
    png_build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    # float32 FMA peak of the CUDA cores: 128 lanes per SM, 2 FLOP per FMA
    f32_peak = sms * 128 * 2 * max_sm_mhz * 1e6
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": sms,
          "max_sm_mhz": max_sm_mhz, "f32_peak_tflops": f32_peak / 1e12,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "png_codec": ("libpng" if libpng else
                        "PIL" if io._pil() is not None else "zlib"),
          "png_build_error": png_loader.build_error(),
          "png_build_s": png_build_s,
          "kernels_built": sorted(logs), "build_s": build_s,
          "ptxas": ptxas})
    return card, f32_peak


NATIVE_FRAMES = 20          # 1536 x 2048 PNGs decoded as one batch
NATIVE_THREADS = 8


def phase_native(torch):
    """The host PNG codec on the rig's sizes: ``load_gray_batch`` of 20
    frames of 1536x2048 (written by PIL) on the native pool of 8 threads
    and of 1, and PIL one file after another, pixel for pixel equal; one
    3072x4096 frame encoded by ``save_png`` (libpng at zlib level 1) and by
    PIL's default encoder, both read back equal.  Without libpng the
    fallback's seconds only."""
    from PIL import Image

    from enph459_super_resolution_tpu_torch.data import io
    from enph459_super_resolution_tpu_torch.native import png_loader

    del torch  # host IO only
    work = WORK / "native"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 7)
    scene = _smooth_scene(rng, (1536, 2048))
    paths = []
    for i in range(NATIVE_FRAMES):
        p = work / f"frame{i:02d}.png"
        Image.fromarray(_noisy_u8(rng, scene)).save(p)
        paths.append(str(p))

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    pil, pil_s = timed(lambda: [np.asarray(Image.open(p)).astype(np.float32)
                                for p in paths])
    row = {"phase": "native", "codec_available": png_loader.available(),
           "frames": [NATIVE_FRAMES, 1536, 2048], "pil_decode_s": pil_s}
    if png_loader.available():
        many, many_s = timed(lambda: io.load_gray_batch(
            paths, n_threads=NATIVE_THREADS))
        one, one_s = timed(lambda: io.load_gray_batch(paths, n_threads=1))
        check(all(np.array_equal(a, b) and np.array_equal(a, c)
                  for a, b, c in zip(many, one, pil)),
              "native batch decode differs from PIL's")
        row.update(threads=NATIVE_THREADS, decode_s=many_s,
                   decode_1_thread_s=one_s, speedup_over_1=one_s / many_s,
                   speedup_over_pil=pil_s / many_s)
    hr = _noisy_u8(rng, _smooth_scene(rng, (3072, 4096)))
    native_png, pil_png = work / "hr_native.png", work / "hr_pil.png"
    _, save_s = timed(lambda: io.save_png(hr, str(native_png)))
    _, pil_save_s = timed(lambda: Image.fromarray(hr).save(pil_png))
    for p in (native_png, pil_png):
        check(np.array_equal(np.asarray(Image.open(p)), hr),
              f"{p.name}: the encoded frame does not read back equal")
    row.update(encode=[3072, 4096], save_png_s=save_s,
               pil_encode_s=pil_save_s, encode_speedup=pil_save_s / save_s,
               save_png_mb=native_png.stat().st_size / 1e6,
               pil_mb=pil_png.stat().st_size / 1e6)
    emit(row)
    shutil.rmtree(work)
    return row


def _dense(op) -> np.ndarray:
    m = np.zeros((op.n_out, op.n_in), dtype=np.float32)
    r0 = 0
    for blk, (lo, hi) in zip(op.blocks, op.col_ranges):
        m[r0:r0 + blk.shape[0], lo:hi] = blk
        r0 += blk.shape[0]
    return m


def _true_window(op) -> int:
    """Band entries of an op's block decomposition (rows x block window)."""
    return sum(b.shape[0] * (hi - lo)
               for b, (lo, hi) in zip(op.blocks, op.col_ranges))


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def host_operators():
    """The host operator sets of the two runs: mono (LR 1536x2048, center+4)
    and rgb (LR 768x1024, 4 corners, 4 reps tiled)."""
    from enph459_super_resolution_tpu_torch.data.sessions import (
        CENTER_SHIFT_FILES, CORNER_SHIFTS_LR)
    from enph459_super_resolution_tpu_torch.sr.classical import (
        _host_solve_matrices, make_gaussian_psf)

    psf = make_gaussian_psf()
    shifts = tuple(s for _, s in CENTER_SHIFT_FILES)
    return {"mono": _host_solve_matrices(psf, shifts, 2, (1536, 2048)),
            "rgb4": _host_solve_matrices(psf, CORNER_SHIFTS_LR, 2,
                                         (768, 1024), reps=4)}


def _band_name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype)[6:]


def _k1_kind_types(torch, kind, f32_peak):
    """From ``KINDS``: the card's peak rate for the type a band kind
    multiplies in (f32 CUDA cores, tf32, bf16 or f16 tensor cores, f64),
    and the type and TF32 switch of the dense ``torch.matmul`` that computes
    the same function (the bf16 splits: float32, TF32 off; a rounded result:
    its type; a single pass: its storage type, bfloat16 as the bf16-rounded
    operands in float32)."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import (
        KINDS, round_tf32)

    spec = KINDS[kind]
    if spec.wide == torch.float64:
        return F64_PEAK, torch.float64, False
    if spec.rounding is round_tf32:
        return TF32_PEAK, torch.float32, True
    if spec.storage == torch.float32:
        return f32_peak, torch.float32, False
    lib = spec.out or (torch.float32 if spec.parts > 1 else spec.storage)
    return BF16_PEAK, lib, False


def _k1_probe(torch, kind, dev, width=130, seed=3):
    """K1's exactness probe for one band kind: a pack of two blocks (128
    and 37 rows, windows of 40) whose rows each hold one nonzero entry, and
    an input ``[2, 64, width]``, all of them ``c * 2^e`` with ``c`` in
    ``K1_PROBE_VALUES`` and ``e`` in [-3, 3].  Every kind's part products
    are exact in float32 and so are their sums, in any order, up to terms
    below half a float32 ulp that every order drops; so the kernel equals
    the plain version bit for bit, and a kind that forms other products (X3
    for X6, one tf32 pass for two) or skips its result's rounding does not.
    X9's three extra products lie below that resolution: no float32 result
    tells them from X6's."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import (
        pack_banded)

    rng = np.random.default_rng(seed)
    vals = np.asarray(K1_PROBE_VALUES)
    rows, win, n_in = (128, 37), 40, 64
    blocks, ranges = [], []
    for i, r in enumerate(rows):
        b = np.zeros((r, win))
        b[np.arange(r), rng.integers(0, win, r)] = (
            rng.choice(vals, r) * 2.0 ** rng.integers(-3, 4, r))
        blocks.append(b)
        ranges.append((i * (n_in - win), i * (n_in - win) + win))
    x = (rng.choice(vals, (2, n_in, width))
         * 2.0 ** rng.integers(-3, 4, (2, n_in, width)))
    return (pack_banded(blocks, ranges, sum(rows), n_in, dev, kind),
            torch.as_tensor(x, dtype=torch.float32, device=dev))


def phase_kernel(torch, f32_peak, host):
    """K1 against its plain version at the main path's shapes."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import (
        F64, KINDS, X3, banded_row_apply, banded_row_apply_reference,
        pack_banded, round_result)

    dev = torch.device("cuda")
    # every kind bit for bit on the exactness probe
    probe = {}
    for kind in KINDS:
        pack, x = _k1_probe(torch, kind, dev)
        got = banded_row_apply(pack, x)
        probe[_band_name(kind)] = bool(
            torch.equal(got, banded_row_apply_reference(pack, x)))
    emit({"phase": "kernel_probe", "exact": probe})
    check(all(probe.values()), f"K1 probe: kinds not bit-exact "
          f"{[k for k, ok in probe.items() if not ok]}")
    full, tiled = host["mono"], host["rgb4"]
    f32, bf16 = torch.float32, torch.bfloat16
    # frame 1 has a nonzero sub-pixel shift; (op, input batch, input width,
    # band type)
    cases = {
        # the zoom runs on the 5-frame stack and on the LR mean
        "zoom_r": (full["zoom_r"], 5, 2048, f32),
        "zoom_r_mean": (full["zoom_r"], 1, 2048, f32),
        "saa_r": (full["saa"][1][0], 1, 4096, f32),
        "fwd_r": (full["frames"][1][0][0], 1, 4096, f32),
        "bwd_r": (full["frames"][1][2][0], 1, 2048, f32),
        # the rgb_barcodes batched solve: 4 reps stacked along H
        "zoom_r_tiled4": (tiled["zoom_r"], 4, 1024, f32),
        "zoom_r_tiled4_mean": (tiled["zoom_r"], 1, 1024, f32),
        "saa_r_tiled4": (tiled["saa"][1][0], 1, 2048, f32),
        "fwd_r_tiled4": (tiled["frames"][1][0][0], 1, 2048, f32),
        "bwd_r_tiled4": (tiled["frames"][1][2][0], 1, 1024, f32),
        # the bf16 band store: zoom and Shift-and-Add under bf16, the
        # bulk's forward and back-projection rows (the banded hybrid:16
        # solve runs 320 of each)
        "zoom_r_bf16": (full["zoom_r"], 5, 2048, bf16),
        "saa_r_bf16": (full["saa"][1][0], 1, 4096, bf16),
        "fwd_r_bf16": (full["frames"][1][0][0], 1, 4096, bf16),
        "bwd_r_bf16": (full["frames"][1][2][0], 1, 2048, bf16),
        # mm_precision BF16_BF16_F32_X3: every f32-band row apply split
        "zoom_r_x3": (full["zoom_r"], 5, 2048, X3),
        "saa_r_x3": (full["saa"][1][0], 1, 4096, X3),
        "fwd_r_x3": (full["frames"][1][0][0], 1, 4096, X3),
        "bwd_r_x3": (full["frames"][1][2][0], 1, 2048, X3),
    }
    # the other matmul precisions' instantiations at the same four shapes
    for kind in KINDS:
        if kind in (f32, bf16, X3):
            continue
        name = _band_name(kind)
        cases.update({
            f"zoom_r_{name}": (full["zoom_r"], 5, 2048, kind),
            f"saa_r_{name}": (full["saa"][1][0], 1, 4096, kind),
            f"fwd_r_{name}": (full["frames"][1][0][0], 1, 4096, kind),
            f"bwd_r_{name}": (full["frames"][1][2][0], 1, 2048, kind)})
    rng = np.random.default_rng(SEED)
    rows = []
    for name, (host_op, batch, width, dtype) in cases.items():
        op = host_op.astype_band(dtype).to(dev)
        pack = op.row_pack
        x = torch.as_tensor(rng.uniform(0, 255, (batch, op.n_in, width)),
                            dtype=torch.float32, device=dev)
        got = banded_row_apply(pack, x)
        # the plain sum, before a kind's result rounding (BF16OUT, F16OUT)
        want_sum = banded_row_apply_reference(pack, x, rounded=False)
        want = round_result(dtype, want_sum)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        # the error as a share of sum_k |b_k| |x_k| per output
        absolute = pack_banded([np.abs(b) for b in host_op.blocks],
                               host_op.col_ranges, op.n_out, op.n_in, dev)
        scale = banded_row_apply_reference(absolute, x)
        rel_err = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
        share = K1_F64_SHARE if dtype == F64 else K1_SHARE
        if KINDS[dtype].out is None:
            check(err <= KERNEL_ATOL,
                  f"{name}: max|kernel - plain| {err} > {KERNEL_ATOL}")
            check(rel_err <= share,
                  f"{name}: max|kernel - plain| / sum|b||x| {rel_err} > "
                  f"{share}")
        else:
            # a value of the result's type, and the rounding of a sum within
            # the share of the plain one (rounding to nearest is monotone)
            lo = round_result(dtype, want_sum - share * scale)
            hi = round_result(dtype, want_sum + share * scale)
            check(torch.equal(got, round_result(dtype, got)),
                  f"{name}: result not rounded to {KINDS[dtype].out}")
            check(bool(((lo <= got) & (got <= hi)).all()),
                  f"{name}: result outside the rounding of the plain sum "
                  f"+- {share} sum|b||x|")
        del absolute, scale, want_sum
        # the library yardstick: one dense matmul of the same function (for
        # bf16 bands, of the bf16-rounded operator and input, in f32; for
        # the bf16 splits, of the f32 operator, TF32 off; for the other
        # kinds in the preset's type: tf32 on the tensor cores, f16, bf16
        # with a bf16 result, f64)
        peak, lib_dtype, lib_tf32 = _k1_kind_types(torch, dtype, f32_peak)
        dense = torch.as_tensor(_dense(host_op), device=dev)
        if lib_dtype == bf16 and dtype == bf16:
            dense, x_lib = dense.to(bf16).float(), x.to(bf16).float()
        else:
            dense, x_lib = dense.to(lib_dtype), x.to(lib_dtype)
        kernel_ms = time_ms(torch, lambda: banded_row_apply(pack, x), 20)
        kernel_device_ms = device_ms(
            torch, lambda: banded_row_apply(pack, x), 20)
        plain_ms = time_ms(torch, lambda: banded_row_apply_reference(pack, x),
                           5)
        torch.backends.cuda.matmul.allow_tf32 = lib_tf32
        try:
            library_ms = time_ms(torch, lambda: torch.matmul(dense, x_lib), 5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        # a multiply-add per nonzero band entry and column of x (the
        # 128-row block windows K1 walks count more: block_window_gflop)
        flops = 2.0 * _nonzeros(host_op) * width * batch
        window_flops = 2.0 * _true_window(host_op) * width * batch
        nbytes = (4.0 * (x.numel() + batch * op.n_out * width
                         + pack.meta.numel())
                  + sum(p.numel() * p.element_size() for p in pack.parts))
        # a split does one product of the f32 apply's work per pair of
        # parts it multiplies (X3 three, X6 six, X9 nine, TF32_X3 three)
        spec = KINDS[dtype]
        products = sum(1 for a in range(spec.parts)
                       for b in range(spec.parts) if a + b <= spec.reach)
        ops = flops * products
        window_ops = window_flops * products
        row = {"phase": "kernel", "op": name, "bands": _band_name(dtype),
               "x": [batch, op.n_in, width], "out_rows": op.n_out,
               "blocks": len(host_op.blocks),
               "true_window": max(hi - lo for lo, hi in host_op.col_ranges),
               "packed_window": int(pack.bands.shape[1]),
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
               "max_abs_err": err, "max_rel_err": rel_err,
               "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_type": str(lib_dtype).replace("torch.", "")
               + (" (tf32)" if lib_tf32 else ""),
               **_bound(ops, nbytes, peak),
               "kernel_tflops": ops / kernel_ms / 1e9}
        if spec.span_k:
            # what its row sub-tiles perform, at the type's peak
            performed = (2.0 * _k1_span_macs(pack, spec.span_k) * width
                         * batch * products)
            row["kernel_gflop"] = performed / 1e9
            row["kernel_share_of_peak"] = (
                performed / (kernel_device_ms * 1e-3) / peak)
        emit(row)
        row["block_window"] = {
            "gflop": window_ops / 1e9,
            **_bound(window_ops, nbytes, peak)}
        rows.append(row)
        del dense, x, x_lib, got, want
    emit(_k1_solve_bound(rows))
    return rows


def _k1_span_macs(pack, step: int) -> int:
    """Multiply-adds per column of x and product of parts that K1's span
    walk performs on ``pack`` (csrc/banded_rows.cu
    ``banded_rows_span_kernel``): each row sub-tile's ``SUB_ROWS`` rows over
    its span (``RowPack.spans``) rounded out to whole steps of ``step``
    window rows (the kind's ``span_k``: 8 for F64 and TF32_X3, 16 for X3,
    X6 and X9)."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import SUB_ROWS

    sp = pack.spans.cpu().numpy().astype(np.int64)
    lo = sp[..., 0] // step * step
    hi = -(-sp[..., 1] // step) * step
    return int(SUB_ROWS * (hi - lo).sum())


def _k1_solve_launches(n: int, n_iter: int, rank: int) -> dict:
    """K1's launches per op in one f32 banded solve of ``n`` frames over
    ``n_iter`` IBP iterations: the stack and mean zooms, a Shift-and-Add
    row apply per frame, a forward and a back-projection row apply per
    frame, iteration and PSF rank term; their sum is
    ``expected_launches``' K1 count."""
    table = {"zoom_r": 1, "zoom_r_mean": 1, "saa_r": n,
             "fwd_r": n * n_iter * rank, "bwd_r": n * n_iter * rank}
    want = expected_launches("f32", False, rank, n, n_iter)["k1_f32"]
    check(sum(table.values()) == want,
          f"K1 per-op launches {table} sum to {sum(table.values())}, "
          f"expected_launches to {want}")
    return table


def _k1_per_solve(rows, table) -> dict:
    """K1 per f32 banded solve whose launches are ``table``: the sum over
    its ops of each op's device time (frame 1's operators standing for
    every frame's) times its launches, and the same sum of the bounds
    over the bands' nonzeros and over the block windows."""
    f32 = {r["op"]: r for r in rows if r["bands"] == "float32"}

    def per_solve(get):
        return sum(n * get(f32[op]) for op, n in table.items())

    summed = per_solve(lambda r: r["kernel_device_ms"])
    bound = per_solve(lambda r: r["bound_ms"])
    return {"launches": sum(table.values()),
            "sum_of_per_op_device_ms": summed, "bound_ms": bound,
            "lost_ms": summed - bound,
            "block_window_bound_ms": per_solve(
                lambda r: r["block_window"]["bound_ms"]),
            "gflop": per_solve(lambda r: r["gflop"])}


def _k1_solve_bound(rows) -> dict:
    """K1's bound over the bands' nonzeros beside the block windows' (the
    figure before this restatement, printed here once), per op and per f32
    banded mono_cal_target solve (5 frames)."""
    from enph459_super_resolution_tpu_torch.sr.classical import \
        make_gaussian_psf
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    cfg = WORKLOADS["mono_cal_target"]
    table = _k1_solve_launches(
        5, cfg.ibp_iterations,
        _rank(make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)))
    f32 = {r["op"]: r for r in rows if r["bands"] == "float32"}
    per_op = {op: {"gflop": f32[op]["gflop"],
                   "bound_ms": f32[op]["bound_ms"],
                   "bound_by": f32[op]["bound_by"],
                   "block_window_gflop": f32[op]["block_window"]["gflop"],
                   "block_window_bound_ms": f32[op]["block_window"][
                       "bound_ms"],
                   "kernel_device_ms": f32[op]["kernel_device_ms"],
                   "share_of_bound": f32[op]["bound_ms"]
                   / f32[op]["kernel_device_ms"]}
              for op in table}
    return {"phase": "k1_bound", "per_op": per_op, "table": table,
            "solve": _k1_per_solve(rows, table)}


def _unfused_fwd(ops, hr, lr):
    from enph459_super_resolution_tpu_torch.sr.classical import \
        forward_model_mm

    return [lr[i] - forward_model_mm(hr, ops[i]) for i in range(len(ops))]


def _unfused_bwd(torch, ops, hr, err, step):
    from enph459_super_resolution_tpu_torch.sr.classical import \
        back_project_mm

    corr = torch.zeros_like(hr)
    for i in range(len(ops)):
        corr += back_project_mm(err[i], ops[i])
    return torch.clamp(hr + step * corr / len(ops), 0.0, 255.0)


def _nonzeros(op) -> int:
    """Nonzero entries of an op's band blocks."""
    return sum(int(np.count_nonzero(b)) for b in op.blocks)


def _fused_work(frames, pack):
    """The FLOPs K2 and K3 need on this pack: a multiply-add for each
    nonzero band entry and each column (row) it meets.  K2 forms each
    unique row operator's product of hr once and each term's column
    product; K3 forms every term's row and column products of its frame's
    error.  The packs' 64-row tiles over whole windows perform more (the
    f32 K2's count is :func:`_k2_f32_flops`)."""
    from enph459_super_resolution_tpu_torch.ops.fused_ibp import _dedup

    h, w = pack.lr_shape
    hh, hw = pack.hr_shape
    rows_u, _ = _dedup([op for fr in frames for op in fr[0]])
    k2 = (sum(2.0 * _nonzeros(op) * hw for op in rows_u)
          + sum(2.0 * _nonzeros(op) * h for fr in frames for op in fr[1]))
    k3 = sum(2.0 * _nonzeros(r) * w + 2.0 * _nonzeros(c) * hh
             for fr in frames for r, c in zip(fr[2], fr[3]))
    return k2, k3


def _k2_f32_flops(pack):
    """FLOPs the f32 K2 performs on this pack (csrc/fused_ibp.cu
    ``fused_fwd_f32_kernel``), as (row products, column products): per
    64 x 64 tile and 16-column chunk of its window (from a multiple of 4),
    each plan group's row product over each 32-row half's nonzero k range
    (from a multiple of 4, as its loop steps), and each term's column
    product in each 32-column half where the column operator's chunk is
    nonzero."""
    import torch

    ks = 16
    bandr, bandc = pack.f_bandr.float().cpu(), pack.f_bandc.float().cpu()
    nb, _, blk, win_r = bandr.shape
    nt, n_c, win_c, tile = bandc.shape
    sc = pack.f_sc.cpu().tolist()
    chunks = [-(-(s % 4 + win_c) // ks) for s in sc]
    nz = bandr.reshape(nb, -1, blk // 32, 32, win_r).ne(0).any(dim=3)
    k = torch.arange(win_r)
    lo = torch.where(nz, k, win_r).amin(dim=-1)
    hi = torch.where(nz, k, -1).amax(dim=-1)
    klen = torch.where(hi >= 0, (hi // 4 - lo // 4 + 1) * 4, 0)
    row = (2.0 * 32 * ks * float(klen[:, list(pack.f_groups)].sum())
           * sum(chunks) * (tile // 64))
    col = 0.0
    for j in range(nt):
        pad = torch.zeros((n_c, chunks[j] * ks, tile))
        pad[:, sc[j] % 4: sc[j] % 4 + win_c] = bandc[j]
        live = pad.reshape(n_c, chunks[j], ks, tile // 32, 32).ne(0).any(
            dim=4).any(dim=2).sum(dim=(1, 2))            # [n_c]
        col += sum(float(live[c]) for _, _, c in pack.f_entries)
    col *= 2.0 * 64 * 32 * ks * nb * (blk // 64)
    return row, col


def phase_fused(torch, f32_peak, host):
    """K2 and K3 against their plain versions, with the unfused yardstick."""
    from enph459_super_resolution_tpu_torch.ops.fused_ibp import (
        FusedIBP, fused_bwd_update, fused_bwd_update_reference, fused_fwd_err,
        fused_fwd_err_reference)
    from enph459_super_resolution_tpu_torch.sr.classical import (
        _cast_bf16, _to_device)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    rows = []
    for layout, mats in host.items():
        frames = mats["frames"]
        pack32 = FusedIBP.build(frames, dev)
        k2_flops, k3_flops = _fused_work(frames, pack32)
        n = pack32.n_frames
        step = 0.5
        hr = torch.as_tensor(rng.uniform(0, 255, pack32.hr_shape),
                             dtype=torch.float32, device=dev)
        lr32 = torch.as_tensor(rng.uniform(0, 255, (n,) + pack32.lr_shape),
                               dtype=torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            low = dtype == torch.bfloat16
            pack = pack32.astype_bands(dtype) if low else pack32
            ops = _to_device(_cast_bf16(frames) if low else frames, dev)
            lr = lr32.to(dtype)
            tol, peak = (BF16_ATOL, BF16_PEAK) if low else (KERNEL_ATOL,
                                                            f32_peak)
            err = fused_fwd_err(pack, hr, lr)
            want_err = fused_fwd_err_reference(pack, hr, lr)
            # K3 from the plain version's err stack, so it is judged alone
            out = fused_bwd_update(pack, hr, want_err, step / n, (0.0, 255.0))
            want_out = fused_bwd_update_reference(pack, hr, want_err,
                                                  step / n, (0.0, 255.0))
            torch.cuda.synchronize()
            band_bytes = {
                k: sum(getattr(pack, f"{k}_band{a}").numel()
                       * getattr(pack, f"{k}_band{a}").element_size()
                       for a in "rc") for k in "fb"}
            io_bytes = lr.numel() * lr.element_size()
            hr_bytes = hr.numel() * 4
            for kernel, got, want, flops, nbytes, fn, plain, unfused in (
                    ("fused_fwd", err, want_err, k2_flops,
                     hr_bytes + 2 * io_bytes + band_bytes["f"],
                     lambda: fused_fwd_err(pack, hr, lr),
                     lambda: fused_fwd_err_reference(pack, hr, lr),
                     lambda: _unfused_fwd(ops, hr, lr32)),
                    ("fused_bwd", out, want_out, k3_flops,
                     2 * hr_bytes + io_bytes + band_bytes["b"],
                     lambda: fused_bwd_update(pack, hr, want_err, step / n,
                                              (0.0, 255.0)),
                     lambda: fused_bwd_update_reference(
                         pack, hr, want_err, step / n, (0.0, 255.0)),
                     lambda: _unfused_bwd(torch, ops, hr, want_err.float(),
                                          step))):
                d = (got.float() - want.float()).abs()
                diff = d.max().item()
                name = f"{kernel}_{layout}_{str(dtype)[6:]}"
                check(bool(torch.isfinite(got.float()).all()),
                      f"{name}: non-finite output")
                check(got.dtype == want.dtype, f"{name}: dtype {got.dtype}")
                check(diff <= tol, f"{name}: max|kernel - plain| {diff} > "
                                   f"{tol}")
                kernel_ms = time_ms(torch, fn, 20)
                row = {"phase": "fused", "kernel": kernel, "pack": layout,
                       "bands": str(dtype)[6:], "frames": n,
                       "hr": list(pack.hr_shape), "lr": list(pack.lr_shape),
                       "bandr": list(getattr(pack, kernel[6] + "_bandr").shape),
                       "bandc": list(getattr(pack, kernel[6] + "_bandc").shape),
                       "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                       "max_abs_err": diff,
                       "share_differing": (d > 0).float().mean().item(),
                       "kernel_ms": kernel_ms,
                       "kernel_device_ms": device_ms(torch, fn, 20),
                       "plain_ms": time_ms(torch, plain, 3),
                       "unfused_ms": time_ms(torch, unfused, 5),
                       "library_ms": None, **_bound(flops, nbytes, peak),
                       "kernel_tflops": flops / kernel_ms / 1e9}
                if kernel == "fused_bwd" and not low:
                    # the f32 K3's strips: tiles per CUDA block that its
                    # launch takes, LR columns of the widest strip's union
                    row["strip_tiles"] = pack.strip_tiles()
                    row["union_w"] = pack.strip_union(row["strip_tiles"])
                if kernel == "fused_fwd" and not low:
                    # what the f32 K2's launch takes, and the FLOPs it
                    # performs (k ranges and zero chunks skipped) as a
                    # share of the f32 peak
                    row["layout"] = pack.k2_f32_layout()
                    k2_row, k2_col = _k2_f32_flops(pack)
                    row["kernel_gflop"] = (k2_row + k2_col) / 1e9
                    row["kernel_gflop_row_col"] = [k2_row / 1e9,
                                                   k2_col / 1e9]
                    row["kernel_share_of_peak"] = (
                        (k2_row + k2_col) / (kernel_ms * 1e-3) / peak)
                emit(row)
                rows.append(row)
        del pack32, hr, lr32
    return rows


def phase_profile(torch, run_solve, what: str, by_kernel=None):
    """Where one warm full-size solve spends the card's time: device time
    by kernel (torch.profiler) against the same solve's wall clock, whose
    ratio is the device's idle share (the profiler's own host overhead is
    in that wall time).  ``by_kernel``, a dict, receives every kernel's
    device ms by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_solve()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same device time again, and so do the device spans
    # of user annotations (the optimizer's step and zero_grad)
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if by_kernel is not None:
        by_kernel.update((k, t / 1e3) for k, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    busy_s = busy_us / 1e6
    emit({"phase": "profile", "what": what,
          "profiled_wall_s": wall_s, "device_busy_s": busy_s,
          "device_launches": sum(c for _, _, c in kernels),
          "device_idle_share": 1.0 - busy_s / wall_s,
          "top_kernels": [{"name": k[:90], "device_ms": t / 1e3, "count": c}
                          for k, t, c in top]})
    check(busy_s > 0, "the profiler saw no device time")
    return busy_s, wall_s


def _smooth_scene(rng, shape):
    import scipy.ndimage as ndi

    scene = ndi.gaussian_filter(rng.uniform(0, 255, shape), 1.5)
    lo, hi = scene.min(), scene.max()
    return (scene - lo) * (230.0 / (hi - lo)) + 10.0


def _noisy_u8(rng, scene):
    return np.clip(scene + rng.normal(0, 2.0, scene.shape), 0,
                   255).astype(np.uint8)


def _check_unit(out_dir: Path, lr_mean_name: str):
    for f in ("native_2x.png", "SAA.png", "SAA_IBP.png", lr_mean_name,
              "shifts.json", "metrics.json", "done.flag"):
        check((out_dir / f).exists(), f"missing artifact {out_dir / f}")
    metrics = json.loads((out_dir / "metrics.json").read_text())
    mse = metrics["mse_history"]
    check(all(np.isfinite(mse)), f"{out_dir}: non-finite MSE")
    check(mse[-1] < mse[0], f"{out_dir}: MSE did not fall "
                            f"({mse[0]} -> {mse[-1]})")
    return metrics


def _rank(psf) -> int:
    from enph459_super_resolution_tpu_torch.ops.opmatrix import \
        psf_separable_factors

    return len(psf_separable_factors(psf)[0])


def _u8_diff(a, b) -> int:
    from enph459_super_resolution_tpu_torch.sr.classical import to_uint8

    return int(np.abs(to_uint8(a).astype(np.int16)
                      - to_uint8(b).astype(np.int16)).max())


def _sr_run(workload: str, data_dir: Path, out: Path, *flags):
    """``sr.run`` on the card with every launch count zeroed just before
    it; returns (seconds, launches)."""
    from enph459_super_resolution_tpu_torch.sr import run

    reset_counts()
    t0 = time.perf_counter()
    rc = run.main(["--workload", workload, "--data-dir", str(data_dir),
                   "--output-dir", str(out), "--device", "cuda",
                   "--no-figures", *flags])
    run_s = time.perf_counter() - t0
    launches = read_counts()
    check(rc == 0, f"sr.run {' '.join(flags)} exited {rc}")
    return run_s, launches


def phase_mono(torch):
    import scipy.ndimage as ndi

    from enph459_super_resolution_tpu_torch.data.io import load_gray, save_png
    from enph459_super_resolution_tpu_torch.data.sessions import \
        load_center_shift_session
    from enph459_super_resolution_tpu_torch.sr import classical
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve, to_uint8)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    cfg = WORKLOADS["mono_cal_target"]
    rng = np.random.default_rng(SEED + 1)
    sdir = WORK / "mono" / "data" / "session0"
    scene = _smooth_scene(rng, (1536, 2048))
    for fname in ("center.png", "shift_0.png", "shift_1.png", "shift_2.png",
                  "shift_3.png"):
        save_png(_noisy_u8(rng, scene), str(sdir / fname))
    out = WORK / "mono" / "results"

    run_s, launches = _sr_run("mono_cal_target", sdir.parent, out)
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    expected = expected_launches("f32", False, _rank(psf), 5,
                                 cfg.ibp_iterations)
    check(launches == expected,
          f"launches {launches}, solve structure implies {expected}")
    unit = out / "session0"
    metrics = _check_unit(unit, cfg.lr_mean_name)
    check(metrics["hr_shape"] == [3072, 4096], f"hr {metrics['hr_shape']}")

    session = load_center_shift_session(str(sdir))
    lr_mean = session.frames.astype(np.float64).mean(axis=0)
    ref_native = to_uint8(ndi.zoom(lr_mean, 2, order=3))
    native = load_gray(str(unit / "native_2x.png")).astype(np.int16)
    native_diff = int(np.abs(native - ref_native).max())
    check(native_diff <= 1, f"native_2x vs scipy zoom: {native_diff} > 1")

    # the same solve again: warm (operator tree kept in process since
    # sr.run), then cold (tree dropped: read back from the disk cache and
    # every pack uploaded again), then profiled, then with the plain
    # versions on the card
    frames = torch.as_tensor(session.frames, device="cuda")

    def timed_solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(frames, psf, session.shifts, device="cuda")
        return res, time.perf_counter() - t0

    solve_runs = []
    for _ in range(3):
        kern, dt = timed_solve()
        solve_runs.append(dt)
    solve_s = sorted(solve_runs)[1]
    classical._device_matrices.cache_clear()
    _, cold_solve_s = timed_solve()
    busy_s, profiled_s = phase_profile(
        torch, lambda: solve(frames, psf, session.shifts, device="cuda"),
        "one warm mono_cal_target solve, f32")
    t0 = time.perf_counter()
    plain = solve(frames, psf, session.shifts, device="cuda", plain=True)
    plain_solve_s = time.perf_counter() - t0
    ibp_png = load_gray(str(unit / "SAA_IBP.png")).astype(np.int16)
    ibp_diff = int(np.abs(ibp_png - to_uint8(plain["ibp"])).max())
    check(ibp_diff <= 1, f"SAA_IBP kernel vs plain: {ibp_diff} > 1")
    rerun_diff = int(np.abs(ibp_png - to_uint8(kern["ibp"])).max())
    emit({"phase": "mono_cal_target", "lr": [5, 1536, 2048],
          "hr": [3072, 4096], "ibp_iterations": cfg.ibp_iterations,
          "launches": launches, "launches_expected": expected,
          "native_vs_scipy_max_diff": native_diff,
          "ibp_kernel_vs_plain_max_diff": ibp_diff,
          "ibp_rerun_max_diff": rerun_diff,
          "mse_first": metrics["mse_history"][0],
          "mse_last": metrics["mse_history"][-1],
          "sr_run_s": run_s, "sr_run_solve_s": metrics["timings_s"]["solve"],
          "solve_s_runs": solve_runs, "solve_s": solve_s,
          "hr_mpix_per_s": HR_MPIX / solve_s,
          "cold_solve_s": cold_solve_s,
          "operator_prologue_s": cold_solve_s - solve_s,
          "profiled_solve_s": profiled_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / profiled_s,
          "plain_solve_s": plain_solve_s})
    return {"frames": frames, "shifts": session.shifts, "psf": psf,
            "f32": kern, "data": sdir.parent, "cfg": cfg,
            "launches": launches}


def phase_mono_bf16(torch, mono):
    """The slice's main path: ``sr.run --band-store bf16``, which auto-routes
    to the fused kernels at this shape."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.sr.classical import solve

    cfg = mono["cfg"]
    out = WORK / "mono" / "results_bf16"
    run_s, launches = _sr_run("mono_cal_target", mono["data"], out,
                              "--band-store", "bf16")
    expected = expected_launches("bf16", True, _rank(mono["psf"]), 5,
                                 cfg.ibp_iterations)
    check(launches == expected,
          f"bf16 launches {launches}, solve structure implies {expected}")
    unit = out / "session0"
    metrics = _check_unit(unit, cfg.lr_mean_name)
    frames, psf, shifts = mono["frames"], mono["psf"], mono["shifts"]
    t0 = time.perf_counter()
    plain = solve(frames, psf, shifts, device="cuda", band_store="bf16",
                  plain=True)
    plain_solve_s = time.perf_counter() - t0
    ibp_png = load_gray(str(unit / "SAA_IBP.png")).astype(np.int16)
    vs_plain = _u8_diff(ibp_png, plain["ibp"])
    vs_f32 = _u8_diff(ibp_png, mono["f32"]["ibp"])
    check(vs_plain <= 2, f"bf16 SAA_IBP kernels vs plain: {vs_plain} > 2")
    check(vs_f32 <= 3, f"bf16 SAA_IBP vs the f32 solve: {vs_f32} > 3")
    busy_s, profiled_s = phase_profile(
        torch, lambda: solve(frames, psf, shifts, device="cuda",
                             band_store="bf16"),
        "one warm mono_cal_target solve, bf16 (fused)")
    emit({"phase": "mono_bf16", "launches": launches,
          "launches_expected": expected,
          "ibp_kernels_vs_plain_max_diff": vs_plain,
          "ibp_vs_f32_max_diff": vs_f32,
          "mse_first": metrics["mse_history"][0],
          "mse_last": metrics["mse_history"][-1],
          "sr_run_s": run_s, "sr_run_solve_s": metrics["timings_s"]["solve"],
          "plain_solve_s": plain_solve_s, "profiled_solve_s": profiled_s,
          "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / profiled_s})
    return launches


def phase_modes(torch, mono):
    """Every band store and engine at full size: launches, parity with the
    f32 banded solve, warm solve time."""
    from enph459_super_resolution_tpu_torch.sr.classical import solve

    frames, psf, shifts = mono["frames"], mono["psf"], mono["shifts"]
    n_iter = mono["cfg"].ibp_iterations
    f32 = mono["f32"]
    modes = (("f32", "off", 1), ("f32", "on", 1), ("bf16", "auto", 3),
             ("bf16", "off", 3), (f"hybrid:{TAIL}", "auto", 1),
             (f"hybrid:{TAIL}", "on", 1))
    out = {}
    for store, fused, tol in modes:
        kind = store.split(":")[0]
        fused_on = fused == "on" or (fused == "auto" and kind == "bf16")
        reset_counts()
        res = solve(frames, psf, shifts, device="cuda", band_store=store,
                    fused=fused)
        launches = read_counts()
        expected = expected_launches(kind, fused_on, _rank(psf), 5, n_iter)
        name = f"{store} fused={fused}"
        check(launches == expected,
              f"{name}: launches {launches}, structure implies {expected}")
        diff = _u8_diff(res["ibp"], f32["ibp"])
        check(diff <= tol, f"{name}: SAA_IBP vs f32 banded {diff} > {tol}")
        saa_equal = bool(np.array_equal(res["saa"], f32["saa"]))
        if kind in ("f32", "hybrid"):
            check(saa_equal, f"{name}: saa differs from the f32 solve's")
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(frames, psf, shifts, device="cuda", band_store=store,
                  fused=fused)
            runs.append(time.perf_counter() - t0)
        solve_s = sorted(runs)[1]
        row = {"phase": "mode", "band_store": store, "fused": fused,
               "engine": "fused" if fused_on else "banded",
               "launches": launches, "ibp_vs_f32_max_diff": diff,
               "saa_equal_f32": saa_equal, "solve_s_runs": runs,
               "solve_s": solve_s, "hr_mpix_per_s": HR_MPIX / solve_s,
               "mse_last": float(res["mse_history"][-1])}
        emit(row)
        out[(store, fused)] = row
    return out


def phase_rgb(torch):
    from enph459_super_resolution_tpu_torch.data.io import load_gray, save_png
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve_batch, to_uint8)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    cfg = WORKLOADS["rgb_barcodes"]
    rng = np.random.default_rng(SEED + 2)
    sdir = WORK / "rgb" / "data" / "barcodes0"
    scene = _smooth_scene(rng, (1536, 2048))
    n_reps = 4
    for ci in range(4):
        for ri in range(n_reps):
            save_png(_noisy_u8(rng, scene),
                     str(sdir / f"corner{ci}_rep{ri:02d}.png"))
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    units = cfg.load(str(sdir))
    check(len(units) == n_reps, f"{len(units)} units, expected {n_reps}")
    stack = np.stack([u.frames for u in units])
    result = {}
    for store, tol in (("f32", 1), ("bf16", 2)):
        out = WORK / "rgb" / f"results_{store}"
        run_s, launches = _sr_run("rgb_barcodes", sdir.parent, out,
                                  "--band-store", store)
        expected = expected_launches(store, store == "bf16", _rank(psf), 4,
                                     cfg.ibp_iterations)
        check(launches == expected, f"{store}: launches {launches} for one "
                                    f"batched solve, structure implies "
                                    f"{expected}")
        # the same batched solve with the plain versions on the card
        t0 = time.perf_counter()
        plain = solve_batch(stack, psf, units[0].shifts,
                            factor=cfg.upsample_factor,
                            n_iter=cfg.ibp_iterations, step=cfg.ibp_step,
                            device="cuda", band_store=store, plain=True)
        plain_batch_s = time.perf_counter() - t0
        batch_s, ibp_diffs = None, []
        for ri, unit in enumerate(units):
            unit_dir = out / "barcodes0" / f"rep{unit.rep}"
            m = _check_unit(unit_dir, cfg.lr_mean_name)
            check(m["hr_shape"] == [1536, 2048],
                  f"rep{ri} hr {m['hr_shape']}")
            batch_s = m["timings_s"]["solve_batch_total"]
            ibp_png = load_gray(str(unit_dir / "SAA_IBP.png")).astype(
                np.int16)
            ibp_diffs.append(int(np.abs(ibp_png
                                        - to_uint8(plain["ibp"][ri])).max()))
        check(max(ibp_diffs) <= tol,
              f"{store}: SAA_IBP kernels vs plain, per rep: {ibp_diffs}")
        emit({"phase": "rgb_barcodes", "band_store": store, "reps": n_reps,
              "lr": [4, 768, 1024], "hr": [1536, 2048],
              "launches": launches, "launches_expected": expected,
              "ibp_kernels_vs_plain_max_diff_per_rep": ibp_diffs,
              "sr_run_s": run_s, "solve_batch_s": batch_s,
              "hr_mpix_per_s": n_reps * 1536 * 2048 / 1e6 / batch_s,
              "plain_solve_batch_s": plain_batch_s})
        result[store] = launches
    return result


def _ulp_bf16(torch, v):
    m = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _trunk_diff(torch, got, want, skip=None):
    """(max|diff|, max|diff| in bf16 ulps of the larger magnitude, share of
    elements beyond one such ulp, whether every element is within the
    stated bound)."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        err = d.max().item()
        return err, None, None, err <= TRUNK_F32_ATOL
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = _ulp_bf16(torch, big)
    bound = TRUNK_F32_ATOL + ulp
    if skip is not None:
        bound = bound + 2 * _ulp_bf16(torch, torch.maximum(big,
                                                           skip.float().abs()))
    return (d.max().item(), (d / ulp).max().item(),
            (d > ulp).float().mean().item(), bool((d <= bound).all()))


def phase_trunk(torch, f32_peak):
    """K4 against its plain version at the two serving shapes."""
    import torch.nn.functional as F

    from enph459_super_resolution_tpu_torch.ops import trunk

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    convs = [(rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.05,
              rng.standard_normal(64).astype(np.float32) * 0.1)
             for _ in range(2)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = []
    for name, shape in (("edsr", (EDSR_BATCH, EDSR_LR, EDSR_LR)),
                        ("burst_lr", BURST_PHASES[:3])):
        x32 = torch.randn(shape + (64,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            pack = trunk.pack_trunk(convs, dtype, dev)
            peak = f32_peak if dtype == torch.float32 else BF16_PEAK
            x = x32.to(dtype)
            # (epilogue, pack, conv, input, skip): the residual launch takes
            # the plain version's relu output, so each launch is judged alone
            cases = [("relu", pack, 0, x, None),
                     ("skip", pack, 1, trunk.trunk_conv_reference(x, pack, 0),
                      x)]
            if name == "edsr":
                cases.append(("relu_only",
                              trunk.TrunkPack(pack.w[:1], pack.b[:1]), 0, x,
                              None))
            for epi, p, i, inp, skip in cases:
                if epi == "relu_only":
                    def fn():
                        return trunk.fused_resblocks_packed(inp, p,
                                                            relu_only=True)
                else:
                    def fn():
                        return trunk.trunk_conv(inp, p, i, skip=skip)

                def plain():
                    return trunk.trunk_conv_reference(inp, p, i, skip=skip)

                got, want = fn(), plain()
                torch.cuda.synchronize()
                err, ulps, share, ok = _trunk_diff(torch, got, want, skip)
                label = f"trunk {name} {epi} {str(dtype)[6:]}"
                check(bool(torch.isfinite(got.float()).all()),
                      f"{label}: non-finite output")
                check(ok, f"{label}: max|kernel - plain| {err} "
                          f"({ulps} bf16 ulps) beyond the bound")
                del got, want
                # the library yardstick: one cuDNN conv with bias, same type
                w = (p.w[i].reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
                     .contiguous())
                b = p.b[i].to(dtype)
                x_cl = inp.permute(0, 3, 1, 2)
                flops = 2.0 * 9 * 64 * 64 * x.numel() / 64
                nbytes = (x.element_size() * x.numel() * (3 if skip is not None
                                                         else 2)
                          + p.w[i].numel() * p.w[i].element_size() + 4 * 64)
                reps = 20 if name == "edsr" else 5
                kernel_ms = time_ms(torch, fn, reps)
                row = {"phase": "trunk", "shape": name,
                       "x": list(x.shape), "dtype": str(dtype)[6:],
                       "epilogue": epi, "gflop": flops / 1e9,
                       "mbytes": nbytes / 1e6, "max_abs_err": err,
                       "max_bf16_ulps": ulps, "share_beyond_1ulp": share,
                       "kernel_ms": kernel_ms,
                       "kernel_device_ms": device_ms(torch, fn, reps),
                       "plain_ms": time_ms(torch, plain, 3),
                       "library_ms": time_ms(
                           torch, lambda: F.conv2d(x_cl, w, b, padding=1),
                           reps),
                       **_bound(flops, nbytes, peak),
                       "kernel_tflops": flops / kernel_ms / 1e9}
                emit(row)
                rows.append(row)
            del cases, x
        del x32
    return rows


def _serve(torch, fn, inputs):
    """Each request through ``fn`` on the host clock, ending in a
    synchronize; returns (outputs of the last request, seconds per
    request)."""
    times = []
    for x in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def phase_edsr(torch):
    """EDSR-baseline x4 served through the fused trunk, bf16 and f32."""
    from enph459_super_resolution_tpu_torch.models import EDSR
    from enph459_super_resolution_tpu_torch.models.fused import \
        make_edsr_fused_apply

    model = EDSR(scale=4, channels=3, n_resblocks=16, n_feats=64,
                 device="cuda", generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 5)
    inputs = [torch.as_tensor(
        rng.uniform(0, 255, (EDSR_BATCH, EDSR_LR, EDSR_LR, 3)),
        dtype=torch.float32, device="cuda") for _ in range(EDSR_REQUESTS)]
    with torch.no_grad():
        model(inputs[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = model(inputs[-1])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    mean = torch.tensor([0.4488, 0.4371, 0.4040], device="cuda") * 255.0
    span = (want - mean).abs().max().item()
    out_mpix = EDSR_BATCH * (4 * EDSR_LR) ** 2 / 1e6
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = "k4_bf16" if dtype == torch.bfloat16 else "k4_f32"
        fn = make_edsr_fused_apply(model, dtype=dtype)
        fn(inputs[0])  # warm-up: cuDNN's first calls at these shapes
        reset_counts()
        got, times = _serve(torch, fn, inputs)
        launches = read_counts()
        expected = dict.fromkeys(launches, 0)
        expected[key] = 32 * EDSR_REQUESTS
        check(launches == expected, f"edsr {dtype}: launches {launches}, "
                                    f"expected {expected}")
        check(tuple(got.shape) == (EDSR_BATCH, 4 * EDSR_LR, 4 * EDSR_LR, 3),
              f"edsr output {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "edsr: non-finite output")
        err = (got - want).abs().max().item()
        bound = (EDSR_F32_SHARE if dtype == torch.float32
                 else EDSR_BF16_SHARE) * span
        check(err <= bound, f"edsr {dtype}: max|fused - module| {err} > "
                            f"{bound}")
        s = sorted(times)[len(times) // 2]
        row = {"phase": "edsr", "dtype": str(dtype)[6:],
               "lr": [EDSR_BATCH, EDSR_LR, EDSR_LR, 3],
               "hr": list(got.shape), "requests": EDSR_REQUESTS,
               "launches": launches, "max_abs_vs_module": err,
               "bound": bound, "output_span": span,
               "request_s_runs": times, "request_s": s,
               "images_per_s": EDSR_BATCH / s,
               "output_mpix_per_s": out_mpix / s, "module_f32_s": plain_s}
        if dtype == torch.bfloat16:
            busy_s, wall_s = phase_profile(
                torch, lambda: (fn(inputs[0]), torch.cuda.synchronize()),
                "one EDSR x4 request, batch 8 x 256x256, bf16 fused trunk")
            row.update(profiled_s=wall_s, device_busy_s=busy_s,
                       device_idle_share=1.0 - busy_s / wall_s)
        emit(row)
        result[key] = row
    return model, result


def phase_burst_lr(torch):
    """BurstFusionLR served through the fused trunk at the classical
    headline geometry, bf16, with a random head so the trunk shows."""
    from enph459_super_resolution_tpu_torch.models import BurstFusionLR
    from enph459_super_resolution_tpu_torch.models.fused import \
        make_burst_lr_fused_apply

    g = torch.Generator().manual_seed(SEED + 6)
    model = BurstFusionLR(n_frames=4, factor=2, n_feats=64, n_resblocks=8,
                          device="cuda", generator=g)
    with torch.no_grad():
        model.Conv_1.weight.copy_(torch.randn(model.Conv_1.weight.shape,
                                              generator=g) * 0.05)
        model.Conv_1.bias.copy_(torch.randn(4, generator=g) * 0.1)
    rng = np.random.default_rng(SEED + 6)
    x = torch.as_tensor(rng.uniform(0, 255, BURST_PHASES),
                        dtype=torch.float32, device="cuda")
    with torch.no_grad():
        want = model(x)
        base = model.shift_and_add(x)
    span = (want - base).abs().max().item()
    fn = make_burst_lr_fused_apply(model)
    fn(x)  # warm-up
    reset_counts()
    got, times = _serve(torch, fn, [x] * 3)
    launches = read_counts()
    expected = dict.fromkeys(launches, 0)
    expected["k4_bf16"] = 16 * 3
    check(launches == expected, f"burst_lr launches {launches}, expected "
                                f"{expected}")
    check(tuple(got.shape) == (1, 3072, 4096, 1), f"burst {got.shape}")
    check(bool(torch.isfinite(got).all()), "burst_lr: non-finite output")
    err = (got - want).abs().max().item()
    check(span > 1.0, f"burst_lr: the trunk does not show ({span})")
    check(err <= EDSR_BF16_SHARE * span,
          f"burst_lr: max|fused - module| {err} > {EDSR_BF16_SHARE * span}")
    s = sorted(times)[1]
    row = {"phase": "burst_lr", "dtype": "bfloat16",
           "phases": list(BURST_PHASES), "hr": list(got.shape),
           "launches": launches, "max_abs_vs_module": err,
           "residual_span": span, "request_s_runs": times, "request_s": s,
           "hr_mpix_per_s": HR_MPIX / s}
    emit(row)
    return row


def phase_tiled(torch, model):
    """One 4K frame through tiled_infer on the EDSR-16 module, against the
    whole-image forward."""
    from enph459_super_resolution_tpu_torch.models.infer import tiled_infer

    lr = np.random.default_rng(SEED + 7).uniform(
        0, 255, (540, 960, 3)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tiled_infer(model, lr)
    tiled_s = time.perf_counter() - t0
    with torch.no_grad():
        t0 = time.perf_counter()
        whole = model(torch.as_tensor(lr, device="cuda")[None])[0]
        whole = whole.cpu().numpy()
        whole_s = time.perf_counter() - t0
    check(got.shape == (2160, 3840, 3), f"tiled {got.shape}")
    err = float(np.abs(got - whole).max())
    check(err <= 5e-3, f"tiled vs whole image: {err} > 5e-3")
    row = {"phase": "tiled", "lr": [540, 960, 3], "hr": list(got.shape),
           "max_abs_vs_whole": err, "tiled_s": tiled_s, "whole_s": whole_s,
           "hr_mpix_per_s": 2160 * 3840 / 1e6 / tiled_s}
    emit(row)
    return row


def _warm_solve(torch, **kw):
    """Launch counts of one solve (counts zeroed just before it), then the
    median wall time of three more warm runs: (result, launches, runs,
    median seconds)."""
    from enph459_super_resolution_tpu_torch.sr.classical import solve

    reset_counts()
    res = solve(device="cuda", **kw)
    launches = read_counts()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(device="cuda", **kw)
        runs.append(time.perf_counter() - t0)
    return res, launches, runs, sorted(runs)[1]


# mm_precision names on K1's other instantiations: (name, K1 counter,
# SAA_IBP's class of HIGHEST in uint8)
NEW_PRESETS = (("BF16_BF16_F32_X6", "k1_x6", 1),
               ("BF16_BF16_F32_X9", "k1_x9", 1),
               ("TF32_TF32_F32", "k1_tf32", 2),
               ("TF32_TF32_F32_X3", "k1_tf32x3", 1),
               ("F16_F16_F32", "k1_f16", 2),
               ("F16_F16_F16", "k1_f16out", 2),
               ("BF16_BF16_BF16", "k1_bf16out", 3),
               ("F64_F64_F64", "k1_f64", 1))


def phase_precision(torch, mono, modes):
    """Warm mono solves at the matmul precisions other than HIGHEST."""
    from enph459_super_resolution_tpu_torch.sr.classical import solve

    frames, psf, shifts = mono["frames"], mono["psf"], mono["shifts"]
    n_iter = mono["cfg"].ibp_iterations
    f32 = mono["f32"]
    highest = modes[("f32", "off")]
    cases = (("f32", "BF16_BF16_F32_X3", "k1_x3", 1),
             ("f32", "DEFAULT", "k1_bf16", 3),
             (f"hybrid:{TAIL}", "BF16_BF16_F32_X3", "k1_x3", 1),
             # the other presets, each on its own K1 instantiation, within
             # the class of HIGHEST the CPU tests state
             # (tests/test_torch_precision.py)
             *(("f32", name, key, tol) for name, key, tol in NEW_PRESETS))
    out = {}
    for store, precision, k1, tol in cases:
        res, launches, runs, solve_s = _warm_solve(
            torch, lr_stack=frames, psf=psf, shifts_yx=shifts,
            band_store=store, mm_precision=precision)
        expected = expected_launches(store.split(":")[0], False, _rank(psf),
                                     5, n_iter, precision=k1)
        name = f"{store} {precision}"
        check(launches == expected,
              f"{name}: launches {launches}, structure implies {expected}")
        diff = _u8_diff(res["ibp"], f32["ibp"])
        check(diff <= tol, f"{name}: SAA_IBP vs HIGHEST {diff} > {tol}")
        row = {"phase": "precision", "band_store": store,
               "mm_precision": precision, "launches": launches,
               "launches_expected": expected,
               "ibp_vs_highest_max_diff": diff,
               "saa_vs_highest_max_diff": _u8_diff(res["saa"], f32["saa"]),
               "mse_last": float(res["mse_history"][-1]),
               "mse_last_highest": float(f32["mse_history"][-1]),
               "solve_s_runs": runs, "solve_s": solve_s,
               "hr_mpix_per_s": HR_MPIX / solve_s,
               "highest_solve_s": highest["solve_s"],
               "highest_hr_mpix_per_s": highest["hr_mpix_per_s"]}
        if (store, precision) == ("f32", "BF16_BF16_F32_X3"):
            busy_s, profiled_s = phase_profile(
                torch, lambda: solve(frames, psf, shifts, device="cuda",
                                     mm_precision=precision),
                "one warm mono_cal_target solve, f32 store, "
                "BF16_BF16_F32_X3")
            row.update(profiled_solve_s=profiled_s, device_busy_s=busy_s,
                       device_idle_share=1.0 - busy_s / profiled_s)
        emit(row)
        out[name] = row
    return out


def _rank2_psf():
    """A 7x7 PSF of exactly two separable terms, as a measured PSF's SVD
    keeps: a round Gaussian core plus an anisotropic halo."""
    t = np.arange(-3, 4, dtype=np.float64)

    def g(sigma):
        return np.exp(-t * t / (2.0 * sigma * sigma))

    psf = np.outer(g(1.0), g(1.0)) + 0.3 * np.outer(g(0.6), g(2.0))
    return psf / psf.sum()


def phase_adjoint(torch, mono):
    """``sr.run --solver adjoint``, ``landweber_refine``, then rank-2 PSF
    solves."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.sr.classical import (
        landweber_refine, solve)

    cfg = mono["cfg"]
    n_iter = max(1, round(cfg.ibp_iterations / 4))
    out = WORK / "mono" / "results_adjoint"
    run_s, launches = _sr_run("mono_cal_target", mono["data"], out,
                              "--solver", "adjoint")
    expected = expected_launches("f32", False, _rank(mono["psf"]), 5, n_iter)
    check(launches == expected,
          f"adjoint launches {launches}, structure implies {expected}")
    metrics = _check_unit(out / "session0", cfg.lr_mean_name)
    mse = np.asarray(metrics["mse_history"])
    check(len(mse) == n_iter and bool((np.diff(mse) < 0).all()),
          f"adjoint MSE history of {len(mse)} does not descend")
    ibp80 = float(mono["f32"]["mse_history"][-1])
    check(mse[-1] <= 1.02 * ibp80,
          f"adjoint final MSE {mse[-1]} > 1.02 x IBP-80's {ibp80}")
    ibp_png = load_gray(str(out / "session0" / "SAA_IBP.png"))
    row = {"phase": "adjoint", "iterations": n_iter, "step": 2.0,
           "launches": launches, "launches_expected": expected,
           "mse_first": float(mse[0]), "mse_last": float(mse[-1]),
           "mse_last_ibp80": ibp80, "sr_run_s": run_s,
           "sr_run_solve_s": metrics["timings_s"]["solve"],
           "ibp_vs_ibp80_max_diff": _u8_diff(ibp_png, mono["f32"]["ibp"])}

    frames, shifts = mono["frames"], mono["shifts"]
    res, launches, runs, solve_s = _warm_solve(
        torch, lr_stack=frames, psf=mono["psf"], shifts_yx=shifts,
        n_iter=n_iter, step=2.0, solver="adjoint")
    check(launches == expected,
          f"warm adjoint launches {launches}, implies {expected}")
    row.update(solve_s_runs=runs, solve_s=solve_s,
               hr_mpix_per_s=HR_MPIX / solve_s)

    # landweber_refine from the SAA seed: per iteration a forward and a
    # back-projection row apply per frame, then one forward per frame
    seed = mono["f32"]["saa"]
    reset_counts()
    t0 = time.perf_counter()
    hr, hist, final = landweber_refine(seed, frames, mono["psf"], shifts,
                                       n_iter=n_iter, device="cuda")
    refine_s = time.perf_counter() - t0
    launches = read_counts()
    expected = expected_launches("f32", False, _rank(mono["psf"]), 5, n_iter)
    expected["k1_f32"] -= 2  # no zoom of the LR mean or of the stack
    check(launches == expected,
          f"landweber_refine launches {launches}, implies {expected}")
    check(hr.shape == seed.shape and bool(np.isfinite(hr).all()),
          f"landweber_refine: shape {hr.shape} or non-finite values")
    check(len(hist) == n_iter and final < hist[0],
          f"landweber_refine MSE {hist[0]} -> {final} does not fall")
    hr_plain, _, final_plain = landweber_refine(
        seed, frames, mono["psf"], shifts, n_iter=n_iter, device="cuda",
        plain=True)
    diff = _u8_diff(hr, hr_plain)
    check(diff <= 1, f"landweber_refine kernels vs plain {diff} > 1")
    row.update(refine_launches=launches, refine_launches_expected=expected,
               refine_mse_first=float(hist[0]), refine_final_mse=final,
               refine_final_mse_plain=final_plain,
               refine_vs_plain_max_diff=diff, refine_s=refine_s)

    psf2 = _rank2_psf()
    check(_rank(psf2) == 2, f"rank-2 PSF has rank {_rank(psf2)}")
    res, launches, runs, solve_s = _warm_solve(
        torch, lr_stack=frames, psf=psf2, shifts_yx=shifts, n_iter=n_iter,
        step=2.0, solver="adjoint")
    expected = expected_launches("f32", False, 2, 5, n_iter)
    check(launches == expected,
          f"rank-2 adjoint launches {launches}, implies {expected}")
    hist = res["mse_history"]
    check(bool((np.diff(hist) < 0).all()), "rank-2 adjoint does not descend")
    plain = solve(frames, psf2, shifts, n_iter=n_iter, step=2.0,
                  device="cuda", solver="adjoint", plain=True)
    diff = _u8_diff(res["ibp"], plain["ibp"])
    check(diff <= 1, f"rank-2 adjoint SAA_IBP kernels vs plain {diff} > 1")
    row.update(rank2_adjoint_launches=launches,
               rank2_adjoint_launches_expected=expected,
               rank2_adjoint_vs_plain_max_diff=diff,
               rank2_adjoint_mse_first=float(hist[0]),
               rank2_adjoint_mse_last=float(hist[-1]),
               rank2_adjoint_solve_s=solve_s)

    res, launches, runs, solve_s = _warm_solve(
        torch, lr_stack=frames, psf=psf2, shifts_yx=shifts,
        band_store="bf16")
    expected = expected_launches("bf16", True, 2, 5, cfg.ibp_iterations)
    check(launches == expected,
          f"rank-2 bf16 fused launches {launches}, implies {expected}")
    plain = solve(frames, psf2, shifts, device="cuda", band_store="bf16",
                  plain=True)
    diff = _u8_diff(res["ibp"], plain["ibp"])
    check(diff <= 2, f"rank-2 bf16 fused SAA_IBP kernels vs plain {diff} > 2")
    row.update(rank2_fused_bf16_launches=launches,
               rank2_fused_bf16_vs_plain_max_diff=diff,
               rank2_fused_bf16_solve_s=solve_s)
    emit(row)
    return row


def phase_conv(torch, mono):
    """The conv engine at full size against the banded engine."""
    frames, psf, shifts = mono["frames"], mono["psf"], mono["shifts"]
    res, launches, runs, solve_s = _warm_solve(
        torch, lr_stack=frames, psf=psf, shifts_yx=shifts, engine="conv")
    check(all(v == 0 for v in launches.values()),
          f"conv engine launched hand-written kernels: {launches}")
    for k in ("lr_mean", "native", "saa", "ibp"):
        check(bool(np.isfinite(res[k]).all()), f"conv {k}: non-finite")
    diffs = {k: _u8_diff(res[k], mono["f32"][k])
             for k in ("native", "saa", "ibp")}
    check(diffs["ibp"] <= 1, f"conv SAA_IBP vs mm {diffs['ibp']} > 1")
    row = {"phase": "conv", "ibp_iterations": mono["cfg"].ibp_iterations,
           "launches": launches, "vs_mm_max_diff": diffs,
           "mse_last": float(res["mse_history"][-1]),
           "mse_last_mm": float(mono["f32"]["mse_history"][-1]),
           "solve_s_runs": runs, "solve_s": solve_s,
           "hr_mpix_per_s": HR_MPIX / solve_s}
    emit(row)
    return dict(row, result=res)


def _sharded_vs(got, want, what: str) -> dict:
    """A sharded solve against an unsharded one: HR within ``SHARDED_ATOL``
    over the full array, the MSE history within ``SHARDED_RTOL``, every
    artifact within +-1 uint8."""
    hr_err = float(np.abs(got["ibp"] - want["ibp"]).max())
    mse_rel = float(np.abs(got["mse_history"] / want["mse_history"]
                           - 1.0).max())
    u8 = {k: _u8_diff(got[k], want[k]) for k in ("native", "saa", "ibp")}
    check(hr_err <= SHARDED_ATOL,
          f"{what}: max|HR - unsharded| {hr_err} > {SHARDED_ATOL}")
    check(mse_rel <= SHARDED_RTOL,
          f"{what}: MSE history rel. diff {mse_rel} > {SHARDED_RTOL}")
    check(max(u8.values()) <= 1, f"{what}: artifacts vs unsharded {u8} > 1")
    return {"max_abs_hr_vs_unsharded": hr_err,
            "mse_history_max_rel_diff": mse_rel, "u8_max_diff": u8}


def phase_sharded(torch, mono, conv, model):
    """The spatially-sharded solve (``parallel/``) at full size, as 4 tiles
    on the one card, against the unsharded solves; ``tiled_infer_sharded``
    against ``tiled_infer``; ``sr.run --sp 2 --device cuda``."""
    import contextlib
    import io

    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.models.infer import (
        receptive_field_radius, tiled_infer, tiled_infer_sharded)
    from enph459_super_resolution_tpu_torch.parallel import (make_mesh,
                                                             solve_sharded)
    from enph459_super_resolution_tpu_torch.sr import run
    from enph459_super_resolution_tpu_torch.sr.classical import solve

    t_phase = time.perf_counter()
    frames, psf, shifts = mono["frames"], mono["psf"], mono["shifts"]
    n_iter = mono["cfg"].ibp_iterations
    card = torch.device("cuda", 0)
    adjoint_iters = max(1, round(n_iter / 4))
    runs = {"sp4": ({"sp": 4}, "ibp", n_iter, 0.5),
            "2x2": ({"sp": 2, "spw": 2}, "ibp", n_iter, 0.5),
            "sp4_adjoint": ({"sp": 4}, "adjoint", adjoint_iters, 2.0)}
    row = {"phase": "sharded", "card": nvidia_smi("name,power.limit"),
           "tiles_on_one_card": 4,
           "conv_solve_s": conv["solve_s"],
           "conv_solve_s_runs": conv["solve_s_runs"]}
    adjoint = solve(frames, psf, shifts, n_iter=adjoint_iters, step=2.0,
                    device="cuda", solver="adjoint")
    for name, (axes, solver, iters, step) in runs.items():
        mesh = make_mesh(axes, devices=[card] * 4)

        def sharded():
            return solve_sharded(frames, psf, shifts, mesh, n_iter=iters,
                                 step=step, sp_axis=tuple(axes),
                                 solver=solver)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        check(all(v == 0 for v in launches.values()),
              f"sharded {name} launched hand-written kernels: {launches}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded()
            times.append(time.perf_counter() - t0)
        want = adjoint if solver == "adjoint" else conv["result"]
        row[name] = dict(
            _sharded_vs(got, want, f"sharded {name}"),
            mesh=axes, solver=solver, iterations=iters, step=step,
            against="banded adjoint solve" if solver == "adjoint"
            else "conv engine solve",
            first_solve_s=first_s, solve_s_runs=times,
            solve_s=sorted(times)[1],
            hr_mpix_per_s=HR_MPIX / sorted(times)[1])
    # the eager per-tile loop's device launches and idle share, over a
    # solve of PROFILED_ITERS iterations (the profiler's own processing of
    # a full solve's ~60 k launches takes longer than the solve)
    mesh = make_mesh({"sp": 4}, devices=[card] * 4)
    busy_s, profiled_s = phase_profile(
        torch, lambda: solve_sharded(frames, psf, shifts, mesh,
                                     n_iter=PROFILED_ITERS, sp_axis=("sp",)),
        f"one warm sharded solve of {PROFILED_ITERS} IBP iterations, sp=4 "
        "on one card")
    row.update(profiled_iterations=PROFILED_ITERS,
               profiled_solve_s=profiled_s, device_busy_s=busy_s,
               device_idle_share=1.0 - busy_s / profiled_s)

    # tiled_infer_sharded of one 4K frame on the EDSR-16 module, 4 tiles
    lr = np.random.default_rng(SEED + 7).uniform(
        0, 255, (540, 960, 3)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tiled_infer_sharded(model, lr, mesh)
    infer_s = time.perf_counter() - t0
    want = tiled_infer(model, lr)
    check(got.shape == want.shape == (2160, 3840, 3),
          f"tiled_infer_sharded {got.shape}")
    b = receptive_field_radius(model) * 4
    err = float(np.abs(got[b:-b] - want[b:-b]).max())
    check(err <= 5e-3, f"tiled_infer_sharded interior vs tiled_infer: "
                       f"{err} > 5e-3")
    row["tiled_infer_sharded"] = {"lr": [540, 960, 3], "tiles": 4,
                                  "edge_rows_left_out": b,
                                  "max_abs_interior_vs_tiled": err,
                                  "infer_s": infer_s}

    # sr.run --sp 2 on cuda: the first 2 cards, never the CPU
    out = WORK / "mono" / "results_sp2"
    err_text = io.StringIO()
    n_cards = torch.cuda.device_count()
    try:
        with contextlib.redirect_stderr(err_text):
            _, launches = _sr_run("mono_cal_target", mono["data"], out,
                                  "--sp", "2")
        rc = 0
    except SystemExit as exc:
        rc = exc.code
    said = err_text.getvalue().strip().splitlines()
    if n_cards < 2:
        check(rc != 0 and f"needs 2 devices, have {n_cards}" in
              err_text.getvalue(),
              f"sr.run --sp 2 on {n_cards} card(s): exit {rc}, {said[-1:]}")
        check(not (out / "session0" / "done.flag").exists(),
              "sr.run --sp 2 wrote a result without the cards")
        row["sr_run_sp2"] = {"cards": n_cards, "exit": rc,
                             "error": said[-1]}
    else:
        ibp = load_gray(str(out / "session0" / "SAA_IBP.png"))
        diff = _u8_diff(ibp, mono["f32"]["ibp"])
        check(diff <= 1, f"sr.run --sp 2 SAA_IBP vs --sp 1: {diff} > 1")
        row["sr_run_sp2"] = {"cards": n_cards, "exit": rc,
                             "ibp_vs_sp1_max_diff": diff,
                             "launches": launches}
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return row


def phase_multicard(torch, mono, conv, model):
    """On a host of 4 or more cards: the sharded solves, ``sr.run --sp`` and
    ``tiled_infer_sharded`` with one tile on each of the first 4 cards
    (halos cross between cards), against the unsharded solves."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.models.infer import (
        receptive_field_radius, tiled_infer, tiled_infer_sharded)
    from enph459_super_resolution_tpu_torch.parallel import (make_mesh,
                                                             solve_sharded)
    from enph459_super_resolution_tpu_torch.sr.classical import solve

    cards = [torch.device("cuda", i) for i in range(4)]
    frames, psf, shifts = mono["frames"], mono["psf"], mono["shifts"]
    n_iter = mono["cfg"].ibp_iterations
    adjoint_iters = max(1, round(n_iter / 4))
    row = {"phase": "multicard", "cards": torch.cuda.device_count(),
           "card": nvidia_smi("name,power.limit")}
    adjoint = solve(frames, psf, shifts, n_iter=adjoint_iters, step=2.0,
                    device="cuda", solver="adjoint")
    for name, axes, solver, iters, step in (
            ("sp4", {"sp": 4}, "ibp", n_iter, 0.5),
            ("2x2", {"sp": 2, "spw": 2}, "ibp", n_iter, 0.5),
            ("sp4_adjoint", {"sp": 4}, "adjoint", adjoint_iters, 2.0)):
        mesh = make_mesh(axes, devices=cards)

        def sharded():
            return solve_sharded(frames, psf, shifts, mesh, n_iter=iters,
                                 step=step, sp_axis=tuple(axes),
                                 solver=solver)

        reset_counts()
        got = sharded()
        launches = read_counts()
        check(all(v == 0 for v in launches.values()),
              f"4 cards {name} launched hand-written kernels: {launches}")
        times = []
        for _ in range(3):
            for c in cards:
                torch.cuda.synchronize(c)
            t0 = time.perf_counter()
            sharded()  # ends in a copy to the host that waits for every card
            times.append(time.perf_counter() - t0)
        want = adjoint if solver == "adjoint" else conv["result"]
        row[name] = dict(_sharded_vs(got, want, f"4 cards {name}"),
                         solve_s_runs=times, solve_s=sorted(times)[1])
    mesh = make_mesh({"sp": 4}, devices=cards)
    busy_s, profiled_s = phase_profile(
        torch, lambda: solve_sharded(frames, psf, shifts, mesh,
                                     n_iter=PROFILED_ITERS, sp_axis=("sp",)),
        f"one warm sharded solve of {PROFILED_ITERS} IBP iterations, sp=4 "
        "on 4 cards (busy: all cards)")
    row.update(profiled_iterations=PROFILED_ITERS,
               profiled_solve_s=profiled_s, device_busy_s_all_cards=busy_s)

    lr = np.random.default_rng(SEED + 7).uniform(
        0, 255, (540, 960, 3)).astype(np.float32)
    tiled_infer_sharded(model, lr, mesh)  # warm: a replica on each card
    t0 = time.perf_counter()
    got = tiled_infer_sharded(model, lr, mesh)
    infer_s = time.perf_counter() - t0
    want = tiled_infer(model, lr)
    b = receptive_field_radius(model) * 4
    err = float(np.abs(got[b:-b] - want[b:-b]).max())
    check(err <= 5e-3, f"tiled_infer_sharded on 4 cards: {err} > 5e-3")
    row["tiled_infer_sharded"] = {"max_abs_interior_vs_tiled": err,
                                  "infer_s": infer_s}

    for sp in ("4", "2x2"):
        out = WORK / "mono" / f"results_sp{sp}"
        run_s, launches = _sr_run("mono_cal_target", mono["data"], out,
                                  "--sp", sp)
        ibp = load_gray(str(out / "session0" / "SAA_IBP.png"))
        diff = _u8_diff(ibp, mono["f32"]["ibp"])
        check(diff <= 1, f"sr.run --sp {sp} on 4 cards vs --sp 1: {diff}")
        row[f"sr_run_sp{sp}"] = {"ibp_vs_sp1_max_diff": diff,
                                 "sr_run_s": run_s, "launches": launches}
    emit(row)
    return row


def phase_prewarm_watch(torch, mono):
    """``sr.prewarm`` in a subprocess fills a fresh op cache that ``sr.run``
    then reads with the process's operator trees dropped and the host build
    forbidden; ``sr.run --watch`` serves the session once over two
    polls."""
    import contextlib
    import io
    import os
    import tempfile

    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.sr import classical

    tmp = WORK / "prewarm_tmp"
    tmp.mkdir(parents=True)
    env = dict(os.environ, TMPDIR=str(tmp),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "enph459_super_resolution_tpu_torch.sr.prewarm",
         "--workloads", "mono_cal_target", "--reps", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    prewarm_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"sr.prewarm exited {proc.returncode}: {proc.stderr[-2000:]}")
    saved = tempfile.tempdir
    tempfile.tempdir = str(tmp)
    try:
        cache = Path(classical.op_cache_dir())
        pickles = sorted(f.name for f in cache.glob("*.pkl"))
        check(len(pickles) == 1, f"prewarm cache holds {pickles}")
        classical._device_matrices.cache_clear()
        host_build = classical._host_solve_matrices

        def forbidden(*a, **k):
            raise RuntimeError("check failed: the host build ran despite "
                               "the prewarmed disk cache")

        classical._host_solve_matrices = forbidden
        warm = WORK / "mono" / "results_prewarmed"
        try:
            run_s, launches = _sr_run("mono_cal_target", mono["data"], warm)
        finally:
            classical._host_solve_matrices = host_build
        check(launches == mono["launches"],
              f"prewarmed sr.run launches {launches}")
        diff = _u8_diff(load_gray(str(warm / "session0" / "SAA_IBP.png")),
                        mono["f32"]["ibp"])
        check(diff <= 1, f"sr.run from the prewarmed cache differs by {diff}")
    finally:
        tempfile.tempdir = saved

    out = WORK / "mono" / "results_watch"
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        watch_s, launches = _sr_run("mono_cal_target", mono["data"], out,
                                    "--watch", "0.1", "--watch-polls", "2")
    text = said.getvalue()
    check("watch done: 1 unit(s) processed over 2 poll(s)" in text,
          f"watch: {text[-500:]}")
    check(launches == mono["launches"],
          f"watch launches {launches}, one solve's are {mono['launches']}")
    _check_unit(out / "session0", mono["cfg"].lr_mean_name)
    row = {"phase": "prewarm_watch", "prewarm_s": prewarm_s,
           "prewarm_out": proc.stdout.strip().splitlines()[-3:],
           "cache_files": pickles, "prewarmed_sr_run_s": run_s,
           "prewarmed_ibp_vs_f32_max_diff": diff,
           "watch_s": watch_s, "watch_launches": launches}
    emit(row)
    return row


BURST_LR = (1536, 2048)     # the rig's frame; HR 3072 x 4096
BURST_REFINE = 10
BURST_STEPS, BURST_CKPT, BURST_HR_STEPS = 200, 100, 20
BURST_STEP_RTOL = 1e-4     # a train step, cuda against cpu: metrics
BURST_STEP_LR_SHARE = 0.01  # ... and parameters, in units of the rate


def _ms(torch, fn):
    """Median milliseconds of three calls of ``fn`` (:func:`_serve`), and
    the last call's result."""
    out, times = _serve(torch, lambda _: fn(), range(3))
    return sorted(times)[1] * 1e3, out


def _finite(obj) -> bool:
    return all(np.isfinite(v) for v in obj.values()
               if isinstance(v, (int, float)))


def _burst_train(torch, work: Path):
    """train_burst at full width on cuda (LR arch 64 x 8, then HR arch
    48 x 6), the run directory, resume from step 100, and one train step on
    cuda against the same step on cpu."""
    from enph459_super_resolution_tpu_torch.sr.classical import \
        make_gaussian_psf
    from enph459_super_resolution_tpu_torch.train import burst as TB
    from enph459_super_resolution_tpu_torch.train import state as TS
    from enph459_super_resolution_tpu_torch.train.data import \
        synthetic_scene_pool

    run = work / "run_lr"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = TB.train_burst(arch="lr", n_feats=64, n_resblocks=8, batch=16,
                           lr_patch=24, pool_images=64, steps=BURST_STEPS,
                           ckpt_every=BURST_CKPT, eval_every=BURST_STEPS,
                           out_dir=str(run), device="cuda")
    train_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for f in ("config.json", "metrics.jsonl", "eval.jsonl",
              "final_eval.json", f"ckpt/{BURST_CKPT}/state.pt",
              f"ckpt/{BURST_STEPS}/state.pt"):
        check((run / f).exists(), f"burst run: missing {f}")
    recs = [json.loads(ln) for ln in
            (run / "metrics.jsonl").read_text().splitlines()]
    logged = sorted({1, BURST_STEPS} | set(range(50, BURST_STEPS, 50)))
    check([r["step"] for r in recs] == logged,
          f"burst metrics.jsonl steps {[r['step'] for r in recs]}")
    check(all(_finite(r) for r in recs) and _finite(final),
          "burst training: a non-finite number")
    check(final["psnr_ibp"] > final["psnr_bicubic"],
          f"psnr_ibp {final['psnr_ibp']} <= psnr_bicubic "
          f"{final['psnr_bicubic']}")
    w = {r["step"]: r["wall_s"] for r in recs}
    steps_per_s = (BURST_STEPS - logged[1]) / (w[BURST_STEPS] - w[logged[1]])

    # resume: the step-100 checkpoint into a fresh state, bit for bit
    ck = TS.load_checkpoint(str(run / "ckpt"), BURST_CKPT)
    cfg = TS.TrainConfig(learning_rate=1e-4, lr_halve_every=BURST_STEPS // 2)

    def state_on(device, ckpt):
        model = TB._build_model("burstfusion_lr", 4, 2, 64, 8, device)
        st = TS.TrainState.create(model, cfg)
        st.load_state_dict(ckpt)
        return st

    back = state_on("cuda", ck).state_dict()
    exact = all(torch.equal(back[part][k].cpu(), ck[part][k])
                for part in ("params", "ema_params") for k in ck[part])
    for key, v in ck["opt_state"]["state"].items():
        exact &= all(torch.equal(v[k].cpu(),
                                 back["opt_state"]["state"][key][k].cpu())
                     for k in v)
    check(exact and back["step"] == BURST_CKPT,
          "resume from the step-100 checkpoint not exact")

    # one step from the step-100 state on one batch, cuda against cpu
    psf = make_gaussian_psf()
    gen = TB.BurstGen(TB.NOMINAL_SHIFTS_4, 2, psf, 2.0, 0.05,
                      model_name="burstfusion_lr")
    pool = torch.as_tensor(np.stack([p[..., 0] for p in synthetic_scene_pool(
        n_images=4, size=192, channels=1, seed=SEED)]))
    g = TB.generator("cpu", SEED, 100)
    stack, tgt = gen(TB._crop_hr_batch(pool, g, 72, 16), g)
    step = TS.make_train_step(cfg)
    got = {}
    for dev in ("cuda", "cpu"):
        st = state_on(dev, TS.load_checkpoint(str(run / "ckpt"),
                                              BURST_CKPT))
        m = step(st, stack.to(dev), tgt.to(dev))
        got[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in st.params.items()})
    metric_rel = max(abs(got["cuda"][0][k] - got["cpu"][0][k])
                     / abs(got["cpu"][0][k]) for k in got["cpu"][0])
    param_dev = max(float((got["cuda"][1][k] - got["cpu"][1][k]).abs().max())
                    for k in got["cpu"][1]) / cfg.learning_rate
    check(metric_rel <= BURST_STEP_RTOL,
          f"train step cuda vs cpu: metrics differ by {metric_rel}")
    check(param_dev <= BURST_STEP_LR_SHARE,
          f"train step cuda vs cpu: parameters differ by {param_dev} lr")

    t0 = time.perf_counter()
    final_hr = TB.train_burst(arch="hr", n_feats=48, n_resblocks=6,
                              batch=16, lr_patch=24, pool_images=64,
                              steps=BURST_HR_STEPS,
                              ckpt_every=BURST_HR_STEPS,
                              eval_every=BURST_HR_STEPS,
                              out_dir=str(work / "run_hr"), device="cuda")
    hr_s = time.perf_counter() - t0
    recs_hr = [json.loads(ln) for ln in
               (work / "run_hr" / "metrics.jsonl").read_text().splitlines()]
    check(all(_finite(r) for r in recs_hr) and _finite(final_hr),
          "hr arch training: a non-finite number")
    row = {"train_lr": {
        "arch": "lr", "n_feats": 64, "n_resblocks": 8, "batch": 16,
        "lr_patch": 24, "steps": BURST_STEPS, "train_s": train_s,
        "steps_per_s": steps_per_s, "bursts_per_s": 16 * steps_per_s,
        "losses": {r["step"]: r["loss"] for r in recs},
        "psnr": {k: final[k] for k in final if k.startswith("psnr")},
        "peak_mem_mb": peak_mb, "resume_exact": exact,
        "step_cuda_vs_cpu_metric_rel": metric_rel,
        "step_cuda_vs_cpu_param_dev_lr": param_dev},
        "train_hr": {"arch": "hr", "n_feats": 48, "n_resblocks": 6,
                     "steps": BURST_HR_STEPS, "train_s": hr_s,
                     "losses": {r["step"]: r["loss"] for r in recs_hr},
                     "psnr": {k: final_hr[k] for k in final_hr
                              if k.startswith("psnr")}}}
    return run, row


def phase_burst(torch):
    """The learned burst engine: trained on the card at full width, then
    served at the rig's frame size through ``sr.run --fusion-run``."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray, save_png
    from enph459_super_resolution_tpu_torch.sr import fusion as TF
    from enph459_super_resolution_tpu_torch.sr.classical import (
        landweber_refine, make_gaussian_psf)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    work = WORK / "burst"
    run, row = _burst_train(torch, work)

    # serve: a mono_barcodes session of 4 corners x 1 rep at full size
    cfg = WORKLOADS["mono_barcodes"]
    rng = np.random.default_rng(SEED + 7)
    sdir = work / "data" / "session0"
    scene = _smooth_scene(rng, BURST_LR)
    for ci in range(4):
        save_png(_noisy_u8(rng, scene), str(sdir / f"corner{ci}_rep00.png"))
    out = work / "results"
    sr_run_s, launches = _sr_run("mono_barcodes", sdir.parent, out,
                                 "--fusion-run", str(run),
                                 "--fusion-refine", str(BURST_REFINE))
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    solve = expected_launches("f32", False, _rank(psf), 4,
                              cfg.ibp_iterations)
    expected = dict(solve)
    # the refine: per iteration a forward and a back-projection row apply
    # per frame and PSF rank term, then one forward of each for the fit
    expected["k1_f32"] += (2 * BURST_REFINE + 1) * 4 * _rank(psf)
    check(launches == expected,
          f"sr.run --fusion-run launches {launches}, the code implies "
          f"{expected}")
    refine_launches = launches["k1_f32"] - solve["k1_f32"]
    unit = out / "session0" / "rep0"
    metrics = _check_unit(unit, cfg.lr_mean_name)
    check((unit / "fusion.png").exists(), "missing fusion.png")
    fusion_png = load_gray(str(unit / "fusion.png"))
    check(fusion_png.shape == tuple(2 * v for v in BURST_LR),
          f"fusion {fusion_png.shape}")
    check(metrics["fusion_forward_mse"] < metrics["fusion_forward_mse_raw"],
          f"the refine did not improve the fit: {metrics}")

    # in process: the same unit through the engine, against plain rows
    unit_data = cfg.load(str(sdir))[0]
    lr = torch.as_tensor(unit_data.frames, device="cuda")
    shifts = unit_data.shifts
    eng = TF.FusionEngine(str(run), refine=BURST_REFINE, device="cuda")
    sr, mse, mse_raw = eng(lr, shifts, psf)
    check(_u8_diff(sr, fusion_png) <= 1, "in-process engine vs sr.run")
    seed, raw_mse, _ = TF.FusionEngine(str(run), device="cuda")(lr, shifts,
                                                                 psf)
    check(np.isclose(raw_mse, mse_raw, rtol=1e-5),
          f"raw fit {raw_mse} != {mse_raw}")
    plain, _, plain_mse = landweber_refine(seed, lr, psf, shifts,
                                           n_iter=BURST_REFINE,
                                           device="cuda", plain=True)
    refine_vs_plain = float(np.abs(sr - plain).max())
    check(refine_vs_plain <= KERNEL_ATOL,
          f"refine kernels vs plain rows {refine_vs_plain}")

    # the banded registration (K1 on 5-tap bands) against the conv one
    stack = eng.register_stack(lr, shifts)
    ops = TF.build_register_phase_ops(shifts, *BURST_LR, 2, device="cuda")
    reset_counts()
    banded = TF.register_burst_phases_banded(lr, ops)
    reg_launches = read_counts()["k1_f32"]
    check(reg_launches == 4 * 2, f"banded registration {reg_launches} K1")
    reg_vs_conv = float((banded - stack).abs().max())
    reg_vs_plain = float((banded - TF.register_burst_phases_banded(
        lr, ops, plain=True)).abs().max())
    check(reg_vs_conv <= KERNEL_ATOL and reg_vs_plain <= KERNEL_ATOL,
          f"banded registration vs conv {reg_vs_conv}, plain {reg_vs_plain}")

    # bf16 trunk against the f32 engine, within 0.05 of the residual span
    sr32, _, _ = TF.FusionEngine(str(run), device="cuda")(lr, shifts, psf)
    eng16 = TF.FusionEngine(str(run), refine=BURST_REFINE, dtype="bf16",
                            device="cuda")
    sr16, _, _ = TF.FusionEngine(str(run), dtype="bf16", device="cuda")(
        lr, shifts, psf)
    base = eng.model.shift_and_add(stack[None])[0, ..., 0].cpu().numpy()
    span = float(np.abs(sr32 - base).max())
    bf16_err = float(np.abs(sr16 - sr32).max())
    check(bf16_err <= EDSR_BF16_SHARE * span,
          f"bf16 engine {bf16_err} > {EDSR_BF16_SHARE} x span {span}")

    # the vjp refine: 2 iterations improve the fit
    _, vjp_mse, vjp_raw = TF.FusionEngine(
        str(run), refine=2, refine_engine="vjp", device="cuda")(lr, shifts,
                                                                psf)
    check(vjp_mse < vjp_raw, f"vjp refine {vjp_raw} -> {vjp_mse}")

    # the whole engine at 4 x 128 x 160, cuda against cpu
    small = lr[:, :128, :160]
    got_c = TF.FusionEngine(str(run), refine=BURST_REFINE, device="cuda")(
        small, shifts, psf)
    got_h = TF.FusionEngine(str(run), refine=BURST_REFINE, device="cpu")(
        small.cpu(), shifts, psf)
    cpu_diff = _u8_diff(got_c[0], got_h[0])
    check(cpu_diff <= 1, f"engine cuda vs cpu at 128x160: {cpu_diff}")

    # warm time split of a unit, f32 and bf16
    split = {}
    for name, e in (("f32", eng), ("bf16", eng16)):
        unit_ms, _ = _ms(torch, lambda: e(lr, shifts, psf))
        reg_ms, st = _ms(torch, lambda: e.register_stack(lr, shifts))
        trunk_ms, sr_t = _ms(torch, lambda: e.net(st))
        refine_ms, _ = _ms(torch, lambda: landweber_refine(
            sr_t, lr, psf, shifts, n_iter=BURST_REFINE, device="cuda"))
        split[name] = {"unit_s": unit_ms / 1e3, "register_ms": reg_ms,
                       "trunk_ms": trunk_ms,
                       "refine_ms_per_iter": refine_ms / BURST_REFINE}
    row.update(phase="burst", serve_lr=[4, *BURST_LR],
               hr=list(fusion_png.shape), sr_run_s=sr_run_s,
               sr_run_timings_s=metrics["timings_s"],
               fusion_forward_mse=metrics["fusion_forward_mse"],
               fusion_forward_mse_raw=metrics["fusion_forward_mse_raw"],
               sr_run_launches=launches, refine_launches=refine_launches,
               refine_vs_plain_max_abs=refine_vs_plain,
               refine_final_mse=mse, refine_final_mse_plain=plain_mse,
               banded_register_launches=reg_launches,
               banded_register_vs_conv=reg_vs_conv,
               bf16_vs_f32_max_abs=bf16_err, residual_span=span,
               vjp2_mse=[vjp_raw, vjp_mse],
               cuda_vs_cpu_u8_diff_128x160=cpu_diff, warm=split)
    emit(row)
    return row


TRAIN_STEPS, TRAIN_RESUME, TRAIN_EVERY = 300, 200, 100
RRDB_STEPS = 20
RRDB_KW = {"nb": 23, "nf": 64, "gc": 32}
ADAM_STEP_BOUND = 10  # |Adam update| <= 10 x the rate, a loose bound


def _vgg19_pth(torch, path: Path) -> None:
    """A seeded random VGG19 in torchvision's state-dict layout (He-scaled
    convs, zero biases): the perceptual term's weights for the GAN runs."""
    from enph459_super_resolution_tpu_torch.train.vgg import (
        _TORCH_CONV_INDICES, VGG19_BLOCKS)

    g = torch.Generator().manual_seed(SEED + 9)
    widths = [w for _, n, w in VGG19_BLOCKS for _ in range(n)]
    sd, cin = {}, 3
    for idx, w in zip(_TORCH_CONV_INDICES, widths):
        sd[f"features.{idx}.weight"] = torch.randn(
            (w, cin, 3, 3), generator=g) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.zeros(w)
        cin = w
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)


def _records(path: Path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _steps_per_s(recs, a: int, b: int) -> float:
    w = {r["step"]: r["wall_s"] for r in recs}
    return (b - a) / (w[b] - w[a])


def _gan_step_cuda_vs_cpu(torch, vgg_path: Path) -> dict:
    """One GAN step at small width on cuda and on cpu, from the same
    parameters, batch and instance noise."""
    from enph459_super_resolution_tpu_torch.models import (
        RRDBNet, VGGStyleDiscriminator)
    from enph459_super_resolution_tpu_torch.train import losses as TL
    from enph459_super_resolution_tpu_torch.train import state as TS
    from enph459_super_resolution_tpu_torch.train import vgg as TV

    cfg = TS.TrainConfig(learning_rate=1e-4)
    rng = np.random.default_rng(SEED + 10)
    lr = torch.as_tensor(rng.uniform(0, 255, (2, 12, 12, 3)),
                         dtype=torch.float32)
    hr = torch.as_tensor(rng.uniform(0, 255, (2, 48, 48, 3)),
                         dtype=torch.float32)
    noise = [torch.randn(hr.shape, generator=torch.Generator().manual_seed(
        SEED + 11 + k)) for k in range(4)]
    got = {}
    for dev in ("cuda", "cpu"):
        g = RRDBNet(scale=4, nb=2, nf=16, gc=8, device=dev,
                    generator=torch.Generator().manual_seed(SEED))
        d = VGGStyleDiscriminator(nf=16, device=dev,
                                  generator=torch.Generator().manual_seed(1))
        st = TS.GANTrainState(TS.TrainState.create(g, cfg), d,
                              TS.make_optimizer(cfg, d.parameters()),
                              TS.GANBalance(gan_weight=0.1,
                                            instance_noise=2.0))
        feat = TV.make_vgg_feature_fn(TV.load_torch_vgg19(str(vgg_path)),
                                      device=dev)
        step = TS.make_gan_train_step(cfg, percep_loss=TL.PerceptualLoss(feat))
        m = step(st, lr.to(dev), hr.to(dev), [n.to(dev) for n in noise])
        got[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in st.g.params.items()},
                    {k: v.cpu() for k, v in st.g.ema_params.items()},
                    {k: v.detach().cpu() for k, v in d.named_parameters()})
    (mc, gc_, ec, dc), (mh, gh, eh, dh) = got["cuda"], got["cpu"]
    metric_rel = max(abs(mc[k] - mh[k]) / abs(mh[k]) for k in mh if mh[k])
    g_dev = max(float((gc_[k] - gh[k]).abs().max()) for k in gh)
    ema_dev = max(float((ec[k] - eh[k]).abs().max()) for k in eh)
    tol = BURST_STEP_LR_SHARE * cfg.learning_rate
    # D: RaGAN's shift invariance leaves Dense_0/Dense_1's biases (and a
    # few elements behind them) with rounding-noise gradients, which Adam
    # turns into steps of up to the rate in either direction; cuDNN's
    # summation order varies from run to run, so the count of such
    # elements does too: at most 1 in 10,000 of the rest may differ
    # by more than 0.01 of the rate, every element by at most 3 rates
    n_off = n_all = 0
    d_max = 0.0
    for k in dh:
        diff = (dc[k] - dh[k]).abs()
        d_max = max(d_max, float(diff.max()))
        if k not in ("Dense_0.bias", "Dense_1.bias"):
            n_off += int((diff > tol).sum())
            n_all += diff.numel()
    check(metric_rel <= BURST_STEP_RTOL,
          f"GAN step cuda vs cpu: metrics differ by {metric_rel}")
    check(max(g_dev, ema_dev) <= tol,
          f"GAN step cuda vs cpu: generator differs by "
          f"{max(g_dev, ema_dev) / cfg.learning_rate} of the rate")
    check(d_max <= 3 * cfg.learning_rate and n_off <= n_all * 1e-4,
          f"GAN step cuda vs cpu: D differs by {d_max} ({n_off} elements "
          f"beyond 0.01 of the rate)")
    return {"metric_rel": metric_rel,
            "g_param_dev_lr": g_dev / cfg.learning_rate,
            "g_ema_dev_lr": ema_dev / cfg.learning_rate,
            "d_param_max_dev_lr": d_max / cfg.learning_rate,
            "d_elements_beyond_0.01_lr": n_off, "d_elements": n_all}


def _serve_trained_edsr(torch, run: Path) -> dict:
    """The run's EMA EDSR through the fused trunk (K4) on its eval split,
    one image a request, f32 and bf16, against the module's forward."""
    from enph459_super_resolution_tpu_torch.models import EDSR
    from enph459_super_resolution_tpu_torch.models.fused import \
        make_edsr_fused_apply
    from enph459_super_resolution_tpu_torch.ops.resize import \
        bicubic_degrade
    from enph459_super_resolution_tpu_torch.train import evaluate as TE
    from enph459_super_resolution_tpu_torch.train.data import \
        synthetic_scene_pool

    weights, step = TE.load_run_weights(str(run), device="cuda")
    model = EDSR(scale=4, channels=3, device="cuda")
    model.load_state_dict(weights, strict=True)
    model.eval().requires_grad_(False)
    pool = synthetic_scene_pool(n_images=32, size=208, channels=3,
                                seed=0)[:4]  # the run's eval split
    inputs = [bicubic_degrade(torch.as_tensor(img, device="cuda")[None], 4)
              for img in pool]
    mean = torch.tensor([0.4488, 0.4371, 0.4040], device="cuda") * 255.0
    out = {"step": step, "requests": len(inputs),
           "lr": list(inputs[0].shape)}
    with torch.no_grad():
        wants = [model(x) for x in inputs]
    span = max((w - mean).abs().max().item() for w in wants)
    for dtype in (torch.float32, torch.bfloat16):
        key = "k4_bf16" if dtype == torch.bfloat16 else "k4_f32"
        fn = make_edsr_fused_apply(model, dtype=dtype)
        fn(inputs[0])  # warm-up
        reset_counts()
        times, err = [], 0.0
        for x, want in zip(inputs, wants):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(tuple(got.shape) == tuple(want.shape)
                  and bool(torch.isfinite(got).all()),
                  f"trained edsr {dtype}: output {tuple(got.shape)}")
            err = max(err, (got - want).abs().max().item())
        launches = read_counts()
        expected = dict.fromkeys(launches, 0)
        expected[key] = 32 * len(inputs)
        check(launches == expected, f"trained edsr {dtype}: launches "
                                    f"{launches}, expected {expected}")
        bound = (EDSR_F32_SHARE if dtype == torch.float32
                 else EDSR_BF16_SHARE) * span
        check(err <= bound, f"trained edsr {dtype}: max|fused - module| "
                            f"{err} > {bound}")
        out[key] = {"launches": launches[key], "max_abs_vs_module": err,
                    "bound": bound, "request_s": sorted(times)[len(times) // 2]}
    out["output_span"] = span
    return out


def phase_train(torch):
    """train.loop / train.evaluate at full width: EDSR-baseline x4 with a
    resume, its EMA weights served through K4, the ESRGAN pretrain and GAN
    fine-tune at RRDB-23 width, and one GAN step cuda against cpu."""
    from enph459_super_resolution_tpu_torch.models import EDSR
    from enph459_super_resolution_tpu_torch.train import evaluate as TE
    from enph459_super_resolution_tpu_torch.train import loop as TL
    from enph459_super_resolution_tpu_torch.train import state as TS
    from enph459_super_resolution_tpu_torch.train.data import (
        PatchConfig, make_patch_sampler, synthetic_scene_pool)

    work = WORK / "train"
    run = work / "edsr"
    kw = dict(model_name="edsr", scale=4, batch=16, lr_patch=48, loss="l1",
              channels=3, out_dir=str(run), eval_every=TRAIN_EVERY,
              ckpt_every=TRAIN_EVERY, device="cuda")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    TL.train(steps=TRAIN_RESUME, **kw)
    first_s = time.perf_counter() - t0
    saved = TS.load_checkpoint(str(run / "ckpt"), TRAIN_RESUME)
    t0 = time.perf_counter()
    final = TL.train(steps=TRAIN_STEPS, **kw)
    resume_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    train_launches = read_counts()
    check(not any(train_launches.values()),
          f"training launched hand-written kernels: {train_launches}")
    recs = _records(run / "metrics.jsonl")
    steps = [r["step"] for r in recs]
    check(steps == [1, 50, 100, 150, 200, 201, 250, 300],
          f"edsr metrics.jsonl steps {steps}")
    check(all(_finite(r) for r in recs) and _finite(final),
          "edsr training: a non-finite number")
    check(recs[-1]["loss"] < recs[0]["loss"],
          f"edsr loss {recs[0]['loss']} -> {recs[-1]['loss']}")
    check(TS.checkpoint_steps(str(run / "ckpt")) == [TRAIN_RESUME,
                                                     TRAIN_STEPS],
          "edsr checkpoints")

    # the step-200 checkpoint restores bit for bit
    cfg = TS.TrainConfig(learning_rate=1e-4, lr_halve_every=TRAIN_STEPS // 2)
    st = TS.TrainState.create(EDSR(scale=4, channels=3, device="cuda"), cfg)
    st.load_state_dict(saved)
    back = st.state_dict()
    exact = back["step"] == TRAIN_RESUME and all(
        torch.equal(back[part][k].cpu(), saved[part][k])
        for part in ("params", "ema_params") for k in saved[part])
    for key, v in saved["opt_state"]["state"].items():
        exact &= all(torch.equal(v[k], back["opt_state"]["state"][key][k]
                                 .cpu()) for k in v)
    check(exact, "resume from the step-200 checkpoint not exact")

    steps_per_s = _steps_per_s(recs, 201, TRAIN_STEPS)
    hr_mpix = 16 * (48 * 4) ** 2 / 1e6
    # one profiled step (the restored state, a fresh batch)
    pool = synthetic_scene_pool(n_images=32, size=208, channels=3, seed=0)
    sampler = make_patch_sampler(pool[4:], PatchConfig(), seed=0,
                                 device="cuda", start=TRAIN_STEPS)
    step_fn = TS.make_train_step(cfg)
    lr_b, hr_b = next(sampler)
    step_fn(st, lr_b, hr_b)  # warm-up
    torch.cuda.synchronize()
    busy_s, prof_s = phase_profile(
        torch, lambda: (step_fn(st, lr_b, hr_b), torch.cuda.synchronize()),
        "one EDSR-baseline x4 train step, batch 16 x 48x48 LR, f32")

    t0 = time.perf_counter()
    check(TE.main(["--run", str(run), "--tiled"]) == 0,
          "train.evaluate --tiled failed")
    eval_tiled_s = time.perf_counter() - t0
    serve = _serve_trained_edsr(torch, run)

    # ESRGAN: L1 pretrain, then the GAN fine-tune from it
    rkw = dict(model_name="rrdbnet", scale=4, batch=16, lr_patch=48,
               channels=3, model_kwargs=RRDB_KW, eval_every=RRDB_STEPS,
               ckpt_every=RRDB_STEPS, steps=RRDB_STEPS, device="cuda")
    pre, gan = work / "rrdb_pre", work / "rrdb_gan"
    vgg = work / "vgg19.pth"
    _vgg19_pth(torch, vgg)
    stages = {}
    for name, out, extra in (
            ("pretrain", pre, {}),
            ("gan", gan, dict(gan=True, init_from=str(pre),
                              vgg_weights=str(vgg), d_every=2,
                              instance_noise=2.0))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fin = TL.train(out_dir=str(out), **rkw, **extra)
        wall = time.perf_counter() - t0
        rr = _records(out / "metrics.jsonl")
        check([r["step"] for r in rr] == [1, RRDB_STEPS] and
              all(_finite(r) for r in rr) and _finite(fin),
              f"rrdbnet {name}: records {rr}, final {fin}")
        stages[name] = {
            "train_s": wall, "steps_per_s": _steps_per_s(rr, 1, RRDB_STEPS),
            "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "first": rr[0], "last": rr[-1], "final_eval": fin}
    ck_pre = TS.load_checkpoint(str(pre / "ckpt"))
    ck_gan = TS.load_checkpoint(str(gan / "ckpt"))
    d_updates = int(ck_gan["d_opt_state"]["state"][0]["step"])
    check(d_updates == RRDB_STEPS // 2, f"D took {d_updates} updates")
    # the generator's EMA continues the pretrain's: after n steps it is
    # d^n ema_pre + (1 - d^n) params_pre, give or take n Adam steps
    decay, n = TS.TrainConfig().ema_decay, RRDB_STEPS
    ema_dev = max(float((ck_gan["g"]["ema_params"][k]
                         - decay ** n * ck_pre["ema_params"][k]
                         - (1 - decay ** n) * ck_pre["params"][k])
                        .abs().max()) for k in ck_pre["params"])
    ema_bound = (1 - decay ** n) * n * ADAM_STEP_BOUND * 1e-4
    check(ema_dev <= ema_bound,
          f"GAN EMA {ema_dev} from the pretrain's continuation > "
          f"{ema_bound}")
    t0 = time.perf_counter()
    check(TE.main(["--run", str(pre), "--interp-run", str(gan),
                   "--alpha", "0.8"]) == 0, "train.evaluate --interp-run")
    interp_s = time.perf_counter() - t0

    step_cmp = _gan_step_cuda_vs_cpu(torch, vgg)
    row = {"phase": "train",
           "edsr": {"n_resblocks": 16, "n_feats": 64, "batch": 16,
                    "lr_patch": 48, "steps": TRAIN_STEPS,
                    "resumed_at": TRAIN_RESUME, "first_call_s": first_s,
                    "resume_call_s": resume_s, "steps_per_s": steps_per_s,
                    "hr_mpix_per_s": steps_per_s * hr_mpix,
                    "peak_mem_mb": peak_mb, "resume_exact": exact,
                    "losses": {r["step"]: r["loss"] for r in recs},
                    "final_eval": final, "profiled_step_s": prof_s,
                    "device_busy_s": busy_s,
                    "device_idle_share": 1.0 - busy_s / prof_s,
                    "evaluate_tiled_s": eval_tiled_s},
           "serve_trained": serve,
           "rrdb": {**RRDB_KW, "batch": 16, "lr_patch": 48,
                    "steps": RRDB_STEPS, **stages, "d_updates": d_updates,
                    "gan_ema_dev": ema_dev, "gan_ema_bound": ema_bound,
                    "evaluate_interp_s": interp_s},
           "gan_step_cuda_vs_cpu": step_cmp}
    emit(row)
    return row


MESH_STEPS = 20
# the reference's bars: dp/sp/tp/pp loss trajectories against one device
# (tests/test_multidevice_cli.py), the edsr_moe ep run against the dense
# one (tests/test_moe_parallel.py: losses, and the final eval's PSNR)
MESH_RTOL = 2e-4
MOE_RTOL, MOE_ATOL, MOE_PSNR_ATOL = 1e-4, 1e-5, 1e-3
MOE_KW = {"n_resblocks": 8, "n_feats": 64, "n_experts": 4}
SCAN_KW = {"scan_trunk": True}
# name: (model, kwargs, mesh, its single-device run, gan steps or 0)
MESH_RUNS = {
    "edsr_single": ("edsr", {}, None, None, 0),
    "edsr_dp2_tp2": ("edsr", {}, "dp=2,tp=2", "edsr_single", 0),
    "edsr_dp2_sp2_tp2": ("edsr", {}, "dp=2,sp=2,tp=2", "edsr_single", 0),
    "edsr_scan_single": ("edsr", SCAN_KW, None, None, 0),
    "edsr_dp2_pp4": ("edsr", SCAN_KW, "dp=2,pp=4", "edsr_scan_single", 0),
    "gan_single": ("edsr", {}, None, None, 2),
    "gan_dp2_tp2": ("edsr", {}, "dp=2,tp=2", "gan_single", 2),
    "moe_dense": ("edsr_moe", MOE_KW, None, None, 0),
    "moe_dense_again": ("edsr_moe", MOE_KW, None, "moe_dense", 0),
    "moe_dp2_ep4": ("edsr_moe", MOE_KW, "dp=2,ep=4", "moe_dense", 0),
}
MOE_F64_RTOL = 1e-9  # one float64 step, dense against dp=2,ep=4


def _mesh_step(torch, model_name, kwargs, mesh_spec, gan, devices, batch):
    """One warm train step of a run's configuration, built from the parts
    ``train.loop.train`` puts together, ready for the profiler."""
    from enph459_super_resolution_tpu_torch.models import (
        VGGStyleDiscriminator, create_model)
    from enph459_super_resolution_tpu_torch.parallel import (
        make_pipelined_edsr_apply, shard_train_step)
    from enph459_super_resolution_tpu_torch.train import loop as TL
    from enph459_super_resolution_tpu_torch.train import state as TS
    from enph459_super_resolution_tpu_torch.train.losses import \
        PerceptualLoss

    mesh, axes = TL.train_mesh(mesh_spec, False, "cuda", devices)

    gen = torch.Generator().manual_seed(SEED)
    model = create_model(model_name, scale=4, channels=3, device="cuda",
                         generator=gen, **kwargs)
    cfg = TS.TrainConfig(learning_rate=1e-4,
                         lr_halve_every=MESH_STEPS // 2)
    forward = None
    if mesh is not None:
        TL.place_params(model, mesh, axes)
        if axes.get("pp", 1) > 1:
            forward = make_pipelined_edsr_apply(model, mesh, dp_axis="dp")
    state = TS.TrainState.create(model, cfg)
    if gan:
        disc = VGGStyleDiscriminator(nf=32, device="cuda", generator=gen)
        if mesh is not None:
            TL.place_params(disc, mesh, axes)
        state = TS.GANTrainState(state, disc,
                                 TS.make_optimizer(cfg, disc.parameters()),
                                 TS.GANBalance())
        step = TS.make_gan_train_step(cfg, percep_loss=PerceptualLoss(),
                                      noise_seed=SEED + 2)
    else:
        step = TS.make_train_step(cfg, forward=forward)
    if mesh is not None:
        step = shard_train_step(step, mesh,
                                sp_axis="sp" if "sp" in axes else None)
    lr, hr = batch
    step(state, lr, hr)
    torch.cuda.synchronize()
    return lambda: (step(state, lr, hr), torch.cuda.synchronize())


def _mesh_run(torch, work, name, batch, devices=None, base=None,
              run=None):
    """One ``train.loop.train`` run of ``run`` (default ``MESH_RUNS[name]``)
    at full width: its records, steps/s, peak memory, a profiled step, and
    its loss trajectory against ``base`` (its single-device run's)."""
    import contextlib
    import io

    from enph459_super_resolution_tpu_torch.train import loop as TL

    model_name, kwargs, mesh_spec, base_name, gan = run or MESH_RUNS[name]
    steps = gan or MESH_STEPS
    n = 1
    for part in (mesh_spec or "").split(","):
        if part:
            n *= int(part.split("=")[1])
    if devices is None:
        devices = [torch.device("cuda", 0)] * n
    out = work / name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # a line a step
        final = TL.train(model_name=model_name, scale=4, steps=steps,
                         batch=16, lr_patch=48, loss="l1", channels=3,
                         out_dir=str(out), eval_every=steps,
                         ckpt_every=steps, dp=False, gan=bool(gan),
                         resume=False, model_kwargs=dict(kwargs),
                         mesh_spec=mesh_spec, device="cuda",
                         devices=devices)
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    recs = _records(out / "metrics.jsonl")
    key = "g_loss" if gan else "loss"
    check([r["step"] for r in recs] == list(range(1, steps + 1))
          and all(_finite(r) for r in recs) and _finite(final),
          f"mesh_train {name}: records {recs[-1:]}, final {final}")
    row = {"phase": "mesh_train", "run": name, "model": model_name,
           "model_kwargs": kwargs, "mesh": mesh_spec,
           "devices": [str(d) for d in devices], "batch": 16,
           "lr_patch": 48, "steps": steps, "gan": bool(gan),
           "train_call_s": wall,
           "steps_per_s": _steps_per_s(recs, 1 if gan else 2, steps),
           "peak_mem_mb": peak_mb, key: [r[key] for r in recs],
           "final_eval_psnr": final["psnr"]}
    busy_s, prof_s = phase_profile(
        torch, _mesh_step(torch, model_name, kwargs, mesh_spec, gan,
                          devices, batch),
        f"one {name} train step")
    row.update(profiled_step_s=prof_s, device_busy_s=busy_s,
               device_idle_share=1.0 - busy_s / prof_s)
    if base is not None:
        rel = max(abs(a[key] - b[key]) / abs(b[key])
                  for a, b in zip(recs, base["records"]))
        row[f"{key}_max_rel_vs_single"] = rel
        if model_name == "edsr_moe":
            # recorded, not raised: EDSRMoE's float32 gradient on the card
            # lies far from its float64 value (_moe_f64_step measures how
            # far), so two float32 runs part within steps, a dense one
            # against itself too (moe_dense_again; ROADMAP Queue 3); the
            # ep blend's math is held in float64 (_moe_f64_step)
            held = all(abs(a[key] - b[key]) <= MOE_ATOL + MOE_RTOL * abs(
                b[key]) for a, b in zip(recs, base["records"]))
            psnr_d = abs(final["psnr"] - base["final"]["psnr"])
            row.update(final_psnr_abs_vs_single=psnr_d,
                       first_loss_rel_vs_single=abs(
                           recs[0][key] - base["records"][0][key])
                       / abs(base["records"][0][key]),
                       bar=f"rtol {MOE_RTOL}, atol {MOE_ATOL}; PSNR atol "
                           f"{MOE_PSNR_ATOL}",
                       bar_held=held and psnr_d <= MOE_PSNR_ATOL)
            check(row["first_loss_rel_vs_single"] <= MOE_RTOL,
                  f"mesh_train {name}: first loss {recs[0][key]} against "
                  f"{base['records'][0][key]}")
        else:
            check(rel <= MESH_RTOL, f"mesh_train {name}: {key} trajectory "
                                    f"{rel} > rtol {MESH_RTOL}")
    emit(row)
    return {"records": recs, "final": final, "row": row}


def _moe_f64_step(torch, batch) -> dict:
    """One EDSRMoE x4 train step at full width in float64 on the card,
    dense and over dp=2,ep=4 (the card repeated): the ep blend's math,
    free of float32's rounding; and how far the dense float32 gradient
    lies from the float64 one."""
    from enph459_super_resolution_tpu_torch.models import create_model
    from enph459_super_resolution_tpu_torch.parallel import (
        make_mesh, shard_params_ep_named, shard_train_step)
    from enph459_super_resolution_tpu_torch.train import state as TS
    from enph459_super_resolution_tpu_torch.train.losses import l1_loss

    lr, hr = (t.double() for t in batch)
    out = {}
    for name in ("dense", "dp2_ep4"):
        model = create_model(
            "edsr_moe", scale=4, channels=3, device="cuda",
            generator=torch.Generator().manual_seed(SEED), **MOE_KW).double()
        cfg = TS.TrainConfig(learning_rate=1e-4)
        step = TS.make_train_step(cfg)
        if name != "dense":
            mesh = make_mesh({"dp": 2, "ep": 4},
                             devices=[torch.device("cuda", 0)] * 8)
            shard_params_ep_named(model, mesh, "ep")
            step = shard_train_step(step, mesh)
        met = step(TS.TrainState.create(model, cfg), lr, hr)
        out[name] = {k: float(met[k]) for k in ("loss", "grad_norm")}
    rel = max(abs(out["dp2_ep4"][k] - out["dense"][k]) / abs(out["dense"][k])
              for k in out["dense"])
    check(rel <= MOE_F64_RTOL, f"EDSRMoE float64 step, dp=2,ep=4 against "
                               f"dense: {out} ({rel} > {MOE_F64_RTOL})")
    # why the float32 runs part: the dense float32 gradient against the
    # float64 one from the same weights, per tensor as a share of its
    # largest float64 element (the worst tensor)
    grads = {}
    for dtype in (torch.float64, torch.float32):
        model = create_model(
            "edsr_moe", scale=4, channels=3, device="cuda",
            generator=torch.Generator().manual_seed(SEED), **MOE_KW).to(dtype)
        loss = l1_loss(model(lr.to(dtype)), hr.to(dtype))
        grads[dtype] = dict(zip([n for n, _ in model.named_parameters()],
                                torch.autograd.grad(loss,
                                                    list(model.parameters()))))
    f32_dev = max((float((grads[torch.float32][n].double() - g).abs().max()
                         / g.abs().max()), n)
                  for n, g in grads[torch.float64].items())
    return dict(out, max_rel=rel, rtol=MOE_F64_RTOL,
                f32_grad_worst_share_of_f64=f32_dev[0],
                f32_grad_worst_tensor=f32_dev[1])


def phase_mesh_train(torch):
    """The training meshes of ``parallel/`` at full width on the one card
    (the card repeated in the mesh): EDSR-baseline x4 on one device and
    under dp=2,tp=2 and dp=2,sp=2,tp=2; the scan-trunk EDSR on one device
    and under dp=2,pp=4, whose checkpoint ``train.evaluate`` reads; 2 GAN
    steps on one device and under dp=2,tp=2; EDSRMoE x4 dense and under
    dp=2,ep=4; ``dryrun_multichip(8)``; ``train.loop --mesh`` without the
    cards exits 2; on a host of 4 or more cards, dp=2,tp=2 and dp=2,ep=2
    with one position per card."""
    import contextlib
    import io

    from enph459_super_resolution_tpu_torch.parallel.dryrun import \
        dryrun_multichip
    from enph459_super_resolution_tpu_torch.train import evaluate as TE
    from enph459_super_resolution_tpu_torch.train import loop as TL
    from enph459_super_resolution_tpu_torch.train.data import (
        PatchConfig, make_patch_sampler, synthetic_scene_pool)

    t_phase = time.perf_counter()
    work = WORK / "mesh_train"
    card = torch.device("cuda", 0)
    pool = synthetic_scene_pool(n_images=32, size=208, channels=3, seed=0)
    batch = next(make_patch_sampler(pool[4:], PatchConfig(), seed=0,
                                    device="cuda"))
    reset_counts()
    log_every, TL.LOG_EVERY = TL.LOG_EVERY, 1  # every step's loss
    done = {}
    try:
        for name, (_, _, _, base, _) in MESH_RUNS.items():
            done[name] = _mesh_run(torch, work, name, batch,
                                   base=done.get(base))
        multicard = {}
        if torch.cuda.device_count() >= 4:
            cards = [torch.device("cuda", i) for i in range(4)]
            for name, base, spec in (
                    ("edsr_dp2_tp2", "edsr_single", "dp=2,tp=2"),
                    ("moe_dp2_ep4", "moe_dense", "dp=2,ep=2")):
                model_name, kw, _, _, gan = MESH_RUNS[name]
                key = name.replace("ep4", "ep2") + "_4cards"
                multicard[key] = _mesh_run(
                    torch, work, key, batch, devices=cards, base=done[base],
                    run=(model_name, kw, spec, base, gan))["row"]
    finally:
        TL.LOG_EVERY = log_every
    launches = read_counts()
    check(not any(launches.values()),
          f"mesh training launched hand-written kernels: {launches}")
    moe_f64 = _moe_f64_step(torch, batch)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TE.main(["--run", str(work / "edsr_dp2_pp4")])
    ev = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and _finite(ev) and ev["step"] == MESH_STEPS,
          f"train.evaluate of the dp=2,pp=4 run: exit {rc}, {ev}")

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(8, devices=[card] * 8)
    dryrun_s = time.perf_counter() - t0
    dryrun = out.getvalue().strip().splitlines()
    check(sum(" ok:" in ln for ln in dryrun) == 8,
          f"dryrun_multichip(8): {dryrun}")

    # train.loop --mesh without the cards: exit 2, nothing written
    n_cards = torch.cuda.device_count()
    refused = None
    if n_cards < 4:
        bad = work / "refused"
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                TL.main(["--mesh", "dp=2,tp=2", "--device", "cuda",
                         "--steps", "2", "--out", str(bad)])
            rc = 0
        except SystemExit as exc:
            rc = exc.code
        said = err.getvalue().strip().splitlines()
        check(rc == 2 and f"needs 4 devices, have {n_cards}" in
              err.getvalue() and not bad.exists(),
              f"train.loop --mesh dp=2,tp=2 on {n_cards} card(s): exit "
              f"{rc}, {said[-1:]}")
        refused = {"cards": n_cards, "exit": rc, "error": said[-1]}
    row = {"phase": "mesh_train", "card": nvidia_smi("name,power.limit"),
           "runs": {k: {f: v["row"][f] for f in (
               "mesh", "steps_per_s", "peak_mem_mb", "device_idle_share")
               if f in v["row"]} for k, v in done.items()},
           "moe_bars_held": {k: v["row"]["bar_held"] for k, v in done.items()
                             if "bar_held" in v["row"]},
           "moe_f64_step": moe_f64, "multicard": multicard,
           "evaluate_dp2_pp4": ev, "dryrun": dryrun, "dryrun_s": dryrun_s,
           "cli_refusal": refused, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    return row


ANALYSES_RTOL = 1e-4          # the analyses on the card against the host
CAL_CHART_BLUR = 1.5          # HR px: the synthetic chart's print and lens
CAL_NOISE_DN = 0.5            # the synthetic session's read noise
# the calibration folder: pos4 has its 30 reps (SURVEY.md: pos4 n=30),
# the other 8 positions are cut to 10 to keep the phase near a minute
PSF_POSITIONS, PSF_REPS = 9, 10
PSF_TRUTH_POS, PSF_TRUTH_REPS = 4, 30
PSF_SHAPE = (1536, 2048)
PSF_SIGMA_PX = 0.73           # SURVEY.md: pos4 sigma 0.725 / 0.731 px
PSF_SIGMA_ATOL = 0.02
PSF_CROP = 50                 # psf.analyze's default --crop-radius


def _cal_target_scene(torch):
    """HR 3072x4096 chart on the card for the mono_cal_target preset: a
    dark bar 40 HR px wide slanted 40 degrees from the columns through
    ROI-2 (HR 1900:2100, 2560:2760; LR 950:1050, 1280:1380), as the real
    chart's ROI-2 line, its two step edges inside the ROI; bars of 16, 10,
    6 and 4 HR px period crossing HR column 2700 at rows 1240:1560 (LR
    column 1350, rows 620:780); a flat background; all softened by a
    Gaussian of ``CAL_CHART_BLUR`` HR px (the print and the lens), before
    the workload's PSF."""
    import math

    from enph459_super_resolution_tpu_torch.ops.conv import gaussian_filter

    h, w = 3072, 4096
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    a = math.radians(40.0)
    across = (xx - 2660) * math.cos(a) - (yy - 2000) * math.sin(a)
    line = torch.where(across.abs() < 20, 40.0, 210.0)
    box = (yy >= 1850) & (yy < 2150) & (xx >= 2500) & (xx < 2820)
    hr = torch.where(box, line, torch.full_like(line, 120.0))
    period = torch.where(yy < 1320, 16.0, torch.where(
        yy < 1400, 10.0, torch.where(yy < 1480, 6.0, 4.0)))
    bars = torch.where(torch.remainder(yy, period) < period / 2, 220.0, 30.0)
    region = (yy >= 1200) & (yy < 1600) & (xx >= 2600) & (xx < 2800)
    return gaussian_filter(torch.where(region, bars, hr), CAL_CHART_BLUR)


def _save_pngs(items) -> None:
    """Write (uint8 image, path) pairs on 8 threads (PIL's encoder lets go
    of the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from enph459_super_resolution_tpu_torch.data.io import save_png

    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(save_png, img, str(path))
                  for img, path in items]:
            f.result()


def _analysis_rel(a, b) -> float:
    """Largest relative difference of two finite-or-nan numbers."""
    if np.isnan(a) and np.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _cli(main, argv):
    """One CLI run with every launch count zeroed just before it: (exit
    code, seconds, launches, its standard output)."""
    import contextlib
    import io

    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, time.perf_counter() - t0, read_counts(), out.getvalue()


def _analyses_cal_target(torch) -> dict:
    from enph459_super_resolution_tpu_torch.data.sessions import \
        CENTER_SHIFT_FILES
    from enph459_super_resolution_tpu_torch.eval import cal_target_analysis
    from enph459_super_resolution_tpu_torch.sr.classical import (
        forward_model, make_gaussian_psf)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    cfg = WORKLOADS["mono_cal_target"]
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    work = WORK / "analyses"
    sdir = work / "cal" / "data" / "session0"
    hr = _cal_target_scene(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    frames = []
    for fname, shift in CENTER_SHIFT_FILES:
        lr = forward_model(hr, psf, shift, 2)
        lr = lr + CAL_NOISE_DN * torch.randn(lr.shape, device="cuda",
                                             generator=gen)
        frames.append((torch.clamp(torch.round(lr), 0, 255).to(
            torch.uint8).cpu().numpy(), sdir / fname))
    check(frames[0][0].shape == (1536, 2048), f"LR {frames[0][0].shape}")
    _save_pngs(frames)
    run_s, launches = _sr_run("mono_cal_target", sdir.parent,
                              work / "cal" / "results")
    expected = expected_launches("f32", False, _rank(psf), 5,
                                 cfg.ibp_iterations)
    check(launches == expected,
          f"launches {launches}, solve structure implies {expected}")
    unit = work / "cal" / "results" / "session0"
    runs = {}
    for device in ("cuda", "cpu"):
        out_dir = work / "cal" / f"analysis_{device}"
        rc, secs, counts, _ = _cli(cal_target_analysis.main, [
            str(unit), "--preset", "mono_cal_target", "--no-figures",
            "--device", device, "--out-dir", str(out_dir)])
        check(rc == 0, f"cal_target_analysis --device {device} exited {rc}")
        check(not any(counts.values()),
              f"cal_target_analysis launched hand-written kernels: {counts}")
        methods = json.loads((out_dir / "analysis.json").read_text())[
            "methods"]
        runs[device] = {"s": secs, "methods": {
            m: {k: rec[k] for k in ("mtf50", "mtf10", "mtf50_full",
                                   "mtf10_full", "contrast_peak",
                                   "contrast_mean", "edge_angle_deg")}
            for m, rec in methods.items()}}
    cuda, cpu = runs["cuda"]["methods"], runs["cpu"]["methods"]
    check(sorted(cuda) == ["LR bicubic 2x", "Native-2x", "SAA", "SAA+IBP"],
          f"methods {sorted(cuda)}")
    rel = max(_analysis_rel(cuda[m][k], cpu[m][k])
              for m in cpu for k in cpu[m])
    check(rel <= ANALYSES_RTOL,
          f"cal target, card against host: {rel} > {ANALYSES_RTOL}")
    check(all(np.isfinite(cuda[m]["mtf50"]) for m in cuda),
          f"non-finite MTF50: {cuda}")
    check(cuda["SAA+IBP"]["mtf50"] > cuda["Native-2x"]["mtf50"],
          f"SAA+IBP MTF50 {cuda['SAA+IBP']['mtf50']} <= Native-2x's "
          f"{cuda['Native-2x']['mtf50']}")
    return {"sr_run_s": run_s, "sr_run_launches": launches,
            "analysis_s": {d: r["s"] for d, r in runs.items()},
            "mtf50": {m: [cuda[m]["mtf50"], cpu[m]["mtf50"]] for m in cpu},
            "mtf10": {m: [cuda[m]["mtf10"], cpu[m]["mtf10"]] for m in cpu},
            "contrast_peak": {m: cuda[m]["contrast_peak"] for m in cuda},
            "card_vs_host_max_rel": rel}


def _pinhole_frames(torch, root):
    """The flat-layout calibration folder: PSF_POSITIONS positions of
    PSF_REPS frames (PSF_TRUTH_REPS at PSF_TRUTH_POS)
    ``sweepx_tilt0.28000_repNN_posK.png`` of PSF_SHAPE, one Gaussian pinhole
    spot of sigma PSF_SIGMA_PX (amplitude 200 over a dark level of 8, read
    noise 0.5 DN) per frame, at position K's place on a 3 x 3 grid plus a
    jitter.  At PSF_TRUTH_POS the jitter is whole pixels (up to 3): the
    cubic-spline alignment of a sub-pixel jitter broadens an undersampled
    spot's fitted sigma (by 0.04 px at sigma 0.73 in the reference and the
    port alike, ``tests/test_torch_psf.py``), so only there the truth is
    the sigma drawn; elsewhere up to 1.5 px in any sub-pixel phase."""
    h, w = PSF_SHAPE
    rng = np.random.default_rng(SEED + 17)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    yy = torch.arange(h, device="cuda", dtype=torch.float64)[:, None]
    xx = torch.arange(w, device="cuda", dtype=torch.float64)[None, :]
    items = []
    for pos in range(PSF_POSITIONS):
        base = np.array([h * (1 + pos // 3) // 4, w * (1 + pos % 3) // 4],
                        np.float64)
        truth = pos == PSF_TRUTH_POS
        for rep in range(PSF_TRUTH_REPS if truth else PSF_REPS):
            if truth:
                cy, cx = base + rng.integers(-3, 4, 2)
            else:
                cy, cx = base + rng.uniform(-1.5, 1.5, 2)
            img = 8.0 + 200.0 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                          / (2 * PSF_SIGMA_PX ** 2))
            img = img + 0.5 * torch.randn((h, w), device="cuda",
                                          dtype=torch.float64, generator=gen)
            items.append((torch.clamp(torch.round(img), 0, 255).to(
                torch.uint8).cpu().numpy(),
                root / f"sweepx_tilt0.28000_rep{rep:02d}_pos{pos}.png"))
    t0 = time.perf_counter()
    _save_pngs(items)
    return time.perf_counter() - t0


def _analyses_psf(torch) -> dict:
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.psf import analyze
    from enph459_super_resolution_tpu_torch.psf import toolkit as tk

    work = WORK / "analyses" / "psf"
    root = work / "data"
    root.mkdir(parents=True)
    write_s = _pinhole_frames(torch, root)
    runs = {}
    for device in ("cuda", "cpu"):
        out_dir = work / f"out_{device}"
        rc, secs, counts, _ = _cli(analyze.main, [
            str(root), "--pixel-pitch-um", "3.45", "--no-figures",
            "--device", device, "--output-dir", str(out_dir)])
        check(rc == 0, f"psf.analyze --device {device} exited {rc}")
        check(not any(counts.values()),
              f"psf.analyze launched hand-written kernels: {counts}")
        runs[device] = {"s": secs, "summary": json.loads(
            (out_dir / "summary.json").read_text())}
        check((out_dir / "psf_mtf_by_position_data.npz").exists(),
              "psf.analyze wrote no npz")
    cuda, cpu = runs["cuda"]["summary"], runs["cpu"]["summary"]
    check(sorted(cuda) == [f"pos{p}" for p in range(PSF_POSITIONS)],
          f"positions {sorted(cuda)}")
    rel = max(_analysis_rel(cuda[p][k], cpu[p][k])
              for p in cpu for k in cpu[p])
    check(rel <= ANALYSES_RTOL,
          f"psf.analyze, card against host: {rel} > {ANALYSES_RTOL}")
    truth = cuda[f"pos{PSF_TRUTH_POS}"]
    sigma_err = max(abs(truth["sigma_x"] - PSF_SIGMA_PX),
                    abs(truth["sigma_y"] - PSF_SIGMA_PX))
    check(truth["n"] == PSF_TRUTH_REPS and sigma_err <= PSF_SIGMA_ATOL,
          f"pos{PSF_TRUTH_POS} sigma {truth} against {PSF_SIGMA_PX}")

    # the batched fit alone: one position's PSF_TRUTH_REPS PSFs, the card's
    # warm time (median of 3) and the host's
    stack = []
    for rep in range(PSF_TRUTH_REPS):
        img = load_gray(str(root / f"sweepx_tilt0.28000_rep{rep:02d}_pos"
                                   f"{PSF_TRUTH_POS}.png"), dtype=np.float64)
        stack.append(tk.extract_psf(img, tk.find_peak(img, device="cuda"),
                                    PSF_CROP))
    stack = np.stack(stack)
    fit_s = {}
    for device, reps in (("cuda", 3), ("cpu", 1)):
        times = []
        for _ in range(reps + (device == "cuda")):
            t0 = time.perf_counter()
            params = tk.fit_gaussian_psf_batch(stack, device=device)
            times.append(time.perf_counter() - t0)
        fit_s[device] = sorted(times[-reps:])[reps // 2]
        check(np.all(np.isfinite(params)), f"fit on {device}: {params}")
    return {"frames": {"positions": PSF_POSITIONS, "reps": PSF_REPS,
                       f"reps_pos{PSF_TRUTH_POS}": PSF_TRUTH_REPS,
                       "shape": list(PSF_SHAPE)},
            "png_write_s": write_s,
            "analyze_s": {d: r["s"] for d, r in runs.items()},
            "pos4": truth, "pos4_sigma_err_px": sigma_err,
            "mtf50": {p: cuda[p]["mtf50"] for p in cuda},
            "mtf50_naive": {p: cuda[p]["mtf50_naive"] for p in cuda},
            "card_vs_host_max_rel": rel,
            "fit_batch_s": fit_s, "fit_batch": list(stack.shape)}


def _analyses_barcodes() -> dict:
    from enph459_super_resolution_tpu_torch.eval import barcode_analysis

    results = REPO / "artifacts" / "rgb_barcodes" / "results"
    out = WORK / "analyses" / "decode_confidence.json"
    rc, secs, counts, _ = _cli(barcode_analysis.main, [
        str(results), "--rois", "rgb", "--decoder", "code128",
        "--figure", "none", "--out", str(out)])
    check(rc == 0, f"barcode_analysis exited {rc}")
    got = json.loads(out.read_text())
    want = json.loads((results / "decode_confidence.json").read_text())
    check(got == want, "barcode_analysis records differ from the committed "
                       "decode_confidence.json")
    recs = [r for s in got["sessions"] for r in s["records"]]
    return {"s": secs, "records": len(recs), "launches": counts,
            "conf_4mil_saa_ibp": [r["confidence"] for r in recs
                                  if r["label"] == "4 mil"
                                  and r["method"] == "SAA+IBP"]}


def phase_analyses(torch):
    """The rig's analyses on the card: the cal-target slanted-edge MTF of
    a fused synthetic session (``eval.cal_target_analysis --preset
    mono_cal_target``), ``psf.analyze`` of a flat-layout pinhole folder,
    each on cuda and on the host, and ``eval.barcode_analysis`` of the
    committed real-session SR outputs."""
    t_phase = time.perf_counter()
    row = {"phase": "analyses", "card": nvidia_smi("name,power.limit"),
           "cal_target": _analyses_cal_target(torch),
           "psf": _analyses_psf(torch),
           "barcodes": _analyses_barcodes(),
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    return row


RIG_CAL = {"tilt_min": 0.1, "tilt_max": 0.3, "tilt_steps": 3,
           "num_repeats": 2, "settle_ms": 50.0}
RIG_GAIN_RTOL = 0.05          # the fitted px/deg against the sim's
RIG_TILT = 0.15625            # deg: 0.5 LR px at the sim's 3.2 px/deg
RIG_DIGITS = "5901234123457"
# HR (row, col) of each EAN-13 code's top-left corner, in the phase of
# tests/test_ean13.py's (48, 143) inside its 192 x 512 scene; the code is
# decoded in that 192 x 512 window around it
RIG_CODES = ((1072, 655), (1072, 3215), (2096, 1935))
RIG_CODE_WINDOW = (48, 143, 192, 512)   # top, left margins; height, width
RIG_AF_POINTS = (9, 7)        # coarse, fine autofocus positions
RIG_STAB = {"n_trials": 2, "num_frames": 12}   # 2 x 4 x 12 = 96 frames
RIG_RENDERS = 3               # frames timed per device


def _rig_gain(shifts_csv: Path) -> float:
    """Least-squares px/deg through the origin of shifts.csv: each
    off-axis position's mean shift along the swept axis against its signed
    tilt."""
    import csv

    from enph459_super_resolution_tpu_torch.hw.calibrate import GRID_SIGNS

    num = den = 0.0
    with open(shifts_csv) as fp:
        for row in csv.DictReader(fp):
            sx, sy = GRID_SIGNS[int(row["position"])]
            x = row["sweep_axis"] == "x"
            t = (sx if x else sy) * float(row["tilt_angle_deg"])
            num += t * float(row["dx_mean_px" if x else "dy_mean_px"])
            den += t * t
    return num / den


def _rig_hr() -> tuple:
    """The HR scene's shape of ``SimConfig()``: the sensor's LR 1536x2048
    at factor 2, 3072x4096."""
    from enph459_super_resolution_tpu_torch.hw import SimConfig

    cfg = SimConfig()
    return tuple(n * cfg.factor for n in cfg.lr_shape)


def _rig_scene_barcodes() -> np.ndarray:
    """The HR barcode scene: flat 235 holding an EAN-13 code (2 HR px per
    module, 96 rows; ``tests/test_ean13.py``'s geometry) at each of
    ``RIG_CODES``."""
    from enph459_super_resolution_tpu_torch.eval import ean13

    bc = ean13.render(RIG_DIGITS, module_px=2, height_px=96)
    scene = np.full(_rig_hr(), 235.0)
    for r, c in RIG_CODES:
        scene[r:r + bc.shape[0], c:c + bc.shape[1]] = bc
    return scene


def _rig_render(torch) -> dict:
    """One pinhole rig on the card and one on the host, the same seed:
    their frames within +-1 uint8, the same shift draws (the rng's state
    equal after the same frames); the prefilter's, a frame's and the tap
    sum's times on each."""
    from enph459_super_resolution_tpu_torch.hw import (SimBeamSteering,
                                                       SimulatedRig)
    from enph459_super_resolution_tpu_torch.hw.sim import render_shifted

    rigs, out = {}, {}
    for name, dev in (("card", "cuda"), ("host", "cpu")):
        rig = SimulatedRig(device=dev)
        SimBeamSteering(rig).set_angles(RIG_TILT, -RIG_TILT)
        rig.sleep(0.05)
        t0 = time.perf_counter()
        coeff = rig._prefiltered()
        if dev == "cuda":
            torch.cuda.synchronize()
        prefilter_s = time.perf_counter() - t0
        frames, times = [], []
        for _ in range(RIG_RENDERS):
            t0 = time.perf_counter()
            frames.append(rig.render(rig.cfg.base_exposure_us))
            times.append(time.perf_counter() - t0)
        dy = np.float32(0.3 * rig.cfg.factor)

        def sample():
            return render_shifted(coeff, dy, -dy, rig._PAD, rig.cfg.factor)

        if dev == "cuda":
            sample_ms = time_ms(torch, sample, 10)
        else:
            sample()
            t0 = time.perf_counter()
            sample()
            sample_ms = (time.perf_counter() - t0) * 1e3
        rigs[name] = (rig, frames)
        out[name] = {"device": dev, "prefilter_s": prefilter_s,
                       "frame_ms": sorted(times)[len(times) // 2] * 1e3,
                       "frame_ms_runs": [t * 1e3 for t in times],
                       "sample_ms": sample_ms}
    (card, card_frames), (host, host_frames) = rigs["card"], rigs["host"]
    check(card.rng.bit_generator.state == host.rng.bit_generator.state,
          "the card's rig and the host's drew different shifts")
    diffs = [np.abs(a.astype(np.int16) - b.astype(np.int16))
             for a, b in zip(card_frames, host_frames)]
    check(card_frames[0].shape == card.cfg.lr_shape,
          f"{card_frames[0].shape}")
    check(max(int(d.max()) for d in diffs) <= 1,
          f"card frames against host frames: {[int(d.max()) for d in diffs]}")
    out["frame_max_diff"] = max(int(d.max()) for d in diffs)
    out["frame_diff_share"] = max(float((d > 0).mean()) for d in diffs)
    return out


def _rig_calibrate(work: Path) -> dict:
    """``run_calibration`` of the pinhole rig (``SimConfig()``: LR
    1536x2048, the 3072x4096 pinhole scene) on the card: the fitted gain
    within ``RIG_GAIN_RTOL`` of the sim's."""
    from enph459_super_resolution_tpu_torch.hw import (SimBeamSteering,
                                                       SimCamera,
                                                       SimulatedRig)
    from enph459_super_resolution_tpu_torch.hw.calibrate import \
        run_calibration

    rig = SimulatedRig(device="cuda")
    cam = SimCamera(rig)
    frames = []
    capture = cam.capture_raw

    def counted():
        frames.append(1)
        return capture()

    cam.capture_raw = counted
    t0 = time.perf_counter()
    res = run_calibration(SimBeamSteering(rig), cam, str(work / "cal"),
                          sleep_fn=rig.sleep, save_images=False,
                          device="cuda", **RIG_CAL)
    cal_s = time.perf_counter() - t0
    gain = _rig_gain(work / "cal" / "shifts.csv")
    want = rig.cfg.gain_px_per_deg
    check(abs(gain - want) <= RIG_GAIN_RTOL * want,
          f"calibrated gain {gain} px/deg, the sim's {want}")
    for f in ("centers.csv", "shifts.csv", "results.json"):
        check((work / "cal" / f).exists(), f"calibration wrote no {f}")
    return {"s": cal_s, "frames": len(frames), "gain_px_per_deg": gain,
            "gain_rel_err": gain / want - 1.0,
            "exposure_us": res["exposure_us"]}


def _rig_collect(work: Path) -> dict:
    """``run_hw_triggered`` of the barcode rig on the card at 0.5 px tilts,
    one settle of 50 ms, 2 repeats, and the special run at the calibrated
    per-corner tilts."""
    from enph459_super_resolution_tpu_torch.hw import (SimBeamSteering,
                                                       SimCamera,
                                                       SimulatedRig)
    from enph459_super_resolution_tpu_torch.hw.collect import \
        run_hw_triggered

    rig = SimulatedRig(scene=_rig_scene_barcodes(), device="cuda")
    t0 = time.perf_counter()
    res = run_hw_triggered(
        SimBeamSteering(rig), SimCamera(rig, hardware_trigger=True),
        str(work / "collect"), calibration_csv=str(work / "cal" /
                                                   "shifts.csv"),
        tilt_min=RIG_TILT, tilt_max=RIG_TILT, tilt_steps=1,
        settling_times_ms=(50.0,), num_repeats=2, special_run=True,
        sleep_fn=rig.sleep, timestamp="run")
    collect_s = time.perf_counter() - t0
    check(len(res["combos"]) == 2 and res["special_run"] is not None,
          f"combos {res['combos']}")
    check(len(res["images"]) == 16, f"{len(res['images'])} images")
    tilts = [t for pair in res["special_run"]["per_corner_tilts"]
             for t in pair]
    check(all(abs(t / RIG_TILT - 1.0) <= RIG_GAIN_RTOL for t in tilts),
          f"special-run tilts {tilts} against {RIG_TILT}")
    return {"s": collect_s, "frames": len(res["images"]),
            "combos": res["combos"],
            "special_tilts_deg": res["special_run"]["per_corner_tilts"]}


def _rig_decode(torch, run_dir: Path, out: Path, cfg) -> dict:
    """Every unit's ``SAA_IBP.png`` decodes every code (confidence 1.0);
    the 2x bicubic of the unit's LR mean decodes none."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.eval import ean13
    from enph459_super_resolution_tpu_torch.eval.decode import \
        decode_confidence
    from enph459_super_resolution_tpu_torch.ops.resize import \
        bicubic_upsample

    top, left, hh, ww = RIG_CODE_WINDOW
    rois = [(r - top, r - top + hh, c - left, c - left + ww)
            for r, c in RIG_CODES]

    def conf(img):
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        return [decode_confidence(u8, roi, decoder=ean13.decode)
                for roi in rois]

    units = {}
    for combo in sorted(p for p in run_dir.iterdir() if p.is_dir()):
        for unit in cfg.load(str(combo)):
            unit_dir = out / combo.name / f"rep{unit.rep}"
            mean = torch.as_tensor(unit.frames.mean(axis=0), device="cuda")
            up = bicubic_upsample(mean[None, :, :, None], 2)[0, :, :, 0]
            units[f"{combo.name}/rep{unit.rep}"] = {
                "saa_ibp": conf(load_gray(str(unit_dir / "SAA_IBP.png"))),
                "native_2x": conf(load_gray(str(unit_dir /
                                                "native_2x.png"))),
                "bicubic": conf(up.cpu().numpy())}
    check(len(units) == 4, f"{len(units)} units decoded")
    for name, u in units.items():
        check(all(r == (RIG_DIGITS, 1.0) for r in u["saa_ibp"]),
              f"{name}: SAA_IBP decodes {u['saa_ibp']}")
        check(all(r == (None, 0.0) for r in u["bicubic"]),
              f"{name}: the bicubic of the LR mean decodes {u['bicubic']}")
    return units


def _rig_rest(torch, work: Path, run_dir: Path, cfg, k1_rows) -> dict:
    """The rest of the layer on the card: the Laplacian variance against
    the host's, an autofocus sweep on a SimStage, a stability run on the
    knife-edge rig, and a Chrome trace of one warm solve naming K1, whose
    K1 device time is set beside the sum of the ``kernel`` phase's per-op
    device times over the same launches."""
    from enph459_super_resolution_tpu_torch.data.io import load_gray
    from enph459_super_resolution_tpu_torch.hw import (SimBeamSteering,
                                                       SimCamera, SimStage,
                                                       SimulatedRig,
                                                       knife_edge_scene)
    from enph459_super_resolution_tpu_torch.hw.autofocus import (
        autofocus_sweep, laplacian_variance)
    from enph459_super_resolution_tpu_torch.hw.stability import \
        run_stability
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve)
    from enph459_super_resolution_tpu_torch.utils.trace import device_trace

    out = {}
    frame = load_gray(str(next(run_dir.glob("*/corner0_rep00.png"))))
    lap = {"card": laplacian_variance(frame, device="cuda"),
           "host": laplacian_variance(frame, device="cpu")}
    rel = abs(lap["card"] - lap["host"]) / abs(lap["host"])
    check(rel <= 1e-5, f"laplacian_variance card {lap['card']} host "
                       f"{lap['host']}")
    out["laplacian_variance"] = {**lap, "rel": rel}

    rig = SimulatedRig(device="cuda")
    stage = SimStage(rig)
    t0 = time.perf_counter()
    af = autofocus_sweep(SimCamera(rig), stage, *stage.travel,
                         coarse_points=RIG_AF_POINTS[0],
                         fine_points=RIG_AF_POINTS[1], sleep_fn=rig.sleep,
                         device="cuda")
    check(abs(af["best_pos_mm"] - stage.best) <= stage.dof,
          f"autofocus best {af['best_pos_mm']} mm, the stage's "
          f"{stage.best} +- {stage.dof}")
    out["autofocus"] = {"s": time.perf_counter() - t0,
                        "best_pos_mm": af["best_pos_mm"],
                        "frames": sum(RIG_AF_POINTS)}

    h, w = _rig_hr()
    rig = SimulatedRig(scene=knife_edge_scene((h, w), edge_col=w / 2),
                       device="cuda")
    t0 = time.perf_counter()
    summary = run_stability(SimCamera(rig), SimBeamSteering(rig),
                            str(work / "stability"), sleep_fn=rig.sleep,
                            figures=False, **RIG_STAB)
    sigmas = [summary["positions"][f"pos{p}"]["sigma_mean_px"]
              for p in range(4)]
    edges = [summary["positions"][f"pos{p}"]["edge_mean_px"]
             for p in range(4)]
    check(all(np.isfinite(sigmas)) and max(sigmas) < 0.5,
          f"stability sigmas {sigmas}")
    check(all(abs(e - w / 4) < 2.0 for e in edges), f"edges {edges}")
    check((work / "stability" / "stability_trials.csv").exists(),
          "stability wrote no stability_trials.csv")
    out["stability"] = {"s": time.perf_counter() - t0,
                        "frames": 4 * RIG_STAB["n_trials"]
                        * RIG_STAB["num_frames"],
                        "sigma_mean_px": sigmas, "edge_mean_px": edges}

    unit = cfg.load(str(next(p for p in sorted(run_dir.iterdir())
                             if p.is_dir())))[0]
    frames = torch.as_tensor(unit.frames, device="cuda")
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    solve(frames, psf, unit.shifts, device="cuda")
    with device_trace(str(work / "trace")) as prof:
        solve(frames, psf, unit.shifts, device="cuda")
    text = Path(prof.trace_path).read_text()
    k1 = [e for e in json.loads(text)["traceEvents"]
          if e.get("cat") == "kernel"
          and "banded_rows_kernel" in e.get("name", "")]
    check(bool(k1), "the solve's trace does not name K1's banded_rows_kernel")
    table = _k1_solve_launches(len(unit.frames), cfg.ibp_iterations,
                               _rank(psf))
    out["trace"] = {"bytes": len(text), "k1_events": len(k1),
                    "k1_device_ms": sum(e["dur"] for e in k1) / 1e3,
                    "per_op": _k1_per_solve(k1_rows, table)}
    return out


def phase_rig(torch, k1_rows) -> dict:
    """The simulated rig at the sensor's size (``SimConfig()``) on the
    card: calibrate, collect, fuse with ``sr.run --workload mono_barcodes``
    on K1, decode; and the rest of the rig layer."""
    from enph459_super_resolution_tpu_torch.sr.classical import \
        make_gaussian_psf
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    t_phase = time.perf_counter()
    work = WORK / "rig"
    cfg = WORKLOADS["mono_barcodes"]
    hr = _rig_hr()
    row = {"phase": "rig", "card": nvidia_smi("name,power.limit"),
           "lr": [hr[0] // 2, hr[1] // 2], "hr": list(hr),
           "render": _rig_render(torch),
           "calibration": _rig_calibrate(work),
           "collection": _rig_collect(work)}
    run_dir = work / "collect" / "run"
    out = work / "results"
    run_s, launches = _sr_run("mono_barcodes", run_dir, out)
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    expected = expected_launches("f32", False, _rank(psf), 4,
                                 cfg.ibp_iterations)
    check(launches == expected,
          f"sr.run launches {launches}, the batched solve implies "
          f"{expected}")
    metrics = [_check_unit(p.parent, cfg.lr_mean_name)
               for p in sorted(out.rglob("done.flag"))]
    check(len(metrics) == 4, f"{len(metrics)} units fused")
    check(all(m["hr_shape"] == list(hr) for m in metrics),
          f"hr {[m['hr_shape'] for m in metrics]}")
    row["sr_run"] = {"s": run_s, "launches": launches,
                     "launches_expected": expected, "units": len(metrics),
                     "solve_batch_s": metrics[0]["timings_s"][
                         "solve_batch_total"],
                     "mse_last": [m["mse_history"][-1] for m in metrics]}
    row["decode"] = _rig_decode(torch, run_dir, out, cfg)
    row.update(_rig_rest(torch, work, run_dir, cfg, k1_rows))
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return row


def _summary(name, source, replaces, launches, rows, head, card):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **({"unfused_ms": head["unfused_ms"]} if "unfused_ms" in head
               else {}),
            **({"device_ms": head["kernel_device_ms"]}
               if "kernel_device_ms" in head else {}),
            "at": head.get("op") or f"{head['pack']} pack", "card": card}


def main() -> int:
    import torch

    if not (REPO / "enph459_super_resolution_tpu_torch").is_dir():
        print("chip_smoke: the port's package enph459_super_resolution_tpu_"
              f"torch is not beside this script in {REPO}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        card, f32_peak = phase_device(torch)
        phase_native(torch)
        host = host_operators()
        k1_rows = phase_kernel(torch, f32_peak, host)
        fused_rows = phase_fused(torch, f32_peak, host)
        del host
        mono = phase_mono(torch)
        phase_analyses(torch)
        rig = phase_rig(torch, k1_rows)
        bf16_launches = phase_mono_bf16(torch, mono)
        modes = phase_modes(torch, mono)
        phase_rgb(torch)
        trunk_rows = phase_trunk(torch, f32_peak)
        edsr_model, edsr = phase_edsr(torch)
        phase_burst_lr(torch)
        phase_tiled(torch, edsr_model)
        precision = phase_precision(torch, mono, modes)
        phase_adjoint(torch, mono)
        conv = phase_conv(torch, mono)
        phase_sharded(torch, mono, conv, edsr_model)
        if torch.cuda.device_count() >= 4:
            phase_multicard(torch, mono, conv, edsr_model)
        phase_prewarm_watch(torch, mono)
        burst = phase_burst(torch)
        train = phase_train(torch)
        phase_mesh_train(torch)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    k1_src = "enph459_super_resolution_tpu_torch/csrc/banded_rows.cu"
    k1_tpu = "enph459_super_resolution_tpu/ops/pallas_kernels.py:34"
    fused_src = "enph459_super_resolution_tpu_torch/csrc/fused_ibp.cu"
    fused_tpu = "enph459_super_resolution_tpu/ops/pallas_fused_ibp.py"
    f32_fused = modes[("f32", "on")]["launches"]

    def k1(dtype):
        return [r for r in k1_rows if r["bands"] == dtype]

    def fused(kernel, dtype):
        return [r for r in fused_rows
                if r["kernel"] == kernel and r["bands"] == dtype]

    def k1_entry(band, launches, **more):
        # a kind on the span walk adds its design and performed GFLOP
        head = next(r for r in k1_rows if r["op"] == f"fwd_r_{band}")
        return dict(_summary(f"banded_rows_{band}", k1_src, k1_tpu, launches,
                             k1(band), head, card), **more,
                    **({"design": K1_SPAN_DESIGNS[band],
                        "kernel_gflop": head["kernel_gflop"]}
                       if band in K1_SPAN_DESIGNS else {}))

    entries = [
        dict(_summary("banded_rows", k1_src, k1_tpu,
                      mono["launches"]["k1_f32"], k1("float32"),
                      next(r for r in k1_rows if r["op"] == "fwd_r"), card),
             fusion_refine_launches=burst["refine_launches"],
             rig_sr_run_launches=rig["sr_run"]["launches"]["k1_f32"]),
        _summary("banded_rows_bf16", k1_src, k1_tpu, bf16_launches["k1_bf16"],
                 k1("bfloat16"),
                 next(r for r in k1_rows if r["op"] == "fwd_r_bf16"), card),
        k1_entry("x3",
                 precision["f32 BF16_BF16_F32_X3"]["launches"]["k1_x3"])]
    for name, key, _ in NEW_PRESETS:
        entries.append(k1_entry(key[len("k1_"):],
                                precision[f"f32 {name}"]["launches"][key],
                                mm_precision=name))
    for kernel, line, key in (("fused_fwd", 237, "k2"),
                              ("fused_bwd", 264, "k3")):
        for dtype, launches in (("float32", f32_fused[f"{key}_f32"]),
                                ("bfloat16", bf16_launches[f"{key}_bf16"])):
            rows = fused(kernel, dtype)
            entries.append(_summary(
                kernel + ("_bf16" if dtype == "bfloat16" else ""), fused_src,
                f"{fused_tpu}:{line}", launches, rows,
                next(r for r in rows if r["pack"] == "mono"), card))
    trunk_src = "enph459_super_resolution_tpu_torch/csrc/trunk.cu"
    trunk_tpu = "enph459_super_resolution_tpu/ops/pallas_trunk.py:118"
    for dtype, key in (("float32", "k4_f32"), ("bfloat16", "k4_bf16")):
        rows = [r for r in trunk_rows if r["dtype"] == dtype]
        block = [r for r in rows if r["shape"] == "edsr"
                 and r["epilogue"] in ("relu", "skip")]
        # per launch over one residual block (relu + skip) at the EDSR shape
        head = {k: sum(r[k] for r in block) / 2
                for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                          "library_ms", "bound_ms")}
        head.update(op="edsr block, per launch", bound_by=block[0]["bound_by"])
        entries.append(dict(
            _summary("trunk" + ("_bf16" if dtype == "bfloat16" else ""),
                     trunk_src, trunk_tpu, edsr[key]["launches"][key], rows,
                     head, card),
            trained_serve_launches=train["serve_trained"][key]["launches"]))
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
