"""Burst-fusion training: learn the reference's multi-frame SR task.

Counterpart of ``enph459_super_resolution_tpu/train/burst.py``.  Classical
SAA+IBP (``sr.classical``) inverts the burst forward model given the
calibrated shifts and PSF; this trainer learns the inversion
(``models.zoo.BurstFusion`` / ``BurstFusionLR`` on the registered stack
from ``sr.fusion``) on bursts simulated with the same forward model, so the
learned engine is benchmarked head to head against SAA/IBP on held-out
scenes, every engine given only the nominal shifts while the true shifts
carry jitter and the sensor adds read noise.

    python -m enph459_super_resolution_tpu_torch.train.burst \\
        --steps 20000 --noise 2.0 --jitter 0.05 --out runs/burst

Runs on CUDA unless ``--device cpu`` is given (no fallback).  Every random
draw comes from an explicit ``torch.Generator`` seeded from ``seed`` and
the step (or the eval scene), apart from a pure function of its draws
(:meth:`BurstGen.batch`, :func:`crop_batch`, :func:`eval_scene`), so a
resumed run draws what an uninterrupted one draws.  The stream differs from
the JAX package's for the same seed (another generator); the scene pools
are the same arrays.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEVICES, resolve_device
from ..sr.fusion import (NOMINAL_SHIFTS_4, REGISTER_FNS, fuse,
                         register_burst, simulate_burst)
from ..utils.timing import rss_mb
from .data import generator

#: --arch CLI value -> (zoo model name, registration grid of the stack)
ARCHS = {"hr": "burstfusion", "lr": "burstfusion_lr"}


class BurstGen:
    """The batch generator: ``gen(hr[B, Hp, Wp], generator) -> (stack,
    target[B, H, W, 1])``, ``stack`` the model's registered input
    (``[B, H, W, N]`` on the HR grid for ``burstfusion``, ``[B, h, w,
    N*f^2]`` polyphase for ``burstfusion_lr``).

    True shifts = nominal + N(0, jitter) per burst; frames carry Gaussian
    read noise; registration uses only the nominal shifts.  A ``margin_lr``
    LR-px border is cropped from stack and target so boundary resampling
    never enters the loss.  :meth:`draw` takes the random draws,
    :meth:`batch` is the pure function of them.
    """

    def __init__(self, nominal, factor: int, psf, noise_sigma: float,
                 jitter_sigma: float, margin_lr: int = 6,
                 model_name: str = "burstfusion"):
        self.register = REGISTER_FNS[model_name]
        self.lr_grid = model_name == "burstfusion_lr"
        self.nominal = np.asarray(nominal, np.float32)
        self.psf = np.asarray(psf, np.float32)
        self.factor = factor
        self.noise_sigma = noise_sigma
        self.jitter_sigma = jitter_sigma
        self.margin = margin_lr * factor
        self.margin_stack = margin_lr if self.lr_grid else self.margin

    def draw(self, hr: torch.Tensor, gen: torch.Generator):
        """``(true_shifts[B, N, 2], noise[B, N, h, w])``."""
        b, n = hr.shape[0], len(self.nominal)
        h, w = hr.shape[-2] // self.factor, hr.shape[-1] // self.factor
        jit = torch.randn((b, n, 2), generator=gen, device=hr.device)
        true = torch.as_tensor(self.nominal, device=hr.device) \
            + self.jitter_sigma * jit
        noise = torch.randn((b, n, h, w), generator=gen, device=hr.device)
        return true, noise

    def batch(self, hr: torch.Tensor, true_shifts: torch.Tensor,
              noise: torch.Tensor):
        lr = simulate_burst(hr, true_shifts, self.psf, self.factor,
                            self.noise_sigma, noise=noise)
        stack = self.register(lr, self.nominal, self.factor)
        ms, m = self.margin_stack, self.margin
        stack = stack[:, ms:stack.shape[1] - ms, ms:stack.shape[2] - ms, :]
        tgt = hr[:, m:hr.shape[1] - m, m:hr.shape[2] - m, None]
        return stack, tgt

    def __call__(self, hr: torch.Tensor, gen: torch.Generator):
        return self.batch(hr, *self.draw(hr, gen))


def crop_batch(pool: torch.Tensor, idx, ys, xs, flips, hp: int):
    """``hp`` x ``hp`` crops of ``pool[idx]`` at ``(ys, xs)``, then per
    crop a row flip, a column flip and a rot90 where ``flips[:, 0..2]``."""
    ar = torch.arange(hp, device=pool.device)
    rows = ys[:, None] + ar
    cols = xs[:, None] + ar
    crops = pool[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    crops = torch.where(flips[:, 0, None, None], crops.flip(1), crops)
    crops = torch.where(flips[:, 1, None, None], crops.flip(2), crops)
    return torch.where(flips[:, 2, None, None],
                       torch.rot90(crops, 1, (1, 2)), crops)


def _crop_hr_batch(pool: torch.Tensor, gen: torch.Generator, hp: int,
                   batch: int):
    """Random HR crops + flip/rot augmentation (mono), drawn on the pool's
    device."""
    p, h, w = pool.shape
    dev = pool.device
    idx = torch.randint(0, p, (batch,), generator=gen, device=dev)
    ys = torch.randint(0, h - hp + 1, (batch,), generator=gen, device=dev)
    xs = torch.randint(0, w - hp + 1, (batch,), generator=gen, device=dev)
    flips = torch.rand((batch, 3), generator=gen, device=dev) < 0.5
    return crop_batch(pool, idx, ys, xs, flips, hp)


def eval_scene(model, hr_true: torch.Tensor, true_shifts: torch.Tensor,
               noise: torch.Tensor, nominal, factor: int, psf,
               noise_sigma: float, n_iter: int, shave: int,
               classical: bool, refine: int, refine_step: float, register):
    """One held-out scene's metrics for given draws: every engine's PSNR
    and SSIM (border-shaved) as 0-d tensors."""
    from ..eval.metrics import ssim as ssim_fn
    from ..ops.resample import spline_zoom
    from ..sr import classical as _classical
    from ..sr.fusion import data_consistency_refine

    lr = simulate_burst(hr_true, true_shifts, psf, factor, noise_sigma,
                        noise=noise)
    nominal_static = tuple((float(dy), float(dx)) for dy, dx in nominal)
    with torch.no_grad():
        rows = {"bicubic": torch.clamp(
            spline_zoom(torch.mean(lr, dim=0), factor), 0, 255)}
        if classical:
            saa = torch.clamp(
                _classical.shift_and_add(lr, nominal_static, factor), 0, 255)
            rows["saa"] = saa
            rows["ibp"], _ = _classical.ibp(lr, nominal_static, psf, saa,
                                            factor, n_iter=n_iter)
        if model is not None:
            rows["fusion"] = fuse(model, lr, np.asarray(nominal, np.float32),
                                  factor, register=register)
    if model is not None and refine > 0:
        rows["fusionref"] = data_consistency_refine(
            rows["fusion"], lr, np.asarray(nominal, np.float32), psf,
            factor, refine, refine_step)
    sl = slice(shave, -shave)
    out = {}
    for name, img in rows.items():
        mse = torch.mean((img[sl, sl] - hr_true[sl, sl]) ** 2)
        out[f"psnr_{name}"] = 10.0 * torch.log10(255.0 ** 2 / mse)
        out[f"ssim_{name}"] = ssim_fn(img[sl, sl], hr_true[sl, sl])
    return out


def evaluate_burst(model, scenes: Sequence[np.ndarray],
                   nominal=NOMINAL_SHIFTS_4, factor: int = 2,
                   psf=None, noise_sigma: float = 2.0,
                   jitter_sigma: float = 0.05, n_iter: int = 80,
                   shave: int = 12, seed: int = 1234,
                   classical: bool = True, refine: int = 0,
                   refine_step: float = 2.0,
                   register=register_burst, device=None) -> dict:
    """Head-to-head burst-SR evaluation on held-out scenes.

    Each scene is the HR ground truth; its burst is simulated with true
    shifts = nominal + jitter and read noise, then every engine gets only
    the nominal shifts.  Returns mean PSNR and SSIM (border-shaved) for
    bicubic LR-mean upsample / SAA / IBP / fusion (+ ``fusionref`` when
    ``refine > 0``: the fusion output after that many data-consistency
    iterations).  ``model`` (or None: classical engines only) runs on its
    own device; ``device`` is where the rest runs (default: the model's,
    else cuda).
    """
    from ..sr.classical import make_gaussian_psf

    if device is None:
        device = (next(model.parameters()).device if model is not None
                  else resolve_device("cuda"))
    if psf is None:
        psf = make_gaussian_psf()
    psf = np.asarray(psf, np.float32)
    nom = torch.as_tensor(np.asarray(nominal, np.float32), device=device)
    sums: dict = {}
    for k, scene in enumerate(scenes):
        hr_true = torch.as_tensor(np.asarray(scene, np.float32),
                                  device=device)
        if hr_true.dim() == 3:
            hr_true = hr_true.mean(-1)
        h, w = hr_true.shape
        hr_true = hr_true[: h - h % factor, : w - w % factor]
        gen = generator(device, seed, k)
        true = nom + jitter_sigma * torch.randn(nom.shape, generator=gen,
                                                device=device)
        noise = torch.randn((len(nom),) + tuple(
            s // factor for s in hr_true.shape), generator=gen,
            device=device)
        scene_out = eval_scene(model, hr_true, true, noise, nominal, factor,
                               psf, noise_sigma, n_iter, shave, classical,
                               refine, refine_step, register)
        for name, v in scene_out.items():
            sums.setdefault(name, []).append(float(v))
    out = {k: float(np.mean(v)) for k, v in sums.items()}
    out.update(noise_sigma=noise_sigma, jitter_sigma=jitter_sigma,
               n_scenes=len(scenes))
    return out


def _tile_pool(images, tile: int):
    """Cut HWC images into non-overlapping ``tile`` x ``tile`` patches --
    turns a handful of large in-domain images (e.g. a session's own HR
    reconstructions) into a uniform training pool."""
    tiles = []
    for img in images:
        h, w = img.shape[:2]
        for y in range(0, h - tile + 1, tile):
            for x in range(0, w - tile + 1, tile):
                tiles.append(np.ascontiguousarray(
                    img[y:y + tile, x:x + tile]))
    if not tiles:
        raise ValueError(f"no {tile}x{tile} tiles fit the given images")
    return tiles


def _build_model(name: str, frames: int, factor: int, n_feats: int,
                 n_resblocks: int, device, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None):
    from ..models import create_model

    kw = {"factor": factor} if name == "burstfusion_lr" else {}
    return create_model(name, n_frames=frames, n_feats=n_feats,
                        n_resblocks=n_resblocks, dtype=dtype, device=device,
                        generator=gen, **kw)


def _ema_model(state):
    """A copy of the state's model holding its EMA weights."""
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return model.requires_grad_(False)


def _pool(cfg_pool: str, pool_images: int, seed: int, lr_patch: int,
          factor: int, data_dir: Optional[str], tile: Optional[int],
          margin_lr: int = 6):
    """The run's scene pool: tiles of ``data_dir``'s images, or a
    procedural pool; identical arrays to the JAX package's for the same
    settings."""
    from .data import POOL_KINDS, image_pool_from_dir

    if data_dir:
        pool = _tile_pool(image_pool_from_dir(data_dir, channels=1), tile)
        np.random.default_rng(seed).shuffle(pool)
        return pool[:pool_images]
    size = max(lr_patch * factor + 32, 192)
    return POOL_KINDS[cfg_pool](n_images=pool_images, channels=1, seed=seed,
                                size=size)


def train_burst(steps: int = 20000, batch: int = 16, lr_patch: int = 24,
                frames: int = 4, factor: int = 2, n_feats: int = 48,
                n_resblocks: int = 6, noise: float = 2.0,
                jitter: float = 0.05, learning_rate: float = 1e-4,
                loss: str = "l1", out_dir: str = "burst_run",
                pool_kind: str = "synthetic", pool_images: int = 64,
                seed: int = 0, eval_every: int = 2000,
                ckpt_every: int = 1000, resume: bool = True,
                margin_lr: int = 6, data_dir: Optional[str] = None,
                tile: int = 128, arch: str = "hr",
                device="cuda") -> dict:
    """Train BurstFusion (``arch='hr'``) or BurstFusionLR (``'lr'``) on
    simulated bursts on ``device``; returns the final eval metrics.

    ``data_dir`` switches the scene pool from procedural scenes to tiles
    cut from real images in that directory (field adaptation).  Writes
    ``config.json``, ``metrics.jsonl``, ``eval.jsonl``,
    ``final_eval.json`` (the JAX package's keys) and ``ckpt/<step>/state.pt``
    (the newest two) under ``out_dir``; ``resume`` continues from the
    newest checkpoint.
    """
    from ..sr.classical import make_gaussian_psf
    from .state import (TrainConfig, TrainState, latest_step,
                        load_checkpoint, make_train_step, save_checkpoint)

    device = resolve_device(device) if isinstance(device, str) else device
    if frames != len(NOMINAL_SHIFTS_4):
        raise ValueError("v1 supports the 4-corner pattern; got "
                         f"frames={frames}")
    if data_dir:
        tile = max(tile, (lr_patch + 2 * margin_lr) * factor)
    pool = _pool(pool_kind, pool_images, seed, lr_patch, factor, data_dir,
                 tile)
    if data_dir and len(pool) < 3:
        raise ValueError(
            f"{data_dir} yields only {len(pool)} {tile}x{tile} tile(s) "
            f"(pool_images={pool_images}); need >= 3 so an eval split "
            "leaves training scenes")
    os.makedirs(out_dir, exist_ok=True)
    n_eval = max(2, len(pool) // 8)
    eval_pool, train_pool = pool[:n_eval], pool[n_eval:]
    pool_arr = torch.as_tensor(np.stack([p[..., 0] for p in train_pool]),
                               device=device)

    model_name = ARCHS[arch]
    register = REGISTER_FNS[model_name]
    psf = make_gaussian_psf()
    gen = BurstGen(NOMINAL_SHIFTS_4, factor, psf, noise, jitter,
                   margin_lr=margin_lr, model_name=model_name)
    hp = (lr_patch + 2 * margin_lr) * factor  # padded HR patch side
    model = _build_model(model_name, frames, factor, n_feats, n_resblocks,
                         device, gen=torch.Generator().manual_seed(seed))
    cfg = TrainConfig(learning_rate=learning_rate, loss=loss,
                      lr_halve_every=max(steps // 2, 1))
    state = TrainState.create(model, cfg)
    step_fn = make_train_step(cfg)

    ckpt_dir = os.path.abspath(os.path.join(out_dir, "ckpt"))
    if not resume:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    start_step = 0
    latest = latest_step(ckpt_dir)
    if resume and latest is not None:
        state.load_state_dict(load_checkpoint(ckpt_dir, latest))
        start_step = state.step
        print(f"resumed from step {start_step}")

    run_cfg = dict(model=model_name, frames=frames, factor=factor,
                   n_feats=n_feats, n_resblocks=n_resblocks, noise=noise,
                   jitter=jitter, lr_patch=lr_patch, batch=batch,
                   steps=steps, pool=pool_kind, pool_images=pool_images,
                   data_dir=data_dir, tile=(tile if data_dir else None),
                   loss=loss, learning_rate=learning_rate, seed=seed)
    with open(os.path.join(out_dir, "config.json"), "w") as fp:
        json.dump(run_cfg, fp, indent=2)

    def evaluate(classical: bool) -> dict:
        return evaluate_burst(_ema_model(state), eval_pool, factor=factor,
                              psf=psf, noise_sigma=noise,
                              jitter_sigma=jitter, classical=classical,
                              register=register)

    log_every = 50
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as mfp:
        for it in range(start_step + 1, steps + 1):
            g = generator(device, seed, 17, it)
            hr = _crop_hr_batch(pool_arr, g, hp, batch)
            stack, tgt = gen(hr, g)
            metrics = step_fn(state, stack, tgt)
            if it % log_every == 0 or it == 1 or it == steps:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=it, wall_s=time.perf_counter() - t0,
                           rss_mb=rss_mb())
                mfp.write(json.dumps(rec) + "\n")
                mfp.flush()
                print(f"step {it}/{steps} " +
                      " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                               if k != "step"))
            if it % ckpt_every == 0 or it == steps:
                save_checkpoint(ckpt_dir, state.state_dict())
            if it % eval_every == 0 or it == steps:
                ev = evaluate(classical=(it == steps))
                ev["step"] = it
                print("  eval: " + " ".join(
                    f"{k}={v:.3f}" for k, v in ev.items()
                    if k.startswith("psnr")))
                with open(os.path.join(out_dir, "eval.jsonl"), "a") as efp:
                    efp.write(json.dumps(ev) + "\n")

    final = evaluate(classical=True)
    final["steps"] = steps
    with open(os.path.join(out_dir, "final_eval.json"), "w") as fp:
        json.dump(final, fp, indent=2)
    return final


def load_burst_run(run_dir: str, dtype=None, device="cuda"):
    """Restore a trained burst run -> ``(model, config)``: the run's model
    on ``device`` holding the EMA weights of its newest checkpoint, in
    inference mode (no gradients), with compute ``dtype`` (default float32;
    ``torch.bfloat16`` runs the trunk's convs in bfloat16, the weights stay
    float32)."""
    from .state import load_checkpoint

    device = resolve_device(device) if isinstance(device, str) else device
    with open(os.path.join(run_dir, "config.json")) as fp:
        cfg = json.load(fp)
    model = _build_model(cfg.get("model", "burstfusion"), cfg["frames"],
                         cfg["factor"], cfg["n_feats"], cfg["n_resblocks"],
                         device, dtype=dtype or torch.float32)
    state = load_checkpoint(os.path.join(run_dir, "ckpt"),
                            map_location=device)
    model.load_state_dict(state["ema_params"], strict=True)
    return model.eval().requires_grad_(False), cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr-patch", type=int, default=24)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--arch", default="hr", choices=sorted(ARCHS),
                   help="hr = BurstFusion (trunk on the registered HR "
                        "grid); lr = BurstFusionLR (polyphase registration, "
                        "trunk on the LR grid; defaults --n-feats/"
                        "--n-resblocks to 64/8)")
    p.add_argument("--n-feats", type=int, default=None,
                   help="trunk width (default 48 for --arch hr, 64 for lr)")
    p.add_argument("--n-resblocks", type=int, default=None,
                   help="trunk depth (default 6 for --arch hr, 8 for lr)")
    p.add_argument("--noise", type=float, default=2.0,
                   help="sensor read-noise sigma (8-bit counts)")
    p.add_argument("--jitter", type=float, default=0.05,
                   help="shift-calibration error sigma (LR px)")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--loss", default="l1",
                   choices=["l1", "l2", "charbonnier"])
    p.add_argument("--out", default="burst_run")
    p.add_argument("--pool", default=None,
                   choices=["synthetic", "natural", "edges"],
                   help="scene pool (training default: synthetic; "
                        "--eval-only default: the run's recorded pool)")
    p.add_argument("--pool-images", type=int, default=None,
                   help="pool size (training default 64; --eval-only "
                        "default: the run's recorded value)")
    p.add_argument("--data-dir", default=None,
                   help="train on tiles cut from real images in this dir "
                        "instead of a procedural pool")
    p.add_argument("--tile", type=int, default=None,
                   help="tile side for --data-dir pools (training default "
                        "128, --eval-only default: the run's recorded "
                        "tile)")
    p.add_argument("--seed", type=int, default=None,
                   help="(training default 0; --eval-only default: the "
                        "run's recorded seed -- the split depends on it)")
    p.add_argument("--eval-every", type=int, default=2000)
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: evaluate the run in --out against "
                        "bicubic/SAA/IBP at --noise/--jitter")
    p.add_argument("--eval-iters", type=int, default=80,
                   help="IBP iterations in the classical comparison")
    p.add_argument("--refine", type=int, default=0,
                   help="with --eval-only: also score the fusion output "
                        "after N data-consistency Landweber iterations")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where training runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    if args.eval_only:
        model, cfg = load_burst_run(args.out, device=device)
        # score the run on its own held-out split: every pool-shaping knob
        # defaults to the run's recorded config; explicit flags override
        data_dir = args.data_dir or cfg.get("data_dir")
        pool = _pool(args.pool or cfg.get("pool", "synthetic"),
                     args.pool_images if args.pool_images is not None
                     else int(cfg.get("pool_images", 64)),
                     args.seed if args.seed is not None
                     else int(cfg.get("seed", 0)),
                     int(cfg.get("lr_patch", 24)), int(cfg.get("factor", 2)),
                     data_dir, args.tile if args.tile is not None
                     else int(cfg.get("tile") or 128))
        n_eval = max(2, len(pool) // 8)
        out = evaluate_burst(model, pool[:n_eval], factor=cfg["factor"],
                             noise_sigma=args.noise,
                             jitter_sigma=args.jitter,
                             n_iter=args.eval_iters, refine=args.refine,
                             register=REGISTER_FNS[
                                 cfg.get("model", "burstfusion")])
        print(json.dumps(out))
        return 0

    n_feats = args.n_feats if args.n_feats is not None else (
        64 if args.arch == "lr" else 48)
    n_resblocks = args.n_resblocks if args.n_resblocks is not None else (
        8 if args.arch == "lr" else 6)
    final = train_burst(steps=args.steps, batch=args.batch,
                        lr_patch=args.lr_patch, frames=args.frames,
                        factor=args.factor, n_feats=n_feats,
                        n_resblocks=n_resblocks, noise=args.noise,
                        jitter=args.jitter,
                        learning_rate=args.learning_rate, loss=args.loss,
                        out_dir=args.out,
                        pool_kind=args.pool or "synthetic",
                        pool_images=(64 if args.pool_images is None
                                     else args.pool_images),
                        seed=0 if args.seed is None else args.seed,
                        eval_every=args.eval_every,
                        ckpt_every=args.ckpt_every,
                        resume=not args.no_resume,
                        data_dir=args.data_dir,
                        tile=(128 if args.tile is None else args.tile),
                        arch=args.arch, device=device)
    print(json.dumps(final))
    return 0


if __name__ == "__main__":
    sys.exit(main())
