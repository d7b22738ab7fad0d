"""The training loop: train steps, periodic eval, checkpoint/resume.

Counterpart of ``enph459_super_resolution_tpu/train/loop.py``.

CLI:
  python -m enph459_super_resolution_tpu_torch.train.loop --model edsr \\
      --scale 4 --steps 2000 --out runs/edsr [--data-dir DIV2K_train_HR] \\
      [--gan]

Covers the BASELINE.json training configs (SRCNN / ESPCN / FSRCNN / EDSR /
ESRGAN fine-tune) on one device: CUDA unless ``--device cpu`` is given (no
fallback).  A run directory holds ``config.json`` (the JAX package's
keys), ``metrics.jsonl`` (every 50 steps and the first and last),
``eval.jsonl``, ``final_eval.json`` (the EMA weights scored by
:func:`~.data.evaluate_sr`) and ``ckpt/<step>/state.pt`` (the newest two;
a GAN run's generator under ``"g"``).  The port reads no orbax run.

Each step runs eagerly; ``--steps-per-dispatch k`` keeps the JAX
package's boundary cadence (a chunk of k steps never crosses a log,
checkpoint or eval boundary, and metrics are logged at chunk ends), and its
k steps run one after another, so the trajectory is the k = 1 one.  The
random streams (flips, rotations, the device sampler's crops, the
instance noise) differ from JAX's for the same seed; the host sampler's
crops are JAX's.  ``--mesh`` (dp/sp/tp/pp/ep meshes) and ``--model
edsr_moe`` come with ``parallel/`` (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import time
from typing import Optional

import torch

from ..device import DEVICES, resolve_device
from ..utils.timing import rss_mb

LOG_EVERY = 50  # metrics.jsonl cadence; chunk_size aligns to it
PARALLEL_LATER = "comes with parallel/ (ROADMAP Queue 1 item 9)"


def _ema_model(model: torch.nn.Module, ema_params) -> torch.nn.Module:
    """A copy of ``model`` holding the EMA weights, for inference."""
    out = copy.deepcopy(model)
    out.load_state_dict(ema_params, strict=True)
    return out.eval().requires_grad_(False)


def pre_upsample(model_name: str, scale: int):
    """``fn(lr)``: the LR batch as the model takes it (SRCNN runs on the
    bicubic pre-upsample, the others on the LR grid)."""
    if model_name != "srcnn":
        return lambda lr: lr
    from ..ops.resize import bicubic_upsample
    return lambda lr: bicubic_upsample(lr, scale)


def train(model_name: str = "edsr", scale: int = 4, steps: int = 1000,
          batch: int = 16, lr_patch: int = 48, learning_rate: float = 1e-4,
          loss: str = "l1", out_dir: str = "sr_train",
          data_dir: Optional[str] = None, eval_every: int = 500,
          ckpt_every: int = 500, channels: int = 3, dp: bool = True,
          gan: bool = False, seed: int = 0, resume: bool = True,
          model_kwargs: Optional[dict] = None,
          pool_images: int = 32, pool_kind: str = "synthetic",
          vgg_weights: Optional[str] = None,
          init_from: Optional[str] = None,
          steps_per_dispatch: int = 1,
          gan_weight: float = 5e-3,
          d_lr_scale: float = 1.0,
          d_every: int = 1,
          instance_noise: float = 0.0,
          mesh_spec: Optional[str] = None,
          device="cuda") -> dict:
    """Train a zoo model on ``device``; returns the final eval metrics.

    The JAX package's signature: ``dp`` (data parallelism over every
    visible device there) is accepted and the port trains on one device;
    ``mesh_spec`` raises, as meshes come with ``parallel/``.  ``gan``
    fine-tunes ESRGAN-style against a ``VGGStyleDiscriminator(nf=32)``
    (:func:`~.state.make_gan_train_step`; the perceptual term is VGG19
    conv5_4 with ``vgg_weights``, else the weight-free gradient features);
    ``init_from`` warm-starts the generator's parameters and EMA from
    another run's newest checkpoint with a fresh optimizer (the ESRGAN
    recipe: L1 pretrain, then the GAN fine-tune).  ``resume`` continues
    from this run's newest checkpoint; the balance knobs follow the
    arguments, not the checkpoint.
    """
    from ..models import VGGStyleDiscriminator, create_model
    from .data import (POOL_KINDS, PatchConfig, evaluate_sr,
                       image_pool_from_dir, make_patch_sampler)
    from .losses import PerceptualLoss
    from .state import (GANBalance, GANTrainState, TrainConfig, TrainState,
                        latest_step, load_checkpoint, make_gan_train_step,
                        make_optimizer, make_train_step, save_checkpoint)

    if mesh_spec:
        raise ValueError(f"--mesh {mesh_spec!r}: device meshes "
                         f"{PARALLEL_LATER}")
    if model_name == "edsr_moe":
        raise ValueError(f"model edsr_moe {PARALLEL_LATER}")
    device = resolve_device(device) if isinstance(device, str) else device
    os.makedirs(out_dir, exist_ok=True)

    kwargs = dict(model_kwargs or {})
    init = dict(device=device, generator=torch.Generator().manual_seed(seed))
    if model_name == "srcnn":
        kwargs.setdefault("channels", channels)
        model = create_model(model_name, **kwargs, **init)
    else:
        model = create_model(model_name, scale=scale, channels=channels,
                             **kwargs, **init)
    prep = pre_upsample(model_name, scale)

    make_pool = POOL_KINDS[pool_kind]
    pool = (image_pool_from_dir(data_dir, channels=channels) if data_dir
            else make_pool(n_images=pool_images,
                           channels=channels, seed=seed,
                           size=max(lr_patch * scale + 16, 192)))
    n_eval = max(2, len(pool) // 8)
    eval_pool, train_pool = pool[:n_eval], pool[n_eval:]

    cfg = TrainConfig(learning_rate=learning_rate, loss=loss,
                      lr_halve_every=max(steps // 2, 1))
    ckpt_dir = os.path.abspath(os.path.join(out_dir, "ckpt"))
    if not resume:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir, exist_ok=True)

    init_ema = None
    if init_from:
        src_dir = os.path.join(init_from, "ckpt")
        src = load_checkpoint(src_dir, map_location=device)
        src = src.get("g", src)
        model.load_state_dict(src["params"], strict=True)
        init_ema = src["ema_params"]
        print(f"initialized generator from {init_from} "
              f"step {latest_step(src_dir)}")

    g_state = TrainState.create(model, cfg)
    if init_ema is not None:
        g_state.ema_params = {n: e.to(device, copy=True)
                              for n, e in init_ema.items()}
    if gan:
        disc = VGGStyleDiscriminator(
            nf=32, channels=channels, device=device,
            generator=torch.Generator().manual_seed(seed + 1))
        feat_fn = None  # default: weight-free gradient features
        if vgg_weights:
            # paper-exact ESRGAN perceptual term (pre-activation conv5_4)
            from .vgg import load_torch_vgg19, make_vgg_feature_fn
            feat_fn = make_vgg_feature_fn(load_torch_vgg19(vgg_weights),
                                          device=device)
        balance = GANBalance(gan_weight=gan_weight, d_lr_scale=d_lr_scale,
                             d_every=d_every, instance_noise=instance_noise)
        state = GANTrainState(g_state, disc,
                              make_optimizer(cfg, disc.parameters()),
                              balance)
        step_fn = make_gan_train_step(cfg,
                                      percep_loss=PerceptualLoss(feat_fn),
                                      noise_seed=seed + 2)
    else:
        state = g_state
        step_fn = make_train_step(cfg)

    start_step = 0
    latest = latest_step(ckpt_dir)
    if resume and latest is not None:
        state.load_state_dict(load_checkpoint(ckpt_dir, latest,
                                              map_location=device))
        start_step = state.step
        if gan:
            # balance knobs follow the CLI, not the checkpoint: a resumed
            # run may be resumed precisely to retune them
            state.balance = balance
        print(f"resumed from step {start_step}")

    sampler = make_patch_sampler(train_pool,
                                 PatchConfig(scale=scale, lr_patch=lr_patch,
                                             batch=batch),
                                 seed=seed, device=device, start=start_step)

    def chunk_size(done: int) -> int:
        """Steps in the next chunk: the full k unless a log/checkpoint/eval
        boundary (or the end) lands inside it."""
        nxt = min(((done // m) + 1) * m
                  for m in (LOG_EVERY, ckpt_every, eval_every))
        return max(1, min(steps_per_dispatch, steps - done, nxt - done))

    def evaluate() -> dict:
        g = state.g if gan else state
        ema = _ema_model(g.model, g.ema_params)
        return evaluate_sr(lambda lr: ema(prep(lr)), eval_pool, scale,
                           device=device)

    with open(os.path.join(out_dir, "config.json"), "w") as fp:
        json.dump(dict(model=model_name, scale=scale, channels=channels,
                       model_kwargs=kwargs, steps=steps, batch=batch,
                       lr_patch=lr_patch, learning_rate=learning_rate,
                       loss=loss, pool=pool_kind, pool_images=pool_images,
                       data_dir=data_dir, seed=seed, mesh=mesh_spec,
                       gan=gan), fp, indent=2)

    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as mfp:
        it = start_step
        first = True
        while it < steps:
            k_eff = chunk_size(it)
            for _ in range(k_eff):
                lr_b, hr_b = next(sampler)
                metrics = step_fn(state, prep(lr_b), hr_b)
            it += k_eff
            if it % LOG_EVERY == 0 or first or it == steps:
                first = False
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
                ev = evaluate()
                ev["step"] = it
                print(f"  eval: psnr={ev['psnr']:.3f} ssim={ev['ssim']:.4f} "
                      f"(bicubic {ev['bicubic_psnr']:.3f})")
                with open(os.path.join(out_dir, "eval.jsonl"), "a") as efp:
                    efp.write(json.dumps(ev) + "\n")

    final = evaluate()
    final["steps"] = steps
    with open(os.path.join(out_dir, "final_eval.json"), "w") as fp:
        json.dump(final, fp, indent=2)
    return final


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="edsr",
                   choices=["srcnn", "espcn", "fsrcnn", "edsr", "edsr_moe",
                            "rrdbnet"])
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr-patch", type=int, default=48)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--loss", default="l1",
                   choices=["l1", "l2", "charbonnier"])
    p.add_argument("--out", default="sr_train")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--gan", action="store_true",
                   help="ESRGAN-style adversarial fine-tune")
    p.add_argument("--gan-weight", type=float, default=5e-3,
                   help="weight on the RaGAN generator term; 0 = "
                        "perceptual-only ablation (the D still trains but "
                        "contributes no gradient to G)")
    p.add_argument("--d-lr-scale", type=float, default=1.0,
                   help="discriminator learning rate = --learning-rate x "
                        "this (lower it when d_loss saturates to ~0)")
    p.add_argument("--d-every", type=int, default=1,
                   help="update the discriminator only every N steps")
    p.add_argument("--instance-noise", type=float, default=0.0,
                   help="sigma (pixel counts, 0..255 scale) of Gaussian "
                        "noise on D inputs")
    p.add_argument("--vgg-weights", default=None,
                   help="torchvision vgg19 .pth: use the paper-exact "
                        "pre-activation conv5_4 perceptual loss (default: "
                        "weight-free gradient features)")
    p.add_argument("--pool-images", type=int, default=32,
                   help="synthetic-pool size when no --data-dir is given")
    p.add_argument("--pool", default="synthetic",
                   choices=["synthetic", "natural", "edges"],
                   help="procedural pool when no --data-dir is given")
    p.add_argument("--model-kwargs", default=None,
                   help='JSON dict of extra model constructor kwargs, e.g. '
                        '\'{"nb": 8}\' for a smaller RRDBNet or '
                        '\'{"n_resblocks": 8, "n_feats": 32}\' for '
                        'EDSR-small')
    p.add_argument("--init-from", default=None,
                   help="warm-start the (generator) params/EMA from another "
                        "run dir's latest checkpoint (ESRGAN recipe: L1 "
                        "pretrain, then --gan fine-tune --init-from it)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="steps per chunk between log/ckpt/eval boundaries "
                        "(the JAX package's cadence; the steps run one "
                        "after another)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help=f"device mesh: {PARALLEL_LATER}")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where training runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    if args.mesh:
        p.error(f"--mesh {args.mesh}: device meshes {PARALLEL_LATER}")
    if args.model == "edsr_moe":
        p.error(f"--model edsr_moe {PARALLEL_LATER}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    final = train(model_name=args.model, scale=args.scale, steps=args.steps,
                  batch=args.batch, lr_patch=args.lr_patch,
                  learning_rate=args.learning_rate, loss=args.loss,
                  out_dir=args.out, data_dir=args.data_dir,
                  channels=args.channels, gan=args.gan,
                  resume=not args.no_resume, pool_images=args.pool_images,
                  pool_kind=args.pool,
                  vgg_weights=args.vgg_weights, init_from=args.init_from,
                  model_kwargs=(json.loads(args.model_kwargs)
                                if args.model_kwargs else None),
                  steps_per_dispatch=args.steps_per_dispatch,
                  gan_weight=args.gan_weight, d_lr_scale=args.d_lr_scale,
                  d_every=args.d_every, instance_noise=args.instance_noise,
                  device=device)
    print(json.dumps(final))
    return 0


if __name__ == "__main__":
    sys.exit(main())
