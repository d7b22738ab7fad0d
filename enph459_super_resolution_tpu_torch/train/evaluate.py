"""Standalone neural-SR evaluation CLI.

Counterpart of ``enph459_super_resolution_tpu/train/evaluate.py``.
Restores a checkpoint written by ``train.loop`` and reports PSNR/SSIM (Y
channel, border shave = scale: the Set5/Set14 protocol) against the
bicubic baseline over a directory of HR images (or a procedural pool when
no directory is given), on CUDA unless ``--device cpu`` is given.

  python -m enph459_super_resolution_tpu_torch.train.evaluate \\
      --run runs/espcn [--data-dir Set5] [--raw] [--tiled] \\
      [--interp-run runs/gan --alpha 0.8]

``--model``, ``--scale``, ``--channels`` and the model's kwargs default to
the run's ``config.json`` (with the ``scan_trunk=True`` a pp mesh run
records, or an ``edsr_moe`` run's expert count); explicit flags override.
A meshed run's checkpoint holds whole tensors and evaluates on one
device.  ``--interp-run``
evaluates the ESRGAN *network interpolation* (Wang et al. 2018 §3.4):
blend the PSNR-oriented pretrain (``--run``) with the adversarial
fine-tune (``--interp-run``) in parameter space, theta = (1 - alpha) *
theta_PSNR + alpha * theta_GAN.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..device import DEVICES, resolve_device


def load_run_weights(run_dir, raw=False, device="cpu"):
    """``(weights, step)`` of a ``train.loop`` run's newest checkpoint: the
    EMA weights (``raw``: the trained parameters), of the generator for a
    GAN run (its state under ``"g"``), as a state dict on ``device``."""
    from .state import load_checkpoint

    tree = load_checkpoint(os.path.join(run_dir, "ckpt"),
                           map_location=device)
    step = int(tree["step"])
    tree = tree.get("g", tree)
    return (tree["params"] if raw else tree["ema_params"]), step


def interpolate_weights(psnr_weights, gan_weights, alpha):
    """ESRGAN network interpolation: (1 - alpha) * theta_PSNR + alpha *
    theta_GAN, tensor by tensor."""
    if set(psnr_weights) != set(gan_weights):
        raise ValueError("the two runs' models differ in their parameters")
    a = float(alpha)
    return {k: (1.0 - a) * psnr_weights[k] + a * gan_weights[k]
            for k in psnr_weights}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default=None,
                   choices=["srcnn", "espcn", "fsrcnn", "edsr", "edsr_moe",
                            "rrdbnet"],
                   help="(default: the run's recorded model, else edsr)")
    p.add_argument("--scale", type=int, default=None,
                   help="(default: the run's recorded scale, else 4)")
    p.add_argument("--channels", type=int, default=None,
                   help="(default: the run's recorded channels, else 3)")
    p.add_argument("--run", required=True,
                   help="training output dir containing ckpt/")
    p.add_argument("--data-dir", default=None,
                   help="directory of HR evaluation images")
    p.add_argument("--raw", action="store_true",
                   help="evaluate raw params instead of EMA weights")
    p.add_argument("--tiled", action="store_true",
                   help="use exact tiled inference (large images)")
    p.add_argument("--model-kwargs", default=None,
                   help="JSON dict of extra model constructor kwargs -- must "
                        "match the training run (e.g. '{\"nb\": 8}')")
    p.add_argument("--interp-run", default=None,
                   help="GAN fine-tune run dir: evaluate the ESRGAN network "
                        "interpolation (1-alpha)*run + alpha*interp-run")
    p.add_argument("--alpha", type=float, default=0.8,
                   help="interpolation weight on --interp-run (ESRGAN paper "
                        "default 0.8)")
    p.add_argument("--pool", default="synthetic",
                   choices=["synthetic", "natural", "edges"],
                   help="procedural eval pool when no --data-dir is given "
                        "(match the training run's --pool)")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where evaluation runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    from ..models import create_model
    from .data import POOL_KINDS, evaluate_sr, image_pool_from_dir
    from .loop import pre_upsample

    run_cfg = {}
    run_cfg_path = os.path.join(args.run, "config.json")
    if os.path.exists(run_cfg_path):
        with open(run_cfg_path) as fp:
            run_cfg = json.load(fp)
    args.model = args.model or run_cfg.get("model", "edsr")
    args.scale = (args.scale if args.scale is not None
                  else int(run_cfg.get("scale", 4)))
    args.channels = (args.channels if args.channels is not None
                     else int(run_cfg.get("channels", 3)))
    kwargs = {"channels": args.channels}
    if args.model != "srcnn":
        kwargs["scale"] = args.scale
    recorded = dict(run_cfg.get("model_kwargs") or {})
    # channels/scale were resolved above (explicit flag > run config)
    recorded.pop("channels", None)
    recorded.pop("scale", None)
    kwargs.update(recorded)
    if args.model_kwargs:
        kwargs.update(json.loads(args.model_kwargs))
    model = create_model(args.model, device=device, **kwargs)

    make_pool = POOL_KINDS[args.pool]
    pool = (image_pool_from_dir(args.data_dir, channels=args.channels)
            if args.data_dir else
            make_pool(n_images=8, channels=args.channels))

    try:
        weights, step = load_run_weights(args.run, raw=args.raw,
                                         device=device)
        if args.interp_run:
            gan_weights, _ = load_run_weights(args.interp_run, raw=args.raw,
                                              device=device)
            weights = interpolate_weights(weights, gan_weights, args.alpha)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    model.load_state_dict(weights, strict=True)
    model.eval().requires_grad_(False)

    prep = pre_upsample(args.model, args.scale)
    if args.tiled:
        from ..models.infer import tiled_infer

        # SRCNN runs at HR resolution on a bicubic pre-upsample: tile the
        # scale-1 trunk over the upsampled image
        scale = 1 if args.model == "srcnn" else None

        def run(lr):
            return torch.as_tensor(tiled_infer(
                model, prep(lr).cpu().numpy(), scale=scale), device=device)
    else:
        def run(lr):
            return model(prep(lr))

    metrics = evaluate_sr(run, pool, args.scale, device=device)
    metrics.update(step=int(step), model=args.model, scale=args.scale,
                   weights="raw" if args.raw else "ema")
    if args.interp_run:
        metrics.update(alpha=args.alpha, interp_run=args.interp_run)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
