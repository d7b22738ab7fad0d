"""Train state: parameters + optimizer + EMA, the train step, checkpoints.

Counterpart of the non-GAN part of
``enph459_super_resolution_tpu/train/state.py``.  The reference carries an
immutable pytree through a jitted step; here a :class:`TrainState` holds
the model (its parameters are the trained ones), a ``torch.optim`` Adam or
AdamW (its state is optax's ``opt_state``), an EMA copy of the parameters
and the step count, and the step updates it in place.

optax's pieces map so:

* ``optax.adam`` / ``adamw`` -> ``torch.optim.Adam`` / ``AdamW`` with
  optax's defaults (b1 0.9, b2 0.999, eps 1e-8; AdamW's decay ``lr * wd *
  p`` is optax's decoupled ``wd * p`` scaled by ``lr``);
* ``exponential_decay(lr0, lr_halve_every, 0.5, staircase=True)`` -> the
  rate ``lr0 * 0.5 ** (count // lr_halve_every)`` set before each update,
  ``count`` being the updates done before it (optax's schedule count; a
  ``StepLR`` stepped after the update would halve one step late);
* ``clip_by_global_norm`` -> ``clip_grad_norm_`` (which adds 1e-6 to the
  norm it divides by);
* ``optax.global_norm`` of the gradients -> the same square root of the
  sum of squares, reported before clipping.

Checkpoints are the port's own: ``<ckpt_dir>/<step>/state.pt`` written by
``torch.save`` (tensors and plain containers only), read with
``torch.load(weights_only=True)``; the newest two are kept.  The GAN step
(``GANBalance``, ``GANTrainState``, ``make_gan_train_step``) comes with the
``train.loop`` slice.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .losses import PIXEL_LOSSES, psnr

CKPT_FILE = "state.pt"
CKPT_KEEP = 2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    loss: str = "l1"
    ema_decay: float = 0.999
    grad_clip: Optional[float] = None
    lr_halve_every: Optional[int] = None  # EDSR-style step decay
    weight_decay: float = 0.0


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """optax's ``adam`` (or ``adamw`` with ``weight_decay``) over
    ``params``; the rate is set per step by :func:`learning_rate`."""
    kw = dict(lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if cfg.weight_decay:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """The rate of the update that follows ``count`` earlier ones."""
    if cfg.lr_halve_every:
        return cfg.learning_rate * 0.5 ** (count // cfg.lr_halve_every)
    return cfg.learning_rate


class TrainState:
    """``step``, ``model`` (whose parameters train), ``optimizer`` (its
    state is the optimizer state) and ``ema_params`` (name -> tensor, an
    EMA of the parameters, starting as a copy)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema_params: Optional[Dict[str, torch.Tensor]] = None,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.ema_params = ema_params if ema_params is not None else {
            n: p.detach().clone() for n, p in model.named_parameters()}
        self.step = int(step)

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig) -> "TrainState":
        return cls(model, make_optimizer(cfg, model.parameters()))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> Dict:
        """Everything a checkpoint holds, as tensors and plain containers
        (what ``torch.load(weights_only=True)`` reads back)."""
        return {"step": self.step,
                "params": {n: p.detach().clone()
                           for n, p in self.model.named_parameters()},
                "opt_state": self.optimizer.state_dict(),
                "ema_params": {n: e.clone()
                               for n, e in self.ema_params.items()}}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s contents onto this state's device
        (an ``opt_state`` of None leaves the optimizer fresh)."""
        self.model.load_state_dict(state["params"], strict=True)
        if state.get("opt_state") is not None:
            self.optimizer.load_state_dict(state["opt_state"])
        device = next(self.model.parameters()).device
        self.ema_params = {n: e.to(device, copy=True)
                           for n, e in state["ema_params"].items()}
        self.step = int(state["step"])


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * params``, in place (one
    multi-tensor op each for the product and the sum)."""
    names = list(ema)
    targets = [ema[n] for n in names]
    torch._foreach_mul_(targets, decay)
    torch._foreach_add_(targets, [params[n].detach() for n in names],
                        alpha=1.0 - decay)


def global_norm(tensors) -> torch.Tensor:
    """optax's ``global_norm``: the square root of the sum of squares."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


def make_train_step(cfg: TrainConfig,
                    extra_loss: Optional[Callable] = None):
    """Build ``step(state, lr_batch, hr_batch) -> metrics``: one update of
    ``state`` in place, returning ``loss``, ``psnr`` and ``grad_norm`` (the
    gradients' global norm before clipping) as 0-d tensors on the state's
    device.  ``extra_loss(sr, hr) -> scalar`` is an optional additive term
    (e.g. perceptual)."""
    pixel_loss = PIXEL_LOSSES[cfg.loss]

    def step(state: TrainState, lr, hr) -> Dict[str, torch.Tensor]:
        params = [p for p in state.model.parameters()]
        for group in state.optimizer.param_groups:
            group["lr"] = learning_rate(cfg, state.step)
        state.optimizer.zero_grad(set_to_none=False)
        sr = state.model(lr)
        loss = pixel_loss(sr, hr)
        if extra_loss is not None:
            loss = loss + extra_loss(sr, hr)
        loss.backward()
        grads = [p.grad for p in params]
        gnorm = global_norm([g.detach() for g in grads])
        if cfg.grad_clip:
            torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip)
        state.optimizer.step()
        ema_update(state.ema_params, state.params, cfg.ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "psnr": psnr(sr.detach(), hr),
                "grad_norm": gnorm}

    return step


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def checkpoint_steps(ckpt_dir: str):
    """The steps with a complete checkpoint under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, d, CKPT_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state_dict: Dict,
                    keep: int = CKPT_KEEP) -> str:
    """Write ``<ckpt_dir>/<step>/state.pt`` (through a temporary file, so a
    cut-off write leaves no checkpoint) and delete all but the newest
    ``keep``.  Returns the file's path."""
    step = int(state_dict["step"])
    out = os.path.join(ckpt_dir, str(step))
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, CKPT_FILE)
    torch.save(state_dict, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in checkpoint_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return path


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    map_location="cpu") -> Dict:
    """Read a checkpoint (the newest without ``step``) onto
    ``map_location``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(os.path.join(ckpt_dir, str(int(step)), CKPT_FILE),
                      map_location=map_location, weights_only=True)
