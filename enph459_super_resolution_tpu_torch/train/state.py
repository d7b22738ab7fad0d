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

The ESRGAN two-player step (:class:`GANBalance`, :class:`GANTrainState`,
:func:`make_gan_train_step`) holds the generator's :class:`TrainState`, the
discriminator and its own optimizer.  JAX keeps the balance knobs in the
jitted state to avoid recompiles; eager PyTorch has none to avoid, so
:class:`GANBalance` is a plain dataclass.

Checkpoints are the port's own: ``<ckpt_dir>/<step>/state.pt`` written by
``torch.save`` (tensors and plain containers only), read with
``torch.load(weights_only=True)``; the newest two are kept.  A GAN
checkpoint holds the generator's state under ``"g"``, as the JAX
package's does.  The port reads no orbax checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .data import generator
from .losses import (PIXEL_LOSSES, l1_loss, psnr, ragan_discriminator_loss,
                     ragan_generator_loss)

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
# GAN (ESRGAN fine-tune) two-player step
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GANBalance:
    """The two players' balance knobs.

    ``gan_weight`` is the weight on the RaGAN generator term (0: the
    perceptual-only ablation, where D still trains but gives G no
    gradient); ``d_lr_scale`` scales D's whole update (for Adam and AdamW
    exactly its rate); D updates only on steps with ``step % d_every ==
    0``; ``instance_noise`` is the sigma (pixel counts, 0..255) of the
    Gaussian noise added to D's inputs.
    """
    gan_weight: float = 5e-3
    d_lr_scale: float = 1.0
    d_every: int = 1
    instance_noise: float = 0.0


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """The updates an Adam/AdamW optimizer has taken (its state's
    ``step``; 0 before the first)."""
    for st in optimizer.state.values():
        return int(st["step"])
    return 0


class GANTrainState:
    """``step`` (the two-player step count), ``g`` (the generator's
    :class:`TrainState`), ``disc`` (the discriminator, whose parameters are
    D's), ``d_optimizer`` (D's own Adam/AdamW: its update count, not the
    step, drives D's rate schedule and bias correction) and ``balance``."""

    def __init__(self, g: TrainState, disc: nn.Module,
                 d_optimizer: torch.optim.Optimizer, balance: GANBalance,
                 step: int = 0):
        self.g = g
        self.disc = disc
        self.d_optimizer = d_optimizer
        self.balance = balance
        self.step = int(step)

    @property
    def d_updates(self) -> int:
        return update_count(self.d_optimizer)

    def state_dict(self) -> Dict:
        return {"step": self.step, "g": self.g.state_dict(),
                "d_params": {n: p.detach().clone()
                             for n, p in self.disc.named_parameters()},
                "d_opt_state": self.d_optimizer.state_dict(),
                "balance": dataclasses.asdict(self.balance)}

    def load_state_dict(self, state: Dict) -> None:
        self.g.load_state_dict(state["g"])
        self.disc.load_state_dict(state["d_params"], strict=True)
        self.d_optimizer.load_state_dict(state["d_opt_state"])
        self.balance = GANBalance(**state["balance"])
        self.step = int(state["step"])


def _apply_grads(params, grads, optimizer, cfg: TrainConfig, rate: float):
    """One optimizer update of ``params`` from ``grads`` at ``rate``, the
    gradients clipped first where ``cfg.grad_clip`` (optax's chain)."""
    for p, g in zip(params, grads):
        p.grad = g
    if cfg.grad_clip:
        torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip)
    for group in optimizer.param_groups:
        group["lr"] = rate
    optimizer.step()
    for p in params:
        p.grad = None


def make_gan_train_step(cfg: TrainConfig, pixel_weight: float = 1e-2,
                        percep_loss: Optional[Callable] = None,
                        noise_seed: int = 0):
    """ESRGAN objective: L_G = percep + lambda * RaGAN + eta * L1, then an
    alternating D step.  Returns ``step(state, lr, hr, noise=None) ->
    metrics``, which updates a :class:`GANTrainState` in place.

    * G: the discriminator runs on ``sr`` and ``hr`` with its parameters
      held (the gradient reaches only the generator's parameters); then
      G's update, then the EMA.
    * D: on the same step's pre-update ``sr``, detached (no fresh forward),
      and ``hr``; only when ``step % d_every == 0``, otherwise D's
      parameters and optimizer state stay as they are.  Its rate is the
      schedule at D's own update count, times ``d_lr_scale``.
    * ``noise`` is the instance noise's four standard-normal draws of
      ``hr``'s shape (G's fake and real, D's fake and real), scaled by
      ``balance.instance_noise``; None draws them from a generator seeded
      by ``noise_seed`` and the step (none are drawn at sigma 0).

    Metrics (0-d tensors): ``g_loss``, ``d_loss``, ``g_gan`` (the raw RaGAN
    G term), ``gan_weight`` and ``psnr`` (of the pre-update ``sr``).
    """
    def step(state: GANTrainState, lr, hr, noise=None):
        bal = state.balance
        if noise is None and bal.instance_noise:
            gen = generator(hr.device, noise_seed, state.step)
            noise = [torch.randn(hr.shape, generator=gen, device=hr.device)
                     for _ in range(4)]

        def noisy(x, k):
            return x if noise is None else x + bal.instance_noise * noise[k]

        g_params = list(state.g.model.parameters())
        sr = state.g.model(lr)
        fake = state.disc(noisy(sr, 0))
        real = state.disc(noisy(hr, 1))
        g_gan = ragan_generator_loss(real, fake)
        g_loss = bal.gan_weight * g_gan + pixel_weight * l1_loss(sr, hr)
        if percep_loss is not None:
            g_loss = g_loss + percep_loss(sr, hr)
        g_grads = torch.autograd.grad(g_loss, g_params)
        _apply_grads(g_params, g_grads, state.g.optimizer, cfg,
                     learning_rate(cfg, state.g.step))
        ema_update(state.g.ema_params, state.g.params, cfg.ema_decay)

        sr = sr.detach()
        d_params = list(state.disc.parameters())
        do_d = state.step % bal.d_every == 0
        with torch.set_grad_enabled(do_d):
            d_loss = ragan_discriminator_loss(state.disc(noisy(hr, 3)),
                                              state.disc(noisy(sr, 2)))
        if do_d:
            d_grads = torch.autograd.grad(d_loss, d_params)
            _apply_grads(d_params, d_grads, state.d_optimizer, cfg,
                         learning_rate(cfg, state.d_updates)
                         * bal.d_lr_scale)
        state.g.step += 1
        state.step += 1
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
                "g_gan": g_gan.detach(),
                "gan_weight": torch.tensor(float(bal.gan_weight)),
                "psnr": psnr(sr, hr)}

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
