"""Every mesh of ``parallel/`` in one short run, with golden parity.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``
(which jits over ``n`` virtual or real devices): here the ``n`` mesh
positions are the first ``n`` CUDA cards, or ``devices`` (which may repeat
one device, e.g. ``["cuda:0"] * 8`` on one card or ``["cpu"] * 8``)::

    python -m enph459_super_resolution_tpu_torch.parallel.dryrun 8 [--device cpu]

Parts, each printing the reference's ``... ok:`` line:

* one EDSR train step over a dp x sp x tp mesh (n factored as the
  reference factors it: tp = 2, sp = 2 when 4 divides n);
* a dp x pp pipeline train step (head, 4 pipelined residual stages, tail;
  one SGD step) and its forward's parity with the sequential model;
* a dp x ep gated-MoE layer and its parity with the dense evaluation;
* the sharded IBP and adjoint solves over n row tiles, and over 2 x 2
  tiles, against the unsharded solves over the whole array;
* an ``edsr_moe`` train step over dp x ep against the dense step's loss.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _devices(n: int, devices: Optional[Sequence]):
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) < n:
            raise ValueError(f"dryrun over {n} positions, have "
                             f"{len(devices)} devices")
        return devices[:n]
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA card (torch.cuda."
                           "is_available() is False); pass devices=[...] "
                           "to run on the CPU")
    if torch.cuda.device_count() < n:
        raise ValueError(f"dryrun over {n} positions, have "
                         f"{torch.cuda.device_count()} cards")
    return [torch.device("cuda", i) for i in range(n)]


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().cpu() - b.detach().cpu()).abs().max())


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None):
    """Run every part over ``n_devices`` mesh positions; raises on a
    non-finite loss or a parity beyond the reference's bar (pipeline
    forward 1e-3, MoE layer 1e-4, sharded solves 1e-3 and the MSE history
    rtol 1e-5, the MoE train step's loss 1e-3)."""
    from ..models import EDSR, create_model
    from ..models.common import Conv, ResBlock, init_flax_default
    from ..sr.classical import forward_model, ibp, make_gaussian_psf, \
        shift_and_add
    from ..train.state import TrainConfig, TrainState, make_train_step
    from . import (make_mesh, moe_apply, pipeline_apply, shard_params_ep,
                   shard_params_ep_named, shard_params_pp, shard_params_tp,
                   shard_train_step, sharded_ibp, stack_experts,
                   stack_stages)

    devices = _devices(n_devices, devices)
    owner = devices[0]
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=owner)

    # ---- the full neural train step, dp x sp x tp ----
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % 4 == 0 else 1
    dp = n_devices // (tp * sp)
    mesh = make_mesh({"dp": dp, "sp": sp, "tp": tp}, devices=devices)
    print(f"mesh: dp={dp} sp={sp} tp={tp}")
    model = EDSR(scale=2, channels=3, n_resblocks=2, n_feats=16,
                 device=owner, generator=gen)
    lr_b = tensor(rng.uniform(0, 255, (dp * 2, 8 * sp, 8, 3)))
    hr_b = tensor(rng.uniform(0, 255, (dp * 2, 16 * sp, 16, 3)))
    shard_params_tp(model, mesh, "tp")
    cfg = TrainConfig(learning_rate=1e-4, loss="l1")
    state = TrainState.create(model, cfg)
    step = shard_train_step(make_train_step(cfg), mesh, sp_axis="sp")
    metrics = step(state, lr_b, hr_b)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError("train step produced non-finite loss")
    print(f"train step ok: loss={loss:.4f} psnr={float(metrics['psnr']):.2f}")

    feats = 16
    block = ResBlock(feats).to(owner)

    def block_params(seed):
        init_flax_default(block, torch.Generator().manual_seed(seed))
        return {k: v.detach().clone() for k, v in block.named_parameters()}

    def run_block(p, u):
        return torch.func.functional_call(block, p, (u,))

    # ---- a dp x pp pipeline train step, with the pipelined forward's
    # parity against the sequential model ----
    if n_devices % 4 == 0:
        pp = 4
        pp_mesh = make_mesh({"dp": n_devices // pp, "pp": pp},
                            devices=devices)
        stacked = stack_stages([block_params(s) for s in range(pp)])
        head, tail = Conv(3, feats, 3), Conv(feats, 3, 3)
        init_flax_default(head, torch.Generator().manual_seed(10))
        init_flax_default(tail, torch.Generator().manual_seed(11))
        head, tail = head.to(owner), tail.to(owner)
        xb = tensor(rng.uniform(0, 255, (8, 8, 8, 3)))
        yb = tensor(rng.uniform(0, 255, (8, 8, 8, 3)))
        shard_params_pp(stacked, pp_mesh)
        params = [*stacked.values(), *head.parameters(), *tail.parameters()]
        for p in params:
            p.requires_grad_(True)

        def pp_forward(x):
            h = pipeline_apply(run_block, stacked, head(x), mesh=pp_mesh,
                               n_micro=4, dp_axis="dp")
            return tail(h)

        pp_l0 = torch.mean((pp_forward(xb) - yb) ** 2)
        grads = torch.autograd.grad(pp_l0, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= 1e-6 * g
        pp_l0 = float(pp_l0.detach())
        if not np.isfinite(pp_l0):
            raise RuntimeError("pp train step non-finite loss")
        with torch.no_grad():
            got = pp_forward(xb)
            h = head(xb)
            for s in range(pp):
                h = run_block({k: v[s] for k, v in stacked.items()}, h)
            pp_err = _max_diff(got, tail(h))
        if not pp_err < 1e-3:
            raise RuntimeError(f"pipelined forward deviates: max|d|={pp_err}")
        print(f"pipeline step ok: dp={n_devices // pp} pp={pp} "
              f"loss={pp_l0:.2f} parity max|d| vs sequential = "
              f"{pp_err:.2e}")

    # ---- a dp x ep gated MoE layer, with its parity against the dense
    # evaluation ----
    if n_devices % 4 == 0:
        ep = 4
        ep_mesh = make_mesh({"dp": n_devices // ep, "ep": ep},
                            devices=devices)
        e_stacked = stack_experts([block_params(20 + e) for e in range(ep)])
        xe = tensor(rng.normal(size=(8, 8, 8, feats)))
        gates = torch.softmax(tensor(rng.normal(size=(8, 8, 8, ep))), dim=-1)
        shard_params_ep(e_stacked, ep_mesh)
        with torch.no_grad():
            got = moe_apply(run_block, e_stacked, gates, xe, mesh=ep_mesh,
                            dp_axis="dp")
            dense = sum(gates[..., e:e + 1] * run_block(
                {k: v[e] for k, v in e_stacked.items()}, xe)
                for e in range(ep))
        ep_err = _max_diff(got, dense)
        if not ep_err < 1e-4:
            raise RuntimeError(f"expert-parallel MoE deviates: {ep_err}")
        print(f"moe step ok: dp={n_devices // ep} ep={ep} "
              f"parity max|d| vs dense = {ep_err:.2e}")

    # ---- the classical sharded IBP over n row tiles, against the
    # single-device solve over the FULL array (edges included) ----
    ibp_mesh = make_mesh({"sp": n_devices}, devices=devices)
    shifts = ((0.5, -0.5), (0.5, 0.5), (-0.5, -0.5), (-0.5, 0.5))
    psf = make_gaussian_psf()
    lrs = tensor(rng.uniform(0, 255, (4, 32 * n_devices, 32)))
    hr0 = shift_and_add(lrs, shifts, 2)
    hr, errs = sharded_ibp(lrs, hr0, psf, shifts, ibp_mesh, factor=2,
                           n_iter=2, halo_lr=28)
    if tuple(hr.shape) != (lrs.shape[1] * 2, lrs.shape[2] * 2) or \
            not bool(torch.isfinite(errs).all()):
        raise RuntimeError(f"sharded IBP: hr {tuple(hr.shape)}, mse {errs}")
    want_hr, want_errs = ibp(lrs, shifts, psf, hr0, 2, n_iter=2, step=0.5)
    err_max = _max_diff(hr, want_hr)
    if not err_max < 1e-3:
        raise RuntimeError("sharded IBP deviates from the unsharded solve: "
                           f"max|d|={err_max}")
    np.testing.assert_allclose(errs.cpu().numpy(), want_errs.cpu().numpy(),
                               rtol=1e-5)
    print(f"sharded IBP ok: hr={tuple(hr.shape)} mse[0]={float(errs[0]):.2f} "
          f"parity max|d| vs single-device = {err_max:.2e}")

    def adjoint_ref(lr_stack, hr, n):
        def fwd(h):
            return torch.stack([forward_model(h, psf, s, 2) for s in shifts])

        for _ in range(n):
            sim, vjp = torch.func.vjp(fwd, hr)
            corr, = vjp(lr_stack - sim)
            hr = torch.clamp(hr + 2.0 * corr / len(shifts), 0.0, 255.0)
        return hr

    hr_a, _ = sharded_ibp(lrs, hr0, psf, shifts, ibp_mesh, factor=2,
                          n_iter=2, halo_lr=28, step=2.0, solver="adjoint")
    adj_err = _max_diff(hr_a, adjoint_ref(lrs, hr0, 2))
    if not adj_err < 1e-3:
        raise RuntimeError("sharded adjoint deviates from the unsharded "
                           f"update: {adj_err}")
    print(f"sharded adjoint ok: parity max|d| vs unsharded = {adj_err:.2e}")

    # ---- 2-D (H x W) tiles: sp x spw, corner exchange ----
    if n_devices % 4 == 0:
        mesh2d = make_mesh({"sp": 2, "spw": 2}, devices=devices[:4])
        lrs2 = tensor(rng.uniform(0, 255, (4, 64, 64)))
        hr02 = shift_and_add(lrs2, shifts, 2)
        want2, want2_errs = ibp(lrs2, shifts, psf, hr02, 2, n_iter=2,
                                step=0.5)
        hr2, errs2 = sharded_ibp(lrs2, hr02, psf, shifts, mesh2d, factor=2,
                                 n_iter=2, halo_lr=28, sp_axis=("sp", "spw"))
        err2 = _max_diff(hr2, want2)
        if not err2 < 1e-3:
            raise RuntimeError(f"2-D sharded IBP deviates: max|d|={err2}")
        np.testing.assert_allclose(errs2.cpu().numpy(),
                                   want2_errs.cpu().numpy(), rtol=1e-5)
        print(f"2-D sharded IBP ok: sp=2 spw=2 hr={tuple(hr2.shape)} "
              f"parity max|d| vs single-device = {err2:.2e}")
        hr2a, _ = sharded_ibp(lrs2, hr02, psf, shifts, mesh2d, factor=2,
                              n_iter=2, halo_lr=28, step=2.0,
                              sp_axis=("sp", "spw"), solver="adjoint")
        err2a = _max_diff(hr2a, adjoint_ref(lrs2, hr02, 2))
        if not err2a < 1e-3:
            raise RuntimeError(f"2-D sharded adjoint deviates: {err2a}")
        print(f"2-D sharded adjoint ok: parity max|d| vs unsharded = "
              f"{err2a:.2e}")

    # ---- the EDSRMoE train step over dp x ep: loss parity with the dense
    # single-device step ----
    if n_devices % 4 == 0:
        lr_m = tensor(rng.uniform(0, 255, (4, 8, 8, 1)))
        hr_m = tensor(rng.uniform(0, 255, (4, 16, 16, 1)))
        losses = {}
        for name in ("dense", "ep"):
            moe = create_model("edsr_moe", scale=2, channels=1,
                               n_resblocks=2, n_feats=8, n_experts=4,
                               device=owner,
                               generator=torch.Generator().manual_seed(2))
            moe_step = make_train_step(cfg)
            st = TrainState.create(moe, cfg)
            if name == "ep":
                ep_mesh2 = make_mesh({"dp": n_devices // 4, "ep": 4},
                                     devices=devices)
                placed = shard_params_ep_named(moe, ep_mesh2, "ep")
                if not any(s.sharded for s in placed.values()):
                    raise RuntimeError("no expert stacks were ep-split")
                moe_step = shard_train_step(moe_step, ep_mesh2)
            losses[name] = float(moe_step(st, lr_m, hr_m)["loss"])
        moe_d = abs(losses["ep"] - losses["dense"])
        if not moe_d < 1e-3:
            raise RuntimeError("ep-split EDSRMoE loss deviates from dense: "
                               f"{moe_d}")
        print(f"edsr_moe train step ok: dp={n_devices // 4} ep=4 "
              f"loss={losses['ep']:.4f} parity |d loss| vs dense = "
              f"{moe_d:.2e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the first N cards; cpu: N positions on the "
                        "host")
    args = p.parse_args(argv)
    try:
        devices = _devices(args.n_devices, ["cpu"] * args.n_devices
                           if args.device == "cpu" else None)
    except (RuntimeError, ValueError) as exc:
        p.error(str(exc))
    dryrun_multichip(args.n_devices, devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
