"""The classical SR solve: one call of ``sr.classical.solve`` for one unit
and ``solve_batch`` for several, each with the frames of one session of a
pool rendered from the seed (:mod:`srbench.generator`), as numpy on the
host (as the session loader gives them), each returning numpy results;
checked against the plain reference (:mod:`srbench.reference`)."""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np

from srbench import generator, reference
from srbench.runners import Runner as _Runner
from srbench.work import calls

PROGRAM = "enph459_super_resolution_tpu_torch.sr.classical"


class Runner(_Runner):
    """The program driven as the cell's traffic mix says, on ``device``."""

    KERNELS = ("enph459_super_resolution_tpu_torch.ops.banded_rows."
               "banded_row_apply",
               "enph459_super_resolution_tpu_torch.ops.fused_ibp."
               "fused_fwd_err",
               "enph459_super_resolution_tpu_torch.ops.fused_ibp."
               "fused_bwd_update")
    GAPS = tuple(name for _, name in reference.GAPS)

    def __init__(self, cell, device: str):
        from enph459_super_resolution_tpu_torch.sr import classical

        super().__init__(cell, device)
        self.classical = classical
        cfg, mix = cell.config, cell.traffic
        self.psf = reference.psf(cfg)
        self.shifts = tuple((float(dy), float(dx)) for dy, dx in
                            cfg["shifts"])
        self.opts = dict(factor=cfg["factor"],
                         n_iter=cfg["ibp"]["iterations"],
                         step=cfg["ibp"]["step"],
                         clip_max=cfg["ibp"]["clip_max"], device=device,
                         **mix["solve"])
        self.units = cell.units
        self.pixels = (self.units * cfg["factor"] ** 2
                       * cfg["lr_shape"][0] * cfg["lr_shape"][1])
        self.expected = calls.launches(cfg, mix)
        self.pool: List[np.ndarray] = []
        self._control_ops = None

    def call(self, session: np.ndarray, **overrides):
        """One call of the program's solve entry on a session's units."""
        opts = dict(self.opts, **overrides)
        if self.units == 1:
            return self.classical.solve(session[0], self.psf, self.shifts,
                                        **opts)
        return self.classical.solve_batch(session[: self.units], self.psf,
                                          self.shifts, **opts)

    def load(self, seed: int) -> None:
        """The session pool of ``seed``."""
        self.pool = generator.render_pool(self.cell.config, self.cell.traffic,
                                          seed, self.device)

    def keep(self, out):
        return reference.with_units_axis(out)

    def release(self) -> None:
        """Drop the program's device state (its operator tree)."""
        self.classical._device_matrices.cache_clear()
        gc.collect()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check(self, kept: Dict[int, tuple],
              arith: str = "f64") -> Dict[str, float]:
        """The worst of each number over the kept calls, against the
        reference computed in ``arith`` on this device."""
        dops = reference.device_operators(self.cell.ops, arith, self.device)
        worst = {name: 0.0 for name in self.GAPS}
        refs: Dict[int, dict] = {}
        for _, (sid, out) in sorted(kept.items()):
            if sid not in refs:
                refs[sid] = reference.solve_call(
                    self.pool[sid][: self.units], dops, self.cell.config,
                    arith)
            for name, v in reference.gaps(out, refs[sid]).items():
                worst[name] = max(worst[name], v)
        return worst

    def control(self, sid: int) -> Dict[str, float]:
        """The reference computed in the mix's ``control`` arithmetic
        against the reference in float64, on session ``sid``'s units."""
        arith = self.cell.traffic["control"]
        if self._control_ops is None:
            self._control_ops = tuple(
                reference.device_operators(self.cell.ops, a, self.device)
                for a in ("f64", arith))
        ref, low = self._control_ops
        units = self.pool[sid][: self.units]
        want = reference.solve_call(units, ref, self.cell.config)
        got = reference.solve_call(units, low, self.cell.config, arith)
        return reference.gaps(got, want)

    @classmethod
    def shrink(cls, cell, card: bool = False) -> None:
        """As the base, but LR 128 x 256 where the mix takes the fused
        kernels: the smallest shape they qualify at."""
        super().shrink(cell, card)
        if any(e == "fused" for e, _, _ in cell.traffic["launches"]["ibp"]):
            cell.config["lr_shape"] = [128, 256]
