"""Runners: how a cell drives the program, one file per runner,
``srbench/runners/<name>.py``, named by the configuration's ``runner``
(``classical`` where the configuration names none) and found by file name
(:meth:`srbench.cells.Cell.runner`).  A cell of a new runner is new files
and new entries of ``BENCHMARK.json``: one in ``configs``, one in
``workloads`` and one in ``per_layer`` for each per-layer metric of its
own (a reader in ``srbench/layer_metrics/``; every cell reports one);
nothing names the runner.

What a runner's files hold:

* the configuration ``srbench/configs/<config>.json``: the sizes the
  runner reads, ``runner`` (its name), and ``lr_shape`` where the default
  :meth:`Runner.shrink` is to cut it;
* the traffic mix ``srbench/traffic/<traffic>.json``: ``pool_sessions``
  (the inputs made from the seed, sent in turn), ``check_calls`` (the
  calls the check keeps) and ``control`` (the precision below the one the
  mix states, in which :meth:`Runner.control` computes the reference);
* the limits ``srbench/limits/<cell>.json``: one per name of ``GAPS``;
* its fault tests ``srbench/tests/test_srbench_runner_<name>.py``: a run
  of the cell on the CPU, with the program's timed path broken underneath,
  comes out not correct, once for each fault the cell can have
  (``test_srbench_runners.py`` fails a cell whose runner has no such
  file; the classical runner's are in ``test_srbench_control.py``).

A runner module defines ``PROGRAM``, the program module it drives (which
``srbench.run`` imports as its test that the program is there), and
``Runner``, a subclass of :class:`Runner` below built as ``Runner(cell,
device)`` that states:

* ``KERNELS``: the kernel wrappers, ``"<module>.<function>"``, whose
  ``launches*`` counters the path check reads;
* ``GAPS``: the names of the numbers its check compares, which its limits
  file holds;
* ``expected``: the launches one call implies, by ``<wrapper>.<counter>``;
* ``pixels``: the HR pixels one call returns;
* ``pool``, filled by ``load(seed)``: the inputs of the run, one per call
  in turn;
* ``call(item)``: one call of the program on an item of the pool;
* ``keep(out)``: what of a call's output the check holds on to;
* ``release()``: drop the program's device state once the window closes;
* ``check(kept)``: the worst of each of ``GAPS`` over the kept calls
  (``{call index: (pool index, keep(out))}``) against the plain reference;
* ``control(sid)``: the same numbers with the control in the program's
  place (the plain reference computed in the mix's ``control``
  precision) on pool item ``sid``, against the reference: the upper
  readings ``srbench.calibrate`` sets limits from, and what
  ``test_srbench_control.py`` holds to fail the cell's limits;
* ``shrink(cell, card=False)``, a classmethod called before the runner
  is built: the cell cut to a size the CPU tests (or, with ``card``, the
  card tests) hold.

The window, its reservoir of kept calls, the traced stretch, the result
line and every printed line are ``srbench.run``'s, shared by every runner.
"""

from __future__ import annotations

import importlib
from typing import Dict, Sequence, Tuple


class PathError(RuntimeError):
    """A call launched other kernels than the traffic mix implies."""


def launch_counts(kernels: Sequence[str]) -> Dict[str, int]:
    """The program's launch counters (``launches*`` of each kernel
    wrapper ``<module>.<function>``), by ``<function>.<counter>``."""
    out = {}
    for path in kernels:
        module, name = path.rsplit(".", 1)
        fn = getattr(importlib.import_module(module), name)
        out.update({f"{name}.{k}": v for k, v in vars(fn).items()
                    if k.startswith("launches")})
    return out


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class Runner:
    """What every runner shares: the cell, the device, the pool and the
    path check."""

    KERNELS: Tuple[str, ...] = ()
    GAPS: Tuple[str, ...] = ()

    def __init__(self, cell, device: str):
        self.cell, self.device = cell, device
        self.expected: Dict[str, int] = {}
        self.pixels = 0
        self.pool: list = []

    def launch_counts(self) -> Dict[str, int]:
        return launch_counts(self.KERNELS)

    def warm(self) -> Dict[str, int]:
        """One call of the cell's shape; on the card, raises
        :class:`PathError` unless its launches are those the mix implies
        (on the CPU the program runs its kernels' plain versions and
        launches none)."""
        before = self.launch_counts()
        self.call(self.pool[0])
        counts = delta(self.launch_counts(), before)
        if self.device == "cuda" and counts != self.expected:
            raise PathError(f"one call launched {counts}, the traffic mix "
                            f"implies {self.expected}")
        return counts

    def keep(self, out):
        return out

    def release(self) -> None:
        pass

    def control(self, sid: int) -> Dict[str, float]:
        """The worst of each of ``GAPS`` with the control in the
        program's place, on pool item ``sid``."""
        name = type(self).__module__.rsplit(".", 1)[-1]
        raise NotImplementedError(f"runner {name!r} has no control")

    @classmethod
    def shrink(cls, cell, card: bool = False) -> None:
        """``cell`` at a test size: LR 24 x 32 (128 x 256 on the card), a
        pool of 2 inputs, 2 calls checked."""
        cell.config["lr_shape"] = [128, 256] if card else [24, 32]
        cell.traffic["pool_sessions"] = 2
        cell.traffic["check_calls"] = 2
