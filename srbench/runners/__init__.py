"""Runners: how a cell drives the program, one file per runner,
``srbench/runners/<name>.py``, named by the configuration's ``runner``
(``classical`` where the configuration names none) and found by file name
(:meth:`srbench.cells.Cell.runner`).  A new runner is a new file; nothing
names it.

A runner module defines ``PROGRAM``, the program module it drives (which
``srbench.run`` imports as its test that the program is there), and
``Runner``, a subclass of :class:`Runner` below built as ``Runner(cell,
device)`` that states:

* ``KERNELS``: the kernel wrappers, ``"<module>.<function>"``, whose
  ``launches*`` counters the path check reads;
* ``GAPS``: the names of the numbers its check compares, which its limits
  file ``srbench/limits/<cell>.json`` holds;
* ``expected``: the launches one call implies, by ``<wrapper>.<counter>``;
* ``pixels``: the HR pixels one call returns;
* ``pool``, filled by ``load(seed)``: the inputs of the run, one per call
  in turn;
* ``call(item)``: one call of the program on an item of the pool;
* ``keep(out)``: what of a call's output the check holds on to;
* ``release()``: drop the program's device state once the window closes;
* ``check(kept)``: the worst of each of ``GAPS`` over the kept calls
  (``{call index: (pool index, keep(out))}``) against the plain reference.

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
