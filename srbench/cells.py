"""A benchmark cell, found by name: its entry in ``BENCHMARK.json``, the
configuration file the entry names, the runner the configuration names
(``srbench/runners/<runner>.py``, ``classical`` where it names none), the
traffic mix ``srbench/traffic/<traffic>.json``, the limits of its
correctness check ``srbench/limits/<cell>.json`` and the readers of its
metrics (``srbench/e2e_metrics/<metric>.py``,
``srbench/layer_metrics/<metric>.py``), all under the root that holds
``BENCHMARK.json``.  A new cell, runner, mix or metric is a new file and a
new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from .work import calls

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> Dict:
    with open(path) as fp:
        return json.load(fp)


def _module(base: Path, kind: str, name: str, what: str) -> ModuleType:
    """``<base>/<kind>/<name>.py``, loaded as ``srbench.<kind>.<name>``."""
    path = base / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{what} {name!r} has no file {path}")
    spec = importlib.util.spec_from_file_location(f"srbench.{kind}.{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    module.__package__ = f"srbench.{kind}"
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads``, with everything it names loaded; a name
    ``<config>.<traffic>`` without an entry takes those two files.  The CPU
    tests shrink ``config`` before :attr:`ops` is first read."""

    def __init__(self, name: str, root: Path = HERE.parent):
        bench = _json(root / "BENCHMARK.json")
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None and "." in name:
            # a cell without an entry yet (to calibrate before adding it):
            # <config>.<traffic> on one chip
            config, traffic = name.split(".", 1)
            entry = {"config": config, "traffic": traffic, "chips": 1}
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        files = {c["name"]: c["file"] for c in bench["configs"]}
        cfg_file = root / files.get(entry["config"],
                                    f"srbench/configs/{entry['config']}.json")
        self.name = name
        self.dir = root / "srbench"
        self.chips = int(entry["chips"])
        self.config = _json(cfg_file)
        self.traffic = _json(self.dir / "traffic" /
                             f"{entry['traffic']}.json")
        limits = self.dir / "limits" / f"{name}.json"
        self.limits: Optional[Dict[str, float]] = (
            _json(limits) if limits.exists() else None)
        self.e2e = [dict(m) for m in bench["end_to_end"]
                    if _applies(m, name)]
        self.per_layer = [dict(m) for m in bench["per_layer"]
                          if _applies(m, name)]
        self._ops = None

    @property
    def units(self) -> int:
        """Units one call solves."""
        return calls.units_per_call(self.config, self.traffic)

    @property
    def ops(self):
        """The reference's operators of the configuration (float64
        numpy), built at first use."""
        from . import reference

        if self._ops is None:
            self._ops = reference.operators(self.config)
        return self._ops

    def readers(self, kind: str) -> List[tuple]:
        """(metric entry, reader module) for each metric of ``kind``
        (``e2e_metrics`` or ``layer_metrics``) this cell reports."""
        metrics = self.e2e if kind == "e2e_metrics" else self.per_layer
        return [(m, _module(self.dir, kind, m["name"], "metric"))
                for m in metrics]

    def runner_module(self) -> ModuleType:
        """The module of the configuration's runner (``classical`` where
        the configuration names none): its ``PROGRAM`` and ``Runner``."""
        return _module(self.dir, "runners",
                       self.config.get("runner", "classical"), "runner")

    def runner(self, device: str):
        """The configuration's runner, built for this cell on
        ``device``."""
        return self.runner_module().Runner(self, device)
