"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, load kind,
metric or kernel bound is a file of its own under ``portbench/``, found
by name:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry);
* ``traffic/<traffic>.json``, whose ``load`` names ``loads/<load>.py``;
* ``e2e/<metric>.py`` and ``layers/<metric>.py``, each with
  ``read(run) -> float | None``;
* ``bounds/<op>.py`` for each ``torch.ops.yolort_tpu.<op>``, with
  ``work(launch) -> (bytes, operations)``; ``bounds/peaks.json`` holds
  the card's published rates;
* ``reference/<reference>.py``, the configuration's plain reference
  network, named by its file's ``reference`` key; without the key,
  ``reference/r60.py`` (the r6.0 layouts of ``reference/models.py``).

So a cell, a configuration or a metric is added by adding files and
entries, and no file that is there changes.

A reference network's module has, at top level:

* ``build(cfg) -> nn.Module``: the network of the configuration ``cfg``
  (its file's JSON), in float32 and in evaluation mode;
* ``head_logits(net, x)``: the raw logits of NCHW float32 images ``x``,
  a list of one (B, A, H_l, W_l, 5 + nc) tensor a level;
* ``save_checkpoint(net, path)``: ``net`` written as an ultralytics
  checkpoint that ``YOLOv5.load_from_yolov5`` reads (``models.save_checkpoint``
  with ``extra`` for classes of its own).

Its detection head is a ``reference.models.FDetect``, which
``weights.make`` finds by type, and it imports torch and
``portbench.reference`` alone: nothing of the program under test.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REFERENCE_API = ("build", "head_logits", "save_checkpoint")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the modules under reference/ that the networks share, none a network of its own
_SUPPORT = ("__init__", "arith", "models", "pipeline")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    kind: str  # "end_to_end" or "per_layer"

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e


def load_module(path: Path) -> ModuleType:
    """A Python file loaded by path (metric names hold dots, so they are
    no module names)."""
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench._by_name.{path.parent.name}."
                                                  f"{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """``BENCHMARK.json`` at ``root`` (a checkout, or a test's copy), with
    the files under ``portbench/`` beside it (``bench_dir``)."""

    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.doc = _load_json(self.root / "BENCHMARK.json")
        self.metrics = [Metric(m["name"], m["unit"], m["better"], m["source"], m.get("workloads"),
                               kind)
                        for kind in ("end_to_end", "per_layer") for m in self.doc[kind]]

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.doc["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json")
        conf = next((c for c in self.doc["configs"] if c["name"] == entry["config"]), None)
        if conf is None:
            raise SpecError(f"workload {name!r} names no known configuration {entry['config']!r}")
        config = _load_json(self.root / conf["file"])
        traffic = _load_json(self.dir / "traffic" / f"{entry['traffic']}.json")
        return Cell(name, config, traffic, int(entry["chips"]))

    def metrics_of(self, cell: str, kind: str) -> List[Metric]:
        return [m for m in self.metrics if m.kind == kind and m.reported_in(cell)]

    def load_kind(self, traffic: dict) -> ModuleType:
        return load_module(self.dir / "loads" / f"{traffic['load']}.py")

    def reader(self, metric: Metric) -> ModuleType:
        return load_module(self.dir / ("e2e" if metric.kind == "end_to_end" else "layers")
                           / f"{metric.name}.py")

    def reference(self, config: dict) -> ModuleType:
        """The reference network's module of ``config``: the file its
        ``reference`` key names (``r60`` without the key), checked for the
        functions of the module docstring's contract."""
        name = config.get("reference", "r60")
        if not isinstance(name, str) or not _NAME.match(name):
            raise SpecError(f"reference {name!r} is no name")
        if name in _SUPPORT:
            raise SpecError(f"reference/{name}.py is no reference network")
        mod = load_module(self.dir / "reference" / f"{name}.py")
        missing = [fn for fn in REFERENCE_API if not callable(getattr(mod, fn, None))]
        if missing:
            raise SpecError(f"reference/{name}.py lacks {', '.join(missing)}")
        return mod


class Bounds:
    """The kernel bounds, ``bounds/<op>.py``, and the card's peaks."""

    def __init__(self, bench_dir: Path = HERE):
        self.dir = Path(bench_dir) / "bounds"
        self.peaks = _load_json(self.dir / "peaks.json")
        self._mods: Dict[str, Optional[ModuleType]] = {}

    def of(self, op: str) -> Optional[ModuleType]:
        if op not in self._mods:
            path = self.dir / f"{op}.py"
            self._mods[op] = load_module(path) if path.is_file() else None
        return self._mods[op]

    def least_seconds(self, nbytes: float, ops: float, kind: str) -> float:
        """The larger of the bytes at the memory rate and the operations at
        the peak rate of their type."""
        return max(nbytes / self.peaks["hbm_bytes_per_s"], ops / self.peaks["ops_per_s"][kind])
