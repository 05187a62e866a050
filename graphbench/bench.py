"""``BENCHMARK.json`` and the files it names, found by name.

  configs/<config>.json     a configuration (``load_config``)
  traffic/<traffic>.json    a traffic mix (``load_traffic``)
  metrics/<metric>.py       the reader of a per-layer metric, named by the
                            metric's name up to its first dot
                            (``fused_frontier_roofline.stream`` is read
                            by ``metrics/fused_frontier_roofline.py``),
                            with ``read(ctx) -> float | None``

A later cell, mix or metric is a new file and a new entry; nothing here
changes.
"""
from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from typing import Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names the benchmark never loads: JAX, the JAX
# package, its CPU benchmark and the card smoke script
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"})


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(kind: str, name: str, suffix: str, base: Path) -> Path:
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"bad {kind} name {name!r}")
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def load_config(name: str, base: Path = HERE) -> dict:
    cfg = json.loads(_named("configs", name, ".json", base).read_text())
    cfg.setdefault("name", name)
    return cfg


def load_traffic(name: str, base: Path = HERE) -> dict:
    return json.loads(_named("traffic", name, ".json", base).read_text())


def metric_reader(metric: str):
    """The ``read`` function of the metric's reader module."""
    module = metric.split(".", 1)[0]
    _named("metrics", module, ".py", HERE)
    return importlib.import_module(f"graphbench.metrics.{module}").read


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Optional[Iterable[str]] = None) -> List[str]:
    """Forbidden modules in ``sys.modules``, by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)
