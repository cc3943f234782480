"""The cell as ``BENCHMARK.json`` and the files it names describe it.

A cell is found by its name: its configuration in the file its
``configs`` entry names, its traffic in ``traffic/<name>.json``, and each
per-layer metric's reader in ``metrics/<name>.py``. Adding a cell, a
traffic mix or a metric is adding files and entries; nothing here names
one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent                                  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]          # the configuration file, whole
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics, cell: str) -> List[Dict[str, Any]]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises KeyError
    for an unknown cell."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / cfg["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
    )


def reader(metric: str) -> Callable[[Any], Optional[float]]:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_config(cls, values: Dict[str, Any]):
    """An instance of the frozen dataclass ``cls`` from a nested dict, as
    ``dataclasses.asdict`` writes one: every field given, lists back to
    tuples, nested groups (and tuples of them) back to their classes."""
    return _rebuild(cls(), values)


def _rebuild(default, value):
    if dataclasses.is_dataclass(default):
        names = {f.name for f in dataclasses.fields(default)}
        if set(value) != names:
            raise ValueError(f"{type(default).__name__}: keys {sorted(set(value) ^ names)} "
                             "differ from the class's fields")
        return dataclasses.replace(default, **{
            k: _rebuild(getattr(default, k), v) for k, v in value.items()})
    if isinstance(default, tuple) and default and dataclasses.is_dataclass(default[0]):
        return tuple(_rebuild(default[0], v) for v in value)
    if isinstance(value, list):
        return _tuple(value)
    return value


def _tuple(value):
    return tuple(_tuple(v) for v in value) if isinstance(value, list) else value
