"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, the
configuration file it names (``configs/<config>.json``) and its traffic
mix (``traffic/<traffic>.json``). Nothing here knows a cell by name, so a
cell is added by adding files and an entry."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    chips: int
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]   # and with --trace 1


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
