"""What a cell is: its entry in ``BENCHMARK.json`` and the data files it
names (configuration, traffic mix, limits), found by name."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def data_file(kind: str, name: str) -> str:
    """``mfbench/<kind>/<name>.json``: a configuration, a traffic mix or a
    cell's limits."""
    return os.path.join(HERE, kind, f"{name}.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<traffic>.json
    limits: Dict          # limits/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def reports(metric: Dict, cell: str, end_to_end: List[str]) -> bool:
    """Whether a cell reports ``metric``: the cells its ``workloads`` list,
    or, without the key, every cell that reports what it moves (a per-layer
    metric) or every cell (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"mfbench: no workload {name!r} in {bench_path}")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(data_file("configs", entry["config"])),
                traffic=load_json(data_file("traffic", entry["traffic"])),
                limits=load_json(data_file("limits", name)),
                end_to_end=e2e, per_layer=layer)
