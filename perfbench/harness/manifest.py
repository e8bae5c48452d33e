"""``BENCHMARK.json`` and the files each of its names leads to.

A cell is a ``workloads`` entry; its configuration is
``configs/<config>.json`` (the entry's ``file``), its traffic
``traffic/<traffic>.json``, the limits of its comparison
``checks/<workload>.json``, and each per-layer metric it reports is read
by ``metrics/<metric>.py``.  Nothing here knows a cell by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def end_to_end_of(manifest: dict, workload: str) -> list[dict]:
    """The end-to-end metrics this cell reports: those that list it, and
    those that list no cells."""
    return [m for m in manifest["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_of(manifest: dict, workload: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those that list no cells but move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(manifest, workload)}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def load_cell(root: Path, workload: str, manifest: dict | None = None) -> Cell:
    manifest = manifest or load_manifest(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(
        name=workload, workload=w,
        config=_json(root / conf["file"]),
        traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=_json(BENCH / "checks" / f"{workload}.json"),
        end_to_end=end_to_end_of(manifest, workload),
        per_layer=per_layer_of(manifest, workload))


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where the
    run had nothing for it to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """``drivers/<kind>.py``: the general generator a traffic file names."""
    return importlib.import_module(f"perfbench.drivers.{kind}")
