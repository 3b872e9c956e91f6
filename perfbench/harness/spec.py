"""Look-ups by name: the cell in BENCHMARK.json, its configuration file,
its traffic file, the traffic's driver, each per-layer metric's reader
and the cell's correctness limits. Everything a cell needs is found from
the names in BENCHMARK.json, so that a new configuration, mix or metric
is new files and entries, never an edit."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


class Bench:
    """BENCHMARK.json, read once."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.data = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config_file(self, name: str) -> dict:
        return json.loads((self.root / self.config_entry(name)["file"]).read_text())

    def metrics_of(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
        reports: those that list it, and those that list no cells."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell in m["workloads"]]


def traffic(name: str) -> dict:
    return json.loads((PERFBENCH / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    """{check name: limit} of a cell, from ``limits/<cell>.json``."""
    data = json.loads((PERFBENCH / "limits" / f"{cell}.json").read_text())
    return {k: v["limit"] for k, v in data["checks"].items()}


def load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return load_file(PERFBENCH / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def quantity(metric: str, mix: str) -> str:
    """The quantity a metric names: a metric of one mix's cells alone may
    carry the mix's name last (``tokens_per_s.docqa``), so that its bound
    and its readings stay apart from the same quantity's in other cells."""
    suffix = f".{mix}"
    return metric[:-len(suffix)] if metric.endswith(suffix) else metric


def reader(metric: str, mix: str) -> ModuleType:
    """The reader of one per-layer metric: ``metrics/<quantity>.py`` with a
    function ``read(readings)`` that returns a number or None."""
    name = quantity(metric, mix)
    return load_file(PERFBENCH / "metrics" / f"{name}.py",
                     "perfbench_metric_" + name.replace(".", "_"))


def run_values(cfg_file: dict) -> dict:
    """The configuration as it is run: the source's keys, each key listed
    under ``reduced`` at the value run there, and each ``assumed`` size."""
    out = {k: v for k, v in cfg_file.items()
           if k not in ("name", "source", "reduced", "departures", "assumed",
                        "deployment", "dtype")}
    for k, entry in cfg_file.get("reduced", {}).items():
        if k not in out:
            raise KeyError(f"reduced names {k!r}, which the source does not have")
        out[k] = entry["run"]
    for k, entry in cfg_file.get("assumed", {}).items():
        out[k] = entry["value"]
    out["dtype"] = cfg_file["dtype"]
    return out
