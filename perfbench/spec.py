"""Find a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``.  A new configuration, traffic mix, cell or
per-layer metric is a new file here, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    here: Path = HERE

    def driver(self):
        return _load_module(self.here / "drivers" / f"{self.traffic['driver']}.py",
                            f"perfbench_driver_{self.traffic['driver']}")

    def readers(self) -> dict:
        """metric name -> its reader's ``read(ctx)``."""
        return {m["name"]: _load_module(self.here / "metrics" / f"{m['name']}.py",
                                        "perfbench_metric_" + m["name"].replace(".", "_")).read
                for m in self.per_layer}


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                         f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(here / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, reported)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer, here)
