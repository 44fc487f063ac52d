"""A cell as its files define it.

``BENCHMARK.json`` names the cell, its configuration and its traffic;
``workloads/<cell>.json`` repeats those two names and holds the cell's
correctness limits; ``configs/<config>.json`` (the file that
``BENCHMARK.json`` gives for the configuration) holds the problem and the
solver's mathematics; ``traffic/<traffic>.json`` holds the mix's parameters
and names its driver (``drivers/<driver>.py``); ``metrics/<metric>.py`` reads
one metric. A later cell, configuration, mix or metric is a new file and a
new entry, and no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: ``name``, ``chips``, ``config``, ``traffic`` (the
    files' objects), ``limits`` and the ``end_to_end`` and ``per_layer``
    metric entries that it reports."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    work = _json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json says {key} {work[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    return {"name": name, "chips": entry["chips"],
            "config": _json(CHECKOUT / conf["file"]),
            "traffic": _json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "limits": work["limits"],
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def driver(cell: dict):
    """The module that drives the cell's traffic."""
    return importlib.import_module(f"benchmark.drivers.{cell['traffic']['driver']}")


def reader(metric: str):
    """The module ``metrics/<metric>.py``, whose ``read(record)`` gives the
    metric's value or None where the record holds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
