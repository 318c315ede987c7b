"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them, so that a
later change adds a configuration, a traffic mix, a metric or a cell's limits
by adding files:

  * a configuration: the ``file`` of its ``configs`` entry (and, for the CPU
    rehearsal, ``<stem>.tiny.json`` beside it);
  * a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``kind`` names
    the driver in ``perfbench/harness/<kind>.py``;
  * a metric: ``perfbench/metrics/<name>.py``, whose ``read(r)`` returns its
    value or None where the run has nothing for it to read;
  * a cell's limits of the correctness comparison:
    ``perfbench/limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(bench: dict, name: str, tiny: bool = False, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    path = root / entry["file"]
    if tiny:
        path = path.with_name(path.stem + ".tiny.json")
    return _json(path)


def traffic(name: str, dry_run: bool = False, base: Path = BENCH) -> dict:
    mix = _json(base / "traffic" / f"{name}.json")
    if dry_run:
        mix = dict(mix, **mix.get("dry_run", {}))
    return mix


def driver(kind: str):
    return importlib.import_module(f"perfbench.harness.{kind}")


def metric(name: str, base: Path = BENCH):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def limits(workload: str, base: Path = BENCH) -> dict:
    return _json(base / "limits" / f"{workload}.json")
