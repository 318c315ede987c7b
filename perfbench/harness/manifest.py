"""``BENCHMARK.json``: loading, the cells' metric lists, and the checks of the
benchmark's contract that need no run."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _in_cell(metric: dict, cell: str, e2e_of: Dict[str, List[str]]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = metric.get("moves", metric["name"])
    return cell in e2e_of.get(moved, [])


def metrics_of(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics untraced,
    its per-layer metrics traced."""
    names = [w["name"] for w in bench["workloads"]]
    e2e_of = {m["name"]: m.get("workloads", names) for m in bench["end_to_end"]}
    if not traced:
        return [m for m in bench["end_to_end"] if cell in e2e_of[m["name"]]]
    return [m for m in bench["per_layer"] if _in_cell(m, cell, e2e_of)]


def problems(bench: dict, root: Path) -> List[str]:
    """What in `bench` breaks the contract's static rules (empty when none)."""
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")
    for p in bench["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    if not (1 <= len(bench["paths"]) <= 16):
        out.append("1 to 16 paths")
    if not (isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51):
        out.append("run_seconds")
    cells = [w["name"] for w in bench["workloads"]]
    configs = [c["name"] for c in bench["configs"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for kind, names in (("cell", cells), ("config", configs), ("metric", metrics)):
        if len(set(names)) != len(names):
            out.append(f"duplicate {kind} names")
        out += [f"{kind} name {n!r}" for n in names if not NAME.match(n)]
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']} keys {sorted(c)}")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in bench["paths"]):
            out.append(f"config file {c['file']} outside paths")
        if not (root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
        out += [f"reduced key {k!r}" for k in c["reduced"] if not NAME.match(k)]
        if c["name"] not in {w["config"] for w in bench["workloads"]}:
            out.append(f"config {c['name']} used by no cell")
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"cell {w['name']} keys {sorted(w)}")
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: unknown config")
        if not NAME.match(w["traffic"]):
            out.append(f"traffic name {w['traffic']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']} chips")
        if not (1 <= len(w["why"]) <= 200) or "\n" in w["why"] or "\t" in w["why"]:
            out.append(f"cell {w['name']} why")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"pair {w['config']}/{w['traffic']} twice")
        pairs.add((w["config"], w["traffic"]))
    if sum(w["chips"] == 4 for w in bench["workloads"]) > max(1, len(cells) // 4):
        out.append("more than 25% of cells on four chips")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']} unit or direction")
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']} source")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"metric {m['name']}: unknown cell {c}")
    for m in bench["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound", "source"}:
            out.append(f"metric {m['name']} keys")
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end-to-end {m['name']} source")
        if not (0.01 <= m["bound"] <= 0.25):
            out.append(f"end-to-end {m['name']} bound")
    names = cells
    for m in bench["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source", "layer", "moves"}:
            out.append(f"metric {m['name']} keys")
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']} moves {m['moves']!r}")
            continue
        moved_in = e2e[m["moves"]].get("workloads", names)
        for c in m.get("workloads", names):
            if c not in moved_in:
                out.append(f"metric {m['name']}: cell {c} does not report {m['moves']}")
    for c in cells:
        e2e_here = [m["name"] for m in metrics_of(bench, c, False)]
        if "setup_s" not in e2e_here or len(e2e_here) < 2:
            out.append(f"cell {c} needs setup_s and another end-to-end metric")
        if not metrics_of(bench, c, True):
            out.append(f"cell {c} has no per-layer metric")
    if len(json.dumps(bench)) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out
