"""The contract's static rules on BENCHMARK.json, and the harness finding a
new configuration, traffic mix and metric by name with no edit to a file it
already has."""

import copy
import json
import shutil
from pathlib import Path

import pytest

from perfbench.harness import manifest, registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = manifest.load(ROOT / "BENCHMARK.json")


def test_benchmark_json_keeps_the_contract():
    assert manifest.problems(BENCH, ROOT) == []


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        spec = registry.config(BENCH, w["config"])
        assert registry.config(BENCH, w["config"], tiny=True)["components"].keys() == spec["components"].keys()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


@pytest.mark.parametrize("bad,needle", [
    (lambda b: b["per_layer"][0].update(name="has space"), "metric name"),
    (lambda b: b["end_to_end"][0].update(unit="images per s"), "unit"),
    (lambda b: b["workloads"][0].update(name="a/b"), "cell name"),
    (lambda b: b["configs"][0]["reduced"].append("bad,key"), "reduced key"),
    (lambda b: b["per_layer"][0].update(moves="setup_s", workloads=[b["workloads"][0]["name"]]), None),
    (lambda b: b["per_layer"][0].update(moves="latency_p90_s",
                                        workloads=[w["name"] for w in b["workloads"]]), "does not report"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["end_to_end"].pop(), "setup_s"),
])
def test_problems_are_found(bad, needle):
    b = copy.deepcopy(BENCH)
    bad(b)
    found = manifest.problems(b, ROOT)
    if needle is None:
        assert found == []
    else:
        assert any(needle in p for p in found), found


def test_at_most_a_quarter_of_cells_on_four_chips():
    b = copy.deepcopy(BENCH)
    base = b["workloads"][0]
    b["workloads"] = [dict(base, name=f"c{i}", traffic=f"t{i}") for i in range(8)]
    for w in b["workloads"][:2]:
        w["chips"] = 4
    assert not any("four chips" in p for p in manifest.problems(b, ROOT))
    b["workloads"][2]["chips"] = 4
    assert any("four chips" in p for p in manifest.problems(b, ROOT))


def test_metrics_of_a_cell():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in manifest.metrics_of(BENCH, w["name"], True):
            assert m["moves"] in e2e


def test_new_parts_are_found_by_name(tmp_path):
    """A copy of the benchmark's folder, to which a configuration, a traffic
    mix, a metric and a limits file are added, and nothing else changes."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "sd15.json").read_text())
    cfg["name"] = "sd15-other"
    (bench_dir / "configs" / "sd15-other.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "closed-c16-512.json").read_text())
    mix["clients"] = 4
    (bench_dir / "traffic" / "closed-c4-512.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "requests_seen.py").write_text("def read(r):\n    return len(r.log)\n")
    (bench_dir / "limits" / "sd15-other-c4.json").write_text('{"image_rms": 1.0}')
    b = copy.deepcopy(BENCH)
    b["configs"].append({"name": "sd15-other", "source": "https://example.org/x",
                         "file": "perfbench/configs/sd15-other.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "sd15-other-c4", "config": "sd15-other", "traffic": "closed-c4-512",
                           "chips": 1, "why": "x"})
    assert registry.config(b, "sd15-other", root=tmp_path)["name"] == "sd15-other"
    assert registry.traffic("closed-c4-512", base=bench_dir)["clients"] == 4
    assert registry.metric("requests_seen", base=bench_dir).read(type("R", (), {"log": [1, 2]})) == 2
    assert registry.limits("sd15-other-c4", base=bench_dir) == {"image_rms": 1.0}
    assert all(p.read_bytes() == data for p, data in before.items())
