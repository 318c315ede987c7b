"""Nothing the harness loads is JAX or the JAX package: a dry run of the
harness's whole path on the CPU, then the loaded modules' top-level names,
compared whole (the port's name begins with the JAX package's).  And the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "stablediffusion_tpu"}

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {bench!r})
import run
rc = run.main(["--workload", "sd15-serve-c16", "--seed", "4294967311", "--seconds", "3",
               "--trace", "0", "--dry-run"])
print(json.dumps({{"rc": rc, "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_dry_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT), bench=str(BENCH))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result, loaded = json.loads(lines[-2]), json.loads(lines[-1])
    assert loaded["rc"] == 0 and result["correct"] is True
    assert "stablediffusion_tpu_torch" in loaded["top"]  # the port did run
    assert not FORBIDDEN & set(loaded["top"])


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    import run

    before = set(sys.modules)
    sys.modules["stablediffusion_tpu_torch_fake.x"] = object()
    sys.modules["jaxfoo"] = object()
    try:
        assert not set(run.forbidden_modules()) - (FORBIDDEN & {m.split(".")[0] for m in before})
        sys.modules["jax.numpy"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"stablediffusion_tpu_torch"}, (path, n)


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the run fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sd15-serve-c16", "--seed", "1",
                          "--seconds", "2", "--trace", "0", "--dry-run"],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
