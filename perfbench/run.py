"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload sd15-serve-c16 --seed 1234 --seconds 40 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced, a
``breakdown``; its last key, ``checks``, gives each number of the
correctness comparison beside its limit, as do the last lines of standard
error.  Without a card, or with fewer than the cell asks for, it exits 2 and
prints no result.  ``--dry-run`` rehearses the whole run on the CPU at the
configuration's tiny stand-in (``configs/<name>.tiny.json``) and the mix's
``dry_run`` sizes; ``--control MODE`` runs the lower-precision control of
the comparison: the program's own int8 path (``w8a8``), or the reference in
float8 in the program's place (``fp8``).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stablediffusion_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one the
    port may not load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Readings:
    """What the metric readers take from a run."""

    def __init__(self, result: dict, spec: dict, mix: dict, device_name: str, setup_s: float):
        self.__dict__.update(result)
        self.spec, self.mix, self.device_name, self.setup_s = spec, mix, device_name, setup_s
        self._work = {}

    def work(self, rows: int):
        """The work one merged call or step of `rows` rows implies
        (``harness/flops.py``)."""
        if rows not in self._work:
            from perfbench.harness import flops
            from perfbench.harness.weights import DTYPES

            served = {k: DTYPES[v] for k, v in self.spec["served_dtypes"].items()}
            m = self.mix
            if m["kind"] == "serve":
                self._work[rows] = flops.txt2img_work(self.spec, served, rows, m["size"], m["steps"])
            else:
                t = m["trainer"]
                self._work[rows] = flops.lora_train_work(self.spec, served, rows, t["resolution"],
                                                         t.get("rank", 16), t.get("vae_microbatch", 8))
        return self._work[rows]


def _number(v):
    """A finite float, or None (JSON has no infinity): a check that could not
    be read, or a tail over failed requests."""
    return float(v) if math.isfinite(v) else None


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--control", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.harness import manifest, registry

    bench = manifest.load(ROOT / "BENCHMARK.json")
    cell = manifest.workload(bench, args.workload)

    import torch

    if args.dry_run:
        device, device_name = torch.device("cpu"), "cpu"
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device, device_name = torch.device("cuda", 0), torch.cuda.get_device_name(0)
    spec = registry.config(bench, cell["config"], tiny=args.dry_run)
    mix = registry.traffic(cell["traffic"], dry_run=args.dry_run)
    ctx = SimpleNamespace(spec=spec, mix=mix, device=device, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), control=args.control, t_process=T_PROCESS, drain_s=60.0)
    result = registry.driver(mix["kind"]).run(ctx)

    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 3

    r = Readings(result, spec, mix, device_name, result["setup_s"])
    metrics = {}
    for m in manifest.metrics_of(bench, args.workload, bool(args.trace)):
        value = registry.metric(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": device_name,
                   "count": cell["chips"], "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = {"correct": None, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device_info}
    tr = result.get("trace")
    if args.trace and tr is not None and tr.window_s > 0:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    lim = registry.limits(args.workload)
    for k, v in result["checks"].items():
        if k not in lim:  # read, not compared
            print(f"reading {k} {v!r}", file=sys.stderr)
    checks = {k: {"value": _number(result["checks"].get(k, math.inf)), "limit": v}
              for k, v in lim.items()}
    line["correct"] = bool(result["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} (samples {result['compared']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
