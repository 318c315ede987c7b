"""Build and time copies of the attention kernels' sources on the card: what
``utils/flash_fwd_ablation``, ``utils/flash_stream_ablation`` and
``utils/flash_bwd_ablation`` share.

A copy is a ``.cu`` file beside the headers it includes (this package's
``csrc/*.cuh`` as they are, or edited copies of them): :func:`write_sources`
writes each into a directory of its own, :func:`build` compiles them all with
the build's flags, one ``nvcc`` each, started together, and loads each as a
library whose entries take the arguments of the package's own.  Times come
from torch.profiler's kernel events (:func:`device_ms`: the median of 20
launches, the kernel's own time) or from CUDA events around 10 launches
(:func:`event_ms`, the wrapper's host work included).  Nothing here runs at
import time; the functions need a card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

from stablediffusion_tpu_torch.ops import _build


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def drop_lines(src: str, lines) -> str:
    """`src` without each of `lines`, each found once."""
    for line in lines:
        assert src.count(line) == 1, line
        src = src.replace(line, "")
    return src


def drop_calls(src: str, name: str) -> str:
    """`src` without the statements that call `name` (lines that start,
    after their indent, with ``name(``); at least one."""
    lines = src.splitlines(keepends=True)
    kept = [ln for ln in lines if not ln.lstrip().startswith(name + "(")]
    assert len(kept) < len(lines), name
    return "".join(kept)


def cut(src: str, start: str, end: str, keep_end: bool = True) -> str:
    """`src` without the text from `start` up to `end` (kept, or not)."""
    a, b = src.index(start), src.index(end)
    assert a < b and src.count(start) == 1 and src.count(end) == 1, start
    return src[:a] + src[b if keep_end else b + len(end):]


def no_copies(src: str, loads: int) -> str:
    """Every expect_tx of `src` becomes a plain arrival and none of its
    `loads` TMA copies (``tma_load(`` calls) is issued: the barriers
    complete at once and the products run on whatever shared memory holds."""
    out = []
    for line in src.splitlines(keepends=True):
        if "mbar_expect_tx(" in line:
            bar = line.split("mbar_expect_tx(", 1)[1].rsplit(",", 1)[0]
            line = line.split("mbar_expect_tx(")[0] + f"mbar_arrive({bar});\n"
        out.append(line)
    src = "".join(out)
    assert src.count("tma_load(") == loads
    return src.replace("tma_load(", "if (false) tma_load(")


def write_sources(out_dir: Path, source: str, variants: Dict[str, dict]) -> Dict[str, Path]:
    """Each variant (name -> {file name: text}, the files it changes) into
    ``out_dir/<name>/``, with the package's ``<source>.cu`` and headers for the
    files it leaves as they are; returns name -> the variant's ``.cu``."""
    paths = {}
    for name, files in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        shutil.copy(_build.CSRC / f"{source}.cu", d / f"{source}.cu")
        for fname, text in files.items():
            (d / fname).write_text(text)
        paths[name] = d / f"{source}.cu"
    return paths


def build(out_dir: Path, sources: Dict[str, Path], entries: Iterable[str],
          report: Optional[Callable[[dict], bool]] = None) -> Dict[str, ctypes.CDLL]:
    """Compile every source (name -> ``.cu`` path, which finds its headers
    beside it) into ``out_dir/<name>.so``, one nvcc each, all started
    together; print the registers and spills that ptxas reports for the
    kernels `report` keeps; set the argument types of the kernel `entries`
    (names of ``_build.ENTRIES``).  Returns name -> library."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    entries = list(entries)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        if report is not None:
            print(json.dumps({"ptxas": name, "kernels": [
                u for u in _build.ptxas_usage(log) if report(u)]}), flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for kernel in entries:
            fn = getattr(lib, _build.ENTRIES[kernel][1])
            fn.argtypes = _build.ENTRIES[kernel][2]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(launch: Callable[[], None], key: str, reps: int = 20) -> float:
    """Median device time of `reps` launches of the kernel whose name holds
    `key`, from torch.profiler's kernel events, after a warm-up; a profiling
    run that kept no event of it is repeated, up to three runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and key in e.name]
        if us:
            return statistics.median(us) / 1e3
    raise RuntimeError(f"torch.profiler kept no event of {key} in 3 runs")


def event_ms(launch: Callable[[], None]) -> list:
    """Mean time of 10 launches by CUDA events after a warm-up, twice."""
    times = []
    for _ in range(2):
        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return times
