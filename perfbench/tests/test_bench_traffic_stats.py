"""The traffic generator repeats from a seed; the rate and percentile
arithmetic over a log with a stall and a drain."""

import json
import math
from pathlib import Path

import pytest

from perfbench.harness import stats, traffic
from perfbench.reference import pipeline

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json") if json.loads(p.read_text())["kind"] == "serve")


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = json.loads((TRAFFIC / f"{mix}.json").read_text())
    assert traffic.serve_requests(m, 2**31 + 17) == traffic.serve_requests(m, 2**31 + 17)
    a, b = traffic.serve_requests(m, 1), traffic.serve_requests(m, 2)
    assert a != b
    # every seed sends the same sizes, steps and guidance
    for reqs in (a, b):
        for r in (r for c in reqs for r in c):
            assert (r["height"], r["width"], r["num_inference_steps"], r["guidance_scale"]) == \
                (m["size"], m["size"], m["steps"], m["guidance"])
            words = r["prompt"].split()
            assert m["min_words"] <= len(words) <= m["max_words"]


@pytest.mark.parametrize("mix", MIXES)
def test_reference_tokenizer_agrees_with_the_ports(mix):
    from perfbench.harness import program

    m = json.loads((TRAFFIC / f"{mix}.json").read_text())
    reqs = [r for c in traffic.serve_requests(m, 3) for r in c][:40]
    for pad in (49407, 0):
        tok = program.tokenizer(pad)
        for r in reqs:
            for text in (r["prompt"], r.get("negative_prompt", "")):
                assert tok([text]).tolist()[0] == pipeline.tokenize(text, pad)


def test_training_images_repeat_from_the_seed(tmp_path):
    """The same seed writes the same JPEGs byte for byte; no image is its
    own mirror, so the dataset's flips reach the pixels."""
    import numpy as np
    from PIL import Image

    from perfbench.harness import train

    mix = json.loads((TRAFFIC / "lora-b16-512.json").read_text())
    for d in ("a", "b"):
        train.write_images(tmp_path / d, 3, 64, 2**31 + 3, mix)
    for f in sorted((tmp_path / "a").iterdir()):
        assert f.read_bytes() == (tmp_path / "b" / f.name).read_bytes()
        if f.suffix == ".jpg":
            a = np.asarray(Image.open(f), np.float32)
            assert a.shape == (64, 64, 3) and np.abs(a - a[:, ::-1]).mean() > 10
        else:
            assert all(w.isalpha() and w.islower() for w in f.read_text().split())


def test_rate_counts_the_stall_and_the_drain():
    # 10 requests; a 5 s stall after the 4th; the window closes at 8 s and the
    # drain finishes the last reply at 12 s
    log = [{"t_submit": i, "t_done": i + 1.0, "ok": True} for i in range(4)]
    log += [{"t_submit": 4.0, "t_done": 9.0, "ok": True}]
    log += [{"t_submit": 9.0 + i * 0.5, "t_done": 9.5 + i * 0.5, "ok": True} for i in range(4)]
    log += [{"t_submit": 11.0, "t_done": 12.0, "ok": False}]
    done = sum(r["ok"] for r in log)
    assert stats.rate(done, 0.0, max(r["t_done"] for r in log)) == pytest.approx(9 / 12)
    lat = stats.latencies(log)
    assert lat[-1] == math.inf and lat[4] == 5.0
    assert stats.percentile(lat, 90) == math.inf  # the failure sits at the top
    assert stats.percentile(lat[:-1], 50) == pytest.approx(1.0)
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)
    with pytest.raises(ValueError):
        stats.rate(1, 5.0, 5.0)
