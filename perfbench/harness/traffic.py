"""The one traffic generator: a mix file's parameters and the run's seed ->
the requests each client sends, in order.  Every seed gives the same sizes,
steps and guidance (the mix fixes them); the seed draws the words, their
count, which requests carry a negative prompt, and each request's own seed."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def vocabulary(rng: np.random.Generator, n: int = 512) -> List[str]:
    """`n` lower-case words of 2 to 9 letters."""
    lengths = rng.integers(2, 10, size=n)
    return ["".join(rng.choice(list(LETTERS), size=int(k))) for k in lengths]


def serve_requests(mix: dict, seed: int) -> List[List[Dict]]:
    """[client][i] -> the i-th txt2img request of that client."""
    rng = np.random.default_rng([int(seed) % 2**63, 7])
    words = vocabulary(rng)

    def text(lo: int, hi: int) -> str:
        return " ".join(rng.choice(words, size=int(rng.integers(lo, hi + 1))))

    out = []
    for _ in range(mix["clients"]):
        reqs = []
        for _ in range(mix["requests_per_client"]):
            req = {"prompt": text(mix["min_words"], mix["max_words"]),
                   "height": mix["size"], "width": mix["size"],
                   "num_inference_steps": mix["steps"], "guidance_scale": mix["guidance"],
                   "seed": int(rng.integers(0, 2**31 - 1))}
            if rng.random() < mix["negative_share"]:
                req["negative_prompt"] = text(mix["min_negative_words"], mix["max_negative_words"])
            reqs.append(req)
        out.append(reqs)
    return out
