"""A1111 prompt emphasis and long-prompt chunks.

The port's own copy of ``stablediffusion_tpu/utils/prompt_weights.py``: the
parser and the tokenizing helpers (``parse_weighted_prompt``,
``strip_weight_markup``, ``encode_with_weights``, ``token_stream``,
``num_chunks``, ``encode_chunked``) are that module's, unchanged (numpy and
the standard library only); ``apply_token_weights`` is ported to tensors.

``(word)`` / ``((word))`` boost by 1.1 a level, ``[word]`` attenuates by
1/1.1, ``(phrase:1.5)`` sets the multiplier, ``\\(`` escapes a bracket.  The
pipelines apply it only under ``prompt_weighting=True``: per-token weights
scale the text encoder's hidden states, then the whole embedding is
rescaled so its mean matches the unweighted one.  Pooled outputs are never
reweighted.  Prompts of more than 75 tokens encode in chunks of 75, each
with its own BOS and EOS, their hidden states concatenated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ROUND_MULT = 1.1
SQUARE_MULT = 1.0 / 1.1


def parse_weighted_prompt(text: str) -> List[Tuple[str, float]]:
    """Split emphasis markup into (fragment, weight) runs, in reading order.

    Nesting multiplies; an explicit ``:w`` before the closing paren overrides
    that paren's 1.1; unmatched openers still apply their multiplier to the
    rest of the prompt; unmatched closers are literal text.
    """
    frags: List[List] = []  # [text, weight]
    stack: List[Tuple[str, int]] = []  # (bracket char, frags index at open)
    buf: List[str] = []

    def flush():
        if buf:
            frags.append(["".join(buf), 1.0])
            buf.clear()

    def apply(start: int, mult: float):
        flush()
        for f in frags[start:]:
            f[1] *= mult

    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\\" and i + 1 < n and text[i + 1] in "()[]\\":
            buf.append(text[i + 1])
            i += 2
            continue
        if c in "([":
            flush()
            stack.append((c, len(frags)))
            i += 1
            continue
        if c == ":" and stack and stack[-1][0] == "(":
            # weight lookahead must stay inside the CURRENT paren scope: any
            # intervening bracket means this ':' is not a weight separator
            close, j = -1, i + 1
            while j < n:
                ch = text[j]
                if ch == "\\" and j + 1 < n and text[j + 1] in "()[]\\":
                    j += 2
                    continue
                if ch == ")":
                    close = j
                    break
                if ch in "([]":
                    break
                j += 1
            if close != -1:
                try:
                    w = float(text[i + 1 : close].strip())
                except ValueError:
                    w = None
                if w is not None:
                    _, start = stack.pop()
                    apply(start, w)
                    i = close + 1
                    continue
        if c == ")" and stack and stack[-1][0] == "(":
            _, start = stack.pop()
            apply(start, ROUND_MULT)
            i += 1
            continue
        if c == "]" and stack and stack[-1][0] == "[":
            _, start = stack.pop()
            apply(start, SQUARE_MULT)
            i += 1
            continue
        buf.append(c)
        i += 1
    flush()
    # unclosed openers emphasize through end-of-prompt
    for bracket, start in stack:
        mult = ROUND_MULT if bracket == "(" else SQUARE_MULT
        for f in frags[start:]:
            f[1] *= mult
    # merge adjacent equal-weight runs so fragment boundaries don't multiply
    merged: List[List] = []
    for t, w in frags:
        if merged and merged[-1][1] == w:
            merged[-1][0] += t
        else:
            merged.append([t, w])
    return [(t, w) for t, w in merged] or [("", 1.0)]


def strip_weight_markup(text: str) -> str:
    """The prompt with all emphasis markup removed (for non-CLIP encoders)."""
    return "".join(t for t, _ in parse_weighted_prompt(text))


def encode_with_weights(
    tokenizer, texts: Sequence[str], max_length: int | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize emphasis-marked prompts -> (ids [B,L] int32, weights [B,L]
    fp32).  BOS/EOS/pad carry weight 1.0.  Fragment-wise tokenization matches
    whole-string tokenization except when markup splits a word — the same
    convention users already know from the webui."""
    max_length = max_length or tokenizer.model_max_length
    rows, wrows = [], []
    for t in texts:
        ids, ws = token_stream(tokenizer, t)
        ids, ws = ids[: max_length - 2], ws[: max_length - 2]
        row = [tokenizer.bos_token_id, *ids, tokenizer.eos_token_id]
        wrow = [1.0, *ws, 1.0]
        if len(row) < max_length:
            pad = max_length - len(row)
            row += [tokenizer.pad_token_id] * pad
            wrow += [1.0] * pad
        rows.append(row)
        wrows.append(wrow)
    return np.asarray(rows, np.int32), np.asarray(wrows, np.float32)


def token_stream(
    tokenizer, text: str
) -> Tuple[List[int], List[float]]:
    """Untruncated (ids, weights) for one emphasis-marked prompt — the raw
    stream that chunked encoding windows over."""
    ids: List[int] = []
    ws: List[float] = []
    for frag, w in parse_weighted_prompt(text):
        fids = tokenizer.tokenize(frag)
        ids.extend(fids)
        ws.extend([w] * len(fids))
    return ids, ws


def num_chunks(tokenizer, text: str, window: int = 75) -> int:
    ids, _ = token_stream(tokenizer, text)
    return max(1, -(-len(ids) // window))


def encode_chunked(
    tokenizer,
    texts: Sequence[str],
    k: int,
    max_length: int | None = None,
    streams: Optional[Sequence[Tuple[List[int], List[float]]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A1111 long-prompt mode: window the untruncated token stream into
    ``k`` chunks of ``max_length-2`` content tokens, each wrapped in its own
    BOS/EOS -> (ids [B, k, L] int32, weights [B, k, L] fp32).  Prompts
    shorter than k windows pad with empty (BOS EOS PAD...) chunks, so every
    batch member and the negative side share one sequence length.
    ``streams`` supplies precomputed token_stream results (the chunk-count
    scan already paid for them)."""
    max_length = max_length or tokenizer.model_max_length
    window = max_length - 2
    rows = np.full((len(texts), k, max_length), tokenizer.pad_token_id,
                   np.int32)
    wrows = np.ones((len(texts), k, max_length), np.float32)
    for b, t in enumerate(texts):
        ids, ws = streams[b] if streams is not None else token_stream(
            tokenizer, t
        )
        ids, ws = ids[: k * window], ws[: k * window]
        for c in range(k):
            part = ids[c * window : (c + 1) * window]
            wpart = ws[c * window : (c + 1) * window]
            rows[b, c, 0] = tokenizer.bos_token_id
            rows[b, c, 1 : 1 + len(part)] = part
            rows[b, c, 1 + len(part)] = tokenizer.eos_token_id
            wrows[b, c, 1 : 1 + len(wpart)] = wpart
    return rows, wrows


def apply_token_weights(hidden: torch.Tensor, weights) -> torch.Tensor:
    """Scale token hidden states [B, L, D] by per-token weights [B, L], then
    restore each sample's mean; a weighted mean within 1e-12 of zero skips
    the restore (``prompt_weights.py:193``)."""
    w = torch.as_tensor(np.asarray(weights), device=hidden.device)[:, :, None].to(hidden.dtype)
    mean0 = hidden.mean(dim=(1, 2), keepdim=True)
    scaled = hidden * w
    mean1 = scaled.mean(dim=(1, 2), keepdim=True)
    ok = mean1.abs() > 1e-12
    safe = torch.where(ok, mean1, torch.ones_like(mean1))
    ratio = torch.where(ok, mean0 / safe, torch.ones_like(mean0))
    return scaled * ratio
