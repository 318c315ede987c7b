"""A1111 prompt editing and alternation: the per-step prompt schedule.

The port's own copy of ``stablediffusion_tpu/utils/prompt_edit.py``, which
imports nothing of JAX (the standard library only); the code below is that
module's, unchanged, so both packages realise the same prompts at the same
steps.

``[from:to:when]`` switches the conditioning text mid-denoise (``when`` < 1
is a fraction of the steps, >= 1 an absolute step); ``[to:when]`` adds text
from ``when`` on; ``[a|b]`` cycles its options per step.  The pipelines
apply it only under ``prompt_weighting=True`` (the default path treats
brackets literally).  Each unique realised prompt is encoded once, and the
denoise loop picks the active embedding by step index.  Boundaries are in
full-schedule steps; the callers shift them by the steps a strength or
denoising_start window skips.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

_BRACKET_RE = re.compile(r"\[([^\[\]]+)\]")  # non-nested bracket groups
_NUM_RE = re.compile(r"^\d+(?:\.\d+)?$|^\.\d+$")


def _boundary(when: str, steps: int) -> int:
    w = float(when)
    step = int(w) if w >= 1.0 else int(w * steps)
    return max(0, min(step, steps))


def _split_top(content: str) -> List[str]:
    """Split on colons OUTSIDE parentheses, so emphasis weights inside an
    edit segment — ``[(cat:1.3):dog:0.5]`` — don't confuse the fields."""
    parts, buf, depth = [], [], 0
    for ch in content:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == ":" and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts


def _split_alt(content: str) -> Optional[List[str]]:
    """Top-level '|' split (outside parens) -> alternation options, or None
    when the bracket has no top-level pipe."""
    parts, buf, depth = [], [], 0
    has_pipe = False
    for ch in content:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == "|" and depth == 0:
            has_pipe = True
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts if has_pipe else None


def realize_at(text: str, step: int, steps: int) -> str:
    """The concrete prompt at one denoise step: ``[a|b]`` alternation cycles
    per step, ``[from:to:when]`` edits switch at their boundary, plain
    ``[attention]`` brackets pass through untouched."""
    out, pos = [], 0
    for m in _BRACKET_RE.finditer(text):
        content = m.group(1)
        alts = _split_alt(content)
        if alts is not None:
            repl = alts[step % len(alts)]
        else:
            parts = _split_top(content)
            if len(parts) in (2, 3) and _NUM_RE.match(parts[-1].strip()):
                boundary = _boundary(parts[-1].strip(), steps)
                if len(parts) == 2:
                    before, after = "", parts[0]
                else:
                    before, after = parts[0], parts[1]
                repl = after if step >= boundary else before
            else:
                repl = m.group(0)  # attention bracket: keep verbatim
        out.append(text[pos : m.start()])
        out.append(repl)
        pos = m.end()
    out.append(text[pos:])
    return "".join(out)


def schedule_prompts(
    texts: List[str], steps: int
) -> Optional[Tuple[List[int], List[List[str]]]]:
    """Per-step realization for a whole batch, deduplicated into intervals:
    (starts, variants) where variants[k] applies from starts[k] on.  None
    when no prompt contains editing or alternation syntax (the realized
    text never changes AND equals the raw text)."""
    steps = max(int(steps), 1)
    per_step = [[realize_at(t, i, steps) for t in texts]
                for i in range(steps)]
    if all(p == list(texts) for p in per_step):
        return None
    starts, variants = [0], [per_step[0]]
    for i in range(1, steps):
        if per_step[i] != variants[-1]:
            starts.append(i)
            variants.append(per_step[i])
    return starts, variants


def unique_variants(
    variants: List[List[str]],
) -> Tuple[List[List[str]], List[int]]:
    """Deduplicate interval variants -> (uniques, idx_map): uniques[0] is
    always variants[0] (the interval-0 texts), idx_map[k] indexes uniques
    for interval k.  Alternation would otherwise encode the same 2 prompts
    once per step."""
    uniq: List[List[str]] = []
    seen = {}
    idx_map: List[int] = []
    for v in variants:
        key = tuple(v)
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(list(v))
        idx_map.append(seen[key])
    return uniq, idx_map
