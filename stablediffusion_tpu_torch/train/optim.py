"""LR schedules and the optimizer of the LoRA train step.

Port of the fp32 subset of ``stablediffusion_tpu/train/optim.py``:
``make_lr_schedule`` with the six diffusers schedule names, evaluated at the
same 0-based update count as optax, and ``make_optimizer``'s chain of
``optax.clip_by_global_norm`` and ``optax.adamw`` with weight decay masked to
leaves of two or more dims (``optim.py:131-172``).  Clipping uses optax's
rule, g * max / ||g|| only when ||g|| >= max (``torch.nn.utils
.clip_grad_norm_`` adds 1e-6 to the norm and is not the same).

The optimizer is functional in its interface, as optax is: ``init(params)``
gives a state, ``update(grads, state, params)`` gives (params, state).
Params are nested dicts of tensors (a LoRA tree).  To keep one copy of each
tensor, ``update`` writes the new params and moments in place and returns
the same dicts.

The blockwise 8-bit Adam (``use_8bit``) and gradient accumulation
(``grad_accum_steps > 1``) come with the trainer slice and raise here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule (linear_schedule at power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) ** power + end

    return schedule


def _cosine_decay(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0, exponent 1."""
    def schedule(count: int) -> float:
        count = min(count, steps)
        return init * 0.5 * (1 + math.cos(math.pi * count / steps))

    return schedule


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """optax.join_schedules: past each boundary, the next schedule counted
    from that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def make_lr_schedule(
    name: str,
    lr: float,
    warmup_steps: int = 0,
    total_steps: int = 10_000,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Schedule:
    """count -> learning rate for the schedule `name`: constant,
    constant_with_warmup, linear, cosine, cosine_with_restarts or
    polynomial."""
    warmup = _polynomial(0.0, lr, 1.0, max(warmup_steps, 1))
    rest = max(total_steps - warmup_steps, 1)
    if name == "constant":
        return lambda count: lr
    if name == "constant_with_warmup":
        return _join([warmup, lambda count: lr], [warmup_steps])
    if name == "linear":
        return _join([warmup, _polynomial(lr, 0.0, 1.0, rest)], [warmup_steps])
    if name == "cosine":
        return _join([warmup, _cosine_decay(lr, rest)], [warmup_steps])
    if name == "cosine_with_restarts":
        n = max(int(num_cycles), 1)
        per = max(rest // n, 1)
        decay = _join([_cosine_decay(lr, per) for _ in range(n)],
                      [per * i for i in range(1, n)])
        return _join([warmup, decay], [warmup_steps])
    if name == "polynomial":
        return _join([warmup, _polynomial(lr, 0.0, power, rest)], [warmup_steps])
    raise ValueError(f"unknown lr schedule {name!r}")


def tree_leaves(tree: Mapping) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of a nested dict, in key order."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out += [(f"{k}.{p}", t) for p, t in tree_leaves(v)]
        else:
            out.append((str(k), v))
    return out


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), fp32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class AdamW:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(...)) with the
    decay masked to leaves of ndim >= 2."""

    def __init__(self, lr_schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: Optional[float]):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Mapping) -> Dict:
        zeros = lambda: {p: torch.zeros_like(t) for p, t in tree_leaves(params)}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Mapping, state: Dict, params: Mapping) -> Tuple[Mapping, Dict]:
        """One step: clip, Adam moments with bias correction, decoupled
        weight decay, times -lr(count).  `grads` has the same tree as
        `params`.  Params and moments are updated in place."""
        named = tree_leaves(params)
        g = [t.float() for _, t in tree_leaves(grads)]
        if self.max_grad_norm:
            norm = global_norm(g)
            if not norm < self.max_grad_norm:
                g = [t / norm * self.max_grad_norm for t in g]
        count = state["count"] + 1
        lr = self.lr_schedule(state["count"])
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        for (path, p), gi in zip(named, g):
            mu, nu = state["mu"][path], state["nu"][path]
            mu.mul_(self.b1).add_(gi, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(gi, gi, value=1.0 - self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            if p.dim() >= 2:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        state["count"] = count
        return params, state


def make_optimizer(
    lr_schedule: Schedule,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_eps: float = 1e-8,
    weight_decay: float = 1e-2,
    max_grad_norm: Optional[float] = 1.0,
    grad_accum_steps: int = 1,
    use_8bit: bool = False,
) -> AdamW:
    if use_8bit:
        raise NotImplementedError(
            "use_8bit: the blockwise 8-bit Adam comes with the trainer slice "
            "of the port (ROADMAP §1 item 19)"
        )
    if grad_accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1: gradient accumulation comes with the "
            "trainer slice of the port (ROADMAP §1 item 19)"
        )
    return AdamW(lr_schedule, adam_beta1, adam_beta2, adam_eps, weight_decay,
                 max_grad_norm)
