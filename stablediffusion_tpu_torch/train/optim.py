"""LR schedules and the optimizer of the LoRA train step.

Port of ``stablediffusion_tpu/train/optim.py``: ``make_lr_schedule`` with
the six diffusers schedule names, evaluated at the same 0-based update count
as optax, and ``make_optimizer``'s chain of ``optax.clip_by_global_norm``
and ``optax.adamw`` with weight decay masked to leaves of two or more dims
(``optim.py:131-172``).  Clipping uses optax's rule, g * max / ||g|| only
when ||g|| >= max (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm
and is not the same).

``use_8bit`` stores the Adam moments as the JAX package's blockwise 8-bit
codes (``scale_by_adam_8bit``, :179-290): leaves of at least
``MIN_QUANT_SIZE`` elements keep an int8 sqrt-companded first moment and a
uint8 sqrt-companded second moment against a per-``BLOCK_SIZE`` absmax
scale; smaller leaves keep fp32 moments.  The recurrences are written in
the JAX version's order of operations, so that the same gradients give the
same codes.

``grad_accum_steps > 1`` wraps the chain in gradient accumulation:
``optax.MultiSteps`` (``accum_dtype`` "fp32"), whose fp32 accumulator is
Welford's running mean acc + (g - acc) / (n + 1), or ``multi_steps_lowmem``
("bf16", :62-128), a bf16 running sum whose fp32 mean is taken every k-th
call.  On the other calls nothing moves: not the params, not the inner
chain's count.

The optimizer is functional in its interface, as optax is: ``init(params)``
gives a state, ``update(grads, state, params)`` gives (params, state).
Params are nested dicts of tensors (a LoRA tree).  To keep one copy of each
tensor, ``update`` writes the new params and moments in place and returns
the same dicts.  A state is a dict of tensors, ``QuantizedMoment``s and
ints (``count``, ``mini_step``), which ``train/checkpoint.py`` stores.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

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


def unflatten(like: Mapping, values) -> Dict:
    """`values` (in ``tree_leaves`` order) in the nested-dict shape of `like`."""
    it = iter(values)

    def build(node):
        return {k: build(v) if isinstance(v, Mapping) else next(it) for k, v in node.items()}

    return build(like)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), fp32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


# -- blockwise 8-bit moments (optim.py:179-290) ------------------------------

BLOCK_SIZE = 256
MIN_QUANT_SIZE = 4096  # bitsandbytes min_8bit_size: smaller leaves stay fp32


class QuantizedMoment(NamedTuple):
    """One moment as 8-bit codes over the flattened, zero-padded leaf, [n
    blocks, BLOCK_SIZE] (int8 for the first moment, uint8 for the second),
    and each block's absmax, fp32 [n blocks]."""

    q: torch.Tensor
    scale: torch.Tensor


def _blocked(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK_SIZE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK_SIZE)


def quantize_m(x: torch.Tensor) -> QuantizedMoment:
    """Signed codes round(sqrt(|x| / absmax) * 127) * sign(x)."""
    xb = _blocked(x.float())
    scale = xb.abs().amax(dim=1)
    frac = xb.abs() / scale.clamp_min(1e-30)[:, None]
    q = torch.sign(xb) * torch.round(torch.sqrt(frac) * 127.0)
    return QuantizedMoment(q.to(torch.int8), scale)


def quantize_v(x: torch.Tensor) -> QuantizedMoment:
    """Unsigned codes round(sqrt(x / max) * 255) of a non-negative moment."""
    xb = _blocked(x.float())
    scale = xb.amax(dim=1)
    q = torch.round(torch.sqrt(xb / scale.clamp_min(1e-30)[:, None]) * 255.0)
    return QuantizedMoment(q.to(torch.uint8), scale)


def dequantize(mom: QuantizedMoment, like: torch.Tensor) -> torch.Tensor:
    """The fp32 moment of `like`'s shape that `mom` codes."""
    if mom.q.dtype == torch.int8:
        frac = mom.q.float() / 127.0
        vals = torch.sign(frac) * frac * frac * mom.scale[:, None]
    else:
        frac = mom.q.float() / 255.0
        vals = frac * frac * mom.scale[:, None]
    return vals.reshape(-1)[: like.numel()].reshape(like.shape)


Moment = Union[torch.Tensor, QuantizedMoment]


class AdamW:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(...)) with the
    decay masked to leaves of ndim >= 2; with `use_8bit`, the chain of
    ``scale_by_adam_8bit``, the masked ``add_decayed_weights`` and
    ``scale_by_learning_rate`` (``make_optimizer``, :143-149)."""

    def __init__(self, lr_schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: Optional[float],
                 use_8bit: bool = False):
        # the clipping norm of the gradient leaves; ZeRO-1
        # (parallel/zero.ZeroOptimizer) sets the norm of the whole gradient
        # from a rank's slices when it wraps this optimizer
        self.norm_fn = global_norm
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.use_8bit = use_8bit

    def _zero_moment(self, t: torch.Tensor, quantize) -> Moment:
        z = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        return quantize(z) if self.use_8bit and t.numel() >= MIN_QUANT_SIZE else z

    def init(self, params: Mapping) -> Dict:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": {p: self._zero_moment(t, quantize_m) for p, t in leaves},
                "nu": {p: self._zero_moment(t, quantize_v) for p, t in leaves}}

    @torch.no_grad()
    def update(self, grads: Mapping, state: Dict, params: Mapping) -> Tuple[Mapping, Dict]:
        """One step: clip, Adam moments with bias correction, decoupled
        weight decay, times -lr(count).  `grads` has the same tree as
        `params`.  Params and moments are updated in place."""
        named = tree_leaves(params)
        g = [t.float() for _, t in tree_leaves(grads)]
        if self.max_grad_norm:
            norm = self.norm_fn(g)
            if not norm < self.max_grad_norm:
                g = [t / norm * self.max_grad_norm for t in g]
        count = state["count"] + 1
        lr = self.lr_schedule(state["count"])
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        for (path, p), gi in zip(named, g):
            if self.use_8bit:
                u = self._moments_8bit(state, path, gi, bc1, bc2)
            else:
                mu, nu = state["mu"][path], state["nu"][path]
                mu.mul_(self.b1).add_(gi, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(gi, gi, value=1.0 - self.b2)
                u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            if p.dim() >= 2:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        state["count"] = count
        return params, state

    def _moments_8bit(self, state: Dict, path: str, g: torch.Tensor,
                      bc1: float, bc2: float) -> torch.Tensor:
        """Advance one leaf's moments in fp32 in scale_by_adam_8bit's order
        of operations (:263-268), store them back (requantized where they
        were codes), and return the Adam direction."""
        m_s, v_s = state["mu"][path], state["nu"][path]
        quantized = isinstance(m_s, QuantizedMoment)
        m = dequantize(m_s, g) if quantized else m_s
        v = dequantize(v_s, g) if quantized else v_s
        m = self.b1 * m + (1.0 - self.b1) * g
        v = self.b2 * v + (1.0 - self.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        state["mu"][path] = quantize_m(m) if quantized else m
        state["nu"][path] = quantize_v(v) if quantized else v
        return u


class MultiSteps:
    """Gradient accumulation around an inner optimizer: the inner update
    runs on every `every_k`-th call with the mean of the last `every_k`
    gradients; the other calls only accumulate.  ``acc_dtype`` fp32 is
    ``optax.MultiSteps`` (Welford's running mean), bf16 is
    ``multi_steps_lowmem`` (a bf16 running sum, divided by k in fp32)."""

    def __init__(self, inner: AdamW, every_k: int, acc_dtype: torch.dtype = torch.float32):
        self.inner, self.every_k, self.acc_dtype = inner, every_k, acc_dtype

    def init(self, params: Mapping) -> Dict:
        return {"mini_step": 0,
                "acc": {p: torch.zeros(t.shape, dtype=self.acc_dtype, device=t.device)
                        for p, t in tree_leaves(params)},
                "inner": self.inner.init(params)}

    @torch.no_grad()
    def update(self, grads: Mapping, state: Dict, params: Mapping) -> Tuple[Mapping, Dict]:
        n = state["mini_step"]
        acc = state["acc"]
        for path, g in tree_leaves(grads):
            if self.acc_dtype == torch.float32:
                acc[path] = acc[path] + (g.float() - acc[path]) / (n + 1)
            else:
                acc[path] = acc[path] + g.to(self.acc_dtype)
        if n == self.every_k - 1:
            if self.acc_dtype == torch.float32:
                mean = dict(acc)
            else:
                mean = {p: a.float() / self.every_k for p, a in acc.items()}
            mean_tree = unflatten(params, [mean[p] for p, _ in tree_leaves(params)])
            params, state["inner"] = self.inner.update(mean_tree, state["inner"], params)
            for a in acc.values():
                a.zero_()
        state["mini_step"] = (n + 1) % self.every_k
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
    accum_dtype: Optional[str] = None,
) -> Union[AdamW, MultiSteps]:
    """The optimizer of ``make_optimizer`` (:131-168): `accum_dtype` None or
    "fp32" accumulates as optax.MultiSteps, "bf16"/"bfloat16" as
    multi_steps_lowmem."""
    opt = AdamW(lr_schedule, adam_beta1, adam_beta2, adam_eps, weight_decay,
                max_grad_norm, use_8bit=use_8bit)
    if grad_accum_steps > 1:
        low = accum_dtype in ("bf16", "bfloat16")
        return MultiSteps(opt, grad_accum_steps, torch.bfloat16 if low else torch.float32)
    return opt
