"""Tensor parallelism of the denoiser's attention and MLP projections.

Port of ``stablediffusion_tpu/parallel/tp.py``: the same suffix rule picks
the linears, column-parallel (output features split over ``tensor``) on
``to_q/to_k/to_v/proj/add_{q,k,v}_proj`` and row-parallel (input features
split) on ``to_out.0`` / ``to_add_out`` / ``*2`` (``ff.net.2`` and, as the
rule reads, every other 2-D ``...2.weight``); int8 layers split their
``weight_int8`` and scale like ``weight`` (a row-parallel layer keeps its
per-output scale whole).  JAX places the weights and lets GSPMD rewrite the
program on global shapes; torch sees local shapes, so the layers here do
the rewriting themselves.  :func:`parallelize` marks the modules; the
port's ``models/layers.lin`` then runs a marked linear through its
:class:`TPLinear`, which slices the weight it is given at each call (so
``functional_call``'s substituted and LoRA-fused weights split too) and
inserts Megatron's two collectives:

  * column-parallel: identity forward, all-reduce of the input's gradient
    backward; the output holds this rank's features.  The attentions count
    their heads from the projection's width (``models/unet.Attention``,
    ``models/mmdit._heads``), so a rank runs heads / tensor of them.
  * row-parallel: the input is this rank's features (after a
    column-parallel layer) or a replicated input sliced here; the partial
    products are all-reduced forward, and the bias added once after.  A
    w8a8 layer all-reduces each token's absmax first, so its codes are the
    whole layer's.

Two places need more than a contiguous split:

  * GEGLU's ``proj`` is ``chunk(2)``-ed into hidden and gate: its rows are
    taken so that a rank holds the matching halves of both.  The MM-DiT's
    feed-forwards (tanh GELU, no chunk) and T5's take the plain split; the
    fused adaLN linears match no suffix and stay whole.
  * The IP-Adapter's ``to_k_ip`` / ``to_v_ip`` meet the local heads, so
    they split with ``to_k`` / ``to_v`` (GSPMD leaves them replicated).
  * A column-parallel linear whose consumer is not head- or
    feed-forward-aware (the rule's ``proj`` suffix also matches the
    resnets' ``time_emb_proj``) all-gathers its output.

Only the denoiser (UNet, MM-DiT, refiner, ControlNet) is split; the text
towers run replicated: their ``*_proj`` / ``fc2`` match the rule, but
their attention has no local-head path, and they are a small share of a
step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

from stablediffusion_tpu_torch.parallel.mesh import TENSOR_AXIS, Mesh

# column-parallel (shard output features): q/k/v and up projections
_COL_SUFFIXES = (
    "to_q", "to_k", "to_v", "proj",
    # MM-DiT context stream (models/mmdit.py)
    "add_q_proj", "add_k_proj", "add_v_proj",
    # the IP-Adapter's image keys and values, which meet the local heads
    "to_k_ip", "to_v_ip",
)
# row-parallel (shard input features): output projections
_ROW_SUFFIXES = ("to_out.0", "to_add_out", "2")  # ff(_context).net.2


def spec_for(path: str, shape, tensor_size: int) -> Optional[str]:
    """"col", "row" or None for the 2-D weight `path` (a parameter name,
    dotted) of torch shape [out, in]: JAX's ``_spec_for`` on the same name
    (whose kernels are [in, out])."""
    if len(shape) != 2:
        return None
    for s in _COL_SUFFIXES:
        if path.endswith((f"{s}.weight", f"{s}.weight_int8")) and shape[0] % tensor_size == 0:
            return "col"
    for s in _ROW_SUFFIXES:
        if path.endswith((f"{s}.weight", f"{s}.weight_int8")) and shape[1] % tensor_size == 0:
            return "row"
    return None


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the tensor group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous(), TENSOR_AXIS), None


class _GatherFromTP(torch.autograd.Function):
    """The ranks' features concatenated forward; this rank's slice of the
    (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return mesh.all_gather(x, TENSOR_AXIS, dim=-1)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.tensor_index
        return g[..., i * ctx.n:(i + 1) * ctx.n], None


class _ReduceFromTP(torch.autograd.Function):
    """The partial products all-reduced forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.contiguous(), TENSOR_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh) if x.requires_grad else x


def _rows(n: int, mesh: Mesh, geglu: bool) -> slice | torch.Tensor:
    """This rank's output rows of a column-parallel weight with `n` rows."""
    t, i = mesh.shape[TENSOR_AXIS], mesh.tensor_index
    if not geglu:
        return slice(i * n // t, (i + 1) * n // t)
    half = n // 2
    lo, hi = i * half // t, (i + 1) * half // t
    return torch.cat([torch.arange(lo, hi), torch.arange(half + lo, half + hi)])


class TPLinear:
    """The split forward of one linear (``nn.Linear`` or ``Int8Linear``)."""

    def __init__(self, kind: str, mesh: Mesh, geglu: bool = False, gather: bool = False):
        self.kind, self.mesh, self.geglu, self.gather = kind, mesh, geglu, gather

    def _cols(self, n: int) -> slice:
        t, i = self.mesh.shape[TENSOR_AXIS], self.mesh.tensor_index
        return slice(i * n // t, (i + 1) * n // t)

    def __call__(self, m: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        from stablediffusion_tpu_torch.ops.basic import linear
        from stablediffusion_tpu_torch.ops.quant import Int8Linear

        mesh = self.mesh
        q = isinstance(m, Int8Linear)
        w = m.weight_int8 if q else m.weight
        if self.kind == "col":
            r = _rows(w.shape[0], mesh, self.geglu)
            x = _copy(x, mesh)
            b = None if m.bias is None else m.bias[r]
            if not q:
                y = linear(x, w[r], b)
            else:
                scale = m.w8_scale if m.mode == "w8" else m.w8a8_scale
                y = _int8(m, x, w[r], scale.reshape(-1)[r], b, None)
            return _GatherFromTP.apply(y, mesh) if self.gather else y
        cols = self._cols(w.shape[1])
        if x.shape[-1] == w.shape[1]:  # a replicated input: take this rank's features
            x = _copy(x, mesh)[..., cols]
        if q:
            scale = m.w8_scale if m.mode == "w8" else m.w8a8_scale
            y = _int8(m, x, w[:, cols], scale.reshape(-1), None, mesh)
        else:
            y = linear(x, w[:, cols])
        y = _ReduceFromTP.apply(y, mesh)
        return y if m.bias is None else y + m.bias.to(y.dtype)


def _int8(m, x, wq, scale, bias, mesh: Optional[Mesh]) -> torch.Tensor:
    """``ops/quant.int8_linear`` over a slice of the layer; with `mesh` (a
    row-parallel slice) the per-token absmax is the whole row's."""
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops import quant

    padded = False
    if m.mode == "w8":
        y = F.linear(x, wq.to(x.dtype) * scale.reshape(-1, 1).to(x.dtype))
    else:
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        if mesh is not None:
            mesh.all_reduce_(amax, TENSOR_AXIS, op=dist.ReduceOp.MAX)
        s = torch.clamp(quant._over_127(amax), min=quant._EPS)
        xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        acc, padded = quant._int8_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
        y = (acc.float() * s.reshape(-1, 1) * scale.reshape(1, -1)).to(x.dtype)
        y = y.reshape(*x.shape[:-1], wq.shape[0])
    quant.INT8_LINEAR_CALLS.add(m.mode, padded)
    return y if bias is None else y + bias.to(y.dtype)


def _local_consumers(module: torch.nn.Module):
    """(ids of the column-parallel linears whose consumers take this rank's
    features: the attentions' projections, which meet the local heads, and
    the feed-forwards' up projections, which meet the row-parallel down
    projection; ids of GEGLU projections)."""
    from stablediffusion_tpu_torch.models import mmdit
    from stablediffusion_tpu_torch.models.unet import GEGLU, Attention

    local, geglus = set(), set()
    for m in module.modules():
        if isinstance(m, (Attention, mmdit.JointAttention, mmdit.ImageSelfAttention)):
            for name in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "add_q_proj",
                         "add_k_proj", "add_v_proj"):
                if hasattr(m, name):
                    local.add(id(getattr(m, name)))
        elif isinstance(m, GEGLU):
            local.add(id(m.proj))
            geglus.add(id(m.proj))
        elif isinstance(m, mmdit.FeedForward):
            local.add(id(m.net[0].proj))
    return local, geglus


def _targets(module: torch.nn.Module, tensor_size: int) -> Iterator:
    from stablediffusion_tpu_torch.ops.quant import Int8Linear

    local, geglus = _local_consumers(module)
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Linear):
            kind = spec_for(f"{name}.weight", tuple(m.weight.shape), tensor_size)
        elif isinstance(m, Int8Linear):
            kind = spec_for(f"{name}.weight_int8", tuple(m.weight_int8.shape), tensor_size)
        else:
            continue
        if kind == "col" and id(m) in geglus and (m.weight_int8 if isinstance(m, Int8Linear)
                                                  else m.weight).shape[0] % (2 * tensor_size):
            kind = None  # the halves do not split evenly: stays whole
        if kind is not None:
            yield name, m, kind, id(m) in geglus, kind == "col" and id(m) not in local


def _heads_divide(module: torch.nn.Module, tensor_size: int) -> bool:
    from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
    from stablediffusion_tpu_torch.models.unet import Attention

    if isinstance(module, SD3Transformer2DModel):
        return module.config.num_attention_heads % tensor_size == 0
    return all(m.heads % tensor_size == 0 for m in module.modules() if isinstance(m, Attention))


def parallelize(module: torch.nn.Module, mesh: Mesh) -> Dict[str, str]:
    """Mark `module`'s linears for the rule (a no-op at tensor 1, which
    splits nothing); returns {marked module name: "col" | "row"}.  Every
    head count must divide by the tensor size."""
    t = mesh.shape[TENSOR_AXIS]
    if t == 1:
        return {}
    if not _heads_divide(module, t):
        raise ValueError(f"tensor={t} must divide every attention's head count")
    names = {}
    for name, m, kind, geglu, gather in _targets(module, t):
        m._tp = TPLinear(kind, mesh, geglu, gather)
        names[name] = kind
    return names


def unparallelize(module: torch.nn.Module) -> None:
    for m in module.modules():
        if "_tp" in m.__dict__:
            del m._tp


@contextlib.contextmanager
def parallel(modules, mesh: Optional[Mesh]):
    """`modules` split over ``tensor`` inside the block (re-marked at each
    entry, so that adapters, int8 swaps and reloads made between calls are
    split too); yields {module index: marked names}."""
    if mesh is None or mesh.shape[TENSOR_AXIS] == 1:
        yield {}
        return
    marked = {}
    try:
        for i, m in enumerate(modules):
            if m is not None:
                marked[i] = parallelize(m, mesh)
        yield marked
    finally:
        for m in modules:
            if m is not None:
                unparallelize(m)
