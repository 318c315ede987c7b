"""ZeRO-style state sharding over the ``data`` axis.

Port of ``stablediffusion_tpu/parallel/zero.py``.  JAX annotates the state
trees as split and XLA inserts the collectives; here the collectives are
explicit:

  * ZeRO-1 (``shard_opt_state``): :class:`ZeroOptimizer` keeps each split
    leaf's Adam moments for this rank's slice only.  The step averages the
    full gradients over ``data`` (an all-reduce: gloo has no
    reduce-scatter), each rank updates its slice of every split leaf in
    place, and the slices are all-gathered into the parameter.  Clipping
    needs the norm of the whole gradient: the split leaves' sums of
    squares are all-reduced, the replicated leaves' added once.  8-bit
    Adam's block-quantized moments stay replicated, as JAX's dry run keeps
    them.
  * FSDP (``shard_params``): trainable and frozen parameters live split
    between steps, and each is gathered whole only while it is used.
    :func:`shard_tree` / :func:`gather_tree` split and rebuild a trainable
    tree, :func:`shard_modules_` keeps only this rank's slice of each
    parameter of the frozen modules; both tag each split tensor
    (:func:`is_split`).  :func:`whole` all-gathers one: differentiably, its
    backward the gradient averaged over ``data``, this rank's slice.  The
    train step (``train/train_step.remat``) gathers a denoiser's weights
    per block inside the block's checkpoint region, so that the whole
    copies of one block live while it runs, and again in the backward's
    recompute; the optimizer (:class:`ZeroOptimizer`) updates the slices.
    :func:`gathered` holds modules whole for a span instead (the text
    towers and the VAE for a step, a model for a render or a save).  This is
    JAX's leaf rule, not torch's ``fully_shard``: the port's step
    substitutes weights through ``functional_call`` and its own optimizer,
    which ``fully_shard``'s parameter hooks would not see.
    :func:`gather_stats` counts the bytes of the whole copies alive.

Leaf rule (:func:`_best_axis`): split the largest axis whose size divides
the axis length (ties: the earliest); leaves with none stay replicated.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterable, List, Mapping, Optional

import torch

from stablediffusion_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from stablediffusion_tpu_torch.train.optim import AdamW, MultiSteps, tree_leaves, unflatten


def _best_axis(shape, n: int) -> Optional[int]:
    """Largest axis divisible by ``n`` (ties -> earliest), else None."""
    best = None
    for i, s in enumerate(shape):
        if s >= n and s % n == 0 and (best is None or s > shape[best]):
            best = i
    return best


def _split_axis(t: torch.Tensor, mesh: Mesh, axis: str) -> Optional[int]:
    n = mesh.shape[axis]
    return None if n == 1 and mesh.groups[axis] is None else _best_axis(tuple(t.shape), n)


def _slice(t: torch.Tensor, ax: Optional[int], mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's slice of `t` along `ax` (a view), or `t` when unsplit."""
    if ax is None:
        return t
    n = mesh.shape[axis]
    step = t.shape[ax] // n
    return t.narrow(ax, mesh.index(axis) * step, step)


def is_split(t) -> bool:
    """Whether `t` is this rank's slice of a split tensor."""
    return isinstance(t, torch.Tensor) and "_zero_split" in t.__dict__


# bytes of the whole copies that :func:`whole` and :func:`gathered` made and
# that are alive, and their most since :func:`reset_gather_stats` (which
# counts the copies alive then: a reader subtracts its "live")
_STATS = {"live": 0, "peak": 0}


def gather_stats() -> Dict[str, int]:
    return dict(_STATS)


def reset_gather_stats() -> None:
    _STATS["peak"] = _STATS["live"]


def _all_gather(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of `t`, split as the split tensor `like` is."""
    mesh, axis, ax = like.__dict__["_zero_split"]
    return mesh.all_gather(t.detach(), axis, dim=ax)


def _count(n: int) -> None:
    _STATS["live"] += n
    _STATS["peak"] = max(_STATS["peak"], _STATS["live"])


def _gather(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of the split `t` (no gradient), counted while alive."""
    out = _all_gather(t, t)
    n = out.numel() * out.element_size()
    _count(n)
    weakref.finalize(out, _count, -n)
    return out


class _Whole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split):
        ctx.split = split
        return _gather(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, ax = ctx.split
        g = mesh.all_reduce_(g.clone(), axis).div_(mesh.shape[axis])
        return _slice(g, ax, mesh, axis).contiguous(), None


def whole(t):
    """`t` whole: a split tensor all-gathered (differentiable: the gradient
    of its slice is the whole gradient averaged over the split's axis, this
    rank's part), any other value as it is."""
    if not is_split(t):
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return _Whole.apply(t, t.__dict__["_zero_split"])
    return _gather(t)


def whole_tree(tree: Mapping) -> Mapping:
    """`tree` with each split leaf made :func:`whole` (itself when none is)."""
    leaves = [t for _, t in tree_leaves(tree)]
    if not any(is_split(t) for t in leaves):
        return tree
    return unflatten(tree, [whole(t) for t in leaves])


def _tag(t: torch.Tensor, mesh: Mesh, axis: str, ax: int) -> torch.Tensor:
    t.__dict__["_zero_split"] = (mesh, axis, ax)
    return t


def shard_tree(tree: Mapping, mesh: Mesh, axis: str = DATA_AXIS) -> Dict:
    """The tree with each leaf replaced by this rank's slice, a copy tagged
    for :func:`whole` (a leaf with no axis to split stays whole)."""
    out = []
    for _, t in tree_leaves(tree):
        ax = _split_axis(t, mesh, axis)
        local = _slice(t, ax, mesh, axis).clone()
        out.append(local if ax is None else _tag(local, mesh, axis, ax))
    return unflatten(tree, out)


@torch.no_grad()
def gather_tree(tree: Mapping) -> Dict:
    """The whole tree from every rank's :func:`shard_tree` slices."""
    return unflatten(tree, [whole(t) for _, t in tree_leaves(tree)])


class ZeroOptimizer:
    """ZeRO-1 around the port's :class:`AdamW` (or a :class:`MultiSteps` of
    it): the same ``init`` / ``update`` interface over the whole parameter
    tree, with the state of each split leaf held for this rank's slice.
    Under FSDP the tree's leaves are slices already (:func:`is_split`): they
    are updated as they are, and nothing is gathered."""

    def __init__(self, inner, mesh: Mesh, axis: str = DATA_AXIS):
        self.inner, self.mesh, self.axis = inner, mesh, axis
        self.adam: AdamW = inner.inner if isinstance(inner, MultiSteps) else inner
        self.adam.norm_fn = self.grad_norm  # clipping needs the whole gradient's norm
        self.axes: Dict[str, Optional[int]] = {}
        self.shapes: List[tuple] = []  # each leaf's whole shape

    def init(self, params: Mapping) -> Dict:
        leaves = tree_leaves(params)
        self.shapes = [tuple(t.shape) for _, t in leaves]
        if self.adam.use_8bit:  # the quantized moments stay replicated
            self.axes = {p: None for p, _ in leaves}
        else:
            self.axes = {p: _split_axis(t, self.mesh, self.axis) for p, t in leaves}
        return self.inner.init(self._local(params, params))

    def _local(self, tree: Mapping, params: Mapping) -> Dict:
        """This rank's slice of each leaf of `tree` whose parameter is whole
        and split by the state (the others as they are)."""
        return unflatten(tree, [t if is_split(w) else _slice(t, self.axes[p], self.mesh, self.axis)
                                for (p, t), (_, w) in zip(tree_leaves(tree),
                                                          tree_leaves(params))])

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient from this rank's leaves, slices
        (smaller than the leaf's whole shape) or whole: each leaf's sum of
        squares, all-reduced (a whole leaf's counted on data rank 0 only),
        summed in leaf order as ``global_norm`` sums them, so that one rank
        reproduces it bit for bit."""
        sq = torch.stack([g.float().pow(2).sum() for g in grads])
        if self.mesh.index(self.axis) != 0:
            sliced = torch.tensor([tuple(g.shape) != s for g, s in zip(grads, self.shapes)],
                                  device=sq.device)
            sq = torch.where(sliced, sq, torch.zeros_like(sq))
        self.mesh.all_reduce_(sq, self.axis)
        return torch.sqrt(sum(sq.unbind()))

    @torch.no_grad()
    def update(self, grads: Mapping, state: Dict, params: Mapping):
        """`grads`: the gradient, already averaged over ``data`` (whole, or
        each FSDP slice's).  Updates `params` in place and returns (params,
        state)."""
        leaves = tree_leaves(params)
        if self.adam.use_8bit and any(is_split(t) for _, t in leaves):
            return self._update_whole(grads, state, params)
        self.inner.update(self._local(grads, params), state, self._local(params, params))
        for p, t in leaves:
            ax = self.axes[p]
            if ax is not None and not is_split(t):
                t.copy_(self.mesh.all_gather(_slice(t, ax, self.mesh, self.axis), self.axis,
                                             dim=ax))
        return params, state

    def _update_whole(self, grads: Mapping, state: Dict, params: Mapping):
        """FSDP slices under 8-bit Adam, whose moments are whole: the update
        runs on the gathered leaves, and each rank keeps its slices."""
        def full(t, w):
            return _all_gather(t, w) if is_split(w) else t

        pairs = list(zip(tree_leaves(grads), tree_leaves(params)))
        p_whole = unflatten(params, [full(w, w) for _, (_, w) in pairs])
        self.inner.update(unflatten(grads, [full(g, w) for (_, g), (_, w) in pairs]), state,
                          p_whole)
        for (_, w), (_, u) in zip(tree_leaves(params), tree_leaves(p_whole)):
            if is_split(w):
                mesh, axis, ax = w.__dict__["_zero_split"]
                w.copy_(_slice(u, ax, mesh, axis))
        return params, state


def shard_modules_(modules: Iterable[torch.nn.Module], mesh: Mesh,
                   axis: str = DATA_AXIS) -> None:
    """Keep only this rank's slice of every parameter of `modules`, tagged
    for :func:`whole`."""
    for m in modules:
        if m is None:
            continue
        for p in m.parameters():
            ax = _split_axis(p, mesh, axis)
            if ax is not None and not is_split(p):
                p.data = _slice(p.data, ax, mesh, axis).clone()
                _tag(p, mesh, axis, ax)


def unshard_modules_(modules: Iterable[torch.nn.Module]) -> None:
    """Gather every parameter of `modules` back for good."""
    for m in modules:
        if m is None:
            continue
        for p in m.parameters():
            if is_split(p):
                p.data = _all_gather(p, p)
                del p.__dict__["_zero_split"]


def is_split_module(module: Optional[torch.nn.Module]) -> bool:
    return module is not None and any(is_split(p) for p in module.parameters())


@contextlib.contextmanager
def gathered(modules: Iterable[torch.nn.Module]):
    """The whole parameters of FSDP-split `modules` inside the block (and
    through a backward run inside it), this rank's slices again after it."""
    held, n = [], 0
    for m in modules:
        if m is None:
            continue
        for p in m.parameters():
            if is_split(p):
                held.append((p, p.data))
                p.data = _all_gather(p, p)
                n += p.numel() * p.element_size()
    _count(n)
    try:
        yield
    finally:
        for p, local in held:
            p.data = local
        _count(-n)
