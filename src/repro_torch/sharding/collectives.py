"""Collectives of the LM stack over a process grid's row ("model") and
column ("data", "pod") groups, and the autograd Functions built on them.

Every collective runs on gloo through host staging, as
``core/comm.py::ProcessWire`` stages the solvers' reductions: a CUDA
tensor is copied to a pinned host buffer, reduced there and copied back.
A group of one rank (an axis of extent 1) is no collective at all.

  * :class:`ViewPlan` -- how one parameter leaf's block becomes the
    tensor a rank computes with (its *view*) and how the gradient of that
    view becomes the gradient of the block: FSDP over the batch axes
    (all-gather forward, reduce-scatter backward; an all-reduce over the
    batch axes a leaf is not split over), and over "model" by the leaf's
    *use* -- ``"local"`` (the rank computes with its model block: the
    Megatron column / row split), ``"partial"`` (gathered over "model"
    where it is split, every rank's gradient a part of the sum) or
    ``"replicated"`` (gathered where split, every rank's gradient the
    whole: the backward keeps the rank's own block);
  * Megatron's conjugate pair over "model": :class:`CopyToGroup`
    (identity forward, all-reduce backward) at the entry of a
    column-parallel region, :class:`ReduceFromGroup` (all-reduce forward,
    identity backward) at the exit of a row-parallel one;
  * :class:`VocabParallelNLL`: the cross entropy of logits split over
    "model" along the vocabulary (the max and the sum of the log-sum-exp
    across the group, the gold logit from the rank that holds it).

  * :func:`merge_partials`: the flash-decoding merge of each rank's
    partial decode attention over its slots of a length-split cache (a
    log-sum-exp all-reduce: the heads' maxima, then the rescaled sums and
    outputs).

``WIRE`` counts the bytes handed to each kind of collective by this
process (the full gathered tensor of an all-gather, the full input of a
reduce-scatter, the tensor of an all-reduce).

A :class:`CountingGroup` in place of a process group (the dry run's, on
the ``meta`` device) makes every collective here count its bytes in
``WIRE`` and move nothing: its results are tensors of the right shape
whose values mean nothing.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

#: bytes this process has handed to collectives, by kind
WIRE = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
#: ... and the calls it made, by kind
CALLS = dict.fromkeys(WIRE, 0)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CountingGroup:
    """A stand-in for a process group of ``size`` ranks (the dry run's):
    the collectives below count their bytes and call no backend."""

    def __init__(self, size: int):
        self.size = int(size)


def _dist(name: str, *args, group, **kw):
    """``torch.distributed.<name>(*args, group=group)``, or nothing for a
    :class:`CountingGroup`."""
    if not isinstance(group, CountingGroup):
        getattr(dist, name)(*args, group=group, **kw)


def _host(x):
    """A contiguous host copy of ``x`` that nothing else holds (pinned for
    a CUDA tensor; a meta tensor stays one)."""
    if x.device.type == "cuda":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    return x.detach().contiguous().clone()


def _back(h, like):
    return h.to(like.device, non_blocking=True) if like.device.type == \
        "cuda" else h


def all_gather(x, dim: int, group, n: int):
    """The blocks of the ``n`` ranks of ``group`` concatenated along
    ``dim`` in group order."""
    if group is None or n == 1:
        return x
    moved = _host(x.movedim(dim, 0))
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]),
                      dtype=moved.dtype, device=moved.device,
                      pin_memory=moved.is_pinned())
    _dist("all_gather_into_tensor", out, moved, group=group)
    WIRE["all_gather"] += _nbytes(out)
    CALLS["all_gather"] += 1
    return _back(out, x).movedim(0, dim)


def reduce_scatter(x, dim: int, group, n: int):
    """The sum over ``group`` of ``x``, this rank's block of ``n`` along
    ``dim``."""
    if group is None or n == 1:
        return x
    moved = _host(x.movedim(dim, 0))
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]),
                      dtype=moved.dtype, device=moved.device,
                      pin_memory=moved.is_pinned())
    _dist("reduce_scatter_tensor", out, moved, group=group)
    WIRE["reduce_scatter"] += _nbytes(moved)
    CALLS["reduce_scatter"] += 1
    return _back(out, x).movedim(0, dim)


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """The sum (or ``op``) of ``x`` over ``group``."""
    if group is None:
        return x
    h = _host(x)
    _dist("all_reduce", h, op=op, group=group)
    WIRE["all_reduce"] += _nbytes(h)
    CALLS["all_reduce"] += 1
    return _back(h, x)


def merge_partials(m, l, o, group):
    """The attention output (B, H, D) float32 of every rank's partial
    ``(m, l, o)`` (``models/attention.py::decode_attention_partial`` over
    its slots) merged over ``group``: the heads' global maxima M (a MAX
    all-reduce), then ``sum_r exp(m_r - M) o_r`` over ``sum_r exp(m_r -
    M) l_r`` (one SUM all-reduce of both).  A rank with no valid slot (m
    = -inf) adds 0."""
    if group is None:
        return o / l[..., None]
    top = all_reduce(m, group, dist.ReduceOp.MAX)
    w = torch.exp(m - top)
    both = all_reduce(torch.cat([(l * w)[..., None], o * w[..., None]], -1),
                      group)
    return both[..., 1:] / both[..., :1]


def own_block(x, dim: int, n: int, index: int):
    return x.chunk(n, dim)[index].contiguous() if n > 1 else x


# ---------------------------------------------------------------------------
# a leaf's view
# ---------------------------------------------------------------------------

USES = ("local", "partial", "replicated")


class ViewPlan:
    """How a rank turns its block of one leaf (global ``shape``, ``spec``
    over ``mesh``, a :class:`repro_torch.launch.mesh.RankMesh`) into the
    tensor it computes with, and the view's gradient back into the
    block's (see the module docstring for ``use``)."""

    def __init__(self, shape, spec, use: str, mesh):
        if use not in USES:
            raise ValueError(f"use {use!r} is not one of {USES}")
        from .rules import batch_axes
        self.shape, self.spec, self.use, self.mesh = tuple(shape), spec, \
            use, mesh
        self.gathers = []          # (dim, axes, backward: "sum" | "own")
        split = set()
        for d in range(len(spec)):
            ax = spec.axes(d)
            if not ax:
                continue
            split.update(ax)
            if "model" not in ax:
                self.gathers.append((d, ax, "sum"))
            elif use != "local":
                self.gathers.append((d, ax, "sum" if use == "partial"
                                     else "own"))
        self.sums = tuple(a for a in batch_axes(mesh) if a not in split)
        if use == "partial" and "model" not in split:
            self.sums += ("model",)

    def _group(self, axes):
        return (self.mesh.group(axes), self.mesh.group_size(axes),
                self.mesh.index(axes))

    def gather(self, x):
        """The view of block ``x`` (no autograd)."""
        for d, ax, _ in self.gathers:
            g, n, _ = self._group(ax)
            x = all_gather(x, d, g, n)
        return x

    def reduce(self, grad):
        """The block's gradient from the view's (no autograd)."""
        for d, ax, back in reversed(self.gathers):
            g, n, i = self._group(ax)
            grad = (reduce_scatter(grad, d, g, n) if back == "sum"
                    else own_block(grad, d, n, i))
        if self.sums:
            # one all-reduce a group: the batch axes together, "model" apart
            b = tuple(a for a in self.sums if a != "model")
            if b:
                grad = all_reduce(grad, self.mesh.group(b))
            if "model" in self.sums:
                grad = all_reduce(grad, self.mesh.group(("model",)))
        return grad

    def view_bytes(self, item: int = 4) -> dict:
        """What one :meth:`gather` and one :meth:`reduce` hand to each kind
        of collective (``WIRE``'s units), by the shapes alone, for
        elements of ``item`` bytes (float32 by default)."""
        out = dict.fromkeys(WIRE, 0)
        block = [int(s) // math.prod(self.mesh.shape[a]
                                     for a in self.spec.axes(d))
                 for d, s in enumerate(self.shape)]
        for d, ax, back in self.gathers:
            n = self.mesh.group_size(ax)
            if n > 1:
                block[d] *= n
                out["all_gather"] += math.prod(block) * item
                if back == "sum":
                    out["reduce_scatter"] += math.prod(block) * item
        own = [int(s) // math.prod(self.mesh.shape[a]
                                   for a in self.spec.axes(d))
               for d, s in enumerate(self.shape)]
        b = tuple(a for a in self.sums if a != "model")
        for axes in ((b,) if b else ()) + ((("model",),)
                                           if "model" in self.sums else ()):
            if self.mesh.group_size(axes) > 1:
                out["all_reduce"] += math.prod(own) * item
        return out


class CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` backward (the
    entry of a column-parallel region: every rank's part of dL/dx)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # summed in float32 on the wire (gloo and a bfloat16 gradient)
        return all_reduce(grad.float(), ctx.group).to(grad.dtype), None


class ReduceFromGroup(torch.autograd.Function):
    """The sum over ``group`` forward; identity backward (the exit of a
    row-parallel region: the partial products summed)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x, group):
    return x if group is None else CopyToGroup.apply(x, group)


def reduce_from(x, group):
    return x if group is None else ReduceFromGroup.apply(x, group)


class VocabParallelNLL(torch.autograd.Function):
    """Per-token negative log-likelihood of float32 logits whose last
    dimension is this rank's slice ``[lo, lo + V_local)`` of the
    vocabulary: ``logsumexp`` over the whole vocabulary (the max and the
    sum of exponentials reduced over ``group``) minus the gold logit
    (summed over ``group``: only its holder contributes).  Backward:
    ``softmax - onehot`` on the rank's slice, times the incoming
    gradient."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, group):
        V = logits.shape[-1]
        m = all_reduce(logits.detach().amax(dim=-1), group,
                       dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = all_reduce(e.sum(dim=-1), group)
        local = labels - lo
        hit = (local >= 0) & (local < V)
        idx = torch.where(hit, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = all_reduce(torch.where(hit, gold, torch.zeros_like(gold)),
                          group)
        e.div_(s[..., None])
        ctx.save_for_backward(e, idx, hit)
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, grad):
        p, idx, hit = ctx.saved_tensors
        g = p.clone()
        g.scatter_add_(-1, idx[..., None], -hit[..., None].to(g.dtype))
        return g * grad[..., None], None, None, None
