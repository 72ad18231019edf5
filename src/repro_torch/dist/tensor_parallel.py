"""Tensor parallelism over a model group of ``torch.distributed`` ranks.

The port's own: the JAX package splits its model by sharding constraints
(``dist/sharding.shard``), and XLA's partitioner inserts the collectives.
Here the layers split themselves, one process a rank, each holding its
slice of the weights (``dist.plan.ShardLayout``), and call these at the
cuts where the partitioner would have inserted a collective:

* :func:`row_parallel`: a product over a split contraction (``wo`` over
  the heads, ``w_down`` over ``mlp``): the local partial in f32, one
  ``all_reduce`` (sum) over the group, one rounding to the activations'
  dtype; the unsharded product also accumulates in f32 and rounds once;
* :func:`vocab_embed`: a lookup of this rank's rows of the embedding,
  zeros for the others' tokens, then an ``all_reduce`` (exact: one term
  is not zero);
* :func:`vocab_logits`: the local product with this rank's vocabulary
  columns, then an ``all_gather``, so that every rank holds the same
  logits and greedy argmax picks the same token on each;
* :func:`split_rmsnorm`: a norm over a vector cut across the group (SSD's
  gated norm over ``mlp``): the f32 sum of squares summed over the group;
* :func:`all_reduce_max`: the row maxima of a softmax whose positions are
  cut over the group (the ``kv_seq`` rule);
* :func:`gather_rows`: every data rank's rows, over the data group (MoE's
  routing, whose capacity counts the global batch).

With a layout of one model rank (or none) no collective runs, and the
code is the single-card code. Under gloo a CUDA tensor goes through the
host (gloo's own CUDA support varies by collective and version); NCCL
takes it as it is.

Under autograd (training across a model group) each collective has the
backward its consumers need. The activations between the split
sub-layers are whole and the same on every rank, and every rank computes
the same loss, so the gradient of a whole activation is whole on each
rank where all of its consumers are whole, and a partial share where a
consumer is split:

* :func:`copy_to_group`: the identity forward, a sum over the group
  backward. It sits at the input of each split sub-layer (after
  ``norm1``, ``norm_x`` with the encoder's output, ``norm2``) and before
  a split head: each rank's product with its own heads, ``mlp`` columns,
  experts or vocabulary gives only its share of the input's gradient;
* :func:`row_parallel`, :func:`vocab_embed` and the MoE FFN's joined
  output (:func:`reduce_from_group`): a sum forward, the identity
  backward, since what consumes the sum is whole;
* :func:`split_rmsnorm`: its sum of squares is a sum forward and
  backward, since the slices that consume it are split;
* :func:`vocab_loss`: the loss of logits whose vocabulary is cut over
  the group, from each rank's max and sum of exponentials (two
  all-reduces, the max detached: it only shifts) and the gold logit from
  the rank that owns the label; no rank builds the whole (B, S, vocab);
* :func:`all_reduce_max`, :func:`gather_rows`, :func:`vocab_logits` and
  the ``kv_seq`` merge carry no gradient: the max is only a softmax
  shift, the gathered rows are MoE's routing (indices), and the other
  two serve decoding.

A whole parameter whose consumers are split gets a partial gradient,
summed over the group by the train step (``dist.plan.grad_classes``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def splits(layout, logical: str) -> bool:
    """Whether ``layout`` cuts ``logical`` over a model group of several
    ranks (False without a layout)."""
    return layout is not None and layout.model > 1 and layout.splits(logical)


def through_host(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``group`` on ``x`` goes through the host
    (a CUDA tensor under gloo)."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if through_host(x, group):
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        return x.copy_(host)
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_reduce(x: torch.Tensor, layout, op) -> torch.Tensor:
    if layout is None or layout.model == 1:
        return x
    return _reduce(x, layout.group, op)


def all_reduce_sum(x: torch.Tensor, layout) -> torch.Tensor:
    """The sum of ``x`` over the layout's model group, in place where it
    can be; returns the sum."""
    return _all_reduce(x, layout, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, layout) -> torch.Tensor:
    """The largest of each element of ``x`` over the model group."""
    return _all_reduce(x, layout, dist.ReduceOp.MAX)


class _Copy(torch.autograd.Function):
    """The identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.layout), None


class _Reduce(torch.autograd.Function):
    """The sum over the group forward (of a copy: autograd refuses an
    in-place change of some tensors, a custom Function's view among
    them); backward the identity, or with ``split`` (the sum's consumers
    are split) the sum again."""

    @staticmethod
    def forward(ctx, x, layout, split):
        ctx.layout, ctx.split = layout, split
        return all_reduce_sum(x.clone(), layout)

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            g = all_reduce_sum(g.clone(), ctx.layout)
        return g, None, None


def _grad(x: torch.Tensor, layout) -> bool:
    return layout is not None and layout.model > 1 and x.requires_grad \
        and torch.is_grad_enabled()


def copy_to_group(x: torch.Tensor, layout) -> torch.Tensor:
    """``x`` (whole and the same on every rank) at the input of a split
    sub-layer: the identity, whose gradient is summed over the model
    group under autograd."""
    return _Copy.apply(x, layout) if _grad(x, layout) else x


def reduce_from_group(x: torch.Tensor, layout,
                      split: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the model group, in place without autograd.
    Under autograd its gradient passes to each rank's ``x`` unchanged
    where what consumes the sum is whole, and is summed over the group
    too with ``split``."""
    return _Reduce.apply(x, layout, split) if _grad(x, layout) \
        else all_reduce_sum(x, layout)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    src = x.cpu() if through_host(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_gather(x: torch.Tensor, layout, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` of the model group, joined along ``dim`` in rank
    order."""
    if layout is None or layout.model == 1:
        return x
    return _gather(x, layout.group, layout.model, dim)


def data_split(layout) -> bool:
    """Whether the layout's data ranks hold different rows of the batch."""
    return layout is not None and layout.batch_split and layout.data > 1


def data_sum(x: torch.Tensor, layout) -> torch.Tensor:
    """The sum of ``x`` over the layout's data group, in place where it
    can be, when its data ranks hold different rows; no gradient (the
    loss's label count and reported value, the train step's
    gradients)."""
    if not data_split(layout):
        return x
    return _reduce(x, layout.data_group, dist.ReduceOp.SUM)


def gather_rows(x: torch.Tensor, layout) -> torch.Tensor:
    """Every data rank's ``x`` (its rows of the batch first), joined along
    dimension 0 in data-rank order: the global batch's."""
    if not data_split(layout):
        return x
    return _gather(x, layout.data_group, layout.data, 0)


def split_rmsnorm(x: torch.Tensor, weight: torch.Tensor, n: int, layout,
                  eps: float = 1e-6) -> torch.Tensor:
    """``layers.rmsnorm`` of a vector of ``n`` whose last dimension is cut
    over the model group (``x`` and ``weight`` this rank's slices): the
    sum of squares in f32 over the group, then this rank's slice scaled."""
    dt = x.dtype
    x = x.float()
    ss = reduce_from_group(torch.sum(x * x, dim=-1, keepdim=True), layout,
                           split=True)
    x = x * torch.rsqrt(ss / n + eps)
    return (x * (1.0 + weight.float())).to(dt)


def _wide_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (m, k) @ ``b`` (k, n), or a batch of them, in f32."""
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)


class _WideProduct(torch.autograd.Function):
    """A bf16 GEMM with an f32 output, whose backward (``out_dtype`` has
    none) takes the gradient in the operands' dtype, as the unsplit
    product's backward has it: the consumers round the sum to that dtype,
    so the gradient that reaches it is one of its values."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _wide_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` (..., k), ``b`` (k, n); or a batch of products,
    ``a`` (E, m, k), ``b`` (E, k, n)) accumulated and returned in f32
    without rounding to the operands' dtype: on the card a bf16 GEMM with
    an f32 output (under autograd through :class:`_WideProduct`; on the
    ``meta`` device too, which stands for the card in the dry run),
    elsewhere the product of the f32 operands (bf16 values are exact in
    f32)."""
    if (a.is_cuda or a.is_meta) and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                        torch.float16):
        wide = _WideProduct.apply if torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad) else _wide_product
        if b.dim() == 3:
            return wide(a, b)
        out = wide(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def row_parallel(a: torch.Tensor, b: torch.Tensor, layout,
                 dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` over a contraction split across the model group (``a``
    and ``b`` this rank's slices of it): each rank's partial in f32,
    summed over the group, rounded once to ``dtype``."""
    return reduce_from_group(f32_product(a, b), layout).to(dtype)


def vocab_embed(tokens: torch.Tensor, embed: torch.Tensor,
                layout) -> torch.Tensor:
    """``F.embedding(tokens, embed)`` where ``embed`` holds this rank's
    rows of the vocabulary (``layout.local("vocab", ...)``) when it is
    split."""
    if not splits(layout, "vocab"):
        return F.embedding(tokens, embed)
    rows = layout.local("vocab", embed.shape[0] * layout.model)
    local = tokens - rows.start
    mine = (local >= 0) & (local < embed.shape[0])
    x = F.embedding(torch.where(mine, local, 0), embed).float()
    x = torch.where(mine[..., None], x, 0.0)
    return reduce_from_group(x, layout).to(embed.dtype)


def vocab_logits(x: torch.Tensor, head: torch.Tensor,
                 layout) -> torch.Tensor:
    """``x @ head`` where ``head`` (d, vocab) holds this rank's columns of
    the vocabulary when it is split: the local product, gathered."""
    return all_gather(x @ head, layout) if splits(layout, "vocab") \
        else x @ head


def vocab_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               layout) -> torch.Tensor:
    """Each position's next-token NLL ``logsumexp(logits) - logits[label]``
    in f32 (0 where ``labels < 0``), where ``head`` (d, vocab) holds this
    rank's columns of the vocabulary: ``x`` passes :func:`copy_to_group`,
    the rank's f32 logits give its max and sum of exponentials, the
    group's max (detached) and sum join them, and the gold logit comes
    from the rank whose columns hold the label. The same on every rank;
    under autograd each rank's logits get their own columns' gradient."""
    logits = (copy_to_group(x, layout) @ head).float()
    cols = layout.local("vocab", head.shape[1] * layout.model)
    with torch.no_grad():
        top = all_reduce_max(torch.amax(logits, dim=-1, keepdim=True),
                             layout)
    sumexp = torch.sum(torch.exp(logits - top), dim=-1)
    local = labels.long() - cols.start
    mine = (labels >= 0) & (local >= 0) & (local < head.shape[1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = torch.where(mine, gold[..., 0], 0.0)
    parts = reduce_from_group(torch.stack([sumexp, gold]), layout)
    nll = top[..., 0] + torch.log(parts[0]) - parts[1]
    return torch.where(labels >= 0, nll, 0.0)
