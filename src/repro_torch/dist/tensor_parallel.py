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
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def splits(layout, logical: str) -> bool:
    """Whether ``layout`` cuts ``logical`` over a model group of several
    ranks (False without a layout)."""
    return layout is not None and layout.model > 1 and layout.splits(logical)


def _through_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _all_reduce(x: torch.Tensor, layout, op) -> torch.Tensor:
    if layout is None or layout.model == 1:
        return x
    if _through_host(x, layout.group):
        host = x.cpu()
        dist.all_reduce(host, op=op, group=layout.group)
        return x.copy_(host)
    dist.all_reduce(x, op=op, group=layout.group)
    return x


def all_reduce_sum(x: torch.Tensor, layout) -> torch.Tensor:
    """The sum of ``x`` over the layout's model group, in place where it
    can be; returns the sum."""
    return _all_reduce(x, layout, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, layout) -> torch.Tensor:
    """The largest of each element of ``x`` over the model group."""
    return _all_reduce(x, layout, dist.ReduceOp.MAX)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    src = x.cpu() if _through_host(x, group) else x.contiguous()
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
    ss = all_reduce_sum(torch.sum(x * x, dim=-1, keepdim=True), layout)
    x = x * torch.rsqrt(ss / n + eps)
    return (x * (1.0 + weight.float())).to(dt)


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` (..., k), ``b`` (k, n); or a batch of products,
    ``a`` (E, m, k), ``b`` (E, k, n)) accumulated and returned in f32
    without rounding to the operands' dtype: on the card a bf16 GEMM with
    an f32 output, elsewhere the product of the f32 operands (bf16 values
    are exact in f32)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                        torch.float16):
        if b.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def row_parallel(a: torch.Tensor, b: torch.Tensor, layout,
                 dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` over a contraction split across the model group (``a``
    and ``b`` this rank's slices of it): each rank's partial in f32,
    summed over the group, rounded once to ``dtype``."""
    return all_reduce_sum(f32_product(a, b), layout).to(dtype)


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
    return all_reduce_sum(x, layout).to(embed.dtype)


def vocab_logits(x: torch.Tensor, head: torch.Tensor,
                 layout) -> torch.Tensor:
    """``x @ head`` where ``head`` (d, vocab) holds this rank's columns of
    the vocabulary when it is split: the local product, gathered."""
    return all_gather(x @ head, layout) if splits(layout, "vocab") \
        else x @ head
