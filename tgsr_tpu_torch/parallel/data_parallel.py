"""What a data-parallel step does across its ranks.

Each rank of a batch group computes on its own rows of the global batch. A
step is the single-process step on the global batch when its loss is
written as L = sum over ranks of L_r: a per-sample mean contributes its
rank's mean times B_local / B_global (`share`); a term that couples samples
(BatchNorm's batch moments, the discriminator's mismatched pair image i
against caption i + 1, the DAMSM losses over every caption-image pair) reads
the other ranks' rows through collectives that carry the gradient
(`all_reduce_sum`, `gather_rows`). The parameter gradients of the L_r are
then summed across ranks (one flat bucket) before the optimizer, and the
metrics too.

`data_parallel(group)` makes `group` the current batch group for the code
it encloses, the whole forward and backward of a step. Train-mode BatchNorm
(`ops/blocks.py`) and the losses read it. The setting is process-wide, not
per thread: the autograd engine runs a CUDA backward, and the recompute of a
rematerialised block, on a thread of its own. With no group, or a group of
one rank, nothing reduces and every module runs its single-process code, bit
for bit. Within `couple_one_rank()` a group of one rank is kept: the coupled
code and the `--fsdp` storage then run their collectives over that one rank,
which drives them where there is one device (the plain step's maths up to
float reassociation).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_GROUP: List[Optional[object]] = [None]
_COUPLE_ONE: List[bool] = [False]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@contextlib.contextmanager
def couple_one_rank() -> Iterator[None]:
    """Within: `data_parallel` keeps a group of one rank, and the trainer's
    `--fsdp` storage shards over one rank as it would over two
    (`storage_shards`), each rank's chunk the whole tensor."""
    prev = _COUPLE_ONE[0]
    _COUPLE_ONE[0] = True
    try:
        yield
    finally:
        _COUPLE_ONE[0] = prev


def storage_shards(n: int) -> int:
    """The rank count whose `fsdp_spec` places a sharded state over `n`
    ranks: n, or 2 for one rank within `couple_one_rank`."""
    return 2 if n == 1 and _COUPLE_ONE[0] else n


@contextlib.contextmanager
def data_parallel(group) -> Iterator[None]:
    """Within: BatchNorm's moments and the coupled losses reduce over `group`
    (nothing where it is None, or one rank outside `couple_one_rank`)."""
    prev = _GROUP[0]
    keep = group is not None and (group_size(group) > 1 or _COUPLE_ONE[0])
    _GROUP[0] = group if keep else None
    try:
        yield
    finally:
        _GROUP[0] = prev


def data_group():
    """The batch group of the step running now, or None (one rank)."""
    return _GROUP[0]


def rank_in(group) -> int:
    return dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group, on every rank. The gradient of a
    loss summed over ranks with respect to each rank's x is the sum of the
    ranks' gradients with respect to y: the backward is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """[B, ...] on each rank -> [ranks * B, ...], rank-major, on every rank;
    the backward sums the ranks' gradients of each rank's rows and hands
    each rank its own (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // n, *grad.shape[1:]))
        reduce_scatter(out, grad, ctx.group)
        return out, None


def reduce_scatter(out: torch.Tensor, full: torch.Tensor, group) -> None:
    """out = this rank's chunk (along dim 0) of the group's sum of `full`."""
    dist.reduce_scatter_tensor(out, full, group=group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` on every rank, differentiable."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of x (the same row count on each), rank-major,
    differentiable. Integer tensors gather without autograd."""
    if not x.is_floating_point():
        out = x.new_empty((group_size(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    return _GatherRows.apply(x, group)


def share(group) -> float:
    """B_local / B_global: the weight of a rank's per-sample mean in the
    global batch's (the ranks hold equal rows)."""
    return 1.0 / group_size(group)


def gather_batch(tensors: Sequence[Optional[torch.Tensor]], group):
    """`gather_rows` of each tensor (None passes through)."""
    return [None if t is None else gather_rows(torch.as_tensor(t), group) for t in tensors]


def sum_tensors(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over `group` in one flat bucket a dtype (one
    collective each; a group of one rank adds nothing, bit for bit); no
    autograd. None as the group: the tensors as they are."""
    out = list(tensors)
    if group is None:
        return out
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view_as(tensors[i])
            at += n
    return out
