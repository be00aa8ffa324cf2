"""The cross-rank reductions inside a mesh step's forward, each a no-op
without an active mesh (`mesh.use_mesh`), so that one process computes as
before.

`all_reduce_sum` is differentiable: its forward sums over the group and its
backward sums the incoming gradients over the same group, so that the
gradient each rank computes for its own inputs is that of the sum of every
rank's loss. With the Trainer's average of the gradients over all ranks
this gives the one-process gradient (`training.trainer`).

- `data_mean` (BatchNorm): per-rank means of equal-sized shards averaged
  over the data group, the global batch's means; on one rank the local
  means bit for bit.
- `seq_sum` (the target sum of the log-likelihood, `losses`): the partial
  sums over this rank's target slice summed over the seq group, before any
  logsumexp over z draws.
- `seq_masked_mean` (a homoskedastic decoder's scale pooled over the
  targets).
- `global_randn` (a latent model's z noise): the global batch's draw on
  every rank, this rank's rows kept.
- `gather_rows` (the eval step's per-function losses): every data rank's
  rows, in rank order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, active_mesh, has_seq_axis

__all__ = ["all_reduce_sum", "data_mean", "seq_sum", "seq_masked_mean", "global_randn",
           "gather_rows"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`; its gradient is the sum of
    the output's gradients over the group."""
    return _AllReduceSum.apply(x, group)


def data_mean(*means: torch.Tensor, mesh: Mesh) -> tuple:
    """Each rank's means of its equal-sized shard -> the means over the data
    axis' global batch (summed over the data group, divided by its size)."""
    if DATA_AXIS not in mesh.axis_names:
        return means
    both = all_reduce_sum(torch.stack(means), mesh.group(DATA_AXIS)) / mesh.axis_size(DATA_AXIS)
    return tuple(both.unbind(0))


def seq_sum(t: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's target slice -> the sum over all targets (the
    seq group's slices); `t` itself without an active seq axis."""
    mesh = active_mesh()
    return all_reduce_sum(t, mesh.group(SEQ_AXIS)) if has_seq_axis(mesh) else t


def seq_masked_mean(t: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """`utils.helpers.masked_mean` over the targets of the whole seq group."""
    m = mask.float().unsqueeze(-1)
    total, count = seq_sum((t.float() * m).sum(dim=dim)), seq_sum(m.sum(dim=dim))
    return (total / count.clamp_min(1.0)).to(t.dtype)


def global_randn(generator: Optional[torch.Generator], shape: tuple, mesh: Mesh,
                 device=None) -> torch.Tensor:
    """Standard normal float32 noise of `shape` [n_z, B, ...] whose dim 1 is
    this rank's rows: the draw of the global batch (B times the data axis'
    size), which every rank makes alike, cut to this rank's block."""
    n_z, rows, *rest = shape
    d, r = mesh.axis_size(DATA_AXIS), mesh.axis_rank(DATA_AXIS)
    eps = torch.randn((n_z, d * rows, *rest), generator=generator, dtype=torch.float32,
                      device=device)
    return eps[:, r * rows:(r + 1) * rows]


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's `t` concatenated along dim 0 in rank order."""
    group = mesh.group(DATA_AXIS)
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(DATA_AXIS))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
