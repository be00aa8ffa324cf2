"""Masked reductions over padded point sets, the counterpart of
`npf_gwwaveform_tpu/utils/helpers.py`. Every set is padded to a fixed size
and carries a boolean mask; an empty mask gives zeros, never NaN."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def rescale_range(x, old_range, new_range):
    """Linearly rescale x from old_range = (lo, hi) to new_range, with the
    JAX helper's operations in its order."""
    old_min, old_max = old_range
    new_min, new_max = new_range
    return (x - old_min) * (new_max - new_min) / (old_max - old_min) + new_min


def sum_from_nth_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum all dims from `dim` onward (none when dim == t.ndim: torch's sum
    over an empty dim tuple would reduce everything)."""
    return t.sum(dim=tuple(range(dim, t.ndim))) if dim < t.ndim else t


def masked_sum(t: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """t [..., N, D], mask [..., N] -> [..., D], counting masked-in entries."""
    return (t * mask.to(t.dtype).unsqueeze(-1)).sum(dim=dim)


def masked_mean(t: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean over masked-in entries; zero when the mask is empty."""
    m = mask.float().unsqueeze(-1)
    total = (t.float() * m).sum(dim=dim)
    count = m.sum(dim=dim)
    return (total / count.clamp_min(1.0)).to(t.dtype)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                   stop_max_grad: bool = False) -> torch.Tensor:
    """Softmax over `dim` with masked-out entries at zero weight; a fully
    masked row gives all zeros, and zero gradients. `stop_max_grad` takes no
    gradient through the subtracted max, as JAX's `masked_softmax` does."""
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=dim, keepdim=True)
    if stop_max_grad:
        m = m.detach()
    unnorm = torch.exp(logits - m) * mask.to(logits.dtype)
    return unnorm / unnorm.sum(dim=dim, keepdim=True).clamp_min(1e-30)


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 `linspace` with `jnp.linspace`'s arithmetic: start*(1-s) +
    stop*s with s = i/(num-1) in float32, the last point exactly `stop`.
    Equal to that arithmetic op by op; XLA's fused evaluation of
    `jnp.linspace` may round a point one ulp differently. Made on `device`
    without a copy from the host, so that a CUDA graph can capture it."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    start_t = torch.full((), start, dtype=torch.float32, device=device)
    stop_t = torch.full((), stop, dtype=torch.float32, device=device)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def set_numerics() -> None:
    """Products on the card as the JAX package computes them: float32 matmuls
    and convolutions without TF32, and bf16 matmuls summed in f32 (cuBLAS may
    otherwise reduce them in reduced precision; JAX asks for f32
    accumulation)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---- z-sample plumbing: n_z draws folded into the batch and back ----


def collapse_z_samples_batch(t: torch.Tensor) -> torch.Tensor:
    """[n_z, B, ...] -> [n_z * B, ...]."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def extract_z_samples_batch(t: torch.Tensor, n_z_samples: int) -> torch.Tensor:
    """[n_z * B, ...] -> [n_z, B, ...], the inverse of `collapse_z_samples_batch`."""
    return t.reshape((n_z_samples, t.shape[0] // n_z_samples) + tuple(t.shape[1:]))


def replicate_z_samples(t: torch.Tensor, n_z_samples: int) -> torch.Tensor:
    """[...] -> [n_z, ...], a broadcast view."""
    return t[None].expand((n_z_samples,) + tuple(t.shape))


def pool_and_replicate_middle(t: torch.Tensor) -> torch.Tensor:
    """[B, *mid, C]: the mean over every middle dimension, broadcast back to
    t's shape."""
    pooled = t.reshape(t.shape[0], -1, t.shape[-1]).mean(dim=1)
    return pooled.reshape((t.shape[0],) + (1,) * (t.dim() - 2) + (t.shape[-1],)).expand(t.shape)


def logcumsumexp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Numerically stable log of the cumulative sum of exp along `dim`."""
    return torch.logcumsumexp(x, dim=dim)
