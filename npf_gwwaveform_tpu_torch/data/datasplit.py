"""Context/target splitting into padded sets with boolean masks, the
counterpart of `npf_gwwaveform_tpu/data/datasplit.py`. Randomness comes from
an explicit `torch.Generator`; the mask construction from scores is a pure
function and gives the JAX package's masks bit for bit."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["get_all_indcs", "get_range_indcs", "GetIndcsMerger", "GetRandomIndcs",
           "exact_topn_mask", "CntxtTrgtSplitter"]


def get_all_indcs(generator, batch_size: int, n_points: int) -> torch.Tensor:
    """Every point selected."""
    return torch.ones((batch_size, n_points), dtype=torch.bool, device=generator.device)


def get_range_indcs(arange):
    """A mask sampler selecting every index in [lo, hi)."""

    def sampler(generator, batch_size: int, n_points: int) -> torch.Tensor:
        idx = torch.arange(n_points, device=generator.device)
        mask = (idx >= arange[0]) & (idx < arange[1])
        return mask[None].expand(batch_size, n_points)

    return sampler


@dataclass(frozen=True)
class GetIndcsMerger:
    """The union of several mask samplers' masks, each drawing from the
    generator in turn."""

    samplers: tuple

    def __call__(self, generator, batch_size: int, n_points: int) -> torch.Tensor:
        out = self.samplers[0](generator, batch_size, n_points)
        for s in self.samplers[1:]:
            out = out | s(generator, batch_size, n_points)
        return out


def exact_topn_mask(scores: torch.Tensor, n_indcs: torch.Tensor, static_ub: int,
                    batch_size: int) -> torch.Tensor:
    """Mask of the n smallest-scoring positions of each row, ties broken
    lower-index-first: the set a stable double argsort selects, as a
    lexicographic (value, index) threshold.

    scores [S, N] with S in {1, batch_size}; n_indcs an integer tensor [] or
    [B, 1] with values <= static_ub. A stable sort orders ties by index, which
    `torch.topk` does not promise.
    """
    n_points = scores.shape[-1]
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    vals, idx = vals[..., :static_ub], idx[..., :static_ub]
    n_b = n_indcs.reshape(-1, 1).expand(batch_size, 1)
    sel_pos = (n_b - 1).clamp(0, static_ub - 1)
    thr_val = vals.expand(batch_size, static_ub).gather(-1, sel_pos)
    thr_idx = idx.expand(batch_size, static_ub).gather(-1, sel_pos)
    ar = torch.arange(n_points, device=scores.device)[None, :]
    s = scores.expand(batch_size, n_points)
    mask = (s < thr_val) | ((s == thr_val) & (ar <= thr_idx))
    return mask & (n_b > 0)


@dataclass(frozen=True)
class GetRandomIndcs:
    """Random subset mask: count n ~ U{a..b} (ratios of n_points when below
    1), positions drawn independently per batch element. The count is drawn
    once for the whole batch, as the JAX package's training splitter does,
    or once per element with `is_indep_n=True`, as its eval splitter does."""

    a: float = 0.1
    b: float = 0.5
    is_indep_n: bool = False

    def __call__(self, generator: torch.Generator, batch_size: int, n_points: int):
        def to_count(v):
            c = int(v * n_points) if 0 <= v < 1 else int(v)
            return max(0, min(c, n_points))

        b = to_count(self.b)
        a = min(to_count(self.a), b)
        device = generator.device
        n_shape = (batch_size, 1) if self.is_indep_n else ()
        n_indcs = torch.randint(a, b + 1, n_shape, generator=generator, device=device)
        scores = torch.rand((batch_size, n_points), generator=generator, device=device)
        if b == 0:
            return torch.zeros((batch_size, n_points), dtype=torch.bool, device=device)
        return exact_topn_mask(scores, n_indcs, b, batch_size)


@dataclass(frozen=True)
class CntxtTrgtSplitter:
    """Split a batch of functions into masked context and target sets:
    X/Y are shared, the masks carry the split."""

    contexts_getter: Callable = GetRandomIndcs()
    targets_getter: Callable = get_all_indcs

    def __call__(self, generator: torch.Generator, x, y, condition=None) -> dict:
        B, N = x.shape[0], x.shape[1]
        batch = dict(
            X_cntxt=x, Y_cntxt=y, mask_cntxt=self.contexts_getter(generator, B, N),
            X_trgt=x, Y_trgt=y, mask_trgt=self.targets_getter(generator, B, N),
        )
        if condition is not None:
            batch["condition"] = condition
        return batch
