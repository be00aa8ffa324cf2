"""Context/target splitting into padded sets with boolean masks, the
counterpart of `npf_gwwaveform_tpu/data/datasplit.py`. Randomness comes from
an explicit `torch.Generator`; the mask construction from scores is a pure
function and gives the JAX package's masks bit for bit.

On image grids ([B, *grid, y_dim], channel-last) a grid masker
(generator, batch_size, grid_shape) -> bool [B, *grid] picks the context
pixels (`RandomMasker`, `no_masker`, `ResolutionMasker`, `half_masker`);
`GridCntxtTrgtSplitter` gives the grid models the masks themselves (X is
the mask), `SuperresolutionCntxtTrgtSplitter` a regular low-resolution
context, and `PointsFromGridSplitter` the point models padded point sets
(`grid_to_points`) at coordinates in [-1, 1] times `upscale_factor`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["get_all_indcs", "get_range_indcs", "GetIndcsMerger", "GetRandomIndcs",
           "exact_topn_mask", "CntxtTrgtSplitter", "RandomMasker", "no_masker",
           "ResolutionMasker", "half_masker", "GridCntxtTrgtSplitter",
           "SuperresolutionCntxtTrgtSplitter", "PointsFromGridSplitter", "unit_axis", "grid_coords",
           "grid_to_points"]


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


# ---- grid maskers: (generator, batch_size, grid_shape) -> bool [B, *grid]


@dataclass(frozen=True)
class RandomMasker:
    """n ~ U{a..b} pixels of the flattened grid (ratios of the pixel count
    below 1), `GetRandomIndcs`'s mask reshaped to the grid."""

    a: float = 0.1
    b: float = 0.5
    is_indep_n: bool = False

    def __call__(self, generator: torch.Generator, batch_size: int, grid_shape) -> torch.Tensor:
        n_pix = 1
        for s in grid_shape:
            n_pix *= s
        flat = GetRandomIndcs(a=self.a, b=self.b, is_indep_n=self.is_indep_n)(
            generator, batch_size, n_pix)
        return flat.reshape((batch_size,) + tuple(grid_shape))


def no_masker(generator, batch_size: int, grid_shape) -> torch.Tensor:
    """Every pixel selected."""
    return torch.ones((batch_size,) + tuple(grid_shape), dtype=torch.bool,
                      device=generator.device)


@dataclass(frozen=True)
class ResolutionMasker:
    """Every `factor`-th pixel along each axis, from the first."""

    factor: int = 2

    def __call__(self, generator, batch_size: int, grid_shape) -> torch.Tensor:
        mask = torch.zeros(tuple(grid_shape), dtype=torch.bool, device=generator.device)
        mask[tuple(slice(None, None, self.factor) for _ in grid_shape)] = True
        return mask[None].expand((batch_size,) + tuple(grid_shape))


def half_masker(generator, batch_size: int, grid_shape, dim: int = 0) -> torch.Tensor:
    """The first half of the grid along `dim`."""
    mask = torch.zeros(tuple(grid_shape), dtype=torch.bool, device=generator.device)
    idx = [slice(None)] * len(grid_shape)
    idx[dim] = slice(0, grid_shape[dim] // 2)
    mask[tuple(idx)] = True
    return mask[None].expand((batch_size,) + tuple(grid_shape))


def unit_axis(n: int, device=None) -> torch.Tensor:
    """`jnp.linspace(-1, 1, n)` in float32 as XLA's CPU code computes it:
    step p_i = i * fl(1 / (n - 1)) and -(1 - fl(p_i)) + p_i fused into one
    multiply-add (the product unrounded), the last point 1; equal to it bit
    for bit for every n up to 352 (each image axis), which the plain
    arithmetic (`utils.helpers.linspace`) is not. Made on `device` in
    float64, without a copy from the host."""
    if n < 2:
        return torch.full((n,), -1.0, dtype=torch.float32, device=device)
    r = torch.full((), 1.0, dtype=torch.float32, device=device) / (n - 1)
    p = torch.arange(n - 1, dtype=torch.float64, device=device) * r.double()
    out = (p - (1.0 - p.float()).double()).float()
    return torch.cat([out, torch.ones(1, dtype=torch.float32, device=device)])


def grid_coords(grid_shape, upscale_factor: float = 1.0, device=None) -> torch.Tensor:
    """[prod(grid), ndim]: each pixel's coordinates, `jnp.linspace(-1, 1, s)`
    along each axis (`unit_axis`) times `upscale_factor`, in raster order."""
    axes = [unit_axis(s, device) * upscale_factor for s in grid_shape]
    mesh = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return mesh.reshape(-1, len(grid_shape))


@dataclass(frozen=True)
class GridCntxtTrgtSplitter:
    """Context and target grid masks for the grid models, which take the
    mask as X ([B, *grid, 1]) and the whole grid as Y; the context mask is
    drawn first, then the target mask."""

    context_masker: Callable = RandomMasker()
    target_masker: Callable = no_masker
    upscale_factor: float = 1.0

    def __call__(self, generator: torch.Generator, x, y=None, condition=None) -> dict:
        """x or y [B, *grid, y_dim] (y when given) -> the split batch."""
        y_grid = x if y is None else y
        B, grid_shape = y_grid.shape[0], tuple(y_grid.shape[1:-1])
        mask_cntxt = self.context_masker(generator, B, grid_shape)
        mask_trgt = self.target_masker(generator, B, grid_shape)
        return dict(X_cntxt=mask_cntxt[..., None], Y_cntxt=y_grid, mask_cntxt=mask_cntxt,
                    X_trgt=mask_trgt[..., None], Y_trgt=y_grid, mask_trgt=mask_trgt)

    def coords(self, grid_shape, device=None) -> torch.Tensor:
        """`grid_coords` at this splitter's `upscale_factor`."""
        return grid_coords(grid_shape, self.upscale_factor, device)


@dataclass(frozen=True)
class SuperresolutionCntxtTrgtSplitter:
    """The image at every `resolution_factor`-th pixel as the context, the
    whole grid as the targets (X_trgt all ones in y's dtype, as in JAX)."""

    resolution_factor: int = 2

    def __call__(self, generator: torch.Generator, x, y=None, condition=None) -> dict:
        y_grid = x if y is None else y
        B, grid_shape = y_grid.shape[0], tuple(y_grid.shape[1:-1])
        mask_cntxt = ResolutionMasker(self.resolution_factor)(generator, B, grid_shape)
        ones = torch.ones((B,) + grid_shape, dtype=torch.bool, device=y_grid.device)
        return dict(X_cntxt=mask_cntxt[..., None], Y_cntxt=y_grid, mask_cntxt=mask_cntxt,
                    X_trgt=ones[..., None].to(y_grid.dtype), Y_trgt=y_grid, mask_trgt=ones)


@dataclass(frozen=True)
class PointsFromGridSplitter:
    """Padded point sets of an image batch for the point models: the
    context pixels `context_masker` picks, every pixel as a target, both
    padded to the pixel count (`grid_to_points`), coordinates in [-1, 1]
    times `upscale_factor`."""

    context_masker: Callable = RandomMasker()
    upscale_factor: float = 1.0

    def __call__(self, generator: torch.Generator, x, y=None, condition=None) -> dict:
        y_grid = x if y is None else y
        B, grid_shape = y_grid.shape[0], tuple(y_grid.shape[1:-1])
        n_pix = 1
        for s in grid_shape:
            n_pix *= s
        mask_cntxt = self.context_masker(generator, B, grid_shape)
        xc, yc, mc = grid_to_points(y_grid, mask_cntxt, n_pix, self.upscale_factor)
        full = torch.ones((B,) + grid_shape, dtype=torch.bool, device=y_grid.device)
        xt, yt, mt = grid_to_points(y_grid, full, n_pix, self.upscale_factor)
        return dict(X_cntxt=xc, Y_cntxt=yc, mask_cntxt=mc, X_trgt=xt, Y_trgt=yt, mask_trgt=mt)


def grid_to_points(y_grid: torch.Tensor, mask: torch.Tensor, n_max: int,
                   upscale_factor: float = 1.0) -> tuple:
    """(image [B, *grid, y_dim], mask [B, *grid]) -> (x [B, n_max, ndim], y
    [B, n_max, y_dim], mask [B, n_max]): the masked-in pixels first, each
    part in raster order (a stable sort), cut to n_max."""
    B, grid_shape, y_dim = y_grid.shape[0], tuple(y_grid.shape[1:-1]), y_grid.shape[-1]
    coords = grid_coords(grid_shape, upscale_factor, y_grid.device)
    flat_mask = mask.reshape(B, -1)
    order = torch.sort((~flat_mask).to(torch.uint8), dim=-1, stable=True)[1][:, :n_max]
    x = coords[order]
    y = y_grid.reshape(B, -1, y_dim).gather(1, order[..., None].expand(-1, -1, y_dim))
    return x, y, flat_mask.gather(1, order)
