"""Image plots for the grid models, the counterpart of
`npf_gwwaveform_tpu/viz/visualize_imgs.py`: the predictive on a context
mask (`get_posterior_samples_imgs`), points back onto a grid
(`points_to_grid`), Sarle's bimodality coefficient (`sarle`), the mixture
marginal over pixel intensity (`marginal_pred`) and the panels that show
them.

The compute functions run on any device and return tensors there, their
noise an input (a generator on the model's device, seeded 0 when none is
given, or the model's z noise `eps`); the mixture marginal is a
`torch.logsumexp` in float64 where JAX calls scipy's on numpy's float64.
The plotting draws on the CPU with matplotlib (seaborn for the KDE where
present), imported inside the functions. A torch model holds its own
parameters, so the functions take no flax `variables`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .helpers import eval_draws, generator_or_seed0, pyplot
from .helpers import to_numpy as _np

__all__ = ["points_to_grid", "plot_dataset_samples_imgs", "sarle", "marginal_pred",
           "plot_img_marginal_pred", "plot_qualitative_with_kde", "get_posterior_samples_imgs",
           "plot_posterior_samples_imgs"]


def points_to_grid(x, y, grid_shape, fill: float = 0.0) -> torch.Tensor:
    """Scatter a point set back onto a grid (the inverse of
    `data.datasplit.grid_to_points`): x [B, N, d] in [-1, 1]^d to the pixel
    round((x + 1) / 2 (size - 1)) (half to even, as numpy), clipped to the
    grid; y [B, N, C] -> float32 [B, *grid_shape, C] filled with `fill`
    elsewhere, on x's device. Where two points land on one pixel the later
    one is kept."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    B, N = x.shape[0], x.shape[1]
    canvas = torch.full((B,) + tuple(grid_shape) + (y.shape[-1],), fill, dtype=torch.float32,
                        device=x.device)
    idx = [torch.arange(B, device=x.device)[:, None].expand(B, N)]
    for d, size in enumerate(grid_shape):
        i = torch.round((x[:, :, d].float() + 1.0) / 2.0 * (size - 1)).long()
        idx.append(i.clamp(0, size - 1))
    flat = idx[0]
    for d, size in enumerate(grid_shape):
        flat = flat * size + idx[d + 1]
    # the last write of a pixel wins, as numpy's fancy assignment leaves it
    order = torch.arange(B * N, device=x.device)
    last = torch.full((canvas[..., 0].numel(),), -1, dtype=torch.long, device=x.device)
    last.scatter_reduce_(0, flat.reshape(-1), order, reduce="amax")
    keep = last[flat.reshape(-1)] == order
    canvas.reshape(-1, y.shape[-1])[flat.reshape(-1)[keep]] = y.reshape(-1, y.shape[-1])[
        keep].float()
    return canvas


def plot_dataset_samples_imgs(dataset, n_plots: int = 4, ax=None, pad_value: float = 1.0,
                              seed: int = 123, title=None):
    """`n_plots` images of the dataset (indices from
    `np.random.default_rng(seed)`) tiled two to a row."""
    rng = np.random.default_rng(seed)
    imgs = _np(dataset.images)[rng.integers(0, len(dataset), n_plots)]
    n, h, w, c = imgs.shape
    ncol, pad = 2, 2
    nrow = int(np.ceil(n / ncol))
    grid = np.full((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        top, left = pad + r * (h + pad), pad + col * (w + pad)
        grid[top: top + h, left: left + w] = imgs[i]
    if ax is None:
        _, ax = pyplot().subplots(figsize=(5, 5))
    ax.imshow(grid.squeeze(-1) if c == 1 else grid, cmap="gray" if c == 1 else None)
    if title is not None:
        ax.set_title(title)
    ax.axis("off")
    return ax


def sarle(out: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sarle's bimodality coefficient along `axis`: (g^2 + 1) / (k + 3 (n -
    1)^2 / ((n - 2)(n - 2))) with g the skewness and k the excess kurtosis
    (both the biased moment ratios, scipy's defaults) and, as the reference
    writes it, n = out.shape[1]. Lower denominators, higher values: more
    bimodal."""
    out = torch.as_tensor(out)
    d = out - out.mean(dim=axis, keepdim=True)
    m2 = (d * d).mean(dim=axis)
    m3 = (d ** 3).mean(dim=axis)
    m4 = (d ** 4).mean(dim=axis)
    k = m4 / (m2 * m2) - 3.0
    g = m3 / m2 ** 1.5
    n = out.shape[1]
    return (g ** 2 + 1) / (k + 3 * (n - 1) ** 2 / ((n - 2) * (n - 2)))


def marginal_pred(locs: torch.Tensor, scales: torch.Tensor, n_grid: int = 1000) -> tuple:
    """The mixture marginal density over pixel intensity of the first image's
    first channel: locs, scales [n_z, B, H, W, C] -> (intensities [n_grid]
    on [0, 1], density [n_grid, H * W]), the mean over the z draws of each
    N(a; mu, max(sd, 1e-6)), by a logsumexp in float64 (the scale's log in
    float32, as numpy computes JAX's version)."""
    n_z = locs.shape[0]
    mu = locs[:, 0, ..., 0].reshape(n_z, -1).float()
    sd = scales[:, 0, ..., 0].reshape(n_z, -1).float().clamp_min(1e-6)
    # numpy's linspace arithmetic: i * (1 / (n - 1)), the last point exactly 1
    arange = torch.arange(n_grid, dtype=torch.float64, device=locs.device) * (1.0 / (n_grid - 1))
    arange[-1] = 1.0
    # numpy's promotions in JAX's version: float64 with the grid, the log of
    # the float32 scale in float32
    z2 = ((arange[:, None, None] - mu[None].double()) / sd[None].double()) ** 2
    log_p = -0.5 * z2 - torch.log(sd[None]).double() - 0.5 * math.log(2 * math.pi)
    return arange, torch.exp(torch.logsumexp(log_p, dim=1) - math.log(n_z))


def get_posterior_samples_imgs(model, mask_cntxt, y_grid, n_samples: int = 3,
                               generator: Optional[torch.Generator] = None,
                               eps: Optional[torch.Tensor] = None) -> tuple:
    """The predictive (loc, scale) [n_z, B, H, W, C] of a grid model on the
    whole grid given a context mask [B, H, W, 1] (a latent model at
    `n_samples` draws); eval mode under no_grad, the model's mode and draw
    count restored."""
    gen = generator_or_seed0(generator, y_grid.device) if model.has_latent and eps is None else None
    mask = mask_cntxt.float()
    with eval_draws(model, n_samples):
        out = model(mask, y_grid, torch.ones_like(mask), generator=gen, eps=eps)
    return out.p_yCc.loc, out.p_yCc.scale


def plot_img_marginal_pred(model, mask_cntxt, y_grid, n_samples: int = 64,
                           n_marginals: int = 5, pixel=None,
                           generator: Optional[torch.Generator] = None, eps=None):
    """The mixture marginal predictive over pixel intensity of the first
    image (`marginal_pred`) for the `n_marginals` pixels Sarle's
    coefficient ranks most multi-modal, or for `pixel=(i, j)`."""
    locs, scales = get_posterior_samples_imgs(model, mask_cntxt, y_grid, n_samples, generator,
                                              eps)
    W = y_grid.shape[2]
    arange, out = marginal_pred(locs, scales)
    arange, out = _np(arange), out.cpu().numpy()
    if pixel is not None:
        flat_idx = [pixel[0] * W + pixel[1]]
    else:
        flat_idx = np.argsort(sarle(torch.from_numpy(out)).numpy())[:n_marginals]
    fig, ax = pyplot().subplots(figsize=(5, 3))
    ax.plot(arange, out[:, flat_idx], alpha=0.7)
    ax.set_yticks([])
    ax.set_ylabel("Marginal Predictive")
    ax.set_xlabel("Pixel Intensity")
    ax.set_xlim(-0.1, 1)
    ax.set_xticks([0, 0.5, 1])
    return fig


def _show(ax, img):
    img = _np(img)
    if img.shape[-1] == 1:
        ax.imshow(img[..., 0], cmap="gray", vmin=0, vmax=1)
    else:
        ax.imshow(np.clip(img, 0, 1))
    ax.set_xticks([])
    ax.set_yticks([])


def plot_posterior_samples_imgs(model, mask_cntxt, y_grid, n_samples: int = 2,
                                generator: Optional[torch.Generator] = None, fig=None, eps=None):
    """A row an image: the target, the masked context (grey where unseen)
    and the predictive mean of each draw."""
    locs, _ = get_posterior_samples_imgs(model, mask_cntxt, y_grid, n_samples, generator, eps)
    locs = _np(locs)
    n_z, B = locs.shape[0], y_grid.shape[0]
    if fig is None:
        fig, axes = pyplot().subplots(B, n_z + 2, figsize=(2 * (n_z + 2), 2 * B))
    else:
        axes = fig.subplots(B, n_z + 2)
    axes = np.atleast_2d(axes)
    mask, imgs = _np(mask_cntxt).astype(np.float32), _np(y_grid)
    for b in range(B):
        _show(axes[b, 0], imgs[b])
        axes[b, 0].set_title("target" if b == 0 else "")
        _show(axes[b, 1], imgs[b] * mask[b] + 0.5 * (1 - mask[b]))
        axes[b, 1].set_title("context" if b == 0 else "")
        for z in range(n_z):
            _show(axes[b, z + 2], locs[z, b])
            if b == 0:
                axes[b, z + 2].set_title(f"sample {z}")
    return fig


def plot_qualitative_with_kde(model, images, lls, percentiles=(1, 25, 50, 75, 99),
                              context_fraction: float = 0.3, model_compare=None,
                              lls_compare=None, name: str = "model",
                              name_compare: str = "compare",
                              generator: Optional[torch.Generator] = None):
    """A KDE of per-image test log-likelihoods with percentile markers (a
    histogram without seaborn), and in-painting panels of the images whose
    LL lies nearest each percentile (numpy's "nearest" percentile, then
    the closest LL); a second model (`model_compare`, `lls_compare`) adds
    its KDE and its reconstructions of the same images under the same
    context mask (each pixel a context with `context_fraction`, drawn from
    `generator`)."""
    plt = pyplot()
    lls = np.asarray(lls)
    idx = [int(np.argmin(np.abs(lls - np.percentile(lls, p, method="nearest"))))
           for p in percentiles]
    n_panel_rows = 2 if model_compare is None else 3
    fig = plt.figure(figsize=(3 * len(percentiles), 4 + 2 * n_panel_rows))
    gs = fig.add_gridspec(2, 1, height_ratios=[1, n_panel_rows])
    ax_kde = fig.add_subplot(gs[0])

    def kde(vals, label):
        try:
            import seaborn as sns
        except ImportError:
            ax_kde.hist(np.asarray(vals), bins=50, density=True, alpha=0.5, label=label)
            return
        sns.kdeplot(np.asarray(vals), ax=ax_kde, fill=True, label=label, cut=0)

    kde(lls, name)
    if lls_compare is not None:
        left = ax_kde.get_xlim()[0]
        kde(lls_compare, name_compare)
        ax_kde.set_xlim(left=left)
    for p, i in zip(percentiles, idx):
        ax_kde.axvline(lls[i], color="tab:green", ls=":", alpha=0.7)
        ax_kde.text(lls[i], ax_kde.get_ylim()[1] * 0.9, f"{p}%", fontsize=7)
    ax_kde.set_xlabel("Test Log-Likelihood")
    ax_kde.set_ylabel("Density")
    ax_kde.legend(loc="upper left")

    device = next(model.parameters()).device
    sel = torch.stack([torch.as_tensor(images[i]) for i in idx]).float().to(device)
    gen = generator_or_seed0(generator, device)
    mask = (torch.rand(sel.shape[:-1], generator=gen, device=device) < context_fraction)[..., None]
    sub = fig.add_subfigure(gs[1])
    if model_compare is None:
        plot_posterior_samples_imgs(model, mask, sel, n_samples=1, generator=gen, fig=sub)
        return fig
    locs, _ = get_posterior_samples_imgs(model, mask, sel, 1, gen)
    locs_c, _ = get_posterior_samples_imgs(model_compare, mask, sel, 1, gen)
    axes = sub.subplots(3, len(idx), squeeze=False)
    maskf, imgs = _np(mask).astype(np.float32), _np(sel)
    for b in range(len(idx)):
        rows = [imgs[b] * maskf[b] + 0.5 * (1 - maskf[b]), _np(locs[0, b]), _np(locs_c[0, b])]
        for r, img in enumerate(rows):
            _show(axes[r, b], img)
            if b == 0:
                axes[r, 0].set_ylabel(["Context", name, name_compare][r])
    return fig
