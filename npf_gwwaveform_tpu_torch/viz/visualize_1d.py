"""1-D plots, the counterpart of `npf_gwwaveform_tpu/viz/visualize_1d.py`:
predictive draws (`gen_p_y_pred`), dataset and prior draws, the posterior
band against the exact GP, and loss curves.

`gen_p_y_pred` runs on any device and returns tensors there; its noise is
an input: the z draws of a latent model and the observation noise come
from `generator` (a generator on the model's device, seeded 0 when none
is given), or are given as `eps` (the model's z noise) and `obs_eps`. The
plotting functions draw on the CPU with matplotlib, imported inside them.
The JAX functions take a flax `variables` tree beside the model; a torch
model holds its own parameters, so the port's take the model alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.helpers import linspace
from .helpers import eval_draws, generator_or_seed0, pyplot
from .helpers import to_numpy as _np

__all__ = ["gen_p_y_pred", "plot_dataset_samples_1d", "plot_prior_samples_1d",
           "plot_posterior_samples_1d", "plot_losses"]


def gen_p_y_pred(model, batch: dict, n_samples: int = 1,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None,
                 obs_eps: Optional[torch.Tensor] = None) -> tuple:
    """Predictive curves of a split batch (no targets' values are given; its
    `condition` where it holds one, which JAX's function never passes, so
    that a conditioned GW run draws too):
    for a latent model `n_samples` z draws (its `n_z_samples_test` set to
    it for the call); for a deterministic one with `n_samples` > 1, draws
    of the observation noise around its one prediction. Returns (locs
    [S, B, Nt, y], scales, samples), the samples loc + scale * obs_eps of
    every draw of a latent model, the deterministic model's `n_samples`
    noisy draws, or its loc. The forward runs in eval mode under no_grad;
    the model's mode and draw count are restored."""
    device = batch["X_trgt"].device
    latent = model.has_latent
    draws = latent and (eps is None or obs_eps is None) or n_samples > 1 and obs_eps is None
    gen = generator_or_seed0(generator, device) if draws else None
    with eval_draws(model, n_samples):
        out = model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                    mask_cntxt=batch.get("mask_cntxt"), mask_trgt=batch.get("mask_trgt"),
                    condition=batch.get("condition"),
                    generator=gen if latent and eps is None else None, eps=eps)
    loc, scale = out.p_yCc.loc, out.p_yCc.scale
    if latent or n_samples > 1:
        shape = loc.shape if latent else (n_samples,) + tuple(loc.shape[1:])
        if obs_eps is None:
            obs_eps = torch.randn(shape, generator=gen, device=device, dtype=loc.dtype)
        samples = loc + scale * obs_eps if latent else loc[0][None] + scale[0][None] * obs_eps
    else:
        samples = loc
    return loc, scale, samples


def plot_dataset_samples_1d(dataset, n_samples: int = 4, ax=None, title=None,
                            generator: Optional[torch.Generator] = None):
    """A few function draws of a dataset (`get_samples`)."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(7, 4))
    x, y = dataset.get_samples(n_samples, generator=generator)
    x, y = _np(x), _np(y)
    for i in range(n_samples):
        ax.plot(x[i, :, 0], y[i, :, 0], alpha=0.7)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if title:
        ax.set_title(title)
    return ax


def plot_prior_samples_1d(model, x_trgt=None, n_samples: int = 5, ax=None,
                          generator: Optional[torch.Generator] = None, eps=None,
                          obs_eps=None):
    """Prior draws: the predictions given an empty context, on 128 points
    over [-1, 1] unless `x_trgt` [B, Nt, x_dim] is given."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(7, 4))
    device = next(model.parameters()).device
    if x_trgt is None:
        x_trgt = linspace(-1.0, 1.0, 128, device=device)[None, :, None]
    B, NT = x_trgt.shape[0], x_trgt.shape[1]
    batch = dict(X_cntxt=torch.zeros((B, 1, x_trgt.shape[-1]), device=device),
                 Y_cntxt=torch.zeros((B, 1, model.y_dim), device=device), X_trgt=x_trgt,
                 mask_cntxt=torch.zeros((B, 1), dtype=torch.bool, device=device),
                 mask_trgt=torch.ones((B, NT), dtype=torch.bool, device=device))
    _, _, samples = gen_p_y_pred(model, batch, n_samples, generator, eps, obs_eps)
    xs, samples = _np(x_trgt[0, :, 0]), _np(samples)
    for s in range(samples.shape[0]):
        ax.plot(xs, samples[s, 0, :, 0], alpha=0.6)
    ax.set_title("prior samples")
    return ax


def plot_posterior_samples_1d(batch, model, gp_sampler=None, n_samples: int = 3,
                              train_min_max=(-1.0, 1.0), ax=None,
                              generator: Optional[torch.Generator] = None, title=None, eps=None,
                              obs_eps=None):
    """The first function's predictive mean +/- std of each draw, its
    context points, the exact GP posterior of `gp_sampler` where given, and
    the training range's edges where the targets go past them."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(8, 4.5))
    locs, scales, _ = gen_p_y_pred(model, batch, n_samples, generator, eps, obs_eps)
    locs, scales = _np(locs), _np(scales)
    xs = _np(batch["X_trgt"][0, :, 0])
    order = np.argsort(xs)
    xs_o = xs[order]
    for s in range(locs.shape[0]):
        mu = locs[s, 0, :, 0][order]
        sd = scales[s, 0, :, 0][order]
        (line,) = ax.plot(xs_o, mu, alpha=0.8, label="model" if s == 0 else None)
        ax.fill_between(xs_o, mu - sd, mu + sd, alpha=0.15, color=line.get_color())
    xc, yc = _np(batch["X_cntxt"][0, :, 0]), _np(batch["Y_cntxt"][0, :, 0])
    if batch.get("mask_cntxt") is not None:
        sel = _np(batch["mask_cntxt"])[0].astype(bool)
        xc, yc = xc[sel], yc[sel]
    ax.scatter(xc, yc, c="k", zorder=3, s=18, label="context")
    if gp_sampler is not None and len(xc) > 0:
        mean, std = gp_sampler.posterior(torch.from_numpy(xc)[:, None],
                                         torch.from_numpy(yc)[:, None],
                                         torch.from_numpy(xs_o)[:, None])
        mean, std = _np(mean), _np(std)
        ax.plot(xs_o, mean, "k--", lw=1, alpha=0.7, label="oracle GP")
        ax.fill_between(xs_o, mean - std, mean + std, color="k", alpha=0.08)
    if xs_o.min() < train_min_max[0] or xs_o.max() > train_min_max[1]:
        for b in train_min_max:
            ax.axvline(b, color="r", ls=":", alpha=0.5)
    ax.legend(loc="upper right", fontsize=8)
    if title:
        ax.set_title(title)
    return ax


def plot_losses(histories: dict, ax=None, y: str = "train_loss"):
    """Loss curves of history lists ({"epoch", y} records) by name."""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(7, 4))
    for name, hist in histories.items():
        ax.plot([h["epoch"] for h in hist], [h[y] for h in hist], label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel(y)
    ax.legend()
    return ax
