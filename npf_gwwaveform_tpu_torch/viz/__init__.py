"""Plots of the port's models and data, the counterpart of
`npf_gwwaveform_tpu/viz`: the compute functions run on any device; the
plotting imports matplotlib (and PIL, seaborn, imageio) inside the
functions, on the CPU."""

from .helpers import fig2img, giffify, plot_config
from .visualize_1d import (
    gen_p_y_pred, plot_dataset_samples_1d, plot_losses, plot_posterior_samples_1d,
    plot_prior_samples_1d,
)
from .visualize_imgs import (
    get_posterior_samples_imgs, marginal_pred, plot_dataset_samples_imgs,
    plot_img_marginal_pred, plot_posterior_samples_imgs, plot_qualitative_with_kde,
    points_to_grid, sarle,
)

__all__ = [
    "fig2img",
    "giffify",
    "plot_config",
    "plot_dataset_samples_1d",
    "plot_prior_samples_1d",
    "plot_posterior_samples_1d",
    "plot_losses",
    "gen_p_y_pred",
    "plot_dataset_samples_imgs",
    "plot_img_marginal_pred",
    "plot_posterior_samples_imgs",
    "plot_qualitative_with_kde",
    "points_to_grid",
    "get_posterior_samples_imgs",
    "marginal_pred",
    "sarle",
]
