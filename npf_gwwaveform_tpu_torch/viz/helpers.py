"""Figure plumbing, the counterpart of `npf_gwwaveform_tpu/viz/helpers.py`:
a figure to an RGB array (`fig2img`), a seaborn plotting context
(`plot_config`) and a GIF of a parameter sweep (`giffify`). matplotlib,
PIL, seaborn and imageio are imported inside the functions: the module
imports without them.
"""

from __future__ import annotations

import contextlib
import io
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["fig2img", "plot_config", "giffify", "pyplot", "to_numpy", "generator_or_seed0",
           "eval_draws"]


def pyplot():
    """matplotlib's pyplot on the Agg backend (no display needed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def to_numpy(t) -> np.ndarray:
    """A tensor (any device, any float dtype) as a float32 numpy array, or
    an array as it is."""
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def generator_or_seed0(generator: Optional[torch.Generator], device) -> torch.Generator:
    """`generator`, or a new one on `device` seeded 0 (JAX's functions draw
    from `PRNGKey(0)` when given no key)."""
    return torch.Generator(device=device).manual_seed(0) if generator is None else generator


@contextlib.contextmanager
def eval_draws(model, n_samples: int):
    """The model in eval mode under no_grad, a latent model at `n_samples`
    z draws (JAX's `clone(n_z_samples_test=...)`); its mode and draw count
    restored after."""
    latent = model.has_latent
    n_z, was_training = getattr(model, "n_z_samples_test", None), model.training
    model.eval()
    if latent:
        model.n_z_samples_test = n_samples
    try:
        with torch.no_grad():
            yield model
    finally:
        if latent:
            model.n_z_samples_test = n_z
        model.train(was_training)


def fig2img(fig, dpi: int = 100) -> np.ndarray:
    """Render a matplotlib figure to an RGB uint8 array [H, W, 3]."""
    import PIL.Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi, bbox_inches="tight")
    buf.seek(0)
    return np.asarray(PIL.Image.open(buf).convert("RGB"))


@contextlib.contextmanager
def plot_config(style="whitegrid", font_scale=1.2, rc=None):
    """Apply a seaborn style and the "notebook" context for the block;
    matplotlib's seaborn-like style where seaborn is absent."""
    plt = pyplot()
    try:
        import seaborn as sns
    except ImportError:
        sns = None
    if sns is not None:
        with sns.axes_style(style), sns.plotting_context("notebook", font_scale=font_scale,
                                                         rc=rc or {}):
            yield
    else:
        name = "seaborn-v0_8-whitegrid"
        with plt.style.context(name if name in plt.style.available else "default"):
            yield


def giffify(save_filename: str, gen_single_fig: Callable, sweep_parameter: str,
            sweep_values: Sequence, fps: int = 2, **kwargs) -> None:
    """Call `gen_single_fig(**{sweep_parameter: v}, **kwargs)` for each value
    and write the figures, padded white to a common size, as a looping GIF
    at `fps` frames a second."""
    import imageio

    plt = pyplot()
    frames = []
    for v in sweep_values:
        fig = gen_single_fig(**{sweep_parameter: v}, **kwargs)
        frames.append(fig2img(fig))
        plt.close(fig)
    h = max(f.shape[0] for f in frames)
    w = max(f.shape[1] for f in frames)
    padded = []
    for f in frames:
        canvas = np.full((h, w, 3), 255, np.uint8)
        canvas[: f.shape[0], : f.shape[1]] = f
        padded.append(canvas)
    imageio.mimsave(save_filename, padded, duration=int(1000 / fps), loop=0)
