"""Convolutional CNP and LNP on a fixed grid; the counterparts of
`npf_gwwaveform_tpu/models/gridconvnp.py::GridConvCNP` and `::GridConvLNP`.

Context, targets and the induced points share one grid of `n_spatial` axes
(2 for images): X is the context (or target) mask [B, *grid, 1] and Y the
whole grid [B, *grid, y_dim], channel-last; the point sets' masks are not
read. The context embedding (`cntxt_to_induced`) convolves the masked
signal and the mask itself (the density) with one `AbsConv` (|w|,
depthwise over the y_dim channels), divides the signal by max(density,
1e-5), concatenates the density and maps the 2 * y_dim channels to r_dim
(`resizer`, a flax Dense); the grid CNN (`induced_to_induced`) follows, and
the decoder discards x: the MLP chain (K2 forward and K3 backward with
`use_kernels`) on every pixel, B * H * W rows. `conv_padding` "CIRCULAR"
wraps the grid in the AbsConv and in every CNN convolution (full
translation equivariance, the zsmms configuration). `cnn_remat` recomputes
each CNN block in the backward pass. `dtype` (bfloat16, or None for
float32) is the compute dtype of the `resizer`, the grid CNNs, the latent
path's Dense layers and the decoders, as in JAX; the AbsConv computes in
its input's dtype (float32: the grid's values), and so do the density
floor and the division, as in JAX.

`GridConvLNP` adds ConvLNP's latent path: q(z|C) per grid point from the
grid CNN's output ("latent"; with `is_global` the second half of z's
channels pooled over the grid before the post-sampling CNN), or one latent
from the grid's mean over its last spatial axis ("both", merged with R
by `r_z_merger`: on a 1-D grid only, where that mean is the whole grid's;
the JAX package's own reshape refuses a 2-D grid there and so does this
one), the n_z draws folded into the batch through the post-sampling CNN
(`induced_to_induced_post_sampling`), and a linear decoder (a flax Dense,
not the MLP chain).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cnn import CNN, AbsConv
from ..ops.encoders import DiscardIthArg
from ..ops.mlp import Dense
from ..utils import init as winit
from ..utils.helpers import collapse_z_samples_batch, pool_and_replicate_middle
from .base import NeuralProcessFamily

__all__ = ["GridConvCNP", "GridConvLNP"]


class GridConvCNP(NeuralProcessFamily):
    def __init__(self, x_dim: int = 1, y_dim: int = 1, r_dim: int = 128,
                 cnn_n_blocks: int = 5, cnn_kernel_size: int = 9, cnn_norm: Optional[str] = "batch",
                 cnn_n_conv_layers: int = 2, cnn_norm_eps: float = 1e-3,
                 conv_kernel_size: int = 11, conv_padding: str = "SAME", n_spatial: int = 2,
                 cnn_remat: bool = False, min_sigma_pred: float = 0.01, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, **latent):
        super().__init__(x_dim, y_dim, r_dim, min_sigma_pred, 0, use_kernels, dtype, **latent)
        self.n_spatial = n_spatial
        self._cnn_args = (cnn_n_blocks, cnn_kernel_size, cnn_norm, cnn_n_conv_layers,
                          cnn_norm_eps, n_spatial, conv_padding, cnn_remat)
        self.conv = AbsConv(y_dim, conv_kernel_size, conv_padding, n_spatial)
        self.resizer = Dense(2 * y_dim, r_dim, dtype,
                             kernel_init=winit.switchable(winit.lecun_normal))
        self.induced_to_induced = self._make_cnn()
        self.decoder = DiscardIthArg(self._make_decoder(), i=0)

    def _make_cnn(self) -> CNN:
        n_blocks, k, norm, n_conv, eps, n_spatial, padding, remat = self._cnn_args
        return CNN(self.r_dim, n_blocks, k, norm, n_conv, eps, self.dtype, n_spatial=n_spatial,
                   padding=padding, remat=remat)

    def _make_decoder(self) -> nn.Module:
        """The decoder behind `DiscardIthArg`: the MLP chain (K2 and K3)."""
        return self._sub_decoder(2 * self.y_dim)

    def cntxt_to_induced(self, mask_cntxt_grid: torch.Tensor, y_grid: torch.Tensor):
        """mask [B, *grid, 1], y [B, *grid, y_dim] -> [B, *grid, r_dim]."""
        mask = mask_cntxt_grid.to(y_grid.dtype)
        signal = self.conv(y_grid * mask)
        density = self.conv(mask.expand(y_grid.shape))
        out = torch.cat([signal / density.clamp_min(1e-5), density], dim=-1)
        return self.resizer(out)

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        return self.induced_to_induced(self.cntxt_to_induced(x_c, y_c))

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        return R[None]

    def seq_targets(self, x_t, mask_trgt, mesh):
        raise NotImplementedError("a grid model's targets are its grid, which the seq axis does "
                                  "not split: ROADMAP queue 1, item 9")


class GridConvLNP(GridConvCNP):
    """`encoded_path` "latent" (the default) or "both"; four blocks in both
    grid CNNs in the image configuration."""

    def __init__(self, *args, encoded_path: str = "latent", is_global: bool = False, **kwargs):
        if encoded_path not in ("latent", "both"):
            raise ValueError(f"GridConvLNP takes encoded_path 'latent' or 'both', not "
                             f"{encoded_path!r}")
        super().__init__(*args, encoded_path=encoded_path, **kwargs)
        self.is_global = is_global
        self.induced_to_induced_post_sampling = self._make_cnn()
        self._make_latent_merger()

    def _make_decoder(self) -> nn.Module:
        """A linear decoder on R only: flax's default Dense."""
        return Dense(self.r_dim, 2 * self.y_dim, self.dtype)

    def rep_to_lat_input(self, R, mask):
        """R itself ("latent"), or its mean over the last spatial axis
        ("both", JAX's `mean(axis=-2)`)."""
        if self.encoded_path == "latent":
            return R
        return R.mean(dim=-2, keepdim=True)

    def add_global_latent(self, z):
        """The second half of the channels pooled over the grid, broadcast back."""
        half = z.shape[-1] // 2
        return torch.cat([z[..., :half], pool_and_replicate_middle(z[..., half:])], dim=-1)

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        """-> [n_z, B, *grid, r_dim]: the draws folded into the batch
        through the post-sampling CNN."""
        B, grid_shape = x_t.shape[0], tuple(x_t.shape[1:-1])
        n_z = z_samples.shape[0]
        if self.encoded_path == "latent":
            z = collapse_z_samples_batch(z_samples)  # [n_z * B, *grid, z_dim]
            if self.is_global:
                z = self.add_global_latent(z)
            if self.z_dim != self.r_dim:
                z = self.reshaper_z(z)
            R_trgt = self.induced_to_induced_post_sampling(z)
        else:
            lead = (n_z, B)
            z = z_samples.reshape(lead + (1,) * len(grid_shape) + (self.z_dim,))
            z = z.expand(lead + grid_shape + (self.z_dim,))
            R_trgt = self.induced_to_induced_post_sampling(
                collapse_z_samples_batch(self.merge_r_z(R, z)))
        return R_trgt.reshape((n_z, B) + grid_shape + (self.r_dim,))
