"""Convolutional CNP and LNP; the counterparts of
`npf_gwwaveform_tpu/models/convnp.py::ConvCNP` and `::ConvLNP`.

SetConv context -> induced grid `linspace(-1.5, 1.5, 3*density)`, FiLM
conditioning on the grid (`cond_mode="film"`), the grid CNN (the flat `CNN`,
dilated per block by `cnn_dilations`, or with `cnn_arch="unet"` the
`UnetCNN` with at most 2 * r_dim channels), additive conditioning after it
(`cond_mode="add"`, in the base class), SetConv grid -> targets, and an
x-independent decoder. `use_kernels` routes both SetConvs through kernel K1
and the decoder through kernel K2 (the JAX package's `use_pallas_setconv`
and `fused_mlp`) through their autograd Functions, so the model trains on
either path; it changes no parameter, and on CPU tensors the kernels' plain
versions run. `model.train()` switches the grid CNN's BatchNorm to batch
statistics; the deterministic path has n_z = 1 in both modes. `dtype`
(bfloat16, or None for float32) is the compute dtype of every module but
the SetConvs' interpolation, the grid and the positional features, which
stay float32 as in JAX.

`ConvLNP` puts a latent on every grid point: q(z|C) from the grid CNN's
output through the latent encoder MLP, n_z draws folded into the batch
(so that the post-sampling CNN, a second grid CNN of the same build, and the
grid->targets SetConv, K1 at n_z * B, run on [n_z * B, ...]), with
`is_global` the second half of the channels pooled over the grid after the
post-sampling CNN, and a linear decoder that discards x (flax's `Dense`:
not the MLP chain). With `encoded_path="both"` one global latent from the
pooled grid is merged with R on every grid point (`merge_r_z`) before the
post-sampling CNN. In train mode its BatchNorm takes statistics over
n_z * B * n_induced positions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.cnn import CNN, UnetCNN
from ..ops.encoders import DiscardIthArg, SinusoidalEncodings
from ..ops.mlp import MLP, Dense, dense
from ..ops.setconv import SetConv
from ..utils import init as winit
from ..utils.helpers import (
    collapse_z_samples_batch, linspace, pool_and_replicate_middle, replicate_z_samples,
)
from .base import NeuralProcessFamily


class ConvCNP(NeuralProcessFamily):
    def __init__(self, x_dim: int = 1, y_dim: int = 1, r_dim: int = 128,
                 density_induced: int = 64, induced_range: Tuple[float, float] = (-1.5, 1.5),
                 cnn_n_blocks: int = 5, cnn_kernel_size: int = 19, cnn_norm: Optional[str] = "batch",
                 cnn_n_conv_layers: int = 2, cnn_norm_eps: float = 1e-3,
                 cnn_arch: str = "cnn", cnn_dilations: Optional[Sequence[int]] = None,
                 cond_dim: int = 0, cond_mode: str = "film", cond_pos_feats: int = 64,
                 min_sigma_pred: float = 0.01, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, **latent):
        super().__init__(x_dim, y_dim, r_dim, min_sigma_pred, cond_dim, use_kernels, dtype,
                         cond_mode, **latent)
        if x_dim != 1:
            raise ValueError("ConvCNP's induced grid is 1-D")
        if cond_mode not in ("film", "add"):
            raise ValueError(f"cond_mode={cond_mode!r}: 'film' or 'add'")
        if cnn_arch == "unet" and cnn_dilations:
            raise ValueError("cnn_dilations are not supported with cnn_arch='unet'")
        self.density_induced = density_induced
        self.induced_range = induced_range
        lo, hi = induced_range
        self.n_induced = int(density_induced * (hi - lo))
        self.cntxt_to_induced = SetConv(y_dim, r_dim, use_kernel=use_kernels, dtype=dtype)
        if cnn_arch not in ("cnn", "unet"):
            raise ValueError(f"cnn_arch={cnn_arch!r}: 'cnn' or 'unet'")
        self._cnn_args = (cnn_arch, cnn_n_blocks, cnn_kernel_size, cnn_norm, cnn_n_conv_layers,
                          cnn_norm_eps, cnn_dilations)
        self.induced_to_induced = self._make_cnn()
        self.induced_to_trgt = SetConv(r_dim, r_dim, use_kernel=use_kernels, dtype=dtype)
        self.decoder = DiscardIthArg(self._make_decoder(), i=0)
        if cond_dim > 0 and cond_mode == "film":
            self.cond_gamma = nn.Linear(r_dim, r_dim)
            self.cond_pos_enc = SinusoidalEncodings(cond_pos_feats)
            self.cond_field = MLP(cond_pos_feats + r_dim, r_dim, n_hidden_layers=2,
                                  hidden_size=r_dim, dtype=dtype)
            self.init_params()

    def _make_decoder(self) -> nn.Module:
        """The decoder behind `DiscardIthArg`: the MLP chain (K2 and K3)."""
        return self._sub_decoder(2 * self.y_dim)

    def _make_cnn(self) -> nn.Module:
        """The grid CNN: the flat `CNN`, or the `UnetCNN` with an odd block
        count, as configs._unet_factory makes it."""
        arch, n_blocks, k, norm, n_conv, eps, dilations = self._cnn_args
        if arch == "unet":
            n_blocks = n_blocks if n_blocks % 2 == 1 else n_blocks + 1
            return UnetCNN(self.r_dim, n_blocks, k, norm, n_conv, eps,
                           max_nchannels=2 * self.r_dim, dtype=self.dtype)
        return CNN(self.r_dim, n_blocks, k, norm, n_conv, eps, self.dtype, dilations)

    def init_params(self, generator=None) -> None:
        # flax's default Dense init, as the JAX model's cond_gamma
        if self.cond_dim > 0 and self.cond_mode == "film":
            winit.init_dense(self.cond_gamma, winit.lecun_normal, generator)

    def _get_x_induced(self, batch_size: int, device) -> torch.Tensor:
        lo, hi = self.induced_range
        grid = linspace(lo, hi, self.n_induced, device=device)
        return grid[None, :, None].expand(batch_size, self.n_induced, self.x_dim)

    def _film(self, R_induced, cond_emb):
        """R_induced [B, n_ind, r_dim], cond_emb [B, r_dim]."""
        B = R_induced.shape[0]
        lo, hi = self.induced_range
        pos = (self._get_x_induced(B, R_induced.device) - lo) * (2.0 / (hi - lo)) - 1.0
        feats = self.cond_pos_enc(pos)
        emb = cond_emb[:, None, :].expand(B, self.n_induced, cond_emb.shape[-1])
        field = self.cond_field(torch.cat([feats, emb], dim=-1))
        gamma = dense(self.cond_gamma, cond_emb, self.dtype)[:, None, :]
        return R_induced * (1.0 + gamma) + field

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        x_induced = self._get_x_induced(x_c.shape[0], x_c.device)
        # an empty context gives zero signal and zero density through the mask
        R_induced = self.cntxt_to_induced(x_c, x_induced, y_c, mask_cntxt)
        if cond_emb is not None and self.cond_mode == "film":
            R_induced = self._film(R_induced, cond_emb)
        return self.induced_to_induced(R_induced)

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        x_induced = self._get_x_induced(x_t.shape[0], x_t.device)
        return self.induced_to_trgt(x_induced, x_t, R)[None]


class ConvLNP(ConvCNP):
    """The latent ConvNP: `ConvCNP`'s modules, a latent per grid point
    (`encoded_path="latent"`, z_dim = r_dim unless given; `reshaper_z` maps
    z_dim to r_dim otherwise) or one global latent (`"both"`, merged with R
    by `r_z_merger`), the post-sampling CNN and a linear decoder."""

    def __init__(self, *args, encoded_path: str = "latent", is_global: bool = False, **kwargs):
        if encoded_path not in ("latent", "both"):
            raise ValueError(f"ConvLNP takes encoded_path 'latent' or 'both', not {encoded_path!r}")
        super().__init__(*args, encoded_path=encoded_path, **kwargs)
        self.is_global = is_global
        self.induced_to_induced_post_sampling = self._make_cnn()
        self._make_latent_merger()

    def _make_decoder(self) -> nn.Module:
        """A linear decoder on R only: flax's default Dense."""
        return Dense(self.r_dim, 2 * self.y_dim, dtype=self.dtype)

    def rep_to_lat_input(self, R, mask):
        """One latent per grid point ("latent"), or one from the grid's mean
        ("both") [B, 1, r_dim]."""
        if self.encoded_path == "latent":
            return R
        return R.mean(dim=-2, keepdim=True)

    def add_global_latent(self, z):
        """The second half of the channels pooled over the grid, broadcast back."""
        half = z.shape[-1] // 2
        return torch.cat([z[..., :half], pool_and_replicate_middle(z[..., half:])], dim=-1)

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        """-> [n_z, B, Nt, r_dim]: the draws folded into the batch through the
        post-sampling CNN and the grid->targets SetConv."""
        B, n_trgt = x_t.shape[:2]
        n_z = z_samples.shape[0]
        x_induced = self._get_x_induced(n_z * B, x_t.device)
        x_t_rep = collapse_z_samples_batch(replicate_z_samples(x_t, n_z))
        if self.encoded_path == "latent":
            z = collapse_z_samples_batch(z_samples)  # [n_z * B, n_ind, z_dim]
            if self.z_dim != self.r_dim:
                z = self.reshaper_z(z)
            z = self.induced_to_induced_post_sampling(z)
            if self.is_global:
                z = self.add_global_latent(z)
        else:
            z = z_samples.expand(n_z, B, self.n_induced, self.z_dim)
            z = self.induced_to_induced_post_sampling(
                collapse_z_samples_batch(self.merge_r_z(R, z)))
        R_trgt = self.induced_to_trgt(x_induced, x_t_rep, z)
        return R_trgt.reshape(n_z, B, n_trgt, self.r_dim)
