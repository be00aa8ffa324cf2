"""Conditional and latent neural processes, the counterparts of
`npf_gwwaveform_tpu/models/np.py::CNP` and `::LNP`.

The x-encoder is an MLP (x_dim -> x_transf_dim, one hidden layer of
r_dim). The xy-encoder sum-merges the encoded x with y (`MergeFlatInputs`:
y resized to x's width by an MLP, relu of the sum) into an MLP of two
hidden layers (`xy_hidden_size`; None is JAX's class default, r_dim
clamped to at most max(in, out)); CNP mean-pools its per-point
representations over the real context points into one R [B, 1, r_dim],
zero for an empty context. The decoder sum-merges the encoded targets with
R_trgt into the decoder MLP of four hidden layers of r_dim, kernel K2
forward and K3 backward with `use_kernels` (JAX's `fused_mlp`; the same
parameters either way).

LNP adds the latent path: q(z|C) from the pooled R (the latent encoder),
z drawn n_z times (`n_z_samples_train` / `n_z_samples_test`), and with
`encoded_path` "latent" z (through `reshaper_z` where z_dim != r_dim) or
with "both" `merge_r_z`(R, z) as the representation of every target: the
decoder then runs on n_z * B * n_trgt rows.

`dtype` (bfloat16, or None for float32) is the compute dtype of the
x-encoder, the xy-encoder, the latent encoder, `merge_r_z` and the decoder
MLP, as JAX's modules take `dtype`; the `resizer` MLPs of the sum-merges
have none in JAX and compute in float32 (the dtype a bf16 input and their
float32 parameters promote to). The latent noise is drawn in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.encoders import MergeFlatInputs
from ..ops.mlp import MLP
from ..utils.helpers import masked_mean
from .base import NeuralProcessFamily

__all__ = ["CNP", "LNP"]


class CNP(NeuralProcessFamily):
    def __init__(self, x_dim: int = 1, y_dim: int = 1, r_dim: int = 128,
                 x_transf_dim: Optional[int] = None, xy_hidden_size: Optional[int] = None,
                 min_sigma_pred: float = 0.01, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, **latent):
        super().__init__(x_dim, y_dim, r_dim, min_sigma_pred, 0, use_kernels, dtype, **latent)
        self.x_transf_dim = r_dim if x_transf_dim is None else x_transf_dim
        self.x_encoder = MLP(x_dim, self.x_transf_dim, n_hidden_layers=1, hidden_size=r_dim,
                             dtype=dtype)
        self.decoder = MergeFlatInputs(self._sub_decoder(2 * y_dim), self.x_transf_dim, r_dim,
                                       is_sum_merge=True)
        self.xy_encoder = self._make_xy_encoder(xy_hidden_size)

    def _sub_decoder(self, n_out: int) -> MLP:
        return MLP(self.x_transf_dim, n_out, n_hidden_layers=4, hidden_size=self.r_dim,
                   fused=self.use_kernels, dtype=self.dtype)

    def _make_xy_encoder(self, hidden_size: Optional[int]) -> MergeFlatInputs:
        """The encoded x sum-merged with y into an MLP of two hidden layers."""
        mlp = MLP(self.x_transf_dim, self.r_dim, n_hidden_layers=2,
                  hidden_size=self.r_dim if hidden_size is None else hidden_size,
                  is_force_hid_smaller=hidden_size is None, dtype=self.dtype)
        return MergeFlatInputs(mlp, self.x_transf_dim, self.y_dim, is_sum_merge=True)

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        """-> R [B, 1, r_dim], the per-point representations' mean over the
        real context points (zero for an empty context)."""
        return masked_mean(self.xy_encoder(x_c, y_c), mask_cntxt, dim=-2)[:, None, :]

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        B, n_trgt = x_t.shape[:2]
        return R[None].expand(1, B, n_trgt, self.r_dim)


class LNP(CNP):
    """`encoded_path` "latent" (the default) or "both"."""

    def __init__(self, *args, encoded_path: str = "latent", **kwargs):
        if encoded_path not in ("latent", "both"):
            raise ValueError(f"LNP takes encoded_path 'latent' or 'both', not {encoded_path!r}")
        super().__init__(*args, encoded_path=encoded_path, **kwargs)
        self._make_latent_merger()

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        """-> [n_z, B, n_trgt, r_dim], a view of one representation a draw."""
        B, n_trgt = x_t.shape[:2]
        if self.encoded_path == "both":
            R_trgt = self.merge_r_z(R, z_samples)  # [n_z, B, 1, r_dim]
        else:
            R_trgt = self.reshaper_z(z_samples) if self.z_dim != self.r_dim else z_samples
        return R_trgt.expand(z_samples.shape[0], B, n_trgt, self.r_dim)
