"""Forward skeleton of the neural-process family, deterministic path only
(n_z = 1 in train and eval mode); the counterpart of
`npf_gwwaveform_tpu/models/base.py::NeuralProcessFamily`.

x-encode -> `encode_globally` -> (with `cond_mode="add"`, the condition
embedding added to every position of R) -> `trgt_dependent_representation`
-> `decode` into a diagonal Gaussian with scale `min_sigma_pred + (1 -
min_sigma_pred) * softplus`. Point sets are padded and carry boolean masks.

`dtype` is the JAX model's compute dtype: None computes in float32;
bfloat16 runs every module in bf16 compute, as the JAX package's modules
with `dtype=jnp.bfloat16` do, while parameters, BatchNorm statistics,
log-probs and the loss stay float32. `decode` then applies the scale
transform to the bf16 raw scale in bf16 as JAX's ops round it: softplus as
`jax.nn.softplus` computes it (`logaddexp(x, 0)`, each op rounded), the two
constants rounded to bf16 as JAX's weak-typed scalars are; loc and scale are
cast to float32 afterwards (`npf_gwwaveform_tpu/models/base.py:298-312`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributions import NormalDiag
from ..losses import NPFOutput
from ..ops.mlp import MLP


def _softplus_jax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`'s ops, max(x, 0) + log1p(exp(-|x|)), each rounded in
    x's dtype (`F.softplus` computes log1p(exp(x)) and rounds once, which
    differs from JAX's in bf16 in about one element of eight)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


class NeuralProcessFamily(nn.Module):
    """Subclasses set `self.decoder` and implement `encode_globally` and
    `trgt_dependent_representation`."""

    def __init__(self, x_dim: int = 1, y_dim: int = 1, r_dim: int = 128,
                 min_sigma_pred: float = 0.01, cond_dim: int = 0, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, cond_mode: str = "film"):
        super().__init__()
        self.x_dim, self.y_dim, self.r_dim = x_dim, y_dim, r_dim
        self.min_sigma_pred = min_sigma_pred
        self.cond_dim = cond_dim
        self.cond_mode = cond_mode
        self.use_kernels = use_kernels
        self.dtype = dtype
        if cond_dim > 0:
            self.cond_encoder = MLP(cond_dim, r_dim, n_hidden_layers=1, hidden_size=r_dim,
                                    dtype=dtype)

    def _sub_decoder(self, n_out: int) -> MLP:
        """The default decoder MLP: 4 hidden layers of width r_dim (kernel K2
        when `use_kernels`)."""
        return MLP(self.r_dim, n_out, n_hidden_layers=4, hidden_size=self.r_dim,
                   fused=self.use_kernels, dtype=self.dtype)

    def x_encoder(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x_cntxt, y_cntxt, x_trgt, mask_cntxt: Optional[torch.Tensor] = None,
                mask_trgt: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None) -> NPFOutput:
        """x_* [B, N*, x_dim], y_cntxt [B, Nc, y_dim], masks [B, N*] bool,
        condition [B, cond_dim] -> NPFOutput with loc/scale [1, B, Nt, y_dim]."""
        if mask_cntxt is None:
            mask_cntxt = torch.ones(x_cntxt.shape[:2], dtype=torch.bool, device=x_cntxt.device)
        if mask_trgt is None:
            mask_trgt = torch.ones(x_trgt.shape[:2], dtype=torch.bool, device=x_trgt.device)
        x_c, x_t = self.x_encoder(x_cntxt), self.x_encoder(x_trgt)
        cond_emb = None
        if self.cond_dim > 0:
            if condition is None:
                raise ValueError("cond_dim > 0 requires a `condition` input")
            cond_emb = self.cond_encoder(condition)
        R = self.encode_globally(x_c, y_cntxt, mask_cntxt, cond_emb=cond_emb)
        if cond_emb is not None and self.cond_mode == "add":  # broadcast over R's positions
            R = R + cond_emb.reshape(cond_emb.shape[0], *([1] * (R.dim() - 2)), cond_emb.shape[-1])
        R_trgt = self.trgt_dependent_representation(x_c, R, x_t, mask_cntxt)
        return NPFOutput(self.decode(x_t, R_trgt))

    def decode(self, x_t, R_trgt) -> NormalDiag:
        suffstat = self.decoder(x_t, R_trgt)  # [n_z, B, Nt, 2*y_dim]
        loc, raw_scale = suffstat.split(self.y_dim, dim=-1)
        lo, span = self.min_sigma_pred, 1.0 - self.min_sigma_pred
        if raw_scale.dtype == torch.float32:
            scale = lo + span * F.softplus(raw_scale)
        else:  # JAX's weak-typed scalars take the array's dtype
            lo, span = (torch.tensor(v, dtype=raw_scale.dtype).item() for v in (lo, span))
            scale = lo + span * _softplus_jax(raw_scale)
        return NormalDiag(loc.float(), scale.float())

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        raise NotImplementedError

    def trgt_dependent_representation(self, x_c, R, x_t, mask_cntxt):
        raise NotImplementedError
