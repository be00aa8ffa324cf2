"""Forward skeleton of the neural-process family, deterministic path only
(n_z = 1 in train and eval mode); the counterpart of
`npf_gwwaveform_tpu/models/base.py::NeuralProcessFamily`.

x-encode -> `encode_globally` -> `trgt_dependent_representation` -> `decode`
into a diagonal Gaussian with scale `min_sigma_pred + (1 - min_sigma_pred) *
softplus`. Point sets are padded and carry boolean masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributions import NormalDiag
from ..losses import NPFOutput
from ..ops.mlp import MLP


class NeuralProcessFamily(nn.Module):
    """Subclasses set `self.decoder` and implement `encode_globally` and
    `trgt_dependent_representation`."""

    def __init__(self, x_dim: int = 1, y_dim: int = 1, r_dim: int = 128,
                 min_sigma_pred: float = 0.01, cond_dim: int = 0, use_kernels: bool = True):
        super().__init__()
        self.x_dim, self.y_dim, self.r_dim = x_dim, y_dim, r_dim
        self.min_sigma_pred = min_sigma_pred
        self.cond_dim = cond_dim
        self.use_kernels = use_kernels
        if cond_dim > 0:
            self.cond_encoder = MLP(cond_dim, r_dim, n_hidden_layers=1, hidden_size=r_dim)

    def _sub_decoder(self, n_out: int) -> MLP:
        """The default decoder MLP: 4 hidden layers of width r_dim (kernel K2
        when `use_kernels`)."""
        return MLP(self.r_dim, n_out, n_hidden_layers=4, hidden_size=self.r_dim,
                   fused=self.use_kernels)

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
        R_trgt = self.trgt_dependent_representation(x_c, R, x_t, mask_cntxt)
        return NPFOutput(self.decode(x_t, R_trgt))

    def decode(self, x_t, R_trgt) -> NormalDiag:
        suffstat = self.decoder(x_t, R_trgt)  # [n_z, B, Nt, 2*y_dim]
        loc, raw_scale = suffstat.split(self.y_dim, dim=-1)
        scale = self.min_sigma_pred + (1.0 - self.min_sigma_pred) * F.softplus(raw_scale)
        return NormalDiag(loc.float(), scale.float())

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        raise NotImplementedError

    def trgt_dependent_representation(self, x_c, R, x_t, mask_cntxt):
        raise NotImplementedError
