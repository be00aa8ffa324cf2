"""SetConv with the ExpRBF kernel (ConvCNP's functional encoder), masked for
padded sets; the counterpart of `npf_gwwaveform_tpu/ops/setconv.py`.

Two paths compute the same function. The plain path keeps the JAX module's
arithmetic: distances `sqrt(d^2 + 1e-12)`, a max-subtracted masked softmax for
the weights and a raw exp sum for the density. The kernel path
(`use_kernel=True`) goes through `SetConvExpRBFFn`: K1 forward, which uses
`|d|` as the Pallas kernel does (the two paths differ by about 1e-12 in the
squared distance), and the JAX package's tiled recompute backward. The
resizer starts xavier-uniform with a zero bias, as in JAX.

With `dtype` (the JAX module's compute dtype, e.g. bfloat16) the
interpolation stays float32, as in JAX (the values are cast to float32
before K1 or the plain ExpRBF), and only the resizer computes in `dtype`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import init as winit
from ..utils.helpers import masked_softmax
from .kernels.setconv import SetConvExpRBFFn
from .mlp import dense


def _init_length_scale(max_dist: float, max_dist_weight: float, p: int) -> float:
    """sigma with exp(-(max_dist/sigma)^p) = max_dist_weight, through softplus^-1."""
    sigma = max_dist / ((-math.log(max_dist_weight)) ** (1.0 / p))
    return math.log(math.expm1(sigma))


def _pairwise_dist(keys_x, queries_x, p):
    """[B,K,xd], [B,Q,xd] -> [B,Q,K] p-norm of the differences."""
    diff = keys_x[:, None, :, :] - queries_x[:, :, None, :]
    if p == 2:
        return torch.sqrt(diff.square().sum(dim=-1) + 1e-12)
    if p == 1:
        return diff.abs().sum(dim=-1)
    return (diff.abs() ** p).sum(dim=-1) ** (1.0 / p)


class ExpRBF(nn.Module):
    """Softmax weights over keys plus a raw-exp density channel."""

    def __init__(self, max_dist: float = 1.0 / 256, max_dist_weight: float = 0.9, p: int = 2):
        super().__init__()
        self.p = p
        self._init_value = _init_length_scale(max_dist, max_dist_weight, p)
        self.length_scale_param = nn.Parameter(torch.full((1,), self._init_value))

    def init_params(self, generator=None) -> None:
        with torch.no_grad():
            self.length_scale_param.fill_(self._init_value)

    def sigma(self) -> torch.Tensor:
        """[1] float32 length scale."""
        return 1e-5 + F.softplus(self.length_scale_param)

    def forward(self, keys_x, queries_x, mask_keys):
        inp = -((_pairwise_dist(keys_x, queries_x, self.p) / self.sigma()) ** self.p)
        mask = mask_keys[:, None, :].bool()
        density = (torch.exp(inp) * mask).sum(dim=-1, keepdim=True)
        weight = masked_softmax(inp, mask.expand_as(inp), dim=-1)
        return weight, density


class SetConv(nn.Module):
    """(keys_x [B,K,1], queries_x [B,Q,1], values [B,K,C], mask_keys [B,K])
    -> [B,Q,out_channels]: interpolated values plus the density channel,
    then the linear `resizer`."""

    def __init__(self, in_channels: int, out_channels: int, use_kernel: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.rbf = ExpRBF()
        self.resizer = nn.Linear(in_channels + 1, out_channels)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_dense(self.resizer, winit.switchable(winit.xavier_uniform), generator)

    def forward(self, keys_x, queries_x, values, mask_keys: Optional[torch.Tensor] = None):
        if mask_keys is None:
            mask_keys = torch.ones(keys_x.shape[:2], dtype=torch.bool, device=keys_x.device)
        if self.use_kernel:
            if keys_x.shape[-1] != 1:
                raise ValueError("the SetConv kernel takes x_dim == 1")
            signal, density = SetConvExpRBFFn.apply(
                keys_x[..., 0].float().contiguous(),
                queries_x[..., 0].float().contiguous(),
                values.float().contiguous(),
                mask_keys.float().contiguous(),
                self.rbf.sigma().float().contiguous(),
                self.rbf.p,
            )
            targets = torch.cat([signal, density[..., None]], dim=-1)
        else:
            weight, density = self.rbf(keys_x, queries_x, mask_keys)
            targets = torch.cat([torch.bmm(weight.float(), values.float()), density.float()], dim=-1)
        return dense(self.resizer, targets, self.dtype)
