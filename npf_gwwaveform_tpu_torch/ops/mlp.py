"""ReLU MLP with the reference's hidden-size clamp and residual option, the
counterpart of `npf_gwwaveform_tpu/ops/mlp.py::MLP` (no dropout).

Order: to_hidden -> relu -> (linear_i -> relu [+ residual])* -> out. With
`fused=True` the whole chain is one `FusedReluMLPFn`: kernel K2 forward and
kernel K3 backward, their plain versions on CPU tensors; the parameters are
the same either way. Initial values follow the JAX scheme
(`utils/init.py`): hidden layers kaiming-uniform, `out` xavier, biases zero.

`dtype` is the JAX module's compute dtype: None computes in the input's
dtype as promoted with the float32 parameters (float32 here); bfloat16
computes in bf16 with float32 parameters. The fused chain then runs at the
Pallas kernel's bf16 rounding points (`compute_dtype`), and each unfused
layer as flax's `Dense(dtype=bfloat16)` (`dense`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import init as winit
from .kernels.mlp_chain import FusedReluMLPFn


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`layer(x)` as flax's `nn.Dense(dtype=dtype)` computes it. None: the
    float32 layer as it is. Otherwise x, the weight and the bias are cast to
    `dtype`, the product is rounded to it and the bias added in it, two
    roundings as in flax (`F.linear` with its bias would round once)."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class Dense(nn.Linear):
    """flax `nn.Dense(out_features, dtype=dtype)` as a module: `dense` of
    itself. Its kernel starts from `kernel_init` (flax's default
    `lecun_normal`, not switchable), its bias at zero."""

    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None,
                 kernel_init=winit.lecun_normal):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_dense(self, self.kernel_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        return dense(self, x, self.dtype)


class MLP(nn.Module):
    """The hidden size is raised to min(input_size, output_size) when it is
    smaller (the reference's clamp)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int = 32,
                 n_hidden_layers: int = 1, is_res: bool = False, fused: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if n_hidden_layers < 1:
            raise ValueError("n_hidden_layers must be >= 1")
        hidden_size = max(hidden_size, min(input_size, output_size))
        self.n_hidden_layers = n_hidden_layers
        self.is_res = is_res
        self.fused = fused
        self.dtype = dtype
        self.to_hidden = nn.Linear(input_size, hidden_size)
        for i in range(n_hidden_layers - 1):
            self.add_module(f"linear_{i}", nn.Linear(hidden_size, hidden_size))
        self.out = nn.Linear(hidden_size, output_size)
        self.init_params()

    def init_params(self, generator=None) -> None:
        for layer in (self.to_hidden, *self._hidden()):
            winit.init_dense(layer, winit.hidden_relu_init, generator)
        winit.init_dense(self.out, winit.mlp_out_init, generator)

    def _hidden(self):
        return [getattr(self, f"linear_{i}") for i in range(self.n_hidden_layers - 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden = self._hidden()
        if self.fused:
            # the Pallas entry's compute_dtype: the module's, else the input's
            cdtype = self.dtype or x.dtype
            w = self.to_hidden.weight
            h = self.to_hidden.out_features
            wh = torch.stack([l.weight for l in hidden]) if hidden else w.new_zeros((0, h, h))
            bh = torch.stack([l.bias for l in hidden]) if hidden else w.new_zeros((0, h))
            out = FusedReluMLPFn.apply(
                x.reshape(-1, x.shape[-1]).to(cdtype).contiguous(),
                w, self.to_hidden.bias, wh, bh,
                self.out.weight, self.out.bias, self.is_res, cdtype,
            )
            return out.reshape(*x.shape[:-1], self.out.out_features)
        a = torch.relu(dense(self.to_hidden, x, self.dtype))
        for layer in hidden:
            r = torch.relu(dense(layer, a, self.dtype))
            a = r + a if self.is_res else r
        return dense(self.out, a, self.dtype)
