"""ReLU MLP with the reference's hidden-size clamp and residual option, the
counterpart of `npf_gwwaveform_tpu/ops/mlp.py::MLP` (no dropout).

Order: to_hidden -> relu -> (linear_i -> relu [+ residual])* -> out. With
`fused=True` the whole chain is one `FusedReluMLPFn`: kernel K2 forward and
kernel K3 backward, their plain versions on CPU tensors; the parameters are
the same either way. Initial values follow the JAX scheme
(`utils/init.py`): hidden layers kaiming-uniform, `out` xavier, biases zero.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import init as winit
from .kernels.mlp_chain import FusedReluMLPFn


class MLP(nn.Module):
    """The hidden size is raised to min(input_size, output_size) when it is
    smaller (the reference's clamp)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int = 32,
                 n_hidden_layers: int = 1, is_res: bool = False, fused: bool = False):
        super().__init__()
        if n_hidden_layers < 1:
            raise ValueError("n_hidden_layers must be >= 1")
        hidden_size = max(hidden_size, min(input_size, output_size))
        self.n_hidden_layers = n_hidden_layers
        self.is_res = is_res
        self.fused = fused
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
            h = self.to_hidden.out_features
            wh = (torch.stack([l.weight for l in hidden]) if hidden
                  else x.new_zeros((0, h, h)))
            bh = torch.stack([l.bias for l in hidden]) if hidden else x.new_zeros((0, h))
            out = FusedReluMLPFn.apply(
                x.reshape(-1, x.shape[-1]).contiguous(),
                self.to_hidden.weight, self.to_hidden.bias, wh, bh,
                self.out.weight, self.out.bias, self.is_res,
            )
            return out.reshape(*x.shape[:-1], self.out.out_features)
        a = torch.relu(self.to_hidden(x))
        for layer in hidden:
            r = torch.relu(layer(a))
            a = r + a if self.is_res else r
        return self.out(a)
