"""`clamp` (leaky, with hard outer bounds) and `ProbabilityConverter`, the
counterparts of `npf_gwwaveform_tpu/ops/probability.py`. No benchmark
configuration uses them; they complete the tensor-helper set."""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

__all__ = ["clamp", "ProbabilityConverter"]


def clamp(x: torch.Tensor, minimum=-float("inf"), maximum=float("inf"), is_leaky: bool = False,
          negative_slope: float = 0.01, hard_min=None, hard_max=None) -> torch.Tensor:
    """x clamped to [minimum, maximum]; with `is_leaky` the bounds are
    minimum + slope * (x - minimum) and maximum + slope * (x - maximum), so
    that a little gradient passes; then, where given, the hard bounds
    `hard_min` and `hard_max` on top of that (as the JAX package applies
    them)."""
    lower = minimum + negative_slope * (x - minimum) if is_leaky else minimum
    upper = maximum + negative_slope * (x - maximum) if is_leaky else maximum
    lower = torch.as_tensor(lower, dtype=x.dtype, device=x.device).expand(x.shape)
    out = torch.maximum(lower, torch.minimum(x, torch.as_tensor(upper, dtype=x.dtype,
                                                                device=x.device)))
    if hard_min is not None or hard_max is not None:
        out = out.clamp(-float("inf") if hard_min is None else hard_min,
                        float("inf") if hard_max is None else hard_max)
    return out


class ProbabilityConverter(nn.Module):
    """Floats -> probabilities in (min_p, 1 - min_p), element-wise: (x +
    bias) * temperature through a sigmoid, a hard sigmoid (0.2 y + 0.5
    clamped to [0, 1]) or a leaky hard sigmoid (leaky-clamped to [0.1,
    0.9], hard-clamped to [0, 1]), rescaled into the band. The bias starts
    where `initial_x` maps to `initial_probability`; temperature and bias
    are parameters [trainable_dim] where `is_train_temperature` /
    `is_train_bias` say so, else constants."""

    def __init__(self, min_p: float = 0.0, activation: str = "sigmoid",
                 is_train_temperature: bool = False, is_train_bias: bool = False,
                 trainable_dim: int = 1, initial_temperature: float = 1.0,
                 initial_probability: float = 0.5, initial_x: float = 0.0,
                 bias_transformer: Callable = lambda b: b,
                 temperature_transformer: Callable = lambda t: t):
        super().__init__()
        if activation not in ("sigmoid", "hard-sigmoid", "leaky-hard-sigmoid"):
            raise ValueError(f"Unknown activation : {activation}")
        self.min_p, self.activation = min_p, activation
        self.initial_temperature = initial_temperature
        self.initial_probability = initial_probability
        self.initial_x = initial_x
        self.bias_transformer = bias_transformer
        self.temperature_transformer = temperature_transformer
        temperature = torch.full((trainable_dim,), float(initial_temperature))
        bias = torch.full((trainable_dim,), float(self._probability_to_bias()))
        if is_train_temperature:
            self.temperature = nn.Parameter(temperature)
        else:
            self.register_buffer("temperature", temperature, persistent=False)
        if is_train_bias:
            self.bias = nn.Parameter(bias)
        else:
            self.register_buffer("bias", bias, persistent=False)

    def _probability_to_bias(self) -> float:
        p = self.initial_probability
        if not self.min_p < p < 1 - self.min_p:
            raise ValueError(f"initial_probability={p} outside ({self.min_p}, {1 - self.min_p})")
        p = (p - self.min_p) / (1 - self.min_p * 2)
        if self.activation == "sigmoid":
            return -(math.log((1 - p) / p) / self.initial_temperature + self.initial_x)
        return ((p - 0.5) / 0.2) / self.initial_temperature - self.initial_x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        temperature = self.temperature_transformer(self.temperature)
        bias = self.bias_transformer(self.bias)
        if self.activation == "sigmoid":
            full_p = torch.sigmoid((x + bias) * temperature)
        else:
            y = 0.2 * ((x + bias) * temperature) + 0.5
            if self.activation == "leaky-hard-sigmoid":
                full_p = clamp(y, minimum=0.1, maximum=0.9, is_leaky=True, negative_slope=0.01,
                               hard_min=0.0, hard_max=1.0)
            else:
                full_p = clamp(y, minimum=0.0, maximum=1.0)
        return full_p * (1 - 2 * self.min_p) + self.min_p
