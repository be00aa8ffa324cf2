"""Weight initialisation schemes, the counterpart of
`npf_gwwaveform_tpu/utils/init.py`.

Each scheme is JAX's `variance_scaling(scale, mode, distribution)` over the
fans JAX counts for the flax kernel a port parameter stands for: a Dense
kernel `[in, out]` has fan_in = in, fan_out = out; a conv kernel
`[k, in/g, out]` has fan_in = k * in/g and fan_out = k * out. So a model
built in the port starts from the distributions the JAX model starts from;
the draws differ, since the generators differ.

The INTENDED scheme (the default) and the reference's REALIZED one differ as
the JAX module explains: with `set_realized_init(True)` every hidden Linear
and conv keeps the torch default U(+-1/sqrt(fan_in)), MLP `out` layers take
kaiming-relu, and biases stay zero. The flax default Dense init
(`lecun_normal`, a truncated normal) is not switchable, as in JAX.

Draws take an optional `torch.Generator`; modules call `init_params` when
they are built, and `init_module(model, generator)` draws a whole model again
from a seeded generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

__all__ = [
    "variance_scaling", "kaiming_uniform_relu", "xavier_uniform", "torch_default_uniform",
    "lecun_normal", "kaiming_normal_fanout", "hidden_relu_init", "hidden_tanh_init",
    "xavier_uniform_tanh", "mlp_out_init", "switchable", "normal_std", "set_realized_init",
    "init_dense", "init_conv", "init_module",
]

# the truncation at +-2 std keeps this share of a unit normal's variance;
# JAX divides the std by it (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978

Init = Callable[[torch.Tensor, int, int, Optional[torch.Generator]], None]


def variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    """init(t, fan_in, fan_out, generator) fills t in place with variance
    scale / fan, fan by `mode` ("fan_in", "fan_out", "fan_avg")."""

    def _init(t: torch.Tensor, fan_in: int, fan_out: int,
              generator: Optional[torch.Generator] = None) -> None:
        fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / max(1.0, fan)
        with torch.no_grad():
            if distribution == "uniform":
                lim = math.sqrt(3.0 * variance)
                t.uniform_(-lim, lim, generator=generator)
            elif distribution == "normal":
                t.normal_(0.0, math.sqrt(variance), generator=generator)
            elif distribution == "truncated_normal":
                # inverse CDF of a unit normal cut at +-2, as jax.random.truncated_normal
                edge = math.erf(2.0 / math.sqrt(2.0))
                t.uniform_(-edge, edge, generator=generator)
                t.erfinv_().mul_(math.sqrt(2.0) * math.sqrt(variance) / _TRUNC_STD)
            else:
                raise ValueError(f"unknown distribution {distribution!r}")

    return _init


# hidden layers followed by ReLU
kaiming_uniform_relu = variance_scaling(2.0, "fan_in", "uniform")
# output layers / no activation
xavier_uniform = variance_scaling(1.0, "fan_avg", "uniform")
# torch's default Linear/Conv init, U(+-sqrt(1/fan_in))
torch_default_uniform = variance_scaling(1.0 / 3.0, "fan_in", "uniform")
# flax's default Dense kernel init
lecun_normal = variance_scaling(1.0, "fan_in", "truncated_normal")
_conv_kaiming_fanout = variance_scaling(2.0, "fan_out", "normal")

_REALIZED = False


def set_realized_init(on: bool) -> None:
    """Toggle the reference-REALIZED scheme for every model built (or drawn
    by `init_module`) after this call."""
    global _REALIZED
    _REALIZED = bool(on)


def _switchable(intended: Init, realized: Init) -> Init:
    def _init(t, fan_in, fan_out, generator=None):
        (realized if _REALIZED else intended)(t, fan_in, fan_out, generator)

    return _init


# convolutions: intended kaiming-normal fan_out; realized torch default
kaiming_normal_fanout = _switchable(_conv_kaiming_fanout, torch_default_uniform)


# hidden layers followed by ReLU: intended kaiming-relu; realized torch default
hidden_relu_init = _switchable(kaiming_uniform_relu, torch_default_uniform)
# hidden layers followed by tanh: intended xavier with the tanh gain (5/3);
# realized torch default
xavier_uniform_tanh = variance_scaling(5.0 / 3.0 * 5.0 / 3.0, "fan_avg", "uniform")
hidden_tanh_init = _switchable(xavier_uniform_tanh, torch_default_uniform)
# MLP `out` layers: intended xavier; realized kaiming-relu
mlp_out_init = _switchable(xavier_uniform, kaiming_uniform_relu)


def normal_std(std: float) -> Init:
    """N(0, std), not switchable: MultiheadAttender's per-head init."""

    def _init(t, fan_in, fan_out, generator=None):
        with torch.no_grad():
            t.normal_(0.0, std, generator=generator)

    return _init


def switchable(intended: Init) -> Init:
    """`intended` normally; the torch default in realized mode."""
    return _switchable(intended, torch_default_uniform)


def init_dense(layer: nn.Linear, kernel_init: Init,
               generator: Optional[torch.Generator] = None) -> None:
    """weight [out, in] stands for the flax kernel [in, out]; bias zero."""
    out_f, in_f = layer.weight.shape
    kernel_init(layer.weight, in_f, out_f, generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def init_conv(conv: nn.Module, kernel_init: Init,
              generator: Optional[torch.Generator] = None) -> None:
    """weight [out, in/g, *k] stands for the flax kernel [*k, in/g, out]
    (1-D or 2-D); bias zero. The receptive field counts into both fans."""
    out_c, in_g, *ks = conv.weight.shape
    k = math.prod(ks)
    kernel_init(conv.weight, k * in_g, k * out_c, generator)
    if getattr(conv, "bias", None) is not None:
        with torch.no_grad():
            conv.bias.zero_()


def init_module(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter of `model` again from its scheme: each port
    module's `init_params(generator)` covers the parameters it owns, in the
    order of `model.modules()`."""
    for m in model.modules():
        fn = getattr(m, "init_params", None)
        if fn is not None:
            fn(generator)
    return model
