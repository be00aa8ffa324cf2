"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch
version, and the autograd Functions through which the model reaches them. A
wrapper launches its kernel for CUDA tensors and uses the plain version for
CPU tensors; `launches` on each wrapper counts kernel launches."""

from .mlp_chain import (
    FusedReluMLPFn, fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain,
    fused_relu_mlp_plain,
)
from .setconv import SetConvExpRBFFn, setconv_exprbf_bwd, setconv_exprbf_fwd, setconv_exprbf_plain

__all__ = [
    "FusedReluMLPFn",
    "SetConvExpRBFFn",
    "fused_relu_mlp",
    "fused_relu_mlp_bwd",
    "fused_relu_mlp_bwd_plain",
    "fused_relu_mlp_plain",
    "setconv_exprbf_bwd",
    "setconv_exprbf_fwd",
    "setconv_exprbf_plain",
]
