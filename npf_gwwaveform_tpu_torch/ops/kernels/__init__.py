"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and uses the plain
version for CPU tensors; `launches` on each wrapper counts kernel launches."""

from .mlp_chain import fused_relu_mlp, fused_relu_mlp_plain
from .setconv import setconv_exprbf_fwd, setconv_exprbf_plain

__all__ = [
    "fused_relu_mlp",
    "fused_relu_mlp_plain",
    "setconv_exprbf_fwd",
    "setconv_exprbf_plain",
]
