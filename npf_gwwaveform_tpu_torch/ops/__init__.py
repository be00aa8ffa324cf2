from .attention import LayerNorm, get_attender
from .cnn import CNN, BatchNorm, DepthSepConv, ResConvBlock
from .encoders import (
    DiscardIthArg, MergeFlatInputs, RelativeSinusoidalEncodings, SinusoidalEncodings,
)
from .mlp import MLP
from .selfattn import SelfAttention
from .setconv import ExpRBF, SetConv

__all__ = ["BatchNorm", "CNN", "DepthSepConv", "DiscardIthArg", "ExpRBF", "LayerNorm", "MLP",
           "MergeFlatInputs", "RelativeSinusoidalEncodings", "ResConvBlock", "SelfAttention",
           "SetConv", "SinusoidalEncodings", "get_attender"]
