from .attention import LayerNorm, get_attender
from .cnn import (
    CNN, AbsConv, BatchNorm, DepthSepConv, GaussianConv2d, ResConvBlock, ResNormalizedConvBlock,
)
from .encoders import (
    DiscardIthArg, MergeFlatInputs, RelativeSinusoidalEncodings, SinusoidalEncodings,
)
from .mlp import MLP
from .probability import ProbabilityConverter, clamp
from .selfattn import SelfAttention
from .setconv import ExpRBF, SetConv

__all__ = ["AbsConv", "BatchNorm", "CNN", "DepthSepConv", "DiscardIthArg", "ExpRBF",
           "GaussianConv2d", "LayerNorm", "MLP", "MergeFlatInputs", "ProbabilityConverter",
           "RelativeSinusoidalEncodings", "ResConvBlock", "ResNormalizedConvBlock",
           "SelfAttention", "SetConv", "SinusoidalEncodings", "clamp", "get_attender"]
