from .cnn import CNN, BatchNorm, DepthSepConv, ResConvBlock
from .encoders import DiscardIthArg, SinusoidalEncodings
from .mlp import MLP
from .setconv import ExpRBF, SetConv

__all__ = ["BatchNorm", "CNN", "DepthSepConv", "DiscardIthArg", "ExpRBF", "MLP",
           "ResConvBlock", "SetConv", "SinusoidalEncodings"]
