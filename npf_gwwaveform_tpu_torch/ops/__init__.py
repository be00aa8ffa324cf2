from .cnn import CNN, BatchNormEval, DepthSepConv, ResConvBlock
from .encoders import DiscardIthArg, SinusoidalEncodings
from .mlp import MLP
from .setconv import ExpRBF, SetConv

__all__ = ["BatchNormEval", "CNN", "DepthSepConv", "DiscardIthArg", "ExpRBF", "MLP",
           "ResConvBlock", "SetConv", "SinusoidalEncodings"]
