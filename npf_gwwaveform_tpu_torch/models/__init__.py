from .base import NeuralProcessFamily
from .convnp import ConvCNP, ConvLNP

__all__ = ["ConvCNP", "ConvLNP", "NeuralProcessFamily"]
