from .base import NeuralProcessFamily
from .convnp import ConvCNP

__all__ = ["ConvCNP", "NeuralProcessFamily"]
