from .attnnp import AttnCNP, AttnLNP
from .base import NeuralProcessFamily
from .convnp import ConvCNP, ConvLNP
from .gridconvnp import GridConvCNP, GridConvLNP
from .np import CNP, LNP

__all__ = ["AttnCNP", "AttnLNP", "CNP", "ConvCNP", "ConvLNP", "GridConvCNP", "GridConvLNP", "LNP",
           "NeuralProcessFamily"]
