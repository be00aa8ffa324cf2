"""PyTorch and CUDA port of `npf_gwwaveform_tpu` for an NVIDIA H100.

Slice 1: scoring a frozen GW ConvCNP run (forward pass, float32, eval mode).
The SetConv interpolations and the decoder's MLP chain run hand-written CUDA
kernels (`csrc/`, built with nvcc at first launch) on CUDA tensors and their
plain PyTorch versions on CPU tensors. Imports torch and numpy only.
"""

from .configs import gw_model_from_summary
from .models import ConvCNP

__all__ = ["ConvCNP", "gw_model_from_summary"]
