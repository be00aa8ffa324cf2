"""PyTorch and CUDA port of `npf_gwwaveform_tpu` for an NVIDIA H100.

Slice 1 scores a frozen GW ConvCNP run (`score.py`); slice 2 trains the
flagship configuration (`train_gw.py`), float32 throughout. The SetConv
interpolations and the decoder's MLP chain, forward and backward, run
hand-written CUDA kernels (`csrc/`, built with nvcc at first launch) on CUDA
tensors and their plain PyTorch versions on CPU tensors. Imports torch and
numpy only.
"""

from .configs import gw_model_from_summary
from .models import ConvCNP

__all__ = ["ConvCNP", "gw_model_from_summary"]
