"""PyTorch and CUDA port of `npf_gwwaveform_tpu` for an NVIDIA H100.

Slice 1 scores a frozen GW ConvCNP run (`score.py`); slice 2 trains the
flagship configuration (`train_gw.py`); later slices add every GW ConvCNP
and ConvLNP run, the GP benchmark (`score_gp.py`, `train_gp.py`) and the
set and attention family (CNP, LNP, AttnCNP, AttnLNP), and the grid and
image family (GridConvCNP, GridConvLNP and the point models on image
corpora: `score_img.py`, `train_img.py`), and training on a device mesh
of ranks (`parallel`, `multichip.py`). The SetConv
interpolations and the decoder's MLP chain, forward and backward, run
hand-written CUDA kernels (`csrc/`, built with nvcc at first launch) on CUDA
tensors and their plain PyTorch versions on CPU tensors. Imports torch and
numpy only.
"""

from .configs import gp_model_1d, gw_model_from_summary, img_model
from .models import CNP, LNP, AttnCNP, AttnLNP, ConvCNP, ConvLNP, GridConvCNP, GridConvLNP

__all__ = ["AttnCNP", "AttnLNP", "CNP", "ConvCNP", "ConvLNP", "GridConvCNP", "GridConvLNP", "LNP",
           "gp_model_1d", "gw_model_from_summary", "img_model"]
