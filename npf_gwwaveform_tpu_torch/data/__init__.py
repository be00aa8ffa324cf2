from .datasplit import CntxtTrgtSplitter, GetRandomIndcs, exact_topn_mask, get_all_indcs
from .gw import GWParameterSpace, GWWaveformGenerator, match, mismatch

__all__ = ["CntxtTrgtSplitter", "GetRandomIndcs", "GWParameterSpace", "GWWaveformGenerator",
           "exact_topn_mask", "get_all_indcs", "match", "mismatch"]
