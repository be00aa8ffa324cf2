from .datasplit import CntxtTrgtSplitter, GetRandomIndcs, exact_topn_mask, get_all_indcs
from .gw import (
    FrequencyDomainWaveform, GWParameterSpace, GWWaveformDataset, GWWaveformGenerator, make_batch,
    match, match_fd, mismatch, mismatch_fd, psd_aligo,
)

__all__ = ["CntxtTrgtSplitter", "GetRandomIndcs", "FrequencyDomainWaveform", "GWParameterSpace",
           "GWWaveformDataset", "GWWaveformGenerator", "exact_topn_mask", "get_all_indcs",
           "make_batch", "match", "match_fd", "mismatch", "mismatch_fd", "psd_aligo"]
