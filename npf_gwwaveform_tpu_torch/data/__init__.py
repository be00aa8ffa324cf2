from .datasplit import (
    CntxtTrgtSplitter, GetIndcsMerger, GetRandomIndcs, exact_topn_mask, get_all_indcs,
    get_range_indcs,
)
from .gp import (
    KERNEL_CONFIGS, DatasetMerger, GPDataset, GPSampler, MixtureGPSampler, get_gp_datasets,
)
from .gw import (
    FrequencyDomainWaveform, GWParameterSpace, GWWaveformDataset, GWWaveformGenerator, make_batch,
    match, match_fd, mismatch, mismatch_fd, psd_aligo,
)

__all__ = ["CntxtTrgtSplitter", "DatasetMerger", "GetIndcsMerger", "GetRandomIndcs",
           "FrequencyDomainWaveform", "GPDataset", "GPSampler", "GWParameterSpace",
           "GWWaveformDataset", "GWWaveformGenerator", "KERNEL_CONFIGS", "MixtureGPSampler",
           "exact_topn_mask", "get_all_indcs", "get_gp_datasets", "get_range_indcs",
           "make_batch", "match", "match_fd", "mismatch", "mismatch_fd", "psd_aligo"]
