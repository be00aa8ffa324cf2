from .datasplit import (
    CntxtTrgtSplitter, GetIndcsMerger, GetRandomIndcs, GridCntxtTrgtSplitter,
    PointsFromGridSplitter, RandomMasker, ResolutionMasker, SuperresolutionCntxtTrgtSplitter,
    exact_topn_mask, get_all_indcs, get_range_indcs, grid_to_points, half_masker, no_masker,
)
from .gp import (
    KERNEL_CONFIGS, DatasetMerger, GPDataset, GPSampler, MixtureGPSampler, get_gp_datasets,
)
from .images import (
    DATASETS_DICT, DigitsDataset, GridImageDataset, LocalNpzDataset, RGBDigitsDataset,
    RGBDigitsMosaicDataset, SingleImage, ZeroShotMultiDigits, get_train_test_img_dataset,
)
from .gw import (
    FrequencyDomainWaveform, GWParameterSpace, GWWaveformDataset, GWWaveformGenerator, make_batch,
    match, match_fd, mismatch, mismatch_fd, psd_aligo,
)

__all__ = ["CntxtTrgtSplitter", "DatasetMerger", "GetIndcsMerger", "GetRandomIndcs",
           "FrequencyDomainWaveform", "GPDataset", "GPSampler", "GWParameterSpace",
           "GWWaveformDataset", "GWWaveformGenerator", "KERNEL_CONFIGS", "MixtureGPSampler",
           "exact_topn_mask", "get_all_indcs", "get_gp_datasets", "get_range_indcs",
           "make_batch", "match", "match_fd", "mismatch", "mismatch_fd", "psd_aligo",
           "DATASETS_DICT", "DigitsDataset", "GridCntxtTrgtSplitter", "GridImageDataset",
           "LocalNpzDataset", "PointsFromGridSplitter", "RGBDigitsDataset",
           "RGBDigitsMosaicDataset", "RandomMasker", "ResolutionMasker", "SingleImage",
           "SuperresolutionCntxtTrgtSplitter", "ZeroShotMultiDigits",
           "get_train_test_img_dataset", "grid_to_points", "half_masker", "no_masker"]
