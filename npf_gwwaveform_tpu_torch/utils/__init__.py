from .helpers import (
    linspace, masked_mean, masked_softmax, masked_sum, rescale_range, sum_from_nth_dim,
)
from .predict import SamplePredictor

__all__ = ["SamplePredictor", "linspace", "masked_mean", "masked_softmax", "masked_sum",
           "rescale_range", "sum_from_nth_dim"]
