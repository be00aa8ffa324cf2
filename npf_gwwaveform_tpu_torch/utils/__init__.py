from .helpers import linspace, masked_mean, masked_softmax, masked_sum, sum_from_nth_dim

__all__ = ["linspace", "masked_mean", "masked_softmax", "masked_sum", "sum_from_nth_dim"]
