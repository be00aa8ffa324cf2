"""One bf16 train step of each set and attention GP model (CNP, LNP,
AttnCNP, AttnLNP at r_dim 16) on the kernel path against the JAX package's
`fused_mlp=True` model, op by op: the loss and every gradient, by
tests/test_torch_bf16_gp_models.py's bars (`check_step`, its reasons)."""

import pytest
import torch

from test_torch_bf16_gp_models import SET, step_case

torch.set_num_threads(1)


@pytest.mark.parametrize("name", SET)
def test_train_step_bf16_matches_jax(name):
    step_case(name)
