"""The conv-family GP models in bfloat16 compute against the JAX package's
bf16 models at r_dim 16 on their 192-point grid: `gp_model_1d`'s ConvCNP
(K1 twice, the decoder chain) and ConvLNP (K1 twice, a linear decoder),
and the notebook ELBO ConvLNP ablation variant (K1 three times: its train
forward and its eval forward encode the targets; a float32 Dense decoder),
by tests/test_torch_bf16_gp_models.py's rules and bars: each path in eval
and train mode with one empty context, then one bf16 train step on the
kernel path."""

import pytest
import torch

from test_torch_bf16_gp_models import CONV, forward_case, step_case

torch.set_num_threads(1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel path", "plain path"])
@pytest.mark.parametrize("name", CONV)
def test_forward_bf16_matches_jax(name, use_kernels, train):
    forward_case(name, use_kernels, train)


@pytest.mark.parametrize("name", CONV)
def test_train_step_bf16_matches_jax(name):
    step_case(name)
