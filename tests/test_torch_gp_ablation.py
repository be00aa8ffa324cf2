"""The eight runs of the RBF ConvLNP objective-ablation grid
(`results/RBF_Kernel/ConvLNP_ELBO*_LatLB*_SigLB*`) on the JAX package's own
eval inputs against the JAX package, as `tests/test_torch_gp_runs.py` does
for the other thirteen GP runs (its inputs, its 2 z draws a function, its
tolerances): seven of the notebook architecture (z_dim 16, `reshaper_z`, no
global latent) and one of the headline one. An ELBO-trained run samples z
from q(z|C,T) at eval, since its forward sees the targets, as JAX's
`_eval_step` does; `min_sigma_pred` is 1e-4 where SigLB is False, and the
q(z) scale `1e-4 + softplus` where LatLB is False."""

import pytest
import torch

from test_torch_gp_runs import ABLATION, check_run

torch.set_num_threads(1)


@pytest.mark.parametrize("rel", ABLATION)
def test_ablation_run_scores_jax_eval_inputs_as_jax(rel):
    check_run(rel)
