"""The 21 conv-family GP runs in `results/` in the port: each loads strictly
through `score_gp.load_model` (the run's own BatchNorm eps and
architecture), its parameter tree in flax's layout read back as it was
written; each ConvCNP and headline ConvLNP run scores one batch of 16
functions on the JAX package's own eval inputs as the JAX package does
(`tests/test_torch_gp_ablation.py` takes the eight ablation runs).

The inputs are `reproduce_gp.py`'s first eval batch: the first 16 of the
256 functions drawn from `fold_in(k_data, 0)` (for `All_Kernels` its first
component, RBF), the eval split of `fold_in(k_split, 0)` (U{0..50} context
points a function, all 128 targets), and for a latent run JAX's own z
noise, recovered from its forward as (z - loc) / scale in float64 and given
to the port. A latent run is compared at 2 z draws a function instead of
its 32 or 16 (both models' `n_z_samples_test`): each draw is the same
computation, and the CPU keeps the file under its time. The JAX models are
grouped by configuration (one jitted forward for the seven ConvCNP runs,
one for the six headline ConvLNP runs).

Tolerances: loc and scale 5e-4 absolute (the predictive bar) plus 2e-3 of
the value: the Noisy Matern ConvCNP's decoder sums hidden units of up to
~100 into scales near 0.36, so the float32 roundings of its inputs, apart
on the two sides, move one scale in 2,048 by 6.0e-4 (1.7e-3 of itself;
no ReLU pre-activation within 0.013 of its kink); each
function's log-likelihood within 2e-4 of its magnitude plus 0.02 nats:
a sum of 128 log-densities, some of scale near 1e-3, whose float32 terms
the two sides round apart (measured over 512 functions a run on the
records' draws, `tests/jax_score_offsets.py`: at most 0.077 nats, Noisy
Matern ConvCNP).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu_torch import score_gp
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP, ConvLNP
from npf_gwwaveform_tpu_torch.run_report import gp_runs
from npf_gwwaveform_tpu_torch.training.checkpoint import (
    _flatten, flax_from_params, load_run_params,
)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
RUNS = [os.path.relpath(r, RESULTS) for r in gp_runs(RESULTS)]
ABLATION = [r for r in RUNS if "_ELBO" in r]
DIST_ATOL, DIST_RTOL, LL_RTOL, LL_ATOL = 5e-4, 2e-3, 2e-4, 0.02
N_FN, N_Z = 16, 2
# the parameter counts of the three trees
N_PARAMS = {"ConvCNP": 276_612, "headline": 376_068, "notebook": 349_348}


def summary_of(rel):
    with open(os.path.join(RESULTS, rel, "summary.json")) as f:
        return json.load(f)


def arch_of(summary):
    if summary["model"] == "ConvCNP":
        return "ConvCNP"
    if "_ELBO" in summary["model"] and summary.get("ablation_arch") != "headline":
        return "notebook"
    return "headline"


def test_there_are_21_runs():
    assert len(RUNS) == 21 and len(ABLATION) == 8
    assert sum(summary_of(r)["model"] == "ConvCNP" for r in RUNS) == 7


@pytest.mark.parametrize("rel", RUNS)
def test_run_loads_strictly_with_its_own_eps(rel):
    """strict=True, the recorded `norm_eps` in every BatchNorm, the
    architecture's parameter count and eval draws, and the state dict
    written back as the flax tree it was read from, leaf for leaf."""
    run_dir = os.path.join(RESULTS, rel)
    summary = summary_of(rel)
    model = score_gp.load_model(run_dir, "cpu")
    arch = arch_of(summary)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS[arch]
    eps = {m.eps for m in model.modules() if hasattr(m, "momentum") and hasattr(m, "eps")}
    assert eps == {summary.get("norm_eps", 1e-3)}
    if arch != "ConvCNP":
        assert isinstance(model, ConvLNP)
        assert model.z_dim == (16 if arch == "notebook" else 128)
        assert model.n_z_samples_test == (16 if "_ELBO" in summary["model"] else 32)
    else:
        assert isinstance(model, ConvCNP) and not isinstance(model, ConvLNP)
    params, extra = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    for got, ref in zip((params, extra), load_run_params(run_dir)):
        got, ref = dict(_flatten(got)), dict(_flatten(ref))
        assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)


@functools.lru_cache(maxsize=None)
def eval_inputs(kernel):
    """reproduce_gp.py's first eval batch's first N_FN functions, their
    split and the batch's latent key."""
    name = "RBF_Kernel" if kernel == "All_Kernels" else kernel
    sampler = GPSampler(n_points=128, **KERNEL_CONFIGS[name])
    k_data, k_split = jax.random.split(jax.random.PRNGKey(123))
    x, y = sampler.sample(jax.random.fold_in(k_data, 0), 256)
    k_sp, k_lat = jax.random.split(jax.random.fold_in(k_split, 0))
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=50, is_indep_n=True),
                                 targets_getter=get_all_indcs)
    mask_c = splitter(k_sp, x, y)["mask_cntxt"]
    return tuple(np.asarray(a[:N_FN]) for a in (x, y, mask_c)) + (k_lat,)


@functools.lru_cache(maxsize=None)
def jax_forward(config):
    """One jitted JAX forward per model configuration (the summary's fields
    that build it), at N_Z draws."""
    from jax_score_offsets import jax_gp_model

    jm = jax_gp_model(dict(config))
    if "LNP" in dict(config)["model"]:
        jm = jm.clone(n_z_samples_test=N_Z)

    @jax.jit
    def forward(variables, x, y, mask_c, key):
        mask_t = jnp.ones(mask_c.shape, bool)
        out = jm.apply(variables, x, y, x, y, mask_cntxt=mask_c, mask_trgt=mask_t, train=False,
                       rngs={"latent": key})
        return out, -JaxCNPFLoss(reduction=None)(out, y, mask_t, train=False)
    return forward


def check_run(rel):
    """The run on JAX's eval inputs against the JAX package."""
    run_dir = os.path.join(RESULTS, rel)
    summary = summary_of(rel)
    x, y, mask_c, k_lat = eval_inputs(summary["kernel"])
    config = tuple(sorted((k, summary[k]) for k in ("model", "norm_eps", "ablation_arch")
                          if k in summary))
    params, extra = load_run_params(run_dir)
    j_out, j_ll = jax_forward(config)({"params": params, **extra}, x, y, mask_c, k_lat)
    model = score_gp.load_model(run_dir, "cpu")
    eps = None
    if isinstance(model, ConvLNP):
        model.n_z_samples_test = N_Z
        q = j_out.q_zCc if j_out.q_zCct is None else j_out.q_zCct
        assert (j_out.q_zCct is not None) == model.is_q_zCct
        eps = torch.from_numpy((np.asarray(j_out.z_samples, np.float64)
                                - np.asarray(q.loc, np.float64))
                               / np.asarray(q.scale, np.float64)).float()
    xt, yt, mt = (torch.from_numpy(np.array(a)) for a in (x, y, mask_c))
    with torch.no_grad():
        out = model(xt, yt, xt, mt, torch.ones_like(mt), y_trgt=yt, eps=eps)
        ll = -CNPFLoss(reduction=None)(out, yt, torch.ones_like(mt), train=False)
    n_z = N_Z if eps is not None else 1
    assert out.p_yCc.loc.shape == (n_z, N_FN, 128, 1)
    for field in ("loc", "scale"):
        np.testing.assert_allclose(getattr(out.p_yCc, field).numpy(),
                                   np.asarray(getattr(j_out.p_yCc, field)), atol=DIST_ATOL,
                                   rtol=DIST_RTOL, err_msg=f"{rel} {field}")
    j_ll = np.asarray(j_ll, np.float64)
    err = np.abs(ll.double().numpy() - j_ll)
    assert np.all(err <= LL_RTOL * np.abs(j_ll) + LL_ATOL), (rel, err.max())


@pytest.mark.parametrize("rel", [r for r in RUNS if r not in ABLATION])
def test_run_scores_jax_eval_inputs_as_jax(rel):
    check_run(rel)
