"""One GP bar run of each family in bfloat16 compute at full width on the
JAX package's own eval inputs, against the JAX package's bf16 model built
as `reproduce_gp.py --bf16` builds it: the RBF ConvCNP, ConvLNP, CNP, LNP,
AttnCNP and AttnLNP `run_0`, the port's kernel path (`use_kernels=True`,
the chain's plain version on the CPU) against `fused_mlp=True`, and the
ConvCNP's plain path against the Dense decoder. The inputs are
tests/test_torch_gp_runs.py's (`reproduce_gp.py`'s first eval batch), here
its first 8 functions, a latent run at 2 z draws (JAX's own noise, given
to the port as `eps`).

The bar is tests/test_torch_bf16_slice.py's full-width rule, against JAX
bf16's own distance to JAX float32 on the same inputs (its "gap"): the
port's RMS distance to JAX bf16 loc at most half the gap's RMS, and its
RMS distance to JAX float32 loc at least 3/4 of it (a port that kept
float32 inside would sit near 0 there and near 1 on the first). The two
sides round at the same points; their float32 sums run in other orders, so
a few roundings differ and later layers carry them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import gp_model_1d as jax_gp_model_1d
from npf_gwwaveform_tpu_torch import score_gp
from npf_gwwaveform_tpu_torch.training.checkpoint import load_run_params
from test_torch_gp_runs import RESULTS, eval_inputs

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
N_FN, N_Z = 8, 2
RMS_NEAR, RMS_FAR = 0.5, 0.75
RUNS = [os.path.join("RBF_Kernel", m, "run_0")
        for m in ("ConvCNP", "ConvLNP", "CNP", "LNP", "AttnCNP", "AttnLNP")]


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def check_distances(loc, loc16, loc32):
    """The full-width rule (module docstring) -> (near, far) as shares of
    the gap's RMS."""
    gap = rms(loc16 - loc32)
    near, far = rms(loc - loc16) / gap, rms(loc - loc32) / gap
    assert near <= RMS_NEAR and far >= RMS_FAR, (near, far, gap)
    return near, far


def jax_locs(models, variables, data, key):
    """loc of each JAX model on the inputs (bf16 op by op, float32 jitted)
    and the first model's output (its z draws)."""
    x, y, mc = data
    mt = np.ones(mc.shape, bool)
    outs = []
    for jm in models:
        def apply(v, jm=jm):
            return jm.apply(v, x, y, x, y, mask_cntxt=mc, mask_trgt=mt, train=False,
                            rngs={"latent": key})
        outs.append(apply(variables) if jm.dtype is not None else jax.jit(apply)(variables))
    return [np.asarray(o.p_yCc.loc) for o in outs], outs[0]


# every run's kernel path; the ConvCNP's plain path too (the others' paths
# differ in the decoder alone, held at small width in
# tests/test_torch_bf16_gp_models.py)
CASES = [(r, True) for r in RUNS] + [(RUNS[0], False)]


@pytest.mark.parametrize("rel,use_kernels", CASES,
                         ids=[f"{r}-{'kernel' if k else 'plain'} path" for r, k in CASES])
def test_run_bf16_against_jax_at_full_width(rel, use_kernels):
    run_dir = os.path.join(RESULTS, rel)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    name, eps_ = summary["model"], summary.get("norm_eps", 1e-3)
    x, y, mc, key = eval_inputs(summary["kernel"])
    data = (x[:N_FN], y[:N_FN], mc[:N_FN])
    latent = "LNP" in name
    j16 = jax_gp_model_1d(name, dtype=JBF16, cnn_norm_eps=eps_).clone(fused_mlp=use_kernels)
    j32 = jax_gp_model_1d(name, cnn_norm_eps=eps_)
    if latent:
        j16, j32 = j16.clone(n_z_samples_test=N_Z), j32.clone(n_z_samples_test=N_Z)
    params, extra = load_run_params(run_dir)
    (loc16, loc32), j_out = jax_locs((j16, j32), {"params": params, **extra}, data, key)
    model = score_gp.load_model(run_dir, "cpu", use_kernels=use_kernels, dtype=BF16)
    eps = None
    if latent:
        model.n_z_samples_test = N_Z
        q = j_out.q_zCc if j_out.q_zCct is None else j_out.q_zCct
        eps = torch.from_numpy((np.asarray(j_out.z_samples, np.float64)
                                - np.asarray(q.loc, np.float64))
                               / np.asarray(q.scale, np.float64)).float()
    t = [torch.from_numpy(np.array(a)) for a in data]
    with torch.no_grad():
        out = model(t[0], t[1], t[0], t[2], torch.ones_like(t[2]), y_trgt=t[1], eps=eps)
    loc = out.p_yCc.loc.numpy()
    assert loc.shape == loc16.shape and np.isfinite(loc).all()
    check_distances(loc, loc16, loc32)
