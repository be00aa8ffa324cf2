"""The 57 set and attention GP runs in `results/` (CNP, LNP, AttnCNP and
AttnLNP of the five kernels and `All_Kernels`, the LNP and AttnLNP
objective-ablation grids, `LNP_SUMO`) in the port: each loads strictly
through `score_gp.load_model` into the family and draw counts its name
gives, and its parameter tree in flax's layout is read back as it was
written; one run of each family (and the SUMO run) scores 16 functions of
the JAX package's own eval inputs as the JAX package does.

The inputs are `reproduce_gp.py`'s first eval batch: the first 16 of the
256 functions drawn from `fold_in(k_data, 0)` (for `All_Kernels` its first
component, RBF), the eval split of `fold_in(k_split, 0)` (U{0..50} context
points a function, all 128 targets), and for a latent run JAX's own z
noise at 2 draws a function (both models' `n_z_samples_test` set to 2:
each draw is the same computation), recovered as (z - loc) / scale in
float64. Tolerances: loc and scale 5e-4 absolute plus 2e-3 of the value,
each function's log-likelihood within 2e-4 of its magnitude plus 0.02 nats
(the conv family's run bars, tests/test_torch_gp_runs.py). A trained
attention model's logits reach ~1.9e4 (Periodic AttnCNP run_0), where a
float32 rounding is 2e-3, so its softmax weights and outputs move by up
to ~1e-3 of themselves under float32 roundings of the keys: there JAX's
own float32 forward is 1.5e-3 from a float64 evaluation and the port's
3.0e-3 in the multihead output, so the attention runs' loc and scale take
2e-3 absolute (measured: 6.8e-4 on Periodic AttnCNP run_0).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu_torch import score_gp
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models import CNP, LNP, AttnCNP, AttnLNP
from npf_gwwaveform_tpu_torch.run_report import gp_set_runs
from npf_gwwaveform_tpu_torch.training.checkpoint import (
    _flatten, flax_from_params, load_run_params,
)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
RUNS = [os.path.relpath(r, RESULTS) for r in gp_set_runs(RESULTS)]
DIST_ATOL, ATTN_DIST_ATOL, DIST_RTOL, LL_RTOL, LL_ATOL = 5e-4, 2e-3, 2e-3, 2e-4, 0.02
N_FN, N_Z = 16, 2
FAMILIES = {"CNP": CNP, "LNP": LNP, "AttnCNP": AttnCNP, "AttnLNP": AttnLNP}
# the headline draws in eval, and the NPML variants' (and SUMO's) in eval and training
DRAWS = {"LNP": 32, "AttnLNP": 8}
# one run of each family, and SUMO
SCORED = [os.path.join("Periodic_Kernel", "CNP", "run_0"),
          os.path.join("RBF_Kernel", "LNP", "run_0"),
          os.path.join("Periodic_Kernel", "AttnCNP", "run_0"),
          os.path.join("All_Kernels", "AttnLNP", "run_0"),
          os.path.join("RBF_Kernel", "LNP_SUMO", "run_0")]


def summary_of(rel):
    with open(os.path.join(RESULTS, rel, "summary.json")) as f:
        return json.load(f)


def test_there_are_57_runs():
    families = [summary_of(r)["model"].split("_")[0] for r in RUNS]
    assert len(RUNS) == 57
    assert {f: families.count(f) for f in FAMILIES} == {"CNP": 6, "LNP": 15, "AttnCNP": 17,
                                                        "AttnLNP": 19}


@pytest.mark.parametrize("rel", RUNS)
def test_run_loads_strictly_and_round_trips(rel):
    """strict=True into its family with its draw counts, and the state dict
    written back as the flax tree it was read from, leaf for leaf."""
    run_dir = os.path.join(RESULTS, rel)
    name = summary_of(rel)["model"]
    family = name.split("_")[0]
    model = score_gp.load_model(run_dir, "cpu")
    assert type(model) is FAMILIES[family]
    if family in DRAWS:
        assert model.n_z_samples_test == DRAWS[family]
        npml = "_ELBOFalse" in name or name.endswith("_SUMO")
        assert model.n_z_samples_train == (DRAWS[family] if npml else 1)
        assert model.is_q_zCct == (not npml)
    params, extra = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    for got, ref in zip((params, extra), load_run_params(run_dir)):
        got, ref = dict(_flatten(got)), dict(_flatten(ref))
        assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    from npf_gwwaveform_tpu.configs import gp_model_1d, gp_model_variant
    from npf_gwwaveform_tpu.data.datasplit import (
        CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs,
    )
    from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler
    from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
    from npf_gwwaveform_tpu_torch.configs import parse_variant
    return locals()


def jax_model(summary):
    """The run's JAX model as `reproduce_gp.py` builds it."""
    j = _jax()
    name = summary["model"]
    if "_ELBO" in name:
        base, flags = j["parse_variant"](name)
        return j["gp_model_variant"](base, flags["ELBO"], flags["LatLB"], flags["SigLB"])
    if name.endswith("_SUMO"):
        return j["gp_model_variant"](name[: -len("_SUMO")], False, True, True)
    return j["gp_model_1d"](name)


def eval_inputs(kernel):
    j = _jax()
    jax = j["jax"]
    name = "RBF_Kernel" if kernel == "All_Kernels" else kernel
    sampler = j["GPSampler"](n_points=128, **j["KERNEL_CONFIGS"][name])
    k_data, k_split = jax.random.split(jax.random.PRNGKey(123))
    x, y = sampler.sample(jax.random.fold_in(k_data, 0), 256)
    k_sp, k_lat = jax.random.split(jax.random.fold_in(k_split, 0))
    splitter = j["CntxtTrgtSplitter"](
        contexts_getter=j["GetRandomIndcs"](a=0.0, b=50, is_indep_n=True),
        targets_getter=j["get_all_indcs"])
    mask_c = splitter(k_sp, x, y)["mask_cntxt"]
    return tuple(np.asarray(a[:N_FN]) for a in (x, y, mask_c)) + (k_lat,)


@pytest.mark.parametrize("rel", SCORED)
def test_run_scores_jax_eval_inputs_as_jax(rel):
    j = _jax()
    summary = summary_of(rel)
    run_dir = os.path.join(RESULTS, rel)
    x, y, mask_c, k_lat = eval_inputs(summary["kernel"])
    jm = jax_model(summary)
    if jm.has_latent:
        jm = jm.clone(n_z_samples_test=N_Z)
    params, extra = load_run_params(run_dir)
    mask_t = np.ones(mask_c.shape, bool)
    assert mask_c.sum(axis=1).min() < mask_c.sum(axis=1).max() <= 50
    j_out = jm.apply({"params": params, **extra}, x, y, x, y, mask_cntxt=mask_c,
                     mask_trgt=mask_t, train=False, rngs={"latent": k_lat})
    j_ll = np.asarray(-j["JaxCNPFLoss"](reduction=None)(j_out, y, mask_t, train=False),
                      np.float64)
    model = score_gp.load_model(run_dir, "cpu")
    eps = None
    if model.has_latent:
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
    assert out.p_yCc.loc.shape == (N_Z if eps is not None else 1, N_FN, 128, 1)
    atol = ATTN_DIST_ATOL if "Attn" in rel else DIST_ATOL
    for field in ("loc", "scale"):
        np.testing.assert_allclose(getattr(out.p_yCc, field).numpy(),
                                   np.asarray(getattr(j_out.p_yCc, field)), atol=atol,
                                   rtol=DIST_RTOL, err_msg=f"{rel} {field}")
    err = np.abs(ll.double().numpy() - j_ll)
    assert np.all(err <= LL_RTOL * np.abs(j_ll) + LL_ATOL), (rel, err.max())


def test_run_report_bands_of_the_set_family(capsys, monkeypatch):
    """`run_report bands --set`: one row a run, its recorded mean LL inside
    its band (1,000 bootstrap resamples here, not 10,000, for time)."""
    from npf_gwwaveform_tpu_torch import run_report

    monkeypatch.setattr(run_report, "N_BOOT", 1000)
    run_report.main(["bands", "--results", RESULTS, "--set"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 + 57 and all(line.startswith("|") for line in lines)
    for line in lines[2:]:
        _, rel, n, mean, band, _ = (c.strip() for c in line.split("|"))
        lo, hi = (float(v) for v in band.strip("[]").split(","))
        assert lo <= float(mean) <= hi and int(n) in (9984, 29952), rel
