"""`npf_gwwaveform_tpu_torch.eval_extrapolation` against
`experiments/eval_extrapolation.py`, whose loop `tests/jax_eval_bands.py`
repeats through the JAX package.

The inputs are the JAX script's first batch of each kernel: 256 functions
over twice the training range from `fold_in(PRNGKey(123), 0)`, its context
mask, and, for a latent model, JAX's own z noise at 2 draws a function (the
models' `n_z_samples_test` set to 2: each draw is the same computation),
recovered as (z - loc) / scale in float64; the model checks take its first
16 functions. Tolerances: masks bit for bit; loc and scale 5e-4 absolute
plus 2e-3 of the value (the GP runs' predictive bar,
tests/test_torch_setattn_runs.py), 2e-3 absolute for the attention runs
(that file's reason: trained logits near 1.9e4 round by 2e-3 in
float32); each function's interpolation and extrapolation log-likelihood
within 1e-4 of its magnitude plus 0.02 nats, the absolute part for the
sums near zero (a sum of a few hundred terms of order 1-10, each off by
float32 roundings of loc and scale); the attention runs' within 5e-4 of
it plus 0.05 (their loc moves by up to 2e-3 for the reason above:
measured 0.060 nats on a function of -202 in Periodic AttnCNP). The
oracle on well-conditioned systems (16 points at least one length scale
apart) within 1e-4 of each LL's magnitude plus 0.01.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from jax_eval_bands import ctx_noise, extrap_state, make_ctx_mask as jax_make_ctx_mask
from jax_eval_bands import oracle_lls as jax_oracle_lls
from jax_eval_bands import sampler_of, wide_range
from npf_gwwaveform_tpu_torch import eval_extrapolation as ex
from npf_gwwaveform_tpu_torch.data.gp import KERNEL_CONFIGS, GPSampler

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
N_FN, N_Z = 16, 2
DIST_ATOL, ATTN_DIST_ATOL, DIST_RTOL, LL_RTOL, LL_ATOL = 5e-4, 2e-3, 2e-3, 1e-4, 0.02
ATTN_LL_RTOL, ATTN_LL_ATOL = 5e-4, 0.05
# one run of each of the six models, across both kernels
SCORED = [("Periodic_Kernel", "CNP"), ("RBF_Kernel", "LNP"), ("Periodic_Kernel", "AttnCNP"),
          ("RBF_Kernel", "AttnLNP"), ("RBF_Kernel", "ConvCNP"), ("Periodic_Kernel", "ConvLNP")]
ROW_KEYS = ["model", "kernel", "interp_ll_per_fn", "extrap_ll_per_fn", "interp_std",
            "extrap_std", "n_test"]


@functools.lru_cache(maxsize=None)
def jax_batch(kernel):
    """The JAX script's batch 0: (x, y, mask_c, k_latent, counts, scores)."""
    import jax

    sampler = sampler_of(kernel)
    kd, ks, kl = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), 0), 3)
    x, y = sampler.sample(kd, 256, min_max=wide_range(sampler))
    mask_c = jax_make_ctx_mask(ks, x)
    n, u = ctx_noise(ks, 256, x.shape[1])
    return tuple(np.asarray(a) for a in (x, y, mask_c)) + (kl,) + tuple(
        np.asarray(a) for a in (n, u))


@pytest.mark.parametrize("kernel", ["RBF_Kernel", "Periodic_Kernel"])
def test_ctx_mask_is_jax_bit_for_bit(kernel):
    x, _, mask_j, _, n, u = jax_batch(kernel)
    mask = ex.make_ctx_mask(torch.from_numpy(x), torch.from_numpy(n).long(), torch.from_numpy(u))
    assert mask.dtype == torch.bool and np.array_equal(mask.numpy(), mask_j)
    inner = np.abs(x[..., 0]) <= 1.0
    assert not (mask.numpy() & ~inner).any()
    assert np.array_equal(mask.numpy().sum(1), np.minimum(n[:, 0], inner.sum(1)))


def test_ctx_mask_guard_counts_as_jax():
    """Functions with fewer inner points than their drawn count get only
    those points, as JAX's guard gives them, never an outer one."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    B, N = 8, 64
    x = rng.uniform(1.05, 2.0, (B, N, 1)) * rng.choice([-1.0, 1.0], (B, N, 1))
    for b in range(B):  # b inner points in function b
        x[b, :b, 0] = rng.uniform(-1.0, 1.0, b)
    x = x.astype(np.float32)
    key = jax.random.PRNGKey(7)
    mask_j = np.asarray(jax_make_ctx_mask(key, jnp.asarray(x)))
    n, u = (np.asarray(a) for a in ctx_noise(key, B, N))
    mask = ex.make_ctx_mask(torch.from_numpy(x), torch.from_numpy(n).long(),
                            torch.from_numpy(u)).numpy()
    assert np.array_equal(mask, mask_j)
    assert np.array_equal(mask.sum(1), np.minimum(n[:, 0], np.arange(B)))
    assert (n[:, 0] > np.arange(B)).any()


def test_oracle_lls_well_conditioned():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    B, N = 32, 16
    sampler_j = sampler_of("RBF_Kernel", N)
    sampler = GPSampler(n_points=N, **KERNEL_CONFIGS["RBF_Kernel"])
    # 16 points at least 0.1 apart over [-2, 2] (0.2 in the kernel's units,
    # one length scale): a covariance far from singular
    x = (np.linspace(-1.95, 1.95, N)[None, :, None]
         + rng.uniform(-0.05, 0.05, (B, N, 1))).astype(np.float32)
    y = rng.normal(size=(B, N, 1)).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for b in range(B):
        inner = np.flatnonzero(np.abs(x[b, :, 0]) <= 1.0)
        mask_c[b, rng.choice(inner, b % (len(inner) + 1), replace=False)] = True
    inner = np.abs(x[..., 0]) <= 1.0
    f = jax.vmap(lambda *a: jax_oracle_lls(sampler_j, *a))
    for mask_t in (inner, ~inner):
        j_ll = np.asarray(f(*(jnp.asarray(a) for a in (x, y, mask_c, mask_t))), np.float64)
        ll = ex.oracle_lls(sampler, *(torch.from_numpy(a) for a in (x, y, mask_c, mask_t)))
        err = np.abs(ll.double().numpy() - j_ll)
        assert np.all(err <= 1e-4 * np.abs(j_ll) + 0.01), err.max()


def test_conv_rebuild_at_twice_the_range():
    """The conv models' grid over (-3, 3): 384 points, JAX's linspace to
    one float32 ulp (`utils.helpers.linspace` rounds as `jnp.linspace`'s
    arithmetic op by op; XLA's fused evaluation rounds some points one ulp
    apart, as at the GP paths' 192 points)."""
    import jax.numpy as jnp

    for name in ("ConvCNP", "ConvLNP"):
        model = ex.load_model("RBF_Kernel", name, "cpu", results=RESULTS)
        assert model.induced_range == (-3.0, 3.0) and model.n_induced == 384
        grid = model._get_x_induced(1, "cpu")[0, :, 0].numpy()
        ref = np.asarray(jnp.linspace(-3.0, 3.0, 384, dtype=jnp.float32))
        np.testing.assert_allclose(grid, ref, rtol=0, atol=5e-7)


@functools.lru_cache(maxsize=None)
def jax_scores(kernel, name):
    """JAX's forward on the first N_FN functions of batch 0 at N_Z draws:
    (interp LLs, extrap LLs, loc, scale, eps or None)."""
    import jax

    model, _, _ = extrap_state(kernel, name)
    if getattr(model, "has_latent", False):
        # one draw in the init's train-mode forward: the parameters' shapes
        # do not depend on it, and XLA's CPU convolutions are slow
        model = model.clone(n_z_samples_test=N_Z, n_z_samples_train=1)
    _, trainer, state = extrap_state(kernel, name, model)
    x, y, mask_c, kl, _, _ = jax_batch(kernel)
    x, y, mask_c = x[:N_FN], y[:N_FN], mask_c[:N_FN]
    inner = np.abs(x[..., 0]) <= 1.0
    batch = dict(X_cntxt=x, Y_cntxt=y, mask_cntxt=mask_c, X_trgt=x, Y_trgt=y,
                 mask_trgt=np.ones_like(inner))
    # jitted: XLA's CPU convolutions are slow op by op
    out, _ = jax.jit(trainer._apply, static_argnames="train")(state.params, state.extra_vars,
                                                               batch, kl, train=False)
    lls = [np.asarray(-trainer.eval_criterion(out, y, m, train=False), np.float64)
           for m in (inner, ~inner)]
    eps = None
    if out.z_samples is not None:
        q = out.q_zCc if out.q_zCct is None else out.q_zCct
        eps = ((np.asarray(out.z_samples, np.float64) - np.asarray(q.loc, np.float64))
               / np.asarray(q.scale, np.float64))
    return lls[0], lls[1], np.asarray(out.p_yCc.loc), np.asarray(out.p_yCc.scale), eps


@pytest.mark.parametrize("kernel,name", SCORED)
def test_run_scores_jax_draws_as_jax(kernel, name):
    j_in, j_ex, j_loc, j_scale, eps = jax_scores(kernel, name)
    x, y, mask_c, _, _, _ = jax_batch(kernel)
    model = ex.load_model(kernel, name, "cpu", results=RESULTS)
    if model.has_latent:
        model.n_z_samples_test = N_Z
    xt, yt, mt = (torch.from_numpy(np.array(a[:N_FN])) for a in (x, y, mask_c))
    with torch.no_grad():
        ll_in, ll_ex = ex.score_batch(model, ex.eval_criterion(name), xt, yt, mt,
                                      eps=None if eps is None else torch.from_numpy(eps).float())
        out = model(xt, yt, xt, mt, torch.ones_like(mt), y_trgt=yt,
                    eps=None if eps is None else torch.from_numpy(eps).float())
    atol = ATTN_DIST_ATOL if name.startswith("Attn") else DIST_ATOL
    for got, ref, field in ((out.p_yCc.loc, j_loc, "loc"), (out.p_yCc.scale, j_scale, "scale")):
        np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=DIST_RTOL,
                                   err_msg=f"{kernel} {name} {field}")
    rtol, ll_atol = ((ATTN_LL_RTOL, ATTN_LL_ATOL) if name.startswith("Attn")
                     else (LL_RTOL, LL_ATOL))
    for got, ref in ((ll_in, j_in), (ll_ex, j_ex)):
        err = np.abs(got.double().numpy() - ref)
        assert np.all(err <= rtol * np.abs(ref) + ll_atol), (kernel, name, err.max())


@pytest.mark.parametrize("name", ex.MODELS[1:])
def test_eval_criterion_is_the_trainers(name):
    """The scorer's criterion is the one the port's `Trainer` evaluates with
    (its `eval_criterion`), built for the family as the JAX script builds
    its trainer."""
    from npf_gwwaveform_tpu_torch.configs import gp_criterion
    from npf_gwwaveform_tpu_torch.data.datasplit import CntxtTrgtSplitter, GetRandomIndcs
    from npf_gwwaveform_tpu_torch.data.datasplit import get_all_indcs
    from npf_gwwaveform_tpu_torch.training.optim import make_optimizer
    from npf_gwwaveform_tpu_torch.training.trainer import Trainer

    model = torch.nn.Linear(1, 1)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=ex.MAX_CNTXT),
                                 targets_getter=get_all_indcs)
    trainer = Trainer(model, gp_criterion(name), make_optimizer(model.parameters(), decay_lr=None),
                      splitter)
    assert ex.eval_criterion(name) == trainer.eval_criterion


def test_rows_json_and_results_refused(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)  # the entry point reads results/ below the working directory
    rows = ex.main(["--device", "cpu", "--kernel", "RBF_Kernel", "--models", "oracle,CNP",
                    "--n-test", "4", "--out", str(tmp_path)])
    with open(tmp_path / "extrapolation_RBF_Kernel.json") as f:
        written = json.load(f)
    with open(os.path.join(RESULTS, "extrapolation_RBF_Kernel.json")) as f:
        record = json.load(f)
    assert written == rows and [r["model"] for r in rows] == ["oracle_gp", "CNP"]
    assert all(list(r) == ROW_KEYS == list(record[0]) for r in rows)
    assert all(r["n_test"] == 4 and np.isfinite(r["interp_ll_per_fn"]) for r in rows)
    for out in (RESULTS, os.path.join(RESULTS, "extrap")):
        with pytest.raises(SystemExit):
            ex.main(["--device", "cpu", "--models", "CNP", "--out", out])
