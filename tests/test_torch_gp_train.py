"""One GP train step of the port from the JAX package's state against the
JAX package's step: the GP ConvCNP from `RBF_Kernel/ConvCNP/run_0`'s
parameters and BatchNorm statistics (BatchNorm eps 1e-5), and the notebook
ablation ConvLNP (NPML, 16 z draws, clip 1.0) from
`RBF_Kernel/ConvLNP_ELBOFalse_LatLBFalse_SigLBFalse/run_0`'s (eps 1e-3), at
full width, on RBF functions JAX's sampler draws, split by the training
splitter (one context count U{0..50} for the batch) drawn from a JAX key;
the ConvLNP's z noise is JAX's own, recovered from its train-mode forward
as (z - loc) / scale and given to the port. Then `train_gp.build_trainer`'s
optimizer for each (Adam 1e-3, the staircase over 100 epochs of 1,562
steps, the clip) against optax's on the port's gradients.

Bars: the loss 3e-5 relative (float32 sums of 128 log-densities a function
in other orders); each gradient 2e-3 of its leaf's largest magnitude (the
BatchNorm-cancelled conv1 biases below 1e-4 times their block's pointwise
weight gradient, on both sides): these trained models predict noise-free
RBF functions to residuals y - loc near 1e-3 at scales near 1e-3, so a
float32 rounding of loc (6e-8 at |loc| ~ 1) is 1e-4 of the residual that
the gradient (y - loc) / scale^2 carries, and every gradient leaf moves
by 2-3e-4 of its magnitude, the grid->targets length scale's by 8.6e-4
(measured, ConvCNP; the GW tests' 1e-4 is for untrained small models);
the running statistics 1e-5; the updated parameters 1e-5 of each leaf's
magnitude (at least 1e-2).
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from npf_gwwaveform_tpu.data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.losses import NLLLossLNPF as JaxNLLLoss
from npf_gwwaveform_tpu.training.optim import make_optimizer as jax_make_optimizer
from npf_gwwaveform_tpu_torch import train_gp
from npf_gwwaveform_tpu_torch.training import flax_from_params, load_run_params, params_from_flax

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
LOSS_RTOL, GRAD_RTOL, STATS_ATOL, OPT_RTOL = 3e-5, 2e-3, 1e-5, 1e-5
CASES = {"ConvCNP": (os.path.join("RBF_Kernel", "ConvCNP", "run_0"), 4),
         "ConvLNP": (os.path.join("RBF_Kernel", "ConvLNP_ELBOFalse_LatLBFalse_SigLBFalse",
                                  "run_0"), 2)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _bn_cancelled(name):
    return ".conv1." in name and name.endswith(".bias")


@pytest.mark.parametrize("case", list(CASES))
def test_gp_train_step_matches_jax(case):
    from jax_score_offsets import jax_gp_model

    rel, n_fn = CASES[case]
    with open(os.path.join(RESULTS, rel, "summary.json")) as f:
        record = json.load(f)
    summary = train_gp.train_summary(
        "ConvLNP" if case == "ConvLNP" else "ConvCNP", norm_eps=record["norm_eps"],
        **({"ablation": "ELBOFalse_LatLBFalse_SigLBFalse"} if case == "ConvLNP" else {}))
    assert summary["model"] == record["model"]
    params, extra = load_run_params(os.path.join(RESULTS, rel))
    variables = {"params": params, **extra}
    jm = jax_gp_model(summary)
    x, y = GPSampler(n_points=128, **KERNEL_CONFIGS["RBF_Kernel"]).sample(
        jax.random.PRNGKey(3), n_fn)
    split = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=50),
                              targets_getter=get_all_indcs)(jax.random.PRNGKey(4), x, y)
    x, y, mask_c = (np.asarray(a) for a in (x, y, split["mask_cntxt"]))
    mask_t = np.ones(mask_c.shape, bool)
    assert 0 < mask_c.sum(axis=1)[0] <= 50
    criterion = JaxCNPFLoss() if case == "ConvCNP" else JaxNLLLoss()
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        out, upd = jm.apply({**variables, "params": p}, x, y, x, y, mask_c, mask_t, train=True,
                            rngs={"latent": key}, mutable=["batch_stats"])
        return criterion(out, y, mask_t, train=True), (upd, out)

    (j_loss, (j_upd, j_out)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    eps = None
    if case == "ConvLNP":
        assert j_out.z_samples.shape[0] == 16
        eps = torch.from_numpy((np.asarray(j_out.z_samples, np.float64)
                                - np.asarray(j_out.q_zCc.loc, np.float64))
                               / np.asarray(j_out.q_zCc.scale, np.float64)).float()

    trainer = train_gp.build_trainer(summary, 100, 1562, "cpu")
    tm = trainer.model
    tm.load_state_dict(params_from_flax(params, extra), strict=True)
    params0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    xt, yt, mct = (torch.from_numpy(a) for a in (x, y, mask_c))
    mtt = torch.ones_like(mct)
    tm.train()
    out = tm(xt, yt, xt, mct, mtt, y_trgt=yt, eps=eps)
    loss = trainer.criterion(out, yt, mtt, train=True)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    ref = params_from_flax(_np(j_grads))
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    assert set(ref) == set(grads)
    for name, g in grads.items():
        r = ref[name]
        if _bn_cancelled(name):
            w = ref[name.rsplit(".", 2)[0] + ".pointwise.weight"].abs().max()
            assert max(g.abs().max(), r.abs().max()) <= 1e-4 * w, name
            continue
        assert (g - r).abs().max() <= GRAD_RTOL * r.abs().max(), name
    stats = params_from_flax({}, {"batch_stats": _np(j_upd["batch_stats"])})
    for name, r in stats.items():
        np.testing.assert_allclose(tm.get_buffer(name).numpy(), r.numpy(), atol=STATS_ATOL,
                                   rtol=0, err_msg=name)

    # the update: train_gp's optimizer against optax's, on the port's gradients
    norm = trainer.state.optimizer.step()
    clip = None if case == "ConvCNP" else 1.0
    assert trainer.state.optimizer.grad_clip_norm == clip
    tx = jax_make_optimizer(lr=1e-3, decay_lr=10.0, max_epochs=100, steps_per_epoch=1562,
                            grad_clip_norm=clip)
    p_tree, _ = flax_from_params(params0, [])
    g_tree, _ = flax_from_params(grads, [])
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(g_tree)), rtol=1e-5)
    updates, _ = tx.update(g_tree, tx.init(p_tree), p_tree)
    for name, r in params_from_flax(_np(optax.apply_updates(p_tree, updates))).items():
        p, r = tm.get_parameter(name).detach().numpy(), r.numpy()
        assert np.abs(p - r).max() <= OPT_RTOL * max(np.abs(r).max(), 1e-2), name
    assert jnp.isfinite(j_loss)
