"""One train step in bfloat16 compute against the JAX package's bf16 step, at
small width: from JAX's parameters and batch, the port's loss, every
parameter gradient and the updated BatchNorm statistics, on the kernel path
(against `fused_mlp=True`) and the plain path (the Dense decoder), in the
way `tests/test_torch_train.py` compares the float32 steps. JAX is
differentiated op by op, each bf16 op rounding its result
(tests/test_torch_bf16_slice.py: XLA's excess precision).

Bars, each with its reason and the value measured on this CPU:
- loss 1e-3 relative: the loss is an f32 sum of log-probs of bf16
  predictions; the two sides' f32 sums run in other orders, which may move
  a rounded value by one ulp (measured: 8.7e-8 on either path);
- gradients 1e-1 of each leaf's max magnitude: the backward runs in bf16
  (cotangents rounded at every bf16 op, as in JAX), and the two autograds
  round some cotangents at other points: JAX's custom softplus JVP, and the
  sums that transpose a broadcast (a bf16 bias's gradient is a bf16 sum over
  rows, which PyTorch accumulates in f32 and XLA may not). A bias gradient
  sums many rounded terms, and the SetConv length scale's sums them with
  cancellation (measured: 6.0e-2 worst, the first SetConv's length scale,
  on either path; 2.9e-2 the worst bias; most leaves below 1e-2);
- the conv1 biases of a BatchNorm block, whose gradient is zero in exact
  arithmetic, below the same bar times the block's conv1.pointwise weight
  gradient on both sides (measured: 2.1e-2);
- BatchNorm's updated running statistics 1e-4: float32 statistics of the
  same bf16 activations (measured: 6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer, params_from_flax

torch.set_num_threads(1)

LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-1
STATS_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, B, N, counts):
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1)).copy()
    y = (0.3 * np.sin(8 * x + rng.uniform(0, 6, (B, 1, 1)))).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for i, n in enumerate(counts):  # counts[0] == 0: an empty context
        mask_c[i, rng.permutation(N)[:n]] = True
    cond = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    return x, y, mask_c, np.ones((B, N), bool), cond


def _jax_step(model, variables, x, y, mask_c, mask_t, cond):
    """(loss, grads, new batch_stats) of one JAX train step, op by op."""
    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t, condition=cond,
                               train=True, mutable=["batch_stats"])
        return JaxCNPFLoss()(out, y, mask_t, train=True), upd["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), _np_tree(grads), _np_tree(stats)


def _bn_cancelled(name):
    return ".conv1." in name and name.endswith(".bias")


def grad_errors(grads, ref_tree):
    """{name: max |port - JAX| / max |JAX|} over every gradient but the
    BatchNorm-cancelled biases, and {name: the larger side's max |.| over its
    block's conv1.pointwise weight gradient's} for those."""
    ref = params_from_flax(ref_tree)
    assert set(ref) == set(grads)
    errs, zero = {}, {}
    for name, g in grads.items():
        g, r = g.numpy(), ref[name].numpy()
        if _bn_cancelled(name):
            scale = np.abs(ref[name.rsplit(".", 2)[0] + ".pointwise.weight"].numpy()).max()
            zero[name] = max(np.abs(g).max(), np.abs(r).max()) / scale
        else:
            errs[name] = np.abs(g - r).max() / np.abs(r).max()
    return errs, zero


def run_step(use_kernels):
    """-> (loss, JAX loss, gradient errors, cancelled-bias ratios, stats
    errors) of one bf16 train step of the small FiLM ConvCNP."""
    rng = np.random.default_rng(0)
    x, y, mask_c, mask_t, cond = _batch(rng, 3, 40, [0, 7, 30])
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, jnp.bfloat16, kernel_size=5), cond_dim=4,
                    cond_mode="film", dtype=jnp.bfloat16, fused_mlp=use_kernels)
    variables = _np_tree(jax.jit(lambda key: jm.init(
        key, x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t, condition=cond, train=True))(
        jax.random.PRNGKey(0)))
    ref_loss, ref_grads, ref_stats = _jax_step(jm, variables, *(jnp.asarray(a) for a in (
        x, y, mask_c, mask_t, cond)))
    tm = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5, cond_dim=4,
                 use_kernels=use_kernels, dtype=torch.bfloat16)
    tm.load_state_dict(params_from_flax(variables["params"],
                                        {"batch_stats": variables["batch_stats"]}))
    batch = {k: torch.from_numpy(v) for k, v in dict(
        X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y, mask_cntxt=mask_c, mask_trgt=mask_t,
        condition=cond).items()}
    trainer = Trainer(tm, CNPFLoss(), make_optimizer(tm.parameters()), splitter=None)
    loss = trainer.loss_and_grads(batch).item()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    errs, zero = grad_errors(grads, ref_grads)
    stats = params_from_flax({}, {"batch_stats": ref_stats})
    stats_err = {n: np.abs(tm.state_dict()[n].numpy() - r.numpy()).max() for n, r in stats.items()}
    return loss, ref_loss, errs, zero, stats_err


@pytest.mark.parametrize("use_kernels", [False, True])
def test_small_convcnp_bf16_train_step_matches_jax(use_kernels):
    loss, ref_loss, errs, zero, stats_err = run_step(use_kernels)
    assert np.isfinite(loss) and abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert max(zero.values()) <= GRAD_RTOL, zero
    assert max(stats_err.values()) <= STATS_ATOL, stats_err
