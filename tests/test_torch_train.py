"""The training slice against the JAX package: one train step (loss,
gradients, BatchNorm statistics) of a small ConvCNP on both kernel paths and
of the flagship run at full width, Adam with its staircase schedule and
optax's clipping, the msgpack writer, and `train_gw` end to end on the CPU.

Tolerances, each with its reason:
- loss 1e-5 relative, BatchNorm running statistics 1e-5: float32 on both
  sides, sums in another order;
- gradients 1e-4 of each leaf's max magnitude at small width: a few float32
  reductions over the batch in another order;
- at full width (run_1, B=4) 1e-3 of each leaf's max magnitude: the loss sums
  256 log-probs per waveform with predictive scales down to 0.01, so rounding
  differences of ~1e-6 in the decoder's input grow ~1e2 by the time they
  reach the grid CNN's gradients (measured: 5.3e-4 worst leaf, on either
  kernel path, against a loss difference of 5e-6 relative);
- the conv1 biases of a BatchNorm block add a per-channel constant that the
  next train-mode BatchNorm subtracts, so their gradient is zero in exact
  arithmetic and rounding noise on both sides: each side's must be below the
  same bar times the block's conv1.pointwise weight gradient;
- Adam and clipping 1e-5 of each leaf's magnitude, given identical gradients;
- predictives of a port-written run loaded into JAX: 5e-4 (the README's
  parity bar).
"""

import json
import os

import flax
import flax.serialization
import jax
import numpy as np
import optax
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_gw_model_from_summary
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu.training.optim import make_optimizer as jax_make_optimizer
from npf_gwwaveform_tpu_torch import train_gw
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary, gw_train_summary
from npf_gwwaveform_tpu_torch.data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.score import (
    load_model, make_eval_batch, read_run_thetas, run_generator,
)
from npf_gwwaveform_tpu_torch.training import (
    Trainer, count_parameters, flax_from_params, load_run_params, make_optimizer,
    params_from_flax, save_run_params,
)
from npf_gwwaveform_tpu_torch.training.checkpoint import write_msgpack
from npf_gwwaveform_tpu_torch.utils.init import init_module

torch.set_num_threads(1)

RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
LOSS_RTOL = 1e-5
STATS_ATOL = 1e-5
GRAD_RTOL_SMALL = 1e-4
GRAD_RTOL_FULL = 1e-3
OPT_RTOL = 1e-5
PRED_ATOL = 5e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _batch(rng, B, N, counts):
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1)).copy()
    y = (0.3 * np.sin(8 * x + rng.uniform(0, 6, (B, 1, 1)))).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for i, n in enumerate(counts):  # counts[0] == 0: an empty context
        mask_c[i, rng.permutation(N)[:n]] = True
    cond = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    return x, y, mask_c, np.ones((B, N), bool), cond


def _jax_step(model, variables, x, y, mask_c, mask_t, cond):
    """(loss, grads, new batch_stats) of one JAX train step."""
    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t, condition=cond,
                               train=True, mutable=["batch_stats"])
        return JaxCNPFLoss()(out, y, mask_t, train=True), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), _np_tree(grads), _np_tree(stats)


def _port_step(model, x, y, mask_c, mask_t, cond):
    batch = dict(X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y, mask_cntxt=mask_c, mask_trgt=mask_t,
                 condition=cond)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    trainer = Trainer(model, CNPFLoss(), make_optimizer(model.parameters()), splitter=None)
    loss = trainer.loss_and_grads(batch).item()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def _bn_cancelled(name):
    """conv1's biases in a BatchNorm block: their gradient is zero in exact arithmetic."""
    return ".conv1." in name and name.endswith(".bias")


def _compare_grads(grads, ref_tree, rtol):
    """Port gradients against the JAX gradient tree mapped to port names."""
    ref = params_from_flax(ref_tree)
    assert set(ref) == set(grads)
    worst = 0.0
    for name, g in grads.items():
        g, r = g.numpy(), ref[name].numpy()
        if _bn_cancelled(name):
            scale = np.abs(ref[name.rsplit(".", 2)[0] + ".pointwise.weight"].numpy()).max()
            assert np.abs(g).max() <= rtol * scale and np.abs(r).max() <= rtol * scale, name
            continue
        err = np.abs(g - r).max() / np.abs(r).max()
        worst = max(worst, err)
        assert err <= rtol, (name, err)
    return worst


@pytest.mark.parametrize("use_kernels", [False, True])
def test_small_convcnp_train_step_matches_jax(use_kernels):
    """r_dim 16, two BatchNorm ResConvBlocks, FiLM: loss, every gradient and
    the updated running statistics of one train step."""
    rng = np.random.default_rng(0)
    x, y, mask_c, mask_t, cond = _batch(rng, 3, 40, [0, 7, 30])
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, kernel_size=5), cond_dim=4, cond_mode="film")
    variables = _np_tree(jax.jit(lambda key: jm.init(
        key, x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t, condition=cond, train=True))(
        jax.random.PRNGKey(0)))
    ref_loss, ref_grads, ref_stats = _jax_step(jm, variables, x, y, mask_c, mask_t, cond)
    tm = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5, cond_dim=4,
                 use_kernels=use_kernels)
    tm.load_state_dict(params_from_flax(variables["params"],
                                        {"batch_stats": variables["batch_stats"]}))
    loss, grads = _port_step(tm, x, y, mask_c, mask_t, cond)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    _compare_grads(grads, ref_grads, GRAD_RTOL_SMALL)
    stats = params_from_flax({}, {"batch_stats": ref_stats})
    for name, ref in stats.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(), ref.numpy(), atol=STATS_ATOL,
                                   rtol=1e-5, err_msg=name)


def test_flagship_train_step_matches_jax_at_full_width():
    """run_1's weights (368,004 parameters), B=4, contexts of 0, 5, 96 and 192
    points: the gradients of one train step."""
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    rng = np.random.default_rng(1)
    x, _, mask_c, mask_t, _ = _batch(rng, 4, 256, [0, 5, 96, 192])
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:4])
    _, y, cond = (t.numpy() for t in make_eval_batch(theta, run_generator(summary),
                                                     GWParameterSpace()))
    params, extra = load_run_params(RUN_DIR)
    ref_loss, ref_grads, _ = _jax_step(jax_gw_model_from_summary(summary),
                                       {"params": params, **extra}, x, y, mask_c, mask_t, cond)
    tm = load_model(RUN_DIR, "cpu")
    loss, grads = _port_step(tm, x, y, mask_c, mask_t, cond)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    _compare_grads(grads, ref_grads, GRAD_RTOL_FULL)


def _grad_trees(rng, params, n):
    return [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 3,
                                   params) for _ in range(n)]


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adam_schedule_and_clipping_match_optax(clip):
    """Three updates from identical gradients: optax's Adam with a staircase
    decay over epochs of 2 steps (so the third update has the decayed rate),
    optionally after clip_by_global_norm (the gradients' norm is far above
    1, so clipping acts)."""
    rng = np.random.default_rng(2)
    model = ConvCNP(r_dim=8, density_induced=8, cnn_n_blocks=1, cnn_kernel_size=3, cond_dim=4)
    params, _ = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    tx = jax_make_optimizer(lr=1e-2, decay_lr=10.0, max_epochs=2, steps_per_epoch=2,
                            grad_clip_norm=clip)
    opt = make_optimizer(model.parameters(), lr=1e-2, decay_lr=10.0, max_epochs=2,
                         steps_per_epoch=2, grad_clip_norm=clip)
    state, ref = tx.init(params), params
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    lrs = []
    for grads in _grad_trees(rng, params, 3):
        ref, state = update(grads, state, ref)
        for name, g in params_from_flax(grads).items():
            model.get_parameter(name).grad = g
        lrs.append(opt.lr())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-5)
    np.testing.assert_allclose(lrs, [1e-2, 1e-2, 1e-2 * 0.1 ** 0.5], rtol=1e-6)
    for name, r in params_from_flax(_np_tree(ref)).items():
        p, r = model.get_parameter(name).detach().numpy(), r.numpy()
        assert np.abs(p - r).max() <= OPT_RTOL * max(np.abs(r).max(), 1e-2), name


def test_msgpack_writer_matches_flax_bytes(tmp_path):
    """The port's params/extra_vars files are the bytes flax writes for the same
    trees, and flax reads them back leaf by leaf."""
    model = gw_model_from_summary(gw_train_summary())
    init_module(model, torch.Generator().manual_seed(0))
    params, extra = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    for name, tree in (("params", params), ("extra_vars", extra)):
        path = tmp_path / f"{name}.msgpack"
        write_msgpack(str(path), tree)
        data = path.read_bytes()
        assert data == flax.serialization.msgpack_serialize(tree)
        restored = flax.serialization.msgpack_restore(data)
        ref, out = (jax.tree_util.tree_leaves_with_path(t) for t in (tree, restored))
        assert [p for p, _ in ref] == [p for p, _ in out]
        for (p, a), (_, b) in zip(ref, out):
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b, err_msg=str(p))
    assert count_parameters(model) == 368004


def test_port_written_run_loads_into_jax(tmp_path):
    """A run written by the port (its own init, one train step so the
    BatchNorm statistics moved) gives JAX the port's predictives."""
    summary = gw_train_summary()
    model = gw_model_from_summary(summary)
    init_module(model, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    x, y, mask_c, mask_t, cond = _batch(rng, 2, 256, [3, 150])
    _port_step(model, x, y, mask_c, mask_t, cond)
    save_run_params(str(tmp_path), model)
    jm = jax_gw_model_from_summary(summary)
    template = jax.jit(lambda key: jm.init(key, x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t,
                                           condition=cond, train=False))(jax.random.PRNGKey(0))
    variables = {
        "params": flax.serialization.from_bytes(template["params"],
                                                (tmp_path / "params.msgpack").read_bytes()),
        **flax.serialization.from_bytes({"batch_stats": template["batch_stats"]},
                                        (tmp_path / "extra_vars.msgpack").read_bytes()),
    }
    out = jax.jit(jm.apply, static_argnames="train")(variables, x, y, x, mask_cntxt=mask_c,
                                                     mask_trgt=mask_t, condition=cond, train=False)
    model.eval()
    with torch.no_grad():
        t = model(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t, cond)))
    np.testing.assert_allclose(t.p_yCc.loc.numpy(), np.asarray(out.p_yCc.loc), atol=PRED_ATOL)
    np.testing.assert_allclose(t.p_yCc.scale.numpy(), np.asarray(out.p_yCc.scale), atol=PRED_ATOL)


def test_train_gw_on_cpu_writes_a_run_the_scorer_reads(tmp_path):
    summary = train_gw.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--n-test", "2",
                             "--out", str(tmp_path)])
    run_dir = tmp_path / "GW_time_cond_film_ctx192_d128" / "ConvCNP" / "run_0"
    for name in ("params.msgpack", "extra_vars.msgpack", "history.json", "summary.json"):
        assert (run_dir / name).exists(), name
    history = json.loads((run_dir / "history.json").read_text())
    assert [h["step"] for h in history] == [2] and np.isfinite(history[0]["train_loss"])
    assert json.loads((run_dir / "summary.json").read_text()) == summary
    assert summary["steps"] == 2 and np.isfinite(summary["test_ll_per_wf"])
    assert load_model(str(run_dir), "cpu").n_induced == 384


def test_trainer_steps_on_raw_batches():
    """train_step_cond splits with the trainer's generator and returns the
    loss and the gradients' global norm as 0-d tensors; eval_step is the
    per-function NPML loss of the eval-mode model on a split made with the
    given generator."""
    torch.manual_seed(0)
    model = ConvCNP(r_dim=8, density_induced=8, cnn_n_blocks=1, cnn_kernel_size=3, cond_dim=4)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=20),
                                 targets_getter=get_all_indcs)
    trainer = Trainer(model, CNPFLoss(), make_optimizer(model.parameters()), splitter,
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    x, y, _, _, cond = (torch.from_numpy(a) for a in _batch(rng, 3, 40, [0, 0, 0]))
    before = [p.detach().clone() for p in model.parameters()]
    metrics = trainer.train_step_cond(x, y, cond)
    assert metrics["loss"].shape == metrics["grad_norm"].shape == ()
    assert trainer.state.step == 1 and model.training
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
    losses = trainer.eval_step(x, y, torch.Generator().manual_seed(5), cond=cond)
    assert losses.shape == (3,) and not model.training
    batch = splitter(torch.Generator().manual_seed(5), x, y, condition=cond)
    with torch.no_grad():
        out = model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"], batch["mask_cntxt"],
                    batch["mask_trgt"], batch["condition"])
    ref = CNPFLoss(reduction=None)(out, batch["Y_trgt"], batch["mask_trgt"], train=False)
    assert torch.equal(losses, ref)
