"""The port's many-step trainer and its graphed entry points on the CPU, where
each runs the eager step: `Trainer.train_steps_generated` against single
steps, `Trainer.train_steps_scanned` against the JAX package's, the device
learning rate against optax's schedule, `predict`, `score_run` over a batch
of 256 and a short one, and the CUDA-graph helper's refusal off CUDA.

Tolerances, each with its reason:
- generated steps against single steps: bit-identical (the same eager step
  on the same generator, in the same order);
- scanned steps against JAX: each step's loss within 1e-4 relative and the
  final parameters within 1e-4 of each tensor's max magnitude: one step
  agrees to 1e-5 (float32 sums in another order, tests/test_torch_train.py),
  compounded over 4 steps. The conv1 biases of a BatchNorm block are held
  apart: the next train-mode BatchNorm subtracts the constant they add, so
  their gradient is zero in exact arithmetic and rounding noise in each
  package, which Adam turns into steps of about the learning rate with
  either sign. So each package's first-step gradient of each such bias must
  be rounding noise, at most 1e-5 of its block's conv1 pointwise weight
  gradient's max magnitude (chip_smoke.py's rule; measured 1e-7 to 6e-7 in
  both packages, float32 roundings of sums of that size), and each
  package's bias must stay within 1.1 times the sum of the run's learning
  rates of its initial value (Adam's bias-corrected step is at most 1.01
  learning rates over the first four updates);
- the learning rate within 1 ulp of optax's float32 value: both compute
  lr0 * gamma ** floor(count / steps_per_epoch) in float32, and the two
  libraries' `pow` may round its last bit differently;
- `predict` and `score_run` against the forward and `score_batch` they run:
  bit-identical.
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu.training.optim import make_optimizer as jax_make_optimizer
from npf_gwwaveform_tpu.training.state import create_train_state
from npf_gwwaveform_tpu.training.trainer import Trainer as JaxTrainer
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary, gw_train_summary
from npf_gwwaveform_tpu_torch.data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.score import (
    EVAL_BATCH, eval_splitter, load_model, run_generator, score_batch, score_run,
)
from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer, params_from_flax
from npf_gwwaveform_tpu_torch.training.checkpoint import save_run_params
from npf_gwwaveform_tpu_torch.utils.cuda_graph import StepGraph
from npf_gwwaveform_tpu_torch.utils.init import init_module

torch.set_num_threads(1)

SCAN_LOSS_RTOL = 1e-4
SCAN_PARAM_RTOL = 1e-4
BN_CANCEL_RTOL = 1e-5
B, N = 3, 40


def _small_model(cond_dim=4, seed=0):
    model = ConvCNP(r_dim=8, density_induced=8, cnn_n_blocks=1, cnn_kernel_size=3,
                    cond_dim=cond_dim)
    init_module(model, torch.Generator().manual_seed(seed))
    return model


def _trainer(model, seed=0, splitter=None, **opt):
    splitter = splitter or CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=20),
                                             targets_getter=get_all_indcs)
    return Trainer(model, CNPFLoss(), make_optimizer(model.parameters(), **opt), splitter,
                   generator=torch.Generator().manual_seed(seed))


def _sample(generator):
    """A batch of phase-shifted sines drawn from `generator`: (x, y, cond)."""
    x = torch.linspace(-1, 1, N)[None, :, None].expand(B, N, 1)
    phase = 6 * torch.rand((B, 1, 1), generator=generator)
    cond = 2 * torch.rand((B, 4), generator=generator) - 1
    return x, 0.3 * torch.sin(8 * x + phase) * (1 + 0.2 * cond[:, None, :1]), cond


def test_generated_steps_equal_single_steps():
    """Six generated steps against six `train_step_cond` calls from the same
    state: losses, parameters, BatchNorm statistics and the generator after."""
    many, single = _trainer(_small_model()), _trainer(_small_model())
    losses = many.train_steps_generated(_sample, 6)
    ref = [single.train_step_cond(*_sample(single.state.generator))["loss"] for _ in range(6)]
    assert losses.shape == (6,) and torch.equal(losses, torch.stack(ref))
    assert many.state.step == single.state.step == 6
    assert many.state.count.item() == single.state.count.item() == 6
    for (name, a), (_, b) in zip(many.model.state_dict().items(),
                                 single.model.state_dict().items()):
        assert torch.equal(a, b), name
    assert torch.equal(many.state.generator.get_state(), single.state.generator.get_state())


def _bn_cancelled(name):
    """conv1's biases in a BatchNorm block: the next train-mode BatchNorm
    subtracts the per-channel constant they add."""
    return ".conv1." in name and name.endswith(".bias")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def test_scanned_steps_match_jax():
    """Four steps on stacked numpy batches from JAX's init, with a splitter
    that returns fixed masks (an empty context among them) in both packages
    and a staircase schedule of two steps an epoch, so that the learning
    rate drops inside the run."""
    rng = np.random.default_rng(0)
    n = 4
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1))
    xs = np.broadcast_to(x, (n, B, N, 1)).copy()
    ys = (0.3 * np.sin(8 * xs + rng.uniform(0, 6, (n, B, 1, 1)))).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for i, c in enumerate([0, 7, 30]):
        mask_c[i, rng.permutation(N)[:c]] = True
    mask_t = np.ones((B, N), bool)
    opt = dict(lr=1e-2, decay_lr=10.0, max_epochs=2, steps_per_epoch=2)

    def jax_split(key, x, y):
        return dict(X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y, mask_cntxt=jnp.asarray(mask_c),
                    mask_trgt=jnp.asarray(mask_t))

    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, kernel_size=5))
    tx = jax_make_optimizer(**opt)
    jt = JaxTrainer(jm, JaxCNPFLoss(), tx, splitter=jax_split)
    state = create_train_state(jm, tx, jax_split(None, xs[0], ys[0]), seed=0)
    init = params_from_flax(_np_tree(state.params), _np_tree(state.extra_vars))
    (_, _), jax_grads = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        state.params, state.extra_vars, jnp.asarray(xs[0]), jnp.asarray(ys[0]), None, None,
        jax.random.PRNGKey(0))
    jax_grads = params_from_flax(_np_tree(jax_grads))
    state, ref_losses = jt.train_steps_scanned(state, jnp.asarray(xs), jnp.asarray(ys))
    ref_params = params_from_flax(_np_tree(state.params))
    lr_sum = sum(opt["lr"] * 0.1 ** (0.5 * (k // 2)) for k in range(n))

    def split(generator, x, y, condition=None):
        return dict(X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y,
                    mask_cntxt=torch.from_numpy(mask_c), mask_trgt=torch.from_numpy(mask_t))

    model = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5)
    model.load_state_dict(init)
    first = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5)
    first.load_state_dict(init)
    _trainer(first, splitter=split, **opt).loss_and_grads(
        split(None, torch.from_numpy(xs[0]), torch.from_numpy(ys[0])))
    grads = {n: p.grad for n, p in first.named_parameters()}
    for name in filter(_bn_cancelled, grads):
        scale_name = name.rsplit(".", 2)[0] + ".pointwise.weight"
        for g in (grads, jax_grads):
            ratio = (g[name].abs().max() / g[scale_name].abs().max()).item()
            assert ratio <= BN_CANCEL_RTOL, (name, ratio)
    trainer = _trainer(model, splitter=split, **opt)
    losses = trainer.train_steps_scanned(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=SCAN_LOSS_RTOL)
    assert trainer.state.step == n
    for name, ref in ref_params.items():
        p, r = model.get_parameter(name).detach().numpy(), ref.numpy()
        if _bn_cancelled(name):  # zero gradient: noise, held above
            p0 = init[name].numpy()
            assert max(np.abs(p - p0).max(), np.abs(r - p0).max()) <= 1.1 * lr_sum, name
            continue
        assert np.abs(p - r).max() <= SCAN_PARAM_RTOL * np.abs(r).max(), name


def test_device_learning_rate_matches_optax_schedule():
    """The flagship's schedule (1e-3, x10 over 128 epochs of 1562 steps) at
    update counts 0..3 epochs, and one update's learning rate through Adam."""
    spe, epochs = 1562, 128
    opt = make_optimizer(_small_model().parameters(), lr=1e-3, decay_lr=10.0, max_epochs=epochs,
                         steps_per_epoch=spe)
    ref = optax.exponential_decay(1e-3, spe, opt.gamma, staircase=True)
    counts = np.arange(3 * spe + 1)
    got = opt.schedule(torch.from_numpy(counts)).numpy()
    want = np.asarray(ref(jnp.asarray(counts, jnp.int32)), np.float32)
    assert got.dtype == want.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 1, (counts[ulps.argmax()], got[ulps.argmax()], want[ulps.argmax()])
    assert len(np.unique(want)) == 4  # three decays inside the range
    opt.count.fill_(2 * spe)
    assert opt.lr() == float(got[2 * spe])
    for p in opt.adam.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    opt.step()
    assert opt.adam.param_groups[0]["lr"].item() == float(got[2 * spe])
    assert opt.count.item() == 2 * spe + 1


def test_predict_is_the_eval_forward():
    trainer = _trainer(_small_model())
    trainer.train_steps_generated(_sample, 1)  # BatchNorm statistics moved
    x, y, cond = _sample(torch.Generator().manual_seed(3))
    batch = trainer.splitter(torch.Generator().manual_seed(4), x, y, condition=cond)
    out = trainer.predict(batch)
    assert not trainer.model.training
    with torch.no_grad():
        ref = trainer.model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                            batch["mask_cntxt"], batch["mask_trgt"], batch["condition"])
    assert torch.equal(out.p_yCc.loc, ref.p_yCc.loc)
    assert torch.equal(out.p_yCc.scale, ref.p_yCc.scale)


def test_score_run_batches_equal_a_loop_of_score_batch(tmp_path):
    """n_test = 516 (two batches of 256; the 4 left over are not scored,
    as `reproduce_gw.py` scores whole batches) on a narrow-grid run
    (density 8, kernel 3) written by the port: per waveform, the scores of
    `score_batch` on the same generator in the same order."""
    summary = {**gw_train_summary(density=8), "cnn_kernel_size": 3}
    model = gw_model_from_summary(summary)
    init_module(model, torch.Generator().manual_seed(5))
    save_run_params(str(tmp_path), model)
    (tmp_path / "summary.json").write_text(json.dumps(summary))
    n_test, n, seed = 2 * EVAL_BATCH + 4, 2 * EVAL_BATCH, 2
    out = score_run(str(tmp_path), n_test, device="cpu", seed=seed)
    model = load_model(str(tmp_path), "cpu")
    gen, space = run_generator(summary), GWParameterSpace()
    generator = torch.Generator().manual_seed(seed)
    thetas = space.sample(n, generator)
    parts = []
    with torch.inference_mode():
        for i in (0, EVAL_BATCH):
            parts.append(score_batch(model, eval_splitter(summary["n_context"]), generator,
                                     thetas[i:i + EVAL_BATCH], gen, space)[:3])
    for key, ref in zip(("ll", "mismatch", "mismatch_zdraw"), zip(*parts)):
        np.testing.assert_array_equal(out[key], torch.cat(ref).numpy(), err_msg=key)
    np.testing.assert_array_equal(out["theta"], thetas.numpy())
    assert out["n"] == n


def test_capture_refuses_cpu_model_and_generator():
    """No CUDA graph of a CPU model or with a CPU generator: an error, never a
    quiet eager run."""
    model = _small_model()
    with pytest.raises(ValueError, match="not on CUDA"):
        StepGraph(lambda: None, model=model)
    with pytest.raises(ValueError, match="generator 0 is on cpu"):
        StepGraph(lambda: None, generators=[torch.Generator()])
    with pytest.raises(ValueError, match="input 0 is on cpu"):
        StepGraph(lambda t: t, inputs=[torch.zeros(2)])
    trainer = _trainer(model)
    with pytest.raises(ValueError, match="not on CUDA"):
        trainer.generated_graph(_sample)
