"""Training every ConvCNP family against the JAX package: one
train step of a small model of each (additive conditioning, per-block
dilations, k=37, the UnetCNN, no conditioning, a short stand-in for the
2 s long waveforms with their stride of 1, their splitter and
`reproduce_gw.py`'s long-run learning rate and clip, and the
frequency-domain data, two channels, with FiLM and with no conditioning) through the port's
`Trainer` against JAX's `Trainer._loss_fn` on the same batch from the same
parameters; optax's clip where it does not bind; and the 2 s data at its
real size.

Bars, those of tests/test_torch_train.py, each with its reason there:
loss 1e-5 relative; each gradient 1e-4 of its leaf's max magnitude (the
BatchNorm-cancelled conv1 biases below that times their block's
conv1.pointwise weight gradient, on both sides); the updated BatchNorm
statistics 1e-5; the Adam update (clip included) 1e-5 of each leaf's
magnitude, given the same gradients: the port's, fed to optax. The global
norm the step reports 1e-4 relative, the gradients' own bar (measured:
1.8e-5, additive conditioning).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory, _unet_factory
from npf_gwwaveform_tpu.data.gw import GWWaveformGenerator as JaxGenerator
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu.training.optim import make_optimizer as jax_make_optimizer
from npf_gwwaveform_tpu.training.trainer import Trainer as JaxTrainer
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary, gw_train_summary
from npf_gwwaveform_tpu_torch.data.datasplit import GetRandomIndcs
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace, GWWaveformGenerator
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.score import make_eval_batch, run_generator
from npf_gwwaveform_tpu_torch.training import (
    Trainer, flax_from_params, make_optimizer, params_from_flax,
)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_ATOL = 1e-5
OPT_RTOL = 1e-5
NORM_RTOL = 1e-4
WAVE_ATOL = 5e-3  # tests/test_torch_gw.py's waveform bar, of the peak

# name: (JAX CNN factory, the port's CNN arguments, cond_mode or None,
# (duration, n_points), n_context, density, lr, clip[, mode]); the mode is
# "time" unless given
FAMILIES = {
    "additive": (_cnn_factory(2, kernel_size=5), dict(cnn_n_blocks=2, cnn_kernel_size=5),
                 "add", (1.0, 64), 16, 16, 1e-3, None),
    "dilated": (_cnn_factory(3, kernel_size=5, dilations=(1, 2, 4)),
                dict(cnn_n_blocks=3, cnn_kernel_size=5, cnn_dilations=(1, 2, 4)),
                "film", (1.0, 64), 16, 16, 1e-3, None),
    "k37": (_cnn_factory(2, kernel_size=37), dict(cnn_n_blocks=2, cnn_kernel_size=37),
            "film", (1.0, 64), 16, 16, 1e-3, None),
    "unet": (_unet_factory(3, kernel_size=5),
             dict(cnn_n_blocks=3, cnn_kernel_size=5, cnn_arch="unet"),
             "film", (1.0, 64), 16, 16, 1e-3, None),
    "unconditioned": (_cnn_factory(2, kernel_size=5), dict(cnn_n_blocks=2, cnn_kernel_size=5),
                      None, (1.0, 64), 16, 16, 1e-3, None),
    # the 2 s runs' data at 1/16 of their length: every sample of a 128-sample
    # generator, U{0..64} context points (half, as 1024 of 2048), k=37, and
    # the long runs' lr 3e-4 and clip 1.0 (which binds on this step)
    "long stand-in": (_cnn_factory(2, kernel_size=37), dict(cnn_n_blocks=2, cnn_kernel_size=37),
                      "film", (0.125, 128), 64, 32, 3e-4, 1.0),
    # amplitude and standardised phase on 64 frequencies (y_dim 2)
    "freq film": (_cnn_factory(2, kernel_size=5), dict(cnn_n_blocks=2, cnn_kernel_size=5),
                  "film", (1.0, 64), 16, 16, 1e-3, None, "freq_ap"),
    "freq unconditioned": (_cnn_factory(2, kernel_size=5), dict(cnn_n_blocks=2, cnn_kernel_size=5),
                           None, (1.0, 64), 16, 16, 1e-3, None, "freq_ap"),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _data(duration, n_points, n_context, seed, mode="time"):
    """(x, y, cond) numpy from the port's generator and the training
    splitter's context mask (one count U{0..n_context} for the batch),
    each drawn from a seed; a second batch element gets an empty context."""
    space = GWParameterSpace()
    g = torch.Generator().manual_seed(seed)
    theta = space.sample(3, g)
    gen = GWWaveformGenerator(duration=duration, sample_rate=1024.0)
    assert gen.n_time // n_points == (1 if duration != 1.0 else 1024 // n_points)
    x, y, cond = make_eval_batch(theta, gen, space, n_points, mode)
    mask_c = GetRandomIndcs(a=0.0, b=n_context)(g, 3, n_points)
    mask_c[1] = False
    assert mask_c.sum() > 0
    return (x.numpy(), y.numpy(), cond.numpy(), mask_c.numpy(),
            np.ones((3, n_points), bool))


def _bn_cancelled(name):
    return ".conv1." in name and name.endswith(".bias")


def _compare_grads(grads, ref_tree):
    ref = params_from_flax(ref_tree)
    assert set(ref) == set(grads)
    for name, g in grads.items():
        g, r = g.numpy(), ref[name].numpy()
        if _bn_cancelled(name):
            scale = np.abs(ref[name.rsplit(".", 2)[0] + ".pointwise.weight"].numpy()).max()
            assert np.abs(g).max() <= GRAD_RTOL * scale and np.abs(r).max() <= GRAD_RTOL * scale
            continue
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_train_step_matches_jax(family):
    factory, cnn_kw, cond_mode, (duration, n_points), n_context, density, lr, clip, *mode = (
        FAMILIES[family])
    mode = mode[0] if mode else "time"
    y_dim = 1 if mode == "time" else 2
    x, y, cond, mask_c, mask_t = _data(duration, n_points, n_context, seed=7, mode=mode)
    assert y.shape[-1] == y_dim
    cond_dim = 0 if cond_mode is None else 4
    jm = JaxConvCNP(y_dim=y_dim, x_dim=1, r_dim=16, density_induced=density, CNNFactory=factory,
                    cond_dim=cond_dim, cond_mode=cond_mode or "film")
    kw = dict(mask_cntxt=mask_c, mask_trgt=mask_t, train=True,
              **({"condition": cond} if cond_dim else {}))
    variables = _np_tree(jax.jit(lambda k: jm.init(k, x, y, x, **kw))(jax.random.PRNGKey(0)))
    # the optimizer reproduce_gw.py builds: 1562-step epochs of a 50,000-step run
    tx = jax_make_optimizer(lr=lr, decay_lr=10.0, max_epochs=32, steps_per_epoch=1562,
                            grad_clip_norm=clip)
    split = dict(X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y, mask_cntxt=mask_c, mask_trgt=mask_t)
    jt = JaxTrainer(jm, JaxCNPFLoss(), tx, splitter=lambda key, x_, y_: dict(split))
    (ref_loss, ref_vars), ref_grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        variables["params"], {"batch_stats": variables["batch_stats"]}, x, y,
        cond if cond_dim else None, jax.random.PRNGKey(1), jax.random.PRNGKey(2))
    ref_grads = _np_tree(ref_grads)

    tm = ConvCNP(y_dim=y_dim, r_dim=16, density_induced=density, cond_dim=cond_dim,
                 cond_mode=cond_mode or "film", **cnn_kw)
    tm.load_state_dict(params_from_flax(variables["params"],
                                        {"batch_stats": variables["batch_stats"]}))
    opt = make_optimizer(tm.parameters(), lr=lr, decay_lr=10.0, max_epochs=32,
                         steps_per_epoch=1562, grad_clip_norm=clip)
    seen = {}

    def splitter(generator, x_, y_, condition=None):
        batch = {k: torch.from_numpy(v) for k, v in split.items()}
        if condition is not None:
            batch["condition"] = condition
        seen["condition"] = condition
        return batch

    trainer = Trainer(tm, CNPFLoss(), opt, splitter)
    real_step, pre = opt.step, {}

    def step():  # the gradients the update starts from, before the clip
        pre.update({n: p.grad.clone() for n, p in tm.named_parameters()})
        return real_step()

    opt.step = step
    params0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    metrics = (trainer.train_step_cond(xt, yt, torch.from_numpy(cond)) if cond_dim
               else trainer.train_step(xt, yt))
    assert (seen["condition"] is None) == (cond_dim == 0)

    assert abs(metrics["loss"].item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    _compare_grads(pre, ref_grads)
    norm = float(optax.global_norm(ref_grads))
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=NORM_RTOL)
    stats = params_from_flax({}, {"batch_stats": _np_tree(ref_vars["batch_stats"])})
    for name, ref in stats.items():
        np.testing.assert_allclose(tm.get_buffer(name).numpy(), ref.numpy(), atol=STATS_ATOL,
                                   rtol=1e-5, err_msg=name)
    if clip is not None:  # the clip binds here, and scales the gradients in place
        assert norm > clip
        for n, p in tm.named_parameters():
            torch.testing.assert_close(p.grad, pre[n] * (clip / metrics["grad_norm"]))

    # the Adam update (and the clip) against optax's on the port's gradients
    p_tree, _ = flax_from_params(params0, [])
    g_tree, _ = flax_from_params(pre, [])
    updates, _ = tx.update(g_tree, tx.init(p_tree), p_tree)
    for name, r in params_from_flax(_np_tree(optax.apply_updates(p_tree, updates))).items():
        p, r = tm.get_parameter(name).detach().numpy(), r.numpy()
        assert np.abs(p - r).max() <= OPT_RTOL * max(np.abs(r).max(), 1e-2), name


@pytest.mark.parametrize("ratio", [0.999, 1.001])
def test_clip_just_below_and_above_its_norm_matches_optax(ratio):
    """Gradients whose global norm is 0.999 of `grad_clip_norm` (the clip
    must leave them as they are) and 1.001 of it (it must scale them), two
    updates, against optax's `clip_by_global_norm` then Adam."""
    rng = np.random.default_rng(5)
    model = ConvCNP(r_dim=8, density_induced=8, cnn_n_blocks=1, cnn_kernel_size=3, cond_dim=4)
    params, _ = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    trees = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                    params) for _ in range(2)]
    clip = 2.5
    trees = [jax.tree_util.tree_map(lambda a, t=t: a * np.float32(
        ratio * clip / float(optax.global_norm(t))), t) for t in trees]
    tx = jax_make_optimizer(lr=1e-2, decay_lr=10.0, max_epochs=2, steps_per_epoch=2,
                            grad_clip_norm=clip)
    opt = make_optimizer(model.parameters(), lr=1e-2, decay_lr=10.0, max_epochs=2,
                         steps_per_epoch=2, grad_clip_norm=clip)
    state, ref = tx.init(params), params
    for grads in trees:
        updates, state = tx.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)
        given = params_from_flax(grads)
        for name, g in given.items():
            model.get_parameter(name).grad = g.clone()
        norm = opt.step()
        assert (norm.item() < clip) == (ratio < 1)
        for name, g in given.items():  # in place: scaled where the clip binds
            scale = 1.0 if ratio < 1 else clip / norm.item()
            torch.testing.assert_close(model.get_parameter(name).grad, g * scale,
                                       rtol=1e-6, atol=0)
    for name, r in params_from_flax(_np_tree(ref)).items():
        p, r = model.get_parameter(name).detach().numpy(), r.numpy()
        assert np.abs(p - r).max() <= OPT_RTOL * max(np.abs(r).max(), 1e-2), name


def test_long_waveform_training_data_is_jax_data():
    """The 2 s runs' training data at its real size: a 2048-sample generator
    (2 s at 1024 Hz) kept whole (stride 1), as reproduce_gw.py's make_batch
    slices it, the training splitter's U{0..1024} contexts, and the
    1536-point grid of density 512."""
    summary = gw_train_summary(n_context=1024, density=512, cnn_kernel=37, duration=2.0,
                               n_points=2048, pallas=True, lr=3e-4, clip=1.0)
    gen = run_generator(summary)
    assert gen.n_time == 2048 and gen.n_time // summary["n_points"] == 1
    theta = GWParameterSpace().sample(2, torch.Generator().manual_seed(3))
    x, y, _ = make_eval_batch(theta, gen, GWParameterSpace(), summary["n_points"])
    jgen = JaxGenerator(duration=2.0, sample_rate=1024.0)
    _, h = jgen.time_domain(jnp.asarray(theta.numpy()))
    ref = np.asarray(h[..., -2048::1][..., :2048])
    assert y.shape == (2, 2048, 1) and x.shape == (2, 2048, 1)
    assert np.abs(y[..., 0].numpy() - ref).max() <= WAVE_ATOL
    np.testing.assert_allclose(x[0, :, 0].numpy(), np.linspace(-1, 1, 2048), atol=1e-6)
    counts = [GetRandomIndcs(a=0.0, b=summary["n_context"])(
        torch.Generator().manual_seed(s), 4, 2048).sum(dim=1) for s in range(20)]
    assert all(len(set(c.tolist())) == 1 and 0 <= c[0] <= 1024 for c in counts)
    assert gw_model_from_summary(summary).n_induced == 1536
