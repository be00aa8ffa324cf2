"""Every time-domain ConvCNP family in bfloat16 compute against the JAX
package's bf16 modules, at small width: the UnetCNN's linear upsampling
(`upsample2_linear`) against `jax.image.resize`, the UnetCNN in eval and
train mode, the forward of a small ConvCNP of each family (additive
conditioning, per-block dilations, k=37, the UnetCNN, no conditioning, the
2 s runs' stride-1 data at 1/16 of their length) with the dtype of each
submodule's output, and one bf16 train step of each. JAX is applied op by op
so that every bf16 op rounds its result (tests/test_torch_bf16_slice.py:
XLA's excess precision); the port follows the ops.

Bars, each with its reason and the value measured on this CPU:
- the upsampling: bit-identical in bf16. Both sides sum 0.25 and 0.75 of
  bf16 inputs in float32, which is exact, and round once to bf16 (measured:
  identical at every length). In float32, 2^-22 of the input's largest
  magnitude: JAX rounds the sum once, the port each product and the sum
  (measured: 1.9e-6 at a largest input of 40, one ulp of the output).
- the UnetCNN, eval and train mode: 4 bf16 ulps of the output's largest
  magnitude, tests/test_torch_bf16_modules.py's block bar (a rounded value
  moves by one ulp where the two sides' f32 sums in other orders lie at a
  rounding boundary, and later blocks carry it along; measured: 0 ulps);
  its updated BatchNorm statistics 1e-5 (float32 on both sides).
- each family's forward: loc and scale within 4 ulps of their largest
  magnitude, and the per-waveform log-likelihood within 0.5 nats,
  tests/test_torch_bf16_slice.py's small-width bars, for the same reasons
  (measured: 0 ulps and at most 1.2e-4 nats in the 1 s families; 2.0 ulps
  in the long stand-in, where the LL moved 1.03 nats: see below).
- one train step: tests/test_torch_bf16_train.py's bars and reasons: loss
  1e-3 relative, each gradient 1e-1 of its leaf's max magnitude, the
  updated statistics 1e-4; the BatchNorm-cancelled conv1 biases (zero in
  exact arithmetic) below 1e-1 of their block's conv1.pointwise weight
  gradient on the port's side (measured: 1.2e-3; JAX's own bf16 reaches
  0.107 with additive conditioning, where it sums rounded bf16 rows).
- where those bars are missed, the value must lie within twice JAX's own
  distance from float32 to JAX's bf16 (GAP_SHARE): the two sides then run
  their f32 sums in other orders at a rounding boundary, and two
  independent bf16 roundings of one float32 computation sit up to about
  twice one's distance from it apart. Measured, as a share of that
  distance: the first SetConv's bias gradient with additive conditioning
  0.92 and without conditioning 0.90 (no FiLM follows it, so the blocks'
  BatchNorms all but cancel it and rounding dominates it); the long
  stand-in's loss 1.03 (4.5e-3 relative: on its 96-point grid the
  train-mode BatchNorm's fast variance E[x^2] - E[x]^2, flax's and the
  port's, cancels so far that the f32 sums' other order moves the
  normalised values by 5e-4 RMS) and its log-likelihood 0.03.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from npf_gwwaveform_tpu.configs import _cnn_factory, _unet_factory
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu_torch.data.datasplit import GetRandomIndcs
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace, GWWaveformGenerator
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.ops.cnn import UnetCNN, upsample2_linear
from npf_gwwaveform_tpu_torch.score import make_eval_batch
from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer, params_from_flax

torch.set_num_threads(1)

BF16 = torch.bfloat16
BLOCK_ULPS = 4
LL_ATOL = 0.5
STATS_ATOL = 1e-5
RESIZE_ULPS = 2.0 ** -22  # of the input's largest magnitude
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_STATS_ATOL = 1e-3, 1e-1, 1e-4
GAP_SHARE = 2.0

# name: (the JAX CNN factory in a compute dtype, the port's CNN arguments,
# cond_mode or None, (duration, n_points), n_context, density)
FAMILIES = {
    "additive": (lambda dt: _cnn_factory(2, dt, kernel_size=5),
                 dict(cnn_n_blocks=2, cnn_kernel_size=5), "add", (1.0, 64), 16, 16),
    "dilated": (lambda dt: _cnn_factory(3, dt, kernel_size=5, dilations=(1, 2, 4)),
                dict(cnn_n_blocks=3, cnn_kernel_size=5, cnn_dilations=(1, 2, 4)),
                "film", (1.0, 64), 16, 16),
    "k37": (lambda dt: _cnn_factory(2, dt, kernel_size=37),
            dict(cnn_n_blocks=2, cnn_kernel_size=37), "film", (1.0, 64), 16, 16),
    "unet": (lambda dt: _unet_factory(3, dt, kernel_size=5),
             dict(cnn_n_blocks=3, cnn_kernel_size=5, cnn_arch="unet"), "film", (1.0, 64), 16,
             16),
    "unconditioned": (lambda dt: _cnn_factory(2, dt, kernel_size=5),
                      dict(cnn_n_blocks=2, cnn_kernel_size=5), None, (1.0, 64), 16, 16),
    # the 2 s runs' stride-1 data at 1/16 of their length, half the points
    # context (as 1024 of 2048), k=37
    "long stand-in": (lambda dt: _cnn_factory(2, dt, kernel_size=37),
                      dict(cnn_n_blocks=2, cnn_kernel_size=37), "film", (0.125, 128), 64, 32),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _bf16(a):
    """numpy float32 values rounded to bf16 (still float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def ulps_of_max(out, ref):
    """max |out - ref| in bf16 ulps of max |ref| (2^-8 of it)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / (np.abs(ref).max() * 2.0 ** -8))


@pytest.mark.parametrize("length", [1, 2, 3, 7, 96])
def test_upsampling_is_jax_resize_in_bf16_and_float32(length):
    """Both grid ends included at every length: each edge output is its
    edge input (JAX renormalises its triangle kernel there)."""
    rng = np.random.default_rng(length)
    # values spread over eight binades, so that sums meet rounding boundaries
    x = (rng.normal(size=(2, length, 6)) * 2.0 ** rng.integers(-4, 4, (2, length, 6)))
    x = x.astype(np.float32)
    xb = _bf16(x)
    ref16 = jax.image.resize(jnp.asarray(xb, jnp.bfloat16), (2, 2 * length, 6), method="linear")
    assert ref16.dtype == jnp.bfloat16
    out16 = upsample2_linear(torch.from_numpy(xb).to(BF16).transpose(1, 2)).transpose(1, 2)
    assert out16.dtype == BF16
    np.testing.assert_array_equal(out16.float().numpy(), np.asarray(ref16, np.float32))
    ref32 = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * length, 6), method="linear"))
    out32 = upsample2_linear(torch.from_numpy(x).transpose(1, 2))
    atol = RESIZE_ULPS * np.abs(x).max()
    np.testing.assert_allclose(out32.transpose(1, 2).numpy(), ref32, atol=atol, rtol=0)
    np.testing.assert_allclose(out32.numpy(), F.interpolate(
        torch.from_numpy(x).transpose(1, 2), size=2 * length, mode="linear",
        align_corners=False).numpy(), atol=atol, rtol=0)
    np.testing.assert_array_equal(out32.transpose(1, 2).numpy()[:, [0, -1]], x[:, [0, -1]])


@pytest.mark.parametrize("train", [False, True])
def test_unet_bf16_matches_jax(train):
    """`_unet_factory(5)` at 8 channels (16 at most) in bf16 on a 24-point
    grid: two max-pools to 6 points and two upsamplings back, each meeting
    both grid ends, skips joined in bf16; BatchNorm in float32."""
    rng = np.random.default_rng(2)
    x = _bf16(rng.normal(size=(3, 24, 8)) * 2 + 0.3)
    jm = _unet_factory(5, jnp.bfloat16, kernel_size=5)(8)
    xj = jnp.asarray(x, jnp.bfloat16)
    variables = _np_tree(jm.init(jax.random.PRNGKey(1), xj, train=False))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    if train:
        ref, upd = jm.apply(variables, xj, train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, xj, train=False)
    assert ref.dtype == jnp.bfloat16
    tm = UnetCNN(8, 5, 5, "batch", n_conv_layers=2, norm_eps=1e-3, max_nchannels=16, dtype=BF16)
    extra = {k: v for k, v in variables.items() if k != "params"}
    tm.load_state_dict(params_from_flax(variables["params"], extra), strict=True)
    tm.train(train)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(BF16))
    assert out.dtype == BF16
    assert ulps_of_max(out.float().numpy(), np.asarray(ref, np.float32)) <= BLOCK_ULPS
    if train:
        stats = params_from_flax({}, {"batch_stats": _np_tree(upd["batch_stats"])})
        for name, buf in tm.named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=STATS_ATOL,
                                       err_msg=name)


def _family(family):
    """(JAX bf16 model, JAX float32 model, port bf16 model with JAX's
    parameters and perturbed statistics, numpy inputs (x, y, mask_c, mask_t,
    cond or None), variables) of a small family."""
    factory, cnn_kw, cond_mode, (duration, n_points), n_context, density = FAMILIES[family]
    space, g = GWParameterSpace(), torch.Generator().manual_seed(11)
    theta = space.sample(3, g)
    gen = GWWaveformGenerator(duration=duration, sample_rate=1024.0)
    x, y, cond = (t.numpy() for t in make_eval_batch(theta, gen, space, n_points))
    mask_c = GetRandomIndcs(a=0.0, b=n_context)(g, 3, n_points).numpy()
    mask_c[1] = False  # an empty context
    mask_t = np.ones((3, n_points), bool)
    cond_dim = 0 if cond_mode is None else 4
    jms = [JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=density,
                      CNNFactory=factory(dt), cond_dim=cond_dim, cond_mode=cond_mode or "film",
                      dtype=dt, fused_mlp=True) for dt in (jnp.bfloat16, None)]
    kw = dict(mask_cntxt=mask_c, mask_trgt=mask_t, **({"condition": cond} if cond_dim else {}))
    variables = _np_tree(jax.jit(lambda k: jms[0].init(k, x, y, x, train=False, **kw))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32), variables["batch_stats"])
    tm = ConvCNP(r_dim=16, density_induced=density, cond_dim=cond_dim,
                 cond_mode=cond_mode or "film", use_kernels=True, dtype=BF16, **cnn_kw)
    tm.load_state_dict(params_from_flax(variables["params"],
                                        {"batch_stats": variables["batch_stats"]}), strict=True)
    return (*jms, tm, (x, y, mask_c, mask_t, cond if cond_dim else None), variables)


def _near(port, ref16, ref32, bar):
    """|port - JAX bf16| (max) within `bar`, or within GAP_SHARE of JAX's
    own bf16-float32 distance (max) -> (passes, port's distance, JAX's)."""
    d, gap = float(np.abs(port - ref16).max()), float(np.abs(ref16 - ref32).max())
    return d <= bar or d <= GAP_SHARE * gap, d, gap


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_bf16_forward_matches_jax(family):
    """Eval mode: loc, scale and per-waveform log-likelihood, and the dtype
    of the condition embedding, of the grid CNN's output (the sum the
    additive embedding joins) and of the SetConv onto the targets."""
    jm, jm32, tm, (x, y, mask_c, mask_t, cond), variables = _family(family)
    kw = dict(mask_cntxt=jnp.asarray(mask_c), mask_trgt=jnp.asarray(mask_t), train=False,
              **({"condition": jnp.asarray(cond)} if cond is not None else {}))
    args = [jnp.asarray(a) for a in (x, y, x)]
    out, inter = jm.apply(variables, *args, capture_intermediates=True,
                          mutable=["intermediates"], **kw)
    out32 = jax.jit(lambda v: jm32.apply(v, *args, **kw))(variables)
    ll_ref, ll32 = (np.asarray(-JaxCNPFLoss(reduction=None)(o, jnp.asarray(y),
                                                             jnp.asarray(mask_t), train=False))
                    for o in (out, out32))
    names = ["induced_to_induced", "induced_to_trgt"] + (["cond_encoder"] if cond is not None
                                                         else [])
    flax_dtypes = {n: str(jnp.dtype(inter["intermediates"][n]["__call__"][0].dtype))
                   for n in names}
    seen = {}
    for n in names:
        tm.get_submodule(n).register_forward_hook(
            lambda m, a, o, n=n: seen.__setitem__(n, str(o.dtype).split(".")[-1]))
    tm.eval()
    with torch.no_grad():
        t = tm(*(torch.from_numpy(a) for a in (x, y, x)), mask_cntxt=torch.from_numpy(mask_c),
               mask_trgt=torch.from_numpy(mask_t),
               condition=None if cond is None else torch.from_numpy(cond))
        ll = -CNPFLoss(reduction=None)(t, torch.from_numpy(y), torch.from_numpy(mask_t),
                                       train=False).numpy()
    assert seen == flax_dtypes and set(seen.values()) == {"bfloat16"}
    for name in ("loc", "scale"):
        assert getattr(t.p_yCc, name).dtype == torch.float32
        assert ulps_of_max(getattr(t.p_yCc, name).numpy(),
                           np.asarray(getattr(out.p_yCc, name))) <= BLOCK_ULPS, name
    ok, d, gap = _near(ll, ll_ref, ll32, LL_ATOL)
    assert ok, (d, gap)


def _bn_cancelled(name):
    return ".conv1." in name and name.endswith(".bias")


def _jax_step(model, variables, x, y, mask_c, mask_t, cond, jit):
    args = [jnp.asarray(a) for a in (x, y, x)]
    kw = dict(mask_cntxt=jnp.asarray(mask_c), mask_trgt=jnp.asarray(mask_t), train=True,
              mutable=["batch_stats"], **({"condition": jnp.asarray(cond)} if cond is not None
                                          else {}))

    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               *args, **kw)
        return JaxCNPFLoss()(out, jnp.asarray(y), jnp.asarray(mask_t), train=True), upd

    step = jax.value_and_grad(loss_fn, has_aux=True)
    (loss, upd), grads = (jax.jit(step) if jit else step)(variables["params"])
    return float(loss), params_from_flax(_np_tree(grads)), upd


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_bf16_train_step_matches_jax(family):
    jm, jm32, tm, (x, y, mask_c, mask_t, cond), variables = _family(family)
    ref_loss, ref, upd = _jax_step(jm, variables, x, y, mask_c, mask_t, cond, jit=False)
    loss32, ref32, _ = _jax_step(jm32, variables, x, y, mask_c, mask_t, cond, jit=True)
    batch = {k: torch.from_numpy(v) for k, v in dict(
        X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y, mask_cntxt=mask_c, mask_trgt=mask_t).items()}
    if cond is not None:
        batch["condition"] = torch.from_numpy(cond)
    trainer = Trainer(tm, CNPFLoss(), make_optimizer(tm.parameters()), splitter=None)
    loss = trainer.loss_and_grads(batch).item()
    assert np.isfinite(loss)
    ok, d, gap = _near(np.float32(loss), np.float32(ref_loss), np.float32(loss32),
                       STEP_LOSS_RTOL * abs(ref_loss))
    assert ok, (loss, ref_loss, loss32)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(ref) == set(grads) and all(g.dtype == torch.float32 for g in grads.values())
    for name, g in grads.items():
        g, r = g.numpy(), ref[name].numpy()
        if _bn_cancelled(name):
            scale = np.abs(ref[name.rsplit(".", 2)[0] + ".pointwise.weight"].numpy()).max()
            assert np.abs(g).max() <= STEP_GRAD_RTOL * scale, name
        else:
            ok, d, gap = _near(g, r, ref32[name].numpy(), STEP_GRAD_RTOL * np.abs(r).max())
            assert ok, (name, d, gap, np.abs(r).max())
    stats = params_from_flax({}, {"batch_stats": _np_tree(upd["batch_stats"])})
    for name, r in stats.items():
        assert np.abs(tm.get_buffer(name).numpy() - r.numpy()).max() <= STEP_STATS_ATOL, name
