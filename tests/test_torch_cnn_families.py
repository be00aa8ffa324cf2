"""The grid CNNs and the conditioning the port gained for the other
time-domain GW runs, against the JAX package at a small width: per-block
dilations, `UnetCNN` (eval and train mode, with its BatchNorm statistics),
its linear upsampling at the grid ends, and additive conditioning in a small
ConvCNP.

Tolerances: 1e-5 absolute at op and module level (float32 on both sides;
the summation orders differ); for the whole small ConvCNP, 1e-5 of the
largest output magnitude (its float32 roundings scale with the outputs:
with FiLM, the path ported before, the same model sits 5e-6 of it from JAX).
The upsampling alone: 1e-6 (two roundings of a two-term weighted sum). Parameters come from a flax `init`, perturbed so
that biases and BatchNorm statistics are off their init values, and carried
over with `params_from_flax`; inputs are made with numpy from a seed.
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
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.ops.cnn import CNN, UnetCNN
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

ATOL = 1e-5
RESIZE_ATOL = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _perturbed(variables, rng, scale=0.3):
    """Random offsets on every leaf; BatchNorm variances kept positive."""
    out = jax.tree_util.tree_map(
        lambda a: a + scale * rng.normal(size=a.shape).astype(np.float32), _np_tree(variables))
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map(np.abs, out["batch_stats"])
    return out


def _load(module, variables):
    extra = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict(params_from_flax(variables["params"], extra), strict=True)
    return module


@pytest.mark.parametrize("dilations", [(1, 2, 4), (3, 1, 2)])
def test_dilated_cnn_matches_jax(dilations):
    """`_cnn_factory(dilations=...)`'s blocks, SAME padding d * (k // 2),
    on a grid shorter than the widest dilated kernel's reach."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 30, 8)).astype(np.float32)
    jm = _cnn_factory(3, kernel_size=7, dilations=dilations)(8)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm = _load(CNN(8, 3, 7, "batch", n_conv_layers=2, norm_eps=1e-3, dilations=dilations),
               variables).eval()
    assert tm.block_2.conv2_depthwise.dilation == (dilations[2],)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def test_cnn_refuses_a_dilation_count_other_than_its_blocks():
    with pytest.raises(ValueError):
        CNN(8, 3, 5, dilations=(1, 2))


def _unet_pair(rng, x, n_chan=8):
    """JAX `_unet_factory(5)` at `n_chan` channels (max 2 * n_chan) and the
    port's `UnetCNN` with the same perturbed variables."""
    jm = _unet_factory(5, kernel_size=5)(n_chan)
    variables = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False), rng,
                           scale=0.1)
    tm = _load(UnetCNN(n_chan, 5, 5, "batch", n_conv_layers=2, norm_eps=1e-3,
                       max_nchannels=2 * n_chan), variables)
    return jm, variables, tm


def test_unet_channels_follow_the_flax_tree():
    """Down blocks double the channels up to 2 * r_dim; each up block takes
    the upsampled input and its down block's output, concatenated."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 16, 8)).astype(np.float32)
    _, variables, tm = _unet_pair(rng, x)
    for i in range(5):
        block = variables["params"][f"block_{i}"]
        c_in = block["conv2_depthwise"]["kernel"].shape[-1]
        c_out = block["conv2_pointwise"]["kernel"].shape[-1]
        port = getattr(tm, f"block_{i}")
        assert (port.conv2_depthwise.in_channels, port.conv2_pointwise.out_channels) == (c_in, c_out)
    ins = [getattr(tm, f"block_{i}").conv2_depthwise.in_channels for i in range(5)]
    assert ins == [8, 16, 16, 32, 32]


def test_unet_eval_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 8)).astype(np.float32)
    jm, variables, tm = _unet_pair(rng, x)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 24, 8)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def test_unet_train_mode_matches_jax():
    """Batch statistics in every block, the running statistics moved as
    flax moves them, and the gradient of the input."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 32, 8)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=(3, 32, 8)).astype(np.float32)
    jm, variables, tm = _unet_pair(rng, x)

    def f(x):
        y, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (ref, ref_stats)), ref_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm.train()(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), atol=ATOL, rtol=1e-5)
    stats = params_from_flax({}, {"batch_stats": _np_tree(ref_stats)})
    for name, ref_buf in stats.items():
        np.testing.assert_allclose(tm.get_buffer(name).numpy(), ref_buf.numpy(), atol=ATOL,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("length", [1, 2, 3, 7, 96])
def test_unet_upsampling_is_jax_linear_resize(length):
    """`jax.image.resize(method="linear")` to twice the length renormalises
    its triangle kernel at the edges, which gives the edge inputs there:
    `F.interpolate(mode="linear", align_corners=False)` clamps to the same."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, length, 3)).astype(np.float32)  # channel-last, as JAX
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * length, 3), method="linear"))
    out = F.interpolate(torch.from_numpy(x).transpose(1, 2), size=2 * length, mode="linear",
                        align_corners=False).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, ref, atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_allclose(out[:, [0, -1]], x[:, [0, -1]], atol=RESIZE_ATOL, rtol=0)


def _batch(rng, B, N, counts):
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1)).copy()
    y = np.sin(8 * x + rng.uniform(0, 6, (B, 1, 1))).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for i, n in enumerate(counts):  # counts[0] == 0: an empty context
        mask_c[i, rng.permutation(N)[:n]] = True
    return x, y, mask_c, np.ones((B, N), bool)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cnn", ["flat", "unet"])
def test_small_convcnp_additive_conditioning_matches_jax(use_kernels, cnn):
    """r_dim 16, density 16, the condition embedding added to the grid
    CNN's output (no FiLM modules), with the flat CNN or the UnetCNN."""
    rng = np.random.default_rng(5)
    B, N = 3, 40
    x, y, mask_c, mask_t = _batch(rng, B, N, [0, 7, 30])
    cond = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    factory = _cnn_factory(2, kernel_size=5) if cnn == "flat" else _unet_factory(3, kernel_size=5)
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16, CNNFactory=factory,
                    cond_dim=4, cond_mode="add")
    args = [jnp.asarray(a) for a in (x, y, x)]
    kw = dict(mask_cntxt=jnp.asarray(mask_c), mask_trgt=jnp.asarray(mask_t),
              condition=jnp.asarray(cond), train=False)
    variables = _perturbed(jax.jit(lambda k: jm.init(k, *args, **kw))(jax.random.PRNGKey(0)), rng,
                           scale=0.1)
    assert "cond_gamma" not in variables["params"] and "cond_encoder" in variables["params"]
    out = jax.jit(lambda v: jm.apply(v, *args, **kw))(variables)
    ll_ref = -np.asarray(JaxCNPFLoss(reduction=None)(out, jnp.asarray(y), jnp.asarray(mask_t),
                                                     train=False))
    tm = _load(ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2 if cnn == "flat" else 3,
                       cnn_kernel_size=5, cnn_arch="cnn" if cnn == "flat" else "unet",
                       cond_dim=4, cond_mode="add", use_kernels=use_kernels), variables).eval()
    with torch.no_grad():
        t = tm(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t, cond)))
        ll = -CNPFLoss(reduction=None)(t, torch.from_numpy(y), torch.from_numpy(mask_t),
                                       train=False).numpy()
    for name in ("loc", "scale"):
        ref = np.asarray(getattr(out.p_yCc, name))
        np.testing.assert_allclose(getattr(t.p_yCc, name).numpy(), ref,
                                   atol=ATOL * np.abs(ref).max(), err_msg=name)
    np.testing.assert_allclose(ll, ll_ref, atol=1e-3, rtol=1e-5)
