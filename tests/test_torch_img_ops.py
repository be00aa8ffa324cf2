"""The image family's ops in the port against the JAX package on the same
numpy inputs and parameters: `AbsConv`, the 2-D `ResConvBlock` with one and
two conv layers, SAME and CIRCULAR padding, on odd and even canvases (eval
mode on perturbed BatchNorm statistics, and train mode with the statistics
it moves), the 2-D `CNN` in train mode with and without `remat` (each
gradient within 1e-4 of its leaf's largest magnitude; a bias that the next
train-mode BatchNorm cancels, whose gradient is rounding noise, within 1e-4
of the largest gradient's), `GaussianConv2d`,
`ResNormalizedConvBlock`, `ProbabilityConverter` and `clamp`; and the
flax <-> port checkpoint map of 2-D kernels. Tolerance 1e-5 absolute on
outputs of unit scale (float32 convolutions summed in other orders).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.ops import cnn as jcnn
from npf_gwwaveform_tpu.ops import probability as jprob
from npf_gwwaveform_tpu_torch.ops import cnn as tcnn
from npf_gwwaveform_tpu_torch.ops import probability as tprob
from npf_gwwaveform_tpu_torch.training.checkpoint import flax_from_params, params_from_flax

torch.set_num_threads(1)

ATOL = 1e-5
C = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _perturbed(tree, rng, scale=0.1):
    """Every leaf moved by scale * N(0, 1) (variances kept positive)."""
    def move(path, a):
        a = np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32)
        return np.abs(a) + 0.5 if path[-1].key == "var" else a
    return jax.tree_util.tree_map_with_path(move, tree)


def _canvas(rng, h, w, c=C, b=3):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("padding", ["SAME", "CIRCULAR"])
@pytest.mark.parametrize("hw", [(9, 9), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("y_dim", [1, 3])
def test_abs_conv_matches_jax(padding, hw, y_dim):
    rng = np.random.default_rng(0)
    x = np.abs(_canvas(rng, *hw, y_dim))
    jm = jcnn.AbsConv(kernel_size=5, padding=padding)
    v = jm.init(jax.random.PRNGKey(0), x)
    tm = tcnn.AbsConv(y_dim, 5, padding)
    tm.load_state_dict(params_from_flax(_np(v["params"])), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("padding", ["SAME", "CIRCULAR"])
@pytest.mark.parametrize("hw", [(9, 9), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("n_conv", [1, 2])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_res_conv_block_2d_matches_jax(padding, hw, n_conv, train):
    """Channel-last JAX block vs the channel-first port block, BatchNorm eps
    1e-2; train mode also moves the running statistics alike."""
    rng = np.random.default_rng(1)
    x = _canvas(rng, *hw)
    jm = jcnn.ResConvBlock(C, kernel_size=5, norm="batch", n_conv_layers=n_conv,
                           padding=padding, norm_eps=1e-2)
    v = jm.init(jax.random.PRNGKey(1), x, train=False)
    v = {"params": _perturbed(_np(v["params"]), rng),
         "batch_stats": _perturbed(_np(v["batch_stats"]), rng)}
    tm = tcnn.ResConvBlock(C, C, 5, "batch", n_conv, 1e-2, n_spatial=2, padding=padding)
    tm.load_state_dict(params_from_flax(v["params"], {"batch_stats": v["batch_stats"]}),
                       strict=True)
    tm.train(train)
    if train:
        ref, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        ref, new = jm.apply(v, x, train=False), None
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)
    if new is not None:
        stats = params_from_flax({}, {"batch_stats": _np(new["batch_stats"])})
        for k, t in tm.state_dict().items():
            if k in stats:
                np.testing.assert_allclose(t.numpy(), stats[k].numpy(), atol=1e-6, rtol=0,
                                           err_msg=k)


def _cnn_pair(remat):
    jm = jcnn.CNN(n_channels=C, n_blocks=2, kernel_size=3, norm="batch", padding="CIRCULAR",
                  block_kwargs={"n_conv_layers": 2, "norm_eps": 1e-2})
    tm = tcnn.CNN(C, 2, 3, "batch", 2, 1e-2, n_spatial=2, padding="CIRCULAR", remat=remat)
    return jm, tm


@pytest.mark.parametrize("remat", [False, True], ids=["stored", "remat"])
def test_cnn_2d_train_step_matches_jax(remat):
    """The 2-D CNN in train mode: output, the gradient of a squared sum with
    respect to every parameter, and the running statistics (moved once a
    step, also when the blocks are recomputed in the backward pass)."""
    rng = np.random.default_rng(2)
    x = _canvas(rng, 7, 6)
    jm, tm = _cnn_pair(remat)
    v = jm.init(jax.random.PRNGKey(2), x, train=False)
    params = _perturbed(_np(v["params"]), rng)
    tm.load_state_dict(params_from_flax(params, {"batch_stats": _np(v["batch_stats"])}),
                       strict=True)
    tm.train()

    def loss(p):
        out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, new)

    (_, (ref, new)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x))
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref_grads = params_from_flax(_np(grads))
    top = max(np.abs(g.numpy()).max() for g in ref_grads.values())
    for name, p in tm.named_parameters():
        g = ref_grads[name].numpy()
        # a bias the next train-mode BatchNorm cancels has a gradient of
        # rounding noise: held to the largest gradient's scale
        scale = np.abs(g).max() if np.abs(g).max() > 1e-3 * top else top
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-4 * scale, rtol=0, err_msg=name)
    stats = params_from_flax({}, {"batch_stats": _np(new["batch_stats"])})
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_gaussian_conv2d_matches_jax():
    rng = np.random.default_rng(3)
    x = _canvas(rng, 9, 10)
    jm = jcnn.GaussianConv2d(kernel_size=5)
    v = jm.init(jax.random.PRNGKey(0), x)
    params = {"weights_x": np.array([0.7], np.float32), "weights_y": np.array([1.3], np.float32)}
    tm = tcnn.GaussianConv2d(5)
    tm.load_state_dict({k: torch.from_numpy(a) for k, a in params.items()}, strict=True)
    assert set(_np(v["params"])) == set(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("padding", ["SAME", "CIRCULAR"])
def test_res_normalized_conv_block_matches_jax(padding):
    """Signal and confidence halves (confidence partly outside [0, 1], so
    that the clip acts), 2-D, channel-first in the port."""
    rng = np.random.default_rng(4)
    x = _canvas(rng, 8, 9, 2 * C)
    x[..., C:] = rng.uniform(-0.2, 1.2, x[..., C:].shape)
    jm = jcnn.ResNormalizedConvBlock(C, kernel_size=3, padding=padding)
    v = jm.init(jax.random.PRNGKey(5), x)
    params = _perturbed(_np(v["params"]), rng, 0.05)
    tm = tcnn.ResNormalizedConvBlock(C, C, 3, n_spatial=2, padding=padding)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jm.apply({"params": params}, x))
    np.testing.assert_allclose(got, ref, atol=ATOL * max(1.0, np.abs(ref).max()), rtol=0)


CONVERTERS = [
    dict(),
    dict(min_p=0.05, initial_probability=0.3, initial_temperature=2.0, initial_x=0.5),
    dict(activation="hard-sigmoid", is_train_bias=True, trainable_dim=3),
    dict(activation="leaky-hard-sigmoid", min_p=0.01, is_train_temperature=True,
         initial_temperature=3.0),
]


@pytest.mark.parametrize("kwargs", CONVERTERS, ids=["sigmoid", "min_p", "hard", "leaky"])
def test_probability_converter_matches_jax(kwargs):
    x = np.random.default_rng(5).standard_normal((4, 6, 3)).astype(np.float32) * 4
    jm = jprob.ProbabilityConverter(**kwargs)
    v = jm.init(jax.random.PRNGKey(0), x)
    tm = tprob.ProbabilityConverter(**kwargs)
    tm.load_state_dict({k: torch.tensor(np.asarray(a)) for k, a in
                        _np(v.get("params", {})).items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kwargs", [
    dict(minimum=-1.0, maximum=2.0),
    dict(minimum=0.1, maximum=0.9, is_leaky=True),
    dict(minimum=0.1, maximum=0.9, is_leaky=True, hard_min=0.0, hard_max=1.0),
    dict(maximum=0.5, hard_min=-0.25),
], ids=["plain", "leaky", "leaky hard", "hard min"])
def test_clamp_matches_jax(kwargs):
    x = np.random.default_rng(6).standard_normal((50,)).astype(np.float32) * 3
    got = tprob.clamp(torch.from_numpy(x), **kwargs).numpy()
    np.testing.assert_allclose(got, np.asarray(jprob.clamp(jnp.asarray(x), **kwargs)), atol=ATOL,
                               rtol=0)


def test_2d_kernels_round_trip_through_the_flax_layout():
    """HWIO [k, k, 1, C] and [1, 1, Cin, Cout] -> torch [C, 1, k, k] and
    [Cout, Cin, 1, 1] -> the same flax arrays."""
    rng = np.random.default_rng(7)
    x = _canvas(rng, 6, 6)
    jm = jcnn.ResConvBlock(C, kernel_size=3, norm="batch", n_conv_layers=2)
    v = jm.init(jax.random.PRNGKey(0), x, train=False)
    params, stats = _np(v["params"]), _np(v["batch_stats"])
    state = params_from_flax(params, {"batch_stats": stats})
    assert state["conv2_depthwise.weight"].shape == (C, 1, 3, 3)
    assert state["conv2_pointwise.weight"].shape == (C, C, 1, 1)
    back, extra = flax_from_params(state, [k for k in state if k.endswith((".mean", ".var"))])
    def flat(t):
        return {jax.tree_util.keystr(k): np.asarray(a)
                for k, a in jax.tree_util.tree_flatten_with_path(t)[0]}

    for tree, ref in ((back, params), (extra["batch_stats"], stats)):
        got, want = flat(tree), flat(ref)
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_flax_nn_is_the_reference():
    """The JAX CNN's 2-D depthwise stage is flax's grouped nn.Conv (the
    port's counterpart is a grouped torch conv2d)."""
    assert jcnn.depthwise_conv(3, True, "SAME", 1, None, "d", n_spatial=2, in_chan=C).__class__ \
        is nn.Conv
