"""The image family's ops in bfloat16 compute against the JAX package's bf16
modules on the same inputs and parameters: `AbsConv` on a bf16 canvas (JAX
convolves in its input's dtype; its `dtype` field is unused) and the 2-D
`ResConvBlock` with two conv layers, `dtype=bfloat16`, SAME and CIRCULAR
padding, on odd and even canvases, in eval mode on perturbed BatchNorm
statistics and in train mode with the statistics it moves. BatchNorm has
no dtype in JAX: it normalises the bf16 input in float32 and returns
float32, which the next bf16 convolution rounds, as in the 1-D bf16 blocks
(tests/test_torch_bf16_modules.py). The block's input goes in as the
contiguous NCHW copy the 2-D CNN makes (`ops/cnn._channel_first`).

JAX is applied op by op (tests/test_torch_bf16_slice.py: XLA's excess
precision). Bars: the output within 4 bf16 ulps (2^-6) of its largest
magnitude, the small-width bar of tests/test_torch_bf16_slice.py (both
sides round at the same points and sum in float32 in other orders; a value
at a rounding boundary rounds one ulp apart, and a later convolution
carries it); the moved statistics 1e-5 (float32 on both sides, as
tests/test_torch_bf16_families.py holds the UnetCNN's). Measured on this
CPU: 0 ulps (bit-identical) in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.ops import cnn as jcnn
from npf_gwwaveform_tpu_torch.ops import cnn as tcnn
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
ULPS, STATS_ATOL = 4, 1e-5
C = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _ulps(got, ref):
    g, r = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(g - r).max() / (np.abs(r).max() * 2.0 ** -8))


def _perturbed(tree, rng, scale=0.1):
    def move(path, a):
        a = np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32)
        return np.abs(a) + 0.5 if path[-1].key == "var" else a
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.mark.parametrize("padding", ["SAME", "CIRCULAR"])
@pytest.mark.parametrize("y_dim", [1, 3])
def test_abs_conv_bf16(padding, y_dim):
    rng = np.random.default_rng(0)
    x = _bf16(np.abs(rng.standard_normal((3, 9, 12, y_dim))))
    jm = jcnn.AbsConv(kernel_size=5, padding=padding, dtype=JBF16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tcnn.AbsConv(y_dim, 5, padding)
    tm.load_state_dict(params_from_flax(_np(v["params"])), strict=True)
    ref = jm.apply(v, jnp.asarray(x, JBF16))
    assert ref.dtype == JBF16
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    assert _ulps(got.float().numpy(), ref) <= ULPS


@pytest.mark.parametrize("padding", ["SAME", "CIRCULAR"])
@pytest.mark.parametrize("hw", [(9, 9), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_res_conv_block_2d_bf16(padding, hw, train):
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal((3, *hw, C)) * 2 + 0.3)
    jm = jcnn.ResConvBlock(C, kernel_size=5, norm="batch", n_conv_layers=2, padding=padding,
                           norm_eps=1e-2, dtype=JBF16)
    xj = jnp.asarray(x, JBF16)
    v = jm.init(jax.random.PRNGKey(1), xj, train=False)
    v = {"params": _perturbed(_np(v["params"]), rng),
         "batch_stats": _perturbed(_np(v["batch_stats"]), rng)}
    tm = tcnn.ResConvBlock(C, C, 5, "batch", 2, 1e-2, BF16, n_spatial=2, padding=padding)
    tm.load_state_dict(params_from_flax(v["params"], {"batch_stats": v["batch_stats"]}),
                       strict=True)
    tm.train(train)
    if train:
        ref, new = jm.apply(v, xj, train=True, mutable=["batch_stats"])
    else:
        ref, new = jm.apply(v, xj, train=False), None
    assert ref.dtype == JBF16
    with torch.no_grad():
        got = tm(tcnn._channel_first(torch.from_numpy(x).to(BF16), 2)).permute(0, 2, 3, 1)
    assert got.dtype == BF16
    assert _ulps(got.float().numpy(), ref) <= ULPS
    if new is not None:
        stats = params_from_flax({}, {"batch_stats": _np(new["batch_stats"])})
        for k, t in tm.state_dict().items():
            if k in stats:
                np.testing.assert_allclose(t.numpy(), stats[k].numpy(), atol=STATS_ATOL, rtol=0,
                                           err_msg=k)
