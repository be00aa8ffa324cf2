"""The port's modules against the JAX package's, on the same numpy inputs with
the same parameters (a flax `init`, carried over with `params_from_flax`).

Tolerances: 1e-5 absolute at op level (float32 on both sides, summation
order differs); masks are compared for equality. Init schemes: the empirical
std of each port layer's draw within 5% of the JAX scheme's draw at the same
shape (at least 16k entries each: the sampling error of a std is ~1%).
"""

import flax
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
import npf_gwwaveform_tpu.data.datasplit as jax_datasplit
from npf_gwwaveform_tpu.data.datasplit import exact_topn_mask as jax_exact_topn_mask
from npf_gwwaveform_tpu.distributions import NormalDiag as JaxNormalDiag
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.losses import NPFOutput as JaxNPFOutput
from npf_gwwaveform_tpu.ops.cnn import ResConvBlock as JaxResConvBlock
from npf_gwwaveform_tpu.ops.encoders import SinusoidalEncodings as JaxSinusoidalEncodings
from npf_gwwaveform_tpu.ops.mlp import MLP as JaxMLP
from npf_gwwaveform_tpu.ops.setconv import SetConv as JaxSetConv
from npf_gwwaveform_tpu.utils import helpers as jax_helpers
from npf_gwwaveform_tpu.utils import init as jax_init
from npf_gwwaveform_tpu_torch.data import datasplit
from npf_gwwaveform_tpu_torch.data.datasplit import GetRandomIndcs, exact_topn_mask
from npf_gwwaveform_tpu_torch.distributions import NormalDiag
from npf_gwwaveform_tpu_torch.losses import CNPFLoss, NPFOutput
from npf_gwwaveform_tpu_torch.ops.cnn import CNN, BatchNorm, ResConvBlock
from npf_gwwaveform_tpu_torch.ops.encoders import SinusoidalEncodings
from npf_gwwaveform_tpu_torch.ops.mlp import MLP
from npf_gwwaveform_tpu_torch.ops.setconv import SetConv
from npf_gwwaveform_tpu_torch.score import eval_splitter
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax, read_msgpack
from npf_gwwaveform_tpu_torch.utils import helpers
from npf_gwwaveform_tpu_torch.utils import init as winit
from npf_gwwaveform_tpu_torch.utils.helpers import linspace, masked_softmax

torch.set_num_threads(1)

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _load(module, variables):
    extra = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict(params_from_flax(_np_tree(variables["params"]), _np_tree(extra)),
                           strict=True)
    return module.eval()


def _perturb(tree, rng, scale=0.3):
    """Random offsets on every leaf, so BatchNorm statistics and biases are
    not at their init values."""
    return jax.tree_util.tree_map(
        lambda a: a + scale * rng.normal(size=a.shape).astype(np.float32), _np_tree(tree))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", [
    dict(out=2, hidden=16, layers=4, inp=16, res=False),  # decoder shape, narrow
    dict(out=5, hidden=3, layers=3, inp=7, res=True),  # hidden clamped up to min(in, out)
    dict(out=12, hidden=12, layers=1, inp=4, res=False),  # no hidden stack
])
def test_mlp_matches_jax(cfg, fused):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 9, cfg["inp"])).astype(np.float32)
    jm = JaxMLP(cfg["out"], hidden_size=cfg["hidden"], n_hidden_layers=cfg["layers"],
                is_res=cfg["res"])
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = _load(MLP(cfg["inp"], cfg["out"], hidden_size=cfg["hidden"],
                   n_hidden_layers=cfg["layers"], is_res=cfg["res"], fused=fused), variables)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def _setconv_inputs(seed, B=2, K=20, Q=30, C=3):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.uniform(-1, 1, (B, K, 1)), axis=1).astype(np.float32)
    queries = rng.uniform(-1.5, 1.5, (B, Q, 1)).astype(np.float32)
    values = rng.normal(size=(B, K, C)).astype(np.float32)
    mask = rng.uniform(size=(B, K)) > 0.4
    mask[1] = False  # an empty context row
    return keys, queries, values, mask


@pytest.mark.parametrize("use_kernel", [False, True])
def test_setconv_matches_jax(use_kernel):
    keys, queries, values, mask = _setconv_inputs(1)
    jm = JaxSetConv(out_channels=6, rbf_kwargs=dict(max_dist=0.05))
    args = tuple(jnp.asarray(a) for a in (keys, queries, values, mask))
    variables = jm.init(jax.random.PRNGKey(0), *args)
    ref = np.asarray(jm.apply(variables, *args))
    tm = _load(SetConv(values.shape[-1], 6, use_kernel=use_kernel), variables)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (keys, queries, values, mask))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("n_conv_layers,norm", [(1, None), (2, "batch")])
def test_res_conv_block_matches_jax(n_conv_layers, norm):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 21, 6)).astype(np.float32)
    jm = JaxResConvBlock(6, kernel_size=5, norm=norm, n_conv_layers=n_conv_layers)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = _perturb(variables, rng)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables.get("batch_stats", {}))
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm = _load(ResConvBlock(6, 6, 5, norm, n_conv_layers), variables)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


def test_cnn_eval_batchnorm_matches_jax():
    """`_cnn_factory` blocks (two depthwise-separable convs, BatchNorm eps
    1e-3, running statistics) at a small width."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 8)).astype(np.float32)
    jm = _cnn_factory(2, kernel_size=7)(8)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = _perturb(variables, rng)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm = _load(CNN(8, 2, 7, "batch", n_conv_layers=2, norm_eps=1e-3), variables)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("out_dim,x_dim", [(64, 1), (8, 2)])
def test_sinusoidal_encodings_match_jax(out_dim, x_dim):
    x = np.random.default_rng(4).uniform(-1, 1, (3, 17, x_dim)).astype(np.float32)
    ref = np.asarray(JaxSinusoidalEncodings(out_dim).apply({}, jnp.asarray(x)))
    out = SinusoidalEncodings(out_dim)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_normal_log_prob_and_npml_match_jax():
    rng = np.random.default_rng(5)
    loc = rng.normal(size=(1, 4, 30, 1)).astype(np.float32)
    scale = rng.uniform(0.01, 2.0, (1, 4, 30, 1)).astype(np.float32)
    y = rng.normal(size=(4, 30, 1)).astype(np.float32)
    mask = rng.uniform(size=(4, 30)) > 0.2
    jout = JaxNPFOutput(JaxNormalDiag(jnp.asarray(loc), jnp.asarray(scale)), None, None, None)
    tout = NPFOutput(NormalDiag(torch.from_numpy(loc), torch.from_numpy(scale)))
    np.testing.assert_allclose(
        tout.p_yCc.log_prob(torch.from_numpy(y)).numpy(),
        np.asarray(jout.p_yCc.log_prob(jnp.asarray(y))), rtol=1e-6, atol=1e-4)
    for train in (True, False):  # CNPF loss at train, NPML at eval
        ref = np.asarray(JaxCNPFLoss(reduction=None)(jout, jnp.asarray(y), jnp.asarray(mask),
                                                     train=train))
        out = CNPFLoss(reduction=None)(tout, torch.from_numpy(y), torch.from_numpy(mask),
                                       train=train).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-3)


def test_masked_softmax_matches_jax_and_zeroes_empty_rows():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 10
    mask = rng.uniform(size=(3, 5, 11)) > 0.5
    mask[1, 2] = False
    ref = np.asarray(jax_helpers.masked_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    out = masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.all(out[1, 2] == 0.0)


def test_masked_reductions_match_jax():
    rng = np.random.default_rng(9)
    t = rng.normal(size=(2, 3, 7, 4)).astype(np.float32)
    mask = rng.uniform(size=(2, 3, 7)) > 0.5
    mask[0, 1] = False  # empty: the masked mean is zero
    for name in ("masked_sum", "masked_mean"):
        ref = np.asarray(getattr(jax_helpers, name)(jnp.asarray(t), jnp.asarray(mask)))
        out = getattr(helpers, name)(torch.from_numpy(t), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL)
    assert np.all(out[0, 1] == 0.0)
    for dim in (1, 2, 4):
        np.testing.assert_allclose(
            helpers.sum_from_nth_dim(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_helpers.sum_from_nth_dim(jnp.asarray(t), dim)), atol=ATOL)


@pytest.mark.parametrize("shared_scores", [False, True])
def test_exact_topn_mask_is_bit_identical(shared_scores):
    """Same scores, same counts -> the same mask, with ties injected across
    the count boundary (the lexicographic (value, index) tie-break)."""
    rng = np.random.default_rng(7)
    B, N, ub = 64, 256, 192
    scores = rng.uniform(size=(1 if shared_scores else B, N)).astype(np.float32)
    scores = np.round(scores * 64) / 64  # ~4 equal values per level
    scores[:, 10:20] = scores[:, 5:6]  # a long run of equal scores
    n = rng.integers(0, ub + 1, size=(B, 1)).astype(np.int32)
    n[:4, 0] = [0, 1, ub, ub - 1]
    ref = np.asarray(jax_exact_topn_mask(jnp.asarray(scores), jnp.asarray(n), ub, B))
    out = exact_topn_mask(torch.from_numpy(scores), torch.from_numpy(n).long(), ub, B).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out.sum(-1) == n[:, 0]).all()


@pytest.mark.parametrize("lo,hi,num", [(-1.5, 1.5, 384), (-1.0, 1.0, 256), (-1.5, 1.5, 48)])
def test_linspace_matches_jnp(lo, hi, num):
    """Bit-identical to jnp.linspace's arithmetic evaluated op by op; XLA's
    fused CPU kernel for jnp.linspace itself rounds some points differently,
    so against it the bar is two float32 ulps of the grid's magnitude (the
    largest difference seen)."""
    out = linspace(lo, hi, num).numpy()
    div = num - 1
    step = jnp.arange(div, dtype=jnp.float32) / jnp.float32(div)
    op_by_op = np.asarray(jnp.float32(lo) * (1 - step) + jnp.float32(hi) * step)
    np.testing.assert_array_equal(out[:-1], op_by_op)
    assert out[-1] == np.float32(hi)
    ref = np.asarray(jnp.linspace(lo, hi, num, dtype=jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 * np.spacing(np.float32(max(abs(lo), hi))))


def test_msgpack_reader_matches_flax(tmp_path):
    """Every msgpack type flax writes for a state tree, decoded leaf by leaf."""
    rng = np.random.default_rng(8)
    tree = {
        "a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
              "bias": np.arange(4, dtype=np.int32)},
        "big": rng.normal(size=(70, 40)).astype(np.float32),  # bin32-sized payload
        "flags": np.array([True, False]),
        "scalar_arr": np.asarray(2.5, np.float64),
        "nested": {str(i): {"w": np.full((i + 1,), i, np.float32)} for i in range(20)},
        "meta": {"name": "x" * 40, "n": 300, "neg": -7, "big_int": 2**40, "f": 1.5,
                 "none": None, "yes": True, "items": [1, "two", 3.0]},
    }
    path = tmp_path / "state.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    ref = flax.serialization.msgpack_restore(path.read_bytes())
    out = read_msgpack(str(path))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    out_leaves = jax.tree_util.tree_leaves_with_path(out)
    assert [p for p, _ in out_leaves] == [p for p, _ in ref_leaves]
    for (p, a), (_, b) in zip(out_leaves, ref_leaves):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b, err_msg=str(p))
        else:
            assert a == b and type(a) is type(b), p


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics over (B, L) with flax's fast biased variance, the
    normalisation in flax's order, gradients through the statistics, and the
    running buffers moved with momentum 0.9 (the biased variance included)."""
    rng = np.random.default_rng(10)
    x = (rng.normal(size=(4, 33, 6)) * 3 + 1.5).astype(np.float32)  # [B, L, C]
    g = rng.normal(size=x.shape).astype(np.float32)
    jm = flax.linen.BatchNorm(momentum=0.9, epsilon=1e-3)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False),
                         rng)
    variables["batch_stats"]["var"] = np.abs(variables["batch_stats"]["var"])

    def f(params, x):
        y, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (ref_y, ref_stats)), (ref_dp, ref_dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    bn = _load(BatchNorm(6, eps=1e-3), variables).train()
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g).transpose(1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().transpose(1, 2).numpy(), np.asarray(ref_y), atol=ATOL)
    np.testing.assert_allclose(xt.grad.transpose(1, 2).numpy(), np.asarray(ref_dx), atol=ATOL)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(ref_dp["scale"]), atol=ATOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(ref_dp["bias"]), atol=ATOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(ref_stats[name]),
                                   atol=ATOL, rtol=1e-5)
    bn.eval()  # eval mode reads the buffers it just moved
    ref_eval = jm.apply({"params": variables["params"], "batch_stats": ref_stats}, jnp.asarray(x),
                        use_running_average=True)
    with torch.no_grad():
        out = bn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, np.asarray(ref_eval), atol=ATOL)


@pytest.mark.parametrize("is_indep_n", [False, True])
def test_get_random_indcs_matches_jax_with_injected_draws(monkeypatch, is_indep_n):
    """The same count(s) and scores, injected into both splitters, give the
    same mask; the default draws one count for the whole batch, as JAX's."""
    rng = np.random.default_rng(11)
    B, N, b = 16, 256, 192
    scores = rng.uniform(size=(B, N)).astype(np.float32)
    n = rng.integers(0, b + 1, size=(B, 1) if is_indep_n else ()).astype(np.int32)
    shapes = {}

    def fake_randint(*args, **kw):
        shape = kw.get("size", args[2] if len(args) > 2 else args[1])
        shapes["torch"] = tuple(shape)
        return torch.from_numpy(np.asarray(n, np.int64)).reshape(shape)

    monkeypatch.setattr(datasplit.torch, "randint", fake_randint)
    monkeypatch.setattr(datasplit.torch, "rand", lambda *a, **kw: torch.from_numpy(scores))
    getter = GetRandomIndcs(a=0.0, b=b) if not is_indep_n else GetRandomIndcs(0.0, b, True)
    out = getter(torch.Generator(), B, N).numpy()

    def jax_randint(key, shape, lo, hi):
        shapes["jax"] = tuple(shape)
        return jnp.asarray(n).reshape(shape)

    monkeypatch.setattr(jax_datasplit.jax.random, "randint", jax_randint)
    monkeypatch.setattr(jax_datasplit.jax.random, "uniform", lambda *a, **kw: jnp.asarray(scores))
    ref = np.asarray(jax_datasplit.GetRandomIndcs(a=0.0, b=b, is_indep_n=is_indep_n)(
        jax.random.PRNGKey(0), B, N))
    np.testing.assert_array_equal(out, ref)
    assert shapes["torch"] == shapes["jax"] == ((B, 1) if is_indep_n else ())
    assert GetRandomIndcs().is_indep_n is False


def test_eval_splitter_masks_unchanged():
    """The scorer's splitter draws one count per waveform, then the scores,
    from its generator: the masks are those draws' exact_topn_mask, bit for bit."""
    B, N, b = 8, 256, 192
    batch = eval_splitter(b)(torch.Generator().manual_seed(3), torch.zeros(B, N, 1),
                             torch.zeros(B, N, 1))
    g = torch.Generator().manual_seed(3)
    n = torch.randint(0, b + 1, (B, 1), generator=g)
    scores = torch.rand((B, N), generator=g)
    assert torch.equal(batch["mask_cntxt"], exact_topn_mask(scores, n, b, B))


def _jax_std(init, shape):
    return float(np.std(np.asarray(init(jax.random.PRNGKey(1), shape, jnp.float32))))


@pytest.mark.parametrize("realized", [False, True])
def test_init_schemes_match_jax(realized):
    """Each port layer's initial weights against the JAX scheme it stands
    for, at the same (flax) shape; biases start at zero."""
    jax_init.set_realized_init(realized)
    winit.set_realized_init(realized)
    try:
        torch.manual_seed(0)
        mlp = MLP(256, 300, hidden_size=256, n_hidden_layers=2)
        setconv = SetConv(255, 256)
        block = ResConvBlock(256, 256, kernel_size=19, norm="batch", n_conv_layers=2)
        gamma = torch.nn.Linear(512, 512)
        winit.init_dense(gamma, winit.lecun_normal)
        hidden = jax_init.linear_init_for(flax.linen.relu)
        cases = [
            (mlp.to_hidden.weight, hidden, (256, 256)),
            (mlp.linear_0.weight, hidden, (256, 256)),
            (mlp.out.weight, jax_init.mlp_out_init, (256, 300)),
            (setconv.resizer.weight, jax_init.switchable(jax_init.xavier_uniform), (256, 256)),
            (block.conv1.depthwise.weight, jax_init.kaiming_normal_fanout, (19, 1, 256)),
            (block.conv1.pointwise.weight, jax_init.kaiming_normal_fanout, (1, 256, 256)),
            (block.conv2_depthwise.weight, jax_init.kaiming_normal_fanout, (19, 1, 256)),
            (block.conv2_pointwise.weight, jax_init.kaiming_normal_fanout, (1, 256, 256)),
            (gamma.weight, flax.linen.initializers.lecun_normal(), (512, 512)),
        ]
        for w, init, shape in cases:
            port_std, ref_std = float(w.detach().std()), _jax_std(init, shape)
            assert abs(port_std / ref_std - 1) < 0.05, (shape, port_std, ref_std)
        for b in (mlp.to_hidden.bias, mlp.out.bias, setconv.resizer.bias,
                  block.conv1.depthwise.bias, block.conv2_pointwise.bias, gamma.bias):
            assert torch.count_nonzero(b) == 0
        assert torch.equal(block.norm1.scale, torch.ones(256))
    finally:
        jax_init.set_realized_init(False)
        winit.set_realized_init(False)


def test_init_module_is_seeded():
    """`init_module` draws every parameter again from a seeded generator:
    the same seed gives the same model, another seed another one."""
    def draw(seed):
        m = MLP(8, 3, hidden_size=16, n_hidden_layers=3)
        winit.init_module(m, torch.Generator().manual_seed(seed))
        return torch.cat([p.detach().flatten() for p in m.parameters()])
    assert torch.equal(draw(0), draw(0)) and not torch.equal(draw(0), draw(1))
