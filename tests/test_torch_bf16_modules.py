"""The port's modules in bfloat16 compute against the JAX package's modules
with `dtype=jnp.bfloat16`, on the same numpy inputs with the same float32
parameters (a flax `init`, perturbed, carried over with `params_from_flax`).

Errors are measured in bf16 ulps of the output's largest magnitude
(2^-8 of it: `ulps_of_max`). Both sides round at the same points and differ
in the order of their f32 sums, so a rounded value moves by one of its own
ulps where its sum lay at a rounding boundary, and later layers carry that
along. Bars (at these small widths every output measured identical, 0 ulps,
on this CPU):
- one Dense chain or fused MLP, one SetConv: 2 ulps of the max;
- a ResConvBlock (two depthwise-separable convs, BatchNorm in float32), in
  eval and in train mode, and FiLM: 4 ulps of the max, as a few rounded
  layers carry a moved value along; BatchNorm's updated running statistics
  1e-5 (float32 on both sides, from the same bf16 input);
- the dtype map: exactly flax's output dtype for every submodule whose
  forward the port calls (the bf16 Dense and Conv layers inside are
  computed by `dense` and `conv`, not through a module call, and show in
  their parents' dtypes).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu.ops.cnn import ResConvBlock as JaxResConvBlock
from npf_gwwaveform_tpu.ops.mlp import MLP as JaxMLP
from npf_gwwaveform_tpu.ops.setconv import SetConv as JaxSetConv
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.ops.cnn import ResConvBlock
from npf_gwwaveform_tpu_torch.ops.mlp import MLP
from npf_gwwaveform_tpu_torch.ops.setconv import SetConv
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

BF16 = torch.bfloat16
LAYER_ULPS = 2
BLOCK_ULPS = 4
STATS_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _load(module, variables):
    extra = {k: v for k, v in variables.items() if k != "params"}
    module.load_state_dict(params_from_flax(_np_tree(variables["params"]), _np_tree(extra)),
                           strict=True)
    return module.eval()


def _perturb(tree, rng, scale=0.3):
    return jax.tree_util.tree_map(
        lambda a: a + scale * rng.normal(size=a.shape).astype(np.float32), _np_tree(tree))


def _bf16(a):
    """numpy float32 values rounded to bf16 (still float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def ulps_of_max(out, ref):
    """max |out - ref| in bf16 ulps of max |ref| (2^-8 of it)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / (np.abs(ref).max() * 2.0 ** -8))


def _out(t):
    assert t.dtype == BF16, t.dtype
    return t.float().numpy()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", [
    dict(out=2, hidden=32, layers=4, inp=32, res=False),  # the decoder's depth, narrow
    dict(out=5, hidden=3, layers=3, inp=7, res=True),  # hidden clamped up to min(in, out)
    dict(out=16, hidden=16, layers=2, inp=80, res=False),  # FiLM's cond_field shape, narrow
])
def test_mlp_bf16_matches_flax(cfg, fused):
    """Dense chain: flax `Dense(dtype=bfloat16)` per layer; fused: the
    Pallas chain at compute_dtype=bfloat16 (interpret mode)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, cfg["inp"])).astype(np.float32)
    jm = JaxMLP(cfg["out"], hidden_size=cfg["hidden"], n_hidden_layers=cfg["layers"],
                is_res=cfg["res"], dtype=jnp.bfloat16, fused=fused)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, 0.05)
    ref = jm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    tm = _load(MLP(cfg["inp"], cfg["out"], hidden_size=cfg["hidden"],
                   n_hidden_layers=cfg["layers"], is_res=cfg["res"], fused=fused, dtype=BF16),
               variables)
    with torch.no_grad():
        out = _out(tm(torch.from_numpy(x).to(BF16)))
    assert ulps_of_max(out, np.asarray(ref, np.float32)) <= LAYER_ULPS


@pytest.mark.parametrize("use_kernel", [False, True])
def test_setconv_bf16_matches_jax(use_kernel):
    """The interpolation in float32 (values cast first), the resizer in bf16."""
    rng = np.random.default_rng(1)
    B, K, Q, C = 2, 20, 30, 8
    keys = np.sort(rng.uniform(-1, 1, (B, K, 1)), axis=1).astype(np.float32)
    queries = rng.uniform(-1.5, 1.5, (B, Q, 1)).astype(np.float32)
    values = _bf16(rng.normal(size=(B, K, C)))
    mask = rng.uniform(size=(B, K)) > 0.4
    mask[1] = False  # an empty context row
    jm = JaxSetConv(out_channels=16, rbf_kwargs=dict(max_dist=0.05), dtype=jnp.bfloat16)
    args = (jnp.asarray(keys), jnp.asarray(queries), jnp.asarray(values, jnp.bfloat16),
            jnp.asarray(mask))
    variables = _perturb(jm.init(jax.random.PRNGKey(0), *args), rng, 0.1)
    ref = jm.apply(variables, *args)
    tm = _load(SetConv(C, 16, use_kernel=use_kernel, dtype=BF16), variables)
    with torch.no_grad():
        out = _out(tm(torch.from_numpy(keys), torch.from_numpy(queries),
                      torch.from_numpy(values).to(BF16), torch.from_numpy(mask)))
    assert ulps_of_max(out, np.asarray(ref, np.float32)) <= LAYER_ULPS


@pytest.mark.parametrize("train", [False, True])
def test_res_conv_block_bf16_matches_jax(train):
    """Two depthwise-separable convs in bf16, BatchNorm in float32 (batch
    statistics and their running update in train mode, the running ones in
    eval mode), the residual in bf16."""
    rng = np.random.default_rng(2)
    x = _bf16(rng.normal(size=(3, 48, 16)))
    jm = JaxResConvBlock(16, kernel_size=5, norm="batch", n_conv_layers=2, dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), xj, train=False), rng, 0.1)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    if train:
        ref, upd = jm.apply(variables, xj, train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, xj, train=False)
    tm = _load(ResConvBlock(16, 16, 5, "batch", 2, dtype=BF16), variables).train(train)
    with torch.no_grad():
        out = _out(tm(torch.from_numpy(x).to(BF16).transpose(1, 2)).transpose(1, 2))
    assert ulps_of_max(out, np.asarray(ref, np.float32)) <= BLOCK_ULPS
    if train:
        stats = params_from_flax({}, {"batch_stats": _np_tree(upd["batch_stats"])})
        for name, buf in tm.named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=STATS_ATOL)


def _small(dtype, fused, use_kernels):
    """The small FiLM ConvCNP of test_torch_slice.py, in compute `dtype`."""
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, jnp.bfloat16, kernel_size=5), cond_dim=4,
                    cond_mode="film", dtype=jnp.bfloat16, fused_mlp=fused)
    tm = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5, cond_dim=4,
                 use_kernels=use_kernels, dtype=dtype)
    return jm, tm


def _small_inputs(rng, B=3, N=40):
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1)).copy()
    y = np.sin(8 * x + rng.uniform(0, 6, (B, 1, 1))).astype(np.float32)
    mask_c = rng.uniform(size=(B, N)) > 0.5
    mask_c[0] = False  # an empty context
    cond = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    return x, y, mask_c, np.ones((B, N), bool), cond


def _init(jm, inputs):
    x, y, mask_c, mask_t, cond = (jnp.asarray(a) for a in inputs)
    return _np_tree(jm.init(jax.random.PRNGKey(0), x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t,
                            condition=cond, train=False))


def test_film_bf16_matches_jax():
    """FiLM on the induced grid: the cond_gamma Dense and the cond_field MLP
    in bf16, the sinusoidal features and the grid in float32."""
    rng = np.random.default_rng(4)
    jm, tm = _small(BF16, False, False)
    variables = _init(jm, _small_inputs(rng))
    variables["params"] = _perturb(variables["params"], rng, 0.05)
    R = _bf16(rng.normal(size=(3, 48, 16)))
    emb = _bf16(rng.normal(size=(3, 16)))
    ref = jm.apply(variables, jnp.asarray(R, jnp.bfloat16), jnp.asarray(emb, jnp.bfloat16),
                   method=JaxConvCNP._film)
    assert ref.dtype == jnp.bfloat16
    tm = _load(tm, variables)
    with torch.no_grad():
        out = _out(tm._film(torch.from_numpy(R).to(BF16), torch.from_numpy(emb).to(BF16)))
    assert ulps_of_max(out, np.asarray(ref, np.float32)) <= BLOCK_ULPS


# port submodule -> flax path of its output (the port's decoder wraps the MLP
# in DiscardIthArg as `.module`; flax's discard_ith_arg names it MLP_0)
_DTYPE_MAP = {
    "cond_encoder": ("cond_encoder",),
    "cntxt_to_induced": ("cntxt_to_induced",),
    "cond_pos_enc": ("cond_pos_enc",),
    "cond_field": ("cond_field",),
    "induced_to_induced": ("induced_to_induced",),
    "induced_to_trgt": ("induced_to_trgt",),
    "decoder": ("decoder",),
    "decoder.module": ("decoder", "MLP_0"),
    **{f"induced_to_induced.block_{i}{sub}": ("induced_to_induced", f"block_{i}",
                                              *([sub[1:]] if sub else []))
       for i in range(2) for sub in ("", ".norm1", ".conv1", ".norm2")},
}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_dtype_map_matches_flax(use_kernels):
    """Each listed submodule's output dtype in the port (forward hooks) is
    flax's (`capture_intermediates`), on the kernel path (JAX fused_mlp) and
    the plain one; loc and scale are float32 on both."""
    rng = np.random.default_rng(5)
    inputs = _small_inputs(rng)
    jm, tm = _small(BF16, use_kernels, use_kernels)
    variables = _init(jm, inputs)
    x, y, mask_c, mask_t, cond = (jnp.asarray(a) for a in inputs)
    out, inter = jm.apply(variables, x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t,
                          condition=cond, train=False, capture_intermediates=True,
                          mutable=["intermediates"])
    flax_dtypes = {}
    for name, path in _DTYPE_MAP.items():
        node = inter["intermediates"]
        for p in path:
            node = node[p]
        flax_dtypes[name] = str(jnp.dtype(node["__call__"][0].dtype))
    tm = _load(tm, variables)
    seen = {}

    def record(name):
        def hook(module, args, output):
            seen[name] = str(output.dtype).split(".")[-1]
        return hook

    for name in _DTYPE_MAP:
        tm.get_submodule(name).register_forward_hook(record(name))
    with torch.no_grad():
        t = tm(*(torch.from_numpy(a) for a in (inputs[0], inputs[1], inputs[0])),
               mask_cntxt=torch.from_numpy(inputs[2]), mask_trgt=torch.from_numpy(inputs[3]),
               condition=torch.from_numpy(inputs[4]))
    assert seen == flax_dtypes
    assert out.p_yCc.loc.dtype == jnp.float32 and t.p_yCc.loc.dtype == torch.float32
    assert out.p_yCc.scale.dtype == jnp.float32 and t.p_yCc.scale.dtype == torch.float32
