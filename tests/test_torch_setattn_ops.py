"""The set and attention family's ops in the port against the JAX package on
the same inputs and parameters (the JAX module's `init` copied over with
`params_from_flax`): `MLP`'s tanh activation, `is_bias=False` and
`is_force_hid_smaller`; `MergeFlatInputs` sum-merged and concatenated (with
a z axis on one input); `RelativeSinusoidalEncodings`; each of the ten
attender names of `get_attender` (3-D keys, and the dot attenders' 4-D
keys), with one function whose keys are all padding; `SelfAttention` with
no positions, absolute and relative ones (relative with "multihead", the
one attender JAX's relative path takes).

Inputs are made from a numpy seed, of unit scale. Tolerance: 1e-5 absolute
at op level (float32 sums of a few dozen products in other orders, on
outputs of magnitude up to ~5). An empty key set gives exact zeros and,
through the port, finite zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.ops import attention as jatt
from npf_gwwaveform_tpu.ops import encoders as jenc
from npf_gwwaveform_tpu.ops.mlp import MLP as JaxMLP
from npf_gwwaveform_tpu.ops.selfattn import SelfAttention as JaxSelfAttention
from npf_gwwaveform_tpu_torch.ops.attention import ATTENDERS, get_attender
from npf_gwwaveform_tpu_torch.ops.encoders import MergeFlatInputs, RelativeSinusoidalEncodings
from npf_gwwaveform_tpu_torch.ops.mlp import MLP
from npf_gwwaveform_tpu_torch.ops.selfattn import SelfAttention
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

ATOL = 1e-5
B, K, Q = 3, 7, 5


def _rng(seed):
    return np.random.default_rng(seed)


def _mask(rng, n=K):
    """[B, n]: the first function's keys all padding, the others partly."""
    m = rng.random((B, n)) < 0.6
    m[0] = False
    m[1, 0] = True
    return m


def _load(module, variables):
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    module.load_state_dict(params_from_flax(params), strict=True)
    return module


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("case", ["tanh", "no_bias", "force_smaller", "relu_fused"])
def test_mlp_options(case):
    kw = {"tanh": dict(activation="tanh"), "no_bias": dict(is_bias=False),
          "force_smaller": dict(is_force_hid_smaller=True, hidden_size=64),
          "relu_fused": dict(n_hidden_layers=3)}[case]
    jkw = dict(kw)
    if "activation" in jkw:
        jkw["activation"] = jnp.tanh
    x = _rng(0).standard_normal((4, 6, 10)).astype(np.float32)
    jm = JaxMLP(12, hidden_size=kw.get("hidden_size", 16), n_hidden_layers=kw.get(
        "n_hidden_layers", 2), **{k: v for k, v in jkw.items()
                                  if k not in ("hidden_size", "n_hidden_layers")})
    v = jm.init(jax.random.PRNGKey(0), x)
    tm = _load(MLP(10, 12, hidden_size=kw.get("hidden_size", 16),
                   n_hidden_layers=kw.get("n_hidden_layers", 2), fused=case == "relu_fused",
                   **{k: v2 for k, v2 in kw.items() if k not in ("hidden_size",
                                                                 "n_hidden_layers")}), v)
    if case == "force_smaller":
        assert tm.to_hidden.out_features == 12  # max(in 10, out 12), not 64
    if case == "no_bias":
        assert tm.to_hidden.bias is None and tm.out.bias is None
    _close(tm(torch.from_numpy(x)), jm.apply(v, x))


@pytest.mark.parametrize("is_sum_merge", [True, False])
def test_merge_flat_inputs(is_sum_merge):
    """x1 [B, N, 8] without and x2 [2, B, N, 3] with a z axis."""
    rng = _rng(1)
    x1 = rng.standard_normal((B, 6, 8)).astype(np.float32)
    x2 = rng.standard_normal((2, B, 6, 3)).astype(np.float32)
    factory = jenc.merge_flat_input(lambda n, **kw: JaxMLP(n, hidden_size=16, **kw),
                                    is_sum_merge=is_sum_merge)
    jm = factory(5)
    v = jm.init(jax.random.PRNGKey(1), x1, x2)
    tm = _load(MergeFlatInputs(MLP(8 if is_sum_merge else 11, 5, hidden_size=16), 8, 3,
                               is_sum_merge=is_sum_merge), v)
    _close(tm(torch.from_numpy(x1), torch.from_numpy(x2)), jm.apply(v, x1, x2))
    # a broadcast x2 (a view of one row a function) gives the same values
    if is_sum_merge:
        row = torch.from_numpy(x2[:, :, :1]).expand(2, B, 6, 3)
        _close(tm(torch.from_numpy(x1), row), jm.apply(v, x1, np.asarray(row)))


def test_relative_sinusoidal_encodings():
    rng = _rng(2)
    kp = rng.uniform(-1, 1, (B, K, 1)).astype(np.float32) * 1.5
    qp = rng.uniform(-1, 1, (B, Q, 1)).astype(np.float32) * 1.5
    jm = jenc.RelativeSinusoidalEncodings(8)
    v = jm.init(jax.random.PRNGKey(2), kp, qp)
    tm = _load(RelativeSinusoidalEncodings(8), v)
    ref = jm.apply(v, kp, qp)
    assert (np.asarray(ref) == 0).any()  # some pairs outside the window
    _close(tm(torch.from_numpy(kp), torch.from_numpy(qp)), ref)


def _attn_sizes(name):
    """(kq, value, out): a resizer or post-processor where value != out,
    except the transformer, which needs kq == out."""
    return (16, 16, 16) if name == "transformer" else (16, 24, 16)


@pytest.mark.parametrize("name", ATTENDERS)
def test_attender(name):
    rng = _rng(3)
    kq, vs, out = _attn_sizes(name)
    keys = rng.standard_normal((B, K, kq)).astype(np.float32)
    queries = rng.standard_normal((B, Q, kq)).astype(np.float32)
    values = rng.standard_normal((B, K, vs)).astype(np.float32)
    mask = _mask(rng)
    jm = jatt.get_attender(name, kq, vs, out)
    v = jm.init(jax.random.PRNGKey(3), keys, queries, values, mask_keys=mask)
    tm = _load(get_attender(name, kq, vs, out), v)
    tk, tq, tv = (torch.from_numpy(a).requires_grad_() for a in (keys, queries, values))
    got = tm(tk, tq, tv, mask_keys=torch.from_numpy(mask))
    ref = jm.apply(v, keys, queries, values, mask_keys=mask)
    _close(got, ref)
    if name != "transformer":  # its LayerNorm adds the queries: not zero
        assert torch.all(got[0] == (tm.resizer.bias if hasattr(tm, "resizer") else
                                    getattr(tm, "post_processor", None).bias
                                    if hasattr(tm, "post_processor") else 0.0))
    got.square().sum().backward()
    for t in (tk, tq, tv):
        assert torch.isfinite(t.grad).all()
    assert torch.all(tk.grad[0] == 0) and torch.all(tv.grad[0] == 0)


@pytest.mark.parametrize("name", ["dot", "scaledot"])
def test_dot_attender_4d_keys(name):
    """One key set a query, [B, Q, K, D], as relative positions make them."""
    rng = _rng(4)
    keys = rng.standard_normal((B, Q, K, 16)).astype(np.float32)
    queries = rng.standard_normal((B, Q, 16)).astype(np.float32)
    values = rng.standard_normal((B, K, 16)).astype(np.float32)
    mask = _mask(rng)
    jm = jatt.get_attender(name, 16, 16, 16)
    ref = jm.apply({}, keys, queries, values, mask_keys=mask)
    got = get_attender(name, 16, 16, 16)(*(torch.from_numpy(a) for a in (keys, queries, values)),
                                         mask_keys=torch.from_numpy(mask))
    _close(got, ref)


@pytest.mark.parametrize("positional,attention", [(None, "transformer"),
                                                  ("absolute", "transformer"),
                                                  ("relative", "multihead")])
def test_self_attention(positional, attention):
    rng = _rng(5)
    x = rng.standard_normal((B, K, 16)).astype(np.float32)
    pos = np.sort(rng.uniform(-1, 1, (B, K, 1)), axis=1).astype(np.float32)
    mask = _mask(rng)
    mask[0, :2] = True  # self-attention: a function with real points
    jm = JaxSelfAttention(out_dim=12, attention=attention, positional=positional)
    v = jm.init(jax.random.PRNGKey(5), x, positions=pos, mask=mask)
    tm = _load(SelfAttention(16, out_dim=12, attention=attention, positional=positional), v)
    if positional == "relative":
        assert tm.attn_0.query_transform.bias is None
    _close(tm(torch.from_numpy(x), positions=torch.from_numpy(pos),
              mask=torch.from_numpy(mask)), jm.apply(v, x, positions=pos, mask=mask))


def test_get_attender_refuses_unknown_names():
    with pytest.raises(ValueError):
        get_attender("softmax", 16, 16, 16)
    with pytest.raises(ValueError):  # as in JAX, a transformer block needs kq == out
        get_attender("transformer", 16, 16, 8)
