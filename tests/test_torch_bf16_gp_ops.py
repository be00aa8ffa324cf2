"""The set and attention family's ops in bfloat16 compute against the JAX
package's bf16 modules on the same inputs and parameters: each of the ten
attenders of `get_attender` with `dtype=bfloat16` (bf16 keys, queries and
values, as the models feed them; one function whose keys are all padding),
`SelfAttention` in bf16 (no positions, absolute and relative ones) on the
float32 sum-merge its xy-encoder feeds it, `MergeFlatInputs` with a bf16
inner MLP on a bf16 x1 and a float32 or bf16 x2 (its `resizer` has no dtype
in JAX and computes in float32), and the MLP in bf16, unfused and fused
(the chain's plain version on the CPU against the Pallas chain in interpret
mode).

JAX is applied op by op, so that every bf16 op rounds its result
(tests/test_torch_bf16_slice.py: XLA's excess precision). Each output keeps
JAX's dtype: bf16 where the last op is a bf16 Dense or product, float32
after the transformer block's LayerNorms (no dtype in JAX: a bf16 input is
promoted with their float32 parameters) and after the sum-merge's float32
resizer.

Bar: within 4 bf16 ulps (2^-6) of the output's largest magnitude,
tests/test_torch_bf16_slice.py's small-width bar: both sides round at the
same points and sum in float32 in other orders, so a value at a rounding
boundary may round one ulp apart and carry that on. Measured on this CPU:
1.06, 1.26 and 0.24 ulps for the cosine, multihead and transformer
attenders, 0.76 and 1.71 for self-attention without and with absolute
positions, 0 (bit-identical) for the other cases.
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
from npf_gwwaveform_tpu_torch.ops.encoders import MergeFlatInputs
from npf_gwwaveform_tpu_torch.ops.mlp import MLP
from npf_gwwaveform_tpu_torch.ops.selfattn import SelfAttention
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
ULPS = 4
B, K, Q = 3, 7, 5


def _bf16(a):
    """numpy float32 values rounded to bf16 (still float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _mask(rng, n=K):
    m = rng.random((B, n)) < 0.6
    m[0] = False  # an empty key set
    m[1, 0] = True
    return m


def _load(module, variables):
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    module.load_state_dict(params_from_flax(params), strict=True)
    return module


def _held(got, ref):
    """got's dtype is ref's, and got within ULPS bf16 ulps of ref's largest
    magnitude -> the distance in those ulps."""
    assert str(got.dtype).split(".")[-1] == str(jnp.dtype(ref.dtype)), (got.dtype, ref.dtype)
    g, r = got.detach().float().numpy(), np.asarray(ref, np.float32)
    ulps = float(np.abs(g - r).max() / (np.abs(r).max() * 2.0 ** -8))
    assert ulps <= ULPS, ulps
    return ulps


def _attn_sizes(name):
    return (16, 16, 16) if name == "transformer" else (16, 24, 16)


@pytest.mark.parametrize("name", ATTENDERS)
def test_attender_bf16(name):
    rng = np.random.default_rng(3)
    kq, vs, out = _attn_sizes(name)
    keys, queries, values = (_bf16(rng.standard_normal(s)) for s in
                             ((B, K, kq), (B, Q, kq), (B, K, vs)))
    mask = _mask(rng)
    j_in = [jnp.asarray(a, JBF16) for a in (keys, queries, values)]
    jm = jatt.get_attender(name, kq, vs, out, dtype=JBF16)
    v = jm.init(jax.random.PRNGKey(3), *j_in, mask_keys=mask)
    tm = _load(get_attender(name, kq, vs, out, dtype=BF16), v)
    ref = jm.apply(v, *j_in, mask_keys=mask)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a).to(BF16) for a in (keys, queries, values)),
                 mask_keys=torch.from_numpy(mask))
    _held(got, ref)
    if name == "transformer":  # JAX's LayerNorm has no dtype: float32 out
        assert got.dtype == torch.float32


@pytest.mark.parametrize("positional,attention", [(None, "transformer"),
                                                  ("absolute", "transformer"),
                                                  ("relative", "multihead")])
def test_self_attention_bf16(positional, attention):
    """On a float32 x, as the sum-merged xy-encoder gives it; bf16 out of
    `resize`."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, K, 16)).astype(np.float32)
    pos = np.sort(rng.uniform(-1, 1, (B, K, 1)), axis=1).astype(np.float32)
    mask = _mask(rng)
    mask[0, :2] = True
    jm = JaxSelfAttention(out_dim=12, attention=attention, positional=positional, dtype=JBF16)
    v = jm.init(jax.random.PRNGKey(5), x, positions=pos, mask=mask)
    tm = _load(SelfAttention(16, out_dim=12, attention=attention, positional=positional,
                             dtype=BF16), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), positions=torch.from_numpy(pos),
                 mask=torch.from_numpy(mask))
    _held(got, jm.apply(v, x, positions=pos, mask=mask))
    assert got.dtype == BF16


@pytest.mark.parametrize("x2_dtype", ["float32", "bfloat16"])
def test_merge_flat_inputs_bf16(x2_dtype):
    """x1 bf16 (an encoded x), x2 float32 (y, a z draw) or bf16 (R); the
    inner MLP in bf16, its output bf16."""
    rng = np.random.default_rng(1)
    x1 = _bf16(rng.standard_normal((B, 6, 8)))
    x2 = _bf16(rng.standard_normal((2, B, 6, 3)))
    j2 = jnp.asarray(x2, JBF16 if x2_dtype == "bfloat16" else jnp.float32)
    factory = jenc.merge_flat_input(lambda n, **kw: JaxMLP(n, hidden_size=16, dtype=JBF16, **kw),
                                    is_sum_merge=True)
    jm = factory(5)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x1, JBF16), j2)
    tm = _load(MergeFlatInputs(MLP(8, 5, hidden_size=16, dtype=BF16), 8, 3, is_sum_merge=True), v)
    t2 = torch.from_numpy(x2).to(getattr(torch, x2_dtype))
    with torch.no_grad():
        got = tm(torch.from_numpy(x1).to(BF16), t2)
    _held(got, jm.apply(v, jnp.asarray(x1, JBF16), j2))


@pytest.mark.parametrize("fused", [False, True])
def test_mlp_bf16(fused):
    """The decoder-like chain (four hidden layers) in bf16 on a float32 input:
    unfused, JAX's Dense chain; fused, the chain's plain version against the
    Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 10)).astype(np.float32)
    jm = JaxMLP(2, hidden_size=16, n_hidden_layers=4, dtype=JBF16, fused=fused)
    v = jm.init(jax.random.PRNGKey(0), x)
    tm = _load(MLP(10, 2, hidden_size=16, n_hidden_layers=4, fused=fused, dtype=BF16), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _held(got, jm.apply(v, x))
