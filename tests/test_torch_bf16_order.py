"""The bars that hold the bfloat16 chain kernels (K2-bf16, K3-bf16) to their
plain versions admit another order of the sums, and they bite.

The kernels sum their bf16 products on the tensor cores, in k-groups of 16,
where the plain versions add them feature by feature (`_matmul_seq`). Here a
test-local product sums in a tensor-core-like order (`_matmul_tc`: each
k-group of 16 exact products summed pairwise in f32, the groups' sums added
to a running f32 sum in feature order), and the plain versions run with it in
place of `_matmul_seq`: the same chain, the same rounding points, another
order. At the decoder shape with run_1's decoder weights (M = 8,192, random
inputs from a seed) that chain meets the bars of `kernel_measure.py`,
against the plain version and against the JAX package's Pallas kernel at
compute_dtype=bfloat16 (interpret mode), with the bars' constants as they
are:
- K2-bf16: every output within 2^-6 s of the reference, s the element's
  absolute product sum |a_L1| |wout|^T + |bout| from the plain version's
  last activations, at most 1% of the elements differing;
- K3-bf16: dx within two bf16 ulps of its row's largest magnitude, at most
  2% differing; dW/db within 1e-2 of each gradient's max magnitude.
So the bars are no tighter than another order needs, and were not read off
the card's result. They bite: an output moved by five ulps of s fails, and
so does a one-ulp move of more than 1% of the outputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.ops.pallas.mlp_chain_kernel import fused_relu_mlp as jax_fused_relu_mlp
from npf_gwwaveform_tpu_torch.kernel_measure import (
    K2_BF16_MAX_SHARE, K2_BF16_SUM_TOL, bf16_ulp, k2_bf16_compare, k2_bf16_ok, k2_bf16_sum_scale,
    k3_bf16_ok, k3_bf16_report,
)
from npf_gwwaveform_tpu_torch.ops.kernels import mlp_chain
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    _bf16_forward, fused_relu_mlp_bwd_plain, fused_relu_mlp_plain,
)
from npf_gwwaveform_tpu_torch.score import load_model

torch.set_num_threads(1)

BF16 = torch.bfloat16
RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
M = 8192


def _matmul_tc(a, b):
    """a [M,K] @ b [K,N] in f32 from bf16-valued operands, in a
    tensor-core-like order: k-groups of 16 (zero padded), the 16 exact
    products of a group summed pairwise in f32, each group's sum added to the
    running f32 sum in feature order."""
    a, b = a.float(), b.float()
    pad = -a.shape[1] % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    acc = a.new_zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], 16):
        p = a[:, k0:k0 + 16, None] * b[None, k0:k0 + 16, :]
        while p.shape[1] > 1:
            p = p[:, 0::2] + p[:, 1::2]
        acc = acc + p[:, 0]
    return acc


@pytest.fixture(scope="module")
def decoder_case():
    """run_1's decoder weights in the port's layout, and x [M,128], g [M,2]
    in bf16 from a seed."""
    dec = load_model(RUN_DIR, "cpu").decoder.module
    with torch.no_grad():
        w = (dec.to_hidden.weight, dec.to_hidden.bias,
             torch.stack([dec.linear_0.weight, dec.linear_1.weight, dec.linear_2.weight]),
             torch.stack([dec.linear_0.bias, dec.linear_1.bias, dec.linear_2.bias]),
             dec.out.weight, dec.out.bias)
        w = tuple(t.detach().clone().contiguous() for t in w)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(M, 128)).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.normal(size=(M, 2)).astype(np.float32)).to(BF16)
    return x, g, w


def _tc_order(fn, *args, **kwargs):
    """fn with the plain versions summing in `_matmul_tc`'s order."""
    saved = mlp_chain._matmul_seq
    mlp_chain._matmul_seq = _matmul_tc
    try:
        return fn(*args, **kwargs)
    finally:
        mlp_chain._matmul_seq = saved


def _jax_args(x, w0, b0, wh, bh, wout, bout):
    """The Pallas entry's layout: x bf16, flax kernels [in, out] float32."""
    return (jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w0.t().numpy()),
            jnp.asarray(b0.numpy()), jnp.asarray(wh.transpose(1, 2).numpy()),
            jnp.asarray(bh.numpy()), jnp.asarray(wout.t().numpy()), jnp.asarray(bout.numpy()))


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def test_matmul_tc_differs_from_the_feature_order():
    """The test-local order is another order: on a random 128-deep product
    its f32 sums differ from `_matmul_seq`'s in their last bits."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)).to(BF16)
    tc, seq = _matmul_tc(a, b), mlp_chain._matmul_seq(a, b)
    assert not torch.equal(tc, seq)
    assert torch.allclose(tc, seq, rtol=0, atol=1e-4)
    exact = (a.double() @ b.double()).float()
    assert (tc - exact).abs().max() < 1e-4


@pytest.mark.parametrize("reference", ["plain", "pallas"])
def test_tc_order_chain_meets_the_k2_bf16_bar(decoder_case, reference):
    x, _, w = decoder_case
    out = _tc_order(fused_relu_mlp_plain, x, *w, compute_dtype=BF16)
    plain, acts, _ = _bf16_forward(x, *w, False)
    if reference == "plain":
        ref = plain
    else:
        ref = _t(jax_fused_relu_mlp(*_jax_args(x, *w), is_res=False,
                                    compute_dtype=jnp.bfloat16))
    report = k2_bf16_compare(out, ref, k2_bf16_sum_scale(acts[-1], w[4], w[5]))
    assert k2_bf16_ok(report), report
    assert not torch.equal(out, plain)  # another order does move some roundings


@pytest.mark.parametrize("reference", ["plain", "pallas"])
def test_tc_order_chain_meets_the_k3_bf16_bar(decoder_case, reference):
    x, g, (w0, b0, wh, bh, wout, bout) = decoder_case
    out = _tc_order(fused_relu_mlp_bwd_plain, x, g, w0, b0, wh, bh, wout, compute_dtype=BF16)
    if reference == "plain":
        ref = fused_relu_mlp_bwd_plain(x, g, w0, b0, wh, bh, wout, compute_dtype=BF16)
    else:
        def f(x, w0, b0, wh, bh, wout, bout):
            return jax_fused_relu_mlp(x, w0, b0, wh, bh, wout, bout, is_res=False,
                                      compute_dtype=jnp.bfloat16)

        _, vjp = jax.vjp(f, *_jax_args(x, w0, b0, wh, bh, wout, bout))
        r = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
        ref = (_t(r[0]), _t(r[1]).t(), _t(r[2]), _t(r[3]).transpose(1, 2), _t(r[4]), _t(r[5]).t(),
               _t(r[6]))
    report = k3_bf16_report(out, ref)
    assert k3_bf16_ok(report), report


def test_the_k2_bf16_bar_bites(decoder_case):
    x, _, w = decoder_case
    ref, acts, _ = _bf16_forward(x[:512], *w, False)
    s = k2_bf16_sum_scale(acts[-1], w[4], w[5])
    ref = ref.float()
    assert k2_bf16_compare(ref, ref, s) == (0.0, 0.0)
    ulp = bf16_ulp(s)
    # one element moved by one ulp of its sum: within the bar
    one = ref.clone()
    one[7, 1] += ulp[7, 1]
    assert k2_bf16_ok(k2_bf16_compare(one, ref, s))
    # one element moved by five ulps of its sum (more than 2^-6 s): outside
    five = ref.clone()
    five[7, 1] += 5 * ulp[7, 1]
    rel, share = k2_bf16_compare(five, ref, s)
    assert rel > K2_BF16_SUM_TOL and not k2_bf16_ok((rel, share))
    # one ulp on 2% of the elements: within the tolerance, outside the share
    many = ref.clone()
    many[:21] += ulp[:21]
    rel, share = k2_bf16_compare(many, ref, s)
    assert rel <= K2_BF16_SUM_TOL and share > K2_BF16_MAX_SHARE
    assert not k2_bf16_ok((rel, share))


def test_the_k3_bf16_bar_bites(decoder_case):
    x, g, (w0, b0, wh, bh, wout, _) = decoder_case
    ref = fused_relu_mlp_bwd_plain(x[:512], g[:512], w0, b0, wh, bh, wout, compute_dtype=BF16)
    assert k3_bf16_ok(k3_bf16_report(ref, ref))
    dx = ref[0].float().clone()
    row = int(dx.abs().amax(-1).argmax())
    dx[row, 3] += 3 * bf16_ulp(dx[row].abs().max())  # three ulps of the row's largest
    assert not k3_bf16_ok(k3_bf16_report((dx, *ref[1:]), ref))
    dw0 = ref[1].clone()
    dw0[0, 0] += 0.02 * dw0.abs().max()
    assert not k3_bf16_ok(k3_bf16_report((ref[0], dw0, *ref[2:]), ref))
