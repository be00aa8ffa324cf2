"""The bfloat16 plain versions of K2 and K3 against the JAX package's Pallas
kernels at `compute_dtype=bfloat16` (interpret mode on the CPU), and the
bf16 wrappers' and autograd Function's CPU behaviour.

Tolerances, each with its reason:
- K2 forward: every element within one bf16 ulp of JAX's (the ulp of the
  larger of the two magnitudes), and at most 1% of elements differing. Both
  round at the same points and differ only in the order of each layer's f32
  sum, so an element moves only where a sum lies within f32 rounding of a
  bf16 rounding boundary (measured: one ulp, 0.02% of elements, at the
  decoder shape; identical elsewhere).
- K3 dx: every element within two bf16 ulps of the largest magnitude in its
  row, and at most 2% of elements differing. dx is the end of a chain of
  rounded products, each of which may move by one ulp where its f32 sum lies
  at a rounding boundary; one such move in a g feeds every element of the
  row, so an element whose sum cancels to near zero moves by many of its own
  ulps (measured: 19 of its own ulps at most, one ulp of its row's largest
  magnitude, 0.05% of elements differing, at the decoder shape).
- K3 dW/db: 1e-2 of each gradient's max magnitude. They are f32 row sums of
  products of rounded activations and masked gradients, each of which may
  sit one ulp (2^-8 of itself) apart where its sum lay at a rounding boundary
  (measured: 3.1e-3 worst, dwout of the ragged residual chain).
- `_matmul_seq` against a numpy loop that adds the exact products feature
  by feature in float32: identical bits (the bf16 kernels' order).
The bf16 bounds of `kernel_measure` are checked at the decoder's shapes.
"""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.ops.pallas.mlp_chain_kernel import fused_relu_mlp as jax_fused_relu_mlp
from npf_gwwaveform_tpu_torch import _build
from npf_gwwaveform_tpu_torch.kernel_measure import bound, k2_bound, k3_bound
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    FusedReluMLPFn, _matmul_seq, fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain,
    fused_relu_mlp_plain,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
K2_ULPS, K2_MAX_SHARE = 1, 0.01
DX_ULPS, DX_MAX_SHARE = 2, 0.02
DW_RTOL = 1e-2

# (name, M, C, H, L1, O, is_res, biases)
CASES = [
    ("decoder", 2048, 128, 128, 3, 2, False, True),
    ("ragged residual", 300, 37, 64, 2, 5, True, True),
    ("no hidden stack", 300, 128, 128, 0, 3, False, True),
    ("no biases", 300, 96, 128, 1, 2, True, False),
]


def bf16_ulp(v):
    """One bf16 ulp at |v| (float32 array): 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    v = np.abs(np.asarray(v, np.float32))
    e = np.floor(np.log2(np.maximum(v, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def ulp_report(out, ref, per_row=False):
    """(largest difference in bf16 ulps of the larger of the two magnitudes,
    or with `per_row` of the largest magnitude in the row, share of elements
    that differ)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    scale = np.maximum(np.abs(out), np.abs(ref))
    if per_row:
        scale = scale.max(axis=-1, keepdims=True)
    ulps = diff / bf16_ulp(scale)
    return float(ulps.max(initial=0.0)), float((diff > 0).mean()) if diff.size else 0.0


def _inputs(seed, M, C, H, L1, O, biases):
    """numpy inputs in flax's layout: x [M,C], w0 [C,H], wh [L1,H,H], wout
    [H,O], float32; x rounded to bf16 (the decoder's input is bf16)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2] if len(shape) > 1 else 4)
                ).astype(np.float32)

    x = torch.from_numpy(rng.normal(size=(M, C)).astype(np.float32)).to(BF16).float().numpy()
    wh = w(L1, H, H) if L1 else np.zeros((0, H, H), np.float32)
    bh = (w(L1, H) if L1 else np.zeros((0, H), np.float32)) if biases else None
    return x, w(C, H), w(H) if biases else None, wh, bh, w(H, O), w(O) if biases else None


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _port_args(x, w0, b0, wh, bh, wout, bout):
    """The port's layout: x bf16, weights [out, in] float32."""
    return (_t(x).to(BF16), _t(w0.T), _t(b0), _t(np.transpose(wh, (0, 2, 1))), _t(bh),
            _t(wout.T), _t(bout))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_k2_bf16_plain_matches_pallas(case):
    _, M, C, H, L1, O, is_res, biases = case
    x, w0, b0, wh, bh, wout, bout = _inputs(M + C + L1, M, C, H, L1, O, biases)
    ref = jax_fused_relu_mlp(_j(x, jnp.bfloat16), _j(w0), _j(b0), _j(wh), _j(bh), _j(wout),
                             _j(bout), is_res=is_res, compute_dtype=jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    out = fused_relu_mlp_plain(*_port_args(x, w0, b0, wh, bh, wout, bout), is_res=is_res,
                               compute_dtype=BF16)
    assert out.dtype == BF16 and out.shape == (M, O)
    ulps, share = ulp_report(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert ulps <= K2_ULPS and share <= K2_MAX_SHARE, (ulps, share)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_k3_bf16_plain_matches_pallas_vjp(case):
    _, M, C, H, L1, O, is_res, biases = case
    x, w0, b0, wh, bh, wout, bout = _inputs(M + C + L1 + 1, M, C, H, L1, O, biases)
    g = torch.from_numpy(np.random.default_rng(M).normal(size=(M, O)).astype(np.float32)).to(BF16)

    def f(x, w0, b0, wh, bh, wout):
        return jax_fused_relu_mlp(x, w0, b0, wh, bh, wout, _j(bout), is_res=is_res,
                                  compute_dtype=jnp.bfloat16)

    _, vjp = jax.vjp(f, _j(x, jnp.bfloat16), _j(w0), _j(b0), _j(wh), _j(bh), _j(wout))
    ref = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    px, pw0, pb0, pwh, pbh, pwout, _ = _port_args(x, w0, b0, wh, bh, wout, bout)
    out = fused_relu_mlp_bwd_plain(px, g, pw0, pb0, pwh, pbh, pwout, is_res=is_res,
                                   compute_dtype=BF16)
    dx, dw0, db0, dwh, dbh, dwout, _ = out
    assert dx.dtype == BF16 and all(t.dtype == torch.float32 for t in out[1:])
    ulps, share = ulp_report(dx.float().numpy(), np.asarray(ref[0].astype(jnp.float32)),
                             per_row=True)
    assert ulps <= DX_ULPS and share <= DX_MAX_SHARE, (ulps, share)
    pairs = [("dw0", dw0, ref[1].T), ("dwh", dwh, np.transpose(ref[3], (0, 2, 1))),
             ("dwout", dwout, ref[5].T)]
    if biases:
        pairs += [("db0", db0, ref[2]), ("dbh", dbh, ref[4])]
    for name, a, r in pairs:
        r = np.asarray(r, np.float32)
        if r.size:
            err = np.abs(a.numpy() - r).max() / np.abs(r).max()
            assert err <= DW_RTOL, (name, err)


def test_matmul_seq_is_the_kernels_feature_order():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(17, 40)).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.normal(size=(40, 9)).astype(np.float32)).to(BF16)
    an, bn = a.float().numpy(), b.float().numpy()
    ref = np.zeros((17, 9), np.float32)
    for k in range(40):
        ref += an[:, k, None] * bn[None, k, :]  # exact products, one f32 rounding a step
    assert np.array_equal(_matmul_seq(a, b).numpy(), ref)


def test_bf16_wrappers_use_plain_on_cpu_and_refuse_other_dtypes():
    x, w0, b0, wh, bh, wout, bout = _port_args(*_inputs(9, 11, 5, 8, 1, 2, True))
    g = torch.ones(11, 2, dtype=BF16)
    before = (fused_relu_mlp.launches, fused_relu_mlp.launches_bf16, fused_relu_mlp_bwd.launches,
              fused_relu_mlp_bwd.launches_bf16)
    fwd = (x, w0, b0, wh, bh, wout, bout)
    assert torch.equal(fused_relu_mlp(*fwd, compute_dtype=BF16),
                       fused_relu_mlp_plain(*fwd, compute_dtype=BF16))
    bwd = (x, g, w0, b0, wh, bh, wout)
    for a, b in zip(fused_relu_mlp_bwd(*bwd, compute_dtype=BF16),
                    fused_relu_mlp_bwd_plain(*bwd, compute_dtype=BF16)):
        assert torch.equal(a, b)
    assert before == (fused_relu_mlp.launches, fused_relu_mlp.launches_bf16,
                      fused_relu_mlp_bwd.launches, fused_relu_mlp_bwd.launches_bf16)
    for fn, args in ((fused_relu_mlp, fwd), (fused_relu_mlp_plain, fwd),
                     (fused_relu_mlp_bwd, bwd), (fused_relu_mlp_bwd_plain, bwd)):
        with pytest.raises(TypeError):
            fn(*args, compute_dtype=torch.float16)


def test_fused_mlp_function_in_bf16_on_cpu():
    """FusedReluMLPFn at compute_dtype=bfloat16: a bf16 output, a bf16 dx and
    float32 weight gradients, equal to K3's plain version on the strided
    cotangent a loc/scale split gives."""
    x, w0, b0, wh, bh, wout, bout = _port_args(*_inputs(12, 30, 6, 16, 2, 2, True))
    leaves = [t.clone().requires_grad_() for t in (x, w0, b0, wh, bh, wout, bout)]
    out = FusedReluMLPFn.apply(*leaves, True, BF16)
    assert out.dtype == BF16
    loc, raw = out.split(1, dim=-1)
    (loc.float().square().sum() + torch.nn.functional.softplus(raw.float()).sum()).backward()
    g = torch.cat([2 * loc.detach().float(), torch.sigmoid(raw.detach().float())], -1).to(BF16)
    ref = fused_relu_mlp_bwd_plain(x, g, w0, b0, wh, bh, wout, True, BF16)
    assert leaves[0].grad.dtype == BF16
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad, r)
    assert torch.equal(leaves[6].grad, g.float().sum(0))


@pytest.mark.parametrize("M,expected_ms", [(8192, 0.00109), (65536, 0.00872)])
def test_k2_bf16_bound_at_the_decoder_shapes(M, expected_ms):
    """The bf16 decoder chain: 65,792 multiply-adds a row over the bf16
    tensor cores' 989 TFLOP/s (8.62 GFLOP at the scoring shape: 8.7 us),
    against 2 bytes an element of x and out and the f32 parameters (17.3 MB
    there: 5.2 us): bound by operations."""
    C, H, L1, O = 128, 128, 3, 2
    args = (torch.zeros(M, C, dtype=BF16), torch.zeros(H, C), torch.zeros(H),
            torch.zeros(L1, H, H), torch.zeros(L1, H), torch.zeros(O, H), torch.zeros(O))
    t, by = k2_bound(*args)
    assert by == "operations" and t == pytest.approx(
        2 * M * (C * H + L1 * H * H + H * O) / 989e9)
    assert t == pytest.approx(expected_ms, abs=5e-6)
    n_bytes = 2 * M * (C + O) + 4 * (H * C + H + L1 * H * H + L1 * H + O * H + O)
    assert bound(n_bytes, 0.0)[0] < t


def test_k3_bf16_bound_at_the_training_shape():
    """The bf16 backward at M = 8,192: 3.23 GFLOP over 989 TFLOP/s."""
    M, C, H, L1, O = 8192, 128, 128, 3, 2
    args = (torch.zeros(M, C, dtype=BF16), torch.zeros(M, O, dtype=BF16), torch.zeros(H, C),
            torch.zeros(H), torch.zeros(L1, H, H), torch.zeros(L1, H), torch.zeros(O, H))
    t, by = k3_bound(*args)
    assert by == "operations" and t == pytest.approx(
        (2 * M * (C * H + L1 * H * H) + 4 * M * (H * C + L1 * H * H + O * H)) / 989e9)


def test_bf16_sources_are_in_the_build_and_bound():
    """The bf16 kernels' sources and header are compiled and hashed into the
    one library, and `load` gives their entry points their C signatures."""
    names = {os.path.basename(p) for p in _build.sources()}
    assert {"mlp_chain_fwd_bf16.cu", "mlp_chain_bwd_bf16.cu"} <= names
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "mlp_chain_bf16.cuh"))
    for name in ("npf_mlp_chain_fwd_bf16", "npf_mlp_chain_bwd_bf16"):
        base = name[:-len("_bf16")]
        assert _build._SIGNATURES[name] == _build._SIGNATURES[base]
    for name in ("npf_mlp_chain_fwd_bf16_smem", "npf_mlp_chain_bwd_bf16_scratch"):
        assert _build._RESTYPES[name] is ctypes.c_longlong
