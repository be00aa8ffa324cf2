"""The plain versions of the port's two CUDA kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), and the wrappers' CPU routing.

K1 `setconv_exprbf_plain` vs `setconv_exprbf_pallas`; K2
`fused_relu_mlp_plain` vs `fused_relu_mlp`. Inputs are made with numpy from a
seed and handed to both. Tolerance 1e-5 absolute: both sides are float32 with
the same arithmetic and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npf_gwwaveform_tpu.ops.pallas.setconv_kernel as sk
from npf_gwwaveform_tpu.ops.pallas.mlp_chain_kernel import fused_relu_mlp as jax_fused_relu_mlp
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import fused_relu_mlp, fused_relu_mlp_plain
from npf_gwwaveform_tpu_torch.ops.kernels.setconv import setconv_exprbf_fwd, setconv_exprbf_plain

torch.set_num_threads(1)

ATOL = 1e-5


def _setconv_inputs(seed, B, K, Q, C, sigma=0.05, empty_rows=()):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.uniform(-1, 1, (B, K)), axis=1).astype(np.float32)
    queries = rng.uniform(-1.5, 1.5, (B, Q)).astype(np.float32)
    values = rng.normal(size=(B, K, C)).astype(np.float32)
    mask = rng.uniform(size=(B, K)) > 0.3
    mask[list(empty_rows)] = False
    return keys, queries, values, mask, np.float32(sigma)


def _compare_setconv(keys, queries, values, mask, sigma):
    ref = np.asarray(sk.setconv_exprbf_pallas(
        jnp.asarray(keys)[..., None], jnp.asarray(queries)[..., None], jnp.asarray(values),
        jnp.asarray(mask), sigma))
    sig, den = setconv_exprbf_plain(
        torch.from_numpy(keys), torch.from_numpy(queries), torch.from_numpy(values),
        torch.from_numpy(mask.astype(np.float32)), torch.tensor([sigma]))
    np.testing.assert_allclose(sig.numpy(), ref[..., :-1], atol=ATOL)
    np.testing.assert_allclose(den.numpy(), ref[..., -1], atol=ATOL, rtol=1e-5)
    return sig.numpy(), den.numpy()


@pytest.mark.parametrize("B,K,Q,C", [(2, 16, 48, 8), (1, 7, 130, 4), (3, 40, 33, 1)])
def test_setconv_plain_matches_pallas(B, K, Q, C):
    _compare_setconv(*_setconv_inputs(0, B, K, Q, C))


def test_setconv_plain_empty_context_row_is_zero():
    sig, den = _compare_setconv(*_setconv_inputs(1, 3, 24, 40, 5, empty_rows=[1]))
    assert np.all(sig[1] == 0.0) and np.all(den[1] == 0.0)
    assert np.isfinite(sig).all() and np.isfinite(den).all()


def test_setconv_plain_matches_pallas_chunked_large_k(monkeypatch):
    """K > the Pallas chunk takes its two-pass, key-padded path; a small chunk
    keeps interpret mode cheap."""
    monkeypatch.setattr(sk, "_TK_CHUNK", 32)
    _compare_setconv(*_setconv_inputs(2, 2, 81, 96, 8, empty_rows=[0]))


def test_setconv_wrapper_uses_plain_on_cpu():
    args = [torch.from_numpy(a) for a in _setconv_inputs(3, 2, 10, 12, 3)[:3]]
    mask = torch.ones(2, 10)
    sigma = torch.tensor([0.1])
    before = setconv_exprbf_fwd.launches
    out = setconv_exprbf_fwd(*args, mask, sigma)
    ref = setconv_exprbf_plain(*args, mask, sigma)
    assert setconv_exprbf_fwd.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _mlp_inputs(seed, M, C, H, L1, O, biases):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0] if len(shape) > 1 else 1)).astype(np.float32)

    x = rng.normal(size=(M, C)).astype(np.float32)
    # flax layout [in, out]
    w0, wh, wout = w(C, H), w(L1, H, H) if L1 else np.zeros((0, H, H), np.float32), w(H, O)
    b0 = w(H) if biases else None
    bh = (w(L1, H) if L1 else np.zeros((0, H), np.float32)) if biases else None
    bout = w(O) if biases else None
    return x, w0, b0, wh, bh, wout, bout


@pytest.mark.parametrize("L1", [0, 2])
@pytest.mark.parametrize("is_res", [False, True])
@pytest.mark.parametrize("biases", [True, False])
def test_mlp_chain_plain_matches_pallas(L1, is_res, biases):
    x, w0, b0, wh, bh, wout, bout = _mlp_inputs(L1 + 2 * is_res + 4 * biases, 37, 7, 24, L1, 3,
                                                biases)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = np.asarray(jax_fused_relu_mlp(j(x), j(w0), j(b0), j(wh), j(bh), j(wout), j(bout),
                                        is_res=is_res, compute_dtype=jnp.float32))
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = fused_relu_mlp_plain(
        t(x), t(w0.T), t(b0), t(np.transpose(wh, (0, 2, 1))), t(bh), t(wout.T), t(bout),
        is_res=is_res)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=1e-5)


def test_mlp_chain_wrapper_uses_plain_on_cpu():
    x, w0, b0, wh, bh, wout, bout = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                                     _mlp_inputs(9, 11, 5, 8, 1, 2, True))
    args = (x, w0.T.contiguous(), b0, wh.transpose(1, 2).contiguous(), bh, wout.T.contiguous(),
            bout)
    before = fused_relu_mlp.launches
    assert torch.equal(fused_relu_mlp(*args), fused_relu_mlp_plain(*args))
    assert fused_relu_mlp.launches == before
