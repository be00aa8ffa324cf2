"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), the autograd Functions' backward
on the CPU, and the wrappers' CPU routing.

K1 `setconv_exprbf_plain` vs `setconv_exprbf_pallas`; K2
`fused_relu_mlp_plain` vs `fused_relu_mlp`; K3 `fused_relu_mlp_bwd_plain` vs
`jax.vjp` of `fused_relu_mlp` (its custom_vjp runs the Pallas backward);
`SetConvExpRBFFn`'s backward vs `jax.vjp` of `setconv_exprbf_pallas`. Inputs
are made with numpy from a seed and handed to both. Tolerance 1e-5: both
sides are float32 with the same arithmetic and differ only in summation
order (absolute for values, of each output's max magnitude for gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npf_gwwaveform_tpu.ops.pallas.setconv_kernel as sk
from npf_gwwaveform_tpu.ops.pallas.mlp_chain_kernel import fused_relu_mlp as jax_fused_relu_mlp
from npf_gwwaveform_tpu_torch.ops.kernels._checks import require_no_grad
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    FusedReluMLPFn, fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain,
    fused_relu_mlp_plain,
)
from npf_gwwaveform_tpu_torch.ops.kernels.setconv import (
    SetConvExpRBFFn, setconv_exprbf_fwd, setconv_exprbf_plain,
)

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


def _assert_rel(out, ref, rtol, name=""):
    """max |out - ref| <= rtol * max |ref| (plus a floor for all-zero refs)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    if ref.size:
        err = np.abs(out - ref).max()
        assert err <= rtol * max(np.abs(ref).max(), 1e-30), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("L1", [0, 2])
@pytest.mark.parametrize("is_res", [False, True])
@pytest.mark.parametrize("biases", [True, False])
def test_mlp_chain_bwd_plain_matches_pallas_vjp(L1, is_res, biases):
    """K3's plain version against the Pallas backward: dx, dW, db."""
    x, w0, b0, wh, bh, wout, bout = _mlp_inputs(11 + L1 + 2 * is_res + 4 * biases, 45, 9, 24,
                                                L1, 3, biases)
    g = np.random.default_rng(5).normal(size=(45, 3)).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

    def f(x, w0, b0, wh, bh, wout):
        return jax_fused_relu_mlp(x, w0, b0, wh, bh, wout, j(bout), is_res=is_res,
                                  compute_dtype=jnp.float32)

    _, vjp = jax.vjp(f, j(x), j(w0), j(b0), j(wh), j(bh), j(wout))
    ref = vjp(jnp.asarray(g))
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = fused_relu_mlp_bwd_plain(t(x), t(g), t(w0.T), t(b0), t(np.transpose(wh, (0, 2, 1))),
                                   t(bh), t(wout.T), is_res=is_res)
    dx, dw0, db0, dwh, dbh, dwout, _ = (o.numpy() for o in out)
    rdx, rdw0, rdb0, rdwh, rdbh, rdwout = (None if r is None else np.asarray(r) for r in ref)
    _assert_rel(dx, rdx, ATOL, "dx")
    _assert_rel(dw0, rdw0.T, ATOL, "dw0")
    _assert_rel(dwh, np.transpose(rdwh, (0, 2, 1)), ATOL, "dwh")
    _assert_rel(dwout, rdwout.T, ATOL, "dwout")
    if biases:
        _assert_rel(db0, rdb0, ATOL, "db0")
        _assert_rel(dbh, rdbh, ATOL, "dbh")


def test_fused_mlp_function_grads_match_autograd_on_cpu():
    """FusedReluMLPFn on CPU tensors: its backward (K3's plain version)
    equals autograd through the plain forward, with the strided cotangent a
    loc/scale split gives; dbout is the cotangent's row sum."""
    x, w0, b0, wh, bh, wout, bout = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                                     _mlp_inputs(12, 30, 6, 16, 2, 2, True))
    args = [x, w0.T.contiguous(), b0, wh.transpose(1, 2).contiguous(), bh,
            wout.T.contiguous(), bout]
    grads = []
    for fn in (lambda *a: FusedReluMLPFn.apply(*a, True),
               lambda *a: fused_relu_mlp_plain(*a, is_res=True)):
        leaves = [a.clone().requires_grad_() for a in args]
        loc, raw = fn(*leaves).split(1, dim=-1)
        (loc.square().sum() + torch.nn.functional.softplus(raw).sum()).backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_mlp_chain_bwd_wrapper_uses_plain_on_cpu():
    x, w0, b0, wh, bh, wout, _ = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                                  _mlp_inputs(13, 11, 5, 8, 1, 2, True))
    g = torch.ones(11, 2)
    args = (x, g, w0.T.contiguous(), b0, wh.transpose(1, 2).contiguous(), bh,
            wout.T.contiguous())
    before = fused_relu_mlp_bwd.launches
    for a, b in zip(fused_relu_mlp_bwd(*args), fused_relu_mlp_bwd_plain(*args)):
        assert torch.equal(a, b)
    assert fused_relu_mlp_bwd.launches == before


def test_setconv_function_backward_matches_pallas_vjp():
    """d_values, d_sigma, d_keys and d_queries of SetConvExpRBFFn (K1's plain
    forward, the tiled recompute backward) against jax.vjp through
    setconv_exprbf_pallas; with an empty-context row and keys that equal
    queries (where JAX's abs has derivative +1)."""
    keys, queries, values, mask, sigma = _setconv_inputs(4, 3, 20, 36, 4, sigma=0.3, empty_rows=[1])
    queries[0, :5] = keys[0, 3:8]  # key == query
    queries[2, 7] = keys[2, 0]
    g = np.random.default_rng(6).normal(size=(3, 36, 5)).astype(np.float32)

    def f(k, q, v, s):
        return sk.setconv_exprbf_pallas(k[..., None], q[..., None], v, jnp.asarray(mask), s)

    _, vjp = jax.vjp(f, jnp.asarray(keys), jnp.asarray(queries), jnp.asarray(values),
                     jnp.float32(sigma))
    rk, rq, rv, rs = (np.asarray(r) for r in vjp(jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (keys, queries, values)]
    sig_t = torch.tensor([sigma], requires_grad=True)
    out_sig, out_den = SetConvExpRBFFn.apply(*leaves, torch.from_numpy(mask.astype(np.float32)),
                                             sig_t, 2)
    assert out_sig.grad_fn is not None
    ((out_sig * torch.from_numpy(g[..., :4])).sum()
     + (out_den * torch.from_numpy(g[..., 4])).sum()).backward()
    for name, a, b in (("keys", leaves[0].grad, rk), ("queries", leaves[1].grad, rq),
                       ("values", leaves[2].grad, rv), ("sigma", sig_t.grad[0], rs)):
        _assert_rel(a.numpy(), b, ATOL, name)
    assert np.all(leaves[2].grad.numpy()[1] == 0.0) and np.all(leaves[0].grad.numpy()[1] == 0.0)


def test_setconv_function_backward_tiles_queries():
    """Q above the 512-query tile: the tiled backward equals autograd through
    the whole plain forward."""
    keys, queries, values, mask, sigma = _setconv_inputs(7, 2, 30, 700, 3, sigma=0.2)
    args = [torch.from_numpy(a) for a in (keys, queries, values)]
    m, s = torch.from_numpy(mask.astype(np.float32)), torch.tensor([sigma])
    g_sig, g_den = torch.randn(2, 700, 3), torch.randn(2, 700)
    grads = []
    for fn in (lambda *a: SetConvExpRBFFn.apply(*a[:3], m, a[3], 2),
               lambda *a: setconv_exprbf_plain(*a[:3], m, a[3])):
        leaves = [a.clone().requires_grad_() for a in (*args, s)]
        sig, den = fn(*leaves)
        ((sig * g_sig).sum() + (den * g_den).sum()).backward()
        grads.append([leaf.grad for leaf in leaves])
    for name, a, b in zip(("keys", "queries", "values", "sigma"), *grads):
        _assert_rel(a.numpy(), b.numpy(), ATOL, name)


def test_require_no_grad_refuses_a_call_that_needs_a_gradient():
    """The check each CUDA launch makes: a tensor that requires grad, with grad
    mode on, is refused (the kernel's output would have no grad_fn)."""
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="require grad"):
        require_no_grad("k", x=torch.ones(3), w=w)
    with torch.no_grad():
        require_no_grad("k", x=torch.ones(3), w=w)
    require_no_grad("k", x=torch.ones(3), w=None)
