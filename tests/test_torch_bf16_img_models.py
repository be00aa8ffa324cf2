"""GridConvCNP and GridConvLNP in bfloat16 compute against the JAX package's
bf16 models at a small width (r_dim 16, two 2-D blocks of two conv layers,
k = 3, the AbsConv at k = 5, 8x8 canvases): GridConvCNP with one channel
and SAME padding, and with three channels and CIRCULAR padding, and
GridConvLNP with a global latent (`reproduce_img.py`'s), each with
`dtype=bfloat16` as `build_model(name, dtype=jnp.bfloat16)` builds it.
The kernel path (`use_kernels=True`, the chain's plain version on the
CPU) against `fused_mlp=True` (the Pallas chain in interpret mode), the
plain path against the Dense decoder (GridConvLNP's decoder is a Dense
either way); eval mode on perturbed BatchNorm statistics and train mode,
the first image's context empty; then one bf16 train step on the kernel
path. The AbsConv, the density floor and the division compute in float32
(the grid's values), as in JAX.

JAX is applied op by op; a latent model's z noise is JAX's own, given to
the port as `eps`. Bars: tests/test_torch_bf16_gp_models.py's, for its
reasons: loc and scale within 4 bf16 ulps of their largest magnitude, each
image's log-likelihood within 0.5 nats, either, where missed, within twice
JAX's own bf16-float32 distance (`_near`); the step's loss 1e-3 of itself
and each gradient 1e-1 of its leaf's largest magnitude, or that distance
rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import losses as jl
from npf_gwwaveform_tpu.models import GridConvCNP as JaxGridConvCNP
from npf_gwwaveform_tpu.models import GridConvLNP as JaxGridConvLNP
from npf_gwwaveform_tpu.ops.cnn import CNN as JaxCNN
from npf_gwwaveform_tpu_torch import losses as tl
from npf_gwwaveform_tpu_torch.models import GridConvCNP, GridConvLNP
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax
from test_torch_bf16_families import _near
from test_torch_bf16_gp_models import LL_ATOL, STEP_GRAD_RTOL, STEP_LOSS_RTOL, ULPS

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
R, B = 16, 3
CASES = {"cnp": dict(kind="cnp"), "cnp rgb circular": dict(kind="cnp", y_dim=3,
                                                             padding="CIRCULAR"),
         "lnp global": dict(kind="lnp")}


def _models(case, dt, use_kernels=True):
    """(JAX model in compute dtype dt, port model in bf16) of a case."""
    y_dim, padding = case.get("y_dim", 1), case.get("padding", "SAME")

    def cnn(r_dim, name=None):
        return JaxCNN(n_channels=r_dim, n_blocks=2, kernel_size=3, norm="batch", padding=padding,
                      block_kwargs={"n_conv_layers": 2, "norm_eps": 1e-3}, dtype=dt, name=name)
    jkw = dict(y_dim=y_dim, x_dim=1, r_dim=R, CNNFactory=cnn, conv_kernel_size=5,
               conv_padding=padding, dtype=dt)
    tkw = dict(y_dim=y_dim, r_dim=R, cnn_n_blocks=2, cnn_kernel_size=3, conv_kernel_size=5,
               conv_padding=padding, use_kernels=use_kernels, dtype=BF16)
    if case["kind"] == "cnp":
        return JaxGridConvCNP(**jkw), GridConvCNP(**tkw)
    lat = dict(is_global=True, n_z_samples_train=2, n_z_samples_test=3)
    return JaxGridConvLNP(**jkw, **lat), GridConvLNP(**tkw, **lat)


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, 1, (B, 8, 8, case.get("y_dim", 1))).astype(np.float32)
    mask_c = rng.random((B, 8, 8)) < 0.3
    mask_c[0] = False
    return y, mask_c, np.ones((B, 8, 8), bool)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@functools.lru_cache(maxsize=None)
def _variables(name):
    case = CASES[name]
    jm, _ = _models(case, JBF16)
    y, mc, mt = _inputs(case)
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                mc[..., None], y, mt[..., None], y, mask_cntxt=mc, mask_trgt=mt, train=False)
    rng = np.random.default_rng(1)

    def move(path, a):
        a = np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)).astype(np.float32)
        return np.abs(a) + 0.5 if path[-1].key == "var" else a
    return {"params": _np(v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(move, _np(v["batch_stats"]))}


def _setup(name, use_kernels, dt=JBF16):
    jm, tm = _models(CASES[name], dt, use_kernels)
    v = _variables(name)
    tm.load_state_dict(params_from_flax(v["params"], {"batch_stats": v["batch_stats"]}),
                       strict=True)
    return jm, tm, v


def _eps(j_out):
    if j_out.z_samples is None:
        return None
    z, loc, scale = (np.asarray(a, np.float64) for a in (j_out.z_samples, j_out.q_zCc.loc,
                                                          j_out.q_zCc.scale))
    return torch.from_numpy((z - loc) / scale).float()


def _jax(jm, v, data, train, key=2):
    y, mc, mt = data
    out = jm.apply(v, mc[..., None], y, mt[..., None], y, mask_cntxt=mc, mask_trgt=mt,
                   train=train, rngs={"latent": jax.random.PRNGKey(key)},
                   mutable=["batch_stats"] if train else False)
    return out[0] if train else out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel path", "plain path"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_bf16_matches_jax(name, use_kernels, train):
    jm, tm, v = _setup(name, use_kernels)
    if use_kernels:
        jm = jm.clone(fused_mlp=True)
    jm32 = _models(CASES[name], None)[0]
    data = _inputs(CASES[name])
    y, mc, mt = data
    j_out = _jax(jm, v, data, train)
    j32 = jax.jit(lambda v_: _jax(jm32, v_, data, train))(v)
    tm.train(train)
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in data]
        out = tm(t[1][..., None], t[0], t[2][..., None], t[1], t[2], y_trgt=t[0],
                 eps=_eps(j_out))
        ll = -tl.npml_loss(out, t[0], t[2], use_iw=False).numpy()
    for field in ("loc", "scale"):
        got = getattr(out.p_yCc, field).numpy()
        ref, ref32 = (np.asarray(getattr(o.p_yCc, field)) for o in (j_out, j32))
        ok, d, gap = _near(got, ref, ref32, ULPS * 2.0 ** -8 * np.abs(ref).max())
        assert ok, (field, d, gap)
    ll_ref, ll32 = (-np.asarray(jl.npml_loss(o, y, mt, use_iw=False)) for o in (j_out, j32))
    ok, d, gap = _near(ll, ll_ref, ll32, LL_ATOL)
    assert ok, (d, gap)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_bf16_matches_jax(name):
    """The kernel path's step (CNPF, or NPML at two draws) against
    `fused_mlp=True`, JAX's float32 step giving the gap."""
    jm, tm, v = _setup(name, True)
    jm = jm.clone(fused_mlp=True)
    jm32 = _models(CASES[name], None)[0]
    data = _inputs(CASES[name], 1)
    y, mc, mt = data
    jloss, tloss = ((jl.CNPFLoss(), tl.CNPFLoss()) if CASES[name]["kind"] == "cnp" else
                    (jl.NLLLossLNPF(), tl.NLLLossLNPF()))

    def loss_fn(model):
        def f(p):
            out = _jax(model, {"params": p, "batch_stats": v["batch_stats"]}, data, True, key=4)
            return jloss(out, y, mt, train=True), out
        return f

    (ref_loss, j_out), ref = jax.value_and_grad(loss_fn(jm), has_aux=True)(v["params"])
    (loss32, _), ref32 = jax.jit(jax.value_and_grad(loss_fn(jm32), has_aux=True))(v["params"])
    tm.train(True)
    t = [torch.from_numpy(a) for a in data]
    out = tm(t[1][..., None], t[0], t[2][..., None], t[1], t[2], y_trgt=t[0], eps=_eps(j_out))
    loss = tloss(out, t[0], t[2], train=True)
    loss.backward()
    ok, d, gap = _near(np.float32(loss.item()), np.float32(ref_loss), np.float32(loss32),
                       STEP_LOSS_RTOL * abs(float(ref_loss)))
    assert ok, (loss.item(), float(ref_loss), float(loss32))
    ref, ref32 = params_from_flax(_np(ref)), params_from_flax(_np(ref32))
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    for n, g in grads.items():
        g, r = g.numpy(), ref[n].numpy()
        if ".conv1." in n and n.endswith(".bias"):  # cancelled by the next train-mode BatchNorm
            scale = np.abs(ref[n.rsplit(".", 2)[0] + ".pointwise.weight"].numpy()).max()
            assert np.abs(g).max() <= STEP_GRAD_RTOL * scale, n
        else:
            ok, d, gap = _near(g, r, ref32[n].numpy(), STEP_GRAD_RTOL * np.abs(r).max())
            assert ok, (n, d, gap, np.abs(r).max())
