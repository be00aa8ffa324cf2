"""The GP benchmark's models in bfloat16 compute against the JAX package's
bf16 models at a small width (r_dim 16; the attention models' transformer
keeps its 8 heads, of 2 features each; the conv family on its 192-point
grid): `gp_model_1d`'s CNP, LNP, AttnCNP, AttnLNP, ConvCNP and ConvLNP, and
the ELBO ConvLNP ablation variant of the notebook architecture (z_dim 16,
`reshaper_z`, its Dense decoder with no dtype: float32 in either dtype),
as `reproduce_gp.py --bf16` builds them. Each port path against its JAX
counterpart: the kernel path (`use_kernels=True`, the chain's plain
version on the CPU) against `fused_mlp=True` (the Pallas chain in
interpret mode), the plain path against the Dense decoder. Eval and train
mode, one function with an empty context; then one bf16 train step's loss
and gradients on the kernel path. This file holds the helpers and the set
family's forwards; tests/test_torch_bf16_gp_conv.py the conv family's
forwards and steps, tests/test_torch_bf16_gp_steps.py the set family's
steps (split so that each file runs in about half a minute).

The inputs come from a numpy seed; a latent model's z noise is JAX's own,
recovered from its forward as (z - loc) / scale in float64 and given to
the port as `eps` (drawn in float32 in either dtype, as in JAX). JAX is
applied op by op so that every bf16 op rounds its result; the float32
reference (for the gap) is jitted.

Bars, tests/test_torch_bf16_slice.py's small-width ones, for its reasons
(both sides round at the same points and sum in float32 in other orders):
loc and scale within 4 bf16 ulps (2^-6) of their largest magnitude, each
function's log-likelihood within 0.5 nats; either, where missed, within
twice JAX's own bf16-float32 distance, as tests/test_torch_bf16_families.py
holds its log-likelihoods and gradients (`_near`). Where that applies: an
untrained ConvLNP in train mode scores -1.5e6 nats a function, where 4
ulps of a scale near its floor move the log-likelihood by thousands; the
ELBO variant in train mode encodes the targets through the first SetConv,
whose float32 sums in another order round one bf16 output apart (1 ulp),
and two train-mode BatchNorm'd grid CNNs over 4 functions carry it to 4.13
ulps of the largest scale. The step:
tests/test_torch_bf16_families.py's rule (`_near`): the loss within 1e-3
of itself, each gradient within 1e-1 of its leaf's largest magnitude (the
BatchNorm-cancelled conv1 biases below 1e-1 of their block's pointwise
weight gradient), or else within twice JAX's own bf16-float32 distance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import losses as jl
from npf_gwwaveform_tpu.configs import gp_model_1d as jax_gp_model_1d
from npf_gwwaveform_tpu.configs import gp_model_variant as jax_gp_model_variant
from npf_gwwaveform_tpu_torch import losses as tl
from npf_gwwaveform_tpu_torch.configs import gp_model_1d, gp_model_variant
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax
from test_torch_bf16_families import _near, ulps_of_max

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
R, B, N = 16, 4, 24
ULPS, LL_ATOL = 4, 0.5
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-3, 1e-1

# name: (JAX model in a dtype, port model in a dtype with or without kernels,
# the training objective)
MODELS = {
    **{n: (lambda dt, n=n: jax_gp_model_1d(n, r_dim=R, dtype=dt),
           lambda dt, uk, n=n: gp_model_1d(n, r_dim=R, dtype=dt, use_kernels=uk),
           {"CNP": "cnpf", "AttnCNP": "cnpf", "ConvCNP": "cnpf", "ConvLNP": "npml"}.get(n, "elbo"))
       for n in ("CNP", "LNP", "AttnCNP", "AttnLNP", "ConvCNP", "ConvLNP")},
    "ConvLNP ELBO notebook": (
        lambda dt: jax_gp_model_variant("ConvLNP", True, False, False, r_dim=R, dtype=dt),
        lambda dt, uk: gp_model_variant("ConvLNP", True, False, False, r_dim=R, dtype=dt,
                                        use_kernels=uk),
        "elbo"),
}
LOSSES = {"cnpf": (jl.CNPFLoss, tl.CNPFLoss), "elbo": (jl.ELBOLossLNPF, tl.ELBOLossLNPF),
          "npml": (jl.NLLLossLNPF, tl.NLLLossLNPF)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def inputs(seed=0):
    """x [B, N, 1] sorted in [-1, 1], y, a context mask with an empty first
    function, every point a target."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, (B, N, 1)), axis=1).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.standard_normal((B, N, 1))).astype(np.float32)
    mask_c = rng.random((B, N)) < 0.4
    mask_c[0] = False
    mask_c[1, :3] = True
    return x, y, mask_c, np.ones((B, N), bool)


@functools.lru_cache(maxsize=None)
def variables(name):
    """The JAX model's initial variables, BatchNorm statistics perturbed."""
    x, y, mc, mt = inputs()
    jm = MODELS[name][0](JBF16)
    v = _np(jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                    x, y, x, y, mask_cntxt=mc, mask_trgt=mt, train=False))
    if "batch_stats" in v:
        rng = np.random.default_rng(3)
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32), v["batch_stats"])
    return v


def port_model(name, use_kernels):
    v = variables(name)
    tm = MODELS[name][1](BF16, use_kernels)
    extra = {"batch_stats": v["batch_stats"]} if "batch_stats" in v else None
    tm.load_state_dict(params_from_flax(v["params"], extra), strict=True)
    return tm


def eps_of(j_out):
    if j_out.z_samples is None:
        return None
    q = j_out.q_zCc if j_out.q_zCct is None else j_out.q_zCct
    z, loc, scale = (np.asarray(a, np.float64) for a in (j_out.z_samples, q.loc, q.scale))
    return torch.from_numpy((z - loc) / scale).float()


def jax_apply(jm, v, data, train, key=2):
    x, y, mc, mt = data
    kw = dict(mask_cntxt=mc, mask_trgt=mt, train=train, rngs={"latent": jax.random.PRNGKey(key)})
    if train and "batch_stats" in v:
        return jm.apply(v, x, y, x, y, mutable=["batch_stats"], **kw)[0]
    return jm.apply(v, x, y, x, y, **kw)


def check_forward(jm, jm32, tm, v, data, train):
    """JAX bf16 op by op against the port in one mode: loc and scale, each
    function's log-likelihood (NPML without importance weights; `_near`
    JAX's float32 model `jm32`, jitted, on the same noise)."""
    x, y, mc, mt = data
    j_out = jax_apply(jm, v, data, train)
    j32 = jax.jit(lambda v_: jax_apply(jm32, v_, data, train))(v)
    tm.train(train)
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in data]
        out = tm(t[0], t[1], t[0], t[2], t[3], y_trgt=t[1], eps=eps_of(j_out))
        ll = -tl.npml_loss(out, t[1], t[3], use_iw=False).numpy()
    ll_ref, ll32 = (-np.asarray(jl.npml_loss(o, y, mt, use_iw=False)) for o in (j_out, j32))
    for field in ("loc", "scale"):
        got = getattr(out.p_yCc, field)
        ref, ref32 = (np.asarray(getattr(o.p_yCc, field)) for o in (j_out, j32))
        assert got.dtype == torch.float32
        ulps = ulps_of_max(got.numpy(), ref)
        ok, d, gap = _near(got.numpy(), ref, ref32, ULPS * 2.0 ** -8 * np.abs(ref).max())
        assert ok, (field, ulps, d, gap)
    ok, d, gap = _near(ll, ll_ref, ll32, LL_ATOL)
    assert ok, (d, gap)


def forward_case(name, use_kernels, train):
    """One model, path and mode (module docstring)."""
    jm = MODELS[name][0](JBF16)
    if use_kernels:
        jm = jm.clone(fused_mlp=True)
    check_forward(jm, MODELS[name][0](None), port_model(name, use_kernels), variables(name),
                  inputs(), train)


SET = ("CNP", "LNP", "AttnCNP", "AttnLNP")
CONV = ("ConvCNP", "ConvLNP", "ConvLNP ELBO notebook")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel path", "plain path"])
@pytest.mark.parametrize("name", SET)
def test_forward_bf16_matches_jax(name, use_kernels, train):
    """The set and attention family (tests/test_torch_bf16_gp_conv.py: the
    conv family)."""
    forward_case(name, use_kernels, train)


def check_step(jm, jm32, tm, v, data, kind):
    """One bf16 train step on the kernel path against JAX's (op by op),
    JAX's float32 step (jitted) giving the gap."""
    x, y, mc, mt = data
    jloss, tloss = (f() for f in LOSSES[kind])
    key = jax.random.PRNGKey(4)

    def loss_fn(model):
        def f(params):
            out = jax_apply(model, {**v, "params": params}, data, True, key=4)
            return jloss(out, y, mt, train=True), out
        return f

    (ref_loss, j_out), ref = jax.value_and_grad(loss_fn(jm), has_aux=True)(v["params"])
    (loss32, _), ref32 = jax.jit(jax.value_and_grad(loss_fn(jm32), has_aux=True))(v["params"])
    del key
    tm.train(True)
    t = [torch.from_numpy(a) for a in data]
    out = tm(t[0], t[1], t[0], t[2], t[3], y_trgt=t[1], eps=eps_of(j_out))
    loss = tloss(out, t[1], t[3], train=True)
    loss.backward()
    ref, ref32 = params_from_flax(_np(ref)), params_from_flax(_np(ref32))
    ok, d, gap = _near(np.float32(loss.item()), np.float32(ref_loss), np.float32(loss32),
                       STEP_LOSS_RTOL * abs(float(ref_loss)))
    assert ok, (loss.item(), float(ref_loss), float(loss32))
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref) and all(g.dtype == torch.float32 for g in grads.values())
    for n, g in grads.items():
        g, r = g.numpy(), ref[n].numpy()
        if ".conv1." in n and n.endswith(".bias"):  # cancelled by the next train-mode BatchNorm
            scale = np.abs(ref[n.rsplit(".", 2)[0] + ".pointwise.weight"].numpy()).max()
            assert np.abs(g).max() <= STEP_GRAD_RTOL * scale, n
        else:
            ok, d, gap = _near(g, r, ref32[n].numpy(), STEP_GRAD_RTOL * np.abs(r).max())
            assert ok, (n, d, gap, np.abs(r).max())


def step_case(name):
    """The kernel path's step against `fused_mlp=True`, the training
    objective of the family (NPVI's ELBO for LNP, AttnLNP and the ELBO
    variant, NPML for ConvLNP); tests/test_torch_bf16_gp_steps.py and
    tests/test_torch_bf16_gp_conv.py run it."""
    jm = MODELS[name][0](JBF16).clone(fused_mlp=True)
    check_step(jm, MODELS[name][0](None), port_model(name, True), variables(name), inputs(1),
               MODELS[name][2])
