"""The set and attention family's models in the port against the JAX package
on the same inputs and parameters, at a small width (r_dim 16; the
attention models' transformer keeps its 8 heads, of 2 features each):
`gp_model_1d`'s CNP, LNP, AttnCNP and AttnLNP, their variants (JAX's CNP
class default xy-encoder, is_heteroskedastic=False, LNP with encoded_path
"both" and with z_dim != r_dim, AttnCNP with a self-attention xy-encoder)
and the objective-ablation and SUMO variants; forwards in eval and train
mode with one function whose context is empty, the NPVI (ELBO), NPML and
SUMO losses, and one train step's gradients for CNP and AttnLNP.

The inputs are made from a numpy seed; a latent model's z noise is JAX's
own, recovered from its forward as (z - loc) / scale in float64 and given
to the port as `eps`. Tolerances: loc and scale 5e-4 absolute (the
predictive bar; measured below 1e-5 on these inputs), losses 1e-4 relative (float32
sums of up to 32 x 24 log-densities in other orders), each gradient 1e-4
of its leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import losses as jl
from npf_gwwaveform_tpu.configs import gp_model_1d as jax_gp_model_1d
from npf_gwwaveform_tpu.configs import gp_model_variant as jax_gp_model_variant
from npf_gwwaveform_tpu.models import AttnCNP as JaxAttnCNP
from npf_gwwaveform_tpu.models import CNP as JaxCNP
from npf_gwwaveform_tpu_torch import losses as tl
from npf_gwwaveform_tpu_torch.configs import gp_model_1d, gp_model_variant
from npf_gwwaveform_tpu_torch.models import CNP, LNP, AttnCNP
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

R, B, N = 16, 4, 24
DIST_ATOL, LOSS_RTOL, GRAD_RTOL = 5e-4, 1e-4, 1e-4


def _inputs(seed=0):
    """x [B, N, 1] sorted in [-1, 1], y, a context mask with an empty first
    function, every point a target."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, (B, N, 1)), axis=1).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.standard_normal((B, N, 1))).astype(np.float32)
    mask_c = rng.random((B, N)) < 0.4
    mask_c[0] = False
    mask_c[1, :3] = True
    return x, y, mask_c, np.ones((B, N), bool)


def _cases():
    """name -> (JAX model, port model) at r_dim R."""
    named = {n: (jax_gp_model_1d(n, r_dim=R), gp_model_1d(n, r_dim=R))
             for n in ("CNP", "LNP", "AttnCNP", "AttnLNP")}
    named.update({
        "CNP default encoder": (JaxCNP(r_dim=R), CNP(r_dim=R)),
        "CNP homoskedastic": (jax_gp_model_1d("CNP", r_dim=R).clone(is_heteroskedastic=False),
                              CNP(r_dim=R, xy_hidden_size=2 * R, is_heteroskedastic=False)),
        "LNP both": (jax_gp_model_1d("LNP", r_dim=R).clone(encoded_path="both"),
                     LNP(r_dim=R, xy_hidden_size=2 * R, encoded_path="both", is_q_zCct=True,
                         n_z_samples_train=1, n_z_samples_test=32)),
        "LNP z_dim 8": (jax_gp_model_1d("LNP", r_dim=R).clone(z_dim=8),
                        LNP(r_dim=R, xy_hidden_size=2 * R, z_dim=8, is_q_zCct=True,
                            n_z_samples_train=1, n_z_samples_test=32)),
        "AttnCNP self-attention": (JaxAttnCNP(r_dim=R, attention="transformer", is_self_attn=True),
                                   AttnCNP(r_dim=R, attention="transformer", is_self_attn=True)),
        "LNP NPML": (jax_gp_model_variant("LNP", False, False, False, r_dim=R),
                     gp_model_variant("LNP", False, False, False, r_dim=R)),
        "AttnLNP NPML": (jax_gp_model_variant("AttnLNP", False, True, True, r_dim=R),
                         gp_model_variant("AttnLNP", False, True, True, r_dim=R)),
        "AttnLNP ELBO": (jax_gp_model_variant("AttnLNP", True, False, True, r_dim=R),
                         gp_model_variant("AttnLNP", True, False, True, r_dim=R)),
    })
    return named


CASES = _cases()
# the training objective of each case
LOSSES = {"LNP NPML": "npml", "AttnLNP NPML": "npml", "LNP SUMO": "sumo"}


def _loss_pair(name, model):
    kind = LOSSES.get(name, "elbo" if model.has_latent else "cnpf")
    return {"cnpf": (jl.CNPFLoss(), tl.CNPFLoss()), "elbo": (jl.ELBOLossLNPF(), tl.ELBOLossLNPF()),
            "npml": (jl.NLLLossLNPF(), tl.NLLLossLNPF()),
            "sumo": (jl.SUMOLossLNPF(), tl.SUMOLossLNPF())}[kind]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _setup(jm, tm, train):
    x, y, mc, mt = _inputs()
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}, x, y, x, y,
                mask_cntxt=mc, mask_trgt=mt, train=True)
    tm.load_state_dict(params_from_flax(_np(v["params"])), strict=True)
    tm.train(train)
    return v, (x, y, mc, mt)


def _eps(j_out):
    if j_out.z_samples is None:
        return None
    q = j_out.q_zCc if j_out.q_zCct is None else j_out.q_zCct
    z, loc, scale = (np.asarray(a, np.float64) for a in (j_out.z_samples, q.loc, q.scale))
    return torch.from_numpy((z - loc) / scale).float()


def _port_out(tm, data, j_out):
    x, y, mc, mt = (torch.from_numpy(a) for a in data)
    return tm(x, y, x, mc, mt, y_trgt=y, eps=_eps(j_out))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_losses_match_jax(name, train):
    jm, tm = CASES[name]
    v, data = _setup(jm, tm, train)
    x, y, mc, mt = data
    j_out = jm.apply(v, x, y, x, y, mask_cntxt=mc, mask_trgt=mt, train=train,
                     rngs={"latent": jax.random.PRNGKey(2)})
    with torch.no_grad():
        out = _port_out(tm, data, j_out)
    for field in ("loc", "scale"):
        np.testing.assert_allclose(getattr(out.p_yCc, field).numpy(),
                                   np.asarray(getattr(j_out.p_yCc, field)), atol=DIST_ATOL,
                                   rtol=0, err_msg=f"{name} {field}")
    if tm.has_latent:
        assert out.z_samples.shape == j_out.z_samples.shape
        assert (out.q_zCct is None) == (j_out.q_zCct is None)
    jloss, tloss = _loss_pair(name, tm)
    yt, mtt = torch.from_numpy(y), torch.from_numpy(mt)
    for mode in (True, False):  # the train loss and the eval NPML
        ref = float(jloss(j_out, y, mt, train=mode))
        got = tloss(out, yt, mtt, train=mode).item()
        assert abs(got - ref) <= LOSS_RTOL * abs(ref), (name, mode, got, ref)


def test_empty_context_gives_the_zero_representation():
    """CNP's pooled R and AttnCNP's multihead cross-attention (before the
    transformer block adds the queries) are exactly zero for the function
    whose context is empty, and the gradients through them finite."""
    for name in ("CNP", "AttnCNP"):
        _, tm = CASES[name]
        x, y, mc, mt = (torch.from_numpy(a) for a in _inputs())
        x_c = tm.x_encoder(x)
        R = tm.encode_globally(x_c, y, mc)
        if name == "CNP":
            R_trgt = tm.trgt_dependent_representation(x_c, None, R, x_c, mc)
        else:
            R_trgt = tm.attender.multihead(x_c, x_c, R, mask_keys=mc)
        assert torch.all(R_trgt[..., 0, :, :] == 0), name
        R_trgt.square().sum().backward()
        assert all(torch.isfinite(p.grad).all() for p in tm.parameters() if p.grad is not None)
        tm.zero_grad()


def test_sumo_loss_matches_jax():
    """SUMO on LNP's NPML variant (32 draws > m = 5)."""
    jm = jax_gp_model_variant("LNP", False, True, True, r_dim=R)
    tm = gp_model_variant("LNP", False, True, True, r_dim=R)
    v, data = _setup(jm, tm, True)
    x, y, mc, mt = data
    j_out = jm.apply(v, x, y, x, y, mask_cntxt=mc, mask_trgt=mt, train=True,
                     rngs={"latent": jax.random.PRNGKey(3)})
    assert j_out.z_samples.shape[0] == 32
    with torch.no_grad():
        out = _port_out(tm, data, j_out)
    ref = float(jl.SUMOLossLNPF()(j_out, y, mt, train=True))
    got = tl.SUMOLossLNPF()(out, torch.from_numpy(y), torch.from_numpy(mt), train=True).item()
    assert abs(got - ref) <= LOSS_RTOL * abs(ref)


@pytest.mark.parametrize("n_z", [8, 32, 200])
def test_sumo_weights_made_on_the_device_equal_the_host_ones(n_z):
    """SUMO's count-law weights, made with torch ops on the loss's device
    (so that a CUDA graph captures the SUMO step with no host copy), equal
    the float64 numpy ones rounded to float32, both branches of the law."""
    got = tl._inv_weights(n_z, 5, 85, "cpu")[:, 0].numpy()
    assert np.array_equal(got, tl.light_tail_pareto_inv_weights(n_z, 5, 85).astype(np.float32))


@pytest.mark.parametrize("name", ["CNP", "AttnLNP"])
def test_train_step_gradients_match_jax(name):
    """The train loss's gradient with respect to every parameter (AttnLNP:
    NPVI, one draw from q(z|C,T), JAX's noise)."""
    jm, tm = CASES[name]
    v, data = _setup(jm, tm, True)
    x, y, mc, mt = data
    jloss, tloss = _loss_pair(name, tm)
    key = jax.random.PRNGKey(4)

    def loss_fn(p):
        out = jm.apply({"params": p}, x, y, x, y, mask_cntxt=mc, mask_trgt=mt, train=True,
                       rngs={"latent": key})
        return jloss(out, y, mt, train=True), out

    (j_loss, j_out), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    out = _port_out(tm, data, j_out)
    loss = tloss(out, torch.from_numpy(y), torch.from_numpy(mt), train=True)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    ref = params_from_flax(_np(j_grads))
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(ref) == set(grads)
    for n, g in grads.items():
        assert (g - ref[n]).abs().max() <= GRAD_RTOL * ref[n].abs().max().clamp_min(1e-6), n


@pytest.mark.parametrize("name", ["AttnCNP self-attention", "AttnLNP", "LNP z_dim 8"])
def test_parameters_round_trip_to_the_flax_tree(name):
    """`flax_from_params` writes the port's state dict back as JAX's own
    parameter tree, leaf for leaf: MergeFlatInputs' inner `MLP_0` or
    `SelfAttention_0`, the attender's LayerNorm `scale`, `reshaper_z`."""
    from npf_gwwaveform_tpu_torch.training.checkpoint import _flatten, flax_from_params

    jm, tm = CASES[name]
    v, _ = _setup(jm, tm, False)
    got, extra = flax_from_params(tm.state_dict(), [])
    ref = dict(_flatten(_np(v["params"])))
    got = dict(_flatten(got))
    assert extra == {} and got.keys() == ref.keys()
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
