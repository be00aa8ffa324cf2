"""GridConvCNP and GridConvLNP in the port against the JAX package on the
same numpy inputs and parameters, at a small width (r_dim 16, two blocks of
two conv layers, k = 3, the AbsConv at k = 5, 8x8 canvases of one and
three channels, SAME and CIRCULAR padding): GridConvCNP, and GridConvLNP
with the `latent` path (with and without `is_global`) on 2-D grids and the
`both` path (with and without `is_global`) on a 1-D grid of 12 points,
where the JAX package's own reshape admits it (on a 2-D grid it refuses
`both`, and the port with it). Forwards in eval mode (BatchNorm statistics
perturbed away from their init) and train mode (with the statistics they
move), one image of each batch with an empty context; one train step's
loss, gradients and statistics (CNPF for GridConvCNP, NPML for
GridConvLNP).

A latent model's z noise is JAX's own, recovered from its forward as (z -
loc) / scale in float64 and given to the port as `eps`. Tolerances: loc and
scale 5e-4 absolute; losses 1e-4 relative; each gradient 1e-4 of its
leaf's largest magnitude (a bias that the next train-mode BatchNorm
cancels, whose gradient is rounding noise, 1e-4 of the largest gradient's);
the moved statistics 1e-5.
"""

import jax
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

torch.set_num_threads(1)

R, B = 16, 3
DIST_ATOL, LOSS_RTOL, GRAD_RTOL, STATS_ATOL = 5e-4, 1e-4, 1e-4, 1e-5


def _jax_cnn(padding):
    def make(r_dim, name=None):
        return JaxCNN(n_channels=r_dim, n_blocks=2, kernel_size=3, norm="batch", padding=padding,
                      block_kwargs={"n_conv_layers": 2, "norm_eps": 1e-3}, name=name)
    return make


def _pair(kind, y_dim=1, padding="SAME", is_global=False, n_spatial=2):
    """(JAX model, port model) of a case."""
    jkw = dict(y_dim=y_dim, x_dim=1, r_dim=R, CNNFactory=_jax_cnn(padding), conv_kernel_size=5,
               conv_padding=padding)
    tkw = dict(y_dim=y_dim, r_dim=R, cnn_n_blocks=2, cnn_kernel_size=3, conv_kernel_size=5,
               conv_padding=padding, n_spatial=n_spatial)
    if kind == "cnp":
        return JaxGridConvCNP(**jkw), GridConvCNP(**tkw)
    path = "both" if kind == "both" else "latent"
    lat = dict(encoded_path=path, is_global=is_global, n_z_samples_train=2, n_z_samples_test=3)
    return JaxGridConvLNP(**jkw, **lat), GridConvLNP(**tkw, **lat)


CASES = {
    "cnp": dict(kind="cnp"),
    "cnp rgb circular": dict(kind="cnp", y_dim=3, padding="CIRCULAR"),
    "lnp latent": dict(kind="latent"),
    "lnp latent global circular": dict(kind="latent", is_global=True, padding="CIRCULAR"),
    "lnp latent global rgb": dict(kind="latent", is_global=True, y_dim=3),
    "lnp both 1-D": dict(kind="both", n_spatial=1),
    "lnp both global 1-D": dict(kind="both", is_global=True, n_spatial=1),
}


def _inputs(case, seed=0):
    """y [B, *grid, y_dim] in [0, 1], the context mask [B, *grid] (the first
    image's empty), every pixel a target."""
    rng = np.random.default_rng(seed)
    grid = (8, 8) if case.get("n_spatial", 2) == 2 else (12,)
    y = rng.uniform(0, 1, (B,) + grid + (case.get("y_dim", 1),)).astype(np.float32)
    mask_c = rng.random((B,) + grid) < 0.3
    mask_c[0] = False
    return y, mask_c, np.ones((B,) + grid, bool)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _perturbed_stats(stats, rng):
    def move(path, a):
        a = np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)).astype(np.float32)
        return np.abs(a) + 0.5 if path[-1].key == "var" else a
    return jax.tree_util.tree_map_with_path(move, stats)


def _setup(name, train):
    case = CASES[name]
    jm, tm = _pair(**case)
    y, mc, mt = _inputs(case)
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                mc[..., None], y, mt[..., None], y, mask_cntxt=mc, mask_trgt=mt, train=False)
    v = {"params": _np(v["params"]),
         "batch_stats": _perturbed_stats(_np(v["batch_stats"]), np.random.default_rng(1))}
    tm.load_state_dict(params_from_flax(v["params"], {"batch_stats": v["batch_stats"]}),
                       strict=True)
    tm.train(train)
    return jm, tm, v, (y, mc, mt)


def _eps(j_out):
    if j_out.z_samples is None:
        return None
    z, loc, scale = (np.asarray(a, np.float64) for a in (j_out.z_samples, j_out.q_zCc.loc,
                                                          j_out.q_zCc.scale))
    return torch.from_numpy((z - loc) / scale).float()


def _port(tm, data, eps):
    y, mc, mt = (torch.from_numpy(a) for a in data)
    return tm(mc[..., None], y, mt[..., None], mc, mt, y_trgt=y, eps=eps)


def _jax(jm, v, data, train, key=2):
    y, mc, mt = data
    out = jm.apply(v, mc[..., None], y, mt[..., None], y, mask_cntxt=mc, mask_trgt=mt,
                   train=train, rngs={"latent": jax.random.PRNGKey(key)},
                   mutable=["batch_stats"] if train else False)
    return out if train else (out, None)


def _check_stats(tm, new):
    stats = params_from_flax({}, {"batch_stats": _np(new["batch_stats"])})
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[k].numpy(), atol=STATS_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name, train):
    jm, tm, v, data = _setup(name, train)
    j_out, new = _jax(jm, v, data, train)
    with torch.no_grad():
        out = _port(tm, data, _eps(j_out))
    assert out.p_yCc.loc.shape == j_out.p_yCc.loc.shape
    for field in ("loc", "scale"):
        np.testing.assert_allclose(getattr(out.p_yCc, field).numpy(),
                                   np.asarray(getattr(j_out.p_yCc, field)), atol=DIST_ATOL,
                                   rtol=0, err_msg=f"{name} {field}")
    if new is not None:
        _check_stats(tm, new)


def test_both_path_on_a_2d_grid_is_refused_as_in_jax():
    """JAX's GridConvLNP averages R over the last spatial axis only for
    `both` and cannot reshape that to one latent an image; the port fails
    there too instead of computing something JAX does not."""
    jm, _ = _pair("both")
    tm = GridConvLNP(r_dim=R, cnn_n_blocks=2, cnn_kernel_size=3, conv_kernel_size=5,
                     encoded_path="both", n_z_samples_test=3).eval()
    y, mc, mt = _inputs({})
    with pytest.raises(TypeError):
        jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                mc[..., None], y, mt[..., None], y, mask_cntxt=mc, mask_trgt=mt, train=False)
    with pytest.raises(RuntimeError), torch.no_grad():
        _port(tm, (y, mc, mt), None)


def test_empty_context_gives_zero_signal_and_density():
    """The image without context pixels: the AbsConv's signal and density
    are exactly zero, so the resizer sees only its bias, and nothing is
    NaN."""
    _, tm, _, data = _setup("cnp", False)
    y, mc, _ = (torch.from_numpy(a) for a in data)
    with torch.no_grad():
        mask = mc[..., None].float()
        assert torch.all(tm.conv(y * mask)[0] == 0) and torch.all(tm.conv(mask)[0] == 0)
        R = tm.cntxt_to_induced(mc[..., None], y)
        assert torch.allclose(R[0], tm.resizer.bias.expand_as(R[0]))
        out = _port(tm, data, None)
    assert torch.isfinite(out.p_yCc.loc).all() and torch.isfinite(out.p_yCc.scale).all()


@pytest.mark.parametrize("name", ["cnp", "cnp rgb circular", "lnp latent global circular"])
def test_train_step_matches_jax(name):
    """The train loss (CNPF, or NPML at two draws), its gradient with
    respect to every parameter, and the statistics the step moves."""
    jm, tm, v, data = _setup(name, True)
    y, mc, mt = data
    jloss, tloss = ((jl.CNPFLoss(), tl.CNPFLoss()) if name.startswith("cnp") else
                    (jl.NLLLossLNPF(), tl.NLLLossLNPF()))

    def loss_fn(p):
        out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, mc[..., None], y,
                            mt[..., None], y, mask_cntxt=mc, mask_trgt=mt, train=True,
                            rngs={"latent": jax.random.PRNGKey(4)}, mutable=["batch_stats"])
        return jloss(out, y, mt, train=True), (out, new)

    (ref, (j_out, new)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    out = _port(tm, data, _eps(j_out))
    loss = tloss(out, torch.from_numpy(y), torch.from_numpy(mt), train=True)
    loss.backward()
    assert abs(loss.item() - float(ref)) <= LOSS_RTOL * abs(float(ref)), (loss.item(), ref)
    ref_grads = params_from_flax(_np(grads))
    top = max(np.abs(g.numpy()).max() for g in ref_grads.values())
    for k, p in tm.named_parameters():
        g = ref_grads[k].numpy()
        scale = np.abs(g).max() if np.abs(g).max() > 1e-3 * top else top
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_RTOL * scale, rtol=0, err_msg=k)
    _check_stats(tm, new)


def test_decoders_are_the_chain_and_a_dense():
    """GridConvCNP decodes with the MLP chain (K2/K3 on the card), GridConvLNP
    with a Dense of its own; the parameter trees are JAX's names."""
    _, tm_c = _pair("cnp")
    _, tm_l = _pair("latent", is_global=True)
    assert tm_c.decoder.module.fused and type(tm_l.decoder.module).__name__ == "Dense"
    jm, _ = _pair("latent", is_global=True)
    y, mc, mt = _inputs({})
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                mc[..., None], y, mt[..., None], y, mask_cntxt=mc, mask_trgt=mt, train=False)
    assert set(params_from_flax(_np(v["params"]))) == {k for k, _ in tm_l.named_parameters()}
