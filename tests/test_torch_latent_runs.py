"""The four GW ConvLNP runs in `results/` in the port: each loads strictly,
its parameter tree in flax's layout read back as it was written; each is
scored at full width on its first recorded waveforms against the JAX
package's arithmetic on the same inputs and the same z noise, in float32
and in bfloat16; `score` prints its JSON line for each; the three training
configurations (NPML, ELBO, the unbounded q(z) scale) give the records'
summaries and directory tags, their criteria and `reproduce_gw.py`'s default
clip of 1.0, and two CPU steps of the ELBO one run through `train_gw`; the
new modules start from flax's init schemes.

The z noise is JAX's own, recovered from the NPFOutput of its float32
forward as (z - loc) / scale in float64 and given to the port (`eps=`);
JAX's bf16 forward on the same latent key draws the same noise (it is
drawn in float32 whatever the dtype). The split is drawn with numpy from
a seed: U{0..64} context points a waveform, every point a target.

Tolerances:
- float32, port against JAX: loc and scale 5e-4 absolute (the predictive
  bar; measured at most 2.2e-5), the NPML log-likelihood 1e-5 relative
  (measured at most 1.2e-6: float32 sums in other orders);
- bfloat16: the port's bf16 loc against JAX's bf16 loc (op by op, so that
  every bf16 op rounds its result) within JAX's own bf16-float32 distance
  (RMS), the port's own bf16-float32 distance within twice it, and each
  waveform's log-likelihood within the larger of JAX's own bf16-float32
  difference and 0.5 nats of JAX's bf16 one: the two sides' float32 sums
  run in other orders, which moves some bf16 roundings through two
  BatchNorm'd CNNs, and two independent bf16 roundings of one float32
  computation lie up to about twice one's distance from it apart
  (`tests/test_torch_bf16_families.py`'s GAP_SHARE). Measured: loc at most
  0.59 of JAX's gap, the port's own gap 1.01 of JAX's, the LL at most 0.28
  nats from JAX's bf16 (JAX's own gaps 0.002-3.9 nats);
- init schemes: each weight's standard deviation within 5% of the JAX
  scheme's at the same flax shape (tens of thousands of draws), biases zero.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import losses as jax_losses
from npf_gwwaveform_tpu.configs import _cnn_factory, gp_model_1d
from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_model_from_summary
from npf_gwwaveform_tpu.models.convnp import ConvLNP as JaxConvLNP
from npf_gwwaveform_tpu.utils import init as jax_init
from npf_gwwaveform_tpu_torch import score, train_gw
from npf_gwwaveform_tpu_torch.configs import (
    criterion_from_summary, default_clip, gw_model_from_summary, gw_train_summary, run_tag,
    train_config,
)
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.losses import CNPFLoss, ELBOLossLNPF, NLLLossLNPF
from npf_gwwaveform_tpu_torch.models.convnp import ConvLNP
from npf_gwwaveform_tpu_torch.training.checkpoint import (
    _flatten, flax_from_params, load_run_params,
)
from npf_gwwaveform_tpu_torch.utils import init as winit

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
RUNS = {
    "npml": os.path.join("GW_time_cond_film_ctx64", "ConvLNP", "run_0"),
    "elbo": os.path.join("GW_time_cond_film_ctx64_elbo", "ConvLNP", "run_0"),
    "latlbF run_0": os.path.join("GW_time_cond_film_ctx64_latlbF", "ConvLNP", "run_0"),
    "latlbF run_1": os.path.join("GW_time_cond_film_ctx64_latlbF", "ConvLNP", "run_1"),
}
# each training configuration's `train_gw` flags, as gw_train_summary's arguments
CONFIGS = {
    "npml": dict(),
    "elbo": dict(loss="elbo"),
    "latlbF run_0": dict(no_lat_lb=True),
}
N_WF = 2
DIST_ATOL, LL_RTOL = 5e-4, 1e-5
INIT_STD_RTOL = 5e-2


def _summary(run):
    with open(os.path.join(RESULTS, RUNS[run], "summary.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("run", list(RUNS))
def test_run_loads_strictly_and_round_trips(run):
    """`score.load_model` loads the run with strict=True (the decoder's
    `decoder/Dense_0` included) and its state dict writes back the flax
    tree it was read from, leaf for leaf."""
    run_dir = os.path.join(RESULTS, RUNS[run])
    model = score.load_model(run_dir, "cpu")
    summary = _summary(run)
    assert isinstance(model, ConvLNP) and model.is_global and not model.training
    assert model.is_q_zCct == (summary.get("train_loss_objective") == "elbo")
    assert model.lat_scale_transform == ("softplus" if summary.get("no_lat_lb") else "sigmoid")
    assert (model.n_z_samples_train, model.n_z_samples_test) == (
        (1, 32) if model.is_q_zCct else (16, 32))
    params, extra = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    ref_params, ref_extra = load_run_params(run_dir)
    for got, ref in ((params, ref_params), (extra, ref_extra)):
        got, ref = dict(_flatten(got)), dict(_flatten(ref))
        assert got.keys() == ref.keys()
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    assert ("decoder", "Dense_0", "kernel") in dict(_flatten(ref_params))


def _jax_models(summary):
    """(float32, bf16) JAX models of the run, XLA SetConv; the bf16 one as
    `reproduce_gw.py --bf16` builds it."""
    f32 = jax_model_from_summary(summary).clone(use_pallas_setconv=False)
    bf16 = gp_model_1d("ConvLNP", dtype=jnp.bfloat16).clone(
        cond_dim=4, cond_mode="film",
        **({"lat_scale_transform": "softplus", "min_lat_sigma": 1e-4}
           if summary.get("no_lat_lb") else {}),
        **({"is_q_zCct": True, "n_z_samples_train": 1}
           if summary.get("train_loss_objective") == "elbo" else {}))
    return f32, bf16


def _batch(run_dir, summary):
    """The first N_WF recorded waveforms, a numpy-drawn split (U{0..n_context}
    context points each), all points as targets, the normalised parameters."""
    theta = torch.from_numpy(score.read_run_thetas(run_dir)[:N_WF])
    space = GWParameterSpace()
    x, y, cond = score.make_eval_batch(theta, score.run_generator(summary), space)
    rng = np.random.default_rng(7)
    mask_c = np.zeros(x.shape[:2], bool)
    for i in range(N_WF):
        n = rng.integers(0, summary["n_context"] + 1)
        mask_c[i, rng.choice(x.shape[1], size=n, replace=False)] = True
    return x.numpy(), y.numpy(), mask_c, cond.numpy()


@pytest.mark.parametrize("run", list(RUNS))
def test_run_scores_match_jax(run):
    """The run in eval mode at 32 draws a waveform: the predictive, q(z|C)
    (and the ELBO run's q(z|C,T), from its targets) and the NPML
    log-likelihood in float32 against JAX on JAX's noise; then in bf16,
    each side's bf16 against its float32, the port's within JAX's own gap."""
    run_dir = os.path.join(RESULTS, RUNS[run])
    summary = _summary(run)
    x, y, mask_c, cond = _batch(run_dir, summary)
    mask_t = np.ones(x.shape[:2], bool)
    variables = {"params": load_run_params(run_dir)[0], **load_run_params(run_dir)[1]}
    key = jax.random.PRNGKey(3)

    def jax_forward(model):
        out = model.apply(variables, x, y, x, y, mask_c, mask_t, condition=cond, train=False,
                          rngs={"latent": key})
        return out, -jax_losses.CNPFLoss(reduction=None)(out, y, mask_t, train=False)

    jm32, jm16 = _jax_models(summary)
    j32, jll32 = jax.jit(lambda: jax_forward(jm32))()
    jll32 = np.asarray(jll32, np.float64)
    q = j32.q_zCc if j32.q_zCct is None else j32.q_zCct
    assert (j32.q_zCct is not None) == (run == "elbo")
    eps = torch.from_numpy((np.asarray(j32.z_samples, np.float64) - np.asarray(q.loc, np.float64))
                           / np.asarray(q.scale, np.float64)).float()

    def port_forward(dtype):
        model = score.load_model(run_dir, "cpu", dtype=dtype)
        xt, yt, mct, ct = (torch.from_numpy(a) for a in (x, y, mask_c, cond))
        with torch.no_grad():
            out = model(xt, yt, xt, mct, torch.ones_like(mct), ct, y_trgt=yt, eps=eps)
            ll = -CNPFLoss(reduction=None)(out, yt, torch.ones_like(mct), train=False)
        return out, ll.double().numpy()

    t32, tll32 = port_forward(None)
    assert t32.p_yCc.loc.shape == (32, N_WF, 256, 1)
    for name in ("p_yCc", "q_zCc", "q_zCct"):
        jd, td = getattr(j32, name), getattr(t32, name)
        if jd is None:
            assert td is None
            continue
        for field in ("loc", "scale"):
            np.testing.assert_allclose(getattr(td, field).numpy(), np.asarray(getattr(jd, field)),
                                       atol=DIST_ATOL, rtol=0, err_msg=f"{name}.{field}")
    np.testing.assert_allclose(tll32, jll32, rtol=LL_RTOL)

    j16, jll16 = jax_forward(jm16)  # op by op: each bf16 op rounds its result
    jll16 = np.asarray(jll16, np.float64)
    t16, tll16 = port_forward(torch.bfloat16)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    jloc16, jloc32 = np.asarray(j16.p_yCc.loc, np.float64), np.asarray(j32.p_yCc.loc, np.float64)
    gap = rms(jloc16 - jloc32)
    assert gap > 0
    assert rms(t16.p_yCc.loc.double().numpy() - jloc16) <= gap
    assert rms(t16.p_yCc.loc.double().numpy() - t32.p_yCc.loc.double().numpy()) <= 2 * gap
    assert np.all(np.abs(tll16 - jll16) <= np.maximum(np.abs(jll16 - jll32), 0.5))


@pytest.mark.parametrize("run", list(RUNS))
def test_score_prints_its_json_line(run, capsys):
    """`python -m npf_gwwaveform_tpu_torch.score --device cpu --run-dir RUN
    --n-test 2` (2 waveforms of 32 draws on the CPU): one JSON line with the
    per-draw mismatch beside the mixture's."""
    res = score.main(["--device", "cpu", "--run-dir", os.path.join(RESULTS, RUNS[run]),
                      "--thetas-from-run", "--n-test", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n"] == 2 and np.isfinite(line["mean_ll"])
    assert 0.0 <= line["mismatch_zdraw_median"] <= 1.0
    assert line["mean_ll"] == res["mean_ll"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_training_configuration_matches_the_record(config):
    """`train_gw --model ConvLNP --n-context 64 --density 0` with the
    configuration's flags gives the recorded run's configuration fields and
    directory tag, its criterion and the default clip of 1.0, which the
    record does not write."""
    record = _summary(config)
    args = train_gw.parser().parse_args(
        ["--model", "ConvLNP", "--n-context", "64", "--density", "0"]
        + (["--no-lat-lb"] if CONFIGS[config].get("no_lat_lb") else [])
        + (["--loss", "elbo"] if CONFIGS[config].get("loss") else []))
    summary = train_gw.summary_from_args(args)
    assert summary == gw_train_summary(model="ConvLNP", n_context=64, density=None,
                                       **CONFIGS[config])
    assert summary == train_config(record)
    assert run_tag(summary) == RUNS[config].split(os.sep)[0]
    assert "grad_clip_norm" not in summary and default_clip(summary) == 1.0
    crit = criterion_from_summary(summary)
    assert type(crit) is (ELBOLossLNPF if config == "elbo" else NLLLossLNPF)
    trainer = train_gw.build_trainer(summary, 10, "cpu")
    assert trainer.state.optimizer.grad_clip_norm == 1.0
    assert type(trainer.criterion) is type(crit)
    assert isinstance(trainer.model, ConvLNP)


def test_clip_and_criterion_defaults():
    """The clip: a summary's `grad_clip_norm` when it records one, else 1.0
    for ConvLNP and none for ConvCNP, as `reproduce_gw.py:232-238`; the ELBO
    is refused for the deterministic family, as JAX's would fail."""
    lnp = gw_train_summary(model="ConvLNP", n_context=64, density=None)
    assert default_clip(lnp) == 1.0
    assert default_clip(dict(lnp, grad_clip_norm=0.5)) == 0.5
    cnp = gw_train_summary()
    assert default_clip(cnp) is None and type(criterion_from_summary(cnp)) is CNPFLoss
    assert gw_train_summary(model="ConvLNP", clip=2.0, n_context=64)["grad_clip_norm"] == 2.0
    with pytest.raises(ValueError):
        gw_train_summary(loss="elbo")
    with pytest.raises(NotImplementedError):
        gw_model_from_summary(dict(lnp, model="AttnLNP"))


def test_train_gw_trains_the_elbo_configuration_on_the_cpu(tmp_path, capsys):
    """Two CPU steps of the ELBO configuration through `train_gw.main`: the
    run directory in the JAX layout, reloadable, scored at 32 draws."""
    out = train_gw.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--n-test", "2",
                         "--model", "ConvLNP", "--loss", "elbo", "--n-context", "64",
                         "--density", "0", "--out", str(tmp_path)])
    run_dir = os.path.join(tmp_path, RUNS["elbo"])
    assert out["train_loss_objective"] == "elbo" and np.isfinite(out["test_ll_per_wf"])
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(os.path.join(RESULTS, RUNS["elbo"])))
    with open(os.path.join(run_dir, "model_summary.txt")) as f:
        assert f.read().rstrip().endswith("n_params: 467460")
    assert isinstance(score.load_model(run_dir, "cpu"), ConvLNP)


@pytest.mark.parametrize("realized", [False, True])
def test_latent_init_schemes_match_jax(realized):
    """`init_module` draws the latent family's new modules from flax's init
    schemes: the latent encoder MLP's (hidden kaiming-relu, out xavier), the
    linear decoder's flax default Dense (lecun-normal, not switchable), and
    `reshaper_z` and `r_z_merger` (switchable lecun-normal); biases zero.
    Each weight against the JAX model's own init at the same flax shape."""
    jax_init.set_realized_init(realized)
    winit.set_realized_init(realized)
    try:
        for path, z_dim in (("latent", 200), ("both", 256)):
            opts = dict(y_dim=64, x_dim=1, r_dim=256, density_induced=4, encoded_path=path,
                        z_dim=z_dim)
            jm = JaxConvLNP(CNNFactory=_cnn_factory(1, kernel_size=3), **opts)
            x = np.linspace(-1, 1, 6, dtype=np.float32)[None, :, None]
            y = np.zeros((1, 6, 64), np.float32)
            ref = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                          x, y, x, train=False)["params"]
            tm = ConvLNP(cnn_n_blocks=1, cnn_kernel_size=3, cnn_norm="batch",
                         cnn_n_conv_layers=2, **opts)
            winit.init_module(tm, torch.Generator().manual_seed(0))
            names = {"latent_encoder.to_hidden": ("latent_encoder", "to_hidden"),
                     "latent_encoder.out": ("latent_encoder", "out"),
                     "decoder.module": ("decoder", "Dense_0")}
            names.update({"reshaper_z": ("reshaper_z",)} if path == "latent" else
                         {"r_z_merger": ("r_z_merger",)})
            for port_name, flax_path in names.items():
                node = ref
                for p in flax_path:
                    node = node[p]
                layer = tm.get_submodule(port_name)
                port_std = float(layer.weight.detach().std())
                ref_std = float(np.std(np.asarray(node["kernel"])))
                assert abs(port_std / ref_std - 1) < INIT_STD_RTOL, (path, port_name, port_std,
                                                                     ref_std)
                assert torch.count_nonzero(layer.bias) == 0
                assert layer.weight.shape == np.asarray(node["kernel"]).T.shape
    finally:
        jax_init.set_realized_init(False)
        winit.set_realized_init(False)
