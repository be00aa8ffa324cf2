"""The port's frequency-domain GW data, metric and scoring against the JAX
package (`mode="freq_ap"`: amplitude and standardised phase, two channels).

Tolerances, each from a measurement on this CPU where it is not exact:
- the frequency grid: two float32 ulps of 1024 Hz (`utils.helpers.linspace`
  follows `jnp.linspace`'s arithmetic op by op; XLA's fused evaluation
  rounds a point one ulp apart: measured one ulp);
- the waveform, on 61 recorded thetas and three corners of the box: the
  peak-normalised amplitude 5e-6 (measured 1.3e-6 against JAX's float32 and
  1.1e-6 against its float64, whose own float32 sits 1.7e-6 from it); the
  de-trended phase 0.05 rad of phases up to 343 rad (measured 0.036 against
  JAX's float32, 0.021 against its float64; JAX's float32 sits 0.016 from
  its float64: the TaylorF2 series in float32); the standardised phase
  3e-3 (measured 1.5e-3, 8.3e-4, and JAX's own 6.8e-4) and its std 1e-3
  relative (measured 3.6e-4 against float64);
- `psd_aligo`, `match_fd`, `mismatch_fd` and the PSD-weighted time-domain
  `match` on identical inputs: 1e-6 (relative for the PSD, whose values
  span 1e-6 to 3e5; absolute for the match, a ratio of float32 sums);
- `GWParameterSpace.grid`: exact (numpy on both sides);
- the y_dim = 2 ConvCNP forward from JAX's parameters: 5e-4 on loc and
  scale, the README's parity bar, at small width and with both recorded
  runs' parameters at full width; the per-waveform LL 2e-2 (the bar of
  tests/test_torch_slice.py for 256 points, doubled for two channels), and
  for the small model with perturbed weights, whose LL reaches -6e5, also
  1e-5 of its magnitude (float32 sums of terms that large: measured 2e-6);
- the frequency-domain scoring of a batch (`score_batch`) against
  `reproduce_gw.py`'s `eval_batch` arithmetic on identical targets, context
  masks and phase stds: LL as above, mismatch 1e-5 plus 1e-4 of its value
  (tests/test_torch_slice.py's bar);
- the port's bf16-float32 scoring gap of each recorded run on 256 of its
  thetas within three standard errors of a 256-waveform mean (the per
  waveform sd JAX measured) of JAX's own gap over 2048
  (tests/jax_bf16_family_gaps.json), the chip's rule at this count.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_gw_model_from_summary
from npf_gwwaveform_tpu.data.gw import GWParameterSpace as JaxSpace
from npf_gwwaveform_tpu.data.gw import GWWaveformDataset as JaxDataset
from npf_gwwaveform_tpu.data.gw import GWWaveformGenerator as JaxGenerator
from npf_gwwaveform_tpu.data.gw import match as jax_match
from npf_gwwaveform_tpu.data.gw import match_fd as jax_match_fd
from npf_gwwaveform_tpu.data.gw import mismatch_fd as jax_mismatch_fd
from npf_gwwaveform_tpu.data.gw import psd_aligo as jax_psd_aligo
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu_torch import score
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary
from npf_gwwaveform_tpu_torch.data.gw import (
    GWParameterSpace, GWWaveformDataset, GWWaveformGenerator, make_batch, match, match_fd,
    mismatch_fd, psd_aligo, standardize_phase,
)
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.score import load_model, read_run_thetas
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")
FREQ_RUNS = ["GW_freq_ap_cond_film_ctx64/ConvCNP/run_0", "GW_freq_ap_ctx64/ConvCNP/run_1"]
FREQ_ULPS = 2
AMP_ATOL, PHASE_ATOL, STD_PHASE_ATOL, SIGMA_RTOL = 5e-6, 0.05, 3e-3, 1e-3
METRIC_TOL = 1e-6
PRED_ATOL = 5e-4
LL_ATOL = 2e-2 * 2
LL_RTOL_SMALL = 1e-5
MISMATCH_ATOL, MISMATCH_RTOL = 1e-5, 1e-4
GAP_SES = 3.0


def _thetas():
    corners = np.array([[10, 10, -0.8, -0.8], [80, 80, 0.8, 0.8], [80, 10, 0.8, -0.8]],
                       np.float32)
    return np.concatenate([read_run_thetas(os.path.join(RESULTS, FREQ_RUNS[0]))[:61], corners])


def _x64():
    return jax.enable_x64(True) if hasattr(jax, "enable_x64") else jax.experimental.enable_x64()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _summary(run):
    with open(os.path.join(RESULTS, run, "summary.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("gen_kwargs", [dict(duration=1.0, sample_rate=1024.0), dict()])
def test_frequency_domain_matches_jax(gen_kwargs):
    theta = _thetas()
    fd = GWWaveformGenerator(**gen_kwargs).frequency_domain(torch.from_numpy(theta), n_f=256)
    j32 = JaxGenerator(**gen_kwargs).frequency_domain(jnp.asarray(theta), n_f=256)
    with _x64():
        j64 = [np.asarray(a) for a in JaxGenerator(**gen_kwargs).frequency_domain(
            jnp.asarray(theta, jnp.float64), n_f=256)]
    assert all(t.dtype == torch.float32 for t in fd)
    assert fd.amplitude.shape == fd.phase.shape == (theta.shape[0], 256)
    np.testing.assert_allclose(fd.freqs.numpy(), np.asarray(j32.freqs), rtol=0,
                               atol=FREQ_ULPS * np.spacing(np.float32(1024.0)))
    assert fd.freqs[0] == 20.0 and fd.freqs[-1] == 1024.0
    for port, ref32, ref64, tol in ((fd.amplitude, j32.amplitude, j64[1], AMP_ATOL),
                                    (fd.phase, j32.phase, j64[2], PHASE_ATOL)):
        port = port.numpy()
        assert np.isfinite(port).all()
        np.testing.assert_allclose(port, np.asarray(ref32), rtol=0, atol=tol)
        np.testing.assert_allclose(port, ref64, rtol=0, atol=tol)
    np.testing.assert_allclose(fd.amplitude.amax(dim=-1).numpy(), 1.0, rtol=0, atol=1e-7)
    # the standardised phase and its std, as reproduce_gw.py's make_batch takes them
    psi, sigma = standardize_phase(fd.phase)
    p32 = np.asarray(j32.phase)
    ref = (p32 - p32.mean(-1, keepdims=True)) / (p32.std(-1, keepdims=True) + 1e-8)
    ref_psi = jnp.asarray(j32.phase)
    ref_std = np.asarray((ref_psi - jnp.mean(ref_psi, -1, keepdims=True))
                         / (jnp.std(ref_psi, -1, keepdims=True) + 1e-8))
    p64 = j64[2]
    std64 = p64.std(-1, keepdims=True)
    np.testing.assert_allclose(psi.numpy(), ref_std, rtol=0, atol=STD_PHASE_ATOL)
    np.testing.assert_allclose(psi.numpy(), ref, rtol=0, atol=STD_PHASE_ATOL)
    np.testing.assert_allclose(psi.numpy(), (p64 - p64.mean(-1, keepdims=True)) / (std64 + 1e-8),
                               rtol=0, atol=STD_PHASE_ATOL)
    np.testing.assert_allclose(sigma.numpy(), std64, rtol=SIGMA_RTOL)
    # the complex waveform h = A exp(-i psi)
    np.testing.assert_allclose(fd.h.numpy(), np.asarray(j32.h), rtol=0, atol=PHASE_ATOL)


def test_phase_std_has_no_bessel_correction():
    psi = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    _, sigma = standardize_phase(psi)
    assert sigma.item() == pytest.approx(np.std([0.0, 1.0, 2.0, 3.0]), rel=1e-7)
    assert sigma.item() != pytest.approx(psi.std().item(), rel=1e-3)


def test_psd_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    freqs = np.linspace(0.0, 1100.0, 300, dtype=np.float32)
    np.testing.assert_allclose(psd_aligo(torch.from_numpy(freqs)).numpy(),
                               np.asarray(jax_psd_aligo(jnp.asarray(freqs))), rtol=METRIC_TOL)
    assert psd_aligo(torch.from_numpy(freqs)).min() >= 1e-6
    # frequency-domain waveforms: a near copy, a pure time and phase shift
    # (match 1), and an unrelated one, each white and aLIGO-weighted
    n_f = 256
    f = np.linspace(20.0, 1024.0, n_f, dtype=np.float32)
    a = rng.uniform(0.1, 1.0, (4, n_f)).astype(np.float32)
    p = np.cumsum(rng.normal(size=(4, n_f)), axis=-1).astype(np.float32)
    h1 = (a * np.exp(-1j * p)).astype(np.complex64)
    h2 = h1 * (1 + 0.05 * rng.normal(size=h1.shape))
    h2[1] = h1[1] * np.exp(-1j * (2 * np.pi * f * 0.0123 / (f[1] - f[0]) / n_f + 0.7))
    h2[2] = (rng.uniform(size=n_f) * np.exp(-1j * rng.normal(size=n_f) * 3))
    h2 = h2.astype(np.complex64)
    psd = jax_psd_aligo(jnp.asarray(f))
    for w in (None, psd):
        for pad in (1, 4):
            ref = np.asarray(jax_match_fd(jnp.asarray(h1), jnp.asarray(h2), psd=w, pad_factor=pad))
            out = match_fd(torch.from_numpy(h1), torch.from_numpy(h2),
                           psd=None if w is None else torch.from_numpy(np.array(w)),
                           pad_factor=pad).numpy()
            np.testing.assert_allclose(out, ref, rtol=0, atol=METRIC_TOL)
            mm = mismatch_fd(torch.from_numpy(h1), torch.from_numpy(h2),
                             psd=None if w is None else torch.from_numpy(np.array(w)),
                             pad_factor=pad).numpy()
            np.testing.assert_allclose(mm, np.asarray(jax_mismatch_fd(
                jnp.asarray(h1), jnp.asarray(h2), psd=w, pad_factor=pad)), rtol=0, atol=METRIC_TOL)
    same = mismatch_fd(torch.from_numpy(h1), torch.from_numpy(h1),
                       psd=torch.from_numpy(np.array(psd))).numpy()
    assert np.abs(same).max() < 1e-6
    # the PSD-weighted time-domain match (rfft frequencies of 256 samples at 256 Hz)
    t1 = rng.normal(size=(5, 256)).astype(np.float32)
    t2 = (t1 + 0.3 * rng.normal(size=(5, 256))).astype(np.float32)
    t2[0] = np.roll(t1[0], 9)
    psd_t = np.array(jax_psd_aligo(jnp.arange(129, dtype=jnp.float32) * 4.0))
    ref = np.asarray(jax_match(jnp.asarray(t1), jnp.asarray(t2), psd=jnp.asarray(psd_t)))
    out = match(torch.from_numpy(t1), torch.from_numpy(t2), psd=torch.from_numpy(psd_t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=METRIC_TOL)
    np.testing.assert_allclose(match(torch.from_numpy(t1), torch.from_numpy(t2)).numpy(),
                               np.asarray(jax_match(jnp.asarray(t1), jnp.asarray(t2))),
                               rtol=0, atol=METRIC_TOL)


@pytest.mark.parametrize("n_per_axis", [1, 2, 7, 15])
def test_parameter_space_grid_is_jax_grid(n_per_axis):
    out = GWParameterSpace().grid(n_per_axis)
    ref = JaxSpace().grid(n_per_axis)
    assert out.shape == ref.shape == (n_per_axis * (n_per_axis + 1) // 2, 4)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["time", "freq_ap"])
def test_dataset_samples_match_jax(mode):
    """`GWWaveformDataset` of each mode on JAX's thetas of one key: x, y and
    the normalised parameters of JAX's dataset on the same key."""
    gen = dict(duration=1.0, sample_rate=1024.0)
    jds = JaxDataset(generator=JaxGenerator(**gen), mode=mode, n_points=128, n_samples=16)
    key = jax.random.PRNGKey(3)
    jx, jy, jp = (np.asarray(a) for a in jds.get_samples(16, key=key))
    theta = torch.from_numpy(np.array(JaxSpace().sample(key, 16)))
    ds = GWWaveformDataset(generator=GWWaveformGenerator(**gen), mode=mode, n_points=128,
                           n_samples=16)
    assert ds.y_dim == jds.y_dim == (1 if mode == "time" else 2)
    x, y, p = ds.samples_of(theta)
    assert y.shape == jy.shape == (16, 128, ds.y_dim) and x.shape == jx.shape
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=2 * np.spacing(np.float32(1.0)))
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-6)
    if mode == "time":  # tests/test_torch_gw.py's waveform bar
        np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=5e-3)
    else:
        np.testing.assert_allclose(y[..., 0].numpy(), jy[..., 0], rtol=0, atol=AMP_ATOL)
        np.testing.assert_allclose(y[..., 1].numpy(), jy[..., 1], rtol=0, atol=STD_PHASE_ATOL)


@pytest.mark.parametrize("mode", ["time", "freq_ap"])
def test_dataset_draws_and_epochs(mode):
    """Fresh draws from the explicit generator, fixed samples once set,
    whole batches only, the conditioned and plain epochs."""
    def ds(**kw):
        return GWWaveformDataset(generator=GWWaveformGenerator(duration=1.0, sample_rate=1024.0),
                                 mode=mode, n_points=64, n_samples=10, **kw)
    a = ds(rng=torch.Generator().manual_seed(5))
    b = ds(rng=torch.Generator().manual_seed(5))
    xa, ya, pa = a.get_samples(4)
    xb, yb, pb = b.get_samples(4)
    assert torch.equal(ya, yb) and torch.equal(pa, pb)
    assert not torch.equal(a.get_samples(4)[1], ya)  # the stream moves on
    batches = list(a.epoch_batches_conditioned(3))
    assert len(batches) == 3 and all(x.shape == (3, 64, 1) and y.shape == (3, 64, a.y_dim)
                                     and p.shape == (3, 4) for x, y, p in batches)
    a.set_samples_(xa, ya, pa)
    assert a.is_reuse_across_epochs and a.n_samples == 4
    fixed = list(a.epoch_batches(2))
    assert len(fixed) == 2 and torch.equal(fixed[1][1], ya[2:4])
    reused = ds(is_reuse_across_epochs=True, seed=1)
    e1, e2 = list(reused.epoch_batches(5)), list(reused.epoch_batches(5))
    assert len(e1) == 2 and all(torch.equal(u[1], v[1]) for u, v in zip(e1, e2))
    batch = make_batch(pa, GWWaveformGenerator(duration=1.0, sample_rate=1024.0),
                       GWParameterSpace(), 64, mode)
    assert (batch[3] is None) == (mode == "time")
    with pytest.raises(ValueError):
        GWWaveformDataset(mode="freq")


def _freq_batch(n, n_points, n_context, seed, cond=True):
    """JAX float32 freq_ap data of `n` recorded thetas (reproduce_gw.py's
    make_batch), its phase stds, and context masks of 0, 5 and n_context
    points, then random counts."""
    rng = np.random.default_rng(seed)
    theta = read_run_thetas(os.path.join(RESULTS, FREQ_RUNS[0]))[seed:seed + n]
    fd = JaxGenerator(duration=1.0, sample_rate=1024.0).frequency_domain(jnp.asarray(theta),
                                                                         n_f=n_points)
    psi = fd.phase
    sigma = jnp.std(psi, -1, keepdims=True)
    psi = (psi - jnp.mean(psi, -1, keepdims=True)) / (sigma + 1e-8)
    y = np.asarray(jnp.stack([fd.amplitude, psi], axis=-1))
    x = np.broadcast_to(np.asarray(jnp.linspace(-1.0, 1.0, n_points))[None, :, None],
                        (n, n_points, 1)).copy()
    mask_c = np.zeros((n, n_points), bool)
    counts = [0, 5, n_context] + list(rng.integers(0, n_context + 1, max(0, n - 3)))
    for i, k in enumerate(counts[:n]):
        mask_c[i, rng.permutation(n_points)[:k]] = True
    cond_in = np.asarray(JaxSpace().normalize(jnp.asarray(theta))) if cond else None
    return theta, x, y, np.asarray(sigma)[:, 0], mask_c, np.ones((n, n_points), bool), cond_in


def _jax_forward(jm, variables, x, y, mask_c, mask_t, cond):
    out = jax.jit(jm.apply, static_argnames="train")(
        variables, *(jnp.asarray(a) for a in (x, y, x)), mask_cntxt=jnp.asarray(mask_c),
        mask_trgt=jnp.asarray(mask_t), train=False,
        **({"condition": jnp.asarray(cond)} if cond is not None else {}))
    ll = -np.asarray(JaxCNPFLoss(reduction=None)(out, jnp.asarray(y), jnp.asarray(mask_t),
                                                 train=False))
    return out, ll


def _port_forward(tm, x, y, mask_c, mask_t, cond):
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t)),
                 condition=None if cond is None else torch.from_numpy(cond))
        ll = -CNPFLoss(reduction=None)(out, torch.from_numpy(y), torch.from_numpy(mask_t),
                                       train=False).numpy()
    return out, ll


@pytest.mark.parametrize("cond_mode", ["film", None])
def test_small_two_channel_convcnp_matches_jax(cond_mode):
    """A small y_dim = 2 ConvCNP (two value channels into the first
    SetConv, four decoder outputs) from JAX's init, perturbed."""
    _, x, y, _, mask_c, mask_t, cond = _freq_batch(4, 64, 16, seed=2, cond=cond_mode is not None)
    jm = JaxConvCNP(y_dim=2, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, kernel_size=5),
                    cond_dim=0 if cond is None else 4, cond_mode=cond_mode or "film")
    kw = {"condition": cond} if cond is not None else {}
    variables = _np_tree(jax.jit(lambda k: jm.init(k, x, y, x, mask_cntxt=mask_c,
                                                   mask_trgt=mask_t, **kw))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), variables["params"])
    out, ll_ref = _jax_forward(jm, variables, x, y, mask_c, mask_t, cond)
    tm = ConvCNP(y_dim=2, r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5,
                 cond_dim=0 if cond is None else 4, cond_mode=cond_mode or "film")
    assert tm.cntxt_to_induced.resizer.in_features == 3  # two channels and the density
    assert tm.decoder.module.out.out_features == 4
    tm.load_state_dict(params_from_flax(variables["params"],
                                        {"batch_stats": variables["batch_stats"]}), strict=True)
    t, ll = _port_forward(tm.eval(), x, y, mask_c, mask_t, cond)
    assert t.p_yCc.loc.shape == (1, 4, 64, 2)
    np.testing.assert_allclose(t.p_yCc.loc.numpy(), np.asarray(out.p_yCc.loc), rtol=0,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(t.p_yCc.scale.numpy(), np.asarray(out.p_yCc.scale), rtol=0,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(ll, ll_ref, rtol=LL_RTOL_SMALL, atol=LL_ATOL)


def _restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


def _jax_run(run):
    summary = _summary(run)
    variables = {"params": _restore(os.path.join(RESULTS, run, "params.msgpack")),
                 **_restore(os.path.join(RESULTS, run, "extra_vars.msgpack"))}
    return summary, jax_gw_model_from_summary(summary).clone(use_pallas_setconv=False), variables


@pytest.mark.parametrize("run", FREQ_RUNS)
def test_recorded_run_matches_jax_at_full_width(run):
    summary, jm, variables = _jax_run(run)
    _, x, y, _, mask_c, mask_t, cond = _freq_batch(3, 256, summary["n_context"], seed=0,
                                                   cond=summary["conditioned"])
    out, ll_ref = _jax_forward(jm, variables, x, y, mask_c, mask_t, cond)
    tm = load_model(os.path.join(RESULTS, run), "cpu")
    assert tm.y_dim == 2 and gw_model_from_summary(summary).y_dim == 2
    t, ll = _port_forward(tm, x, y, mask_c, mask_t, cond)
    np.testing.assert_allclose(t.p_yCc.loc.numpy(), np.asarray(out.p_yCc.loc), rtol=0,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(t.p_yCc.scale.numpy(), np.asarray(out.p_yCc.scale), rtol=0,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(ll, ll_ref, rtol=0, atol=LL_ATOL)


@pytest.mark.parametrize("run", FREQ_RUNS)
def test_score_batch_is_reproduce_gw_eval(run, monkeypatch):
    """`score_batch` in freq_ap mode against `reproduce_gw.py`'s
    `eval_batch` arithmetic (NPML LL; the predictive mean's and each draw's
    `mismatch_fd` of h(f) = A exp(-i psi sigma), both rebuilt with the true
    sigma, aLIGO-weighted) on identical targets, context masks and sigma:
    JAX's data stands in for the port's (`make_eval_batch`) and a fixed
    split for the splitter."""
    summary, jm, variables = _jax_run(run)
    theta, x, y, sigma, mask_c, mask_t, cond = _freq_batch(
        6, 256, summary["n_context"], seed=4, cond=summary["conditioned"])
    out, ll_ref = _jax_forward(jm, variables, x, y, mask_c, mask_t, cond)
    gen = JaxGenerator(duration=1.0, sample_rate=1024.0)
    psd = jax_psd_aligo(gen.freqs(256))

    def recon(ap):
        return ap[..., 0] * jnp.exp(-1j * ap[..., 1] * jnp.asarray(sigma)[:, None])

    pred = jnp.mean(out.p_yCc.loc, axis=0)
    mm_ref = np.asarray(jax_mismatch_fd(recon(pred), recon(jnp.asarray(y)), psd=psd))

    def batch(*args, **kw):
        assert kw.get("return_aux") and args[4] == "freq_ap"
        return (torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(np.asarray(JaxSpace().normalize(jnp.asarray(theta)))),
                torch.from_numpy(sigma))

    def splitter(generator, x_, y_, condition=None):
        assert (condition is None) == (cond is None)
        split = dict(X_cntxt=x_, Y_cntxt=y_, X_trgt=x_, Y_trgt=y_,
                     mask_cntxt=torch.from_numpy(mask_c), mask_trgt=torch.from_numpy(mask_t))
        return {**split, **({"condition": condition} if condition is not None else {})}

    monkeypatch.setattr(score, "make_eval_batch", batch)
    tm = load_model(os.path.join(RESULTS, run), "cpu")
    with torch.no_grad():
        ll, mm, mz, _ = score.score_batch(tm, splitter, None, torch.from_numpy(theta),
                                          GWWaveformGenerator(duration=1.0, sample_rate=1024.0),
                                          GWParameterSpace(), 256, "freq_ap")
    np.testing.assert_allclose(ll.numpy(), ll_ref, rtol=0, atol=LL_ATOL)
    np.testing.assert_allclose(mm.numpy(), mm_ref, rtol=MISMATCH_RTOL, atol=MISMATCH_ATOL)
    assert torch.equal(mz, mm)  # one draw: the per-draw mismatch is the mixture's


@pytest.mark.parametrize("run", FREQ_RUNS)
def test_bf16_scoring_gap_is_jaxs(run):
    """The port's bf16 scoring against its float32 scoring of the run's first
    256 recorded thetas with the same context draws, on the CPU (the bf16
    chain's plain version, summed feature by feature): the mean LL gap
    within three standard errors of a 256-waveform mean of JAX's gap over
    2048 (tests/jax_bf16_family_gaps.py)."""
    with open(os.path.join(os.path.dirname(__file__), "jax_bf16_family_gaps.json")) as f:
        ref = json.load(f)[run]
    run_dir = os.path.join(RESULTS, run)
    f32 = score.score_run(run_dir, 256, thetas_from=run_dir, device="cpu")
    bf16 = score.score_run(run_dir, 256, thetas_from=run_dir, device="cpu",
                           dtype=torch.bfloat16)
    gap = (bf16["ll"] - f32["ll"]).mean()
    assert np.isfinite(bf16["ll"]).all() and np.isfinite(bf16["mismatch"]).all()
    assert abs(gap - ref["d_mean_ll"]) <= GAP_SES * ref["d_ll_std"] / 256 ** 0.5, (
        gap, ref["d_mean_ll"])
