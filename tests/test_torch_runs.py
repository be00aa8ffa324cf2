"""Every GW ConvCNP run in `results/` that holds parameters (the 19
time-domain runs and the two frequency-domain ones), rebuilt by the port
from its `summary.json` and loaded strictly, each frequency-domain run
scored on the CPU through `score`'s command line, and one run
of each family the port gained (dilated CNN, additive conditioning, UnetCNN,
the 2 s long-waveform runs with k=37 and with the UnetCNN), and the UnetCNN
run whose rescoring sits furthest from its record (run_1), against the JAX
package at full width.

The JAX model runs with `use_pallas_setconv=False`: the same function as the
Pallas SetConv the long runs were trained with (`tests/test_pallas_setconv.py`
holds them equal). Both sides get the same JAX float32 waveforms of 3
recorded thetas, sliced as `reproduce_gw.py` slices them, and contexts of 0,
5 and the run's maximum.

Tolerances: 5e-4 on loc/scale, the README's parity bar (and 1e-5 of each
value for the one diverged run, whose outputs reach 1.2e8). The per-waveform LL
sums n_points log-probs, so its bar is `tests/test_torch_slice.py`'s 2e-2 a
256 points, scaled by n_points / 256; mismatch 1e-5 plus 1e-4 of its value,
as there. The long generator: 5e-3 of the peak, `tests/test_torch_gw.py`'s
bar.
"""

import glob
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_gw_model_from_summary
from npf_gwwaveform_tpu.data.gw import GWWaveformGenerator as JaxGenerator
from npf_gwwaveform_tpu.data.gw import mismatch as jax_mismatch
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.data.gw import mismatch
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.score import load_model, make_eval_batch, read_run_thetas, run_generator
from npf_gwwaveform_tpu_torch.score import main as score_main
from npf_gwwaveform_tpu_torch.training.checkpoint import (
    flax_from_params, load_run_params, write_msgpack,
)

torch.set_num_threads(1)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")
RUNS = sorted(os.path.relpath(os.path.dirname(p), RESULTS)
              for p in glob.glob(os.path.join(RESULTS, "GW_time*", "ConvCNP", "run_*",
                                              "params.msgpack")))
FREQ_RUNS = sorted(os.path.relpath(os.path.dirname(p), RESULTS)
                   for p in glob.glob(os.path.join(RESULTS, "GW_freq_ap*", "ConvCNP", "run_*",
                                                   "params.msgpack")))
PARITY_RUNS = [
    "GW_time_cond_film_ctx64_d128_dil1-1-2-4-8/ConvCNP/run_0",
    "GW_time_cond_ctx32/ConvCNP/run_0",
    "GW_time_cond_film_ctx192_d128_unet/ConvCNP/run_1",
    "GW_time_cond_film_ctx192_d128_unet/ConvCNP/run_2",
    "GW_time_cond_film_ctx1024_d512_k37_T2s_np2048_pallas/ConvCNP/run_3",
    "GW_time_cond_film_ctx1024_d512_unet_T2s_np2048_pallas/ConvCNP/run_1",
]
PRED_ATOL = 5e-4
# ctx192_d128_unet run_1 diverged in training (recorded LL -5060.5): its loc
# and scale reach 1.2e8, where a float32 ulp is 8, so beside the absolute
# bar each value is held to 1e-5 of itself (measured 2.3e-6 on the CPU)
PRED_RTOL = {"GW_time_cond_film_ctx192_d128_unet/ConvCNP/run_1": 1e-5}
LL_ATOL_256 = 2e-2
MISMATCH_ATOL, MISMATCH_RTOL = 1e-5, 1e-4
WAVE_ATOL = 5e-3


def _summary(run):
    with open(os.path.join(RESULTS, run, "summary.json")) as f:
        return json.load(f)


def test_the_nineteen_runs():
    assert len(RUNS) == 19 and set(PARITY_RUNS) <= set(RUNS)
    assert FREQ_RUNS == ["GW_freq_ap_cond_film_ctx64/ConvCNP/run_0",
                         "GW_freq_ap_ctx64/ConvCNP/run_1"]


@pytest.mark.parametrize("run", RUNS + FREQ_RUNS)
def test_run_loads_strictly_and_round_trips(run, tmp_path):
    """`load_model` builds the run's architecture and loads it with
    strict=True; written back by the port, its two files are the run's own
    bytes."""
    run_dir = os.path.join(RESULTS, run)
    model = load_model(run_dir, "cpu")
    params, extra = flax_from_params(model.state_dict(), [n for n, _ in model.named_buffers()])
    for name, tree in (("params", params), ("extra_vars", extra)):
        out = tmp_path / f"{name}.msgpack"
        write_msgpack(str(out), tree)
        with open(os.path.join(run_dir, f"{name}.msgpack"), "rb") as f:
            assert out.read_bytes() == f.read(), name
    n_params = sum(p.numel() for p in model.parameters())
    with open(os.path.join(run_dir, "model_summary.txt")) as f:
        assert f.read().rstrip().endswith(f"n_params: {n_params}")
    ref = load_run_params(run_dir)[0]
    assert ref.keys() == params.keys()


def test_long_waveform_batch_matches_jax():
    """The long runs' eval batch: the generator at 1024 Hz over 2 s (2048
    samples), all 2048 kept at stride 1, on x in [-1, 1]."""
    run = "GW_time_cond_film_ctx1024_d512_k37_T2s_np2048_pallas/ConvCNP/run_3"
    summary = _summary(run)
    theta = read_run_thetas(os.path.join(RESULTS, run))[:16]
    gen = run_generator(summary)
    assert (gen.n_time, gen.sample_rate, summary["n_points"]) == (2048, 1024.0, 2048)
    x, y, cond = make_eval_batch(torch.from_numpy(theta), gen, GWParameterSpace(),
                                 summary["n_points"])
    _, h = JaxGenerator(duration=2.0, sample_rate=1024.0).time_domain(jnp.asarray(theta))
    ref = np.asarray(h)[..., -2048::1][..., :2048]
    assert y.shape == (16, 2048, 1) and x.shape == (16, 2048, 1)
    np.testing.assert_allclose(y[..., 0].numpy(), ref, rtol=0, atol=WAVE_ATOL)
    # two float32 ulps, as tests/test_torch_modules.py holds `linspace` to XLA's
    np.testing.assert_allclose(x[0, :, 0].numpy(), np.asarray(jnp.linspace(-1.0, 1.0, 2048)),
                               rtol=0, atol=2 * np.spacing(np.float32(1.0)))
    assert np.isfinite(y.numpy()).all() and cond.shape == (16, 4)


def _flax_restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


@pytest.mark.parametrize("run", PARITY_RUNS)
def test_run_matches_jax_at_full_width(run):
    run_dir = os.path.join(RESULTS, run)
    summary = _summary(run)
    n_points, n_context = summary.get("n_points", 256), summary["n_context"]
    rng = np.random.default_rng(7)
    theta = read_run_thetas(run_dir)[:3]
    gen = JaxGenerator(duration=summary.get("duration", 1.0), sample_rate=1024.0)
    _, h = gen.time_domain(jnp.asarray(theta))
    stride = gen.n_time // n_points
    y = np.array(h)[:, -n_points * stride::stride][:, :n_points, None]
    x = np.broadcast_to(np.linspace(-1, 1, n_points, dtype=np.float32)[None, :, None],
                        (3, n_points, 1)).copy()
    mask_c = np.zeros((3, n_points), bool)
    for i, n in enumerate([0, 5, n_context]):
        mask_c[i, rng.permutation(n_points)[:n]] = True
    mask_t = np.ones((3, n_points), bool)
    cond = ((theta - [10, 10, -0.8, -0.8]) / [70, 70, 1.6, 1.6] * 2 - 1).astype(np.float32)

    jm = jax_gw_model_from_summary(summary).clone(use_pallas_setconv=False)
    variables = {"params": _flax_restore(os.path.join(run_dir, "params.msgpack")),
                 **_flax_restore(os.path.join(run_dir, "extra_vars.msgpack"))}
    out = jax.jit(jm.apply, static_argnames="train")(
        variables, *(jnp.asarray(a) for a in (x, y, x)), mask_cntxt=jnp.asarray(mask_c),
        mask_trgt=jnp.asarray(mask_t), condition=jnp.asarray(cond), train=False)
    ll_ref = -np.asarray(JaxCNPFLoss(reduction=None)(out, jnp.asarray(y), jnp.asarray(mask_t),
                                                     train=False))
    mm_ref = np.asarray(jax_mismatch(out.p_yCc.loc[0, ..., 0], jnp.asarray(y[..., 0])))

    tm = load_model(run_dir, "cpu")
    with torch.no_grad():
        t = tm(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t, cond)))
        ll = -CNPFLoss(reduction=None)(t, torch.from_numpy(y), torch.from_numpy(mask_t),
                                       train=False).numpy()
        mm = mismatch(t.p_yCc.loc[0, ..., 0], torch.from_numpy(y[..., 0])).numpy()
    rtol = PRED_RTOL.get(run, 0.0)
    np.testing.assert_allclose(t.p_yCc.loc.numpy(), np.asarray(out.p_yCc.loc), atol=PRED_ATOL,
                               rtol=rtol)
    np.testing.assert_allclose(t.p_yCc.scale.numpy(), np.asarray(out.p_yCc.scale), atol=PRED_ATOL,
                               rtol=rtol)
    np.testing.assert_allclose(ll, ll_ref, atol=LL_ATOL_256 * n_points / 256)
    np.testing.assert_allclose(mm, mm_ref, atol=MISMATCH_ATOL, rtol=MISMATCH_RTOL)
    assert np.isfinite(ll).all()


@pytest.mark.parametrize("run", FREQ_RUNS)
def test_freq_run_scores_on_the_cpu(run, capsys):
    """`python -m npf_gwwaveform_tpu_torch.score --device cpu --thetas-from-run
    --run-dir RUN --n-test 8`: eight of the run's recorded thetas, one JSON
    line of finite scores, the mismatch a fraction."""
    res = score_main(["--device", "cpu", "--thetas-from-run", "--run-dir",
                      os.path.join(RESULTS, run), "--n-test", "8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["n"] == 8 and res["device"] == "cpu"
    assert np.isfinite(res["mean_ll"]) and 0.0 <= res["median_mismatch"] <= 1.0
    assert res["mismatch_zdraw_median"] == res["median_mismatch"]
    assert load_model(os.path.join(RESULTS, run), "cpu").y_dim == 2
