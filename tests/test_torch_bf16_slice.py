"""The scored and trained slice in bfloat16 compute against the JAX package's
bf16 model: the small FiLM ConvCNP and the flagship run at full width, each
port path against its JAX counterpart (the kernel path, `use_kernels=True`,
against `fused_mlp=True`; the plain path against the Dense decoder that
`reproduce_gw.py --bf16` builds), and the `--bf16` entry points on the CPU.

Reference semantics: JAX is applied op by op, so that every bf16 op rounds
its result, as the JAX code reads. Under `jax.jit` XLA's default excess
precision (`--xla_allow_excess_precision`) keeps some fused elementwise
chains in f32 and drops those roundings; with that flag off, jit and op by
op agree (checked on the small model), and the port follows the ops.

Bars, each with its reason and the value measured on this CPU:
- small width: loc and scale within 4 bf16 ulps (2^-6) of their largest
  magnitude, per-waveform log-likelihood within 0.5 nats. Both sides round
  at the same points and differ in the order of their f32 sums (measured:
  identical loc, scale and log-likelihood on either path).
- full width (run_1, B=4, contexts of 0, 5, 96 and 192 points), against JAX
  bf16's own distance to JAX f32 on the same inputs (its "gap"): the port's
  RMS distance to JAX bf16 loc at most half the gap's RMS, its largest
  distance at most 3/4 of the gap's largest, and its RMS distance to JAX f32
  loc at least 3/4 of the gap's RMS (a port that kept float32 inside would
  sit near 0 there and near 1 on the first). Why not closer: the f32 sums
  of the two sides run in other orders, so a few rounded values differ by
  one ulp from the first layers on (0.12% of the first SetConv's outputs),
  and five BatchNorm'd conv blocks spread them (78% of the last block's
  outputs differ). JAX's own fused and Dense decoders sit as far apart.
  Measured, kernel path / plain path: RMS 0.36 / 0.43 of the gap, largest
  0.43 / 0.61, RMS to f32 1.03 / 1.01.
"""

import json
import os

import flax
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory, gp_model_1d
from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_gw_model_from_summary
from npf_gwwaveform_tpu.data.gw import GWWaveformGenerator as JaxGenerator
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu_torch import score, train_gw
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.score import load_model, read_run_thetas
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

BF16 = torch.bfloat16
RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
SMALL_ULPS = 4
SMALL_LL_ATOL = 0.5
FULL_RMS_NEAR, FULL_MAX_NEAR, FULL_RMS_FAR = 0.5, 0.75, 0.75


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _batch(rng, B, N, counts):
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1)).copy()
    y = np.sin(8 * x + rng.uniform(0, 6, (B, 1, 1))).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for i, n in enumerate(counts):  # counts[0] == 0: an empty context
        mask_c[i, rng.permutation(N)[:n]] = True
    return x, y, mask_c, np.ones((B, N), bool)


def _jax_out(model, variables, x, y, mask_c, mask_t, cond):
    """(loc [B,N], scale [B,N], LL [B]) of a JAX model in eval mode, applied
    op by op (module doc: XLA's excess precision)."""
    out = model.apply(
        variables, *(jnp.asarray(a) for a in (x, y, x)), mask_cntxt=jnp.asarray(mask_c),
        mask_trgt=jnp.asarray(mask_t), condition=jnp.asarray(cond), train=False)
    ll = -JaxCNPFLoss(reduction=None)(out, jnp.asarray(y), jnp.asarray(mask_t), train=False)
    return (np.asarray(out.p_yCc.loc[0, ..., 0]), np.asarray(out.p_yCc.scale[0, ..., 0]),
            np.asarray(ll))


def _port_out(model, x, y, mask_c, mask_t, cond):
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t, cond)))
        ll = -CNPFLoss(reduction=None)(out, torch.from_numpy(y), torch.from_numpy(mask_t),
                                       train=False)
    assert out.p_yCc.loc.dtype == out.p_yCc.scale.dtype == torch.float32
    return out.p_yCc.loc[0, ..., 0].numpy(), out.p_yCc.scale[0, ..., 0].numpy(), ll.numpy()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_small_convcnp_bf16_matches_jax(use_kernels):
    """r_dim 16, density 16, two BatchNorm ResConvBlocks, FiLM; JAX with
    fused_mlp == use_kernels."""
    rng = np.random.default_rng(0)
    x, y, mask_c, mask_t = _batch(rng, 3, 40, [0, 7, 30])
    cond = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, jnp.bfloat16, kernel_size=5), cond_dim=4,
                    cond_mode="film", dtype=jnp.bfloat16, fused_mlp=use_kernels)
    variables = _np_tree(jax.jit(lambda key: jm.init(
        key, *(jnp.asarray(a) for a in (x, y, x)), mask_cntxt=jnp.asarray(mask_c),
        mask_trgt=jnp.asarray(mask_t), condition=jnp.asarray(cond), train=False))(
            jax.random.PRNGKey(0)))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32), variables["batch_stats"])
    tm = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5, cond_dim=4,
                 use_kernels=use_kernels, dtype=BF16)
    tm.load_state_dict(params_from_flax(variables["params"],
                                        {"batch_stats": variables["batch_stats"]}), strict=True)
    ref = _jax_out(jm, variables, x, y, mask_c, mask_t, cond)
    loc, scale, ll = _port_out(tm.eval(), x, y, mask_c, mask_t, cond)
    for a, r in ((loc, ref[0]), (scale, ref[1])):
        assert np.abs(a - r).max() <= SMALL_ULPS * 2.0 ** -8 * np.abs(r).max()
    np.testing.assert_allclose(ll, ref[2], atol=SMALL_LL_ATOL)


def _flax_restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_run_bf16_matches_jax_at_full_width(use_kernels):
    """run_1 (368,004 parameters), B=4 recorded thetas, JAX float32 waveforms
    fed to every model; JAX bf16 built as reproduce_gw.py --bf16 builds it."""
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    rng = np.random.default_rng(1)
    theta = read_run_thetas(RUN_DIR)[:4]
    _, h = JaxGenerator(duration=1.0, sample_rate=1024.0).time_domain(jnp.asarray(theta))
    x, _, mask_c, mask_t = _batch(rng, 4, 256, [0, 5, 96, 192])
    y = np.array(h)[:, ::4, None]
    cond = ((theta - [10, 10, -0.8, -0.8]) / [70, 70, 1.6, 1.6] * 2 - 1).astype(np.float32)
    variables = {"params": _flax_restore(os.path.join(RUN_DIR, "params.msgpack")),
                 **_flax_restore(os.path.join(RUN_DIR, "extra_vars.msgpack"))}
    jax_bf16 = gp_model_1d("ConvCNP", dtype=jnp.bfloat16, cnn_kernel_size=19).clone(
        y_dim=1, cond_dim=4, cond_mode="film", density_induced=summary["density_induced"],
        fused_mlp=use_kernels)
    ref32 = _jax_out(jax_gw_model_from_summary(summary), variables, x, y, mask_c, mask_t, cond)
    ref16 = _jax_out(jax_bf16, variables, x, y, mask_c, mask_t, cond)
    tm = load_model(RUN_DIR, "cpu", use_kernels=use_kernels, dtype=BF16)
    loc, scale, ll = _port_out(tm, x, y, mask_c, mask_t, cond)
    assert np.isfinite(ll).all() and np.isfinite(scale).all()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    gap = ref16[0] - ref32[0]
    assert rms(loc - ref16[0]) <= FULL_RMS_NEAR * rms(gap)
    assert np.abs(loc - ref16[0]).max() <= FULL_MAX_NEAR * np.abs(gap).max()
    assert rms(loc - ref32[0]) >= FULL_RMS_FAR * rms(gap)


def test_score_and_train_gw_bf16_on_cpu(tmp_path):
    """`score --bf16` and `train_gw --bf16` end to end on the CPU; the bf16
    run's summary has exactly the keys of a float32 run."""
    res = score.main(["--run-dir", RUN_DIR, "--n-test", "2", "--thetas-from-run",
                      "--device", "cpu", "--bf16"])
    assert res["n"] == 2 and np.isfinite(res["mean_ll"]) and np.isfinite(res["median_mismatch"])
    common = ["--device", "cpu", "--steps", "2", "--batch", "2", "--n-test", "2"]
    s16 = train_gw.main([*common, "--bf16", "--out", str(tmp_path / "bf16")])
    s32 = train_gw.main([*common, "--out", str(tmp_path / "f32")])
    assert set(s16) == set(s32)
    assert np.isfinite(s16["test_ll_per_wf"]) and np.isfinite(s16["mismatch_median"])
    run_dir = tmp_path / "bf16" / "GW_time_cond_film_ctx192_d128" / "ConvCNP" / "run_0"
    assert json.loads((run_dir / "summary.json").read_text()) == s16
    assert load_model(str(run_dir), "cpu", dtype=BF16).dtype == BF16
