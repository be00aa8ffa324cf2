"""`npf_gwwaveform_tpu_torch.gw_eval_ctx` against `experiments/gw_eval_ctx.py`,
whose loop `tests/jax_eval_bands.py` repeats through the JAX package.

The splitters get JAX's own draws: the port's `GetRandomIndcs` is handed
the counts and scores JAX's draws from the same key (`torch.randint` and
`torch.rand` replaced for the call), and its masks must equal JAX's bit for
bit, for U{0..n} and for `--fixed` n, at every count of the records. The
sweep row takes JAX's first batch of `GW_time_cond_film_ctx192_d128/run_1`
(thetas, waveforms and masks from `fold_in(PRNGKey(123), 0)`, its first
64 waveforms; the port's generator is held to JAX's in tests/test_torch_gw.py):
each waveform's mismatch within 1e-3 of JAX's plus four float32 steps of
1 - match just below 1 (4 * 2^-24), the chirp masses bit for bit, and the
row's quantiles within the same bound. A mismatch is 1 - match of a
predictive mean whose loc the GW run tests hold to 5e-4; measured: at most
3.6e-4 of JAX's mismatch (7e-7 at 0.00198) with U{0..64} contexts, and at
most 3 steps of 2^-24 (1.8e-7 at 1.16e-5) with all 256 points, where the
mismatches are 1.2e-5 to 5.3e-5 and float32 resolves them only to 2^-24.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax_eval_bands as jeb
from npf_gwwaveform_tpu_torch import gw_eval_ctx, score
from npf_gwwaveform_tpu_torch.data.gw import mismatch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
RUN = os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
N_WF, MM_RTOL, MM_ATOL = 64, 1e-3, 4 * 2.0 ** -24


def jax_draws(key, B, N, b, fixed):
    """The count(s) and scores JAX's splitter draws from `key` (its
    `GetRandomIndcs` takes the first half of the key's split)."""
    import jax

    k_n, _, _, k_perm = jax.random.split(jax.random.split(key)[0], 4)
    a = b if fixed else 0
    n = jax.random.randint(k_n, () if fixed else (B, 1), a, b + 1)
    return np.asarray(n), np.asarray(jax.random.uniform(k_perm, (B, N)))


@pytest.mark.parametrize("fixed", [False, True])
def test_splitters_equal_jax_on_its_draws(fixed, monkeypatch):
    import jax

    B, N = 256, 256
    x = torch.zeros((B, N, 1))
    for i, n_ctx in enumerate((16, 32, 64, 128, 192, 256)):
        key = jax.random.fold_in(jax.random.PRNGKey(123), i)
        mask_j = np.asarray(jeb.sweep_splitter(n_ctx, fixed)(key, np.zeros((B, N, 1)),
                                                               np.zeros((B, N, 1)))["mask_cntxt"])
        n, u = jax_draws(key, B, N, n_ctx, fixed)
        monkeypatch.setattr(torch, "randint", lambda lo, hi, shape, **kw: torch.from_numpy(
            np.broadcast_to(n, shape).astype(np.int64)))
        monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.from_numpy(u))
        mask = score.eval_splitter(n_ctx, fixed)(torch.Generator(), x, x)["mask_cntxt"]
        monkeypatch.undo()
        assert np.array_equal(mask.numpy(), mask_j), (n_ctx, fixed)
        sizes = mask.numpy().sum(1)
        assert (sizes == n_ctx).all() if fixed else (sizes <= n_ctx).all()


@functools.lru_cache(maxsize=None)
def jax_first_batch(n_ctx, fixed):
    """JAX's per-waveform mismatches, thetas and masks of batch 0 at one count
    (its first N_WF waveforms), as the script computes them."""
    import jax
    import jax.numpy as jnp

    from npf_gwwaveform_tpu.data.gw import mismatch as jax_mismatch

    trainer, state, make_batch, space, conditioned = _jax_state()
    kd, ks, kl = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), 0), 3)
    x, y, theta = make_batch(kd, 256)
    batch = jeb.sweep_splitter(n_ctx, fixed)(ks, x, y, condition=space.normalize(theta))
    batch = {k: v[:N_WF] for k, v in batch.items()}
    out, _ = trainer._apply(state.params, state.extra_vars, batch, kl, train=False)
    mm = jax_mismatch(jnp.mean(out.p_yCc.loc, axis=0)[..., 0], y[:N_WF, :, 0])
    return tuple(np.asarray(a) for a in (mm, theta[:N_WF], batch["mask_cntxt"], x[:N_WF],
                                         y[:N_WF]))


@functools.lru_cache(maxsize=None)
def _jax_state():
    return jeb.sweep_state(RUN)


@pytest.mark.parametrize("n_ctx,fixed", [(64, False), (256, True)])
def test_sweep_row_on_jax_thetas_and_masks(n_ctx, fixed):
    j_mm, theta, mask_c, j_x, j_y = jax_first_batch(n_ctx, fixed)
    th = theta.astype(np.float32)
    j_mc = (th[:, 0] * th[:, 1]) ** 0.6 / (th[:, 0] + th[:, 1]) ** 0.2
    j_row = jeb.sweep_row(n_ctx, j_mm, j_mc)
    assert np.array_equal(gw_eval_ctx.chirp_mass(th), j_mc)
    assert gw_eval_ctx.sweep_row(n_ctx, j_mm, j_mc) == j_row
    if fixed:
        assert mask_c.all()
    model = score.load_model(RUN, "cpu")
    with open(os.path.join(RUN, "summary.json")) as f:
        summary = json.load(f)
    gen, space = score.run_generator(summary), score.GWParameterSpace()
    _, _, cond = score.make_eval_batch(torch.from_numpy(th), gen, space)
    x, y, mt = (torch.from_numpy(np.array(a)) for a in (j_x, j_y, mask_c))
    with torch.no_grad():
        out = model(x, y, x, mt, torch.ones_like(mt), condition=cond, y_trgt=y)
    mm = mismatch(out.p_yCc.loc.mean(dim=0)[..., 0], y[..., 0]).double().numpy()
    err = np.abs(mm - j_mm)
    assert np.all(err <= MM_RTOL * np.abs(j_mm) + MM_ATOL), err.max()
    row = gw_eval_ctx.sweep_row(n_ctx, mm, gw_eval_ctx.chirp_mass(th))
    for k, v in j_row.items():
        bound = 0 if k == "n_context" else MM_RTOL * abs(v) + MM_ATOL
        assert abs(row[k] - v) <= bound, (k, row[k], v)


def test_fixed_256_through_the_entry_point(tmp_path):
    rows = gw_eval_ctx.main([RUN, "--ctx", "256", "--fixed", "--n-test", "4", "--device", "cpu",
                             "--out", str(tmp_path)])
    path = tmp_path / "GW_time_cond_film_ctx192_d128" / "ConvCNP" / "run_1" / "ctx_sweep_fixed.json"
    with open(path) as f:
        assert json.load(f) == rows
    with open(os.path.join(RUN, "ctx_sweep_fixed.json")) as f:
        assert list(rows[0]) == list(json.load(f)[0])
    assert len(rows) == 1 and rows[0]["n_context"] == 256 and rows[0]["p90"] < 1e-3


def test_out_under_results_or_the_run_is_refused():
    for out in (RESULTS, os.path.join(RESULTS, "sweeps"), RUN):
        with pytest.raises(SystemExit):
            gw_eval_ctx.main([RUN, "--ctx", "16", "--device", "cpu", "--out", out])


def test_out_refused_from_another_working_directory(tmp_path, monkeypatch):
    """The guard takes the tree of runs from the run directory, and checks
    the directory the file would land in, whatever the working directory."""
    monkeypatch.chdir(tmp_path)
    assert gw_eval_ctx.runs_root(RUN) == os.path.realpath(RESULTS)
    for out in (RESULTS, os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128"),
                os.path.relpath(RESULTS)):
        with pytest.raises(SystemExit):
            gw_eval_ctx.main([RUN, "--ctx", "16", "--device", "cpu", "--out", out])
    with pytest.raises(ValueError, match="run directory"):
        gw_eval_ctx.check_out(str(tmp_path), RUN, RUN)
    with pytest.raises(SystemExit):
        gw_eval_ctx.main(["--plot", RUN, "--out", RUN])


def test_plot_writes_a_png(tmp_path):
    dirs = []
    for i, tag in enumerate(("GW_time_cond_film_ctx64", "GW_time_cond_film_ctx192_d128")):
        d = tmp_path / "sweeps" / tag / "ConvCNP" / "run_0"
        d.mkdir(parents=True)
        rows = [{"n_context": n, "p50": 0.1 / n * (i + 1), "p90": 1.0 / n * (i + 1)}
                for n in (16, 64, 192)]
        (d / "ctx_sweep.json").write_text(json.dumps(rows))
        dirs.append(str(d))
    out = gw_eval_ctx.main(["--plot", *dirs, "--out", str(tmp_path / "fig")])
    assert out.endswith("gw_ctx_sweep.png") and os.path.getsize(out) > 10_000
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
