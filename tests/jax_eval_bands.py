"""The JAX package's own values of the two evaluation scripts, and the bands
`chip_smoke.py` holds the port's rescorings to. Not a test: run it by hand
on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_eval_bands.py --extrap [--kernels RBF_Kernel,...]
        [--models oracle,CNP,...] [--n-test 2560] [--chunk 64] --out F
    JAX_PLATFORMS=cpu python tests/jax_eval_bands.py --ctx [--runs RUN_DIR ...]
        [--n-test 1024] --out F
    python tests/jax_eval_bands.py --merge F ... [--out tests/jax_eval_bands.json]

`experiments/eval_extrapolation.py` and `experiments/gw_eval_ctx.py` keep
their loops local to `main`, so this file repeats them through the JAX
package: the same keys (`fold_in(PRNGKey(123), i)` for batch i, split as
each script splits it), the same model rebuild and state restore, the same
jitted forward and criterion. It keeps the per-function (per-waveform)
values the scripts reduce to their rows, and writes, per row, the row's
own statistics and their bands: the 99% interval of each statistic over
10,000 bootstrap resamples of half the values (`run_report`'s rule, drawn
from seed 0), widened by half its half-width on each side.

With `--extrap` each kernel's rows: the exact-GP oracle (`oracle_gp`) and
each model's run_0 under `results/<kernel>/`, over `--n-test` functions
(batches of 256) on twice the training range, the interpolation and
extrapolation per-function log-likelihoods of one forward, their mean,
std and median and the bands of the mean and the median. A latent model's
batch of 256 runs in chunks of `--chunk` functions: its z noise for the
whole batch is drawn from the key and shape the script's forward draws it
with (`NormalDiag.sample` is replaced while this file runs, never in the
package), and each chunk takes its slice, so that the values are the
script's own to float32 rounding while a ConvLNP batch (32 draws on the
384-point grid) stays within a few GB.

With `--ctx` each context-sweep record under `results/` (`ctx_sweep.json`
and `ctx_sweep_fixed.json`, at the counts each record holds): the
per-waveform mismatches of `--n-test` waveforms (batches of 256) and
their chirp masses, the script's seven fields, and the bands of p50 and
p90.

`--merge` joins the files of processes run side by side into one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
RESULTS = os.path.join(ROOT, "results")
OUT = os.path.join(ROOT, "tests", "jax_eval_bands.json")
KERNELS = ("RBF_Kernel", "Periodic_Kernel")
MODELS = ("oracle", "CNP", "LNP", "AttnCNP", "AttnLNP", "ConvCNP", "ConvLNP")
BS, MAX_CNTXT, N_POINTS = 256, 50, 256
SWEEP_FILES = ("ctx_sweep.json", "ctx_sweep_fixed.json")

__all__ = ["make_ctx_mask", "ctx_noise", "oracle_lls", "wide_range", "extrap_model",
           "extrap_state", "extrap_values", "sweep_state", "sweep_values", "sweep_row",
           "band", "sweep_records"]


def band(values: np.ndarray, stat) -> list:
    """`stat`'s 99% bootstrap interval at half the count, widened by half its
    half-width on each side (`run_report.bands_of`'s rule)."""
    from npf_gwwaveform_tpu_torch.run_report import BOOT_SEED, N_BOOT, QUANTILE, WIDEN

    idx = np.random.default_rng(BOOT_SEED).integers(0, values.shape[0],
                                                   (N_BOOT, values.shape[0] // 2))
    s = stat(values[idx], axis=1)
    lo, hi = np.quantile(s, [(1 - QUANTILE) / 2, (1 + QUANTILE) / 2])
    half = (hi - lo) / 2
    return [float(lo - WIDEN * half), float(hi + WIDEN * half)]


# ---------------------------------------------------------------- extrapolation


def ctx_noise(key, B, N, max_cntxt=MAX_CNTXT):
    """The draws `make_ctx_mask` makes from `key`: the counts n [B, 1] and the
    uniform scores [B, N]."""
    import jax

    kn, kp = jax.random.split(key)
    n = jax.random.randint(kn, (B, 1), 0, max_cntxt + 1)
    return n, jax.random.uniform(kp, (B, N))


def make_ctx_mask(key, x, max_cntxt=MAX_CNTXT):
    """`experiments/eval_extrapolation.py`'s `make_ctx_mask`, as written there."""
    import jax
    import jax.numpy as jnp

    B, N = x.shape[0], x.shape[1]
    kn, kp = jax.random.split(key)
    inner = jnp.abs(x[..., 0]) <= 1.0
    n = jax.random.randint(kn, (B, 1), 0, max_cntxt + 1)
    scores = jax.random.uniform(kp, (B, N)) + jnp.where(inner, 0.0, jnp.inf)
    _, idx = jax.lax.top_k(-scores, max_cntxt)
    sel = jnp.arange(max_cntxt)[None, :] < n
    sel = sel & jnp.take_along_axis(inner, idx, axis=1)
    rows = jnp.arange(B)[:, None]
    return jnp.zeros((B, N), bool).at[rows, idx].set(sel)


def wide_range(sampler) -> tuple:
    lo, hi = sampler.min_max
    return (2.0 * lo, 2.0 * hi)


def oracle_lls(sampler, x, y, mask_c, mask_t):
    """The script's `oracle_lls` for one function (vmap it over a batch)."""
    import jax.numpy as jnp

    lo_, hi_ = sampler.min_max
    xn = (x + 1.0) * 0.5 * (hi_ - lo_) + lo_
    ls = jnp.asarray(sampler.length_scale)
    K = sampler._cov(xn, ls, jitter=0.0)
    big = 1e8
    A = K + jnp.diag(jnp.where(mask_c, sampler.sample_jitter, big))
    yc = jnp.where(mask_c[:, None], y, 0.0)
    sol = jnp.linalg.solve(A, jnp.concatenate([yc, K], axis=1))
    mean = (K @ sol[:, :1])[:, 0]
    var = (jnp.clip(jnp.diag(K) - jnp.sum(K * sol[:, 1:].T, axis=1), 1e-8)
           + sampler.sample_jitter)
    ll = -0.5 * ((y[:, 0] - mean) ** 2 / var + jnp.log(2 * jnp.pi * var))
    return jnp.sum(jnp.where(mask_t, ll, 0.0))


def sampler_of(kernel, n_points=N_POINTS):
    from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler

    return GPSampler(n_points=n_points, **dict(KERNEL_CONFIGS[kernel]))


def extrap_model(name):
    """The script's model: `reproduce_gp.build_model(name)` (the default
    BatchNorm eps), a conv model at twice its own induced range."""
    from experiments.reproduce_gp import build_model

    model = build_model(name)
    if hasattr(model, "induced_range"):
        model = model.clone(induced_range=tuple(2.0 * v for v in model.induced_range))
    return model


def extrap_state(kernel, name, model=None):
    """(model, trainer, state) restored from `results/<kernel>/<name>/run_0`
    as the script restores it."""
    import jax

    from experiments.reproduce_gp import criterion_for
    from npf_gwwaveform_tpu.data import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
    from npf_gwwaveform_tpu.training import (
        Trainer, create_train_state, load_run_params, make_optimizer,
    )

    sampler = sampler_of(kernel)
    model = extrap_model(name) if model is None else model
    tx = make_optimizer(lr=1e-3, decay_lr=None)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=MAX_CNTXT),
                                 targets_getter=get_all_indcs)
    trainer = Trainer(model, criterion_for(name), tx, splitter=splitter)
    key = jax.random.PRNGKey(0)
    x0, y0 = sampler.sample(key, 16, min_max=wide_range(sampler))
    state = create_train_state(model, tx, splitter(key, x0, y0), seed=0)
    state = load_run_params(os.path.join(RESULTS, kernel, name, "run_0"), state)
    return model, trainer, state


# the chunk's first function and the whole batch's size while a chunked
# forward is traced: the replaced `NormalDiag.sample` draws the whole
# batch's noise and takes the chunk's slice of it
_CHUNK = {}


def _install_chunked_sample():
    import jax
    import jax.numpy as jnp

    from npf_gwwaveform_tpu import distributions

    cls = distributions.NormalDiag
    if getattr(cls, "_chunked", False):
        return
    orig = cls.sample

    def sample(self, key, sample_shape=()):
        if not _CHUNK:
            return orig(self, key, sample_shape)
        lead = len(tuple(sample_shape))
        shape = tuple(sample_shape) + (_CHUNK["n"],) + tuple(self.loc.shape[1:])
        eps = jax.random.normal(key, shape, dtype=jnp.float32)
        eps = jax.lax.dynamic_slice_in_dim(eps, _CHUNK["lo"], self.loc.shape[0], axis=lead)
        return self.loc + self.scale * eps

    cls.sample = sample
    cls.rsample = sample
    cls._chunked = True


def extrap_values(kernel, name, n_test, chunk=BS, verbose=True) -> dict:
    """{interp, extrap}: the per-function log-likelihoods the script reduces
    to its row, batch i from `fold_in(PRNGKey(123), i)`; a latent model's
    forward in chunks of `chunk` functions."""
    import jax
    import jax.numpy as jnp

    sampler = sampler_of(kernel)
    wide = wide_range(sampler)
    li, le = [], []
    t0 = time.perf_counter()
    if name == "oracle":
        @jax.jit
        def oracle_batch(key):
            kd, ks = jax.random.split(key)
            x, y = sampler.sample(kd, BS, min_max=wide)
            mask_c = make_ctx_mask(ks, x)
            inner = jnp.abs(x[..., 0]) <= 1.0
            f = jax.vmap(lambda *a: oracle_lls(sampler, *a))
            return f(x, y, mask_c, inner), f(x, y, mask_c, ~inner)

        for i in range(max(1, n_test // BS)):
            a, b = oracle_batch(jax.random.fold_in(jax.random.PRNGKey(123), i))
            li.append(np.asarray(a))
            le.append(np.asarray(b))
        return dict(interp=np.concatenate(li), extrap=np.concatenate(le),
                    seconds=time.perf_counter() - t0)

    model, trainer, state = extrap_state(kernel, name)
    latent = bool(getattr(model, "has_latent", False))
    chunk = chunk if latent else BS
    if latent:
        _install_chunked_sample()

    @jax.jit
    def draws(key):
        kd, ks, kl = jax.random.split(key, 3)
        x, y = sampler.sample(kd, BS, min_max=wide)
        return x, y, make_ctx_mask(ks, x), kl

    @jax.jit
    def forward(params, extra, x, y, mask_c, kl, lo):
        inner = jnp.abs(x[..., 0]) <= 1.0
        batch = dict(X_cntxt=x, Y_cntxt=y, mask_cntxt=mask_c, X_trgt=x, Y_trgt=y,
                     mask_trgt=jnp.ones_like(inner))
        if latent:
            _CHUNK.update(lo=lo, n=BS)
        try:
            out, _ = trainer._apply(params, extra, batch, kl, train=False)
        finally:
            _CHUNK.clear()
        return tuple(-trainer.eval_criterion(out, y, m, train=False) for m in (inner, ~inner))

    for i in range(max(1, n_test // BS)):
        x, y, mask_c, kl = draws(jax.random.fold_in(jax.random.PRNGKey(123), i))
        for lo in range(0, BS, chunk):
            sl = slice(lo, lo + chunk)
            a, b = forward(state.params, state.extra_vars, x[sl], y[sl], mask_c[sl], kl,
                           jnp.int32(lo))
            li.append(np.asarray(a))
            le.append(np.asarray(b))
        if verbose:
            print(f"  {kernel} {name}: batch {i} ({time.perf_counter() - t0:.0f}s)", flush=True)
    return dict(interp=np.concatenate(li), extrap=np.concatenate(le),
                seconds=time.perf_counter() - t0)


def extrap_entry(kernel, name, vals) -> dict:
    """The script's row and, for each of interp and extrap, the statistics
    and their bands."""
    li, le = vals["interp"], vals["extrap"]
    row = {"model": "oracle_gp" if name == "oracle" else name, "kernel": kernel,
           "interp_ll_per_fn": float(li.mean()), "extrap_ll_per_fn": float(le.mean()),
           "interp_std": float(li.std()), "extrap_std": float(le.std()),
           "n_test": int(li.shape[0])}
    entry = {"row": row, "seconds": vals["seconds"]}
    for tag, v in (("interp", li), ("extrap", le)):
        entry[tag] = {"mean": float(v.mean()), "median": float(np.median(v)),
                      "std": float(v.std()), "mean_band": band(v, np.mean),
                      "median_band": band(v, np.median)}
    return entry


# ---------------------------------------------------------------- context sweeps


def sweep_records(results=RESULTS) -> list:
    """[(run directory relative to `results`, file name, counts)] of every
    context-sweep record, sorted."""
    out = []
    for path in sorted(glob.glob(os.path.join(results, "*", "*", "run_*", "ctx_sweep*.json"))):
        with open(path) as f:
            counts = [r["n_context"] for r in json.load(f)]
        out.append((os.path.relpath(os.path.dirname(path), results), os.path.basename(path),
                    counts))
    return out


def sweep_state(run_dir, n_points=None):
    """The script's restored (trainer, state, make_batch, space, conditioned)."""
    import jax
    import jax.numpy as jnp

    from npf_gwwaveform_tpu.configs import gw_model_from_summary
    from npf_gwwaveform_tpu.data import (
        CntxtTrgtSplitter, GetRandomIndcs, GWParameterSpace, GWWaveformGenerator, get_all_indcs,
    )
    from npf_gwwaveform_tpu.losses import CNPFLoss
    from npf_gwwaveform_tpu.training import (
        Trainer, create_train_state, load_run_params, make_optimizer,
    )

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    conditioned = bool(summary.get("conditioned"))
    model = gw_model_from_summary(summary)
    gen = GWWaveformGenerator(duration=float(summary.get("duration", 1.0)), sample_rate=1024.0)
    space = GWParameterSpace()
    n_points = n_points if n_points is not None else int(summary.get("n_points", 256))
    stride = gen.n_time // n_points
    x_grid = jnp.linspace(-1.0, 1.0, n_points)

    def make_batch(key, n):
        theta = space.sample(key, n)
        _, h = gen.time_domain(theta)
        h = h[..., -n_points * stride::stride][..., :n_points]
        x = jnp.broadcast_to(x_grid[None, :, None], (n, n_points, 1))
        return x, h[..., None], theta

    init_splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=64),
                                      targets_getter=get_all_indcs)
    tx = make_optimizer(lr=1e-3, decay_lr=None)
    trainer = Trainer(model, CNPFLoss(), tx, splitter=init_splitter)
    key = jax.random.PRNGKey(0)
    x0, y0, th0 = make_batch(key, 16)
    ex = init_splitter(key, x0, y0, condition=space.normalize(th0) if conditioned else None)
    state = create_train_state(model, tx, ex, seed=0)
    state = load_run_params(run_dir, state)
    return trainer, state, make_batch, space, conditioned


def sweep_splitter(n_ctx, fixed):
    from npf_gwwaveform_tpu.data import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs

    return CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=float(n_ctx) if fixed else 0.0, b=n_ctx,
                                       is_indep_n=not fixed),
        targets_getter=get_all_indcs)


def sweep_values(run_dir, counts, fixed, n_test, restored=None) -> dict:
    """{n_ctx: (mismatch [n], chirp mass [n])} as the script computes them."""
    import jax
    import jax.numpy as jnp

    from npf_gwwaveform_tpu.data.gw import mismatch

    trainer, state, make_batch, space, conditioned = (
        sweep_state(run_dir) if restored is None else restored)
    out = {}
    for n_ctx in counts:
        splitter = sweep_splitter(n_ctx, fixed)

        @jax.jit
        def eval_batch(state, key):
            kd, ks, kl = jax.random.split(key, 3)
            x, y, theta = make_batch(kd, BS)
            cond = space.normalize(theta) if conditioned else None
            batch = splitter(ks, x, y, condition=cond)
            o, _ = trainer._apply(state.params, state.extra_vars, batch, kl, train=False)
            pred = jnp.mean(o.p_yCc.loc, axis=0)
            return mismatch(pred[..., 0], y[..., 0]), theta

        mms, mcs = [], []
        for i in range(max(1, n_test // BS)):
            mm, theta = eval_batch(state, jax.random.fold_in(jax.random.PRNGKey(123), i))
            mms.append(np.asarray(mm))
            th = np.asarray(theta)
            mcs.append((th[:, 0] * th[:, 1]) ** 0.6 / (th[:, 0] + th[:, 1]) ** 0.2)
        out[n_ctx] = (np.concatenate(mms), np.concatenate(mcs))
    return out


def sweep_row(n_ctx, mm, mc) -> dict:
    """The script's row of one count."""
    lo = mc <= np.percentile(mc, 33.3)
    return {"n_context": n_ctx, "p50": float(np.median(mm)), "p90": float(np.percentile(mm, 90)),
            "p99": float(np.percentile(mm, 99)),
            "low_mc_tercile_p50": float(np.median(mm[lo])),
            "low_mc_tercile_p90": float(np.percentile(mm[lo], 90)),
            "frac_below_0.03": float((mm < 0.03).mean())}


def _p90(v, axis):
    return np.percentile(v, 90, axis=axis)


# ---------------------------------------------------------------- entry point


def _write(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extrap", action="store_true")
    ap.add_argument("--ctx", action="store_true")
    ap.add_argument("--merge", nargs="*", default=None, metavar="F")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--runs", nargs="*", default=None, help="sweep run dirs under results/")
    ap.add_argument("--n-test", type=int, default=None,
                    help="functions (2560) or waveforms (1024)")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    if args.merge is not None:
        data = {"extrapolation": {}, "ctx_sweep": {}}
        for path in args.merge:
            with open(path) as f:
                part = json.load(f)
            for k, v in part.get("extrapolation", {}).items():
                data["extrapolation"].setdefault(k, {}).update(v)
            for k, v in part.get("ctx_sweep", {}).items():
                data["ctx_sweep"].setdefault(k, {}).update(v)
        _write(args.out, data)
        return
    data = {"extrapolation": {}, "ctx_sweep": {}}
    if args.extrap:
        n = args.n_test or 2560
        for kernel in args.kernels.split(","):
            for name in args.models.split(","):
                if name == "oracle" and kernel != "RBF_Kernel":
                    continue  # the script's docstring: the periodic solve is ill-conditioned
                vals = extrap_values(kernel, name, n, args.chunk)
                entry = extrap_entry(kernel, name, vals)
                data["extrapolation"].setdefault(kernel, {})[entry["row"]["model"]] = entry
                print(json.dumps(entry["row"]), f"({vals['seconds']:.0f}s)", flush=True)
                _write(args.out, data)
    if args.ctx:
        n = args.n_test or 1024
        want = None if args.runs is None else {os.path.relpath(os.path.abspath(r), RESULTS)
                                                for r in args.runs}
        for rel, fname, counts in sweep_records():
            if want is not None and rel not in want:
                continue
            t0 = time.perf_counter()
            vals = sweep_values(os.path.join(RESULTS, rel), counts, fname.endswith("_fixed.json"),
                                n)
            rows = []
            for n_ctx, (mm, mc) in vals.items():
                row = sweep_row(n_ctx, mm, mc)
                row.update(n=int(mm.shape[0]), p50_band=band(mm, np.median),
                           p90_band=band(mm, _p90))
                rows.append(row)
            data["ctx_sweep"].setdefault(rel, {})[fname] = {
                "rows": rows, "seconds": time.perf_counter() - t0}
            print(rel, fname, json.dumps([(r["n_context"], r["p50"], r["p90"]) for r in rows]),
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            _write(args.out, data)


if __name__ == "__main__":
    main()
