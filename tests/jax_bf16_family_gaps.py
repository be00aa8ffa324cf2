"""The JAX package's own gap between bfloat16 and float32 scoring of every
GW ConvCNP run in `results/` but the flagship's `run_1` (which
`tests/jax_bf16_score_gap.py` covers), time-domain and frequency-domain,
and of every GW ConvLNP run, for setting the port's bf16 scoring bars. Not
a test: run it by hand on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_bf16_family_gaps.py [--n 2048] [--n-long 256]
        [--long-batch 256] [--n-latent-bf16 256] [--latent-batch 64]
        [--out tests/jax_bf16_family_gaps.json] [--runs RUN_DIR ...]

A ConvLNP run is scored at its 32 z draws a waveform (NPML without
importance weights; the ELBO run from q(z|C,T), its targets given, as
`reproduce_gw.py` scores it), the draws from one latent key per batch, the
same in both dtypes (the noise is drawn in float32 whatever the dtype), in
batches of `--latent-batch`: in float32 on the first `--n` thetas, which
give its `f32_bands` (the records of these runs were not made with the JAX
package's float32 arithmetic either: `tests/jax_score_offsets.py`), and in
bf16 on the first `--n-latent-bf16` (op by op bf16 at 32 draws is slow on
the CPU); the gap is taken over those.

Each run is scored on its first `--n` recorded thetas (`--n-long` for the
2 s long-waveform runs, whose bf16 model with the chain in interpret mode is
slow on the CPU) in batches of 256 (`--long-batch` for the long runs: the
interpret-mode chain holds about 25 GB at 256 long waveforms), with the
run's own generator (1024 Hz over its duration; `n_points` evenly strided
samples, or for a `freq_ap` run amplitude and standardised phase on
`n_points` frequencies, scored with `reproduce_gw.py`'s PSD-weighted
frequency-domain mismatch of the rebuilt h(f)) and the eval split's U{0..n_context}
context counts drawn from one key per batch, with the run's parameters two
ways on the same inputs: float32 (`gw_model_from_summary`) and bfloat16
with the fused MLP-chain decoder (`fused_mlp=True`, the Pallas chain in
interpret mode: the model the port's kernel path matches), built as
`reproduce_gw.py --bf16` builds the run's architecture. Both take the XLA
SetConv (`use_pallas_setconv=False`): the Pallas one computes the same
function to float32 rounding and is slow in interpret mode. Writes, per run
(keyed by its path under `results/`), the number scored and the batch, each
way's mean log-likelihood and median mismatch, the bf16-minus-float32 difference of
the means and of the medians, the mean and standard deviation of the
per-waveform log-likelihood differences and, for a `freq_ap` run, the
float32 scores' bands (`f32_bands`: `run_report.bands_of`, the rule of the
recorded scores' bands; the records of those runs sit between the JAX
package's float32 and bf16 scores on the CPU, so the port's float32
rescoring is held to the JAX package's own), into `--out` as JSON, and
prints one line a run.

XLA's excess precision is turned off (`--xla_allow_excess_precision=false`)
so that every bf16 op under jit rounds its result, as the ops read and as
the port computes (tests/test_torch_bf16_slice.py).
"""

import argparse
import glob
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_allow_excess_precision=false").strip()

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from npf_gwwaveform_tpu.configs import gp_model_1d, gw_model_from_summary  # noqa: E402
from npf_gwwaveform_tpu.data import (  # noqa: E402
    CntxtTrgtSplitter, GetRandomIndcs, GWParameterSpace, GWWaveformGenerator, get_all_indcs,
)
from npf_gwwaveform_tpu.data.gw import mismatch, mismatch_fd, psd_aligo  # noqa: E402
from npf_gwwaveform_tpu.losses import CNPFLoss  # noqa: E402
from npf_gwwaveform_tpu_torch.run_report import bands_of  # noqa: E402

RESULTS = os.path.join(ROOT, "results")
FLAGSHIP = os.path.join("GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")


def _restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


def models(summary):
    """(float32, bf16 fused) JAX models of the run, XLA SetConv on both."""
    if summary["model"] == "ConvLNP":
        return latent_models(summary)
    dilations = summary.get("cnn_dilations")
    bf16 = gp_model_1d("ConvCNP", dtype=jnp.bfloat16,
                       cnn_kernel_size=summary.get("cnn_kernel_size") or 19,
                       cnn_dilations=tuple(dilations) if dilations else None,
                       cnn_arch=summary.get("cnn_arch", "cnn"))
    cond = bool(summary.get("conditioned"))
    bf16 = bf16.clone(y_dim=1 if summary.get("mode", "time") == "time" else 2,
                      cond_dim=4 if cond else 0,
                      cond_mode=summary.get("cond_mode") or "film", fused_mlp=True,
                      **({"density_induced": summary["density_induced"]}
                         if summary.get("density_induced") else {}))
    f32 = gw_model_from_summary(summary).clone(use_pallas_setconv=False)
    return f32, bf16


def latent_models(summary):
    """(float32, bf16) JAX models of a ConvLNP run, XLA SetConv on both, the
    bf16 one built as `reproduce_gw.py --bf16` builds it."""
    f32 = gw_model_from_summary(summary).clone(use_pallas_setconv=False)
    bf16 = gp_model_1d("ConvLNP", dtype=jnp.bfloat16).clone(
        cond_dim=4 if summary.get("conditioned") else 0,
        cond_mode=summary.get("cond_mode") or "film",
        **({"lat_scale_transform": "softplus", "min_lat_sigma": 1e-4}
           if summary.get("no_lat_lb") else {}),
        **({"is_q_zCct": True, "n_z_samples_train": 1}
           if summary.get("train_loss_objective") == "elbo" else {}))
    return f32, bf16


def gap(run_dir, n, batch, n_bf16=None):
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    variables = {"params": _restore(os.path.join(run_dir, "params.msgpack")),
                 **_restore(os.path.join(run_dir, "extra_vars.msgpack"))}
    thetas = np.loadtxt(os.path.join(run_dir, "mismatch_theta.csv"), delimiter=",",
                        ndmin=2)[:n, 1:5].astype(np.float32)
    gen = GWWaveformGenerator(duration=summary.get("duration", 1.0), sample_rate=1024.0)
    space = GWParameterSpace()
    splitter = CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=0.0, b=summary["n_context"], is_indep_n=True),
        targets_getter=get_all_indcs)
    n_points = summary.get("n_points", 256)
    stride = gen.n_time // n_points
    cond = bool(summary.get("conditioned"))
    freq = summary.get("mode", "time") == "freq_ap"

    def data(theta):
        """reproduce_gw.py's make_batch: (y, mismatch of a prediction)."""
        if not freq:
            _, h = gen.time_domain(theta)
            y = h[..., -n_points * stride::stride][..., :n_points, None]
            return y, lambda loc: mismatch(loc[..., 0], y[..., 0])
        fd = gen.frequency_domain(theta, n_f=n_points)
        sigma = jnp.std(fd.phase, -1, keepdims=True)
        psi = (fd.phase - jnp.mean(fd.phase, -1, keepdims=True)) / (sigma + 1e-8)
        y = jnp.stack([fd.amplitude, psi], axis=-1)
        psd = psd_aligo(gen.freqs(n_points))

        def recon(ap):
            return ap[..., 0] * jnp.exp(-1j * ap[..., 1] * sigma)
        return y, lambda loc: mismatch_fd(recon(loc), recon(y), psd=psd)

    def scorer(model):
        @jax.jit
        def score(theta, key):
            y, mismatch_of = data(theta)
            x = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, n_points)[None, :, None],
                                 y.shape[:2] + (1,))
            batch = splitter(key, x, y, condition=space.normalize(theta) if cond else None)
            out = model.apply(variables, batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                              batch["Y_trgt"], mask_cntxt=batch["mask_cntxt"],
                              mask_trgt=batch["mask_trgt"],
                              **({"condition": batch["condition"]} if cond else {}),
                              train=False, rngs={"latent": jax.random.fold_in(key, 1)})
            ll = -CNPFLoss(reduction=None)(out, batch["Y_trgt"], batch["mask_trgt"], train=False)
            return ll, mismatch_of(jnp.mean(out.p_yCc.loc, axis=0))
        return score

    res = []
    for model, count in zip(models(summary), (len(thetas), n_bf16 or len(thetas))):
        score = scorer(model)
        parts = [score(jnp.asarray(thetas[i:i + batch]),
                       jax.random.fold_in(jax.random.PRNGKey(0), i))
                 for i in range(0, count, batch)]
        res.append([np.concatenate([np.asarray(p[k], np.float32) for p in parts])
                    for k in range(2)])
    (ll32_all, mm32_all), (ll16, mm16) = res
    ll32, mm32 = ll32_all[:len(ll16)], mm32_all[:len(ll16)]
    d = ll16 - ll32
    latent = summary["model"] == "ConvLNP"
    bands = {"f32_bands": bands_of(ll32_all, mm32_all)} if freq or latent else {}
    if latent:
        bands["f32_all"] = {"n": int(len(ll32_all)), "mean_ll": float(ll32_all.mean()),
                            "median_mismatch": float(np.median(mm32_all))}
    return {"n": int(len(ll16)), "batch": batch, **bands,
            "f32": {"mean_ll": float(ll32.mean()), "median_mismatch": float(np.median(mm32))},
            "bf16": {"mean_ll": float(ll16.mean()), "median_mismatch": float(np.median(mm16))},
            "d_mean_ll": float(ll16.mean() - ll32.mean()),
            "d_median_mismatch": float(np.median(mm16) - np.median(mm32)),
            "d_ll_mean": float(d.mean()), "d_ll_std": float(d.std())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--n-long", type=int, default=256)
    ap.add_argument("--long-batch", type=int, default=256)
    ap.add_argument("--n-latent-bf16", type=int, default=256)
    ap.add_argument("--latent-batch", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "jax_bf16_family_gaps.json"))
    ap.add_argument("--runs", nargs="*", default=None,
                    help="run dirs (default: every GW ConvCNP run with parameters)")
    args = ap.parse_args()
    runs = args.runs or sorted(
        os.path.dirname(p) for model in ("ConvCNP", "ConvLNP") for p in glob.glob(
            os.path.join(RESULTS, "GW_*", model, "run_*", "params.msgpack"))
        if not os.path.dirname(p).endswith(FLAGSHIP))
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for run_dir in runs:
        name = os.path.relpath(os.path.abspath(run_dir), RESULTS)
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        if summary["model"] == "ConvLNP":
            out[name] = gap(run_dir, args.n, args.latent_batch, args.n_latent_bf16)
        elif summary.get("duration", 1.0) != 1.0:
            out[name] = gap(run_dir, args.n_long, args.long_batch)
        else:
            out[name] = gap(run_dir, args.n, 256)
        r = out[name]
        print(f"{name}: n {r['n']}, f32 mean LL {r['f32']['mean_ll']:.3f}, bf16 "
              f"{r['bf16']['mean_ll']:.3f}, gap {r['d_mean_ll']:+.4f} (sd {r['d_ll_std']:.3f}), "
              f"median mismatch gap {r['d_median_mismatch']:+.2e}", flush=True)
        with open(args.out, "w") as f:  # after every run: a long job keeps what it has
            json.dump(dict(sorted(out.items())), f, indent=1)


if __name__ == "__main__":
    main()
