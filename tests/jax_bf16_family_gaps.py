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

With `--gp` (or GP run directories in `--runs`) it scores the conv-family
GP runs (`run_report.gp_runs`) in float32 only, as `reproduce_gp.py` draws
its eval set (kernel component c's batch i of 256 functions from
`fold_in(k_data, i)`, folded with c from the second component on, its split
and z keys from `k_split`), at least `--n` functions a run in whole batches
split evenly over its components (2,304 for `All_Kernels` at 2,048;
`--n-gp-cnp`, 9,984, for a ConvCNP run, cheap on the CPU), in chunks of
`--latent-batch` (each chunk its own z key), and writes each run's
`f32_bands` ({"mean_ll": band}, `run_report.bands_of` at half the count):
the records were not made with the JAX package's float32 arithmetic
(`tests/jax_score_offsets.py`: on the records' own draws JAX scores one to
ten nats a function above them), so `chip_smoke.py` holds the port's GP
rescorings to these bands and prints the records' beside. The functions
and splits are the JAX package's eval draws; the forward is the port's on
the CPU (`gp_f32`), which equals the JAX package's on identical inputs to
0.08 nats a function: XLA's CPU depthwise convolutions would take hours a
latent run. `--shard i/k` takes every k-th GP run from the i-th, for k
processes side by side (each writes `--out` with its runs only).

With `--gp-set` it does the same for the 57 set and attention GP runs
(`run_report.gp_set_runs`: CNP, LNP, AttnCNP, AttnLNP, the LNP and AttnLNP
ablation grids, `LNP_SUMO`), at `--n-gp-set` functions a run (9,984, a
kernel's whole eval set; for `All_Kernels` 3,328 of each component), each
latent run at its
own eval draws (32 for LNP, 8 for AttnLNP; an NPVI-trained run from
q(z|C,T), its targets given, as JAX's eval step samples it): about 1.4 s
a chunk of 64 LNP functions on one CPU thread, ~4 min a 32-draw run.

With `--img` it does the same for the 20 scorable image runs
(`run_report.img_runs(scored=True)`): each run's whole test set (160, 256
or 1,024 images) in `reproduce_img.py`'s eval batches of 32, the images
the JAX package's corpus, the context masks (or point sets) the JAX
package's eval splitter draws from batch i's `fold_in(PRNGKey(123), i)`
(its split key), the forward the port's on the CPU (z from a CPU generator
seeded by the batch); `f32_bands` is `run_report.bands_of` at half the
count. About 40 minutes on two threads for all 20.

With `--gp-bf16` it takes the JAX package's own bf16-float32 gap of the GP
bar runs (`run_report.gp_bf16_bar_runs`: RBF and Matern ConvCNP, ConvLNP,
CNP, LNP, AttnCNP and AttnLNP run_0, and the ELBO ConvLNP ablation run),
with `--img-bf16` that of the image bar runs (`run_report.img_bf16_bar_runs`:
the six `digits` runs, `zsmms/GridConvCNP/run_1` and
`rgb_digits128/GridConvCNPXL/run_0`): each run's JAX model three ways on the
same inputs, float32, bf16 with the fused MLP-chain decoder
(`fused_mlp=True`, the Pallas chain in interpret mode: the model the port's
kernel path matches) and bf16 with the Dense decoder the scripts build (the
port's plain path), as `reproduce_gp.py --bf16` and
`reproduce_img.build_model(name, dtype=jnp.bfloat16)` build them, every
forward JAX's own. The functions, images, context masks and z draws are
JAX's eval draws as `--gp`, `--gp-set` and `--img` draw them (a GP chunk's
z key is folded from the second half of its batch's split key, an image
batch's from `fold_in(PRNGKey(123), i)`'s), the same for the three models.
A GP run scores the first `--n-gp-bf16` functions of each kernel in chunks
of `--latent-batch`, an image run the first `--n-img-bf16` test images in
batches of at most 32 (`--n-img-bf16-slow` for GridConvLNP and the XL,
whose XLA CPU convolutions are slow); `--banded` gives the conv-family GP
models the banded-matmul depthwise lowering (`cnn_banded`: the same
parameters and linear map; XLA's CPU depthwise convolutions are slow).
Each run's entry gains `bf16_gap`: the count, the seconds, `banded`, the
float32 mean LL and, for `fused` and `dense`, the bf16 mean LL, the mean
and standard deviation of the per-function (per-image) bf16-minus-float32
log-likelihood differences (`d_mean_ll`, `d_ll_std`).

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


def gp_f32(run_dir, n, chunk):
    """A GP run's float32 scores over at least `n` functions, whole batches
    of 256 split evenly over its components (module docstring) -> its
    entry. The functions and context masks are the JAX package's eval
    draws; the forward is the port's on the CPU (z drawn from a CPU
    generator seeded by the batch): XLA's CPU depthwise convolutions take
    minutes a batch at 32 z draws, and on identical inputs the port is the
    JAX package to 0.08 nats a function (tests/test_torch_gp_runs.py,
    tests/jax_score_offsets.py)."""
    import torch

    from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler
    from npf_gwwaveform_tpu_torch import score_gp
    from npf_gwwaveform_tpu_torch.losses import npml_loss

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    comps = score_gp.ALL_KERNELS if summary["kernel"] == "All_Kernels" else (summary["kernel"],)
    model = score_gp.load_model(run_dir, "cpu")
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=50, is_indep_n=True),
                                 targets_getter=get_all_indcs)
    k_data, k_split = jax.random.split(jax.random.PRNGKey(123))
    lls = []
    for c, name in enumerate(comps):
        sampler = GPSampler(n_points=128, **KERNEL_CONFIGS[name])
        kd = k_data if c == 0 else jax.random.fold_in(k_data, c)
        ks = k_split if c == 0 else jax.random.fold_in(k_split, c)
        for i in range(-(-n // (256 * len(comps)))):
            x, y = sampler.sample(jax.random.fold_in(kd, i), 256)
            k_sp, _ = jax.random.split(jax.random.fold_in(ks, i))
            mask_c = splitter(k_sp, x, y)["mask_cntxt"]
            g = torch.Generator().manual_seed(1000 * c + i)
            x, y, mask_c = (torch.from_numpy(np.array(a)) for a in (x, y, mask_c))
            for j in range(0, 256, chunk):
                xs, ys, ms = x[j:j + chunk], y[j:j + chunk], mask_c[j:j + chunk]
                with torch.no_grad():
                    out = model(xs, ys, xs, ms, torch.ones_like(ms), y_trgt=ys, generator=g)
                    lls.append(-npml_loss(out, ys, torch.ones_like(ms), use_iw=False)
                               .double().numpy())
    ll = np.concatenate(lls)
    lo, hi = bands_of(ll, n_resample=ll.shape[0] // 2)["mean_ll"]
    return {"n": int(ll.shape[0]), "batch": chunk, "gp": True,
            "f32": {"mean_ll": float(ll.mean()), "std_ll": float(ll.std())},
            "f32_bands": {"mean_ll": [lo, hi]}}


def img_f32(run_dir):
    """An image run's float32 scores over its whole test set (module
    docstring) -> its entry."""
    import torch

    from experiments.reproduce_img import POINT_MODELS
    from npf_gwwaveform_tpu.data import get_train_test_img_dataset
    from npf_gwwaveform_tpu.data.datasplit import (
        GridCntxtTrgtSplitter, PointsFromGridSplitter, RandomMasker, no_masker,
    )
    from npf_gwwaveform_tpu_torch import score_img
    from npf_gwwaveform_tpu_torch.losses import npml_loss

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = score_img.load_model(run_dir, "cpu")
    _, test = get_train_test_img_dataset(summary["dataset"])
    masker = RandomMasker(a=0.0, b=0.3, is_indep_n=True)
    splitter = (PointsFromGridSplitter(context_masker=masker,
                                       upscale_factor=getattr(test, "test_upscale_factor", 1.0))
                if summary["model"] in POINT_MODELS else
                GridCntxtTrgtSplitter(context_masker=masker, target_masker=no_masker))
    imgs, lls = test.images, []
    for i in range(imgs.shape[0] // 32):
        k_split, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), i))
        y = imgs[i * 32:(i + 1) * 32]
        b = {k: torch.from_numpy(np.array(v)) for k, v in splitter(k_split, y, y).items()}
        with torch.no_grad():
            out = model(b["X_cntxt"], b["Y_cntxt"], b["X_trgt"], b["mask_cntxt"], b["mask_trgt"],
                        y_trgt=b["Y_trgt"], generator=torch.Generator().manual_seed(i))
            lls.append(-npml_loss(out, b["Y_trgt"], b["mask_trgt"], use_iw=False)
                       .double().numpy())
    ll = np.concatenate(lls)
    lo, hi = bands_of(ll, n_resample=ll.shape[0] // 2)["mean_ll"]
    return {"n": int(ll.shape[0]), "batch": 32, "img": True,
            "f32": {"mean_ll": float(ll.mean()), "std_ll": float(ll.std())},
            "f32_bands": {"mean_ll": [lo, hi]}}


def jax_gp_model(summary, dtype=None, banded=False):
    """A GP run's JAX model in compute `dtype`, as `reproduce_gp.py` builds
    it (an ablation variant, SUMO's NPML variant or `gp_model_1d`), with the
    banded depthwise lowering on the conv family's grid CNNs."""
    from npf_gwwaveform_tpu.configs import gp_model_variant
    from npf_gwwaveform_tpu_torch.configs import parse_variant

    name, eps = summary["model"], summary.get("norm_eps", 1e-3)
    if "_ELBO" in name:
        base, flags = parse_variant(name)
        model = gp_model_variant(base, flags["ELBO"], flags["LatLB"], flags["SigLB"], dtype=dtype,
                                 cnn_norm_eps=eps,
                                 headline_arch=summary.get("ablation_arch") == "headline")
    elif name.endswith("_SUMO"):
        base = name[: -len("_SUMO")]
        model = gp_model_variant(base, False, True, True, dtype=dtype, cnn_norm_eps=eps)
    else:
        base = name
        model = gp_model_1d(name, dtype=dtype, cnn_norm_eps=eps)
    if banded and base.startswith("Conv"):
        model = model.clone(CNNFactory=gp_model_1d(base, dtype=dtype, cnn_norm_eps=eps,
                                                   cnn_banded=True).CNNFactory)
    return model


def _three_ways(models, variables, batches):
    """Per-function log-likelihoods (NPML without importance weights) of
    the (float32, bf16 fused, bf16 Dense) models on `batches` of (x_c, y_c,
    x_t, y_t, mask_c, mask_t, latent key) -> three float64 arrays."""
    from npf_gwwaveform_tpu.losses import npml_loss

    lls = []
    for model in models:
        @jax.jit
        def ll(v, xc, yc, xt, yt, mc, mt, key, model=model):
            out = model.apply(v, xc, yc, xt, yt, mask_cntxt=mc, mask_trgt=mt, train=False,
                              rngs={"latent": key})
            return -npml_loss(out, yt, mt, use_iw=False)
        lls.append(np.concatenate([np.asarray(ll(variables, *b), np.float64) for b in batches]))
    return lls


def _gap_entry(lls, batch, seconds, **extra):
    ll32, fused, dense = lls
    entry = {"n": int(ll32.shape[0]), "batch": batch, "seconds": seconds, **extra,
             "f32": {"mean_ll": float(ll32.mean())}}
    for name, ll in (("fused", fused), ("dense", dense)):
        d = ll - ll32
        entry[name] = {"mean_ll": float(ll.mean()), "d_mean_ll": float(d.mean()),
                       "d_ll_std": float(d.std())}
    return entry


def gp_bf16(run_dir, n, chunk, banded):
    """A GP bar run's JAX bf16-float32 gaps on JAX's eval draws, the first
    `n` functions of each kernel (module docstring) -> its `bf16_gap`."""
    import time

    from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler
    from npf_gwwaveform_tpu_torch import score_gp

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    comps = score_gp.ALL_KERNELS if summary["kernel"] == "All_Kernels" else (summary["kernel"],)
    variables = {"params": _restore(os.path.join(run_dir, "params.msgpack"))}
    extra = os.path.join(run_dir, "extra_vars.msgpack")
    if os.path.exists(extra):
        variables.update(_restore(extra))
    models = (jax_gp_model(summary, None, banded),
              jax_gp_model(summary, jnp.bfloat16, banded).clone(fused_mlp=True),
              jax_gp_model(summary, jnp.bfloat16, banded))
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=50, is_indep_n=True),
                                 targets_getter=get_all_indcs)
    k_data, k_split = jax.random.split(jax.random.PRNGKey(123))
    batches = []
    for c, name in enumerate(comps):
        sampler = GPSampler(n_points=128, **KERNEL_CONFIGS[name])
        kd = k_data if c == 0 else jax.random.fold_in(k_data, c)
        ks = k_split if c == 0 else jax.random.fold_in(k_split, c)
        for i in range(-(-n // 256)):
            x, y = sampler.sample(jax.random.fold_in(kd, i), 256)
            k_sp, k_z = jax.random.split(jax.random.fold_in(ks, i))
            mask_c = splitter(k_sp, x, y)["mask_cntxt"]
            mask_t = jnp.ones(mask_c.shape, bool)
            for j in range(0, min(256, n - 256 * i), chunk):
                s = slice(j, min(j + chunk, n - 256 * i))
                batches.append((x[s], y[s], x[s], y[s], mask_c[s], mask_t[s],
                                jax.random.fold_in(k_z, j)))
    t0 = time.perf_counter()
    lls = _three_ways(models, variables, batches)
    return _gap_entry(lls, chunk, time.perf_counter() - t0, banded=bool(banded))


def img_bf16(run_dir, n):
    """An image bar run's JAX bf16-float32 gaps on JAX's eval draws, its
    first `n` test images (module docstring) -> its `bf16_gap`."""
    import time

    from experiments.reproduce_img import POINT_MODELS, build_model
    from npf_gwwaveform_tpu.data import get_train_test_img_dataset
    from npf_gwwaveform_tpu.data.datasplit import (
        GridCntxtTrgtSplitter, PointsFromGridSplitter, RandomMasker, no_masker,
    )

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    variables = {"params": _restore(os.path.join(run_dir, "params.msgpack")),
                 **_restore(os.path.join(run_dir, "extra_vars.msgpack"))}
    kw = dict(y_dim=summary.get("y_dim", 1),
              **(dict(padding="CIRCULAR", norm_eps=1e-2) if summary["dataset"] == "zsmms"
                 else {}))
    models = (build_model(summary["model"], **kw),
              build_model(summary["model"], dtype=jnp.bfloat16, **kw).clone(fused_mlp=True),
              build_model(summary["model"], dtype=jnp.bfloat16, **kw))
    _, test = get_train_test_img_dataset(summary["dataset"])
    masker = RandomMasker(a=0.0, b=0.3, is_indep_n=True)
    splitter = (PointsFromGridSplitter(context_masker=masker,
                                       upscale_factor=getattr(test, "test_upscale_factor", 1.0))
                if summary["model"] in POINT_MODELS else
                GridCntxtTrgtSplitter(context_masker=masker, target_masker=no_masker))
    batches = []
    for i in range(-(-n // 32)):
        k_split, k_latent = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), i))
        y = test.images[i * 32:(i + 1) * 32]
        b = splitter(k_split, y, y)
        m = min(32, n - 32 * i)
        batches.append(tuple(b[k][:m] for k in ("X_cntxt", "Y_cntxt", "X_trgt", "Y_trgt",
                                                 "mask_cntxt", "mask_trgt")) + (k_latent,))
    t0 = time.perf_counter()
    lls = _three_ways(models, variables, batches)
    return _gap_entry(lls, min(32, n), time.perf_counter() - t0)


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
    ap.add_argument("--gp", action="store_true", help="every conv-family GP run, float32")
    ap.add_argument("--gp-set", action="store_true",
                    help="every set and attention GP run, float32")
    ap.add_argument("--n-gp-set", type=int, default=9984,
                    help="functions a set or attention GP run")
    ap.add_argument("--img", action="store_true", help="every scorable image run, float32")
    ap.add_argument("--gp-bf16", action="store_true",
                    help="JAX's bf16 gaps of the GP bar runs (fused and Dense decoder)")
    ap.add_argument("--img-bf16", action="store_true",
                    help="JAX's bf16 gaps of the image bar runs (fused and Dense decoder)")
    ap.add_argument("--n-gp-bf16", type=int, default=256, help="functions a kernel")
    ap.add_argument("--n-img-bf16", type=int, default=64, help="test images")
    ap.add_argument("--n-img-bf16-slow", type=int, default=16,
                    help="test images of GridConvLNP and GridConvCNPXL")
    ap.add_argument("--banded", action="store_true",
                    help="with --gp-bf16, the conv family's depthwise convs as banded matmuls")
    ap.add_argument("--shard", default=None, help="i/k: every k-th GP run from the i-th")
    ap.add_argument("--n-gp-cnp", type=int, default=9984,
                    help="functions a GP ConvCNP run (cheap on the CPU); a GP ConvLNP run "
                         "takes --n")
    args = ap.parse_args()
    if args.gp_bf16 or args.img_bf16:
        bf16_gaps(args)
        return
    if args.gp or args.gp_set or args.img:
        from npf_gwwaveform_tpu_torch.run_report import gp_runs, gp_set_runs, img_runs

        args.runs = (img_runs(RESULTS, scored=True) if args.img else
                     gp_set_runs(RESULTS) if args.gp_set else gp_runs(RESULTS))
        if args.shard:
            i, k = (int(v) for v in args.shard.split("/"))
            args.runs = args.runs[i::k]
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
        if "dataset" in summary:  # an image run: float32 only
            out[name] = img_f32(run_dir)
            print(f"{name}: n {out[name]['n']}, f32 mean LL {out[name]['f32']['mean_ll']:.3f}, "
                  f"band {out[name]['f32_bands']['mean_ll']}", flush=True)
            with open(args.out, "w") as f:
                json.dump(dict(sorted(out.items())), f, indent=1)
            continue
        if "kernel" in summary:  # a GP run: float32 only
            family = summary["model"].split("_")[0]
            n = (args.n_gp_cnp if family == "ConvCNP" else args.n if family == "ConvLNP"
                 else args.n_gp_set)
            out[name] = gp_f32(run_dir, n, args.latent_batch)
            print(f"{name}: n {out[name]['n']}, f32 mean LL {out[name]['f32']['mean_ll']:.3f}, "
                  f"band {out[name]['f32_bands']['mean_ll']}", flush=True)
            with open(args.out, "w") as f:
                json.dump(dict(sorted(out.items())), f, indent=1)
            continue
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


def bf16_gaps(args) -> None:
    """`--gp-bf16` / `--img-bf16`: each bar run's `bf16_gap` into its entry
    of `--out`, after every run."""
    from npf_gwwaveform_tpu_torch.run_report import gp_bf16_bar_runs, img_bf16_bar_runs

    runs = args.runs or (gp_bf16_bar_runs(RESULTS) if args.gp_bf16 else
                         img_bf16_bar_runs(RESULTS))
    if args.shard:
        i, k = (int(v) for v in args.shard.split("/"))
        runs = runs[i::k]
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for run_dir in runs:
        name = os.path.relpath(os.path.abspath(run_dir), RESULTS)
        if args.gp_bf16:
            gap_ = gp_bf16(run_dir, args.n_gp_bf16, args.latent_batch, args.banded)
        else:
            slow = any(m in name for m in ("GridConvLNP", "GridConvCNPXL"))
            gap_ = img_bf16(run_dir, args.n_img_bf16_slow if slow else args.n_img_bf16)
        out.setdefault(name, {})["bf16_gap"] = gap_
        print(f"{name}: n {gap_['n']}, f32 {gap_['f32']['mean_ll']:.3f}, fused gap "
              f"{gap_['fused']['d_mean_ll']:+.4f} (sd {gap_['fused']['d_ll_std']:.3f}), Dense gap "
              f"{gap_['dense']['d_mean_ll']:+.4f} (sd {gap_['dense']['d_ll_std']:.3f}), "
              f"{gap_['seconds']:.0f} s", flush=True)
        with open(args.out, "w") as f:
            json.dump(dict(sorted(out.items())), f, indent=1)


if __name__ == "__main__":
    main()
