"""The JAX package's own gap between bfloat16 and float32 scoring of the
flagship run, for setting the port's bf16 scoring bar. Not a test: run it by
hand on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_bf16_score_gap.py [--n 2048] [--out gap.json]

Scores the first `--n` thetas recorded in
`results/GW_time_cond_film_ctx192_d128/ConvCNP/run_1` (batches of 256, the
run's generator at 1024 Hz, every 4th sample, the eval split's U{0..192}
context counts drawn from one key per batch) with the run's parameters three
ways on the same inputs: float32 (`gw_model_from_summary`), bfloat16 with the
fused MLP-chain decoder (`fused_mlp=True`, the Pallas kernel in interpret
mode: the model the port's kernel path matches) and bfloat16 with the Dense
decoder (what `reproduce_gw.py --bf16` builds). Prints one JSON line: each
way's mean log-likelihood and median mismatch, and for each bf16 way its
gap to float32: the difference of the means and of the medians, the mean,
standard deviation and largest |difference| of the per-waveform
log-likelihoods, and the largest |difference| of the predictive mean.

XLA's excess precision is turned off (`--xla_allow_excess_precision=false`)
so that every bf16 op under jit rounds its result, as the ops read and as
the port computes (tests/test_torch_bf16_slice.py).
"""

import argparse
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_allow_excess_precision=false").strip()

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from npf_gwwaveform_tpu.configs import gp_model_1d, gw_model_from_summary  # noqa: E402
from npf_gwwaveform_tpu.data import (  # noqa: E402
    CntxtTrgtSplitter, GetRandomIndcs, GWParameterSpace, GWWaveformGenerator, get_all_indcs,
)
from npf_gwwaveform_tpu.data.gw import mismatch  # noqa: E402
from npf_gwwaveform_tpu.losses import CNPFLoss  # noqa: E402

RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")


def _restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    variables = {"params": _restore(os.path.join(RUN_DIR, "params.msgpack")),
                 **_restore(os.path.join(RUN_DIR, "extra_vars.msgpack"))}
    bf16 = gp_model_1d("ConvCNP", dtype=jnp.bfloat16, cnn_kernel_size=19).clone(
        y_dim=1, cond_dim=4, cond_mode="film", density_induced=summary["density_induced"])
    models = {"f32": gw_model_from_summary(summary), "bf16_fused": bf16.clone(fused_mlp=True),
              "bf16_dense": bf16}
    thetas = np.loadtxt(os.path.join(RUN_DIR, "mismatch_theta.csv"), delimiter=",",
                        ndmin=2)[:args.n, 1:5].astype(np.float32)
    gen, space = GWWaveformGenerator(duration=1.0, sample_rate=1024.0), GWParameterSpace()
    splitter = CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=0.0, b=summary["n_context"], is_indep_n=True),
        targets_getter=get_all_indcs)
    n_points = 256
    stride = gen.n_time // n_points

    def scorer(model):
        @jax.jit
        def score(theta, key):
            _, h = gen.time_domain(theta)
            y = h[..., -n_points * stride::stride][..., :n_points, None]
            x = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, n_points)[None, :, None], y.shape)
            batch = splitter(key, x, y, condition=space.normalize(theta))
            out = model.apply(variables, batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                              mask_cntxt=batch["mask_cntxt"], mask_trgt=batch["mask_trgt"],
                              condition=batch["condition"], train=False)
            ll = -CNPFLoss(reduction=None)(out, batch["Y_trgt"], batch["mask_trgt"], train=False)
            loc = out.p_yCc.loc[0, ..., 0]
            return ll, mismatch(loc, y[..., 0]), loc
        return score

    res = {}
    for name, model in models.items():
        score = scorer(model)
        parts = [score(jnp.asarray(thetas[i:i + 256]), jax.random.fold_in(jax.random.PRNGKey(0), i))
                 for i in range(0, len(thetas), 256)]
        res[name] = [np.concatenate([np.asarray(p[k], np.float32) for p in parts])
                     for k in range(3)]
        print(f"{name}: mean LL {res[name][0].mean():.4f}, median mismatch "
              f"{np.median(res[name][1]):.6f}", flush=True)
    ll32, mm32, loc32 = res["f32"]
    out = {"n": int(len(thetas)), "f32": {"mean_ll": float(ll32.mean()),
                                         "median_mismatch": float(np.median(mm32))}}
    for name in ("bf16_fused", "bf16_dense"):
        ll, mm, loc = res[name]
        d = ll - ll32
        out[name] = {"mean_ll": float(ll.mean()), "median_mismatch": float(np.median(mm)),
                     "d_mean_ll": float(ll.mean() - ll32.mean()),
                     "d_median_mismatch": float(np.median(mm) - np.median(mm32)),
                     "d_ll_mean": float(d.mean()), "d_ll_std": float(d.std()),
                     "d_ll_max_abs": float(np.abs(d).max()),
                     "d_loc_max_abs": float(np.abs(loc - loc32).max())}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
