"""Where a rescoring's offset from a run's recorded scores comes from. Not a
test: run it by hand on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_score_offsets.py --run RUN_DIR [--n 256]
        [--chunk 16] [--seeds 0,1,2,3] [--out offsets.json]

`reproduce_gw.py` scores every run on one set of eval draws: batch i of 256
takes its thetas and context masks from `fold_in(PRNGKey(123), i)`, whatever
the run. This script draws that set again for the first `--n` recorded
waveforms (and checks the thetas it draws against the recorded ones), makes
their waveforms with the JAX generator (time-domain, or for a `freq_ap` run
amplitude and standardised phase, scored with the PSD-weighted
frequency-domain mismatch of h(f) rebuilt with each waveform's phase std,
as `reproduce_gw.py` does), and scores the run in float32 on the
CPU with the JAX package (`use_pallas_setconv=False`, the same function as
the Pallas SetConv) and with the port, on the same waveforms, under two
kinds of draws:

- `jax`: the record's own context masks;
- `port_<seed>`: the port's eval splitter from a CPU generator seeded with
  each of `--seeds`, 256 waveforms a draw as `score_run` draws them (the
  port's draws on the card come from CUDA's Philox stream instead: the same
  law, other masks).

Prints one JSON line: the record's mean LL and median/p90/p99 mismatch over
the same waveforms; each (model, draws) pair's; and per waveform, the JAX
package on the record's draws against the record (what the recording
device's arithmetic adds) and the port against the JAX package on the same
draws (what the port adds).

A ConvLNP run (NPML at 32 z draws, the ELBO run from q(z|C,T)) is scored on
the record's own z draws too: the latent key of each batch of 256
(`reproduce_gw.py`'s third split of the batch key) gives JAX's draws for the
whole batch (the latent path alone, `latent_draws`), their standard-normal
noise is recovered as (z - loc) / scale in float64, and both packages then
score the chunks on that noise (JAX through its `NormalDiag.sample`
replaced, in this process only, by one that returns loc + scale * eps; the
port through `eps=`). On the port's own draws the port draws its z from the
same CPU generator after the split, as `score_run` does, and JAX takes the
record's noise. Such a run also reports the per-draw mismatch
(`mismatch_zdraw`, the mean over the draws of each draw's mismatch) beside
the record's `mismatch_zdraw_median`, so that the z noise and the port are
told apart.
"""

import argparse
import json
import os
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import npf_gwwaveform_tpu.distributions as jax_distributions  # noqa: E402
from npf_gwwaveform_tpu.configs import gw_model_from_summary  # noqa: E402
from npf_gwwaveform_tpu.data import (  # noqa: E402
    CntxtTrgtSplitter, GetRandomIndcs, GWParameterSpace, GWWaveformGenerator, get_all_indcs,
)
from npf_gwwaveform_tpu.data.gw import mismatch as jax_mismatch  # noqa: E402
from npf_gwwaveform_tpu.data.gw import mismatch_fd as jax_mismatch_fd  # noqa: E402
from npf_gwwaveform_tpu.data.gw import psd_aligo as jax_psd_aligo  # noqa: E402
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss  # noqa: E402
from npf_gwwaveform_tpu_torch.data.gw import (  # noqa: E402
    mismatch, mismatch_fd, polar_conj, psd_aligo,
)
from npf_gwwaveform_tpu_torch.losses import CNPFLoss  # noqa: E402
from npf_gwwaveform_tpu_torch.run_report import recorded_scores  # noqa: E402
from npf_gwwaveform_tpu_torch.score import eval_splitter, load_model, read_run_thetas  # noqa: E402

EVAL_BATCH = 256


def _restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


def _stats(ll, mm, mz=None):
    out = {"mean_ll": float(ll.mean()), "median_mismatch": float(np.median(mm)),
           "p90_mismatch": float(np.percentile(mm, 90)),
           "p99_mismatch": float(np.percentile(mm, 99))}
    if mz is not None:
        out["mismatch_zdraw_median"] = float(np.median(mz))
    return out


# the noise JAX's NormalDiag.sample returns while it is replaced (a latent run)
_EPS = []


def _sample_given_eps(self, key, sample_shape=()):
    return self.loc + self.scale * _EPS[0]


def latent_draws(jm, variables, x, y, mask_c, cond, key, conditioned):
    """JAX's z draws of one batch from the latent key, as its eval forward
    makes them (the latent path alone) -> the float64 noise [n_z, B, n_lat,
    z_dim] that gives them: (z - loc) / scale of the distribution sampled."""
    def lat(module, x, y, mask_c, cond):
        x_e = module.x_encoder(x)
        emb = module.cond_encoder(cond) if conditioned else None
        R = module.encode_globally(x_e, y, mask_c, train=False, cond_emb=emb)
        if emb is not None and module.cond_mode == "add":
            R = R + emb[:, None, :]
        mask_t = jnp.ones(mask_c.shape, bool)
        return module.latent_path(x_e, R, x_e, y, mask_c, mask_t, False, cond_emb=emb)

    z, q_c, q_ct = jax.jit(lambda *a: jm.apply(variables, *a, method=lat,
                                               rngs={"latent": key}))(x, y, mask_c, cond)
    q = q_c if q_ct is None else q_ct
    return (np.asarray(z, np.float64) - np.asarray(q.loc, np.float64)) / np.asarray(
        q.scale, np.float64)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, metavar="RUN_DIR")
    ap.add_argument("--n", type=int, default=256, help="a multiple of 256")
    ap.add_argument("--chunk", type=int, default=16, help="waveforms a forward pass")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.set_num_threads(4)
    with open(os.path.join(args.run, "summary.json")) as f:
        summary = json.load(f)
    n_points, n_context = summary.get("n_points", 256), summary["n_context"]
    gen = GWWaveformGenerator(duration=summary.get("duration", 1.0), sample_rate=1024.0)
    space = GWParameterSpace()
    stride = gen.n_time // n_points
    splitter = CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=0.0, b=n_context, is_indep_n=True),
        targets_getter=get_all_indcs)

    freq = summary.get("mode", "time") == "freq_ap"
    # the record's eval draws, batch by batch, as reproduce_gw.py's eval_batch
    ys, conds, masks, sigmas, latent_keys = [], [], {"jax": []}, [], []
    for i in range(args.n // EVAL_BATCH):
        kd, ks, kl = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), i), 3)
        latent_keys.append(kl)
        theta = space.sample(kd, EVAL_BATCH)
        if freq:
            fd = gen.frequency_domain(theta, n_f=n_points)
            sigma = jnp.std(fd.phase, -1, keepdims=True)
            psi = (fd.phase - jnp.mean(fd.phase, -1, keepdims=True)) / (sigma + 1e-8)
            y = jnp.stack([fd.amplitude, psi], axis=-1)
            sigmas.append(np.asarray(sigma))
        else:
            _, h = gen.time_domain(theta)
            y = h[..., -n_points * stride::stride][..., :n_points, None]
        x = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, n_points)[None, :, None],
                             y.shape[:2] + (1,))
        batch = splitter(ks, x, y, condition=space.normalize(theta))
        ys.append(np.asarray(y))
        conds.append(np.asarray(batch["condition"]))
        masks["jax"].append(np.asarray(batch["mask_cntxt"]))
        assert np.all(np.asarray(batch["mask_trgt"]))
        np.testing.assert_allclose(np.asarray(theta),
                                   read_run_thetas(args.run)[i * EVAL_BATCH:(i + 1) * EVAL_BATCH],
                                   rtol=1e-5, atol=1e-5)
    y, cond = np.concatenate(ys), np.concatenate(conds)
    sigma = np.concatenate(sigmas) if freq else np.zeros((args.n, 1), np.float32)
    masks["jax"] = np.concatenate(masks["jax"])
    x = np.broadcast_to(np.asarray(jnp.linspace(-1.0, 1.0, n_points))[None, :, None],
                        y.shape[:2] + (1,)).copy()
    # the port's draws, 256 waveforms a draw from one generator, as score_run
    split = eval_splitter(n_context)
    for seed in (int(s) for s in args.seeds.split(",")):
        g = torch.Generator().manual_seed(seed)
        masks[f"port_{seed}"] = np.concatenate([
            split(g, torch.from_numpy(x[i:i + EVAL_BATCH]), torch.from_numpy(y[i:i + EVAL_BATCH]))
            ["mask_cntxt"].numpy() for i in range(0, args.n, EVAL_BATCH)])

    jm = gw_model_from_summary(summary).clone(use_pallas_setconv=False)
    variables = {"params": _restore(os.path.join(args.run, "params.msgpack")),
                 **_restore(os.path.join(args.run, "extra_vars.msgpack"))}

    conditioned = bool(summary.get("conditioned"))
    psd = jax_psd_aligo(gen.freqs(n_points))
    latent = summary["model"] == "ConvLNP"
    # the record's z noise, one batch of 256 at a time: [n_z, n, n_lat, z_dim]
    eps = np.concatenate([
        latent_draws(jm, variables, *(jnp.asarray(a[i * EVAL_BATCH:(i + 1) * EVAL_BATCH])
                                      for a in (x, y, masks["jax"], cond)), kl, conditioned)
        for i, kl in enumerate(latent_keys)], axis=1) if latent else None
    if latent:
        jax_distributions.NormalDiag.sample = _sample_given_eps

    def jax_mm(loc, y, sigma):
        if not freq:
            return jax_mismatch(loc[..., 0], y[..., 0])
        def recon(ap):
            return ap[..., 0] * jnp.exp(-1j * ap[..., 1] * sigma)
        return jax_mismatch_fd(recon(loc), recon(y), psd=psd)

    @jax.jit
    def jax_forward(x, y, mask_c, cond, sigma, eps):
        _EPS[:] = [eps]
        mask_t = jnp.ones(mask_c.shape, bool)
        out = jm.apply(variables, x, y, x, y, mask_cntxt=mask_c, mask_trgt=mask_t, train=False,
                       rngs={"latent": jax.random.PRNGKey(0)},
                       **({"condition": cond} if conditioned else {}))
        ll = -JaxCNPFLoss(reduction=None)(out, y, mask_t, train=False)
        loc = out.p_yCc.loc
        mz = jnp.mean(jax.vmap(lambda l: jax_mm(l, y, sigma))(loc), axis=0)
        return ll, jax_mm(jnp.mean(loc, axis=0), y, sigma), mz

    def jax_score(x, y, mask_c, cond, sigma, eps, g):
        # JAX takes the record's noise (eps); the port's generator g is unused
        return jax_forward(x, y, mask_c, cond, sigma, jnp.asarray(eps, jnp.float32)
                           if eps is not None else None)

    tm = load_model(args.run, "cpu")
    psd_t = torch.from_numpy(np.array(psd))

    def port_mm(loc, y, sigma):
        if not freq:
            return mismatch(loc[..., 0], y[..., 0])

        def recon(ap):
            return polar_conj(ap[..., 0], ap[..., 1] * sigma)
        return mismatch_fd(recon(loc), recon(y), psd=psd_t)

    def port_score(x, y, mask_c, cond, sigma, eps, g):
        x, y, mask_c, cond, sigma = (torch.from_numpy(np.ascontiguousarray(a))
                                     for a in (x, y, mask_c, cond, sigma))
        mask_t = torch.ones_like(mask_c)
        with torch.no_grad():
            out = tm(x, y, x, mask_c, mask_t, cond if conditioned else None, y_trgt=y,
                     generator=g, eps=None if eps is None else torch.from_numpy(eps).float())
            ll = -CNPFLoss(reduction=None)(out, y, mask_t, train=False)
            loc = out.p_yCc.loc
            mz = torch.stack([port_mm(l, y, sigma) for l in loc]).mean(dim=0)
            return ll, port_mm(loc.mean(dim=0), y, sigma), mz

    scores = {}
    first_seed = int(args.seeds.split(",")[0])
    for model, score in (("jax", jax_score), ("port", port_score)):
        for draws, mask in masks.items():
            if model == "port" and draws not in ("jax", f"port_{first_seed}"):
                continue
            # the port on its own draws draws its own z (after the split, as score_run)
            own_z = model == "port" and draws != "jax"
            g = torch.Generator().manual_seed(first_seed + 1000) if own_z else None
            parts = [score(x[i:i + args.chunk], y[i:i + args.chunk], mask[i:i + args.chunk],
                           cond[i:i + args.chunk], sigma[i:i + args.chunk],
                           None if eps is None or own_z else eps[:, i:i + args.chunk], g)
                     for i in range(0, args.n, args.chunk)]
            scores[model, draws] = [np.concatenate([np.asarray(p[k], np.float64) for p in parts])
                                    for k in range(3)]
            print(f"{model} on {draws}'s draws: {_stats(*scores[model, draws])}", flush=True)

    rec_ll, rec_mm = (a[:args.n].astype(np.float64) for a in recorded_scores(args.run))
    d_rec = scores["jax", "jax"][0] - rec_ll
    record = _stats(rec_ll, rec_mm)
    if latent:  # over all the record's waveforms: it keeps no per-waveform values
        record["mismatch_zdraw_median (all)"] = summary["mismatch_zdraw_median"]
    out = {"run": args.run, "n": args.n, "record": record,
           "scores": {f"{m}@{d}": _stats(*v) for (m, d), v in scores.items()},
           "jax_vs_record": {"d_ll_mean": float(d_rec.mean()),
                             "d_ll_max_abs": float(np.abs(d_rec).max()),
                             "d_mismatch_max_abs": float(
                                 np.abs(scores["jax", "jax"][1] - rec_mm).max())},
           "port_vs_jax": {}}
    for draws in {d for m, d in scores if m == "port"}:
        out["port_vs_jax"][draws] = {
            "d_ll_max_abs": float(np.abs(scores["port", draws][0] - scores["jax", draws][0]).max()),
            "d_mismatch_max_abs": float(
                np.abs(scores["port", draws][1] - scores["jax", draws][1]).max()),
            "d_mismatch_zdraw_max_abs": float(
                np.abs(scores["port", draws][2] - scores["jax", draws][2]).max())}
    n_ctx = {d: m.sum(axis=1) for d, m in masks.items()}
    out["mean_context"] = {d: float(c.mean()) for d, c in n_ctx.items()}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
