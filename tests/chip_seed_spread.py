#!/usr/bin/env python3
"""On one NVIDIA H100: how two of `chip_smoke.py`'s training checks depend
on the initial draw, for the bars they are held to.

    python3 tests/chip_seed_spread.py [--out chiprun_out/seed_spread.json]

The k=37 ConvCNP configuration
(`results/GW_time_cond_film_ctx64_d128_k37/ConvCNP/run_0`, phase 14)
trained in bf16 from seeds 0, 1 and 2 for 300 and for 500 graphed
steps, as phase 14 trains it. On each trained model and each of two batches (generator
seeds 4, phase 14's, and 5), every parameter's gradient gap
(`chip_smoke._step_grad_errs`: max |a - b| / max |b|) between
  - `check`: the bf16 kernel path and the bf16 plain-kernel path (phase
    14's bf16 step check, bar `BF16_STEP_GRAD_RTOL`);
  - `f32`: the float32 kernel path and the float32 plain path (the same
    check in float32, bar `STEP_GRAD_RTOL`);
  - `bf16`: the bf16 plain-kernel path and the float32 plain path (what
    bf16 compute moves);
  - `k1_ulp`: the bf16 plain-kernel path and itself with K1's float32
    outputs each multiplied by 1 + 2^-24 n, n standard normal (half an ulp,
    as a sum in another order rounds them), the largest over
    `ROUNDING_DRAWS` draws.
Then phase 28's eight image training paths (`IMG_TRAIN`) from the same
seeds, the first and last value of each of `IMG_JAX`'s statistics.

Prints one JSON line a trained model and writes them all to `--out`.
The repo's root must be the parent of this file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from npf_gwwaveform_tpu_torch import _build, train_gw, train_img  # noqa: E402
from npf_gwwaveform_tpu_torch.configs import train_config  # noqa: E402
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace  # noqa: E402
from npf_gwwaveform_tpu_torch.data.images import get_train_test_img_dataset  # noqa: E402
from npf_gwwaveform_tpu_torch.ops.kernels import setconv  # noqa: E402
from npf_gwwaveform_tpu_torch.score import make_eval_batch, run_generator  # noqa: E402
from npf_gwwaveform_tpu_torch.utils.helpers import set_numerics  # noqa: E402

SEEDS, K37_DEPTHS, K37_BATCH_SEEDS = (0, 1, 2), (300, 500), (4, 5)
IMG_KINDS = ("median50", "median101", "mean100", "mean200")


def _grads(summary, state, batch, dtype, use_kernels, plain=False):
    """(loss, {parameter: gradient}) of one step from `state` on `batch`."""
    trainer = train_gw.build_trainer(summary, 1, "cuda", use_kernels=use_kernels, dtype=dtype)
    trainer.model.load_state_dict(state)
    with cs.plain_kernels() if plain else contextlib.nullcontext():
        loss = trainer.loss_and_grads(batch)
    return loss.item(), {n: p.grad.clone() for n, p in trainer.model.named_parameters()}


def _k1_rounded(summary, state, batch, draws):
    """The bf16 plain-kernel path's gradients with K1's outputs rounded
    apart by half an ulp, once a draw."""
    noise = torch.Generator(device="cuda").manual_seed(0)

    def rounded(*args):
        return tuple(t * (1.0 + 2.0 ** -24 * torch.randn(t.shape, generator=noise,
                                                         device=t.device))
                     for t in setconv.setconv_exprbf_plain(*args))

    out = []
    with cs.plain_kernels():
        setconv.setconv_exprbf_fwd = rounded  # plain_kernels restores the wrapper
        for _ in range(draws):
            out.append(_grads(summary, state, batch, cs.BF16, True)[1])
    return out


def _gaps(a, b) -> dict:
    errs, zero = cs._step_grad_errs(a, b)
    return {**errs, **{f"{n} (cancelled)": v for n, v in zero.items()}}


def k37() -> list:
    run_dir = next(r for n, r, _, _ in cs.FAMILY_RUNS if n == "k37")
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = train_config(json.load(f))
    space, wave = GWParameterSpace(), run_generator(summary)
    rows = []
    for steps in K37_DEPTHS:
        for seed in SEEDS:
            trainer = train_gw.build_trainer(summary, steps, "cuda", seed=seed, dtype=cs.BF16)
            _, losses, _, _ = train_gw.train(trainer, summary, steps, cs.TRAIN_BATCH)
            losses = losses.cpu().numpy()
            state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            splitter = trainer.splitter
            del trainer
            cs.release()
            row = dict(part="k37", steps=steps, seed=seed,
                       early=float(np.median(losses[:50])), late=float(np.median(losses[-50:])),
                       batches={})
            for bs in K37_BATCH_SEEDS:
                gen = torch.Generator(device="cuda").manual_seed(bs)
                theta = space.sample(cs.TRAIN_BATCH, gen)
                x, y, cond = make_eval_batch(theta, wave, space, summary.get("n_points", 256),
                                             summary.get("mode", "time"))
                batch = splitter(gen, x, y, condition=cond if summary["conditioned"] else None)
                lk, gk = _grads(summary, state, batch, cs.BF16, True)
                lp, gp = _grads(summary, state, batch, cs.BF16, True, plain=True)
                lfk, gfk = _grads(summary, state, batch, None, True)
                lfp, gfp = _grads(summary, state, batch, None, False)
                ulp = [_gaps(d, gp) for d in _k1_rounded(summary, state, batch,
                                                         cs.ROUNDING_DRAWS)]
                gaps = dict(check=_gaps(gk, gp), f32=_gaps(gfk, gfp), bf16=_gaps(gp, gfp),
                            k1_ulp={n: max(u[n] for u in ulp) for n in ulp[0]})
                row["batches"][bs] = dict(
                    loss=dict(bf16_kernel=lk, bf16_plain=lp, f32_kernel=lfk, f32_plain=lfp),
                    gaps=gaps, worst={k: max(g.items(), key=lambda kv: kv[1])
                                      for k, g in gaps.items()})
                cs.release()
            print(json.dumps({k: v for k, v in row.items() if k != "batches"}
                             | {"worst": {bs: b["worst"] for bs, b in row["batches"].items()}}),
                  flush=True)
            rows.append(row)
    return rows


def img() -> list:
    rows = []
    for name, model, dataset, steps in cs.IMG_TRAIN:
        train_ds, _ = get_train_test_img_dataset(dataset)
        images = train_ds.images.cuda()
        sched = train_img.schedule(len(train_ds), 50, cs.TRAIN_BATCH, steps)
        for seed in SEEDS:
            trainer = train_img.build_trainer(model, dataset, images.shape[-1], 50,
                                              sched["steps_per_epoch"], "cuda", seed)
            _, losses, seconds = train_img.train(trainer, images, cs.TRAIN_BATCH, sched,
                                                 verbose=False)
            losses = losses.cpu().numpy()
            row = dict(part="img", name=name, seed=seed, steps=sched["steps"], seconds=seconds,
                       finite=bool(np.isfinite(losses).all()),
                       stats={k: cs._img_stat(k, losses) for k in IMG_KINDS},
                       means50=[float(v) for v in losses.reshape(-1, 50).mean(axis=1)])
            print(json.dumps(row), flush=True)
            rows.append(row)
            del trainer
            cs.release()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "seed_spread.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_seed_spread: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    set_numerics()
    torch.backends.cudnn.deterministic = True  # as chip_smoke.py runs
    _build.build()
    rows = k37() + img()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
