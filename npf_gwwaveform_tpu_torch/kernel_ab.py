"""Two builds of the SetConv forward (K1), MLP-chain forward (K2) and
MLP-chain backward (K3) kernels, timed in turns in one process on one card:
the sources in the package's `csrc/` against those of another directory with
the same C entry points (an earlier commit's `csrc/`, unpacked with `git show`
or `git archive`).

    python -m npf_gwwaveform_tpu_torch.kernel_ab --old-csrc DIR [--reps 20]
        [--out kernel_ab.json]

Both libraries are built with `nvcc -Xptxas -v`; each kernel's registers,
shared memory and spills are printed. At each shape of the flagship paths
(K1 context->grid and grid->targets at batch 32 and 256, with the paths'
masks; K2 and K3 at M = 8,192 and 65,536 with the flagship run's decoder
weights) and at K2's other cases in `chip_smoke.py` (`K2_CASES`), both
builds are driven through the port's own wrappers (`_build.using` routes
their launches to one build or the other), checked against the plain
PyTorch version, for identical bits over two launches and for identical
bits between the two builds, then timed over `--reps` launches in the order
old, new, new, old (`kernel_measure.time_ms`: each run of launches is
captured in a CUDA graph and replayed, so the host's launch overhead is not
counted). Bounds are `kernel_measure`'s, as in `chip_smoke.py`. The
bfloat16 kernels (K2-bf16, K3-bf16) are timed in the new build alone at the
decoder shapes (an earlier build may lack them), checked against their plain
versions (identical bits for K2-bf16's output and K3-bf16's dx) and for
identical bits over two launches. Prints one JSON line (also written to
`--out`) with each case's times, bound and errors, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import torch

from . import _build
from .kernel_measure import (
    K2_CASES, k1_bound, k1_inputs, k2_bound, k2_inputs, k3_bound, k3_inputs, time_ms,
)
from .ops.kernels.mlp_chain import (
    fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain, fused_relu_mlp_plain,
)
from .ops.kernels.setconv import setconv_exprbf_fwd, setconv_exprbf_plain
from .score import load_model
from .utils.helpers import set_numerics

BF16 = torch.bfloat16

RUN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")


def ab_case(libs, row, call, ref, err_fields, bound, reps):
    """Both builds on one case: each one's errors against the plain version
    `ref` (err_fields(out, ref) -> dict), whether two launches give the same
    bits, whether the two builds do, and device times in the order old, new,
    new, old. `call` and `ref` are tuples of tensors."""
    outs = {}
    for tag, lib in libs.items():
        with _build.using(lib):
            out, again = call(), call()
        outs[tag] = out
        row.update({f"{tag}_{k}": v for k, v in err_fields(out, ref).items()})
        row[f"{tag}_repeat_identical"] = all(torch.equal(a, b) for a, b in zip(out, again))
    row["builds_identical"] = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
    t = {tag: [] for tag in libs}
    for tag in ("old", "new", "new", "old"):
        with _build.using(libs[tag]):
            t[tag].append(time_ms(call, reps))
    row["bound_ms"], row["bound_by"] = bound
    return row, t


def bf16_case(lib, row, call, ref, bound, reps):
    """The new build's bf16 kernel on one case: whether its rounded output
    (K2-bf16's out, K3-bf16's dx) has the plain version's bits, the largest
    relative error of the rest (K3-bf16's dW/db), whether two launches give
    the same bits, and two device times."""
    with _build.using(lib):
        out, again = call(), call()
        row["rounded_equal_plain"] = torch.equal(out[0], ref[0])
        row["f32_rel_err"] = max((((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                                  for a, b in zip(out[1:], ref[1:]) if b.numel()), default=0.0)
        row["repeat_identical"] = all(torch.equal(a, b) for a, b in zip(out, again))
        t = [time_ms(call, reps) for _ in range(2)]
    row["new_ms"], row["new_ms_each"] = sum(t) / 2, t
    row["bound_ms"], row["bound_by"] = bound
    row["new_bound_share"] = row["bound_ms"] / row["new_ms"]
    return row


def k1_errs(out, ref):
    (s, d), (s_p, d_p) = out, ref
    return dict(signal_err=(s - s_p).abs().max().item(),
                density_rel_err=((d - d_p).abs() / (d_p.abs() + 1e-30)).max().item())


def k2_errs(out, ref):
    (o,), (p,) = out, ref
    err = (o - p).abs().max().item()
    return dict(max_abs_err=err, rel_err=err / max(p.abs().max().item(), 1e-30))


def k3_errs(out, ref):
    return dict(rel_err=max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                            for a, b in zip(out, ref) if b.numel()))


def ptxas_report(log: str) -> list:
    """(kernel, registers, static shared memory bytes) per compiled kernel."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(dict(kernel=name, registers=int(m.group(1)),
                            smem_bytes=int(m.group(2) or 0)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--run-dir", default=RUN_DIR)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    set_numerics()
    builds = {"new": _build.build(verbose=True), "old": _build.build(True, args.old_csrc)}
    libs = {tag: _build.load(b.path) for tag, b in builds.items()}
    if not hasattr(libs["old"], "npf_mlp_chain_fwd_smem"):
        # builds before this query checked K2's widths in the launcher alone
        libs["old"].npf_mlp_chain_fwd_smem = lambda M, C, H, O: 0
    ptxas = {tag: ptxas_report(b.log) for tag, b in builds.items()}
    for tag, rows in ptxas.items():
        for r in rows:
            if any(k in r["kernel"] for k in ("setconv", "mlp_chain")):
                print(f"ptxas {tag}: {r}")

    model = load_model(args.run_dir, "cpu")
    sig_ctx = model.cntxt_to_induced.rbf.sigma().item()
    sig_trgt = model.induced_to_trgt.rbf.sigma().item()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with torch.inference_mode():
        for B in (32, 256):
            for name, inp in ((f"ctx->grid B={B}", (B, 256, 384, 1, sig_ctx, gen, (), True, 192)),
                              (f"grid->trgt B={B}",
                               (B, 384, 256, 128, sig_trgt, gen, (), True, "all"))):
                a = k1_inputs(*inp)
                rows.append(ab_case(
                    libs, dict(kernel="K1", shape=name, B=B, K=inp[1], Q=inp[2], C=inp[3]),
                    lambda: setconv_exprbf_fwd(*a), setconv_exprbf_plain(*a), k1_errs,
                    k1_bound(*a[:4]), args.reps))
        dec = model.decoder.module
        weights = tuple(t.detach().contiguous().cuda() for t in (
            dec.to_hidden.weight, dec.to_hidden.bias,
            torch.stack([dec.linear_0.weight, dec.linear_1.weight, dec.linear_2.weight]),
            torch.stack([dec.linear_0.bias, dec.linear_1.bias, dec.linear_2.bias]),
            dec.out.weight, dec.out.bias))
        for M in (8192, 65536):
            a2 = k2_inputs(M, 128, 128, 3, 2, True, gen, weights)
            rows.append(ab_case(libs, dict(kernel="K2", shape=f"M={M}", M=M),
                                lambda: (fused_relu_mlp(*a2),), (fused_relu_mlp_plain(*a2),),
                                k2_errs, k2_bound(*a2), args.reps))
            a = k3_inputs(M, 128, 128, 3, 2, True, gen, weights[:5])
            rows.append(ab_case(libs, dict(kernel="K3", shape=f"M={M}", M=M),
                                lambda: fused_relu_mlp_bwd(*a), fused_relu_mlp_bwd_plain(*a),
                                k3_errs, k3_bound(*a), args.reps))
        for name, M, C, H, L1, O, is_res, biases in K2_CASES:
            a2 = k2_inputs(M, C, H, L1, O, biases, gen)
            rows.append(ab_case(
                libs, dict(kernel="K2", shape=name, M=M, C=C, H=H, L1=L1, O=O, is_res=is_res),
                lambda: (fused_relu_mlp(*a2, is_res=is_res),),
                (fused_relu_mlp_plain(*a2, is_res=is_res),), k2_errs, k2_bound(*a2), args.reps))
        bf16_rows = []
        for M in (8192, 65536):
            a2 = k2_inputs(M, 128, 128, 3, 2, True, gen, weights, BF16)
            bf16_rows.append(bf16_case(
                libs["new"], dict(kernel="K2-bf16", shape=f"M={M}", M=M),
                lambda: (fused_relu_mlp(*a2, compute_dtype=BF16),),
                (fused_relu_mlp_plain(*a2, compute_dtype=BF16),), k2_bound(*a2), args.reps))
            a3 = k3_inputs(M, 128, 128, 3, 2, True, gen, weights[:5], BF16)
            bf16_rows.append(bf16_case(
                libs["new"], dict(kernel="K3-bf16", shape=f"M={M}", M=M),
                lambda: fused_relu_mlp_bwd(*a3, compute_dtype=BF16),
                fused_relu_mlp_bwd_plain(*a3, compute_dtype=BF16), k3_bound(*a3), args.reps))
    cases = []
    for row, t in rows:
        for tag in ("old", "new"):
            row[f"{tag}_ms"] = sum(t[tag]) / len(t[tag])
            row[f"{tag}_ms_each"] = t[tag]
            row[f"{tag}_bound_share"] = row["bound_ms"] / row[f"{tag}_ms"]
        row["speedup"] = row["old_ms"] / row["new_ms"]
        print(json.dumps(row))
        cases.append(row)
    for row in bf16_rows:
        print(json.dumps(row))
    res = dict(card=smi, ptxas=ptxas, cases=cases, bf16_cases=bf16_rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(dict(card=smi, cases=[{k: r.get(k) for k in ("kernel", "shape", "old_ms",
                                                                   "new_ms", "bound_ms", "speedup",
                                                                   "builds_identical")}
                                           for r in cases + bf16_rows])))
    return res


if __name__ == "__main__":
    main()
