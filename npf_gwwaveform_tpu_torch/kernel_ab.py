"""Two builds of the port's kernels (K1, the SetConv forward; K2 and K3,
the MLP-chain forward and backward, in float32 and in bfloat16), timed in
turns in one process on one card: the sources in the package's `csrc/`
against those of another directory with the same C entry points (an earlier
commit's `csrc/`, unpacked with `git show` or `git archive`).

    python -m npf_gwwaveform_tpu_torch.kernel_ab --old-csrc DIR [--reps 20]
        [--out kernel_ab.json]

Both libraries are built with `nvcc -Xptxas -v`; each kernel's registers,
shared memory and spills are printed. At each shape of the flagship paths
(K1 context->grid and grid->targets at batch 32 and 256, with the paths'
masks; K2, K3, K2-bf16 and K3-bf16 at M = 8,192 and 65,536 with the flagship
run's decoder weights) and at K2's other cases in `chip_smoke.py`
(`K2_CASES`), both builds are driven through the port's own wrappers
(`_build.using` routes their launches to one build or the other), checked
against the plain PyTorch version, for identical bits over two launches and
between the two builds, then timed over `--reps` launches in the order old,
new, new, old (`kernel_measure.time_ms`: each run of launches is captured in
a CUDA graph and replayed, so the host's launch overhead is not counted;
L2 is warm). The float32 kernels are expected to give the same bits in both
builds; the bfloat16 kernels are held, in each build, to the bars of
`kernel_measure.py` against their plain versions (`*_within_bars`), and the
bf16 cuBLAS layer chain is timed beside them (`cublas_chain_ms`). Bounds are
`kernel_measure`'s, as in `chip_smoke.py`. Prints one JSON line (also written
to `--out`) with each case's times, bound and errors, and the card's name and
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
    K2_CASES, cublas_chain_ms, k1_bound, k1_inputs, k2_bf16_ok, k2_bf16_report, k2_bound,
    k2_inputs, k3_bf16_ok, k3_bf16_report, k3_bound, k3_inputs, time_ms,
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


def k2_bf16_errs(args):
    """K2-bf16's bars (kernel_measure.py) on the inputs `args`."""
    def errs(out, ref):
        rel, share = k2_bf16_report(out[0], *args)
        return dict(max_rel_sum=rel, share_differing=share, within_bars=k2_bf16_ok((rel, share)),
                    plain_identical=torch.equal(out[0], ref[0]))
    return errs


def k3_bf16_errs(out, ref):
    rep = k3_bf16_report(out, ref)
    return dict(**rep, within_bars=k3_bf16_ok(rep), dx_plain_identical=torch.equal(out[0], ref[0]))


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
        for M in (8192, 65536):
            a2 = k2_inputs(M, 128, 128, 3, 2, True, gen, weights, BF16)
            row, t = ab_case(libs, dict(kernel="K2-bf16", shape=f"M={M}", M=M),
                             lambda: (fused_relu_mlp(*a2, compute_dtype=BF16),),
                             (fused_relu_mlp_plain(*a2, compute_dtype=BF16),), k2_bf16_errs(a2),
                             k2_bound(*a2), args.reps)
            row["new_path"] = libs["new"].npf_mlp_chain_fwd_bf16_path(M, 128, 128, 3, 2)
            row["cublas_chain_ms"] = cublas_chain_ms(*a2)
            rows.append((row, t))
            a3 = k3_inputs(M, 128, 128, 3, 2, True, gen, weights[:5], BF16)
            row, t = ab_case(libs, dict(kernel="K3-bf16", shape=f"M={M}", M=M),
                             lambda: fused_relu_mlp_bwd(*a3, compute_dtype=BF16),
                             fused_relu_mlp_bwd_plain(*a3, compute_dtype=BF16), k3_bf16_errs,
                             k3_bound(*a3), args.reps)
            row["new_path"] = libs["new"].npf_mlp_chain_bwd_bf16_path(M, 128, 128, 3, 2)
            x, g, w0, b0, wh, bh, wout = a3
            row["cublas_chain_ms"] = cublas_chain_ms(x, w0, b0, wh, bh, wout, g=g)
            rows.append((row, t))
    cases = []
    for row, t in rows:
        for tag in ("old", "new"):
            row[f"{tag}_ms"] = sum(t[tag]) / len(t[tag])
            row[f"{tag}_ms_each"] = t[tag]
            row[f"{tag}_bound_share"] = row["bound_ms"] / row[f"{tag}_ms"]
        row["speedup"] = row["old_ms"] / row["new_ms"]
        print(json.dumps(row))
        cases.append(row)
    res = dict(card=smi, ptxas=ptxas, cases=cases)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(dict(card=smi, cases=[{k: r.get(k) for k in (
        "kernel", "shape", "old_ms", "new_ms", "bound_ms", "cublas_chain_ms", "speedup",
        "builds_identical", "old_within_bars", "new_within_bars")} for r in cases])))
    return res


if __name__ == "__main__":
    main()
