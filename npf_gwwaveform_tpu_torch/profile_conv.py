"""Time the image CNN's depthwise convolution on the card in each memory
layout and cuDNN setting PyTorch offers it, forward and forward plus
backward.

    python -m npf_gwwaveform_tpu_torch.profile_conv [--kernel 9] [--channels 128]
        [--shapes 32x32x32,32x128x128] [--reps 5]

For each batch x height x width it prints one JSON line a variant: the
layout of the input (NCHW contiguous, which PyTorch's own depthwise kernel
takes in float32, or channels-last, which goes to cuDNN), cuDNN's
`deterministic` and `benchmark` flags, the forward time and the forward
plus backward time (input and weight gradients) in ms, device time from
CUDA events around `reps` calls after a warm-up, and the largest
difference of the output and of the gradients from the first variant's.
Needs a card.
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch
import torch.nn.functional as F

__all__ = ["time_variant", "main"]


def _events_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_variant(x, w, g, channels_last: bool, deterministic: bool, benchmark: bool,
                 reps: int) -> dict:
    """The depthwise conv of x [B, C, H, W] with w [C, 1, k, k] (SAME
    padding) in one variant -> times and outputs."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    xv = x.contiguous(memory_format=fmt).requires_grad_(True)
    wv = w.detach().clone().requires_grad_(True)
    pad = w.shape[-1] // 2
    with torch.backends.cudnn.flags(enabled=True, deterministic=deterministic,
                                    benchmark=benchmark, allow_tf32=False):
        def fwd():
            with torch.no_grad():
                return F.conv2d(xv, wv, None, 1, pad, 1, x.shape[1])

        def fwd_bwd():
            y = F.conv2d(xv, wv, None, 1, pad, 1, x.shape[1])
            return torch.autograd.grad(y, (xv, wv), g)

        fwd_ms, fwd_bwd_ms = _events_ms(fwd, reps), _events_ms(fwd_bwd, reps)
        out, (gx, gw) = fwd(), fwd_bwd()
    return dict(fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms, out=out, gx=gx, gw=gw)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", type=int, default=9)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--shapes", default="32x32x32,32x20x20,32x128x128,512x32x32")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    for shape in args.shapes.split(","):
        b, h, wd = (int(v) for v in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((b, args.channels, h, wd), generator=gen, device="cuda")
        w = torch.randn((args.channels, 1, args.kernel, args.kernel), generator=gen,
                        device="cuda") / args.kernel
        g = torch.randn((b, args.channels, h, wd), generator=gen, device="cuda")
        ref = None
        for cl, det, bench in itertools.product((False, True), (True, False), (False, True)):
            r = time_variant(x, w, g, cl, det, bench, args.reps)
            if ref is None:
                ref = r
            line = dict(shape=[b, args.channels, h, wd], kernel=args.kernel,
                        layout="channels_last" if cl else "nchw", deterministic=det,
                        benchmark=bench, fwd_ms=r["fwd_ms"], fwd_bwd_ms=r["fwd_bwd_ms"],
                        out_diff=(r["out"] - ref["out"]).abs().max().item(),
                        gx_diff=(r["gx"] - ref["gx"]).abs().max().item(),
                        gw_diff=(r["gw"] - ref["gw"]).abs().max().item(),
                        device=torch.cuda.get_device_name(0))
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
