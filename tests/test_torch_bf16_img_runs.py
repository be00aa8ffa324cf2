"""One image bar run of each family in bfloat16 compute at full width on the
JAX package's own first eval batch, against the JAX package's bf16 model
as `reproduce_img.build_model(name, dtype=jnp.bfloat16)` builds it (with
`fused_mlp=True`: the port's kernel path, `use_kernels=True`, the chain's
plain version on the CPU): the six `digits` runs and zsmms' circular
GridConvCNP `run_1`, on tests/test_torch_img_runs.py's inputs and image
counts (the LNP run 2 images, whose 32 draws through JAX's interpret-mode
chain are slow on the CPU; a latent run at its eval draws, JAX's own noise
given to the port as `eps`). The point models' bar is tests/test_torch_bf16_gp_runs.py's
full-width rule: the port's RMS distance to JAX bf16 loc at most half the
RMS of JAX's own bf16-float32 gap, its RMS distance to JAX float32 at
least 3/4 of it.

That rule cannot tell the grid runs' roundings from JAX's: their
bf16-float32 gap is itself about one bf16 ulp (digits GridConvCNP: loc
RMS 0.0018, where an ulp near 1 is 0.0039), and two roundings of one
computation that sum in other orders sit that far apart whoever rounds
right (the first block's pointwise sums round 0.17% of its outputs one
ulp apart; five blocks carry that to 53%). So a grid run is held block by
block: each block of its grid CNN on JAX's own input to that block (the
captured intermediates) against JAX's output, at most 1% of the elements
apart and none by more than 4 bf16 ulps of the block output's largest
magnitude (measured: 0.05-0.5%, about one ulp), the resizer by the same
bar (the float32 AbsConv sums in another order, 4.8e-7 apart, which the
bf16 Dense after the division rounds one ulp apart in 0.016% of its
outputs on GridConvLNP's images, none on GridConvCNP's), and
the whole model's loc within 4 bf16 ulps of its largest magnitude
(tests/test_torch_bf16_slice.py's small-width bar) or, where two grid CNNs
carry the roundings further, within twice JAX's own largest bf16-float32
distance (`_near`, tests/test_torch_bf16_families.py's rule).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.reproduce_img import POINT_MODELS, build_model
from npf_gwwaveform_tpu_torch import score_img
from npf_gwwaveform_tpu_torch.ops.cnn import _channel_first
from npf_gwwaveform_tpu_torch.training.checkpoint import load_run_params
from test_torch_bf16_families import _near
from test_torch_bf16_gp_runs import check_distances
from test_torch_img_runs import N_IMAGES, RESULTS, _jax_batch

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
BLOCK_SHARE, ULPS = 0.01, 4
RUNS = [os.path.join("digits", m, "run_0")
        for m in ("GridConvCNP", "GridConvLNP", "CNP", "LNP", "AttnCNP", "AttnLNP")] + [
    os.path.join("zsmms", "GridConvCNP", "run_1")]


@pytest.mark.parametrize("name", RUNS)
def test_run_bf16_against_jax_at_full_width(name):
    run_dir = os.path.join(RESULTS, name)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    batch, k_latent = _jax_batch(summary)
    n = N_IMAGES.get(name, 2 if name.startswith(os.path.join("digits", "LNP")) else 8)
    b = {k: v[:n] for k, v in batch.items()}
    kw = dict(y_dim=summary.get("y_dim", 1),
              **(dict(padding="CIRCULAR", norm_eps=1e-2) if summary["dataset"] == "zsmms"
                 else {}))
    params, extra = load_run_params(run_dir)
    variables = {"params": params, **extra}
    outs = []
    for jm in (build_model(summary["model"], dtype=JBF16, **kw).clone(fused_mlp=True),
               build_model(summary["model"], **kw)):
        def apply(v, jm=jm, **more):
            return jm.apply(v, b["X_cntxt"], b["Y_cntxt"], b["X_trgt"], b["Y_trgt"],
                            mask_cntxt=b["mask_cntxt"], mask_trgt=b["mask_trgt"], train=False,
                            rngs={"latent": k_latent}, **more)
        if jm.dtype is None:
            outs.append(jax.jit(apply)(variables))
        else:
            out, inter = apply(variables, capture_intermediates=True, mutable=["intermediates"])
            outs.append(out)
    j_out = outs[0]
    eps = None
    if j_out.z_samples is not None:
        q = j_out.q_zCc if j_out.q_zCct is None else j_out.q_zCct
        z, loc, scale = (np.asarray(a, np.float64) for a in (j_out.z_samples, q.loc, q.scale))
        eps = torch.from_numpy((z - loc) / scale).float()
    tm = score_img.load_model(run_dir, "cpu", dtype=BF16)
    t = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    with torch.no_grad():
        out = tm(t["X_cntxt"], t["Y_cntxt"], t["X_trgt"], mask_cntxt=t["mask_cntxt"],
                 mask_trgt=t["mask_trgt"], y_trgt=t["Y_trgt"], eps=eps)
    loc = out.p_yCc.loc.numpy()
    assert np.isfinite(loc).all()
    if summary["model"] in POINT_MODELS:
        check_distances(loc, *(np.asarray(o.p_yCc.loc) for o in outs))
        return
    ref, ref32 = (np.asarray(o.p_yCc.loc) for o in outs)
    ok, d, gap = _near(loc, ref, ref32, ULPS * 2.0 ** -8 * np.abs(ref).max())
    assert ok, (d, gap)
    inter = inter["intermediates"]

    def held(got, ref, what):
        ref = np.asarray(ref, np.float32)
        share = float((got != ref).mean())
        ulps = float(np.abs(got - ref).max() / (2.0 ** -8 * np.abs(ref).max()))
        assert share <= BLOCK_SHARE and ulps <= ULPS, (what, share, ulps)

    with torch.no_grad():
        r_port = tm.cntxt_to_induced(t["X_cntxt"], t["Y_cntxt"])
    held(r_port.float().numpy(), inter["resizer"]["__call__"][0], "resizer")
    prev, blocks = inter["resizer"]["__call__"][0], inter["induced_to_induced"]
    for i in range(tm.induced_to_induced.n_blocks):
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(prev, np.float32)).to(BF16)
            got = getattr(tm.induced_to_induced, f"block_{i}")(_channel_first(x, 2))
        held(got.float().permute(0, 2, 3, 1).numpy(), blocks[f"block_{i}"]["__call__"][0],
             f"block_{i}")
        prev = blocks[f"block_{i}"]["__call__"][0]
