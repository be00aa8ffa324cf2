#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`npf_gwwaveform_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each announced with the seconds elapsed:
  1. device: the card's name and power limit, torch and nvcc versions;
  2. build: the kernels, one nvcc a source started together and one link
     (ptxas resource report);
  3. K1 (SetConv forward) against its plain version at the two path shapes of
     the scoring batch and of the train step, with the paths' own masks
     (U{0..192} of 256 context points real, every grid point real), at the
     long-waveform scoring batch's two shapes (B = 256; 2048 context points
     of which U{0..1024} real onto the 1536-point grid, C = 1, and the grid
     onto 2048 targets, C = 128, with the long k=37 run's length scales)
     and the long train step's (the same at B = 32), at the
     frequency-domain paths' (C = 2: U{0..64} of 256 context points onto
     the 192-point grid, and the grid onto 256 targets at C = 128, B = 256
     and 32, each frequency-domain run's length scales), at the ConvLNP
     paths' (phase 16: U{0..64} of 256 context points onto the 192-point
     grid at B = 256 and 32; the grid onto 256 targets with the z draws
     folded into the batch, B = 32 * 256 = 8,192 for a scoring batch and
     16 * 32 = 512 for an NPML train step, C = 128, the latlbF `run_1`'s
     length scales; the ELBO run's encoding of all 256 targets onto the
     grid at B = 256 and 32), and at three other cases: random masks at the grid->targets shape, K = 5000 keys, and the
     width C = 512 (K = 2048, Q = 1536); two launches
     must give the same bits;
  4. K2 (fused MLP chain forward) against its plain version at the scoring
     and training decoder shapes, at the long-waveform scoring batch's
     (M = 256 * 2048 = 524,288 rows, the long k=37 run's decoder) and
     train step's (M = 32 * 2048 = 65,536), at the frequency-domain
     decoders' (O = 4, M = 65,536 and 8,192, each run's weights), and at
     the edges of its design: L1=0, a
     ragged residual chain with C != H and no biases, C > H, widths over 128
     (H = 256, and 320 with the residual), O on each side of the small-O
     output (8 and 9), 128-row tiles with a two-pass output and with two
     activation buffers, and widths served by the wide kernel; two launches
     must give the same bits;
  5. K3 (fused MLP chain backward) against its plain version at the training
     and scoring shapes, the long train step's (M = 65,536, the long
     run's weights), the frequency-domain train steps' (O = 4, M = 8,192,
     each run's weights), with L1=0 and no biases, at a ragged row count, and
     at widths over 128 (H = 256 and 320, L1 = 2, with and without the
     residual); two launches must give the same bits;
  6. autograd through the kernels against the plain modules at the training
     shapes: a SetConv through K1 and the decoder MLP through K2 and K3;
  7. the scoring path: score the 2048 thetas recorded in the flagship run
     `results/GW_time_cond_film_ctx192_d128/ConvCNP/run_1` through K1 and K2
     with `score_run`, the first batch eagerly and the other seven
     replayed from its CUDA graph (which `score_run` takes by itself only
     where more batches follow: `graph_every_run`); count the path's launches (the
     wrappers' counts at the eager batch and the capture, and a traced
     replay of that run's own graph) and check the quality bands; score them
     eagerly (a loop of `score_batch`) and hold the graphed scores to the
     eager ones per waveform; then compare one batch with the plain path,
     and time one batch eagerly and replayed from its graph;
  8. the training path: the train step captured in a CUDA graph against the
     eager step, from two trainers with the same init and generator seed
     (the counters at the capture; one step and ten: thetas, masks, losses,
     gradients, parameters and statistics bit-identical; ten steps of
     `train_steps_scanned` on stacked batches; the kernels of one replay in
     the profiler's trace);
     then train the flagship configuration from the port's init for 500
     graphed steps at batch 32 (`train_gw.train`), check that the loss
     falls, a kernel-path train step against a plain-path one, that the
     written run reloads, count the path's launches (the wrappers' counts at
     the warm-up steps and the capture, and a traced replay of that run's own
     graph), and print the eager and graphed step and batch times;
  9. K2-bf16 (the chain forward in bfloat16 compute) against its plain
     version at the scoring and training decoder shapes with the run's
     weights, at the long scoring batch's and train step's (M = 524,288
     and 65,536, the long run's weights), at the frequency-domain
     decoders' (O = 4), and at K2's edge cases (the two
     widths past its shared memory must be refused before any launch), and
     K3-bf16 against its plain version at K3's cases (the long and
     frequency-domain train steps' too), each case with the kernel its plan takes (the decoder shapes
     must take the tensor cores) and the bf16 cuBLAS layer
     chain's time beside the kernel's at the decoder shapes; each pair must
     meet the bars of `kernel_measure.py`, and two launches must give the
     same bits;
 10. the bf16 scoring path: score the same 2048 thetas in bfloat16 compute
     with the same context draws, graphed, count the launches (no float32 K2
     or K3), check the quality bands and the gap to the float32 score, hold
     them to eager bf16 scoring; time `score_run` end to end against the
     eager loop at n_test 2048, 300 and the least it graphs, in float32 and
     bf16; then one batch
     of the kernel path against the same path with every kernel replaced by
     its plain version;
 11. the bf16 training path: phase 8's graph checks in bfloat16 compute,
     500 graphed steps at batch 32 from seed 0, that the loss falls, one step
     of the kernel path against the plain-kernel path, and the launches;
 12. the other 20 ConvCNP runs in `results/` (dilated CNN, additive
     conditioning, UnetCNN, the 2 s long waveforms with k=37 and with the
     UnetCNN, the flat-CNN runs, and the two frequency-domain runs
     `GW_freq_ap_cond_film_ctx64/run_0` and `GW_freq_ap_ctx64/run_1`, K1 at
     C = 2 and the chain at O = 4): each scored in float32 with `score_run`
     on its own 2048 recorded thetas, graphed as in phase 7, through K1 and
     K2 (the wrappers' counts at the eager batch and the capture), held to
     its bands (a time-domain run's from its recorded scores,
     `run_report.score_bands`; a frequency-domain run's from the JAX
     package's own float32 scoring of the same thetas,
     `tests/jax_bf16_family_gaps.json`) and printed beside its recorded
     scores; the launches of the long k=37, long UnetCNN and both
     frequency-domain paths counted from a traced replay of each one's own
     graph, and the frequency-domain runs' graphed scores held to eager
     ones; then each run again in bfloat16 with the same context draws
     (through K1 and K2-bf16, at M = 524,288 rows on the long runs), its
     bf16-float32 mean LL gap held to JAX's own gap on the same thetas
     (`tests/jax_bf16_family_gaps.json`); one long-waveform batch of each
     timed eagerly and replayed;
 13. decile checkpoints and resuming: 300 graphed steps of the flagship
     configuration through `train_gw.run` (six chunks of 50, checkpoints
     after chunks 1-5), each checkpoint read back bit for bit as it is
     written; a continuation resumed from the last checkpoint into run
     index 1 (its first forward, before any step, equal to the
     checkpoint's model's bit for bit; `resumed_from` recorded), and a
     resume into the run's own directory refused;
 14. the training paths of the other families, each the configuration a
     run recorded (`configs.train_config`: architecture, data, learning
     rate, decay, clip), in float32 and in bf16: additive conditioning
     (`GW_time_cond_ctx32/run_0`), per-block dilations, k=37, the UnetCNN
     (`ctx192_d128_unet/run_0`), and the 2 s long waveforms with k=37
     (`run_1`: lr 3e-4, clip 1.0) and with the UnetCNN (`run_0`: lr 3e-4,
     decay x100, clip 1.0), K1 at B = 32 on 2048 points and a 1536-point
     grid, K3 and K3-bf16 at M = 65,536 rows; and (phase 15) the two
     frequency-domain configurations, `GW_freq_ap_cond_film_ctx64` (FiLM)
     and `GW_freq_ap_ctx64` (no conditioning), K1 at C = 2, K2, K3,
     K2-bf16 and K3-bf16 at O = 4. For each: phase 8's graph
     checks (the norms before the clip printed; the clip must bind in a
     long path's checked steps); graphed steps at batch 32 through
     `train_gw.train` (`FAMILY_RUNS`: 300-500 for the 1 s paths and 500
     for the frequency-domain ones in float32, 500-1,000 in bf16, from seeds
     0, 1 and 2; 200 and 300 for the 2 s ones from seed 0), each draw
     printing its median loss over the first
     and the last 50 steps, of which one must fall `FAMILY_FALL` nats; one
     step of seed 0's trained model on the kernel path against the plain
     path; the path's launches from a traced replay of seed 0's graph. The
     seeds after the first are fallbacks: a path trains the next seed only
     while no draw has met its bar;
 16. the latent ConvNP family: the four ConvLNP runs in `results/` (NPML,
     the ELBO run, the unbounded q(z) scale's `run_0` and `run_1`), each
     scored with `score_run` on its own 2048 recorded thetas at 32 z draws
     a waveform (K1's grid->targets launch at B = 8,192; the ELBO run's
     eval forward encodes its targets too, K1 three times a batch and K2,
     K3 never), graphed as in phase 12 and held to eager scoring, in float32
     within the JAX package's own float32 bands of the same thetas
     (`tests/jax_bf16_family_gaps.json`: the records were not made with its
     float32 arithmetic, `tests/jax_score_offsets.py`) and in bf16 within
     the bar of JAX's own bf16 gap; one batch of the NPML and of the ELBO
     path on the kernel path against the plain path, the same z draws; and
     (in phase 14's loop) the three training configurations, NPML, ELBO
     and the unbounded scale, in float32 and bf16, each checked as the
     other families (graphed against eager bit for bit, a traced replay
     holding K1 two or three times and K2/K3 never, the loss falling by
     its bar and its last 50 steps' median at or below its level over
     300-500 steps, one kernel-path step against the plain path).
 17. the GP paths' kernels: K1 at the GP shapes (128 points a function at
     sorted x ~ U(-1, 1), not evenly spaced, and the 192-point grid): the
     context (U{0..50} real) onto the grid at B = 256 and 32, the grid onto
     the 128 targets at C = 128 at B = 256, 32, 8,192 (32 z draws x 256,
     headline ConvLNP scoring), 4,096 (16 x 256, ablation scoring) and 512
     (16 x 32, an NPML step), and the ELBO-trained runs' encoding of all 128
     targets; K2 at M = 32,768 and 4,096 and K3 at M = 4,096 with the GP
     ConvCNP's decoder; each at phases 3-5's bars, two launches bit-identical;
 18. the GP sampler on the card: 4,096 functions of each kernel and of the
     All_Kernels mixture from one seed, finite, each kernel's sample
     covariance at one fixed x within 6 standard errors of the kernel's;
 19. the 21 conv-family GP runs in `results/` (ConvCNP, ConvLNP and the
     RBF ConvLNP objective-ablation grid): each scored with
     `score_gp.score_run` over 5,376 fresh functions a kernel (16,128 for
     All_Kernels), graphed after each kernel's first batch, through K1 (and
     K2 for ConvCNP), within the band of the JAX package's eval draws
     scored by the port's CPU forward (`tests/jax_bf16_family_gaps.json`),
     the record's band printed beside;
     for one run of each family (ConvCNP, the headline NPML ConvLNP, an
     ELBO-trained ablation run) the graphed scores against eager ones (LL
     1e-4), the launches of a traced replay (K1 x2 and K2; K1 x2; K1 x3) and
     one batch on the kernel path against the plain path;
 20. the GP training configurations of `experiments/reproduce_gp.py` (the
     ConvCNP, the headline ConvLNP NPML, the notebook ablation
     `ConvLNP_ELBOFalse_LatLBFalse_SigLBFalse`) on RBF functions sampled on
     the card inside the step: phase 8's graph checks (bit for bit), 1,000
     graphed steps at batch 32 from seed 0 (seeds 1-2 fallbacks) held to
     bars from the JAX package's own runs (`GP_FALL`, `GP_LEVEL`), one
     step on the kernel path against the plain path, and a traced replay's
     launches (K1 x2, K2, K3; K1 x2).
 21. the set and attention family's kernels (after phase 17): K2 at the
     decoder's z-folded rows with the RBF runs' own weights, a scoring
     batch of 256 functions (CNP 32,768 rows, AttnLNP's 8 draws 262,144,
     LNP's 32 draws 1,048,576) and a train step of 32 (4,096; the NPML
     variants 131,072 for LNP and 32,768 for AttnLNP), K3 at the train
     rows, each at phases 4-5's bars, two launches bit-identical;
 22. the 57 set and attention GP runs in `results/` (CNP, LNP, AttnCNP and
     AttnLNP of every kernel and All_Kernels, the LNP and AttnLNP ablation
     grids, LNP_SUMO; after phase 19): each scored as phase 19 scores the
     conv family, K2 once a batch, at the run's own z draws (32 LNP, 8
     AttnLNP), within the band of the JAX package's eval draws through the
     port's CPU forward, the record's band printed beside; for one RBF run
     of each family the graphed scores against eager ones, the launches of
     a traced replay (K2) and one batch on the kernel path against the
     plain path;
 23. the set family's training configurations of `reproduce_gp.py` (CNP,
     LNP, AttnCNP, AttnLNP, the NPML ablation variant
     `AttnLNP_ELBOFalse_LatLBFalse_SigLBFalse`, `LNP_SUMO`; after phase
     20), each checked as phase 20 checks the conv family (graphed against
     eager bit for bit, 1,000 graphed steps from seed 0 held to bars from
     the JAX package's own runs, one step on the kernel path against the
     plain path, a traced replay's launches: K2 and K3).
 24. the grid and image family's kernels: K2 and K3 at the image decoders'
     rows (B x H x W, times the z draws) with the runs' own weights: K2 at
     32,768 rows (GridConvCNP and CNP at 32x32, zsmms on its 32x32 test
     canvas), 12,800 (zsmms' 20x20 training canvas), O = 6 on the RGB
     corpora (rgb_digits at 32,768; the XL model at 128x128, 524,288),
     262,144 (AttnLNP's 8 draws) and 1,048,576 (LNP's 32, at O = 2 and 6);
     K3 at the train steps' rows (12,800 to 524,288, O = 2 and 6); each at
     phases 4-5's bars, two launches bit-identical;
 25. the 20 scorable image runs in `results/` (`digits`, `rgb_digits`,
     `rgb_digits128`, `zsmms`: GridConvCNP, GridConvLNP, GridConvCNPXL,
     CNP, LNP, AttnCNP, AttnLNP; `zsmms/GridConvCNP/run_0` has no BatchNorm
     statistics, ROADMAP), each scored with `score_img.score_run` over its
     whole test set (160, 256 or 1,024 images), every batch after the first
     replayed from its CUDA graph, K2 once a batch (none for GridConvLNP),
     within the band of the JAX package's eval draws through the port's
     CPU forward (`tests/jax_bf16_family_gaps.json`), the record's band
     printed beside; for one run of each family (the six `digits` runs,
     zsmms GridConvCNP `run_1`, the XL `run_0`) the graphed scores against
     eager ones per image, a traced replay's launches and one batch timed
     eager and replayed;
 26. one batch of each of those runs on the kernel path against the plain
     path;
 27. `score_img --diag` on `zsmms/GridConvCNP/run_1`, its four rows beside
     `zsmms_diag.json`'s, in the record's order;
 28. `reproduce_img.py`'s configurations trained from seed 0 (GridConvCNP,
     GridConvLNP, CNP, LNP, AttnCNP, AttnLNP on `digits`, GridConvCNP on
     `zsmms` and on `rgb_digits`): three graphed steps bit-identical to
     three eager ones, 300 graphed steps (200 for the attention models)
     held to fall and
     level bars from the JAX package's runs and the seeds' spread
     (`IMG_JAX`, `IMG_SEED_LAST`), seeds 1-2 as
     fallbacks, a traced replay's launches (K2 and K3, none for
     GridConvLNP); and GridConvCNPXL on `rgb_digits128`, 8 graphed steps
     with its blocks stored and 3 rematerialised, the peak memory and step
     time of each.
 29. bf16 for the GP and image families: K2-bf16 and K3-bf16 at the bf16
     decoders' rows with the runs' own weights (`check_bf16_family_kernels`:
     32,768 to 1,048,576 rows scoring, O = 2 and 6; 4,096 to 131,072 a GP
     step, 32,768 an image step), at phases 9-10's bars, two launches
     bit-identical, each timed beside its bound, its plain version and the
     bf16 cuBLAS chain;
 30. the 21 bar runs (`GP_BF16_RUNS`, `IMG_BF16_RUNS`) scored graphed in
     bf16 and in float32 on the same functions or images, each run's
     bf16-float32 mean-LL gap within `bf16_gap_bar` of the JAX package's
     own fused-decoder gap, its Dense-decoder gap printed beside; for one
     run of each family (`BF16_FAMILIES`) the graphed bf16 scores against
     eager ones, the rows of the chain's launches, a traced replay's
     launches (K2-bf16 once, K1 as in float32, none for GridConvLNP), a
     replay's time, and the XL's bf16 peak memory;
 31. one batch of each of those runs in bf16 on the kernel path against
     the plain-kernel path, held to the batch's bf16-float32 gap;
 32. nine training paths in bf16 (`GP16_TRAIN`: the GP ConvCNP and NPML
     ConvLNP, CNP, LNP, AttnCNP, AttnLNP; `IMG16_TRAIN`: GridConvCNP, CNP
     and LNP on `digits`) at their float32 paths' depths, seeds and bars:
     graphed against eager, bit for bit, the fall and level bars, one step
     of seed 0's trained model on the kernel path against the plain-kernel
     path (phase 11's check with `rounding_grads`' allowance), the rows of
     that step's chain launches, a traced replay's launches.
 33. the evaluation tools' kernels: K1 at `eval_extrapolation`'s shapes
     with the RBF conv runs' length scales (256 functions of 256 points on
     twice the range, contexts among the inner points, onto the 384-point
     grid over (-3, 3); the grid onto the targets at B = 256 and, for
     ConvLNP's 32 draws, 8,192) and at the context sweeps' new masks, K2
     at the extrapolation decoders' rows with the RBF runs' weights (65,536;
     AttnLNP's 524,288; LNP's 2,097,152), each at phases 3-4's bars, two
     launches bit-identical, timed beside its bound and plain version;
 34. `eval_extrapolation` on the card: both kernels' six models (and the
     RBF oracle) at 2,560 functions, eager, each held statistic
     (`EXTRAP_HELD`: the means; the heavy-tailed rows' medians too; the
     oracle's interpolation by its median) inside the band of the JAX
     package's own values on its draws (`tests/jax_eval_bands.json`), the
     record printed beside; each model's launches; one conv batch on the
     plain-kernel path against the kernel path;
 35. `gw_eval_ctx` on the card: the nine context-sweep records in
     `results/` at 1,024 waveforms a count, p50 and p90 at every count
     inside the bands of the JAX package's own values on its draws, the
     record and the other four fields printed beside; the launches;
 36. the tools on the card: `utils.profiling.trace` around one replay of
     the flagship scoring batch's graph (its trace lists K1 and K2),
     `StepTimer` over 20 synchronised replays against CUDA events,
     `viz.gen_p_y_pred` on the flagship run and
     `viz.get_posterior_samples_imgs` on `digits/GridConvCNP/run_0` against
     their CPU results.
 37. the device mesh (`parallel`, `Trainer(mesh=...)`), after the kernels at
     a rank's shard (K1 both launches, K2, K3, K2-bf16, K3-bf16 at the
     flagship's B = 128 of 256 and at 1,024 of the 2 s path's 2,048
     targets, `check_mesh_kernels`), on a one-rank NCCL group: bench.py's
     flagship (`multichip.flagship_trainer`) at batch 256 through
     `Trainer(mesh=...)` on a `data` mesh and a 1 x 1 `data` x `seq` mesh,
     3 graphed steps bit for bit against 3 eager ones; then, on each mesh,
     20 graphed steps against 20 graphed steps without a mesh from the same
     init and seed, bit for bit (else the step bars and 2e-4); the replay
     wall ms of each, the collectives' share of a traced replay, each mesh
     path's launches; in float32 and bf16;
 38. two gloo ranks sharing the card (`parallel.launch.run_ranks`), eager:
     the flagship at batch 256 on `data` = 2, the 2 s k=37 FiLM
     configuration at batch 32 on `data` 1 x `seq` 2, and digits
     GridConvCNP with BatchNorm and its blocks recomputed in the backward
     pass at batch 32 on `data` = 2, 5 steps each against one process's
     (the first step at the step bars, the trace at 2e-4), each rank's
     launches, the graphed entry points refusing the gloo mesh; then
     `multichip.dryrun_multichip(1)`.
Phases 17-38 run after phase 16's scoring and before phase 14's training
loop. It ends with a JSON line of per-kernel numbers and the JSON result line.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from npf_gwwaveform_tpu_torch import _build
from npf_gwwaveform_tpu_torch import eval_extrapolation as extrap
from npf_gwwaveform_tpu_torch import gw_eval_ctx, multichip
from npf_gwwaveform_tpu_torch import score as score_mod
from npf_gwwaveform_tpu_torch import score_gp, score_img, train_gp, train_gw, train_img, viz
from npf_gwwaveform_tpu_torch.configs import (
    SET_MODELS, gw_model_from_summary, gw_train_summary, train_config,
)
from npf_gwwaveform_tpu_torch.data.gp import KERNEL_CONFIGS, GPSampler, sample_covariance_z
from npf_gwwaveform_tpu_torch.data.images import get_train_test_img_dataset
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.kernel_measure import (
    K2_BF16_SUM_TOL, K2_CASES, cublas_chain_ms, k1_bound, k1_inputs, k2_bf16_ok, k2_bf16_report,
    k2_bound, k2_inputs, k3_bf16_ok, k3_bf16_report, k3_bound, k3_inputs, measure_step, time_ms,
    traced_launches,
)
from npf_gwwaveform_tpu_torch.ops.kernels import (
    counts, hand_kernel_id, mlp_chain, reset_counts, setconv,
)
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain, fused_relu_mlp_plain,
)
from npf_gwwaveform_tpu_torch.ops.kernels.setconv import setconv_exprbf_fwd, setconv_exprbf_plain
from npf_gwwaveform_tpu_torch.parallel import make_mesh
from npf_gwwaveform_tpu_torch.parallel.launch import run_ranks
from npf_gwwaveform_tpu_torch.run_report import (
    bf16_gap_bar, gp_band, gp_bf16_bar_runs, gp_runs, gp_set_runs, img_bf16_bar_runs, img_runs,
    recorded_scores, score_bands, scored_runs,
)
from npf_gwwaveform_tpu_torch.score import (
    batch_graph, eval_splitter, load_model, make_eval_batch, read_run_thetas, run_generator,
    score_batch, score_run,
)
from npf_gwwaveform_tpu_torch.training.checkpoint import load_run_params, params_from_flax
from npf_gwwaveform_tpu_torch.utils.cuda_graph import WARMUP_CALLS
from npf_gwwaveform_tpu_torch.utils import profiling
from npf_gwwaveform_tpu_torch.utils.helpers import linspace, set_numerics

ROOT = os.path.dirname(os.path.abspath(__file__))
RESULTS = os.path.join(ROOT, "results")
RUN_DIR = os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
# the other time-domain ConvCNP runs that hold parameters, each scored on its
# own recorded thetas and held to its own bands (phase 12)
OTHER_RUNS = tuple(r for r in scored_runs(RESULTS) if r != RUN_DIR)
assert len(OTHER_RUNS) == 20, OTHER_RUNS
# the long paths traced and timed
LONG_K37 = os.path.join(RESULTS, "GW_time_cond_film_ctx1024_d512_k37_T2s_np2048_pallas",
                        "ConvCNP", "run_3")
LONG_UNET = os.path.join(RESULTS, "GW_time_cond_film_ctx1024_d512_unet_T2s_np2048_pallas",
                         "ConvCNP", "run_1")
# the frequency-domain runs (mode "freq_ap": amplitude and standardised
# phase, two channels): K1's context->grid launch at C = 2 and the decoder
# chain at O = 4, each path traced, its graphed scoring held to its eager
# scoring, and each configuration trained (phase 15)
FREQ_FILM = os.path.join(RESULTS, "GW_freq_ap_cond_film_ctx64", "ConvCNP", "run_0")
FREQ_UNCOND = os.path.join(RESULTS, "GW_freq_ap_ctx64", "ConvCNP", "run_1")
FREQ_RUNS = {FREQ_FILM: "freq film", FREQ_UNCOND: "freq"}
assert set(FREQ_RUNS) <= set(OTHER_RUNS)
# the latent ConvNP runs (phase 16): K1's grid->targets launch at n_z * B
# (32 draws a scored waveform, 16 a trained one), the ELBO run's third K1
# launch on its targets, no K2 or K3 (a linear decoder)
LATENT_NPML = os.path.join(RESULTS, "GW_time_cond_film_ctx64", "ConvLNP", "run_0")
LATENT_ELBO = os.path.join(RESULTS, "GW_time_cond_film_ctx64_elbo", "ConvLNP", "run_0")
LATENT_LATLBF = os.path.join(RESULTS, "GW_time_cond_film_ctx64_latlbF", "ConvLNP", "run_0")
LATENT_LATLBF1 = os.path.join(RESULTS, "GW_time_cond_film_ctx64_latlbF", "ConvLNP", "run_1")
LATENT_RUNS = {LATENT_NPML: "latent npml", LATENT_ELBO: "latent elbo",
               LATENT_LATLBF: "latent latlbF", LATENT_LATLBF1: "latent latlbF run_1"}
assert sorted(LATENT_RUNS) == scored_runs(RESULTS, "ConvLNP")
# decile checkpoints: six chunks of 50 steps, checkpoints after chunks 1-5;
# then a continuation of two chunks from the last one
RESUME_STEPS, RESUMED_STEPS = 300, 100
N_TEST = 2048
# the recorded run scored mean LL 895.10 and median mismatch 0.00218 on these
# thetas; bootstrap 99% intervals at 1024 waveforms are [887.6, 901.8] and
# [0.00169, 0.00267], and only the context draws differ from that run
LL_BAND = (885.0, 905.0)
MISMATCH_BAND = (0.0016, 0.0030)
PATH_TOL = 5e-4  # loc/scale, kernel path vs plain path
K1_SIGNAL_ATOL = 1e-5
K1_DENSITY_RTOL = 1e-5
K2_RTOL = 1e-4  # of the output's max magnitude
# K3: each output (dx and every dW/db) against its max magnitude; f32 sums
# over up to 65,536 rows in another order than the plain version's
K3_RTOL = 1e-4
# autograd through the kernels vs the plain modules, per gradient against its
# max magnitude: the kernels sum in other orders and K1 uses |d| where the
# plain SetConv uses sqrt(d^2 + 1e-12)
GRAD_RTOL = 1e-4
# one train step, kernel path vs plain path on identical parameters and batch:
# loss relative, each parameter's gradient against its max magnitude (cuDNN's
# conv backward sums in no fixed order by default; the kernels sum in other
# orders than the plain path; train-mode BatchNorm magnifies both in its
# biases' gradients)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-3
# a gradient past its step bar (float32 STEP_GRAD_RTOL, bf16
# BF16_STEP_GRAD_RTOL) passes where the plain path, with the float32
# outputs of the modules the kernels replace rounded apart by about half an
# ulp, comes within the bar of the kernel path's in one of these draws
# (`rounding_grads`): on a trained unconditioned freq_ap model one decoder
# ReLU mask in 1,048,576 switched under such noise and moved the first
# SetConv's length-scale gradient by 2.6e-3 of itself, the plain path
# landing on either side (PERF.md, section 6); in bf16 half an ulp at K1's
# outputs alone moved k=37's context length-scale gradient by 0.282 of its
# largest value on the trained state where the kernel path sat 0.287 away
# (tests/chip_seed_spread.py, ROADMAP section 3.20)
ROUNDING_DRAWS = 8
# traces of one replay a launch count may take: in 82 traced replays, two
# runs of this script on an H100, the profiler left one launch out once (K1's 6.5 us
# context->grid launch of the freq_ap FiLM train step, whose ten graphed
# steps had just equalled the eager ones bit for bit) (PERF.md, section 6)
TRACE_TRIES = 3
# traces that record no kernel at all a replay may take on top: once, in one
# run of this script on an H100, three traces in a row of one graph (the
# additive bf16 training path's) listed no kernel of any kind, though the
# same graph's replay had traced in full a minute before (PERF.md, section
# 6); such a trace says nothing of the launches, so another is traced
EMPTY_TRACE_TRIES = 5
TRAIN_STEPS, TRAIN_BATCH = 500, 32
LONG_TRAIN_STEPS = 300  # the 2 s paths' graphed steps in phase 14
# the loss must fall: the median per-step loss over steps 251-500 at least 300
# nats below the median over steps 1-50. Whether it is also below 0 (as in the
# recorded JAX run, whose 50-step means over steps 251-500 are -53 to -257) is
# printed, not required: that depends on the initial draw, in the JAX package
# as in the port (PERF.md: of three JAX initial draws and of ten port draws on
# the H100, only some get there by step 500; the port's train step equals the
# JAX step to float32 rounding on identical batches).
LOSS_FALL_NATS = 300.0

BF16 = torch.bfloat16
# K2-bf16 and K3-bf16 against their plain versions: the bars of
# kernel_measure.py (K2_BF16_*, K3_BF16_*), which admit any order of the sums
# (tests/test_torch_bf16_order.py). K2-bf16: every output within 2^-6 of its
# absolute product sum, at most 1% differing. K3-bf16: dx within two bf16
# ulps of its row's largest magnitude, at most 2% differing; dW/db within
# 1e-2 of each one's max magnitude. The kernels sum on the tensor cores and
# again in the plain order where their sum leaves a rounding undecided, so
# they are expected to round as the plain version does (dW/db excepted: f32
# row sums in the tensor cores' order); the differences are printed.
PATH_NAMES = {1: "tensor cores", 2: "f32 FMA", -1: "refused"}
# bf16 scoring of the 2048 thetas against the float32 scoring with the same
# context draws, from the JAX package on the CPU (tests/jax_bf16_score_gap.py,
# op-by-op bf16, fused decoder): JAX's bf16 mean LL sits 0.576 nats below its
# float32 one, per-waveform differences with a standard deviation of 2.38
# (0.053 for a mean of 2048); its median mismatch moved by 1.4e-5. The port's
# gap must lie within 0.3 nats (5.7 of those standard errors) of JAX's, and
# its median mismatch move within 2e-4 (9% of the median, three times the
# largest move seen: 6.9e-5, the port's own bf16 against float32 on the CPU)
BF16_D_MEAN_LL, BF16_D_MEAN_LL_TOL = -0.576, 0.3
BF16_D_MEDIAN_MISMATCH = 2e-4
# the bf16 kernel path against the same path with every kernel replaced by
# its plain version, measured against the bf16-vs-float32 gap of the same
# batch, the bars of tests/test_torch_bf16_slice.py: the RMS distance of loc
# at most half the gap's RMS, the largest at most 3/4 of the gap's largest.
# K2-bf16 rounds as its plain version does (it sums again in the plain order
# where its tensor-core sums leave a rounding undecided); K1 and its plain
# version differ at float32 rounding, which moves a few bf16 roundings after
# it
BF16_PATH_RMS, BF16_PATH_MAX = 0.5, 0.75
# one bf16 train step, kernel path against the plain-kernel path: the bars
# of tests/test_torch_bf16_train.py (loss 1e-3 relative; each gradient 1e-1
# of its max magnitude)
BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL = 1e-3, 1e-1
# the train step captured in a CUDA graph against the eager step, from two
# trainers with the same init and generator seed: one step at the step bars
# above (the same kernels on the same inputs; cuDNN deterministic), then
# GRAPH_STEPS steps, each loss within 1e-4 relative (ROADMAP's 1e-5 a step,
# grown over ten steps)
GRAPH_STEPS, GRAPH_STEPS_LOSS_RTOL = 10, 1e-4
# graphed scoring against eager scoring of the same 2048 thetas with the same
# context draws, per waveform: LL 1e-4 absolute (about 1e-7 of the LL, a few
# float32 roundings), mismatch 1e-6 absolute (a few float32 roundings of the
# match, 1 - mismatch)
GRAPH_LL_ATOL, GRAPH_MISMATCH_ATOL = 1e-4, 1e-6
# the launches a call of each path makes, (K1, K2, K3, K2-bf16, K3-bf16) as
# `counts()` orders them
SCORE_CALL, SCORE16_CALL = (2, 1, 0, 0, 0), (2, 0, 0, 1, 0)
# phase 12 in bf16: each run's bf16-float32 mean LL gap on its 2048 recorded
# thetas with the same context draws within the larger of 0.3 nats and 3
# standard errors of JAX's own gap on the same thetas (its per-waveform
# differences' sd over the square root of the count it scored: 2048, or 256
# for a long run), from tests/jax_bf16_family_gaps.py (CPU, op-by-op bf16)
with open(os.path.join(ROOT, "tests", "jax_bf16_family_gaps.json")) as _f:
    BF16_GAPS = json.load(_f)
BF16_GAP_TOL, BF16_GAP_SES = 0.3, 3.0
# phase 14: the training paths of the other families, each the
# configuration its run recorded (learning rate, decay and clip included),
# trained at batch 32: (name, run, steps, seeds). Each draw prints the fall
# of its median loss from the first 50 steps to the last 50; at least one
# draw must fall by FAMILY_FALL nats, in float32 and in bf16 (PERF.md,
# section 6, stated before the first call from CPU rehearsals of
# seed 0, card draws of seeds 1-8 and the runs' histories). Whether a 1 s
# configuration falls within its steps depends on the draw: of eight card
# draws, the UnetCNN's loss rose over 1,000 steps in two, and additive
# conditioning fell 25-33 nats in two over 500 (its loss falls below 0
# within the first 50); the CPU rehearsals of seed 0 rose with k=37 and the
# UnetCNN. So the 1 s paths take seeds 0-2 and the sizes below; the 2 s
# paths fell 3,800-5,900 nats over 300 steps in each of six draws
# (name, run, (float32 steps, bf16 steps), seeds). The depths were cut to
# keep the call within its time once the image phases came in:
# each float32 path, and both dtypes of the latent paths (whose only kernel
# is K1, in float32 in either dtype), to the steps at which seed 0's
# 50-step means on the H100 in an earlier call had met their bars with room
# (1 s paths 300-500 of 500-1,000, dilated's kept, the 2 s paths 200 of
# 300, NPML and the
# unbounded scale 500 of 1,000, ELBO 300 of 1,000). The other bf16 paths
# keep the depths they had. Their kernel-path step is compared with the
# plain path on seed 0's trained model; at 300 steps the k=37 one differs
# by 0.287 of its largest context length-scale gradient (bar 0.1) on batch
# 4, the plain path's own rounding: half an ulp at K1's float32 outputs
# alone moves it by 0.282 there, while on the 11 other trained models and
# batches (seeds 0-2, 300 and 500 steps, batches 4 and 5) the worst leaf is
# 0.0064-0.0105 (tests/chip_seed_spread.py, one call on the H100; PERF.md
# section 7); `rounding_grads` now gives bf16 the float32 allowance for it.
# Cut again once the bf16 GP and image phases came in, each to a depth at
# which seed 0's 50-step means in the last call at the longer depth (the
# same code and seed: the shorter run is the longer one's first steps) had
# met its bars with room: additive bf16 1,000 -> 300 (fell 728 nats at
# 1,000, bar 150; its 50-step mean at steps 251-300 -182 from a first
# median of 478), UnetCNN 500 -> 300 (steps 251-300: 316 from 1,609, bar
# 300) and bf16 1,000 -> 500 (steps 451-500: 339 from 1,606), freq FiLM
# 500 -> 300 (-153 from 1,677, bar 500) and bf16 1,000 -> 500 (-212 from
# 1,557), long k37 bf16 300 -> 200 (steps 151-200: -701 from 4,038, bar
# 2,000), dilated bf16 500 -> 300 (steps 251-300: 579 from 1,489, bar 250),
# freq 500 -> 300 (289 from 844, bar 300), latent NPML bf16 500 -> 300
# (-251 from 432, bar 300, level -150), the unbounded scale 500 -> 300
# (-184 from 292, level -100); PERF.md section 6
FAMILY_SEEDS = (0, 1, 2)
FAMILY_RUNS = (
    ("additive", os.path.join(RESULTS, "GW_time_cond_ctx32", "ConvCNP", "run_0"), (300, 300),
     FAMILY_SEEDS),
    ("dilated", os.path.join(RESULTS, "GW_time_cond_film_ctx64_d128_dil1-1-2-4-8", "ConvCNP",
                             "run_0"), (500, 300), FAMILY_SEEDS),
    ("k37", os.path.join(RESULTS, "GW_time_cond_film_ctx64_d128_k37", "ConvCNP", "run_0"),
     (300, 500), FAMILY_SEEDS),
    ("unet", os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128_unet", "ConvCNP", "run_0"),
     (300, 500), FAMILY_SEEDS),
    ("long k37", os.path.join(RESULTS, "GW_time_cond_film_ctx1024_d512_k37_T2s_np2048_pallas",
                              "ConvCNP", "run_1"), (200, 200), (0,)),
    ("long unet", os.path.join(RESULTS, "GW_time_cond_film_ctx1024_d512_unet_T2s_np2048_pallas",
                               "ConvCNP", "run_0"), (200, LONG_TRAIN_STEPS), (0,)),
    # the frequency-domain configurations (phase 15)
    ("freq film", FREQ_FILM, (300, 500), FAMILY_SEEDS),
    ("freq", FREQ_UNCOND, (300, 1000), FAMILY_SEEDS),
    # the latent configurations (phase 16)
    ("latent npml", LATENT_NPML, (500, 300), FAMILY_SEEDS),
    ("latent elbo", LATENT_ELBO, (300, 300), FAMILY_SEEDS),
    ("latent latlbF", LATENT_LATLBF, (300, 500), FAMILY_SEEDS),
)
FAMILY_CLIP = 1.0  # the long runs' grad_clip_norm
FAMILY_FALL = {"additive": 150.0, "dilated": 250.0, "k37": 300.0, "unet": 300.0,
               "long k37": 2000.0, "long unet": 2000.0, "freq film": 500.0, "freq": 300.0,
               "latent npml": 300.0, "latent elbo": 300.0, "latent latlbF": 300.0}
# the latent paths' last 50 steps' median loss must also lie at or below a
# level, from the JAX runs' histories (50-step means: NPML -181.8 at step
# 100 and -373.0 at 1,000; ELBO -115.8 and -141.4; the unbounded scale
# -232.7 at 100, -269.1 at 500 and -222.6 at 1,000, not monotone): their
# first steps start from losses of 1e5-1e6 nats, so a fall alone says little
# (PERF.md, section 6, written before the first call)
FAMILY_LEVEL = {"latent npml": -150.0, "latent elbo": -100.0, "latent latlbF": -100.0}
TRAIN_CALL, TRAIN16_CALL = (2, 1, 1, 0, 0), (2, 0, 0, 1, 1)

# ---- the GP paths (phases 17-20): the 21 conv-family GP runs, 128 points a
# function on sorted x ~ U(-1, 1), the 192-point grid, U{0..50} contexts
GP_RUNS = tuple(gp_runs(RESULTS))
assert len(GP_RUNS) == 21, GP_RUNS
GP_CNP = os.path.join(RESULTS, "RBF_Kernel", "ConvCNP", "run_0")
GP_NPML = os.path.join(RESULTS, "RBF_Kernel", "ConvLNP", "run_0")
GP_ELBO = os.path.join(RESULTS, "RBF_Kernel", "ConvLNP_ELBOTrue_LatLBFalse_SigLBFalse", "run_0")
GP_NOTEBOOK = os.path.join(RESULTS, "RBF_Kernel", "ConvLNP_ELBOFalse_LatLBFalse_SigLBFalse",
                           "run_0")
# one run of each family: graphed scoring against eager, one batch on the
# kernel path against the plain path, one replay traced
GP_FAMILIES = {GP_CNP: "gp cnp", GP_NPML: "gp npml", GP_ELBO: "gp elbo"}
# the functions a kernel each GP run scores: 21 batches of 256, the fewest
# after whose first `score_run` replays a graph (GRAPH_MIN_REPLAYS), and
# more than the 4,992 (half the 9,984 JAX draws) whose mean its band's
# bootstrap was built for. Cut from the record's 9,984 to keep the call
# within its time once the bf16 phases came in: in the last call at
# 9,984, every one of the 78 runs lay within 0.41 of its band's half-width
# of the band's centre (PERF.md section 6)
GP_N_TEST, GP_POINTS, GP_CONTEXT = 5376, 128, 50
# each GP run's float32 per-function log-likelihoods from phases 19 and 21,
# which phase 30 takes as its float32 scores (the same functions, splits
# and draws: the same seed and count)
GP_F32_LL = {}
# phase 18: 4,096 functions of each kernel from one seed at one fixed x;
# each sample covariance entry within 6 of its standard errors of the
# kernel's (`data.gp.sample_covariance_z`; tests/test_torch_gp.py holds the
# CPU's draws to the same bar)
GP_MOMENT_N, GP_MOMENT_SES = 4096, 6.0
# phase 20: the three GP training configurations of reproduce_gp.py
# (its defaults: BatchNorm eps 1e-3, the intended init, Adam 1e-3 decaying
# x10 over 100 epochs of 1,562 steps, ConvLNP clipped at 1.0), 1,000
# graphed steps at batch 32 on RBF functions from seeds 0-2 (the later ones
# fallbacks); a draw meets its bars when its median loss over the last 50
# steps lies GP_FALL nats below its median over the first 50 and at or
# below GP_LEVEL. From the JAX package's own 1,000-step runs on the CPU
# (tests/jax_reference_training.py --gp, seed 0, the two ConvLNP with
# --banded; PERF.md section 6, written before the call): medians over the
# first and last 50 steps 172.23 -> 79.16 (ConvCNP; its 50-step means
# swing 62-318 on the way), 154.96 -> -48.92 (NPML) and 168.71 -> -23.95
# (notebook), so half each fall and each last median plus 50 nats
GP_TRAIN_STEPS = 1000
GP_TRAIN = (
    ("gp cnp", train_gp.train_summary("ConvCNP")),
    ("gp npml", train_gp.train_summary("ConvLNP")),
    ("gp notebook", train_gp.train_summary("ConvLNP", ablation="ELBOFalse_LatLBFalse_SigLBFalse")),
)
GP_FALL = {"gp cnp": 46.5, "gp npml": 101.9, "gp notebook": 96.3}
GP_LEVEL = {"gp cnp": 129.2, "gp npml": 1.1, "gp notebook": 26.0}
# the launches of one call of each GP path, (K1, K2, K3, K2-bf16, K3-bf16)
GP_SCORE_CALL = {"gp cnp": (2, 1, 0, 0, 0), "gp npml": (2, 0, 0, 0, 0),
                 "gp elbo": (3, 0, 0, 0, 0)}
GP_TRAIN_CALL = {"gp cnp": (2, 1, 1, 0, 0), "gp npml": (2, 0, 0, 0, 0),
                 "gp notebook": (2, 0, 0, 0, 0)}

# ---- the set and attention family's GP paths (phases 21-23): the 57 runs
# of CNP, LNP, AttnCNP and AttnLNP (the five kernels and All_Kernels, the
# LNP and AttnLNP ablation grids, LNP_SUMO); no SetConv, the decoder the
# MLP chain on the z draws folded into the rows: K2 in every forward, K3 in
# every step, at n_z x B x 128 rows
SET_RUNS = tuple(gp_set_runs(RESULTS))
assert len(SET_RUNS) == 57, SET_RUNS
SET_CNP, SET_LNP, SET_ATTNCNP, SET_ATTNLNP = (os.path.join(RESULTS, "RBF_Kernel", m, "run_0")
                                              for m in SET_MODELS)
# one run of each family checked in depth (as GP_FAMILIES)
SET_FAMILIES = {SET_CNP: "set cnp", SET_LNP: "set lnp", SET_ATTNCNP: "set attncnp",
                SET_ATTNLNP: "set attnlnp"}
SET_SCORE_CALL = (0, 1, 0, 0, 0)  # K2 once a scoring batch
# phase 23: the set family's training configurations of reproduce_gp.py
# (its defaults; CNP, LNP and AttnLNP with NPVI, AttnCNP; an NPML ablation
# variant, AttnLNP's at 8 draws; SUMO on LNP's NPML variant at 32 draws),
# 1,000 graphed steps at batch 32 on RBF functions from seed 0 (seeds 1-2
# fallbacks), held to bars from the JAX package's own 1,000-step runs on
# the CPU by phase 20's rule (tests/jax_reference_training.py --gp NAME,
# seed 0: half JAX's fall from the median over the first 50 steps to the
# median over the last 50, and a last median at or below JAX's plus 50
# nats; the medians in PERF.md section 6)
SET_TRAIN = (
    ("set cnp", train_gp.train_summary("CNP")),
    ("set lnp", train_gp.train_summary("LNP")),
    ("set attncnp", train_gp.train_summary("AttnCNP")),
    ("set attnlnp", train_gp.train_summary("AttnLNP")),
    ("set attnlnp npml", train_gp.train_summary("AttnLNP",
                                                ablation="ELBOFalse_LatLBFalse_SigLBFalse")),
    ("set lnp sumo", train_gp.train_summary("LNP", loss="sumo")),
)
# (JAX's median over the first 50 steps, over the last 50), seed 0
SET_JAX_MEDIANS = {"set cnp": (173.71, 143.69), "set lnp": (183.92, 158.24),
                   "set attncnp": (177.13, 69.02), "set attnlnp": (176.33, 50.83),
                   "set attnlnp npml": (169.18, 57.51), "set lnp sumo": (170.44, 144.19)}
GP_FALL.update({k: round((a - b) / 2, 1) for k, (a, b) in SET_JAX_MEDIANS.items()})
GP_LEVEL.update({k: round(b + 50.0, 1) for k, (a, b) in SET_JAX_MEDIANS.items()})
GP_TRAIN_CALL.update({name: (0, 1, 1, 0, 0) for name, _ in SET_TRAIN})

# ---- the grid and image family's paths (phases 24-28): the 20 scorable
# image runs (`run_report.img_runs`; zsmms/GridConvCNP/run_0 has no
# BatchNorm statistics, ROADMAP), K2 in every forward of GridConvCNP,
# GridConvCNPXL and the four point models and K3 in every step of them
# (GridConvLNP's decoder is a Dense), at B x H x W (x n_z) rows
IMG_RUNS = tuple(img_runs(RESULTS, scored=True))
assert len(IMG_RUNS) == 20, IMG_RUNS
IMG_ZSMMS = os.path.join(RESULTS, "zsmms", "GridConvCNP", "run_1")
IMG_XL = os.path.join(RESULTS, "rgb_digits128", "GridConvCNPXL", "run_0")
# one run of each family checked in depth: graphed scores against eager
# ones, a traced replay, one batch on the kernel path against the plain path
IMG_FAMILIES = {**{os.path.join(RESULTS, "digits", m, "run_0"): f"img {m.lower()}"
                   for m in ("GridConvCNP", "GridConvLNP", "CNP", "LNP", "AttnCNP", "AttnLNP")},
                IMG_ZSMMS: "img zsmms", IMG_XL: "img xl"}
# graphed against eager scoring, per image: within IMG_GRAPH_LL_RTOL of the
# image's |LL| (a few float32 roundings; the LLs reach 7e4 an image)
IMG_GRAPH_LL_RTOL = 3e-7
# zsmms_diag.py's four rows of zsmms/GridConvCNP/run_1 (the JAX package's
# draws, printed beside the port's)
with open(os.path.join(IMG_ZSMMS, "zsmms_diag.json")) as _f:
    IMG_DIAG_JAX = json.load(_f)
IMG_DIAG_ROWS = ("test_canvas", "train_canvas", "test_canvas_batchstats", "test_canvas_adapted")
# phase 28: reproduce_img.py's configurations trained from seed 0 (seeds 1-2
# fallbacks) for IMG_TRAIN_STEPS graphed steps at batch 32 (its defaults:
# 50 epochs of len(train) // 32 steps for the decay, clip 1.0), each held to
# a fall bar (half the JAX run's fall) and a level bar (the JAX run's last
# value plus a margin, below). CNP, LNP, and GridConvCNP on digits and on
# zsmms: the medians over the first and the last 50 of 300 steps of the
# JAX package's own run, the GP paths' rule (tests/jax_reference_training.py
# --img NAME [--dataset zsmms], seed 0, CPU; 7-9 s a GridConvCNP step on six
# threads). The others: GridConvLNP's 16 draws and the attention models'
# 1,024-point self-attention take a minute or more a JAX step here, so
# their bars come from their runs' own history.json, the 100-step means at
# steps 100 and 300 (200 for the attention models), against the port's own
# 100-step means (those runs decayed over 400 epochs, not 50: the learning
# rate at step 300 is 0.966 of the initial, not 0.76). The BatchNorm'd grid
# models blow up over their first steps, to 1e7-1e8 nats in the port and
# in the runs' histories (JAX's CPU zsmms run did not), and differently
# from call to call, so that their first window measures the blow-up, not
# training: their falls run from the second window on (the median over
# steps 101-150, the 100-step mean at step 200). PERF.md section 6,
# written before the call.
IMG_TRAIN_STEPS = 300
# (name, model, dataset, steps): the attention models 200 steps (a step
# takes 75-130 ms on the H100), their bars at history steps 100 and 200
IMG_TRAIN = (("img gridconvcnp", "GridConvCNP", "digits", IMG_TRAIN_STEPS),
             ("img gridconvlnp", "GridConvLNP", "digits", IMG_TRAIN_STEPS),
             ("img cnp", "CNP", "digits", IMG_TRAIN_STEPS),
             ("img lnp", "LNP", "digits", IMG_TRAIN_STEPS),
             ("img attncnp", "AttnCNP", "digits", 200), ("img attnlnp", "AttnLNP", "digits", 200),
             ("img zsmms", "GridConvCNP", "zsmms", IMG_TRAIN_STEPS),
             ("img rgb", "GridConvCNP", "rgb_digits", IMG_TRAIN_STEPS))
# (statistic, JAX's first value, JAX's last value): "median50" the medians
# over the first 50 steps and the last 50, "median101" over steps 101-150
# and the last 50, "mean100" the first and the last 100-step means,
# "mean200" the 100-step means at steps 200 and 300
IMG_JAX = {"img cnp": ("median50", -6.05, -231.85),
           "img lnp": ("median50", 112.15, -236.18),
           "img gridconvcnp": ("median101", 275.55, -175.56),
           "img gridconvlnp": ("mean200", 6.2, -224.8),
           "img attncnp": ("mean100", 29.0, -171.1),
           "img attnlnp": ("mean100", -0.7, -170.7),
           "img zsmms": ("median101", 359.86, -23.01),
           "img rgb": ("mean200", -1245.2, -1862.8)}
# the last values by each bar's statistic of the port's own seeds 0, 1 and
# 2 (tests/chip_seed_spread.py, one call on the H100, PERF.md
# section 6) and of JAX's where its CPU runs are cheap enough
# (tests/jax_reference_training.py --img NAME --seed S, S = 0-2): the
# level bar's margin is twice the larger range of the two, but at most
# half JAX's fall, so that each level bar lies at least half JAX's fall
# below JAX's first value
IMG_SEED_LAST = {"img cnp": ((-310.26, -299.95, -285.67), (-231.85, -360.25, -224.66)),
                 "img lnp": ((-205.98, -173.76, -262.27), (-236.18, -182.06, -257.07)),
                 "img gridconvcnp": ((-335.9, -10.05, -109.22), ()),
                 "img gridconvlnp": ((-416.59, -545.54, -308.07), ()),
                 "img attncnp": ((-189.89, 102.52, -105.24), ()),
                 "img attnlnp": ((-109.88, -98.03, -142.19), ()),
                 "img zsmms": ((-20.85, 56.9, -40.97), ()),
                 "img rgb": ((-2412.73, -1690.59, -2254.98), ())}
IMG_FALL = {k: round((a - b) / 2, 1) for k, (_, a, b) in IMG_JAX.items()}
IMG_LEVEL = {k: round(b + min(2 * max(max(v) - min(v) for v in IMG_SEED_LAST[k] if v),
                               (a - b) / 2), 1)
             for k, (_, a, b) in IMG_JAX.items()}
assert all(IMG_LEVEL[k] < a for k, (_, a, _) in IMG_JAX.items())
# GridConvCNPXL on rgb_digits128: 8 graphed steps with the blocks'
# activations stored, 3 rematerialised (the peak memory and step time of
# each; no bar reads the losses but their finiteness, so the steps were cut
# to keep the call within its time)
IMG_XL_STEPS, IMG_XL_REMAT_STEPS = 8, 3

# ---- bfloat16 for the GP and image families (phases 29-32): the 21 bar
# runs (`run_report.GP_BF16_BARS`: RBF and Matern ConvCNP, ConvLNP, CNP,
# LNP, AttnCNP and AttnLNP, and the ELBO ConvLNP ablation run;
# `IMG_BF16_BARS`: the six digits runs, zsmms GridConvCNP run_1 and the XL
# run_0), each scored in bf16 and in float32 on the same functions or
# images, its bf16-float32 mean-LL gap held by phase 12's rule to the JAX
# package's own gap with the fused MLP-chain decoder (`bf16_gap_bar`: within
# the larger of BF16_GAP_TOL nats and BF16_GAP_SES standard errors;
# tests/jax_bf16_family_gaps.py --gp-bf16 / --img-bf16, CPU, op by op, the
# count it took in its entry), JAX's Dense-decoder gap printed beside. The
# standard error is that of the difference of the two gaps, JAX's and the
# port's own: the port scores its own draws (5,376 GP functions; each test
# image under IMG_BF16_PASSES context masks, 1,280 draws of the 160 digits
# images; the two slow models fewer), and on the 160 images alone its
# noise would match JAX's
IMG_BF16_PASSES = {"GridConvLNP": 4, "GridConvCNPXL": 2}
IMG_BF16_PASSES_DEFAULT = 8
GP_BF16_RUNS = tuple(gp_bf16_bar_runs(RESULTS))
IMG_BF16_RUNS = tuple(img_bf16_bar_runs(RESULTS))
assert len(GP_BF16_RUNS) + len(IMG_BF16_RUNS) == 21
assert all("bf16_gap" in BF16_GAPS[os.path.relpath(r, RESULTS)]
           for r in GP_BF16_RUNS + IMG_BF16_RUNS)
# one run of each family in depth (the float32 phases' family runs, all bar
# runs): graphed against eager, a traced replay, one batch on the kernel
# path against the plain-kernel path
BF16_FAMILIES = {**GP_FAMILIES, **SET_FAMILIES, **IMG_FAMILIES}
assert set(BF16_FAMILIES) <= set(GP_BF16_RUNS + IMG_BF16_RUNS)
# phase 32: nine training paths in bf16 at their float32 paths' depths,
# seeds and bars (`GP_FALL`, `GP_LEVEL`, `IMG_FALL`, `IMG_LEVEL`), as
# `FAMILY_FALL` holds both dtypes of the GW families
GP16_TRAIN = tuple((n, s) for n, s in GP_TRAIN + SET_TRAIN
                   if n in ("gp cnp", "gp npml", "set cnp", "set lnp", "set attncnp",
                            "set attnlnp"))
IMG16_TRAIN = tuple(t for t in IMG_TRAIN if t[0] in ("img gridconvcnp", "img cnp", "img lnp"))

# phases 33-36, the evaluation tools: the JAX package's own per-function and
# per-waveform values of `experiments/eval_extrapolation.py` and
# `experiments/gw_eval_ctx.py` on their own draws, and their bands
# (tests/jax_eval_bands.py: `run_report.bands_of`'s rule at half the count)
# the device mesh (phases 37-38): bench.py's flagship at its batch of 256;
# each check's graphed steps against eager ones, and the steps a mesh path
# runs against one process's; loss traces at the JAX package's own mesh
# bar (tests/test_training.py:130); two gloo ranks on the card, their
# launch's deadline
MESH_BATCH, MESH_STEPS, MESH_GRAPH_CHECK = 256, 20, 3
MESH_TRACE_RTOL = 2e-4
GLOO_STEPS, GLOO_LONG_BATCH, RANKS_S = 5, 32, 300
# phase 38's image cases: digits GridConvCNP (BatchNorm over the data axis)
# at train_img.py's batch of 32, its blocks stored and recomputed in the
# backward pass; ROW_ORDERS orders of one process's rows give its own spread
GLOO_IMG_RUN, GLOO_IMG_BATCH = os.path.join(RESULTS, "digits", "GridConvCNP", "run_0"), 32
ROW_ORDERS = 8
EVAL_BANDS_JSON = os.path.join(ROOT, "tests", "jax_eval_bands.json")
EXTRAP_KERNELS = ("RBF_Kernel", "Periodic_Kernel")
EXTRAP_N = 2560  # the records' count: ten batches of 256 a model, eager
EXTRAP_MODELS = extrap.MODELS[1:]
# the launches of one extrapolation batch (K1, K2, K3, K2-bf16, K3-bf16):
# the set family's decoder is the chain, ConvCNP's too with two SetConvs,
# ConvLNP's decoder is linear
EXTRAP_CALL = {"CNP": (0, 1, 0, 0, 0), "LNP": (0, 1, 0, 0, 0), "AttnCNP": (0, 1, 0, 0, 0),
               "AttnLNP": (0, 1, 0, 0, 0), "ConvCNP": (2, 1, 0, 0, 0), "ConvLNP": (2, 0, 0, 0, 0)}
# the statistics each row is held by: both means; the heavy-tailed
# extrapolation rows (RBF AttnLNP's std 152,899 in the record, Periodic
# CNP's 12,328) by their medians too; the oracle's interpolation mean is an
# ill-conditioned float32 solve (the record's -2,002.70, std 24,177; JAX on
# the CPU gives +251 on the same draws), so its median is held instead and
# its mean printed; cuSOLVER rounds those solves otherwise again
EXTRAP_HELD = {("RBF_Kernel", "oracle_gp"): (("interp", "median"), ("extrap", "mean")),
               ("RBF_Kernel", "AttnLNP"): (("interp", "mean"), ("extrap", "mean"),
                                           ("extrap", "median")),
               ("Periodic_Kernel", "CNP"): (("interp", "mean"), ("extrap", "mean"),
                                            ("extrap", "median"))}
EXTRAP_HELD_DEFAULT = (("interp", "mean"), ("extrap", "mean"))
# the run scored on the plain-kernel path as well (one batch), per function
# within the CPU tests' bar (1e-4 of the LL plus 0.02 nats)
EXTRAP_PLAIN = ("RBF_Kernel", "ConvCNP")
SWEEP_N = 1024  # the records' count: four batches of 256 a count, eager
SWEEP_CALL = (2, 1, 0, 0, 0)  # a GW ConvCNP scoring batch
# StepTimer, a synchronize after each replay, against CUDA events around the
# same number of replays
TOOL_REPLAYS, TOOL_TIMER_RTOL = 20, 0.10


def img_call(model: str) -> tuple:
    """The launches (K1, K2, K3, K2-bf16, K3-bf16) of one scoring batch of an
    image model: K2 once, none for GridConvLNP (a Dense decoder)."""
    return (0, 0, 0, 0, 0) if model == "GridConvLNP" else (0, 1, 0, 0, 0)


def img_train_call(model: str) -> tuple:
    """The launches of one image train step: K2 and K3 once, none for
    GridConvLNP."""
    return (0, 0, 0, 0, 0) if model == "GridConvLNP" else (0, 1, 1, 0, 0)


_T0 = time.perf_counter()


def path_call(summary: dict, bf16: bool, train: bool) -> tuple:
    """The launches (K1, K2, K3, K2-bf16, K3-bf16) one call of a path makes:
    a train step (`train`) or a scoring batch of the configuration
    `summary` in bf16 or float32. A ConvLNP path launches K1 only (its
    decoder is linear), twice, or three times where the ELBO encodes the
    targets (in training and, since its eval forward sees them, in scoring)."""
    if summary["model"] == "ConvLNP":
        return (3 if summary.get("train_loss_objective") == "elbo" else 2, 0, 0, 0, 0)
    if train:
        return TRAIN16_CALL if bf16 else TRAIN_CALL
    return SCORE16_CALL if bf16 else SCORE_CALL


def phase(name: str) -> None:
    """Announce a phase, with the card memory PyTorch holds when it starts."""
    mem = (f"; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
           f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved"
           if torch.cuda.is_available() and torch.cuda.is_initialized() else "")
    print(f"== {name} (t={time.perf_counter() - _T0:.1f}s{mem})", flush=True)


# the records' bands, printed beside each GP and image rescoring
# (`run_report.gp_band`: a 10,000-resample bootstrap, about a second of host
# time a run), computed on host threads while the card works (`main`)
RECORD_BANDS = {}


def record_band(run_dir) -> tuple:
    """`gp_band(run_dir)`, from `RECORD_BANDS` where `main` started it."""
    band = RECORD_BANDS.get(run_dir)
    return gp_band(run_dir) if band is None else band.result()


def release() -> None:
    """Free what dropped CUDA graphs and their pools hold: a capture here
    does not collect garbage or empty the allocator's cache first, as
    `torch.cuda.graph` does (`utils.cuda_graph.StepGraph.capture`)."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def chain_weights(mlp) -> tuple:
    """(w0, b0, wh, bh, wout, bout) of a decoder MLP of three hidden-to-hidden
    layers, detached and contiguous: the chain K2 and K3 take."""
    hidden = [mlp.linear_0, mlp.linear_1, mlp.linear_2]
    with torch.no_grad():
        return tuple(t.detach().contiguous() for t in (
            mlp.to_hidden.weight, mlp.to_hidden.bias,
            torch.stack([h.weight for h in hidden]), torch.stack([h.bias for h in hidden]),
            mlp.out.weight, mlp.out.bias))


def check_k1(cases):
    rows = []
    for name, args in cases:
        keys, queries, values, mask, sig = args
        B, K = keys.shape
        Q, C = queries.shape[1], values.shape[-1]
        s_k, d_k = setconv_exprbf_fwd(*args)
        s_k2, d_k2 = setconv_exprbf_fwd(*args)
        s_p, d_p = setconv_exprbf_plain(*args)
        torch.cuda.synchronize()
        same = torch.equal(s_k, s_k2) and torch.equal(d_k, d_k2)
        sig_err = (s_k - s_p).abs().max().item()
        den_rel = ((d_k - d_p).abs() / (d_p.abs() + 1e-30)).max().item()
        empty = mask.sum(-1) == 0
        empty_ok = bool((s_k[empty] == 0).all() and (d_k[empty] == 0).all()) if empty.any() else True
        finite = bool(torch.isfinite(s_k).all() and torch.isfinite(d_k).all())
        print(f"K1 {name}: B={B} K={K} Q={Q} C={C} signal max abs err {sig_err:.3e}, "
              f"density max rel err {den_rel:.3e}, empty rows zero {empty_ok}; repeat "
              f"bit-identical {same}")
        if not (finite and empty_ok and sig_err <= K1_SIGNAL_ATOL and den_rel <= K1_DENSITY_RTOL):
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"K1 {name}: two launches on the same inputs differ")
        ms = time_ms(lambda: setconv_exprbf_fwd(*args))
        plain_ms = time_ms(lambda: setconv_exprbf_plain(*args), reps=5)
        bms, by = k1_bound(keys, queries, values, mask)
        rows.append(dict(shape=name, B=B, K=K, Q=Q, C=C, max_abs_err=sig_err,
                         density_max_rel_err=den_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def check_k2(cases):
    rows = []
    for name, args, is_res in cases:
        x, w0, _, wh, _, wout, _ = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        o_k = fused_relu_mlp(*args, is_res=is_res)
        o_k2 = fused_relu_mlp(*args, is_res=is_res)
        o_p = fused_relu_mlp_plain(*args, is_res=is_res)
        torch.cuda.synchronize()
        same = torch.equal(o_k, o_k2)
        err = (o_k - o_p).abs().max().item()
        scale = o_p.abs().max().item()
        finite = bool(torch.isfinite(o_k).all())
        print(f"K2 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} "
              f"max abs err {err:.3e} (output max {scale:.3e}); repeat bit-identical {same}")
        if not (finite and err <= K2_RTOL * scale):
            raise AssertionError(f"K2 {name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"K2 {name}: two launches on the same inputs differ")
        ms = time_ms(lambda: fused_relu_mlp(*args, is_res=is_res))
        plain_ms = time_ms(lambda: fused_relu_mlp_plain(*args, is_res=is_res))
        bms, by = k2_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def check_k3(cases):
    rows = []
    names = ("dx", "dw0", "db0", "dwh", "dbh", "dwout", "dbout")
    for name, args, is_res in cases:
        x, g, w0, b0, wh, bh, wout = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        out_k = fused_relu_mlp_bwd(*args, is_res=is_res)
        out_k2 = fused_relu_mlp_bwd(*args, is_res=is_res)
        out_p = fused_relu_mlp_bwd_plain(*args, is_res=is_res)
        torch.cuda.synchronize()
        rel = {}
        for n, a, b in zip(names, out_k, out_p):
            if b.numel():
                rel[n] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        finite = all(bool(torch.isfinite(t).all()) for t in out_k)
        worst = max(rel, key=rel.get)
        print(f"K3 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} biases={b0 is not None} "
              f"max err / max magnitude {rel[worst]:.3e} ({worst}); repeat bit-identical {same}")
        if not (finite and same and rel[worst] <= K3_RTOL):
            raise AssertionError(f"K3 {name} disagrees with its plain version or is not repeatable")
        ms = time_ms(lambda: fused_relu_mlp_bwd(*args, is_res=is_res))
        plain_ms = time_ms(lambda: fused_relu_mlp_bwd_plain(*args, is_res=is_res))
        bms, by = k3_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, max_abs_err=rel[worst], ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


@contextlib.contextmanager
def plain_kernels():
    """Inside, the autograd Functions reach each kernel's plain version in
    place of its wrapper (on CUDA tensors too): the reference path of the
    kernel-path checks, at the kernels' own rounding points."""
    saved = (setconv.setconv_exprbf_fwd, mlp_chain.fused_relu_mlp, mlp_chain.fused_relu_mlp_bwd)
    setconv.setconv_exprbf_fwd = setconv.setconv_exprbf_plain
    mlp_chain.fused_relu_mlp = mlp_chain.fused_relu_mlp_plain
    mlp_chain.fused_relu_mlp_bwd = mlp_chain.fused_relu_mlp_bwd_plain
    try:
        yield
    finally:
        setconv.setconv_exprbf_fwd, mlp_chain.fused_relu_mlp, mlp_chain.fused_relu_mlp_bwd = saved


def check_k2_bf16(cases):
    rows = []
    for name, args, is_res in cases:
        x, w0, _, wh, _, wout, _ = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        call = lambda: fused_relu_mlp(*args, is_res=is_res, compute_dtype=BF16)  # noqa: E731
        path = _build.lib().npf_mlp_chain_fwd_bf16_path(M, C, H, L1, O)
        if name.startswith("decoder") and path != 1:
            raise AssertionError(f"K2-bf16 {name}: the decoder's shape takes the "
                                 f"{PATH_NAMES[path]} path, not the tensor cores")
        if path < 0:
            before = fused_relu_mlp.launches_bf16
            try:
                call()
            except ValueError as e:
                print(f"K2-bf16 {name}: M={M} C={C} H={H}: refused before any launch ({e})")
            else:
                raise AssertionError(f"K2-bf16 {name}: widths past its shared memory not refused")
            if fused_relu_mlp.launches_bf16 != before:
                raise AssertionError(f"K2-bf16 {name}: a refused call launched")
            continue
        o_k, o_k2 = call(), call()
        torch.cuda.synchronize()
        same = torch.equal(o_k, o_k2)
        rel, share = k2_bf16_report(o_k, *args, is_res=is_res)
        o_p = fused_relu_mlp_plain(*args, is_res=is_res, compute_dtype=BF16)
        err = (o_k.float() - o_p.float()).abs().max().item()
        finite = bool(torch.isfinite(o_k.float()).all()) and o_k.dtype == BF16
        print(f"K2-bf16 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} path "
              f"{PATH_NAMES[path]}: max |err| / s {rel:.3e} (bar {K2_BF16_SUM_TOL:.3e}), "
              f"{share:.2e} of elements differ; repeat bit-identical {same}")
        if not (finite and k2_bf16_ok((rel, share))):
            raise AssertionError(f"K2-bf16 {name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"K2-bf16 {name}: two launches on the same inputs differ")
        ms = time_ms(call)
        plain_ms = time_ms(lambda: fused_relu_mlp_plain(*args, is_res=is_res, compute_dtype=BF16),
                           reps=2, warmup=1)
        cublas_ms = cublas_chain_ms(*args, is_res=is_res) if name.startswith("decoder") else None
        bms, by = k2_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, path=PATH_NAMES[path],
                         max_abs_err=err, max_rel_sum=rel, share_differing=share, ms=ms,
                         plain_ms=plain_ms, cublas_chain_ms=cublas_ms, bound_ms=bms,
                         bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
              + (f", bf16 cuBLAS chain {cublas_ms:.4f} ms" if cublas_ms is not None else ""))
    return rows


def check_k3_bf16(cases):
    rows = []
    for name, args, is_res in cases:
        x, g, w0, b0, wh, bh, wout = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        call = lambda: fused_relu_mlp_bwd(*args, is_res=is_res, compute_dtype=BF16)  # noqa: E731
        path = _build.lib().npf_mlp_chain_bwd_bf16_path(M, C, H, L1, O)
        if name.startswith("decoder") and path != 1:
            raise AssertionError(f"K3-bf16 {name}: the decoder's shape takes the "
                                 f"{PATH_NAMES[path]} path, not the tensor cores")
        out_k, out_k2 = call(), call()
        out_p = fused_relu_mlp_bwd_plain(*args, is_res=is_res, compute_dtype=BF16)
        torch.cuda.synchronize()
        rep = k3_bf16_report(out_k, out_p)
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in out_k)
        print(f"K3-bf16 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} biases="
              f"{b0 is not None} path {PATH_NAMES[path]}: dx max {rep['dx_ulps']:.2f} ulps of "
              f"its row's max, {rep['dx_share']:.2e} of elements differ; dW/db worst "
              f"{rep['dw_rel']:.3e} ({rep['dw_worst']}); repeat bit-identical {same}")
        if not (finite and same and out_k[0].dtype == BF16 and k3_bf16_ok(rep)):
            raise AssertionError(f"K3-bf16 {name} disagrees with its plain version or is not "
                                 "repeatable")
        ms = time_ms(call)
        plain_ms = time_ms(lambda: fused_relu_mlp_bwd_plain(*args, is_res=is_res,
                                                            compute_dtype=BF16),
                           reps=2, warmup=1)
        cublas_ms = (cublas_chain_ms(x, w0, b0, wh, bh, wout, None, is_res, g=g)
                     if name.startswith("decoder") else None)
        bms, by = k3_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, path=PATH_NAMES[path],
                         max_abs_err=rep["dw_rel"], dx_max_ulps=rep["dx_ulps"],
                         dx_share_differing=rep["dx_share"], ms=ms, plain_ms=plain_ms,
                         cublas_chain_ms=cublas_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
              + (f", bf16 cuBLAS chain {cublas_ms:.4f} ms" if cublas_ms is not None else ""))
    return rows


def _grad_errs(pairs):
    """{name: max |a - b| / max |b|} over pairs of gradients."""
    return {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for n, a, b in pairs}


def check_autograd(model, gen):
    """A SetConv through K1 and the decoder MLP through K2 and K3 against the
    plain modules, same weights and inputs, at the training shapes."""
    B, n_trgt = TRAIN_BATCH, 256
    n_ind = model.n_induced
    errs = {}
    for name, src in (("ctx->grid", model.cntxt_to_induced), ("grid->trgt", model.induced_to_trgt)):
        c_in = src.resizer.in_features - 1
        kern = copy.deepcopy(src).train()
        plain = copy.deepcopy(src).train()
        kern.use_kernel, plain.use_kernel = True, False
        grid = linspace(-1.5, 1.5, n_ind, device="cuda")[None, :, None].expand(B, n_ind, 1)
        trgt = linspace(-1.0, 1.0, n_trgt, device="cuda")[None, :, None].expand(B, n_trgt, 1)
        keys, queries = (trgt, grid) if name == "ctx->grid" else (grid, trgt)
        K = keys.shape[1]
        mask = torch.ones((B, K), dtype=torch.bool, device="cuda")
        if name == "ctx->grid":  # about half the points, and an empty context
            mask = torch.rand((B, K), generator=gen, device="cuda") < 0.5
            mask[0] = False
        values = torch.randn((B, K, c_in), generator=gen, device="cuda")
        g_out = torch.randn((B, queries.shape[1], src.resizer.out_features), generator=gen,
                            device="cuda")
        grads = []
        for m in (kern, plain):
            v = values.clone().requires_grad_()
            (m(keys, queries, v, mask) * g_out).sum().backward()
            grads.append({"values": v.grad, "length_scale": m.rbf.length_scale_param.grad,
                          "resizer.weight": m.resizer.weight.grad,
                          "resizer.bias": m.resizer.bias.grad})
        errs.update({f"SetConv {name} d{k}": v for k, v in _grad_errs(
            (k, grads[0][k], grads[1][k]) for k in grads[0]).items()})
    dec = model.decoder.module
    kern, plain = copy.deepcopy(dec), copy.deepcopy(dec)
    kern.fused, plain.fused = True, False
    r = torch.randn((1, B, n_trgt, dec.to_hidden.in_features), generator=gen, device="cuda")
    g_loc, g_scale = (torch.randn((1, B, n_trgt, 1), generator=gen, device="cuda")
                      for _ in range(2))
    grads = []
    for m in (kern, plain):
        x = r.clone().requires_grad_()
        loc, raw = m(x).split(1, dim=-1)  # strided cotangents, as in decode()
        ((loc * g_loc).sum() + (torch.nn.functional.softplus(raw) * g_scale).sum()).backward()
        grads.append({"input": x.grad, **{n: p.grad for n, p in m.named_parameters()}})
    errs.update({f"decoder d{k}": v for k, v in _grad_errs(
        (k, grads[0][k], grads[1][k]) for k in grads[0]).items()})
    torch.cuda.synchronize()
    worst = max(errs, key=errs.get)
    print(f"autograd, kernels vs plain: {len(errs)} gradients, worst {errs[worst]:.3e} ({worst})")
    for k, v in errs.items():
        print(f"   {k}: {v:.3e}")
    if errs[worst] > GRAD_RTOL:
        raise AssertionError(f"autograd through the kernels disagrees with the plain path: {worst}")
    return errs


def _bn_cancelled(name):
    """conv1's biases in a BatchNorm block add a per-channel constant that the
    next train-mode BatchNorm subtracts: their gradient is zero in exact
    arithmetic, rounding noise in practice."""
    return ".conv1." in name and name.endswith(".bias")


def _step_grad_errs(grads, ref):
    """({parameter: max |g - ref| / max |ref|} but the BatchNorm-cancelled
    biases, {cancelled bias: the larger of its two gradients' max magnitudes
    over its block's conv1.pointwise weight gradient's}). A block whose
    weight gradient is exactly zero on the reference path holds its biases
    to zero too: 0 where both are zero, else far past any bar. (After
    1,000 ELBO steps nothing before the latent encoder gets a gradient: the
    recorded ELBO run's latent encoder has all its hidden ReLUs off, so
    q(z|C) = q(z|C,T) no longer depends on the data.)"""
    errs = _grad_errs((n, grads[n], ref[n]) for n in ref if not _bn_cancelled(n))
    zero = {}
    for n in filter(_bn_cancelled, ref):
        scale = ref[n.rsplit(".", 2)[0] + ".pointwise.weight"].abs().max().clamp_min(1e-30)
        zero[n] = (max(grads[n].abs().max(), ref[n].abs().max()) / scale).item()
    return errs, zero or {"(a model without BatchNorm)": 0.0}


def check_train_step(model, summary, gen, dtype=None, term_scale=False, build=None, data=None,
                     build32=None):
    """One train step on the kernel path against one on the plain path, on
    copies with identical parameters and one identical split batch. Each
    parameter's gradient is held to the step's gradient bar of its max
    magnitude; the conv1 biases of the BatchNorm blocks, whose gradient is
    zero in exact arithmetic, are held on both paths below that bar of the
    max magnitude of their block's conv1.pointwise weight gradient. In
    float32 the plain path is the model without kernels (`use_kernels=False`);
    in bf16 (`dtype`) it is the kernel path with every kernel replaced by its
    plain version, since the Dense decoder rounds elsewhere than the chain.
    With `term_scale` the loss is held relative to the larger of its
    magnitude and its terms' (the batch mean of each waveform's summed
    |log-prob|, the plain path's): a float32 sum's rounding scales with its
    terms, and a trained model's loss can lie near 0 with terms of
    thousands of nats. In bf16 the loss may then instead lie within
    `BF16_PATH_MAX` of the bf16-float32 gap of the same step (the float32
    kernel path's loss on the same parameters and batch), the bar the bf16
    scoring paths are held to: the two paths differ only where K1 and its
    plain version round their float32 sums apart, which moves later bf16
    roundings, and on the 2 s UnetCNN path that alone moved the loss by
    1.09e-3 of its terms. In either dtype a gradient past its bar is
    accepted where the plain path reaches it (within the bar) itself when
    the modules the kernels replace round apart (`rounding_grads`): a
    discrete switch at a rounding boundary that either path may take (in
    bf16, K1's float32 outputs rounded apart by half an ulp moved the k=37
    path's context length-scale gradient 0.282 of its largest value on the
    trained state where the kernel path sat 0.287 from the plain one: ROADMAP
    section 3.20). `build(use_kernels)` and `data` (x, y, cond) give another
    family's trainer and batch (the GP and image paths'; `build32()` their
    float32 kernel-path trainer for the bf16 gap); by default the GW run's
    (`train_gw.build_trainer`, fresh waveforms drawn from `gen`)."""
    bf16 = dtype is not None
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL) if bf16
                            else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
    if build is None:
        def build(use_kernels):
            return train_gw.build_trainer(summary, 1, "cuda", use_kernels=use_kernels, dtype=dtype)
        space, wave = GWParameterSpace(), run_generator(summary)
        theta = space.sample(TRAIN_BATCH, gen)
        x, y, cond = make_eval_batch(theta, wave, space, summary.get("n_points", 256),
                                     summary.get("mode", "time"))
        cond = cond if summary["conditioned"] else None
    else:
        x, y, cond = data
    batch = None
    res = {}
    for label in ("kernel", "plain"):
        trainer = build(label == "kernel" or bf16)
        trainer.model.load_state_dict(model.state_dict())
        if batch is None:
            batch = trainer.splitter(gen, x, y, condition=cond)
        with plain_kernels() if bf16 and label == "plain" else contextlib.nullcontext():
            loss = trainer.loss_and_grads(batch)
            if label == "plain" and term_scale:
                with torch.no_grad():
                    log_p = trainer._forward(batch).p_yCc.log_prob(batch["Y_trgt"])
                scale = torch.maximum(loss.abs(), log_p.abs().sum(dim=-1).mean())
        res[label] = (loss, {n: p.grad for n, p in trainer.model.named_parameters()})
    gap = None
    if bf16 and term_scale:
        trainer = build32() if build32 is not None else train_gw.build_trainer(summary, 1, "cuda")
        trainer.model.load_state_dict(model.state_dict())
        gap = abs(trainer.loss_and_grads(batch) - res["plain"][0]).item()
    torch.cuda.synchronize()
    (loss_k, grads_k), (loss_p, grads_p) = res["kernel"], res["plain"]
    loss_rel = (abs(loss_k - loss_p) / (scale if term_scale else abs(loss_p))).item()
    loss_ok = loss_rel <= loss_rtol or (
        gap is not None and abs(loss_k - loss_p).item() <= BF16_PATH_MAX * gap)
    errs, zero = _step_grad_errs(grads_k, grads_p)
    over = [n for n, e in errs.items() if e > grad_rtol]
    if over:
        draws = rounding_grads(summary, model.state_dict(), batch, over, lambda: build(bf16),
                               bf16)
        for n in over:
            scale = grads_p[n].abs().max().clamp_min(1e-30)
            reach = min((grads_k[n] - d[n]).abs().max() for d in draws) / scale
            spread = max((d[n] - grads_p[n]).abs().max() for d in draws) / scale
            print(f"   {n}: {errs[n]:.3e} of its max magnitude from the plain path; the plain "
                  f"path with its kernels' modules rounded apart ({ROUNDING_DRAWS} draws) "
                  f"spreads {spread.item():.3e} and comes within {reach.item():.3e} of the "
                  "kernel path")
            errs[n] = reach.item()
    worst, worst_zero = max(errs, key=errs.get), max(zero, key=zero.get)
    print(f"train step{' (bf16)' if bf16 else ''}, kernel vs plain path: loss "
          f"{loss_k.item():.4f} vs {loss_p.item():.4f} (rel {loss_rel:.3e}"
          f"{f' of its terms, {scale.item():.1f}' if term_scale else ''}"
          f"{f'; bf16-float32 gap {gap:.4f}' if gap is not None else ''}); {len(errs)} parameter "
          f"gradients, worst {errs[worst]:.3e} of its max magnitude ({worst}); {len(zero)} "
          f"BatchNorm-cancelled biases, largest {zero[worst_zero]:.3e} of their weight's "
          f"gradient ({worst_zero})")
    if not (loss_ok and errs[worst] <= grad_rtol and zero[worst_zero] <= grad_rtol):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    return loss_rel, errs[worst]


def rounding_grads(summary, state, batch, names, build=None, bf16=False) -> list:
    """The plain path's gradients of the parameters `names` on `batch` from
    the model state `state`, once for each of `ROUNDING_DRAWS` draws, with
    the float32 outputs of the modules the kernels replace multiplied by 1
    + 2^-24 n, n standard normal: each output rounded apart by about half an
    ulp, as a kernel that sums in another order rounds it. In float32 these
    are the outputs of both SetConvs and the decoder (a set or attention
    model: its decoder); in bf16 (`bf16`: the kernel path's model with each
    kernel's plain version, `plain_kernels`) K1's float32 outputs, the only
    float32 outputs a kernel there computes (K2-bf16 rounds as its plain
    version does). `build()` gives the plain path's trainer (default
    `train_gw.build_trainer`'s float32 one without kernels)."""
    noise = torch.Generator(device="cuda").manual_seed(0)
    if build is None:
        def build():
            return train_gw.build_trainer(summary, 1, "cuda", use_kernels=False)

    def round_apart(module, inputs, out):
        return out * (1.0 + 2.0 ** -24 * torch.randn(out.shape, generator=noise,
                                                      device=out.device))

    def k1_rounded(*args):
        return tuple(round_apart(None, None, t) for t in setconv_exprbf_plain(*args))

    draws = []
    for _ in range(ROUNDING_DRAWS):
        trainer = build()
        trainer.model.load_state_dict(state)
        m = trainer.model
        hooks = [] if bf16 else [getattr(m, name).register_forward_hook(round_apart)
                                 for name in ("cntxt_to_induced", "induced_to_trgt", "decoder")
                                 if isinstance(getattr(m, name, None), torch.nn.Module)]
        with plain_kernels() if bf16 else contextlib.nullcontext():
            if bf16:  # plain_kernels restores the wrapper
                setconv.setconv_exprbf_fwd = k1_rounded
            trainer.loss_and_grads(batch)
        for h in hooks:
            h.remove()
        draws.append({n: m.get_parameter(n).grad for n in names})
    return draws


def trace_replay(graph, tag="", expected=None):
    """One replay of `graph` under the profiler -> its wrappers' launches
    (`traced_launches`); prints them and the hand kernels it ran. With
    `expected`, a trace that lists fewer launches than expected and none
    more is followed by another replay's, up to `TRACE_TRIES` in all: a
    trace lists what the profiler recorded, and it has left out a launch
    the replay made (a trace can add none); the caller's check fails
    unless one trace lists `expected`. A trace that lists no kernel at all
    is followed by another, up to `EMPTY_TRACE_TRIES` such traces."""
    short_tries = empty_tries = 0
    while True:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        per_replay = traced_launches(prof)
        events = prof.key_averages()
        n_kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
        print(f"one traced replay{tag}: wrapper launches (K1, K2, K3, K2-bf16, K3-bf16) "
              f"{per_replay} among {n_kernels} traced kernels; its hand kernels:")
        for e in events:
            if e.device_type == DeviceType.CUDA and hand_kernel_id(e.key) is not None:
                print(f"   x{e.count} {e.key[:100]}")
        if n_kernels == 0 and empty_tries < EMPTY_TRACE_TRIES:
            empty_tries += 1
            print("   (the trace recorded no kernel: tracing another replay)")
            time.sleep(1.0)
            continue
        short = expected is not None and per_replay != expected and all(
            p <= e for p, e in zip(per_replay, expected))
        short_tries += 1
        if not short or short_tries == TRACE_TRIES:
            return per_replay
        print(f"   (the trace lists fewer launches than {expected}: tracing another replay)")


def path_launches(name, counted, graph, calls, per_call):
    """The launches a graphed path made on the card, from its run: the
    wrappers' counts over the run (`counted`: its `calls` eager or captured
    calls of the step, each `per_call` launches) less the capture's, which
    records the kernels without running them, plus `graph.replays` times
    the launches of one traced replay of the path's own graph, which must
    be `per_call`. -> {launches, replays, per_replay}."""
    replays = graph.replays
    per_replay = trace_replay(graph, f" of the {name} path's graph", per_call)
    if counted != tuple(calls * c for c in per_call) or per_replay != per_call:
        raise AssertionError(f"the {name} path: wrapper counts {counted} over {calls} calls and "
                             f"{per_replay} a replay, not {per_call} a call")
    launches = tuple((calls - 1 + replays) * c for c in per_call)
    print(f"the {name} path launched (K1, K2, K3, K2-bf16, K3-bf16) {launches} on the card: "
          f"{calls - 1} eager calls, the capture and {replays} replays")
    return dict(launches=launches, replays=replays, per_replay=per_replay)


def check_graph_train(summary, dtype=None, recorded_trainer=None, expected=None) -> dict:
    """The train step captured in a CUDA graph against the eager step, two
    trainers from seed 0 (same init, same generator seed) in compute `dtype`
    on the run's data (`summary`: its waveforms, `n_points`, condition or
    none, learning rate and clip): the counters at the capture, one step
    (thetas and masks bit-identical, loss and gradients at the step bars),
    ten steps (each loss within `GRAPH_STEPS_LOSS_RTOL`), ten
    `train_steps_scanned` steps on stacked batches against eager steps on
    them, and the kernels of one replay in the profiler's trace. The one
    step (loss, gradients, parameters, BatchNorm statistics), the ten
    steps' losses and their gradients' global norms before the clip must
    also be bit-identical (cuDNN runs deterministically here). ->
    {per_replay: launches (K1,
    K2, K3, K2-bf16, K3-bf16) of one replay, eager_step_ms: the eager
    step's median, norms: the ten eager steps' norms before the clip}.
    Another family (the GP paths) gives `recorded_trainer()` -> (trainer,
    sample, draws), whose sample and splitter append each step's draws to
    `draws`, and the `expected` launches of one replay; it takes no
    `train_steps_scanned` check."""
    bf16 = dtype is not None
    tag = " (bf16)" if bf16 else ""
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL) if bf16
                            else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
    if recorded_trainer is not None:
        return _graph_vs_eager(recorded_trainer, expected, tag, loss_rtol, grad_rtol)
    expected = path_call(summary, bf16, train=True)
    space, wave = GWParameterSpace(), run_generator(summary)
    n_points, conditioned = summary.get("n_points", 256), bool(summary["conditioned"])
    mode = summary.get("mode", "time")

    def batch(theta):
        x, y, cond = make_eval_batch(theta, wave, space, n_points, mode)
        return x, y, cond if conditioned else None

    def recorded_trainer():
        """A trainer whose thetas and context masks are kept, step by step."""
        trainer = train_gw.build_trainer(summary, TRAIN_STEPS, "cuda", seed=0, dtype=dtype)
        draws, split = [], trainer.splitter

        def sample(g):
            theta = space.sample(TRAIN_BATCH, g)
            draws.append([theta])
            return batch(theta)

        def splitter(g, x, y, condition=None):
            out = split(g, x, y, condition=condition)
            draws[-1].append(out["mask_cntxt"])
            return out

        trainer.splitter = splitter
        return trainer, sample, draws

    return _graph_vs_eager(recorded_trainer, expected, tag, loss_rtol, grad_rtol,
                           lambda: check_scanned(summary, dtype, batch, conditioned, tag))


def _graph_vs_eager(recorded_trainer, expected, tag, loss_rtol, grad_rtol, more=None) -> dict:
    """`check_graph_train`'s checks on two trainers from `recorded_trainer()`;
    `more()` runs before the traced replay."""
    (t_g, sample_g, draws_g), (t_e, sample_e, draws_e) = recorded_trainer(), recorded_trainer()
    graph = t_g.generated_graph(sample_g)
    graph.warm_up()
    reset_counts()
    graph.capture()
    captured = counts()
    print(f"captured train step{tag}: wrapper launches (K1, K2, K3, K2-bf16, K3-bf16) {captured} "
          f"at the capture (after {WARMUP_CALLS} eager warm-up steps)")
    if captured != expected:
        raise AssertionError(f"the capture launched {captured}, not {expected}")

    loss_g = t_g.train_steps_generated(sample_g, 1)
    norms_g = [graph.outputs["grad_norm"].clone()]
    metrics_e = t_e.train_step_cond(*sample_e(t_e.state.generator))
    loss_e, norms_e = metrics_e["loss"], [metrics_e["grad_norm"]]
    torch.cuda.synchronize()
    draws_same = all(torch.equal(a, b) for a, b in zip(draws_g[-1], draws_e[-1]))
    grads_g = {n: p.grad for n, p in t_g.model.named_parameters()}
    grads_e = {n: p.grad for n, p in t_e.model.named_parameters()}
    loss_rel = (abs(loss_g[0] - loss_e) / abs(loss_e)).item()
    errs, zero = _step_grad_errs(grads_g, grads_e)
    worst, worst_zero = max(errs, key=errs.get), max(zero, key=zero.get)
    bits = (draws_same and torch.equal(loss_g[0], loss_e)
            and all(torch.equal(grads_g[n], grads_e[n]) for n in grads_e)
            and all(torch.equal(a, b) for a, b in zip(t_g.model.state_dict().values(),
                                                       t_e.model.state_dict().values())))
    print(f"one graphed step vs one eager step{tag}: draws and masks bit-identical "
          f"{draws_same}; loss {loss_g[0].item():.4f} vs {loss_e.item():.4f} (rel "
          f"{loss_rel:.3e}); {len(errs)} gradients, worst {errs[worst]:.3e} of its max magnitude "
          f"({worst}); BatchNorm-cancelled biases {zero[worst_zero]:.3e}; everything "
          f"bit-identical (loss, gradients, parameters, BatchNorm statistics) {bits}")
    if not (draws_same and loss_rel <= loss_rtol and errs[worst] <= grad_rtol
            and zero[worst_zero] <= grad_rtol and bits):
        raise AssertionError(f"the graphed train step{tag} disagrees with the eager step")

    eager, eager_seconds, graphed = [loss_e], [], [loss_g]
    for _ in range(GRAPH_STEPS - 1):
        t0 = time.perf_counter()
        metrics_e = t_e.train_step_cond(*sample_e(t_e.state.generator))
        torch.cuda.synchronize()
        eager_seconds.append(time.perf_counter() - t0)
        eager.append(metrics_e["loss"])
        norms_e.append(metrics_e["grad_norm"])
        graphed.append(t_g.train_steps_generated(sample_g, 1))
        norms_g.append(graph.outputs["grad_norm"].clone())
    graphed, eager = torch.cat(graphed), torch.stack(eager)
    norms_g, norms_e = torch.stack(norms_g), torch.stack(norms_e)
    gaps = ((graphed - eager).abs() / eager.abs()).cpu().numpy()
    bits10 = torch.equal(graphed, eager) and torch.equal(norms_g, norms_e)
    print(f"{GRAPH_STEPS} graphed steps vs {GRAPH_STEPS} eager steps{tag}: largest loss gap "
          f"{gaps.max():.3e} relative (step {gaps.argmax() + 1}); losses and gradient norms "
          f"bit-identical {bits10}; norms before the clip "
          + ", ".join(f"{v:.4g}" for v in norms_e.tolist()))
    if gaps.max() > GRAPH_STEPS_LOSS_RTOL or not bits10:
        raise AssertionError(f"{GRAPH_STEPS} graphed steps{tag} part from the eager steps")

    if more is not None:
        more()
    per_replay = trace_replay(graph, tag, expected)
    if per_replay != expected:
        raise AssertionError(f"one replay{tag} launched {per_replay}, not {expected}")
    return dict(per_replay=per_replay, eager_step_ms=1e3 * float(np.median(eager_seconds)),
                norms=norms_e.tolist())


def check_scanned(summary, dtype, batch, conditioned, tag):
    """Ten `train_steps_scanned` steps on stacked batches against eager steps
    on them, from two trainers of seed 0."""
    space = GWParameterSpace()
    g = torch.Generator(device="cuda").manual_seed(3)
    made = [batch(space.sample(TRAIN_BATCH, g)) for _ in range(GRAPH_STEPS)]
    xs, ys = (torch.stack([b[i] for b in made]) for i in range(2))
    conds = torch.stack([b[2] for b in made]) if conditioned else None
    t_s = train_gw.build_trainer(summary, TRAIN_STEPS, "cuda", seed=0, dtype=dtype)
    t_se = train_gw.build_trainer(summary, TRAIN_STEPS, "cuda", seed=0, dtype=dtype)
    scanned = t_s.train_steps_scanned(xs, ys, conds)
    eager_scan = torch.stack([t_se.train_step_cond(*b)["loss"] for b in made])
    scan_gaps = ((scanned - eager_scan).abs() / eager_scan.abs()).cpu().numpy()
    print(f"{GRAPH_STEPS} scanned graphed steps vs {GRAPH_STEPS} eager steps on the same stacked "
          f"batches{tag}: largest loss gap {scan_gaps.max():.3e} relative; bit-identical "
          f"{torch.equal(scanned, eager_scan)}")
    if scan_gaps.max() > GRAPH_STEPS_LOSS_RTOL:
        raise AssertionError(f"scanned graphed steps{tag} part from the eager steps")


def check_family(name, run_dir, dtype, steps, seeds, smi) -> dict:
    """Phase 14, one training path: the configuration `run_dir` recorded
    (`train_config`: its architecture, data, learning rate, decay and clip)
    in compute `dtype`. The graphed step against the eager one, bit for bit
    (`check_graph_train`); for each of `seeds`, `steps` graphed steps at
    batch 32 through `train_gw.train`, each printing its median loss over
    the first and the last 50 steps; at least one draw must fall by
    `FAMILY_FALL[name]` nats between the two; one step of seed 0's trained
    model on the kernel path against the plain path; the path's launches
    from a traced replay of seed 0's graph. The seeds after the first are
    fallbacks: the next one trains only while no draw has met the bar (and,
    on a latent path, `FAMILY_LEVEL`). -> the path's numbers."""
    bf16 = dtype is not None
    label = f"{name}{' (bf16)' if bf16 else ''}"
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = train_config(json.load(f))
    release()
    graph_train = check_graph_train(summary, dtype)
    release()
    draws = []
    for seed in seeds:
        trainer = train_gw.build_trainer(summary, steps, "cuda", seed=seed, dtype=dtype)
        reset_counts()
        history, losses, seconds, step_seconds = train_gw.train(trainer, summary, steps,
                                                                TRAIN_BATCH, time_steps=True)
        counted = counts()
        (graph,) = trainer.graphs.values()
        losses = losses.cpu().numpy()
        early, late = float(np.median(losses[:50])), float(np.median(losses[-50:]))
        step_ms = 1e3 * float(np.median(step_seconds))
        print(f"{label}, seed {seed}: {steps} graphed steps in {seconds:.2f}s, {graph.replays} "
              "replays; 50-step mean losses: "
              + ", ".join(f"{h['train_loss']:.1f}" for h in history))
        level = FAMILY_LEVEL.get(name, float("inf"))
        print(f"{label}, seed {seed}: median loss over the first 50 steps {early:.2f}, over the "
              f"last 50 {late:.2f} (fell {early - late:.2f} nats, bar {FAMILY_FALL[name]:.0f}"
              + (f"; level {level:.0f}" if name in FAMILY_LEVEL else "") + "); "
              f"graphed train step {step_ms:.3f} ms (median of {steps}, host clock, "
              f"synchronised), eager {graph_train['eager_step_ms']:.3f} ms; {smi}")
        if graph.replays != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{label}, seed {seed}: {graph.replays} replays, finite "
                                 f"{np.isfinite(losses).all()}")
        met = early - late >= FAMILY_FALL[name] and late <= level
        draws.append(dict(seed=seed, early=early, late=late, step_ms=step_ms, met=met))
        if seed == seeds[0]:
            first = (trainer, counted, graph)
        else:
            del trainer, graph
            release()
        if met:
            break
    if not any(d["met"] for d in draws):
        raise AssertionError(f"{label}: the loss fell by {FAMILY_FALL[name]} nats"
                             + (f" to {FAMILY_LEVEL[name]}" if name in FAMILY_LEVEL else "")
                             + " in no draw")
    trainer, counted, graph = first
    check_train_step(trainer.model, summary, torch.Generator(device="cuda").manual_seed(4), dtype,
                     term_scale=True)
    path = path_launches(f"{label} training", counted, graph, WARMUP_CALLS + 1,
                         path_call(summary, bf16, train=True))
    return dict(path=path, step_ms=draws[0]["step_ms"], eager_step_ms=graph_train["eager_step_ms"],
                draws=draws, norms=graph_train["norms"], clip=summary.get("grad_clip_norm"))


@contextlib.contextmanager
def graph_every_run():
    """Inside, `score_run` replays its batch graph whenever a second batch
    of 256 follows the first: `score.GRAPH_MIN_REPLAYS` (the graph pays for
    its capture only in longer runs) set to 1."""
    saved = score_mod.GRAPH_MIN_REPLAYS
    score_mod.GRAPH_MIN_REPLAYS = 1
    try:
        yield
    finally:
        score_mod.GRAPH_MIN_REPLAYS = saved


def eager_scores(n, dtype=None, recorded=True, run_dir=RUN_DIR):
    """`score_run`'s scoring of `run_dir`'s first `n` recorded thetas (or,
    not `recorded`, of `n` drawn as `score_run` draws them) with no graph:
    a loop of `score_batch` on a generator seeded as `score_run` seeds it,
    timed as `score_run` times its loop -> {ll, mismatch, mismatch_zdraw,
    n, mean_ll, seconds}. Like `score_run` it scores `score.n_scored(n)`
    waveforms: whole batches of 256 from 256 on."""
    n = score_mod.n_scored(n)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(run_dir, "cuda", dtype=dtype)
    wave, space = run_generator(summary), GWParameterSpace()
    n_points, mode = summary.get("n_points", 256), summary.get("mode", "time")
    splitter = eval_splitter(summary["n_context"])
    generator = torch.Generator(device="cuda").manual_seed(0)
    if recorded:
        thetas = torch.from_numpy(read_run_thetas(run_dir)[:n]).cuda()
    else:
        thetas = space.sample(n, generator)
    parts = []
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i in range(0, n, 256):
            parts.append(score_batch(model, splitter, generator, thetas[i:i + 256], wave,
                                     space, n_points, mode)[:3])
        ll, mm, mz = (torch.cat(t).cpu().numpy() for t in zip(*parts))
    return dict(ll=ll, mismatch=mm, mismatch_zdraw=mz, n=int(ll.shape[0]),
                mean_ll=float(ll.mean()), seconds=time.perf_counter() - t0)


def score_timing(smi, dtype=None) -> dict:
    """`score_run` end to end (the seconds of its loop, graphed where enough
    batches follow) against the eager loop (`eager_scores`): at n_test 2048
    and 300 (both score 256) on the recorded thetas, and on drawn thetas at the least n_test
    that `score_run` graphs, (GRAPH_MIN_REPLAYS + 1) batches of 256; each
    in the order score_run, eager, eager, score_run -> {n: {"score_run": [s,
    s], "eager": [s, s], "graphed": whether score_run replayed a graph}}."""
    tag = " (bf16)" if dtype is not None else ""
    res = {}
    for n in (N_TEST, 300, (score_mod.GRAPH_MIN_REPLAYS + 1) * 256):
        recorded = n <= N_TEST
        t = {"score_run": [], "eager": []}
        for which in ("score_run", "eager", "eager", "score_run"):
            if which == "eager":
                t["eager"].append(eager_scores(n, dtype, recorded)["seconds"])
            else:
                out = score_run(RUN_DIR, n, thetas_from=RUN_DIR if recorded else None,
                                device="cuda", dtype=dtype)
                if out["n"] != score_mod.n_scored(n):
                    raise AssertionError(f"score_run scored {out['n']} of n_test {n}")
                t["score_run"].append(out["seconds"])
                t["graphed"] = out["graph"] is not None
        print(f"score_run end to end{tag}, n_test {n} ({'graphed' if t['graphed'] else 'eager'}): "
              f"{', '.join(f'{x:.4f}' for x in t['score_run'])} s; the eager loop "
              f"{', '.join(f'{x:.4f}' for x in t['eager'])} s (host clock; {smi})")
        res[n] = t
    return res


def check_graph_scores(graphed, eager, tag=""):
    """Graphed scoring against eager scoring of the same thetas, per waveform."""
    d_ll = np.abs(graphed["ll"] - eager["ll"]).max()
    d_mm = np.abs(graphed["mismatch"] - eager["mismatch"]).max()
    same = all(np.array_equal(graphed[k], eager[k]) for k in ("ll", "mismatch", "mismatch_zdraw"))
    print(f"graphed vs eager scoring{tag} of {eager['n']} waveforms: LL largest gap {d_ll:.3e}, "
          f"mismatch {d_mm:.3e}; bit-identical {same}; eager mean LL {eager['mean_ll']:.3f}, "
          f"{eager['seconds']:.2f}s; graphed {graphed['seconds']:.2f}s")
    if not (d_ll <= GRAPH_LL_ATOL and d_mm <= GRAPH_MISMATCH_ATOL):
        raise AssertionError(f"graphed scoring{tag} disagrees with eager scoring")


def graphed_batch_ms(model, splitter, theta, wave, space, reps=5, n_points=256):
    """Median host-clock time of a synchronised replay of the batch's graph
    (after an eager batch of the same model and shapes; run under inference
    mode)."""
    graph = batch_graph(model, splitter, torch.Generator(device="cuda").manual_seed(1), theta,
                        wave, space, n_points)
    graph.replay(theta)  # the capture
    t = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay(theta)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(t))


def check_run_scores(runs, smi) -> dict:
    """Phase 12: each run scored on its own 2048 recorded thetas, graphed,
    held to its bands; then in bf16 with the same context draws, its
    bf16-float32 mean LL gap held within the larger of `BF16_GAP_TOL` nats
    and `BF16_GAP_SES` standard errors of JAX's own gap on those thetas
    (`tests/jax_bf16_family_gaps.json`); the long and frequency-domain
    paths' launches from a traced replay of each one's own graph, in each
    dtype, and the frequency-domain runs' graphed scores against eager
    ones. A time-domain run's bands are those of its recorded scores
    (`run_report.score_bands`); a frequency-domain run's those of the JAX
    package's own float32 scoring of the same thetas on the CPU (the
    json's `f32_bands`, by the same rule): its records lie between the JAX
    package's float32 and bf16 scores (PERF.md, section 6), and its
    record's bands are printed beside. A ConvLNP run (phase 16) is held to
    the JAX package's own float32 bands as well, its graphed scores to
    eager ones, and prints its per-draw mismatch beside the record's. ->
    {"long k37", "long unet", "freq film", "freq", the `LATENT_RUNS` labels
    and their " bf16": `path_launches`}."""
    misses, paths = [], {}
    for run_dir in runs:
        name = os.path.relpath(run_dir, RESULTS)
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        rec_ll, rec_mm = recorded_scores(run_dir)
        rec_bands = score_bands(run_dir)
        jax_gap = BF16_GAPS[name]
        own = run_dir in FREQ_RUNS or run_dir in LATENT_RUNS  # JAX's own float32 bands
        bands = jax_gap["f32_bands"] if own else rec_bands
        outs = {}
        for dtype in (None, BF16):
            call = path_call(summary, dtype is not None, train=False)
            reset_counts()
            with graph_every_run():
                out = score_run(run_dir, N_TEST, thetas_from=run_dir, device="cuda", dtype=dtype)
            counted = counts()
            graph = out["graph"]
            if graph is None or graph.replays != N_TEST // 256 - 1:
                raise AssertionError(f"{name}: scored without its batch graph's "
                                     f"{N_TEST // 256 - 1} replays")
            if counted != tuple(2 * c for c in call):
                raise AssertionError(f"{name}: wrapper launches {counted} at the eager batch and "
                                     f"the capture, not {tuple(2 * c for c in call)}")
            if not (out["n"] == N_TEST and np.isfinite(out["ll"]).all()
                    and np.isfinite(out["mismatch"]).all()):
                raise AssertionError(f"{name}: non-finite or missing per-waveform results")
            outs[dtype] = out
            kind = {LONG_K37: "long k37", LONG_UNET: "long unet", **FREQ_RUNS,
                    **LATENT_RUNS}.get(run_dir)
            if kind is not None:
                kind += " bf16" if dtype is not None else ""
                paths[kind] = path_launches(f"{kind} scoring", counted, graph, 2, call)
            if own:
                reset_counts()
                eager = eager_scores(N_TEST, dtype, run_dir=run_dir)
                if counts() != tuple(N_TEST // 256 * c for c in call):
                    raise AssertionError(f"{name}: eager scoring launched {counts()}")
                check_graph_scores(out, eager, f" of {kind}")
        out, out16 = outs[None], outs[BF16]
        (l0, l1), (m0, m1) = bands["mean_ll"], bands["median_mismatch"]
        inside = l0 <= out["mean_ll"] <= l1 and m0 <= out["median_mismatch"] <= m1
        (r0, r1), (q0, q1) = rec_bands["mean_ll"], rec_bands["median_mismatch"]
        in_rec = r0 <= out["mean_ll"] <= r1 and q0 <= out["median_mismatch"] <= q1
        print(f"{name}: mean LL {out['mean_ll']:.2f} in [{l0:.2f}, {l1:.2f}] (recorded "
              f"{rec_ll.mean():.2f}); median mismatch {out['median_mismatch']:.5f} in [{m0:.5f}, "
              f"{m1:.5f}] (recorded {np.median(rec_mm):.5f}); p90 {out['mismatch_p90']:.4f} "
              f"(recorded {np.percentile(rec_mm, 90):.4f}), p99 {out['mismatch_p99']:.4f} "
              f"(recorded {np.percentile(rec_mm, 99):.4f}), frac < 0.1 "
              f"{out['frac_below_0.1']:.4f} (recorded {(rec_mm < 0.1).mean():.4f}), frac < 0.03 "
              f"{out['frac_below_0.03']:.4f} (recorded {(rec_mm < 0.03).mean():.4f}); inside its "
              f"bands {inside}"
              + ("" if bands is rec_bands else
                 f" (JAX's float32 rescoring's; the record's [{r0:.2f}, {r1:.2f}] and "
                 f"[{q0:.5f}, {q1:.5f}]: inside {in_rec})")
              + f"; {out['seconds']:.2f}s")
        if run_dir in LATENT_RUNS:
            print(f"{name}: per-draw median mismatch {out['mismatch_zdraw_median']:.5f} (recorded "
                  f"{summary['mismatch_zdraw_median']:.5f}; the JAX package's own float32 mean "
                  f"LL and median mismatch over the same thetas "
                  f"{jax_gap['f32_all']['mean_ll']:.2f} and "
                  f"{jax_gap['f32_all']['median_mismatch']:.5f})")
        d_ll = out16["ll"] - out["ll"]
        tol = max(BF16_GAP_TOL, BF16_GAP_SES * jax_gap["d_ll_std"] / jax_gap["n"] ** 0.5)
        near = abs(d_ll.mean() - jax_gap["d_mean_ll"]) <= tol
        print(f"{name} bf16: mean LL {out16['mean_ll']:.2f}, gap to float32 {d_ll.mean():+.4f} "
              f"(sd {d_ll.std():.3f}; JAX's {jax_gap['d_mean_ll']:+.4f}, sd "
              f"{jax_gap['d_ll_std']:.3f} over {jax_gap['n']}; bar {tol:.3f}) within its bar "
              f"{near}; median mismatch {out16['median_mismatch']:.5f} (gap "
              f"{out16['median_mismatch'] - out['median_mismatch']:+.2e}, JAX's "
              f"{jax_gap['d_median_mismatch']:+.2e}); {out16['seconds']:.2f}s")
        if not inside:
            misses.append(name)
        if not near:
            misses.append(f"{name} (bf16 gap)")
        del outs, out, out16, graph
        release()
    print(f"{len(runs) - len(misses)} of {len(runs)} runs inside their bands and bf16 bars ({smi})")
    if misses:
        raise AssertionError(f"outside their bands or bars: {', '.join(misses)}")
    return paths


def check_latent_batch(run_dir, smi) -> dict:
    """Phase 16: one 256-waveform batch of a ConvLNP run on its first
    recorded thetas, 32 z draws a waveform, on the kernel path against the
    plain path (`use_kernels=False`), the split and the draws from
    generators seeded alike: loc and scale within `PATH_TOL`; each path's
    batch timed on the host clock (median of 3, synchronised)."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    wave, space = run_generator(summary), GWParameterSpace()
    splitter = eval_splitter(summary["n_context"])
    theta = torch.from_numpy(read_run_thetas(run_dir)[:256]).cuda()
    outs, ms = {}, {}
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for label, use_kernels in (("kernel", True), ("plain", False)):
            model = load_model(run_dir, "cuda", use_kernels=use_kernels)
            t = []
            for _ in range(4):
                g = torch.Generator(device="cuda").manual_seed(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ll, _, _, o = score_batch(model, splitter, g, theta, wave, space)
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            outs[label] = (o.p_yCc.loc.clone(), o.p_yCc.scale.clone(), ll.clone())
            ms[label] = 1e3 * float(np.median(t[1:]))
            del model, o
            release()
    loc_err, scale_err, ll_err = ((a - b).abs().max().item()
                                  for a, b in zip(outs["kernel"], outs["plain"]))
    print(f"{os.path.relpath(run_dir, RESULTS)}: one batch of 256 x {outs['kernel'][0].shape[0]} "
          f"draws, kernel vs plain path: loc {loc_err:.3e}, scale {scale_err:.3e}, LL "
          f"{ll_err:.3e}; eager batch {ms['kernel']:.3f} ms (kernel path), {ms['plain']:.3f} ms "
          f"(plain path), host clock; {smi}")
    if not (loc_err <= PATH_TOL and scale_err <= PATH_TOL):
        raise AssertionError(f"{run_dir}: the kernel path disagrees with the plain path")
    return dict(loc_err=loc_err, scale_err=scale_err, ll_err=ll_err, **ms)


def long_batch_ms(run_dir, smi) -> dict:
    """One 256-waveform batch of a long-waveform run on its first recorded
    thetas: the eager batch's median host-clock time over 3 (synchronised),
    then one replayed from its CUDA graph (median of 5)."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(run_dir, "cuda")
    wave, space = run_generator(summary), GWParameterSpace()
    splitter, n_points = eval_splitter(summary["n_context"]), summary["n_points"]
    theta = torch.from_numpy(read_run_thetas(run_dir)[:256]).cuda()
    t = []
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for _ in range(4):
            g = torch.Generator(device="cuda").manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            score_batch(model, splitter, g, theta, wave, space, n_points)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        eager = 1e3 * float(np.median(t[1:]))
        graphed = graphed_batch_ms(model, splitter, theta, wave, space, n_points=n_points)
    print(f"{os.path.relpath(run_dir, RESULTS)}: one 256-waveform batch eager {eager:.3f} ms "
          f"(median of 3, host clock), replayed from its CUDA graph {graphed:.3f} ms (median of "
          f"5); {smi}")
    return dict(eager_ms=eager, graphed_ms=graphed)


def check_resume() -> None:
    """Phase 13: the decile checkpoints of a short run through `train_gw.run`,
    each read back as it is written, and a continuation resumed from the
    last one; the run's own directory refused."""
    summary = gw_train_summary()
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:TRAIN_BATCH]).cuda()
    wave, space = run_generator(summary), GWParameterSpace()
    x, y, cond = make_eval_batch(theta, wave, space)
    batch = eval_splitter(summary["n_context"])(torch.Generator(device="cuda").manual_seed(3),
                                                x, y, condition=cond)

    def forward(model):
        model.eval()
        with torch.inference_mode():
            o = model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                      mask_cntxt=batch["mask_cntxt"], mask_trgt=batch["mask_trgt"],
                      condition=batch["condition"]).p_yCc
        return o.loc.clone(), o.scale.clone()

    real_save, real_train = train_gw.save_run_params, train_gw.train
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = os.path.join(tmp, "last_checkpoint")
        read_back = []

        def save_and_read_back(run_dir, model):
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            real_save(run_dir, model)
            loaded = params_from_flax(*load_run_params(run_dir))
            read_back.append(loaded.keys() == state.keys()
                             and all(torch.equal(loaded[k], state[k]) for k in state))
            if len(read_back) == len(train_gw.checkpoint_chunks(RESUME_STEPS)):
                real_save(checkpoint, model)  # what a run lost after it leaves behind

        train_gw.save_run_params = save_and_read_back
        try:
            run_dir, first = train_gw.run(RESUME_STEPS, TRAIN_BATCH, device="cuda", out=tmp,
                                          n_test=256, thetas_from=RUN_DIR)
        finally:
            train_gw.save_run_params = real_save
        n_ckpt = len(train_gw.checkpoint_chunks(RESUME_STEPS))
        print(f"{RESUME_STEPS} graphed steps through train_gw.run: {len(read_back)} writes "
              f"({n_ckpt} checkpoints and the run's own), each read back bit for bit "
              f"{all(read_back)}; scored 256: mean LL {first['test_ll_per_wf']:.2f}")
        if not (len(read_back) == n_ckpt + 1 and all(read_back)):
            raise AssertionError("a checkpoint does not read back as it was written")

        resumed_first = {}

        def train_from(trainer, *args, **kw):
            resumed_first["out"] = forward(trainer.model)  # before any step
            return real_train(trainer, *args, **kw)

        train_gw.train = train_from
        try:
            run_dir1, second = train_gw.run(RESUMED_STEPS, TRAIN_BATCH, device="cuda", out=tmp,
                                            run_index=1, n_test=256, thetas_from=RUN_DIR,
                                            resume_from=checkpoint)
        finally:
            train_gw.train = real_train
        ckpt_model = gw_model_from_summary(summary).to("cuda")  # a checkpoint has no summary
        train_gw.load_params_into(ckpt_model, checkpoint)
        ref = forward(ckpt_model)
        same = all(torch.equal(a, b) for a, b in zip(resumed_first["out"], ref))
        with open(os.path.join(run_dir, "history.json")) as f:
            hist0 = json.load(f)
        with open(os.path.join(run_dir1, "history.json")) as f:
            hist1 = json.load(f)
        print(f"resumed into run_1 from the last checkpoint: resumed_from "
              f"{second.get('resumed_from') == checkpoint}; its first forward equal to the "
              f"checkpoint's model's bit for bit {same}; 50-step losses: the first run "
              + ", ".join(f"{h['train_loss']:.1f}" for h in hist0) + "; the continuation "
              + ", ".join(f"{h['train_loss']:.1f}" for h in hist1)
              + f"; scored 256: mean LL {second['test_ll_per_wf']:.2f}")
        if not (same and second.get("resumed_from") == checkpoint):
            raise AssertionError("the resumed run does not start from its checkpoint")
        try:
            train_gw.run(RESUMED_STEPS, TRAIN_BATCH, device="cuda", out=tmp, run_index=1,
                         resume_from=run_dir1)
        except ValueError as e:
            print(f"resuming into the run's own directory refused: {e}")
        else:
            raise AssertionError("a resume into the run's own directory was not refused")


def gp_recorded_trainer(summary, dtype=None):
    """`check_graph_train`'s `recorded_trainer` for a GP configuration in
    compute `dtype`: a trainer from seed 0 whose functions and context
    masks are kept."""
    sampler = score_gp.samplers(summary["kernel"])[0]

    def make():
        trainer = train_gp.build_trainer(summary, 100, 1562, "cuda", seed=0, dtype=dtype)
        draws, split = [], trainer.splitter

        def sample(g):
            x, y = sampler.sample(g, TRAIN_BATCH)
            draws.append([x, y])
            return x, y, None

        def splitter(g, x, y, condition=None):
            out = split(g, x, y, condition=condition)
            draws[-1].append(out["mask_cntxt"])
            return out

        trainer.splitter = splitter
        return trainer, sample, draws
    return make


def gp_call(summary) -> tuple:
    """The launches (K1, K2, K3, K2-bf16, K3-bf16) one scoring batch of a GP
    run makes: ConvCNP K1 twice and K2; ConvLNP K1 twice, three times where
    an ELBO-trained run encodes its targets at eval; the set and attention
    family K2 once."""
    if summary["model"].split("_")[0] in SET_MODELS:
        return SET_SCORE_CALL
    if summary["model"] == "ConvCNP":
        return GP_SCORE_CALL["gp cnp"]
    return GP_SCORE_CALL["gp elbo" if "_ELBOTrue" in summary["model"] else "gp npml"]


@contextlib.contextmanager
def no_graphs():
    """Inside, `score_gp` scores every batch eagerly (a loop of `score_batch`)."""
    saved = score_mod.GRAPH_MIN_REPLAYS
    score_mod.GRAPH_MIN_REPLAYS = 10 ** 9
    try:
        yield
    finally:
        score_mod.GRAPH_MIN_REPLAYS = saved


def check_gp_sampler(smi) -> dict:
    """Phase 18: 4,096 functions of each GP kernel (and the All_Kernels
    mixture) drawn on the card from seed 0, every value finite, x sorted in
    [-1, 1]; each kernel's sample covariance at one fixed x within
    `GP_MOMENT_SES` standard errors of the kernel's; the draw timed (host
    clock, synchronised)."""
    out = {}
    for kernel in score_gp.KERNELS:
        sampler = score_gp.samplers(kernel)[0]
        g = torch.Generator(device="cuda").manual_seed(0)
        sampler.sample(g, 32)  # the periodic sampler's coefficients, and warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, y = sampler.sample(g, GP_MOMENT_N)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        finite = bool(torch.isfinite(y).all() and torch.isfinite(x).all())
        ordered = bool((x[:, 1:] >= x[:, :-1]).all() and x.abs().max() <= 1.0)
        z = (None if kernel == "All_Kernels" else
             sample_covariance_z(sampler, GP_MOMENT_N, torch.Generator(device="cuda").manual_seed(1)))
        print(f"GP sampler {kernel}: {GP_MOMENT_N} functions of {GP_POINTS} points in {ms:.2f} ms; "
              f"finite {finite}, x sorted in [-1, 1] {ordered}; y std {y.std().item():.4f}"
              + ("" if z is None else f"; sample covariance at a fixed x: largest error "
                 f"{z:.2f} standard errors (bar {GP_MOMENT_SES})") + f"; {smi}")
        if not (finite and ordered and (z is None or z <= GP_MOMENT_SES)):
            raise AssertionError(f"the GP sampler {kernel} draws wrong functions")
        out[kernel] = dict(ms=ms, z=z)
    return out


def check_gp_scores(runs, families, smi) -> tuple:
    """Phases 19 and 21: each GP run of `runs` scored with
    `score_gp.score_run` over 9,984 functions a kernel (29,952 for
    All_Kernels), every batch after a kernel's first replayed from its CUDA
    graph, held to the band of the JAX package's eval functions and splits
    scored by the port's forward in float32 on the CPU
    (`tests/jax_bf16_family_gaps.json`; the records were not made with the
    JAX package's float32 arithmetic, `tests/jax_score_offsets.py`) and
    printed beside the record's band; the wrappers' counts at the eager
    batches and the captures. For one run of each family (`families`):
    the graphed scores against eager ones, the launches of a traced replay,
    and a replay's time. -> ({family: `path_launches`}, {family: batch
    ms})."""
    misses, paths, batch_ms = [], {}, {}
    for run_dir in runs:
        name = os.path.relpath(run_dir, RESULTS)
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        n_comp = len(score_gp.samplers(summary["kernel"])[1])
        call = gp_call(summary)
        reset_counts()
        out = score_gp.score_run(run_dir, GP_N_TEST, "cuda")
        counted = counts()
        graphs = out["graphs"]
        if not (len(graphs) == n_comp
                and all(g.replays == GP_N_TEST // 256 - 1 for g in graphs)):
            raise AssertionError(f"{name}: scored without a batch graph a kernel")
        if counted != tuple(2 * n_comp * c for c in call):
            raise AssertionError(f"{name}: wrapper launches {counted} at the eager batches and "
                                 f"the captures, not {tuple(2 * n_comp * c for c in call)}")
        if not (out["n"] == GP_N_TEST * n_comp and np.isfinite(out["ll"]).all()):
            raise AssertionError(f"{name}: non-finite or missing per-function results")
        GP_F32_LL[run_dir] = out["ll"]
        lo, hi = BF16_GAPS[name]["f32_bands"]["mean_ll"]
        r0, r1 = record_band(run_dir)
        inside = lo <= out["mean_ll"] <= hi
        print(f"{name}: mean LL {out['mean_ll']:.3f} over {out['n']} in [{lo:.2f}, {hi:.2f}] "
              f"(JAX's eval draws, the port's CPU forward, "
              f"{BF16_GAPS[name]['f32']['mean_ll']:.3f}) {inside}; recorded "
              f"{summary['mean_test_ll']:.2f}, its band [{r0:.2f}, {r1:.2f}]: inside "
              f"{r0 <= out['mean_ll'] <= r1}; launches {counted}; {out['seconds']:.2f}s")
        if not inside:
            misses.append(name)
        kind = families.get(run_dir)
        if kind is not None:
            graph = graphs[0]
            paths[kind] = path_launches(f"{kind} scoring", counted, graph, 2, call)
            t = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graph.replay()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            batch_ms[kind] = 1e3 * float(np.median(t))
            reset_counts()
            with no_graphs():
                eager = score_gp.score_model(score_gp.load_model(run_dir, "cuda"),
                                             summary["kernel"], GP_N_TEST, "cuda")
            n_batches = GP_N_TEST // 256
            if counts() != tuple(n_batches * c for c in call) or eager["graphs"]:
                raise AssertionError(f"{name}: eager scoring launched {counts()}")
            diff = np.abs(out["ll"] - eager["ll"]).max()
            print(f"{name}: graphed against eager scoring, largest LL difference {diff:.3e} (bar "
                  f"{GRAPH_LL_ATOL}); one batch replayed from its graph {batch_ms[kind]:.3f} ms "
                  f"(median of 5, host clock), eager {1e3 * eager['seconds'] / n_batches:.3f} ms "
                  "(mean)")
            if diff > GRAPH_LL_ATOL:
                raise AssertionError(f"{name}: graphed scoring differs from eager scoring")
            del eager, graph
        del out, graphs
        release()
    print(f"{len(runs) - len(misses)} of {len(runs)} GP runs inside the bands of JAX's eval "
          f"draws through the port's CPU forward ({smi})")
    if misses:
        raise AssertionError(f"GP runs outside their bands: {', '.join(misses)}")
    return paths, batch_ms


def check_gp_batch(run_dir, smi) -> dict:
    """Phase 19: one batch of 256 functions of a GP run on the kernel path
    against the plain path, the functions, split and z draws from
    generators seeded alike: loc and scale within `PATH_TOL`."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        kernel = json.load(f)["kernel"]
    sampler = score_gp.samplers(kernel)[1][0]
    outs = {}
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for label, use_kernels in (("kernel", True), ("plain", False)):
            model = score_gp.load_model(run_dir, "cuda", use_kernels=use_kernels)
            g = torch.Generator(device="cuda").manual_seed(1)
            ll, o = score_gp.score_batch(model, score_gp.eval_splitter(), g, sampler)
            outs[label] = (o.p_yCc.loc.clone(), o.p_yCc.scale.clone(), ll.clone())
            del model, o
    loc_err, scale_err, ll_err = ((a - b).abs().max().item()
                                  for a, b in zip(outs["kernel"], outs["plain"]))
    print(f"{os.path.relpath(run_dir, RESULTS)}: one batch of 256 x {outs['kernel'][0].shape[0]} "
          f"draws, kernel vs plain path: loc {loc_err:.3e}, scale {scale_err:.3e}, LL "
          f"{ll_err:.3e}; {smi}")
    if not (loc_err <= PATH_TOL and scale_err <= PATH_TOL):
        raise AssertionError(f"{run_dir}: the kernel path disagrees with the plain path")
    return dict(loc_err=loc_err, scale_err=scale_err, ll_err=ll_err)


def check_gp_family(name, summary, smi, dtype=None) -> dict:
    """Phase 20, one GP training path (`GP_TRAIN`) in compute `dtype`
    (phase 32 in bf16): the graphed step against the eager one, bit for
    bit (`check_graph_train`); 1,000 graphed steps at batch 32 from seed 0
    (seeds 1 and 2 only while no draw has met the bars), each draw's median
    loss over the first and the last 50 steps (`GP_FALL`, `GP_LEVEL`, the
    float32 path's in either dtype); one step of seed 0's trained model on
    the kernel path against the plain path; the launches of a traced
    replay of seed 0's graph. -> the path's numbers."""
    call = GP_TRAIN_CALL[name] if dtype is None else bf16_call(GP_TRAIN_CALL[name])
    label = name if dtype is None else f"{name} bf16"
    release()
    graph_train = check_graph_train(summary, dtype,
                                    recorded_trainer=gp_recorded_trainer(summary, dtype),
                                    expected=call)
    release()
    sampler = score_gp.samplers(summary["kernel"])[0]

    def sample(g):
        return (*sampler.sample(g, TRAIN_BATCH), None)

    draws = []
    for seed in FAMILY_SEEDS:
        trainer = train_gp.build_trainer(summary, 100, 1562, "cuda", seed=seed, dtype=dtype)
        reset_counts()
        chunks, chunk_s = [], []
        t0 = time.perf_counter()
        for _ in range(GP_TRAIN_STEPS // 50):
            t1 = time.perf_counter()
            chunks.append(trainer.train_steps_generated(sample, 50))
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t1)
        seconds = time.perf_counter() - t0
        counted = counts()
        (graph,) = trainer.graphs.values()
        losses = torch.cat(chunks).cpu().numpy()
        early, late = float(np.median(losses[:50])), float(np.median(losses[-50:]))
        step_ms = 1e3 * float(np.median(chunk_s[1:])) / 50
        met = early - late >= GP_FALL[name] and late <= GP_LEVEL[name]
        print(f"{label}, seed {seed}: {GP_TRAIN_STEPS} graphed steps in {seconds:.2f}s, "
              f"{graph.replays} replays; 50-step mean losses: "
              + ", ".join(f"{v:.1f}" for v in losses.reshape(-1, 50).mean(axis=1)))
        print(f"{label}, seed {seed}: median loss over the first 50 steps {early:.2f}, over the last "
              f"50 {late:.2f} (fell {early - late:.2f} nats, bar {GP_FALL[name]:.0f}; level "
              f"{GP_LEVEL[name]:.0f}) met {met}; graphed train step {step_ms:.3f} ms (chunks of "
              f"50, host clock, synchronised), eager {graph_train['eager_step_ms']:.3f} ms; {smi}")
        if graph.replays != GP_TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"{label}, seed {seed}: {graph.replays} replays, finite "
                                 f"{np.isfinite(losses).all()}")
        draws.append(dict(seed=seed, early=early, late=late, step_ms=step_ms, met=met))
        if seed == FAMILY_SEEDS[0]:
            first = (trainer, counted, graph)
        else:
            del trainer, graph
            release()
        if met:
            break
    if not any(d["met"] for d in draws):
        raise AssertionError(f"{label}: the loss fell by {GP_FALL[name]} nats to "
                             f"{GP_LEVEL[name]} in no draw")
    trainer, counted, graph = first
    data = sample(torch.Generator(device="cuda").manual_seed(4))
    with recorded_rows() as rows:
        check_train_step(trainer.model, summary, torch.Generator(device="cuda").manual_seed(4),
                         dtype, term_scale=True, data=data,
                         build=lambda use_kernels: train_gp.build_trainer(
                             summary, 100, 1562, "cuda", use_kernels=use_kernels, dtype=dtype),
                         build32=lambda: train_gp.build_trainer(summary, 100, 1562, "cuda"))
    print_rows(f"{label} train step", rows, dtype)
    path = path_launches(f"{label} training", counted, graph, WARMUP_CALLS + 1, call)
    return dict(path=path, step_ms=draws[0]["step_ms"], eager_step_ms=graph_train["eager_step_ms"],
                draws=draws)


def check_set_kernels(gen) -> dict:
    """Phase 22 (c): K2 and K3 at the set and attention family's decoder
    rows with the RBF runs' own decoder weights (C = H = 128, L1 = 3, O =
    2): K2 at a scoring batch of 256 functions of 128 points (CNP and
    AttnCNP one draw, 32,768 rows; AttnLNP 8 draws, 262,144; LNP 32 draws,
    1,048,576, the largest row count the chain has met: M * C = 1.3e8 <
    2^31, each thread's row offsets in range) and at a train step of 32
    (4,096; the NPML variants at 32 x 128 x 32 = 131,072 for LNP and x 8 =
    32,768 for AttnLNP), K3 at the train steps' rows; each at phases 4-5's
    bars, two launches bit-identical. -> {"K2": rows, "K3": rows}."""
    w = {m: chain_weights(score_gp.load_model(run, "cuda").decoder.module)
         for m, run in (("cnp", SET_CNP), ("lnp", SET_LNP), ("attnlnp", SET_ATTNLNP))}
    rows = 256 * GP_POINTS
    train = TRAIN_BATCH * GP_POINTS
    with torch.inference_mode():
        k2 = check_k2([
            ("decoder set cnp", k2_inputs(rows, 128, 128, 3, 2, True, gen, w["cnp"]), False),
            ("decoder set attnlnp", k2_inputs(8 * rows, 128, 128, 3, 2, True, gen, w["attnlnp"]),
             False),
            ("decoder set lnp", k2_inputs(32 * rows, 128, 128, 3, 2, True, gen, w["lnp"]), False),
            ("decoder set cnp train", k2_inputs(train, 128, 128, 3, 2, True, gen, w["cnp"]),
             False),
            ("decoder set lnp npml train", k2_inputs(32 * train, 128, 128, 3, 2, True, gen,
                                                     w["lnp"]), False),
            ("decoder set attnlnp npml train", k2_inputs(8 * train, 128, 128, 3, 2, True, gen,
                                                         w["attnlnp"]), False),
        ])
        k3 = check_k3([
            ("decoder set cnp train", k3_inputs(train, 128, 128, 3, 2, True, gen,
                                                w["cnp"][:5]), False),
            ("decoder set lnp npml train", k3_inputs(32 * train, 128, 128, 3, 2, True, gen,
                                                     w["lnp"][:5]), False),
            ("decoder set attnlnp npml train", k3_inputs(8 * train, 128, 128, 3, 2, True, gen,
                                                         w["attnlnp"][:5]), False),
        ])
    return {"K2": k2, "K3": k3}


def check_img_kernels(gen) -> dict:
    """Phase 24: K2 and K3 at the image paths' rows with the runs' own
    decoder weights (C = H = 128, L1 = 3; O = 2, or 6 on the RGB corpora):
    K2 at the scoring batches (32 images: GridConvCNP 32 x 32 x 32 = 32,768
    rows, zsmms on its 32x32 test canvas, rgb_digits at O = 6, the XL model
    at 32 x 128 x 128 = 524,288, CNP 32,768, AttnLNP's 8 draws 262,144,
    LNP's 32 draws 1,048,576 at O = 2 and at O = 6) and the train steps
    (zsmms' 20x20 training canvas 12,800), K3 at the train steps (32,768 at
    O = 2 and 6; zsmms 12,800; XL 524,288; LNP and AttnLNP one draw,
    32,768); each at phases 4-5's bars, two launches bit-identical, timed
    from a CUDA graph beside the bound. -> {"K2": rows, "K3": rows}."""
    runs = {"cnp": ("digits", "GridConvCNP"), "zsmms": ("zsmms", "GridConvCNP", "run_1"),
            "rgb": ("rgb_digits", "GridConvCNP"), "xl": ("rgb_digits128", "GridConvCNPXL"),
            "set cnp": ("digits", "CNP"), "set lnp": ("digits", "LNP"),
            "set attnlnp": ("digits", "AttnLNP"), "rgb lnp": ("rgb_digits", "LNP")}
    w = {}
    for k, (d, m, *r) in runs.items():
        w[k] = chain_weights(score_img.load_model(
            os.path.join(RESULTS, d, m, r[0] if r else "run_0"), "cuda").decoder.module)
    img, xl, zs = 32 * 32 * 32, 32 * 128 * 128, 32 * 20 * 20

    def k2(name, M, key, O):
        return (f"decoder img {name}", k2_inputs(M, 128, 128, 3, O, True, gen, w[key]), False)

    def k3(name, M, key, O):
        return (f"decoder img {name}", k3_inputs(M, 128, 128, 3, O, True, gen, w[key][:5]),
                False)

    with torch.inference_mode():
        k2_rows = check_k2([
            k2("gridconvcnp", img, "cnp", 2), k2("zsmms", img, "zsmms", 2),
            k2("zsmms train", zs, "zsmms", 2), k2("rgb", img, "rgb", 6), k2("xl", xl, "xl", 6),
            k2("cnp", img, "set cnp", 2), k2("attnlnp", 8 * img, "set attnlnp", 2),
            k2("lnp", 32 * img, "set lnp", 2), k2("rgb lnp", 32 * img, "rgb lnp", 6),
        ])
        k3_rows = check_k3([
            k3("gridconvcnp train", img, "cnp", 2), k3("zsmms train", zs, "zsmms", 2),
            k3("rgb train", img, "rgb", 6), k3("xl train", xl, "xl", 6),
            k3("lnp train", img, "set lnp", 2), k3("attnlnp train", img, "set attnlnp", 2),
        ])
    return {"K2": k2_rows, "K3": k3_rows}


def check_img_scores(smi) -> tuple:
    """Phases 25-26: each of the 20 scorable image runs scored with
    `score_img.score_run` over its whole test set (160, 256 or 1,024
    images), every batch after the first replayed from its CUDA graph, held
    to the band of the JAX package's eval draws through the port's CPU
    forward (`tests/jax_bf16_family_gaps.json`), the record's band printed
    beside; the wrappers' counts at the eager batch and the capture. For one
    run of each family (`IMG_FAMILIES`): the graphed scores against eager
    ones, the launches of a traced replay, one batch replayed and eager,
    timed. -> ({family: `path_launches`}, {family: (eager ms, replay ms)})."""
    misses, paths, batch_ms = [], {}, {}
    for run_dir in IMG_RUNS:
        name = os.path.relpath(run_dir, RESULTS)
        summary = score_img.read_summary(run_dir)
        call = img_call(summary["model"])
        reset_counts()
        out = score_img.score_run(run_dir, device="cuda")
        counted = counts()
        n_batches = out["n"] // score_img.EVAL_BATCH
        graph = out["graph"]
        if graph is None or graph.replays != n_batches - 1:
            raise AssertionError(f"{name}: scored without its batch graph")
        if counted != tuple(2 * c for c in call):
            raise AssertionError(f"{name}: wrapper launches {counted} at the eager batch and the "
                                 f"capture, not {tuple(2 * c for c in call)}")
        if not (out["n"] == summary["n_test"] and np.isfinite(out["ll"]).all()):
            raise AssertionError(f"{name}: non-finite or missing per-image results")
        lo, hi = BF16_GAPS[name]["f32_bands"]["mean_ll"]
        r0, r1 = record_band(run_dir)
        inside = lo <= out["mean_ll"] <= hi
        print(f"{name}: mean LL {out['mean_ll']:.3f} over {out['n']} images in [{lo:.2f}, "
              f"{hi:.2f}] (JAX's eval draws, the port's CPU forward, "
              f"{BF16_GAPS[name]['f32']['mean_ll']:.3f}) {inside}; recorded "
              f"{summary['mean_test_ll']:.2f}, its band [{r0:.2f}, {r1:.2f}]: inside "
              f"{r0 <= out['mean_ll'] <= r1}; launches {counted}; {out['seconds']:.2f}s")
        if not inside:
            misses.append(name)
        kind = IMG_FAMILIES.get(run_dir)
        if kind is not None:
            paths[kind] = path_launches(f"{kind} scoring", counted, graph, 2, call)
            t = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graph.replay()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            reset_counts()
            eager = score_img.score_run(run_dir, device="cuda", graphed=False)
            if counts() != tuple(n_batches * c for c in call) or eager["graph"] is not None:
                raise AssertionError(f"{name}: eager scoring launched {counts()}")
            diff = np.abs(out["ll"] - eager["ll"])
            bar = IMG_GRAPH_LL_RTOL * np.maximum(np.abs(eager["ll"]), 1.0)
            batch_ms[kind] = (1e3 * eager["seconds"] / n_batches, 1e3 * float(np.median(t)))
            print(f"{name}: graphed against eager scoring, largest LL difference "
                  f"{diff.max():.3e} (bar {IMG_GRAPH_LL_RTOL:g} of each |LL|: worst ratio "
                  f"{(diff / bar).max() * IMG_GRAPH_LL_RTOL:.2e}); one batch of 32 replayed "
                  f"{batch_ms[kind][1]:.3f} ms (median of 5, host clock), eager "
                  f"{batch_ms[kind][0]:.3f} ms (mean, its first batch included); {smi}")
            if (diff > bar).any():
                raise AssertionError(f"{name}: graphed scoring differs from eager scoring")
            del eager
        del out, graph
        release()
    print(f"{len(IMG_RUNS) - len(misses)} of {len(IMG_RUNS)} image runs inside the bands of JAX's "
          f"eval draws through the port's CPU forward ({smi})")
    if misses:
        raise AssertionError(f"image runs outside their bands: {', '.join(misses)}")
    return paths, batch_ms


def check_img_batch(run_dir, smi) -> dict:
    """Phase 26: the first 32 test images of an image run on the kernel path
    against the plain path, the masks and z draws from generators seeded
    alike: loc and scale within `PATH_TOL`."""
    summary = score_img.read_summary(run_dir)
    _, test = get_train_test_img_dataset(summary["dataset"])
    splitter = score_img.splitter_for(summary["model"], score_img.test_upscale(test))
    y = test.images[:score_img.EVAL_BATCH].cuda()
    outs = {}
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for label, use_kernels in (("kernel", True), ("plain", False)):
            model = score_img.load_model(run_dir, "cuda", use_kernels=use_kernels)
            g = torch.Generator(device="cuda").manual_seed(1)
            ll, o = score_img.score_batch(model, splitter, g, y)
            outs[label] = (o.p_yCc.loc.clone(), o.p_yCc.scale.clone(), ll.clone())
            del model, o
    loc_err, scale_err, ll_err = ((a - b).abs().max().item()
                                  for a, b in zip(outs["kernel"], outs["plain"]))
    print(f"{os.path.relpath(run_dir, RESULTS)}: one batch of 32 images x "
          f"{outs['kernel'][0].shape[0]} draws, kernel vs plain path: loc {loc_err:.3e}, scale "
          f"{scale_err:.3e}, LL {ll_err:.3e}; {smi}")
    if not (loc_err <= PATH_TOL and scale_err <= PATH_TOL):
        raise AssertionError(f"{run_dir}: the kernel path disagrees with the plain path")
    return dict(loc_err=loc_err, scale_err=scale_err, ll_err=ll_err)


def check_img_diag(smi) -> dict:
    """Phase 27: `score_img --diag` on zsmms/GridConvCNP/run_1, its four rows
    beside `zsmms_diag.json`'s (the JAX package's draws): finite, and in
    the record's order (the training canvas above the test canvas, each
    BatchNorm remedy above the frozen statistics)."""
    t0 = time.perf_counter()
    res = score_img.diag(IMG_ZSMMS, "cuda")
    print("zsmms/GridConvCNP/run_1 diagnosis, port (zsmms_diag.json): " + ", ".join(
        f"{k} {res[k]:.2f} ({IMG_DIAG_JAX[k]:.2f})" for k in IMG_DIAG_ROWS)
        + f"; {time.perf_counter() - t0:.2f}s; {smi}")
    ordered = (res["train_canvas"] > res["test_canvas"]
               and min(res["test_canvas_batchstats"], res["test_canvas_adapted"])
               > res["test_canvas"])
    if not (all(np.isfinite(res[k]) for k in IMG_DIAG_ROWS) and ordered):
        raise AssertionError("the zsmms diagnosis is not finite or not in the record's order")
    release()
    return res


def check_img_graph_train(model, dataset, images, dtype=None) -> None:
    """Phase 28 (32 in bf16): three graphed train steps of an image
    configuration in compute `dtype` against three eager steps from a
    trainer with the same init and generator seed: losses, parameters and
    statistics bit-identical."""
    y_dim = images.shape[-1]
    sample = train_img.image_sampler(images, TRAIN_BATCH)
    eager = train_img.build_trainer(model, dataset, y_dim, 50, 50, "cuda", seed=0, dtype=dtype)
    e_losses = torch.stack([eager._update(*sample(eager.state.generator))["loss"]
                            for _ in range(3)])
    e_state = {k: t.clone() for k, t in eager.model.state_dict().items()}
    del eager  # one trainer's activations at a time (the attention models' are large)
    release()
    graphed = train_img.build_trainer(model, dataset, y_dim, 50, 50, "cuda", seed=0, dtype=dtype)
    g_losses = graphed.train_steps_generated(sample, 3)
    same = torch.equal(e_losses, g_losses) and all(
        torch.equal(e_state[k], t) for k, t in graphed.model.state_dict().items())
    print(f"{model} on {dataset}{' (bf16)' if dtype is not None else ''}: three graphed steps "
          f"against three eager ones, losses "
          f"{g_losses.tolist()}, parameters and statistics bit-identical {same}")
    if not same:
        raise AssertionError(f"{model} on {dataset}: the graphed step differs from the eager one")
    del graphed, e_state
    release()


def _img_stat(kind, losses) -> tuple:
    """(first, last) of a 300-step loss trajectory by `IMG_JAX`'s statistic."""
    first = {"median50": lambda: np.median(losses[:50]),
             "median101": lambda: np.median(losses[100:150]),
             "mean100": lambda: losses[:100].mean(), "mean200": lambda: losses[100:200].mean()}
    last = np.median(losses[-50:]) if kind.startswith("median") else losses[-100:].mean()
    return float(first[kind]()), float(last)


def check_img_family(name, model, dataset, steps, smi, dtype=None) -> dict:
    """Phase 28, one image training path (`IMG_TRAIN`) in compute `dtype`
    (phase 32 in bf16): the graphed step against the eager one
    (`check_img_graph_train`); `steps` graphed steps at batch 32 from seed
    0 (seeds 1 and 2 only while no draw has met the bars) through
    `train_img.train`, each draw's first and last value by its bars'
    statistic (`IMG_JAX`) held to `IMG_FALL` and `IMG_LEVEL` (the float32
    path's in either dtype); in bf16 one step of seed 0's trained model on
    the kernel path against the plain-kernel path (phase 11's check); the
    launches of a traced replay of seed 0's graph. -> the path's
    numbers."""
    train_ds, _ = get_train_test_img_dataset(dataset)
    images = train_ds.images.cuda()
    label = name if dtype is None else f"{name} bf16"
    check_img_graph_train(model, dataset, images, dtype)
    sched = train_img.schedule(len(train_ds), 50, TRAIN_BATCH, steps)
    kind = IMG_JAX[name][0]
    draws = []
    for seed in FAMILY_SEEDS:
        trainer = train_img.build_trainer(model, dataset, images.shape[-1], 50,
                                          sched["steps_per_epoch"], "cuda", seed, dtype=dtype)
        reset_counts()
        history, losses, seconds = train_img.train(trainer, images, TRAIN_BATCH, sched,
                                                   verbose=False)
        counted = counts()
        (graph,) = trainer.graphs.values()
        losses = losses.cpu().numpy()
        first, last = _img_stat(kind, losses)
        step_ms = 1e3 * float(np.median(np.diff([0.0] + [h["dur"] for h in history])[1:])) \
            / sched["chunk"]
        met = first - last >= IMG_FALL[name] and last <= IMG_LEVEL[name]
        print(f"{label}, seed {seed}: {sched['steps']} graphed steps in {seconds:.2f}s, "
              f"{graph.replays} replays; 50-step mean losses: "
              + ", ".join(f"{v:.1f}" for v in losses.reshape(-1, 50).mean(axis=1)))
        print(f"{label}, seed {seed}: {kind} first {first:.2f}, last {last:.2f} (fell "
              f"{first - last:.2f}, bar {IMG_FALL[name]:.1f}; level {IMG_LEVEL[name]:.1f}) met "
              f"{met}; graphed train step {step_ms:.3f} ms (chunks of {sched['chunk']}, host "
              f"clock, synchronised); {smi}")
        if graph.replays != sched["steps"] or not np.isfinite(losses).all():
            raise AssertionError(f"{label}, seed {seed}: {graph.replays} replays, finite "
                                 f"{np.isfinite(losses).all()}")
        draws.append(dict(seed=seed, first=first, last=last, step_ms=step_ms, met=met))
        if seed == FAMILY_SEEDS[0]:
            first_run = (counted, graph)
            if dtype is not None:
                y_dim = images.shape[-1]
                spe = sched["steps_per_epoch"]
                y = train_img.image_sampler(images, TRAIN_BATCH)(
                    torch.Generator(device="cuda").manual_seed(4))
                with recorded_rows() as rows:
                    check_train_step(trainer.model, None,
                                     torch.Generator(device="cuda").manual_seed(4), dtype,
                                     term_scale=True, data=y,
                                     build=lambda use_kernels: train_img.build_trainer(
                                         model, dataset, y_dim, 50, spe, "cuda",
                                         use_kernels=use_kernels, dtype=dtype),
                                     build32=lambda: train_img.build_trainer(
                                         model, dataset, y_dim, 50, spe, "cuda"))
                print_rows(f"{label} train step", rows, dtype)
        else:
            del graph
        del trainer
        release()
        if met:
            break
    if not any(d["met"] for d in draws):
        raise AssertionError(f"{label}: the loss fell by {IMG_FALL[name]} nats to "
                             f"{IMG_LEVEL[name]} in no draw")
    counted, graph = first_run
    call = img_train_call(model)
    path = path_launches(f"{label} training", counted, graph, WARMUP_CALLS + 1,
                         call if dtype is None else bf16_call(call))
    del graph
    release()
    return dict(path=path, step_ms=draws[0]["step_ms"], draws=draws)


def check_img_xl(smi) -> dict:
    """Phase 28: GridConvCNPXL (12 blocks) on rgb_digits128 at batch 32,
    `IMG_XL_STEPS` graphed steps with the blocks' activations stored and
    `IMG_XL_REMAT_STEPS` rematerialised (`--remat`): finite losses, K2 and
    K3 once a replay, the peak device memory and the step time."""
    train_ds, _ = get_train_test_img_dataset("rgb_digits128")
    images = train_ds.images.cuda()
    out = {}
    for remat, steps in ((False, IMG_XL_STEPS), (True, IMG_XL_REMAT_STEPS)):
        sched = train_img.schedule(len(train_ds), 100, TRAIN_BATCH, steps)
        release()
        torch.cuda.reset_peak_memory_stats()
        trainer = train_img.build_trainer("GridConvCNPXL", "rgb_digits128", 3, 100,
                                          sched["steps_per_epoch"], "cuda", 0, remat)
        reset_counts()
        _, losses, seconds = train_img.train(trainer, images, TRAIN_BATCH, sched, verbose=False)
        torch.cuda.synchronize()
        counted = counts()
        (graph,) = trainer.graphs.values()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = losses.cpu().numpy()
        label = "rematerialised" if remat else "stored"
        per_replay = trace_replay(graph, f" of the XL {label} train graph", (0, 1, 1, 0, 0))
        print(f"GridConvCNPXL, rgb_digits128, blocks {label}: {steps} graphed steps in "
              f"{seconds:.2f}s, losses {losses[0]:.4g} -> {losses[-1]:.4g}; one step replayed "
              f"{step_ms:.3f} ms (host clock, synchronised); peak memory "
              f"{peak:.2f} GiB allocated; wrapper launches {counted}, a replay {per_replay}; {smi}")
        if not (np.isfinite(losses).all() and per_replay == (0, 1, 1, 0, 0)):
            raise AssertionError(f"GridConvCNPXL ({label}): non-finite losses or launches "
                                 f"{per_replay}")
        out[label] = dict(step_ms=step_ms, peak_gib=peak,
                          first_loss=float(losses[0]), last_loss=float(losses[-1]))
        del trainer, graph
    release()
    return out


def run_img_phases(gen, smi) -> dict:
    """Phases 24-28, the grid and image family, in order (module docstring)."""
    phase("image kernels: K2 and K3 at the image decoders' rows (B x H x W x n_z; O = 2 and 6) "
          "with the runs' own weights vs plain")
    kernels = check_img_kernels(gen)
    release()
    phase("the 20 image runs: each scored over its whole test set, graphed, held to the bands "
          "of JAX's eval draws through the port's CPU forward; one run of each family against "
          "eager scoring")
    score_paths, batch_ms = check_img_scores(smi)
    phase("the image paths: one batch of each family, kernel path vs plain path")
    batch = {IMG_FAMILIES[r]: check_img_batch(r, smi) for r in IMG_FAMILIES}
    release()
    phase("zsmms_diag: the four rows of zsmms/GridConvCNP/run_1")
    diag = check_img_diag(smi)
    train = {}
    for name, model, dataset, steps in IMG_TRAIN:
        phase(f"image training path {name}: {model} on {dataset}, graphed against eager, "
              f"{steps} graphed steps from seeds {FAMILY_SEEDS}")
        train[name] = check_img_family(name, model, dataset, steps, smi)
    phase(f"GridConvCNPXL on rgb_digits128: {IMG_XL_STEPS} graphed steps stored, "
          f"{IMG_XL_REMAT_STEPS} rematerialised; peak memory")
    xl = check_img_xl(smi)
    print(f"image paths (host clock, synchronised; {smi}): " + json.dumps(
        {"score_batch_ms": batch_ms, "batch": batch, "diag": diag, "xl": xl,
         "train": {k: {m: f[m] for m in ("step_ms", "draws")} for k, f in train.items()}}))
    return dict(kernels=kernels, score_paths=score_paths, train=train)


def bf16_call(call: tuple) -> tuple:
    """A float32 path's launches (K1, K2, K3, K2-bf16, K3-bf16) in bf16: K1
    as it is (float32 in either dtype), K2 and K3 as their bf16 kernels."""
    return (call[0], 0, 0, call[1], call[2])


@contextlib.contextmanager
def recorded_rows():
    """Inside, each forward and backward of the MLP chain's autograd
    Function (K2 and K3, or K2-bf16 and K3-bf16, on the kernel path)
    appends (kernel, rows, dtype) to the list yielded: the rows a launch
    of it runs on the path."""
    rows = []
    fwd, bwd = mlp_chain.FusedReluMLPFn.forward, mlp_chain.FusedReluMLPFn.backward

    def rec_fwd(ctx, x, *args):
        rows.append(("K2", x.shape[0], x.dtype))
        return fwd(ctx, x, *args)

    def rec_bwd(ctx, g):
        rows.append(("K3", g.shape[0], g.dtype))
        return bwd(ctx, g)

    mlp_chain.FusedReluMLPFn.forward = staticmethod(rec_fwd)
    mlp_chain.FusedReluMLPFn.backward = staticmethod(rec_bwd)
    try:
        yield rows
    finally:
        mlp_chain.FusedReluMLPFn.forward = staticmethod(fwd)
        mlp_chain.FusedReluMLPFn.backward = staticmethod(bwd)


def print_rows(label, rows, dtype=None) -> dict:
    """Print the distinct row counts of the chain launches recorded in
    `rows` (`recorded_rows`) in compute `dtype` -> {kernel: sorted counts}."""
    dt = torch.float32 if dtype is None else dtype
    out = {}
    for kernel, m, d in rows:
        if d == dt:
            name = kernel if dtype is None else f"{kernel}-bf16"
            out.setdefault(name, set()).add(int(m))
    out = {k: sorted(v) for k, v in out.items()}
    print(f"{label}: rows a launch of the chain (recorded at its autograd Function) {out or 'none'}")
    return out


def check_bf16_family_kernels(gen) -> dict:
    """Phase 29: K2-bf16 and K3-bf16 at the bf16 GP and image paths' decoder
    rows with the runs' own decoder weights (C = H = 128, L1 = 3; O = 2, or
    6 on the RGB corpora): K2-bf16 at the scoring batches (the GP ConvCNP,
    CNP and AttnCNP 256 functions x 128 points, 32,768 rows; AttnLNP's 8
    draws 262,144; LNP's 32 draws 1,048,576; 32 images of 32x32, 32,768, at
    O = 2 and 6; the XL's 524,288 at O = 6; the image LNP's 32 draws
    1,048,576 at O = 2 and 6) and the train steps (4,096 for 32 GP
    functions, the NPML AttnLNP's 32,768 and SUMO LNP's 131,072), K3-bf16 at
    the train steps (4,096; 32,768 and 131,072; 32,768 for the image
    GridConvCNP, CNP and LNP); each at phases 9-10's bars (its plain
    version's rounding), two launches bit-identical, timed in a CUDA graph
    beside the bound, the plain version and the bf16 cuBLAS chain. ->
    {"K2-bf16": rows, "K3-bf16": rows}."""
    w = {k: chain_weights(score_gp.load_model(r, "cuda").decoder.module)
         for k, r in (("gp cnp", GP_CNP), ("set cnp", SET_CNP), ("set attncnp", SET_ATTNCNP),
                      ("set lnp", SET_LNP), ("set attnlnp", SET_ATTNLNP))}
    for k, (d, m) in {"img cnp": ("digits", "GridConvCNP"), "img rgb": ("rgb_digits", "GridConvCNP"),
                      "img xl": ("rgb_digits128", "GridConvCNPXL"),
                      "img set cnp": ("digits", "CNP"), "img set lnp": ("digits", "LNP"),
                      "img rgb lnp": ("rgb_digits", "LNP")}.items():
        w[k] = chain_weights(score_img.load_model(os.path.join(RESULTS, d, m, "run_0"),
                                                  "cuda").decoder.module)
    score, train, img, xl = 256 * GP_POINTS, TRAIN_BATCH * GP_POINTS, 32 * 32 * 32, 32 * 128 * 128

    def k2(name, M, key, O=2):
        return (f"decoder bf16 {name}", k2_inputs(M, 128, 128, 3, O, True, gen, w[key], BF16),
                False)

    def k3(name, M, key, O=2):
        return (f"decoder bf16 {name}", k3_inputs(M, 128, 128, 3, O, True, gen, w[key][:5], BF16),
                False)

    with torch.inference_mode():
        k2_rows = check_k2_bf16([
            k2("gp cnp", score, "gp cnp"), k2("gp cnp train", train, "gp cnp"),
            k2("set cnp", score, "set cnp"), k2("set attncnp", score, "set attncnp"),
            k2("set attnlnp", 8 * score, "set attnlnp"), k2("set lnp", 32 * score, "set lnp"),
            k2("set cnp train", train, "set cnp"),
            k2("set attnlnp npml train", 8 * train, "set attnlnp"),
            k2("set lnp sumo train", 32 * train, "set lnp"),
            k2("img gridconvcnp", img, "img cnp"), k2("img rgb", img, "img rgb", 6),
            k2("img xl", xl, "img xl", 6), k2("img cnp", img, "img set cnp"),
            k2("img lnp", 32 * img, "img set lnp"), k2("img rgb lnp", 32 * img, "img rgb lnp", 6),
        ])
        k3_rows = check_k3_bf16([
            k3("gp cnp train", train, "gp cnp"), k3("set cnp train", train, "set cnp"),
            k3("set attnlnp train", train, "set attnlnp"),
            k3("set attnlnp npml train", 8 * train, "set attnlnp"),
            k3("set lnp sumo train", 32 * train, "set lnp"),
            k3("img gridconvcnp train", img, "img cnp"), k3("img cnp train", img, "img set cnp"),
            k3("img lnp train", img, "img set lnp"),
        ])
    return {"K2-bf16": k2_rows, "K3-bf16": k3_rows}


def _bar_run(run_dir) -> tuple:
    """(summary, kernels a GP run scores or 1 for an image run, float32 call,
    score(dtype, graphed) -> {ll, n, mean_ll, seconds, graph(s)}) of a bar
    run: a GP run's GP_N_TEST functions a kernel (`score_gp.score_run`; in
    float32 phases 19 and 21's scores, `GP_F32_LL`), an image run's test
    set `IMG_BF16_PASSES` times over, each pass under other context masks
    and z draws (`score_img.score_images`)."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    if run_dir in GP_BF16_RUNS:
        def score(dtype, graphed=True):
            if dtype is None and graphed and run_dir in GP_F32_LL:
                return {"ll": GP_F32_LL[run_dir]}
            if graphed:
                return score_gp.score_run(run_dir, GP_N_TEST, "cuda", dtype=dtype)
            with no_graphs():
                return score_gp.score_run(run_dir, GP_N_TEST, "cuda", dtype=dtype)
        return summary, len(score_gp.samplers(summary["kernel"])[1]), gp_call(summary), score

    _, test = get_train_test_img_dataset(summary["dataset"])
    passes = IMG_BF16_PASSES.get(summary["model"], IMG_BF16_PASSES_DEFAULT)
    images = test.images.repeat(passes, 1, 1, 1)
    splitter = score_img.splitter_for(summary["model"], score_img.test_upscale(test))

    def score(dtype, graphed=True):
        model = score_img.load_model(run_dir, "cuda", dtype=dtype)
        out = score_img.score_images(model, splitter, images, "cuda", graphed=graphed)
        return dict(out, n=int(out["ll"].shape[0]), mean_ll=float(out["ll"].mean()))
    return summary, 1, img_call(summary["model"]), score


def check_bf16_scores(smi) -> tuple:
    """Phases 30-31: each of the 21 bar runs (`GP_BF16_RUNS`, `IMG_BF16_RUNS`)
    scored in float32 and in bf16 (`_bar_run`: GP_N_TEST fresh functions a
    kernel, or the test set several times over), the
    same functions or images, splits and z draws in both dtypes, every batch
    after a kernel's first replayed from its CUDA graph; the wrappers'
    counts at the eager batches and the captures (K2-bf16 in place of K2);
    the bf16-float32 mean-LL gap held to `bf16_gap_bar` (the JAX package's
    own gap with the fused MLP-chain decoder, within the larger of 0.3 nats
    and 3 standard errors of the two gaps' difference), JAX's Dense-decoder
    gap printed beside.
    For one run of each family (`BF16_FAMILIES`): the graphed bf16 scores
    against eager ones (GP: `GRAPH_LL_ATOL`; images: `IMG_GRAPH_LL_RTOL` of
    each |LL|), the chain's rows recorded at the eager batches, the launches
    of a traced replay, a replay's time; the XL's peak memory in bf16. ->
    ({family: `path_launches`}, {family: (eager ms, replay ms)}, gaps)."""
    misses, paths, batch_ms, gaps = [], {}, {}, {}
    for run_dir in GP_BF16_RUNS + IMG_BF16_RUNS:
        name = os.path.relpath(run_dir, RESULTS)
        summary, n_comp, call, score = _bar_run(run_dir)
        call16 = bf16_call(call)
        ll32 = score(None)["ll"].astype(np.float64)
        release()
        if run_dir == IMG_XL:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = score(BF16)
        counted = counts()
        graphs = out["graphs"] if "graphs" in out else [out["graph"]]
        n_batches = out["n"] // (n_comp * (256 if run_dir in GP_BF16_RUNS
                                           else score_img.EVAL_BATCH))
        if not (len(graphs) == n_comp and all(g is not None and g.replays == n_batches - 1
                                              for g in graphs)):
            raise AssertionError(f"{name}: scored in bf16 without its batch graphs")
        if counted != tuple(2 * n_comp * c for c in call16):
            raise AssertionError(f"{name}: bf16 wrapper launches {counted} at the eager batches "
                                 f"and the captures, not {tuple(2 * n_comp * c for c in call16)}")
        if not (np.isfinite(out["ll"]).all() and out["ll"].shape == ll32.shape):
            raise AssertionError(f"{name}: non-finite or missing bf16 results")
        d = out["ll"].astype(np.float64) - ll32
        gap = BF16_GAPS[name]["bf16_gap"]
        centre, half = bf16_gap_bar(gap, float(d.std() / np.sqrt(d.shape[0])))
        inside = abs(d.mean() - centre) <= half
        memory = ""
        if run_dir == IMG_XL:
            memory = f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        gaps[name] = dict(n=int(d.shape[0]), d_mean_ll=float(d.mean()), d_ll_std=float(d.std()),
                          mean_ll_bf16=float(out["mean_ll"]), mean_ll_f32=float(ll32.mean()),
                          jax_fused=gap["fused"]["d_mean_ll"], jax_dense=gap["dense"]["d_mean_ll"],
                          bar=[centre - half, centre + half], inside=bool(inside))
        print(f"{name}: bf16 mean LL {out['mean_ll']:.3f}, float32 {ll32.mean():.3f} over "
              f"{d.shape[0]}; gap {d.mean():+.4f} (sd {d.std():.3f}) in [{centre - half:+.3f}, "
              f"{centre + half:+.3f}] (JAX's fused-decoder gap {centre:+.3f} over {gap['n']}, its "
              f"Dense-decoder gap {gap['dense']['d_mean_ll']:+.3f}) {inside}; launches {counted}; "
              f"{out['seconds']:.2f}s{memory}")
        if not inside:
            misses.append(name)
        kind = BF16_FAMILIES.get(run_dir)
        if kind is not None:
            graph = graphs[0]
            paths[kind] = path_launches(f"{kind} bf16 scoring", counted, graph, 2, call16)
            t = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graph.replay()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            reset_counts()
            with recorded_rows() as rows:
                eager = score(BF16, graphed=False)
            if counts() != tuple(n_comp * n_batches * c for c in call16):
                raise AssertionError(f"{name}: eager bf16 scoring launched {counts()}")
            print_rows(f"{kind} bf16 scoring", rows, BF16)
            diff = np.abs(out["ll"] - eager["ll"])
            bar = (np.full(diff.shape, GRAPH_LL_ATOL) if run_dir in GP_BF16_RUNS
                   else IMG_GRAPH_LL_RTOL * np.maximum(np.abs(eager["ll"]), 1.0))
            batch_ms[kind] = (1e3 * eager["seconds"] / (n_comp * n_batches),
                              1e3 * float(np.median(t)))
            print(f"{name}: graphed against eager bf16 scoring, largest LL difference "
                  f"{diff.max():.3e} (worst against its bar {(diff / bar).max():.2e}); one batch "
                  f"replayed {batch_ms[kind][1]:.3f} ms (median of 5, host clock), eager "
                  f"{batch_ms[kind][0]:.3f} ms (mean); {smi}")
            if (diff > bar).any():
                raise AssertionError(f"{name}: graphed bf16 scoring differs from eager scoring")
            del eager, graph
        del out, graphs
        release()
    n_runs = len(GP_BF16_RUNS) + len(IMG_BF16_RUNS)
    print(f"{n_runs - len(misses)} of {n_runs} bar runs' bf16-float32 gaps within their bars "
          f"({smi})")
    if misses:
        raise AssertionError(f"bf16 gaps outside their bars: {', '.join(misses)}")
    return paths, batch_ms, gaps


def check_bf16_batch(run_dir, smi) -> dict:
    """Phase 31: one batch of a bar run (256 GP functions, or the first 32
    test images) in bf16 on the kernel path against the plain-kernel path
    (`plain_kernels`), the functions, splits and z draws from generators
    seeded alike, held to the bf16-float32 gap of the same batch (the
    float32 kernel path's), phase 11's bars: the RMS distance of loc at
    most `BF16_PATH_RMS` of the gap's RMS, the largest `BF16_PATH_MAX` of
    the gap's largest. A path without K1 gives the same bits on both (K2-bf16
    rounds as its plain version)."""
    summary, _, _, _ = _bar_run(run_dir)
    if run_dir in GP_BF16_RUNS:
        sampler, splitter = score_gp.samplers(summary["kernel"])[1][0], score_gp.eval_splitter()
        load = lambda dtype: score_gp.load_model(run_dir, "cuda", dtype=dtype)  # noqa: E731
        batch = lambda m, g: score_gp.score_batch(m, splitter, g, sampler)  # noqa: E731
    else:
        _, test = get_train_test_img_dataset(summary["dataset"])
        splitter = score_img.splitter_for(summary["model"], score_img.test_upscale(test))
        y = test.images[:score_img.EVAL_BATCH].cuda()
        load = lambda dtype: score_img.load_model(run_dir, "cuda", dtype=dtype)  # noqa: E731
        batch = lambda m, g: score_img.score_batch(m, splitter, g, y)  # noqa: E731
    outs = {}
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for label, dtype, ctx in (("kernel", BF16, contextlib.nullcontext),
                                  ("plain-kernel", BF16, plain_kernels),
                                  ("float32", None, contextlib.nullcontext)):
            model = load(dtype)
            with ctx():
                ll, o = batch(model, torch.Generator(device="cuda").manual_seed(1))
            outs[label] = (o.p_yCc.loc.clone(), o.p_yCc.scale.clone(), ll.clone())
            del model, o
    rms = lambda a: a.float().square().mean().sqrt().item()  # noqa: E731
    loc_k, loc_p, loc_32 = outs["kernel"][0], outs["plain-kernel"][0], outs["float32"][0]
    near, gap = rms(loc_k - loc_p), rms(loc_k - loc_32)
    near_max, gap_max = (loc_k - loc_p).abs().max().item(), (loc_k - loc_32).abs().max().item()
    ll_err = (outs["kernel"][2] - outs["plain-kernel"][2]).abs().max().item()
    print(f"{os.path.relpath(run_dir, RESULTS)}: one bf16 batch x {loc_k.shape[0]} draws, kernel "
          f"vs plain-kernel path: loc RMS {near:.3e}, largest {near_max:.3e}; the bf16-float32 "
          f"gap of the same batch: RMS {gap:.3e}, largest {gap_max:.3e}; LL {ll_err:.3e}; {smi}")
    if not (near <= BF16_PATH_RMS * gap and near_max <= BF16_PATH_MAX * gap_max):
        raise AssertionError(f"{run_dir}: the bf16 kernel path disagrees with its plain-kernel "
                             "path")
    return dict(loc_rms=near, loc_max=near_max, gap_rms=gap, gap_max=gap_max, ll_err=ll_err)


def run_bf16_family_phases(gen, smi) -> dict:
    """Phases 29-32, bfloat16 for the GP and image families, in order
    (module docstring)."""
    phase("bf16 GP and image kernels: K2-bf16 and K3-bf16 at the bf16 decoders' rows with the "
          "runs' own weights vs plain")
    kernels = check_bf16_family_kernels(gen)
    release()
    phase("the 21 bar runs in bf16 and float32: each scored graphed on the same functions or "
          "images, the bf16-float32 gap held to JAX's own; one run of each family against eager "
          "scoring")
    score_paths, batch_ms, gaps = check_bf16_scores(smi)
    phase("the bf16 GP and image paths: one batch of each family, kernel path vs plain-kernel path")
    batch = {BF16_FAMILIES[r]: check_bf16_batch(r, smi) for r in BF16_FAMILIES}
    release()
    train = {}
    for name, gp_summary in GP16_TRAIN:
        phase(f"bf16 GP training path {name}: {gp_summary['model']} on {gp_summary['kernel']}, "
              f"graphed against eager, {GP_TRAIN_STEPS} graphed steps from seeds {FAMILY_SEEDS}, "
              "kernel path against plain-kernel path")
        train[name] = check_gp_family(name, gp_summary, smi, BF16)
    for name, model, dataset, steps in IMG16_TRAIN:
        phase(f"bf16 image training path {name}: {model} on {dataset}, graphed against eager, "
              f"{steps} graphed steps from seeds {FAMILY_SEEDS}, kernel path against "
              "plain-kernel path")
        train[name] = check_img_family(name, model, dataset, steps, smi, BF16)
    release()
    free, total = torch.cuda.mem_get_info()
    print(f"bf16 GP and image paths (host clock, synchronised; {smi}): " + json.dumps(
        {"score_batch_ms": batch_ms, "batch": batch, "gaps": gaps,
         "train": {k: {m: f[m] for m in ("step_ms", "draws")} for k, f in train.items()},
         "card_memory_gib": {"used": (total - free) / 2**30, "total": total / 2**30,
                             "peak_allocated": torch.cuda.max_memory_allocated() / 2**30}}))
    return dict(kernels=kernels, score_paths=score_paths, train=train)


def eval_bands() -> dict:
    """The JAX package's evaluation bands (`tests/jax_eval_bands.py`)."""
    with open(EVAL_BANDS_JSON) as f:
        return json.load(f)


def check_eval_kernels(gen) -> dict:
    """Phase 33: K1 at the extrapolation path's shapes with the RBF conv
    runs' length scales (256 functions of 256 sorted points on twice the
    range, contexts U{0..50} among the inner ones by `make_ctx_mask`, onto
    the 384-point grid over (-3, 3); the grid onto the 256 targets at C =
    128, at B = 256 for ConvCNP and 32 x 256 = 8,192 for ConvLNP's draws),
    at the context sweeps' new masks (the flagship's 384-point grid, U{0..128}
    and all 256 points real); K2 at the extrapolation decoders' rows with
    the RBF runs' own weights (65,536 for CNP, AttnCNP and ConvCNP; 524,288
    for AttnLNP's 8 draws; 2,097,152 for LNP's 32, twice the most rows the
    chain has met: M * C = 2.7e8 < 2^31); each at phases 3-4's bars, two
    launches bit-identical, timed beside its bound and its plain version.
    -> {"K1": rows, "K2": rows}."""
    conv = {n: extrap.load_model("RBF_Kernel", n, "cuda", results=RESULTS)
            for n in ("ConvCNP", "ConvLNP")}
    sampler = GPSampler(n_points=256, **KERNEL_CONFIGS["RBF_Kernel"])
    x, y = sampler.sample(gen, 256, min_max=extrap.wide_range(sampler))
    mask = extrap.make_ctx_mask(x, *extrap.draw_ctx(gen, 256, 256)).float()
    keys = x[..., 0].contiguous()
    grid = conv["ConvCNP"]._get_x_induced(256, "cuda")[..., 0].contiguous()
    n_grid, n_z = grid.shape[1], conv["ConvLNP"].n_z_samples_test

    def sig(name, setconv):
        return torch.full((1,), getattr(conv[name], setconv).rbf.sigma().item(), device="cuda")

    def to_targets(name, B):
        rep = B // 256
        return (grid.repeat(rep, 1), keys.repeat(rep, 1),
                torch.randn((B, n_grid, 128), generator=gen, device="cuda"),
                torch.ones((B, n_grid), device="cuda"), sig(name, "induced_to_trgt"))

    flagship = load_model(RUN_DIR, "cuda")
    sig_flag = flagship.cntxt_to_induced.rbf.sigma().item()
    k1 = check_k1([
        ("ctx->grid extrap", (keys, grid, y.contiguous(), mask,
                              sig("ConvCNP", "cntxt_to_induced"))),
        ("grid->trgt extrap", to_targets("ConvCNP", 256)),
        ("ctx->grid extrap convlnp", (keys, grid, y.contiguous(), mask,
                                      sig("ConvLNP", "cntxt_to_induced"))),
        ("grid->trgt extrap convlnp", to_targets("ConvLNP", n_z * 256)),
        ("ctx->grid sweep 128", k1_inputs(256, 256, 384, 1, sig_flag, gen, [0], max_real=128)),
        ("ctx->grid sweep fixed 256", k1_inputs(256, 256, 384, 1, sig_flag, gen, max_real="all")),
    ])
    w = {m: chain_weights(score_gp.load_model(os.path.join(RESULTS, "RBF_Kernel", m, "run_0"),
                                              "cuda").decoder.module)
         for m in ("CNP", "AttnCNP", "AttnLNP", "LNP")}
    w["ConvCNP"] = chain_weights(conv["ConvCNP"].decoder.module)
    del conv, flagship
    rows = 256 * 256
    with torch.inference_mode():
        k2 = check_k2([(f"decoder extrap {m.lower()}",
                        k2_inputs(r, 128, 128, 3, 2, True, gen, w[m]), False)
                       for m, r in (("CNP", rows), ("AttnCNP", rows), ("ConvCNP", rows),
                                    ("AttnLNP", 8 * rows), ("LNP", 32 * rows))])
    return {"K1": k1, "K2": k2}


def _held(values: np.ndarray, stat: str) -> float:
    return float(np.median(values) if stat == "median" else values.mean())


def check_extrapolation(smi) -> tuple:
    """Phase 34: `eval_extrapolation`'s rows of both kernels on the card,
    2,560 functions a row (the oracle on RBF only, as the record), each
    held statistic (`EXTRAP_HELD`) inside the band of the JAX package's own
    values on its draws, the record printed beside; the launches of each
    model's ten batches (`EXTRAP_CALL`); one batch of `EXTRAP_PLAIN` on the
    plain-kernel path against the kernel path. -> ({path: {launches}},
    {row: numbers})."""
    bands = eval_bands()["extrapolation"]
    paths, out, bad = {}, {}, []
    n_batches = EXTRAP_N // 256
    for kernel in EXTRAP_KERNELS:
        with open(os.path.join(RESULTS, f"extrapolation_{kernel}.json")) as f:
            record = {r["model"]: r for r in json.load(f)}
        names = (("oracle",) if kernel == "RBF_Kernel" else ()) + EXTRAP_MODELS
        for name in names:
            reset_counts()
            t0 = time.perf_counter()
            scorer = extrap.oracle_scorer if name == "oracle" else extrap.model_scorer(
                extrap.load_model(kernel, name, "cuda", results=RESULTS), name)
            res = extrap.score_model(scorer, kernel, EXTRAP_N, device="cuda")
            del scorer
            torch.cuda.synchronize()
            seconds, counted = time.perf_counter() - t0, counts()
            row = extrap.row_of(name, kernel, res)
            ref, rec = bands[kernel][row["model"]], record[row["model"]]
            call = EXTRAP_CALL.get(name, (0, 0, 0, 0, 0))
            held = EXTRAP_HELD.get((kernel, row["model"]), EXTRAP_HELD_DEFAULT)
            line = []
            for tag, stat in (("interp", "mean"), ("interp", "median"), ("extrap", "mean"),
                              ("extrap", "median")):
                v, band = _held(res[tag], stat), ref[tag][f"{stat}_band"]
                ok = band[0] <= v <= band[1]
                gated = (tag, stat) in held
                if gated and not ok:
                    bad.append(f"{kernel} {row['model']} {tag} {stat} {v:.3f} outside {band}")
                recorded = f", record {rec[f'{tag}_ll_per_fn']:.2f}" if stat == "mean" else ""
                line.append(f"{tag} {stat} {v:.3f} (JAX {ref[tag][stat]:.3f}, band "
                            f"[{band[0]:.3f}, {band[1]:.3f}]{recorded}"
                            f"{'' if gated else ', not held'}{'' if ok else ', OUTSIDE'})")
            finite = np.isfinite(res["interp"]).all() and np.isfinite(res["extrap"]).all()
            print(f"{kernel} {row['model']}: {row['n_test']} functions in {seconds:.2f}s; "
                  + "; ".join(line) + f"; std {row['interp_std']:.2f} / {row['extrap_std']:.2f} "
                  f"(record {rec['interp_std']:.2f} / {rec['extrap_std']:.2f}); launches "
                  f"{counted}")
            if not finite or row["n_test"] != EXTRAP_N:
                bad.append(f"{kernel} {row['model']}: non-finite or missing values")
            if counted != tuple(n_batches * c for c in call):
                bad.append(f"{kernel} {row['model']}: launches {counted}, not {n_batches} x {call}")
            if name != "oracle":
                paths[f"extrap_{kernel.split('_')[0].lower()}_{name.lower()}"] = dict(
                    launches=counted)
            out[f"{kernel} {row['model']}"] = dict(
                seconds=seconds, **{k: row[k] for k in ("interp_ll_per_fn", "extrap_ll_per_fn")},
                interp_median=_held(res["interp"], "median"),
                extrap_median=_held(res["extrap"], "median"))
            release()
    kernel, name = EXTRAP_PLAIN
    lls = {}
    for label, use_kernels in (("kernel", True), ("plain", False)):
        scorer = extrap.model_scorer(
            extrap.load_model(kernel, name, "cuda", use_kernels, results=RESULTS), name)
        res = extrap.score_model(scorer, kernel, 256, device="cuda", seed=1)
        lls[label] = np.concatenate([res["interp"], res["extrap"]]).astype(np.float64)
    err = np.abs(lls["kernel"] - lls["plain"])
    worst = float((err / (1e-4 * np.abs(lls["plain"]) + 0.02)).max())
    print(f"{kernel} {name}: one batch, kernel vs plain-kernel path: per-function LL largest "
          f"difference {err.max():.3e} ({worst:.3f} of its bar); {smi}")
    if worst > 1.0:
        bad.append(f"{kernel} {name}: the kernel path disagrees with the plain path")
    if bad:
        raise AssertionError("extrapolation: " + "; ".join(bad))
    return paths, out


def sweep_records() -> list:
    """[(run directory under results/, file name, counts)] of the context
    sweep records, sorted."""
    out = []
    for path in sorted(glob.glob(os.path.join(RESULTS, "*", "*", "run_*", "ctx_sweep*.json"))):
        with open(path) as f:
            counts_ = [r["n_context"] for r in json.load(f)]
        out.append((os.path.relpath(os.path.dirname(path), RESULTS), os.path.basename(path),
                    counts_))
    return out


def check_ctx_sweeps(smi) -> tuple:
    """Phase 35: `gw_eval_ctx`'s sweep of each of the nine records at 1,024
    waveforms a count, p50 and p90 at every count inside the bands of the
    JAX package's own values on its draws, the record and the other four
    fields printed beside; the launches (`SWEEP_CALL` a batch). -> ({path:
    {launches}}, {record: seconds})."""
    bands = eval_bands()["ctx_sweep"]
    paths, seconds, bad = {}, {}, []
    records = sweep_records()
    if len(records) != 9:
        raise AssertionError(f"{len(records)} context-sweep records, not 9")
    for rel, fname, counts_ in records:
        fixed = fname.endswith("_fixed.json")
        reset_counts()
        res = gw_eval_ctx.sweep(os.path.join(RESULTS, rel), counts_, fixed, SWEEP_N,
                                device="cuda")
        counted = counts()
        with open(os.path.join(RESULTS, rel, fname)) as f:
            recorded = json.load(f)
        tag = f"{rel} {'fixed' if fixed else 'U{0..n}'}"
        print(f"{tag}: {len(counts_)} counts x {SWEEP_N} waveforms in {res['seconds']:.2f}s, "
              f"launches {counted}")
        n_calls = len(counts_) * (SWEEP_N // 256)
        if counted != tuple(n_calls * c for c in SWEEP_CALL):
            bad.append(f"{tag}: launches {counted}, not {n_calls} x {SWEEP_CALL}")
        for row, rec, ref in zip(res["rows"], recorded, bands[rel][fname]["rows"]):
            if not row["n_context"] == rec["n_context"] == ref["n_context"]:
                raise AssertionError(f"{tag}: counts out of order")
            cells = []
            for key in ("p50", "p90"):
                band = ref[f"{key}_band"]
                ok = band[0] <= row[key] <= band[1]
                if not ok:
                    bad.append(f"{tag} n={row['n_context']} {key} {row[key]:.5g} outside {band}")
                cells.append(f"{key} {row[key]:.5g} (JAX {ref[key]:.5g}, band [{band[0]:.5g}, "
                             f"{band[1]:.5g}], record {rec[key]:.5g}{'' if ok else ', OUTSIDE'})")
            others = ", ".join(f"{k} {row[k]:.4g} ({rec[k]:.4g})" for k in (
                "p99", "low_mc_tercile_p50", "low_mc_tercile_p90", "frac_below_0.03"))
            print(f"   n={row['n_context']}: " + "; ".join(cells) + f"; {others}")
            if not all(np.isfinite(row[k]) for k in row):
                bad.append(f"{tag} n={row['n_context']}: non-finite")
        paths[f"sweep_{rel.replace('/', '_')}{'_fixed' if fixed else ''}"] = dict(
            launches=counted)
        seconds[tag] = res["seconds"]
        release()
    print(f"context sweeps (host clock; {smi}): " + json.dumps(seconds))
    if bad:
        raise AssertionError("context sweeps: " + "; ".join(bad))
    return paths, seconds


def check_tools(smi) -> dict:
    """Phase 36: `profiling.trace` around one replay of the flagship scoring
    batch's CUDA graph writes a Chrome trace whose kernels include K1's and
    K2's; `StepTimer`, a synchronize after each of 20 replays, within
    `TOOL_TIMER_RTOL` of the replay time CUDA events measure around 20
    replays; `viz.gen_p_y_pred` on the flagship run and
    `viz.get_posterior_samples_imgs` on `digits/GridConvCNP/run_0` on the
    card equal to their CPU results within the predictive bar `PATH_TOL`."""
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(RUN_DIR, "cuda")
    gw_gen, space = run_generator(summary), GWParameterSpace()
    splitter = eval_splitter(summary["n_context"])
    g = torch.Generator(device="cuda").manual_seed(3)
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:256]).cuda()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        score_batch(model, splitter, g, theta, gw_gen, space)
        graph = batch_graph(model, splitter, g, theta, gw_gen, space)
        graph.replay(theta)
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp):
                graph.replay(theta)
                torch.cuda.synchronize()
            with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
                events = json.load(f)["traceEvents"]
        names = [e["name"] for e in events if e.get("cat") == "kernel"]
        ids = sorted({k for k in map(hand_kernel_id, names) if k is not None})
        print(f"trace of one replay: {len(names)} kernels, hand kernels {ids}")
        if not {"K1", "K2"} <= set(ids):
            raise AssertionError(f"the trace lists the hand kernels {ids}, not K1 and K2")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TOOL_REPLAYS):
            graph.replay(theta)
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / TOOL_REPLAYS
        timer = profiling.StepTimer(256)
        timer.start()
        for _ in range(TOOL_REPLAYS):
            graph.replay(theta)
            torch.cuda.synchronize()
            timer.tick()
        summary_t = timer.summary()
        timer_ms = 1e3 * summary_t["mean_s"]
        print(f"StepTimer over {TOOL_REPLAYS} synchronised replays: mean {timer_ms:.3f} ms, p50 "
              f"{1e3 * summary_t['p50_s']:.3f}, p90 {1e3 * summary_t['p90_s']:.3f}, "
              f"{summary_t['items_per_s']:.0f} waveforms/s; CUDA events {event_ms:.3f} ms a "
              f"replay ({smi})")
        if abs(timer_ms - event_ms) > TOOL_TIMER_RTOL * event_ms:
            raise AssertionError("StepTimer disagrees with the CUDA events")
        del graph
        release()

        x, y, cond = make_eval_batch(theta[:16], gw_gen, space)
        batch = splitter(torch.Generator(device="cuda").manual_seed(4), x, y, condition=cond)
        obs = torch.randn((4, 16, 256, 1), generator=g, device="cuda")
        preds = {}
        cpu_model = load_model(RUN_DIR, "cpu")
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            b = {k: v.to(dev) for k, v in batch.items()}
            preds[dev] = [t.cpu() for t in viz.gen_p_y_pred(m, b, 4, obs_eps=obs.to(dev))]
        gen_err = max((a - b).abs().max().item() for a, b in zip(preds["cuda"], preds["cpu"]))

        img_run = os.path.join(RESULTS, "digits", "GridConvCNP", "run_0")
        _, test = get_train_test_img_dataset("digits")
        imgs = test.images[:8]
        mask = torch.rand(imgs.shape[:-1] + (1,), generator=torch.Generator().manual_seed(5)) < 0.3
        img = {}
        for dev in ("cuda", "cpu"):
            m = score_img.load_model(img_run, dev)
            img[dev] = [t.cpu() for t in viz.get_posterior_samples_imgs(m, mask.to(dev),
                                                                        imgs.to(dev))]
        img_err = max((a - b).abs().max().item() for a, b in zip(img["cuda"], img["cpu"]))
    print(f"gen_p_y_pred on the flagship run (16 waveforms, 4 noise draws), card vs CPU: "
          f"{gen_err:.3e}; get_posterior_samples_imgs on digits/GridConvCNP (8 images): "
          f"{img_err:.3e} (bar {PATH_TOL})")
    if not (gen_err <= PATH_TOL and img_err <= PATH_TOL):
        raise AssertionError("a viz function on the card disagrees with its CPU result")
    return dict(trace_kernels=len(names), timer_ms=timer_ms, event_ms=event_ms,
                gen_p_y_pred_err=gen_err, posterior_imgs_err=img_err)


def run_eval_tool_phases(gen, smi) -> dict:
    """Phases 33-36, the evaluation and notebook tools, in order (module
    docstring)."""
    phase("evaluation kernels: K1 at the extrapolation grid (384 points over (-3, 3)) and the "
          "sweeps' masks, K2 at 65,536 to 2,097,152 rows, with the runs' own weights vs plain")
    kernels = check_eval_kernels(gen)
    release()
    phase(f"the extrapolation evaluation: both kernels' rows at {EXTRAP_N} functions, held to "
          "the bands of JAX's own values on its draws; one conv run on the plain-kernel path")
    extrap_paths, extrap_rows = check_extrapolation(smi)
    phase(f"the context sweeps: the nine records at {SWEEP_N} waveforms, p50 and p90 held to "
          "the bands of JAX's own values on its draws")
    sweep_paths, sweep_s = check_ctx_sweeps(smi)
    phase("the tools on the card: trace, StepTimer, gen_p_y_pred, get_posterior_samples_imgs")
    tools = check_tools(smi)
    release()
    print(f"evaluation tools (host clock; {smi}): " + json.dumps(
        {"extrapolation": extrap_rows, "sweeps_s": sweep_s, "tools": tools}))
    return dict(kernels=kernels, paths={**extrap_paths, **sweep_paths})


def _mesh_grad_errs(name, grads, ref, state, batch, build, bf16) -> float:
    """The largest per-parameter gradient error of a mesh step against one
    process's (`_step_grad_errs`, the BatchNorm-cancelled biases apart),
    with `rounding_grads`' allowance for a gradient past its bar: the one
    process's path with its kernels' modules rounded apart coming within the
    bar of the mesh's."""
    grad_rtol = BF16_STEP_GRAD_RTOL if bf16 else STEP_GRAD_RTOL
    errs, zero = _step_grad_errs(grads, ref)
    over = [n for n, e in errs.items() if e > grad_rtol]
    if over:
        draws = rounding_grads(None, state, batch, over, build, bf16)
        for n in over:
            scale = ref[n].abs().max().clamp_min(1e-30)
            reach = min((grads[n] - d[n].cpu()).abs().max() for d in draws) / scale
            print(f"   {name}, {n}: {errs[n]:.3e} of its max magnitude from one process; one "
                  f"process with its kernels' modules rounded apart comes within {reach:.3e}")
            errs[n] = reach.item()
    worst = max(errs.values())
    if worst > grad_rtol or max(zero.values()) > grad_rtol:
        raise AssertionError(f"{name}: the mesh step's gradients are not one process's")
    return worst


def check_mesh_nccl(dtype, smi) -> dict:
    """Phase 37 in compute `dtype`, on a one-rank NCCL group: bench.py's
    flagship (`multichip.flagship_trainer`: no BatchNorm, batch 256, fresh
    waveforms every step) through `Trainer(mesh=...)` on a `data` mesh and
    on a 1 x 1 `data` x `seq` mesh. On each, `MESH_GRAPH_CHECK` graphed
    steps bit for bit against as many eager ones (losses and parameters).
    Then, on each mesh, `MESH_STEPS` graphed steps against as many graphed
    steps without a mesh, from the same init and seed: the loss traces and
    the parameters bit for bit (a sum over one rank is a copy, and the mesh
    paths sum in no other order: PERF.md), else the first step at the step
    bars and the trace at `MESH_TRACE_RTOL`; the largest differences
    printed. Each run's replay wall ms (median of the steps after the
    capture, synchronised), the collectives' device share of each mesh
    graph's replay, and each mesh path's launches (`path_launches`)."""
    bf16 = dtype is not None
    tag = " (bf16)" if bf16 else ""
    sample = train_gw.batch_sampler(multichip.FLAGSHIP_DATA, MESH_BATCH)
    meshes = {"data": make_mesh(), "data x seq": make_mesh({"data": 1, "seq": 1})}
    for name, mesh in meshes.items():
        graphed, eager = (multichip.flagship_trainer("cuda", dtype, mesh) for _ in range(2))
        g_losses = graphed.train_steps_generated(sample, MESH_GRAPH_CHECK)
        e_losses = []
        for _ in range(MESH_GRAPH_CHECK):
            x, y, _ = sample(eager.state.generator)
            e_losses.append(eager.train_step(x, y)["loss"])
        same = torch.equal(g_losses, torch.stack(e_losses)) and all(
            torch.equal(a, b) for a, b in zip(graphed.model.parameters(),
                                              eager.model.parameters()))
        print(f"{name} mesh{tag}: {MESH_GRAPH_CHECK} graphed steps against eager ones, losses "
              f"{g_losses.tolist()}, bit for bit {same}")
        if not same:
            raise AssertionError(f"the {name} mesh's graphed steps{tag} are not its eager ones")
        del graphed, eager
        release()
    runs = {}
    for label, mesh in (*meshes.items(), ("plain", None)):
        trainer = multichip.flagship_trainer("cuda", dtype, mesh)
        reset_counts()
        losses, seconds = [], []
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.train_steps_generated(sample, 1))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        (graph,) = trainer.graphs.values()
        runs[label] = dict(trainer=trainer, losses=torch.cat(losses), counted=counts(),
                           graph=graph, ms=1e3 * float(np.median(seconds[1:])))
    plain_run = runs["plain"]
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL) if bf16
                            else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
    # the first step at the step bars, on one batch from fresh trainers
    x, y, _ = sample(torch.Generator(device="cuda").manual_seed(1))

    def first_step(mesh):
        trainer = multichip.flagship_trainer("cuda", dtype, mesh)
        batch = trainer.splitter(torch.Generator(device="cuda").manual_seed(2), x, y)
        loss = trainer.loss_and_grads(batch)
        return loss, {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}

    plain_loss, plain_grads = first_step(None)
    compared = {}
    for name, mesh in meshes.items():
        run = runs[name]
        params = list(zip(run["trainer"].model.parameters(),
                          plain_run["trainer"].model.parameters()))
        bitwise = torch.equal(run["losses"], plain_run["losses"]) and all(
            torch.equal(a, b) for a, b in params)
        trace_rel = ((run["losses"] - plain_run["losses"]).abs()
                     / plain_run["losses"].abs()).max().item()
        param_abs = max((a - b).abs().max().item() for a, b in params)
        loss, grads = first_step(mesh)
        loss_rel = (abs(loss - plain_loss) / abs(plain_loss)).item()
        errs, _ = _step_grad_errs(grads, plain_grads)
        print(f"{name} mesh{tag} against no mesh, {MESH_STEPS} graphed steps at batch "
              f"{MESH_BATCH}: loss traces and parameters bit for bit {bitwise}; largest loss "
              f"difference {trace_rel:.3e} of the loss, parameter {param_abs:.3e}; first step: "
              f"loss {loss_rel:.3e}, gradients {max(errs.values()):.3e} of their max magnitudes")
        if not bitwise and not (loss_rel <= loss_rtol and max(errs.values()) <= grad_rtol
                                and trace_rel <= MESH_TRACE_RTOL):
            raise AssertionError(f"the one-rank {name} mesh{tag} is not the plain step")
        compared[name] = dict(bitwise=bitwise, loss_rel=trace_rel)
    traced = {label: measure_step(lambda: (r["graph"].replay(), torch.cuda.synchronize()), 5)
              for label, r in runs.items()}
    plain_step = traced["plain"]
    times = {}
    for name in meshes:
        step = traced[name]
        nccl = [e for e in step["kernels"] if "nccl" in e.key.lower()]
        nccl_ms = sum(e.self_device_time_total for e in nccl) / 1e3
        share = nccl_ms / step["device_ms"] if step["device_ms"] else 0.0
        print(f"{name} mesh{tag} replay wall (host clock, synchronised, median of "
              f"{MESH_STEPS - 1}; {smi}): mesh {runs[name]['ms']:.3f} ms, no mesh "
              f"{plain_run['ms']:.3f} ms; one traced replay each: mesh {step['device_ms']:.3f} "
              f"device ms in {step['n_launches']} launches, no mesh "
              f"{plain_step['device_ms']:.3f} in {plain_step['n_launches']}; the collectives' "
              f"kernels {sum(e.count for e in nccl)}, {nccl_ms:.4f} ms ({100 * share:.2f}% of "
              "the mesh replay's device time; an all-reduce in place over one NCCL rank need "
              "launch none)")
        times[name] = dict(compared[name], mesh_ms=runs[name]["ms"], plain_ms=plain_run["ms"],
                           collective_ms=nccl_ms, collective_share=share,
                           device_ms=step["device_ms"], plain_device_ms=plain_step["device_ms"],
                           launches=step["n_launches"], plain_launches=plain_step["n_launches"])
    paths = {name: path_launches(f"{name} mesh{tag}", runs[name]["counted"], runs[name]["graph"],
                                 WARMUP_CALLS + 1, TRAIN16_CALL if bf16 else TRAIN_CALL)
             for name in meshes}
    return dict(paths=paths, times=times)


def _row_order_spread(build, batch, ref_losses, ref_grads) -> tuple:
    """One process's own moves when it sums the same rows in other orders:
    `ROW_ORDERS` trainers from `build()`, each with every split batch's rows
    permuted (after the split, so that each example keeps its draws) by one
    fixed permutation, `GLOO_STEPS` eager steps -> (the largest relative
    move of a loss from `ref_losses`, {parameter: the largest error of its
    first-step gradient against `ref_grads`, `_step_grad_errs`'s})."""
    trace, errs = 0.0, {}
    for k in range(ROW_ORDERS):
        trainer, sample = build()
        perm = torch.randperm(batch, generator=torch.Generator().manual_seed(k)).to("cuda")
        split = trainer.splitter

        def permuted(g, x, y, condition=None, split=split, perm=perm):
            return {key: v[perm] if torch.is_tensor(v) and v.shape[:1] == (batch,) else v
                    for key, v in split(g, x, y, condition=condition).items()}

        trainer.splitter = permuted
        for step in range(GLOO_STEPS):
            x, y, _ = sample(trainer.state.generator)
            loss = trainer.train_step(x, y)["loss"].item()
            trace = max(trace, abs(loss - ref_losses[step]) / abs(ref_losses[step]))
            if step == 0:
                e, _ = _step_grad_errs({n: p.grad.cpu() for n, p in
                                        trainer.model.named_parameters()}, ref_grads)
                errs = {n: max(v, errs.get(n, 0.0)) for n, v in e.items()}
        del trainer
    return trace, errs


def check_mesh_gloo(smi) -> dict:
    """Phase 38: two ranks sharing the card over gloo (NCCL refuses two
    ranks on one device), eager, started with `parallel.launch.run_ranks`:
    the flagship at batch 256 on `data` = 2, the 2 s k=37 FiLM
    configuration (`LONG_K37`'s) at batch 32 on `data` 1 x `seq` 2, and
    digits GridConvCNP (BatchNorm over the data axis) at batch 32 on `data`
    = 2 with its blocks stored and recomputed in the backward pass, each
    `GLOO_STEPS` steps from one process's init and generator seed
    (`multichip.train_on_mesh`), against that process's steps here
    (`multichip.run_trainer`): the first step's loss at the step bar; its
    gradients at the step bar (`rounding_grads`' allowance) and the loss
    traces at `MESH_TRACE_RTOL`, or, for the image model, within one
    process's own spread over `ROW_ORDERS` orders of its rows where that is
    larger (`_row_order_spread`: its first-step gradients sum thousands of
    cancelling terms, and the BatchNorm-cancelled biases' rounding noise
    takes Adam steps of +-lr); every rank's launches of K1, K2 and K3, and
    the graphed entry points refusing the gloo mesh. Then the recomputed
    image step against the stored one on the ranks: the recomputation runs
    on the autograd engine's device thread and must normalise with the
    global batch's statistics, as the forward did, so the two are bit for
    bit (else the first step at the step bars)."""
    img_call = img_train_call("GridConvCNP")
    cases = {"flagship data=2": (None, {"data": 2}, MESH_BATCH, False, TRAIN_CALL),
             "k37 seq=2": (LONG_K37, {"data": 1, "seq": 2}, GLOO_LONG_BATCH, False, TRAIN_CALL),
             "img gridconvcnp data=2": (GLOO_IMG_RUN, {"data": 2}, GLOO_IMG_BATCH, False,
                                        img_call),
             "img gridconvcnp remat data=2": (GLOO_IMG_RUN, {"data": 2}, GLOO_IMG_BATCH, True,
                                              img_call)}
    with tempfile.TemporaryDirectory() as tmp:
        runs = [dict(run_dir=run_dir, axes=axes, steps=GLOO_STEPS, batch=batch, device="cuda",
                     grads_out=os.path.join(tmp, f"grads{i}.pt"), remat=remat)
                for i, (run_dir, axes, batch, remat, _) in enumerate(cases.values())]
        t0 = time.perf_counter()
        ranks = run_ranks("npf_gwwaveform_tpu_torch.multichip:mesh_rank", 2, (runs,),
                          backend="gloo", timeout=RANKS_S)
        launch_s = time.perf_counter() - t0
        grads = [torch.load(r["grads_out"]) for r in runs]
    out = {}
    for i, (name, (run_dir, axes, batch, remat, call)) in enumerate(cases.items()):
        def build(run_dir=run_dir, batch=batch, remat=remat):
            return multichip.run_trainer(run_dir, GLOO_STEPS, batch, "cuda", remat=remat)

        trainer, sample = build()
        state = copy.deepcopy(trainer.model.state_dict())
        g = torch.Generator(device="cuda").manual_seed(0)  # the first step's draws, again
        x, y, cond = sample(g)
        first_batch = trainer.splitter(g, x, y, condition=cond)
        reset_counts()
        losses, ref = [], None
        for step in range(GLOO_STEPS):
            x, y, cond = sample(trainer.state.generator)
            m = trainer.train_step(x, y) if cond is None else trainer.train_step_cond(x, y, cond)
            losses.append(m["loss"].item())
            if step == 0:
                ref = {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}
        one_counts = counts()
        del trainer
        mesh_losses = ranks[0][i]["losses"]
        if any(r[i]["losses"] != mesh_losses for r in ranks):
            raise AssertionError(f"{name}: the ranks report different losses")
        loss_rel = abs(mesh_losses[0] - losses[0]) / abs(losses[0])
        trace_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses))
        trace_bar = MESH_TRACE_RTOL
        if run_dir == GLOO_IMG_RUN:
            spread, row_errs = _row_order_spread(build, batch, losses, ref)
            trace_bar = max(trace_bar, spread)
            errs, zero = _step_grad_errs(grads[i], ref)
            worst = max(errs.values())
            print(f"   {name}: one process over {ROW_ORDERS} orders of its rows moves its "
                  f"trace by up to {spread:.3e}; past the gradient bar: " + ", ".join(
                      f"{n} {e:.3e} (its rows' orders {row_errs[n]:.3e})"
                      for n, e in errs.items() if e > STEP_GRAD_RTOL))
            if (max(zero.values()) > STEP_GRAD_RTOL
                    or any(e > max(STEP_GRAD_RTOL, row_errs[n]) for n, e in errs.items())):
                raise AssertionError(f"{name}: the mesh step's gradients are not one process's")
        else:
            worst = _mesh_grad_errs(name, grads[i], ref, state, first_batch,
                                    lambda build=build: build()[0], False)
        rank_counts = [tuple(r[i]["counts"]) for r in ranks]
        refused = [r[i]["refused"] for r in ranks]
        print(f"{name} over gloo, 2 ranks on one card, {GLOO_STEPS} eager steps: losses "
              f"{[round(v, 4) for v in mesh_losses]} against one process's "
              f"{[round(v, 4) for v in losses]}; first step loss {loss_rel:.3e}, gradients "
              f"{worst:.3e} of their max magnitudes; trace {trace_rel:.3e} (bar "
              f"{trace_bar:.3e}); each rank's launches (K1, K2, K3, K2-bf16, K3-bf16) "
              f"{rank_counts}, one process's {one_counts}; the graphed entry points refused: "
              f"{refused[0]!r}")
        if not (loss_rel <= STEP_LOSS_RTOL and trace_rel <= trace_bar):
            raise AssertionError(f"{name}: the gloo mesh's losses are not one process's")
        if any(c != tuple(GLOO_STEPS * k for k in call) for c in rank_counts):
            raise AssertionError(f"{name}: a rank launched {rank_counts}, not {call} a step")
        if any(r is None or "cannot capture gloo" not in r for r in refused):
            raise AssertionError(f"{name}: a graphed entry point took the gloo mesh")
        out[name] = dict(loss_rel=loss_rel, trace_rel=trace_rel, trace_bar=trace_bar,
                         grad_err=worst, launches=rank_counts[0])
        release()
    stored, remat = (list(cases).index(k) for k in ("img gridconvcnp data=2",
                                                     "img gridconvcnp remat data=2"))
    same = ranks[0][remat]["losses"] == ranks[0][stored]["losses"] and all(
        torch.equal(grads[remat][n], grads[stored][n]) for n in grads[stored])
    errs, zero = _step_grad_errs(grads[remat], grads[stored])
    first = abs(ranks[0][remat]["losses"][0] - ranks[0][stored]["losses"][0]) / abs(
        ranks[0][stored]["losses"][0])
    print(f"the recomputed image step on the ranks against the stored one: bit for bit {same}; "
          f"first step loss {first:.3e}, gradients {max(errs.values()):.3e} of their max "
          "magnitudes")
    if not same and not (first <= STEP_LOSS_RTOL and max(errs.values()) <= STEP_GRAD_RTOL
                         and max(zero.values()) <= STEP_GRAD_RTOL):
        raise AssertionError("the recomputed image step on the mesh is not the stored one")
    print(f"phase 38's two ranks: {launch_s:.1f} s from their start to their results ({smi})")
    return dict(out, launch_s=launch_s, remat_bitwise=same)


def check_mesh_kernels(gen) -> dict:
    """K1, K2 and K3 (and K2-bf16, K3-bf16) at the shapes a rank's shard
    gives them on the mesh paths: the flagship's half batch, B = 128 of 256
    (256 points onto the 192-point grid, U{0..64} real, and back at C =
    128; the decoder at 128 x 256 = 32,768 rows with its init weights), and
    half the 2 s targets, 1,024 of 2,048, on the k=37 run's grid->targets
    launch at B = 32 (its weights and length scales; the decoder at 32 x
    1,024 = 32,768 rows); each at phases 3-5's and 9's bars, two launches
    bit-identical, timed beside its bound and plain version."""
    flag = multichip.flagship_trainer("cuda").model
    long_model = load_model(LONG_K37, "cuda")
    sig_ctx, sig_trgt = (getattr(flag, s).rbf.sigma().item()
                         for s in ("cntxt_to_induced", "induced_to_trgt"))
    keys, queries, values, mask, sigma = k1_inputs(
        GLOO_LONG_BATCH, 1536, 2048, 128, long_model.induced_to_trgt.rbf.sigma().item(), gen,
        max_real="all", n_points=2048)
    k1 = check_k1([
        ("ctx->grid mesh", k1_inputs(MESH_BATCH // 2, 256, 192, 1, sig_ctx, gen, [0],
                                     max_real=64)),
        ("grid->trgt mesh", k1_inputs(MESH_BATCH // 2, 192, 256, 128, sig_trgt, gen,
                                      max_real="all")),
        ("grid->trgt long seq", (keys, queries[:, :1024].contiguous(), values, mask, sigma)),
    ])
    w = {"mesh": chain_weights(flag.decoder.module),
         "long seq": chain_weights(long_model.decoder.module)}
    rows = {"mesh": MESH_BATCH // 2 * 256, "long seq": GLOO_LONG_BATCH * 1024}
    out = {"K1": k1}
    with torch.inference_mode():
        out["K2"] = check_k2([(f"decoder {n}", k2_inputs(rows[n], 128, 128, 3, 2, True, gen, w[n]),
                               False) for n in w])
        out["K3"] = check_k3([(f"decoder {n}", k3_inputs(rows[n], 128, 128, 3, 2, True, gen,
                                                         w[n][:5]), False) for n in w])
        out["K2-bf16"] = check_k2_bf16([(f"decoder {n}", k2_inputs(rows[n], 128, 128, 3, 2, True,
                                                                   gen, w[n], BF16), False)
                                        for n in w])
        out["K3-bf16"] = check_k3_bf16([(f"decoder {n}", k3_inputs(rows[n], 128, 128, 3, 2, True,
                                                                   gen, w[n][:5], BF16), False)
                                        for n in w])
    return out


def run_mesh_phases(gen, smi) -> dict:
    """Phases 37-38 and the dry run, after the mesh shapes' kernel checks.
    -> {"kernels": rows by kernel, "paths": the graphed mesh paths'
    launches, "times": their numbers}."""
    phase("mesh kernels: K1, K2, K3, K2-bf16 and K3-bf16 at a rank's shard (the flagship's "
          "B = 128 of 256; 1,024 of the 2 s path's 2,048 targets) vs plain")
    kernels = check_mesh_kernels(gen)
    release()
    phase(f"the device mesh on one NCCL rank: bench.py's flagship at batch {MESH_BATCH} through "
          "Trainer(mesh=...), graphed against eager and against no mesh, float32 and bf16")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                                world_size=1, rank=0)
        try:
            nccl = {tag: check_mesh_nccl(dtype, smi) for tag, dtype in (("", None),
                                                                         ("_bf16", BF16))}
        finally:
            dist.destroy_process_group()
    release()
    phase(f"the device mesh on two gloo ranks sharing the card: the flagship on data=2, the "
          f"2 s k=37 path on seq=2 and a remat BatchNorm GridConvCNP on data=2, {GLOO_STEPS} "
          "steps against one process; dryrun_multichip(1) started beside them")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # its rank starts while phase 38's do
        dry = pool.submit(multichip.dryrun_multichip, 1)
        gloo = check_mesh_gloo(smi)
        print(f"dryrun_multichip(1) on the card: {dry.result()} after "
              f"{time.perf_counter() - t0:.1f} s")
    times = {f"nccl{tag}": r["times"] for tag, r in nccl.items()}
    print(f"mesh paths (host clock; {smi}): " + json.dumps(dict(times, gloo=gloo)))
    paths = {f"train_mesh{'_seq' if name != 'data' else ''}{tag}": path
             for tag, r in nccl.items() for name, path in r["paths"].items()}
    return dict(kernels=kernels, paths=paths, times=dict(times, gloo=gloo))


def kernel_entry(name, source, replaces, launches, rows, path_shapes, launches_by_path):
    """One kernel's line entry: times summed over the shapes one train step
    runs, the largest error over every shape checked; `launches` is the
    training path's launches on the card (`path_launches`)."""
    on_path = [r for r in rows if r["shape"] in path_shapes]
    total = lambda key: sum(r[key] for r in on_path)  # noqa: E731
    entry = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if all(r["bound_by"] == "operations" for r in on_path) else "bytes",
        library_ms=None, launches_by_path=launches_by_path, shapes=rows,
    )
    if all(r.get("cublas_chain_ms") is not None for r in on_path):
        # the bf16 kernels' yardstick: several cuBLAS calls, so not "library_ms"
        entry["cublas_chain_ms"] = total("cublas_chain_ms")
    return entry


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    nvcc_version = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc_version}")
    set_numerics()
    # cuDNN's deterministic algorithms, so that the run is reproducible: with
    # its default backward, each run's 500 steps reach another model, and the
    # float32 one-step check above measured 3e-5 to 1.2e-3 (one model in
    # eight over its bar) on the models they reached (PERF.md, section 6)
    torch.backends.cudnn.deterministic = True

    band_threads = ThreadPoolExecutor(max_workers=4)
    RECORD_BANDS.update({r: band_threads.submit(gp_band, r)
                         for r in GP_RUNS + SET_RUNS + IMG_RUNS})

    phase("build")
    res = _build.build(verbose=True)
    print(f"nvcc built {os.path.basename(res.path)} in {res.seconds:.1f}s")
    for line in res.log.splitlines():
        if any(s in line for s in ("Compiling entry", "registers", "spill")):
            print("  " + line.strip())

    model = load_model(RUN_DIR, "cuda")
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    model_ctx = summary["n_context"]  # the path's contexts hold U{0..n_context} points
    sig_ctx = model.cntxt_to_induced.rbf.sigma().item()
    sig_trgt = model.induced_to_trgt.rbf.sigma().item()
    long_model = load_model(LONG_K37, "cuda")  # the long-waveform shapes' length scales, weights
    sig_ctx_long = long_model.cntxt_to_induced.rbf.sigma().item()
    sig_trgt_long = long_model.induced_to_trgt.rbf.sigma().item()
    # the frequency-domain runs' length scales and decoders (two channels in, four out)
    freq_models = {run: load_model(run, "cuda") for run in FREQ_RUNS}
    sig_ctx_freq, sig_trgt_freq = ({run: getattr(m, sc).rbf.sigma().item()
                                    for run, m in freq_models.items()}
                                   for sc in ("cntxt_to_induced", "induced_to_trgt"))
    with open(os.path.join(FREQ_FILM, "summary.json")) as f:
        freq_ctx = json.load(f)["n_context"]
    # the latent paths' length scales: the unbounded scale's run_1 for the
    # context and the grid->targets SetConvs, the ELBO run's context SetConv
    # for its encoding of the targets
    lat_model, elbo_model = load_model(LATENT_LATLBF1, "cuda"), load_model(LATENT_ELBO, "cuda")
    sig_ctx_lat = lat_model.cntxt_to_induced.rbf.sigma().item()
    sig_trgt_lat = lat_model.induced_to_trgt.rbf.sigma().item()
    sig_ctx_elbo = elbo_model.cntxt_to_induced.rbf.sigma().item()
    lat_ctx, n_z_score, n_z_train = 64, lat_model.n_z_samples_test, lat_model.n_z_samples_train
    del lat_model, elbo_model
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase("K1 setconv_fwd vs plain")
    k1_rows = check_k1([
        # the paths' shapes and masks: the scoring batch, then the train step
        ("ctx->grid", k1_inputs(256, 256, 384, 1, sig_ctx, gen, [0, 7], max_real=model_ctx)),
        ("grid->trgt", k1_inputs(256, 384, 256, 128, sig_trgt, gen, max_real="all")),
        ("ctx->grid train", k1_inputs(TRAIN_BATCH, 256, 384, 1, sig_ctx, gen, [0],
                                      max_real=model_ctx)),
        ("grid->trgt train", k1_inputs(TRAIN_BATCH, 384, 256, 128, sig_trgt, gen,
                                       max_real="all")),
        # the long-waveform scoring batch: 2048 points, U{0..1024} of them
        # context, onto the 1536-point grid and back
        ("ctx->grid long", k1_inputs(256, 2048, 1536, 1, sig_ctx_long, gen, [0, 7],
                                     max_real=1024, n_points=2048)),
        ("grid->trgt long", k1_inputs(256, 1536, 2048, 128, sig_trgt_long, gen, max_real="all",
                                      n_points=2048)),
        # the long-waveform train step at batch 32 (phase 14)
        ("ctx->grid long train", k1_inputs(TRAIN_BATCH, 2048, 1536, 1, sig_ctx_long, gen, [0],
                                           max_real=1024, n_points=2048)),
        ("grid->trgt long train", k1_inputs(TRAIN_BATCH, 1536, 2048, 128, sig_trgt_long, gen,
                                            max_real="all", n_points=2048)),
        # the frequency-domain paths: two value channels, U{0..64} of 256
        # context points onto the 192-point grid, and the grid onto the 256
        # targets, at the scoring batch and the train step, each run's
        # length scales
        *((f"ctx->grid {FREQ_RUNS[run]}{tag}",
           k1_inputs(B, 256, 192, 2, sig_ctx_freq[run], gen, empty, max_real=freq_ctx))
          for run in FREQ_RUNS for B, tag, empty in ((256, "", [0, 7]),
                                                     (TRAIN_BATCH, " train", [0]))),
        *((f"grid->trgt {FREQ_RUNS[run]}{tag}",
           k1_inputs(B, 192, 256, 128, sig_trgt_freq[run], gen, max_real="all"))
          for run in FREQ_RUNS for B, tag in ((256, ""), (TRAIN_BATCH, " train"))),
        # the latent paths: U{0..64} of 256 context points onto the 192-point
        # grid; the grid onto the 256 targets at n_z * B (32 draws of a
        # scoring batch of 256, 16 of a train step's 32); the ELBO path's
        # encoding of all 256 targets onto the grid
        ("ctx->grid latent", k1_inputs(256, 256, 192, 1, sig_ctx_lat, gen, [0, 7],
                                       max_real=lat_ctx)),
        ("ctx->grid latent train", k1_inputs(TRAIN_BATCH, 256, 192, 1, sig_ctx_lat, gen, [0],
                                             max_real=lat_ctx)),
        ("grid->trgt latent", k1_inputs(n_z_score * 256, 192, 256, 128, sig_trgt_lat, gen,
                                        max_real="all")),
        ("grid->trgt latent train", k1_inputs(n_z_train * TRAIN_BATCH, 192, 256, 128,
                                              sig_trgt_lat, gen, max_real="all")),
        ("trgt->grid elbo", k1_inputs(256, 256, 192, 1, sig_ctx_elbo, gen, max_real="all")),
        ("trgt->grid elbo train", k1_inputs(TRAIN_BATCH, 256, 192, 1, sig_ctx_elbo, gen,
                                            max_real="all")),
        # off the paths: random masks with an empty row, many keys, the
        # long-waveform runs' width (ROADMAP queue 1, item 3)
        ("grid->trgt random mask", k1_inputs(256, 384, 256, 128, sig_trgt, gen, [3])),
        ("large-K", k1_inputs(4, 5000, 512, 8, 0.05, gen, [2], path=False)),
        ("large-C", k1_inputs(4, 2048, 1536, 512, 0.02, gen, [1], path=False)),
    ])

    phase("K2 mlp_chain_fwd vs plain")
    dec_w = chain_weights(model.decoder.module)
    long_dec_w = chain_weights(long_model.decoder.module)
    freq_dec_w = {run: chain_weights(m.decoder.module) for run, m in freq_models.items()}
    with torch.inference_mode():
        # the frequency-domain decoders' cases (O = 4), (name, M, weights):
        # the scoring batch's rows and the train step's, each run's weights
        freq_dec = [(f"decoder {FREQ_RUNS[run]}{tag}", M, w) for run, w in freq_dec_w.items()
                    for M, tag in ((65536, ""), (TRAIN_BATCH * 256, " train"))]
        k2_rows = check_k2([
            ("decoder", k2_inputs(65536, 128, 128, 3, 2, True, gen, dec_w), False),
            ("decoder train", k2_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w),
             False),
            ("decoder long", k2_inputs(256 * 2048, 128, 128, 3, 2, True, gen, long_dec_w), False),
            ("decoder long train", k2_inputs(TRAIN_BATCH * 2048, 128, 128, 3, 2, True, gen,
                                             long_dec_w), False),
            *((name, k2_inputs(M, 128, 128, 3, 4, True, gen, w), False)
              for name, M, w in freq_dec),
            *((name, k2_inputs(M, C, H, L1, O, biases, gen), is_res)
              for name, M, C, H, L1, O, is_res, biases in K2_CASES),
        ])

        phase("K3 mlp_chain_bwd vs plain")
        k3_rows = check_k3([
            ("decoder train", k3_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w[:5]),
             False),
            ("decoder score shape", k3_inputs(65536, 128, 128, 3, 2, True, gen, dec_w[:5]), False),
            ("decoder long train", k3_inputs(TRAIN_BATCH * 2048, 128, 128, 3, 2, True, gen,
                                             long_dec_w[:5]), False),
            *((name, k3_inputs(M, 128, 128, 3, 4, True, gen, w[:5]), False)
              for name, M, w in freq_dec if name.endswith("train")),
            ("no-hidden residual no-bias", k3_inputs(1000, 128, 128, 0, 3, False, gen), True),
            ("ragged residual", k3_inputs(4099, 37, 64, 2, 5, True, gen), True),
            # widths past one 128-column pass of the kernel's products
            ("wide", k3_inputs(3001, 200, 256, 2, 3, True, gen), False),
            ("wide residual", k3_inputs(3001, 200, 320, 2, 3, True, gen), True),
        ])

    phase("autograd through K1, K2, K3 vs the plain modules")
    check_autograd(model, gen)

    phase("scoring path: score run_1 through K1 and K2, the first batch eagerly and the rest "
          "replayed from its CUDA graph")
    reset_counts()
    with graph_every_run():
        out = score_run(RUN_DIR, N_TEST, thetas_from=RUN_DIR, device="cuda")
    score_counted = counts()
    n_batches = -(-N_TEST // 256)
    print(f"scored {out['n']} waveforms in {out['seconds']:.2f}s: mean LL {out['mean_ll']:.3f}, "
          f"median mismatch {out['median_mismatch']:.6f}, p90 {out['mismatch_p90']:.4f}, p99 "
          f"{out['mismatch_p99']:.4f}, frac < 0.1 {out['frac_below_0.1']:.4f}; wrapper launches "
          f"(K1, K2, K3, K2-bf16, K3-bf16) {score_counted} (the first batch and the capture of "
          "its graph)")
    if out["graph"] is None:
        raise AssertionError(f"score_run scored {N_TEST} thetas without its batch graph")
    score_path = path_launches("scoring", score_counted, out["graph"], 2, SCORE_CALL)
    if score_path["replays"] != n_batches - 1:
        raise AssertionError(f"{score_path['replays']} replays of the batch graph, not "
                             f"{n_batches - 1}")
    if not (np.isfinite(out["ll"]).all() and np.isfinite(out["mismatch"]).all()
            and out["n"] == N_TEST):
        raise AssertionError("non-finite or missing per-waveform results")
    if not LL_BAND[0] <= out["mean_ll"] <= LL_BAND[1]:
        raise AssertionError(f"mean LL {out['mean_ll']} outside {LL_BAND}")
    if not MISMATCH_BAND[0] <= out["median_mismatch"] <= MISMATCH_BAND[1]:
        raise AssertionError(f"median mismatch {out['median_mismatch']} outside {MISMATCH_BAND}")

    phase("scoring path: graphed vs eager scoring of the 2048 thetas")
    reset_counts()
    eager_out = eager_scores(N_TEST)
    if counts() != tuple(n_batches * c for c in SCORE_CALL):
        raise AssertionError(f"eager scoring launched {counts()}")
    check_graph_scores(out, eager_out)

    phase("scoring path: one batch, kernel path vs plain path")
    plain_model = load_model(RUN_DIR, "cuda", use_kernels=False)
    gw_gen, space = run_generator(summary), GWParameterSpace()
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:256]).cuda()
    splitter = eval_splitter(summary["n_context"])
    outs = {}
    with torch.inference_mode():
        for label, m in (("kernel", model), ("plain", plain_model)):
            g = torch.Generator(device="cuda").manual_seed(1)
            ll, _, _, o = score_batch(m, splitter, g, theta, gw_gen, space)
            outs[label] = (o.p_yCc.loc, o.p_yCc.scale, ll)
            torch.cuda.synchronize()
            t = []
            for _ in range(5):
                g = torch.Generator(device="cuda").manual_seed(1)
                t0 = time.perf_counter()
                score_batch(m, splitter, g, theta, gw_gen, space)
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            print(f"{label} path: one 256-waveform batch {1e3 * float(np.median(t)):.3f} ms "
                  f"(median of 5, host clock)")
            if label == "kernel":
                batch_ms = (1e3 * float(np.median(t)),
                            graphed_batch_ms(m, splitter, theta, gw_gen, space))
    print(f"kernel path, one batch replayed from its CUDA graph: {batch_ms[1]:.3f} ms (median of "
          "5, host clock)")
    loc_err = (outs["kernel"][0] - outs["plain"][0]).abs().max().item()
    scale_err = (outs["kernel"][1] - outs["plain"][1]).abs().max().item()
    ll_err = (outs["kernel"][2] - outs["plain"][2]).abs().max().item()
    print(f"kernel vs plain path: loc {loc_err:.3e}, scale {scale_err:.3e}, LL {ll_err:.3e}")
    if not (loc_err <= PATH_TOL and scale_err <= PATH_TOL):
        raise AssertionError("kernel path disagrees with the plain path")

    train_summary = gw_train_summary()
    phase("training path: the train step in a CUDA graph vs the eager step")
    graph_train = check_graph_train(train_summary)

    phase(f"training path: {TRAIN_STEPS} graphed steps of the flagship configuration at batch "
          f"{TRAIN_BATCH} from the port's init")
    trainer = train_gw.build_trainer(train_summary, TRAIN_STEPS, "cuda", seed=0)
    reset_counts()
    history, losses, seconds, step_seconds = train_gw.train(
        trainer, train_summary, TRAIN_STEPS, TRAIN_BATCH, time_steps=True)
    train_counted = counts()
    (train_graph,) = trainer.graphs.values()
    losses = losses.cpu().numpy()
    early, late = float(np.median(losses[:50])), float(np.median(losses[250:500]))
    step_ms = 1e3 * float(np.median(step_seconds))
    print(f"trained {TRAIN_STEPS} steps in {seconds:.2f}s; wrapper launches (K1, K2, K3, "
          f"K2-bf16, K3-bf16) {train_counted} ({WARMUP_CALLS} warm-up steps and the capture), "
          f"{train_graph.replays} replays")
    print("50-step mean losses: " + ", ".join(f"{h['step']}: {h['train_loss']:.1f}"
                                              for h in history))
    print(f"median loss over steps 1-50 {early:.2f}, over steps 251-500 {late:.2f} "
          f"(fell {early - late:.2f} nats; below 0: {late < 0.0})")
    print(f"graphed train step {step_ms:.3f} ms (median of {TRAIN_STEPS}, host clock, "
          f"synchronised): {1e3 * TRAIN_BATCH / step_ms:.0f} wf/s on {smi}")
    if train_graph.replays != TRAIN_STEPS:
        raise AssertionError(f"{train_graph.replays} replays of the train graph, not {TRAIN_STEPS}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    if not late <= early - LOSS_FALL_NATS:
        raise AssertionError(f"the loss did not fall: median {early:.2f} over steps 1-50, "
                             f"{late:.2f} over steps 251-500")
    print(f"timing (host clock, synchronised, medians; {smi}): train step eager "
          f"{graph_train['eager_step_ms']:.3f} ms, graphed {step_ms:.3f} ms; scoring batch eager "
          f"{batch_ms[0]:.3f} ms, graphed {batch_ms[1]:.3f} ms")

    phase("training path: one step, kernel path vs plain path")
    trained = trainer.model
    check_train_step(trained, train_summary, gen)

    phase("training path: the written run reloads")
    with tempfile.TemporaryDirectory() as tmp:
        train_summary.update(steps=TRAIN_STEPS, batch=TRAIN_BATCH)
        run_dir = os.path.join(tmp, "run_0")
        train_gw.write_run(run_dir, trained, train_summary, history)
        reloaded = load_model(run_dir, "cuda")
        trained.eval()
        theta = space.sample(256, gen)
        preds = []
        with torch.inference_mode():
            for m in (trained, reloaded):
                g = torch.Generator(device="cuda").manual_seed(2)
                *_, o = score_batch(m, splitter, g, theta, gw_gen, space)
                preds.append((o.p_yCc.loc, o.p_yCc.scale))
        same = all(torch.equal(a, b) for a, b in zip(*preds))
        scored = score_run(run_dir, 256, device="cuda")
        print(f"reloaded run: eval forward equal to the in-memory model's {same}; scored 256 "
              f"waveforms: mean LL {scored['mean_ll']:.3f}, median mismatch "
              f"{scored['median_mismatch']:.4f}")
        if not (same and np.isfinite(scored["ll"]).all()):
            raise AssertionError("the written run does not reload to the trained model")
    # the last use of the trained model: a traced replay trains it one step on
    train_path = path_launches("training", train_counted, train_graph, WARMUP_CALLS + 1,
                               TRAIN_CALL)

    phase("K2-bf16 mlp_chain_fwd_bf16 vs plain")
    with torch.inference_mode():
        k2b_rows = check_k2_bf16([
            ("decoder", k2_inputs(65536, 128, 128, 3, 2, True, gen, dec_w, BF16), False),
            ("decoder train", k2_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w, BF16),
             False),
            ("decoder long", k2_inputs(256 * 2048, 128, 128, 3, 2, True, gen, long_dec_w, BF16),
             False),
            ("decoder long train", k2_inputs(TRAIN_BATCH * 2048, 128, 128, 3, 2, True, gen,
                                             long_dec_w, BF16), False),
            *((name, k2_inputs(M, 128, 128, 3, 4, True, gen, w, BF16), False)
              for name, M, w in freq_dec),
            *((name, k2_inputs(M, C, H, L1, O, biases, gen, dtype=BF16), is_res)
              for name, M, C, H, L1, O, is_res, biases in K2_CASES),
        ])

        phase("K3-bf16 mlp_chain_bwd_bf16 vs plain")
        k3b_rows = check_k3_bf16([
            ("decoder train", k3_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w[:5],
                                        BF16), False),
            ("decoder score shape", k3_inputs(65536, 128, 128, 3, 2, True, gen, dec_w[:5], BF16),
             False),
            ("decoder long train", k3_inputs(TRAIN_BATCH * 2048, 128, 128, 3, 2, True, gen,
                                             long_dec_w[:5], BF16), False),
            *((name, k3_inputs(M, 128, 128, 3, 4, True, gen, w[:5], BF16), False)
              for name, M, w in freq_dec if name.endswith("train")),
            ("no-hidden residual no-bias", k3_inputs(1000, 128, 128, 0, 3, False, gen, dtype=BF16),
             True),
            ("ragged residual", k3_inputs(4099, 37, 64, 2, 5, True, gen, dtype=BF16), True),
            ("wide", k3_inputs(3001, 200, 256, 2, 3, True, gen, dtype=BF16), False),
            ("wide residual", k3_inputs(3001, 200, 320, 2, 3, True, gen, dtype=BF16), True),
        ])

    phase("bf16 scoring path: score run_1 in bfloat16 compute through K1 and K2-bf16")
    reset_counts()
    with graph_every_run():
        out16 = score_run(RUN_DIR, N_TEST, thetas_from=RUN_DIR, device="cuda", dtype=BF16)
    score16_counted = counts()
    d_ll = out16["mean_ll"] - out["mean_ll"]
    d_mm = out16["median_mismatch"] - out["median_mismatch"]
    d_wf = out16["ll"] - out["ll"]
    print(f"scored {out16['n']} waveforms in bf16 in {out16['seconds']:.2f}s: mean LL "
          f"{out16['mean_ll']:.3f}, median mismatch {out16['median_mismatch']:.6f}; against "
          f"float32 with the same context draws: mean LL {d_ll:+.4f} (JAX {BF16_D_MEAN_LL:+.3f}), "
          f"median mismatch {d_mm:+.3e}, per-waveform LL differences sd {d_wf.std():.3f}, largest "
          f"{np.abs(d_wf).max():.2f}; wrapper launches (K1, K2, K3, K2-bf16, K3-bf16) "
          f"{score16_counted} (the first batch and the capture of its graph)")
    if out16["graph"] is None:
        raise AssertionError(f"score_run scored {N_TEST} thetas in bf16 without its batch graph")
    score16_path = path_launches("bf16 scoring", score16_counted, out16["graph"], 2, SCORE16_CALL)
    if score16_path["replays"] != n_batches - 1:
        raise AssertionError(f"{score16_path['replays']} replays of the bf16 batch graph, not "
                             f"{n_batches - 1}")
    if not (np.isfinite(out16["ll"]).all() and np.isfinite(out16["mismatch"]).all()
            and out16["n"] == N_TEST):
        raise AssertionError("non-finite or missing per-waveform results in bf16")
    if not LL_BAND[0] <= out16["mean_ll"] <= LL_BAND[1]:
        raise AssertionError(f"bf16 mean LL {out16['mean_ll']} outside {LL_BAND}")
    if not MISMATCH_BAND[0] <= out16["median_mismatch"] <= MISMATCH_BAND[1]:
        raise AssertionError(f"bf16 median mismatch {out16['median_mismatch']} outside "
                             f"{MISMATCH_BAND}")
    if not (abs(d_ll - BF16_D_MEAN_LL) <= BF16_D_MEAN_LL_TOL
            and abs(d_mm) <= BF16_D_MEDIAN_MISMATCH):
        raise AssertionError("the bf16 score's gap to the float32 score is not JAX's")

    phase("bf16 scoring path: graphed vs eager scoring of the 2048 thetas")
    reset_counts()
    eager16 = eager_scores(N_TEST, BF16)
    if counts() != tuple(n_batches * c for c in SCORE16_CALL):
        raise AssertionError(f"eager bf16 scoring launched {counts()}")
    check_graph_scores(out16, eager16, " (bf16)")

    phase("scoring end to end: score_run against the eager loop, float32 and bf16")
    for dtype in (None, BF16):
        score_timing(smi, dtype)

    phase("bf16 scoring path: one batch, kernel path vs plain-kernel path")
    model16 = load_model(RUN_DIR, "cuda", dtype=BF16)
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:256]).cuda()
    outs = {}
    with torch.inference_mode():
        for label, m, ctx in (("kernel", model16, contextlib.nullcontext),
                              ("plain-kernel", model16, plain_kernels),
                              ("float32", model, contextlib.nullcontext)):
            with ctx():
                g = torch.Generator(device="cuda").manual_seed(1)
                ll, _, _, o = score_batch(m, splitter, g, theta, gw_gen, space)
                outs[label] = (o.p_yCc.loc, o.p_yCc.scale, ll)
                torch.cuda.synchronize()
                t = []
                for _ in range(3):
                    g = torch.Generator(device="cuda").manual_seed(1)
                    t0 = time.perf_counter()
                    score_batch(m, splitter, g, theta, gw_gen, space)
                    torch.cuda.synchronize()
                    t.append(time.perf_counter() - t0)
            print(f"{label} path: one 256-waveform batch {1e3 * float(np.median(t)):.3f} ms "
                  f"(median of 3, host clock)")
            if label == "kernel":
                batch16_ms = (1e3 * float(np.median(t)),
                              graphed_batch_ms(m, splitter, theta, gw_gen, space))
    print(f"bf16 kernel path, one batch replayed from its CUDA graph: {batch16_ms[1]:.3f} ms "
          "(median of 5, host clock)")
    rms = lambda a: a.float().square().mean().sqrt().item()  # noqa: E731
    loc_k, loc_p, loc_32 = outs["kernel"][0], outs["plain-kernel"][0], outs["float32"][0]
    near, gap = rms(loc_k - loc_p), rms(loc_k - loc_32)
    near_max, gap_max = ((loc_k - loc_p).abs().max().item(), (loc_k - loc_32).abs().max().item())
    print(f"bf16 kernel vs plain-kernel path: loc RMS {near:.3e}, largest {near_max:.3e}; the "
          f"bf16-float32 gap of the same batch: RMS {gap:.3e}, largest {gap_max:.3e}; scale "
          f"{(outs['kernel'][1] - outs['plain-kernel'][1]).abs().max().item():.3e}, LL "
          f"{(outs['kernel'][2] - outs['plain-kernel'][2]).abs().max().item():.3e}")
    if not (near <= BF16_PATH_RMS * gap and near_max <= BF16_PATH_MAX * gap_max):
        raise AssertionError("the bf16 kernel path disagrees with its plain-kernel path")

    phase("bf16 training path: the train step in a CUDA graph vs the eager step")
    graph_train16 = check_graph_train(train_summary, BF16)

    phase(f"bf16 training path: {TRAIN_STEPS} graphed steps at batch {TRAIN_BATCH} from seed 0")
    trainer16 = train_gw.build_trainer(train_summary, TRAIN_STEPS, "cuda", seed=0, dtype=BF16)
    reset_counts()
    history16, losses16, seconds16, step_seconds16 = train_gw.train(
        trainer16, train_summary, TRAIN_STEPS, TRAIN_BATCH, time_steps=True)
    train16_counted = counts()
    (train16_graph,) = trainer16.graphs.values()
    losses16 = losses16.cpu().numpy()
    early16, late16 = float(np.median(losses16[:50])), float(np.median(losses16[250:500]))
    step16_ms = 1e3 * float(np.median(step_seconds16))
    print(f"trained {TRAIN_STEPS} bf16 steps in {seconds16:.2f}s; wrapper launches (K1, K2, K3, "
          f"K2-bf16, K3-bf16) {train16_counted} ({WARMUP_CALLS} warm-up steps and the "
          f"capture), {train16_graph.replays} replays")
    print("50-step mean losses: " + ", ".join(f"{h['step']}: {h['train_loss']:.1f}"
                                              for h in history16))
    print(f"median loss over steps 1-50 {early16:.2f}, over steps 251-500 {late16:.2f} "
          f"(fell {early16 - late16:.2f} nats; below 0: {late16 < 0.0})")
    print(f"graphed bf16 train step {step16_ms:.3f} ms (median of {TRAIN_STEPS}, host clock, "
          f"synchronised): {1e3 * TRAIN_BATCH / step16_ms:.0f} wf/s on {smi}")
    if train16_graph.replays != TRAIN_STEPS:
        raise AssertionError(f"{train16_graph.replays} replays of the bf16 train graph, not "
                             f"{TRAIN_STEPS}")
    if not np.isfinite(losses16).all():
        raise AssertionError("non-finite bf16 training loss")
    if not late16 <= early16 - LOSS_FALL_NATS:
        raise AssertionError(f"the bf16 loss did not fall: median {early16:.2f} over steps "
                             f"1-50, {late16:.2f} over steps 251-500")
    print(f"bf16 timing (host clock, synchronised, medians; {smi}): train step eager "
          f"{graph_train16['eager_step_ms']:.3f} ms, graphed {step16_ms:.3f} ms; scoring batch "
          f"eager {batch16_ms[0]:.3f} ms, graphed {batch16_ms[1]:.3f} ms")

    phase("bf16 training path: one step, kernel path vs plain-kernel path")
    check_train_step(trainer16.model, train_summary, gen, BF16)
    train16_path = path_launches("bf16 training", train16_counted, train16_graph,
                                 WARMUP_CALLS + 1, TRAIN16_CALL)

    del long_model, freq_models
    release()
    phase("the other 20 runs: each scored on its own 2048 recorded thetas through K1 and K2, "
          "held to its bands, then in bf16 through K1 and K2-bf16, held to JAX's bf16 gap; the "
          "frequency-domain runs' graphed scoring against eager")
    long_paths = check_run_scores(OTHER_RUNS, smi)
    long_ms = {kind: long_batch_ms(run_dir, smi)
               for kind, run_dir in (("k37", LONG_K37), ("unet", LONG_UNET))}

    phase(f"decile checkpoints and resuming: {RESUME_STEPS} graphed steps, then a continuation "
          "from the last checkpoint")
    check_resume()

    release()
    phase("the four ConvLNP runs: each scored on its own 2048 recorded thetas at 32 z draws a "
          "waveform through K1 (grid->targets at B = 8,192), held to the JAX package's float32 "
          "bands, then in bf16, held to JAX's bf16 gap; graphed against eager scoring")
    latent_paths = check_run_scores(tuple(LATENT_RUNS), smi)
    phase("the latent paths: one batch of the NPML and of the ELBO run, kernel path vs plain path")
    latent_batch = {LATENT_RUNS[r]: check_latent_batch(r, smi) for r in (LATENT_NPML, LATENT_ELBO)}
    release()

    phase("GP kernels: K1, K2 and K3 at the GP paths' shapes (128 sorted U(-1, 1) points a "
          "function, the 192-point grid) vs plain")
    gp_models = {r: score_gp.load_model(r, "cuda") for r in (GP_CNP, GP_NPML, GP_ELBO, GP_NOTEBOOK)}

    def gp_sig(run_dir, setconv_name):
        return getattr(gp_models[run_dir], setconv_name).rbf.sigma().item()

    def gp_k1(B, K, Q, C, sig, empty=(), max_real="all"):
        return k1_inputs(B, K, Q, C, sig, gen, empty, max_real=max_real, n_points=GP_POINTS,
                         uniform_points=True)

    sig_ctx, sig_trgt = gp_sig(GP_CNP, "cntxt_to_induced"), gp_sig(GP_CNP, "induced_to_trgt")
    sig_trgt_npml, sig_trgt_nb = (gp_sig(r, "induced_to_trgt") for r in (GP_NPML, GP_NOTEBOOK))
    n_grid = gp_models[GP_CNP].n_induced
    k1_rows += check_k1([
        # context -> grid: U{0..50} of 128 points real, at a scoring batch and a train step
        ("ctx->grid gp", gp_k1(256, GP_POINTS, n_grid, 1, sig_ctx, [0, 7], GP_CONTEXT)),
        ("ctx->grid gp train", gp_k1(TRAIN_BATCH, GP_POINTS, n_grid, 1, sig_ctx, [0], GP_CONTEXT)),
        # grid -> the 128 targets: ConvCNP's scoring batch and train step, the
        # z draws folded into the batch (32 x 256 headline scoring, 16 x 256
        # ablation scoring, 16 x 32 an NPML step)
        ("grid->trgt gp", gp_k1(256, n_grid, GP_POINTS, 128, sig_trgt)),
        ("grid->trgt gp train", gp_k1(TRAIN_BATCH, n_grid, GP_POINTS, 128, sig_trgt)),
        ("grid->trgt gp npml", gp_k1(32 * 256, n_grid, GP_POINTS, 128, sig_trgt_npml)),
        ("grid->trgt gp ablation", gp_k1(16 * 256, n_grid, GP_POINTS, 128, sig_trgt_nb)),
        ("grid->trgt gp npml train", gp_k1(16 * TRAIN_BATCH, n_grid, GP_POINTS, 128,
                                           sig_trgt_npml)),
        # the ELBO-trained ablation runs' encoding of all 128 targets at eval
        ("trgt->grid gp elbo", gp_k1(256, GP_POINTS, n_grid, 1,
                                     gp_sig(GP_ELBO, "cntxt_to_induced"))),
    ])
    gp_dec_w = chain_weights(gp_models[GP_CNP].decoder.module)
    with torch.inference_mode():
        k2_rows += check_k2([
            ("decoder gp", k2_inputs(256 * GP_POINTS, 128, 128, 3, 2, True, gen, gp_dec_w), False),
            ("decoder gp train", k2_inputs(TRAIN_BATCH * GP_POINTS, 128, 128, 3, 2, True, gen,
                                           gp_dec_w), False),
        ])
        k3_rows += check_k3([
            ("decoder gp train", k3_inputs(TRAIN_BATCH * GP_POINTS, 128, 128, 3, 2, True, gen,
                                           gp_dec_w[:5]), False),
        ])
    del gp_models, gp_dec_w
    release()

    phase("set and attention family kernels: K2 and K3 at the decoders' z-folded rows "
          "(n_z x B x 128 points) with the runs' own weights vs plain")
    set_rows = check_set_kernels(gen)
    k2_rows += set_rows["K2"]
    k3_rows += set_rows["K3"]
    release()

    phase(f"GP sampler on the card: {GP_MOMENT_N} functions of each kernel, their moments")
    gp_sampler = check_gp_sampler(smi)

    phase(f"the 21 GP runs: each scored over {GP_N_TEST} fresh functions a kernel, graphed, held to "
          "the bands of JAX's eval draws through the port's CPU forward; one run of each family against eager scoring")
    gp_score_paths, gp_batch_ms = check_gp_scores(GP_RUNS, GP_FAMILIES, smi)
    phase("the GP paths: one batch of each family, kernel path vs plain path")
    gp_batch = {GP_FAMILIES[r]: check_gp_batch(r, smi) for r in GP_FAMILIES}
    release()

    phase(f"the 57 set and attention GP runs: each scored over {GP_N_TEST} fresh functions a "
          "kernel through K2, graphed, held to the bands of JAX's eval draws through the port's "
          "CPU forward; one run of each family against eager scoring")
    set_score_paths, set_batch_ms = check_gp_scores(SET_RUNS, SET_FAMILIES, smi)
    gp_score_paths.update(set_score_paths)
    gp_batch_ms.update(set_batch_ms)
    phase("the set and attention paths: one batch of each family, kernel path vs plain path")
    gp_batch.update({SET_FAMILIES[r]: check_gp_batch(r, smi) for r in SET_FAMILIES})
    release()

    gp_families = {}
    for name, gp_summary in GP_TRAIN + SET_TRAIN:
        phase(f"GP training path {name}: {gp_summary['model']} on {gp_summary['kernel']}, graphed "
              f"against eager, {GP_TRAIN_STEPS} graphed steps from seeds {FAMILY_SEEDS}, kernel "
              "path against plain")
        gp_families[name] = check_gp_family(name, gp_summary, smi)
    print(f"GP paths (host clock, synchronised; {smi}): " + json.dumps(
        {"sampler": gp_sampler, "score_batch_ms": gp_batch_ms, "batch": gp_batch,
         "train": {k: {m: f[m] for m in ("step_ms", "eager_step_ms", "draws")}
                   for k, f in gp_families.items()}}))

    release()
    img = run_img_phases(gen, smi)
    k2_rows += img["kernels"]["K2"]
    k3_rows += img["kernels"]["K3"]

    release()
    fam16 = run_bf16_family_phases(gen, smi)
    k2b_rows += fam16["kernels"]["K2-bf16"]
    k3b_rows += fam16["kernels"]["K3-bf16"]

    release()
    tools = run_eval_tool_phases(gen, smi)
    k1_rows += tools["kernels"]["K1"]
    k2_rows += tools["kernels"]["K2"]

    release()
    mesh = run_mesh_phases(gen, smi)
    k1_rows += mesh["kernels"]["K1"]
    k2_rows += mesh["kernels"]["K2"]
    k3_rows += mesh["kernels"]["K3"]
    k2b_rows += mesh["kernels"]["K2-bf16"]
    k3b_rows += mesh["kernels"]["K3-bf16"]

    families = {}
    for name, run_dir, dtype_steps, seeds in FAMILY_RUNS:
        for dtype, steps in zip((None, BF16), dtype_steps):
            label = f"{name}{' bf16' if dtype is not None else ''}"
            phase(f"training path {label}: {os.path.relpath(run_dir, RESULTS)}'s configuration, "
                  f"graphed against eager, {steps} graphed steps from seeds {seeds}, kernel path "
                  "against plain")
            families[label] = check_family(name, run_dir, dtype, steps, seeds, smi)
    clipped = {k: max(f["norms"]) for k, f in families.items() if f["clip"] is not None}
    print("long paths, the largest gradient norm before the clip in the ten checked steps: "
          + ", ".join(f"{k} {v:.4g}" for k, v in clipped.items()))
    if not any(v > FAMILY_CLIP for v in clipped.values()):
        raise AssertionError("the clip bound in none of the long paths' checked steps")
    print(f"training paths (host clock, synchronised; {smi}): " + json.dumps(
        {k: {m: f[m] for m in ("step_ms", "eager_step_ms", "draws")} for k, f in families.items()}))

    paths = {"score": score_path, "train": train_path, "score_bf16": score16_path,
             "train_bf16": train16_path, "score_long_k37": long_paths["long k37"],
             "score_long_unet": long_paths["long unet"],
             "score_bf16_long_k37": long_paths["long k37 bf16"],
             "score_bf16_long_unet": long_paths["long unet bf16"],
             **{f"score{'_bf16' if k.endswith(' bf16') else ''}_"
                f"{k.removesuffix(' bf16').replace(' ', '_')}": p
                for k, p in {**long_paths, **latent_paths}.items()
                if k.startswith(("freq", "latent"))},
             **{f"train_{k.replace(' ', '_')}": f["path"] for k, f in families.items()},
             **{f"score_{k.replace(' ', '_')}": p for k, p in gp_score_paths.items()},
             **{f"train_{k.replace(' ', '_')}": f["path"] for k, f in gp_families.items()},
             **{f"score_{k.replace(' ', '_')}": p for k, p in img["score_paths"].items()},
             **{f"train_{k.replace(' ', '_')}": f["path"] for k, f in img["train"].items()},
             **{f"score_bf16_{k.replace(' ', '_')}": p
                for k, p in fam16["score_paths"].items()},
             **{f"train_bf16_{k.replace(' ', '_')}": f["path"]
                for k, f in fam16["train"].items()},
             **tools["paths"], **mesh["paths"]}
    print(f"long-waveform batch times (host clock; {smi}): " + json.dumps(long_ms))
    print(f"latent batches, kernel vs plain path (host clock; {smi}): " + json.dumps(latent_batch))

    def launches_by_path(i):
        """Each path's launches of kernel i on the card (`path_launches`)."""
        return {name: p["launches"][i] for name, p in paths.items()}

    mlp = "npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py"
    kernels = [
        kernel_entry("K1 setconv_fwd", "npf_gwwaveform_tpu_torch/csrc/setconv_fwd.cu",
                     "npf_gwwaveform_tpu/ops/pallas/setconv_kernel.py:45",
                     train_path["launches"][0],
                     k1_rows, ("ctx->grid train", "grid->trgt train"), launches_by_path(0)),
        kernel_entry("K2 mlp_chain_fwd", "npf_gwwaveform_tpu_torch/csrc/mlp_chain_fwd.cu",
                     f"{mlp}:63", train_path["launches"][1], k2_rows, ("decoder train",),
                     launches_by_path(1)),
        kernel_entry("K3 mlp_chain_bwd", "npf_gwwaveform_tpu_torch/csrc/mlp_chain_bwd.cu",
                     f"{mlp}:83", train_path["launches"][2], k3_rows, ("decoder train",),
                     launches_by_path(2)),
        kernel_entry("K2-bf16 mlp_chain_fwd_bf16",
                     "npf_gwwaveform_tpu_torch/csrc/mlp_chain_fwd_bf16.cu", f"{mlp}:63",
                     train16_path["launches"][3], k2b_rows, ("decoder train",), launches_by_path(3)),
        kernel_entry("K3-bf16 mlp_chain_bwd_bf16",
                     "npf_gwwaveform_tpu_torch/csrc/mlp_chain_bwd_bf16.cu", f"{mlp}:83",
                     train16_path["launches"][4], k3b_rows, ("decoder train",), launches_by_path(4)),
    ]
    band_threads.shutdown()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
