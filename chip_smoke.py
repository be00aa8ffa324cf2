#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`npf_gwwaveform_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each announced with the seconds elapsed:
  1. device: the card's name and power limit, torch and nvcc versions;
  2. build: the kernels with one nvcc call (ptxas resource report);
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
     `train_gw.train` (`FAMILY_RUNS`: 500 or 1,000 for the 1 s paths and
     1,000 for the frequency-domain ones from seeds 0, 1 and 2, 300 for the
     2 s ones from seed 0), each draw printing its median loss over the first
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
     1,000 steps, one kernel-path step against the plain path).
It ends with a JSON line of per-kernel numbers and the JSON result line.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from npf_gwwaveform_tpu_torch import _build
from npf_gwwaveform_tpu_torch import score as score_mod
from npf_gwwaveform_tpu_torch import train_gw
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary, gw_train_summary, train_config
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.kernel_measure import (
    K2_BF16_SUM_TOL, K2_CASES, cublas_chain_ms, k1_bound, k1_inputs, k2_bf16_ok, k2_bf16_report,
    k2_bound, k2_inputs, k3_bf16_ok, k3_bf16_report, k3_bound, k3_inputs, time_ms,
    traced_launches,
)
from npf_gwwaveform_tpu_torch.ops.kernels import (
    counts, hand_kernel_id, mlp_chain, reset_counts, setconv,
)
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain, fused_relu_mlp_plain,
)
from npf_gwwaveform_tpu_torch.ops.kernels.setconv import setconv_exprbf_fwd, setconv_exprbf_plain
from npf_gwwaveform_tpu_torch.run_report import recorded_scores, score_bands, scored_runs
from npf_gwwaveform_tpu_torch.score import (
    batch_graph, eval_splitter, load_model, make_eval_batch, read_run_thetas, run_generator,
    score_batch, score_run,
)
from npf_gwwaveform_tpu_torch.training.checkpoint import load_run_params, params_from_flax
from npf_gwwaveform_tpu_torch.utils.cuda_graph import WARMUP_CALLS
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
# a float32 gradient past STEP_GRAD_RTOL passes where the plain path, with
# the outputs of the modules the kernels replace rounded apart by about half
# an ulp, comes within the bar of the kernel path's in one of these draws
# (`rounding_grads`): on a trained unconditioned freq_ap model one decoder
# ReLU mask in 1,048,576 switched under such noise and moved the first
# SetConv's length-scale gradient by 2.6e-3 of itself, the plain path
# landing on either side (PERF.md, section 6)
ROUNDING_DRAWS = 8
# traces of one replay a launch count may take: in 82 traced replays, two
# runs of this script on an H100, the profiler left one launch out once (K1's 6.5 us
# context->grid launch of the freq_ap FiLM train step, whose ten graphed
# steps had just equalled the eager ones bit for bit) (PERF.md, section 6)
TRACE_TRIES = 3
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
FAMILY_SEEDS = (0, 1, 2)
FAMILY_RUNS = (
    ("additive", os.path.join(RESULTS, "GW_time_cond_ctx32", "ConvCNP", "run_0"), 1000,
     FAMILY_SEEDS),
    ("dilated", os.path.join(RESULTS, "GW_time_cond_film_ctx64_d128_dil1-1-2-4-8", "ConvCNP",
                             "run_0"), 500, FAMILY_SEEDS),
    ("k37", os.path.join(RESULTS, "GW_time_cond_film_ctx64_d128_k37", "ConvCNP", "run_0"), 500,
     FAMILY_SEEDS),
    ("unet", os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128_unet", "ConvCNP", "run_0"),
     1000, FAMILY_SEEDS),
    ("long k37", os.path.join(RESULTS, "GW_time_cond_film_ctx1024_d512_k37_T2s_np2048_pallas",
                              "ConvCNP", "run_1"), LONG_TRAIN_STEPS, (0,)),
    ("long unet", os.path.join(RESULTS, "GW_time_cond_film_ctx1024_d512_unet_T2s_np2048_pallas",
                               "ConvCNP", "run_0"), LONG_TRAIN_STEPS, (0,)),
    # the frequency-domain configurations (phase 15)
    ("freq film", FREQ_FILM, 1000, FAMILY_SEEDS),
    ("freq", FREQ_UNCOND, 1000, FAMILY_SEEDS),
    # the latent configurations (phase 16)
    ("latent npml", LATENT_NPML, 1000, FAMILY_SEEDS),
    ("latent elbo", LATENT_ELBO, 1000, FAMILY_SEEDS),
    ("latent latlbF", LATENT_LATLBF, 1000, FAMILY_SEEDS),
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
    return errs, zero


def check_train_step(model, summary, gen, dtype=None, term_scale=False):
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
    1.09e-3 of its terms. In float32 a gradient past its bar is accepted
    where the plain path reaches it (within the bar) itself when the
    modules the kernels replace round apart (`rounding_grads`): a discrete
    switch at a rounding boundary that either path may take."""
    bf16 = dtype is not None
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL) if bf16
                            else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
    space, wave = GWParameterSpace(), run_generator(summary)
    theta = space.sample(TRAIN_BATCH, gen)
    x, y, cond = make_eval_batch(theta, wave, space, summary.get("n_points", 256),
                                 summary.get("mode", "time"))
    cond = cond if summary["conditioned"] else None
    batch = None
    res = {}
    for label in ("kernel", "plain"):
        trainer = train_gw.build_trainer(summary, 1, "cuda", use_kernels=label == "kernel" or bf16,
                                         dtype=dtype)
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
        trainer = train_gw.build_trainer(summary, 1, "cuda")
        trainer.model.load_state_dict(model.state_dict())
        gap = abs(trainer.loss_and_grads(batch) - res["plain"][0]).item()
    torch.cuda.synchronize()
    (loss_k, grads_k), (loss_p, grads_p) = res["kernel"], res["plain"]
    loss_rel = (abs(loss_k - loss_p) / (scale if term_scale else abs(loss_p))).item()
    loss_ok = loss_rel <= loss_rtol or (
        gap is not None and abs(loss_k - loss_p).item() <= BF16_PATH_MAX * gap)
    errs, zero = _step_grad_errs(grads_k, grads_p)
    over = [] if bf16 else [n for n, e in errs.items() if e > grad_rtol]
    if over:
        draws = rounding_grads(summary, model.state_dict(), batch, over)
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


def rounding_grads(summary, state, batch, names) -> list:
    """The float32 plain path's gradients of the parameters `names` on
    `batch` from the model state `state`, once for each of `ROUNDING_DRAWS`
    draws, with the outputs of the modules the kernels replace (both
    SetConvs and the decoder) multiplied by 1 + 2^-24 n, n standard normal:
    each output rounded apart by about half an ulp, as a kernel that sums
    in another order rounds it."""
    noise = torch.Generator(device="cuda").manual_seed(0)

    def round_apart(module, inputs, out):
        return out * (1.0 + 2.0 ** -24 * torch.randn(out.shape, generator=noise,
                                                      device=out.device))

    draws = []
    for _ in range(ROUNDING_DRAWS):
        trainer = train_gw.build_trainer(summary, 1, "cuda", use_kernels=False)
        trainer.model.load_state_dict(state)
        m = trainer.model
        hooks = [mod.register_forward_hook(round_apart)
                 for mod in (m.cntxt_to_induced, m.induced_to_trgt, m.decoder)]
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
    unless one trace lists `expected`."""
    for attempt in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        per_replay = traced_launches(prof)
        print(f"one traced replay{tag}: wrapper launches (K1, K2, K3, K2-bf16, K3-bf16) "
              f"{per_replay}; its hand kernels:")
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and hand_kernel_id(e.key) is not None:
                print(f"   x{e.count} {e.key[:100]}")
        short = expected is not None and per_replay != expected and all(
            p <= e for p, e in zip(per_replay, expected))
        if not short or attempt == TRACE_TRIES - 1:
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


def check_graph_train(summary, dtype=None) -> dict:
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
    step's median, norms: the ten eager steps' norms before the clip}."""
    bf16 = dtype is not None
    tag = " (bf16)" if bf16 else ""
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL) if bf16
                            else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
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
    print(f"one graphed step vs one eager step{tag}: thetas and masks bit-identical "
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

    # train_steps_scanned: the same steps on stacked batches made beforehand,
    # each copied into the graph's inputs, against eager steps on them
    check_scanned(summary, dtype, batch, conditioned, tag)
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
    dec = model.decoder.module
    dec_w = (dec.to_hidden.weight, dec.to_hidden.bias,
             torch.stack([dec.linear_0.weight, dec.linear_1.weight, dec.linear_2.weight]),
             torch.stack([dec.linear_0.bias, dec.linear_1.bias, dec.linear_2.bias]),
             dec.out.weight, dec.out.bias)
    ldec = long_model.decoder.module
    long_dec_w = (ldec.to_hidden.weight, ldec.to_hidden.bias,
                  torch.stack([ldec.linear_0.weight, ldec.linear_1.weight, ldec.linear_2.weight]),
                  torch.stack([ldec.linear_0.bias, ldec.linear_1.bias, ldec.linear_2.bias]),
                  ldec.out.weight, ldec.out.bias)
    freq_dec_w = {}
    for run, m in freq_models.items():
        d = m.decoder.module
        freq_dec_w[run] = (d.to_hidden.weight, d.to_hidden.bias,
                           torch.stack([d.linear_0.weight, d.linear_1.weight, d.linear_2.weight]),
                           torch.stack([d.linear_0.bias, d.linear_1.bias, d.linear_2.bias]),
                           d.out.weight, d.out.bias)
    with torch.inference_mode():
        dec_w = tuple(t.detach().contiguous() for t in dec_w)
        long_dec_w = tuple(t.detach().contiguous() for t in long_dec_w)
        freq_dec_w = {run: tuple(t.detach().contiguous() for t in w)
                      for run, w in freq_dec_w.items()}
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

    families = {}
    for name, run_dir, steps, seeds in FAMILY_RUNS:
        for dtype in (None, BF16):
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
             **{f"train_{k.replace(' ', '_')}": f["path"] for k, f in families.items()}}
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
