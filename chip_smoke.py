#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py        # from the repository root, one GPU

It imports nothing of JAX or of the JAX package. Phases, each printed on its
own line:
1. build: nvcc builds the kernels of pl_convlstm_gan_tpu_torch/csrc/ for
   sm_90a (all sources in parallel), with ptxas' register/spill report;
2. cell kernel (K1) against its plain PyTorch version at the nowcast_128 cell
   shapes (B 4, 128x128, (Cx, Ch) = (1, 64) and (64, 64)) and at B 1 in
   float32 and bfloat16, plus a ragged shape (odd H/W, Ch not a multiple of
   the block's channels, K=5); float32 also at gan_64's cells (B 8, 64x64),
   bfloat16 at (256, 256) on 64x64 (four N-blocks of the wgmma kernel);
   kernel, plain and library (one F.conv2d) times, TFLOP/s and the share of
   the bound; each kernel is timed on a weight packed outside the timed
   loop (kernel_pack), and the pack's own time is printed on its own line;
   both dtypes also at the Generator's cells (configs/default.yaml: B 8,
   16x16, (Cx, Ch) = (16, 16) and (16, 32));
3. head kernel (K2) the same way in both dtypes at the head's shape (Ch 64
   -> 1 channel) at B 4 and B 1, and at a ragged shape with Cout 5;
3a. rollout_persistent: K5, the whole bf16 rollout in one cooperative
   launch, at nowcast_128's full width (3x64, 128^2, weights from the seed):
   a cold request at B 4 (5 -> 20), forecast(30) at B 1 and B 8 from states
   K5 observed, observe of 5 frames at B 1 and B 8, and a precip_256 stream
   (2x64, 256^2, B 1: observe 5 frames, forecast(30)). Each call is one K5
   launch and no K1/K2 (counts set to 0 before and read after), torch.equal
   to the K1/K2 host loop (the same _steps walked through convlstm_cell_fwd
   and conv_head_fwd) and within PATH_TOL of the plain path (observe's
   state within 4 bf16 ulps of its binade); timed in turns (host loop, K5,
   K5, host loop) beside the plain path, the per-step F.conv2d sum and
   K5's bound; the slope of forecast(h) over h = 10 and 30 at B 1 and B 8
   against the per-step bound, with block 0's clock of every phase (the
   stamps of rollout_persistent_fwd: each cell's and the head's phase time
   and the barrier's); torch.profiler over one B 1 forecast(30) (idle
   share); ptxas' registers and spills and the launch's grid and blocks an
   SM; and a bf16 model K5 refuses (8-channel frames) served on the K1/K2
   host loop with 72 K1 + 20 K2;
4. main path: load_predictor on configs/nowcast_128.yaml at full width, with
   weights made from a seed and carried through weights.py, in float32 and
   bfloat16; each serves 3 requests of [4, 5, 1, 128, 128] through the
   kernels, checked against rollout_impl="torch" on the card, with the
   launch counts set to 0 before and read after (float32 72 K1 + 20 K2 a
   request, bfloat16 one K5); then torch.profiler over one more bf16
   request: device time by kernel and the device's idle share;
5. stream: StreamingForecaster on the same checkpoint, in float32 and
   bfloat16. observe_window of the first request's 5 frames + forecast(19)
   against the kernel predictor's output for that request (launch counts
   exactly 3 K1 + 1 K2 per observed frame and 3h K1 + h K2 per forecast(h)
   in float32, one K5 a call in bfloat16);
   frame-by-frame observe against the window and two forecasts from one
   state (torch.equal, state unchanged); forecast(30) at B 1 and B 8 against
   rollout_impl="torch" from the same carried state; p50 times of one
   observe and of forecast(30), kernel and plain, beside the forecast's
   bound; torch.profiler over one B 1 forecast(30) (idle share);
6. export: the serving artifacts (serve.py) of nowcast_128 at full width,
   in float32 and bfloat16, weights from the seed through weights.py.
   export_model on the card takes the kernel path (one plcg_torch.rollout
   node); a child process of this script (``--export-worker``) with the
   checkpoint deleted serves the 3 requests from the artifact alone:
   torch.equal to the eager kernel predictor, within PATH_TOL of the plain
   path, 72 K1 + 20 K2 a request (bf16: one K5); a plain artifact exported
   on the CPU serves on the card within PATH_TOL, and a kernel artifact
   exported on the CPU (K1's weights packed there) torch.equal to the
   eager kernel path with the same launches; export_streaming (horizons 10, 30,
   kernel entries) served by load_streaming_exported: the first request's
   frames observed one at a time and forecast(10), forecast(30), then
   forecast(30) at B 1 and B 8, each torch.equal to StreamingForecaster's
   kernel path with 3 K1 + 1 K2 an observed frame and 3h K1 + h K2 a
   forecast(h) (bf16: one K5 a call); configs/default.yaml's Generator (B 8, 16^2 -> 128^2)
   exported on its plain cells, within PATH_TOL of its eager plain path;
   p50 of an artifact request (exported on the card and on the CPU),
   observe and forecast(30) beside the eager path's, in turns;
7. precip_256 (2x64 cells, 256x256, bf16, B 1): observe_window of 5 frames
   and forecast(30) against the plain path, timed; then fit: rollout_impl
   auto on models that K1 or K2 refuse (bf16 Ch 12, f32 7x7 cells, f32 head
   of 6 channels) serves a request and a stream on the plain path with zero
   K1/K2 launches and the bits of rollout_impl torch, rollout_impl kernel
   and pallas raise naming the rule, and nowcast_128 in both dtypes still
   takes the kernels with exact launch counts (bf16: one K5);
7a. int8: nowcast_128 at full width with rollout_impl int8 (weights from
   the seed through weights.py): 3 load_predictor requests of B 4, each
   with its first step's int32 conv sums torch.equal to the same int8
   operands convolved on the CPU, within INT8_CPU_TOL of the int8 path on
   the CPU, and under INT8_MAX_REL_L2 relative L2 from the f32 plain path;
   the p50 of 5 requests (utils.profiling.benchmark_fn) beside the f32 and
   bf16 kernel paths', in turns; the stream: observe_window of the first
   request's 5 frames on the float path (3 K1 + 1 K2 a frame) and
   forecast(30) with no launch, then forecast(30) and one observe at B 1
   and B 8, timed beside the f32 kernel stream's forecast; export_model
   and export_streaming (horizon INT8_HORIZON) under int8 served from
   their bytes, torch.equal to the eager int8 path; the int8 weights'
   bytes beside the f32 weights';
7b. profiling: log_compiled_cost on one nowcast_128_pallas bf16 train step
   on the kernel path (K1's flops counter) and the plain path: the two
   GFLOP within COST_RTOL and equal to the count from the shapes, with the
   peak of allocated memory; profile_trace over one int8 request writes a
   trace file whose aten::_int_mm ops (120) name the int8 GEMM kernels
   (cuBLASLt's, "s8" in the name) they launched;
8. cell_save_z: K1 writing z (the training form, save_z=True) against its
   plain version at the cell shapes of 2 in both dtypes (h', c' and z; the
   Generator's cells included),
   timed beside K1 without z, its bound, plain and library times, TFLOP/s
   and the share of the bound; then
   ConvLSTMCellFn's backward on the card against torch autograd through
   convlstm_step_torch at the (64, 64) shape: all five gradients;
8a. cell_backward: K6, the cell's gate backward, against its plain version
   (the eager ops ConvLSTMCellFn's backward ran before K6) at the nowcast
   cells (bf16, B 4, 128^2, Cx 1 and 64, Ch 64), the Generator's (f32, B 8,
   16^2, (16, 16) and (16, 32)) and a Ch of 20 (the scalar variant): dz,
   dc_prev, xh and db within K6_TOL, two launches bit-equal; at the nowcast
   and Generator cells K6 and the plain version timed in turns beside K6's
   bound (its bytes at 3.35 TB/s) and the host's time a call of each (K6
   as the backward launches it and through its checked wrapper). Every
   phase's launch counts include K6's: 0 wherever nothing trains, one a
   cell step of every training backward (the kernels line's K6 entries
   list each count read, by path);
9. train: configs/nowcast_128_pallas.yaml at full width (3x64, 128x128, B
   4, 5 -> 20, bf16 compute on f32 params), weights from seed 0 through
   weights.py, batches from the port's SyntheticSequenceDataset (seed 0):
   the step-1 gradients, then 5 steps on the kernel path (convlstm_impl
   pallas: 72 K1-with-z and 72 K6 launches a step, no K1 without z, no
   K2) and the same 5 steps on the plain path (xla) from the same state:
   per-step losses, gradients and params after 5 steps within TRAIN_TOL;
   on both paths the step-1 gradient is the loss's eager first call (timed
   as eager_first_fwd_bwd_ms), step 1 captures its CUDA graphs and later
   steps replay them (models/loss_graphs.py: one capture and a replay,
   then a replay a step, no eager call; the launch counts hold through the
   replays); p50 step times, the replayed steps' apart; 72 K1 without z
   per eval batch; torch.profiler over one replayed kernel step (device
   time by kernel group, idle share); then 2 steps in f32;
10. trainer: the CLI's train path on nowcast_128_pallas with 24 sequences
   and 2 epochs, --resume to 3 epochs (starts at epoch 2), --mode eval,
   and load_predictor on the trainer's best_model serving one request on
   K5 (bf16), each with exact launch counts;
11. gan: GAN training at full width (generator 2x64, discriminator
   64/128/256), from one seeded state on the kernel path (convlstm_impl
   pallas: K1 with z and ConvLSTMCellFn in G) and on the plain path (auto):
   gan_64 as written (f32, default step: K1 without z and K1 with z, 28 of
   each a step; B 8, 5 -> 10, 64x64) and gan_256_single with remat cut
   (bf16, vjp step: 68 K1 with z a step; scheduled sampling; B 2, 5 -> 30,
   256x256; the remat phase runs it as written), 3 steps each: step-1
   gradients of G and D, per-step d_total / g_total and params after the
   steps within TRAIN_TOL, default against vjp, p50 step times, peak
   memory, and a profiled kernel step (K1 / cuDNN convs of G / of D /
   elementwise, idle share);
12. gan_trainer: the CLI's train path on gan_64 cut to 24 sequences and 2
   epochs, --resume to 3, --mode eval, and load_predictor serving the
   best_model's gen_params on K1/K2, with exact launch counts;
13. generator: the downscaling Generator of configs/default.yaml at full
   width (hidden (16, 32), T 5, 16x16 -> 128x128, B 8, 16 stations), in
   float32 as written and in bfloat16, weights from seed 0 through
   weights.py, batches of the port's SyntheticDownscalingDataset (64 days,
   seed 0): 3 load_predictor requests on K1 (convlstm_impl pallas: 10 K1 a
   request, none with z) against the plain path (auto) within PATH_TOL,
   the p50 of 5 requests of each path in turns, one forward at the
   reference's test shape (B 2, 32x32 -> 256x256); 3 train steps on both
   paths from one state (10 K1 with z a step; step-1 gradients, per-step
   losses, params after the steps within TRAIN_TOL), an eval batch, the
   steps' p50 in turns and a profiled kernel step (K1 / cuDNN convs /
   elementwise, idle share);
14. generator_trainer: the CLI on configs/default.yaml with convlstm_impl
   pallas, cut to 64 days and 2 epochs, --resume to 3, --mode eval and
   --mode predict on an .npz of rain_lr/dem/lu, with exact launch counts
   and each stage's seconds;
15. remat: gan_256_single as written (bf16, vjp, B 2, 5 -> 30, 256x256,
   remat save_z on the plain cell) against the same run without remat,
   then the kernel path (convlstm_impl pallas) under remat policies "" and
   "dots" against the kernel path without remat, 3 steps each from one
   seeded state and batches: step-1 gradients of G and D, per-step losses
   and params after the steps within TRAIN_TOL, exact K1 counts a step
   (68 with z without remat, 136 under remat: the backward runs each step
   again, K1 included), p50 step times and the peak of allocated memory of
   every run;
16. dp: data parallelism at world 2 on the one card: two ranks of this
   script (``--dp-worker``) in a gloo group (gloo carries CUDA tensors;
   NCCL refuses two ranks on one GPU), started as child processes under a
   timeout, each on its half of the global batch with the port's train
   steps bound to the group from rank 0's state, against one
   process's steps on the whole batch: nowcast_128_pallas (B 4, 72 K1 with
   z a step per rank), gan_64 (default step, kernel path, B 8: 28 K1 and
   28 K1 with z), default (the Generator, kernel path, B 8, the halves
   with other NaN-station patterns: 10 K1 with z) and dp_v5e16 as written
   but its global batch (16 -> 2, one a rank); per-step losses and params
   after 2 steps within TRAIN_TOL, the step-1 gradients within the
   rounding bound dp_grad_tol derives, params bit-equal across the ranks,
   exact K1 counts on every rank, the forecaster's steps a capture then a
   replay of its loss's CUDA graphs (none for the GAN and the Generator);
   then one NCCL group at world 1 (the
   production backend) running nowcast_128_pallas's DP steps. No scaling
   numbers: the box has one card;
17. tp: tensor parallelism at world 2 (data 1 x model 2) on the one card:
   two ranks of this script (``--tp-worker``) in a gloo group, each holding
   half of every ConvLSTM cell's channels (the plain cell: K1 is refused
   under TP, which each rank checks before any launch), against one
   process's steps on the same global batch from one canonical state:
   tp_nowcast_128 at full width (3x256, 128^2, 5 -> 20) in bf16 as written
   and in f32, its global batch cut 8 -> 2 (two ranks share the card), and
   gan_64 (f32, default step) with model_axis 2; 2 steps each: per-step
   losses within TRAIN_TOL, the params after the steps within TP_PARAM_TOL
   (their move from the init, in norm; the unchanged init must fail it), Adam's
   moments after step 1 within TP_MOMENT_TOL, the replicated params (head, D) bit-equal
   on both ranks, the collectives a step counted exactly (72 all-gathers
   forward, 71 all-reduces backward, the clip's norm and the replicated
   mean), 0 K1 launches, peak allocated memory a rank against one process,
   step ms on the shared card; then the TP trainer trains one epoch of
   tp_nowcast_128 cut to 8 sequences, and one process serves its canonical
   best_model (load_predictor) against the TP model's prediction of the
   same request (plain path), and on K5 (one launch). No NCCL
   (it refuses two ranks on one GPU), no scaling numbers;
18. tap_structure: the tap-structure experiment (P5 on Hopper) at its full
   shape through experiments.tap_structure.run() with its launch counts,
   then K3 and K4 against their plain versions (rtol 2^-7), timed in
   turns, beside the plain versions, 64 cuBLAS products and the bound;
   each also in a CUDA graph at 64 and 8 repetitions: the device time,
   and the work-done guard (the 56 extra repetitions take at least their
   FLOPs at the bf16 peak; no rate above 1.05x the peak), with the
   steady-state TFLOP/s of that slope;
8b. st_gates: K7, the ST-LSTM cell's gate passes (A and B, forward and
   backward, some gradients absent), against their plain versions at
   PredRNN-V2's KTH width (B 8 x 32^2 pixels, F 128) in bf16 and float32
   and at a scalar width; the KTH shapes timed in turns (queued_ms)
   beside K7's byte bound, with the wrapper's host time;
9a. predrnn: PredRNN-V2 at its KTH widths (4 x 128, 5x5, patch 4, 128^2,
   10 -> 20 frames, B 8, bf16, masks at p 0.5): a train step's loss and
   gradients on K7 against the same step on K7's plain versions from one
   state (PREDRNN_TOL), six train steps timed (304 K7 launches each, no
   K1/K2/K5/K6; from the third on, replays of the CUDA graphs the second
   captured), a profile of one, and a request of 10 frames through
   load_predictor (152 K7 launches) against the plain versions'; K7 reads
   0 on every ConvLSTM phase (expect_counts);
19. one JSON line {"kernels": [...]} with each kernel's launches (per path,
   K5's among them; K1's and K2's bf16 launches those of the host loop a
   model K5 refuses keeps,
   the artifacts' (export_predict, export_stream), the int8 stream's
   observe (int8_stream), the Generator's, remat's, dp's and tp's (0)
   included), error, and its
   time beside
   its bound, its
   plain version's and the library call's (K1 with z as its own entry; K1
   to K4; K1 also over the Generator's two cells, ``generator_mix``);
then the card's name and power limit (nvidia-smi), and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.

On four GPUs: ``--tp-nccl`` runs phase 17 over NCCL, one rank a GPU;
``--dp-nccl`` runs phase 16's NCCL run (nowcast_128_pallas, global batch 4)
at world 2 and 4, one rank a GPU, against one process.
"""
import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.data import (SyntheticDownscalingDataset,
                                            SyntheticSequenceDataset,
                                            batch_iterator, to_device)
from pl_convlstm_gan_tpu_torch.models.quantized import (
    _int8_step, _zero_states, prepare_int8_forecaster)
from pl_convlstm_gan_tpu_torch.ops.convlstm import convlstm_step_torch
from pl_convlstm_gan_tpu_torch.ops.kernels import build
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as cell_mod
from pl_convlstm_gan_tpu_torch.ops.kernels import rollout_kernel as head_mod
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    ConvLSTMCellFn, cell_backward, cell_backward_plain, convlstm_cell_fwd,
    convlstm_cell_plain, kernel_pack)
from pl_convlstm_gan_tpu_torch.ops.kernels import st_gates_kernel as k7_mod
from pl_convlstm_gan_tpu_torch.ops.kernels import tap_structure_kernel as tap_mod
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    conv_head_fwd, conv_head_plain, persistent_misfit, rollout_persistent_fwd,
    rollout_schedule)
from pl_convlstm_gan_tpu_torch.ops.kernels.st_gates_kernel import (
    st_gates_bwd_plain, st_gates_plain, st_hidden_bwd_plain, st_hidden_plain)
from pl_convlstm_gan_tpu_torch.ops.kernels.tap_structure_kernel import (
    big_plain, tap_k1152, tap_loop, taps_plain)
from pl_convlstm_gan_tpu_torch.ops.nn import oihw_from_hwio
from pl_convlstm_gan_tpu_torch.ops.quant import (conv2d_int8, dynamic_scale,
                                                 quantize_act)
from pl_convlstm_gan_tpu_torch.predict import (
    build_discriminator, build_model, build_predict_fn, load_predictor,
    load_state_dict, rollout_choice)
from pl_convlstm_gan_tpu_torch.serve import (
    export_model, export_streaming, load_exported, load_streaming_exported,
    parse_stream_header)
from pl_convlstm_gan_tpu_torch.streaming import StreamState, StreamingForecaster
from pl_convlstm_gan_tpu_torch.train.steps import (
    GANTrainState, TrainState, forecaster_eval_step, forecaster_loss,
    forecaster_train_step, gan_d_loss, gan_g_loss, gan_train_step,
    generator_eval_step, generator_loss, generator_train_step, loss_config,
    make_optimizer)
from pl_convlstm_gan_tpu_torch.utils.profiling import (
    benchmark_fn, counters, log_compiled_cost, profile_trace)
from pl_convlstm_gan_tpu_torch.weights import flax_to_state_dict

SEED = 0
DEVICE = "cuda"
N_REQUESTS = 3
# published peaks of one H100 SXM (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 without tensor cores
# kernel vs plain version on the same inputs, per element:
#   float32: both sum the same ~1e3 products in different orders -> ~1e-6;
#   bfloat16: both round the same f32 value once at the store, so they differ
#   by at most one bf16 ulp where the f32 values straddle a rounding point:
#   2^-7 = 7.8e-3 for the |values| < 2 of h and c here.
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 0.0)}   # (atol, rtol)
# kernel path vs rollout_impl="torch" over a whole 24-step request, whose
# outputs are below 0.0625 here (checked): float32 differs by sums taken in
# other orders (~1e-7); bfloat16 by stored values an ulp apart (2^-12 =
# 2.4e-4 at these magnitudes) carried through the recurrence: 1e-3 is 4 ulps.
PATH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 0.0)}
MAX_OUTPUT = 0.0625
K1_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/convlstm_cell.cu"
K2_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/conv_head.cu"
K1_REPLACES = "pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:121"
K2_REPLACES = "pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py:407"
# every TPU kernel each CUDA kernel stands for (PERF.md's table)
_ROLLOUT = "pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py"
K1_STANDS_FOR = [
    "P1 pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:121 (save_z=False)",
    "P2 pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:247 (save_z=False)",
    f"P3 cells {_ROLLOUT}:505 via rollout_pallas :672",
    f"P4 cells {_ROLLOUT}:505 via rollout_pallas_from_state :706"]
K2_STANDS_FOR = [f"P3 head_pass {_ROLLOUT}:407 via rollout_pallas :672",
                 f"P4 head_pass {_ROLLOUT}:407 via rollout_pallas_from_state :706"]
# K5: the whole bf16 rollout in one cooperative launch
K5_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/rollout_persistent.cu"
K5_REPLACES = f"{_ROLLOUT}:505"
K5_STANDS_FOR = [f"P3 {_ROLLOUT}:505 (_launch_rollout) via rollout_pallas :672",
                 f"P4 {_ROLLOUT}:505 (_launch_rollout) via "
                 f"rollout_pallas_from_state :706"]
K5_SLOPE_HORIZONS = (10, 30)   # forecast(h) whose difference is the slope
# K1 writing z (the training form) stands for P1/P2 with save_z=True
K1Z_STANDS_FOR = [
    "P1 pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:121 (save_z=True, "
    "z stored at :81-82) via _fwd :331",
    "P2 pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:247 (save_z=True, "
    "z stored at :213-215) via _fwd :331"]
# z against the plain version's z: the same KERNEL_TOL atol, plus one bf16
# ulp relative (2^-7 |z|) because z reaches |z| ~ 2 here, where one ulp
# (2^-6) is above the 1e-2 that holds h' and c' (|h|, |c| < 2)
Z_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2.0 ** -7)}
# ConvLSTMCellFn's gradients against torch autograd through
# convlstm_step_torch on the same operands, as max |diff| / max |reference|
# per gradient: float32 (TF32 off) differs by sums in other orders (~1e-6);
# bfloat16 by the backward's inputs: the Function recomputes the gates from
# z and c' stored in bf16 (relative error up to 2^-9 each), autograd from
# float32 values it never rounded, and each gradient is rounded to bf16
# (2^-9) at the end: a few bf16 ulps of the largest gradient
CELL_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K6 (csrc/cell_backward.cu) against cell_backward_plain on the same CUDA
# tensors (tests/test_torch_cell_backward.py states the reasons): dz (and
# float32 dc_prev) 2^-20 relative plus 2^-20 of the largest magnitude
# (float32 ulps: the same operations in the same order, expf / tanhf of two
# builds); bf16 dc_prev one bf16 ulp (2^-7 relative); db per channel 2^-15
# of the sum of |dz| (the same terms summed in other orders) plus a bf16
# ulp where it is rounded to bf16
K6_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/cell_backward.cu"
K6_REPLACES = ("none: XLA's fusion of _bwd's gate algebra, "
               "pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:336-385")
K6_TOL = {"dz": 2.0 ** -20, "dc_prev_bf16": 2.0 ** -7, "db": 2.0 ** -15}
# K7 (csrc/st_lstm_gates.cu) against its plain versions on the same CUDA
# tensors (tests/test_torch_st_gates.py states the reasons): 2^-18 of the
# largest magnitude (float32 ulps of the same operations in the same order,
# expf / tanhf of two builds), plus one bf16 ulp (2^-7 relative) where the
# result is rounded to bf16
K7_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/st_lstm_gates.cu"
K7_REPLACES = ("none: the JAX package has no PredRNN; the ST-LSTM cell's "
               "gate algebra (models/predrnn.py), ~75 eager launches a "
               "cell-step forward and backward")
K7_TOL = {"max": 2.0 ** -18, "bf16": 2.0 ** -7}
# PredRNN-V2 at its KTH widths (bench_cuda/configs/predrnn_v2_kth_bf16.json)
PREDRNN_MODEL = {"family": "predrnn", "hidden_dims": [128] * 4,
                 "kernel_size": 5, "patch_size": 4, "in_channels": 1,
                 "input_frames": 10, "output_frames": 10,
                 "decouple_beta": 0.1}
PREDRNN_B, PREDRNN_SIZE = 8, 128
# the K7 path against the same model with K7's plain versions on the card,
# bf16, from one state: both round at the same sites, and differ by a bf16
# ulp where expf / tanhf of two builds straddle a rounding point; the
# recurrence carries such ulps through 19 steps and 4 layers, and the
# decoupling term's |cos| flips the sign of a pair's gradient where its
# cosine lies within such a change of zero, so the gradients are compared
# by the norm of their difference over all parameters
PREDRNN_TOL = {"loss": 1e-3, "request": 2e-2, "grad": 5e-2}
TRAIN_STEPS = {"bfloat16": 5, "float32": 2}
# kernel path (K1 + ConvLSTMCellFn) against the plain path (autograd through
# convlstm_step_torch) from one state, same batches:
TRAIN_TOL = {
    # |loss_k - loss_p| per step: L1 is 1-Lipschitz in the predictions, so
    # it is at most max |pred_k - pred_p|, which PATH_TOL's atol bounds
    # (later steps start from params that differ as bounded below).
    # Measured on an H100: float32 0, bfloat16 7.4e-7
    "loss": {"float32": 1e-5, "bfloat16": 1e-3},
    # ||g_k - g_p|| / ||g_p|| at step 1 over all params: float32 sums in
    # other orders; bfloat16 the per-element differences of CELL_GRAD_TOL
    # (a few bf16 ulps of the largest element), which a norm over 0.9 M
    # elements averages down. Measured: float32 3.3e-8, bfloat16 6.7e-5
    "grad": {"float32": 1e-4, "bfloat16": 1e-3},
    # max |p_k - p_p| after the steps: Adam moves an element by about lr a
    # step (|m_hat| / sqrt(v_hat) ~ 1 while a gradient keeps its sign), so
    # an element whose gradient's sign differs between the paths (it lies
    # within the gradient error of 0) lands at most 2 lr per step away.
    # Measured: float32 1.5e-7 (2 steps), bfloat16 8.7e-5 (5 steps)
    "param": {"float32": 2e-3 * 2, "bfloat16": 2e-3 * 5},
}
TRAINER_SEQUENCES = 24
TRAINER_EPOCHS = 2
K3_SOURCE = K4_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/tap_structure.cu"
K3_REPLACES = "experiments/pallas_tap_structure.py:48"
K4_REPLACES = "experiments/pallas_tap_structure.py:52"
K3_STANDS_FOR = ["P5 experiments/pallas_tap_structure.py taps_kernel :15 "
                 "(pallas_call :48)"]
K4_STANDS_FOR = ["P5 experiments/pallas_tap_structure.py big_kernel :25 "
                 "(pallas_call :52)"]
# K3/K4 against taps_plain/big_plain: both sum float32 products in other
# orders and round once to bf16; outputs are ~1.8e4, where one bf16 ulp is
# 128, so where a float32 value straddles a rounding point they land one
# ulp apart: 2 ulps relative at the finest spacing, 2^-7
TAP_RTOL = 2.0 ** -7
# the work-done guard: each kernel in a CUDA graph at TAP_LOW_REPS and at
# REPS; the difference is the extra repetitions' work alone, which the
# tensor cores cannot do in less than its FLOPs at the bf16 peak. A rate
# above the peak (with 5 % for the clock's boost) means work was skipped.
TAP_LOW_REPS = 8
TAP_GRAPH_ITERS = 20
TAP_MAX_RATE = 1.05
# the GAN configurations of the gan phase: (config, compute dtype, step
# impl, teacher-forcing prob of the draws, steps, the cuts made); each runs
# at full width from one seeded state on both paths
GAN_RUNS = (
    ("gan_64", "float32", "default", 0.0, 3, []),
    ("gan_256_single", "bfloat16", "vjp", 0.5, 3,
     ["model.remat true -> false and remat_policy save_z -> '' (the remat "
      "phase runs it as written)", "depth: 3 steps of the 30-epoch run"]),
)
# default against vjp on the kernel path, one step from one state: the
# same math; the JAX test's bounds (tests/test_sequence_trainer.py:100-107)
# on the losses; params within 2 lr (an element whose gradient lies within
# the reduction-order noise of 0 may take Adam's other sign)
GAN_IMPL_LOSS_TOL = (1e-6, 1e-5)
GAN_TRAINER_SEQUENCES = 24
# the downscaling Generator (configs/default.yaml): the JAX bench's parity
# Generator batch (bench.py:207-212) and the reference's test shape (B 2,
# 32^2 -> 256^2)
GEN_DATA = dict(num_days=64, T=5, lr_size=16, scale_factor=8,
                num_stations=16, seed=SEED)
GEN_TRAIN_STEPS = 3
GEN_REF_SHAPE = (2, 32)
GEN_TRAINER_SEQUENCES = 64
# the Generator's outputs stay below 0.125 here (checked; ~0.07 with these
# weights), where a bf16 ulp is 2^-11 = 4.9e-4: PATH_TOL's bfloat16 1e-3 is
# two ulps of the rounded output
GEN_MAX_OUTPUT = 0.125
# the JAX bench's streaming rows (bench.py:263-298): horizon 30 at B 1 and 8
STREAM_HORIZON = 30
STREAM_BATCHES = (1, 8)
N_TIMED = 5
# int8 (rollout_impl: int8) on the card against the same int8 path on the
# CPU. The int32 sums are exact on both; the float32 gates' sigmoid/tanh
# differ by ulps between CUDA and the CPU, which can move an int8 level of a
# later conv input by one. One level of the head's input (|h| < 1, so a
# level is at most 1/127) moves an output by at most 1/127 times the head's
# largest weight (1/sqrt(9*64) at torch's default init): 3.3e-4. The bound
# allows three such levels in one output's 3x3 window.
INT8_CPU_TOL = 1e-3
# against the f32 plain path: JAX's bound (tests/test_quant.py:185)
INT8_MAX_REL_L2 = 0.08
# the int8 stream artifact's horizon: torch.export traces every step of the
# unrolled loop (~1.5 s a step at nowcast_128), so 10, not 30
INT8_HORIZON = 10
COST_RTOL = 1e-6           # kernel against plain GFLOP of one train step


def say(**fields):
    print(json.dumps(fields), flush=True)


def check_close(what, got, want, atol, rtol):
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite values")
    if bool((diff > bound).any()):
        raise AssertionError(f"{what}: max abs error {float(diff.max()):.3e} "
                             f"beyond atol={atol} rtol={rtol}")
    return float(diff.max())


def time_ms(fn, iters):
    """Mean device time of fn over `iters` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters, hold_cycles=100_000_000):
    """Mean device time of fn over `iters` back-to-back calls, as time_ms,
    but issued while the device is held by a spin kernel of
    ``hold_cycles`` clocks (~50 ms): the calls wait queued, so the events
    time their device work alone, not the host's issue of each call (which
    sets time_ms for work shorter than its launch)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of fn over `iters` calls captured in one CUDA graph
    and replayed (after a warm-up call and a warm-up replay): the launches
    back to back on the device without the host's launch gaps, for kernels
    shorter than one Python launch."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def raw_launcher(lib, symbol, argtypes, tensors, ints):
    """The kernel's C entry bound to fixed operands: a launch without the
    wrapper's Python checks (for timing, after the wrapper has checked them
    once) through ``build.launch``, on the current stream; a None operand
    passes a null pointer. It does not touch the wrapper's launch counts."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    device = tensors[0].device

    def launch():
        build.launch(lib, symbol, argtypes, device, *ptrs, *ints, what=symbol)
    return launch


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_build():
    """Build every kernel; returns {source: ptxas' register, spill and
    warning lines}."""
    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    say(phase="build", seconds=round(seconds, 3),
        per_source={k: round(v["seconds"], 3) for k, v in report.items()})
    lines = {}
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if any(word in line for word in ("registers", "spill", "wgmma",
                                             "warning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
                lines.setdefault(name, []).append(line.strip())
    return lines


def cell_inputs(gen, b, hgt, wid, cx, ch, k, dtype):
    dev = DEVICE
    u = lambda shape, lo, hi: torch.empty(shape, device=dev).uniform_(
        lo, hi, generator=gen)
    bnd = 1.0 / (k * k * (cx + ch)) ** 0.5
    return [t.to(dtype).contiguous() for t in (
        u((b, hgt, wid, cx), -1, 1), u((b, hgt, wid, ch), -1, 1),
        u((b, hgt, wid, ch), -1, 1), u((k, k, cx + ch, 4 * ch), -bnd, bnd),
        u((4 * ch,), -bnd, bnd))]


def cell_launcher(dtype, x, h, c, w, packed, bias, h_out, c_out, z):
    """K1's raw launch on fixed operands: it reads the weight packed in its
    dtype's layout (kernel_pack, packed beforehand, outside any timed
    loop)."""
    b, hgt, wid, cx = x.shape
    return raw_launcher(
        "convlstm_cell", cell_mod._SYMBOLS[dtype], cell_mod._ARGTYPES,
        (x, h, c, packed, bias, h_out, c_out, z),
        (b, hgt, wid, cx, h.shape[-1], w.shape[0]))


def cell_costs(rec, x, h, w, bias, z, name):
    """The bound and achieved rate of one timed K1 record: operations
    2*B*H*W*K*K*Cin*4Ch; bytes x, h, c, h', c' (and z), the HWIO weight
    and the bias, each once."""
    b, hgt, wid, cx = x.shape
    k, ch = w.shape[0], h.shape[-1]
    flops = 2 * b * hgt * wid * k * k * (cx + ch) * 4 * ch
    nbytes = x.element_size() * (x.numel() + 4 * h.numel() + w.numel()
                                 + bias.numel() + (0 if z is None else z.numel()))
    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, name)
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def time_pack(w, name, shape, phase):
    """kernel_pack's time on the card (K1's weight layout of w's dtype, made
    once per predictor, stream or training forward pass), printed on its own
    line. Returns (packed, ms)."""
    packed = kernel_pack(w, w.dtype)
    ms = time_ms(lambda: kernel_pack(w, w.dtype), 20)
    say(phase=phase + "_pack", dtype=name, shape=shape, pack_ms=ms)
    return packed, ms


def phase_cell(gen, shapes):
    """K1 against its plain version; returns {dtype: [per-shape records]}.
    ``shapes`` = {dtype: [(B, H, W, Cx, Ch, K, role)]}, role "mix" (timed,
    in the kernels line's per-request mix), "generator" (timed, in the
    Generator's mix), "timed" or None (checked only)."""
    out = {}
    for dtype, dtype_shapes in shapes.items():
        name = str(dtype).split(".")[-1]
        atol, rtol = KERNEL_TOL[name]
        recs = []
        for (b, hgt, wid, cx, ch, k, role) in dtype_shapes:
            x, h, c, w, bias = cell_inputs(gen, b, hgt, wid, cx, ch, k, dtype)
            hk, ck = convlstm_cell_fwd(x, h, c, w, bias)
            hp, cp = convlstm_cell_plain(x, h, c, w, bias)
            torch.cuda.synchronize()
            err = max(check_close(f"K1 h' {name} {(b, cx, ch, k)}", hk, hp, atol, rtol),
                      check_close(f"K1 c' {name} {(b, cx, ch, k)}", ck, cp, atol, rtol))
            rec = dict(shape=[b, hgt, wid, cx, ch, k], max_abs_err=err,
                       mix=role == "mix", generator=role == "generator")
            if role is not None:
                packed, rec["pack_ms"] = time_pack(w, name, rec["shape"],
                                                   "cell_kernel")
                h_out, c_out = torch.empty_like(h), torch.empty_like(c)
                launch = cell_launcher(dtype, x, h, c, w, packed, bias, h_out,
                                       c_out, None)
                rec["ms"] = time_ms(launch, 20)
                rec["plain_ms"] = time_ms(
                    lambda: convlstm_cell_plain(x, h, c, w, bias), 5)
                xh = torch.cat([x, h], -1).permute(0, 3, 1, 2)  # channels_last
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                rec["library_ms"] = time_ms(
                    lambda: F.conv2d(xh, w_oihw, bias, padding=k // 2), 20)
                cell_costs(rec, x, h, w, bias, None, name)
            say(phase="cell_kernel", dtype=name, tol=[atol, rtol], **rec)
            recs.append(rec)
        out[name] = recs
    return out


def phase_head(gen, shapes, dtypes):
    out = {}
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        atol, rtol = KERNEL_TOL[name]
        recs = []
        for (b, hgt, wid, cin, cout, k, timed) in shapes:
            u = lambda shape, lo, hi: torch.empty(shape, device="cuda").uniform_(
                lo, hi, generator=gen).to(dtype)
            bnd = 1.0 / (k * k * cin) ** 0.5
            h = u((b, hgt, wid, cin), -1, 1)
            w, bias = u((k, k, cin, cout), -bnd, bnd), u((cout,), -bnd, bnd)
            ok = conv_head_fwd(h, w, bias)
            op = conv_head_plain(h, w, bias)
            torch.cuda.synchronize()
            err = check_close(f"K2 {name} {(cin, cout, k)}", ok, op, atol, rtol)
            rec = dict(shape=[b, hgt, wid, cin, cout, k], max_abs_err=err)
            if timed:
                o = torch.empty_like(ok)
                launch = raw_launcher("conv_head", head_mod._SYMBOLS[dtype],
                                      head_mod._ARGTYPES, (h, w, bias, o),
                                      (b, hgt, wid, cin, cout, k))
                # K2 and its library call take ~10 us: the eager loop (ms,
                # library_ms, as in earlier records) includes the host's
                # launch rate; a graph of the launches (graph_ms,
                # library_graph_ms) gives the device time alone
                h_nchw = h.permute(0, 3, 1, 2)                    # channels_last
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                library = lambda: F.conv2d(h_nchw, w_oihw, bias, padding=k // 2)
                rec["ms"], rec["graph_ms"] = time_ms(launch, 50), graph_ms(launch, 50)
                rec["plain_ms"] = time_ms(lambda: conv_head_plain(h, w, bias), 50)
                rec["library_ms"] = time_ms(library, 50)
                rec["library_graph_ms"] = graph_ms(library, 50)
                flops = 2 * b * hgt * wid * k * k * cin * cout
                nbytes = h.element_size() * (h.numel() + w.numel() + bias.numel()
                                             + o.numel())
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, name)
                rec["bound_share"] = rec["bound_ms"] / rec["graph_ms"]
            say(phase="head_kernel", dtype=name, tol=[atol, rtol], **rec)
            recs.append(rec)
        out[name] = recs
    return out


def rollout_bound_ms(b, hgt, wid, cin, hidden, steps, heads, frames_in,
                     k=3, dtype_name="bfloat16"):
    """A rollout's bound as one function: operations (every cell phase's
    conv and every head phase's) at the dtype's peak against bytes (the
    frames in, the seeds, every weight, the outputs and the final state,
    each once) at the memory rate; ``steps`` cell steps, ``heads`` head
    steps, ``frames_in`` frames read."""
    px = b * hgt * wid
    flops, wbytes, cx = 0, 0, cin
    for ch in hidden:
        flops += 2 * px * k * k * (cx + ch) * 4 * ch
        wbytes += k * k * (cx + ch) * 4 * ch + 4 * ch
        cx = ch
    flops = steps * flops + heads * 2 * px * 9 * cx * cin
    state = 2 * px * sum(hidden)                  # (h, c) of every cell
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * (frames_in * px * cin + state + wbytes + 9 * cx * cin
                     + cin + heads * px * cin + state)
    return bound(flops, nbytes, dtype_name)


def conv_parts(b, hgt, wid, cin, hidden, dtype, k=3):
    """(one step's cell convs, the head's conv) as library calls: F.conv2d
    over concat(x, h) per cell and over the top h, channels-last, without
    the gates; a rollout of s steps and e heads costs s x the first and e x
    the second."""
    convs, cx = [], cin
    for ch in hidden:
        xh = torch.randn(b, hgt, wid, cx + ch, device=DEVICE, dtype=dtype)
        convs.append((xh.permute(0, 3, 1, 2),
                      torch.randn(4 * ch, cx + ch, k, k, device=DEVICE,
                                  dtype=dtype),
                      torch.randn(4 * ch, device=DEVICE, dtype=dtype), k // 2))
        cx = ch
    h = torch.randn(b, hgt, wid, cx, device=DEVICE, dtype=dtype).permute(
        0, 3, 1, 2)
    w = torch.randn(cin, cx, 3, 3, device=DEVICE, dtype=dtype)
    bias = torch.randn(cin, device=DEVICE, dtype=dtype)
    return (lambda: [F.conv2d(x, wt, bt, padding=p) for x, wt, bt, p in convs],
            lambda: F.conv2d(h, w, bias, padding=1))


def p50_turns(a, b, n=N_TIMED):
    """{"a": (p50 ms, [ms...]), "b": ...} of two calls timed in turns a, b,
    b, a, n times, after one warm-up call each (CUDA events around each
    call, as p50_ms)."""
    a(), b()
    torch.cuda.synchronize()
    times = {"a": [], "b": []}
    for _ in range(n):
        for name, fn in (("a", a), ("b", b), ("b", b), ("a", a)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: (statistics.median(ts), ts) for name, ts in times.items()}


def state_close(what, got, want):
    """A state against the plain path's: PATH_TOL's bf16 bound of 4 ulps,
    at the binade of the state's largest magnitude (|c| reaches ~1 where
    outputs stay below 0.0625)."""
    top = max(float(t.float().abs().max()) for pair in want for t in pair)
    atol = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
    return max(check_close(f"{what} state", g, w, atol, 0.0)
               for pg, pw in zip(got, want) for g, w in zip(pg, pw))


def stamp_summary(stamps, table):
    """K5's per-phase clock of block 0 (rollout_persistent_fwd's stamps,
    split by ``rollout_kernel.stamp_phases``): the mean µs of each cell's
    phases and of the head's (block 0's tiles), and of a barrier (from
    block 0's last tile to the barrier's exit)."""
    p = head_mod.stamp_phases(stamps.cpu(), table)
    return dict(total_us=p["total_us"],
                phase_us={k: v / p["phases"][k]
                          for k, v in p["work_us"].items()},
                barrier_us=(p["barrier_us"] / p["barriers"] if p["barriers"]
                            else 0.0),
                barriers=p["barriers"])


def k5_weights(cfg, seed):
    """The config's forecaster, weights made from the seed, on the card in
    bf16, packed for K1/K5."""
    sd = flax_to_state_dict(nowcast_params(cfg, seed))
    return head_mod.pack_weights({k: v.to(DEVICE) for k, v in sd.items()},
                                 torch.bfloat16)


def k5_call(name, weights, hidden, frames, cells, horizon, t_out):
    """One K5 call of the phase: a cold request (``cells`` None, ``t_out``
    frames out), a forecast(horizon) from (``cells``, the frame
    ``frames``) or an observe of ``frames`` into ``cells`` (``horizon``
    None, ``t_out`` None). Returns (a function of the two executors' fns
    -> the result, steps, heads, frames read)."""
    bf = torch.bfloat16
    b, hgt, wid = frames.shape[0], frames.shape[-2], frames.shape[-1]
    if cells is None:
        t_in = frames.shape[1]
        run = lambda fns: head_mod._rollout(weights, frames, t_out, bf, *fns)
        return run, t_in + t_out - 1, t_out, t_in
    if horizon is not None:
        prev = frames[:, -1].permute(0, 2, 3, 1).to(bf).contiguous()
        run = lambda fns: head_mod._rollout_from_state(
            weights, cells, prev, horizon, bf, *fns)
        return run, horizon, horizon, 1
    t = frames.shape[1]

    def run(fns):
        fr = head_mod._time_major(weights, frames, bf)
        seeds = head_mod._seeds(weights, cells, b, hgt, wid, bf, fr.device)
        out, state = head_mod._steps(weights, fr, t, 0, seeds, *fns)
        return state, out[-1]
    return run, t, t, t


def phase_rollout_persistent(tmp, requests, frames8, seed, ptxas):
    """K5 (see the module docstring, 3a). Returns its record."""
    bf = torch.bfloat16
    atol, rtol = PATH_TOL["bfloat16"]
    K5 = (None, None)                     # _steps' kernel path: K5 in bf16
    HOST = (convlstm_cell_fwd, conv_head_fwd)
    PLAIN = (convlstm_cell_plain, conv_head_plain)
    cfg = load_config("nowcast_128")
    mc = cfg.model
    hidden, cin = tuple(mc.hidden_dims), mc.in_channels
    why = persistent_misfit(hidden, cin, mc.kernel_size, bf)
    if why is not None:
        raise AssertionError(f"K5 refuses nowcast_128: {why}")
    weights = k5_weights(cfg, seed)
    size = frames8.shape[-1]
    zero = lambda nb, hid, size: tuple(
        (torch.zeros(nb, size, size, ch, device=DEVICE, dtype=bf),) * 2
        for ch in hid)
    warm = {}
    for nb in STREAM_BATCHES:
        warm[nb], _ = head_mod.observe_kernel(weights, zero(nb, hidden, size),
                                              frames8[:nb], bf)
    calls = [("request_b4", weights, hidden, requests[0], None, None,
              mc.output_frames)]
    for nb in STREAM_BATCHES:
        calls.append((f"forecast{STREAM_HORIZON}_b{nb}", weights, hidden,
                      frames8[:nb], warm[nb], STREAM_HORIZON, None))
    for nb in STREAM_BATCHES:
        calls.append((f"observe{mc.input_frames}_b{nb}", weights, hidden,
                      frames8[:nb], warm[nb], None, None))
    pcfg = load_config("precip_256")
    p_hidden, p_size = tuple(pcfg.model.hidden_dims), \
        pcfg.data.synthetic_image_size
    p_weights = k5_weights(pcfg, seed)
    p_frames = torch.from_numpy(np.random.default_rng(seed).random(
        (1, pcfg.model.input_frames, pcfg.model.in_channels, p_size, p_size),
        dtype=np.float32)).to(DEVICE)
    p_warm, _ = head_mod.observe_kernel(p_weights, zero(1, p_hidden, p_size),
                                        p_frames, bf)
    calls += [("precip_256_observe5_b1", p_weights, p_hidden, p_frames,
               zero(1, p_hidden, p_size), None, None),
              (f"precip_256_forecast{STREAM_HORIZON}_b1", p_weights, p_hidden,
               p_frames, p_warm, STREAM_HORIZON, None)]

    recs = {}
    for name, w, hid, frames, cells, horizon, t_out in calls:
        run, steps, heads, frames_in = k5_call(name, w, hid, frames, cells,
                                               horizon, t_out)
        b, hgt = frames.shape[0], frames.shape[-1]
        reset_counts()
        got = run(K5)
        torch.cuda.synchronize()
        launches = expect_counts(f"K5 {name}", 0, 0, k5=1)
        grid = dict(rollout_persistent_fwd.last_launch)
        host = run(HOST)
        plain = run(PLAIN)
        torch.cuda.synchronize()
        if horizon is None and t_out is None:          # observe
            (state, prev), (h_state, h_prev), (p_state, p_prev) = \
                got, host, plain
            if not (torch.equal(prev, h_prev) and states_equal(
                    StreamState(state, prev), StreamState(h_state, h_prev))):
                raise AssertionError(f"K5 {name}: differs from the K1/K2 "
                                     f"host loop")
            err = check_close(f"K5 {name} prev_out vs plain", prev, p_prev,
                              atol, rtol)
            err_state = state_close(f"K5 {name}", state, p_state)
            max_out = float(p_prev.float().abs().max())
        else:
            if not torch.equal(got, host):
                raise AssertionError(f"K5 {name}: differs from the K1/K2 "
                                     f"host loop")
            err, err_state = check_close(f"K5 {name} vs plain", got, plain,
                                         atol, rtol), None
            max_out = float(plain.abs().max())
        if max_out >= MAX_OUTPUT:
            raise AssertionError(f"K5 {name}: outputs reach {max_out}, "
                                 f"beyond the range PATH_TOL was set for")
        times = p50_turns(lambda: run(HOST), lambda: run(K5))
        plain_ms = p50_ms({"plain": lambda: run(PLAIN)})["plain"][0]
        cells_fn, head_fn = conv_parts(b, hgt, hgt, 1, hid, bf)
        lib = p50_ms({"cells": cells_fn, "head": head_fn})
        bound_ms, bound_by = rollout_bound_ms(b, hgt, hgt, 1, hid, steps,
                                              heads, frames_in)
        recs[name] = dict(
            batch=b, size=hgt, hidden=list(hid), steps=steps, heads=heads,
            launches=launches, grid=grid, equal_to_host_loop=True,
            max_abs_err=err, max_abs_err_state=err_state,
            max_abs_output=max_out, ms=times["b"][0],
            host_loop_ms=times["a"][0], plain_ms=plain_ms,
            library_ms=steps * lib["cells"][0] + heads * lib["head"][0],
            bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / times["b"][0],
            ms_all=times["b"][1], host_loop_ms_all=times["a"][1])
        say(phase="rollout_persistent", call=name, tol=[atol, rtol],
            **recs[name])

    # the per-step slope of forecast(h) over K5_SLOPE_HORIZONS, K5 and the
    # host loop in turns, against the per-step bound; block 0's clock of
    # each phase
    slopes = {}
    for nb in STREAM_BATCHES:
        t = {}
        for h in K5_SLOPE_HORIZONS:
            run = k5_call("slope", weights, hidden, frames8[:nb], warm[nb],
                          h, None)[0]
            times = p50_turns(lambda: run(HOST), lambda: run(K5))
            t[h] = (times["b"][0], times["a"][0])
        lo, hi = K5_SLOPE_HORIZONS
        fr = head_mod._time_major(weights, frames8[:nb, -1:], bf)
        seeds = head_mod._seeds(weights, warm[nb], nb, size, size, bf,
                                fr.device)
        table = rollout_schedule(len(hidden), STREAM_HORIZON, 0, 1)
        stamps = torch.zeros(1 + 2 * table.shape[0], dtype=torch.int64,
                             device=DEVICE)
        for _ in range(2):                     # the second is the one kept
            rollout_persistent_fwd(weights, fr, STREAM_HORIZON, 0, seeds,
                                   stamps=stamps)
        torch.cuda.synchronize()
        slopes[f"b{nb}"] = dict(
            p50_ms={str(h): {"k5": t[h][0], "host_loop": t[h][1]}
                    for h in K5_SLOPE_HORIZONS},
            k5_ms_per_step=(t[hi][0] - t[lo][0]) / (hi - lo),
            host_loop_ms_per_step=(t[hi][1] - t[lo][1]) / (hi - lo),
            bound_ms_per_step=rollout_bound_ms(nb, size, size, cin, hidden,
                                               1, 1, 0)[0],
            stamps=stamp_summary(stamps, table))
    req = requests[0]
    fr = head_mod._time_major(weights, req, bf)
    table = rollout_schedule(len(hidden), mc.input_frames + mc.output_frames
                             - 1, mc.input_frames - 1, mc.input_frames)
    stamps = torch.zeros(1 + 2 * table.shape[0], dtype=torch.int64,
                         device=DEVICE)
    for _ in range(2):
        rollout_persistent_fwd(
            weights, fr, mc.input_frames + mc.output_frames - 1,
            mc.input_frames - 1, zero(req.shape[0], hidden, size),
            stamps=stamps)
    torch.cuda.synchronize()
    slopes["request_b4_stamps"] = stamp_summary(stamps, table)
    say(phase="rollout_persistent_slope", **slopes)
    run = k5_call("profile", weights, hidden, frames8[:1], warm[1],
                  STREAM_HORIZON, None)[0]
    profile = profile_request(lambda _: run(K5), None,
                              phase="rollout_persistent_profile")

    # a bf16 model K5 refuses (frames of 8 channels are not folded) keeps
    # the K1/K2 host loop: the static choice, with K1/K2's exact counts
    c8 = load_config("nowcast_128")
    c8.precision.compute_dtype = "bfloat16"
    c8.model.in_channels = 8
    c8.validate()
    why8 = persistent_misfit(tuple(c8.model.hidden_dims), 8,
                             c8.model.kernel_size, bf)
    if why8 is None or "folded" not in why8:
        raise AssertionError(f"K5 took 8-channel frames: {why8}")
    ckpt8 = write_checkpoint(os.path.join(tmp, "k5_refused_8ch.npz"), c8, seed)
    frames_8ch = torch.from_numpy(np.random.default_rng(seed).random(
        (req.shape[0], c8.model.input_frames, 8, size, size),
        dtype=np.float32)).to(DEVICE)
    steps8 = c8.model.input_frames + c8.model.output_frames - 1
    predict8 = load_predictor(c8, ckpt8)
    reset_counts()
    out8 = predict8(frames_8ch)
    host_loop_launches = expect_counts(
        "bf16 8-channel request (K5 refuses)", steps8 * len(hidden),
        c8.model.output_frames)
    c8.model.rollout_impl = "torch"
    ref8 = load_predictor(c8, ckpt8)(frames_8ch)
    # PATH_TOL's 4 ulps at the binade of this model's largest output
    top8 = float(ref8.abs().max())
    atol8 = max(atol, 4 * 2.0 ** (np.floor(np.log2(top8)) - 7))
    err8 = check_close("bf16 8-channel request vs plain", out8, ref8, atol8,
                       rtol)
    rec = dict(calls=recs, slopes=slopes, profile_b1_forecast=profile,
               ptxas=ptxas.get("rollout_persistent", []),
               host_loop_8ch=dict(refusal=why8, launches=host_loop_launches,
                                  max_abs_err=err8, max_abs_output=top8,
                                  tol=[atol8, rtol]))
    say(phase="rollout_persistent_summary", ptxas=rec["ptxas"],
        host_loop_8ch=rec["host_loop_8ch"],
        profile_idle_share=profile["idle_share"])
    return rec


def phase_cell_save_z(gen, shapes, grad_shape):
    """K1 writing z against its plain version (h', c' and z), timed beside
    K1 without z on the same operands (``shapes`` as phase_cell's); then
    ConvLSTMCellFn's gradients against autograd at ``grad_shape``. Returns
    {dtype: [records]}."""
    out = {}
    for dtype, dtype_shapes in shapes.items():
        name = str(dtype).split(".")[-1]
        recs = []
        for (b, hgt, wid, cx, ch, k, role) in dtype_shapes:
            x, h, c, w, bias = cell_inputs(gen, b, hgt, wid, cx, ch, k, dtype)
            z_k = torch.empty((b, hgt, wid, 4 * ch), dtype=dtype, device=DEVICE)
            z_p = torch.empty_like(z_k)
            hk, ck = convlstm_cell_fwd(x, h, c, w, bias, z_out=z_k)
            hp, cp = convlstm_cell_plain(x, h, c, w, bias, z_out=z_p)
            torch.cuda.synchronize()
            what = f"K1+z {name} {(b, cx, ch, k)}"
            err = max(check_close(f"{what} h'", hk, hp, *KERNEL_TOL[name]),
                      check_close(f"{what} c'", ck, cp, *KERNEL_TOL[name]))
            err_z = check_close(f"{what} z", z_k, z_p, *Z_TOL[name])
            rec = dict(shape=[b, hgt, wid, cx, ch, k], max_abs_err=err,
                       max_abs_err_z=err_z, max_abs_z=float(z_p.abs().max()),
                       mix=role == "mix", generator=role == "generator")
            if role is not None:
                packed, rec["pack_ms"] = time_pack(w, name, rec["shape"],
                                                   "cell_save_z")
                h_out, c_out = torch.empty_like(h), torch.empty_like(c)
                launch = {z: cell_launcher(dtype, x, h, c, w, packed, bias,
                                           h_out, c_out, z)
                          for z in (None, z_k)}
                # in turns within one call: without z, with z, with, without
                times = {"ms_no_z": [], "ms": []}
                for key, z in (("ms_no_z", None), ("ms", z_k), ("ms", z_k),
                               ("ms_no_z", None)):
                    times[key].append(time_ms(launch[z], 20))
                rec.update({key: statistics.mean(v) for key, v in times.items()})
                rec["plain_ms"] = time_ms(
                    lambda: convlstm_cell_plain(x, h, c, w, bias, z_out=z_p), 5)
                xh = torch.cat([x, h], -1).permute(0, 3, 1, 2)  # channels_last
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                rec["library_ms"] = time_ms(
                    lambda: F.conv2d(xh, w_oihw, bias, padding=k // 2), 20)
                cell_costs(rec, x, h, w, bias, z_k, name)
            say(phase="cell_save_z", dtype=name, tol=KERNEL_TOL[name],
                tol_z=Z_TOL[name], **rec)
            recs.append(rec)
        out[name] = recs
        out[name + "_grad"] = phase_cell_grad(gen, grad_shape, dtype, name)
    return out


def phase_cell_grad(gen, shape, dtype, name):
    """ConvLSTMCellFn (K1 with z, the hand-written backward) against torch
    autograd through convlstm_step_torch: the five gradients of one
    random-cotangent loss, each as max |diff| / max |reference|."""
    b, hgt, wid, cx, ch, k = shape
    x, h, c, w, bias = cell_inputs(gen, b, hgt, wid, cx, ch, k, dtype)
    operands = (w, bias, x, h, c)
    gh = torch.randn((b, hgt, wid, ch), device=DEVICE, generator=gen)
    gc = torch.randn((b, hgt, wid, ch), device=DEVICE, generator=gen)

    def grads(step):
        leaves = [t.clone().requires_grad_(True) for t in operands]
        hn, cn = step(*leaves)
        ((hn.float() * gh).sum() + (cn.float() * gc).sum()).backward()
        return [t.grad for t in leaves]

    reset_counts()
    got = grads(ConvLSTMCellFn.apply)
    if counted("k1z") != 1:
        raise AssertionError("ConvLSTMCellFn did not launch K1 with z")
    want = grads(lambda w, bias, x, h, c: convlstm_step_torch(
        x, h, c, oihw_from_hwio(w), bias))
    torch.cuda.synchronize()
    errs = {}
    for gname, g, r in zip(("dweight", "dbias", "dx", "dh", "dc"), got, want):
        if g.dtype != r.dtype or not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"cell grad {name} {gname}: {g.dtype} vs "
                                 f"{r.dtype} or non-finite")
        errs[gname] = float((g.float() - r.float()).abs().max()
                            / r.float().abs().max())
    say(phase="cell_grad", dtype=name, shape=[b, hgt, wid, cx, ch, k],
        tol=CELL_GRAD_TOL[name], rel_err=errs)
    for gname, err in errs.items():
        if not err <= CELL_GRAD_TOL[name]:
            raise AssertionError(f"cell grad {name} {gname}: relative error "
                                 f"{err:.3e} > {CELL_GRAD_TOL[name]}")
    return errs


def cell_backward_bytes(b, hgt, wid, cx, ch, dtype):
    """K6's bytes, each operand read or written once: z, c, c', dh', dc', h
    and x read in the operands' type; dz and xh written in float32, dc_prev
    and db in the operands' type."""
    e, px = torch.empty((), dtype=dtype).element_size(), b * hgt * wid
    return px * ((9 * ch + cx) * e + (5 * ch + cx) * 4 + ch * e) + 4 * ch * e


def k6_errors(got, want, dtype):
    """K6's outputs against the plain version's, each against K6_TOL:
    {output: the largest error over its bound} (<= 1 passes)."""
    dz, dc_prev, xh, db = (t.float() for t in got)
    dz_p, dc_prev_p, xh_p, db_p = (t.float() for t in want)

    def ratio(err, bound):
        return float((err / bound.clamp_min(1e-30)).max())

    def f32(a, b):
        return ratio((a - b).abs(), K6_TOL["dz"] * (b.abs() + b.abs().max()))
    errs = {"dz": f32(dz, dz_p), "xh": 0.0 if torch.equal(xh, xh_p) else
            float("inf")}
    if dtype == torch.float32:
        errs["dc_prev"] = f32(dc_prev, dc_prev_p)
    else:
        errs["dc_prev"] = ratio((dc_prev - dc_prev_p).abs(),
                                K6_TOL["dc_prev_bf16"] * dc_prev_p.abs()
                                + K6_TOL["dz"] * dc_prev_p.abs().max())
    db_bound = K6_TOL["db"] * dz_p.abs().sum(dim=(0, 1, 2))
    if dtype == torch.bfloat16:
        db_bound = db_bound + K6_TOL["dc_prev_bf16"] * db_p.abs()
    errs["db"] = ratio((db - db_p).abs(), db_bound)
    return errs


def phase_cell_backward(gen, shapes):
    """K6 against cell_backward_plain at each shape (b, hgt, wid, cx, ch,
    dtype, timed); the timed shapes also in turns (K6, plain, plain, K6;
    device time by queued_ms) beside K6's bound, with the host's time a call (Python and launch, not
    waiting for the device) of the launch ConvLSTMCellFn's backward makes,
    of the checked wrapper and of the plain version. Returns the
    records."""
    recs = []
    for b, hgt, wid, cx, ch, dtype, timed in shapes:
        name = str(dtype).split(".")[-1]

        def draw(*shape, scale=1.0):
            return (torch.randn(shape, device=DEVICE, generator=gen)
                    * scale).to(dtype)
        ops = (draw(b, hgt, wid, 4 * ch, scale=2.0), draw(b, hgt, wid, ch),
               draw(b, hgt, wid, ch), draw(b, hgt, wid, ch, scale=1e-2),
               draw(b, hgt, wid, ch, scale=1e-2), draw(b, hgt, wid, cx),
               draw(b, hgt, wid, ch))
        reset_counts()
        got = cell_backward(*ops, dtype)
        again = cell_backward(*ops, dtype)
        expect_counts(f"K6 {name}: 2 calls", 0, 0, k6=2)
        errs = k6_errors(got, cell_backward_plain(*ops, dtype), dtype)
        repeat = all(torch.equal(a, c) for a, c in zip(got, again))
        rec = dict(shape=[b, hgt, wid, cx, ch], dtype=name,
                   err_over_tol=errs, repeat_bit_equal=repeat,
                   max_abs_dz=float(got[0].abs().max()))
        if timed:
            times = {"ms": [], "plain_ms": []}
            for key in ("ms", "plain_ms", "plain_ms", "ms"):
                fn = cell_backward if key == "ms" else cell_backward_plain
                times[key].append(queued_ms(lambda: fn(*ops, dtype), 20))
            rec.update({k: statistics.mean(v) for k, v in times.items()})
            nbytes = cell_backward_bytes(b, hgt, wid, cx, ch, dtype)
            rec["bytes"] = nbytes
            rec["bound_ms"], rec["bound_by"] = bound(0, nbytes, name)
            rec["roofline"] = rec["bound_ms"] / rec["ms"]
            for key, fn in (("host_us", cell_mod._launch_cell_backward),
                            ("wrapper_host_us", cell_backward),
                            ("plain_host_us", cell_backward_plain)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fn(*ops, dtype)
                rec[key] = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
        say(phase="cell_backward", tol=K6_TOL, **rec)
        if not repeat or not all(v <= 1.0 for v in errs.values()):
            raise AssertionError(f"K6 {name} {rec['shape']}: errors over "
                                 f"tolerance {errs}, repeat {repeat}")
        recs.append(rec)
    return recs


def nowcast_params(cfg, seed):
    """The nowcast_128 forecaster as a flax params tree of numpy arrays, with
    torch-default-init ranges (the layout a JAX checkpoint exports)."""
    rng = np.random.default_rng(seed)
    k, cin = cfg.model.kernel_size, cfg.model.in_channels

    def conv(kk, ci, co):
        bnd = 1.0 / np.sqrt(kk * kk * ci)
        return {"kernel": rng.uniform(-bnd, bnd, (kk, kk, ci, co)).astype(np.float32),
                "bias": rng.uniform(-bnd, bnd, co).astype(np.float32)}

    core = {}
    for i, ch in enumerate(cfg.model.hidden_dims):
        core[f"cell_{i}"] = conv(k, cin + ch, 4 * ch)
        cin = ch
    core["head"] = conv(3, cin, cfg.model.in_channels)
    return {"params": {"core": core}}


def request_ms(predict, frames):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = predict(frames)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_main_path(ckpt, dtype_name, requests):
    cfg = load_config("nowcast_128")
    cfg.precision.compute_dtype = dtype_name
    cfg.validate()
    steps = cfg.model.input_frames + cfg.model.output_frames - 1
    n_cells = len(cfg.model.hidden_dims)
    kernel_predict = load_predictor(cfg, ckpt)           # rollout_impl: auto
    cfg_torch = load_config("nowcast_128")
    cfg_torch.precision.compute_dtype = dtype_name
    cfg_torch.model.rollout_impl = "torch"
    torch_predict = load_predictor(cfg_torch, ckpt)

    reset_counts()
    outs, k_ms = zip(*(request_ms(kernel_predict, f) for f in requests))
    launches = expect_rollout(f"main path {dtype_name}", dtype_name, n_cells,
                              steps, cfg.model.output_frames, N_REQUESTS,
                              path=f"predict.{dtype_name}")
    refs, t_ms = zip(*(request_ms(torch_predict, f) for f in requests))
    b, t_in, cin, hgt, wid = requests[0].shape
    cells_fn, head_fn = conv_parts(b, hgt, wid, cin, cfg.model.hidden_dims,
                                   getattr(torch, dtype_name))
    lib = p50_ms({"cells": cells_fn, "head": head_fn})
    heads = cfg.model.output_frames
    atol, rtol = PATH_TOL[dtype_name]
    want = (requests[0].shape[0], cfg.model.output_frames,
            cfg.model.in_channels) + tuple(requests[0].shape[-2:])
    errs = []
    for i, (o, r) in enumerate(zip(outs, refs)):
        if tuple(o.shape) != want or o.dtype != torch.float32:
            raise AssertionError(f"request {i}: got {tuple(o.shape)} {o.dtype}")
        if float(o.std()) == 0.0:
            raise AssertionError(f"request {i}: constant output")
        if float(r.abs().max()) >= MAX_OUTPUT:
            raise AssertionError(f"request {i}: outputs reach "
                                 f"{float(r.abs().max())}, beyond the range "
                                 f"PATH_TOL was set for")
        errs.append(check_close(f"main path {dtype_name} request {i}", o, r,
                                atol, rtol))
    bound_ms, bound_by = rollout_bound_ms(b, hgt, wid, cin,
                                          cfg.model.hidden_dims, steps, heads,
                                          t_in, dtype_name=dtype_name)
    rec = dict(dtype=dtype_name, requests=N_REQUESTS, launches=launches,
               kernel_p50_ms=statistics.median(k_ms), kernel_ms=list(k_ms),
               torch_p50_ms=statistics.median(t_ms), torch_ms=list(t_ms),
               bound_ms=bound_ms, bound_by=bound_by,
               conv2d_sum_ms=steps * lib["cells"][0] + heads * lib["head"][0],
               max_abs_err=max(errs), tol=[atol, rtol],
               max_abs_output=max(float(r.abs().max()) for r in refs))
    say(phase="main_path", **rec)
    return rec, kernel_predict


def profile_request(predict, frames, phase="profile"):
    """torch.profiler over one request: device time by kernel name. One
    traced warm-up request comes first and is discarded: the first launches
    after tracing starts can be missing from the trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    predict(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        predict(frames)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        predict(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # aten:: rows repeat the device time of the kernels they launch, and
        # the ProfilerStep# row that of the whole step
        if dev_us > 0 and not ev.key.startswith(("aten::", "ProfilerStep")):
            rows.append((ev.key, ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    traced = {name: sum(n for k, n, _ in rows if name in k)
              for name in ("convlstm_cell", "conv_head", "rollout_persistent")}
    rec = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=max(0.0, 1 - busy / (wall * 1e3)),
               traced_launches=traced,
               top=[[k[:100], n, round(ms, 4)] for k, n, ms in rows[:8]])
    say(phase=phase, **rec)
    return rec


def st_gates_bytes(kind, px, fw, dtype):
    """K7's bytes of one launch with every operand present, each read or
    written once at its dtype (oxh and its gradient float32): the a_fwd
    pass 16F read and 4F written (mem = c' | m', dc, dm; c' and m' written
    again apart are not counted), a_bwd 14F + 6F gradients read and 16F
    written, b_fwd 2F + oxh read and h' written, b_bwd 3F + oxh read and
    2F + d_oxh written (bench_cuda/flops_predrnn.py keeps the same count)."""
    e = torch.empty((), dtype=dtype).element_size()
    per = {"a_fwd": 20 * e + 4, "b_fwd": 3 * e + 4, "a_bwd": 36 * e + 4,
           "b_bwd": 5 * e + 8}[kind]
    return px * fw * per


def k7_err(got, want):
    """The largest error of K7's output over its bound (K7_TOL; <= 1
    passes)."""
    w = want.float()
    bound = K7_TOL["max"] * w.abs().max()
    if want.dtype == torch.bfloat16:
        bound = bound + K7_TOL["bf16"] * w.abs()
    return float(((got.float() - w).abs() / bound.clamp_min(1e-30)).max())


def phase_st_gates(gen, shapes):
    """K7 against its plain versions (passes A and B, forward and backward,
    with some gradients absent) at each shape (pixels, F, dtype, timed);
    the timed shapes also in turns (K7, plain, plain, K7; device time by
    queued_ms: back to back, so operands that fit the 50 MB L2 stay there,
    which a train step's other work would evict) beside K7's byte bound,
    with the host's time a call of the wrapper. Returns the records."""
    recs = []
    for px, fw, dtype, timed in shapes:
        name = str(dtype).split(".")[-1]

        def draw(width, scale=1.0, dt=dtype):
            return (torch.randn((px, width), device=DEVICE, generator=gen)
                    * scale).to(dt)
        ops = (draw(7 * fw, 2.0), draw(4 * fw, 2.0), draw(3 * fw, 2.0),
               draw(fw), draw(fw))
        grads = (draw(2 * fw), draw(fw), draw(fw), draw(fw), draw(fw),
                 draw(fw, dt=torch.float32))
        oxh, om, last, gh = (draw(fw, 2.0, torch.float32), draw(fw, 2.0),
                             draw(fw, 2.0), draw(fw))
        calls = {
            "a_fwd": (lambda: k7_mod.st_gates_fwd(*ops),
                      lambda: st_gates_plain(*ops)),
            "a_bwd": (lambda: k7_mod.st_gates_bwd(*ops, *grads),
                      lambda: st_gates_bwd_plain(*ops, *grads)),
            "a_bwd_some_absent": (
                lambda: k7_mod.st_gates_bwd(*ops, None, grads[1], None, None,
                                            grads[4], None, need_c=False),
                lambda: st_gates_bwd_plain(*ops, None, grads[1], None, None,
                                           grads[4])),
            "b_fwd": (lambda: (k7_mod.st_hidden_fwd(oxh, om, last),),
                      lambda: (st_hidden_plain(oxh, om, last),)),
            "b_bwd": (lambda: k7_mod.st_hidden_bwd(gh, oxh, om, last),
                      lambda: st_hidden_bwd_plain(gh, oxh, om, last))}
        reset_counts()
        errs = {}
        for key, (k7_fn, plain_fn) in calls.items():
            got, want = k7_fn(), plain_fn()
            errs[key] = max(k7_err(g, w) for g, w in zip(got, want)
                            if g is not None)
        expect_counts(f"K7 {name}: {len(calls)} calls", 0, 0, k7=len(calls))
        rec = dict(pixels=px, hidden=fw, dtype=name, err_over_tol=errs)
        if timed:
            for kind in ("a_fwd", "a_bwd", "b_fwd", "b_bwd"):
                k7_fn, plain_fn = calls[kind]
                times = {"ms": [], "plain_ms": []}
                for key in ("ms", "plain_ms", "plain_ms", "ms"):
                    times[key].append(queued_ms(
                        k7_fn if key == "ms" else plain_fn, 20))
                nbytes = st_gates_bytes(kind, px, fw, dtype)
                bound_ms, by = bound(0, nbytes, name)
                ms = statistics.mean(times["ms"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    k7_fn()
                host_us = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
                rec[kind] = dict(ms=ms, plain_ms=statistics.mean(
                    times["plain_ms"]), bytes=nbytes, bound_ms=bound_ms,
                    bound_by=by, roofline=bound_ms / ms,
                    wrapper_host_us=host_us)
        say(phase="st_gates", tol=K7_TOL, **rec)
        if not all(v <= 1.0 for v in errs.values()):
            raise AssertionError(f"K7 {name} {px}x{fw}: errors over "
                                 f"tolerance {errs}")
        recs.append(rec)
    return recs


def predrnn_config():
    from pl_convlstm_gan_tpu_torch.config import Config
    return Config.from_dict({
        "model": dict(PREDRNN_MODEL),
        "training": {"batch_size": PREDRNN_B, "learning_rate": 1e-4},
        "precision": {"compute_dtype": "bfloat16"}})


class k7_plain_on_card:
    """Within: K7's wrappers run their plain versions on the card's
    tensors (the path K7 replaces), with no launch counted."""

    def __enter__(self):
        def a_fwd(x_cat, h_cat, m_cat, c, m, deltas=True):
            out = st_gates_plain(x_cat, h_cat, m_cat, c, m)
            return out if deltas else out[:3] + (None, None, out[5])

        def a_bwd(*args, need_c=True, need_m=True):
            out = st_gates_bwd_plain(*args)
            return out[:3] + (out[3] if need_c else None,
                              out[4] if need_m else None)
        self.saved = (k7_mod.st_gates_fwd, k7_mod.st_gates_bwd,
                      k7_mod.st_hidden_fwd, k7_mod.st_hidden_bwd)
        (k7_mod.st_gates_fwd, k7_mod.st_gates_bwd, k7_mod.st_hidden_fwd,
         k7_mod.st_hidden_bwd) = (a_fwd, a_bwd, st_hidden_plain,
                                  st_hidden_bwd_plain)
        return self

    def __exit__(self, *exc):
        (k7_mod.st_gates_fwd, k7_mod.st_gates_bwd, k7_mod.st_hidden_fwd,
         k7_mod.st_hidden_bwd) = self.saved
        return False


def phase_predrnn(tmp, seed):
    """PredRNN-V2 at its KTH widths (B 8, 128^2 patched to 32^2 x 16, 4 x
    128, 5x5, 10 -> 20 frames, bf16, masks at p 0.5): a train step's
    gradients and loss on K7 against the same step with K7's plain versions
    on the card, from one state; train steps timed (4 x 76 K7 launches a
    step, no K1/K2/K5/K6; the third on replay the CUDA graphs the second
    captured); a request of 10 frames through load_predictor
    (2 x 76 K7 launches) against the plain versions' request; a profile of
    one step. Returns the record."""
    cfg = predrnn_config()
    torch.manual_seed(seed)
    model = build_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt = os.path.join(tmp, "predrnn_seed.pt")
    torch.save(sd, ckpt)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    frames = torch.rand(PREDRNN_B, 20, 1, PREDRNN_SIZE, PREDRNN_SIZE,
                        device=DEVICE, generator=g)
    mask = torch.rand(18, PREDRNN_B, device=DEVICE, generator=g) < 0.5
    batch = (frames[:, :10], frames[:, 10:])
    per_step = 4 * len(PREDRNN_MODEL["hidden_dims"]) * 19

    def grads_of(plain):
        m = build_model(cfg)
        m.load_state_dict(sd)
        m.to(DEVICE).train()
        reset_counts()
        with (k7_plain_on_card() if plain else contextlib.nullcontext()):
            loss, _ = forecaster_loss(m, *batch, mask)
            loss.backward()
        expect_counts(f"predrnn {'plain' if plain else 'K7'} gradients",
                      0, 0, k7=0 if plain else per_step)
        return float(loss.detach()), torch.cat([p.grad.flatten().float()
                                       for p in m.parameters()])
    (loss_k, g_k), (loss_p, g_p) = grads_of(False), grads_of(True)
    errs = {"loss": abs(loss_k - loss_p) / abs(loss_p),
            "grad": float((g_k - g_p).norm() / g_p.norm())}
    del g_k, g_p

    model.load_state_dict(sd)
    model.to(DEVICE).train()
    state = TrainState(model, make_optimizer(model))
    times = []
    for i in range(6):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = forecaster_train_step(state, batch, 1e-4, teacher_draws=mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        expect_counts(f"predrnn train step {i}", 0, 0, k7=per_step)
        if m["skipped"] or not np.isfinite(m["total"]):
            raise AssertionError(f"predrnn train step {i}: {m}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = profile_train_step(lambda: forecaster_train_step(
        state, batch, 1e-4, teacher_draws=mask), phase="predrnn_profile")
    del state, model
    torch.cuda.empty_cache()

    predict = load_predictor(cfg, ckpt)
    reset_counts()
    out = predict(frames[:, :10])
    expect_counts("predrnn request", 0, 0, k7=per_step // 2)
    with k7_plain_on_card():
        want = predict(frames[:, :10])
    errs["request"] = float((out - want).norm() / want.norm())
    request_ms = p50_ms({"k7": lambda: predict(frames[:, :10])})["k7"][0]
    rec = dict(widths=PREDRNN_MODEL, batch=PREDRNN_B, errors=errs,
               tol=PREDRNN_TOL, losses=(loss_k, loss_p),
               k7_per_step=per_step, k7_per_request=per_step // 2,
               step_ms=times, step_p50_ms=statistics.median(times[2:]),
               request_p50_ms=request_ms, peak_gib=peak,
               out_shape=list(out.shape))
    say(phase="predrnn", **rec)
    for key, err in errs.items():
        if not err <= PREDRNN_TOL[key]:
            raise AssertionError(f"predrnn: {key} error {err:.3e} > "
                                 f"{PREDRNN_TOL[key]}")
    rec["profile"] = profile
    return rec


# the launch counters of the program's registry (utils.profiling.counters(),
# declared by the kernel wrappers), by the keyword expect_counts takes
LAUNCH_KEYS = {"k1": "convlstm_cell_fwd.launches",
               "k1z": "convlstm_cell_fwd.launches_z",
               "k2": "conv_head_fwd.launches", "k3": "tap_loop.launches",
               "k4": "tap_k1152.launches",
               "k5": "rollout_persistent_fwd.launches",
               "k6": "cell_backward.launches", "k7": "st_gates.launches",
               "wg": "cell_wgrad.calls"}
_since = {}


def reset_counts():
    """Snapshot the program's counters: ``counted`` reads from here."""
    _since.clear()
    _since.update(counters())


def counted(key):
    """What the counter ``key`` (a key of ``counters()`` or of LAUNCH_KEYS)
    rose by since the last reset_counts()."""
    key = LAUNCH_KEYS.get(key, key)
    return counters()[key] - _since.get(key, 0)


# K6 launches as expect_counts read them, by the path its ``path`` names
# ("<path>.<compute dtype>"): the kernels line's K6 entries
K6_BY_PATH = {}


def expect_counts(what, k1, k2, k1z=0, k5=0, k6=0, path=None, k7=0, k3=0,
                  k4=0, wg=0):
    """Raise unless each kernel launched as often as its keyword of
    LAUNCH_KEYS says since the last reset_counts() (K1 without z, K2, K1
    with z, K5, K6, K7 and K3/K4, and the cells' weight-gradient
    convolutions ``wg``: one a kernel cell and training pass over all its
    steps, one a step under remat; every one not named 0: K7, the ST-LSTM gate passes, on every
    ConvLSTM path); returns the counts of K1, K2, K5, K6 and K7 by
    wrapper. With ``path`` the K6 count read is kept in K6_BY_PATH[path]."""
    want = dict(k1=k1, k1z=k1z, k2=k2, k3=k3, k4=k4, k5=k5, k6=k6, k7=k7,
                wg=wg)
    got = {kw: counted(kw) for kw in LAUNCH_KEYS}
    if got != want:
        raise AssertionError(f"{what}: launches {got}; expected {want}")
    if path is not None:
        K6_BY_PATH[path] = got["k6"]
    return {LAUNCH_KEYS[kw].split(".")[0]: got[kw]
            for kw in ("k1", "k2", "k5", "k6", "k7")}


def graph_counts():
    """(captures, replays, eager calls) of the training losses' CUDA graphs
    so far (``models/loss_graphs.py``)."""
    got = counters()
    return tuple(got[f"loss_graphs.{k}"] for k in ("captures", "replays",
                                                   "eager"))


def graph_delta(before):
    return tuple(a - b for a, b in zip(graph_counts(), before))


def expect_graphs(what, got, steps):
    """Raise unless ``got`` (graph_delta a step, from the step after the
    warm-up call on) reads one capture and a replay, then replays, and no
    eager call."""
    want = [(1, 1, 0)] + [(0, 1, 0)] * (steps - 1)
    if list(got) != want:
        raise AssertionError(f"{what}: loss graphs (captures, replays, "
                             f"eager) a step {list(got)}, expected {want}")


def rollout_launches(dtype_name, n_cells, steps, heads, calls=1):
    """(K1, K2, K5) launches of ``calls`` rollouts (or observes) of
    ``steps`` steps with ``heads`` head steps each on the kernel path of
    nowcast_128-like models: bfloat16 one K5 launch a call; float32 K1 for
    every cell and step and K2 for every head step."""
    if dtype_name == "bfloat16":
        return 0, 0, calls
    return n_cells * steps * calls, heads * calls, 0


def expect_rollout(what, dtype_name, n_cells, steps, heads, calls=1,
                   path=None):
    """expect_counts of ``rollout_launches`` (no K6)."""
    k1, k2, k5 = rollout_launches(dtype_name, n_cells, steps, heads, calls)
    return expect_counts(what, k1, k2, k5=k5, path=path)


def p50_ms(fns, n=N_TIMED):
    """{name: (p50 ms, [ms...])} of each fn over n calls taken in turns,
    after one warm-up call each. A call's time runs from an event recorded
    before it to one after its last launch, so it holds the host's launch
    cost wherever the device waits for it."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(n):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: (statistics.median(ts), ts) for name, ts in times.items()}


def steps_bound_ms(b, hgt, wid, cin, hidden, dtype_name, steps, k=3):
    """bound() summed over `steps` steps of K1 per cell and K2 for the head,
    counted as phase_cell and phase_head count one launch."""
    elem = 2 if dtype_name == "bfloat16" else 4
    px = b * hgt * wid
    per_step, cx = 0.0, cin
    for ch in hidden:
        flops = 2 * px * k * k * (cx + ch) * 4 * ch
        nbytes = elem * (px * cx + 4 * px * ch + k * k * (cx + ch) * 4 * ch
                         + 4 * ch)
        per_step += bound(flops, nbytes, dtype_name)[0]
        cx = ch
    flops = 2 * px * 9 * cx * cin
    nbytes = elem * (px * cx + 9 * cx * cin + cin + px * cin)
    per_step += bound(flops, nbytes, dtype_name)[0]
    return steps * per_step


def conv_step_fn(b, hgt, wid, cin, hidden, dtype, k=3):
    """One step's convs as library calls (``conv_parts``: one F.conv2d per
    cell over concat(x, h) and one for the head, channels-last, without the
    gates): the yardstick beside a rollout, which no one PyTorch call
    computes."""
    cells, head = conv_parts(b, hgt, wid, cin, hidden, dtype, k)
    return lambda: (cells(), head())


def states_equal(a, b):
    return (len(a.cells) == len(b.cells) and torch.equal(a.prev_out, b.prev_out)
            and all(torch.equal(x, y) for pa, pb in zip(a.cells, b.cells)
                    for x, y in zip(pa, pb)))


def clone_state(state):
    return type(state)(tuple((h.clone(), c.clone()) for h, c in state.cells),
                       state.prev_out.clone())


def stream_pair(name, dtype_name, ckpt):
    """(the config with rollout_impl auto, the streaming forecaster on the
    kernels, the one on the plain modules: rollout_impl torch)."""
    cfgs = []
    for impl in ("auto", "torch"):
        cfg = load_config(name)
        cfg.precision.compute_dtype = dtype_name
        cfg.model.rollout_impl = impl
        cfg.validate()
        cfgs.append(cfg)
    return (cfgs[0], StreamingForecaster.from_checkpoint(cfgs[0], ckpt),
            StreamingForecaster.from_checkpoint(cfgs[1], ckpt))


def check_forecast_vs_plain(what, sf, sf_plain, state, horizon, dtype_name):
    """forecast(horizon) on the kernels against the plain modules from the
    same carried state; checks the launch counts; returns the max error."""
    n_cells = len(state.cells)
    reset_counts()
    out = sf.forecast(state, horizon)
    expect_rollout(f"{what} forecast({horizon})", dtype_name, n_cells,
                   horizon, horizon)
    ref = sf_plain.forecast(state, horizon)
    b, hgt, wid, chans = state.prev_out.shape
    want = (b, horizon, chans, hgt, wid)
    if tuple(out.shape) != want or out.dtype != torch.float32:
        raise AssertionError(f"{what}: got {tuple(out.shape)} {out.dtype}")
    if float(out.std()) == 0.0:
        raise AssertionError(f"{what}: constant output")
    if float(ref.abs().max()) >= MAX_OUTPUT:
        raise AssertionError(f"{what}: outputs reach {float(ref.abs().max())}"
                             f", beyond the range PATH_TOL was set for")
    return check_close(what, out, ref, *PATH_TOL[dtype_name])


def phase_stream(ckpt, dtype_name, request, frames8):
    """The streaming path on nowcast_128 (see the module docstring, 5).
    Returns its record; the launch counts of the stream path's own run (the
    first request observed and forecast to the batch horizon) under
    "launches"."""
    cfg, sf, sf_plain = stream_pair("nowcast_128", dtype_name, ckpt)
    n_cells = len(cfg.model.hidden_dims)
    t_in, t_out = cfg.model.input_frames, cfg.model.output_frames
    b, _, cin, hgt, wid = request.shape
    batch = load_predictor(cfg, ckpt)(request)
    atol, rtol = PATH_TOL[dtype_name]

    reset_counts()
    state, nowcast = sf.observe_window(sf.init_state(b, hgt, wid), request)
    expect_rollout("observe_window", dtype_name, n_cells, t_in, t_in)
    rest = sf.forecast(state, t_out - 1)
    k1, k2, k5 = rollout_launches(dtype_name, n_cells, t_in + t_out - 1,
                                  t_in + t_out - 1)
    launches = expect_counts("observe_window + forecast", k1, k2,
                             k5=2 * k5, path=f"stream.{dtype_name}")
    rollout = torch.cat([nowcast[:, None], rest], 1)
    err_batch = check_close(f"stream {dtype_name} vs batch", rollout, batch,
                            atol, rtol)

    frame_state = sf.init_state(b, hgt, wid)
    for t in range(t_in):
        reset_counts()
        frame_state, frame_now = sf.observe(frame_state, request[:, t])
        expect_rollout(f"observe frame {t}", dtype_name, n_cells, 1, 1)
    if not (torch.equal(frame_now, nowcast)
            and states_equal(frame_state, state)):
        raise AssertionError(f"stream {dtype_name}: frame-by-frame observe "
                             f"differs from observe_window")

    before = clone_state(state)
    reset_counts()
    again = sf.forecast(state, t_out - 1)
    expect_rollout(f"forecast({t_out - 1})", dtype_name, n_cells, t_out - 1,
                   t_out - 1)
    if not torch.equal(again, rest):
        raise AssertionError(f"stream {dtype_name}: two forecasts from one "
                             f"state differ")
    if not states_equal(state, before):
        raise AssertionError(f"stream {dtype_name}: forecast wrote its state")

    per_batch = []
    horizon = STREAM_HORIZON
    for nb in STREAM_BATCHES:
        warm, _ = sf.observe_window(sf.init_state(nb, hgt, wid), frames8[:nb])
        err = check_forecast_vs_plain(f"stream {dtype_name} B {nb}", sf,
                                      sf_plain, warm, horizon, dtype_name)
        frame = frames8[:nb, -1]
        times = p50_ms({
            "observe": lambda: sf.observe(warm, frame),
            "observe_plain": lambda: sf_plain.observe(warm, frame),
            "forecast": lambda: sf.forecast(warm, horizon),
            "forecast_plain": lambda: sf_plain.forecast(warm, horizon),
            "conv_step": conv_step_fn(nb, hgt, wid, cin, cfg.model.hidden_dims,
                                      warm.prev_out.dtype)})
        per_batch.append(dict(
            batch=nb, horizon=horizon, max_abs_err=err,
            forecast_ms=times["forecast"][0],
            forecast_plain_ms=times["forecast_plain"][0],
            forecast_bound_ms=steps_bound_ms(nb, hgt, wid, cin,
                                             cfg.model.hidden_dims,
                                             dtype_name, horizon),
            forecast_launches=list(rollout_launches(
                dtype_name, n_cells, horizon, horizon)),
            forecast_library_ms=horizon * times["conv_step"][0],
            observe_ms=times["observe"][0],
            observe_plain_ms=times["observe_plain"][0],
            observe_bound_ms=steps_bound_ms(nb, hgt, wid, cin,
                                            cfg.model.hidden_dims,
                                            dtype_name, 1),
            forecast_ms_all=times["forecast"][1],
            forecast_plain_ms_all=times["forecast_plain"][1]))
        if nb == 1:
            warm_b1 = warm
    rec = dict(dtype=dtype_name, launches=launches,
               max_abs_err_vs_batch=err_batch,
               bit_identical_to_batch=bool(torch.equal(rollout, batch)),
               frame_by_frame_equal=True, forecast_pure=True,
               tol=[atol, rtol], per_batch=per_batch)
    say(phase="stream", **rec)
    return rec, sf, warm_b1


# ------------------------------------------------------------------ export
# The serving artifacts (serve.py) at nowcast_128's full width, weights from
# the seed through weights.py: the kernel path's programs hold the
# plcg_torch ops, which launch K1/K2 (float32) or K5 (bfloat16) as the
# eager kernel path does.
EXPORT_HORIZONS = (10, 30)
EXPORT_TIMEOUT = 600    # seconds the serving child may take


def graph_ops(blob):
    """The call targets of an exported program's graph."""
    import io
    program = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function"}


def export_worker(work, dtype_name):
    """``chip_smoke.py --export-worker <work> <dtype>``: a process that has
    only the artifact <work>/model_<dtype>.pt2 (the checkpoint is deleted)
    serves the requests of <work>/requests.npy through serve.load_exported
    and saves the outputs and the K1 / K2 / K1-with-z / K5 / K6 counts of the
    requests to <work>/served_<dtype>.pt."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(work, f"model_{dtype_name}.pt2"), "rb") as f:
        serve = load_exported(f.read())
    requests = torch.from_numpy(np.load(os.path.join(work, "requests.npy")))
    requests = requests.to(DEVICE)
    reset_counts()
    outs = [serve(r) for r in requests]
    torch.cuda.synchronize()
    torch.save({"outs": [o.cpu() for o in outs],
                "counts": tuple(counted(kw) for kw in ("k1", "k2", "k1z",
                                                       "k5", "k6"))},
               os.path.join(work, f"served_{dtype_name}.pt"))
    return 0


def export_batch(tmp, dtype_name, requests, seed):
    """export_model on the card (the kernel path: one plcg_torch.rollout
    node), then a child process with the checkpoint deleted serves the
    requests from the artifact alone: equal to the eager kernel predictor
    (torch.equal), within PATH_TOL of the plain path, 72 K1 + 20 K2 a
    request in float32 and one K5 in bfloat16. A plain artifact exported on
    the CPU serves on the card within PATH_TOL; a kernel artifact exported
    on the CPU (K1's weights packed there) serves on the card equal to the
    eager kernel path with the same launches. Artifacts and eager requests
    timed in turns."""
    cfg = load_config("nowcast_128")
    cfg.precision.compute_dtype = dtype_name
    cfg.validate()
    cfg_torch = load_config("nowcast_128")
    cfg_torch.precision.compute_dtype = dtype_name
    cfg_torch.model.rollout_impl = "torch"
    steps = cfg.model.input_frames + cfg.model.output_frames - 1
    k1, k2, k5 = rollout_launches(dtype_name, len(cfg.model.hidden_dims),
                                  steps, cfg.model.output_frames)
    work = tempfile.mkdtemp(dir=tmp)
    ckpt = write_checkpoint(os.path.join(work, "weights.npz"), cfg, seed)
    t0 = time.perf_counter()
    blob = export_model(cfg, ckpt, (requests[0][:1],))
    export_s = time.perf_counter() - t0
    if "plcg_torch.rollout.default" not in graph_ops(blob):
        raise AssertionError(f"export {dtype_name}: the artifact holds no "
                             f"plcg_torch.rollout node")
    plain_blob = export_model(cfg_torch, ckpt, (requests[0][:1].cpu(),),
                              device="cpu")
    cfg_kernel = load_config("nowcast_128")
    cfg_kernel.precision.compute_dtype = dtype_name
    cfg_kernel.model.rollout_impl = "kernel"
    cpu_blob = export_model(cfg_kernel, ckpt, (requests[0][:1].cpu(),),
                            device="cpu")
    if "plcg_torch.rollout.default" not in graph_ops(cpu_blob):
        raise AssertionError(f"export {dtype_name}: the kernel artifact "
                             f"exported on the CPU holds no "
                             f"plcg_torch.rollout node")
    eager = load_predictor(cfg, ckpt)
    eager_plain = load_predictor(cfg_torch, ckpt)
    outs = [eager(r) for r in requests]
    refs = [eager_plain(r) for r in requests]
    os.remove(ckpt)
    with open(os.path.join(work, f"model_{dtype_name}.pt2"), "wb") as f:
        f.write(blob)
    np.save(os.path.join(work, "requests.npy"),
            torch.stack(requests).cpu().numpy())
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--export-worker", work, dtype_name],
                         capture_output=True, text=True,
                         timeout=EXPORT_TIMEOUT)
    if res.returncode != 0:
        raise AssertionError(f"export {dtype_name}: the serving child exit "
                             f"{res.returncode}:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    served = torch.load(os.path.join(work, f"served_{dtype_name}.pt"),
                        weights_only=False)
    n = len(requests)
    if served["counts"] != (n * k1, n * k2, 0, n * k5, 0):
        raise AssertionError(f"export {dtype_name}: the child launched "
                             f"(K1, K2, K1 with z, K5, K6) {served['counts']}, "
                             f"expected {(n * k1, n * k2, 0, n * k5, 0)}")
    K6_BY_PATH[f"export_served_in_a_child.{dtype_name}"] = served["counts"][4]
    atol, rtol = PATH_TOL[dtype_name]
    errs = []
    for i, (got, want, ref) in enumerate(zip(served["outs"], outs, refs)):
        if not torch.equal(got, want.cpu()):
            raise AssertionError(f"export {dtype_name} request {i}: the "
                                 f"artifact differs from the eager kernel "
                                 f"path")
        errs.append(check_close(f"export {dtype_name} request {i} vs plain",
                                got.to(DEVICE), ref, atol, rtol))
    serve_plain = load_exported(plain_blob, device=DEVICE)
    reset_counts()
    plain_outs = [serve_plain(r) for r in requests]
    expect_counts(f"export {dtype_name} plain artifact", 0, 0)
    plain_errs = [check_close(f"export {dtype_name} plain artifact {i}", o,
                              r, atol, rtol)
                  for i, (o, r) in enumerate(zip(plain_outs, refs))]
    serve_cpu = load_exported(cpu_blob, device=DEVICE)
    for i, (r, want) in enumerate(zip(requests, outs)):
        reset_counts()
        got = serve_cpu(r)
        expect_counts(f"export {dtype_name} CPU-exported kernel artifact "
                      f"request {i}", k1, k2, k5=k5)
        if not torch.equal(got, want):
            raise AssertionError(f"export {dtype_name} request {i}: the "
                                 f"kernel artifact exported on the CPU "
                                 f"differs from the eager kernel path")
    serve = load_exported(blob)
    reset_counts()
    out = serve(requests[0])
    launches = expect_counts(f"export {dtype_name} request", k1, k2, k5=k5,
                             path=f"export_predict.{dtype_name}")
    if not torch.equal(out, outs[0]):
        raise AssertionError(f"export {dtype_name}: the artifact in this "
                             f"process differs from the eager kernel path")
    req = requests[0]
    times = p50_ms({"artifact": lambda: serve(req),
                    "artifact_from_cpu": lambda: serve_cpu(req),
                    "eager": lambda: eager(req)})
    rec = dict(dtype=dtype_name, export_s=export_s, artifact_bytes=len(blob),
               child_launches=served["counts"], launches=launches,
               equal_to_eager_kernel_path=True, max_abs_err_vs_plain=max(errs),
               plain_artifact_from_cpu_max_abs_err=max(plain_errs),
               plain_artifact_bit_equal=all(torch.equal(o, r) for o, r in
                                            zip(plain_outs, refs)),
               kernel_artifact_from_cpu_equal_to_eager_kernel_path=True,
               tol=[atol, rtol],
               artifact_p50_ms=times["artifact"][0],
               artifact_from_cpu_p50_ms=times["artifact_from_cpu"][0],
               eager_kernel_p50_ms=times["eager"][0],
               artifact_ms=times["artifact"][1], eager_ms=times["eager"][1])
    say(phase="export_predict", **rec)
    return rec


def export_stream(tmp, dtype_name, request, frames8, seed):
    """export_streaming on the card (kernel entries, horizons
    EXPORT_HORIZONS) served by load_streaming_exported: the first request's
    frames observed one at a time, then forecast(h) for each exported h;
    then forecast(30) at B 1 and B 8 from states observed the same way.
    Each equal to StreamingForecaster's kernel path, 3 K1 + 1 K2 an
    observed frame, 3h K1 + h K2 a forecast(h) in float32, one K5 a call in
    bfloat16; observe and forecast(30) timed in turns with the eager
    path."""
    cfg = load_config("nowcast_128")
    cfg.precision.compute_dtype = dtype_name
    ckpt = write_checkpoint(os.path.join(tempfile.mkdtemp(dir=tmp),
                                         "weights.npz"), cfg, seed)
    cfg, sf, _ = stream_pair("nowcast_128", dtype_name, ckpt)
    n_cells, t_in = len(cfg.model.hidden_dims), cfg.model.input_frames
    _, _, _, hgt, wid = request.shape
    t0 = time.perf_counter()
    blob = export_streaming(cfg, ckpt, hgt, wid, horizons=EXPORT_HORIZONS)
    export_s = time.perf_counter() - t0
    meta = parse_stream_header(blob)[0]
    if meta["rollout"] != "kernel" or \
            meta["kernel_horizons"] != list(EXPORT_HORIZONS):
        raise AssertionError(f"export stream {dtype_name}: header {meta}")
    os.remove(ckpt)
    server = load_streaming_exported(blob)

    def observe_both(frames):
        """-> (artifact state, eager state, the artifact's K1/K2/K5
        counts summed over the observed frames)"""
        state = server.init_state(frames.shape[0])
        eager = sf.init_state(frames.shape[0], hgt, wid)
        seen = Counter()
        for t in range(t_in):
            reset_counts()
            state, now = server.observe(state, frames[:, t])
            seen.update(expect_rollout(
                f"export stream {dtype_name} observe", dtype_name, n_cells,
                1, 1))
            eager, eager_now = sf.observe(eager, frames[:, t])
            if not (torch.equal(now, eager_now) and states_equal(
                    StreamState(*state), eager)):
                raise AssertionError(f"export stream {dtype_name}: observe "
                                     f"differs from the eager kernel path")
        return state, eager, seen

    def forecast_both(state, eager, h, what):
        """-> the artifact's K1/K2/K5 counts of forecast(h)"""
        reset_counts()
        out = server.forecast(state, h)
        seen = expect_rollout(f"export stream {dtype_name} {what} "
                              f"forecast({h})", dtype_name, n_cells, h, h,
                              path=f"export_stream.{dtype_name}")
        if not torch.equal(out, sf.forecast(eager, h)):
            raise AssertionError(f"export stream {dtype_name} {what}: "
                                 f"forecast({h}) differs from the eager "
                                 f"kernel path")
        return seen

    h = STREAM_HORIZON
    state, eager, launches = observe_both(request)
    for hz in EXPORT_HORIZONS:
        seen = forecast_both(state, eager, hz, "request")
        if hz == h:
            launches.update(seen)
    launches = dict(launches)
    per_batch = []
    for nb in STREAM_BATCHES:
        state, eager, _ = observe_both(frames8[:nb])
        forecast_both(state, eager, h, f"B {nb}")
        frame = frames8[:nb, -1]
        times = p50_ms({
            "artifact_forecast": lambda: server.forecast(state, h),
            "eager_forecast": lambda: sf.forecast(eager, h),
            "artifact_observe": lambda: server.observe(state, frame),
            "eager_observe": lambda: sf.observe(eager, frame)})
        per_batch.append(dict(
            batch=nb, horizon=h,
            artifact_forecast_p50_ms=times["artifact_forecast"][0],
            eager_forecast_p50_ms=times["eager_forecast"][0],
            artifact_observe_p50_ms=times["artifact_observe"][0],
            eager_observe_p50_ms=times["eager_observe"][0],
            artifact_forecast_ms=times["artifact_forecast"][1],
            eager_forecast_ms=times["eager_forecast"][1]))
    rec = dict(dtype=dtype_name, export_s=export_s, artifact_bytes=len(blob),
               horizons=list(EXPORT_HORIZONS), launches=launches,
               launches_counted_as=f"the first request's {t_in} frames "
               f"observed one at a time, then forecast({h})",
               equal_to_eager_kernel_path=True, per_batch=per_batch)
    say(phase="export_stream", **rec)
    return rec


def export_generator(tmp, dtype_name, seed):
    """configs/default.yaml's Generator (B 8, 16^2 -> 128^2) exported with
    convlstm_impl pallas on its plain cells (serve.py's decision: its K1 is
    not a registered op) and served on the card within PATH_TOL of its
    eager plain path, with no K1 launch; timed in turns."""
    ds = SyntheticDownscalingDataset(**GEN_DATA)
    lu_c = ds.num_lu_classes
    cfg = generator_config(dtype_name, "pallas")
    plain = generator_config(dtype_name, "auto")
    mc = cfg.model
    ckpt = write_generator_checkpoint(os.path.join(
        tempfile.mkdtemp(dir=tmp), "generator.npz"), cfg, lu_c, seed)
    batch = to_device(next(batch_iterator(ds, cfg.training.batch_size)),
                      torch.device(DEVICE))[:3]
    blob = export_model(cfg, ckpt, tuple(x[:1] for x in batch),
                        lu_channels=lu_c)
    eager = load_predictor(plain, ckpt)
    os.remove(ckpt)
    serve = load_exported(blob)
    reset_counts()
    out = serve(*batch)
    expect_counts(f"export generator {dtype_name}", 0, 0,
                  path=f"export_generator.{dtype_name}")
    ref = eager(*batch)
    hgt, wid = batch[0].shape[-2:]
    want = (batch[0].shape[0], mc.T, 1, hgt * mc.scale_factor,
            wid * mc.scale_factor)
    err = check_generator_output(f"export generator {dtype_name}", out, ref,
                                 want, dtype_name)
    times = p50_ms({"artifact": lambda: serve(*batch),
                    "eager_plain": lambda: eager(*batch)})
    rec = dict(dtype=dtype_name, max_abs_err_vs_eager_plain=err,
               bit_equal=bool(torch.equal(out, ref)),
               tol=PATH_TOL[dtype_name], artifact_bytes=len(blob),
               artifact_p50_ms=times["artifact"][0],
               eager_plain_p50_ms=times["eager_plain"][0])
    say(phase="export_generator", **rec)
    return rec


def phase_export(tmp, requests, frames8, seed):
    """The export phase (see the module docstring, 6): batch, streaming
    and Generator artifacts in both dtypes."""
    rec = {}
    for dtype_name in ("float32", "bfloat16"):
        rec[dtype_name] = dict(
            predict=export_batch(tmp, dtype_name, requests, seed),
            stream=export_stream(tmp, dtype_name, requests[0], frames8, seed),
            generator=export_generator(tmp, dtype_name, seed))
    return rec


def phase_precip_256(tmp, seed):
    """precip_256 through the same streaming code: bf16, B 1, 256x256."""
    dtype_name = "bfloat16"
    cfg = load_config("precip_256")
    ckpt = write_checkpoint(os.path.join(tmp, "precip_256_seed.npz"), cfg,
                            seed)
    cfg, sf, sf_plain = stream_pair("precip_256", dtype_name, ckpt)
    n_cells = len(cfg.model.hidden_dims)
    size, t_in = cfg.data.synthetic_image_size, cfg.model.input_frames
    frames = torch.from_numpy(np.random.default_rng(seed).random(
        (1, t_in, cfg.model.in_channels, size, size),
        dtype=np.float32)).cuda()
    reset_counts()
    warm, _ = sf.observe_window(sf.init_state(1, size, size), frames)
    launches = expect_rollout("precip_256 observe_window", dtype_name,
                              n_cells, t_in, t_in,
                              path=f"precip_256_observe_window.{dtype_name}")
    err = check_forecast_vs_plain("precip_256 B 1", sf, sf_plain, warm,
                                  STREAM_HORIZON, dtype_name)
    times = p50_ms({"forecast": lambda: sf.forecast(warm, STREAM_HORIZON),
                    "forecast_plain": lambda: sf_plain.forecast(
                        warm, STREAM_HORIZON)})
    say(phase="precip_256", dtype=dtype_name, batch=1, size=size,
        hidden=list(cfg.model.hidden_dims), horizon=STREAM_HORIZON,
        max_abs_err=err, tol=list(PATH_TOL[dtype_name]),
        forecast_ms=times["forecast"][0],
        forecast_plain_ms=times["forecast_plain"][0],
        forecast_bound_ms=steps_bound_ms(1, size, size, cfg.model.in_channels,
                                         cfg.model.hidden_dims, dtype_name,
                                         STREAM_HORIZON),
        forecast_ms_all=times["forecast"][1],
        forecast_plain_ms_all=times["forecast_plain"][1], launches=launches)
    return dict(launches=launches)


def train_config(dtype_name, impl="pallas"):
    cfg = load_config("nowcast_128_pallas")
    cfg.precision.compute_dtype = dtype_name
    cfg.model.convlstm_impl = impl
    cfg.validate(training=True)
    return cfg


def train_state(cfg, state_dict, lu_channels=0):
    model = build_model(cfg, lu_channels=lu_channels)
    model.load_state_dict(state_dict)
    model.to(DEVICE).train()
    return TrainState(model, make_optimizer(model), 0)


def flat_grads(model):
    return torch.cat([p.grad.flatten() for p in model.parameters()])


def profile_train_step(step, phase="train_profile"):
    """torch.profiler over one kernel-path train step (``step()``) after a
    traced warm-up step: device time by kernel group and the idle share."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        # the kernels' own rows only: an op's row (aten::, the autograd
        # Function's, the step's, the optimizer step's annotation) repeats
        # the device time of what it launched
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == DeviceType.CUDA and \
                not ev.key.startswith(("ProfilerStep", "Optimizer.")):
            rows.append((ev.key, ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    conv_marks = ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad",
                  "implicit", "cutlass", "sm90", "sm80")

    def group(key):
        if "convlstm_cell" in key:
            return "K1"
        if "st_gates" in key:
            return "K7"
        if any(m in key.lower() for m in conv_marks):
            return "cudnn_conv"
        return "elementwise_reduce_copy"

    groups = {}
    for key, n, ms in rows:
        g = groups.setdefault(group(key), [0, 0.0])
        g[0] += n
        g[1] += ms
    busy = sum(r[2] for r in rows)
    rec = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=max(0.0, 1 - busy / (wall * 1e3)),
               groups={k: [n, round(ms, 3)] for k, (n, ms) in groups.items()},
               top=[[k[:100], n, round(ms, 3)] for k, n, ms in rows[:12]])
    say(phase=phase, **rec)
    return rec


def phase_train(dtype_name, seed):
    """nowcast_128_pallas at full width: the kernel path (K1 with z and the
    custom backward) against the plain path from one state (see the module
    docstring, 9). Returns the record."""
    steps = TRAIN_STEPS[dtype_name]
    cfg = train_config(dtype_name)
    mc = cfg.model
    b, size = cfg.training.batch_size, cfg.data.synthetic_image_size
    n_cells = len(mc.hidden_dims)
    per_step = n_cells * (mc.input_frames + mc.output_frames - 1)
    lr = cfg.training.learning_rate
    state_dict = flax_to_state_dict(nowcast_params(cfg, seed))
    ds = SyntheticSequenceDataset(steps * b, mc.input_frames, mc.output_frames,
                                  size, seed=seed)
    batches = [to_device(x, torch.device(DEVICE))
               for x in batch_iterator(ds, b)]
    paths = {"kernel": train_state(cfg, state_dict),
             "plain": train_state(train_config(dtype_name, "xla"), state_dict)}

    # step-1 gradients, then cleared: each path's first call at the shape,
    # eager (it warms every kernel; the first step then captures the loss's
    # CUDA graphs and later steps replay them)
    grads, eager_ms = {}, {}
    for name, st in paths.items():
        before = graph_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forecaster_loss(st.model, *batches[0])[0].backward()
        torch.cuda.synchronize()
        eager_ms[name] = (time.perf_counter() - t0) * 1e3
        if graph_delta(before) != (0, 0, 1):
            raise AssertionError(f"train {name} {dtype_name}: the first call "
                                 f"was not eager: {graph_delta(before)}")
        grads[name] = flat_grads(st.model)
        st.optimizer.zero_grad(set_to_none=True)
    grad_err = float((grads["kernel"] - grads["plain"]).norm()
                     / grads["plain"].norm())
    del grads

    losses, times, graphs = {}, {}, {}
    for name, st in paths.items():
        losses[name], times[name], graphs[name] = [], [], []
        for i, batch in enumerate(batches):
            reset_counts()
            before = graph_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = forecaster_train_step(st, batch, lr)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            graphs[name].append(graph_delta(before))
            if name == "kernel":
                expect_counts(f"train {dtype_name} step {i}", 0, 0, per_step,
                              k6=per_step, wg=n_cells,
                              path=f"train_per_step.{dtype_name}")
            else:
                expect_counts(f"plain train {dtype_name} step {i}", 0, 0, 0)
            if m["skipped"] or not np.isfinite(m["total"]):
                raise AssertionError(f"train {name} {dtype_name} step {i}: "
                                     f"{m}")
            losses[name].append(m["total"])
        expect_graphs(f"train {name} {dtype_name}", graphs[name], steps)
    loss_err = max(abs(a - c) for a, c in zip(losses["kernel"],
                                               losses["plain"]))
    param_err = max(float((pk - pp).detach().abs().max()) for pk, pp in zip(
        paths["kernel"].model.parameters(), paths["plain"].model.parameters()))
    moved = max(float((p.detach().cpu() - state_dict[n]).abs().max())
                for n, p in paths["kernel"].model.named_parameters())
    errs = {"loss": loss_err, "grad": grad_err, "param": param_err}
    say(phase="train_check", dtype=dtype_name, errors=errs,
        tol={k: v[dtype_name] for k, v in TRAIN_TOL.items()},
        max_param_move=moved, losses_kernel=losses["kernel"],
        losses_plain=losses["plain"])
    for key, err in errs.items():
        if not err <= TRAIN_TOL[key][dtype_name]:
            raise AssertionError(f"train {dtype_name}: {key} error {err:.3e} "
                                 f"> {TRAIN_TOL[key][dtype_name]}")
    if moved == 0.0:
        raise AssertionError(f"train {dtype_name}: the params did not move")

    reset_counts()
    acc = forecaster_eval_step(paths["kernel"].model, batches[0], b,
                               tuple(cfg.training.eval_thresholds))
    expect_counts(f"eval {dtype_name}", per_step, 0,
                  path=f"eval_batch.{dtype_name}")
    if not all(bool(torch.isfinite(v[0]).all()) for v in acc.values()):
        raise AssertionError(f"eval {dtype_name}: non-finite metrics")

    profile = None
    if dtype_name == "bfloat16":
        profile = profile_train_step(lambda: forecaster_train_step(
            paths["kernel"], batches[0], lr))
    rec = dict(dtype=dtype_name, steps=steps, batch=b,
               launches_per_step={"convlstm_cell_fwd_save_z": per_step,
                                  "convlstm_cell_fwd": 0, "conv_head_fwd": 0,
                                  "cell_backward": K6_BY_PATH[
                                      f"train_per_step.{dtype_name}"]},
               launches_train=per_step * steps, launches_eval_batch=per_step,
               kernel_p50_ms=statistics.median(times["kernel"]),
               plain_p50_ms=statistics.median(times["plain"]),
               kernel_ms=times["kernel"], plain_ms=times["plain"],
               # the first call's forward and backward, eager; the first
               # step captures; later steps replay
               eager_first_fwd_bwd_ms=eager_ms,
               replayed_step_p50_ms={k: statistics.median(v[1:])
                                     for k, v in times.items()},
               graphs_per_step=graphs,
               losses_kernel=losses["kernel"], losses_plain=losses["plain"],
               errors=errs, tol={k: v[dtype_name] for k, v in TRAIN_TOL.items()},
               max_param_move=moved,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(phase="train", **rec)
    del paths, batches
    torch.cuda.empty_cache()
    rec["profile"] = profile
    return rec


def phase_trainer(tmp, request):
    """The CLI's train path on nowcast_128_pallas in process (24 sequences,
    2 epochs; latest saved every epoch so that --resume starts at epoch 2),
    --resume to 3 epochs, --mode eval, then load_predictor on the trainer's
    best_model serving one request on K5 (bf16)."""
    cfg = load_config("nowcast_128_pallas")
    mc = cfg.model
    cfg.data.synthetic_num_sequences = TRAINER_SEQUENCES
    cfg.training.epochs = TRAINER_EPOCHS
    cfg.output.output_dir = os.path.join(tmp, "trainer")
    cfg.output.save_model_interval = 1
    yamls = []
    for epochs in (TRAINER_EPOCHS, TRAINER_EPOCHS + 1):
        cfg.training.epochs = epochs
        yamls.append(os.path.join(tmp, f"trainer_{epochs}.yaml"))
        cfg.to_yaml(yamls[-1])
    per_step = len(mc.hidden_dims) * (mc.input_frames + mc.output_frames - 1)
    b = cfg.training.batch_size
    n_train = int(TRAINER_SEQUENCES * 0.7) // b
    n_val = -(-int(TRAINER_SEQUENCES * 0.15) // b)
    t0 = time.perf_counter()
    reset_counts()
    h2 = cli.main(["--config", yamls[0], "--mode", "train"])
    train_launches = counted("k1z")
    expect_counts("trainer 2 epochs", TRAINER_EPOCHS * n_val * per_step, 0,
                  TRAINER_EPOCHS * n_train * per_step,
                  k6=TRAINER_EPOCHS * n_train * per_step,
                  wg=TRAINER_EPOCHS * n_train * len(mc.hidden_dims),
                  path="trainer_train." + cfg.precision.compute_dtype)
    h3 = cli.main(["--config", yamls[1], "--mode", "train", "--resume"])
    if h3["epoch"] != list(range(TRAINER_EPOCHS + 1)) or \
            {k: v[:TRAINER_EPOCHS] for k, v in h3.items()} != h2:
        raise AssertionError(f"--resume did not continue at epoch "
                             f"{TRAINER_EPOCHS}: {h3['epoch']}")
    with open(os.path.join(cfg.output.output_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line)["epoch"] for line in f]
    if logged != list(range(TRAINER_EPOCHS + 1)):
        raise AssertionError(f"metrics.jsonl epochs {logged}")
    metrics = cli.main(["--config", yamls[1], "--mode", "eval"])
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"--mode eval metrics {metrics}")
    predict = load_predictor(cfg, os.path.join(cfg.output.output_dir,
                                               "best_model"))
    reset_counts()
    out = predict(request)
    served = expect_rollout("trainer best_model predict",
                            cfg.precision.compute_dtype,
                   len(mc.hidden_dims), mc.input_frames + mc.output_frames - 1,
                   mc.output_frames, path="trainer_best_model_request."
                   + cfg.precision.compute_dtype)
    want = (request.shape[0], mc.output_frames) + tuple(request.shape[2:])
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"trainer predict: {tuple(out.shape)}")
    rec = dict(sequences=TRAINER_SEQUENCES, epochs=TRAINER_EPOCHS + 1,
               seconds=time.perf_counter() - t0, train_launches_z=train_launches,
               served_launches=served,
               val_l1=h3["val_l1"], total_loss=h3["total_loss"],
               test_metrics=metrics)
    say(phase="trainer", **rec)
    return rec


def phase_tap_structure():
    """The tap-structure experiment (P5 on Hopper) at its full shape: its
    own path, experiments.tap_structure.run(), with the launch counts set to
    0 before and read after; then K3 and K4 against their plain versions on
    the experiment's operands, timed in turns beside the plain versions,
    64 cuBLAS products of the same operands, and the bound; then each in a
    CUDA graph at REPS and TAP_LOW_REPS: the device time, and the slope
    between the two, which must take at least the extra repetitions' time
    at the tensor cores' peak (the work-done guard)."""
    from pl_convlstm_gan_tpu_torch.experiments import tap_structure as ts
    reset_counts()
    runs = {r["name"]: r for r in ts.run(device=DEVICE)}
    expect = ts.ITERS * ts.ROUNDS + 1          # and one warm-up launch
    expect_counts("tap_structure", 0, 0, k3=expect, k4=expect)
    launches = {"tap_loop": expect, "tap_k1152": expect}
    a9, w9, abig, wbig = ts.operands(DEVICE)
    m, n, kt, reps = ts.M, ts.N, ts.TAPS * ts.K, ts.REPS
    flops = ts.flops(reps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # a 64 x 64 tile per cluster of _PAIR blocks, split along K
    blocks = (m // tap_mod._BM) * (n // tap_mod._BN) * tap_mod._PAIR
    out = torch.empty((m, n), dtype=torch.bfloat16, device=DEVICE)

    def raws(r):
        return {"tap_loop": raw_launcher(
                    "tap_structure", "tap_loop_bf16", tap_mod._ARGTYPES,
                    (a9, w9, out), (m, ts.K, n, r)),
                "tap_k1152": raw_launcher(
                    "tap_structure", "tap_k1152_bf16", tap_mod._ARGTYPES,
                    (abig, wbig, out), (m, kt, n, r))}
    raw, raw_low = raws(reps), raws(TAP_LOW_REPS)
    slope_flops = flops - ts.flops(TAP_LOW_REPS)
    min_slope_ms = slope_flops / PEAK_FLOPS["bfloat16"] * 1e3
    max_tflops = TAP_MAX_RATE * PEAK_FLOPS["bfloat16"] / 1e12
    # in turns within one call: K3, K4, K4, K3
    turns = {"tap_loop": [], "tap_k1152": []}
    for name in ("tap_loop", "tap_k1152", "tap_k1152", "tap_loop"):
        turns[name].append(ts.launch_ms(raw[name])[0])
    recs = {}
    for name, run_name, kernel, plain, operands, library in (
            ("tap_loop", "9-tap-loop", tap_loop, taps_plain, (a9, w9),
             lambda: torch.matmul(a9, w9)),
            ("tap_k1152", "one-K1152", tap_k1152, big_plain, (abig, wbig),
             lambda: torch.matmul(abig, wbig))):
        got = kernel(*operands, reps)
        want = plain(*operands, reps)
        torch.cuda.synchronize()
        err = check_close(f"{name} vs plain", got, want, 0.0, TAP_RTOL)
        nbytes = 2 * (operands[0].numel() + operands[1].numel() + m * n)
        rec = dict(
            ms=runs[run_name]["ms"], ms_all=runs[run_name]["ms_all"],
            ms_turns=turns[name], tflops=runs[run_name]["tflops"],
            launches=launches[name], max_abs_err=err,
            max_rel_err=float(((got.float() - want.float()).abs()
                               / want.float().abs()).max()),
            max_abs_output=float(want.float().abs().max()),
            plain_ms=ts.launch_ms(lambda: plain(*operands, reps), 3)[0],
            library_ms=ts.launch_ms(lambda: [library() for _ in range(reps)],
                                    3)[0],
            flops=flops, nbytes=nbytes, blocks=blocks,
            cluster=tap_mod._PAIR, sms=sms, sm_share=min(blocks, sms) / sms)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, "bfloat16")
        rec["graph_ms"] = graph_ms(raw[name], TAP_GRAPH_ITERS)
        rec["graph_ms_low_reps"] = graph_ms(raw_low[name], TAP_GRAPH_ITERS)
        rec["low_reps"] = TAP_LOW_REPS
        rec["slope_ms"] = rec["graph_ms"] - rec["graph_ms_low_reps"]
        rec["min_slope_ms"] = min_slope_ms
        rec["graph_tflops"] = flops / (rec["graph_ms"] * 1e-3) / 1e12
        rec["slope_tflops"] = (slope_flops / (rec["slope_ms"] * 1e-3) / 1e12
                               if rec["slope_ms"] > 0 else None)
        # the repetitions' fixed part: launch, staging, epilogue
        rec["fixed_ms"] = rec["graph_ms"] - rec["slope_ms"] * reps / (
            reps - TAP_LOW_REPS)
        say(phase="tap_structure", kernel=name, tol=[0.0, TAP_RTOL], **rec)
        if rec["slope_ms"] < min_slope_ms:
            raise AssertionError(
                f"{name}: {reps - TAP_LOW_REPS} more repetitions took "
                f"{rec['slope_ms']:.4f} ms, less than the {min_slope_ms:.4f} "
                "ms the tensor cores need for them: repetitions skipped")
        for key in ("tflops", "graph_tflops", "slope_tflops"):
            if rec[key] > max_tflops:
                raise AssertionError(f"{name}: {key} {rec[key]:.1f} above "
                                     f"{max_tflops:.1f} TFLOP/s")
        recs[name] = rec
    return recs


def gan_config(name, dtype_name, step_impl, impl="pallas"):
    cfg = load_config(name)
    cfg.precision.compute_dtype = dtype_name
    cfg.model.convlstm_impl = impl
    cfg.model.remat, cfg.model.remat_policy = False, ""
    cfg.training.gan_step_impl = step_impl
    cfg.validate(training=True)
    return cfg


def disc_params(cfg, seed):
    """The discriminator of cfg as a flax params tree of numpy arrays with
    torch-default-init ranges (conv_0 ... conv_out, 4x4 kernels)."""
    rng = np.random.default_rng(seed)
    tree, cin = {}, cfg.model.in_channels
    names = [f"conv_{i}" for i in range(len(cfg.model.disc_features))]
    for name, cout in zip(names + ["conv_out"],
                          list(cfg.model.disc_features) + [1]):
        bnd = 1.0 / np.sqrt(16 * cin)
        tree[name] = {
            "kernel": rng.uniform(-bnd, bnd, (4, 4, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bnd, bnd, cout).astype(np.float32)}
        cin = cout
    return {"params": tree}


def gan_state(cfg, gen_sd, disc_sd):
    gen, disc = build_model(cfg), build_discriminator(cfg)
    gen.load_state_dict(gen_sd)
    disc.load_state_dict(disc_sd)
    gen.to(DEVICE).train()
    disc.to(DEVICE).train()
    return GANTrainState(gen, disc, make_optimizer(gen), make_optimizer(disc))


def gan_step_fn(state, cfg, lr, d_lr, draws):
    tc = cfg.training
    return lambda batch: gan_train_step(
        state, batch, lr, d_lr, draws, tc.lambda_adv, tc.lambda_l1,
        tc.label_smoothing, tc.grad_clip_norm, tc.gan_step_impl)


def gan_grads(state, cfg, batch, draws):
    """Step-1 gradients of D (on the detached fake) and of G (against the
    same D), flattened, without an update."""
    inputs, targets = batch
    tc = cfg.training
    fake = state.gen(inputs, targets, draws)
    d_total, _ = gan_d_loss(state.disc, targets, fake.detach(),
                            tc.label_smoothing)
    d = torch.autograd.grad(d_total, list(state.disc.parameters()))
    g_total, _ = gan_g_loss(state.disc, fake, targets, tc.lambda_adv,
                            tc.lambda_l1)
    g = torch.autograd.grad(g_total, list(state.gen.parameters()))
    return {"g": torch.cat([t.flatten() for t in g]),
            "d": torch.cat([t.flatten() for t in d])}


def max_param_diff(a, b):
    return max(float((pa - pb).detach().abs().max())
               for pa, pb in zip(a.parameters(), b.parameters()))


def profile_gan_step(step, batch, p50_ms):
    """torch.profiler over one GAN step after a traced warm-up step: device
    time by group. A kernel goes to the op that launched it (the profiler's
    own link, ``FunctionEvent.kernels``): K1 by its name; the kernels of a
    convolution op (forward or backward) to D when the op's weight is 4x4,
    else to G (3x3: the cells' backward, the head); the rest to
    elementwise. Device time no op claims is listed as unattributed. The
    idle share is taken against the unprofiled p50 step (recording shapes
    slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        step(batch)
        torch.cuda.synchronize()
        prof.step()
        reset_counts()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    k1 = {"without_z": counted("k1"), "with_z": counted("k1z")}
    events = list(prof.events())
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and not ev.name.startswith("ProfilerStep")
               and not getattr(ev, "is_user_annotation", False)]
    span = lambda ev: (ev.time_range.end - ev.time_range.start) / 1e3
    busy = sum(span(ev) for ev in kernels)
    # K1 by name: a launch outside any op (the detached forward) has no op
    k1_events = [ev for ev in kernels if "convlstm_cell" in ev.name]
    groups = {"K1": [len(k1_events), sum(span(ev) for ev in k1_events)]}
    for op in events:
        if op.device_type != DeviceType.CPU:
            continue
        for k in op.kernels:
            if "convlstm_cell" in k.name:
                continue
            if "conv" in op.name:
                d = any(len(sh) == 4 and tuple(sh[-2:]) == (4, 4)
                        for sh in (op.input_shapes or []))
                name = "cudnn_conv_D" if d else "cudnn_conv_G"
            else:
                name = "elementwise_reduce_copy"
            g = groups.setdefault(name, [0, 0.0])
            g[0] += 1
            g[1] += k.duration / 1e3
    groups["unattributed"] = [0, busy - sum(ms for _, ms in groups.values())]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=max(0.0, 1 - busy / p50_ms),
                idle_share_profiled=max(0.0, 1 - busy / (wall * 1e3)),
                k1_launches=k1,
                groups={k: [n, round(ms, 3)] for k, (n, ms) in groups.items()})


def phase_gan(name, dtype_name, step_impl, tf_prob, steps, cuts, seed):
    """GAN training at full width on the kernel path (convlstm_impl pallas:
    K1 with z and ConvLSTMCellFn in G) against the plain path (auto) from
    one state and batches: step-1 gradients of G and D, per-step d_total
    and g_total, params after the steps, within TRAIN_TOL; exact K1 launch
    counts; default against vjp on the kernel path; p50 step times, peak
    memory and a profiled kernel step."""
    cfg = gan_config(name, dtype_name, step_impl)
    mc, tc = cfg.model, cfg.training
    b, size = tc.batch_size, cfg.data.synthetic_image_size
    n_cells = len(mc.hidden_dims)
    scan = mc.input_frames + mc.output_frames - 1
    lr, d_lr = tc.learning_rate, tc.disc_learning_rate or tc.learning_rate
    gen_sd = flax_to_state_dict(nowcast_params(cfg, seed))
    disc_sd = flax_to_state_dict(disc_params(cfg, seed + 1))
    ds = SyntheticSequenceDataset(steps * b, mc.input_frames, mc.output_frames,
                                  size, seed=seed)
    batches = [to_device(x, torch.device(DEVICE))
               for x in batch_iterator(ds, b)]
    gen = torch.Generator().manual_seed(seed)
    draws = [(torch.rand((scan, b), generator=gen) < tf_prob).to(DEVICE)
             if tf_prob > 0 else None for _ in batches]
    cfgs = {"kernel": cfg,
            "plain": gan_config(name, dtype_name, step_impl, "auto")}
    paths = {p: gan_state(c, gen_sd, disc_sd) for p, c in cfgs.items()}

    grads = {p: gan_grads(st, cfgs[p], batches[0], draws[0])
             for p, st in paths.items()}
    grad_err = {k: float((grads["kernel"][k] - grads["plain"][k]).norm()
                         / grads["plain"][k].norm()) for k in ("g", "d")}
    del grads
    if step_impl == "default":      # K1 without z (the detached forward)
        expect = (n_cells * scan, n_cells * scan)
    else:
        expect = (0, n_cells * scan)
    metrics, times, peak_gb = {}, {}, {}
    for p, st in paths.items():
        torch.cuda.reset_peak_memory_stats()
        metrics[p], times[p] = [], []
        for i, batch in enumerate(batches):
            step = gan_step_fn(st, cfgs[p], lr, d_lr, draws[i])
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            times[p].append((time.perf_counter() - t0) * 1e3)
            want = expect if p == "kernel" else (0, 0)
            expect_counts(f"gan {name} {p} step {i}", want[0], 0, want[1],
                          k6=want[1], wg=n_cells if want[1] else 0,
                          path=f"gan_{name}_{step_impl}_per_step"
                          f".{dtype_name}" if p == "kernel" else None)
            if m["skipped"] or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"gan {name} {p} step {i}: {m}")
            metrics[p].append(m)
        peak_gb[p] = torch.cuda.max_memory_allocated() / 1e9
    loss_err = max(abs(mk[k] - mp[k]) for mk, mp in zip(
        metrics["kernel"], metrics["plain"]) for k in ("d_total", "g_total"))
    param_err = {"g": max_param_diff(paths["kernel"].gen, paths["plain"].gen),
                 "d": max_param_diff(paths["kernel"].disc,
                                     paths["plain"].disc)}
    moved = max(float((p.detach().cpu() - gen_sd[n]).abs().max())
                for n, p in paths["kernel"].gen.named_parameters())
    errs = {"loss": loss_err, "grad_g": grad_err["g"],
            "grad_d": grad_err["d"], "param_g": param_err["g"],
            "param_d": param_err["d"]}
    tol = {k: TRAIN_TOL[k.split("_")[0]][dtype_name] for k in errs}
    say(phase="gan_check", config=name, dtype=dtype_name, impl=step_impl,
        errors=errs, tol=tol, max_param_move=moved,
        d_total_kernel=[m["d_total"] for m in metrics["kernel"]],
        d_total_plain=[m["d_total"] for m in metrics["plain"]],
        g_total_kernel=[m["g_total"] for m in metrics["kernel"]],
        g_total_plain=[m["g_total"] for m in metrics["plain"]])
    for key, err in errs.items():
        if not err <= tol[key]:
            raise AssertionError(f"gan {name}: {key} error {err:.3e} > "
                                 f"{tol[key]}")
    if moved == 0.0:
        raise AssertionError(f"gan {name}: the generator did not move")

    # the other step impl on the kernel path, one step from the same state
    other = "vjp" if step_impl == "default" else "default"
    pair = {}
    for impl in (step_impl, other):
        c = gan_config(name, dtype_name, impl)
        st = gan_state(c, gen_sd, disc_sd)
        pair[impl] = (st, gan_step_fn(st, c, lr, d_lr, draws[0])(batches[0]))
    atol, rtol = GAN_IMPL_LOSS_TOL
    impl_err = {k: abs(pair["vjp"][1][k] - pair["default"][1][k])
                for k in ("d_total", "g_total")}
    impl_param = max_param_diff(pair["vjp"][0].gen, pair["default"][0].gen)
    for k, err in impl_err.items():
        if not err <= atol + rtol * abs(pair["default"][1][k]):
            raise AssertionError(f"gan {name}: vjp vs default {k} {err:.3e}")
    if not impl_param <= 2 * lr:
        raise AssertionError(f"gan {name}: vjp vs default params "
                             f"{impl_param:.3e} > 2 lr")
    del pair

    # the two paths' steps again, taken in turns on one batch, so that a
    # slower host weighs on both alike (the p50s above run one path, then
    # the other)
    turns = p50_ms({p: (lambda s=gan_step_fn(st, cfgs[p], lr, d_lr, draws[0]):
                        s(batches[0])) for p, st in paths.items()})

    prof = profile_gan_step(gan_step_fn(paths["kernel"], cfg, lr, d_lr,
                                        draws[0]), batches[0],
                            statistics.median(times["kernel"]))
    say(phase="gan_profile", config=name, dtype=dtype_name, impl=step_impl,
        **prof)
    rec = dict(config=name, dtype=dtype_name, impl=step_impl, steps=steps,
               batch=b, size=size, frames=[mc.input_frames, mc.output_frames],
               hidden=list(mc.hidden_dims),
               disc_features=list(mc.disc_features), tf_prob=tf_prob,
               cuts=cuts,
               launches_per_step={"convlstm_cell_fwd": expect[0],
                                  "convlstm_cell_fwd_save_z": expect[1],
                                  "conv_head_fwd": 0,
                                  "cell_backward": K6_BY_PATH[
                                      f"gan_{name}_{step_impl}_per_step."
                                      f"{dtype_name}"]},
               kernel_p50_ms=statistics.median(times["kernel"]),
               plain_p50_ms=statistics.median(times["plain"]),
               kernel_ms=times["kernel"], plain_ms=times["plain"],
               kernel_p50_ms_in_turns=turns["kernel"][0],
               plain_p50_ms_in_turns=turns["plain"][0],
               errors=errs, tol=tol,
               impl_check={"other": other, "loss_err": impl_err,
                           "param_err": impl_param},
               peak_mem_gb=peak_gb, max_param_move=moved)
    say(phase="gan", **rec)
    del paths, batches
    torch.cuda.empty_cache()
    rec["profile"] = prof
    return rec


def phase_gan_trainer(tmp, seed):
    """The CLI's train path on gan_64 (kernel path: convlstm_impl pallas) in
    process, with its data cut to 24 sequences and the run to 2 epochs, then
    --resume to 3, --mode eval, and load_predictor on the trainer's
    best_model (its gen_params) serving one request of B frames on K1/K2,
    each with exact launch counts."""
    cfg = load_config("gan_64")
    mc = cfg.model
    size = cfg.data.synthetic_image_size
    request = torch.from_numpy(np.random.default_rng(seed).random(
        (cfg.training.batch_size, mc.input_frames, mc.in_channels, size,
         size), dtype=np.float32)).to(DEVICE)
    cfg.model.convlstm_impl = "pallas"
    cfg.data.synthetic_num_sequences = GAN_TRAINER_SEQUENCES
    cfg.output.output_dir = os.path.join(tmp, "gan_trainer")
    cfg.output.save_model_interval = 1
    cuts = [f"data: {GAN_TRAINER_SEQUENCES} sequences (from "
            f"{load_config('gan_64').data.synthetic_num_sequences})",
            f"epochs: {TRAINER_EPOCHS} + 1 resumed (from "
            f"{load_config('gan_64').training.epochs})"]
    yamls = []
    for epochs in (TRAINER_EPOCHS, TRAINER_EPOCHS + 1):
        cfg.training.epochs = epochs
        yamls.append(os.path.join(tmp, f"gan_trainer_{epochs}.yaml"))
        cfg.to_yaml(yamls[-1])
    per_step = len(mc.hidden_dims) * (mc.input_frames + mc.output_frames - 1)
    b = cfg.training.batch_size
    n_train = int(GAN_TRAINER_SEQUENCES * 0.7) // b
    n_val = -(-int(GAN_TRAINER_SEQUENCES * 0.15) // b)
    t0 = time.perf_counter()
    reset_counts()
    h2 = cli.main(["--config", yamls[0], "--mode", "train"])
    train_launches = {"convlstm_cell_fwd": counted("k1"),
                      "convlstm_cell_fwd_save_z": counted("k1z")}
    # default step: one detached forward (K1 without z) and one with z a
    # step; validation runs K1 without z
    expect_counts("gan trainer 2 epochs",
                  TRAINER_EPOCHS * (n_train + n_val) * per_step, 0,
                  TRAINER_EPOCHS * n_train * per_step,
                  k6=TRAINER_EPOCHS * n_train * per_step,
                  wg=TRAINER_EPOCHS * n_train * len(mc.hidden_dims),
                  path="gan_trainer_train." + cfg.precision.compute_dtype)
    h3 = cli.main(["--config", yamls[1], "--mode", "train", "--resume"])
    if h3["epoch"] != list(range(TRAINER_EPOCHS + 1)) or \
            {k: v[:TRAINER_EPOCHS] for k, v in h3.items()} != h2:
        raise AssertionError(f"gan --resume did not continue at epoch "
                             f"{TRAINER_EPOCHS}: {h3['epoch']}")
    if not (all(np.isfinite(h3["g_loss"])) and all(np.isfinite(h3["d_loss"]))):
        raise AssertionError(f"gan trainer losses {h3['g_loss']} "
                             f"{h3['d_loss']}")
    metrics = cli.main(["--config", yamls[1], "--mode", "eval"])
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"gan --mode eval metrics {metrics}")
    predict = load_predictor(cfg, os.path.join(cfg.output.output_dir,
                                               "best_model"))
    reset_counts()
    out = predict(request)
    expect_counts("gan trainer best_model predict", per_step,
                  mc.output_frames, path="gan_trainer_best_model_request."
                  + cfg.precision.compute_dtype)
    want = (request.shape[0], mc.output_frames) + tuple(request.shape[2:])
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"gan trainer predict: {tuple(out.shape)}")
    rec = dict(config="gan_64", cuts=cuts, sequences=GAN_TRAINER_SEQUENCES,
               epochs=TRAINER_EPOCHS + 1, seconds=time.perf_counter() - t0,
               train_launches=train_launches, g_loss=h3["g_loss"],
               d_loss=h3["d_loss"], val_l1=h3["val_l1"], test_metrics=metrics)
    say(phase="gan_trainer", **rec)
    return rec


def generator_params(cfg, lu_channels, seed):
    """The Generator of ``cfg`` (two cells, three x2 blocks: scale 8) as
    the JAX package's flax params tree of numpy arrays, named as
    pl_convlstm_gan_tpu/models/generator.py names them, with
    torch-default-init ranges."""
    rng = np.random.default_rng(seed)
    mc = cfg.model
    hd, k = mc.hidden_dims, mc.kernel_size

    def conv(kk, ci, co):
        bnd = 1.0 / np.sqrt(kk * kk * ci)
        return {"kernel": rng.uniform(-bnd, bnd, (kk, kk, ci, co)).astype(np.float32),
                "bias": rng.uniform(-bnd, bnd, co).astype(np.float32)}

    params = {"init_conv": conv(3, mc.in_channels + 2, hd[0]),
              "recurrence": {}}
    cin = hd[0]
    for i, ch in enumerate(hd):
        params["recurrence"][f"cell{i + 1}"] = conv(k, cin + ch, 4 * ch)
        cin = ch
    for i in range(int(np.log2(mc.scale_factor))):
        params[f"upsample_{i}"] = {"conv": conv(3, hd[-1], 4 * hd[-1])}
    for name, cc in (("dem_attn", mc.dem_channels), ("lu_attn", lu_channels)):
        params[name] = {"conv_reduce": conv(3, cc, hd[-1] // 2),
                        "conv_gate": conv(1, hd[-1] // 2, hd[-1])}
    params["post_conv1"] = conv(3, hd[-1], 32)
    params["post_conv2"] = conv(3, 32, 1)
    return {"params": params}


def generator_config(dtype_name, impl):
    """configs/default.yaml as written but for the compute dtype and
    model.convlstm_impl ("pallas": the cells on K1; "auto": the plain
    step)."""
    cfg = load_config("default")
    cfg.precision.compute_dtype = dtype_name
    cfg.model.convlstm_impl = impl
    cfg.validate(training=True)
    return cfg


def write_generator_checkpoint(path, cfg, lu_channels, seed):
    """generator_params as an .npz of flattened flax params; checks that
    weights.py maps them onto every parameter of the port's Generator."""
    tree = generator_params(cfg, lu_channels, seed)["params"]

    def flat(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}/{key}")
            else:
                yield f"{prefix}/{key}", value
    arrays = dict(flat(tree, "params"))
    np.savez(path, **arrays)
    want = set(build_model(cfg, lu_channels=lu_channels).state_dict())
    if set(flax_to_state_dict(arrays)) != want:
        raise AssertionError("weights.py does not map the Generator's tree "
                             "onto the port's Generator")
    return path


def check_generator_output(what, out, ref, want_shape, dtype_name):
    """Shape, dtype, a varying output inside the range PATH_TOL was set for,
    and the kernel path's output against the plain path's."""
    if tuple(out.shape) != want_shape or out.dtype != torch.float32:
        raise AssertionError(f"{what}: got {tuple(out.shape)} {out.dtype}")
    if float(out.std()) == 0.0:
        raise AssertionError(f"{what}: constant output")
    if float(ref.abs().max()) >= GEN_MAX_OUTPUT:
        raise AssertionError(f"{what}: outputs reach {float(ref.abs().max())}"
                             f", beyond the range PATH_TOL was set for")
    return check_close(what, out, ref, *PATH_TOL[dtype_name])


def phase_generator(tmp, dtype_name, seed):
    """The downscaling Generator at configs/default.yaml's width (hidden
    (16, 32), T 5, 16^2 -> 128^2, B 8), weights from ``seed`` through
    weights.py, batches of SyntheticDownscalingDataset(GEN_DATA): requests
    through load_predictor on K1 (convlstm_impl pallas) against the plain
    path (auto), with exact K1 launch counts, timed in turns; one forward
    at the reference's test shape; then GEN_TRAIN_STEPS train steps on both
    paths from one state (step-1 gradients, per-step losses, params after
    the steps, within TRAIN_TOL; K1 with z launch counts), an eval batch,
    both paths' steps timed in turns and a profiled kernel step."""
    torch.cuda.reset_peak_memory_stats()
    ds = SyntheticDownscalingDataset(**GEN_DATA)
    lu_c = ds.num_lu_classes
    cfgs = {"kernel": generator_config(dtype_name, "pallas"),
            "plain": generator_config(dtype_name, "auto")}
    mc, tc = cfgs["kernel"].model, cfgs["kernel"].training
    b, per_call = tc.batch_size, mc.T * len(mc.hidden_dims)
    lr, clip = tc.learning_rate, tc.grad_clip_norm
    loss_cfg = loss_config(tc)
    ckpt = write_generator_checkpoint(
        os.path.join(tmp, f"generator_{dtype_name}.npz"), cfgs["kernel"],
        lu_c, seed)
    batches = [to_device(x, torch.device(DEVICE)) for x in itertools.islice(
        batch_iterator(ds, b), max(N_REQUESTS, GEN_TRAIN_STEPS))]
    predicts = {p: load_predictor(c, ckpt) for p, c in cfgs.items()}
    hgt, wid = batches[0][0].shape[-2:]
    want = (b, mc.T, 1, hgt * mc.scale_factor, wid * mc.scale_factor)

    reset_counts()
    outs = [predicts["kernel"](*x[:3]) for x in batches[:N_REQUESTS]]
    launches = expect_counts(f"generator {dtype_name} requests",
                             N_REQUESTS * per_call, 0,
                             path=f"generator_request.{dtype_name}")
    refs = [predicts["plain"](*x[:3]) for x in batches[:N_REQUESTS]]
    expect_counts(f"generator {dtype_name} plain requests",
                  N_REQUESTS * per_call, 0)
    errs = [check_generator_output(f"generator {dtype_name} request {i}", o,
                                   r, want, dtype_name)
            for i, (o, r) in enumerate(zip(outs, refs))]
    req = batches[0][:3]
    req_times = p50_ms({p: (lambda f=f: f(*req)) for p, f in predicts.items()})

    # the reference's test shape (B 2, 32^2 -> 256^2)
    rng = np.random.default_rng(seed)
    rb, rs = GEN_REF_SHAPE
    hs = rs * mc.scale_factor
    lu = np.eye(lu_c, dtype=np.float32)[rng.integers(0, lu_c, (rb, hs, hs))]
    ref_in = [torch.from_numpy(a).to(DEVICE) for a in (
        8.0 * rng.random((rb, mc.T, 1, rs, rs), dtype=np.float32),
        rng.random((rb, 1, hs, hs), dtype=np.float32),
        np.ascontiguousarray(lu.transpose(0, 3, 1, 2)))]
    reset_counts()
    ref_out = predicts["kernel"](*ref_in)
    expect_counts(f"generator {dtype_name} reference shape", per_call, 0)
    err_ref = check_generator_output(
        f"generator {dtype_name} reference shape", ref_out,
        predicts["plain"](*ref_in), (rb, mc.T, 1, hs, hs), dtype_name)
    del predicts

    state_dict = flax_to_state_dict(generator_params(cfgs["kernel"], lu_c,
                                                     seed))
    paths = {p: train_state(c, state_dict, lu_c) for p, c in cfgs.items()}
    grads = {}
    for p, st in paths.items():            # step-1 gradients, then cleared
        reset_counts()
        generator_loss(st.model, batches[0], loss_cfg)[0].backward()
        expect_counts(f"generator {dtype_name} {p} gradients", 0, 0,
                      per_call if p == "kernel" else 0,
                      k6=per_call if p == "kernel" else 0,
                      wg=len(mc.hidden_dims) if p == "kernel" else 0)
        grads[p] = flat_grads(st.model)
        st.optimizer.zero_grad(set_to_none=True)
    grad_err = float((grads["kernel"] - grads["plain"]).norm()
                     / grads["plain"].norm())
    del grads
    losses, times = {}, {}
    for p, st in paths.items():
        losses[p], times[p] = [], []
        for i, batch in enumerate(batches[:GEN_TRAIN_STEPS]):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = generator_train_step(st, batch, lr, loss_cfg, clip)
            torch.cuda.synchronize()
            times[p].append((time.perf_counter() - t0) * 1e3)
            expect_counts(f"generator {dtype_name} {p} step {i}", 0, 0,
                          per_call if p == "kernel" else 0,
                          k6=per_call if p == "kernel" else 0,
                          wg=len(mc.hidden_dims) if p == "kernel" else 0,
                          path=f"generator_train_step.{dtype_name}"
                          if p == "kernel" else None)
            if m["skipped"] or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"generator {dtype_name} {p} step {i}: "
                                     f"{m}")
            losses[p].append(m["total"])
    loss_err = max(abs(a - c) for a, c in zip(losses["kernel"],
                                               losses["plain"]))
    param_err = max_param_diff(paths["kernel"].model, paths["plain"].model)
    moved = max(float((p.detach().cpu() - state_dict[n]).abs().max())
                for n, p in paths["kernel"].model.named_parameters())
    errs_train = {"loss": loss_err, "grad": grad_err, "param": param_err}
    tol = {k: v[dtype_name] for k, v in TRAIN_TOL.items()}
    say(phase="generator_check", dtype=dtype_name, errors=errs_train, tol=tol,
        max_param_move=moved, losses_kernel=losses["kernel"],
        losses_plain=losses["plain"])
    for key, err in errs_train.items():
        if not err <= tol[key]:
            raise AssertionError(f"generator {dtype_name}: {key} error "
                                 f"{err:.3e} > {tol[key]}")
    if moved == 0.0:
        raise AssertionError(f"generator {dtype_name}: the params did not "
                             f"move")

    reset_counts()
    acc = generator_eval_step(paths["kernel"].model, batches[0], b, loss_cfg)
    expect_counts(f"generator {dtype_name} eval", per_call, 0,
                  path=f"generator_eval_batch.{dtype_name}")
    if not all(bool(torch.isfinite(v[0])) for v in acc.values()):
        raise AssertionError(f"generator {dtype_name} eval: non-finite sums")

    step_times = p50_ms({p: (lambda st=st: generator_train_step(
        st, batches[0], lr, loss_cfg, clip)) for p, st in paths.items()})
    prof = profile_train_step(
        lambda: generator_train_step(paths["kernel"], batches[0], lr,
                                     loss_cfg, clip),
        phase="generator_train_profile")
    rec = dict(dtype=dtype_name, config="default", batch=b, T=mc.T,
               hidden=list(mc.hidden_dims), lr_size=[int(hgt), int(wid)],
               hr_size=list(want[-2:]), requests=N_REQUESTS,
               launches=launches,
               launches_per_request={"convlstm_cell_fwd": per_call},
               launches_per_step={"convlstm_cell_fwd_save_z": per_call,
                                  "cell_backward": K6_BY_PATH[
                                      f"generator_train_step.{dtype_name}"]},
               launches_eval_batch=per_call,
               request_p50_ms=req_times["kernel"][0],
               request_plain_p50_ms=req_times["plain"][0],
               request_ms=req_times["kernel"][1],
               request_plain_ms=req_times["plain"][1],
               max_abs_err=max(errs), max_abs_err_ref_shape=err_ref,
               ref_shape=[rb, mc.T, rs, rs, hs, hs],
               max_abs_output=max(float(r.abs().max()) for r in refs),
               tol=list(PATH_TOL[dtype_name]), train_steps=GEN_TRAIN_STEPS,
               step_p50_ms=step_times["kernel"][0],
               step_plain_p50_ms=step_times["plain"][0],
               step_ms_in_turns=step_times["kernel"][1],
               step_plain_ms_in_turns=step_times["plain"][1],
               step_ms_in_sequence=times["kernel"],
               step_plain_ms_in_sequence=times["plain"],
               errors=errs_train, train_tol=tol, max_param_move=moved,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(phase="generator", **rec)
    del paths, batches
    torch.cuda.empty_cache()
    rec["profile"] = prof
    return rec


def phase_generator_trainer(tmp, seed):
    """The CLI on configs/default.yaml with convlstm_impl pallas, its data
    cut to GEN_TRAINER_SEQUENCES days and the run to 2 epochs: train, then
    --resume to 3, --mode eval, and --mode predict on an .npz of rain_lr /
    dem / lu, each with exact K1 launch counts and its seconds."""
    cfg = load_config("default")
    mc, tc = cfg.model, cfg.training
    written = (cfg.data.synthetic_num_sequences, tc.epochs)
    cfg.model.convlstm_impl = "pallas"
    cfg.data.synthetic_num_sequences = GEN_TRAINER_SEQUENCES
    cfg.output.output_dir = os.path.join(tmp, "generator_trainer")
    cfg.output.save_model_interval = 1
    cuts = ["model.convlstm_impl auto -> pallas (the cells on K1)",
            f"data: {GEN_TRAINER_SEQUENCES} days (from {written[0]})",
            f"epochs: {TRAINER_EPOCHS} + 1 resumed (from {written[1]})"]
    yamls = []
    for epochs in (TRAINER_EPOCHS, TRAINER_EPOCHS + 1):
        cfg.training.epochs = epochs
        yamls.append(os.path.join(tmp, f"generator_trainer_{epochs}.yaml"))
        cfg.to_yaml(yamls[-1])
    per_call = mc.T * len(mc.hidden_dims)
    b = tc.batch_size
    n = GEN_TRAINER_SEQUENCES - mc.T                       # windows
    n_train, n_val = int(n * 0.7), int(n * 0.15)
    n_test = n - n_train - n_val
    seconds = {}

    t0 = time.perf_counter()
    reset_counts()
    h2 = cli.main(["--config", yamls[0], "--mode", "train"])
    seconds["train"] = time.perf_counter() - t0
    train_launches_z = counted("k1z")
    expect_counts("generator trainer 2 epochs",
                  TRAINER_EPOCHS * -(-n_val // b) * per_call, 0,
                  TRAINER_EPOCHS * (n_train // b) * per_call,
                  k6=TRAINER_EPOCHS * (n_train // b) * per_call,
                  wg=TRAINER_EPOCHS * (n_train // b) * len(mc.hidden_dims),
                  path="generator_trainer_train."
                  + cfg.precision.compute_dtype)
    t0 = time.perf_counter()
    h3 = cli.main(["--config", yamls[1], "--mode", "train", "--resume"])
    seconds["resume"] = time.perf_counter() - t0
    if h3["epoch"] != list(range(TRAINER_EPOCHS + 1)) or \
            {k: v[:TRAINER_EPOCHS] for k, v in h3.items()} != h2:
        raise AssertionError(f"generator --resume did not continue at epoch "
                             f"{TRAINER_EPOCHS}: {h3['epoch']}")
    if not all(np.isfinite(h3["total_loss"] + h3["rmse"])):
        raise AssertionError(f"generator trainer losses {h3['total_loss']}")
    with open(os.path.join(cfg.output.output_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line)["epoch"] for line in f]
    if logged != list(range(TRAINER_EPOCHS + 1)):
        raise AssertionError(f"generator metrics.jsonl epochs {logged}")

    t0 = time.perf_counter()
    reset_counts()
    metrics = cli.main(["--config", yamls[1], "--mode", "eval"])
    seconds["eval"] = time.perf_counter() - t0
    expect_counts("generator --mode eval", -(-n_test // b) * per_call, 0)
    if set(metrics) != {"loss", "rmse", "point", "conserve", "smooth",
                        "temporal"} or \
            not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"generator --mode eval metrics {metrics}")

    ds = SyntheticDownscalingDataset(**GEN_DATA)
    rain, dem, lu = next(batch_iterator(ds, b))[:3]
    inp = os.path.join(tmp, "generator_request.npz")
    out_path = os.path.join(tmp, "generator_pred.npy")
    np.savez(inp, rain_lr=rain, dem=dem, lu=lu)
    t0 = time.perf_counter()
    reset_counts()
    cli.main(["--config", yamls[1], "--mode", "predict", "--input", inp,
              "--output", out_path])
    seconds["predict"] = time.perf_counter() - t0
    expect_counts("generator --mode predict", per_call, 0)
    pred = np.load(out_path)
    want = (b, mc.T, 1) + tuple(d * mc.scale_factor for d in rain.shape[-2:])
    if pred.shape != want or not np.isfinite(pred).all():
        raise AssertionError(f"generator --mode predict: {pred.shape}")
    rec = dict(config="default", cuts=cuts, days=GEN_TRAINER_SEQUENCES,
               epochs=TRAINER_EPOCHS + 1, seconds=seconds,
               train_launches_z=train_launches_z, rmse=h3["rmse"],
               total_loss=h3["total_loss"], test_metrics=metrics,
               predict_shape=list(pred.shape))
    say(phase="generator_trainer", **rec)
    return rec


# models that K1 or K2 refuse on the card (config nowcast_128 with these
# changes, 32x32 frames, B 2): (what, dtype, hidden_dims, kernel_size, the
# words of the rule that must name the refusal)
REFUSED_MODELS = (
    ("bf16 Ch 12", "bfloat16", [12, 12], 3, "multiple of 8"),
    ("f32 7x7 cells", "float32", [16], 7, "kernel sizes"),
    ("f32 head Cin 6", "float32", [6], 3, "multiple of 4"),
)


def phase_fit(tmp, seed):
    """C1 on the card: rollout_impl auto routes a model that K1 or K2
    refuses to the plain path before any launch (zero K1/K2 launches in a
    request and in a stream, the same bits as rollout_impl torch), and
    rollout_impl kernel (and JAX's pallas) raises naming the rule; the
    nowcast_128 configs, f32 and bf16, still take the kernels, with exact
    launch counts."""
    recs = []
    rng = np.random.default_rng(seed)
    for what, dtype_name, hidden, k, rule in REFUSED_MODELS:
        cfg = load_config("nowcast_128")
        cfg.precision.compute_dtype = dtype_name
        cfg.model.hidden_dims, cfg.model.kernel_size = hidden, k
        cfg.validate()
        ckpt = write_checkpoint(os.path.join(tmp, f"fit_{len(recs)}.npz"),
                                cfg, seed)
        if rollout_choice(cfg, torch.device("cuda")) != "torch":
            raise AssertionError(f"fit {what}: auto did not choose torch")
        frames = torch.from_numpy(rng.random(
            (2, cfg.model.input_frames, 1, 32, 32), dtype=np.float32)).cuda()
        reset_counts()
        out = load_predictor(cfg, ckpt)(frames)
        sf = StreamingForecaster.from_checkpoint(cfg, ckpt)
        state, _ = sf.observe_window(sf.init_state(2, 32, 32), frames)
        sf.forecast(state, 3)
        expect_counts(f"fit {what} auto", 0, 0)
        cfg_torch = load_config("nowcast_128")
        cfg_torch.precision.compute_dtype = dtype_name
        cfg_torch.model.hidden_dims, cfg_torch.model.kernel_size = hidden, k
        cfg_torch.model.rollout_impl = "torch"
        if not torch.equal(out, load_predictor(cfg_torch, ckpt)(frames)):
            raise AssertionError(f"fit {what}: auto differs from torch")
        refusals = {}
        for impl in ("kernel", "pallas"):
            try:
                build_predict_fn(cfg, ckpt, rollout_impl=impl)
            except ValueError as err:
                refusals[impl] = str(err)
            if rule not in refusals.get(impl, ""):
                raise AssertionError(f"fit {what}: rollout_impl {impl} did "
                                     f"not refuse by its rule: {refusals}")
        recs.append(dict(model=what, dtype=dtype_name, hidden=hidden,
                         kernel_size=k, auto="torch", auto_launches=[0, 0],
                         refusal=refusals["kernel"]))
    fits = {}
    cfg = load_config("nowcast_128")
    steps = cfg.model.input_frames + cfg.model.output_frames - 1
    n_cells = len(cfg.model.hidden_dims)
    ckpt = write_checkpoint(os.path.join(tmp, "fit_nowcast.npz"), cfg, seed)
    request = torch.from_numpy(rng.random(
        (1, cfg.model.input_frames, 1, 128, 128), dtype=np.float32)).cuda()
    for dtype_name in ("float32", "bfloat16"):
        cfg.precision.compute_dtype = dtype_name
        if rollout_choice(cfg, torch.device("cuda")) != "kernel":
            raise AssertionError(f"fit nowcast_128 {dtype_name}: auto did "
                                 f"not choose the kernels")
        predict = load_predictor(cfg, ckpt)
        reset_counts()
        predict(request)
        fits[dtype_name] = expect_rollout(
            f"fit nowcast_128 {dtype_name}", dtype_name, n_cells, steps,
            cfg.model.output_frames, path=f"fit_request.{dtype_name}")
    say(phase="fit", refused=recs, nowcast_128_launches=fits)
    return dict(refused=recs, nowcast_128_launches=fits)


def write_checkpoint(path, cfg, seed):
    """nowcast_params(cfg, seed) as the README's .npz of flattened flax
    params; checks that weights.py maps every entry."""
    params = nowcast_params(cfg, seed)
    flat = {f"params/core/{m}/{leaf}": v
            for m, d in params["params"]["core"].items()
            for leaf, v in d.items()}
    np.savez(path, **flat)
    if set(flax_to_state_dict(flat)) != {
            f"core.{m}.{leaf}" for m in params["params"]["core"]
            for leaf in ("weight", "bias")}:
        raise AssertionError("weights.py does not map every parameter")
    return path


# ------------------------------------------------------------------- int8

def int8_config(impl="int8", dtype_name="float32"):
    cfg = load_config("nowcast_128")
    cfg.model.rollout_impl = impl
    cfg.precision.compute_dtype = dtype_name
    cfg.validate()
    return cfg


def first_step_convs(q, frames):
    """The five int8 convs of the first quantized step of ``frames``
    [B,T,C,H,W] (cell 0's x side and h side, the fused cells, the head):
    [(name, int8 input, int8 kernel, int32 sum)], as ``_int8_step`` runs
    them."""
    b, _, _, hgt, wid = frames.shape
    x = frames[:, 0].permute(0, 2, 3, 1).float()
    states = _zero_states(q, b, hgt, wid, frames.device)
    new_states, _ = _int8_step(q, states, x)
    inputs = [("cell_0_x", q.cell0.conv_x, x),
              ("cell_0_h", q.cell0.conv_h, states[0][0])]
    inputs += [(f"cell_{i + 1}", qc, torch.cat([new_states[i][0],
                                                states[i + 1][0]], -1))
               for i, qc in enumerate(q.cells)]
    inputs.append(("head", q.head, new_states[-1][0]))
    out = []
    for name, qc, inp in inputs:
        xq = quantize_act(inp, dynamic_scale(inp))
        out.append((name, xq, qc.wq, conv2d_int8(xq, qc.wq)))
    return out


def tensor_bytes(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def phase_int8(ckpt, requests, frames8):
    """int8 serving of nowcast_128 at full width on the card (see the module
    docstring, 7a). Returns its record; the int8 stream's launch counts
    under "stream_launches"."""
    cfg = int8_config()
    steps = cfg.model.input_frames + cfg.model.output_frames - 1
    n_cells = len(cfg.model.hidden_dims)
    t_in = cfg.model.input_frames
    b, _, cin, hgt, wid = requests[0].shape
    state_dict = load_state_dict(ckpt)
    q = prepare_int8_forecaster({k: v.cuda() for k, v in state_dict.items()})
    int8 = load_predictor(cfg, ckpt)
    int8_cpu = load_predictor(cfg, ckpt, device="cpu")
    plain = load_predictor(int8_config("torch"), ckpt)
    kernels = {d: load_predictor(int8_config("auto", d), ckpt)
               for d in ("float32", "bfloat16")}

    per_request = []
    for i, req in enumerate(requests):
        for name, xq, wq, z in first_step_convs(q, req):
            if not torch.equal(z.cpu(), conv2d_int8(xq.cpu(), wq.cpu())):
                raise AssertionError(f"int8 request {i}: the first step's "
                                     f"{name} int32 sums differ from the "
                                     f"CPU's")
        reset_counts()
        out = int8(req)
        expect_counts(f"int8 request {i}", 0, 0)
        want = (b, cfg.model.output_frames, cin, hgt, wid)
        if tuple(out.shape) != want or out.dtype != torch.float32 or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"int8 request {i}: {tuple(out.shape)} "
                                 f"{out.dtype}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        cpu_err = check_close(f"int8 request {i} vs the CPU", out.cpu(),
                              int8_cpu(req.cpu()), INT8_CPU_TOL, 0.0)
        ref = plain(req)
        rel_l2 = float((out - ref).norm() / ref.norm())
        if not rel_l2 < INT8_MAX_REL_L2:
            raise AssertionError(f"int8 request {i}: relative L2 {rel_l2:.4f}"
                                 f" against f32 >= {INT8_MAX_REL_L2}")
        per_request.append(dict(max_abs_err_vs_cpu=cpu_err,
                                rel_l2_vs_f32=rel_l2,
                                first_step_int32_equal=True))

    # p50 of N_TIMED requests a path, taken in turns (utils.profiling)
    req = requests[0]
    paths = {"int8": lambda: int8(req),
             "f32_kernel": lambda: kernels["float32"](req),
             "bf16_kernel": lambda: kernels["bfloat16"](req)}
    times = {name: [] for name in paths}
    for fn in paths.values():
        benchmark_fn(fn, warmup=1, iters=1)
    for _ in range(N_TIMED):
        for name, fn in paths.items():
            times[name].append(benchmark_fn(fn, warmup=0, iters=1)["p50"]
                               * 1e3)
    request_p50 = {name: statistics.median(ts) for name, ts in times.items()}

    # the stream: float observe on K1/K2, int8 forecast without a launch
    sf = StreamingForecaster.from_checkpoint(cfg, ckpt)
    sf_f = StreamingForecaster.from_checkpoint(int8_config("auto"), ckpt)
    reset_counts()
    state, nowcast = sf.observe_window(sf.init_state(b, hgt, wid), req)
    expect_counts("int8 stream observe_window", n_cells * t_in, t_in)
    forecast = sf.forecast(state, STREAM_HORIZON)
    stream_launches = expect_counts("int8 stream observe_window + "
                                    f"forecast({STREAM_HORIZON})",
                                    n_cells * t_in, t_in,
                                    path="int8_stream.float32")
    f_ref = sf_f.forecast(state, STREAM_HORIZON)
    stream_rel_l2 = float((forecast - f_ref).norm() / f_ref.norm())
    per_batch = []
    for nb in STREAM_BATCHES:
        warm, _ = sf.observe_window(sf.init_state(nb, hgt, wid), frames8[:nb])
        frame = frames8[:nb, -1]
        reset_counts()
        sf.observe(warm, frame)
        expect_counts(f"int8 stream observe B {nb}", n_cells, 1)
        reset_counts()
        out = sf.forecast(warm, STREAM_HORIZON)
        expect_counts(f"int8 forecast({STREAM_HORIZON}) B {nb}", 0, 0)
        if tuple(out.shape) != (nb, STREAM_HORIZON, cin, hgt, wid) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"int8 forecast B {nb}: {tuple(out.shape)}")
        t = p50_ms({"forecast": lambda: sf.forecast(warm, STREAM_HORIZON),
                    "forecast_f32_kernel": lambda: sf_f.forecast(
                        warm, STREAM_HORIZON),
                    "observe": lambda: sf.observe(warm, frame)})
        per_batch.append(dict(batch=nb, horizon=STREAM_HORIZON,
                              forecast_ms=t["forecast"][0],
                              forecast_f32_kernel_ms=t["forecast_f32_kernel"][0],
                              observe_ms=t["observe"][0],
                              forecast_ms_all=t["forecast"][1]))

    # the artifacts, served from their bytes
    t0 = time.perf_counter()
    blob = export_model(cfg, ckpt, (req,))
    export_s = time.perf_counter() - t0
    served = load_exported(blob)(req)
    if not torch.equal(served, int8(req)):
        raise AssertionError("int8 artifact: differs from the eager int8 "
                             "path")
    t0 = time.perf_counter()
    sblob = export_streaming(cfg, ckpt, hgt, wid, horizons=(INT8_HORIZON,))
    export_stream_s = time.perf_counter() - t0
    meta = parse_stream_header(sblob)[0]
    if meta["rollout"] != "int8" or meta["kernel_horizons"]:
        raise AssertionError(f"int8 stream artifact header: {meta}")
    server = load_streaming_exported(sblob)
    s_state = server.init_state(b)
    e_state = sf.init_state(b, hgt, wid)
    reset_counts()
    for t in range(t_in):
        s_state, s_now = server.observe(s_state, req[:, t])
    expect_counts("int8 stream artifact observe", n_cells * t_in, t_in)
    for t in range(t_in):
        e_state, e_now = sf.observe(e_state, req[:, t])
    s_fore = server.forecast(s_state, INT8_HORIZON)
    if not (torch.equal(s_now, e_now) and torch.equal(
            s_fore, sf.forecast(e_state, INT8_HORIZON))):
        raise AssertionError("int8 stream artifact: differs from the eager "
                             "int8 stream")

    rec = dict(config="nowcast_128", batch=b, steps=steps,
               requests=per_request, request_p50_ms=request_p50,
               request_ms=times, stream_launches=stream_launches,
               stream_forecast_rel_l2_vs_f32_kernel=stream_rel_l2,
               stream=per_batch,
               artifacts=dict(export_s=export_s, bytes=len(blob),
                              export_stream_s=export_stream_s,
                              stream_bytes=len(sblob), equal=True),
               weight_bytes=dict(int8=tensor_bytes(q),
                                 float32=tensor_bytes(state_dict)),
               tol=dict(vs_cpu=INT8_CPU_TOL, rel_l2_vs_f32=INT8_MAX_REL_L2))
    say(phase="int8", **rec)
    return rec, int8


# -------------------------------------------------------------- profiling

def train_step_flops(cfg):
    """The operations of one forecaster train step, counted from the
    shapes: each conv's forward and weight gradient, and its input gradient
    wherever the input needs one (not cell 0 at step 0)."""
    mc = cfg.model
    b, size = cfg.training.batch_size, cfg.data.synthetic_image_size
    conv = lambda cin, cout, k: 2 * b * size * size * k * k * cin * cout
    steps = mc.input_frames + mc.output_frames - 1
    cells, cin = [], mc.in_channels
    for ch in mc.hidden_dims:
        cells.append(conv(cin + ch, 4 * ch, mc.kernel_size))
        cin = ch
    head = conv(cin, mc.in_channels, 3)
    forward = steps * sum(cells) + mc.output_frames * head
    return 2 * forward + forward - cells[0]


def int8_trace_kernels(events):
    """The kernels the aten::_int_mm ops of a Chrome trace launched, by
    name, and the number of those ops."""
    ops = [e for e in events if e.get("name") == "aten::_int_mm"]
    ext = {e.get("args", {}).get("External id") for e in ops}
    corr = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and e.get("args", {}).get("External id") in ext}
    kernels = Counter(
        e["name"] for e in events if e.get("cat") == "kernel" and (
            e.get("args", {}).get("External id") in ext
            or e.get("args", {}).get("correlation") in corr))
    return len(ops), kernels


def phase_profiling(tmp, int8_predict, request, seed):
    """utils.profiling on the card (see the module docstring, 7b)."""
    costs = {}
    for name, impl in (("kernel", "pallas"), ("plain", "xla")):
        cfg = train_config("bfloat16", impl)
        mc = cfg.model
        b, size = cfg.training.batch_size, cfg.data.synthetic_image_size
        state = train_state(cfg, flax_to_state_dict(nowcast_params(cfg, seed)))
        ds = SyntheticSequenceDataset(b, mc.input_frames, mc.output_frames,
                                      size, seed=seed)
        batch = to_device(next(batch_iterator(ds, b)), torch.device(DEVICE))
        reset_counts()
        m, cost = log_compiled_cost(f"nowcast_128_pallas {name} train step",
                                    forecaster_train_step, state, batch,
                                    cfg.training.learning_rate)
        per_step = len(mc.hidden_dims) * (mc.input_frames
                                          + mc.output_frames - 1)
        expect_counts(f"profiling {name} step", 0, 0,
                      per_step if name == "kernel" else 0,
                      k6=per_step if name == "kernel" else 0,
                      wg=len(mc.hidden_dims) if name == "kernel" else 0,
                      path="profiling_train_step." + cfg.precision.compute_dtype
                      if name == "kernel" else None)
        if cost is None or m["skipped"] or not np.isfinite(m["total"]):
            raise AssertionError(f"profiling {name} step: {m}, {cost}")
        costs[name] = cost
        del state
        torch.cuda.empty_cache()
    analytic = train_step_flops(train_config("bfloat16"))
    rel = abs(costs["kernel"]["flops"] - costs["plain"]["flops"]) / \
        costs["plain"]["flops"]
    if not rel <= COST_RTOL or costs["plain"]["flops"] != analytic:
        raise AssertionError(f"profiling: GFLOP kernel "
                             f"{costs['kernel']['flops'] / 1e9} plain "
                             f"{costs['plain']['flops'] / 1e9} analytic "
                             f"{analytic / 1e9}")

    logdir = os.path.join(tmp, "int8_trace")
    int8_predict(request)
    torch.cuda.synchronize()
    with profile_trace(logdir):
        # the first launches after tracing starts can be missing from the
        # trace: a throwaway launch takes that place
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        int8_predict(request)
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")]
    if len(files) != 1 or os.path.getsize(files[0]) == 0:
        raise AssertionError(f"profile_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    cfg = int8_config()
    n_ops, kernels = int8_trace_kernels(events)
    want = (cfg.model.input_frames + cfg.model.output_frames - 1) * (
        len(cfg.model.hidden_dims) + 2)
    if n_ops != want or not kernels or \
            not all("s8" in name for name in kernels):
        raise AssertionError(f"int8 trace: {n_ops} aten::_int_mm (expected "
                             f"{want}), their kernels {dict(kernels)}")
    rec = dict(gflop={k: c["flops"] / 1e9 for k, c in costs.items()},
               gflop_analytic=analytic / 1e9, gflop_rel_diff=rel,
               peak_bytes={k: c["peak_bytes"] for k, c in costs.items()},
               trace_bytes=os.path.getsize(files[0]), int_mm_ops=n_ops,
               int_mm_kernels=dict(kernels))
    say(phase="profiling", **rec)
    return rec


# ------------------------------------------------------------------ remat
# gan_256_single as written (bf16, vjp, B 2, 5 -> 30, 256^2, remat save_z on
# the plain cell) against the same run without remat (the gan phase's cut);
# then the kernel path (convlstm_impl pallas) under each policy K1 takes
# ("" and "dots") against the kernel path without remat. Each run: (label,
# convlstm_impl, remat, remat_policy, the run it is held against)
REMAT_RUNS = (
    ("plain_no_remat", "auto", False, "", None),
    ("plain_save_z", "auto", True, "save_z", "plain_no_remat"),
    ("kernel_no_remat", "pallas", False, "", None),
    ("kernel_full", "pallas", True, "", "kernel_no_remat"),
    ("kernel_dots", "pallas", True, "dots", "kernel_no_remat"),
)
REMAT_STEPS = 3
REMAT_TF_PROB = 0.5


def remat_config(impl, remat, policy):
    cfg = load_config("gan_256_single")
    cfg.model.convlstm_impl = impl
    cfg.model.remat, cfg.model.remat_policy = remat, policy
    cfg.validate(training=True)
    return cfg


def remat_run(label, cfg, gen_sd, disc_sd, batches, draws, expect):
    """One run of the remat phase from the seeded state: the step-1
    gradients of G and D, then the steps with exact K1 and K6 counts
    (``expect``: K1 without z, K1 with z, K6 and the cells' weight-gradient
    convolutions, per step and per gradient pass), their times,
    and the peak of allocated device memory over the gradient pass and the
    steps. Returns its record, with the gradients and the final params."""
    tc = cfg.training
    lr, d_lr = tc.learning_rate, tc.disc_learning_rate or tc.learning_rate
    st = gan_state(cfg, gen_sd, disc_sd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    grads = gan_grads(st, cfg, batches[0], draws[0])
    expect_counts(f"remat {label} gradients", expect[0], 0, expect[1],
                  k6=expect[2], wg=expect[3])
    metrics, times = [], []
    for i, batch in enumerate(batches):
        step = gan_step_fn(st, cfg, lr, d_lr, draws[i])
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        expect_counts(f"remat {label} step {i}", expect[0], 0, expect[1],
                      k6=expect[2], wg=expect[3],
                      path=f"remat_{label}_per_step."
                      + cfg.precision.compute_dtype)
        if m["skipped"] or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"remat {label} step {i}: {m}")
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    rec = dict(label=label, convlstm_impl=cfg.model.convlstm_impl,
               remat=cfg.model.remat, remat_policy=cfg.model.remat_policy,
               launches_per_step={"convlstm_cell_fwd": expect[0],
                                  "convlstm_cell_fwd_save_z": expect[1],
                                  "cell_backward": K6_BY_PATH[
                                      f"remat_{label}_per_step."
                                      + cfg.precision.compute_dtype]},
               p50_ms=statistics.median(times), step_ms=times,
               peak_mem_gb=peak / 1e9, peak_over_base_gb=(peak - base) / 1e9,
               d_total=[m["d_total"] for m in metrics],
               g_total=[m["g_total"] for m in metrics])
    params = {"g": [p.detach().clone() for p in st.gen.parameters()],
              "d": [p.detach().clone() for p in st.disc.parameters()]}
    del st
    torch.cuda.empty_cache()
    return rec, grads, metrics, params


def phase_remat(seed):
    """gan_256_single as written and the kernel path under remat (see
    REMAT_RUNS), each against its run without remat from one seeded state
    and the same batches and draws: step-1 gradients of G and D, per-step
    d_total and g_total, params after the steps within TRAIN_TOL; exact K1
    and K6 counts a step (kernel path: 68 K1 with z without remat; under ""
    and "dots" the backward runs every step again, K1 with z included: 136;
    68 K6 under each);
    p50 step times and peak memory of each run."""
    base = remat_config("auto", True, "save_z")
    mc, tc = base.model, base.training
    dtype_name = base.precision.compute_dtype
    b, size = tc.batch_size, base.data.synthetic_image_size
    per_pass = len(mc.hidden_dims) * (mc.input_frames + mc.output_frames - 1)
    gen_sd = flax_to_state_dict(nowcast_params(base, seed))
    disc_sd = flax_to_state_dict(disc_params(base, seed + 1))
    ds = SyntheticSequenceDataset(REMAT_STEPS * b, mc.input_frames,
                                  mc.output_frames, size, seed=seed)
    batches = [to_device(x, torch.device(DEVICE))
               for x in batch_iterator(ds, b)]
    gen = torch.Generator().manual_seed(seed)
    draws = [(torch.rand((per_pass // len(mc.hidden_dims), b), generator=gen)
              < REMAT_TF_PROB).to(DEVICE) for _ in batches]
    runs, results = {}, {}
    for label, impl, remat, policy, _ in REMAT_RUNS:
        cfg = remat_config(impl, remat, policy)
        if impl == "auto":
            expect = (0, 0, 0, 0)
        else:       # vjp: one forward with z, remat runs it again; one K6;
            # the weight gradient once a cell, or once a step under remat
            expect = (0, per_pass * (2 if remat else 1), per_pass,
                      per_pass if remat else len(mc.hidden_dims))
        runs[label] = remat_run(label, cfg, gen_sd, disc_sd, batches, draws,
                                expect)
    for label, _, _, _, against in REMAT_RUNS:
        rec, grads, metrics, params = runs[label]
        if against is not None:
            _, g0, m0, p0 = runs[against]
            errs = {f"grad_{k}": float((grads[k] - g0[k]).norm()
                                       / g0[k].norm()) for k in ("g", "d")}
            errs["loss"] = max(abs(a[k] - c[k]) for a, c in zip(metrics, m0)
                               for k in ("d_total", "g_total"))
            for k in ("g", "d"):
                errs[f"param_{k}"] = max(float((x - y).abs().max())
                                         for x, y in zip(params[k], p0[k]))
            tol = {k: TRAIN_TOL[k.split("_")[0]][dtype_name] for k in errs}
            rec.update(against=against, errors=errs, tol=tol)
            for key, err in errs.items():
                if not err <= tol[key]:
                    raise AssertionError(f"remat {label} vs {against}: {key} "
                                         f"error {err:.3e} > {tol[key]}")
        say(phase="remat_run", config="gan_256_single", dtype=dtype_name,
            **rec)
        results[label] = rec
    out = dict(config="gan_256_single", dtype=dtype_name,
               impl=tc.gan_step_impl, batch=b, size=size,
               frames=[mc.input_frames, mc.output_frames],
               steps=REMAT_STEPS, tf_prob=REMAT_TF_PROB,
               cuts=[f"depth: {REMAT_STEPS} steps of the {tc.epochs}-epoch "
                     f"run"],
               runs=results)
    say(phase="remat", **{k: v for k, v in out.items() if k != "runs"},
        summary={k: {"p50_ms": r["p50_ms"], "peak_mem_gb": r["peak_mem_gb"],
                     "launches_per_step": r["launches_per_step"]}
                 for k, r in results.items()})
    del runs, batches
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- dp
# Data parallelism at world 2 on the one card: two ranks as child processes
# in a gloo group (gloo carries CUDA tensors for all_reduce and broadcast;
# NCCL refuses two ranks on one GPU), each on its block of the global
# batch, held against one process's steps on the whole batch from the same
# state; then one NCCL group at world 1 (the production backend). Each run:
# (config, global batch, convlstm_impl, teacher-forcing prob of the draws,
# the cuts made)
DP_RUNS = (
    ("nowcast_128_pallas", 4, "pallas", 0.0, []),
    ("gan_64", 8, "pallas", 0.0,
     ["model.convlstm_impl auto -> pallas (K1 in G)"]),
    ("default", 8, "pallas", 0.0,
     ["model.convlstm_impl auto -> pallas (K1)",
      "data: SyntheticDownscalingDataset of 64 days (GEN_DATA); rank 0's "
      "rows keep one station, rank 1's lose their first day's observations "
      "(NaN), so the global station counts matter"]),
    ("dp_v5e16", 2, "auto", 0.5,
     ["training.batch_size 16 -> 2: one sequence a rank at world 2, as its "
      "comment intends for 16 ranks"]),
)
DP_WORLD = 2
DP_STEPS = 2
# DP against one process on the whole batch: losses and params within
# TRAIN_TOL; the step-1 gradients within the bound dp_grad_tol derives. A
# gradient reaches its float32 param through the param's cast to the
# compute dtype, which rounds it to that dtype (relative error at most
# UNIT_ROUNDOFF): each rank rounds the gradient g_r of its block before the
# mean over the ranks, one process the whole batch's g = mean_r g_r (every
# loss here is a mean, and the blocks' scales differ from the batch's by
# powers of two, so everything else rounds alike). Then
#   |mean_r round(g_r) - round(g)| <= u (mean_r |g_r| + |g|)
# in norm, plus float32 sums in other orders (TRAIN_TOL's float32 1e-4).
# TRAIN_TOL's bfloat16 1e-3 holds two paths that round the same values;
# here every element is rounded from other values.
UNIT_ROUNDOFF = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}


def dp_grad_tol(dtype_name, rank_norms, norm):
    """The bound above on ||g_dp - g_one|| / ||g_one||, from the ranks'
    gradient norms of their blocks and the whole batch's."""
    return (UNIT_ROUNDOFF[dtype_name] * (1 + statistics.mean(rank_norms)
                                         / norm)
            + TRAIN_TOL["grad"]["float32"])
DP_NCCL_RUN = "nowcast_128_pallas"
DP_TIMEOUT = 600        # seconds a rank may take


def dp_config(name, batch, impl):
    cfg = load_config(name)
    cfg.training.batch_size = batch
    cfg.model.convlstm_impl = impl
    cfg.validate(training=True)
    return cfg


def dp_setup(seed, runs=DP_RUNS):
    """name -> what a rank needs to run runs[name]: the seeded initial
    state dicts, the global batches and draws (numpy), and the K1 and K6
    counts a step each rank must show (K1 without z, K1 with z, K6: one a
    cell step of the backward; then the cells' weight-gradient convolutions,
    one a cell)."""
    setup = {}
    for name, batch, impl, tf_prob, cuts in runs:
        cfg = dp_config(name, batch, impl)
        mc = cfg.model
        entry = dict(name=name, batch=batch, impl=impl, cuts=cuts)
        if mc.family == "generator":
            ds = SyntheticDownscalingDataset(**GEN_DATA)
            entry["lu_channels"] = lu_c = ds.num_lu_classes
            entry["init"] = {"model": flax_to_state_dict(
                generator_params(cfg, lu_c, seed))}
            batches = []
            for bt in itertools.islice(batch_iterator(ds, batch), DP_STEPS):
                sv = bt[4].copy()                          # [B, T, N]
                sv[:batch // 2, :, 1:] = np.nan
                sv[batch // 2:, 0] = np.nan
                batches.append(tuple(bt[:4]) + (sv,))
            entry["draws"] = [None] * DP_STEPS
            per_pass = mc.T * len(mc.hidden_dims)
            k1 = impl == "pallas"
            entry["expect"] = (0, per_pass * k1, per_pass * k1,
                               len(mc.hidden_dims) * k1)
        else:
            size = cfg.data.synthetic_image_size
            scan = mc.input_frames + mc.output_frames - 1
            entry["init"] = {"model": flax_to_state_dict(
                nowcast_params(cfg, seed))}
            if mc.family == "gan":
                entry["init"]["disc"] = flax_to_state_dict(
                    disc_params(cfg, seed + 1))
            ds = SyntheticSequenceDataset(DP_STEPS * batch, mc.input_frames,
                                          mc.output_frames, size, seed=seed)
            batches = list(batch_iterator(ds, batch))
            gen = torch.Generator().manual_seed(seed)
            entry["draws"] = [
                (torch.rand((scan, batch), generator=gen) < tf_prob).numpy()
                if tf_prob > 0 else None for _ in batches]
            per_pass = len(mc.hidden_dims) * scan
            k1 = impl == "pallas"
            detached = (mc.family == "gan"
                        and cfg.training.gan_step_impl == "default")
            entry["expect"] = (per_pass * (k1 and detached),
                               per_pass * k1, per_pass * k1,
                               len(mc.hidden_dims) * k1)
        entry["batches"] = batches
        entry["dtype"] = cfg.precision.compute_dtype
        entry["graph_steps"] = mc.family == "forecaster"
        setup[name] = entry
    return setup


def dp_parts(entry, group):
    """(modules, step(batch, draws) -> metrics, grads(batch, draws) ->
    {"g" (G or the model), "d" (D): (the flat step-1 gradient, the norm of
    this process's own)}) of one DP run, on the card: the train steps bound
    to ``group`` (None: one process), as the trainers bind them. The
    gradient under a group is the mean over the ranks of each rank's
    gradient on its block (the DP step's reduction)."""
    from pl_convlstm_gan_tpu_torch.parallel.mesh import as_groups
    from pl_convlstm_gan_tpu_torch.train import steps as st_mod
    cfg = dp_config(entry["name"], entry["batch"], entry["impl"])
    tc = cfg.training
    lr, d_lr = tc.learning_rate, tc.disc_learning_rate or tc.learning_rate
    def reduce(gs):
        """(the flat gradient, mean over the ranks under a group, and the
        norm of this process's own)."""
        norm = float(torch.cat([g.flatten() for g in gs]).norm())
        if group is not None:
            gs = st_mod._reduced_grads(gs, as_groups(group),
                                       [False] * len(gs))
        return torch.cat([g.flatten() for g in gs]), norm
    if cfg.model.family == "gan":
        state = gan_state(cfg, entry["init"]["model"], entry["init"]["disc"])
        modules = [state.gen, state.disc]
        kw = dict(lambda_adv=tc.lambda_adv, lambda_l1=tc.lambda_l1,
                  label_smoothing=tc.label_smoothing)
        step = functools.partial(gan_train_step, impl=tc.gan_step_impl,
                                 group=group, **kw)

        def grads(batch, draws):
            g = gan_grads(state, cfg, batch, draws)
            return {k: reduce([g[k]]) for k in ("g", "d")}
        run = lambda batch, draws: step(state, batch, lr, d_lr, draws,
                                        grad_clip_norm=tc.grad_clip_norm)
        return modules, run, grads
    state = train_state(cfg, entry["init"]["model"],
                        entry.get("lu_channels", 0))
    modules = [state.model]
    params = list(state.model.parameters())
    if cfg.model.family == "generator":
        loss_cfg = loss_config(tc)
        step = functools.partial(generator_train_step, loss_cfg=loss_cfg,
                                 group=group)
        loss = lambda batch, draws: generator_loss(state.model, batch,
                                                   loss_cfg, group)[0]
        run = lambda batch, draws: step(state, batch, lr,
                                        grad_clip_norm=tc.grad_clip_norm)
    else:
        step = functools.partial(forecaster_train_step, group=group)
        loss = lambda batch, draws: forecaster_loss(state.model, *batch,
                                                    draws)[0]
        run = lambda batch, draws: step(state, batch, lr, draws,
                                        grad_clip_norm=tc.grad_clip_norm)

    def grads(batch, draws):
        return {"g": reduce(list(torch.autograd.grad(loss(batch, draws),
                                                     params)))}
    return modules, run, grads


def dp_drive(entry, group, rank=0, world=1):
    """One DP run on this process: rank ``rank``'s block of every global
    batch (the whole batch at world 1 without a group), the step-1
    gradient, then the steps, each between reset_counts() and a read of
    the counts. Returns the record: gradients, metrics, counts, times and
    the final params, on the CPU."""
    from pl_convlstm_gan_tpu_torch.data import _process_slice
    from pl_convlstm_gan_tpu_torch.parallel.mesh import broadcast_module
    rows = _process_slice(np.arange(entry["batch"]), rank, world)
    dev = torch.device(DEVICE)
    batches = [to_device(tuple(np.ascontiguousarray(a[rows]) for a in bt),
                         dev) for bt in entry["batches"]]
    draws = [None if d is None else torch.from_numpy(
        np.ascontiguousarray(d[:, rows])).to(dev) for d in entry["draws"]]
    modules, run, grads_fn = dp_parts(entry, group)
    broadcast_module(torch.nn.ModuleList(modules), group)
    reset_counts()
    got = grads_fn(batches[0], draws[0])
    grads = {k: g.cpu() for k, (g, _) in got.items()}
    grad_norms = {k: n for k, (_, n) in got.items()}
    metrics, counts, times, graphs = [], [], [], []
    for batch, d in zip(batches, draws):
        reset_counts()
        before = graph_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(run(batch, d))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(tuple(counted(kw)
                            for kw in ("k1", "k1z", "k6", "wg")))
        graphs.append(graph_delta(before))
    params = [p.detach().cpu() for m in modules for p in m.parameters()]
    return dict(grads=grads, grad_norms=grad_norms, metrics=metrics,
                counts=counts, step_ms=times, graphs=graphs, params=params)


def dp_worker(rank, world, port, work, backend, names):
    """A rank of the dp phase (``chip_smoke.py --dp-worker ...``): joins the
    process group through the port's bootstrap (torchrun's variables,
    ``backend``), drives each named run on its block and saves the records
    to ``<work>/<backend>_rank<rank>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank if backend == "nccl" else 0))
    import torch.distributed as dist
    from pl_convlstm_gan_tpu_torch.parallel.mesh import maybe_init_distributed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not maybe_init_distributed(backend=backend):
        raise RuntimeError("dp worker: no process group")
    if dist.get_backend() != backend or dist.get_world_size() != world:
        raise RuntimeError(f"dp worker: {dist.get_backend()} at world "
                           f"{dist.get_world_size()}")
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    out = {name: dp_drive(setup[name], dist.group.WORLD, rank, world)
           for name in names.split(",")}
    torch.save(out, os.path.join(work, f"{backend}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(flag, work, world, args, prefix, timeout):
    """Start ``world`` ranks of this script (``flag`` and its arguments:
    rank, world, port, work dir, then ``args``) as child processes, wait
    for them within ``timeout`` seconds each (killing every one on a
    timeout or a failure) and return their records
    (``<work>/<prefix>_rank<r>.pt``) and seconds."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    port = _free_port()
    cmd = [sys.executable, os.path.abspath(__file__), flag]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + [str(r), str(world), str(port), work,
                                     *args],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{flag} {prefix} rank {r} exit "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return ([torch.load(os.path.join(work, f"{prefix}_rank{r}.pt"),
                        weights_only=False) for r in range(world)],
            time.perf_counter() - t0)


def dp_launch(work, backend, world, names):
    """The dp phase's ranks (``--dp-worker``) over ``backend``."""
    return launch_ranks("--dp-worker", work, world,
                        [backend, ",".join(names)], backend, DP_TIMEOUT)


def dp_compare(name, entry, ranks, ref, label):
    """The ranks' records against the single-process record: params
    identical across the ranks, the same metrics on every rank, exact K1
    and K6 counts a step on every rank, and the DP run against one process:
    per-step losses and params after the steps within TRAIN_TOL, the
    step-1 gradients within dp_grad_tol."""
    dtype_name = entry["dtype"]
    for r, rec in enumerate(ranks):
        if rec["counts"] != [tuple(entry["expect"])] * len(rec["counts"]):
            raise AssertionError(f"dp {label} {name} rank {r}: launches "
                                 f"(K1 without z, K1 with z, K6, weight-"
                                 f"gradient convolutions) "
                                 f"{rec['counts']}, expected "
                                 f"{tuple(entry['expect'])} a step")
        if any(m["skipped"] for m in rec["metrics"]):
            raise AssertionError(f"dp {label} {name} rank {r} skipped")
        # the forecaster's steps replay its loss's graphs (the step-1
        # gradient was the eager warm-up); the GAN's and the Generator's
        # steps never call ConvLSTMForecaster.loss
        if entry["graph_steps"]:
            expect_graphs(f"dp {label} {name} rank {r}", rec["graphs"],
                          len(rec["graphs"]))
        elif any(any(g) for g in rec["graphs"]):
            raise AssertionError(f"dp {label} {name} rank {r}: loss graphs "
                                 f"{rec['graphs']}, expected none")
    for rec in ranks[1:]:
        if not all(torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                                     rec["params"])):
            raise AssertionError(f"dp {label} {name}: the ranks' params "
                                 f"differ")
        if rec["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"dp {label} {name}: the ranks' metrics "
                                 f"differ")
    got = ranks[0]
    keys = [k for k in ref["metrics"][0] if k != "skipped"]
    errs = {"loss": max(abs(a[k] - c[k]) for a, c in zip(
        got["metrics"], ref["metrics"]) for k in keys)}
    for k in ref["grads"]:
        errs[f"grad_{k}"] = float((got["grads"][k] - ref["grads"][k]).norm()
                                  / ref["grads"][k].norm())
    errs["param"] = max(float((a - c).abs().max())
                        for a, c in zip(got["params"], ref["params"]))
    tol = {k: TRAIN_TOL[k][dtype_name] for k in ("loss", "param")}
    for k in ref["grads"]:
        tol[f"grad_{k}"] = dp_grad_tol(
            dtype_name, [r["grad_norms"][k] for r in ranks],
            float(ref["grads"][k].norm()))
    for key, err in errs.items():
        if not (np.isfinite(err) and err <= tol[key]):
            raise AssertionError(f"dp {label} {name}: {key} error {err:.3e} "
                                 f"> {tol[key]}")
    return errs, tol


def phase_dp(seed):
    """DP_RUNS at world 2 over gloo on the one card, then DP_NCCL_RUN at
    world 1 over NCCL, each against one process's run on the whole global
    batch (see dp_compare). No scaling numbers: the two ranks share one
    card."""
    setup = dp_setup(seed)
    with tempfile.TemporaryDirectory() as work:
        torch.save(setup, os.path.join(work, "setup.pt"))
        refs = {}
        for name in setup:          # one process on the whole batch
            refs[name] = dp_drive(setup[name], None)
            torch.cuda.empty_cache()
        ranks, gloo_s = dp_launch(work, "gloo", DP_WORLD, list(setup))
        nccl_setup = dict(setup[DP_NCCL_RUN])
        nccl, nccl_s = dp_launch(work, "nccl", 1, [DP_NCCL_RUN])
    runs = {}
    for name, entry in setup.items():
        errs, tol = dp_compare(name, entry, [r[name] for r in ranks],
                               refs[name], "gloo")
        runs[name] = dict(
            dtype=entry["dtype"], global_batch=entry["batch"],
            per_rank_batch=entry["batch"] // DP_WORLD,
            convlstm_impl=entry["impl"], cuts=entry["cuts"] + [
                f"depth: {DP_STEPS} steps"],
            launches_per_step_per_rank={
                "convlstm_cell_fwd": entry["expect"][0],
                "convlstm_cell_fwd_save_z": entry["expect"][1],
                "cell_backward": K6_BY_PATH.setdefault(
                    f"dp_gloo_{name}_per_step_per_rank.{entry['dtype']}",
                    ranks[0][name]["counts"][0][2])},
            errors=errs, tol=tol,
            losses_dp=[{k: v for k, v in m.items() if k != "skipped"}
                       for m in ranks[0][name]["metrics"]],
            step_ms_rank0_shared_card=ranks[0][name]["step_ms"],
            step_ms_one_process=refs[name]["step_ms"],
            graphs_per_step=ranks[0][name]["graphs"])
        say(phase="dp_run", config=name, world=DP_WORLD, backend="gloo",
            **runs[name])
    errs, tol = dp_compare(DP_NCCL_RUN, nccl_setup, [nccl[0][DP_NCCL_RUN]],
                           refs[DP_NCCL_RUN], "nccl")
    K6_BY_PATH[f"dp_nccl_{DP_NCCL_RUN}_per_step.{nccl_setup['dtype']}"] = \
        nccl[0][DP_NCCL_RUN]["counts"][0][2]
    exact = all(torch.equal(a, b) for a, b in zip(
        nccl[0][DP_NCCL_RUN]["params"], refs[DP_NCCL_RUN]["params"]))
    rec = dict(world=DP_WORLD, backend="gloo", steps=DP_STEPS, runs=runs,
               gloo_seconds=gloo_s,
               nccl={"config": DP_NCCL_RUN, "world": 1, "errors": errs,
                     "tol": tol, "params_equal_one_process": exact,
                     "launches_per_step": nccl_setup["expect"],
                     "seconds": nccl_s},
               scaling="not measured: one card (the two gloo ranks share it)")
    say(phase="dp", **{k: v for k, v in rec.items() if k != "runs"})
    return rec


# The tp phase: tensor parallelism at world 2 (data 1 x model 2) on the one
# card, two ranks of this script (``--tp-worker``) in a gloo group (gloo
# carries CUDA tensors; NCCL refuses two ranks on one GPU), each holding
# half of every cell's channels, against one process's steps on the same
# global batch from the same canonical state. Each run: (label, config,
# compute dtype, global batch, teacher-forcing prob of the draws, cuts).
# Memory (PERF.md's TP finding): a rank keeps, a cell-step, the float32
# conv input (all of Cin + Ch, replicated) and its half of the gates'
# float32 residuals: ~14 KB a pixel-sample over the 3 x 256 cells against
# ~23 KB in one process, so 24 steps at B 8 would need ~45 GB a rank
# (90 GB for two on one card): the global batch is cut to 2 (~11 GB a
# rank, ~18 GB one process).
TP_RUNS = (
    ("tp_nowcast_128", "tp_nowcast_128", "bfloat16", 2, 0.5,
     ["training.batch_size 8 -> 2 (the global batch; two ranks share one "
      "card: PERF.md's memory reckoning)"]),
    ("tp_nowcast_128_f32", "tp_nowcast_128", "float32", 2, 0.0,
     ["precision.compute_dtype bfloat16 -> float32",
      "training.batch_size 8 -> 2"]),
    ("tp_gan_64", "gan_64", "float32", 8, 0.0,
     ["mesh.model_axis 1 -> 2 (gan_64's family, widths and default step "
      "under TP)"]),
)
TP_MODEL = 2            # the model axis of every TP run
TP_WORLD = 2            # the gloo phase: data 1 x model 2 on the one card
TP_STEPS = 2
# TP against one process on the same global batch. The TP path rounds to
# the compute dtype the values one process rounds: the forward's h' and c'
# from float32 z of the same sums (each rank computes its channels' whole
# sums; cuDNN may take another algorithm for 4Ch/2 output channels, so
# float32 orders differ), and the backward's gradient of the conv input
# after the model group's float32 sum of the ranks' partial gradients
# (copy_in sits on the float32 conv input), rounded once, as one process
# rounds its whole sum. These are two paths that round the same values, so
# TRAIN_TOL holds for the losses. With a data axis of 1 nothing is rounded
# from other values (dp_grad_tol's term is 0). Adam's moments after step 1
# are the clipped step-1 gradient g (mu = 0.1 g, nu = 0.001 g^2): float32
# within 1e-5 of each tensor's largest magnitude; bfloat16 in norm over all
# of a model's moments: mu within TRAIN_TOL's bfloat16 gradient bound
# (1e-3) plus the clip's scale (its norm's relative error is at most that
# bound too), 2e-3; nu twice that (a square doubles a relative error),
# 4e-3.
TP_MOMENT_TOL = {"float32": {"exp_avg": 1e-5, "exp_avg_sq": 1e-5},
                 "bfloat16": {"exp_avg": 2 * TRAIN_TOL["grad"]["bfloat16"],
                              "exp_avg_sq": 4 * TRAIN_TOL["grad"]["bfloat16"]}}
# The params after the steps, held by their move from the canonical init:
# ||(p_tp - p0) - (p_one - p0)|| / ||p_one - p0|| over all of a model's
# params. The unchanged init reads 1, a run that skips its last update
# about 1/2 (two Adam steps of about lr each), one that applies it with the
# wrong sign about 1. Adam moves an element by about lr a step whatever its
# gradient's size (m_hat / sqrt(v_hat) ~ +-1), so an element whose gradient
# lies within the gradient error of 0 may move the other way: 2 lr apart.
# With a relative gradient error e in norm, such elements are a share of
# about e / pi of a normally distributed gradient (at most e), so the
# update's error in norm is at most 2 sqrt(e) of the update: e is
# TP_MOMENT_TOL's mu bound (float32 1e-5 -> 6.3e-3; bfloat16 2e-3 ->
# 8.9e-2). A bound per element (of its tensor's largest magnitude) cannot
# hold in float32: Adam divides each element's gradient error by the
# gradient, and an element whose gradient is 1e-3 of its tensor's largest
# carries 1e3 times the relative error into its update (the record's
# worst_param_element: the farthest element and its gradient's share).
TP_PARAM_TOL = {d: 2 * float(np.sqrt(t["exp_avg"]))
                for d, t in TP_MOMENT_TOL.items()}
# the trainer round trip under TP: tp_nowcast_128 cut to 8 sequences (5 to
# train: 2 steps of the global batch 2), one epoch; then one process serves
# its canonical best_model
TP_TRAINER = dict(sequences=8, epochs=1, batch=2)
TP_TIMEOUT = 900        # seconds a rank may take


def tp_config(name, dtype_name, batch):
    cfg = load_config(name)
    cfg.precision.compute_dtype = dtype_name
    cfg.training.batch_size = batch
    cfg.mesh.model_axis = TP_MODEL
    cfg.validate(training=True)
    return cfg


def tp_expected_collectives(cfg, data=1):
    """Per train step of cfg at ``data`` x TP_MODEL: the forward
    all-gathers (one a cell and step; the GAN default step runs G twice),
    the backward's copy_in all-reduces (one a cell and step, less cell 0
    at step 0, whose input needs no gradient) and every all_reduce: those,
    the clip's norm over the model group and the replicated gradients'
    mean (the head; D's too), and with more than one data replica the
    finite-loss decision, the shards' gradient mean and the metrics (the
    GAN: D's decision too)."""
    mc = cfg.model
    per_pass = len(mc.hidden_dims) * (mc.input_frames + mc.output_frames - 1)
    gan = mc.family == "gan"
    twice = gan and cfg.training.gan_step_impl == "default"
    copies = per_pass - 1
    dp = data > 1
    reduces = copies + 2 + 3 * dp + ((1 + dp) if gan else 0)
    return dict(gather_h=per_pass * (2 if twice else 1), copy_in=copies,
                all_reduce=reduces)


def tp_setup(seed, runs=TP_RUNS, data=1):
    """label -> what a rank needs to run one of ``runs`` at ``data`` data
    replicas: the seeded canonical initial state dicts, the global batches
    and draws (numpy)."""
    setup = {}
    for label, name, dtype_name, batch, tf_prob, cuts in runs:
        cfg = tp_config(name, dtype_name, batch)
        mc = cfg.model
        size = cfg.data.synthetic_image_size
        scan = mc.input_frames + mc.output_frames - 1
        init = {"model": flax_to_state_dict(nowcast_params(cfg, seed))}
        if mc.family == "gan":
            init["disc"] = flax_to_state_dict(disc_params(cfg, seed + 1))
        ds = SyntheticSequenceDataset(TP_STEPS * batch, mc.input_frames,
                                      mc.output_frames, size, seed=seed)
        gen = torch.Generator().manual_seed(seed)
        batches = list(batch_iterator(ds, batch))
        setup[label] = dict(
            name=name, dtype=dtype_name, batch=batch, cuts=cuts, init=init,
            batches=batches, expect=tp_expected_collectives(cfg, data),
            draws=[(torch.rand((scan, batch), generator=gen) < tf_prob
                    ).numpy() if tf_prob > 0 else None for _ in batches])
    return setup


def tp_count_all_reduce():
    """Wrap torch.distributed.all_reduce (the port calls it through the
    module) to count its calls; returns the counter."""
    import torch.distributed as dist
    count = {"n": 0}
    inner = dist.all_reduce

    def all_reduce(*args, **kwargs):
        count["n"] += 1
        return inner(*args, **kwargs)
    dist.all_reduce = all_reduce
    return count


def tp_drive(entry, group, pos, count=None):
    """One TP run on this process: under ``group`` (MeshGroups) this rank's
    shards of the canonical state on its data replica's rows, else one
    process on the global batch; TP_STEPS steps, each between a snapshot
    of the counters and a read: K1 (without z, with z), the cells'
    all-gathers and all-reduces, every all_reduce (``count``); step ms;
    peak allocated memory. Returns, on the CPU: metrics, counts, times, the canonical
    Adam moments after step 1, the canonical params after the steps, and
    this rank's replicated params."""
    from pl_convlstm_gan_tpu_torch.parallel.tensor_parallel import (
        canonical_state_dict, is_cell_param, shard_state_dict)
    cfg = tp_config(entry["name"], entry["dtype"], entry["batch"])
    tc = cfg.training
    dev = torch.device(DEVICE)
    tp_group = None if group is None else group.model
    model = build_model(cfg, tp_group=tp_group)
    init = entry["init"]["model"]
    model.load_state_dict(init if group is None else shard_state_dict(
        init, pos.model_index, pos.model_count))
    model.to(dev).train()
    names = [n for n, _ in model.named_parameters()]
    lr, d_lr = tc.learning_rate, tc.disc_learning_rate or tc.learning_rate
    if cfg.model.family == "gan":
        disc = build_discriminator(cfg)
        disc.load_state_dict(entry["init"]["disc"])
        disc.to(dev).train()
        state = GANTrainState(model, disc, make_optimizer(model),
                              make_optimizer(disc))
        opts = {"g": state.gen_optimizer, "d": state.disc_optimizer}
        run = lambda b, d: gan_train_step(
            state, b, lr, d_lr, d, tc.lambda_adv, tc.lambda_l1,
            tc.label_smoothing, tc.grad_clip_norm, tc.gan_step_impl, group)
    else:
        state = TrainState(model, make_optimizer(model), 0)
        opts = {"g": state.optimizer}
        run = lambda b, d: forecaster_train_step(
            state, b, lr, d, tc.grad_clip_norm, group)

    def moments():
        out = {}
        for key, opt in opts.items():
            sd = opt.state_dict()
            if key == "g" and group is not None:
                sd = canonical_state_dict(sd, tp_group, names)
            out[key] = {i: {m: st[m].detach().to("cpu", copy=True)
                            for m in ("exp_avg", "exp_avg_sq")}
                        for i, st in sd["state"].items()}
        return out

    from pl_convlstm_gan_tpu_torch.data import _process_slice
    rows = np.arange(entry["batch"])
    if group is not None:
        rows = _process_slice(rows, pos.data_index, pos.data_count)
    batches = [to_device(tuple(np.ascontiguousarray(a[rows]) for a in bt),
                         dev) for bt in entry["batches"]]
    draws = [None if d is None else torch.from_numpy(
        np.ascontiguousarray(d[:, rows])).to(dev) for d in entry["draws"]]
    metrics, counts, times, peaks, first = [], [], [], [], None
    for i, (batch, d) in enumerate(zip(batches, draws)):
        reset_counts()
        if count is not None:
            count["n"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics.append(run(batch, d))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        counts.append(dict(
            convlstm_cell_fwd=counted("k1"),
            convlstm_cell_fwd_save_z=counted("k1z"),
            cell_backward=counted("k6"),
            gather_h=counted("gather_h.calls"),
            copy_in=counted("copy_in.calls"),
            all_reduce=None if count is None else count["n"]))
        if i == 0:
            first = moments()
    sd = model.state_dict()
    canonical = (sd if group is None
                 else canonical_state_dict(sd, tp_group))
    replicated = {k: v.cpu() for k, v in sd.items() if not is_cell_param(k)}
    params = {"g": {k: v.cpu() for k, v in canonical.items()}}
    if cfg.model.family == "gan":
        params["d"] = {k: v.cpu() for k, v in state.disc.state_dict().items()}
        replicated.update({f"disc.{k}": v for k, v in params["d"].items()})
    return dict(metrics=metrics, counts=counts, step_ms=times,
                peak_gb=max(peaks), moments_step1=first, params=params,
                replicated=replicated)


def tp_trainer_round_trip(work):
    """The TP trainer (every rank): tp_nowcast_128 cut to TP_TRAINER, one
    epoch, canonical checkpoints in ``<work>/tp_trainer``; then the trained
    TP model's prediction of one request (B 2, seed 0) under no_grad.
    Returns the prediction (CPU), the history and the seconds."""
    from pl_convlstm_gan_tpu_torch.train import SequenceTrainer
    cfg = load_config("tp_nowcast_128")
    cfg.data.synthetic_num_sequences = TP_TRAINER["sequences"]
    cfg.training.epochs = TP_TRAINER["epochs"]
    cfg.training.batch_size = TP_TRAINER["batch"]
    cfg.output.output_dir = os.path.join(work, "tp_trainer")
    cfg.validate(training=True)
    t0 = time.perf_counter()
    trainer = SequenceTrainer(config=cfg)
    history = trainer.train()
    seconds = time.perf_counter() - t0
    frames = torch.from_numpy(tp_request(cfg)).to(DEVICE)
    trainer.model.eval()
    with torch.no_grad():
        pred = trainer.model(frames)
    return dict(pred=pred.cpu(), history=history, seconds=seconds)


def tp_request(cfg):
    mc = cfg.model
    size = cfg.data.synthetic_image_size
    return np.random.default_rng(SEED).random(
        (TP_TRAINER["batch"], mc.input_frames, mc.in_channels, size, size),
        dtype=np.float32)


def tp_worker(rank, world, port, work, backend, labels):
    """A rank of the tp phases (``chip_smoke.py --tp-worker ...``): joins
    the process group through the port's bootstrap (torchrun's variables,
    ``backend``; NCCL: each rank on cuda:rank), cuts it into world /
    TP_MODEL data x TP_MODEL model with ``parallel.mesh.train_group``,
    checks that the kernel cell is refused under TP before any launch,
    drives the named runs of ``<work>/setup.pt`` (and, where ``labels``
    holds "trainer", the trainer round trip) and saves the records to
    ``<work>/<backend>_rank<rank>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank if backend == "nccl" else 0))
    import torch.distributed as dist
    from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
    from pl_convlstm_gan_tpu_torch.parallel.mesh import (
        maybe_init_distributed, mesh_position, train_group)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not maybe_init_distributed(backend=backend):
        raise RuntimeError("tp worker: no process group")
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    labels = labels.split(",")
    first = setup[next(k for k in labels if k != "trainer")]
    group = train_group(tp_config(first["name"], first["dtype"],
                                  first["batch"]), DEVICE)
    pos = mesh_position(TP_MODEL)
    if (dist.get_world_size(group.model), pos.data_count) != (
            TP_MODEL, world // TP_MODEL):
        raise RuntimeError(f"tp worker: layout {tuple(pos)}")
    reset_counts()
    try:
        ConvLSTMForecaster((256,), convlstm_impl="kernel",
                           tp_group=group.model)
        raise AssertionError("tp: the kernel cell was not refused under TP")
    except ValueError as e:
        refused = str(e)
    expect_counts("tp: kernel cell refused", 0, 0, 0)
    count = tp_count_all_reduce()
    out = {"position": tuple(pos), "refused": refused}
    for label in labels:
        if label == "trainer":
            out[label] = tp_trainer_round_trip(work)
        else:
            out[label] = tp_drive(setup[label], group, pos, count)
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(work, f"{backend}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_compare(label, entry, ranks, ref):
    """The ranks' records against the one-process record (see TP_RUNS,
    TP_MOMENT_TOL and TP_PARAM_TOL): exact counts a step on every rank (no
    K1, the collectives of tp_expected_collectives), no skipped step, the
    same metrics and canonical params on every rank, the replicated params
    bit for bit; then losses within TRAIN_TOL, the params after the steps
    within TP_PARAM_TOL (with the same measure of the unchanged init, which
    must exceed it) and Adam's moments after step 1 within TP_MOMENT_TOL
    (float32 only with more than one data replica: in bfloat16 each replica
    would round its block's gradient, dp_grad_tol's term). Returns the
    errors, the bounds, the init's readings, the element farthest from one
    process, and the failures (the caller raises after recording them)."""
    dtype_name = entry["dtype"]
    want = dict(convlstm_cell_fwd=0, convlstm_cell_fwd_save_z=0,
                cell_backward=0, **entry["expect"])
    for r, rec in enumerate(ranks):
        if rec["counts"] != [want] * TP_STEPS:
            raise AssertionError(f"tp {label} rank {r}: counts "
                                 f"{rec['counts']}, expected {want} a step")
        if any(m["skipped"] for m in rec["metrics"]):
            raise AssertionError(f"tp {label} rank {r} skipped")
    a = ranks[0]
    for b in ranks[1:]:
        if a["metrics"] != b["metrics"]:
            raise AssertionError(f"tp {label}: the ranks' metrics differ")
        for key in a["replicated"]:
            if not torch.equal(a["replicated"][key], b["replicated"][key]):
                raise AssertionError(f"tp {label}: replicated {key} "
                                     f"differs between the ranks")
        for side in a["params"]:
            for k, v in a["params"][side].items():
                if not torch.equal(v, b["params"][side][k]):
                    raise AssertionError(f"tp {label}: canonical {k} "
                                         f"differs between the ranks")
    if dtype_name != "float32" and len(ranks) > TP_MODEL:
        raise ValueError(f"tp {label}: bfloat16 with more than one data "
                         f"replica has no moment bound here")
    keys = [k for k in ref["metrics"][0] if k != "skipped"]
    errs = {"loss": max(abs(g[k] - w[k]) for g, w in zip(
        a["metrics"], ref["metrics"]) for k in keys)}
    tol = {"loss": TRAIN_TOL["loss"][dtype_name]}
    init_reads, worst = {}, {}
    starts = {"g": entry["init"]["model"], "d": entry["init"].get("disc")}
    for side, ref_p in ref["params"].items():
        p0 = starts[side]

        def move_err(got):
            d = torch.cat([(got[k] - p0[k]).flatten() for k in ref_p])
            w = torch.cat([(v - p0[k]).flatten() for k, v in ref_p.items()])
            return float((d - w).norm() / w.norm())

        errs[f"param_{side}"] = move_err(a["params"][side])
        init_reads[f"param_{side}"] = move_err(p0)
        tol[f"param_{side}"] = TP_PARAM_TOL[dtype_name]
        # the element farthest from one process, and its step-1 gradient
        # as a share of its tensor's largest (mu = 0.1 g)
        diff = {k: (a["params"][side][k] - v).abs().flatten()
                for k, v in ref_p.items()}
        k = max(diff, key=lambda k: float(diff[k].max()))
        j = int(diff[k].argmax())
        mu = ref["moments_step1"][side][list(ref_p).index(k)]["exp_avg"]
        mu = mu.flatten().abs()
        worst[side] = dict(tensor=k, abs_err=float(diff[k][j]),
                           tensor_max=float(ref_p[k].abs().max()),
                           grad_share=float(mu[j] / mu.max()))
    for side, got in a["moments_step1"].items():
        ref_m = ref["moments_step1"][side]
        for m in ("exp_avg", "exp_avg_sq"):
            g = [got[i][m] for i in sorted(ref_m)]
            w = [ref_m[i][m] for i in sorted(ref_m)]
            key = f"{m}_{side}"
            if dtype_name == "float32":      # per tensor, of its largest
                errs[key] = max(float((x - y).abs().max() / y.abs().max())
                                for x, y in zip(g, w))
            else:                            # in norm over the model
                gf = torch.cat([x.flatten() for x in g])
                wf = torch.cat([y.flatten() for y in w])
                errs[key] = float((gf - wf).norm() / wf.norm())
            tol[key] = TP_MOMENT_TOL[dtype_name][m]
    bad = [f"{key} error {err:.3e} > {tol[key]}" for key, err in errs.items()
           if not (np.isfinite(err) and err <= tol[key])]
    bad += [f"{key}: the unchanged init reads {v:.3e} <= {tol[key]}"
            for key, v in init_reads.items() if not v > tol[key]]
    return errs, tol, init_reads, worst, bad


def tp_serve_checkpoint(work):
    """One process serves the TP trainer's canonical best_model (in
    ``work``): (the request, the plain path's prediction, the kernel
    path's (K5 in bf16) and its exact launch counts)."""
    ckpt = os.path.join(work, "tp_trainer", "best_model")
    cfg = load_config("tp_nowcast_128")
    cfg.model.rollout_impl = "torch"
    plain = load_predictor(cfg, ckpt)
    kernel = load_predictor(load_config("tp_nowcast_128"), ckpt)  # auto
    frames = torch.from_numpy(tp_request(cfg)).cuda()
    want = plain(frames)
    reset_counts()
    served = kernel(frames)
    steps = cfg.model.input_frames + cfg.model.output_frames - 1
    launches = expect_rollout("tp trainer: served on the kernels",
                              cfg.precision.compute_dtype,
                              len(cfg.model.hidden_dims), steps,
                              cfg.model.output_frames,
                              path="tp_trainer_best_model_request."
                              + cfg.precision.compute_dtype)
    return want, served, launches


def tp_trainer_record(ranks, want, served, launches):
    """The trainer round trip's checks: the ranks' predictions bit-equal,
    the TP model's against one process serving its checkpoint (plain), and
    the kernel path (K5) against plain."""
    # PATH_TOL's bfloat16 atol is 4 ulps of outputs below MAX_OUTPUT; the
    # trained model's outputs may reach a higher binade, where 4 ulps are
    # 4 * 2^(e - 7) for outputs in [2^e, 2^(e+1))
    top = float(want.abs().max())
    atol = max(PATH_TOL["bfloat16"][0],
               4 * 2.0 ** (np.floor(np.log2(top)) - 7))
    rtol = PATH_TOL["bfloat16"][1]
    tr = ranks[0]["trainer"]
    if any(not torch.equal(tr["pred"], r["trainer"]["pred"])
           for r in ranks[1:]):
        raise AssertionError("tp trainer: the ranks' predictions differ")
    return dict(
        sequences=TP_TRAINER["sequences"], epochs=TP_TRAINER["epochs"],
        global_batch=TP_TRAINER["batch"], seconds=tr["seconds"],
        train_loss=tr["history"]["total_loss"],
        val_l1=tr["history"]["val_l1"],
        tp_vs_one_process_plain=check_close(
            "tp trainer: TP model against one process (plain)",
            tr["pred"], want.cpu(), atol, rtol),
        kernel_vs_plain=check_close(
            "tp trainer: one process on the kernels against plain", served,
            want, atol, rtol),
        served_launches=launches, max_abs_output=top, tol=[atol, rtol])


def phase_tp(seed, backend="gloo", runs=TP_RUNS, layouts=None):
    """``runs`` in each of ``layouts`` (world -> the labels it runs, "trainer"
    for the trainer round trip; default: every run and the trainer at
    TP_WORLD = data 1 x model 2) over ``backend``, each against one
    process's run on the same global batch (tp_compare). Over gloo the
    ranks share the one card (NCCL refuses two ranks on one GPU): no
    scaling numbers. Over NCCL (``--tp-nccl``) each rank has a GPU. The
    trainer round trip: the TP trainer's canonical best_model served by
    one process (load_predictor) on the plain path against the TP model's
    own prediction of the same request, and on the kernels (K5) against
    the plain path, with exact launch counts."""
    layouts = layouts or {TP_WORLD: (*[r[0] for r in runs], "trainer")}
    refs = {}
    for label, entry in tp_setup(seed, runs).items():   # one process
        refs[label] = tp_drive(entry, None, None)
        torch.cuda.empty_cache()
    rec = dict(backend=backend, steps=TP_STEPS, layouts={})
    failures = []
    for world, labels in layouts.items():
        data = world // TP_MODEL
        setup = tp_setup(seed, [r for r in runs if r[0] in labels], data)
        trainer = "trainer" in labels
        with tempfile.TemporaryDirectory() as work:
            torch.save(setup, os.path.join(work, "setup.pt"))
            ranks, seconds = launch_ranks(
                "--tp-worker", work, world,
                [backend, ",".join([*setup, *(["trainer"] * trainer)])],
                backend, TP_TIMEOUT)
            served = tp_serve_checkpoint(work) if trainer else None
        refused = {r["refused"] for r in ranks}
        if len(refused) != 1 or "tensor parallelism requires the plain " \
                "cell" not in ranks[0]["refused"]:
            raise AssertionError(f"tp: kernel cell refusal {refused}")
        out = dict(world=world, layout={"data": data, "model": TP_MODEL},
                   seconds=seconds, kernel_cell_refused=ranks[0]["refused"],
                   runs={})
        for label, entry in setup.items():
            errs, tol, init_reads, worst, bad = tp_compare(
                label, entry, [r[label] for r in ranks], refs[label])
            failures += [f"tp {label} at world {world}: {b}" for b in bad]
            run = dict(
                config=entry["name"], dtype=entry["dtype"],
                global_batch=entry["batch"], layout=out["layout"],
                cuts=entry["cuts"] + [f"depth: {TP_STEPS} steps"],
                collectives_per_step=entry["expect"],
                launches_per_step_per_rank={
                    "convlstm_cell_fwd": 0, "convlstm_cell_fwd_save_z": 0,
                    "cell_backward": ranks[0][label]["counts"][0][
                        "cell_backward"]},
                errors=errs, tol=tol, unchanged_init_reads=init_reads,
                worst_param_element=worst,
                peak_gb_per_rank=[r[label]["peak_gb"] for r in ranks],
                peak_gb_one_process=refs[label]["peak_gb"],
                step_ms_per_rank=[r[label]["step_ms"] for r in ranks],
                step_ms_one_process=refs[label]["step_ms"],
                scaling=("no scaling: one card" if backend == "gloo"
                         else f"{world} GPUs against one"))
            say(phase="tp_run", backend=backend, **run)
            out["runs"][label] = run
        if trainer:
            out["trainer"] = tp_trainer_record(ranks, *served)
        say(phase="tp", backend=backend,
            **{k: v for k, v in out.items() if k != "runs"})
        rec["layouts"][world] = out
    if failures:
        raise AssertionError("tp: " + "; ".join(failures))
    return rec


# TP over NCCL, one rank a GPU (``chip_smoke.py --tp-nccl``, on four GPUs;
# not part of the one-card run): phase_tp with these runs and layouts.
# tp_nowcast_128 at full width at the global batch 4 (one process on one
# card, the reference, holds ~42 GB at B 4; the config's 8 does not fit
# it), at data 1 x model 2 on two GPUs (bf16 as written, and f32) and at
# data 2 x model 2 on four (f32: in bf16 each data replica rounds its
# block's gradient, for which tp_compare has no moment bound), each against
# one process on cuda:0: TP's only scaling numbers.
TP_NCCL_RUNS = (
    ("tp_nowcast_128_b4", "tp_nowcast_128", "bfloat16", 4, 0.5,
     ["training.batch_size 8 -> 4 (the one-process reference fits one "
      "card)"]),
    ("tp_nowcast_128_f32_b4", "tp_nowcast_128", "float32", 4, 0.0,
     ["precision.compute_dtype bfloat16 -> float32",
      "training.batch_size 8 -> 4"]),
)
TP_NCCL_LAYOUTS = {2: ("tp_nowcast_128_b4", "tp_nowcast_128_f32_b4"),
                   4: ("tp_nowcast_128_f32_b4",)}


def tp_nccl_main() -> int:
    """``chip_smoke.py --tp-nccl``: phase_tp over NCCL on four GPUs, then
    each card's name and power limit, and the device line."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --tp-nccl: needs four CUDA devices",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    phase_tp(SEED, "nccl", TP_NCCL_RUNS, TP_NCCL_LAYOUTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# DP over NCCL at world 2 and 4, one rank a GPU (``chip_smoke.py --dp-nccl``,
# on four GPUs; not part of the one-card run): phase_dp's NCCL run
# (DP_NCCL_RUN at its global batch 4: 2 or 1 a rank), each against one
# process on cuda:0 on the whole batch (dp_compare).
DP_NCCL_WORLDS = (2, 4)


def dp_nccl_main() -> int:
    """``chip_smoke.py --dp-nccl``: the runs above, then each card's name
    and power limit, and the device line."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --dp-nccl: needs four CUDA devices",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    setup = dp_setup(SEED, [r for r in DP_RUNS if r[0] == DP_NCCL_RUN])
    entry = setup[DP_NCCL_RUN]
    ref = dp_drive(entry, None)
    torch.cuda.empty_cache()
    for world in DP_NCCL_WORLDS:
        with tempfile.TemporaryDirectory() as work:
            torch.save(setup, os.path.join(work, "setup.pt"))
            ranks, seconds = dp_launch(work, "nccl", world, [DP_NCCL_RUN])
        ranks = [r[DP_NCCL_RUN] for r in ranks]
        errs, tol = dp_compare(DP_NCCL_RUN, entry, ranks, ref,
                               f"nccl world {world}")
        say(phase="dp_nccl", config=DP_NCCL_RUN, world=world,
            global_batch=entry["batch"],
            per_rank_batch=entry["batch"] // world, dtype=entry["dtype"],
            launches_per_step_per_rank=entry["expect"], errors=errs, tol=tol,
            params_equal_one_process=all(torch.equal(a, b) for a, b in zip(
                ranks[0]["params"], ref["params"])),
            step_ms_per_rank=[r["step_ms"] for r in ranks],
            step_ms_one_process=ref["step_ms"], seconds=seconds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def k5_entry(k5, paths, streams, exports, precip, fit, trainer, tp):
    """K5's record of the kernels line: launches per path, its error
    against the plain path (it equals the K1/K2 host loop bit for bit),
    and its times at the main path's call (a nowcast_128 request, B 4),
    with every call of the K5 phase beside them."""
    calls = k5["calls"]
    r = calls["request_b4"]
    count = lambda d: d["rollout_persistent_fwd"]
    by_path = {
        "predict": count(paths["bfloat16"]["launches"]),
        "stream": count(streams["bfloat16"]["launches"]),
        "export_predict": count(exports["bfloat16"]["predict"]["launches"]),
        "export_stream": count(exports["bfloat16"]["stream"]["launches"]),
        "precip_256_observe_window": count(precip["launches"]),
        "fit_nowcast_128_request": count(
            fit["nowcast_128_launches"]["bfloat16"]),
        "trainer_best_model_request": count(trainer["served_launches"]),
        "tp_trainer_best_model_request": count(
            tp["layouts"][TP_WORLD]["trainer"]["served_launches"]),
        **{f"k5_{name}": count(c["launches"]) for name, c in calls.items()}}
    keep = ("batch", "size", "steps", "heads", "ms", "host_loop_ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share",
            "max_abs_err", "grid")
    return dict(
        name="rollout_persistent_fwd", dtype="bfloat16", route="cuda",
        source=K5_SOURCE, replaces=K5_REPLACES, stands_for=K5_STANDS_FOR,
        launches=by_path["predict"], launches_by_path=by_path,
        max_abs_err=max(c["max_abs_err"] for c in calls.values()),
        equal_to_host_loop=all(c["equal_to_host_loop"]
                               for c in calls.values()),
        measured_at="request_b4: nowcast_128, B 4, 5 -> 20, bf16",
        ms=r["ms"], host_loop_ms=r["host_loop_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        conv2d_sum_ms=r["library_ms"],
        per_call={name: {k: c[k] for k in keep}
                  for name, c in calls.items()},
        slopes=k5["slopes"], profile_b1_forecast=k5["profile_b1_forecast"],
        ptxas=k5["ptxas"])


def kernel_entries(cell, head, paths, streams, n_cells, cell_z, trains,
                   trainer, gans, gan_trainer, gens, gen_trainer, taps,
                   remat, dp, tp, exports, int8, k5, precip, fit, cell_bwd,
                   k7, predrnn):
    """The {"kernels": [...]} records, one per kernel (K1 with z as its own
    entry) and compute dtype, then K3 and K4. K1's times and bound are per
    launch, averaged over one request's (or train step's) mix of cell shapes
    (cell 1: (1, 64); cells 2-3: (64, 64)); ``generator_mix`` averages the
    Generator's two cells ((16, 16), (16, 32)) alike. The GAN paths'
    launches are per step of each configuration and of the GAN trainer's
    run; the Generator's per request, per train step and of its trainer's
    run. The int8 stream (float32) launches K1/K2 in its observe only: its
    count covers the first request's observed frames and one int8
    forecast. In bfloat16 the rollouts run on K5 (its own entry): K1's and
    K2's bf16 ``launches`` are those of the host loop that a bf16 model K5
    refuses keeps (``host_loop_8ch_request``)."""
    entries = []
    int8_k1 = {"float32": {"int8_stream": int8["stream_launches"][
        "convlstm_cell_fwd"]}, "bfloat16": {}}
    int8_k2 = {"float32": {"int8_stream": int8["stream_launches"][
        "conv_head_fwd"]}, "bfloat16": {}}
    gan_k1 = {name: {} for name in paths}
    gan_k1z = {name: {} for name in paths}
    for g in gans:
        gan_k1[g["dtype"]][f"{g['config']}_step"] = \
            g["launches_per_step"]["convlstm_cell_fwd"]
        gan_k1z[g["dtype"]][f"{g['config']}_step"] = \
            g["launches_per_step"]["convlstm_cell_fwd_save_z"]
    gan_k1["float32"]["gan_trainer_train"] = \
        gan_trainer["train_launches"]["convlstm_cell_fwd"]
    gan_k1z["float32"]["gan_trainer_train"] = \
        gan_trainer["train_launches"]["convlstm_cell_fwd_save_z"]
    # the remat and dp phases: K1's launches a step (dp: on each rank)
    for label, r in remat["runs"].items():
        if r["convlstm_impl"] == "pallas":
            gan_k1z[remat["dtype"]][f"remat_gan_256_single_{label}_step"] = \
                r["launches_per_step"]["convlstm_cell_fwd_save_z"]
    for name, r in dp["runs"].items():
        n = r["launches_per_step_per_rank"]
        if n["convlstm_cell_fwd"]:
            gan_k1[r["dtype"]][f"dp_{name}_step_per_rank"] = \
                n["convlstm_cell_fwd"]
        if n["convlstm_cell_fwd_save_z"]:
            gan_k1z[r["dtype"]][f"dp_{name}_step_per_rank"] = \
                n["convlstm_cell_fwd_save_z"]
    nccl = dp["nccl"]
    gan_k1z[dp["runs"][nccl["config"]]["dtype"]][
        f"dp_nccl_{nccl['config']}_step"] = nccl["launches_per_step"][1]
    # the tp phase: K1 is refused under TP (the plain cell), 0 a step
    for label, r in tp["layouts"][TP_WORLD]["runs"].items():
        n = r["launches_per_step_per_rank"]
        K6_BY_PATH[f"tp_{label}_step_per_rank.{r['dtype']}"] = \
            n["cell_backward"]
        gan_k1[r["dtype"]][f"{label}_step_per_rank"] = n["convlstm_cell_fwd"]
        gan_k1z[r["dtype"]][f"{label}_step_per_rank"] = \
            n["convlstm_cell_fwd_save_z"]
    weights = [1, n_cells - 1]

    def gen_mix(recs):
        g = [r for r in recs if r["generator"]]
        return {key: statistics.mean(r[key] for r in g) for key in
                ("ms", "plain_ms", "bound_ms", "library_ms")}
    host8 = k5["host_loop_8ch"]["launches"]
    for name, path in paths.items():
        c_recs = [r for r in cell[name] if r["mix"]]
        mix = lambda key: sum(w * r[key] for w, r in zip(weights, c_recs)) / sum(weights)
        bf16 = name == "bfloat16"
        entries.append(dict(
            name="convlstm_cell_fwd", dtype=name, route="cuda", source=K1_SOURCE,
            replaces=K1_REPLACES, stands_for=K1_STANDS_FOR,
            launches=(host8 if bf16 else path["launches"])[
                "convlstm_cell_fwd"],
            launches_by_path={
                "predict": path["launches"]["convlstm_cell_fwd"],
                "stream": streams[name]["launches"]["convlstm_cell_fwd"],
                "export_predict": exports[name]["predict"]["launches"][
                    "convlstm_cell_fwd"],
                "export_stream": exports[name]["stream"]["launches"][
                    "convlstm_cell_fwd"],
                "train_eval_batch": trains[name]["launches_eval_batch"],
                **gan_k1[name],
                "generator_request": gens[name]["launches_per_request"][
                    "convlstm_cell_fwd"],
                "generator_eval_batch": gens[name]["launches_eval_batch"],
                **int8_k1[name],
                **({"host_loop_8ch_request": host8["convlstm_cell_fwd"]}
                   if bf16 else {})},
            max_abs_err=max(r["max_abs_err"] for r in cell[name]),
            ms=mix("ms"), plain_ms=mix("plain_ms"), bound_ms=mix("bound_ms"),
            bound_by=c_recs[0]["bound_by"], library_ms=mix("library_ms"),
            generator_mix=gen_mix(cell[name]),
            per_shape=[r for r in cell[name] if "ms" in r]))
        z_recs = [r for r in cell_z[name] if r["mix"]]
        zmix = lambda key: sum(w * r[key] for w, r in zip(weights, z_recs)) / sum(weights)
        by_path = {"train": trains[name]["launches_train"],
                   "train_per_step": trains[name]["launches_per_step"][
                       "convlstm_cell_fwd_save_z"]}
        if name == "bfloat16":
            by_path["trainer"] = trainer["train_launches_z"]
        by_path.update(gan_k1z[name])
        by_path["generator_train_step"] = gens[name]["launches_per_step"][
            "convlstm_cell_fwd_save_z"]
        if name == "float32":
            by_path["generator_trainer_train"] = gen_trainer["train_launches_z"]
        entries.append(dict(
            name="convlstm_cell_fwd", variant="save_z", dtype=name, route="cuda",
            source=K1_SOURCE, replaces=K1_REPLACES, stands_for=K1Z_STANDS_FOR,
            launches=trains[name]["launches_train"], launches_by_path=by_path,
            max_abs_err=max(max(r["max_abs_err"], r["max_abs_err_z"])
                            for r in cell_z[name]),
            ms=zmix("ms"), ms_without_z=zmix("ms_no_z"),
            plain_ms=zmix("plain_ms"), bound_ms=zmix("bound_ms"),
            # the bound of the shape of two of the three cells, (64, 64)
            bound_by=z_recs[-1]["bound_by"], library_ms=zmix("library_ms"),
            grad_rel_err=cell_z[name + "_grad"],
            generator_mix=gen_mix(cell_z[name]),
            per_shape=[r for r in cell_z[name] if "ms" in r]))
        h = [r for r in head[name] if "ms" in r][0]
        entries.append(dict(
            name="conv_head_fwd", dtype=name, route="cuda", source=K2_SOURCE,
            replaces=K2_REPLACES, stands_for=K2_STANDS_FOR,
            launches=(host8 if bf16 else path["launches"])["conv_head_fwd"],
            launches_by_path={
                "predict": path["launches"]["conv_head_fwd"],
                "stream": streams[name]["launches"]["conv_head_fwd"],
                "export_predict": exports[name]["predict"]["launches"][
                    "conv_head_fwd"],
                "export_stream": exports[name]["stream"]["launches"][
                    "conv_head_fwd"], **int8_k2[name],
                **({"host_loop_8ch_request": host8["conv_head_fwd"]}
                   if bf16 else {})},
            max_abs_err=max(r["max_abs_err"] for r in head[name]),
            ms=h["ms"], graph_ms=h["graph_ms"], plain_ms=h["plain_ms"],
            bound_ms=h["bound_ms"], bound_by=h["bound_by"],
            library_ms=h["library_ms"],
            library_graph_ms=h["library_graph_ms"],
            per_shape=[r for r in head[name] if "ms" in r]))
    entries.append(k5_entry(k5, paths, streams, exports, precip, fit, trainer,
                            tp))
    # K6 by dtype: bf16 timed at the nowcast train step's mix of cells
    # (cell 1: Cx 1; cells 2-3: Cx 64), float32 at the Generator's two cells
    # (one launch each a time step); launches as expect_counts read them
    for name in ("bfloat16", "float32"):
        timed = [r for r in cell_bwd if "ms" in r and r["dtype"] == name]
        wts = weights if name == "bfloat16" else [1] * len(timed)
        kmix = lambda key: sum(w * r[key] for w, r in zip(wts, timed)) / sum(wts)
        per_step = ("train_per_step" if name == "bfloat16"
                    else "generator_train_step")
        entries.append(dict(
            name="cell_backward", dtype=name, route="cuda", source=K6_SOURCE,
            replaces=K6_REPLACES, stands_for=[K6_REPLACES],
            measured_at=("nowcast_128 train step cells, B 4, 128^2"
                         if name == "bfloat16" else
                         "the Generator's cells (16, 16), (16, 32), B 8, 16^2"),
            launches=K6_BY_PATH[f"{per_step}.{name}"],
            launches_by_path={p.rsplit(".", 1)[0]: n
                              for p, n in K6_BY_PATH.items()
                              if p.rsplit(".", 1)[1] == name},
            err_over_tol=max(max(r["err_over_tol"].values())
                             for r in cell_bwd if r["dtype"] == name),
            ms=kmix("ms"), plain_ms=kmix("plain_ms"),
            bound_ms=kmix("bound_ms"), bound_by=timed[0]["bound_by"],
            library_ms=None, host_us=kmix("host_us"),
            wrapper_host_us=kmix("wrapper_host_us"),
            plain_host_us=kmix("plain_host_us"),
            per_shape=[r for r in cell_bwd if r["dtype"] == name]))
    for r in k7:
        if "a_fwd" not in r:
            continue
        passes = {k: r[k] for k in ("a_fwd", "b_fwd", "a_bwd", "b_bwd")}
        bf16 = r["dtype"] == "bfloat16"
        entries.append(dict(
            name="st_gates", dtype=r["dtype"], route="cuda", source=K7_SOURCE,
            replaces=K7_REPLACES,
            launches=predrnn["k7_per_step"] if bf16 else 0,
            launches_by_path={"predrnn_train_step": predrnn["k7_per_step"],
                              "predrnn_request": predrnn["k7_per_request"]}
            if bf16 else {}, err_over_tol=r["err_over_tol"],
            ms=sum(p["ms"] for p in passes.values()),
            plain_ms=sum(p["plain_ms"] for p in passes.values()),
            bound_ms=sum(p["bound_ms"] for p in passes.values()),
            bound_by="bytes", library_ms=None, per_pass=passes))
    for name, source, replaces, stands_for in (
            ("tap_loop", K3_SOURCE, K3_REPLACES, K3_STANDS_FOR),
            ("tap_k1152", K4_SOURCE, K4_REPLACES, K4_STANDS_FOR)):
        t = taps[name]
        entries.append(dict(
            name=name, dtype="bfloat16", route="cuda", source=source,
            replaces=replaces, stands_for=stands_for, launches=t["launches"],
            launches_by_path={"tap_structure_experiment": t["launches"]},
            max_abs_err=t["max_abs_err"], max_rel_err=t["max_rel_err"],
            ms=t["ms"], graph_ms=t["graph_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], tflops=t["tflops"],
            slope_tflops=t["slope_tflops"], sm_share=t["sm_share"]))
    return entries


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:      # a rank of the dp phase
        rank, world, port, work, backend, names = sys.argv[2:8]
        return dp_worker(int(rank), int(world), int(port), work, backend,
                         names)
    if sys.argv[1:2] == ["--tp-worker"]:      # a rank of the tp phases
        rank, world, port, work, backend, labels = sys.argv[2:8]
        return tp_worker(int(rank), int(world), int(port), work, backend,
                         labels)
    if sys.argv[1:2] == ["--tp-nccl"]:        # TP over NCCL on 4 GPUs
        return tp_nccl_main()
    if sys.argv[1:2] == ["--dp-nccl"]:        # DP over NCCL on 4 GPUs
        return dp_nccl_main()
    if sys.argv[1:2] == ["--export-worker"]:  # the export phase's server
        return export_worker(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    # float32 references in full float32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import importlib.util
    say(phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        optional={m: importlib.util.find_spec(m) is not None
                  for m in ("matplotlib", "grain", "pandas")})

    ptxas = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtypes = (torch.float32, torch.bfloat16)
    cfg = load_config("nowcast_128")
    b, size = cfg.training.batch_size, 128
    hidden = cfg.model.hidden_dims
    nowcast = [(cfg.model.in_channels, hidden[0]), (hidden[0], hidden[1])]
    ragged = (2, 13, 21, 3, 40, 5, None)                   # odd H/W, Ch 40, K=5
    gan = load_config("gan_64")
    gan_b, gan_size = gan.training.batch_size, gan.data.synthetic_image_size
    gan_cells = [(gan.model.in_channels, gan.model.hidden_dims[0]),
                 (gan.model.hidden_dims[0], gan.model.hidden_dims[1])]
    # the Generator's cells (configs/default.yaml): (16, 16) and (16, 32),
    # B 8 at 16^2; in bf16 one N-block whose 256 GEMM columns hold 64 or
    # 128 real ones, in f32 4Ch padded to 128 columns at Ch 16
    gdef = load_config("default")
    gh = gdef.model.hidden_dims
    gen_cells = [(gdef.training.batch_size, gdef.data.synthetic_image_size,
                  gdef.data.synthetic_image_size, cx, ch, 3, "generator")
                 for cx, ch in ((gh[0], gh[0]), (gh[0], gh[1]))]
    cell_shapes = {
        # f32 adds B 1 (a stream's forecast) and gan_64's cells (B 8, 64^2)
        torch.float32: [(b, size, size, cx, ch, 3, "mix") for cx, ch in nowcast]
        + [(1, size, size, cx, ch, 3, "timed") for cx, ch in nowcast]
        + [(gan_b, gan_size, gan_size, cx, ch, 3, "timed")
           for cx, ch in gan_cells]
        + [ragged] + gen_cells,
        # bf16 adds B 1 (a stream's forecast) and (256, 256) at 64^2
        # (tp_nowcast_128's width: four N-blocks)
        torch.bfloat16: [(b, size, size, cx, ch, 3, "mix") for cx, ch in nowcast]
        + [(1, size, size, cx, ch, 3, "timed") for cx, ch in nowcast]
        + [ragged, (b, 64, 64, 256, 256, 3, "timed")] + gen_cells}
    head_shapes = [(b, size, size, hidden[-1], cfg.model.in_channels, 3, True),
                   (1, size, size, hidden[-1], cfg.model.in_channels, 3, True),
                   (2, 13, 21, 40, 5, 3, True)]            # ragged, Cout=5
    cell = phase_cell(gen, cell_shapes)
    head = phase_head(gen, head_shapes, dtypes)
    cell_z = phase_cell_save_z(gen, cell_shapes,
                               (b, size, size, hidden[0], hidden[1], 3))
    # K6 at the nowcast cells and the Generator's (timed) and a scalar Ch
    cell_bwd = phase_cell_backward(
        gen, [(b, size, size, cx, ch, torch.bfloat16, True)
              for cx, ch in nowcast]
        + [(bb, hh, ww, cx, ch, torch.float32, True)
           for bb, hh, ww, cx, ch, _, _ in gen_cells]
        + [(2, 13, 21, 3, 20, torch.float32, False)])
    # K7 at PredRNN-V2's KTH width (B 8 x 32^2 pixels, F 128) and a scalar F
    k7 = phase_st_gates(gen, [(PREDRNN_B * 32 * 32, 128, torch.bfloat16, True),
                              (PREDRNN_B * 32 * 32, 128, torch.float32, True),
                              (2 * 13 * 21, 12, torch.bfloat16, False)])

    rng = np.random.default_rng(SEED)
    requests = [torch.from_numpy(rng.random(
        (b, cfg.model.input_frames, cfg.model.in_channels, size, size),
        dtype=np.float32)).cuda() for _ in range(N_REQUESTS)]
    frames8 = torch.from_numpy(rng.random(
        (max(STREAM_BATCHES), cfg.model.input_frames, cfg.model.in_channels,
         size, size), dtype=np.float32)).cuda()
    paths, streams = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        k5 = phase_rollout_persistent(tmp, requests, frames8, SEED, ptxas)
        ckpt = write_checkpoint(os.path.join(tmp, "nowcast_128_seed.npz"),
                                cfg, SEED)
        for dtype_name in ("float32", "bfloat16"):
            paths[dtype_name], predict = phase_main_path(ckpt, dtype_name,
                                                         requests)
        profile_request(predict, requests[0])
        for dtype_name in ("float32", "bfloat16"):
            streams[dtype_name], sf, warm_b1 = phase_stream(
                ckpt, dtype_name, requests[0], frames8)
        profile_request(lambda st: sf.forecast(st, STREAM_HORIZON), warm_b1,
                        phase="stream_profile")
        exports = phase_export(tmp, requests, frames8, SEED)
        precip = phase_precip_256(tmp, SEED)
        fit = phase_fit(tmp, SEED)
        int8, int8_predict = phase_int8(ckpt, requests, frames8)
        phase_profiling(tmp, int8_predict, requests[0], SEED)
        del int8_predict
        trains = {dtype_name: phase_train(dtype_name, SEED)
                  for dtype_name in ("bfloat16", "float32")}
        predrnn = phase_predrnn(tmp, SEED)
        trainer = phase_trainer(tmp, requests[0])
        gans = [phase_gan(*run, seed=SEED) for run in GAN_RUNS]
        gan_trainer = phase_gan_trainer(tmp, SEED)
        gens = {dtype_name: phase_generator(tmp, dtype_name, SEED)
                for dtype_name in ("float32", "bfloat16")}
        gen_trainer = phase_generator_trainer(tmp, SEED)
    remat = phase_remat(SEED)
    dp = phase_dp(SEED)
    tp = phase_tp(SEED)
    taps = phase_tap_structure()

    print(json.dumps({"kernels": kernel_entries(
        cell, head, paths, streams, len(hidden), cell_z, trains, trainer,
        gans, gan_trainer, gens, gen_trainer, taps, remat, dp, tp,
        exports, int8, k5, precip, fit, cell_bwd, k7, predrnn)}),
        flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
