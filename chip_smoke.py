#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`audiodepth_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the script exits
non-zero:
  env        torch / CUDA versions, the card's name, power limit, SMs and
             maximum SM clock;
  build      compile every CUDA kernel of the port from `csrc/` (nvcc, one
             process per source, all started together), its seconds,
             ptxas's registers and spills per kernel (no instantiation but
             those of KNOWN_SPILLS may spill), and the count of
             HGMMA (wgmma) and HMMA (mma.sync) instructions per kernel in
             `cuobjdump -sass` of the built libraries (B1 must have HMMA,
             B2 and B3 HGMMA, every float32 three-piece instantiation
             too);
  layout_probe  the q/k operand layouts of B2 and B3 alone, at each dkp
             (16, 32, 64, 128 and 128 part filled): S = Q·Kᵀ and the two
             MN-major products of B3 against torch.matmul in float64;
  kernel     each kernel against its plain PyTorch version on the card at
             the shapes its path gives it, max |Δ| asserted, and its time,
             the plain version's time, the card's bound for the same work
             and, where one PyTorch call computes the same function, that
             call's time: B1 (the mel front end: noise at B·C 2, 8, 32 and
             a short L, the train path's synthetic echoes as a strided
             view, clean chirps against float64; each row naming its plan),
             B2 (flash cross-attention forward) and B3 (its backward), each
             at the four binaural level shapes of a batch of 16, level 2 of
             a batch of 1, float32 (level 3 at a batch of 1, levels 2-5
             at the training batch of 16; bound: six bf16 passes on the
             tensor cores, the CUDA cores' fp32 time beside it), and
             ragged shapes that reach every branch of the plan
             (`fwd_plan` / `bwd_plan`: dk 8 and 40
             padded, dv 136 and 320, N and M not multiples of 64, N = 1),
             the level shapes of base 16 and 128 and dk 12 and dv 768 in
             bf16 and f32 (the widths the wrapper zero-pads, dkp 128, B3's
             split design), each row naming the plan it ran; B1 also at
             B·C = 2, L = 100,000 (its two-pass form: each B1 row asserts
             the form its call took and its launches, 1 or 2);
  autograd   `cross_attention` gradients through FlashCrossAttentionFn
             (B2 forward, B3 backward) against autograd of the blockwise
             plain path on the card, level 3 in bf16, level 2 in f32;
  kernel_bn  the BatchNorm pair (`audiodepth::batch_norm_train_fwd` /
             `_bwd`, csrc/batch_norm.cu) at every BatchNorm shape of the
             benchmark's two train cells (BN_ROWS; the binaural ones with
             the ReLU epilogue) against its plain version: y, dx, the
             statistics, dγ, dβ and the folded buffers, two runs bit-equal;
             forward and backward times against the bytes bound (4 and 6 B
             an element), the plain version's and `F.batch_norm` between
             its casts (library); the build phase reports its ptxas
             registers and spills with the others'. Every bf16 train phase
             below counts the pair's launches against BN_PER_TRAIN_STEP
             (none in eval, serving, float32 or a data or model group);
  kernel_sb  AdaBins' soft-binning pair (`audiodepth::soft_binning_fwd` /
             `_bwd`, csrc/soft_binning.cu) at the AdaBins cell's class-head
             logits [64, 128, 256, 256] and a small ragged shape (SB_ROWS)
             against its plain version (the model's own chain): base and
             the logits' spatial mean within SB_REL_TOL of their scales,
             grad_logits within one bf16 ulp, grad_centers within
             SB_REL_TOL of Σ|g·p|, two runs bit-equal; the device memory a
             forward and backward through autograd takes beside its inputs
             (less than one fp32 copy of the logits: no fp32 tensor of
             their shape exists on the path); forward and backward times
             against the bytes bound (2 and 4 B an element), the plain
             version's, and today's PyTorch chain through autograd
             (library). Every bf16 AdaBins phase below counts the pair's
             launches (`sb_launches`: two forwards and a backward a train
             step, one forward an eval or served batch; none elsewhere);
  serve      the unet path: unet_256 / ngf 64 / 256² / bf16, random init
             from seed 0, batch ladder 1,4,16, the port's HTTP server
             in-process, 16 warm-up requests, then a 48-request loadtest
             at concurrency 8; every answer checked, one served answer
             compared with a direct run, and each kernel's launch count
             compared with what the path runs per device batch (B1 once,
             B2 never);
  serve      the binaural path: binaural_attention / base 64 / levels
             2,3,4,5 / bf16, random init from seed 0 with every γ then set
             to a seeded non-zero value (γ is zero at init, which would make
             the answer independent of the attention); the same loadtest and
             checks, B1 once and B2 four times per device batch, and the
             answer must change when γ is set back to zero;
  profile    host wall and device time of one served batch (sizes 1, 16)
             for each path, and B2's share of the binaural device time;
  f32_vs_cpu each model seeded in float32 (TF32 off) through
             `predict_meters` on the card and on the CPU;
  train      the training path: `cli/train.py`'s main in-process, the
             binaural net at base 64, levels 2-5, 256², bf16, remat on,
             batch 16, 64 synthetic samples (4 steps) and one validation
             pass of 64, with every γ set non-zero after init; every loss
             and grad_norm finite, every parameter moved, every attention
             projection's first-step gradient non-zero, and the launches
             per train step (B1 1, B2 4, B3 4) and per eval batch and per
             detector forward (one a validated epoch; B1 1, B2 4, B3 0);
             then 8 steps on one repeated batch, whose last
             loss must be below its first, timed step by step;
  f32_train_vs_cpu  one seeded float32 train step (TF32 off) at full
             width, 256², batch 2, γ non-zero, on the card and on the CPU
             from one state_dict, and in float64 on the CPU: the losses,
             and the card's gradients as close to the float64 ones as the
             CPU's float32 gradients are;
  train_f32  the training path in float32 (`--compute_dtype float32`):
             `cli/train.py`'s main in-process, the binaural net at base 64,
             levels 2-5, 256², batch 16, γ non-zero, 2 steps (finite, every
             parameter moved, B1 1 / B2 4 / B3 4 a step, B2 and B3 on their
             three-piece variants, F32_VARIANTS_PER_STEP), then 5 timed
             steps on one batch (the loss must fall), peak memory and a
             profile of one;
  profile    one bf16 train step at batch 16: host wall, device time, busy
             share, top items, B2's and B3's shares;
  train_unet the main training path: `cli/train.py`'s main in-process,
             unet_baseline (unet_256, ngf 64, 54,408,833 params), 256²,
             bf16, batch 16, 64 synthetic samples (4 steps), one validation
             pass, checkpoints into a temporary directory; every loss and
             grad_norm finite, every parameter moved, val metrics finite,
             B1 launched once a step, once an eval batch and once for the
             detectors' forward, B2 and B3 never;
  ckpt_round_trip  `serve` restores that checkpoint (--checkpoint_path,
             --use_best) and answers HTTP requests within SERVED_TOL of the
             trained task's own answers; `--resume` takes one more step;
  train_unet_steps  8 steps on one repeated batch of 16 (the loss must
             fall), timed, a profile of one (B1's share), then one timed
             step at UNET_BIG_BATCH with its peak memory;
  f32_train_vs_cpu  the same rule for one float32 unet step at full width;
  train_width  one bf16 binaural train step at base 16 and at base 128
             (widths dk 4 and dk 128 / dv 1024 that B2 and B3 refused
             before), B2 and B3 launched 4 times each;
  corpus     a fabricated BatVision V2 tree in a temporary directory (three
             locations, 64 / 16 / 16 rows, 16-bit 44.1 kHz stereo WAVs of
             9,000 samples, 480×640 depth .npy in mm with values below 0
             and above 30 m, 480×640 camera PNGs, a '__pycache__' and an
             'X_unzipped' directory);
             the native decoder's build seconds, one batch of 16 decoded by
             the native pool and by the Python decoder (bit-equal in the
             compact dtypes, each timed), and its copy to the card from
             pinned and from pageable memory, timed; which of pandas,
             OpenCV, matplotlib and scipy import on the machine;
  train_corpus  the main path from disk: `cli/train.py`'s main on that
             tree, unet_256 / ngf 64 / 256² / bf16 / batch 16, 2 epochs, one
             location held out, the JSONL log and checkpoints in the
             temporary directory; then the same with --device_cache. Every
             loss and grad_norm finite, every parameter moved, no held-out
             row in a train step or the val split, the holdout evaluated
             alone and logged, B1 once per step, per eval batch and per
             detector forward (B2 and B3 never), the batches the steps got
             on the card bit-equal to the host loader's (and, cached, to the
             streamed ones) in every epoch, the first-step losses of the two
             runs within LOSS_REL_TOL, and prefetch's counter of batch copies
             (two tensors and one event a step; none when cached); each
             run's steps timed and profiled (busy share; the counter again;
             each streamed batch copy the trace keeps from pinned memory on
             a stream no kernel uses; no batch copy when cached), the
             preemption snapshot's size and the cache's bytes;
  evaluate   `cli/evaluate.py` on the card against the streamed run's best
             checkpoint (--use_best --eval_on val --save_tensors): its means
             equal that epoch's val record within EVAL_REL_TOL, B1 once per
             batch, one artifact row a sample;
  train_families  each of base_residual (warmup_epochs 1, so the second
             epoch runs detached), unet_cvae (unet_256, latent 128),
             adabins_distillation (n_bins 128, the teacher frozen),
             rgb_depth and the four coarse_depth variants (unet, lite,
             hybrid, dual_reg; 128 sid bins, the batches' bins bucketized
             on the host) through `cli/train.py`'s main at full width (base 64),
             256², bf16, batch 16, synthetic data (with images where the
             family reads them), 2 epochs of 2 steps, each validated,
             checkpoints in a temporary directory: every loss and grad_norm
             finite, every trainable parameter moved (only the cVAE's three
             never-run BatchNorms get no gradient), the AdaBins teacher's
             parameters bit-unchanged and its BatchNorm buffers moved, B1
             once per step, eval batch and detector forward for the three
             audio families and never for rgb_depth, B2 and B3 never; for
             the audio families `serve` from the best checkpoint
             (`serve_family`: answers within SERVED_TOL of the task's own at
             that epoch, B1 once a device batch); then 8 timed steps on one
             repeated batch (the loss must fall) with the peak memory, for
             the cVAE two eval forwards equal (its draw is reseeded), and a
             profile of one step (busy share, B1's share);
  aux_centers  the coarse unet's best checkpoint with linear bins written
             into its aux, served under the sid flags: the answer moves by
             more than AUX_CHANGE_MIN and equals the task's own on the
             linear centers within SERVED_TOL;
  f32_train_vs_cpu  the same rule for one float32 adabins_distillation step
             at full width (teacher included, the same dropout masks on
             every device), and for one coarse hybrid step;
  corpus_images  the tree's camera PNGs (480×640): one batch with
             use_image="both" streamed to the card and one gathered by the
             device cache there, bit-equal to the host loader's, and the
             decode time with and without images;
  train_corpus_images  rgb_depth (camera images), adabins_distillation
             (paired) and unet_baseline --eval_img trained from the tree
             for one epoch with a location held out (B1 only for adabins);
  evaluate_eval_img  `cli/evaluate.py --eval_img` on the --eval_img
             checkpoint: its means equal the val record, no front end;
  train_sparse  `tools/preprocess_sparse_depth.py --method downup_015` over
             the tree (timed), then the coarse hybrid (base 64, 128 sid
             bins, bf16, batch 16) trained on those targets for one epoch
             with a location held out, streamed and with --device_cache:
             B1 once per step, eval batch and detector forward, the bins on
             the card equal to the host dataset's;
  evaluate_sparse  `cli/evaluate.py` on that checkpoint (the dense val
             ground truth): its means equal the engine's per-sample metrics
             of the same split, reduced the CLI's way, within
             SPARSE_EVAL_REL_TOL, B1 once per batch;
  export     `tools/export.py` (torch.export, the kernels as the registered
             ops audiodepth::fused_mel_frontend and
             audiodepth::flash_cross_attention_fwd): the unet and the
             binaural net (γ seeded) of the serve phase at batch 1 and 16,
             and the coarse unet's checkpoint with linear bins in its aux
             (aux_centers), each saved as a `.pt2`, then loaded and run in a
             fresh `python3 -c` process that imports tools.export alone:
             answers finite, in [0, 30] m and within SERVED_TOL of serve's
             (of aux_centers' for the coarse one), B1 once a call, B2 four
             times a binaural call, B3 never; export seconds, `.pt2` bytes,
             the median ms of an exported call and of eager predict_meters;
  profile_step  `tools/profile_step.py` in-process: the unet at batch 16 and
             256 and the binaural net at 16, 8 traced steps each, its
             report, and each hand-written kernel's launches in the trace
             beside its counter (DROPPED where they differ); every profile
             phase above reads its trace with the tool's `parse_trace`;
  trace_probe  B1 (a cluster launch) and B2 10 times each under the
             profiler as is, with a synchronize before it stops and with
             its CUDA sync events: the trace's launches beside the counters;
  profile_dir  `cli/train.py --profile_dir` for the unet, 2 epochs of 2
             steps: one trace, epoch 2's, holding the step's kernels;
  adabins_remat  adabins_distillation at full width, batch 16, with
             model.extra.remat and without: bf16 step ms and peak memory of
             each (lower with remat), and float32 gradients from the same
             weights and seed within F32_GRAD_FACTOR of the card's
             run-to-run floor;
  verify_contracts  `tools/verify_contracts.py` on the card at base 64, 256²;
  train_dp   data parallelism (`parallel/`) on the one card. A world of one
             NCCL rank in a child process: unet_256 (ngf 64, bf16, batch
             16, 4 steps) beside the plain engine from the same init and
             batches (|Δ| of losses and parameters printed), B1 once a
             step. Two gloo ranks time-sharing cuda:0 (NCCL refuses two
             ranks on one GPU; every collective staged through pinned host
             memory), 8 + 8 rows of one repeated batch, 3 bf16 steps of the
             unet and of the binaural net (base 64, γ seeded): both ranks'
             parameters and buffers bit-equal after every step (a sha256 of
             each state), one loss, falling, every parameter moved, B1 once
             and B2 / B3 four times a rank and step. In each world a float32
             step (TF32 off; the unet with the sigmoid head, see `_dp_cfg`)
             whose reduced gradient is within F32_GRAD_FACTOR × the plain
             engine's own error + DP_F32_SLACK of a CPU float64 step on the
             same global batch. `cli.train --num_devices` above the card
             count exits naming the count; `--num_devices 1` trains. The
             step times are two processes time-sharing one card, not
             scaling;
  train_sp   sequence parallelism (`parallel/`, the binaural net's
             `sp_axis`) on the one card: two gloo ranks time-sharing cuda:0
             as a 1 × 2 ('data', 'model') group, each with the whole global
             batch of 8, 3 bf16 steps of the binaural net at full width
             (base 64, levels 2-5, 256², γ seeded) with every attention's
             query rows split over the two ranks: both ranks' states
             bit-equal after every step, one loss, falling, every parameter
             moved, B1 once and B2 / B3 four times a rank and step, each
             attention at Nq = N/2 against all N keys, and the step's
             collectives by kind and bytes equal to their formulas
             (`sp_collectives_want`); a float32 step at batch 2 whose
             gradient is within F32_GRAD_FACTOR × the plain engine's own
             error + DP_F32_SLACK of a CPU float64 step; and the
             plain-spectrogram front end of a batch of 8 BV2-length
             waveforms with its STFT's frames split over the two ranks
             (halo exchange), within SP_STFT_TOL of the one-device front
             end on the card. The steps run in torch's deterministic mode,
             which the engine scopes to them; the same steps are timed
             once more without it, for its cost. The step times are
             time-sharing, not scaling;
  examples_compare  `examples/compare_checkpoints.py` (float32) over the
             checkpoints the run wrote: train_unet's experiment directory,
             a reference-format .pth of its latest epoch, the train phase's
             binaural directory and the coarse hybrid's from train_families;
             the CSV's header is the reference's and each row equals
             `cli/evaluate.py`'s means on the same split within
             COMPARE_REL_TOL (the two unet rows as well);
  examples_convergence  `examples/synthetic_convergence.py` at its defaults
             (unet_256, bf16, batch 64, 512 / 64 samples, 30 epochs): every
             loss finite, the last val RMSE below epoch 1's and at most
             EXAMPLES_RMSE_MAX, B1 once a step and an eval batch;
  examples_sweep  `examples/family_sweep.py` at its defaults (seven
             families, batch 32, 10 epochs): every loss and metric finite,
             every last RMSE at most EXAMPLES_RMSE_MAX and, but for
             base_residual's plateau, below the first, B1 / B2 / B3 counted;
             only the cVAE or rgb_depth (FLOOR_AT_0_FAMILIES: heads with a
             floor at 0, dead or slow from some draws in JAX as in the
             port, ROADMAP.md §C) may miss that from seed 0: the miss is
             recorded and each of its SWEEP_RESEEDS runs must meet it;
  examples_step_bench  `examples/family_step_bench.py` at its defaults (the
             seven families at full width, bs 32, 3 + 20 steps): ms a step,
             pairs/s and peak memory, the launches counted;
  kernels    one line listing every kernel with its numbers at its main
             shape, its launches on each path (by plan variant where the
             plan has several) and its SASS HGMMA and HMMA counts.
The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

# (fp32 TFLOP/s on the CUDA cores, HBM TB/s, dense bf16 tensor TFLOP/s),
# NVIDIA data sheets
PEAKS = {"H100 SXM": (67.0, 3.35, 989.0), "H100 PCIe": (51.0, 2.0, 756.0),
         "H100 NVL": (60.0, 3.9, 835.0)}
EX2_PER_CLOCK_PER_SM = 16  # the SFU's exp2 rate on sm_90
KERNEL_TOL = 1e-5          # B1 vs its fp32 plain version (see phase_kernel)
B1_CLEAN_SLACK = 1e-5      # B1 vs float64 on clean chirps, beyond the fp32 plain's own error
# B1's rows (input, B·C, L)
B1_ROWS = [("noise", 2, 7782), ("noise", 8, 7782), ("noise", 32, 7782), ("noise", 8, 4000),
           ("synthetic", 32, 7782), ("clean chirps", 8, 7782),
           # a channel of 3,126 frames: the two-pass form (more than 16 blocks a channel)
           ("noise", 2, 100_000)]
B1_MAIN = ("noise", 32, 7782)
# the BatchNorm pair's calls a bf16 train step makes on one card (forward,
# backward), by family: every BatchNorm of a train-mode bf16 step takes the
# kernels; eval, serving, float32 and data- or sequence-parallel steps keep
# the module's own code and make none. The binaural net's remat recomputes
# its encoders' 20 forwards; the frozen AdaBins teacher's 18 have no backward.
BN_PER_TRAIN_STEP = {"binaural_attention": (53, 33), "unet_baseline": (13, 13),
                     "base_residual": (26, 26), "unet_cvae": (13, 13),
                     "adabins_distillation": (36, 18), "rgb_depth": (18, 18),
                     "coarse_depth/unet": (18, 18), "coarse_depth/lite": (10, 10),
                     "coarse_depth/hybrid": (28, 28), "coarse_depth/dual_reg": (28, 28)}
NO_BN = {"batch_norm_train_fwd": 0, "batch_norm_train_bwd": 0}


def bn_launches(family: str, steps: int) -> dict:
    """The BatchNorm pair's launches over `steps` bf16 train steps of `family`."""
    fwd, bwd = BN_PER_TRAIN_STEP[family]
    return {"batch_norm_train_fwd": fwd * steps, "batch_norm_train_bwd": bwd * steps}


# the soft-binning pair's calls on one card: a bf16 AdaBins train step runs
# it in the student (with grad) and the teacher (under no_grad) and takes one
# backward; an eval, detector or served forward runs the student alone. No
# other family, and no float32 step, calls it.
NO_SB = {"soft_binning_fwd": 0, "soft_binning_bwd": 0}


def sb_launches(family: str, steps: int, forwards: int = 0) -> dict:
    """The soft-binning pair's launches over `steps` bf16 train steps (with
    the teacher) and `forwards` student forwards of `family`."""
    if family != "adabins_distillation":
        return dict(NO_SB)
    return {"soft_binning_fwd": 2 * steps + forwards, "soft_binning_bwd": steps}

F32_VS_CPU_TOL = 1e-3      # relative to max |cpu|
SERVED_TOL = 2 ** -5       # served vs direct bf16 answer, relative to max |direct|
# B2 vs its plain version (see phase_kernel_b2)
B2_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}  # o, relative to max |v|
B2_LSE_TOL = 1e-4                                 # lse, relative to max(1, |lse|)
# (2B, N = M, dk, dv, dtype) of every B2 shape; level l of base 64 at 256²
# has N = (256 / 2^(l-1))², dk = C/8, dv = C; 2B = 32 is a serve batch of 16
B2_SHAPES = [
    ("level 2", 32, 16384, 16384, 16, 128, "bfloat16"),
    ("level 3", 32, 4096, 4096, 32, 256, "bfloat16"),
    ("level 4", 32, 1024, 1024, 64, 512, "bfloat16"),
    ("level 5", 32, 256, 256, 64, 512, "bfloat16"),
    ("level 2, batch 1", 2, 16384, 16384, 16, 128, "bfloat16"),
    ("level 3, float32", 2, 4096, 4096, 32, 256, "float32"),
    # the levels in float32 at the training batch of 16 (`--compute_dtype
    # float32`, the reference's own numerics; train_f32's launches)
    ("level 2, float32, batch 16", 32, 16384, 16384, 16, 128, "float32"),
    ("level 3, float32, batch 16", 32, 4096, 4096, 32, 256, "float32"),
    ("level 4, float32, batch 16", 32, 1024, 1024, 64, 512, "float32"),
    ("level 5, float32, batch 16", 32, 256, 256, 64, 512, "float32"),
    ("ragged", 4, 1000, 777, 32, 256, "bfloat16"),
    # the plan's other branches: dk padded to 16 and 64, dv tiles of 64 and
    # 192, two forward dv slices and two B3 warpgroups sharing dv, one q row
    ("dk 8, ragged", 2, 300, 200, 8, 64, "bfloat16"),
    ("dk 40, dv 136, ragged", 2, 333, 129, 40, 136, "bfloat16"),
    ("dk 24, dv 320, ragged", 2, 200, 150, 24, 320, "bfloat16"),
    ("N 1", 2, 1, 70, 16, 128, "bfloat16"),
    # the widths of other base channels c (dk = C/8, dv = C, C = 2c, 4c, 8c,
    # 8c at levels 2-5), each in bf16 at a batch of 16 and in f32 at a batch
    # of 1: dk below 8 and not a multiple of 8 (zero-padded by the wrapper),
    # dkp 128 (two 64-column boxes a row) and dv above 512 (B3's split design)
    ("base 16 level 2", 32, 16384, 16384, 4, 32, "bfloat16"),
    ("base 16 level 2, float32", 2, 16384, 16384, 4, 32, "float32"),
    ("base 128 level 3", 32, 4096, 4096, 64, 512, "bfloat16"),
    ("base 128 level 3, float32", 2, 4096, 4096, 64, 512, "float32"),
    ("base 128 level 4", 32, 1024, 1024, 128, 1024, "bfloat16"),
    ("base 128 level 4, float32", 2, 1024, 1024, 128, 1024, "float32"),
    ("dk 12 (base 48 level 2)", 32, 16384, 16384, 12, 96, "bfloat16"),
    ("dk 12 (base 48 level 2), float32", 2, 16384, 16384, 12, 96, "float32"),
    ("dv 768 (base 96 level 4)", 32, 1024, 1024, 96, 768, "bfloat16"),
    ("dv 768 (base 96 level 4), float32", 2, 1024, 1024, 96, 768, "float32"),
    # the split design's other branches: dkp 128 with one slice of 64, dkp 64
    # with three slices of 192; dv not a multiple of 8
    ("dk 128, dv 64, ragged", 2, 300, 200, 128, 64, "bfloat16"),
    ("dk 64, dv 520, ragged", 2, 300, 200, 64, 520, "bfloat16"),
    ("dk 12, dv 36, ragged", 2, 333, 129, 12, 36, "bfloat16"),
    # sequence parallelism: a rank's query rows against all keys; the sp 2
    # rows are train_sp's launches (2B = 16 there, 32 at level 2 here)
    ("level 2, sp 2 q rows", 32, 8192, 16384, 16, 128, "bfloat16"),
    ("level 3, sp 2 q rows", 16, 2048, 4096, 32, 256, "bfloat16"),
    ("level 4, sp 2 q rows", 16, 512, 1024, 64, 512, "bfloat16"),
    ("level 5, sp 2 q rows", 16, 128, 256, 64, 512, "bfloat16"),
    ("level 4, sp 4 q rows", 32, 256, 1024, 64, 512, "bfloat16"),
]
B2_MAIN = "level 2"
B2_F32_MAIN = "level 2, float32, batch 16"  # the float32 main row, in the kernels line too
# B3 vs its plain version, relative to the plain version's max |·| of each
# of dq, dk, dv: in bf16, p and ds are rounded to bf16 before their products
# (2^-9 relative each) and the outputs to bf16 (2^-9), in sums of up to
# 16384 terms whose rounding errors partly cancel: 2^-6; in f32 the path is
# full fp32 (the accurate exp2f) with atomics in another order: 1e-4
B3_TOL = {"bfloat16": 2 ** -6, "float32": 1e-4}  # also the autograd phase's
F32_TRAIN_TOL = 1e-3   # train loss, card vs CPU in float32, relative
F32_GRAD_FACTOR = 2.0  # card's f32 gradient error vs the CPU's, both against f64 (see phase)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peak_for(name: str):
    key = ("H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name
           else "H100 SXM")
    return key, PEAKS[key]


def time_ms(torch, fn, runs: int = 50, warmup: int = 5) -> float:
    """Median per-call device time (CUDA events between back-to-back calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(50_000_000)  # hold the stream while the host queues every call
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_env(torch):
    smi = _smi("name,power.limit")
    max_sm_mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sms": n_sm, "max_sm_clock_mhz": max_sm_mhz})
    return smi, n_sm * max_sm_mhz * 1e6 * EX2_PER_CLOCK_PER_SM


def kernel_name(text: str) -> str:
    """`flash_bwd_wgmma_kernel<16,128>` from a line holding its mangled name
    (the line itself where there is none)."""
    m = re.search(r"((?:flash_fwd|flash_bwd|flash_split3|fused_mel|frontend_normalize|bn_fwd|bn_bwd"
                  r"|soft_bin)"
                  r"\w*?_kernel)(I(?:L[ib]\d+E)+E)?", text)
    if not m:
        return text.strip()
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_mma(build, names) -> dict:
    """{kernel: {"HGMMA": n, "HMMA": m}}: its wgmma and its mma.sync tensor
    instructions in `cuobjdump -sass` of each built library."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    counts, name = {}, None
    for lib in names:
        out = subprocess.run([tool, "-sass", str(build.library_path(lib))], capture_output=True,
                             text=True, timeout=300, check=True).stdout
        for ln in out.splitlines():
            if "Function :" in ln:
                name = kernel_name(ln.split("Function :")[-1])
                counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
            elif name:
                for op in ("HGMMA", "HMMA"):
                    counts[name][op] += op in ln
    return counts


def ptxas_report(logs) -> dict:
    """{kernel (template argument in <>): ptxas's registers and spills}
    from nvcc's `-Xptxas -v` output."""
    report, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            if "entry function" in ln:
                name = kernel_name(ln)
            elif name and (re.search(r"Used \d+ registers", ln) or "spill stores" in ln):
                part = ln.split("Used ")[-1].strip() if "registers" in ln else ln.strip()
                report[name] = f"{report[name]}; {part}" if name in report else part
    return report


# instantiations that spill, all from before the C1 repair (B3's two-warpgroup
# variants at dv 384-512): any other spill fails the build phase
KNOWN_SPILLS = {"flash_bwd_wgmma_kernel<64,256,2>", "flash_bwd_wgmma_kernel<64,192,2>",
                "flash_bwd_wgmma_kernel<32,256,2>"}


def spills(report) -> dict:
    """{kernel: spill store bytes} of every instantiation that spills."""
    out = {}
    for name, text in report.items():
        m = re.search(r"(\d+) bytes spill stores", text)
        if m and int(m.group(1)):
            out[name] = int(m.group(1))
    return out


def phase_build(build):
    # one library per source; B2 and B3 share csrc/flash_attention.cu, the
    # BatchNorm pair csrc/batch_norm.cu, the soft-binning pair csrc/soft_binning.cu
    names = ["fused_frontend", "flash_attention", "batch_norm", "soft_binning"]
    t0 = time.perf_counter()
    logs = build.build(names)
    seconds = time.perf_counter() - t0
    report = ptxas_report(logs)
    sass = sass_mma(build, names)
    spilled = spills(report)
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs), "ptxas": report,
          "sass_mma": sass, "spills": spilled})
    new = set(spilled) - KNOWN_SPILLS
    assert not new, f"instantiations that spill: {sorted(new)}"
    # the float32 designs run on the tensor cores: every three-piece
    # instantiation of B2 and B3 has wgmma in its SASS
    bf16x3 = {k: v["HGMMA"] for k, v in sass.items() if k.endswith(",3>")}
    assert all(bf16x3.values()) and {k.split("<")[0] for k in bf16x3} == {
        "flash_fwd_wgmma_kernel", "flash_bwd_split_kernel"}, bf16x3
    return report, sass


def _b1_input(np, kind: str, bc: int, length: int, configs):
    """[bc/2, 2, length] float32 waveforms (numpy) of one kind of input:
    noise σ 0.05 with channel 0 silent; the train path's synthetic echoes
    (rows of 8038 samples, cut by the caller to a view); clean chirps, two
    echoes a channel and no noise."""
    rng = np.random.default_rng(bc * 100_003 + length)
    if kind == "noise":
        wave = (rng.standard_normal((bc // 2, 2, length)) * 0.05).astype(np.float32)
        wave[0, 0] = 0.0  # a silent channel takes the max == min branch
        return wave
    if kind == "synthetic":
        from audiodepth_tpu_torch.data.synthetic import SyntheticEchoDataset

        ds = SyntheticEchoDataset(configs.load_config("synthetic", "train"), num_samples=bc // 2)
        return np.stack([ds.sample(i)["waveform"] for i in range(bc // 2)])
    t = np.arange(256, dtype=np.float32)
    chirp = np.sin(2 * np.pi * (0.01 + 0.0008 * t) * t) * np.hanning(256).astype(np.float32)
    wave = np.zeros((bc // 2, 2, length), np.float32)
    for i in range(bc // 2):
        for ch in range(2):
            for amp in (1.0, 0.5):
                d = int(rng.integers(0, length - 256))
                wave[i, ch, d:d + 256] += amp * chirp
    return wave


def _b1_bounds(bc, t_frames, length, consts, peak, win=64, n_freq=257, n_mels=32):
    """(bound_us, bound_by, bound_fp32_us) of one B1 call.

    bound_us: the work the function needs at the card's peak for it, against
    its bytes: the DFT over the bins the bank reads only, in the six bf16
    passes of the kernel's three-piece products, 6·2·BC·T·win·2·n_bins flops
    at the dense bf16 rate (the time of three TF32 passes at the TF32 rate,
    half the bf16 one), plus the bank's non-zeros, 2·BC·T·nnz flops at the
    fp32 rate; bytes: the waveform and the packed constants read once, the
    output written once. bound_fp32_us: the first port's yardstick, the
    dense product 2·BC·T·(win·2·n_freq + n_freq·n_mels) flops at the fp32
    rate against the waveform, output, basis and bank."""
    flops_peak, bw_peak, tensor_peak = peak
    dft_s = 6 * 2.0 * bc * t_frames * win * 2 * consts.n_bins / (tensor_peak * 1e12)
    mel_s = 2.0 * bc * t_frames * consts.nnz / (flops_peak * 1e12)
    bytes_s = (4.0 * (bc * length + bc * n_mels * t_frames) + consts.nbytes) / (bw_peak * 1e12)
    ops_s = dft_s + mel_s
    dense_flops = 2.0 * bc * t_frames * (win * 2 * n_freq + n_freq * n_mels)
    dense_bytes = 4.0 * (bc * length + bc * n_mels * t_frames + win * 2 * n_freq + n_freq * n_mels)
    fp32_s = max(dense_flops / (flops_peak * 1e12), dense_bytes / (bw_peak * 1e12))
    return (max(ops_s, bytes_s) * 1e6, "operations" if ops_s > bytes_s else "bytes",
            fp32_s * 1e6)


def phase_kernel(torch, np, ff, peak, configs):
    """B1 against its plain versions on the card, every row through the
    wrapper as the main path calls it.

    Rows (input, B·C, L): noise at the serving shapes (2, 8, 32 at L =
    7782) and at L = 4000, held to the fp32 plain version within
    KERNEL_TOL; the train path's synthetic echoes at 32 × 7782, cut from
    rows of 8038 to a strided view as `make_frontend` cuts them, the same
    gate. KERNEL_TOL = 1e-5: the JAX package holds its Pallas kernel to the
    XLA composition at 1e-6; here the DFT's products are exact to 2^-26 but
    sum in another order (16-tap steps on the tensor cores), and the
    difference passes through log and the division by the channel's range.
    Clean chirps without noise (8 × 7782) are held to the float64 plain
    version instead: sidelobe bins near the 1e-8 floor make any two fp32
    summation orders differ by up to ~1e-4 there (the fp32 plain version
    itself is ~6e-5 from float64), so the gate is the fp32 plain version's
    own float64 error + B1_CLEAN_SLACK.

    Times: median of back-to-back launches; bounds: `_b1_bounds`."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    caps = ff.cluster_capacity(0)
    consts = ff.frontend_constants()
    emit({"phase": "b1_plan", "sms": n_sm, "cluster_capacity": caps,
          "const_bytes": consts.nbytes})
    rows = []
    for kind, bc, length in B1_ROWS:
        wave_np = _b1_input(np, kind, bc, length, configs)
        wave = torch.from_numpy(wave_np).cuda()[..., :length]
        plan = ff.frontend_plan(bc, length, n_sm, caps)
        reset_launches([(ff.fused_mel_frontend, None, None)])
        got = ff.fused_mel_frontend(wave)
        want = ff.fused_mel_frontend_plain(wave)
        torch.cuda.synchronize()
        # the call took the plan's form: a two-pass call launches both kernels
        form = "two_pass" if plan.two_pass else "one_pass"
        assert dict(ff.fused_mel_frontend.variant_launches) == {form: 1}
        assert ff.fused_mel_frontend.launches == (2 if plan.two_pass else 1)
        assert got.shape == want.shape and torch.isfinite(got).all()
        vs_plain = float((got - want).abs().max())
        row = {"phase": "kernel", "name": ff.fused_mel_frontend.name, "input": kind, "bc": bc,
               "L": length, "T": got.shape[-1], "strided": not wave.is_contiguous(),
               "plan": dataclasses.asdict(plan), "max_abs_err_vs_plain": vs_plain}
        if kind == "clean chirps":
            want64 = log_minmax_f64(torch, wave)
            err = float((got.double() - want64).abs().max())
            plain_err = float((want.double() - want64).abs().max())
            tol = plain_err + B1_CLEAN_SLACK
            row.update(vs="float64 plain", plain_vs_f64=plain_err)
        else:
            err, tol = vs_plain, KERNEL_TOL
            row.update(vs="fp32 plain")
        if kind == "noise":
            assert float(got[0, 0].abs().max()) == 0.0
        assert err <= tol, f"B1 {kind} {bc}x{length}: differs by {err} (tolerance {tol})"
        ms = time_ms(torch, lambda: ff.fused_mel_frontend(wave))
        plain_ms = time_ms(torch, lambda: ff.fused_mel_frontend_plain(wave))
        bound_us, bound_by, bound_fp32_us = _b1_bounds(bc, got.shape[-1], length, consts, peak)
        row.update(max_abs_err=err, tol=tol, us=ms * 1e3, plain_us=plain_ms * 1e3,
                   bound_us=bound_us, bound_by=bound_by, bound_fp32_us=bound_fp32_us)
        emit(row)
        rows.append(row)
    return rows


def log_minmax_f64(torch, wave):
    """The plain front end in float64 (the reference of the clean-chirp row)."""
    from audiodepth_tpu_torch.ops.stft import log_minmax_per_channel, mel_spectrogram

    return log_minmax_per_channel(mel_spectrogram(wave.double(), n_fft=512, win_length=64,
                                                  hop_length=32, n_mels=32,
                                                  dtype=torch.float64))


def plan_dict(plan) -> dict:
    return {"variant": plan.variant, "dkp": plan.dkp, "dvs": plan.dvs,
            "n_slices": plan.n_slices, "stages": plan.stages, "smem_bytes": plan.smem_bytes,
            "grid": list(plan.grid), "block": plan.block, "blocks_per_sm": plan.blocks_per_sm,
            "chunk_stages": plan.chunk_stages, "dq_bufs": plan.dq_bufs, "pieces": plan.pieces}


def attention_bound(flops, ex2, nbytes, dtype, peak, ex2_rate) -> dict:
    """The least time of one B2 / B3 call on the card, by term (ms): the
    products at the dense bf16 tensor rate, in float32 as the kernels run
    them, six bf16 passes ("operations"); the exp2 unit ("ex2"); every
    input read once and every output written once ("bytes"). In float32
    the same products once at the CUDA cores' fp32 rate stand beside them
    ("fp32_cuda_cores": the parent design's yardstick, not a bound of
    this one). Returns the row's bound fields."""
    flops_peak, bw_peak, tensor_peak = peak
    passes = 6 if dtype == "float32" else 1
    terms = {"operations": passes * flops / (tensor_peak * 1e12), "ex2": ex2 / ex2_rate,
             "bytes": nbytes / (bw_peak * 1e12)}
    term = max(terms, key=terms.get)
    out = {"bound_ms": terms[term] * 1e3, "bound_term": term,
           "bound_by": "bytes" if term == "bytes" else "operations",
           "bound_terms_ms": {k: t * 1e3 for k, t in terms.items()}}
    if dtype == "float32":
        out["bound_terms_ms"]["fp32_cuda_cores"] = flops / (flops_peak * 1e12) * 1e3
    return out


def is_heavy(b, n, m, dtype) -> bool:
    """Rows whose calls take long (level 2 at 2B = 32; float32 at the
    training batch): few timed runs."""
    return n * m * b > 2 ** 31 or (dtype == "float32" and b >= 32)


def _sdpa_ms(torch, q, k, v, scale):
    """(ms, backend) of `F.scaled_dot_product_attention` on the same inputs,
    restricted to its fused backends; (None, reason) where none takes the
    shapes. The math backend is never timed: it would materialise the
    [2B, N, M] scores (17 GB at level 2). A yardstick only: the port never
    calls SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    refused = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)

        def call():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as exc:  # this backend does not take the shapes
            refused[name] = str(exc).splitlines()[0][:80]
            continue
        return time_ms(torch, call, runs=10, warmup=2), name
    return None, f"no fused SDPA backend takes these shapes: {refused}"


# q/k widths of the layout probe: each dkp whole, and dkp 128 part filled
PROBE_DK = (16, 32, 64, 128, 72)
PROBE_TOL = 1e-5  # relative to the largest |entry| of the float64 product


def phase_layout_probe(torch, fa):
    """The q/k operand layouts of B2 and B3 alone, before the kernels that
    use them (csrc/flash_attention.cu, flash_layout_probe_kernel): one
    64-row tile each of q and k as the kernels load them, S = Q·Kᵀ with both
    K-major, bf16(S)·Q with Q MN-major (B3's dK), bf16(S)·K with K MN-major
    a box at a time (B3's dQ), against torch.matmul in float64 of the same
    bf16 values (of the kernel's own S rounded to bf16 for the last two).
    The products are exact in fp32 and only the summation order differs, so
    PROBE_TOL; a wrong swizzle or descriptor moves whole entries."""
    lib = fa.flash_cross_attention.library()
    stream = torch.cuda.current_stream().cuda_stream
    for dk in PROBE_DK:
        dkp = fa._wgmma_dkp(dk)
        g = torch.Generator(device="cuda").manual_seed(dk)
        q = torch.randn(64, dk, device="cuda", generator=g).bfloat16()
        k = torch.randn(64, dk, device="cuda", generator=g).bfloat16()
        s = torch.empty(64, 64, device="cuda")
        x = torch.empty(64, dk, device="cuda")
        y = torch.empty(64, dk, device="cuda")
        err = lib.adepth_flash_layout_probe(q.data_ptr(), k.data_ptr(), s.data_ptr(),
                                            x.data_ptr(), y.data_ptr(), dk, dkp, 0, stream)
        assert err == 0, lib.adepth_cuda_error_string(err).decode()
        torch.cuda.synchronize()
        sb = s.bfloat16().double()
        pairs = {"Q.K^T": (s, torch.matmul(q.double(), k.double().T)),
                 "bf16(S).Q": (x, torch.matmul(sb, q.double())),
                 "bf16(S).K": (y, torch.matmul(sb, k.double()))}
        errs = {name: float((got.double() - want).abs().max() / want.abs().max())
                for name, (got, want) in pairs.items()}
        emit({"phase": "layout_probe", "dk": dk, "dkp": dkp, "rel_err": errs, "tol": PROBE_TOL})
        bad = {name: e for name, e in errs.items() if not e <= PROBE_TOL}
        assert not bad, f"layout probe dk {dk} (dkp {dkp}): {bad}"


def phase_kernel_b2(torch, np, fa, peak, ex2_rate):
    """B2 against its plain version on the card at the binaural shapes.

    q and k are drawn with standard deviation 3, so that the scores spread
    over several units and the online softmax rescales often. Tolerances:
    o in bf16 within 2^-7·max|v| (P is rounded to bf16 before P·V, about
    2^-9 relative per weight, and o to bf16, 2^-9); o in f32 within
    1e-5·max|v| (the f32 path is full fp32 with the accurate exp2f, sums
    of at most 64 terms in sequence); lse within 1e-4·max(1, |lse|) (fp32
    statistics in another summation order)."""
    rows = []
    for label, b, n, m, dk, dv, dtype in B2_SHAPES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(n + m + dk + dv + b)
        q = (3 * torch.randn(b, n, dk, device="cuda", generator=g)).to(dt)
        k = (3 * torch.randn(b, m, dk, device="cuda", generator=g)).to(dt)
        v = torch.randn(b, m, dv, device="cuda", generator=g).to(dt)
        scale = 1.0 / dv ** 0.5  # the model's 1/sqrt(C), C = dv
        o, lse = fa.flash_cross_attention(q, k, v, scale)
        want_o, want_lse = fa.flash_cross_attention_fwd_plain(q, k, v, scale)
        torch.cuda.synchronize()
        assert o.shape == want_o.shape == (b, n, dv) and o.dtype == dt
        assert lse.shape == want_lse.shape == (b, n, 1) and torch.isfinite(o).all()
        vmax = float(v.abs().max())
        err = float((o.float() - want_o.float()).abs().max())
        lse_err = float(((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max())
        assert err <= B2_TOL[dtype] * vmax, f"B2 {label}: o differs by {err} (max|v| {vmax})"
        assert lse_err <= B2_LSE_TOL, f"B2 {label}: lse differs by {lse_err} relative"
        heavy = is_heavy(b, n, m, dtype)
        ms = time_ms(torch, lambda: fa.flash_cross_attention(q, k, v, scale),
                     runs=10 if heavy else 50)
        plain_ms = time_ms(torch, lambda: fa.flash_cross_attention_fwd_plain(q, k, v, scale),
                           runs=3 if heavy else 20, warmup=1 if heavy else 3)
        library_ms, library = _sdpa_ms(torch, q, k, v, scale)
        es = q.element_size()
        flops = 2.0 * b * n * m * (dk + dv)
        ex2 = float(b) * n * m
        nbytes = es * b * (n * dk + m * dk + m * dv + n * dv) + 4.0 * b * n
        row = {"phase": "kernel", "name": fa.flash_cross_attention.name, "shape": label,
               "B": b, "N": n, "M": m, "dk": dk, "dv": dv, "dtype": dtype,
               "plan": plan_dict(fa.fwd_plan(b, n, m, dk, dv, dt)),
               "max_abs_err": err, "max_abs_v": vmax, "tol_abs": B2_TOL[dtype] * vmax,
               "lse_rel_err": lse_err, "ms": ms, "plain_ms": plain_ms,
               **attention_bound(flops, ex2, nbytes, dtype, peak, ex2_rate),
               "library_ms": library_ms, "library": library,
               "tflops": flops / (ms * 1e9)}
        emit(row)
        assert dtype != "float32" or row["ms"] >= row["bound_ms"], f"B2 {label}: over its bound"
        rows.append(row)
        del q, k, v, o, lse, want_o, want_lse
    return rows


def _sdpa_bwd_ms(torch, q, k, v, do, scale):
    """(ms, backend) of the backward of `F.scaled_dot_product_attention` on
    its memory-efficient backend, the only fused one that takes dk != dv:
    `torch.autograd.grad` of its output alone is timed. A yardstick only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_() for t in (q, k, v))
    do4 = do.unsqueeze(1)
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
        torch.cuda.synchronize()
    except RuntimeError as exc:  # the backend does not take the shapes
        return None, "EFFICIENT_ATTENTION refused: " + str(exc).splitlines()[0][:80]
    ms = time_ms(torch, lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True),
                 runs=10, warmup=2)
    return ms, "EFFICIENT_ATTENTION backward"


def phase_kernel_b3(torch, fa, peak, ex2_rate):
    """B3 against its plain version on the card at B2's shapes, from B2's
    forward on inputs drawn as B2's phase draws them (q, k with standard
    deviation 3) and do ~ N(0, 1). Tolerances: B3_TOL."""
    rows = []
    for label, b, n, m, dk, dv, dtype in B2_SHAPES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(n + m + dk + dv + b)
        q = (3 * torch.randn(b, n, dk, device="cuda", generator=g)).to(dt)
        k = (3 * torch.randn(b, m, dk, device="cuda", generator=g)).to(dt)
        v = torch.randn(b, m, dv, device="cuda", generator=g).to(dt)
        do = torch.randn(b, n, dv, device="cuda", generator=g).to(dt)
        scale = 1.0 / dv ** 0.5
        o, lse = fa.flash_cross_attention(q, k, v, scale)
        got = fa.flash_cross_attention_bwd(q, k, v, o, lse, do, scale)
        want = fa.flash_cross_attention_bwd_plain(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        errs, maxes = {}, {}
        for name, a, w, shape in zip(("dq", "dk", "dv"), got, want,
                                     ((b, n, dk), (b, m, dk), (b, m, dv))):
            assert a.shape == w.shape == shape and a.dtype == dt, (label, name, a.shape)
            assert torch.isfinite(a).all(), f"B3 {label}: {name} is not finite"
            maxes[name] = float(w.float().abs().max())
            errs[name] = float((a.float() - w.float()).abs().max())
            assert errs[name] <= B3_TOL[dtype] * maxes[name], \
                f"B3 {label}: {name} differs by {errs[name]} (max {maxes[name]})"
        del got, want
        heavy = is_heavy(b, n, m, dtype)
        ms = time_ms(torch, lambda: fa.flash_cross_attention_bwd(q, k, v, o, lse, do, scale),
                     runs=10 if heavy else 50)
        plain_ms = time_ms(torch, lambda: fa.flash_cross_attention_bwd_plain(
            q, k, v, o, lse, do, scale), runs=3 if heavy else 20, warmup=1 if heavy else 3)
        library_ms, library = _sdpa_bwd_ms(torch, q, k, v, do, scale)
        es = q.element_size()
        flops = 2.0 * b * n * m * (3 * dk + 2 * dv)  # s, pᵀ·do, do·vᵀ, dsᵀ·q, ds·k
        ex2 = float(b) * n * m
        # in: q, k, v, o, do, lse; out: dq, dk, dv
        nbytes = es * b * (2 * n * dk + 2 * m * dk + 2 * m * dv + 2 * n * dv) + 4.0 * b * n
        row = {"phase": "kernel", "name": fa.flash_cross_attention_bwd.name, "shape": label,
               "B": b, "N": n, "M": m, "dk": dk, "dv": dv, "dtype": dtype,
               "plan": plan_dict(fa.bwd_plan(b, n, m, dk, dv, dt)),
               "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
               "max_abs_plain": maxes, "tol_rel": B3_TOL[dtype], "ms": ms, "plain_ms": plain_ms,
               **attention_bound(flops, ex2, nbytes, dtype, peak, ex2_rate),
               "library_ms": library_ms, "library": library,
               "tflops": flops / (ms * 1e9)}
        emit(row)
        assert dtype != "float32" or row["ms"] >= row["bound_ms"], f"B3 {label}: over its bound"
        rows.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


# the BatchNorm pair's rows: every BatchNorm input of the benchmark's two
# train cells ([N, C, H, W]; the UNet's without the ReLU epilogue, the
# binaural net's with it); the main row is the largest, the same rows in both
BN_ROWS = ([((256, 64, 128, 128), False), ((256, 128, 64, 64), False),
            ((256, 256, 32, 32), False), ((256, 512, 16, 16), False),
            ((256, 512, 8, 8), False), ((256, 512, 4, 4), False), ((256, 512, 2, 2), False)]
           + [((64, 64, 256, 256), True), ((64, 128, 128, 128), True),
              ((64, 256, 64, 64), True), ((64, 512, 32, 32), True), ((64, 512, 16, 16), True),
              ((64, 256, 32, 32), True), ((64, 128, 64, 64), True), ((64, 64, 128, 128), True)])
BN_MAIN = {((256, 64, 128, 128), False): "UNet", ((64, 64, 256, 256), True): "binaural"}
BN_BYTES_FWD, BN_BYTES_BWD = 4, 6  # bf16 x read, y written; x, dy read, dx written


def _bn_inputs(torch, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]

    def draw(*size):
        return torch.randn(size, generator=g, device="cuda")

    x = (draw(*shape) * 1.7 + 0.6).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = draw(*shape).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return x, dy, draw(c) * 0.5 + 1.0, draw(c) * 0.2, draw(c), draw(c).abs() + 0.5


def phase_kernel_bn(torch, bn, peak):
    """The BatchNorm pair (`audiodepth::batch_norm_train_fwd` / `_bwd`) at
    BN_ROWS against its plain version (the module's cast → cuDNN BatchNorm →
    cast [→ ReLU], and that chain's backward) on the card: y and dx within
    one bf16 ulp of the plain's (2^-7 of the value, two roundings of fp32
    values that differ in their last bits) plus 1e-4 of the largest value,
    where the two ReLU masks agree (they part only where the pre-activation
    rounds to 0); mean, invstd and the folded buffers within 1e-4 relative,
    dγ and dβ within 1e-4 of the sum of their terms' magnitudes (fp32 sums
    over up to 4.2 M rows in two orders); the kernels' two runs bit-equal. Times (median of back-to-back calls): forward, backward,
    their sum against the bytes bound (4 B an element forward, 6 B
    backward, at the card's published bandwidth), the plain version's, and
    `F.batch_norm` between its casts through autograd as library_ms (the
    kernels' own tests hold them to float64: tests/test_torch_batch_norm.py
    -m card)."""
    import torch.nn.functional as F

    gbps = peak[1] * 1e12
    rows_out = []
    for shape, relu in BN_ROWS:
        x, dy, w, b, rm, rv = _bn_inputs(torch, shape, seed=len(rows_out))
        n, c, h, wd = shape
        plan = bn.bn_plan(n * h * wd, c, torch.cuda.get_device_properties(0).multi_processor_count)
        runs = []
        for _ in range(2):
            bufs = (rm.clone(), rv.clone())
            y, mean, invstd = bn.batch_norm_train_fwd(x, w, b, *bufs, 0.1, 1e-5, relu, True)
            dx, dw, db = bn.batch_norm_train_bwd(dy, x, w, b, mean, invstd, 1e-5, relu)
            runs.append((y, mean, invstd, dx, dw, db, *bufs))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(*runs)), f"BN {shape}: runs differ"
        got = runs[0]
        del runs
        bufs = (rm.clone(), rv.clone())
        y_p, mean_p, invstd_p = bn.batch_norm_train_fwd_plain(x, w, b, *bufs, 0.1, 1e-5, relu, True)
        dx_p, dw_p, db_p = bn.batch_norm_train_bwd_plain(dy, x, w, b, mean_p, invstd_p, 1e-5, relu)
        want = (y_p, mean_p, invstd_p, dx_p, dw_p, db_p, *bufs)
        # the sums' scales: Σ|g| and Σ|g·x̂| a channel (g: dy through the ReLU's mask)
        g = dy.double() * (y_p > 0) if relu else dy.double()
        xhat = (x.double() - mean_p.double().view(1, -1, 1, 1)) * invstd_p.double().view(1, -1, 1, 1)
        scale = {"dbias": g.abs().sum((0, 2, 3)), "dweight": (g * xhat).abs().sum((0, 2, 3))}
        del g, xhat
        # the two ReLU masks part only where the pre-activation rounds to 0
        # in one of the two fp32 expressions (the kernel's fma, cuDNN's own)
        parted = (got[0] > 0) != (y_p > 0)
        assert float(torch.where(parted, (got[0].double() - y_p.double()).abs(), 0.0).max()) \
            <= 1e-4 * float(y_p.abs().max())
        errs = {"parted_masks": int(parted.sum())}
        for name, k, p in zip(("y", "mean", "invstd", "dx", "dweight", "dbias", "running_mean",
                               "running_var"), got, want):
            k, p = k.double(), p.double()
            if name in ("y", "dx"):
                excess = (k - p).abs() - 2 ** -7 * p.abs() - 1e-4 * p.abs().max()
                # dx where the masks agree (elsewhere one passes dy, the other 0)
                excess = float(torch.where(parted, -1.0, excess).max())
            elif name in scale:
                excess = float(((k - p).abs() - 1e-4 * scale[name]).max())
            else:
                excess = float(((k - p).abs() - 1e-4 * p.abs().clamp_min(1e-3)).max())
            assert excess <= 0, f"BN {shape} relu={relu}: {name} beyond its tolerance by {excess}"
            errs[name] = float(torch.where(parted, 0.0, (k - p).abs()).max()
                               if name in ("y", "dx") else (k - p).abs().max())
        del want, y_p, dx_p, parted
        fwd_ms = time_ms(torch, lambda: bn.batch_norm_train_fwd(x, w, b, rm, rv, 0.1, 1e-5, relu,
                                                                True), runs=20)
        bwd_ms = time_ms(torch, lambda: bn.batch_norm_train_bwd(dy, x, w, b, got[1], got[2],
                                                                1e-5, relu), runs=20)
        plain_fwd_ms = time_ms(torch, lambda: bn.batch_norm_train_fwd_plain(
            x, w, b, rm, rv, 0.1, 1e-5, relu, True), runs=10)
        plain_bwd_ms = time_ms(torch, lambda: bn.batch_norm_train_bwd_plain(
            dy, x, w, b, got[1], got[2], 1e-5, relu), runs=10)
        xs = x.detach().requires_grad_()
        wl, bl = w.detach().requires_grad_(), b.detach().requires_grad_()

        def library(backward):
            yl = F.batch_norm(xs.float(), rm, rv, wl, bl, True, 0.1, 1e-5).to(torch.bfloat16)
            yl = F.relu(yl) if relu else yl
            if backward:
                yl.backward(dy)

        library_fwd_ms = time_ms(torch, lambda: library(False), runs=10)
        library_ms = time_ms(torch, lambda: library(True), runs=10)
        elems = x.numel()
        bound_ms = (BN_BYTES_FWD + BN_BYTES_BWD) * elems / gbps * 1e3
        row = {"phase": "kernel", "name": "batch_norm_train", "shape": list(shape), "relu": relu,
               "main": BN_MAIN.get((shape, relu)), "plan": dataclasses.asdict(plan),
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": fwd_ms + bwd_ms,
               "bound_fwd_ms": BN_BYTES_FWD * elems / gbps * 1e3,
               "bound_bwd_ms": BN_BYTES_BWD * elems / gbps * 1e3, "bound_ms": bound_ms,
               "bound_by": "bytes", "bound_share": bound_ms / (fwd_ms + bwd_ms),
               "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
               "plain_ms": plain_fwd_ms + plain_bwd_ms, "library_fwd_ms": library_fwd_ms,
               "library_bwd_ms": library_ms - library_fwd_ms, "library_ms": library_ms,
               "library": "F.batch_norm between bf16<->fp32 casts [ReLU], through autograd",
               "max_abs_err_vs_plain": errs, "max_abs_err": max(errs["y"], errs["dx"])}
        emit(row)
        rows_out.append(row)
        del x, dy, got, xs
        torch.cuda.empty_cache()
    return rows_out


# the soft-binning pair's rows, the class head's logits [B, K, H, W]: the
# AdaBins cell's (the main row) and a small ragged one (K = 24: three of a
# pixel's four lanes hold bins; H·W = 323 not a multiple of a block's slots)
SB_ROWS = [(64, 128, 256, 256), (3, 24, 17, 19)]
SB_MAIN = (64, 128, 256, 256)
SB_BYTES_FWD, SB_BYTES_BWD = 2, 4  # bf16 logits read; read, and their gradient written
# base, the logits' spatial mean and grad_centers against the plain version,
# relative to their scales (the largest |base|; the mean of |logit| over a
# bin's pixels; Σ|g·p| over them): fp32 sums in two orders of 128 bins and
# up to 65,536 pixels, and exp2 against expf
SB_REL_TOL = 1e-5


def _sb_inputs(torch, shape, seed):
    """logits (bf16 channels-last, N(0, 2)), centers (fp32, increasing in
    (0, 30) as the bin predictor's), g_base and g_mean (fp32)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, k, h, w = shape

    def draw(*size):
        return torch.randn(size, generator=g, device="cuda")

    logits = (draw(*shape) * 2.0).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    widths = torch.softmax(draw(b, k), dim=1)
    edges = torch.cumsum(widths, dim=1) * 30.0
    centers = edges - 0.5 * widths * 30.0
    return logits, centers, draw(b, 1, h, w), draw(b, k)


def _bf16_ulp(torch, x):
    """One bf16 ulp of |x| (8 significant bits), x float32."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def phase_kernel_sb(torch, sb, peak):
    """AdaBins' soft-binning pair (`audiodepth::soft_binning_fwd` / `_bwd`)
    at SB_ROWS against its plain version (the model's own chain: cast,
    softmax, product, sum, mean, and that chain's gradient) on the card:
    base and logit_mean within SB_REL_TOL of their scales, grad_logits
    within one bf16 ulp of the plain's (two roundings of fp32 values that
    differ in their last bits) plus 1e-6 of its largest value, grad_centers
    within SB_REL_TOL of Σ|g·p|; two runs bit-equal. The device memory one
    forward and backward through autograd adds to its inputs, against one
    fp32 copy of the logits (4 B an element): the path keeps none. Times
    (median of back-to-back calls): forward, backward, each against its
    bytes bound (SB_BYTES_FWD, SB_BYTES_BWD at the card's published
    bandwidth), the plain version's, and today's PyTorch chain through
    autograd (cast, softmax, product, sum, mean; library_ms, a yardstick the
    port does not call)."""
    gbps = peak[1] * 1e12
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = []
    for shape in SB_ROWS:
        logits, centers, g_base, g_mean = _sb_inputs(torch, shape, seed=len(rows_out))
        b, k, h, w = shape
        plan = sb.sb_plan(b, k, h * w, n_sm)
        runs = []
        for _ in range(2):
            base, mean = sb.soft_binning_fwd(logits, centers)
            dz, dc = sb.soft_binning_bwd(g_base, g_mean, logits, centers, base)
            runs.append((base, mean, dz, dc))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(*runs)), f"SB {shape}: runs differ"
        base, mean, dz, dc = runs[0]
        del runs
        base_p, mean_p = sb.soft_binning_fwd_plain(logits, centers)
        dz_p, dc_p = sb.soft_binning_bwd_plain(g_base, g_mean, logits, centers, base_p)
        probs = torch.softmax(logits.float(), dim=1)
        scale = {"base": base_p.abs().max(),
                 "logit_mean": logits.float().abs().mean(dim=(2, 3)),
                 "grad_centers": (g_base.abs() * probs).sum(dim=(2, 3))}
        del probs
        errs = {}
        for name, got, want in (("base", base, base_p), ("logit_mean", mean, mean_p),
                                ("grad_centers", dc, dc_p)):
            gap = (got - want).abs()
            rel = float((gap / scale[name]).max())
            assert rel <= SB_REL_TOL, f"SB {shape}: {name} {rel} of its scale"
            errs[name] = float(gap.max())
            errs[f"{name}_rel"] = rel
        got, want = dz.float(), dz_p.float()
        gap = (got - want).abs()
        excess = float((gap - _bf16_ulp(torch, want) - 1e-6 * want.abs().max()).max())
        assert excess <= 0, f"SB {shape}: grad_logits beyond one bf16 ulp by {excess}"
        errs["grad_logits"] = float(gap.max())
        errs["grad_logits_beyond_half_ulp"] = int((gap > 0.5 * _bf16_ulp(torch, want)).sum())
        del got, want, gap, dz_p
        torch.cuda.empty_cache()
        # the memory one forward and backward through autograd adds to its inputs
        leaf = logits.detach().requires_grad_()
        c_leaf = centers.detach().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        base_a, mean_a = sb.soft_binning_fwd_op(leaf, c_leaf)
        torch.autograd.backward((base_a, mean_a), (g_base, g_mean))
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - before
        elems = logits.numel()
        assert torch.equal(leaf.grad, dz) and torch.equal(c_leaf.grad, dc), f"SB {shape}: autograd"
        # an fp32 tensor of the logits' shape alone would take 4 B an element
        # (1 MiB for the allocator's rounding of a small shape's tensors)
        assert added < 3 * elems + 2 ** 20, f"SB {shape}: {added} bytes beside the inputs"
        del leaf, c_leaf, base_a, mean_a
        torch.cuda.empty_cache()
        fwd_ms = time_ms(torch, lambda: sb.soft_binning_fwd(logits, centers), runs=20)
        bwd_ms = time_ms(torch, lambda: sb.soft_binning_bwd(g_base, g_mean, logits, centers,
                                                            base), runs=20)
        plain_fwd_ms = time_ms(torch, lambda: sb.soft_binning_fwd_plain(logits, centers), runs=10)
        plain_bwd_ms = time_ms(torch, lambda: sb.soft_binning_bwd_plain(
            g_base, g_mean, logits, centers, base), runs=10)
        xs = logits.detach().requires_grad_()
        cs = centers.detach().requires_grad_()

        def library(backward):
            z = xs.float()
            probs = torch.softmax(z, dim=1)
            out = torch.sum(probs * cs[:, :, None, None], dim=1, keepdim=True)
            m = z.mean(dim=(2, 3))
            if backward:
                torch.autograd.backward((out, m), (g_base, g_mean))

        library_fwd_ms = time_ms(torch, lambda: library(False), runs=10)
        library_ms = time_ms(torch, lambda: library(True), runs=10)
        bound_fwd_ms = SB_BYTES_FWD * elems / gbps * 1e3
        bound_bwd_ms = SB_BYTES_BWD * elems / gbps * 1e3
        row = {"phase": "kernel", "name": "soft_binning", "shape": list(shape),
               "main": shape == SB_MAIN, "plan": dataclasses.asdict(plan),
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": fwd_ms + bwd_ms,
               "bound_fwd_ms": bound_fwd_ms, "bound_bwd_ms": bound_bwd_ms,
               "bound_ms": bound_fwd_ms + bound_bwd_ms, "bound_by": "bytes",
               "bound_share_fwd": bound_fwd_ms / fwd_ms, "bound_share_bwd": bound_bwd_ms / bwd_ms,
               "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
               "plain_ms": plain_fwd_ms + plain_bwd_ms, "library_fwd_ms": library_fwd_ms,
               "library_bwd_ms": library_ms - library_fwd_ms, "library_ms": library_ms,
               "library": "cast, softmax, product, sum and mean through autograd",
               "memory_added_bytes": added, "fp32_copy_bytes": 4 * elems,
               "max_abs_err_vs_plain": errs, "max_abs_err": errs["grad_logits"]}
        emit(row)
        rows_out.append(row)
        del logits, centers, g_base, g_mean, base, mean, dz, dc, xs, cs
        torch.cuda.empty_cache()
    return rows_out


def phase_autograd(torch, fa, blockwise):
    """`cross_attention` (FlashCrossAttentionFn: B2 forward, B3 backward)
    against autograd of the blockwise plain path on the card, values and
    gradients, at level 3 (2B = 32) in bf16 and level 2 (2B = 2) in f32."""
    for label, b, n, dk, dv, dtype in (("level 3", 32, 4096, 32, 256, "bfloat16"),
                                       ("level 2, batch 1", 2, 16384, 16, 128, "float32")):
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(b + n)
        q, k, v = ((torch.randn(b, n, d, device="cuda", generator=g)).to(dt).requires_grad_()
                   for d in (dk, dk, dv))
        do = torch.randn(b, n, dv, device="cuda", generator=g).to(dt)
        scale = 1.0 / dv ** 0.5
        before = fa.flash_cross_attention_bwd.launches
        got = torch.autograd.grad(fa.cross_attention(q, k, v, scale), (q, k, v), do)
        assert fa.flash_cross_attention_bwd.launches == before + 1
        want = torch.autograd.grad(blockwise(q, k, v, scale, block_q=512), (q, k, v), do)
        rel = {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a).all()
            rel[name] = float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
            assert rel[name] <= B3_TOL[dtype], f"autograd {label}: {name} off by {rel}"
        emit({"phase": "autograd", "shape": label, "dtype": dtype, "rel_err": rel,
              "tol_rel": B3_TOL[dtype]})
        del q, k, v, do, got, want
        torch.cuda.empty_cache()


def _post(port, wave):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=wave.astype("float32").tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        shape = tuple(int(s) for s in resp.headers["X-Shape"].split(","))
        return resp.read(), shape


def traced(torch, fn):
    """Run `fn` under torch.profiler (CPU and CUDA activity) in one span,
    after `obs.logging.prime_trace`, from a synchronised start to a synchronised
    end; returns (the span's GPU events read by
    `tools/profile_step.py::parse_trace`, the host wall in s, each
    hand-written kernel's counter over the run)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from audiodepth_tpu_torch.ops.cuda import KERNELS
    from audiodepth_tpu_torch.obs.logging import prime_trace
    from audiodepth_tpu_torch.tools.profile_step import STEP_PREFIX, parse_trace

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime_trace("cuda")  # the trace loses the first records after it starts
            before = {w.name: w.launches for w, _, _ in KERNELS}
            t0 = time.perf_counter()
            with record_function(f"{STEP_PREFIX}0"):
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = parse_trace(path, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counters = {w.name: w.launches - before[w.name] for w, _, _ in KERNELS}
    return trace, wall, counters


def hand_written(trace, counters):
    """Each hand-written kernel's launches in the trace beside its counter."""
    from audiodepth_tpu_torch.tools.profile_step import hand_written_rows

    return {name: {"trace": seen, "counter": counted, "dropped": dropped}
            for name, seen, counted, dropped in hand_written_rows(trace, counters)}


def measure_profile(torch, np, runner, share_of=None):
    """Host wall and device time of one served batch at ladder sizes 1 and
    16 (GPU events of a torch.profiler trace summed by `parse_trace`), and
    the share of device time of the kernels whose name holds `share_of`."""
    out = {"phase": "profile", "model": runner.cfg.model.name}
    for bs in (1, 16):
        waves = (np.random.default_rng(bs).standard_normal((bs, 2, runner.wave_len))
                 * 0.05).astype(np.float32)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            runner.run(waves)
            walls.append(time.perf_counter() - t0)
        trace, wall, counters = traced(torch, lambda: [runner.run(waves) for _ in range(5)])
        kernels = sorted(((d, k) for k, d in trace.per_kernel.items()), reverse=True)
        device_us = trace.total_us
        row = {
            "wall_ms_median": statistics.median(walls) * 1e3,
            "device_ms_per_batch": device_us / 5 / 1e3 if device_us else "not measured",
            "device_busy_share": device_us / 1e6 / wall if device_us else "not measured",
            "n_kernel_names": len(kernels),
            "top_us_per_batch": [[k[:60], d / 5] for d, k in kernels[:8]],
            "hand_written": hand_written(trace, counters)}
        if share_of:
            mine = sum(d for d, k in kernels if share_of in k)
            row[f"{share_of}_share"] = mine / device_us if device_us else "not measured"
            row[f"{share_of}_ms_per_batch"] = mine / 5 / 1e3
        out[f"bs{bs}"] = row
    return out


def reset_launches(kernels) -> None:
    """Every count to 0, just before a path is driven."""
    for wrapper, _, _ in kernels:
        wrapper.launches = 0
        if hasattr(wrapper, "variant_launches"):
            wrapper.variant_launches.clear()


def read_launches(kernels):
    """({kernel: launches}, {kernel: {plan variant: launches}}) since the reset."""
    return ({w.name: w.launches for w, _, _ in kernels},
            {w.name: dict(w.variant_launches) for w, _, _ in kernels
             if hasattr(w, "variant_launches")})


def _gammas(model):
    return [m.gamma for m in model.attention_modules.values()]


def set_gammas(torch, np, model, seed: int = 1234):
    """Give every attention gate a seeded γ ~ N(0, 0.5): γ is zero at init,
    and a zero γ makes the answer independent of the attention."""
    values = np.random.default_rng(seed).normal(0.0, 0.5, len(_gammas(model)))
    with torch.no_grad():
        for gamma, value in zip(_gammas(model), values):
            gamma.fill_(float(value))
    return [float(x) for x in values]


# the two serve paths: flags, the launches each kernel makes per device
# batch, and the kernel whose share of device time the profile reports
SERVE_PATHS = {
    "unet_baseline": {
        "argv": ["--generator", "unet_256", "--ngf", "64"],
        "per_batch": {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 0,
                      "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB},
        "share_of": None},
    "binaural_attention": {
        "argv": ["--model", "binaural_attention", "--base_channels", "64",
                 "--attention_levels", "2,3,4,5"],
        "per_batch": {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4,
                      "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB},
        "share_of": "flash_fwd"},
}


def phase_serve(torch, np, serve, kernels, path: str):
    spec = SERVE_PATHS[path]
    args = serve.build_parser().parse_args(
        ["--random_init", "--seed", "0", *spec["argv"],
         "--compute_dtype", "bfloat16", "--batch_ladder", "1,4,16",
         "--loadtest", "48", "--loadtest_concurrency", "8"])
    cfg, task, source = serve.load_serving_state(args)
    assert cfg.dataset.images_size == 256 and cfg.dataset.name == "batvisionv2"
    assert cfg.model.name == path
    gammas = set_gammas(torch, np, task.model) if path == "binaural_attention" else None
    n_params = sum(p.numel() for p in task.model.parameters())
    runner = serve.InferenceRunner(cfg, task, ladder=[1, 4, 16])
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    warm = runner.warmup()
    batcher = serve.MicroBatcher(runner, wait_ms=args.batch_wait_ms)
    server = serve.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        # first requests pay one-time Python costs (imports, connections)
        warm_http = serve.run_loadtest(port, runner, 16, args.loadtest_concurrency)
        res = serve.run_loadtest(port, runner, args.loadtest, args.loadtest_concurrency)
        wave = (np.random.default_rng(7).standard_normal((2, runner.wave_len)) * 0.05
                ).astype(np.float32)
        body, shape = _post(port, wave)
        direct = runner.run(wave[None])[0, ..., 0]
        direct_again = runner.run(wave[None])[0, ..., 0]
        launches, by_variant = read_launches(kernels)
        # the warm-up runs each ladder size once, then the server's batches
        # and the two direct runs
        device_batches = len(runner.ladder) + batcher.batches + 2
        stats = batcher.stats()
        gamma_effect = None
        if gammas is not None:
            # the same model with every γ at zero must answer differently
            saved = [g.detach().clone() for g in _gammas(task.model)]
            with torch.no_grad():
                for g in _gammas(task.model):
                    g.zero_()
            no_attention = runner.run(wave[None])[0, ..., 0]
            with torch.no_grad():
                for g, v in zip(_gammas(task.model), saved):
                    g.copy_(v)
            gamma_effect = float(np.abs(direct - no_attention).max())
        profile = measure_profile(torch, np, runner, spec["share_of"])
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        runner.close()
        thread.join(timeout=10)
    served = np.frombuffer(body, np.float32).reshape(shape)
    assert res["answered"] == res["requests"] == 48 and res["bad_responses"] == 0, res
    assert warm_http["bad_responses"] == 0, warm_http
    assert shape == (256, 256)
    assert np.isfinite(served).all() and served.min() >= 0 and served.max() <= 30
    # cuDNN does not promise bit-reproducible bf16 answers from run to run
    # (an NCHW-contiguous model gave one-ulp differences between repeats),
    # so the served answer is held to four bf16 ulps at its largest value
    scale = float(np.abs(direct).max())
    served_err = float(np.abs(served - direct).max())
    assert served_err <= SERVED_TOL * scale, (served_err, scale)
    expected = {name: k * device_batches for name, k in spec["per_batch"].items()}
    assert launches == expected, f"{path}: launches {launches}, expected {expected}"
    if gammas is not None:
        assert gamma_effect > SERVED_TOL * scale, f"γ does not reach the answer: {gamma_effect}"
    emit({"phase": "serve", "model": path, "flags": spec["argv"],
          "params": n_params, "images_size": 256, "compute_dtype": "bfloat16",
          "weights": source, "gammas_set_to": gammas, "ladder": runner.ladder,
          "warmup_s": warm, "requests": res["requests"], "answered": res["answered"],
          "bad_responses": res["bad_responses"], "concurrency": res["concurrency"],
          "warmup_http": {k: warm_http[k] for k in ("throughput_rps", "p50_ms", "p99_ms")},
          "throughput_rps": res["throughput_rps"], "p50_ms": res["p50_ms"],
          "p95_ms": res["p95_ms"], "p99_ms": res["p99_ms"],
          "device_batches": device_batches, "mean_batch_fill": stats.get("mean_batch_fill"),
          "launches": launches, "launches_by_variant": by_variant,
          "expected_launches": expected, "served_vs_direct_max_abs": served_err, "direct_max_abs": scale,
          "direct_repeat_max_abs": float(np.abs(direct_again - direct).max()),
          "gamma_zero_vs_set_max_abs": gamma_effect,
          "depth_range_m": [float(served.min()), float(served.max())],
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile)
    return launches, by_variant


def phase_f32_vs_cpu(torch, np, configs, models, path: str):
    """The same seeded model in float32 (TF32 off) through `predict_meters`
    on the card and on the CPU, at full width, 256² and batch 1; the
    binaural model with every γ non-zero, so B2's f32 path is in the sum."""
    cfg = configs.load_config("batvisionv2", "test", model_name=path, overrides={
        "mode.compute_dtype": "float32"})
    cpu = models.make_task(cfg, device="cpu")
    models.init_weights(cpu.model, torch.Generator().manual_seed(0))
    if path == "binaural_attention":
        set_gammas(torch, np, cpu.model)
    gpu = models.make_task(cfg, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    wave = (np.random.default_rng(11).standard_normal((1, 2, 7782)) * 0.05).astype(np.float32)
    t0 = time.perf_counter()
    want = cpu.predict_meters({"waveform": wave}).numpy()
    cpu_s = time.perf_counter() - t0
    got = gpu.predict_meters({"waveform": wave}).cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape == (1, 256, 256, 1) and np.isfinite(got).all()
    assert scale > 0 and err <= F32_VS_CPU_TOL * scale, (err, scale)
    emit({"phase": "f32_vs_cpu", "model": path, "max_abs_err": err, "max_abs_cpu": scale,
          "rel_err": err / scale, "tol_rel": F32_VS_CPU_TOL, "cpu_seconds": cpu_s})


# the training path: flags of cli/train.py's main, and the launches each
# kernel makes per train step and per eval batch
TRAIN_BATCH = 16
TRAIN_ARGV = ["--dataset", "synthetic", "--model", "binaural_attention",
              "--base_channels", "64", "--attention_levels", "2,3,4,5",
              "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
              "--num_samples", "64", "--epochs", "1", "--validation", "true",
              "--validation_iter", "1", "--seed", "0"]
VAL_SAMPLES = 64  # the synthetic val split (data/batvision.py)
PER_TRAIN_STEP = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4,
                  "flash_cross_attention_bwd": 4, **bn_launches("binaural_attention", 1),
                  **NO_SB}
PER_EVAL_BATCH = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 4,
                  "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB}
REPEATED_STEPS = 8


def phase_train(torch, np, train_cli, kernels, ckpt_root):
    """cli/train.py's main in-process on the card (see the module note),
    its checkpoint under `ckpt_root` (for examples_compare), then
    REPEATED_STEPS steps on one batch, timed, and a profile of one."""
    from audiodepth_tpu_torch.data.batvision import make_dataset

    seen, steps = {}, []

    def on_task(task):
        seen["task"] = task
        seen["gammas"] = set_gammas(torch, np, task.model)
        seen["before"] = {n: p.detach().clone() for n, p in task.model.named_parameters()}

    def on_step(state, metrics):
        if not steps:  # the first step's gradients are still on the parameters
            seen["first_grads"] = {
                n: float(p.grad.abs().max()) for n, p in state.model.named_parameters()
                if n.startswith("attention_modules.") and ".gamma" not in n}
        steps.append(metrics)

    argv = TRAIN_ARGV + ["--ckpt_dir", ckpt_root]
    reset_launches(kernels)
    t0 = time.perf_counter()
    eng, state = train_cli.main(argv, on_task=on_task, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    task, record = seen["task"], eng.history[-1]
    cfg = task.cfg
    assert cfg.dataset.images_size == 256 and cfg.model.base_channels == 64
    assert cfg.mode.compute_dtype == "bfloat16" and task.model.left_encoder.remat
    assert tuple(cfg.model.attention_levels) == (2, 3, 4, 5)
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    assert len(steps) == 64 // TRAIN_BATCH, len(steps)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    unmoved = [n for n, p in task.model.named_parameters()
               if torch.equal(p.detach(), seen["before"][n])]
    assert not unmoved, f"parameters that did not move: {unmoved[:8]}"
    zero = [n for n, g in seen["first_grads"].items() if not g > 0]
    assert len(seen["first_grads"]) == 4 * 8 and not zero, f"zero attention gradients: {zero}"
    n_eval = -(-VAL_SAMPLES // TRAIN_BATCH)
    # + 1: the detectors' forward on the first val batch of the validated epoch
    expected = {name: PER_TRAIN_STEP[name] * len(steps) + PER_EVAL_BATCH[name] * (n_eval + 1)
                for name in PER_TRAIN_STEP}
    assert launches == expected, f"train: launches {launches}, expected {expected}"
    val = record["val"]
    assert val and all(np.isfinite(v) for v in val.values()), val

    # one batch, repeated: the loss must fall; each step timed to its end
    ds = make_dataset(cfg, "train", num_samples=TRAIN_BATCH)
    batch = eng.encode(next(ds.batches(TRAIN_BATCH, shuffle=False)))
    torch.cuda.reset_peak_memory_stats()
    rep_losses, times = [], []
    for _ in range(REPEATED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rep_losses.append(float(metrics["loss"]))
    assert all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0], rep_losses
    step_ms = statistics.median(times[1:]) * 1e3
    emit({"phase": "train", "flags": argv, "remat": True, "gammas_set_to": seen["gammas"],
          "params": sum(p.numel() for p in task.model.parameters()),
          "steps": len(steps), "eval_batches": n_eval, "losses": losses, "grad_norms": norms,
          "first_step_attention_grad_min": min(seen["first_grads"].values()),
          "launches": launches, "launches_by_variant": by_variant,
          "expected_launches": expected, "epoch_record": record,
          "main_wall_s": wall, "repeated_batch_losses": rep_losses,
          "step_ms_median": step_ms, "step_ms_all": [t * 1e3 for t in times],
          "pairs_per_sec": TRAIN_BATCH / (step_ms / 1e3),
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile_train_step(torch, eng, state, batch))
    return launches, by_variant


def profile_train_step(torch, eng, state, batch, model="binaural_attention",
                       tags=("flash_fwd", "flash_bwd"), what="one bf16 train step"):
    """Host wall and device time of one train step (GPU events of a
    torch.profiler trace summed by `parse_trace`), the top items, the
    shares of the kernels named by `tags` (B2: flash_fwd, B3: flash_bwd,
    B1: fused_mel) and each hand-written kernel's launches in the trace
    beside its counter."""
    trace, wall, counters = traced(torch, lambda: eng.train_step(state, batch))
    kernels = sorted(((d, k) for k, d in trace.per_kernel.items()), reverse=True)
    device_us = trace.total_us
    row = {"phase": "profile", "model": model, "what": what,
           "batch": TRAIN_BATCH, "wall_ms": wall * 1e3,
           "device_ms": device_us / 1e3 if device_us else "not measured",
           "device_busy_share": device_us / 1e6 / wall if device_us else "not measured",
           "busy_union_share": trace.busy_us / 1e6 / wall if device_us else "not measured",
           "n_kernel_names": len(kernels),
           "top_ms": [[k[:60], d / 1e3] for d, k in kernels[:12]],
           "hand_written": hand_written(trace, counters)}
    for tag in tags:
        mine = sum(d for d, k in kernels if tag in k)
        row[f"{tag}_ms"] = mine / 1e3
        row[f"{tag}_share"] = mine / device_us if device_us else "not measured"
    return row


# the float32 training path (`--compute_dtype float32`, the reference's own
# numerics): the binaural net at base 64, levels 2-5, 256², batch 16, its
# attention through B2's and B3's three-piece variants
TRAIN_F32_ARGV = ["--dataset", "synthetic", "--model", "binaural_attention",
                  "--base_channels", "64", "--attention_levels", "2,3,4,5",
                  "--compute_dtype", "float32", "--batch_size", str(TRAIN_BATCH),
                  "--num_samples", str(2 * TRAIN_BATCH), "--epochs", "1",
                  "--validation", "false", "--seed", "0"]
TRAIN_F32_TIMED_STEPS = 5
# B2's and B3's launches a float32 step by plan variant
F32_VARIANTS_PER_STEP = {"flash_cross_attention_fwd": {"wgmma_bf16x3": 4},
                         "flash_cross_attention_bwd": {"split_bf16x3": 4}}


def phase_train_f32(torch, np, train_cli, kernels):
    """cli/train.py's main in-process in float32 (two steps, every γ set
    non-zero after init): losses and grad_norms finite, every parameter
    moved, B1 1 / B2 4 / B3 4 launches a step, B2's and B3's on their
    float32 variants (F32_VARIANTS_PER_STEP); then TRAIN_F32_TIMED_STEPS
    steps on one repeated batch (the loss must fall), timed, with the peak
    memory, and a profile of one. Returns (launches, by variant)."""
    from audiodepth_tpu_torch.data.batvision import make_dataset

    gammas = {}
    eng, state, steps, launches, by_variant, seen = _train_run(
        torch, train_cli, kernels, TRAIN_F32_ARGV,
        on_task=lambda task: gammas.update(g=set_gammas(torch, np, task.model)))
    task = seen["task"]
    cfg = task.cfg
    assert cfg.mode.compute_dtype == "float32" and cfg.model.base_channels == 64
    assert cfg.dataset.images_size == 256 and tuple(cfg.model.attention_levels) == (2, 3, 4, 5)
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    assert len(steps) == 2 and all(np.isfinite(losses)) and all(np.isfinite(norms))
    unmoved = [n for n, p in task.model.named_parameters()
               if torch.equal(p.detach(), seen["before"][n])]
    assert not unmoved, f"parameters that did not move: {unmoved[:8]}"
    # float32: BatchNorm keeps its own code
    expected = dict({name: PER_TRAIN_STEP[name] * len(steps) for name in PER_TRAIN_STEP}, **NO_BN,
                    **NO_SB)
    assert launches == expected, f"train_f32: launches {launches}, expected {expected}"
    for name, per_step in F32_VARIANTS_PER_STEP.items():
        assert by_variant[name] == {v: k * len(steps) for v, k in per_step.items()}, \
            (name, by_variant[name])

    ds = make_dataset(cfg, "train", num_samples=TRAIN_BATCH)
    batch = eng.encode(next(ds.batches(TRAIN_BATCH, shuffle=False)))
    torch.cuda.reset_peak_memory_stats()
    rep_losses, times = [], []
    for _ in range(TRAIN_F32_TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rep_losses.append(float(metrics["loss"]))
    assert all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0], rep_losses
    step_ms = statistics.median(times[1:]) * 1e3
    emit({"phase": "train_f32", "flags": TRAIN_F32_ARGV, "gammas_set_to": gammas["g"],
          "params": sum(p.numel() for p in task.model.parameters()), "steps": len(steps),
          "losses": losses, "grad_norms": norms, "launches": launches,
          "launches_by_variant": by_variant, "expected_launches": expected,
          "main_wall_s": seen["wall"], "repeated_batch_losses": rep_losses,
          "step_ms_median": step_ms, "step_ms_all": [t * 1e3 for t in times],
          "pairs_per_sec": TRAIN_BATCH / (step_ms / 1e3),
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    emit(profile_train_step(torch, eng, state, batch, tags=("flash_fwd", "flash_bwd",
                                                           "flash_split3"),
                            what="one float32 train step"))
    return launches, by_variant


def phase_f32_train_vs_cpu(torch, np, configs, models, model_name):
    """One seeded float32 train step (TF32 off) at full width, 256², batch
    2 (the binaural net with every γ non-zero), on the card and on the CPU
    from one state_dict, and the same step in float64 on the CPU as the
    reference.

    The loss: card within F32_TRAIN_TOL of the CPU's float32 loss. The
    gradients: this step's float32 gradient field is ill-conditioned (the
    CPU's own float32 gradients are 0.8 % off its float64 ones in global L2,
    7 % on the worst tensor), so a float32-vs-float32 gate at 1e-3 fails
    for correct code. Both float32 gradients are measured against float64,
    each tensor relative to max(its max, 1e-3 · the largest max over all
    tensors), and the card must be as close as the CPU: its global
    relative L2 error within F32_GRAD_FACTOR × the CPU's, and its worst
    tensor within F32_GRAD_FACTOR × the CPU's worst. A wrong kernel moves
    the tensors it feeds by O(1) and fails both. `model_name` may name a
    coarse_depth variant (coarse_depth/<model_type>), whose batch gets the
    CLI's host bins."""
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.models import adabins

    family, _, model_type = model_name.partition("/")

    def cfg_for(dtype):
        overrides = {"mode.compute_dtype": dtype}
        if model_type:
            overrides["model.model_type"] = model_type
        return configs.load_config("synthetic", "train", model_name=family,
                                   overrides=overrides)

    # AdaBins' dropout: the same keep masks on every device (audio's, then
    # rgb's, drawn on the CPU), so the three steps differ only in arithmetic
    draws = [0]

    def same_masks(h, generator):
        g = torch.Generator().manual_seed(draws[0] % 2)
        draws[0] += 1
        return (torch.rand(h.shape, generator=g) < 1.0 - adabins.DROPOUT).to(h.device)

    keep, adabins.dropout_keep = adabins.dropout_keep, same_masks
    try:
        _f32_train_vs_cpu(torch, np, models, model_name, cfg_for, make_dataset)
    finally:
        adabins.dropout_keep = keep


def _f32_train_vs_cpu(torch, np, models, model_name, cfg_for, make_dataset):

    cpu = models.make_task(cfg_for("float32"), device="cpu")
    models.init_weights(cpu.model, torch.Generator().manual_seed(0))
    if model_name == "binaural_attention":
        set_gammas(torch, np, cpu.model)
    state_dict = cpu.model.state_dict()
    gpu = models.make_task(cfg_for("float32"), device="cuda")
    gpu.model.load_state_dict(state_dict, strict=True)
    ref = models.make_task(cfg_for("float64"), device="cpu")
    ref.model.double().load_state_dict(state_dict, strict=True)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    image = {"with_image": True} if model_name in ("rgb_depth", "adabins_distillation") else {}
    batch = next(make_dataset(cfg_for("float32"), "train", num_samples=2, **image)
                 .batches(2, shuffle=False))
    if cpu.cfg.model.name == "coarse_depth":
        from audiodepth_tpu_torch.data.bins import add_bins_to_batch

        batch = add_bins_to_batch(batch, cpu.bin_edges, cpu.max_depth, cpu.depth_norm)

    def step(task):
        t0 = time.perf_counter()
        task.model.zero_grad(set_to_none=True)
        dev = {k: torch.from_numpy(v).to(task.device) for k, v in batch.items()}
        loss, _ = task.loss_fn(dev, 0.0)
        loss.backward()
        # a frozen teacher's parameters have no gradient
        grads = {n: p.grad.detach().cpu().double() for n, p in task.model.named_parameters()
                 if p.grad is not None}
        return loss.item(), grads, time.perf_counter() - t0

    want_loss, want, cpu_s = step(ref)
    cpu_loss, cpu_grads, cpu32_s = step(cpu)
    got_loss, got, _ = step(gpu)
    assert np.isfinite(got_loss) and abs(got_loss - cpu_loss) <= F32_TRAIN_TOL * abs(cpu_loss)
    gmax = max(float(g.abs().max()) for g in want.values())
    ref_l2 = float(torch.sqrt(sum((g * g).sum() for g in want.values())))

    def errors(grads):
        per = {n: float((grads[n] - w).abs().max()) / max(float(w.abs().max()), 1e-3 * gmax)
               for n, w in want.items()}
        l2 = float(torch.sqrt(sum(((grads[n] - w) ** 2).sum() for n, w in want.items())))
        return per, l2 / ref_l2

    card_per, card_l2 = errors(got)
    cpu_per, cpu_l2 = errors(cpu_grads)
    worst = max(card_per, key=card_per.get)
    cpu_worst = max(cpu_per.values())
    assert card_l2 <= F32_GRAD_FACTOR * cpu_l2, (card_l2, cpu_l2)
    assert card_per[worst] <= F32_GRAD_FACTOR * cpu_worst, (worst, card_per[worst], cpu_worst)
    # the per-tensor measure card vs CPU float32, as reported before the f64 reference
    vs_cpu32 = max(float((got[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * gmax)
                   for n, g in cpu_grads.items())
    attention = max((v for n, v in card_per.items() if n.startswith("attention_modules.")),
                    default=None)
    emit({"phase": "f32_train_vs_cpu", "model": model_name, "loss_f64": want_loss,
          "loss_cpu_f32": cpu_loss,
          "loss_card_f32": got_loss, "loss_tol_rel": F32_TRAIN_TOL,
          "card_vs_f64_global_l2_rel": card_l2, "cpu_f32_vs_f64_global_l2_rel": cpu_l2,
          "card_vs_f64_worst_tensor": [worst, card_per[worst]],
          "cpu_f32_vs_f64_worst_tensor": cpu_worst, "grad_factor": F32_GRAD_FACTOR,
          "card_vs_f64_worst_attention_tensor": attention,
          "card_vs_cpu_f32_worst_tensor": vs_cpu32,
          "tensors_over_1e-3": {"card": sum(v > 1e-3 for v in card_per.values()),
                                "cpu_f32": sum(v > 1e-3 for v in cpu_per.values()),
                                "of": len(card_per)},
          "largest_grad_max": gmax, "cpu_f64_seconds": cpu_s, "cpu_f32_seconds": cpu32_s})

# the main training path: unet_baseline (unet_256, ngf 64) on BatVision
# V2's shapes, bf16, batch 16, with checkpoints; B1 runs once a step and
# once an eval batch, B2 and B3 never
UNET_NGF, UNET_PARAMS = 64, 54_408_833
UNET_TRAIN_ARGV = ["--dataset", "synthetic", "--model", "unet_baseline",
                   "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
                   "--num_samples", "64", "--epochs", "1", "--validation", "true",
                   "--validation_iter", "1", "--seed", "0", "--saving_checkpoints", "1"]
UNET_PER_TRAIN_STEP = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 0,
                       "flash_cross_attention_bwd": 0, **bn_launches("unet_baseline", 1),
                       **NO_SB}
UNET_PER_EVAL_BATCH = dict(UNET_PER_TRAIN_STEP, **NO_BN, **NO_SB)
# the larger batch of one timed unet step: the config's batch
# (conf/mode/train.yaml: 256), the largest of 256, 128 and 64 that fits
UNET_BIG_BATCH = 256
# the binaural widths the C1 repair opened, one train step each at batch 2
WIDTH_BASES = (16, 128)


def _train_run(torch, train_cli, kernels, argv, on_task=None):
    """cli/train.py's main with the counts reset just before and read just
    after: (engine, state, per-step metrics, launches, by variant, seen)."""
    seen, steps = {}, []

    def task_hook(task):
        seen["task"] = task
        seen["before"] = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        if on_task is not None:
            on_task(task)

    reset_launches(kernels)
    t0 = time.perf_counter()
    eng, state = train_cli.main(argv, on_task=task_hook, on_step=lambda s, m: steps.append(m))
    torch.cuda.synchronize()
    seen["wall"] = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    return eng, state, steps, launches, by_variant, seen


def phase_train_unet(torch, np, train_cli, kernels, ckpt_root):
    """The main training path through cli/train.py's main in-process:
    unet_baseline at full width on BV2's shapes (synthetic data), bf16,
    batch 16, 64 samples (4 steps), one validation pass of 64, checkpoints
    under `ckpt_root`. Every loss and grad_norm finite, every parameter
    moved, val metrics finite, B1 launched once a step and once an eval
    batch and B2 and B3 never."""
    argv = UNET_TRAIN_ARGV + ["--ckpt_dir", ckpt_root]
    eng, state, steps, launches, by_variant, seen = _train_run(torch, train_cli, kernels, argv)
    task, record = seen["task"], eng.history[-1]
    cfg = task.cfg
    n_params = sum(p.numel() for p in task.model.parameters())
    assert cfg.dataset.images_size == 256 and cfg.model.generator == "unet_256"
    assert cfg.model.ngf == UNET_NGF and n_params == UNET_PARAMS, n_params
    assert cfg.mode.compute_dtype == "bfloat16" and cfg.mode.criterion == "Combined"
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    assert len(steps) == 64 // TRAIN_BATCH, len(steps)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    unmoved = [n for n, p in task.model.named_parameters()
               if torch.equal(p.detach(), seen["before"][n])]
    assert not unmoved, f"parameters that did not move: {unmoved[:8]}"
    n_eval = -(-VAL_SAMPLES // TRAIN_BATCH)
    # + 1: the detectors' forward on the first val batch of the validated epoch
    expected = {name: UNET_PER_TRAIN_STEP[name] * len(steps)
                + UNET_PER_EVAL_BATCH[name] * (n_eval + 1) for name in UNET_PER_TRAIN_STEP}
    assert launches == expected, f"train unet: launches {launches}, expected {expected}"
    val = record["val"]
    assert val and all(np.isfinite(v) for v in val.values()), val
    emit({"phase": "train_unet", "flags": argv, "params": n_params, "steps": len(steps),
          "eval_batches": n_eval, "losses": losses, "grad_norms": norms,
          "launches": launches, "launches_by_variant": by_variant, "expected_launches": expected,
          "epoch_record": record, "main_wall_s": seen["wall"]})
    return eng, state, (launches, by_variant)


def phase_unet_steps(torch, np, eng, state):
    """REPEATED_STEPS steps of the trained unet on one batch of 16, each timed
    to its end (the loss must fall), a profile of one, then two steps at
    UNET_BIG_BATCH, the second timed, with the peak memory of each batch."""
    from audiodepth_tpu_torch.data.batvision import make_dataset

    cfg = eng.cfg
    ds = make_dataset(cfg, "train", num_samples=TRAIN_BATCH)
    batch = eng.encode(next(ds.batches(TRAIN_BATCH, shuffle=False)))
    torch.cuda.reset_peak_memory_stats()
    rep_losses, times = [], []
    for _ in range(REPEATED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rep_losses.append(float(metrics["loss"]))
    assert all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0], rep_losses
    step_ms = statistics.median(times[1:]) * 1e3
    peak16 = torch.cuda.max_memory_allocated() / 2**20
    emit({"phase": "train_unet_steps", "batch": TRAIN_BATCH, "repeated_batch_losses": rep_losses,
          "step_ms_median": step_ms, "step_ms_all": [t * 1e3 for t in times],
          "pairs_per_sec": TRAIN_BATCH / (step_ms / 1e3), "peak_mem_mb": peak16})
    emit(profile_train_step(torch, eng, state, batch, "unet_baseline", ("fused_mel",)))

    big = make_dataset(cfg, "train", num_samples=UNET_BIG_BATCH)
    big_batch = eng.encode(next(big.batches(UNET_BIG_BATCH, shuffle=False)))
    torch.cuda.reset_peak_memory_stats()
    big_times, big_losses = [], []
    for _ in range(2):  # the first at a new batch size picks cuDNN's algorithms
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = eng.train_step(state, big_batch)
        torch.cuda.synchronize()
        big_times.append(time.perf_counter() - t1)
        big_losses.append(float(metrics["loss"]))
    assert all(np.isfinite(big_losses)), big_losses
    emit({"phase": "train_unet_big_batch", "batch": UNET_BIG_BATCH,
          "step_ms": big_times[1] * 1e3, "first_step_ms": big_times[0] * 1e3,
          "pairs_per_sec": UNET_BIG_BATCH / big_times[1], "losses": big_losses,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
          "total_mem_mb": torch.cuda.get_device_properties(0).total_memory / 2**20})


def serve_checkpoint(torch, np, serve, kernels, eng, exp_dir, flags, per_batch):
    """`serve` restores the best checkpoint under `exp_dir` (--checkpoint_path,
    --use_best) on the card and answers HTTP requests: an 8-request
    loadtest, then three answers each within SERVED_TOL of the trained
    task's own at that epoch (the task is given the best epoch's weights
    first), and `per_batch` launches per device batch. Returns (source,
    loadtest result, errors, launches, by variant, expected launches)."""
    from audiodepth_tpu_torch.ckpt import CheckpointManager

    best_sd, _, _ = CheckpointManager(os.path.dirname(exp_dir), os.path.basename(exp_dir),
                                      create=False).restore_eval(epoch="best")
    eng.task.model.load_state_dict(best_sd, strict=True)
    waves = (np.random.default_rng(21).standard_normal((3, 2, 7782)) * 0.05).astype(np.float32)
    dev = eng.task.device
    trained = [np.clip(eng.task.predict_meters({"waveform": torch.from_numpy(w[None]).to(dev)})
                       .float().cpu().numpy()[0, ..., 0], 0.0, eng.cfg.dataset.max_depth)
               for w in waves]
    args = serve.build_parser().parse_args(
        ["--checkpoint_path", exp_dir, "--use_best", "--device", str(dev), *flags,
         "--compute_dtype", eng.cfg.mode.compute_dtype, "--batch_ladder", "1,4"])
    cfg, task, source = serve.load_serving_state(args)
    runner = serve.InferenceRunner(cfg, task, ladder=[1, 4])
    reset_launches(kernels)
    runner.warmup()
    batcher = serve.MicroBatcher(runner, wait_ms=args.batch_wait_ms)
    server = serve.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        res = serve.run_loadtest(port, runner, 8, 4)
        answers = []
        for w in waves:
            body, shape = _post(port, w)
            answers.append(np.frombuffer(body, np.float32).reshape(shape))
        launches, by_variant = read_launches(kernels)
        device_batches = len(runner.ladder) + batcher.batches
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        runner.close()
        thread.join(timeout=10)
    assert res["answered"] == res["requests"] == 8 and res["bad_responses"] == 0, res
    errs = []
    for got, want in zip(answers, trained):
        assert got.shape == (256, 256) and np.isfinite(got).all()
        errs.append(float(np.abs(got - want).max()))
        assert errs[-1] <= SERVED_TOL * float(np.abs(want).max()), (errs, float(np.abs(want).max()))
    expected = {name: k * device_batches for name, k in per_batch.items()}
    assert launches == expected, f"serve {exp_dir}: launches {launches}, expected {expected}"
    del task, runner
    return source, res, errs, launches, by_variant, expected


def phase_ckpt_round_trip(torch, np, serve, train_cli, kernels, eng, ckpt_root):
    """The checkpoint phase_train_unet wrote, restored by `serve`
    (--checkpoint_path, --use_best) on the card: a few HTTP requests, each
    answer within SERVED_TOL of the trained task's direct answer; then
    `--resume` takes one more step from the saved step."""
    from audiodepth_tpu_torch.configs import experiment_name

    exp_dir = os.path.join(ckpt_root, experiment_name(eng.cfg))
    source, res, errs, launches, by_variant, expected = serve_checkpoint(
        torch, np, serve, kernels, eng, exp_dir,
        ["--generator", eng.cfg.model.generator, "--ngf", str(eng.cfg.model.ngf)],
        UNET_PER_EVAL_BATCH)

    # --resume: the latest epoch's state and step, then one more step
    saved_step = eng.history[-1]["steps"]
    argv = UNET_TRAIN_ARGV + ["--ckpt_dir", ckpt_root, "--resume", "--epochs", "2",
                              "--num_samples", str(TRAIN_BATCH), "--validation", "false"]
    eng2, state2 = train_cli.main(argv)
    assert [r["epoch"] for r in eng2.history] == [2], eng2.history
    assert state2.step == saved_step + 1 and np.isfinite(eng2.history[0]["loss"])
    emit({"phase": "ckpt_round_trip", "checkpoint": source, "files": sorted(os.listdir(exp_dir)),
          "requests": res["requests"], "bad_responses": res["bad_responses"],
          "served_vs_trained_max_abs": errs, "tol_rel": SERVED_TOL,
          "launches": launches, "expected_launches": expected,
          "resumed_step": state2.step, "resumed_loss": eng2.history[0]["loss"]})
    del eng2, state2
    torch.cuda.empty_cache()
    return launches, by_variant


def phase_train_widths(torch, np, train_cli, kernels, base):
    """One bf16 train step of binaural_attention at `base` (levels 2-5,
    256², batch 2, every γ set non-zero) through cli/train.py: the widths
    the C1 repair opened reach B2 and B3 (4 launches each a step)."""
    argv = ["--dataset", "synthetic", "--model", "binaural_attention",
            "--base_channels", str(base), "--attention_levels", "2,3,4,5",
            "--compute_dtype", "bfloat16", "--batch_size", "2", "--num_samples", "2",
            "--epochs", "1", "--validation", "false", "--seed", "0"]
    gammas = {}
    eng, state, steps, launches, by_variant, seen = _train_run(
        torch, train_cli, kernels, argv,
        on_task=lambda task: gammas.update(g=set_gammas(torch, np, task.model)))
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    assert len(steps) == 1 and all(np.isfinite(losses)) and all(np.isfinite(norms))
    expected = {name: PER_TRAIN_STEP[name] for name in PER_TRAIN_STEP}
    assert launches == expected, f"train base {base}: launches {launches}, expected {expected}"
    emit({"phase": "train_width", "base_channels": base, "gammas_set_to": gammas["g"],
          "params": sum(p.numel() for p in seen["task"].model.parameters()),
          "losses": losses, "grad_norms": norms, "launches": launches,
          "launches_by_variant": by_variant, "expected_launches": expected})
    del eng, state, seen
    torch.cuda.empty_cache()
    return launches, by_variant


# ---------------------------------------------------------------------------
# the other families (ROADMAP A5.1-A5.4): each trained through cli/train.py at
# full width, timed, profiled, and the audio ones served from a checkpoint
# ---------------------------------------------------------------------------

B1_ONCE = {"fused_mel_frontend": 1, "flash_cross_attention_fwd": 0,
           "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB}
NO_KERNEL = {"fused_mel_frontend": 0, "flash_cross_attention_fwd": 0,
             "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB}
# family → (its flags beyond the preset, parameters, launches per train step,
# eval batch and detector forward, the serve flags of its shapes or None)
FAMILIES = {
    "base_residual": (["--warmup_epochs", "1"], 23_589_074, B1_ONCE,
                      ["--model", "base_residual", "--base_channels", "64"]),
    "unet_cvae": ([], 50_413_059, B1_ONCE,
                  ["--model", "unet_cvae", "--generator", "unet_256", "--ngf", "64"]),
    "adabins_distillation": ([], 42_614_529, B1_ONCE,
                             ["--model", "adabins_distillation", "--base_channels", "64",
                              "--n_bins", "128"]),
    "rgb_depth": ([], 17_262_977, NO_KERNEL, None),
}
# the coarse_depth variants at the preset's width: base 64, 128 sid bins
COARSE_PARAMS = {"unet": 17_270_656, "lite": 14_042_560, "hybrid": 25_181_825,
                 "dual_reg": 25_173_570}
for _t, _n in COARSE_PARAMS.items():
    _shape = ["--model_type", _t, "--base_channels", "64", "--n_bins", "128"]
    # the variants share a model name: each its own experiment directory
    FAMILIES[f"coarse_depth/{_t}"] = (_shape + ["--bin_strategy", "sid", "--experiment_name",
                                                _t], _n, B1_ONCE,
                                      ["--model", "coarse_depth", *_shape])
FAMILY_SAMPLES, FAMILY_EPOCHS = 2 * TRAIN_BATCH, 2  # 2 epochs of 2 steps


def _family_argv(family, extra=()):
    """`family` is a model name, or coarse_depth/<model_type>."""
    return ["--dataset", "synthetic", "--model", family.split("/")[0],
            "--compute_dtype", "bfloat16",
            "--batch_size", str(TRAIN_BATCH), "--num_samples", str(FAMILY_SAMPLES),
            "--epochs", str(FAMILY_EPOCHS), "--validation", "true", "--validation_iter", "1",
            "--seed", "0", "--saving_checkpoints", "1", *FAMILIES[family][0], *extra]


def _moved_checks(torch, task, before, buffers_before):
    """The trainable parameters that did not move, those that got no
    gradient in the last step, and for a frozen teacher its parameters that
    moved and its BatchNorm buffers that did not."""
    trainable = {id(p) for p in task.trainable_parameters()}
    named = dict(task.model.named_parameters())
    no_grad = sorted(n for n, p in named.items() if id(p) in trainable and p.grad is None)
    unmoved = [n for n, p in named.items() if id(p) in trainable and p.grad is not None
               and torch.equal(p.detach(), before[n])]
    frozen = [n for n, p in named.items() if id(p) not in trainable]
    teacher_moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    buffers = {n: b for n, b in task.model.named_buffers()
               if n.startswith("rgb_") and n.endswith(("running_mean", "running_var"))}
    still = [n for n, b in buffers.items() if torch.equal(b, buffers_before[n])]
    return unmoved, no_grad, frozen, teacher_moved, buffers, still


def phase_train_family(torch, np, train_cli, serve, kernels, family, ckpt_root, export=None):
    """One family (a coarse_depth variant: coarse_depth/<model_type>)
    through cli/train.py's main in-process at full width
    (its preset: base 64, unet_256, n_bins 128), 256², bf16, batch 16,
    synthetic data (with images where it reads them), 2 epochs of 2 steps,
    each validated, checkpoints under `ckpt_root`. Every loss and grad_norm
    finite, every trainable parameter moved (the AdaBins teacher bit for
    bit unmoved, its BatchNorm running buffers moved), B1 once per step,
    eval batch and detector forward for the audio families and never for
    rgb_depth, B2 and B3 never. Then REPEATED_STEPS steps on one batch (the
    loss must fall), timed, with the peak memory, a profile of one step,
    and for the audio families `serve` from the best checkpoint (for the
    coarse unet, also with linear bins written into its aux: `phase_aux_centers`,
    whose checkpoint `tools/export.py` exports into `export` = (work
    directory, list of jobs) for phase_export)."""
    from audiodepth_tpu_torch.configs import experiment_name
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.bins import add_bins_to_batch
    from audiodepth_tpu_torch.data.codec import decode_batch

    extra, n_params, per, serve_flags = FAMILIES[family]
    argv = _family_argv(family, ["--ckpt_dir", ckpt_root])
    snap = {}

    def on_task(task):
        snap["buffers"] = {n: b.detach().clone() for n, b in task.model.named_buffers()}

    eng, state, steps, launches, by_variant, seen = _train_run(torch, train_cli, kernels, argv,
                                                               on_task=on_task)
    task, cfg = seen["task"], seen["task"].cfg
    assert cfg.dataset.images_size == 256 and cfg.mode.compute_dtype == "bfloat16"
    assert sum(p.numel() for p in task.model.parameters()) == n_params
    losses = [float(m["loss"]) for m in steps]
    norms = [float(m["grad_norm"]) for m in steps]
    n_steps = FAMILY_SAMPLES // TRAIN_BATCH * FAMILY_EPOCHS
    assert len(steps) == n_steps, len(steps)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    unmoved, no_grad, frozen, teacher_moved, buffers, still = _moved_checks(
        torch, task, seen["before"], snap["buffers"])
    assert not unmoved, f"{family}: trainable parameters that did not move: {unmoved[:8]}"
    # only the cVAE's never-run BatchNorms get no gradient
    dead = sorted(task.model.never_run()) if family == "unet_cvae" else []
    assert no_grad == dead, f"{family}: parameters without a gradient: {no_grad[:8]}"
    if family == "adabins_distillation":
        assert frozen and all(n.startswith("rgb_") for n in frozen), frozen[:4]
        assert not teacher_moved, f"teacher parameters moved: {teacher_moved[:8]}"
        assert buffers and not still, f"teacher BatchNorm buffers that did not move: {still[:4]}"
    else:
        assert not frozen, frozen[:4]
    n_eval = -(-VAL_SAMPLES // TRAIN_BATCH)
    # per epoch: its steps, its eval batches and the detectors' forward
    expected = {k: per[k] * (n_steps + FAMILY_EPOCHS * (n_eval + 1)) for k in per}
    expected.update(bn_launches(family, n_steps))  # train steps only
    expected.update(sb_launches(family, n_steps, FAMILY_EPOCHS * (n_eval + 1)))
    assert launches == expected, f"train {family}: launches {launches}, expected {expected}"
    for rec in eng.history:
        assert rec["val"] and all(np.isfinite(v) for v in rec["val"].values()), rec
    if family == "base_residual":
        assert task.warmup_epochs == 1  # the second epoch ran detached
    row = {"phase": "train_families", "model": family, "flags": argv, "params": n_params,
           "steps": len(steps), "eval_batches_per_epoch": n_eval, "losses": losses,
           "grad_norms": norms, "launches": launches, "expected_launches": expected,
           "epoch_records": eng.history, "main_wall_s": seen["wall"],
           "frozen_params": len(frozen), "never_run_params": len(dead),
           "teacher_buffers_moved": len(buffers) - len(still)}

    paths = {f"train {family}": (launches, by_variant)}
    if serve_flags is not None:
        exp_dir = os.path.join(ckpt_root, experiment_name(cfg))
        source, res, errs, s_launches, s_by_variant, s_expected = serve_checkpoint(
            torch, np, serve, kernels, eng, exp_dir, serve_flags,
            dict(per, **sb_launches(family, 0, 1)))
        emit({"phase": "serve_family", "model": family, "checkpoint": source,
              "requests": res["requests"], "bad_responses": res["bad_responses"],
              "p50_ms": res["p50_ms"], "served_vs_trained_max_abs": errs,
              "tol_rel": SERVED_TOL, "launches": s_launches, "expected_launches": s_expected})
        paths[f"serve {family} from its checkpoint"] = (s_launches, s_by_variant)
        if family == "coarse_depth/unet":
            row_aux, linear_dir, waves, answer = phase_aux_centers(torch, np, serve, eng,
                                                                   exp_dir, serve_flags)
            emit(row_aux)
            if export is not None:
                work, jobs = export
                jobs.append(export_coarse_job(torch, np, serve_flags, linear_dir, waves, answer,
                                              work))

    # one batch, repeated: the loss must fall; each step timed to its end
    image = {"with_image": True} if family in train_cli.IMAGE_MODELS else {}
    batch = next(make_dataset(cfg, "train", num_samples=TRAIN_BATCH, **image)
                 .batches(TRAIN_BATCH, shuffle=False))
    if cfg.model.name == "coarse_depth":  # the CLI's host bins
        batch = add_bins_to_batch(batch, task.bin_edges, cfg.dataset.max_depth,
                                  cfg.dataset.depth_norm)
    batch = eng.encode(batch)
    torch.cuda.reset_peak_memory_stats()
    rep_losses, times = [], []
    for _ in range(REPEATED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = eng.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rep_losses.append(float(metrics["loss"]))
    assert all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0], rep_losses
    step_ms = statistics.median(times[1:]) * 1e3
    row.update(repeated_batch_losses=rep_losses, step_ms_median=step_ms,
               step_ms_all=[t * 1e3 for t in times],
               pairs_per_sec=TRAIN_BATCH / (step_ms / 1e3),
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    if family == "unet_cvae":
        # the eval forward samples from a generator reseeded to 0: two
        # agree, and another seed's draw gives another answer. The ReLU head
        # (depth_norm off) holds this briefly trained net's eval output at 0,
        # so the check reads the head's input (the depth_norm head)
        dec = decode_batch({k: torch.as_tensor(v).to(eng.device) for k, v in batch.items()},
                           eng._depth_units)
        head = task.model.model
        head.depth_norm = True
        try:
            a, b = task.predict_raw(dec), task.predict_raw(dec)
            with torch.no_grad():
                other, _ = task.model(task.prepare(dec).permute(0, 3, 1, 2), sample=True,
                                      generator=torch.Generator(device=eng.device).manual_seed(1))
        finally:
            head.depth_norm = cfg.dataset.depth_norm
        scale = float(a.abs().max())
        repeat = float((a - b).abs().max())
        reseeded = float((a - other.permute(0, 2, 3, 1)).abs().max())
        # cuDNN does not promise bit-equal bf16 repeats (phase_serve)
        assert 0 < scale and repeat <= SERVED_TOL * scale and reseeded > repeat, (
            repeat, scale, reseeded)
        row.update(eval_repeat_max_abs=repeat, eval_other_seed_max_abs=reseeded,
                   eval_max_abs=scale)
    emit(row)
    emit(profile_train_step(torch, eng, state, batch, family, ("fused_mel",)))
    del eng, state, seen, task
    torch.cuda.empty_cache()
    return paths


AUX_CHANGE_MIN = 0.05   # served answer under linear vs sid centers, relative to max |sid answer|


def phase_aux_centers(torch, np, serve, eng, exp_dir, flags):
    """The coarse unet's best checkpoint with its aux centers rewritten to
    linear bins, copied to a new experiment directory and served by
    `serve.load_serving_state` under the same (sid) flags: the served answer
    must move by more than AUX_CHANGE_MIN of its scale from the sid answer,
    and equal the trained task's own forward on the linear centers within
    SERVED_TOL (bins come from the checkpoint's aux, never the config).
    Returns (row, the linear checkpoint's directory, the waveforms, the
    served answer)."""
    from audiodepth_tpu_torch.ckpt import CheckpointManager
    from audiodepth_tpu_torch.data.bins import compute_bin_edges

    task, cfg = eng.task, eng.cfg
    best = CheckpointManager(os.path.dirname(exp_dir), os.path.basename(exp_dir),
                             create=False).best_epoch()
    payload = torch.load(os.path.join(exp_dir, f"checkpoint_{best}.pth"), map_location="cpu",
                         weights_only=True)
    edges, centers = compute_bin_edges(task.n_bins, 0.1, task.max_depth, "linear")
    payload["aux"] = {"bin_edges": torch.from_numpy(edges),
                      "bin_centers": torch.from_numpy(centers)}
    linear_dir = exp_dir + "_linear_aux"
    os.makedirs(linear_dir)
    torch.save(payload, os.path.join(linear_dir, f"checkpoint_{best}.pth"))
    shutil.copy(os.path.join(exp_dir, "best.json"), linear_dir)
    args = serve.build_parser().parse_args(
        ["--checkpoint_path", linear_dir, "--use_best", "--device", str(task.device), *flags,
         "--compute_dtype", cfg.mode.compute_dtype])
    _, served, source = serve.load_serving_state(args)
    assert np.array_equal(served.bin_centers, centers) and served.bin_mode == "sid"
    wave = torch.from_numpy((np.random.default_rng(22).standard_normal((2, 2, 7782)) * 0.05)
                            .astype(np.float32)).to(task.device)
    saved_aux = task.checkpoint_aux()
    task.model.load_state_dict(payload["state_dict"], strict=True)
    sid = task.predict_meters({"waveform": wave}).float()
    task.restore_aux(payload["aux"])
    try:
        direct = task.predict_meters({"waveform": wave}).float()
    finally:
        task.restore_aux(saved_aux)
    got = served.predict_meters({"waveform": wave}).float()
    scale = float(sid.abs().max())
    changed = float((got - sid).abs().max())
    err = float((got - direct).abs().max())
    assert changed > AUX_CHANGE_MIN * scale, (changed, scale)
    assert err <= SERVED_TOL * float(direct.abs().max()), (err, float(direct.abs().max()))
    del served
    return ({"phase": "aux_centers", "model": "coarse_depth/unet", "checkpoint": source,
             "served_vs_sid_max_abs": changed, "sid_max_abs": scale,
             "min_change_rel": AUX_CHANGE_MIN, "served_vs_linear_task_max_abs": err,
             "tol_rel": SERVED_TOL, "linear_centers_first_last": [float(centers[0]),
                                                                  float(centers[-1])]},
            linear_dir, wave.cpu().numpy(), got.cpu().numpy())


# ---------------------------------------------------------------------------
# the corpus path: a fabricated BatVision V2 tree on disk, trained from and
# evaluated through the CLIs
# ---------------------------------------------------------------------------

# (location, train rows, val rows, test rows): 64 / 16 / 16 rows. The held-out
# location has no val or test CSV (the scan warns and skips it), so the val
# split the train CLI validates on is the one the evaluate CLI scores.
CORPUS_LOCATIONS = (("lobby", 24, 8, 8), ("lab", 24, 8, 8), ("stairs", 16, 0, 0))
CORPUS_HOLDOUT = "stairs"
CORPUS_WAVE_SAMPLES = 9000         # 16-bit 44.1 kHz stereo, longer than the 7,782 kept
CORPUS_DEPTH_HW = (480, 640)       # depth .npy in mm, resized to 256² by the loader
CORPUS_CAMERA_HW = (480, 640)      # camera PNGs, decoded and resized to 256² by OpenCV
CORPUS_EPOCHS = 2
CORPUS_ARGV = ["--dataset", "batvisionv2", "--model", "unet_baseline",
               "--holdout_locations", CORPUS_HOLDOUT, "--no_visualize",
               "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
               "--epochs", str(CORPUS_EPOCHS), "--validation", "true", "--validation_iter", "1",
               "--seed", "0", "--saving_checkpoints", "1"]
CORPUS_TIMED_EPOCHS = 2            # epochs of the timed and profiled step loop
LOSS_REL_TOL = 1e-6                # first-step loss, streamed vs device cache
EVAL_REL_TOL = 1e-6                # evaluate CLI means vs the engine's val record


def _write_wav(path, pcm):
    import wave

    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(44100)
        f.writeframes(pcm.T.tobytes())


def write_corpus(np, root):
    """The fabricated BV2 tree: per location audio/ WAVs, depth/ .npy in
    mm (values below 0 and above 30 m) and cam/ PNGs (a smooth colour
    field with noise, 480×640, written by OpenCV), a CSV per split it has
    rows in, and a '__pycache__' and an 'X_unzipped' directory the scan
    skips."""
    import cv2

    rng = np.random.default_rng(7)
    cam_rng = np.random.default_rng(8)  # the audio and depth draws stay as they were
    h, w = CORPUS_CAMERA_HW
    ramp = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    header = "audio path,audio file name,depth path,depth file name,camera path,camera file name"
    for loc, *counts in CORPUS_LOCATIONS:
        for sub in ("audio", "depth", "cam"):
            os.makedirs(os.path.join(root, loc, sub))
        for split, n in zip(("train", "val", "test"), counts):
            if not n:
                continue
            lines = []
            for i in range(n):
                name = f"{split}{i:03d}"
                depth = rng.uniform(-500.0, 40_000.0, CORPUS_DEPTH_HW).astype(np.float32)
                # depth_*.npy: the names the sparse-depth preprocessor reads
                np.save(os.path.join(root, loc, "depth", f"depth_{name}.npy"), depth)
                pcm = np.clip(rng.normal(0.0, 3000.0, (2, CORPUS_WAVE_SAMPLES)),
                              -32768, 32767).astype(np.int16)
                _write_wav(os.path.join(root, loc, "audio", f"{name}.wav"), pcm)
                tint = cam_rng.uniform(0.2, 1.0, 3).astype(np.float32)
                bgr = np.clip(255.0 * ramp * tint + cam_rng.normal(0.0, 12.0, (h, w, 3)), 0, 255)
                assert cv2.imwrite(os.path.join(root, loc, "cam", f"{name}.png"),
                                   bgr.astype(np.uint8))
                lines.append(f"{loc}/audio,{name}.wav,{loc}/depth,depth_{name}.npy,"
                             f"{loc}/cam,{name}.png")
            with open(os.path.join(root, loc, f"{split}.csv"), "w") as f:
                f.write(header + "\n" + "\n".join(lines) + "\n")
    os.makedirs(os.path.join(root, "__pycache__"))
    os.makedirs(os.path.join(root, "X_unzipped"))


def _median_s(fn, runs):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_corpus(torch, np, configs, root, smi):
    """Write the fabricated tree, build the native decoder (its seconds),
    time one batch of 16 decoded by the native pool against the Python
    decoder (bit-equal in the compact dtypes), and time that batch's copy
    to the card from pinned against pageable memory."""
    import importlib.util

    from audiodepth_tpu_torch.data import native_io
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.codec import encode_batch

    t0 = time.perf_counter()
    write_corpus(np, root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = native_io.build()
    build_s = time.perf_counter() - t0
    cfg = configs.load_config("batvisionv2", "train", overrides={"dataset.dataset_dir": root})
    ds = make_dataset(cfg, "train")
    assert len(ds) == sum(c[1] for c in CORPUS_LOCATIONS), len(ds)

    def native():
        return next(ds.batches(TRAIN_BATCH, shuffle=False))

    def python():
        return encode_batch(next(ds.batches(TRAIN_BATCH, shuffle=False, native=False)),
                            float(cfg.dataset.max_depth))

    nat, py = native(), python()
    for k in ("waveform", "depth"):
        assert nat[k].dtype == py[k].dtype and np.array_equal(nat[k], py[k]), k
    native_s, python_s = _median_s(native, 5), _median_s(python, 3)

    dev = torch.device("cuda")
    host = {k: np.ascontiguousarray(nat[k]) for k in ("waveform", "depth")}
    nbytes = sum(a.nbytes for a in host.values())
    pinned = {k: torch.from_numpy(a).pin_memory() for k, a in host.items()}
    dst = {k: torch.empty(a.shape, dtype=pinned[k].dtype, device=dev) for k, a in host.items()}

    def pageable_copy():
        for k, a in host.items():
            dst[k].copy_(torch.from_numpy(a), non_blocking=True)
        torch.cuda.synchronize()

    def pinned_copy():
        for k, t in pinned.items():
            dst[k].copy_(t, non_blocking=True)
        torch.cuda.synchronize()

    for fn in (pageable_copy, pinned_copy):
        fn()
    pageable_ms, pinned_ms = (_median_s(fn, 50) * 1e3 for fn in (pageable_copy, pinned_copy))
    for k in host:
        assert np.array_equal(dst[k].cpu().numpy(), host[k]), k
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("pandas", "cv2", "matplotlib", "scipy")}
    emit({"phase": "corpus", "root_rows": {loc: c for loc, *c in CORPUS_LOCATIONS},
          "depth_hw_on_disk": CORPUS_DEPTH_HW, "wave_samples_on_disk": CORPUS_WAVE_SAMPLES,
          "write_s": write_s, "native_build_s": build_s, "native_library": lib.name,
          "batch": TRAIN_BATCH, "decode_ms_native": native_s * 1e3,
          "decode_ms_python": python_s * 1e3, "native_equals_python": True,
          "batch_bytes": nbytes, "h2d_ms_pageable": pageable_ms, "h2d_ms_pinned": pinned_ms,
          "h2d_gbps_pageable": nbytes / pageable_ms / 1e6,
          "h2d_gbps_pinned": nbytes / pinned_ms / 1e6, "nvidia_smi": smi,
          "importable": found})


class spy:
    """Wrap `cls.name` so that `record(self, *args)` runs before each call;
    the original is put back on exit."""

    def __init__(self, cls, name, record):
        self.cls, self.name, self.record = cls, name, record

    def __enter__(self):
        self.orig = orig = getattr(self.cls, self.name)
        record = self.record

        def wrapper(obj, *args, **kwargs):
            record(obj, *args, **kwargs)
            return orig(obj, *args, **kwargs)

        setattr(self.cls, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def profile_corpus_steps(torch, eng, state, make_batches, what, batch_bytes):
    """CORPUS_TIMED_EPOCHS epochs of train steps fed by `make_batches()`
    through `device_prefetch`, as `Engine.fit` feeds them: one warm-up
    pass, a timed pass (host clock, ending in a synchronize), then a
    profiled pass: the device's busy share (kernels and copies, merged
    over streams) and, for host batches, where each batch copy ran (it
    must come from pinned memory on a stream no kernel of the step uses)."""
    from audiodepth_tpu_torch.data.prefetch import device_prefetch

    def run():
        marks = []
        for batch in device_prefetch(make_batches(), eng.device,
                                     encode_units=eng._encode_units):
            eng.train_step(state, batch)
            marks.append(time.perf_counter())
        torch.cuda.synchronize()
        return marks

    from audiodepth_tpu_torch.data import prefetch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks = run()
    wall = time.perf_counter() - t0
    steps = len(marks)
    intervals = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    prefetch.copies.reset()
    trace, pwall, _ = traced(torch, run)
    issued = prefetch.copies.read()
    acts = trace.activity
    kernel_streams = {a.stream for a in acts if a.cat == "kernel"}
    copies = [(a.cat, a.name, a.stream, a.ts, a.dur, a.bytes) for a in acts
              if a.cat == "gpu_memcpy" and "HtoD" in a.name and a.bytes in batch_bytes]
    kernel_us = sum(a.dur for a in acts if a.cat == "kernel")
    row = {"phase": "profile", "what": what, "steps": steps, "wall_ms": wall * 1e3,
           "step_ms": wall / steps * 1e3,
           "step_interval_ms_median": statistics.median(intervals) * 1e3,
           "profiled_wall_ms": pwall * 1e3, "kernel_ms": kernel_us / 1e3,
           "device_busy_share": (trace.busy_us / 1e6 / pwall if acts
                                 else "not measured"),
           "kernel_busy_share": kernel_us / 1e6 / pwall if acts else "not measured",
           "batch_copies": [[name, stream, b] for _, name, stream, _, _, b in copies],
           "prefetch_counts": issued,
           "kernel_streams": sorted(map(str, kernel_streams))}
    assert acts, f"{what}: the profiler recorded no device activity"
    return row, copies, kernel_streams


def phase_train_corpus(torch, np, configs, train_cli, kernels, root, work):
    """cli/train.py's main in-process on the fabricated tree (the main path:
    unet_256, ngf 64, 256², bf16, batch 16, 2 epochs, one location held
    out, the JSONL log and checkpoints in `work`), then the same run with
    --device_cache. Checks: finite losses and grad norms, every parameter
    moved, the held-out rows absent from train and val and evaluated on
    their own, the holdout record in the JSONL, B1 once per step, per eval
    batch and per detector forward (B2 = B3 = 0), the batches the steps
    received on the card bit-equal to the host loader's (streamed) and to
    the streamed ones (cached), and the first-step losses of the two runs
    within LOSS_REL_TOL. Each run's steps are then timed and profiled."""
    import itertools

    from audiodepth_tpu_torch.configs import experiment_name
    from audiodepth_tpu_torch.data import prefetch
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
    from audiodepth_tpu_torch.train.engine import Engine

    cfg0 = configs.load_config("batvisionv2", "train", overrides={"dataset.dataset_dir": root})
    full = make_dataset(cfg0, "train")
    holdout_rows = {b["depth"][0].tobytes()
                    for b in full.filter_by_audio_path(CORPUS_HOLDOUT).batches(1, shuffle=False)}
    n_train = sum(c[1] for c in CORPUS_LOCATIONS if c[0] != CORPUS_HOLDOUT)
    n_val = sum(c[2] for c in CORPUS_LOCATIONS if c[0] != CORPUS_HOLDOUT)
    steps_per_epoch = n_train // TRAIN_BATCH
    eval_batches = -(-n_val // TRAIN_BATCH) + -(-len(holdout_rows) // TRAIN_BATCH)
    per_epoch = steps_per_epoch + eval_batches + 1  # + the detectors' forward
    expected = {"fused_mel_frontend": per_epoch * CORPUS_EPOCHS,
                "flash_cross_attention_fwd": 0, "flash_cross_attention_bwd": 0,
                **bn_launches("unet_baseline", steps_per_epoch * CORPUS_EPOCHS), **NO_SB}
    out = {}
    for name, extra in (("streamed", []), ("cached", ["--device_cache"])):
        log_dir, ckpt_dir = os.path.join(work, f"logs_{name}"), os.path.join(work, f"ck_{name}")
        argv = CORPUS_ARGV + ["--dataset_dir", root, "--log_dir", log_dir,
                              "--ckpt_dir", ckpt_dir] + extra
        received, evaluated, caches = [], [], []
        prefetch.copies.reset()
        with spy(Engine, "train_step", lambda eng, state, batch, epoch=0.0: received.append(
                     {k: v.clone() for k, v in batch.items()})), \
             spy(Engine, "eval_step", lambda eng, state, batch, epoch=0.0: evaluated.append(
                     np.array(batch["depth"].cpu() if hasattr(batch["depth"], "cpu")
                              else batch["depth"]))), \
             spy(DeviceDatasetCache, "__init__", lambda c, *a, **k: caches.append(c)):
            eng, state, steps, launches, by_variant, seen = _train_run(
                torch, train_cli, kernels, argv)
        fit_copies = prefetch.copies.read()
        task = seen["task"]
        cfg = task.cfg
        assert cfg.model.generator == "unet_256" and cfg.model.ngf == UNET_NGF
        assert cfg.dataset.images_size == 256 and cfg.mode.compute_dtype == "bfloat16"
        losses = [float(m["loss"]) for m in steps]
        norms = [float(m["grad_norm"]) for m in steps]
        assert len(steps) == steps_per_epoch * CORPUS_EPOCHS, len(steps)
        assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
        unmoved = [n for n, p in task.model.named_parameters()
                   if torch.equal(p.detach(), seen["before"][n])]
        assert not unmoved, f"{name}: parameters that did not move: {unmoved[:8]}"
        assert launches == expected, f"train corpus {name}: launches {launches}, expected {expected}"
        for rec in eng.history:
            assert set(rec["holdout"]) == {CORPUS_HOLDOUT}, rec
            assert all(np.isfinite(v) for v in (*rec["val"].values(),
                                                *rec["holdout"][CORPUS_HOLDOUT].values()))
        exp = experiment_name(cfg, f"holdout_{CORPUS_HOLDOUT}")
        with open(os.path.join(log_dir, f"{exp}.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        assert sum(f"holdout/{CORPUS_HOLDOUT}/rmse" in r for r in logged) == CORPUS_EPOCHS
        received = [{k: v.cpu().numpy() for k, v in b.items()} for b in received]
        rows = [b["depth"][i].tobytes() for b in received for i in range(len(b["depth"]))]
        assert not holdout_rows & set(rows), f"{name}: a held-out row reached a train step"
        if name == "streamed":
            # per epoch: one val batch (no held-out row), then the holdout's
            assert len(evaluated) == 2 * CORPUS_EPOCHS, len(evaluated)
            for val, hold in zip(evaluated[0::2], evaluated[1::2]):
                assert not holdout_rows & {r.tobytes() for r in val}
                assert {r.tobytes() for r in hold} == holdout_rows
            ds = make_dataset(cfg, "train", location_blacklist=[CORPUS_HOLDOUT])
            # every epoch's steps (epoch e shuffles with seed·100003 + e + 1)
            host = [b for e in range(1, CORPUS_EPOCHS + 1)
                    for b in ds.batches(TRAIN_BATCH, shuffle=True, seed=e + 1)]
            assert len(host) == len(received), (len(host), len(received))
            for step, (got, want) in enumerate(zip(received, host)):
                for k in want:
                    assert np.array_equal(got[k], want[k]), \
                        f"step {step}: prefetched {k} != host batch"
            # every batch copied: two tensors and one event a step
            assert fit_copies == {"copies": 2 * len(steps), "events": len(steps)}, fit_copies
        else:
            assert fit_copies == {"copies": 0, "events": 0}, fit_copies
            for got, want in zip(received, out["streamed"]["received"]):
                for k in ("waveform", "depth"):
                    assert np.array_equal(got[k], want[k]), f"cached {k} != streamed"
            first = out["streamed"]["losses"][0]
            assert abs(losses[0] - first) <= LOSS_REL_TOL * abs(first), (losses[0], first)
        state_bytes = sum(v.numel() * v.element_size() for v in state.model.state_dict().values())
        if name == "streamed":
            make = lambda: itertools.chain.from_iterable(  # noqa: E731
                ds.batches(TRAIN_BATCH, seed=e) for e in range(CORPUS_TIMED_EPOCHS))
        else:
            cache = caches[0]
            make = lambda: itertools.chain.from_iterable(  # noqa: E731
                cache.batches(TRAIN_BATCH, seed=e) for e in range(CORPUS_TIMED_EPOCHS))
        batch_bytes = {received[0][k].nbytes for k in ("waveform", "depth")}
        prof_row, copies, kernel_streams = profile_corpus_steps(
            torch, eng, state, make, f"unet_256 corpus steps, {name}", batch_bytes)
        if name == "streamed":
            # the trace may drop some copy records (the prefetch counter
            # shows every copy ran); every one it keeps must be a pinned
            # copy on a stream no kernel of the steps ran on
            issued = 2 * steps_per_epoch * CORPUS_TIMED_EPOCHS
            prof_row["batch_copies_issued"] = issued
            assert prof_row["prefetch_counts"] == {"copies": issued, "events": issued // 2}, \
                prof_row
            assert 2 <= len(copies) <= issued, prof_row
            bad = [c for c in copies if "Pinned" not in c[1] or c[2] in kernel_streams]
            assert not bad, f"batch copies not from pinned memory on a side stream: {bad}"
        else:
            assert not copies, f"the cached run copied batches: {copies}"
            assert prof_row["prefetch_counts"] == {"copies": 0, "events": 0}, prof_row
        emit(prof_row)
        out[name] = {"losses": losses, "received": received}
        emit({"phase": "train_corpus", "run": name, "flags": argv, "steps": len(steps),
              "losses": losses, "grad_norms": norms, "launches": launches,
              "expected_launches": expected, "epoch_records": eng.history,
              "main_wall_s": seen["wall"], "prefetch_counts": fit_copies,
              "epoch_step_ms": [r["epoch_time"] / r["steps"] * 1e3 for r in eng.history],
              "device_cache_nbytes": {s: c.nbytes() for s, c in zip(("train", "val"), caches)},
              "snapshot_state_mb": state_bytes / 2**20,
              "holdout_rows": len(holdout_rows), "jsonl_records": len(logged)})
        out[name].update(launches=(launches, by_variant), eng=eng, exp=exp, ckpt_dir=ckpt_dir)
        del state, seen, task, received
        torch.cuda.empty_cache()
    return out


def phase_evaluate(torch, np, evaluate_cli, kernels, root, work, run):
    """cli/evaluate.py on the card against the best checkpoint of the
    streamed corpus run (--use_best --eval_on val --save_tensors): its
    means equal the engine's val record of that epoch within EVAL_REL_TOL,
    B1 launches once per batch, and the artifact holds one row a sample."""
    from audiodepth_tpu_torch.ckpt import CheckpointManager

    eng, exp = run["eng"], run["exp"]
    best = CheckpointManager(run["ckpt_dir"], exp, create=False).best_epoch()
    stat_dir = os.path.join(work, "eval")
    argv = ["--dataset", "batvisionv2", "--dataset_dir", root, "--checkpoint_path",
            os.path.join(run["ckpt_dir"], exp), "--use_best", "--eval_on", "val",
            "--save_tensors", "--stat_dir", stat_dir, "--batch_size", str(TRAIN_BATCH),
            "--compute_dtype", "bfloat16"]
    reset_launches(kernels)
    t0 = time.perf_counter()
    means = evaluate_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    n_val = sum(c[2] for c in CORPUS_LOCATIONS)
    batches = -(-n_val // TRAIN_BATCH)
    expected = {"fused_mel_frontend": batches, "flash_cross_attention_fwd": 0,
                "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB}
    assert launches == expected, f"evaluate: launches {launches}, expected {expected}"
    val = eng.history[best - 1]["val"]
    diffs = {k: abs(means[k] - val[k]) / max(abs(val[k]), 1e-12) for k in means}
    assert all(d <= EVAL_REL_TOL for d in diffs.values()), (means, val)
    artifact = os.path.join(stat_dir, "batvisionv2", "val", f"stats_on_{exp}_epoch{best}.npz")
    stats = np.load(artifact)
    assert all(stats[k].shape == (n_val,) for k in means), {k: stats[k].shape for k in stats}
    assert stats["pred"].shape == stats["gt"].shape == (n_val, 256, 256, 1)
    assert np.isfinite(stats["pred"]).all()
    emit({"phase": "evaluate", "flags": argv, "best_epoch": best, "seconds": seconds,
          "means": means, "val_record": val, "rel_diff": diffs, "tol_rel": EVAL_REL_TOL,
          "launches": launches, "expected_launches": expected,
          "artifact_keys": sorted(stats.files), "rows": n_val})
    return launches, by_variant


# the image paths on the fabricated tree: the loader on the card, the two
# image families trained from it, and the --eval_img baseline evaluated
IMAGE_CORPUS_ARGV = ["--dataset", "batvisionv2", "--holdout_locations", CORPUS_HOLDOUT,
                     "--no_visualize", "--compute_dtype", "bfloat16", "--batch_size",
                     str(TRAIN_BATCH), "--epochs", "1", "--validation", "true",
                     "--validation_iter", "1", "--seed", "0", "--saving_checkpoints", "1"]


def phase_corpus_images(torch, np, configs, root, dev="cuda"):
    """One batch of the tree decoded with use_image="both" (camera image,
    audio and depth) by the native loader and the image pool, streamed to
    the card through `device_prefetch` and gathered there by
    `DeviceDatasetCache`: both bit-equal to the host batch; the decode
    times of the images."""
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.device_cache import DeviceDatasetCache
    from audiodepth_tpu_torch.data.prefetch import device_prefetch

    cfg = configs.load_config("batvisionv2", "train", overrides={"dataset.dataset_dir": root})
    ds = make_dataset(cfg, "train", use_image="both")
    host = next(ds.batches(TRAIN_BATCH, shuffle=False))
    assert host["image"].shape == (TRAIN_BATCH, 256, 256, 3) and host["image"].dtype == np.uint8
    (streamed,) = list(device_prefetch(iter([host]), dev))
    cache = DeviceDatasetCache(make_dataset(cfg, "val", use_image="both"), 30.0, dev)
    val_host = next(make_dataset(cfg, "val", use_image="both").batches(TRAIN_BATCH,
                                                                       shuffle=False))
    cached = cache.batch(np.arange(TRAIN_BATCH))
    for k in ("image", "waveform", "depth"):
        for got, want in ((streamed[k], host[k]), (cached[k], val_host[k])):
            assert got.device.type == dev and np.array_equal(got.cpu().numpy(), want), k
    both_s = _median_s(lambda: next(ds.batches(TRAIN_BATCH, shuffle=False)), 3)
    audio_s = _median_s(lambda: next(make_dataset(cfg, "train").batches(TRAIN_BATCH,
                                                                        shuffle=False)), 3)
    emit({"phase": "corpus_images", "camera_hw_on_disk": CORPUS_CAMERA_HW, "batch": TRAIN_BATCH,
          "streamed_equals_host": True, "cached_equals_host": True,
          "decode_ms_with_images": both_s * 1e3, "decode_ms_audio_only": audio_s * 1e3,
          "cache_nbytes": cache.nbytes()})


def phase_train_corpus_images(torch, np, train_cli, kernels, root, work, family, flags=()):
    """cli/train.py's main on the tree for one epoch, one location held out:
    rgb_depth on camera images, adabins_distillation on paired audio and
    images, or (with --eval_img) the baseline on images. Every loss finite,
    every trainable parameter moved, the holdout evaluated, B1 once per
    step, eval batch and detector forward where the family reads audio."""
    argv = IMAGE_CORPUS_ARGV + ["--dataset_dir", root, "--model", family,
                                "--ckpt_dir", os.path.join(work, f"ck_{family}"), *flags]
    eng, state, steps, launches, by_variant, seen = _train_run(torch, train_cli, kernels, argv)
    task = seen["task"]
    losses = [float(m["loss"]) for m in steps]
    n_train = sum(c[1] for c in CORPUS_LOCATIONS if c[0] != CORPUS_HOLDOUT)
    n_val = sum(c[2] for c in CORPUS_LOCATIONS if c[0] != CORPUS_HOLDOUT)
    n_hold = sum(c[1] for c in CORPUS_LOCATIONS if c[0] == CORPUS_HOLDOUT)
    assert len(steps) == n_train // TRAIN_BATCH and all(np.isfinite(losses)), losses
    trainable = {id(p) for p in task.trainable_parameters()}
    unmoved = [n for n, p in task.model.named_parameters()
               if id(p) in trainable and torch.equal(p.detach(), seen["before"][n])]
    assert not unmoved, f"{family} corpus: parameters that did not move: {unmoved[:8]}"
    (rec,) = eng.history
    assert set(rec["holdout"]) == {CORPUS_HOLDOUT} and np.isfinite(rec["val"]["rmse"]), rec
    reads_audio = family == "adabins_distillation"
    forwards = len(steps) + -(-n_val // TRAIN_BATCH) + -(-n_hold // TRAIN_BATCH) + 1
    expected = dict(NO_KERNEL, fused_mel_frontend=forwards if reads_audio else 0,
                    **bn_launches(family, len(steps)),
                    **sb_launches(family, len(steps), forwards - len(steps)))
    assert launches == expected, f"train corpus {family}: launches {launches}, expected {expected}"
    emit({"phase": "train_corpus_images", "model": family, "flags": argv, "steps": len(steps),
          "losses": losses, "launches": launches, "expected_launches": expected,
          "epoch_record": rec, "main_wall_s": seen["wall"],
          "epoch_step_ms": rec["epoch_time"] / rec["steps"] * 1e3})
    return eng, state, (launches, by_variant)


def phase_evaluate_eval_img(torch, np, evaluate_cli, kernels, root, work, eng):
    """cli/evaluate.py --eval_img on the card against the best checkpoint of
    the baseline trained on images: its means equal the val record within
    EVAL_REL_TOL, and no front end runs."""
    from audiodepth_tpu_torch.configs import experiment_name

    exp = experiment_name(eng.cfg, f"IMG_holdout_{CORPUS_HOLDOUT}")
    ck = os.path.join(work, "ck_unet_baseline", exp)
    assert os.path.isdir(ck), ck
    argv = ["--dataset", "batvisionv2", "--dataset_dir", root, "--checkpoint_path", ck,
            "--use_best", "--eval_on", "val", "--eval_img", "--stat_dir",
            os.path.join(work, "eval_img"), "--batch_size", str(TRAIN_BATCH),
            "--compute_dtype", "bfloat16"]
    reset_launches(kernels)
    means = evaluate_cli.main(argv)
    torch.cuda.synchronize()
    launches, by_variant = read_launches(kernels)
    assert launches == NO_KERNEL, f"evaluate --eval_img: launches {launches}"
    val = eng.history[-1]["val"]
    diffs = {k: abs(means[k] - val[k]) / max(abs(val[k]), 1e-12) for k in means}
    assert all(d <= EVAL_REL_TOL for d in diffs.values()), (means, val)
    emit({"phase": "evaluate_eval_img", "flags": argv, "means": means, "val_record": val,
          "rel_diff": diffs, "tol_rel": EVAL_REL_TOL, "launches": launches})
    return launches, by_variant


# the sparse-depth workflow on the fabricated tree: its preprocessor, the
# hybrid trained on its targets (streamed and cached) and evaluated
SPARSE_METHOD = "downup_015"
SPARSE_ARGV = ["--dataset", "batvisionv2", "--model", "coarse_depth", "--model_type", "hybrid",
               "--sparse_method", SPARSE_METHOD, "--holdout_locations", CORPUS_HOLDOUT,
               "--no_visualize", "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
               "--epochs", "1", "--validation", "true", "--validation_iter", "1", "--seed", "0",
               "--saving_checkpoints", "1"]
SPARSE_EVAL_REL_TOL = 1.2e-7  # evaluate CLI means vs the engine's on the same split


def phase_sparse_corpus(torch, np, configs, train_cli, evaluate_cli, kernels, root, work):
    """The port's `tools/preprocess_sparse_depth.py --method downup_015` over
    the tree (timed; one target per depth map), then cli/train.py's main
    with --model coarse_depth --model_type hybrid --sparse_method downup_015
    (base 64, 128 sid bins, 256², bf16, batch 16, 1 epoch, one location
    held out: the sparse datasets have no holdout loader, as in the JAX
    CLI), streamed and with --device_cache: finite losses and grad norms,
    every parameter moved, B1 once per step, per eval batch and for the
    detectors' forward, and the bins each step received on the card equal
    to the host dataset's. Then `cli/evaluate.py` on the streamed run's best
    checkpoint: it scores the val split's dense ground truth (the JAX
    evaluate CLI reads no sparse targets), and its means equal those of the
    trained engine's per-sample metrics of that split with the best
    epoch's weights (reduced as the CLI reduces them) within
    SPARSE_EVAL_REL_TOL, B1 once per batch."""
    from audiodepth_tpu_torch.ckpt import CheckpointManager
    from audiodepth_tpu_torch.configs import experiment_name
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.sparse_depth import BinnedSparseDepthDataset
    from audiodepth_tpu_torch.tools import preprocess_sparse_depth as prep
    from audiodepth_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    prep.main(["--dataset_dir", root, "--method", SPARSE_METHOD])
    prep_s = time.perf_counter() - t0
    folder = f"sparse_depth_{SPARSE_METHOD}"
    n_maps = sum(sum(c) for _, *c in CORPUS_LOCATIONS)
    written = sum(len(os.listdir(os.path.join(root, loc, folder))) for loc, *_ in CORPUS_LOCATIONS)
    assert written == n_maps, (written, n_maps)
    n_train = sum(c[1] for c in CORPUS_LOCATIONS if c[0] != CORPUS_HOLDOUT)
    n_val = sum(c[2] for c in CORPUS_LOCATIONS if c[0] != CORPUS_HOLDOUT)
    steps_per_epoch, eval_batches = n_train // TRAIN_BATCH, -(-n_val // TRAIN_BATCH)
    expected = {"fused_mel_frontend": steps_per_epoch + eval_batches + 1,
                "flash_cross_attention_fwd": 0, "flash_cross_attention_bwd": 0,
                **bn_launches("coarse_depth/hybrid", steps_per_epoch), **NO_SB}
    paths, runs = {}, {}
    for name, extra in (("streamed", []), ("cached", ["--device_cache"])):
        ckpt_dir = os.path.join(work, f"ck_sparse_{name}")
        argv = SPARSE_ARGV + ["--dataset_dir", root, "--ckpt_dir", ckpt_dir] + extra
        received = []
        with spy(Engine, "train_step", lambda eng, state, batch, epoch=0.0: received.append(
                batch["bins"].cpu().numpy())):
            eng, state, steps, launches, by_variant, seen = _train_run(
                torch, train_cli, kernels, argv)
        task, cfg = seen["task"], seen["task"].cfg
        assert task.model_type == "hybrid" and task.n_bins == 128 and task.bin_mode == "sid"
        losses = [float(m["loss"]) for m in steps]
        norms = [float(m["grad_norm"]) for m in steps]
        assert len(steps) == steps_per_epoch and all(np.isfinite(losses + norms)), (losses, norms)
        unmoved = [n for n, p in task.model.named_parameters()
                   if torch.equal(p.detach(), seen["before"][n])]
        assert not unmoved, f"sparse {name}: parameters that did not move: {unmoved[:8]}"
        assert launches == expected, f"sparse {name}: launches {launches}, expected {expected}"
        (record,) = eng.history
        assert "holdout" not in record and all(np.isfinite(v) for v in record["val"].values())
        host = BinnedSparseDepthDataset(cfg, cfg.dataset.annotation_file_train,
                                        sparse_depth_method=SPARSE_METHOD,
                                        location_blacklist=[CORPUS_HOLDOUT],
                                        n_bins=task.n_bins, bin_mode=task.bin_mode)
        want = [b["bins"] for b in host.batches(TRAIN_BATCH, seed=2)]  # epoch 1's seed
        assert len(received) == len(want) == steps_per_epoch
        for got, w in zip(received, want):
            assert got.dtype == np.int32 and np.array_equal(got, w), f"sparse {name}: bins"
        runs[name] = (eng, ckpt_dir, experiment_name(cfg, f"holdout_{CORPUS_HOLDOUT}"))
        paths[f"train coarse_depth/hybrid sparse {name}"] = (launches, by_variant)
        emit({"phase": "train_sparse", "run": name, "flags": argv, "preprocess_s": prep_s,
              "sparse_targets": written, "steps": len(steps), "losses": losses,
              "grad_norms": norms, "launches": launches, "expected_launches": expected,
              "bins_equal_host": True, "epoch_record": record, "main_wall_s": seen["wall"]})
        del state, seen
    eng, ckpt_dir, exp = runs["streamed"]
    del runs
    torch.cuda.empty_cache()
    mgr = CheckpointManager(ckpt_dir, exp, create=False)
    best = mgr.best_epoch()
    sd, _, _ = mgr.restore_eval(epoch="best")
    eng.task.model.load_state_dict(sd, strict=True)
    per_sample = {}
    for batch in make_dataset(eng.task.cfg, "val").batches(TRAIN_BATCH, shuffle=False,
                                                          drop_last=False):
        for k, v in eng.eval_step(None, batch).items():
            per_sample.setdefault(k, []).append(v.cpu().numpy())
    # the CLI's reduction: the float32 mean of the concatenated samples
    want = {k: float(np.concatenate(v).mean()) for k, v in per_sample.items()}
    argv = ["--dataset", "batvisionv2", "--dataset_dir", root, "--model", "coarse_depth",
            "--model_type", "hybrid", "--checkpoint_path", os.path.join(ckpt_dir, exp),
            "--use_best", "--eval_on", "val", "--stat_dir", os.path.join(work, "eval_sparse"),
            "--batch_size", str(TRAIN_BATCH), "--compute_dtype", "bfloat16"]
    reset_launches(kernels)
    t0 = time.perf_counter()
    means = evaluate_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    n_dense = sum(c[2] for c in CORPUS_LOCATIONS)
    e_expected = {"fused_mel_frontend": -(-n_dense // TRAIN_BATCH),
                  "flash_cross_attention_fwd": 0, "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB}
    assert launches == e_expected, f"evaluate sparse: launches {launches}, expected {e_expected}"
    diffs = {k: abs(means[k] - want[k]) / max(abs(want[k]), 1e-12) for k in means}
    assert all(d <= SPARSE_EVAL_REL_TOL for d in diffs.values()), (means, want)
    emit({"phase": "evaluate_sparse", "flags": argv, "best_epoch": best, "seconds": seconds,
          "means": means, "engine_evaluate": want, "rel_diff": diffs,
          "tol_rel": SPARSE_EVAL_REL_TOL, "launches": launches, "expected_launches": e_expected,
          "sparse_val_record": eng.history[best - 1]["val"]})
    paths["evaluate coarse_depth/hybrid (sparse-trained)"] = (launches, by_variant)
    del eng
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# the tools: the exported inference graph, the step profiler, --profile_dir,
# AdaBins' remat and the feature-shape contract
# ---------------------------------------------------------------------------

EXPORT_BATCHES = (1, 16)
EXPORT_RUNS = 20  # timed calls of each exported program, and of eager predict_meters
# the fresh process that loads and runs the saved programs: it imports
# tools.export alone, whose load_exported registers the ops the graphs hold
EXPORT_CHILD = r"""
import json, statistics, sys, time
import numpy as np
import torch
from audiodepth_tpu_torch.tools import export as texport

out = []
for job in json.load(open(sys.argv[1])):
    t0 = time.perf_counter()
    module = texport.load_exported(job["pt2"]).module()
    load_s = time.perf_counter() - t0
    kernels = sys.modules["audiodepth_tpu_torch.ops.cuda"].KERNELS
    for w, _, _ in kernels:
        w.launches = 0
        w.variant_launches.clear()
    wave = torch.from_numpy(np.load(job["wave"])).cuda()
    times = []
    with torch.no_grad():
        got = module(wave)
        torch.cuda.synchronize()
        first = {w.name: w.launches for w, _, _ in kernels}
        for _ in range(job["runs"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            module(wave)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    np.save(job["got"], got.float().cpu().numpy())
    out.append({"name": job["name"], "load_s": load_s, "first_call": first,
                "calls": 1 + job["runs"], "launches": {w.name: w.launches for w, _, _ in kernels},
                "by_variant": {w.name: dict(w.variant_launches) for w, _, _ in kernels},
                "ms_median": statistics.median(times) * 1e3})
print("EXPORT_CHILD " + json.dumps(out))
"""


def _eager_ms(torch, task, x, runs=EXPORT_RUNS):
    """Median ms of one eager `predict_meters` call on a device batch."""
    times = []
    with torch.no_grad():
        task.predict_meters({"waveform": x})
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            task.predict_meters({"waveform": x})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def export_job(torch, np, texport, cfg, task, batch, waves, want, per_call, work, name):
    """Export `task` at `batch` into `work` (timed), save the waveform and
    the answer the program must give; returns (the child's job, a row)."""
    stem = os.path.join(work, name.replace(" ", "_").replace("/", "_"))
    x = torch.from_numpy(waves).cuda()
    eager_ms = _eager_ms(torch, task, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, pt2 = texport.export_inference(cfg, task, batch, stem + ".pt2")
    export_s = time.perf_counter() - t0
    np.save(stem + "_wave.npy", waves)
    np.save(stem + "_want.npy", want)
    job = {"name": name, "pt2": pt2, "wave": stem + "_wave.npy", "want": stem + "_want.npy",
           "got": stem + "_got.npy", "runs": EXPORT_RUNS, "per_call": per_call}
    return job, {"name": name, "batch": batch, "export_s": export_s,
                 "pt2_bytes": os.path.getsize(pt2), "eager_ms_median": eager_ms}


def export_coarse_job(torch, np, serve_flags, linear_dir, waves, answer, work):
    """`tools/export.py`'s CLI on the coarse unet's checkpoint whose aux
    holds linear bins (phase_aux_centers): the graph must answer what
    aux_centers served."""
    from audiodepth_tpu_torch.tools import export as texport

    wave_len = waves.shape[-1] + 256  # the export's length: the cut + 256
    full = np.zeros(waves.shape[:-1] + (wave_len,), np.float32)
    full[..., :waves.shape[-1]] = waves
    name = "coarse_depth/unet linear aux"
    stem = os.path.join(work, "coarse_unet_linear_aux")
    t0 = time.perf_counter()
    texport.main(["--device", "cuda", *serve_flags, "--ckpt_dir", os.path.dirname(linear_dir),
                  "--experiment_name", os.path.basename(linear_dir), "--use_best",
                  "--batch_size", str(waves.shape[0]), "--out", stem + ".pt2"])
    export_s = time.perf_counter() - t0
    np.save(stem + "_wave.npy", full)
    np.save(stem + "_want.npy", np.clip(answer, 0.0, 30.0))
    return {"name": name, "pt2": stem + ".pt2", "wave": stem + "_wave.npy",
            "want": stem + "_want.npy", "got": stem + "_got.npy", "runs": EXPORT_RUNS,
            "per_call": B1_ONCE,
            "row": {"name": name, "batch": int(waves.shape[0]), "export_s": export_s,
                    "pt2_bytes": os.path.getsize(stem + ".pt2")}}


def phase_export(torch, np, serve, work, coarse_jobs):
    """unet_baseline (unet_256, ngf 64) and binaural_attention (base 64,
    levels 2-5, γ seeded) in bf16 at 256², random init from seed 0, each
    exported at batch 1 and 16 by `tools/export.py` (timed, `.pt2` bytes),
    with the coarse unet's linear-aux checkpoint from train_families; then
    one fresh `python3 -c` process that imports tools.export alone loads
    and runs every program: each answer finite, within [0, 30] m and within
    SERVED_TOL of `serve`'s InferenceRunner on the same weights (of the
    aux_centers answer for the coarse one); B1 once a call, B2 four times
    a binaural call and never a unet call, B3 never; the median ms of one
    exported call beside eager `predict_meters`'s."""
    from audiodepth_tpu_torch.tools import export as texport

    jobs, rows = [], {}
    for path, spec in SERVE_PATHS.items():
        args = serve.build_parser().parse_args(
            ["--random_init", "--seed", "0", *spec["argv"], "--compute_dtype", "bfloat16"])
        cfg, task, _ = serve.load_serving_state(args)
        if path == "binaural_attention":
            set_gammas(torch, np, task.model)
        runner = serve.InferenceRunner(cfg, task, ladder=list(EXPORT_BATCHES))
        try:
            for b in EXPORT_BATCHES:
                waves = (np.random.default_rng(30 + b).standard_normal(
                    (b, 2, texport.wave_length(cfg))) * 0.05).astype(np.float32)
                served = runner.run(np.ascontiguousarray(waves[..., :runner.wave_len]))
                job, row = export_job(torch, np, texport, cfg, task, b, waves, served,
                                      spec["per_batch"], work, f"{path} bs{b}")
                jobs.append(job)
                rows[job["name"]] = row
        finally:
            runner.close()
        del task, runner
        torch.cuda.empty_cache()
    for job in coarse_jobs:
        rows[job["name"]] = job.pop("row")
        jobs.append(job)
    spec_path = os.path.join(work, "jobs.json")
    with open(spec_path, "w") as f:
        json.dump(jobs, f)
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", EXPORT_CHILD, spec_path],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    assert child.returncode == 0, child.stderr[-4000:]
    line = next(ln for ln in child.stdout.splitlines() if ln.startswith("EXPORT_CHILD "))
    results = {r["name"]: r for r in json.loads(line[len("EXPORT_CHILD "):])}
    paths = {}
    for job in jobs:
        r, row = results[job["name"]], rows[job["name"]]
        got, want = np.load(job["got"]), np.load(job["want"])
        assert got.shape == want.shape and got.shape[1:] == (256, 256, 1), (got.shape, want.shape)
        assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 30.0
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= SERVED_TOL * scale, (job["name"], err, scale)
        per_call = {k: v for k, v in job["per_call"].items()}
        assert r["first_call"] == per_call, (job["name"], r["first_call"], per_call)
        expected = {k: v * r["calls"] for k, v in per_call.items()}
        assert r["launches"] == expected, (job["name"], r["launches"], expected)
        assert r["launches"]["flash_cross_attention_bwd"] == 0
        row.update(exported_ms_median=r["ms_median"], load_s=r["load_s"],
                   launches=r["launches"], launches_per_call=r["first_call"],
                   launches_by_variant=r["by_variant"], served_vs_exported_max_abs=err,
                   served_max_abs=scale, tol_rel=SERVED_TOL)
        emit({"phase": "export", **row})
        paths[f"export {job['name']}"] = (r["launches"], r["by_variant"])
    emit({"phase": "export", "fresh_process_s": child_s, "programs": len(jobs)})
    return paths


PROFILE_STEP_RUNS = (("unet_baseline", TRAIN_BATCH), ("unet_baseline", UNET_BIG_BATCH),
                     ("binaural_attention", TRAIN_BATCH))
PROFILE_STEPS = 8


def phase_profile_step(torch, kernels):
    """`tools/profile_step.py` in-process for the unet at batch 16 and 256
    and the binaural net (base 64, levels 2-5, remat) at 16, 8 traced steps
    each after 3 untraced: its report, and for each hand-written kernel the
    trace's launches beside its counter (DROPPED where they differ)."""
    from audiodepth_tpu_torch.tools import profile_step as ps

    paths = {}
    for model, batch in PROFILE_STEP_RUNS:
        reset_launches(kernels)
        t0 = time.perf_counter()
        prof, counters = ps.main(["--model", model, "--batch_size", str(batch),
                                  "--steps", str(PROFILE_STEPS)])
        wall = time.perf_counter() - t0
        launches, by_variant = read_launches(kernels)
        per_step = PER_TRAIN_STEP if model == "binaural_attention" else UNET_PER_TRAIN_STEP
        assert counters == {k: v * PROFILE_STEPS for k, v in per_step.items()}, counters
        assert len(prof.per_step) == PROFILE_STEPS and min(prof.per_step) > 0, prof.per_step
        rows = hand_written(prof, counters)
        emit({"phase": "profile_step", "model": model, "batch": batch, "steps": PROFILE_STEPS,
              "wall_s": wall, "gpu_ms_per_step": prof.total_us / 1e3 / PROFILE_STEPS,
              "per_step_ms": [t / 1e3 for t in prof.per_step],
              "busy_union_ms": prof.busy_us / 1e3, "window_ms": prof.window_us / 1e3,
              "busy_share": prof.busy_us / prof.window_us if prof.window_us else None,
              "categories_ms_per_step": {k: v / 1e3 / PROFILE_STEPS for k, v in
                                         sorted(prof.per_category.items(), key=lambda kv: -kv[1])},
              "hand_written": rows,
              "dropped": sorted(k for k, v in rows.items() if v["dropped"])})
        paths[f"profile_step {model} bs{batch}"] = (launches, by_variant)
        torch.cuda.empty_cache()
    return paths


def phase_trace_probe(torch, np, ff, fa):
    """Which hand-written kernels' records the profiler keeps: 10 calls of
    B1 (a cluster launch, cudaLaunchKernelEx) and of B2 (a plain launch) on
    the train path's shapes, right after the profiler starts, traced four
    ways: as is, with a synchronize before the trace stops, with the
    profiler's CUDA sync events on, and after `prime_trace`."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    from audiodepth_tpu_torch.obs.logging import prime_trace
    from audiodepth_tpu_torch.tools.profile_step import HAND_WRITTEN, parse_trace

    wave = torch.from_numpy((np.random.default_rng(5).standard_normal((16, 2, 7782)) * 0.05)
                            .astype(np.float32)).cuda()
    q, k, v = (torch.randn((32, 256, d), device="cuda", dtype=torch.bfloat16)
               for d in (64, 64, 512))
    patterns = dict(HAND_WRITTEN)
    rows = {}
    for how in ("as is", "synchronize before stop", "cuda sync events", "after the primer"):
        config = _ExperimentalConfig(enable_cuda_sync_events=True) if how == "cuda sync events" \
            else None
        before = (ff.fused_mel_frontend.launches, fa.flash_cross_attention.launches)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_probe_")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         experimental_config=config) as prof:
                if how == "after the primer":
                    prime_trace("cuda")
                for _ in range(10):
                    ff.fused_mel_frontend(wave)
                    fa.flash_cross_attention(q, k, v, 0.125)
                if how == "synchronize before stop":
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trace = parse_trace(path, 1)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        counted = (ff.fused_mel_frontend.launches - before[0],
                   fa.flash_cross_attention.launches - before[1])
        rows[how] = {"B1 trace": trace.launches(patterns["fused_mel_frontend"]),
                     "B1 counter": counted[0],
                     "B2 trace": trace.launches(patterns["flash_cross_attention_fwd"]),
                     "B2 counter": counted[1],
                     "kernel names": sorted({a.name[:50] for a in trace.activity})[:12]}
    emit({"phase": "trace_probe", "rows": rows})


def phase_profile_dir(torch, train_cli, kernels):
    """cli/train.py --profile_dir for the unet (2 epochs of 2 steps at 16,
    no validation): one trace, epoch 2's, whose kernels `parse_trace` reads
    (B1 and the convolutions among them) beside epoch 2's counters."""
    from audiodepth_tpu_torch.tools import profile_step as ps

    out = tempfile.mkdtemp(prefix="chip_smoke_profile_dir_")
    marks = {}

    def on_step(state, metrics):
        if state.step == 2:  # the end of epoch 1
            marks["epoch1"] = {w.name: w.launches for w, _, _ in kernels}

    try:
        reset_launches(kernels)
        argv = UNET_TRAIN_ARGV + ["--epochs", "2", "--num_samples", str(2 * TRAIN_BATCH),
                                  "--validation", "false", "--profile_dir", out]
        eng, state = train_cli.main(argv, on_step=on_step)
        launches, by_variant = read_launches(kernels)
        files = sorted(os.listdir(out))
        assert files == ["epoch_2.pt.trace.json"], files
        trace = ps.parse_trace(os.path.join(out, files[0]), 2)
        counters = {k: launches[k] - marks["epoch1"][k] for k in launches}
        print(ps.report(trace, 2, 12, counters), flush=True)
        assert counters == {k: 2 * v for k, v in UNET_PER_TRAIN_STEP.items()}, counters
        assert trace.per_category.get("convolution forward (cuDNN fprop)", 0) > 0, \
            trace.per_category
        emit({"phase": "profile_dir", "flags": argv, "files": files, "steps": state.step,
              "gpu_ms_per_step": trace.total_us / 1e3 / 2, "n_gpu_events": len(trace.activity),
              "hand_written": hand_written(trace, counters), "launches": launches})
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return launches, by_variant


REMAT_TIMED_STEPS = 3
REMAT_FLOOR_PAIRS = 3  # repeated no-remat float32 passes, each paired with the first


def phase_adabins_remat(torch, np, configs, models, kernels):
    """adabins_distillation at full width (base 64, 128 bins, 256²) and
    batch 16 with model.extra.remat: in bf16, REMAT_TIMED_STEPS timed train
    steps with the student recomputed and without, with the peak memory of
    each (lower with remat); in float32 (TF32 off), the gradients of one
    loss from the same weights and generator seed with remat and without
    (without four times: the card's run-to-run floor is the largest
    distance of the three repeats from the first): the remat gradients
    within F32_GRAD_FACTOR of that floor + 1e-6, in global relative L2."""
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.codec import decode_batch
    from audiodepth_tpu_torch.train.engine import Engine

    def setup(dtype):
        cfg = configs.load_config("synthetic", "train", model_name="adabins_distillation",
                                  overrides={"mode.batch_size": TRAIN_BATCH,
                                             "mode.compute_dtype": dtype,
                                             "model.extra.remat": True})
        task = models.make_task(cfg, device="cuda")
        assert task.model.remat and cfg.model.base_channels == 64 and cfg.model.n_bins == 128
        models.init_weights(task.model, torch.Generator().manual_seed(0))
        eng = Engine(cfg, task)
        batch = eng.encode(next(make_dataset(cfg, "train", num_samples=TRAIN_BATCH,
                                             with_image=True).batches(TRAIN_BATCH,
                                                                      shuffle=False)))
        return cfg, task, eng, batch

    reset_launches(kernels)
    cfg, task, eng, batch = setup("bfloat16")
    state = eng.init_state()
    timing = {}
    for remat in (False, True, False, True):  # in turns
        task.model.remat = remat
        state, _ = eng.train_step(state, batch)  # warm: cuDNN's choices, AdamW's moments
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REMAT_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = eng.train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        assert np.isfinite(float(m["loss"]))
        timing.setdefault(remat, []).append({
            "step_ms_median": statistics.median(times) * 1e3,
            "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    del state, eng, task
    torch.cuda.empty_cache()

    cfg, task, eng, batch = setup("float32")
    dec = decode_batch(eng.put_batch(batch), eng._depth_units)

    def grads(remat):
        task.model.remat = remat
        task.model.zero_grad(set_to_none=True)
        task.begin_step(0)
        loss, _ = task.loss_fn(dec, 0.0)
        loss.backward()
        named = {n: p.grad.detach().clone() for n, p in task.model.named_parameters()
                 if p.grad is not None}
        return float(loss), named

    def rel_l2(a, b):
        num = sum(float((a[n] - b[n]).double().pow(2).sum()) for n in b)
        den = sum(float(b[n].double().pow(2).sum()) for n in b)
        return (num / den) ** 0.5

    loss_a, a = grads(False)
    repeats = [grads(False) for _ in range(REMAT_FLOOR_PAIRS)]
    loss_b, b = grads(True)
    launches, by_variant = read_launches(kernels)
    # the card's run-to-run floor: the largest of REMAT_FLOOR_PAIRS repeated
    # no-remat pairs (one pair understates it)
    floors = [rel_l2(r, a) for _, r in repeats]
    floor, err = max(floors), rel_l2(b, a)
    assert set(a) == set(b) and all(n.startswith(("audio_", "residual_")) for n in a), \
        sorted(set(a) ^ set(b))[:4]
    assert err <= F32_GRAD_FACTOR * floor + 1e-6, (err, floor)
    peak = {r: max(t["peak_mem_mb"] for t in timing[r]) for r in timing}
    assert peak[True] < peak[False], peak
    steps = 2 * 2 * (1 + REMAT_TIMED_STEPS)
    assert launches["fused_mel_frontend"] == steps + 2 + REMAT_FLOOR_PAIRS, launches
    # the soft-binning pair in the bf16 steps only (float32 keeps the model's
    # chain); a remat step runs the student's forward twice, both with grad
    assert by_variant["soft_binning_fwd"] == {"grad": steps // 2 * 3, "no_grad": steps} \
        and launches["soft_binning_bwd"] == steps, by_variant
    emit({"phase": "adabins_remat", "batch": TRAIN_BATCH, "timing_bf16": {
          "remat": timing[True], "no_remat": timing[False]},
          "peak_mem_mb": {"remat": peak[True], "no_remat": peak[False]},
          "f32_loss": {"no_remat": [loss_a] + [l for l, _ in repeats], "remat": loss_b},
          "f32_grad_rel_l2": {"remat_vs_no_remat": err, "no_remat_repeats": floors,
                              "floor": floor},
          "tol": f"{F32_GRAD_FACTOR} x floor + 1e-6", "launches": launches})
    del task, eng
    torch.cuda.empty_cache()
    return launches, by_variant


def phase_verify_contracts(torch):
    """tools/verify_contracts.py on the card at base 64, 256²."""
    from audiodepth_tpu_torch.tools import verify_contracts as vc

    ok = vc.verify_compatibility(64, 256, verbose=True, device="cuda")
    shapes = vc.contract_shapes(64, 256, device="cuda")
    assert ok and all(a == b for a, b in shapes.values()), shapes
    emit({"phase": "verify_contracts", "ok": ok, "shapes_nchw": shapes})


# the example scripts (`audiodepth_tpu_torch/examples/`) on the card
COMPARE_REL_TOL = 1e-6  # a compare_checkpoints row vs cli/evaluate's means, float32
EXAMPLES_RMSE_MAX = 7.0  # m: the last val RMSE of the convergence run and of each family
# the family whose last val RMSE may exceed its first: its λ_recon
# curriculum plateaus in 10 epochs (the JAX package's sweep: 5.18 → 5.40)
SWEEP_PLATEAU = ("base_residual",)
# the two families whose head has a hard floor at 0 (the cVAE's ReLU, the
# RGB teacher's clamp) and which, in the JAX package as in the port, end
# dead or slow from some draws of their init (ROADMAP.md §C; the draws are
# counted by tests/torch_head_init_witness.py on the CPU). Where one of them
# misses the gate from the scripts' seed (mode.seed 0), the miss is recorded
# and the family is trained again from each of SWEEP_RESEEDS, and every one
# of those runs must meet the whole gate. Any other family that misses it
# from seed 0 fails the phase
FLOOR_AT_0_FAMILIES = ("unet_cvae", "rgb_depth")
SWEEP_RESEEDS = (1, 2, 3, 4, 5)
AUDIO_FREE = ("rgb_depth",)  # the sweep's families that run no front end


def experiment_dir(train_cli, argv, root):
    """Where `cli/train.py` run with `argv` saves under `root`."""
    from audiodepth_tpu_torch.configs import experiment_name

    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    return os.path.join(root, experiment_name(cfg))


def _compare_entries(root, unet_dir, binaural_dir, coarse_dir):
    """The checkpoints the run wrote, as (label, family, path, entry
    overrides, cli/evaluate flags naming the same weights): the unet's
    experiment directory and a reference-format .pth of its latest epoch,
    the binaural net's and the coarse hybrid's directories."""
    import torch

    from audiodepth_tpu_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(*os.path.split(unet_dir), create=False)
    payload = torch.load(mgr.path(mgr.latest_epoch()), map_location="cpu", weights_only=True)
    pth = os.path.join(root, "unet_reference.pth")
    torch.save({"epoch": payload["epoch"], "state_dict": payload["state_dict"]}, pth)
    hybrid = ["model.model_type=hybrid"]
    return [("unet_baseline dir", "unet_baseline", unet_dir, [], ["--checkpoint_path", unet_dir]),
            ("unet_baseline pth", "unet_baseline", pth, [], ["--torch_checkpoint", pth]),
            ("binaural_attention dir", "binaural_attention", binaural_dir, [],
             ["--checkpoint_path", binaural_dir]),
            ("coarse_depth hybrid dir", "coarse_depth", coarse_dir, hybrid,
             ["--checkpoint_path", coarse_dir] + [f"--override={o}" for o in hybrid])]


def phase_examples_compare(torch, np, evaluate_cli, kernels, root, entries):
    """`examples/compare_checkpoints.py` over the run's checkpoints
    (`_compare_entries`) on the synthetic val split of VAL_SAMPLES, in
    float32: the CSV's header is the reference's, each row equals
    `cli/evaluate.py`'s means of the same weights on the same split within
    COMPARE_REL_TOL, and the two unet rows (the directory and the .pth)
    agree as closely; B1 once an eval batch, B2 four times a binaural one.
    Both tools run on cuDNN's deterministic algorithms: without them the
    card's float32 eval is not bit-reproducible (a .pth row's ABS_REL,
    RMSE and MAE were seen 4-9e-8 from evaluate's), and Delta1 counts pixels
    against a threshold, so one pixel within rounding of it (1 of 4.2 M)
    moves it by 2.7e-6, above COMPARE_REL_TOL."""
    import csv

    from audiodepth_tpu_torch.examples import compare_checkpoints

    out = os.path.join(root, "comparison.csv")
    argv = ["--dataset", "synthetic", "--num_samples", str(VAL_SAMPLES),
            "--batch_size", str(TRAIN_BATCH), "--out", out]
    for label, family, path, overrides, _ in entries:
        argv += ["--entry", ":".join([label, family, path] + ([",".join(overrides)]
                                                             if overrides else []))]
    reset_launches(kernels)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    rows = compare_checkpoints.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    n_eval = -(-VAL_SAMPLES // TRAIN_BATCH)
    n_binaural = sum(family == "binaural_attention" for _, family, _, _, _ in entries)
    expected = {"fused_mel_frontend": n_eval * len(entries),
                "flash_cross_attention_fwd": 4 * n_eval * n_binaural,
                "flash_cross_attention_bwd": 0, **NO_BN, **NO_SB}
    assert launches == expected, f"compare: launches {launches}, expected {expected}"
    with open(out) as f:
        header = next(csv.reader(f))
    assert header == list(compare_checkpoints.COLUMNS), header
    keys = {"ABS_REL": "abs_rel", "RMSE": "rmse", "MAE": "mae", "Delta1": "delta1"}
    checks = []
    for row, (label, family, _, _, flags) in zip(rows, entries):
        assert row["Model"] == label and all(np.isfinite(row[c]) for c in keys), row
        means = evaluate_cli.main(["--dataset", "synthetic", "--eval_on", "val",
                                   "--model", family, "--compute_dtype", "float32",
                                   "--batch_size", str(TRAIN_BATCH),
                                   "--stat_dir", os.path.join(root, "eval"), *flags])
        rel = {c: abs(row[c] - means[k]) / max(abs(means[k]), 1e-12) for c, k in keys.items()}
        assert all(d <= COMPARE_REL_TOL for d in rel.values()), (label, row, means)
        checks.append({"label": label, "row": row, "evaluate_means": means, "rel_diff": rel})
    torch.backends.cudnn.deterministic = deterministic
    same = {c: abs(rows[0][c] - rows[1][c]) / max(abs(rows[1][c]), 1e-12) for c in keys}
    assert all(d <= COMPARE_REL_TOL for d in same.values()), (rows[0], rows[1])
    emit({"phase": "examples_compare", "flags": argv, "seconds": seconds, "rows": checks,
          "unet_dir_vs_pth_rel_diff": same, "tol_rel": COMPARE_REL_TOL,
          "launches": launches, "expected_launches": expected})
    return launches, by_variant


def phase_examples_convergence(torch, np, kernels):
    """`examples/synthetic_convergence.py` at its defaults: unet_256 (ngf
    64), bf16, batch 64, 512 train / 64 val samples, 30 epochs (240
    steps), validated at epoch 1 and every 5th. Every loss finite; the last
    val RMSE below epoch 1's and at most EXAMPLES_RMSE_MAX; B1 once a step
    and an eval batch, B2 and B3 never."""
    from audiodepth_tpu_torch.examples import synthetic_convergence

    losses = []
    reset_launches(kernels)
    t0 = time.perf_counter()
    rows = synthetic_convergence.run(device="cuda",
                                     on_step=lambda state, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_variant = read_launches(kernels)
    losses = torch.stack(losses).float().cpu().numpy()
    epochs, steps = rows[-1]["epoch"], len(losses)
    assert epochs == 30 and steps == 30 * 512 // 64, (epochs, steps)
    assert np.isfinite(losses).all(), losses
    first, last = rows[0]["rmse"], rows[-1]["rmse"]
    assert last < first and last <= EXAMPLES_RMSE_MAX, (first, last)
    expected = {"fused_mel_frontend": steps + len(rows), "flash_cross_attention_fwd": 0,
                "flash_cross_attention_bwd": 0, **bn_launches("unet_baseline", steps), **NO_SB}
    assert launches == expected, f"convergence: launches {launches}, expected {expected}"
    emit({"phase": "examples_convergence", "rows": rows, "steps": steps,
          "train_s": rows[-1]["train_s"], "s_per_epoch": rows[-1]["train_s"] / epochs,
          "s_per_epoch_after_first": (rows[-1]["train_s"] - rows[0]["epoch_s"]) / (epochs - 1),
          "ms_per_step": rows[-1]["train_s"] / steps * 1e3, "main_wall_s": wall,
          "rmse_max": EXAMPLES_RMSE_MAX, "launches": launches, "expected_launches": expected,
          "table": synthetic_convergence.format_table(rows)})
    return launches, by_variant


def _family_expected(name, steps, eval_batches):
    """The launches of `steps` train steps and `eval_batches` eval batches
    of a sweep or step-bench family."""
    b1 = 0 if name in AUDIO_FREE else steps + eval_batches
    attn = name == "binaural_attention"
    return {"fused_mel_frontend": b1,
            "flash_cross_attention_fwd": 4 * (steps + eval_batches) if attn else 0,
            "flash_cross_attention_bwd": 4 * steps if attn else 0,
            # the examples' coarse_depth is the hybrid
            **bn_launches("coarse_depth/hybrid" if name == "coarse_depth" else name, steps),
            **sb_launches(name, steps, eval_batches)}


def _sweep_run(torch, np, kernels, family_sweep, name, over, overrides=None):
    """One family of the sweep with its launches counted: (row, losses,
    launches, by variant)."""
    losses = []
    reset_launches(kernels)
    row = family_sweep.run_family(name, over, device="cuda", overrides=overrides,
                                  on_step=lambda state, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    launches, by_variant = read_launches(kernels)
    expected = _family_expected(name, row["steps"], row["eval_batches"])
    assert launches == expected, f"sweep {name}: launches {launches}, expected {expected}"
    losses = torch.stack(losses).float().cpu().numpy()
    assert row["steps"] == 10 * 256 // 32 == len(losses), (name, row["steps"])
    assert np.isfinite(losses).all(), (name, losses)
    first, last = row["first"], row["last"]
    assert all(np.isfinite(v) for d in (first, last) for v in d.values()), (name, row)
    return (dict(row, launches=launches, expected_launches=expected,
                 loss_first=float(losses[0]), loss_last=float(losses[-1])),
            launches, by_variant)


def _meets_gate(name, row) -> bool:
    """The last val RMSE at most EXAMPLES_RMSE_MAX and below the first (but
    for SWEEP_PLATEAU)."""
    first, last = row["first"]["rmse"], row["last"]["rmse"]
    return last <= EXAMPLES_RMSE_MAX and (name in SWEEP_PLATEAU or last < first)


def phase_examples_sweep(torch, np, kernels):
    """`examples/family_sweep.py` at its defaults: the seven families (base
    32 for the big ones, 64 AdaBins bins, the coarse hybrid with 32 bins),
    bf16, batch 32, 256 train / 32 val samples, 10 epochs, validated after
    epochs 1 and 10, weights from seed 0. Every loss and val metric finite;
    each family meets the gate (`_meets_gate`), or, for one of
    FLOOR_AT_0_FAMILIES that misses it from seed 0, each of its
    SWEEP_RESEEDS runs does; B1 once a step and an eval batch in each audio
    family, B2 four times a binaural step and eval batch, B3 four times a
    binaural step."""
    import gc

    from audiodepth_tpu_torch.examples import family_sweep

    rows, paths, misses = [], {}, []
    t0 = time.perf_counter()
    for name, over in family_sweep.FAMILIES:
        row, launches, by_variant = _sweep_run(torch, np, kernels, family_sweep, name, over)
        paths[f"examples family_sweep {name}"] = (launches, by_variant)
        rows.append(row)
        if not _meets_gate(name, row):
            first, last = row["first"]["rmse"], row["last"]["rmse"]
            assert name in FLOOR_AT_0_FAMILIES, (name, first, last)
            misses.append({"family": name, "seed": 0, "first_rmse": first, "last_rmse": last})
            for seed in SWEEP_RESEEDS:
                gc.collect()
                torch.cuda.empty_cache()
                row, launches, by_variant = _sweep_run(
                    torch, np, kernels, family_sweep, name, over, overrides={"mode.seed": seed})
                paths[f"examples family_sweep {name} seed {seed}"] = (launches, by_variant)
                rows.append(dict(row, family=f"{name} (seed {seed})"))
                assert _meets_gate(name, row), (name, seed, row["first"]["rmse"],
                                                row["last"]["rmse"])
            misses[-1].update(reseeds=list(SWEEP_RESEEDS),
                              reseed_last_rmse=[r["last"]["rmse"] for r in rows[-5:]])
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "examples_sweep", "families": rows, "rmse_max": EXAMPLES_RMSE_MAX,
          "plateau_allowed": list(SWEEP_PLATEAU), "misses_at_seed_0": misses,
          "wall_s": time.perf_counter() - t0, "table": family_sweep.format_table(rows)})
    return paths


def phase_examples_step_bench(torch, kernels, smi):
    """`examples/family_step_bench.py` at its defaults: the seven families at
    full width (the presets; the coarse hybrid with 32 bins), bf16, batch
    32, one device-resident batch, 3 warm-up and 20 timed steps: ms a step,
    pairs/s and the peak memory of each; the last loss finite; B1, B2 and
    B3 launched as the steps need."""
    import gc

    from audiodepth_tpu_torch.examples import family_step_bench

    rows, paths = [], {}
    for name, over in family_step_bench.FAMILIES:
        reset_launches(kernels)
        row = family_step_bench.time_family(name, over, device="cuda")
        launches, by_variant = read_launches(kernels)
        expected = _family_expected(name, 3 + row["steps"], 0)
        assert launches == expected, f"step bench {name}: launches {launches}, expected {expected}"
        assert math.isfinite(row["loss"]) and row["batch"] == 32, row
        rows.append(dict(row, launches=launches))
        paths[f"examples family_step_bench {name}"] = (launches, by_variant)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "examples_step_bench", "families": rows, "nvidia_smi": smi,
          "table": family_step_bench.format_table(rows)})
    return paths


# the prefix of each wrapper's kernels in the ptxas report
PTXAS_PREFIX = {"fused_mel_frontend": ("fused_mel", "frontend_normalize"),
                "flash_cross_attention_fwd": "flash_fwd",
                "flash_cross_attention_bwd": "flash_bwd",
                "batch_norm_train_fwd": "bn_fwd", "batch_norm_train_bwd": "bn_bwd",
                "soft_binning_fwd": "soft_bin_fwd", "soft_binning_bwd": "soft_bin_bwd"}


# data parallelism on the one card (`parallel/`): a world of one NCCL rank
# in a child process (no process group leaks into the phases after it), and
# two gloo ranks time-sharing cuda:0 (NCCL refuses two ranks on one GPU)
DP_GLOBAL_BATCH = 16      # 8 + 8 rows on the two gloo ranks
DP_NCCL_STEPS = 4         # the NCCL world's bf16 steps, beside the plain engine's
DP_STEPS = 3              # the gloo world's bf16 steps on one repeated batch
DP_MODELS = ("unet_baseline", "binaural_attention")
# the float32 gradient check's global batch: small enough for the CPU's
# float64 reference at full width (one row a rank for the binaural net)
DP_F32_BATCH = {"unet_baseline": 4, "binaural_attention": 2}
DP_F32_SLACK = 1e-6       # added to F32_GRAD_FACTOR × the plain engine's error
# a data group keeps BatchNorm's own code (the global batch's statistics)
DP_PER_STEP = {"unet_baseline": dict(UNET_PER_TRAIN_STEP, **NO_BN, **NO_SB),
               "binaural_attention": dict(PER_TRAIN_STEP, **NO_BN, **NO_SB)}
DP_WORLD_TIMEOUT_S = 420
DP_DEVICE = "cuda:0"      # every rank's card
DP_ONE_RANK_BACKEND = "nccl"


def _dp_cfg(configs, model, dtype, batch, f32_check=False):
    """The model at full width (unet_256 ngf 64, or the binaural net at
    base 64), 256², synthetic. `f32_check`: plain SGD without a clip, which
    leaves a train step's reduced gradient on the parameters as it was, and
    for the unet the sigmoid head (depth_norm): at init the default head's
    outputs sit at the SIlog's clamp, where the gradient is discontinuous,
    and there a float32 gradient is 14-18 % off float64 on the card and on
    the CPU alike (f32_train_vs_cpu), which no bound of 2× can resolve."""
    over = {"mode.compute_dtype": dtype, "mode.batch_size": batch, "mode.seed": 0}
    if f32_check:
        over.update({"mode.optimizer": "SGD", "mode.grad_clip_norm": 0.0})
        if model == "unet_baseline":
            over["dataset.depth_norm"] = True
    return configs.load_config("synthetic", "train", model_name=model, overrides=over)


def _dp_task(torch, np, models, cfg, device, sp_axis=None):
    task = models.make_task(cfg, device=device)
    models.init_weights(task.model, torch.Generator().manual_seed(0))
    if cfg.model.name == "binaural_attention":
        set_gammas(torch, np, task.model)
        task.model.sp_axis = sp_axis
    return task


def _dp_digest(torch, model) -> str:
    """sha256 of every parameter's and buffer's bytes, in state_dict order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_local(batch, group):
    """This rank's rows of a global batch (its data index's in a
    ('data', 'model') group)."""
    from audiodepth_tpu_torch.parallel import shard_global_batch

    return shard_global_batch(batch, group)


def _dp_f32_grads(torch, np, configs, models, model, group, state_dict, batch):
    """The float32 (TF32 off) gradient of one engine step on the global
    `batch` (this rank's rows in a group), on the card."""
    from audiodepth_tpu_torch.parallel import MeshGroup
    from audiodepth_tpu_torch.train.engine import Engine

    cfg = _dp_cfg(configs, model, "float32", DP_F32_BATCH[model], f32_check=True)
    task = models.make_task(cfg, device=DP_DEVICE)
    task.model.load_state_dict(state_dict, strict=True)
    if isinstance(group, MeshGroup):
        task.model.sp_axis = "model"
    eng = Engine(cfg, task, group=group)
    state = eng.init_state()
    eng.train_step(state, _dp_local(batch, group))
    return {n: p.grad.detach().cpu().double() for n, p in task.model.named_parameters()
            if p.grad is not None}


def _dp_f32_check(torch, np, configs, models, model, group):
    """The group's float32 gradient against a CPU float64 step on the same
    global batch, beside the plain engine's (no group) on the card: the
    group's error (global relative L2, worst tensor) within F32_GRAD_FACTOR
    × the plain engine's + DP_F32_SLACK. Rank 0 measures; every rank takes
    the group's step."""
    from audiodepth_tpu_torch.data.batvision import make_dataset

    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    n = DP_F32_BATCH[model]
    cfg64 = _dp_cfg(configs, model, "float64", n, f32_check=True)
    ref = _dp_task(torch, np, models, cfg64, "cpu")
    state_dict = {k: v.float() if v.is_floating_point() else v
                  for k, v in ref.model.state_dict().items()}
    batch = next(make_dataset(cfg64, "train", num_samples=n).batches(n, shuffle=False))
    got = _dp_f32_grads(torch, np, configs, models, model, group, state_dict, batch)
    if group is not None and not group.is_main:
        group.barrier()
        return None
    plain = _dp_f32_grads(torch, np, configs, models, model, None, state_dict, batch)
    t0 = time.perf_counter()
    ref.model.double().load_state_dict(state_dict, strict=True)
    ref.model.zero_grad(set_to_none=True)
    loss, _ = ref.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0)
    loss.backward()
    want = {n: p.grad.detach().double() for n, p in ref.model.named_parameters()
            if p.grad is not None}
    cpu_s = time.perf_counter() - t0
    gmax = max(float(g.abs().max()) for g in want.values())
    ref_l2 = float(torch.sqrt(sum((g * g).sum() for g in want.values())))

    def errors(grads):
        per = {k: float((grads[k] - w).abs().max()) / max(float(w.abs().max()), 1e-3 * gmax)
               for k, w in want.items()}
        l2 = float(torch.sqrt(sum(((grads[k] - w) ** 2).sum() for k, w in want.items())))
        return l2 / ref_l2, max(per.values())

    assert set(got) == set(plain) == set(want), model
    got_l2, got_worst = errors(got)
    plain_l2, plain_worst = errors(plain)
    if group is not None:
        group.barrier()
    assert got_l2 <= F32_GRAD_FACTOR * plain_l2 + DP_F32_SLACK, (model, got_l2, plain_l2)
    assert got_worst <= F32_GRAD_FACTOR * plain_worst + DP_F32_SLACK, (
        model, got_worst, plain_worst)
    return {"model": model, "global_batch": n, "group_vs_f64_global_l2_rel": got_l2,
            "plain_vs_f64_global_l2_rel": plain_l2, "group_vs_f64_worst_tensor": got_worst,
            "plain_vs_f64_worst_tensor": plain_worst, "grad_factor": F32_GRAD_FACTOR,
            "slack": DP_F32_SLACK, "cpu_f64_seconds": cpu_s}


def _dp_bf16_steps(torch, np, configs, models, kernels, model, group, steps, batches,
                   global_batch=DP_GLOBAL_BATCH, sp_axis=None):
    """`steps` bf16 engine steps (this rank's rows of each global batch)
    from the seeded init: losses, step times, launches (counts reset just
    before, read just after), a digest of the state after each step, the
    parameters that did not move, the collectives of the last step and the
    (2B, Nq, Nk) of every attention launch."""
    from audiodepth_tpu_torch.ops.cuda import flash_attention as fa
    from audiodepth_tpu_torch.parallel import collectives
    from audiodepth_tpu_torch.train.engine import Engine

    cfg = _dp_cfg(configs, model, "bfloat16", global_batch)
    task = _dp_task(torch, np, models, cfg, DP_DEVICE, sp_axis)
    eng = Engine(cfg, task, steps_per_epoch=steps, group=group)
    state = eng.init_state()
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    local = [_dp_local(eng.encode(b), group) for b in batches]
    losses, times, digests = [], [], []
    shapes = {"fwd": set(), "bwd": set()}
    wrappers = {"fwd": fa.flash_cross_attention, "bwd": fa.flash_cross_attention_bwd}
    for kind, w in wrappers.items():
        def seen(q, k, *rest, launch=w._launch, kind=kind):
            shapes[kind].add((int(q.shape[0]), int(q.shape[1]), int(k.shape[1])))
            return launch(q, k, *rest)

        w._launch = seen
    try:
        torch.cuda.synchronize()
        reset_launches(kernels)
        for i in range(steps):
            if i == steps - 1:
                collectives.reset()
            t0 = time.perf_counter()
            state, metrics = eng.train_step(state, local[i % len(local)])
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if group is not None and group.size > 1:
                digests.append(_dp_digest(torch, task.model))
        last_step_collectives = collectives.read()
        launches, by_variant = read_launches(kernels)
    finally:
        for w in wrappers.values():
            del w._launch
    unmoved = [n for n, p in task.model.named_parameters()
               if p.requires_grad and torch.equal(p.detach(), before[n])]
    params = {n: p.detach().float().cpu() for n, p in task.model.named_parameters()}
    return {"losses": losses, "step_ms": [t * 1e3 for t in times], "digests": digests,
            "launches": launches, "by_variant": by_variant, "unmoved": unmoved,
            "collectives": last_step_collectives,
            "attention_shapes": {k: sorted(v) for k, v in shapes.items()}}, params


def _dp_rank(rank, world, backend, init, outdir):
    """One rank of a train_dp world, on cuda:0: its cases, then
    rank<r>.json in `outdir`."""
    import torch
    import numpy as np

    from audiodepth_tpu_torch import configs, models
    from audiodepth_tpu_torch._device import configure_precision
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.ops.cuda import KERNELS
    from audiodepth_tpu_torch.parallel import initialize_multihost, shutdown

    configure_precision()
    group = initialize_multihost(init, world, rank, backend=backend, device=DP_DEVICE)
    out = {"rank": rank, "world": world, "backend": backend}
    try:
        one_rank = world == 1
        for model in (("unet_baseline",) if one_rank else DP_MODELS):
            cfg = _dp_cfg(configs, model, "bfloat16", DP_GLOBAL_BATCH)
            n_batches = DP_NCCL_STEPS if one_rank else 1
            ds = make_dataset(cfg, "train", num_samples=DP_GLOBAL_BATCH * n_batches)
            batches = list(ds.batches(DP_GLOBAL_BATCH, shuffle=False))
            steps = DP_NCCL_STEPS if one_rank else DP_STEPS
            row, params = _dp_bf16_steps(torch, np, configs, models, KERNELS, model, group,
                                         steps, batches)
            if one_rank:  # the plain engine from the same init and batches
                plain, plain_params = _dp_bf16_steps(torch, np, configs, models, KERNELS,
                                                     model, None, steps, batches)
                row["plain_losses"] = plain["losses"]
                row["plain_step_ms"] = plain["step_ms"]
                row["max_abs_loss_delta"] = max(abs(a - b) for a, b in
                                                zip(row["losses"], plain["losses"]))
                row["max_abs_param_delta"] = max(float((params[k] - plain_params[k]).abs().max())
                                                 for k in params)
            del params
            row["f32"] = _dp_f32_check(torch, np, configs, models, model, group)
            out[model] = row
            torch.cuda.empty_cache()
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def _dp_world(world, backend, rank_fn=None, timeout_s=DP_WORLD_TIMEOUT_S):
    """Spawn the world (file:// rendezvous) of `rank_fn` (default
    `_dp_rank`), wait at most `timeout_s`, and return every rank's results;
    a rank that fails or hangs fails the phase, and no rank outlives it."""
    import torch.multiprocessing as mp

    rank_fn = rank_fn or _dp_rank
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        ctx = mp.start_processes(rank_fn, args=(world, backend,
                                                "file://" + os.path.join(work, "rdv"), work),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{rank_fn.__name__} {backend} world of {world}: "
                                       f"no end within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_train_dp(torch, np, train_cli, kernels, smi):
    """Data-parallel training on the one card (module note). Returns the
    launches of each rank's path for the kernels line."""
    launches = {}
    t0 = time.perf_counter()
    (one,) = _dp_world(1, DP_ONE_RANK_BACKEND)
    nccl_s = time.perf_counter() - t0
    row = one["unet_baseline"]
    assert all(np.isfinite(row["losses"])) and len(row["losses"]) == DP_NCCL_STEPS, row
    want = {k: v * DP_NCCL_STEPS for k, v in DP_PER_STEP["unet_baseline"].items()}
    assert row["launches"] == want, (row["launches"], want)
    assert not row["unmoved"], row["unmoved"][:8]
    launches["train_dp nccl world of 1 unet_baseline"] = (row["launches"], row["by_variant"])
    emit({"phase": "train_dp", "world": "1 nccl rank", "model": "unet_baseline",
          "card": smi, "global_batch": DP_GLOBAL_BATCH, "steps": DP_NCCL_STEPS,
          "losses": row["losses"], "plain_losses": row["plain_losses"],
          "max_abs_loss_delta": row["max_abs_loss_delta"],
          "max_abs_param_delta": row["max_abs_param_delta"],
          "step_ms": row["step_ms"], "plain_step_ms": row["plain_step_ms"],
          "launches": row["launches"], "f32": row["f32"], "world_s": nccl_s})

    t0 = time.perf_counter()
    ranks = _dp_world(2, "gloo")
    gloo_s = time.perf_counter() - t0
    for model in DP_MODELS:
        rows = [r[model] for r in ranks]
        per_step = {k: v * DP_STEPS for k, v in DP_PER_STEP[model].items()}
        for rank, r in enumerate(rows):
            assert all(np.isfinite(r["losses"])), (model, rank, r["losses"])
            assert r["losses"][-1] < r["losses"][0], (model, rank, r["losses"])
            assert not r["unmoved"], (model, rank, r["unmoved"][:8])
            assert r["launches"] == per_step, (model, rank, r["launches"], per_step)
            launches[f"train_dp gloo rank {rank} of 2 {model}"] = (r["launches"],
                                                                  r["by_variant"])
        # one replicated state: both ranks' parameters and buffers bit-equal
        # after every step, and one global loss
        assert rows[0]["digests"] == rows[1]["digests"], model
        assert rows[0]["losses"] == rows[1]["losses"], model
        assert rows[0]["f32"] is not None and rows[1]["f32"] is None
        emit({"phase": "train_dp", "world": "2 gloo ranks time-sharing one card",
              "model": model, "card": smi, "global_batch": DP_GLOBAL_BATCH,
              "rows_per_rank": DP_GLOBAL_BATCH // 2, "steps": DP_STEPS,
              "losses": rows[0]["losses"],
              "step_ms": {f"rank {i}": r["step_ms"] for i, r in enumerate(rows)},
              "note": "two processes time-sharing one card, collectives staged "
                      "through host memory: not a scaling measurement",
              "launches_per_rank": rows[0]["launches"], "f32": rows[0]["f32"],
              "state_digest_after_each_step": rows[0]["digests"]})

    # the CLI: more ranks than cards exits naming the count; one rank trains
    count = torch.cuda.device_count()
    proc = subprocess.run([sys.executable, "-m", "audiodepth_tpu_torch.cli.train",
                           "--dataset", "synthetic", "--num_devices", str(count + 1)],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    said = proc.stdout + proc.stderr
    assert proc.returncode != 0 and f"this machine has {count} CUDA device" in said, said[-2000:]
    eng, state = train_cli.main([
        "--dataset", "synthetic", "--model", "unet_baseline", "--compute_dtype", "bfloat16",
        "--batch_size", str(DP_GLOBAL_BATCH), "--num_samples", str(DP_GLOBAL_BATCH),
        "--epochs", "1", "--validation", "false", "--seed", "0", "--num_devices", "1"])
    assert state.step == 1 and np.isfinite(eng.history[-1]["loss"]), eng.history
    emit({"phase": "train_dp", "cli_num_devices_over_count": {
        "num_devices": count + 1, "returncode": proc.returncode,
        "message": said.strip().splitlines()[-1]},
          "cli_num_devices_1_steps": state.step, "gloo_world_s": gloo_s})
    return launches


# sequence parallelism (`parallel/`, `sp_axis`) on the one card: a world of
# two gloo ranks time-sharing cuda:0 as a 1 × 2 ('data', 'model') group,
# each holding the whole global batch and half of every attention's query
# rows
SP_GLOBAL_BATCH = 8
SP_STEPS = 3
SP_STFT_TOL = 1e-5        # sharded vs one-device plain-STFT front end, relative to max
SP_WORLD_TIMEOUT_S = 420


def _sp_levels(size=256, base=64, rows=SP_GLOBAL_BATCH):
    """(2B, N, C) of each attention level of the binaural net."""
    ch = {2: 2 * base, 3: 4 * base, 4: 8 * base, 5: 8 * base}
    return [(2 * rows, (size // 2 ** (lv - 1)) ** 2, ch[lv]) for lv in (2, 3, 4, 5)]


def sp_collectives_want(sp, itemsize=2):
    """A rank's collectives of one dp 1 × sp binaural step at full width
    (the formulas of tests/test_torch_sequence_parallel.py): the attention
    outputs and dq all-gathered over the model axis in the compute dtype,
    dK and dV all-reduced in float32; nothing over the data axis of one."""
    levels = _sp_levels()
    return {"all-gather": {"count": 2 * len(levels), "bytes": sum(
                b2 * n * c * itemsize + b2 * n * (c // 8) * itemsize for b2, n, c in levels)},
            "all-reduce": {"count": 2 * len(levels), "bytes": sum(
                b2 * n * (c // 8) * 4 + b2 * n * c * 4 for b2, n, c in levels)}}


def _sp_stft_check(torch, np, configs, mesh):
    """The plain-spectrogram front end on a global batch of 8 synthetic
    BV2 waveforms (7,782 samples after the time-of-flight cut) with its
    STFT's frames split over the model axis, against the one-device front
    end, both on the card in float32 (TF32 off); times and collectives."""
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.data.frontend import make_frontend, tof_cut_samples
    from audiodepth_tpu_torch.parallel import collectives

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.load_config("synthetic", "train", overrides={
        "dataset.audio_format": "spectrogram", "mode.batch_size": SP_GLOBAL_BATCH,
        "mode.compute_dtype": "float32"})
    cut = tof_cut_samples(cfg.dataset.max_depth, cfg.dataset.sample_rate)
    assert cut == 7782, cut
    wave = next(make_dataset(cfg, "train", num_samples=SP_GLOBAL_BATCH).batches(
        SP_GLOBAL_BATCH, shuffle=False))["waveform"]
    x = torch.from_numpy(wave).to(DP_DEVICE)
    sharded, plain = make_frontend(cfg, group=mesh), make_frontend(cfg)
    collectives.reset()
    got = sharded(x)
    calls = collectives.read()
    want = plain(x)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert got.shape == want.shape and rel <= SP_STFT_TOL, (rel, SP_STFT_TOL)
    return {"waveform": list(x.shape), "cut": cut, "out": list(got.shape), "rel_err": rel,
            "tol": SP_STFT_TOL, "collectives": calls,
            "sharded_ms": time_ms(torch, lambda: sharded(x), runs=10),
            "plain_ms": time_ms(torch, lambda: plain(x), runs=10)}


def _sp_rank(rank, world, backend, init, outdir):
    """One rank of the train_sp world, on cuda:0: SP_STEPS bf16 steps of
    the full-width binaural net with its query rows split over the model
    axis, the float32 gradient check and the sharded STFT, then
    rank<r>.json in `outdir`."""
    import torch
    import numpy as np

    from audiodepth_tpu_torch import configs, models
    from audiodepth_tpu_torch._device import configure_precision
    from audiodepth_tpu_torch.data.batvision import make_dataset
    from audiodepth_tpu_torch.ops.cuda import KERNELS
    from audiodepth_tpu_torch.parallel import initialize_multihost, make_mesh_group, shutdown
    from audiodepth_tpu_torch.train import engine as engine_mod

    configure_precision()
    initialize_multihost(init, world, rank, backend=backend, device=DP_DEVICE)
    out = {"rank": rank, "world": world, "backend": backend}
    try:
        mesh = make_mesh_group(1, world)
        model = "binaural_attention"
        cfg = _dp_cfg(configs, model, "bfloat16", SP_GLOBAL_BATCH)
        batches = list(make_dataset(cfg, "train", num_samples=SP_GLOBAL_BATCH).batches(
            SP_GLOBAL_BATCH, shuffle=False))
        row, params = _dp_bf16_steps(torch, np, configs, models, KERNELS, model, mesh,
                                     SP_STEPS, batches, SP_GLOBAL_BATCH, sp_axis="model")
        del params
        torch.cuda.empty_cache()
        # what the deterministic mode costs: the same steps without it (the
        # ranks' states then part by a rounding a step; only timed)
        scoped = engine_mod.deterministic_kernels
        engine_mod.deterministic_kernels = lambda on=True: contextlib.nullcontext()
        try:
            off, params = _dp_bf16_steps(torch, np, configs, models, KERNELS, model, mesh,
                                         SP_STEPS, batches, SP_GLOBAL_BATCH, sp_axis="model")
        finally:
            engine_mod.deterministic_kernels = scoped
        del params
        torch.cuda.empty_cache()
        assert not torch.are_deterministic_algorithms_enabled()  # scoped to the steps
        row["nondeterministic"] = {"losses": off["losses"], "step_ms": off["step_ms"]}
        row["f32"] = _dp_f32_check(torch, np, configs, models, model, mesh)
        row["stft"] = _sp_stft_check(torch, np, configs, mesh)
        out[model] = row
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def phase_train_sp(torch, np, kernels, smi):
    """Sequence parallelism on the one card (module note). Returns the
    launches of each rank's path for the kernels line."""
    t0 = time.perf_counter()
    ranks = _dp_world(2, "gloo", _sp_rank, SP_WORLD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    rows = [r["binaural_attention"] for r in ranks]
    # the mesh's data group keeps BatchNorm's own code
    per_step = {k: v * SP_STEPS for k, v in dict(PER_TRAIN_STEP, **NO_BN, **NO_SB).items()}
    want_shapes = sorted((b2, n // 2, n) for b2, n, _ in _sp_levels())
    # every query-row shape of the phase is held to its plain version
    held = {(n, m, dk, dv) for _, _, n, m, dk, dv, dtype in B2_SHAPES if dtype == "bfloat16"}
    for _, n, c in _sp_levels():
        assert (n // 2, n, c // 8, c) in held, (n, c)
    launches = {}
    for rank, r in enumerate(rows):
        assert all(np.isfinite(r["losses"])), (rank, r["losses"])
        assert r["losses"][-1] < r["losses"][0], (rank, r["losses"])
        assert not r["unmoved"], (rank, r["unmoved"][:8])
        assert r["launches"] == per_step, (rank, r["launches"], per_step)
        for kind in ("fwd", "bwd"):  # half the query rows against all keys
            got = sorted(tuple(s) for s in r["attention_shapes"][kind])
            assert got == want_shapes, (rank, kind, got, want_shapes)
        assert r["collectives"] == sp_collectives_want(2), (rank, r["collectives"])
        assert r["stft"]["rel_err"] <= SP_STFT_TOL, r["stft"]
        launches[f"train_sp gloo rank {rank} of 2 binaural_attention"] = (r["launches"],
                                                                          r["by_variant"])
    # one replicated state: both ranks' parameters and buffers bit-equal
    # after every step, and one loss
    assert rows[0]["digests"] == rows[1]["digests"]
    assert rows[0]["losses"] == rows[1]["losses"]
    assert rows[0]["f32"] is not None and rows[1]["f32"] is None
    emit({"phase": "train_sp", "world": "2 gloo ranks time-sharing one card, layout 1 x 2",
          "model": "binaural_attention", "card": smi, "global_batch": SP_GLOBAL_BATCH,
          "rows_per_rank": SP_GLOBAL_BATCH, "steps": SP_STEPS, "losses": rows[0]["losses"],
          "step_ms": {f"rank {i}": r["step_ms"] for i, r in enumerate(rows)},
          "step_ms_deterministic_mode_off": {f"rank {i}": r["nondeterministic"]["step_ms"]
                                             for i, r in enumerate(rows)},
          "losses_deterministic_mode_off": rows[0]["nondeterministic"]["losses"],
          "note": "two processes time-sharing one card, collectives staged through host "
                  "memory: not a scaling measurement",
          "launches_per_rank": rows[0]["launches"],
          "attention_shapes_2B_Nq_Nk": rows[0]["attention_shapes"],
          "collectives_per_rank_step": rows[0]["collectives"], "f32": rows[0]["f32"],
          "sharded_stft": rows[0]["stft"],
          "state_digest_after_each_step": rows[0]["digests"], "world_s": world_s})
    return launches


def kernel_entry(wrapper, source, replaces, rows, main_row, launches, peak_name, ptxas, sass):
    """One entry of the `kernels` line: numbers at the kernel's main shape,
    the largest error over all its shapes, launches summed over the paths
    (and by plan variant), ptxas's registers and spills of each of its
    instantiations, and their HGMMA and HMMA counts in the SASS."""
    mine = [r for r in rows if r["name"] == wrapper.name]
    prefix = PTXAS_PREFIX[wrapper.name]
    by_function = {k: v for k, v in sass.items() if k.startswith(prefix)}
    entry = {
        "name": wrapper.name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(counts[wrapper.name] for counts, _ in launches.values()),
        "launches_by_path": {p: counts[wrapper.name] for p, (counts, _) in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library", "main_shape") + tuple(main_row.get("extra", ()))},
        "peak": peak_name,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(prefix)},
        "sass": {op: sum(v[op] for v in by_function.values()) for op in ("HGMMA", "HMMA")}}
    entry["sass"]["by_function"] = by_function
    if hasattr(wrapper, "variant_launches"):
        entry["launches_by_variant"] = {p: by_variant[wrapper.name]
                                        for p, (_, by_variant) in launches.items()}
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from audiodepth_tpu_torch import configs, models
    from audiodepth_tpu_torch._device import configure_precision
    from audiodepth_tpu_torch.cli import evaluate as evaluate_cli
    from audiodepth_tpu_torch.cli import serve
    from audiodepth_tpu_torch.cli import train as train_cli
    from audiodepth_tpu_torch.ops.attention import blockwise_cross_attention
    from audiodepth_tpu_torch.ops.cuda import KERNELS, _build
    from audiodepth_tpu_torch.ops.cuda import batch_norm as bn
    from audiodepth_tpu_torch.ops.cuda import flash_attention as fa
    from audiodepth_tpu_torch.ops.cuda import fused_frontend as ff
    from audiodepth_tpu_torch.ops.cuda import soft_binning as sb

    configure_precision()
    smi, ex2_rate = phase_env(torch)
    peak_name, peak = peak_for(torch.cuda.get_device_name(0))
    ptxas, sass = phase_build(_build)
    b1_rows = phase_kernel(torch, np, ff, peak, configs)
    phase_layout_probe(torch, fa)
    b2_rows = phase_kernel_b2(torch, np, fa, peak, ex2_rate)
    b3_rows = phase_kernel_b3(torch, fa, peak, ex2_rate)
    phase_autograd(torch, fa, blockwise_cross_attention)
    bn_rows = phase_kernel_bn(torch, bn, peak)
    sb_rows = phase_kernel_sb(torch, sb, peak)
    launches = {f"serve {path}": phase_serve(torch, np, serve, KERNELS, path)
                for path in SERVE_PATHS}
    for path in SERVE_PATHS:
        phase_f32_vs_cpu(torch, np, configs, models, path)
    # the checkpoints examples_compare reads, kept to the end of the run
    compare_root = tempfile.mkdtemp(prefix="chip_smoke_compare_")
    atexit.register(shutil.rmtree, compare_root, ignore_errors=True)
    launches["train binaural_attention"] = phase_train(torch, np, train_cli, KERNELS,
                                                       compare_root)
    binaural_dir = experiment_dir(train_cli, TRAIN_ARGV, compare_root)
    phase_f32_train_vs_cpu(torch, np, configs, models, "binaural_attention")
    launches["train binaural_attention float32"] = phase_train_f32(torch, np, train_cli, KERNELS)
    torch.cuda.empty_cache()
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        eng, state, launches["train unet_baseline"] = phase_train_unet(
            torch, np, train_cli, KERNELS, ckpt_root)
        launches["serve unet_baseline from its checkpoint"] = phase_ckpt_round_trip(
            torch, np, serve, train_cli, KERNELS, eng, ckpt_root)
        phase_unet_steps(torch, np, eng, state)
        del eng, state
        unet_dir = shutil.move(experiment_dir(train_cli, UNET_TRAIN_ARGV, ckpt_root),
                               compare_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_f32_train_vs_cpu(torch, np, configs, models, "unet_baseline")
    for base in WIDTH_BASES:
        launches[f"train binaural_attention base {base}"] = phase_train_widths(
            torch, np, train_cli, KERNELS, base)
    families_root = tempfile.mkdtemp(prefix="chip_smoke_families_")
    export_work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        coarse_jobs = []
        try:
            for family in FAMILIES:
                launches.update(phase_train_family(torch, np, train_cli, serve, KERNELS, family,
                                                   families_root, (export_work, coarse_jobs)))
            coarse_dir = shutil.move(experiment_dir(train_cli, _family_argv("coarse_depth/hybrid"),
                                                    families_root), compare_root)
        finally:
            shutil.rmtree(families_root, ignore_errors=True)
        phase_f32_train_vs_cpu(torch, np, configs, models, "adabins_distillation")
        phase_f32_train_vs_cpu(torch, np, configs, models, "coarse_depth/hybrid")
        assert len(coarse_jobs) == 1, coarse_jobs
        launches.update(phase_export(torch, np, serve, export_work, coarse_jobs))
    finally:
        shutil.rmtree(export_work, ignore_errors=True)
    torch.cuda.empty_cache()
    launches.update(phase_profile_step(torch, KERNELS))
    phase_trace_probe(torch, np, ff, fa)
    launches["train unet_baseline --profile_dir"] = phase_profile_dir(torch, train_cli, KERNELS)
    launches["train adabins_distillation remat"] = phase_adabins_remat(torch, np, configs, models,
                                                                      KERNELS)
    phase_verify_contracts(torch)
    launches.update(phase_train_dp(torch, np, train_cli, KERNELS, smi))
    launches.update(phase_train_sp(torch, np, KERNELS, smi))
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        root = os.path.join(work, "BatvisionV2")
        phase_corpus(torch, np, configs, root, smi)
        runs = phase_train_corpus(torch, np, configs, train_cli, KERNELS, root, work)
        launches["train unet_baseline corpus"] = runs["streamed"]["launches"]
        launches["train unet_baseline corpus --device_cache"] = runs["cached"]["launches"]
        launches["evaluate unet_baseline"] = phase_evaluate(
            torch, np, evaluate_cli, KERNELS, root, work, runs["streamed"])
        del runs
        torch.cuda.empty_cache()
        phase_corpus_images(torch, np, configs, root)
        for family, flags in (("rgb_depth", ()), ("adabins_distillation", ()),
                              ("unet_baseline", ("--eval_img",))):
            name = f"train {family} {' '.join(flags) + ' ' if flags else ''}corpus"
            eng_i, state_i, launches[name] = phase_train_corpus_images(
                torch, np, train_cli, KERNELS, root, work, family, flags)
            if flags:
                launches["evaluate unet_baseline --eval_img"] = phase_evaluate_eval_img(
                    torch, np, evaluate_cli, KERNELS, root, work, eng_i)
            del eng_i, state_i
            torch.cuda.empty_cache()
        launches.update(phase_sparse_corpus(torch, np, configs, train_cli, evaluate_cli,
                                            KERNELS, root, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    seconds = {}
    t0 = time.perf_counter()
    entries = _compare_entries(compare_root, unet_dir, binaural_dir, coarse_dir)
    launches["examples compare_checkpoints"] = phase_examples_compare(
        torch, np, evaluate_cli, KERNELS, compare_root, entries)
    seconds["examples_compare"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["examples synthetic_convergence"] = phase_examples_convergence(torch, np, KERNELS)
    seconds["examples_convergence"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(phase_examples_sweep(torch, np, KERNELS))
    seconds["examples_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(phase_examples_step_bench(torch, KERNELS, smi))
    seconds["examples_step_bench"] = time.perf_counter() - t0
    emit({"phase": "examples_seconds", **seconds})

    b1 = next(r for r in b1_rows if (r["input"], r["bc"], r["L"]) == B1_MAIN)
    b1_main = dict(b1, main_shape="B*C=32, L=7782, noise", ms=b1["us"] / 1e3,
                   plain_ms=b1["plain_us"] / 1e3, bound_ms=b1["bound_us"] / 1e3,
                   bound_fp32_ms=b1["bound_fp32_us"] / 1e3,
                   # no single PyTorch call computes the fused STFT→mel→log→min-max
                   library_ms=None, library=None,
                   us_by_bc={r["bc"]: r["us"] for r in b1_rows if r["input"] == "noise"
                             and r["L"] == 7782},
                   extra=("bound_fp32_ms", "plan", "us_by_bc"))
    level2 = "level 2: 2B=32, N=M=16384, dk=16, dv=128, bf16"
    f32_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_term", "bound_terms_ms",
                "library_ms", "library", "plan")
    mains = {}
    for name, rows in (("B2", b2_rows), ("B3", b3_rows)):
        f32 = next(r for r in rows if r["shape"] == B2_F32_MAIN)
        mains[name] = dict(next(r for r in rows if r["shape"] == B2_MAIN), main_shape=level2,
                           float32={"shape": B2_F32_MAIN, **{k: f32[k] for k in f32_keys}},
                           extra=("float32",))
    b2_main, b3_main = mains["B2"], mains["B3"]
    main_rows = {ff.fused_mel_frontend.name: (b1_rows, b1_main),
                 fa.flash_cross_attention.name: (b2_rows, b2_main),
                 fa.flash_cross_attention_bwd.name: (b3_rows, b3_main)}
    for w, way in ((bn.batch_norm_train_fwd, "fwd"), (bn.batch_norm_train_bwd, "bwd")):
        rows = [dict(r, name=w.name, ms=r[f"{way}_ms"], plain_ms=r[f"plain_{way}_ms"],
                     library_ms=r[f"library_{way}_ms"], bound_ms=r[f"bound_{way}_ms"])
                for r in bn_rows]
        main = next(r for r in rows if r["main"] == "UNet")
        main_rows[w.name] = (rows, dict(
            main, main_shape="[256, 64, 128, 128] bf16 channels-last (the UNet's largest; the "
            "binaural net's [64, 64, 256, 256] has as many rows)",
            ms_by_shape={f"{r['shape']} relu={r['relu']}": r["ms"] for r in rows},
            pair_bound_share={r["main"]: r["bound_share"] for r in rows if r["main"]},
            extra=("ms_by_shape", "pair_bound_share")))
    for w, way in ((sb.soft_binning_fwd, "fwd"), (sb.soft_binning_bwd, "bwd")):
        rows = [dict(r, name=w.name, ms=r[f"{way}_ms"], plain_ms=r[f"plain_{way}_ms"],
                     library_ms=r[f"library_{way}_ms"], bound_ms=r[f"bound_{way}_ms"],
                     bound_share=r[f"bound_share_{way}"]) for r in sb_rows]
        main = next(r for r in rows if r["main"])
        main_rows[w.name] = (rows, dict(
            main, main_shape="[64, 128, 256, 256] bf16 channels-last (the AdaBins cell's "
            "class-head logits)", extra=("bound_share", "memory_added_bytes")))
    kernels = [kernel_entry(w, src, rep, *main_rows[w.name], launches, peak_name, ptxas, sass)
               for w, src, rep in KERNELS]
    for entry in kernels:  # the tensor-core designs must be in the binary
        if entry["name"] in (bn.batch_norm_train_fwd.name, bn.batch_norm_train_bwd.name,
                             sb.soft_binning_fwd.name, sb.soft_binning_bwd.name):
            continue  # bound by bytes: no tensor-core instruction
        op = "HMMA" if entry["name"] == ff.fused_mel_frontend.name else "HGMMA"
        assert entry["sass"][op] > 0, f"{entry['name']}: no {op} in its SASS"
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
