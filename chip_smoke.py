#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (sr3_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its own line and its seconds; any failure exits 1.
The SR3 16->128 paths (configs/sr_sr3_16_128.json):
  1. device: name and power limit from nvidia-smi, torch and CUDA versions;
     TF32 off for the float32 phases;
  2. build: compile sr3_tpu_torch/csrc with nvcc (one process per source);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at every shape the SR3 16->128 sampling path gives it (batch
     2), in float32 and bfloat16 (each kernel's route by dtype: KERNELS),
     error relative to max|plain| (TOL); K1 also at every shape of the
     64->512 UNet (batch 2; both shape lists checked against the models'
     Blocks), at two of its serving-batch shapes, at one shape of every
     bf16 class of the conv launch (K1_CLASS_CASES) and at K1_TIMED, each
     bf16 check labelled with the class it launched; then "K1 classes":
     every class of conv_fused.BF16_TILES was checked; K2 at every site of both UNets
     (K2_SITES, K2_SITES_512, checked against the models) at every batch
     the paths run it at (k2_batches), each check labelled with the cluster
     size it launched, a ragged map and a slice too large for a cluster's
     shared memory; K4 (each bf16 check labelled with the head_dim class
     it launched, and the merge of a key split), its logsumexp and
     the backward
     kernels K5 / K6 at the training shapes, a ragged one and a ragged
     split (each bf16 check labelled with the K5 / K6 classes it launched
     and the merge of a split); the autograd
     Functions of K1, K2 and K4 against autograd of their plain versions,
     every input gradient; the GroupNorm(+SiLU) backward kernel
     (gn_silu_bwd, and gn_silu_act, its mode that recomputes K1's
     activation) against gn_silu_bwd_plain / gn_silu_act_plain at the
     training paths' shapes (GN_BWD_CASES); then the GroupNorm launches: device kernels per
     call from torch.profiler (K2: 1; K1: 2, its statistics and its conv),
     two calls on the same input bit-identical, K1's ticket counters back
     at 0, and the C library's plan (cluster size, channel block,
     residency) printed for every K2 site; then "K4 classes": every bf16
     K4 class and the merge checked, and "K5/K6 classes": every bf16 K5
     and K6 class and their merge checked;
  4. full-width model: the 97.8M-parameter SR3 16->128 UNet (random seeded
     weights), one float32 forward on the card (kernels) against the same
     weights on the CPU (plain versions), and the bf16 sampling copy of the
     serving trainer against the same CPU forward;
  5. serving path: GroupedEvaluator.run_sr (what infer_sr runs) in bf16,
     group of 2, T=10 val schedule (the -debug shrink), seeded 16->128
     inputs; launch counters are zeroed just before and every forward
     kernel must have launched; frames must be finite and 1 + n_snap per
     image;
  6. timing (printed, not gated): ms per UNet step of the T=2000 chain at
     batch 8 in bf16 and the 2000-step images/s extrapolated from it, and a
     torch.profiler window over two steps (device launches per step); ms
     per call of K1, K2 and K4 against their plain versions;
  7. training path: the train-phase Trainer (batch 4, bf16 compute, float32
     parameters, dropout 0.2, Adam 1e-4) through train_loop for TRAIN_STEPS
     steps on seeded synthetic (HR, SR) batches; counters zeroed just
     before, and K1, K2, K4, K5, K6 and the GroupNorm backward must all have
     launched, the backward once a K1, K2 or statistics-route call a step
     and its activation mode once a K1 call (gn_bwd_sites); every loss
     finite, every parameter with a finite gradient, every parameter moved;
     then get_current_log has l_pix, step_time_ms and imgs_per_sec, all
     finite and positive (the JAX trainer's keys);
  8. training gradients: one float32 batch-1 loss and backward of the
     full-width UNet with injected noise, sqrt-gamma and the same dropout
     draws, kernels against the plain ops swapped into the UNet module;
     loss and every parameter's gradient within GRAD_TOL;
  9. training timing: ms per train step at batch 4 (median of TIME_STEPS)
     and train images/s; K4 with its logsumexp, K5 and K6 against the plain
     versions.
The SR3 64->512 training path (configs/sr_sr3_64_512_attn.json, remat on):
 10. K3 statistics: K3 against float64 sums and gn_stats_plain (K3_TOL) at
     the path's 512^2 and 256^2 maps and a ragged one, float32 and bf16; the
     statistics route of group_norm against group_norm_plain, forward and
     input gradients;
 11. long-sequence attention: K4 with its logsumexp, K5 and K6 against the
     plain versions at 4096 and 1024 tokens (head_dim 512; batch*heads 2
     and 8), at 16384 tokens (head_dim 256) and at the 16->128 train
     step's 256 and 64 tokens at batch 4 and 16 (LONG_SHAPES); the bf16 K4
     autograd Function at 4096 and 16384 tokens; then "K4 classes" and
     "K5/K6 classes": every bf16 class launched since phase 3 was checked;
 12. 64->512 training path: the full-width train-phase Trainer (70.0M
     parameters, batch 2, bf16, dropout 0.2, remat) through train_loop for
     TRAIN_STEPS_512 steps; counters zeroed just before; K1-K6 and the
     GroupNorm backward launched, K3 and K4-K6 exactly as often as the
     model's sites say (twice per forward with remat), the GroupNorm
     backward as phase 7 says; finite losses, every parameter with a finite
     gradient that moved;
 13. 64->512 training gradients: float32 batch 1, kernels against the plain
     ops (GRAD_TOL), and remat on against remat off (REMAT_TOL);
 14. 64->512 bf16 attention gradients: bf16 batch 1, the loss and every
     attention parameter's gradient with K4-K6 against attention_plain
     swapped into the same model (FORWARD_TOL_BF16);
 15. 64->512 training timing: median train step (CUDA events), train
     images/s, peak memory, and a torch.profiler window (device time by op,
     device busy share);
 16. 64->512 serving path: GroupedEvaluator.run_sr on 2 images, T=10, 512^2
     bf16, frames finite, K1, K2 and K4 launched; median ms of a batch-8
     p_sample_step at 512^2 (the config's val batch) and a torch.profiler
     window over it (device time by op, device busy share);
 17. 64->512 kernel timing: each kernel at the path's shapes (bf16, batch
     2; K4-K6 also at 16384 tokens) beside its plain version and the one
     PyTorch call that computes the same function where there is one
     (library_ms; the port never calls it), each as CUDA-event ms per call
     and as device ms per call (20 calls queued behind a spin kernel, CUDA
     events around them), the kernel's split by launch from the profiler
     where it kept records; and the least time the card
     could take (bound_ms: the larger of bytes over 3.35 TB/s and operations
     over 989 TFLOP/s). Beside K1, cuDNN's conv3x3 alone at its shape (not
     the same function, so not library_ms); K2 also at the 16->128 training
     site 4x64x128^2 with SiLU and the 64->512 serving site 8x512x64^2; the
     GroupNorm backward at the benchmark's training maps, 128x192x128^2
     (K1's, statistics given) and 128x64x128^2 (K2's, its own statistics
     pass) at 16->128 and 16x64x512^2 (the statistics route) at 64->512,
     its bound 6 bytes an element (x, dy, dx in bf16), and its activation
     mode at K1's two maps there (4 bytes an element). The JSON line
     carries the first shape of each. Then "K4 classes": every
     bf16 K4 class launched since phase 11 was checked.
The rest of the sampling surface (phases 18 and 19 run right after phase
6, on its serving trainer; phase 3 also checks K1 and K2 at every site of
the three models below, checked against their Blocks, K1 of the six-level
model at batches 2, 4 and 8, and K4-K6 at (b, 256, 128) and (b, 16, 256)):
 18. strided chains: DDIM-50, DPM++-25 and the SDE DPM++-25 from the
     T=2000 schedule through GroupedEvaluator.run_sr at batch 8, bf16;
     counters zeroed before each; UNet forwards equal to the steps, finite
     outputs; ms of a whole chain (median of 3), images/s, device ops per
     UNet forward;
 19. -p val: evaluate_sr on 2 seeded images at T=10, writing its PNGs
     through Metrics.save_img (the port's PNG codec: the card's machine has
     neither cv2 nor Pillow); every file asked for at its shape and read
     back equal to the array written, PSNR and SSIM equal to those of the
     arrays and to what python -m sr3_tpu_torch.eval -p <that dir> reads
     from the files (in-process), every forward kernel launched;
 20. ddpm 16->128 (configs/sr_ddpm_16_128.json): float32 forward on the
     card against the CPU at t = 1999 (FORWARD_TOL); run_sr of 2 images,
     bf16, T=10; NEW_TRAIN_STEPS train steps at batch 4 through train_loop
     (K1, K2, K4-K6 launched, finite losses, every parameter moved);
 21. unconditional 128^2 (configs/sample_sr3_128.json and the six-level
     configs/sample_ddpm_128.json): float32 forward against the CPU;
     run_uncond of 2 samples, bf16, T=10, every forward kernel launched;
     for sample_ddpm_128 NEW_TRAIN_STEPS train steps and the median ms of a
     batch-8 UNet step with a torch.profiler window (device ops per step);
 22. sample_ddpm_128 kernel timing: K5 and K6 at (8, 256, 128) and
     (8, 16, 256) checked against the plain version, then K4-K6 there and
     K1 at 8x512x4^2->256 timed, each beside its plain version, SDPA (or
     cuDNN's conv alone) and its bound; then "K5/K6 classes": every bf16
     K5 / K6 class launched since phase 11 was checked (and at the end of
     the run, every one since phase 22).
The SR3 128->1024 cascade stage (configs/sr_sr3_128_1024.json: 91.6M
parameters, six levels, attention at 32x32, remat, dropout 0.2; phase 3
also checks K1 at every site of its UNet at batches 2 and 8, K2 at its
sites, K3 at its statistics-route maps (phase 10, with one 8x128x1024^2
map) and K4-K6 at (2 | 8, 1024, 512) (phase 11)), the cascade, the bf16
Adam first moment and the device-resident dataset:
 23. 128->1024 model: its float32 forward, batch 1 at 1024^2, on the card
     against the same weights on the CPU (FORWARD_TOL); peak memory;
 24. 128->1024 serving: GroupedEvaluator.run_sr of the config's val batch
     of 8 images, bf16, T=10, every forward kernel launched, finite
     outputs; the median ms of a batch-8 1024^2 UNet step of the T=2000
     chain and a torch.profiler window; peak memory of each;
 25. 128->1024 training: TRAIN_STEPS_1024 bf16 remat train steps at the
     config's batch 2 through train_loop, K1-K6 launched, K3 and K4-K6
     exactly as often as the model's sites say; the median train step and
     a torch.profiler window; peak memory;
 26. cascade: run_cascade (what python -m sr3_tpu_torch.cascade runs) of
     configs/sample_sr3_128.json then configs/sr_sr3_128_1024.json, bf16,
     T=10 each, 2 samples, random weights, no PNGs: shapes, finite
     outputs, stage 2's conditioning equal to the bicubic resize of stage
     1's outputs; each stage's wall time;
 27. bf16 Adam first moment: 16->128 training at batch 4 with
     train.optimizer.mu_dtype "bfloat16" through train_loop, every exp_avg
     bfloat16, the optimizer state's bytes against the float32 run's;
 28. device-resident dataset: 16->128 training at batch 4 on a resident
     synthetic uint8 set of RESIDENT_PAIRS pairs, datasets.train.device_data
     with RESIDENT_K steps a call through train_loop: finite losses, every
     parameter moved, the resident bytes; the resident step against the
     host-loader step, both timed in this run (printed, not gated);
 29. 128->1024 kernel timing: K1 at 8x64x1024^2->64 and 8x128x1024^2->64,
     K3 at 2x64x1024^2, K4-K6 at (2 | 8, 1024, 512) and at the 16->128
     serving attention (8, 256 | 64, 512), as phase 17.
The last drivers and configs (after phase 29):
 39. 64->512 attention-free (configs/sr_sr3_64_512.json: 63.7M parameters,
     attention only in the mid block, one res block, 16 groups, remat,
     dropout 0.2): its K1 sites those of phase 3's 64->512 list, its K2 and
     K3 sites among phases 3's and 10's; the float32 batch-1 forward
     against the CPU (FORWARD_TOL); TRAIN_STEPS_512 bf16 remat train steps
     at batch 2 through train_loop (K3 and K4-K6 as often as its sites
     say; K2's launches printed); run_sr of 2 images at T=10; the median
     ms of a batch-8 512^2 p_sample_step, its busy share, peak memory and
     MFU from the counted FLOPs (utils/flops.py);
 40. sampler tool: python -m sr3_tpu_torch.sampler_eval (in-process) on a
     random-weight .pth of the 16->128 model saved in the phase, two
     fixture images, T=20, ddpm:20 ddpm:20 ddim:5, 2 reps: finite score
     grids, the repeated sampler's scores equal to the first's and its
     deltas exactly 0, every forward kernel launched;
 41. bench: python -m sr3_tpu_torch.bench in a subprocess at
     BENCH_STEPS=200: the five lines in order, finite positive values,
     0 < mfu <= 1 on the train and headline lines, the card's name on each;
 42. ADM 128->512 (portbench/configs/adm_128_512.json, guided-diffusion's
     upsampler at its published widths, bf16; runs after phase 17): one
     batch-8 forward, counters zeroed just before it: K1 once at each site
     of the benchmark reference's list (portbench/reference/adm.py
     k1_sites: ADM_K1_SITES calls, ADM_SCALE_SHIFT_SITES of them with the
     scale-shift after the norm, every one counted by block.scale_shift),
     a finite (8, 6, 512, 512) output; then K1's scale-shift route and its
     wide statistics launch timed at K1_ADM as phase 17 (ms, plain_ms,
     bound_ms; cuDNN's bare conv3x3 on the same map and weight as
     library_ms, a yardstick the port never calls; the class launched).
     Then "K1 class timing": K1 timed so at K1_TIMED, the SR3 serving
     cells' class shapes. Phase 3 checks K1 at K1_ADM against its plain version in
     float32 and bf16 (the float32 512^2 case at batch 2), and K2 at
     K2_SITES_ADM at batch 8, each list checked against the reference.
Every timed UNet step, train step and strided chain (phases 6, 9, 15,
16, 18, 21, 24, 25, 39) also prints its MFU: the FLOPs utils/flops.py
counts for it over its median ms, against 989 TFLOP/s.
After phase 41 the bf16 K1 classes, and K2's (dtype, cluster size,
residency), launched since phase 3 (the main paths and the timing) must
all be ones that phase 3 checked ("K1 classes" also needs every class of
conv_fused.BF16_TILES checked), and the bf16 K4 classes launched since
phase 17 ones that phases 3 and 11 checked.
The JAX package's host modules in the port (phase 35 runs right after
phase 5, as early as it can: late in a long process the profiler has kept
no record of whole windows; phase 38 right after phase 19, on its files;
36 and 37 after phase 9):
 35. profiler trace: utils/profiler.trace around two bf16 batch-8 serving
     steps writes one TensorBoard trace file whose device kernels include
     K1's conv (gn_silu_conv3x3_*) and K4 (flash_fwd_*);
 36. host data pipeline: the 16->128 trainer at batch 4. float32 on the
     committed fixture PNGs (dataset/fixtures_16_128, decoded by the
     port's codec): 3 steps fed host arrays and the same 3 steps through
     train_loop's device_prefetch (pinned on its own thread, a side
     stream), same seeds, deterministic cuDNN: bit-equal losses. The
     codec's decode ms an image, filter 0 and Paeth rows at 128^2 and
     1024^2 and the fixture's files. bf16 on 2048 seeded pairs of PNGs
     written here (Paeth rows, the RAM cache off, so every batch decodes):
     the synthetic batches and the files with 0 and 8 workers, each fed
     host arrays and through device_prefetch, in alternating rounds of
     windows of 25 steps: ms a step, the launching thread's CPU ms a
     step, per-round differences and device busy share (printed, not
     gated); train_loop from the files with 8
     workers must launch K1, K2, K4-K6; the training log's keys;
 37. LMDB: the port's fake_lmdb as lmdb; prepare over the fixture's HR
     images into PNG directories and into an LMDB; the LMDB dataset's val
     items bit-equal to the directories'; 2 bf16 train steps from the LMDB
     dataset through train_loop (finite losses, every parameter moved,
     K1, K2, K4-K6 launched);
 38. FID: RandomFeatureExtractor(seed 0, width 192) on 256 seeded 128^2
     images on the card, float32, within 1e-5 of max|f| of the CPU's;
     images/s at batch 64; python -m sr3_tpu_torch.fid_eval -p <phase 19's
     dir> (in-process) prints a finite proxy-FID; --extractor inception
     raises the ImportError naming torchvision.
The parallel paths (sr3_tpu_torch/parallel), two ranks started through
``torch.distributed.run --standalone``, each running ``chip_smoke.py
--rank DIR BACKEND``: nccl with one card a rank where the machine has two or more,
else gloo with both ranks on the one card (printed); every kernel runs on
the card either way; the ranks' output is printed after them:
 30. collectives: all_reduce (SUM, MAX) and all_gather of float32,
     bfloat16 and int64 CUDA tensors, each result checked;
 31. data = 2: sr_sr3_16_128 at full width, global batch 4 (2 a rank),
     bf16, PAR_STEPS train steps, counters zeroed just before (K1, K2,
     K4-K6 launched); the parameters' checksum after each step equal on
     both ranks; ms a step and the all-reduced bytes; PAR_STEPS float32
     steps with injected global draws (noise, sqrt-gamma, dropout masks):
     every step's loss within 1e-4 of one process's (run here after the
     ranks), and the first step's all-reduced gradients within 1e-4 of
     each leaf's max|g| of one process's;
 32. model = 2: sr_sr3_16_128, the float32 forward of the sharded UNet
     against the unsharded one on the same rank (1e-4); one bf16 train
     step with EMA (K1, K2, K4-K6 launched); parameter + Adam + EMA bytes a
     rank against one device's;
 33. space = 2: sr_sr3_64_512_attn, the batch-8 bf16 512^2 forward (2e-2)
     and a batch-1 float32 one (1e-4) against the same module unsharded,
     run first on the same rank; the loss and gradients of a batch-2 remat
     step, float32 (1e-3) and bf16 (5e-2), against unsharded (the same
     draws: every space rank draws the whole map's); K1's halo entry, K3
     and K4-K6 launched; then the batch-8 1024^2 step of sr_sr3_128_1024;
     peak memory a rank beside the unsharded run's; every K1 halo-entry
     site of these runs held against its plain version, and every bf16
     tile they launched among those checked;
 34. K1 halo entry timing: at a 512^2 serving shard (8x64x256x512->64)
     beside its plain version and beside K1's own entry at that shape.

Then one JSON line with every kernel's route, source, the TPU kernel it
replaces, launches in phase 12 (K1's halo entry: in phase 33's 512^2
forward; and on the other paths: launches_* keys, each path's counters
zeroed just before it; the parallel paths from rank 0; phase 36's 8-worker
run and phase 37's steps as launches_16_128_train_files / _lmdb), max error
and times
(timings_sample_ddpm_128: phase 22; timings_128_1024: phase 29;
timings_adm_128_512: phase 42; timings_k1_classes: "K1 class
timing"), and
last the line {"ok": true,
"device": {...}}. Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "sr_sr3_16_128.json")
BATCH_CHECK = 2
BATCH_TIME = 8
TRAIN_STEPS = 6
TIME_STEPS = 12
# bf16: K4's o, K5's dk, dv and K6's dq round P (K4), dO, P, dS (K5) and
# dO, dS (K6) to bf16 before their products on the tensor-core routes
# (attention.cu, attention_bwd.cu headers), where the plain versions keep
# them in float32; K4's logsumexp ("flash_attention_lse") computes in
# float32 from the same inputs as the plain version; the autograd
# Functions: each side rounds its input gradients to bf16 once
TOL = {"float32": {"gn_silu_conv3x3": 1e-4, "group_norm": 1e-5,
                   "flash_attention_fwd": 1e-4, "flash_attention_lse": 1e-4,
                   "flash_attention_bwd_dkv": 1e-4,
                   "flash_attention_bwd_dq": 1e-4, "function": 1e-4,
                   "gn_silu_bwd": 1e-4, "gn_silu_act": 1e-5},
       "bfloat16": {"gn_silu_conv3x3": 2e-2, "group_norm": 2e-2,
                    "flash_attention_fwd": 2e-2, "flash_attention_lse": 1e-4,
                    "flash_attention_bwd_dkv": 2e-2,
                    "flash_attention_bwd_dq": 2e-2, "function": 2e-2,
                    "gn_silu_bwd": 8e-3, "gn_silu_act": 8e-3}}
# The GroupNorm(+SiLU) backward's dx and its activation mode's act in bf16:
# both sides compute in float32 from the same bf16 inputs and round once,
# so they differ by at most one bf16 step (2^-7 of an element, at most
# 7.8e-3 of max|plain|); its float32 dgamma, dbeta and pre-affine gradients
# (sums in another order) within GN_BWD_PARAM_TOL of their max|plain|
GN_BWD_PARAM_TOL = 1e-4
# float32 loss and gradients of the full-width UNet, kernels vs plain ops
GRAD_TOL = 1e-3
FORWARD_TOL = 1e-3
# bf16 activations and weights (2^-9 relative rounding per op) through ~30
# layers; measured ~1.2e-2 of max|out| on an H100
FORWARD_TOL_BF16 = 5e-2

# (Cin, Cout, H=W) of every K1 call of the 16->128 UNet, in the order of
# the forward; phase 3 checks the list against the model's Blocks (k1_sites)
K1_SHAPES = [
    (64, 64, 128), (64, 128, 64), (128, 128, 64), (128, 256, 32),
    (256, 256, 32), (256, 512, 16), (512, 512, 16), (512, 512, 8),
    (1024, 512, 8), (1024, 512, 16), (768, 512, 16), (768, 256, 32),
    (512, 256, 32), (384, 256, 32), (384, 128, 64), (256, 128, 64),
    (192, 128, 64), (192, 64, 128), (128, 64, 128), (64, 3, 128),
]
# (C, H=W, swish) of the K2 calls of a 16->128 training forward: the
# dropout Blocks (GroupNorm+SiLU; maps of 256^2 and more take the statistics
# route instead) and the attention pre-norms; phase 3 checks the list
# against the model (k2_sites) and runs it at every batch of k2_batches
K2_SITES = [(64, 128, True), (128, 64, True), (256, 32, True),
            (512, 16, True), (512, 8, True), (512, 16, False),
            (512, 8, False)]
K2_SERVING = [(512, 16), (512, 8)]         # (C, H=W), swish off, timed
# (B, C, H, W, G, swish): a ragged map, and a slice larger than a 16-block
# cluster's shared memory (128 channels a group at 128^2), which the
# kernel normalizes from a second read of x
K2_EXTRA = [(2, 96, 10, 10, 32, True), (1, 256, 128, 128, 2, True)]
# (B, C, H=W, G, swish, pre-affine, statistics given) of the GroupNorm
# backward: the 16->128 training cell's K1 input at 128^2 (192 channels),
# its 8^2 maps, the 64->512 cell's statistics route at 512^2, a 1024^2 map
# (a slice split over all SMs), the attention pre-norm (no SiLU), K1's
# pre-affine, and a ragged map
GN_BWD_CASES = [(128, 192, 128, 32, True, False, False),
                (128, 512, 8, 32, True, False, True),
                (16, 64, 512, 16, True, False, True),
                (2, 64, 1024, 32, True, False, False),
                (4, 512, 16, 32, False, False, False),
                (2, 64, 32, 32, True, True, True),
                (3, 96, 10, 8, True, True, False)]
K4_SHAPES = [(256, 512), (64, 512)]        # (seq, head_dim)
# (batch*heads, seq, head_dim) of K4-with-lse, K5 and K6 in the train step
# at batch 4, a ragged shape, and a ragged one whose keys K4 splits (as it
# does at the 64->512 path's 2x1024x512), so that phase 3 checks the merge
BWD_SHAPES = [(4, 256, 512), (4, 64, 512), (3, 100, 64), (2, 1000, 512)]

# The SR3 64->512 training path (configs/sr_sr3_64_512_attn.json: 70.0M
# parameters, 16 norm groups, attention at 64x64 and 32x32, remat, dropout
# 0.2), batch 2, and its val batch 8
CONFIG_512 = os.path.join(ROOT, "configs", "sr_sr3_64_512_attn.json")
# (Cin, Cout, H=W) of every K1 call of the 64->512 UNet (checked as
# K1_SHAPES is); phase 3 runs them at the train batch, in float32 and bf16
K1_SHAPES_512 = [
    (64, 64, 512), (64, 128, 256), (128, 128, 256), (128, 256, 128),
    (256, 256, 128), (256, 512, 64), (512, 512, 64), (512, 512, 32),
    (1024, 512, 32), (1024, 512, 64), (768, 512, 64), (768, 256, 128),
    (384, 256, 128), (384, 128, 256), (192, 128, 256), (192, 64, 512),
    (128, 64, 512), (64, 3, 512),
]
BATCH_CHECK_512 = 2
# the K2 calls of a 64->512 training forward (as K2_SITES), 16 groups
K2_SITES_512 = [(256, 128, True), (512, 64, True), (512, 32, True),
                (512, 64, False), (512, 32, False)]
# (B, Cin, Cout, H=W): K1 calls of the batch-8 512^2 serving step on which
# the bf16 route takes 128 output channels a block, over 4 and 2 blocks of
# them; phase 3 checks these too
K1_SERVING_512 = [(8, 512, 512, 64), (8, 128, 256, 128)]
# (b, Cin, Cout, H=W): one K1 call of each bf16 class of the conv launch
# (conv_fused.BF16_TILES, in that order, on a 132-SM H100), so phase 3
# checks every class against the plain version
K1_CLASS_CASES = [(2, 128, 256, 128), (2, 192, 192, 128), (8, 128, 128, 64),
                  (1, 128, 256, 64), (128, 512, 512, 8), (2, 512, 512, 8),
                  (2, 64, 3, 32)]
# (b, Cin, Cout, H=W) K1 timed at each serving class's cell shapes beside
# its bound and cuDNN's bare conv (library_ms; the port never calls it):
# SR3 16->128 at batch 128 (64^2, 32^2, 16^2), SR3 64->512 at batch 8
# (256^2), FiLM and residual; the ADM's at K1_ADM (phase 42)
K1_TIMED = [(128, 128, 128, 64), (128, 256, 256, 32), (128, 512, 512, 16),
            (8, 128, 128, 256)]
TRAIN_STEPS_512 = 3
TIME_STEPS_512 = 10
PROFILE_STEPS_512 = 2
# (B, C, H, W) of K3: the dropout Blocks at 512^2 and 256^2, a ragged map
# whose 90,000 pixels do not divide into the kernel's pixel slices, and the
# 128->1024 path's dropout Blocks at 1024^2, 512^2 and 256^2 (batch 2)
K3_SHAPES = [(2, 64, 512, 512), (2, 128, 256, 256), (2, 96, 300, 300),
             (2, 64, 1024, 1024), (2, 128, 512, 512), (2, 256, 256, 256)]
# K3 past 2^30 elements (sums only): 8 x 128 x 1024^2
K3_LARGE = [(8, 128, 1024, 1024)]
# K3's sums against float64 sums: s1 within K3_TOL of sum|x|, s2 within
# K3_TOL of s2 (float32 partial sums of a few thousand terms, in a tree)
K3_TOL = 1e-5
# (batch*heads, seq, head_dim): the 64->512 path's 64x64 and 32x32
# attention, 16384 tokens (attention at 128x128 on that model), the
# 1024-token serving batch and the 4096-token one of the 512^2 serving
# step, and the 16->128 train step's attention at its batch 4 and at the
# bench's 16 (phases 11 and 17 check and time each)
LONG_SHAPES = [(2, 4096, 512), (2, 1024, 512), (1, 16384, 256),
               (8, 1024, 512), (8, 4096, 512), (4, 256, 512), (4, 64, 512),
               (16, 256, 512), (16, 64, 512)]
# remat on against remat off, float32, same seed and dropout draws, cuDNN's
# deterministic algorithms: the same operations on the same values
REMAT_TOL = 1e-5
# The rest of the sampling surface: the ddpm 16->128 model (the same sites as
# the sr3 one, time_mlp / mlp conditioning on float t), the unconditional
# sr3 128^2 model (the same sites, 3 input channels) and the six-level
# unconditional ddpm 128^2 model (26.4M parameters, maps down to 4x4,
# attention at 16x16 with C 128 and in the 4x4 mid block with C 256)
CONFIG_DDPM = os.path.join(ROOT, "configs", "sr_ddpm_16_128.json")
CONFIG_UNCOND_SR3 = os.path.join(ROOT, "configs", "sample_sr3_128.json")
CONFIG_DDPM_128 = os.path.join(ROOT, "configs", "sample_ddpm_128.json")
# (Cin, Cout, H=W) of every K1 call of the sample_ddpm_128 UNet (checked as
# K1_SHAPES is); phase 3 runs them at every batch of k1_batches
K1_SHAPES_DDPM_128 = [
    (64, 64, 128), (64, 64, 64), (64, 128, 32), (128, 128, 32),
    (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4),
    (512, 256, 4), (512, 256, 8), (384, 256, 8), (384, 128, 16),
    (256, 128, 16), (256, 128, 32), (192, 128, 32), (192, 64, 64),
    (128, 64, 64), (128, 64, 128), (64, 3, 128),
]
# its K2 calls (as K2_SITES): C 256 at 4x4 and C 128 at 16x16 among them
K2_SITES_DDPM_128 = [(64, 128, True), (64, 64, True), (128, 32, True),
                     (128, 16, True), (256, 8, True), (256, 4, True),
                     (128, 16, False), (256, 4, False)]
# (batch*heads, seq, head_dim) of its attention (16x16 at C 128, the 4x4
# mid block at C 256: fewer rows than one tile) at the train batch, and of
# K4 at the serving group of 2
BWD_SHAPES_DDPM_128 = [(4, 256, 128), (4, 16, 256)]
K4_SHAPES_DDPM_128 = [(256, 128), (16, 256)]
# the strided chains on the 16->128 sr3 model, bf16, batch BATCH_TIME, from
# the T=2000 schedule: (label, model.diffusion settings, UNet forwards)
STRIDED = [("DDIM-50", {"sampler": "ddim", "sampler_steps": 50}, 50),
           ("DPM++-25", {"sampler": "dpm++", "sampler_steps": 25}, 25),
           ("SDE DPM++-25", {"sampler": "dpm++", "sampler_steps": 25,
                             "eta": 1.0}, 25)]
NEW_TRAIN_STEPS = 3
# The SR3 128->1024 cascade stage (configs/sr_sr3_128_1024.json: 91.6M
# parameters, six levels 1-2-4-8-8-8 down to 32x32, one res block a level,
# 16 norm groups, attention at 32x32 (1024 tokens at C 512), remat, dropout
# 0.2), train batch 2 and val batch 8
CONFIG_1024 = os.path.join(ROOT, "configs", "sr_sr3_128_1024.json")
# (Cin, Cout, H=W) of every K1 call of its UNet (checked as K1_SHAPES is);
# phase 3 runs them at every batch of k1_batches (2, 8): the largest input
# is 8 x 192 x 1024^2 (1.6e9 elements, 3.2 GB in bf16)
K1_SHAPES_1024 = [
    (64, 64, 1024), (64, 128, 512), (128, 128, 512), (128, 256, 256),
    (256, 256, 256), (256, 512, 128), (512, 512, 128), (512, 512, 64),
    (512, 512, 32), (1024, 512, 32), (1024, 512, 64), (1024, 512, 128),
    (768, 512, 128), (768, 256, 256), (384, 256, 256), (384, 128, 512),
    (192, 128, 512), (192, 64, 1024), (128, 64, 1024), (64, 3, 1024),
]
# its K2 calls (as K2_SITES): the dropout Blocks below 256^2, the pre-norm
K2_SITES_1024 = [(512, 128, True), (512, 64, True), (512, 32, True),
                 (512, 32, False)]
TRAIN_STEPS_1024 = 3
TIME_STEPS_1024 = 5
# the device-resident dataset: synthetic uint8 (HR, SR) pairs at 128^2 on
# the card, steps a train_loop call
RESIDENT_PAIRS = 64
RESIDENT_K = 4
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores and HBM3
# guided-diffusion's 128->512 upsampler (the benchmark's ADM cell): K1 at
# its shapes (b, Cin, Cout, H=W, scale-shift): out_layers with the
# per-(b, c) scale-shift after the norm and the skip as residual at 512^2
# and 16^2, up-path in_layers over 1536 and 1152 concatenated channels (no
# affine; K1's statistics launch takes up to 2048 channels); phase 3 checks
# each against the reference's sites, phase 42 times them
CONFIG_ADM = os.path.join(ROOT, "portbench", "configs", "adm_128_512.json")
K1_ADM = [(8, 192, 192, 512, True), (8, 768, 768, 16, True),
          (8, 1536, 768, 16, False), (8, 1152, 384, 64, False)]
# K1 calls of one ADM forward, and those with the scale-shift (every
# ResBlock's out_layers)
ADM_K1_SITES, ADM_SCALE_SHIFT_SITES = 75, 42
# (C, H=W, swish) of its K2 calls: the GroupNorm+SiLU of the down / up
# ResBlocks on maps below 256^2 and the attention norms; phase 3 checks the
# list against the reference (adm_k2_sites) and runs them at batch 8
K2_SITES_ADM = [(384, 128, True), (384, 64, True), (768, 32, True),
                (768, 16, True), (768, 32, False), (768, 16, False)]

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# name: (source, the TPU kernel it replaces, route by input dtype)
FMA = "float32 FMA"
WGMMA = ("bf16 wgmma tensor cores (A by ldmatrix from registers, B by "
         "shared-memory descriptor), float32 accumulate; C_out > 8: one "
         "persistent block per SM, a TMA producer warp (weight ring and raw "
         "halo under mbarriers), three normalizer warps off the tensor "
         "pipe, a class per (map width, C_out, items) "
         "(conv_fused.BF16_TILES); C_out <= 8: cp.async weight ring and "
         "halo")
K4_WGMMA = ("bf16 wgmma tensor cores (S = Q K^T by shared-memory "
            "descriptors, P V with P from registers and V by a transposed "
            "descriptor), float32 accumulate; TMA loads of a K / V ring "
            "under mbarriers from one producer warp; a class per head_dim "
            "(attention.BF16_TILES); below half a wave of blocks a key "
            "split merged in a fixed order by a second launch")
K56_WGMMA = ("bf16 wgmma tensor cores (S and dP, or their transposes, by "
             "shared-memory descriptors; P and dS from registers times dO, "
             "Q or K by a transposed descriptor), float32 accumulate; the "
             "resident pair loaded once and the streamed pair through a "
             "ring by TMA under mbarriers from one producer warp; a class "
             "per head_dim (attention.BWD_TILES); below a quarter wave of "
             "blocks a split of the streamed tiles added in a fixed order "
             "by a second launch")
GN_CLUSTER = ("one launch: a thread-block cluster per (image, channel "
              "block), 16-byte loads, the range resident in shared memory, "
              "sums folded through distributed shared memory in rank order, "
              "float32 arithmetic")
GN_BWD = ("two passes over the map (the per-(b, group) sums, then dx), "
          "slices split over pixels to fill the card once, 16-byte loads, "
          "float32 arithmetic, fixed-order folds without atomics")
KERNELS = {
    "gn_silu_conv3x3": ("sr3_tpu_torch/csrc/conv_fused.cu",
                        "sr3_tpu/ops/conv_fused.py:117",
                        {"float32": FMA, "bfloat16": WGMMA}),
    "group_norm": ("sr3_tpu_torch/csrc/groupnorm.cu",
                   "sr3_tpu/ops/groupnorm.py:237",
                   {"float32": GN_CLUSTER, "bfloat16": GN_CLUSTER}),
    "flash_attention_fwd": ("sr3_tpu_torch/csrc/attention.cu",
                            "sr3_tpu/ops/attention.py:58",
                            {"float32": FMA, "bfloat16": K4_WGMMA}),
    "flash_attention_bwd_dkv": ("sr3_tpu_torch/csrc/attention_bwd.cu",
                                "sr3_tpu/ops/attention.py:163",
                                {"float32": FMA, "bfloat16": K56_WGMMA}),
    "flash_attention_bwd_dq": ("sr3_tpu_torch/csrc/attention_bwd.cu",
                               "sr3_tpu/ops/attention.py:203",
                               {"float32": FMA, "bfloat16": K56_WGMMA}),
    "gn_stats": ("sr3_tpu_torch/csrc/gn_stats.cu",
                 "sr3_tpu/ops/groupnorm.py:66",
                 {"float32": FMA, "bfloat16": FMA}),
    # the GroupNorm(+SiLU) backward of K1, K2 and the statistics route, and
    # its mode that recomputes K1's activation; the JAX package leaves both
    # to XLA (_fused_fwd_bwd, _gn_swish_fwd_bwd), so they replace no Pallas
    # kernel
    "gn_silu_bwd": ("sr3_tpu_torch/csrc/gn_bwd.cu", "none (XLA)",
                    {"float32": GN_BWD, "bfloat16": GN_BWD}),
    "gn_silu_act": ("sr3_tpu_torch/csrc/gn_bwd.cu", "none (XLA)",
                    {"float32": GN_BWD, "bfloat16": GN_BWD}),
    # K1's halo entry (an H-shard under the space axis): the conv launch of
    # both routes with outside statistics and the neighbours' halo rows
    "gn_silu_conv3x3_halo": ("sr3_tpu_torch/csrc/conv_fused.cu",
                             "sr3_tpu/ops/conv_fused.py:117",
                             {"float32": FMA, "bfloat16": WGMMA}),
}
# the kernels of the single-device paths (all but K1's halo entry)
ONE_DEVICE_KERNELS = tuple(k for k in KERNELS
                           if k != "gn_silu_conv3x3_halo")
FORWARD_KERNELS = ("gn_silu_conv3x3", "group_norm", "flash_attention_fwd")
KERNELS_16_128 = FORWARD_KERNELS + ("flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq", "gn_silu_bwd",
                                    "gn_silu_act")


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] done in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return wrap


def rel_err(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30), d


def check(torch, errs, failures, kernel, dtype, label, out, ref, tol=None):
    """Hold one kernel output against its plain version: error relative to
    max|ref| within TOL (or ``tol``); recorded in ``errs[kernel]``."""
    torch.cuda.synchronize()
    rel, absd = rel_err(out, ref)
    tol = TOL[dtype][kernel] if tol is None else tol
    ok = rel <= tol
    e = errs.setdefault(kernel, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                 "checks": 0})
    e["max_abs_err"] = max(e["max_abs_err"], absd)
    e["max_rel_err"] = max(e["max_rel_err"], rel)
    e["checks"] += 1
    print(f"  {kernel} {dtype} {label}: rel {rel:.3e} abs {absd:.3e} "
          f"tol {tol:g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{kernel} {dtype} {label}")


def check_grad(torch, failures, name, dtype, i, got, ref):
    """An autograd Function's input gradient against autograd of the plain
    version."""
    torch.cuda.synchronize()
    rel, absd = rel_err(got, ref)
    tol = TOL[dtype]["function"]
    ok = rel <= tol and got.dtype == ref.dtype
    print(f"  autograd {name} {dtype} input {i} gradient: rel {rel:.3e} "
          f"abs {absd:.3e} tol {tol:g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"autograd {name} {dtype} input {i}")


def function_grads(torch, call, wrapper, plain, inputs):
    """Input gradients of (wrapper, plain) for one seeded output weighting."""
    grads = []
    for f in (wrapper, plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = call(f, leaves)
        w = torch.randn(out.shape, device="cuda", generator=torch
                        .Generator(device="cuda").manual_seed(1))
        (out.float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    return grads


@phase("device")
def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@phase("build")
def build_phase():
    from sr3_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"built {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with open(path + ".log") as f:
        print_ptxas(f.read())


def print_ptxas(log):
    """Registers and spill stores of each kernel, from ptxas -v output."""
    import re

    name, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas {name}: {m.group(1)} registers, {spill} bytes "
                  f"spill stores", flush=True)
            name, spill = None, 0


def _kernel_name(mangled):
    """`flash_fwd_kernel<float>` or `..._wgmma_kernel<16,1,128>` from a
    mangled kernel name: the length-prefixed identifier that ends in
    `_kernel`, and its dtype or integer template arguments."""
    import re

    for run in re.finditer(r"\d+", mangled):
        for i in range(len(run.group())):
            n, at = int(run.group()[i:]), run.end()
            ident = mangled[at:at + n]
            if len(ident) == n and ident.endswith("_kernel"):
                rest = mangled[at + n:]
                ints = re.match(r"I((?:Li\d+E)+)E", rest)
                if ints:
                    args = re.findall(r"Li(\d+)E", ints.group(1))
                    return ident + "<" + ",".join(args) + ">"
                return ident + ("<float>" if rest.startswith("If") else
                                "<bf16>" if rest.startswith("I13__nv_bf")
                                else "")
    return mangled


def _k1_inputs(torch, g, b, cin, cout, hw, dtype, film):
    dev, cl = "cuda", torch.channels_last
    x = torch.randn(b, cin, hw, hw, device=dev, generator=g)
    x = x.to(dtype).contiguous(memory_format=cl)
    gw = 1 + 0.2 * torch.randn(cin, device=dev, generator=g)
    gb = 0.1 * torch.randn(cin, device=dev, generator=g)
    w = torch.randn(cout, cin, 3, 3, device=dev, generator=g) / (3 * cin ** .5)
    w = w.to(dtype).contiguous(memory_format=cl)
    bias = 0.1 * torch.randn(cout, device=dev, generator=g)
    kw = {}
    if film:
        kw["pre_scale"] = 1 + 0.3 * torch.randn(b, cin, device=dev, generator=g)
        kw["pre_bias"] = 0.5 * torch.randn(b, cin, device=dev, generator=g)
        r = torch.randn(b, cout, hw, hw, device=dev, generator=g)
        kw["residual"] = r.to(dtype).contiguous(memory_format=cl)
    return (x, gw, gb, w, bias, 32), kw


def _adm_opt():
    with open(CONFIG_ADM) as f:
        return json.load(f)["opt"]


def _adm_reference():
    from portbench.reference import adm

    return adm


def adm_k2_sites():
    """(C, H, swish) of each K2 call of one ADM forward, in order, read off
    the benchmark reference on the meta device: the GroupNorm+SiLU at the
    input of each down / up ResBlock on maps below STATS_MIN_HW (larger
    ones take the statistics route), and every attention norm (no SiLU)."""
    from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW

    adm, opt, out = _adm_reference(), _adm_opt(), []

    def hook(block, args):
        _, c, h, w = args[0].shape
        if isinstance(block, adm.AttentionBlock):
            out.append((c, h, False))
        elif (block.up or block.down) and h * w < STATS_MIN_HW:
            out.append((c, h, True))

    net = adm.build(opt, "meta")
    for m in net.modules():
        if isinstance(m, (adm.ResBlock, adm.AttentionBlock)):
            m.register_forward_pre_hook(hook)
    net(*adm._meta_inputs(opt, 1))
    return out


def _k1_adm_inputs(torch, g, dtype, b, cin, cout, hw, post):
    """K1's inputs at an ADM site: x, GroupNorm affine and conv as
    _k1_inputs; with ``post`` a per-(b, c) scale and shift after the norm
    and a residual, else no affine."""
    args, _ = _k1_inputs(torch, g, b, cin, cout, hw, dtype, False)
    if not post:
        return args, {}
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    return args, dict(post_scale=0.3 * r(b, cin), post_shift=0.5 * r(b, cin),
                      residual=r(b, cout, hw, hw).to(dtype).contiguous(
                          memory_format=torch.channels_last))


@phase("kernels")
def kernel_phase(torch, errs):
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    g = torch.Generator(device="cuda").manual_seed(0)
    failures = []

    def record_fn(name, dtype, i, got, ref):
        check_grad(torch, failures, name, dtype, i, got, ref)

    def record(kernel, dtype, label, out, ref):
        check(torch, errs, failures, kernel, dtype, label, out, ref)

    for config, shapes in ((CONFIG, K1_SHAPES), (CONFIG_DDPM, K1_SHAPES),
                           (CONFIG_UNCOND_SR3, K1_SHAPES),
                           (CONFIG_512, K1_SHAPES_512),
                           (CONFIG_DDPM_128, K1_SHAPES_DDPM_128),
                           (CONFIG_1024, K1_SHAPES_1024)):
        sites = k1_sites(torch, config)
        if sorted(set(sites)) != sorted(shapes):
            failures.append(f"K1 shapes of {os.path.basename(config)}: the "
                            f"model's {sorted(set(sites))}")
    adm_sites = {(s["b"], s["cin"], s["cout"], s["h"], s["post"])
                 for s in _adm_reference().k1_sites(_adm_opt(), 8)}
    for case in K1_ADM:
        if case not in adm_sites:
            failures.append(f"K1 ADM case {case} is no site of the "
                            f"reference's batch-8 forward")
    if sorted(set(adm_k2_sites())) != sorted(K2_SITES_ADM):
        failures.append(f"K2 sites of the ADM: the reference's "
                        f"{sorted(set(adm_k2_sites()))}")
    k1_cases = ([(BATCH_CHECK, *s) for s in K1_SHAPES]
                + [(BATCH_CHECK_512, *s) for s in K1_SHAPES_512]
                + K1_SERVING_512 + K1_CLASS_CASES + K1_TIMED
                + [(b, *s) for b in k1_batches(_load_opt(config=CONFIG_DDPM_128))
                   for s in K1_SHAPES_DDPM_128]
                + [(b, *s) for b in k1_batches(_load_opt(config=CONFIG_1024))
                   for s in K1_SHAPES_1024])
    k2_cases = K2_EXTRA[:]
    for config, sites in ((CONFIG, K2_SITES), (CONFIG_DDPM, K2_SITES),
                          (CONFIG_UNCOND_SR3, K2_SITES),
                          (CONFIG_512, K2_SITES_512),
                          (CONFIG_DDPM_128, K2_SITES_DDPM_128),
                          (CONFIG_1024, K2_SITES_1024)):
        opt = _load_opt(config=config)
        model_sites = k2_sites(torch, config)
        if sorted(set(model_sites)) != sorted(sites):
            failures.append(f"K2 sites of {os.path.basename(config)}: the "
                            f"model's {sorted(set(model_sites))}")
        groups = opt["model"]["unet"].get("norm_groups") or 32
        for b in k2_batches(opt):
            k2_cases += [(b, c, h, h, groups, swish) for c, h, swish in sites
                         if (b, c, h, h, groups, swish) not in k2_cases]
    k2_cases += [(8, c, h, h, 32, swish) for c, h, swish in K2_SITES_ADM]
    checked_tiles, checked_clusters, checked_k4 = set(), set(), set()
    checked_bwd = set()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, cin, cout, hw in k1_cases:
            for film in ((False,) if cout == 3 else (False, True)):
                args, kw = _k1_inputs(torch, g, b, cin, cout, hw, dtype, film)
                label = (f"{b}x{cin}x{hw}x{hw}->{cout}"
                         + (" +film+residual" if film else ""))
                conv_fused.bf16_tile_launches(reset=True)
                out = conv_fused.gn_silu_conv3x3(*args, **kw)
                tiles = [t for t, n in conv_fused.bf16_tile_launches().items()
                         if n]
                if dtype == torch.bfloat16:
                    label += " tile " + ",".join(tiles)
                    checked_tiles.update(tiles)
                record("gn_silu_conv3x3", dn, label, out,
                       conv_fused.gn_silu_conv3x3_plain(*args, **kw))
                del args, kw, out
        for case in K1_ADM:
            if dtype == torch.float32 and case[3] == 512:
                case = (2,) + case[1:]  # the float32 plain's intermediates
            args, kw = _k1_adm_inputs(torch, g, dtype, *case)
            conv_fused.bf16_tile_launches(reset=True)
            out = conv_fused.gn_silu_conv3x3(*args, **kw)
            b, cin, cout, hw, post = case
            label = (f"ADM {b}x{cin}x{hw}x{hw}->{cout}"
                     + (" +scale-shift+residual" if post else ""))
            if dtype == torch.bfloat16:
                tiles = [t for t, n in
                         conv_fused.bf16_tile_launches().items() if n]
                label += " tile " + ",".join(tiles)
                checked_tiles.update(tiles)
            record("gn_silu_conv3x3", dn, label, out,
                   conv_fused.gn_silu_conv3x3_plain(*args, **kw))
            del args, kw, out
        for b, c, h, w, groups, swish in k2_cases:
            x = torch.randn(b, c, h, w, device="cuda", generator=g)
            x = (3 * x + 1).to(dtype).contiguous(memory_format=torch.channels_last)
            gw = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
            gb = 0.1 * torch.randn(c, device="cuda", generator=g)
            groupnorm.cluster_launches(reset=True)
            out = groupnorm.group_norm(x, gw, gb, groups, swish=swish)
            launched = groupnorm.cluster_launches()
            checked_clusters.update(launched)
            label = (f"{b}x{c}x{h}x{w} G={groups}"
                     + (" +silu" if swish else "") + " cluster "
                     + ",".join(f"{n}" + ("" if res else " not resident")
                                for _, n, res in launched))
            record("group_norm", dn, label, out,
                   groupnorm.group_norm_plain(x, gw, gb, groups, swish=swish))
            del x, out
        for seq, d in K4_SHAPES + K4_SHAPES_DDPM_128:
            q, k, v = (torch.randn(BATCH_CHECK, seq, d, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            attention.bf16_tile_launches(reset=True)
            out = attention.attention(q, k, v, d ** -0.5)
            record("flash_attention_fwd", dn, f"{BATCH_CHECK}x{seq}x{d}"
                   + k4_classes(checked_k4), out,
                   attention.attention_plain(q, k, v, d ** -0.5))
        for bh, seq, d in BWD_SHAPES + BWD_SHAPES_DDPM_128:
            q, k, v = (torch.randn(bh, seq, d, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            gr = torch.randn(bh, seq, d, device="cuda", generator=g)
            attention.bf16_tile_launches(reset=True)
            o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
            label = f"{bh}x{seq}x{d}" + k4_classes(checked_k4)
            ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, d ** -0.5)
            record("flash_attention_fwd", dn, label + " with lse: o", o, ref_o)
            check(torch, errs, failures, "flash_attention_fwd", dn,
                  label + " with lse: lse", lse, ref_lse,
                  tol=TOL[dn]["flash_attention_lse"])
            dsum = (gr * o).sum(-1)
            attention.bwd_tile_launches(reset=True)
            dq, dk, dv = attention.attention_bwd(q, k, v, gr, lse, dsum,
                                                 d ** -0.5)
            label += bwd_classes(checked_bwd)
            rq, rk, rv = attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                                       d ** -0.5)
            record("flash_attention_bwd_dkv", dn, label + ": dk", dk, rk)
            record("flash_attention_bwd_dkv", dn, label + ": dv", dv, rv)
            record("flash_attention_bwd_dq", dn, label + ": dq", dq, rq)
        for case in GN_BWD_CASES:
            _gn_bwd_checks(torch, g, dtype, dn, case, record,
                           lambda *a: check(torch, errs, failures, *a,
                                            tol=GN_BWD_PARAM_TOL))
        for name, call, wrapper, plain, inputs in _function_cases(
                torch, g, dtype):
            attention.bf16_tile_launches(reset=True)
            attention.bwd_tile_launches(reset=True)
            grads = function_grads(torch, call, wrapper, plain, inputs)
            k4_classes(checked_k4)
            bwd_classes(checked_bwd)
            for i, (got, ref) in enumerate(zip(*grads)):
                record_fn(name, dn, i, got, ref)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    conv_fused.bf16_tile_launches(reset=True)
    groupnorm.cluster_launches(reset=True)
    attention.bf16_tile_launches(reset=True)
    attention.bwd_tile_launches(reset=True)
    return checked_tiles, checked_clusters, checked_k4, checked_bwd


def _gn_bwd_inputs(torch, g, dtype, b, c, hw, pre):
    """x, dy (``dtype``, channels_last), gamma, beta and the pre-affine
    (``pre``) of one GroupNorm backward case."""
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    cl = torch.channels_last
    x = (3 * r(b, c, hw, hw) + 1).to(dtype).contiguous(memory_format=cl)
    dy = r(b, c, hw, hw).to(dtype).contiguous(memory_format=cl)
    affine = dict(pre_scale=1 + 0.3 * r(b, c), pre_bias=0.5 * r(b, c)) \
        if pre else {}
    return x, dy, 1 + 0.2 * r(c), 0.1 * r(c), affine


def _gn_bwd_checks(torch, g, dtype, dn, case, record, record_param):
    """One GN_BWD_CASES case: where the statistics are given, gn_silu_act's
    activation and statistics against gn_silu_act_plain's; then
    gn_silu_bwd's dx (``record``) and its float32 parameter gradients
    (``record_param``) against gn_silu_bwd_plain's."""
    from sr3_tpu_torch.ops import groupnorm

    b, c, hw, groups, swish, pre, given = case
    x, dy, gw, gb, affine = _gn_bwd_inputs(torch, g, dtype, b, c, hw, pre)
    label = (f"{b}x{c}x{hw}x{hw} G={groups}" + (" +silu" if swish else "")
             + (" +pre-affine" if pre else ""))
    stats = None
    if given:
        act, stats = groupnorm.gn_silu_act(x, gw, gb, groups, **affine)
        ref_act, ref_stats = groupnorm.gn_silu_act_plain(x, gw, gb, groups,
                                                         **affine)
        record("gn_silu_act", dn, label, act, ref_act)
        for name, got, ref in zip(("mean", "rstd"), stats, ref_stats):
            record_param("gn_silu_act", dn, f"{label}: {name}", got, ref)
        del act, ref_act
    got = groupnorm.gn_silu_bwd(x, dy, gw, gb, groups, swish=swish,
                                stats=stats, **affine)
    want = groupnorm.gn_silu_bwd_plain(x, dy, gw, gb, groups, swish=swish,
                                       stats=stats, **affine)
    label += " statistics " + ("given" if given else "its own")
    record("gn_silu_bwd", dn, label + ": dx", got[0], want[0])
    for name, a, w in zip(("dgamma", "dbeta", "dpre_scale", "dpre_bias"),
                          got[1:], want[1:]):
        if (a is None) != (w is None):
            raise AssertionError(f"gn_silu_bwd {label}: {name} {a} vs {w}")
        if a is not None:
            record_param("gn_silu_bwd", dn, f"{label}: {name}", a, w)


def gn_bwd_sites(torch, config):
    """(K1 calls, GroupNorm backward calls) of one training forward of
    ``config``'s model, read off a meta-device copy: K1 runs both Blocks of
    every ResnetBlock but its dropout Block (K2 or the statistics route
    and a plain conv in training), and final_conv; the backward kernel
    runs once for each of those, each dropout Block and each attention
    pre-norm. Remat replays forwards, not backwards: the counts hold a
    step with it too."""
    from sr3_tpu_torch.models.networks import define_G

    net = define_G(_load_opt(config=config), device="meta").denoise_fn
    blocks = [layer for layer in (*net.downs[1:], *net.mid, *net.ups)
              if hasattr(layer, "res_block")]
    dropout = sum(bool(layer.res_block.block2.dropout) for layer in blocks)
    attn = sum(layer.attn is not None for layer in blocks)
    k1 = 2 * len(blocks) - dropout + 1
    return k1, k1 + dropout + attn


def _gn_bwd_launches_checked(torch, launches, config, steps):
    """Fail unless ``steps`` train steps of ``config``'s model called the
    GroupNorm backward and its activation mode as gn_bwd_sites says."""
    k1, norms = gn_bwd_sites(torch, config)
    expect = {"gn_silu_bwd": norms * steps, "gn_silu_act": k1 * steps}
    wrong = {k: (launches[k], v) for k, v in expect.items()
             if launches[k] != v}
    print(f"  expected GroupNorm backward calls {expect}", flush=True)
    if wrong:
        raise AssertionError(f"GroupNorm backward calls (got, expected): "
                             f"{wrong}")


@phase("K1 classes")
def k1_class_phase(checked, since):
    """Every bf16 class of K1's conv launch checked against the plain
    version (phase 3), and every one launched since the last reading among
    them."""
    from sr3_tpu_torch.ops import conv_fused

    _classes_checked("K1", conv_fused.bf16_tile_launches,
                     conv_fused.BF16_TILES, checked, since)


def launched_classes(launches, checked):
    """The bf16 classes (and merges) a tile-launch reader (``launches``:
    ``attention.bf16_tile_launches`` for K4, ``attention.bwd_tile_launches``
    for K5 / K6) counted since its last reset, added to ``checked``, as a
    label for the check that launched them."""
    taken = [t for t, n in launches().items() if n]
    checked.update(taken)
    return " class " + ",".join(taken) if taken else ""


def k4_classes(checked):
    from sr3_tpu_torch.ops import attention

    return launched_classes(attention.bf16_tile_launches, checked)


def bwd_classes(checked):
    from sr3_tpu_torch.ops import attention

    return launched_classes(attention.bwd_tile_launches, checked)


def _classes_checked(what, launches, tiles, checked, since):
    """Fail unless every bf16 class of ``tiles`` (and the merge) was
    checked against the plain version, and every one launched since the
    last reading was among them; then set the counts to 0."""
    taken = {t: n for t, n in launches(reset=True).items() if n}
    print(f"  bf16 {what} launches by class since {since}: {taken}; "
          f"checked: {sorted(checked)}", flush=True)
    missing = set(tiles) - checked
    if missing or set(taken) - checked:
        raise AssertionError(f"bf16 {what} classes not checked: "
                             f"{sorted(missing | (set(taken) - checked))}")


@phase("K4 classes")
def k4_class_phase(checked, since):
    """Every bf16 K4 class and the merge checked (phases 3 and 11)."""
    from sr3_tpu_torch.ops import attention

    _classes_checked("K4", attention.bf16_tile_launches,
                     attention.BF16_TILES, checked, since)


@phase("K5/K6 classes")
def bwd_class_phase(checked, since):
    """Every bf16 K5 and K6 class and the merge checked (phases 3, 11 and
    22)."""
    from sr3_tpu_torch.ops import attention

    _classes_checked("K5 / K6", attention.bwd_tile_launches,
                     attention.BWD_TILES, checked, since)


@phase("K2 clusters")
def k2_cluster_phase(checked):
    """Fail if a K2 launch since phase 3 took a (dtype, cluster size,
    residency) that phase 3 did not check against the plain version."""
    from sr3_tpu_torch.ops import groupnorm

    taken = groupnorm.cluster_launches()
    print(f"  K2 launches by (dtype, cluster size, resident) since phase 3: "
          f"{dict(sorted(taken.items()))}; checked in phase 3: "
          f"{sorted(checked)}", flush=True)
    if not taken or set(taken) - checked:
        raise AssertionError(f"K2 clusters launched but not checked: "
                             f"{sorted(set(taken) - checked)}")


def k1_batches(opt):
    """The batches at which the paths run K1 on the sample_ddpm_128 and the
    128->1024 models: 2 (run_uncond's groups), the train batch and
    BATCH_TIME (the timed step, the 1024^2 val batch and the cascade's
    group)."""
    return sorted({BATCH_CHECK, opt["datasets"]["train"]["batch_size"],
                   BATCH_TIME})


def k2_batches(opt):
    """The batches at which the paths run K2 on ``opt``'s model: 1 (the
    full-width forward and the gradient phases), 2 (run_sr's groups of two
    images), the train batch and BATCH_TIME (the timed serving steps)."""
    return sorted({1, 2, opt["datasets"]["train"]["batch_size"], BATCH_TIME})


def k1_sites(torch, config):
    """(Cin, Cout, H) of each K1 call of one UNet forward of ``config``'s
    model, in order, read off its Blocks (a meta-device copy): both Blocks
    of every ResnetBlock, then final_conv. In training the dropout Blocks
    run K2 and a plain conv instead."""
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.unet import Downsample, Upsample

    net = define_G(_load_opt(config=config), device="meta").denoise_fn
    res, out = net.image_size, []

    def conv(block):
        return (*block.block[3].weight.shape[1::-1], res)

    for layer in (*net.downs[1:], *net.mid, *net.ups):
        if isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
        else:
            out += [conv(layer.res_block.block1), conv(layer.res_block.block2)]
    return out + [conv(net.final_conv)]


def k2_sites(torch, config, training=True):
    """(C, H, swish) of each K2 call of one UNet forward of ``config``'s
    model, in order, read off a meta-device copy: with ``training`` the
    dropout Block (block2) of every ResnetBlock on maps below STATS_MIN_HW
    (GroupNorm + SiLU), and every attention pre-norm (no SiLU)."""
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.unet import Downsample, Upsample
    from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW

    net = define_G(_load_opt(config=config), device="meta").denoise_fn
    res, out = net.image_size, []
    for layer in (*net.downs[1:], *net.mid, *net.ups):
        if isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
        else:
            block2 = layer.res_block.block2
            if training and block2.dropout and res * res < STATS_MIN_HW:
                out.append((block2.block[3].weight.shape[0], res, True))
            if layer.attn is not None:
                out.append((layer.attn.qkv.weight.shape[1], res, False))
    return out


def _function_cases(torch, g, dtype):
    """(name, call, wrapper, plain, inputs) of the K1, K2 and K4 autograd
    Functions at main-path shapes (batch 2)."""
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    args, kw = _k1_inputs(torch, g, BATCH_CHECK, 512, 512, 16, dtype, True)
    k1 = [*args[:5], kw["pre_bias"], kw["residual"]]
    x = (3 * r(BATCH_CHECK, 512, 16, 16) + 1).to(dtype)
    k2 = [x.contiguous(memory_format=torch.channels_last), 1 + 0.2 * r(512),
          0.1 * r(512)]
    k4 = [r(BATCH_CHECK, 256, 512).to(dtype) for _ in range(3)]
    return [
        ("gn_silu_conv3x3", lambda f, t: f(*t[:5], 32, pre_bias=t[5],
                                           residual=t[6]),
         conv_fused.gn_silu_conv3x3, conv_fused.gn_silu_conv3x3_plain, k1),
        ("group_norm", lambda f, t: f(*t, 32, swish=True),
         groupnorm.group_norm, groupnorm.group_norm_plain, k2),
        ("attention", lambda f, t: f(*t, 512 ** -0.5),
         attention.attention, attention.attention_plain, k4),
    ]


def _load_opt(dtype=None, val_steps=None, phase="val", config=CONFIG):
    from sr3_tpu_torch.utils.config import load_config

    opt = load_config(config)
    opt["phase"] = phase
    opt["path"]["resume_state"] = None
    if dtype:
        opt["model"]["dtype"] = dtype
    if val_steps:
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = val_steps
    return opt


def counters():
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    return [conv_fused.counter, groupnorm.counter, groupnorm.stats_counter,
            attention.counter, attention.dkv_counter, attention.dq_counter,
            conv_fused.halo_counter, groupnorm.bwd_counter,
            groupnorm.act_counter]


def launches_of(names):
    return {c.name: c.n for c in counters() if c.name in names}


def forward_launches():
    return {c.name: c.n for c in counters() if c.name in FORWARD_KERNELS}


@phase("full-width model")
def model_phase(torch):
    from sr3_tpu_torch.models.networks import count_params, define_G
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(dtype="float32")
    gpu = define_G(opt, device="cuda", seed=0).denoise_fn
    n = count_params(gpu)
    print(f"  SR3 16->128 UNet: {n:,d} parameters ({n / 1e6:.1f}M)", flush=True)
    if abs(n / 1e6 - 97.8) > 0.05:
        raise AssertionError(f"expected 97.8M parameters, got {n}")
    cpu = define_G(opt, device="cpu", seed=0).denoise_fn
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, 128, 128, generator=g)
    lvl = torch.tensor([0.5])
    for c in counters():
        c.n = 0
    with torch.inference_mode():
        out_gpu = gpu(x.cuda(), lvl.cuda()).cpu()
        out_cpu = cpu(x, lvl)
    rel, absd = rel_err(out_gpu, out_cpu)
    launches = forward_launches()
    print(f"  forward B=1 float32, card vs CPU: rel {rel:.3e} abs {absd:.3e} "
          f"tol {FORWARD_TOL:g}; launches {launches}", flush=True)
    if not (rel <= FORWARD_TOL and torch.isfinite(out_gpu).all()):
        raise AssertionError(f"full-width forward: rel {rel} > {FORWARD_TOL}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")

    trainer = create_model(_load_opt(val_steps=10))  # the serving model
    trainer.netG.load_state_dict(gpu.state_dict())
    with torch.inference_mode():
        out16 = trainer._eval_params()(x.cuda(), lvl.cuda()).cpu()
    rel, absd = rel_err(out16, out_cpu)
    print(f"  forward B=1 {trainer.netG.dtype} sampling copy, card vs CPU "
          f"float32: rel {rel:.3e} abs {absd:.3e} tol {FORWARD_TOL_BF16:g}",
          flush=True)
    if not (rel <= FORWARD_TOL_BF16 and torch.isfinite(out16).all()):
        raise AssertionError(f"bf16 forward: rel {rel} > {FORWARD_TOL_BF16}")
    return trainer


@phase("serving path")
def serving_phase(torch, trainer):
    import numpy as np
    import torch.nn.functional as F

    from sr3_tpu_torch.models.diffusion import _snapshot_count
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    opt = trainer.opt
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    g = torch.Generator().manual_seed(2)
    lr = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
    sr = F.interpolate(lr, size=(128, 128), mode="bicubic",
                       align_corners=False).clamp(-1, 1)
    items = [{"SR": sr[i].permute(1, 2, 0).numpy(), "Index": i}
             for i in range(2)]
    ev = GroupedEvaluator(trainer, group_size=2)
    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    outs = list(ev.run_sr(iter(items), continous=True))
    dt = time.perf_counter() - t0
    launches = forward_launches()
    n_snap, _ = _snapshot_count(trainer.sched.num_timesteps)
    for item, frames in outs:
        if frames.shape != (1 + n_snap, 128, 128, 3):
            raise AssertionError(f"frames shape {frames.shape}")
        if not np.isfinite(frames).all():
            raise AssertionError("non-finite frames")
    print(f"  run_sr(continous=True) {trainer.netG.dtype}: {len(outs)} images, "
          f"frames {outs[0][1].shape}, T={trainer.sched.num_timesteps}, "
          f"{dt:.2f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{launches}")
    return launches


def _synthetic_batches(np, n, b, seed, lr_size=16, scale=8):
    """n seeded (HR, SR) host batches, NHWC float32 in [-1, 1]: the SR image
    is the upsampled low-resolution image and HR that plus noise, as the
    dataset's pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lr = rng.uniform(-1, 1, (b, lr_size, lr_size, 3)).astype(np.float32)
        sr = np.repeat(np.repeat(lr, scale, axis=1), scale, axis=2)
        hr = np.clip(sr + 0.1 * rng.standard_normal(sr.shape), -1, 1)
        out.append({"HR": hr.astype(np.float32), "SR": sr})
    return out


def _train_loop_checked(torch, trainer, opt, loader, names):
    """``train_loop`` over host batches with the launch counters zeroed just
    before; fails unless every loss is finite, every kernel of ``names``
    launched, and every parameter got a finite gradient and moved. Returns
    the launches."""
    import numpy as np

    from sr3_tpu_torch.training.loops import train_loop

    net = trainer.netG
    before = [p.detach().clone() for p in net.parameters()]
    losses = []
    step = trainer.optimize_parameters

    def logged_step():
        step()
        losses.append(trainer.log_dict["l_pix"])

    trainer.optimize_parameters = logged_step
    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    try:
        train_loop(trainer, loader, opt, lambda s, e: None)
        torch.cuda.synchronize()
    finally:
        del trainer.optimize_parameters
    dt = time.perf_counter() - t0
    launches = launches_of(names)
    losses = [float(x) for x in losses]
    print(f"  train_loop {len(losses)} steps in {dt:.2f} s; losses "
          f"{[round(x, 5) for x in losses]}; launches {launches}", flush=True)
    if len(losses) != len(loader) or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch in training: "
                             f"{launches}")
    bad = [n for n, p in net.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    still = [n for (n, p), p0 in zip(net.named_parameters(), before)
             if torch.equal(p.detach(), p0)]
    print(f"  parameters without a finite gradient: {len(bad)}; "
          f"parameters that did not move: {len(still)} of {len(before)}",
          flush=True)
    if bad or still:
        raise AssertionError(f"no finite gradient: {bad[:5]}; "
                             f"not moved: {still[:5]}")
    return launches


def _train_trainer(torch, config, steps):
    """The train-phase Trainer of ``config`` for ``steps`` steps through
    train_loop (print every step, no validation or checkpoint)."""
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(phase="train", config=config)
    opt["train"].update(n_iter=steps, print_freq=1, val_freq=10 ** 9,
                        save_checkpoint_freq=10 ** 9)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
    return trainer, opt


@phase("training path")
def training_phase(torch):
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params

    trainer, opt = _train_trainer(torch, CONFIG, TRAIN_STEPS)
    b = opt["datasets"]["train"]["batch_size"]
    unet = opt["model"]["unet"]
    print(f"  train-phase Trainer: {count_params(trainer.netG):,d} params "
          f"float32, compute {trainer.netG.dtype}, batch {b}, dropout "
          f"{unet['dropout']}, Adam lr {opt['train']['optimizer']['lr']}",
          flush=True)
    if trainer.netG.dtype != torch.bfloat16 or b != 4 or unet["dropout"] != 0.2:
        raise AssertionError("the training path runs at batch 4, bf16, "
                             "dropout 0.2")
    loader = _synthetic_batches(np, TRAIN_STEPS, b, seed=4)
    launches = _train_loop_checked(torch, trainer, opt, loader, KERNELS_16_128)
    _gn_bwd_launches_checked(torch, launches, CONFIG, TRAIN_STEPS)
    _log_checked(trainer, "training path")
    return trainer, launches


def _train_case(torch, config, size, seed, dtype="float32"):
    """A train-mode diffusion of ``config`` computing in ``dtype`` on the
    card and a seeded batch-1 loss with injected noise and sqrt-gamma:
    ``loss_and_grads()`` runs it with a fresh dropout generator of one seed
    and returns (loss, {name: grad})."""
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.schedule import make_schedule

    opt = _load_opt(dtype=dtype, phase="train", config=config)
    diffusion = define_G(opt, device="cuda", seed=0)
    net = diffusion.denoise_fn.train()
    sched = make_schedule(opt["model"]["beta_schedule"]["train"], "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    batch = {k: (torch.rand(1, 3, size, size, device="cuda", generator=g) * 2
                 - 1).contiguous(memory_format=cl) for k in ("HR", "SR")}
    injected = {"noise": torch.randn(1, 3, size, size, device="cuda",
                                     generator=g),
                "sqrt_gamma": torch.full((1, 1), 0.7, device="cuda")}

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        masks = torch.Generator(device="cuda").manual_seed(seed + 1)
        loss = diffusion.p_losses(net, sched, batch, masks, injected)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in net.named_parameters()}

    return net, loss_and_grads


def _compare_grads(a, b):
    """(relative loss difference, worst parameter, its relative error) of
    two (loss, grads) results."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    worst, worst_rel = None, 0.0
    for n, gb in grads_b.items():
        rel, _ = rel_err(grads_a[n], gb)
        if worst is None or not rel <= worst_rel:
            worst, worst_rel = n, rel
    return abs(loss_a - loss_b) / abs(loss_b), worst, worst_rel


def _kernels_vs_plain(torch, loss_and_grads, names, label):
    """The loss and gradients with the kernels (counters zeroed just before;
    every kernel of ``names`` must launch) against the plain ops swapped
    into the UNet module, within GRAD_TOL. Returns the kernels' result."""
    from sr3_tpu_torch.models import unet as unet_module
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    for c in counters():
        c.n = 0
    kernels = loss_and_grads()
    launches = launches_of(names)
    plain = {"gn_silu_conv3x3": conv_fused.gn_silu_conv3x3_plain,
             "group_norm": groupnorm.group_norm_plain,
             "attention": attention.attention_plain}
    saved = {k: getattr(unet_module, k) for k in plain}
    try:
        for k, f in plain.items():
            setattr(unet_module, k, f)
        plain_ops = loss_and_grads()
    finally:
        for k, f in saved.items():
            setattr(unet_module, k, f)
    loss_rel, worst, worst_rel = _compare_grads(kernels, plain_ops)
    print(f"  float32 batch 1{label}, kernels {launches} vs plain ops: loss "
          f"{kernels[0]:.6f} vs {plain_ops[0]:.6f} (rel {loss_rel:.3e}); worst "
          f"of {len(plain_ops[1])} gradients {worst}: rel {worst_rel:.3e}; tol "
          f"{GRAD_TOL:g}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    if not (loss_rel <= GRAD_TOL and worst_rel <= GRAD_TOL):
        raise AssertionError(f"gradients disagree: loss {loss_rel}, {worst} "
                             f"{worst_rel}")
    return kernels


@phase("training gradients")
def grad_check_phase(torch):
    _, loss_and_grads = _train_case(torch, CONFIG, 128, seed=5)
    _kernels_vs_plain(torch, loss_and_grads, KERNELS_16_128, "")


@phase("training timing")
def train_timing_phase(torch, trainer):
    import numpy as np

    from sr3_tpu_torch.ops import attention

    b = trainer.opt["datasets"]["train"]["batch_size"]
    trainer.feed_data(_synthetic_batches(np, 1, b, seed=7)[0])
    for _ in range(3):
        trainer.optimize_parameters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(TIME_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.optimize_parameters()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    step_ms = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train step B={b} {trainer.netG.dtype}: median {step_ms:.3f} "
          f"ms/step over {TIME_STEPS} steps (min {min(ms):.3f}, max "
          f"{max(ms):.3f}); {b / (step_ms / 1000):.3f} train img/s; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    _mfu(CONFIG, b, step_ms, train=True)

    g = torch.Generator(device="cuda").manual_seed(8)
    times = {}
    for bh, seq, d in BWD_SHAPES[:2]:
        q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        gr = torch.randn(bh, seq, d, device="cuda", generator=g)
        scale = d ** -0.5
        o, lse = attention.attention_fwd(q, k, v, scale)
        dsum = (gr * o).sum(-1)
        gr16 = gr.to(torch.bfloat16)  # K5's and K6's dO, as attention_bwd
        out = [torch.empty_like(gr) for _ in range(3)]
        plain_bwd = _time_ms(torch, lambda: attention.attention_bwd_plain(
            q, k, v, gr, lse, dsum, scale))
        pairs = {
            "flash_attention_fwd (lse)": (
                lambda: attention.attention_fwd(q, k, v, scale),
                _time_ms(torch, lambda: attention.attention_fwd_plain(
                    q, k, v, scale))),
            "flash_attention_bwd_dkv": (lambda: attention._bwd_kernel(
                "sr3_flash_attention_bwd_dkv", attention.dkv_counter, q, k,
                v, gr16, lse, dsum, out[1:], scale), plain_bwd),
            "flash_attention_bwd_dq": (lambda: attention._bwd_kernel(
                "sr3_flash_attention_bwd_dq", attention.dq_counter, q, k, v,
                gr16, lse, dsum, out[:1], scale), plain_bwd),
        }
        for name, (fn, plain_ms) in pairs.items():
            kms = _time_ms(torch, fn)
            times.setdefault(name, (kms, plain_ms))
            print(f"  {name} {bh}x{seq}x{d} bf16: kernel {kms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms" + (" (the whole plain backward)"
                                          if "bwd" in name else ""),
                  flush=True)
    return step_ms, times


@functools.lru_cache(maxsize=None)
def _counted_flops(config, train):
    """utils/flops.py's count for one image of ``config``'s model: a UNet
    forward, or with ``train`` p_losses + backward."""
    from sr3_tpu_torch.utils.flops import forward_flops, train_step_flops

    return (train_step_flops if train else forward_flops)(
        _load_opt(config=config))


def _mfu(config, batch, ms, train=False, forwards=1):
    """Print and return the MFU of a timed path: the counted FLOPs of
    ``forwards`` UNet forwards (``train``: p_losses + backward) of
    ``config``'s model for ``batch`` images over ``ms``, against
    PEAK_BF16_FLOPS."""
    flops = _counted_flops(config, train) * batch * forwards
    mfu = flops / (ms / 1000) / PEAK_BF16_FLOPS
    print(f"  MFU {100 * mfu:.2f}%: {flops / 1e12:.3f} TFLOP counted "
          f"({os.path.basename(config)}, {'train step' if train else 'forward'}"
          f" x {forwards} x batch {batch}) in {ms:.3f} ms, of "
          f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s", flush=True)
    return mfu


def _time_ms(torch, fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _serving_step(torch, trainer, seed):
    """A function that runs one p_sample_step of the serving network at
    batch BATCH_TIME, walking down the T=2000 chain from t = 1999."""
    from sr3_tpu_torch.models.schedule import make_schedule

    sched = make_schedule(dict(schedule="linear", n_timestep=2000,
                               linear_start=1e-6, linear_end=1e-2), "cuda")
    net = trainer._eval_params()
    g = torch.Generator(device="cuda").manual_seed(seed)
    cond = torch.rand(BATCH_TIME, 3, 128, 128, device="cuda", generator=g) * 2 - 1
    img = torch.randn(BATCH_TIME, 3, 128, 128, device="cuda", generator=g)
    steps = iter(range(1999, -1, -1))
    return lambda: trainer.diffusion.p_sample_step(
        net, sched, img, next(steps), cond, generator=g)


def _serving_step_ms(torch, trainer, when):
    """The mean ms of 20 serving steps, printed with ``when``."""
    with torch.inference_mode():
        ms = _time_ms(torch, _serving_step(torch, trainer, 3))
    print(f"  UNet step (p_sample_step) B={BATCH_TIME} {trainer.netG.dtype}, "
          f"{when}: {ms:.3f} ms/step (mean of 20 steps of the T=2000 "
          f"chain)", flush=True)
    return ms


@phase("timing")
def timing_phase(torch, trainer):
    """The 16->128 serving step, first before any torch.profiler run
    of the process (the path's reading), then with a profiler window (busy
    share, launches) and again after it; then K1, K2 and K4 at its shapes
    against their plain versions."""
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    step_ms = _serving_step_ms(torch, trainer, "before any profiler")
    ips = BATCH_TIME / (2000 * step_ms / 1000)
    print(f"  2000-step throughput extrapolated {ips:.4f} img/s", flush=True)
    _mfu(CONFIG, BATCH_TIME, step_ms)
    with torch.inference_mode():  # device launches and busy share
        _profile_steps(torch, _serving_step(torch, trainer, 3), 2)
    _serving_step_ms(torch, trainer, "after a profiler window")
    g = torch.Generator(device="cuda").manual_seed(3)
    dt, cl = torch.bfloat16, torch.channels_last
    times = {}

    def pair(kernel, label, fn, plain):
        ms, pms = _time_ms(torch, fn), _time_ms(torch, plain)
        times.setdefault(kernel, (ms, pms))
        print(f"  {kernel} {label} bf16: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms", flush=True)

    for cin, cout, hw in [(64, 64, 128), (256, 256, 32), (1024, 512, 8)]:
        args, kw = _k1_inputs(torch, g, BATCH_TIME, cin, cout, hw, dt, True)
        pair("gn_silu_conv3x3", f"{BATCH_TIME}x{cin}x{hw}x{hw}->{cout}",
             lambda: conv_fused.gn_silu_conv3x3(*args, **kw),
             lambda: conv_fused.gn_silu_conv3x3_plain(*args, **kw))
    for c, hw in K2_SERVING:
        x = torch.randn(BATCH_TIME, c, hw, hw, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        gw, gb = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        pair("group_norm", f"{BATCH_TIME}x{c}x{hw}x{hw}",
             lambda: groupnorm.group_norm(x, gw, gb, 32, swish=False),
             lambda: groupnorm.group_norm_plain(x, gw, gb, 32, swish=False))
    for seq, d in K4_SHAPES:
        q, k, v = (torch.randn(BATCH_TIME, seq, d, device="cuda",
                               generator=g).to(dt) for _ in range(3))
        pair("flash_attention_fwd", f"{BATCH_TIME}x{seq}x{d}",
             lambda: attention.attention(q, k, v, d ** -0.5),
             lambda: attention.attention_plain(q, k, v, d ** -0.5))
    return times

# ------------------------------------------------------- the 64->512 slice


@phase("K3 statistics")
def k3_phase(torch, errs):
    """K3 against float64 sums and gn_stats_plain; the statistics route of
    group_norm against group_norm_plain, forward and input gradients."""
    from sr3_tpu_torch.ops import groupnorm

    g = torch.Generator(device="cuda").manual_seed(10)
    failures = []
    for config in (CONFIG_512, CONFIG_1024):
        missing = set(k3_shapes(torch, config)) - set(K3_SHAPES)
        if missing:
            failures.append(f"K3 shapes of {os.path.basename(config)} not "
                            f"checked: {sorted(missing)}")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, c, h, w in K3_SHAPES + K3_LARGE:
            label = f"{b}x{c}x{h}x{w}"
            x = 3 * torch.randn(b, c, h, w, device="cuda", generator=g) + 1
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            n = groupnorm.stats_counter.n
            s1, s2 = groupnorm.gn_stats(x)
            p1, p2 = groupnorm.gn_stats_plain(x)
            torch.cuda.synchronize()
            if groupnorm.stats_counter.n != n + 1:
                failures.append(f"gn_stats {label} did not launch once")
            # float64 sums an image at a time (1 GB of float64 at most)
            r1, r2, sabs = (torch.empty(b, c, dtype=torch.float64,
                                        device="cuda") for _ in range(3))
            for i in range(b):
                xd = x[i].double()
                r1[i], r2[i] = xd.sum(dim=(1, 2)), xd.square().sum(dim=(1, 2))
                sabs[i] = xd.abs().sum(dim=(1, 2))
                del xd
            scales = (sabs, r2)
            e = errs.setdefault("gn_stats", {"max_abs_err": 0.0,
                                             "max_rel_err": 0.0, "checks": 0})
            for name, got, plain, ref, sc in (("s1", s1, p1, r1, scales[0]),
                                              ("s2", s2, p2, r2, scales[1])):
                absd = (got.double() - ref).abs()
                rel = (absd / sc).max().item()
                rel_plain = ((got.double() - plain.double()).abs()
                             / sc).max().item()
                e["max_abs_err"] = max(e["max_abs_err"], absd.max().item())
                e["max_rel_err"] = max(e["max_rel_err"], rel)
                e["checks"] += 1
                ok = rel <= K3_TOL and rel_plain <= K3_TOL
                print(f"  gn_stats {dn} {label} {name}: vs float64 rel {rel:.3e}"
                      f" (abs {absd.max().item():.3e}), vs plain rel "
                      f"{rel_plain:.3e} tol {K3_TOL:g} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    failures.append(f"gn_stats {dn} {label} {name}")
            if (b, c, h, w) in K3_LARGE:
                del x
                torch.cuda.empty_cache()
                continue
            wt = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
            bs = 0.1 * torch.randn(c, device="cuda", generator=g)
            n = groupnorm.stats_counter.n
            check(torch, {}, failures, "group_norm", dn,
                  f"{label} statistics route (G=16)",
                  groupnorm.group_norm(x, wt, bs, 16, swish=True),
                  groupnorm.group_norm_plain(x, wt, bs, 16, swish=True))
            if groupnorm.stats_counter.n != n + 1:
                failures.append(f"group_norm {label} did not take the "
                                f"statistics route")
            grads = function_grads(
                torch, lambda f, t: f(*t, 16, swish=True),
                groupnorm.group_norm, groupnorm.group_norm_plain, [x, wt, bs])
            for i, (got, ref) in enumerate(zip(*grads)):
                check_grad(torch, failures, f"group_norm route {label}", dn, i,
                           got, ref)
    if failures:
        raise AssertionError(f"K3 disagrees with its plain version: "
                             f"{failures}")


@phase("long-sequence attention")
def long_attention_phase(torch, errs):
    """K4 with its logsumexp, K5 and K6 against the plain versions at the
    64->512 path's sequence lengths and at 16384 tokens."""
    from sr3_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(11)
    failures, checked, checked_bwd = [], set(), set()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for bh, seq, d in LONG_SHAPES:
            q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g)
                       .to(dtype) for _ in range(3))
            gr = torch.randn(bh, seq, d, device="cuda", generator=g)
            attention.bf16_tile_launches(reset=True)
            o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
            label = f"{bh}x{seq}x{d}" + k4_classes(checked)
            scale = d ** -0.5
            ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, scale)
            check(torch, errs, failures, "flash_attention_fwd", dn,
                  label + " with lse: o", o, ref_o)
            check(torch, errs, failures, "flash_attention_fwd", dn,
                  label + " with lse: lse", lse, ref_lse,
                  tol=TOL[dn]["flash_attention_lse"])
            del ref_o, ref_lse
            dsum = (gr * o).sum(-1)
            attention.bwd_tile_launches(reset=True)
            dq, dk, dv = attention.attention_bwd(q, k, v, gr, lse, dsum, scale)
            label += bwd_classes(checked_bwd)
            rq, rk, rv = attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                                       scale)
            check(torch, errs, failures, "flash_attention_bwd_dkv", dn,
                  label + ": dk", dk, rk)
            check(torch, errs, failures, "flash_attention_bwd_dkv", dn,
                  label + ": dv", dv, rv)
            check(torch, errs, failures, "flash_attention_bwd_dq", dn,
                  label + ": dq", dq, rq)
            del rq, rk, rv
            torch.cuda.empty_cache()
    # the K4 autograd Function (K4 with lse, then K5 and K6) in bf16 at the
    # long shapes, against autograd of the plain version
    for bh, seq, d in (LONG_SHAPES[0], LONG_SHAPES[2]):
        inputs = [torch.randn(bh, seq, d, device="cuda", generator=g)
                  .to(torch.bfloat16) for _ in range(3)]
        attention.bwd_tile_launches(reset=True)
        grads = function_grads(torch, lambda f, t: f(*t, d ** -0.5),
                               attention.attention, attention.attention_plain,
                               inputs)
        bwd_classes(checked_bwd)
        for i, (got, ref) in enumerate(zip(*grads)):
            check_grad(torch, failures, f"attention {bh}x{seq}x{d}",
                       "bfloat16", i, got, ref)
        del inputs, grads
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"long-sequence attention disagrees with the "
                             f"plain versions: {failures}")
    return checked, checked_bwd


def k3_shapes(torch, config):
    """(B, C, H, W) of each K3 call of one training forward of ``config``'s
    model at its train batch, read off a meta-device copy: the dropout Block
    (block2) of every ResnetBlock on a map of STATS_MIN_HW pixels or
    more."""
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.unet import Downsample, Upsample
    from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW

    opt = _load_opt(config=config)
    b = opt["datasets"]["train"]["batch_size"]
    net = define_G(opt, device="meta").denoise_fn
    res, out = net.image_size, []
    for layer in (*net.downs[1:], *net.mid, *net.ups):
        if isinstance(layer, Downsample):
            res //= 2
        elif isinstance(layer, Upsample):
            res *= 2
        elif layer.res_block.block2.dropout and res * res >= STATS_MIN_HW:
            c = layer.res_block.block2.block[3].weight.shape[1]
            out.append((b, c, res, res))
    return out


def k3_sites(opt):
    """Blocks of one UNet forward whose GroupNorm takes the statistics
    route: the dropout Block (block2) of every ResnetBlock on a map of
    STATS_MIN_HW pixels or more -- res_blocks per level on the way down,
    res_blocks + 1 on the way up."""
    from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW

    unet = opt["model"]["unet"]
    res, n = opt["model"]["diffusion"]["image_size"], 0
    for _ in unet["channel_multiplier"]:
        if res * res >= STATS_MIN_HW:
            n += 2 * unet["res_blocks"] + 1
        res //= 2
    return n


@phase("64->512 training path")
def training_512_phase(torch):
    """TRAIN_STEPS_512 full-width steps through train_loop at the config's
    batch 2, bf16, remat on; every kernel launched, K3 and K4-K6 as often
    as the model says."""
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params
    from sr3_tpu_torch.models.unet import SelfAttention

    trainer, opt = _train_trainer(torch, CONFIG_512, TRAIN_STEPS_512)
    b = opt["datasets"]["train"]["batch_size"]
    unet = opt["model"]["unet"]
    net = trainer.netG
    n_attn = sum(isinstance(m, SelfAttention) for m in net.modules())
    sites = k3_sites(opt)
    print(f"  train-phase Trainer: {count_params(net):,d} params float32, "
          f"compute {net.dtype}, batch {b}, dropout {unet['dropout']}, remat "
          f"{net.remat}, {n_attn} attention calls and {sites} statistics-"
          f"route GroupNorms per forward", flush=True)
    if net.dtype != torch.bfloat16 or b != 2 or not net.remat \
            or unet["dropout"] != 0.2:
        raise AssertionError("the 64->512 path trains at batch 2, bf16, "
                             "dropout 0.2, remat on")
    loader = _synthetic_batches(np, TRAIN_STEPS_512, b, seed=12, lr_size=64)
    launches = _train_loop_checked(torch, trainer, opt, loader,
                                   ONE_DEVICE_KERNELS)
    _remat_launches_checked(launches, sites, n_attn, TRAIN_STEPS_512)
    _gn_bwd_launches_checked(torch, launches, CONFIG_512, TRAIN_STEPS_512)
    return trainer, launches


def _remat_launches_checked(launches, sites, n_attn, steps):
    """Fail unless ``steps`` remat train steps launched K3 and K4-K6 as
    often as the model's ``sites`` statistics-route GroupNorms and
    ``n_attn`` attention calls a forward say: remat runs every block's
    forward twice (once more in the backward)."""
    expect = {"gn_stats": 2 * sites * steps,
              "flash_attention_fwd": 2 * n_attn * steps,
              "flash_attention_bwd_dkv": n_attn * steps,
              "flash_attention_bwd_dq": n_attn * steps}
    wrong = {k: (launches[k], v) for k, v in expect.items()
             if launches[k] != v}
    print(f"  expected launches {expect}", flush=True)
    if wrong:
        raise AssertionError(f"launches (got, expected): {wrong}")


@phase("64->512 training gradients")
def grad_check_512_phase(torch):
    """Float32, batch 1, remat on: kernels against the plain ops swapped
    into the UNet (GRAD_TOL); then remat on against remat off with the same
    draws (REMAT_TOL)."""
    net, loss_and_grads = _train_case(torch, CONFIG_512, 512, seed=13)
    _kernels_vs_plain(torch, loss_and_grads, ONE_DEVICE_KERNELS,
                      " remat on")
    # cuDNN's default conv backward sums with atomics, in an order that
    # changes from run to run; its deterministic algorithms keep the two
    # runs comparable
    torch.backends.cudnn.deterministic = True
    try:
        kernels = loss_and_grads()
        net.remat = False
        no_remat = loss_and_grads()
    finally:
        net.remat = True
        torch.backends.cudnn.deterministic = False
    loss_rel, worst, worst_rel = _compare_grads(kernels, no_remat)
    print(f"  float32 batch 1, kernels, deterministic cuDNN, remat on vs off: loss "
          f"{kernels[0]:.6f} vs {no_remat[0]:.6f} (rel {loss_rel:.3e}); worst "
          f"gradient {worst}: rel {worst_rel:.3e}; tol {REMAT_TOL:g}",
          flush=True)
    if not (loss_rel <= REMAT_TOL and worst_rel <= REMAT_TOL):
        raise AssertionError(f"remat changes the gradients: loss {loss_rel}, "
                             f"{worst} {worst_rel}")


@phase("64->512 bf16 attention gradients")
def bf16_attention_grad_phase(torch):
    """bf16, batch 1, remat on: the loss and the gradient of every attention
    parameter with K4-K6 (the tensor-core routes of K4 and K5) against the
    same bf16 model with attention_plain swapped into the UNet module; the
    other kernels run on both sides, under cuDNN's deterministic algorithms.
    Within FORWARD_TOL_BF16."""
    from sr3_tpu_torch.models import unet as unet_module
    from sr3_tpu_torch.ops import attention

    _, loss_and_grads = _train_case(torch, CONFIG_512, 512, seed=18,
                                    dtype="bfloat16")
    names = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    torch.backends.cudnn.deterministic = True
    try:
        for c in counters():
            c.n = 0
        kernels = loss_and_grads()
        launches = launches_of(names)
        unet_module.attention = attention.attention_plain
        try:
            plain = loss_and_grads()
        finally:
            unet_module.attention = attention.attention
    finally:
        torch.backends.cudnn.deterministic = False
    attn = lambda r: (r[0], {n: gr for n, gr in r[1].items() if ".attn." in n})
    kernels, plain = attn(kernels), attn(plain)
    loss_rel, worst, worst_rel = _compare_grads(kernels, plain)
    print(f"  bf16 batch 1 remat on, kernels {launches} vs attention_plain: "
          f"loss {kernels[0]:.6f} vs {plain[0]:.6f} (rel {loss_rel:.3e}); "
          f"worst of {len(plain[1])} attention-parameter gradients {worst}: "
          f"rel {worst_rel:.3e}; tol {FORWARD_TOL_BF16:g}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"an attention kernel did not launch: {launches}")
    if not (loss_rel <= FORWARD_TOL_BF16 and worst_rel <= FORWARD_TOL_BF16):
        raise AssertionError(f"bf16 attention gradients disagree: loss "
                             f"{loss_rel}, {worst} {worst_rel}")


@phase("64->512 serving path")
def serving_512_phase(torch):
    """GroupedEvaluator.run_sr on 2 images, T=10 val schedule, 512^2 bf16;
    then the median ms of one batch-8 p_sample_step (the config's val
    batch) and a torch.profiler window over it."""
    import numpy as np
    import torch.nn.functional as F

    from sr3_tpu_torch.models.diffusion import _snapshot_count
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(val_steps=10, config=CONFIG_512)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    g = torch.Generator().manual_seed(14)
    lr = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    sr = F.interpolate(lr, size=(512, 512), mode="bicubic",
                       align_corners=False).clamp(-1, 1)
    items = [{"SR": sr[i].permute(1, 2, 0).numpy(), "Index": i}
             for i in range(2)]
    ev = GroupedEvaluator(trainer, group_size=2)
    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    outs = list(ev.run_sr(iter(items), continous=True))
    dt = time.perf_counter() - t0
    launches = forward_launches()
    n_snap, _ = _snapshot_count(trainer.sched.num_timesteps)
    for item, frames in outs:
        if frames.shape != (1 + n_snap, 512, 512, 3):
            raise AssertionError(f"frames shape {frames.shape}")
        if not np.isfinite(frames).all():
            raise AssertionError("non-finite frames")
    print(f"  run_sr(continous=True) {trainer.netG.dtype}: {len(outs)} images, "
          f"frames {outs[0][1].shape}, T={trainer.sched.num_timesteps}, "
          f"{dt:.2f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")

    from sr3_tpu_torch.models.schedule import make_schedule

    bt = opt["datasets"]["val"]["batch_size"]
    sched = make_schedule(opt["model"]["beta_schedule"]["val"] | {
        "n_timestep": 2000}, "cuda")
    net = trainer._eval_params()
    gd = torch.Generator(device="cuda").manual_seed(15)
    cond = torch.rand(bt, 3, 512, 512, device="cuda", generator=gd) * 2 - 1
    img = torch.randn(bt, 3, 512, 512, device="cuda", generator=gd)
    steps = iter(range(1999, -1, -1))
    step = lambda: trainer.diffusion.p_sample_step(
        net, sched, img, next(steps), cond, generator=gd)
    # the least time the step's GroupNorm statistics could take: each K1
    # input and each K2 input (the attention pre-norms) read once
    stats_bytes = 2 * bt * (
        sum(cin * h * h for cin, _, h in k1_sites(torch, CONFIG_512))
        + sum(c * h * h for c, h, _ in k2_sites(torch, CONFIG_512,
                                                 training=False)))
    print(f"  GroupNorm statistics of the step read {stats_bytes / 1e9:.3f} "
          f"GB: bound {1000 * stats_bytes / PEAK_BYTES:.3f} ms at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s", flush=True)
    with torch.inference_mode():
        ms = _time_each(torch, step, 10)
        step_ms = float(np.median(ms))
        print(f"  UNet step (p_sample_step) B={bt} 512^2 {net.dtype}: median "
              f"{step_ms:.3f} ms/step over {len(ms)} steps (min "
              f"{min(ms):.3f}, max {max(ms):.3f}); 2000-step throughput "
              f"extrapolated {bt / (2000 * step_ms / 1000):.5f} img/s",
              flush=True)
        _mfu(CONFIG_512, bt, step_ms)
        _profile_steps(torch, step, PROFILE_STEPS_512)
    return launches


def _time_each(torch, fn, n, warmup=2):
    """CUDA-event milliseconds of each of n calls, after warm-up calls."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return ms


def _device_events(torch, prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_busy(torch, prof):
    """Union of the profiled device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(torch, prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1000


def _profile_steps(torch, step, n, unet_steps=1):
    """A torch.profiler window over n calls of ``step``: wall and device
    busy ms per step (union of device intervals) and device time by kernel,
    printed; with ``unet_steps`` (the UNet forwards of one call, as in a
    whole chain) also the device ops per UNet forward. Returns (wall, busy)
    ms per step."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000 / n
    busy = _device_busy(torch, prof) / n
    by_kernel = {}
    for e in _device_events(torch, prof):
        t, k = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    n_dev = sum(k for _, k in by_kernel.values())
    print(f"  profiled {n} steps: wall {wall:.1f} ms/step, device busy "
          f"{busy:.1f} ms/step ({100 * busy / wall:.1f}%), {n_dev / n:.0f} "
          f"device ops/step"
          + (f" ({n_dev / n / unet_steps:.1f} per UNet forward)"
             if unet_steps > 1 else "")
          + "; device time per step by kernel:", flush=True)
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (t, k) in rows[:16]:
        print(f"    {t / 1000 / n:9.3f} ms  {k / n:7.1f}/step  {name[:90]}",
              flush=True)
    rest = sum(t for _, (t, _) in rows[16:]) / 1000 / n
    print(f"    {rest:9.3f} ms  the other {len(rows) - 16} kernels",
          flush=True)
    gn = [(t, k) for name, (t, k) in rows if any(f in name for f in GN_KERNELS)]
    print(f"  GroupNorm kernels (K1's statistics launch, K2): "
          f"{sum(t for t, _ in gn) / 1000 / n:.3f} ms/step in "
          f"{sum(k for _, k in gn) / n:.0f} launches/step", flush=True)
    return wall, busy


@phase("64->512 training timing")
def train_timing_512_phase(torch, trainer):
    """Median train step (CUDA events), train img/s and peak memory at
    batch 2; then a torch.profiler window: device time by op, launches and
    the device busy share of the step."""
    import numpy as np

    b = trainer.opt["datasets"]["train"]["batch_size"]
    trainer.feed_data(_synthetic_batches(np, 1, b, seed=16, lr_size=64)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_each(torch, trainer.optimize_parameters, TIME_STEPS_512)
    step_ms = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train step B={b} {trainer.netG.dtype} remat: median "
          f"{step_ms:.3f} ms/step over {TIME_STEPS_512} steps (min "
          f"{min(ms):.3f}, max {max(ms):.3f}); {b / (step_ms / 1000):.4f} "
          f"train img/s; peak device memory {peak:.2f} GiB", flush=True)
    _mfu(CONFIG_512, b, step_ms, train=True)
    _profile_steps(torch, trainer.optimize_parameters, PROFILE_STEPS_512)
    return step_ms


def _sdpa_backend(torch, fn):
    """The aten op that one SDPA call dispatches to (its backend)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.name.startswith("aten::_scaled_dot_product")})


def _device_by_kernel(torch, fn, n=5, tries=4, required=True):
    """{kernel name: (device ms per launch, launches per call)} of ``fn``
    from a torch.profiler window over n calls, after one warm-up. The
    profiler on this card drops records now and then, more of them late in
    a long process (whole windows there): a window whose records do not
    come to a whole number per call is taken again, up to ``tries`` times
    (the fullest is kept); a launch's time is the mean over the records
    kept, its launches per call rounded and at least 1 for a kernel seen.
    When no window kept a record, it raises (``required``) or returns
    None: never a count that was not seen."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    best = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)  # let the tracer deliver the window's records
        got = {}
        for e in _device_events(torch, prof):
            t, k = got.get(e.name, (0.0, 0))
            got[e.name] = (t + e.time_range.elapsed_us() / 1000, k + 1)
        if best is None or sum(k for _, k in got.values()) > \
                sum(k for _, k in best.values()):
            best = got
        if got and all(k % n == 0 for _, k in got.values()):
            break
    if not best:
        if required:
            raise AssertionError(f"the profiler kept no record of the "
                                 f"call's kernels in {tries} windows")
        return None
    return {name: (t / k, max(1, round(k / n)))
            for name, (t, k) in best.items()}


def _call_ms(by):
    """Device ms per call from _device_by_kernel's result."""
    return sum(ms * k for ms, k in by.values())


_SPIN = {}  # spin-kernel clock cycles per ms, measured at first use


def _device_ms(torch, fn, n=20, required=False):
    """Device ms per call of ``fn``, without the profiler: n calls queued
    behind a spin kernel (``torch.cuda._sleep``) that keeps the card busy
    until the host has enqueued them all, then CUDA events around the n
    calls time the card alone, without the host's launch gaps. The spin
    doubles (from 20 ms) until the host's enqueue takes under 80% of it;
    when it never does (a call that waits for the card), it raises
    (``required``) or returns None (not measured)."""
    if "per_ms" not in _SPIN:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _SPIN["per_ms"] = 10 ** 7 / a.elapsed_time(b)
    fn()
    spin_ms = 20.0
    for _ in range(6):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _SPIN["per_ms"]))
        h0 = time.perf_counter()
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        host_ms = 1000 * (time.perf_counter() - h0)
        e1.synchronize()
        if host_ms < 0.8 * spin_ms:
            return e0.elapsed_time(e1) / n
        spin_ms *= 2
    if required:
        raise AssertionError(f"the host took {host_ms:.1f} ms to enqueue {n} "
                             f"calls, longer than a {spin_ms / 2:.0f} ms spin")
    return None


def _show(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _short(name):
    """A kernel's name without its return type, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base, lt, args = name.split("(")[0].partition("<")
    return (base.split("::")[-1] + lt + args)[:60]


# the port's GroupNorm kernels: K1's statistics launch and K2
GN_KERNELS = ("gn_stats_kernel<", "gn_cluster_kernel<")


@phase("GroupNorm launches")
def gn_launch_phase(torch):
    """The C library's plan at every K2 site (bf16, train batch and batch
    8: each must keep its slice resident); K2 in one device launch per call
    and K1 in two (its statistics, its conv), each bit-identical over two
    calls on the same input; K1's ticket counters back at 0."""
    from sr3_tpu_torch.ops import conv_fused, groupnorm

    failures = []
    for config, sites in ((CONFIG, K2_SITES), (CONFIG_512, K2_SITES_512),
                          (CONFIG_1024, K2_SITES_1024)):
        opt = _load_opt(config=config)
        groups = opt["model"]["unet"].get("norm_groups") or 32
        for b in (opt["datasets"]["train"]["batch_size"], BATCH_TIME):
            for c, h, _ in sites:
                p = groupnorm.gn_plan((b, c, h, h), groups, torch.bfloat16)
                print(f"  K2 plan {b}x{c}x{h}x{h} G={groups} bf16: cluster "
                      f"{p['splits']} x {b * c // p['cb']} ({p['cb']} "
                      f"channels, {p['per']} pixels, {p['threads']} threads "
                      f"a block), resident {p['resident']}, "
                      f"{p['smem_bytes']} B shared memory", flush=True)
                if not p["resident"]:
                    failures.append(f"K2 {b}x{c}x{h}x{h} not resident")
    g = torch.Generator(device="cuda").manual_seed(19)
    cases = []
    for b, c, h, groups, swish, dtype in (
            (2, 512, 64, 16, False, torch.bfloat16),
            (4, 64, 128, 32, True, torch.bfloat16),
            (2, 512, 64, 16, True, torch.float32),
            (2, 96, 10, 32, True, torch.bfloat16)):
        x = (3 * torch.randn(b, c, h, h, device="cuda", generator=g) + 1)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        gw = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
        gb = 0.1 * torch.randn(c, device="cuda", generator=g)
        fn = (lambda x=x, gw=gw, gb=gb, groups=groups, swish=swish:
              groupnorm.group_norm(x, gw, gb, groups, swish=swish))
        cases.append(("K2", f"{b}x{c}x{h}x{h} G={groups}"
                      + (" +silu" if swish else "") + f" {dtype}", fn, 1))
    for b, cin, cout, hw in ((2, 64, 64, 512), (8, 1024, 512, 8)):
        args, kw = _k1_inputs(torch, g, b, cin, cout, hw, torch.bfloat16,
                              True)
        p = groupnorm.gn_plan((b, cin, hw, hw), 32, torch.bfloat16, "stats")
        fn = lambda args=args, kw=kw: conv_fused.gn_silu_conv3x3(*args, **kw)
        cases.append(("K1", f"{b}x{cin}x{hw}x{hw}->{cout} +film bf16, "
                      f"statistics in {p['splits']} blocks a slice", fn, 2))
    for name, label, fn, want in cases:
        a, b = fn(), fn()
        torch.cuda.synchronize()
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        same = torch.equal(a.view(bits), b.view(bits))
        by = _device_by_kernel(torch, fn, n=3)
        launches = sum(k for _, k in by.values())
        print(f"  {name} {label}: {launches} device launches a call ("
              + ", ".join(f"{_short(k)} {ms:.4f} ms x{n}"
                          for k, (ms, n) in by.items())
              + f"); two calls bit-identical: {same}", flush=True)
        if launches != want or not same:
            failures.append(f"{name} {label}: {launches} launches (want "
                            f"{want}), bit-identical {same}")
    for (device, stream), tickets in groupnorm._tickets.items():
        busy = int(torch.count_nonzero(tickets))
        print(f"  K1 ticket counters on {device} stream {stream:#x}: "
              f"{tickets.numel()}, "
              f"{busy} not 0", flush=True)
        if busy:
            failures.append(f"{busy} ticket counters left non-zero")
    if failures:
        raise AssertionError(f"GroupNorm launches: {failures}")


def _time_entry(torch, name, shape, fn, plain, library, flops, nbytes):
    """One kernel call ``fn`` beside its plain version and the library call
    (None where there is none): CUDA-event ms around single calls and the
    device ms of queued calls (``_device_ms``; the kernel's must be
    measured) of each; the kernel's device launches a call and their split
    by kernel from the profiler (None when it kept no record: not
    measured); and the least time the card could take for ``flops`` bf16
    operations and ``nbytes`` moved (bound_ms). Printed; returns the
    record."""
    fns = {"": fn, "plain_": plain, "library_": library}
    t = {}
    for key, f in fns.items():
        t[key + "ms"] = None if f is None else _time_ms(torch, f, n=5)
        t[key + "device_ms"] = None if f is None else \
            _device_ms(torch, f, required=not key)
    kernels = _device_by_kernel(torch, fn, required=False)
    t["device_launches_per_call"] = None if kernels is None else \
        sum(k for _, k in kernels.values())
    t["profiler_device_ms"] = None if kernels is None else _call_ms(kernels)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = 1000 * max(t_ops, t_bytes)
    by = "operations" if t_ops > t_bytes else "bytes"
    print(f"  {name} {shape}: device kernels a call (profiler): " + (
        "not measured (no record kept)" if kernels is None else ", ".join(
            f"{_short(k)} {ms:.4f} ms x{n}"
            for k, (ms, n) in kernels.items())), flush=True)
    show = lambda k: "none" if fns[k.removesuffix("device_ms")
                                   .removesuffix("ms")] is None \
        else _show(t[k])
    print(f"  {name} {shape} bf16, ms (events / device): kernel "
          f"{show('ms')} / {show('device_ms')}, plain {show('plain_ms')} / "
          f"{show('plain_device_ms')}, library {show('library_ms')} / "
          f"{show('library_device_ms')}; bound {bound_ms:.4f} ({by}; "
          f"kernel device time {t['device_ms'] / bound_ms:.1f}x)", flush=True)
    return {**t, "bound_ms": bound_ms, "bound_by": by, "shape": shape}


@phase("ADM 128->512")
def adm_phase(torch):
    """One batch-8 bf16 forward of guided-diffusion's 128->512 upsampler at
    its published widths, counters zeroed just before it: K1 once at each
    site of the benchmark reference's list, the scale-shift route at each
    ResBlock's out_layers. Then K1 at K1_ADM timed as phase 17. Returns
    the forward's launches by kernel and the timings."""
    from sr3_tpu_torch.models import adm_unet
    from sr3_tpu_torch.ops import conv_fused

    opt = _adm_opt()
    sites = _adm_reference().k1_sites(opt, 8)
    if (len(sites), sum(s["post"] for s in sites)) != \
            (ADM_K1_SITES, ADM_SCALE_SHIFT_SITES):
        raise AssertionError(f"the reference lists {len(sites)} K1 sites, "
                             f"{sum(s['post'] for s in sites)} with the "
                             f"scale-shift; expected {ADM_K1_SITES}, "
                             f"{ADM_SCALE_SHIFT_SITES}")
    torch.manual_seed(0)
    with torch.device("cuda"):
        net = adm_unet.adm_from_opt(opt["model"], torch.bfloat16)
    net = net.to(memory_format=torch.channels_last).eval()
    g = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(8, 3, 512, 512, device="cuda", generator=g)
    low = torch.rand(8, 3, 128, 128, device="cuda", generator=g) * 2 - 1
    t = torch.randint(0, 1000, (8,), device="cuda", generator=g)
    y = torch.randint(0, 1000, (8,), device="cuda", generator=g)
    for c in counters() + [adm_unet.scale_shift_blocks]:
        c.n = 0
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = net(x, t, low, y)
    torch.cuda.synchronize()
    launches = launches_of(KERNELS)
    scale_shift = adm_unet.scale_shift_blocks.n
    print(f"  batch-8 bf16 forward: launches {launches}, block.scale_shift "
          f"{scale_shift}, peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    if (launches["gn_silu_conv3x3"], scale_shift) != \
            (ADM_K1_SITES, ADM_SCALE_SHIFT_SITES):
        raise AssertionError(f"K1 launched {launches['gn_silu_conv3x3']} "
                             f"times, {scale_shift} with the scale-shift; "
                             f"the reference lists {ADM_K1_SITES}, "
                             f"{ADM_SCALE_SHIFT_SITES}")
    if tuple(out.shape) != (8, 6, 512, 512) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"ADM output {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    del net, x, low, out
    torch.cuda.empty_cache()
    timings = []
    for case in K1_ADM:
        args, kw = _k1_adm_inputs(torch, g, torch.bfloat16, *case)
        timings.append(_time_k1(torch, case[:4], args, kw,
                                " +scale-shift+residual" if case[4] else ""))
        del args, kw
    return launches, timings


def _time_k1(torch, case, args, kw, what):
    """K1 at one (b, Cin, Cout, H=W) ``case`` timed by _time_entry beside
    its plain version, cuDNN's bare conv3x3 on the same map and weight as
    library_ms (the conv alone, without GroupNorm, SiLU, affine or
    residual: a yardstick the port never calls) and its bound (bytes of x,
    the weight, y and the residual where given; operations), labelled with
    the bf16 class it launched."""
    import torch.nn.functional as F

    from sr3_tpu_torch.ops import conv_fused

    b, cin, cout, hw = case
    n = b * hw * hw
    x, w, cb = args[0], args[3], args[4].to(args[0].dtype)
    conv_fused.bf16_tile_launches(reset=True)
    conv_fused.gn_silu_conv3x3(*args, **kw)
    cls = ",".join(t for t, k in conv_fused.bf16_tile_launches().items() if k)
    out = _time_entry(
        torch, "gn_silu_conv3x3", f"{b}x{cin}x{hw}x{hw}->{cout}{what} {cls}",
        lambda: conv_fused.gn_silu_conv3x3(*args, **kw),
        lambda: conv_fused.gn_silu_conv3x3_plain(*args, **kw),
        lambda: F.conv2d(x, w, cb, padding=1), 2 * n * cin * cout * 9,
        2 * (n * cin + n * cout * (2 if "residual" in kw else 1)
             + cout * cin * 9))
    return {**out, "class": cls}


@phase("K1 class timing")
def k1_class_timing_phase(torch):
    """K1 (bf16, FiLM and residual) at K1_TIMED, the SR3 serving cells'
    class shapes, timed as phase 42's: ms, bound_ms, cuDNN's bare conv as
    library_ms, the class launched."""
    g = torch.Generator(device="cuda").manual_seed(20)
    timings = []
    for case in K1_TIMED:
        b, cin, cout, hw = case
        args, kw = _k1_inputs(torch, g, b, cin, cout, hw, torch.bfloat16,
                              True)
        timings.append(_time_k1(torch, case, args, kw, " +film+residual"))
        del args, kw
        torch.cuda.empty_cache()
    return timings


@phase("64->512 kernel timing")
def kernel_timing_512_phase(torch):
    """One round of each kernel at a 64->512 training shape (bf16, batch 2)
    beside its plain version and, where one PyTorch call computes the same
    function, that call (library_ms, never called by the port); and the
    least time the card could take for the same work (bound_ms)."""
    import torch.nn.functional as F

    from sr3_tpu_torch.ops import conv_fused, groupnorm

    g = torch.Generator(device="cuda").manual_seed(17)
    dt, cl = torch.bfloat16, torch.channels_last
    out = {}

    def entry(name, shape, *args):
        out.setdefault(name, _time_entry(torch, name, shape, *args))

    b = 2
    args, kw = _k1_inputs(torch, g, b, 64, 64, 512, dt, True)
    hw = 512 * 512
    entry("gn_silu_conv3x3", f"{b}x64x512x512->64 +film+residual",
          lambda: conv_fused.gn_silu_conv3x3(*args, **kw),
          lambda: conv_fused.gn_silu_conv3x3_plain(*args, **kw), None,
          2 * b * hw * 64 * 64 * 9, 2 * (3 * b * hw * 64 + 64 * 64 * 9))
    # cuDNN's conv3x3 alone on the same map and weight: not the same
    # function (no GroupNorm, SiLU, FiLM or residual), so not library_ms
    x, w, cb = args[0], args[3], args[4].to(dt)
    conv = lambda: F.conv2d(x, w, cb, padding=1)
    alone = {"cudnn_conv_alone_ms": _time_ms(torch, conv, n=5),
             "cudnn_conv_alone_device_ms": _device_ms(torch, conv)}
    out["gn_silu_conv3x3"].update(alone)
    print(f"  cuDNN F.conv2d alone (the conv only, bf16 channels_last) "
          f"{b}x64x512x512->64, ms (events / device): "
          f"{alone['cudnn_conv_alone_ms']:.4f} / "
          f"{_show(alone['cudnn_conv_alone_device_ms'])}", flush=True)
    del args, kw, x, w
    x = torch.randn(b, 512, 64, 64, device="cuda", generator=g)
    x = x.to(dt).contiguous(memory_format=cl)
    gw = 1 + 0.2 * torch.randn(512, device="cuda", generator=g)
    gb = 0.1 * torch.randn(512, device="cuda", generator=g)
    gw16, gb16 = gw.to(dt), gb.to(dt)
    entry("group_norm", f"{b}x512x64x64 swish off",
          lambda: groupnorm.group_norm(x, gw, gb, 16, swish=False),
          lambda: groupnorm.group_norm_plain(x, gw, gb, 16, swish=False),
          lambda: F.group_norm(x, 16, gw16, gb16, 1e-5),
          10 * x.numel(), 2 * 2 * x.numel())
    # the 16->128 training site (dropout Block, SiLU; library: F.group_norm
    # without the SiLU) and the 64->512 serving site
    for bb, c, hw, groups, swish in ((4, 64, 128, 32, True),
                                     (8, 512, 64, 16, False)):
        x = torch.randn(bb, c, hw, hw, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        gw = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
        gb = 0.1 * torch.randn(c, device="cuda", generator=g)
        gw16, gb16 = gw.to(dt), gb.to(dt)
        entry("group_norm", f"{bb}x{c}x{hw}x{hw} G={groups} swish "
              + ("on" if swish else "off"),
              lambda: groupnorm.group_norm(x, gw, gb, groups, swish=swish),
              lambda: groupnorm.group_norm_plain(x, gw, gb, groups,
                                                 swish=swish),
              lambda: F.group_norm(x, groups, gw16, gb16, 1e-5),
              (14 if swish else 10) * x.numel(), 2 * 2 * x.numel())
    for _, c, h, w in K3_SHAPES[:2]:
        x = torch.randn(b, c, h, w, device="cuda", generator=g)
        x = x.to(dt).contiguous(memory_format=cl)
        xf = x.float()
        entry("gn_stats", f"{b}x{c}x{h}x{w}",
              lambda: groupnorm.gn_stats(x),
              lambda: groupnorm.gn_stats_plain(x),
              lambda: torch.var_mean(xf, dim=(2, 3), correction=0),
              3 * x.numel(), 2 * x.numel() + 2 * 4 * b * c)
        del x, xf
    # the GroupNorm backward at the benchmark's training maps: K1's at
    # 16->128 (statistics from its activation mode), K2's (its own
    # statistics pass) and the 64->512 statistics route; least bytes x, dy
    # and dx, and x and act for the activation mode
    for bb, c, hw, groups, given in ((128, 192, 128, 32, True),
                                     (128, 64, 128, 32, False),
                                     (16, 64, 512, 16, True)):
        x, dy, gw, gb, _ = _gn_bwd_inputs(torch, g, dt, bb, c, hw, False)
        shape = f"{bb}x{c}x{hw}x{hw} G={groups} +silu"
        stats = None
        if given:
            _, stats = groupnorm.gn_silu_act(x, gw, gb, groups)
            entry("gn_silu_act", shape,
                  lambda: groupnorm.gn_silu_act(x, gw, gb, groups),
                  lambda: groupnorm.gn_silu_act_plain(x, gw, gb, groups),
                  None, 14 * x.numel(), 2 * 2 * x.numel())
        entry("gn_silu_bwd", shape + " statistics "
              + ("given" if given else "its own"),
              lambda: groupnorm.gn_silu_bwd(x, dy, gw, gb, groups,
                                            stats=stats),
              lambda: groupnorm.gn_silu_bwd_plain(x, dy, gw, gb, groups,
                                                  stats=stats),
              None, 30 * x.numel(), 3 * 2 * x.numel())
        del x, dy, stats
    for bh, seq, d in LONG_SHAPES:
        _attention_entries(torch, g, entry, bh, seq, d)
    return out


def _attention_entries(torch, g, entry, bh, seq, d):
    """Timing entries of K4 (with its logsumexp), K5 and K6 at one shape."""
    import torch.nn.functional as F

    from sr3_tpu_torch.ops import attention

    dt = torch.bfloat16
    q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g).to(dt)
               for _ in range(3))
    gr = torch.randn(bh, seq, d, device="cuda", generator=g)
    scale = d ** -0.5
    o, lse = attention.attention_fwd(q, k, v, scale)
    dsum = (gr * o).sum(-1)
    gr16 = gr.to(dt)  # K5's and K6's dO, as attention_bwd rounds it
    outs = [torch.empty_like(gr) for _ in range(3)]
    shape = f"{bh}x{seq}x{d}"
    mm = 2 * bh * seq * seq * d  # one (seq x seq x d) product
    qkv_bytes = 3 * 2 * q.numel()
    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    print(f"  SDPA at head_dim {d} runs: {_sdpa_backend(torch, sdpa)}",
          flush=True)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    lo = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    lg = gr.to(dt).unsqueeze(1)
    sdpa_bwd = lambda: torch.autograd.grad(lo, (ql, kl, vl), lg,
                                           retain_graph=True)
    try:
        sdpa_bwd()
    except RuntimeError as e:  # no SDPA backward at this head_dim
        print(f"  SDPA backward at head_dim {d}: {e}", flush=True)
        sdpa_bwd = None
    plain_bwd = lambda: attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                                      scale)
    entry("flash_attention_fwd", shape + " with lse",
          lambda: attention.attention_fwd(q, k, v, scale),
          lambda: attention.attention_fwd_plain(q, k, v, scale), sdpa,
          2 * mm, qkv_bytes + 4 * (q.numel() + bh * seq))
    entry("flash_attention_bwd_dkv", shape,
          lambda: attention._bwd_kernel(
              "sr3_flash_attention_bwd_dkv", attention.dkv_counter, q, k, v,
              gr16, lse, dsum, outs[1:], scale), plain_bwd, sdpa_bwd,
          4 * mm, qkv_bytes + 2 * gr16.numel() + 4 * 2 * bh * seq
          + 2 * 4 * q.numel())
    entry("flash_attention_bwd_dq", shape,
          lambda: attention._bwd_kernel(
              "sr3_flash_attention_bwd_dq", attention.dq_counter, q, k, v,
              gr16, lse, dsum, outs[:1], scale), plain_bwd, sdpa_bwd,
          3 * mm, qkv_bytes + 2 * gr16.numel() + 4 * 2 * bh * seq
          + 4 * q.numel())


# ------------------------------------------- the rest of the sampling surface


def _sr_items(torch, n, seed):
    """n seeded 16->128 val items, HWC float32 in [-1, 1]: LR, SR its
    bicubic upsampling (the condition), HR that plus noise."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    lr = torch.rand(n, 3, 16, 16, generator=g) * 2 - 1
    sr = F.interpolate(lr, size=(128, 128), mode="bicubic",
                       align_corners=False).clamp(-1, 1)
    hr = (sr + 0.1 * torch.randn(sr.shape, generator=g)).clamp(-1, 1)
    hwc = lambda t: t.permute(1, 2, 0).numpy()
    return [{"LR": hwc(lr[i]), "SR": hwc(sr[i]), "HR": hwc(hr[i]), "Index": i}
            for i in range(n)]


def _forward_vs_cpu(torch, config):
    """One float32 forward of ``config``'s full-width UNet (random seeded
    weights), batch 1 at its image size, on the card (kernels; counters
    zeroed just before, every forward kernel must launch) against the same
    weights on the CPU (plain versions), within FORWARD_TOL; conditioned on
    noise level 0.5 (sr3) or on t = 1999, the top of the schedule (ddpm).
    Returns the module on the card."""
    import copy

    from sr3_tpu_torch.models.networks import count_params, define_G

    gpu = define_G(_load_opt(dtype="float32", config=config), device="cuda",
                   seed=0).denoise_fn
    cpu = copy.deepcopy(gpu).cpu()
    g = torch.Generator().manual_seed(1)
    size = gpu.image_size
    x = torch.randn(1, gpu.in_channel, size, size, generator=g)
    cond = torch.tensor([1999.0 if gpu.cond_mode == "ddpm" else 0.5])
    for c in counters():
        c.n = 0
    with torch.inference_mode():
        out_gpu = gpu(x.cuda(), cond.cuda()).cpu()
        out_cpu = cpu(x, cond)
    rel, absd = rel_err(out_gpu, out_cpu)
    launches = forward_launches()
    print(f"  {os.path.basename(config)}: UNet(cond_mode={gpu.cond_mode}) "
          f"{count_params(gpu):,d} parameters, {gpu.in_channel} input "
          f"channels; forward B=1 float32 at condition {cond.item():g}, card "
          f"vs CPU: rel {rel:.3e} abs {absd:.3e} tol {FORWARD_TOL:g}; "
          f"launches {launches}", flush=True)
    if not (rel <= FORWARD_TOL and torch.isfinite(out_gpu).all()):
        raise AssertionError(f"full-width forward: rel {rel} > {FORWARD_TOL}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    return gpu


def _serving_trainer(config):
    """The val-phase Trainer of ``config`` (bf16 sampling copy) with the
    T=10 val schedule set."""
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(val_steps=10, config=config)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")
    return trainer


def _frames_checked(torch, trainer, run, label):
    """``run()``'s process frames (one (1 + n_snap, 128, 128, 3) array an
    image) with the counters zeroed just before: finite, every forward
    kernel launched. Returns the launches."""
    import numpy as np

    from sr3_tpu_torch.models.diffusion import _snapshot_count

    for c in counters():
        c.n = 0
    t0 = time.perf_counter()
    frames = list(run())
    dt = time.perf_counter() - t0
    launches = forward_launches()
    n_snap, _ = _snapshot_count(trainer.sched.num_timesteps)
    print(f"  {label} {trainer.netG.dtype}: {len(frames)} images, frames "
          f"{frames[0].shape}, T={trainer.sched.num_timesteps}, {dt:.2f} s; "
          f"launches {launches}", flush=True)
    for f in frames:
        if f.shape != (1 + n_snap, 128, 128, 3) or not np.isfinite(f).all():
            raise AssertionError(f"{label}: frames {f.shape}, finite "
                                 f"{np.isfinite(f).all()}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    return launches


def _train_new(torch, config, seed):
    """NEW_TRAIN_STEPS full-width train steps of ``config`` at its batch
    (bf16, dropout 0.2) through train_loop, on seeded synthetic batches;
    K1, K2, K4, K5 and K6 must launch."""
    import numpy as np

    trainer, opt = _train_trainer(torch, config, NEW_TRAIN_STEPS)
    b = opt["datasets"]["train"]["batch_size"]
    print(f"  train-phase Trainer, UNet(cond_mode="
          f"{trainer.diffusion.cond_mode}), conditional "
          f"{trainer.conditional}, compute {trainer.netG.dtype}, batch {b}, "
          f"dropout {opt['model']['unet']['dropout']}", flush=True)
    loader = _synthetic_batches(np, NEW_TRAIN_STEPS, b, seed=seed)
    return _train_loop_checked(torch, trainer, opt, loader, KERNELS_16_128)


@phase("ddpm 16->128")
def ddpm_phase(torch):
    """configs/sr_ddpm_16_128.json at full width: the float32 forward
    against the CPU; GroupedEvaluator.run_sr on 2 images (bf16, T=10,
    group of 2); NEW_TRAIN_STEPS train steps at batch 4."""
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    _forward_vs_cpu(torch, CONFIG_DDPM)
    trainer = _serving_trainer(CONFIG_DDPM)
    items = _sr_items(torch, 2, seed=20)
    ev = GroupedEvaluator(trainer, group_size=2)
    serving = _frames_checked(
        torch, trainer,
        lambda: (f for _, f in ev.run_sr(iter(items), continous=True)),
        "run_sr(continous=True) ddpm")
    del trainer, ev
    return {"serving": serving, "train": _train_new(torch, CONFIG_DDPM, 21)}


@phase("unconditional 128^2")
def uncond_phase(torch):
    """configs/sample_sr3_128.json and configs/sample_ddpm_128.json (the
    six-level model) at full width: the float32 forward against the CPU;
    GroupedEvaluator.run_uncond of 2 samples (bf16, T=10, group of 2); for
    sample_ddpm_128 NEW_TRAIN_STEPS train steps at batch 4, then the median
    ms of a batch-8 UNet step (p_sample_step of the T=2000 chain) and a
    torch.profiler window over it."""
    import numpy as np

    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    out = {}
    for config, key in ((CONFIG_UNCOND_SR3, "sample_sr3_128"),
                        (CONFIG_DDPM_128, "sample_ddpm_128")):
        _forward_vs_cpu(torch, config)
        trainer = _serving_trainer(config)
        ev = GroupedEvaluator(trainer, group_size=2)
        out[key + "_serving"] = _frames_checked(
            torch, trainer, lambda: ev.run_uncond(2, continous=True),
            f"run_uncond(continous=True) {key}")
        if config != CONFIG_DDPM_128:
            del trainer, ev
            continue
        sched = make_schedule(trainer.opt["model"]["beta_schedule"]["val"]
                              | {"n_timestep": 2000}, "cuda")
        net = trainer._eval_params()
        gd = torch.Generator(device="cuda").manual_seed(25)
        img = torch.randn(BATCH_TIME, 3, 128, 128, device="cuda",
                          generator=gd)
        steps = iter(range(1999, -1, -1))
        step = lambda: trainer.diffusion.p_sample_step(
            net, sched, img, next(steps), None, generator=gd)
        with torch.inference_mode():
            ms = _time_each(torch, step, 10)
            step_ms = float(np.median(ms))
            print(f"  UNet step (p_sample_step) {key} B={BATCH_TIME} "
                  f"{net.dtype}: median {step_ms:.3f} ms/step over {len(ms)} "
                  f"steps (min {min(ms):.3f}, max {max(ms):.3f}); 2000-step "
                  f"throughput extrapolated "
                  f"{BATCH_TIME / (2000 * step_ms / 1000):.4f} img/s",
                  flush=True)
            _mfu(config, BATCH_TIME, step_ms)
            _profile_steps(torch, step, 2)
        del trainer, ev, net, img
        out[key + "_train"] = _train_new(torch, config, 26)
    return out


@phase("strided chains")
def strided_phase(torch, trainer):
    """DDIM-50, DPM++-25 and the SDE DPM++-25 (STRIDED) on the 16->128 sr3
    serving trainer (bf16) from the T=2000 schedule, through
    GroupedEvaluator.run_sr of BATCH_TIME images in one group: counters
    zeroed just before each chain; its UNet forwards (K1 launches over the
    K1 calls of one forward) must equal its steps and its outputs be
    finite. Then the wall ms of a whole chain (median of 3 more runs),
    images/s, and a torch.profiler window over one more (device ops per
    UNet forward)."""
    import numpy as np

    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    opt = trainer.opt
    diff_opt = opt["model"]["diffusion"]
    saved = dict(diff_opt)
    trainer.set_new_noise_schedule(
        opt["model"]["beta_schedule"]["val"] | {"n_timestep": 2000},
        schedule_phase="strided")
    items = _sr_items(torch, BATCH_TIME, seed=22)
    ev = GroupedEvaluator(trainer, group_size=BATCH_TIME, base_seed=23)
    run = lambda: [o for _, o in ev.run_sr(iter(items))]
    k1_per_forward = len(k1_sites(torch, CONFIG))
    out = {}
    try:
        for label, knobs, steps in STRIDED:
            diff_opt.clear()
            diff_opt.update(saved, **knobs)
            for c in counters():
                c.n = 0
            outs = run()
            launches = forward_launches()
            forwards = launches["gn_silu_conv3x3"] / k1_per_forward
            finite = all(np.isfinite(o).all() for o in outs)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
            chain_s = float(np.median(times))
            print(f"  {label} ({knobs}) B={BATCH_TIME} {trainer.netG.dtype}, "
                  f"T=2000: {forwards:g} UNet forwards (want {steps}), "
                  f"finite {finite}; launches {launches}; whole chain median "
                  f"{1000 * chain_s:.1f} ms of 3 (min {1000 * min(times):.1f}, "
                  f"max {1000 * max(times):.1f}), {BATCH_TIME / chain_s:.3f} "
                  f"images/s", flush=True)
            _mfu(CONFIG, BATCH_TIME, 1000 * chain_s, forwards=steps)
            with torch.inference_mode():
                _profile_steps(torch, run, 1, unet_steps=steps)
            if forwards != steps or not finite or len(outs) != BATCH_TIME:
                raise AssertionError(f"{label}: {forwards} forwards, finite "
                                     f"{finite}")
            out[label] = launches
    finally:
        diff_opt.clear()
        diff_opt.update(saved)
        trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                       schedule_phase="val")
    return out


@phase("-p val")
def val_phase(torch, trainer, results):
    """evaluate_sr (what ``python -m sr3_tpu_torch.sr -p val`` runs) on 2
    seeded synthetic 16->128 images with the serving trainer (bf16, T=10),
    counters zeroed just before; it writes its PNGs into ``results``
    through Metrics.save_img (on the card's machine, which has neither cv2
    nor Pillow, the port's PNG codec), wrapped here only to keep a copy of
    each array it writes. Every file asked for at its shape; each file read
    back (Metrics.load_img) equal to the array written; the PSNR and SSIM
    that evaluate_sr returns equal to those of the arrays and to what
    ``python -m sr3_tpu_torch.eval -p results`` (run in-process) reads from
    the files."""
    import numpy as np

    import sr3_tpu_torch.eval as port_eval
    import sr3_tpu_torch.utils.metrics as Metrics
    from sr3_tpu_torch.models.diffusion import _snapshot_count
    from sr3_tpu_torch.training.evaluation import evaluate_sr

    opt = trainer.opt
    items = _sr_items(torch, 2, seed=24)
    written = {}
    save_img = Metrics.save_img

    def save_and_keep(img, path):
        save_img(img, path)
        written[os.path.basename(path)] = np.array(img)

    prev = opt["path"]["results"]
    opt["path"]["results"] = results
    Metrics.save_img = save_and_keep
    try:
        for c in counters():
            c.n = 0
        psnr, ssim = evaluate_sr(trainer, items, opt, current_step=0,
                                 current_epoch=0)
        launches = forward_launches()
    finally:
        Metrics.save_img = save_img
        opt["path"]["results"] = prev
    want = {f"0_{i}_{tag}.png" for i in (1, 2)
            for tag in ("sr_process", "sr", "hr", "lr", "inf")}
    shapes = {n: (a.shape, str(a.dtype)) for n, a in sorted(written.items())}
    on_disk = {n: Metrics.load_img(os.path.join(results, n))
               for n in sorted(os.listdir(results))}
    pairs = [(written[f"0_{i}_sr.png"], written[f"0_{i}_hr.png"])
             for i in (1, 2)]
    ref_psnr = sum(Metrics.calculate_psnr(a, b) for a, b in pairs) / 2
    ref_ssim = sum(Metrics.calculate_ssim(a, b) for a, b in pairs) / 2
    scored = os.path.join(os.path.dirname(results), "eval.json")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = port_eval.main(["-p", results, "--json", scored])
    with open(scored) as f:
        scores = json.load(f)
    print(f"  evaluate_sr {trainer.netG.dtype}, T="
          f"{trainer.sched.num_timesteps}: PSNR {psnr:.4f} SSIM {ssim:.4f} "
          f"(from the written arrays {ref_psnr:.4f}, {ref_ssim:.4f}; "
          f"sr3_tpu_torch.eval from the files {scores['avg_psnr']:.4f}, "
          f"{scores['avg_ssim']:.4f}, {scores['count']} pairs); files "
          f"{shapes}; launches {launches}", flush=True)
    print("  " + out.getvalue().strip().replace("\n", "\n  "), flush=True)
    n_snap, _ = _snapshot_count(trainer.sched.num_timesteps)
    grid = Metrics.tensor2img(np.zeros((1 + n_snap, 128, 128, 3))).shape
    want_shape = {"sr_process": grid, "lr": (16, 16, 3)}
    ok_shapes = all(
        a.dtype == np.uint8
        and a.shape == want_shape.get(n[4:-4], (128, 128, 3))
        for n, a in written.items())
    if set(written) != want or set(on_disk) != want or not ok_shapes:
        raise AssertionError(f"evaluate_sr wrote {shapes}, on disk "
                             f"{sorted(on_disk)}, want {sorted(want)}")
    differ = [n for n in want if not np.array_equal(on_disk[n], written[n])]
    if differ:
        raise AssertionError(f"files read back unlike what was written: "
                             f"{differ}")
    if (psnr, ssim) != (ref_psnr, ref_ssim) or rc != 0 or (
            scores["count"], scores["avg_psnr"], scores["avg_ssim"]) != (
            2, psnr, ssim):
        raise AssertionError(f"PSNR / SSIM {psnr}, {ssim} against "
                             f"{ref_psnr}, {ref_ssim} and the scorer's "
                             f"{scores}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    return launches


@phase("sample_ddpm_128 kernel timing")
def kernel_timing_ddpm_128_phase(torch, errs, checked_bwd):
    """At BATCH_TIME, bf16: K4 (with its logsumexp), K5 and K6 at the
    six-level model's attention (8, 256, 128) (16x16 at C 128) and
    (8, 16, 256) (the 4x4 mid block), first checked against the plain
    versions (the K5 / K6 classes they launch added to ``checked_bwd``),
    and K1 at its 4x4 up-path site 8x512x4^2->256 (+FiLM+residual), each
    beside its plain version, the library call where there is one (SDPA;
    beside K1 cuDNN's conv alone, not the same function) and its bound."""
    import functools

    import torch.nn.functional as F

    from sr3_tpu_torch.ops import attention, conv_fused

    g = torch.Generator(device="cuda").manual_seed(27)
    out = {}

    def entry(name, shape, *args):
        out.setdefault(name, {})[shape] = _time_entry(torch, name, shape,
                                                      *args)

    b, cin, cout, hw = BATCH_TIME, 512, 256, 4
    args, kw = _k1_inputs(torch, g, b, cin, cout, hw, torch.bfloat16, True)
    px = b * hw * hw
    shape = f"{b}x{cin}x{hw}x{hw}->{cout} +film+residual"
    entry("gn_silu_conv3x3", shape,
          functools.partial(conv_fused.gn_silu_conv3x3, *args, **kw),
          functools.partial(conv_fused.gn_silu_conv3x3_plain, *args, **kw),
          None, 2 * px * cin * cout * 9,
          2 * (px * cin + 2 * px * cout + cout * cin * 9))
    x, w, cb = args[0], args[3], args[4].to(torch.bfloat16)
    conv = lambda: F.conv2d(x, w, cb, padding=1)
    alone = {"cudnn_conv_alone_ms": _time_ms(torch, conv, n=5),
             "cudnn_conv_alone_device_ms": _device_ms(torch, conv)}
    out["gn_silu_conv3x3"][shape].update(alone)
    print(f"  cuDNN F.conv2d alone {b}x{cin}x{hw}x{hw}->{cout}, ms (events "
          f"/ device): {alone['cudnn_conv_alone_ms']:.4f} / "
          f"{_show(alone['cudnn_conv_alone_device_ms'])}", flush=True)
    failures = []
    for _, seq, d in BWD_SHAPES_DDPM_128:
        q, k, v = (torch.randn(b, seq, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        gr = torch.randn(b, seq, d, device="cuda", generator=g)
        o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
        dsum = (gr * o).sum(-1)
        attention.bwd_tile_launches(reset=True)
        grads = attention.attention_bwd(q, k, v, gr, lse, dsum, d ** -0.5)
        label = f"{b}x{seq}x{d}" + bwd_classes(checked_bwd)
        refs = attention.attention_bwd_plain(q, k, v, gr, lse, dsum,
                                             d ** -0.5)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            check(torch, errs, failures, "flash_attention_bwd_"
                  + ("dq" if name == "dq" else "dkv"), "bfloat16",
                  f"{label}: {name}", got, ref)
    if failures:
        raise AssertionError(f"K5 / K6 disagree with the plain version: "
                             f"{failures}")
    for _, seq, d in BWD_SHAPES_DDPM_128:
        _attention_entries(torch, g, entry, b, seq, d)
    return out

# --------------------------------------- the 128->1024 slice and the rest


def _peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


@phase("128->1024 model")
def model_1024_phase(torch):
    """configs/sr_sr3_128_1024.json at full width: the float32 forward,
    batch 1 at 1024^2, on the card against the CPU (FORWARD_TOL)."""
    from sr3_tpu_torch.models.networks import count_params

    torch.cuda.reset_peak_memory_stats()
    net = _forward_vs_cpu(torch, CONFIG_1024)
    n = count_params(net)
    print(f"  peak device memory of the float32 forward (and its weights): "
          f"{_peak_gib(torch):.2f} GiB", flush=True)
    if n != 91_564_227:
        raise AssertionError(f"expected 91,564,227 parameters, got {n:,d}")
    del net
    torch.cuda.empty_cache()


def _upsampled_items(torch, n, seed, lr=128, hr=1024):
    """n seeded lr->hr val items: SR the bicubic upsampling of a random
    lr^2 image, HWC float32 in [-1, 1]."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, lr, lr, generator=g) * 2 - 1
    sr = F.interpolate(x, size=(hr, hr), mode="bicubic",
                       align_corners=False).clamp(-1, 1)
    return [{"SR": sr[i].permute(1, 2, 0).numpy(), "Index": i}
            for i in range(n)]


@phase("128->1024 serving")
def serving_1024_phase(torch):
    """GroupedEvaluator.run_sr of the val batch (8 images, one group),
    bf16, T=10; then the median ms of a batch-8 p_sample_step at 1024^2 on
    the T=2000 schedule and a torch.profiler window; peak memory."""
    import numpy as np

    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    trainer = _serving_trainer(CONFIG_1024)
    bt = trainer.opt["datasets"]["val"]["batch_size"]
    items = _upsampled_items(torch, bt, seed=30)
    ev = GroupedEvaluator(trainer, group_size=bt)
    for c in counters():
        c.n = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [o for _, o in ev.run_sr(iter(items))]
    dt = time.perf_counter() - t0
    launches = forward_launches()
    finite = all(np.isfinite(o).all() for o in outs)
    print(f"  run_sr {trainer.netG.dtype} B={bt}, T="
          f"{trainer.sched.num_timesteps}: {len(outs)} images of "
          f"{outs[0].shape}, finite {finite}, {dt:.2f} s; launches "
          f"{launches}; peak device memory {_peak_gib(torch):.2f} GiB",
          flush=True)
    if len(outs) != bt or outs[0].shape != (1024, 1024, 3) or not finite:
        raise AssertionError(f"1024^2 serving: {len(outs)} outputs, finite "
                             f"{finite}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    sched = make_schedule(trainer.opt["model"]["beta_schedule"]["val"]
                          | {"n_timestep": 2000}, "cuda")
    net = trainer._eval_params()
    gd = torch.Generator(device="cuda").manual_seed(31)
    cond = torch.rand(bt, 3, 1024, 1024, device="cuda", generator=gd) * 2 - 1
    img = torch.randn(bt, 3, 1024, 1024, device="cuda", generator=gd)
    steps = iter(range(1999, -1, -1))
    step = lambda: trainer.diffusion.p_sample_step(
        net, sched, img, next(steps), cond, generator=gd)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_each(torch, step, TIME_STEPS_1024)
        step_ms = float(np.median(ms))
        print(f"  UNet step (p_sample_step) B={bt} 1024^2 {net.dtype}: median "
              f"{step_ms:.3f} ms/step over {len(ms)} steps (min "
              f"{min(ms):.3f}, max {max(ms):.3f}); 2000-step throughput "
              f"extrapolated {bt / (2000 * step_ms / 1000):.6f} img/s; peak "
              f"device memory {_peak_gib(torch):.2f} GiB", flush=True)
        _mfu(CONFIG_1024, bt, step_ms)
        _profile_steps(torch, step, 1)
    del trainer, ev, net, cond, img
    torch.cuda.empty_cache()
    return launches


@phase("128->1024 training")
def training_1024_phase(torch):
    """TRAIN_STEPS_1024 full-width steps through train_loop at the config's
    batch 2, bf16, remat on; every kernel launched, K3 and K4-K6 as often as
    the model says; then the median train step, a torch.profiler window
    and the peak memory."""
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params
    from sr3_tpu_torch.models.unet import SelfAttention

    trainer, opt = _train_trainer(torch, CONFIG_1024, TRAIN_STEPS_1024)
    b = opt["datasets"]["train"]["batch_size"]
    net = trainer.netG
    n_attn = sum(isinstance(m, SelfAttention) for m in net.modules())
    sites = k3_sites(opt)
    print(f"  train-phase Trainer: {count_params(net):,d} params float32, "
          f"compute {net.dtype}, batch {b}, dropout "
          f"{opt['model']['unet']['dropout']}, remat {net.remat}, {n_attn} "
          f"attention calls and {sites} statistics-route GroupNorms per "
          f"forward", flush=True)
    if net.dtype != torch.bfloat16 or b != 2 or not net.remat:
        raise AssertionError("the 128->1024 path trains at batch 2, bf16, "
                             "remat on")
    loader = _synthetic_batches(np, TRAIN_STEPS_1024, b, seed=32,
                                lr_size=128)
    torch.cuda.reset_peak_memory_stats()
    launches = _train_loop_checked(torch, trainer, opt, loader,
                                   ONE_DEVICE_KERNELS)
    print(f"  peak device memory {_peak_gib(torch):.2f} GiB", flush=True)
    _remat_launches_checked(launches, sites, n_attn, TRAIN_STEPS_1024)
    _gn_bwd_launches_checked(torch, launches, CONFIG_1024, TRAIN_STEPS_1024)
    trainer.feed_data(_synthetic_batches(np, 1, b, seed=33, lr_size=128)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_each(torch, trainer.optimize_parameters, TIME_STEPS_1024)
    step_ms = float(np.median(ms))
    print(f"  train step B={b} {net.dtype} remat 1024^2: median "
          f"{step_ms:.3f} ms/step over {len(ms)} steps (min {min(ms):.3f}, "
          f"max {max(ms):.3f}); {b / (step_ms / 1000):.4f} train img/s; peak "
          f"device memory {_peak_gib(torch):.2f} GiB", flush=True)
    _mfu(CONFIG_1024, b, step_ms, train=True)
    _profile_steps(torch, trainer.optimize_parameters, 1)
    del trainer, net
    torch.cuda.empty_cache()
    return launches


@phase("cascade")
def cascade_phase(torch):
    """run_cascade of sample_sr3_128 then sr_sr3_128_1024 (bf16, T=10 each,
    2 samples, random weights, no output directory): stage 1's samples
    (2, 128, 128, 3), stage 2's outputs (2, 1024, 1024, 3), all finite;
    stage 2's conditioning (what its chain was given) equal to the bicubic
    resize of stage 1's outputs through uint8; each stage's wall time."""
    import numpy as np

    import sr3_tpu_torch.utils.metrics as Metrics
    from sr3_tpu_torch.data.prepare import BICUBIC, resize_and_convert
    from sr3_tpu_torch.training import cascade
    from sr3_tpu_torch.training.trainer import Trainer

    opts = [_load_opt(val_steps=10, config=c)
            for c in (CONFIG_UNCOND_SR3, CONFIG_1024)]
    stages, conditions = [], []
    run_stage, test_batched = cascade.run_stage, Trainer.test_batched

    def timed_stage(opt, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_stage(opt, **kw)
        stages.append((opt["name"], time.perf_counter() - t0, out))
        return out

    def recorded(self, xs, generators, continous=False):
        conditions.append(np.array(xs))
        return test_batched(self, xs, generators, continous)

    cascade.run_stage, Trainer.test_batched = timed_stage, recorded
    for c in counters():
        c.n = 0
    try:
        final = cascade.run_cascade(opts, n_samples=2)
    finally:
        cascade.run_stage, Trainer.test_batched = run_stage, test_batched
    launches = forward_launches()
    (_, t1, out1), (_, t2, out2) = stages
    want = np.stack([resize_and_convert(Metrics.tensor2img(o), 1024,
                                        BICUBIC).astype(np.float32)
                     / 127.5 - 1.0 for o in out1])
    given = conditions[0][:len(out1)]
    same = given.shape == want.shape and np.array_equal(given, want)
    finite = all(np.isfinite(o).all() for o in out1 + out2)
    print(f"  stage 1 {opts[0]['name']}: {len(out1)} x {out1[0].shape} in "
          f"{t1:.2f} s; stage 2 {opts[1]['name']}: {len(out2)} x "
          f"{out2[0].shape} in {t2:.2f} s (group of "
          f"{conditions[0].shape[0]}); finite {finite}; stage 2's condition "
          f"equals the resize of stage 1's outputs: {same}; launches "
          f"{launches}", flush=True)
    if (len(final) != 2 or final[0].shape != (1024, 1024, 3)
            or out1[0].shape != (128, 128, 3) or not finite or not same):
        raise AssertionError("cascade outputs or conditioning wrong")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    torch.cuda.empty_cache()
    return launches


def _optimizer_state_bytes(trainer):
    return sum(t.numel() * t.element_size()
               for st in trainer.optimizer.state.values()
               for t in st.values() if t.is_cuda)


@phase("bf16 Adam first moment")
def mu_bf16_phase(torch, f32_state_bytes):
    """16->128 at batch 4 with train.optimizer.mu_dtype "bfloat16":
    NEW_TRAIN_STEPS steps through train_loop; every exp_avg bfloat16, every
    exp_avg_sq float32; the optimizer state's bytes against the float32
    run's (phase 7's trainer)."""
    import numpy as np

    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(phase="train", config=CONFIG)
    opt["train"].update(n_iter=NEW_TRAIN_STEPS, print_freq=1,
                        val_freq=10 ** 9, save_checkpoint_freq=10 ** 9)
    opt["train"]["optimizer"]["mu_dtype"] = "bfloat16"
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
    b = opt["datasets"]["train"]["batch_size"]
    loader = _synthetic_batches(np, NEW_TRAIN_STEPS, b, seed=34)
    launches = _train_loop_checked(torch, trainer, opt, loader,
                                   KERNELS_16_128)
    states = list(trainer.optimizer.state.values())
    mu = {str(st["exp_avg"].dtype) for st in states}
    nu = {str(st["exp_avg_sq"].dtype) for st in states}
    nbytes = _optimizer_state_bytes(trainer)
    n = sum(p.numel() for p in trainer.netG.parameters())
    print(f"  mu_dtype bfloat16: exp_avg {mu}, exp_avg_sq {nu} over "
          f"{len(states)} parameters; optimizer state {nbytes / 1e6:.1f} MB "
          f"against {f32_state_bytes / 1e6:.1f} MB for the float32 run "
          f"(saved {(f32_state_bytes - nbytes) / 1e6:.1f} MB; 2 B x "
          f"{n / 1e6:.1f}M parameters = {2 * n / 1e6:.1f} MB)", flush=True)
    if mu != {"torch.bfloat16"} or nu != {"torch.float32"} \
            or len(states) != len(list(trainer.netG.parameters())) \
            or f32_state_bytes - nbytes != 2 * n:
        raise AssertionError(f"bf16 first moment: exp_avg {mu}, exp_avg_sq "
                             f"{nu}, {nbytes} bytes")
    del trainer
    torch.cuda.empty_cache()
    return launches


class SyntheticPairs:
    """``n`` seeded uint8 (HR, SR) pairs at 128^2 as the port's dataset
    decodes them (``_decoded``): SR the nearest upsampling of a random 16^2
    image, HR that plus noise."""
    min_max = (-1, 1)

    def __init__(self, np, n, seed):
        rng = np.random.default_rng(seed)
        lr = rng.integers(0, 256, (n, 16, 16, 3))
        sr = np.repeat(np.repeat(lr, 8, axis=1), 8, axis=2)
        hr = np.clip(sr + rng.integers(-12, 13, sr.shape), 0, 255)
        self.sr, self.hr = sr.astype(np.uint8), hr.astype(np.uint8)

    def __len__(self):
        return len(self.sr)

    def _decoded(self, i):
        return {"HR": self.hr[i], "SR": self.sr[i]}


@phase("device-resident dataset")
def resident_phase(torch):
    """16->128 at batch 4 with datasets.train.device_data on RESIDENT_PAIRS
    synthetic uint8 pairs, RESIDENT_K steps a call through train_loop:
    finite losses, every parameter moved, every kernel launched, the
    resident bytes; then the median step of the resident path against the
    host-loader path (feed_data of host batches) in this run."""
    import numpy as np

    from sr3_tpu_torch.data.loader import DataLoader
    from sr3_tpu_torch.training.loops import train_loop
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(phase="train", config=CONFIG)
    calls = 3
    opt["train"].update(n_iter=calls * RESIDENT_K,
                        steps_per_dispatch=RESIDENT_K, print_freq=RESIDENT_K,
                        val_freq=10 ** 9, save_checkpoint_freq=10 ** 9)
    opt["datasets"]["train"]["device_data"] = True
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
    b = opt["datasets"]["train"]["batch_size"]
    data = SyntheticPairs(np, RESIDENT_PAIRS, seed=35)
    loader = DataLoader(data, batch_size=b, shuffle=True, drop_last=True)
    before = [p.detach().clone() for p in trainer.netG.parameters()]
    losses, step = [], trainer.optimize_parameters_resident

    def logged(bs, k):
        step(bs, k)
        losses.append(trainer.log_dict["l_pix"])

    trainer.optimize_parameters_resident = logged
    for c in counters():
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        train_loop(trainer, loader, opt, lambda s, e: None)
        torch.cuda.synchronize()
    finally:
        del trainer.optimize_parameters_resident
    dt = time.perf_counter() - t0
    launches = launches_of(KERNELS_16_128)
    losses = [float(x) for x in losses]
    resident = sum(v.numel() * v.element_size()
                   for v in trainer._dev_data.values())
    still = sum(torch.equal(p.detach(), q)
                for p, q in zip(trainer.netG.parameters(), before))
    print(f"  device_data: {len(data)} pairs resident, "
          f"{resident / 1e6:.3f} MB uint8 ({trainer._dev_data['HR'].dtype}); {trainer.step} steps in "
          f"{len(losses)} calls of {RESIDENT_K} in {dt:.2f} s; last losses "
          f"{[round(x, 5) for x in losses]}; parameters that did not move "
          f"{still}; launches {launches}", flush=True)
    if (resident != 2 * RESIDENT_PAIRS * 128 * 128 * 3
            or trainer.step != calls * RESIDENT_K
            or not all(np.isfinite(losses)) or still
            or min(launches.values()) <= 0):
        raise AssertionError("device-resident training failed its checks")
    # the resident step against the host-loader step, one call each way
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        trainer.optimize_parameters_resident(b, RESIDENT_K)
    torch.cuda.synchronize()
    resident_ms = 1000 * (time.perf_counter() - t0) / (calls * RESIDENT_K)
    batches = _synthetic_batches(np, calls * RESIDENT_K, b, seed=36)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        trainer.feed_data(batch)
        trainer.optimize_parameters()
    torch.cuda.synchronize()
    host_ms = 1000 * (time.perf_counter() - t0) / len(batches)
    print(f"  train step B={b} bf16, mean of {calls * RESIDENT_K}: resident "
          f"{resident_ms:.3f} ms, host loader {host_ms:.3f} ms (host-bound; "
          f"printed, not gated)", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


@phase("128->1024 kernel timing")
def kernel_timing_1024_phase(torch):
    """At this slice's shapes, bf16: K1 at 8x64x1024^2->64 and
    8x128x1024^2->64 (+FiLM+residual; beside it cuDNN's conv alone), K3 at
    2x64x1024^2, K4 (with its logsumexp), K5 and K6 at (2 | 8, 1024, 512),
    and at the 16->128 serving attention (8, 256 | 64, 512); each beside its
    plain version, the library call where there is one and its bound."""
    import functools

    import torch.nn.functional as F

    from sr3_tpu_torch.ops import conv_fused, groupnorm

    g = torch.Generator(device="cuda").manual_seed(37)
    out = {}

    def entry(name, shape, *args):
        out.setdefault(name, {})[shape] = _time_entry(torch, name, shape,
                                                      *args)

    b, hw = BATCH_TIME, 1024
    for cin in (64, 128):
        args, kw = _k1_inputs(torch, g, b, cin, 64, hw, torch.bfloat16, True)
        px = b * hw * hw
        shape = f"{b}x{cin}x{hw}x{hw}->64 +film+residual"
        entry("gn_silu_conv3x3", shape,
              functools.partial(conv_fused.gn_silu_conv3x3, *args, **kw),
              functools.partial(conv_fused.gn_silu_conv3x3_plain, *args, **kw),
              None, 2 * px * cin * 64 * 9,
              2 * (px * cin + 2 * px * 64 + 64 * cin * 9))
        x, w, cb = args[0], args[3], args[4].to(torch.bfloat16)
        conv = lambda: F.conv2d(x, w, cb, padding=1)
        alone = {"cudnn_conv_alone_ms": _time_ms(torch, conv, n=5),
                 "cudnn_conv_alone_device_ms": _device_ms(torch, conv)}
        out["gn_silu_conv3x3"][shape].update(alone)
        print(f"  cuDNN F.conv2d alone {b}x{cin}x{hw}x{hw}->64, ms (events "
              f"/ device): {alone['cudnn_conv_alone_ms']:.4f} / "
              f"{_show(alone['cudnn_conv_alone_device_ms'])}", flush=True)
        del args, kw, x, w
        torch.cuda.empty_cache()
    x = torch.randn(2, 64, hw, hw, device="cuda", generator=g)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xf = x.float()
    entry("gn_stats", f"2x64x{hw}x{hw}",
          lambda: groupnorm.gn_stats(x), lambda: groupnorm.gn_stats_plain(x),
          lambda: torch.var_mean(xf, dim=(2, 3), correction=0),
          3 * x.numel(), 2 * x.numel() + 2 * 4 * 2 * 64)
    del x, xf
    for bh, seq, d in ((2, 1024, 512), (8, 1024, 512), (8, 256, 512),
                       (8, 64, 512)):
        _attention_entries(torch, g, entry, bh, seq, d)
    return out



# ------------------------------------------- the JAX package's host modules
# the committed 16->128 fixture set (6 triplets of PNGs); the pairs of the
# loader's timing set, the steps of a timed window and its rounds
FIXTURES = os.path.join(ROOT, "dataset", "fixtures_16_128")
LOADER_F32_STEPS = 3
LOADER_SET = 2048
LOADER_WINDOW = 25
LOADER_ROUNDS = 4
LOADER_PROFILE_STEPS = 4
LOADER_WORKERS = 8
FID_IMAGES = 256
FID_BATCH = 64
FID_TOL = 1e-5


def _log_checked(trainer, label):
    """The trainer's log has the JAX trainer's keys, all finite and
    positive."""
    import math

    log = trainer.get_current_log()
    print(f"  {label} get_current_log: "
          + ", ".join(f"{k} {v:.4f}" for k, v in log.items()), flush=True)
    if (sorted(log) != ["imgs_per_sec", "l_pix", "step_time_ms"]
            or not all(math.isfinite(v) and v > 0 for v in log.values())):
        raise AssertionError(f"training log {log}")


@phase("profiler trace")
def trace_phase(torch, trainer, workdir):
    """sr3_tpu_torch.utils.profiler.trace around two bf16 serving steps
    (p_sample_step at batch 8 of the T=2000 chain): one trace file, whose
    device kernels include K1's conv and K4. Then the serving step timed
    again, after the trace."""
    import glob

    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.utils.profiler import trace

    sched = make_schedule(dict(schedule="linear", n_timestep=2000,
                               linear_start=1e-6, linear_end=1e-2), "cuda")
    net = trainer._eval_params()
    g = torch.Generator(device="cuda").manual_seed(41)
    cond = torch.rand(BATCH_TIME, 3, 128, 128, device="cuda",
                      generator=g) * 2 - 1
    img = torch.randn(BATCH_TIME, 3, 128, 128, device="cuda", generator=g)
    log_dir = os.path.join(workdir, "trace")
    with torch.inference_mode():
        trainer.diffusion.p_sample_step(net, sched, img, 1999, cond,
                                        generator=g)  # warm
        with trace(log_dir):
            for t in (1998, 1997):
                trainer.diffusion.p_sample_step(net, sched, img, t, cond,
                                                generator=g)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    print(f"  trace {os.path.basename(files[0])}: "
          f"{os.path.getsize(files[0]) / 1e6:.1f} MB, {len(events)} events, "
          f"{len(kernels)} distinct device kernels", flush=True)
    for want in ("gn_silu_conv3x3_", "flash_fwd_"):
        hits = sorted(_short(k) for k in kernels if want in k)
        print(f"    {want}*: {hits[:4]}", flush=True)
        if not hits:
            raise AssertionError(f"no {want}* kernel in the trace")
    _serving_step_ms(torch, trainer, "after the profiler trace")


def _fixture_opt(dtype, num_workers=0):
    """The 16->128 train config at batch 4 on the committed fixture PNGs."""
    opt = _load_opt(dtype=dtype, phase="train")
    opt["datasets"]["train"].update(
        dataroot=FIXTURES, datatype="img", data_len=-1, num_workers=num_workers)
    opt["train"].update(print_freq=10 ** 9, val_freq=10 ** 9,
                        save_checkpoint_freq=10 ** 9)
    return opt


def _fixture_trainer(opt):
    from sr3_tpu_torch.training.trainer import create_model

    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   schedule_phase="train")
    return trainer


def _epochs(loader):
    while True:
        yield from loader


def _loop_steps(trainer, opt, loader, n):
    """n steps of train_loop (the loader through device_prefetch)."""
    from sr3_tpu_torch.training.loops import train_loop

    trainer.begin_step = trainer.step
    opt["train"]["n_iter"] = trainer.step + n
    train_loop(trainer, loader, opt, lambda s, e: None)


def _paeth_png(np, img):
    """PNG bytes of uint8 RGB ``img`` with the Paeth filter on every row,
    as Pillow's and libpng's writers choose for almost every row of a
    photograph (125-127 of the 128 rows of each fixture HR image)."""
    import struct
    import zlib

    h, w, _ = img.shape
    x = img.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = ((x - pred) & 0xFF).reshape(h, 3 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _decode_timing(np):
    """ms per image of the port's PNG decoder (median of repeats), each
    file checked against the pixels written: filter 0 (the port's encoder)
    and Paeth on every row at 128^2 and 1024^2, and the fixture's
    Pillow-written 128^2 HR and 512^2 files."""
    import glob

    from sr3_tpu_torch.utils import png

    rng = np.random.default_rng(36)
    files = {}
    for side in (128, 1024):
        low = rng.integers(0, 256, (side // 8, side // 8, 3), np.uint8)
        img = np.clip(np.repeat(np.repeat(low, 8, 0), 8, 1).astype(np.int16)
                      + rng.integers(-12, 13, (side, side, 3)), 0, 255) \
            .astype(np.uint8)
        files[f"{side}^2 filter 0"] = img, png.encode(img)
        files[f"{side}^2 Paeth"] = img, _paeth_png(np, img)
    for path in (sorted(glob.glob(os.path.join(FIXTURES, "hr_128", "*")))[0],
                 sorted(glob.glob(os.path.join(ROOT, "dataset",
                                               "fixtures_64_512", "hr_512",
                                               "*")))[0]):
        with open(path, "rb") as f:
            data = f.read()
        img = png.decode(data)
        files[f"{img.shape[0]}^2 fixture {os.path.basename(path)}"] = \
            img, data
    out = {}
    for label, (img, data) in files.items():
        if not np.array_equal(png.decode(data), img):
            raise AssertionError(f"decode of {label} differs")
        n = 20 if img.shape[0] <= 128 else 3
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            png.decode(data)
            ms.append(1000 * (time.perf_counter() - t0))
        out[label] = float(np.median(ms))
        print(f"  decode {label}: {out[label]:.3f} ms an image "
              f"(median of {n}, {len(data) / 1e3:.1f} kB)", flush=True)
    return out


def _write_loader_set(np, root, n):
    """n seeded 16->128 training pairs as PNGs, hr_128 and sr_16_128, Paeth
    on every row: SR the 8x upsampled 16^2 image, HR that plus noise."""
    rng = np.random.default_rng(360)
    for d in ("hr_128", "sr_16_128"):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
        low = rng.integers(0, 256, (16, 16, 3), np.uint8)
        sr = np.repeat(np.repeat(low, 8, 0), 8, 1)
        hr = np.clip(sr.astype(np.int16)
                     + rng.integers(-12, 13, sr.shape), 0, 255) \
            .astype(np.uint8)
        for d, img in (("hr_128", hr), ("sr_16_128", sr)):
            with open(os.path.join(root, d, f"{i:05d}.png"), "wb") as f:
                f.write(_paeth_png(np, img))


@phase("host data pipeline")
def loader_phase(torch, workdir):
    """16->128 training at batch 4 from PNGs decoded on this machine by the
    port's codec. float32, on the committed fixture set: LOADER_F32_STEPS
    steps with num_workers 0 fed host arrays (feed_data) and the same steps
    through train_loop (device_prefetch: pinned memory, a side stream),
    from the same seeds (generator, ``random``), cuDNN deterministic: the
    losses bit-equal. The decoder's ms an image (_decode_timing). bf16, on
    LOADER_SET seeded pairs written here (Paeth rows, the dataset's RAM
    cache off, so every batch decodes its files): windows of LOADER_WINDOW
    steps of the synthetic batches and of the files with 0 and
    LOADER_WORKERS workers, each fed host arrays and through
    device_prefetch, every setting once a round for LOADER_ROUNDS rounds,
    the order reversed every other round, each window from a fresh
    iterator filled by 2 untimed steps; each setting's median ms a step,
    the launching thread's CPU ms a step (``time.thread_time``), its
    per-round differences, and the device busy share of a profiled
    window (printed, not gated). Then train_loop from the files with
    LOADER_WORKERS workers, counters zeroed just before: K1, K2, K4-K6
    launched; the trainer's log."""
    import functools
    import itertools
    import random
    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from sr3_tpu_torch.data.loader import create_dataloader, create_dataset
    from sr3_tpu_torch.data.prefetch import device_prefetch

    opt = _fixture_opt("float32")
    b = opt["datasets"]["train"]["batch_size"]
    dataset = create_dataset(opt["datasets"]["train"], "train")
    print(f"  {len(dataset)} fixture triplets from {FIXTURES}, batch {b}",
          flush=True)
    losses = {}
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for how in ("feed_data", "device_prefetch"):
            trainer = _fixture_trainer(opt)
            loader = create_dataloader(dataset, opt["datasets"]["train"],
                                       "train")
            random.seed(37)
            if how == "feed_data":
                batches = _epochs(loader)
                for _ in range(LOADER_F32_STEPS):
                    trainer.feed_data(next(batches))
                    trainer.optimize_parameters()
                    losses.setdefault(how, []).append(
                        trainer.log_dict["l_pix"].item())
            else:
                step = trainer.optimize_parameters

                def logged():
                    step()
                    losses.setdefault(how, []).append(
                        trainer.log_dict["l_pix"].item())

                trainer.optimize_parameters = logged
                _loop_steps(trainer, opt, loader, LOADER_F32_STEPS)
            del trainer
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    torch.cuda.empty_cache()
    print(f"  float32 losses, num_workers 0: feed_data {losses['feed_data']}"
          f", train_loop with device_prefetch {losses['device_prefetch']}",
          flush=True)
    if (len(losses["feed_data"]) != LOADER_F32_STEPS
            or losses["feed_data"] != losses["device_prefetch"]):
        raise AssertionError("the prefetched batches train otherwise")
    _decode_timing(np)

    root = os.path.join(workdir, "loader_set")
    t0 = time.perf_counter()
    _write_loader_set(np, root, LOADER_SET)
    print(f"  wrote {LOADER_SET} seeded pairs (Paeth rows) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opt = _fixture_opt("bfloat16", num_workers=LOADER_WORKERS)
    opt["datasets"]["train"].update(dataroot=root, cache=False)
    files = create_dataset(opt["datasets"]["train"], "train")
    if len(files) != LOADER_SET or files._cache is not None:
        raise AssertionError("the timing set is not read from its files")
    trainer = _fixture_trainer(opt)
    loaders = {w: create_dataloader(files, {**opt["datasets"]["train"],
                                            "num_workers": w}, "train")
               for w in (0, LOADER_WORKERS)}
    synthetic = _synthetic_batches(np, 8, b, seed=38)

    def cycled():
        yield from itertools.cycle(synthetic)

    def setting(source, prefetch):
        """A new batch iterator and the generators to close after it."""
        def make():
            src = source()
            return ((device_prefetch(src, trainer.device), src) if prefetch
                    else (src, src))
        return make

    settings = {}
    for name, source in (("synthetic", cycled),
                         *((f"files, {w} workers",
                            functools.partial(_epochs, loaders[w]))
                           for w in loaders)):
        settings[f"{name}, feed_data"] = setting(source, False)
        settings[f"{name}, device_prefetch"] = setting(source, True)

    def window(make, n):
        """Wall and this thread's CPU ms a step over n steps."""
        it, src = make()
        try:
            for i in range(2 + n):
                if i == 2:
                    torch.cuda.synchronize()
                    t0, c0 = time.perf_counter(), time.thread_time()
                batch = next(it)
                batch.pop("_epoch", None)
                trainer.feed_data(batch)
                trainer.optimize_parameters()
            torch.cuda.synchronize()
            return (1000 * (time.perf_counter() - t0) / n,
                    1000 * (time.thread_time() - c0) / n)
        finally:
            it.close()
            src.close()

    window(settings["synthetic, feed_data"], 2)  # warm
    ms = {label: [] for label in settings}
    cpu = {label: [] for label in settings}
    for r in range(LOADER_ROUNDS):
        for label in (list(settings) if r % 2 == 0 else
                      list(settings)[::-1]):
            wall, host = window(settings[label], LOADER_WINDOW)
            ms[label].append(wall)
            cpu[label].append(host)
    for label, make in settings.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window(make, LOADER_PROFILE_STEPS)
        busy = _device_busy(torch, prof) / LOADER_PROFILE_STEPS
        med = statistics.median(ms[label])
        print(f"  bf16 {label}: median {med:.3f} ms/step "
              f"({b / med * 1000:.2f} train img/s), windows "
              f"{[round(m, 3) for m in ms[label]]}; the launching "
              f"thread's CPU {statistics.median(cpu[label]):.3f} ms/step; "
              f"device busy {busy:.1f} ms/step ({100 * busy / med:.1f}% of "
              f"the median; {LOADER_PROFILE_STEPS} profiled steps)",
              flush=True)
    for a, c in (("synthetic, feed_data", "synthetic, device_prefetch"),
                 *((f"files, {w} workers, feed_data",
                    f"files, {w} workers, device_prefetch") for w in loaders),
                 *((f"files, 0 workers, {how}",
                    f"files, {LOADER_WORKERS} workers, {how}")
                   for how in ("feed_data", "device_prefetch"))):
        d = [y - x for x, y in zip(ms[a], ms[c])]
        print(f"  ({c}) - ({a}) per round, ms/step: "
              f"{[round(x, 3) for x in d]}, median "
              f"{statistics.median(d):.3f}", flush=True)

    for c in counters():
        c.n = 0
    _loop_steps(trainer, opt, loaders[LOADER_WORKERS], LOADER_PROFILE_STEPS)
    torch.cuda.synchronize()
    launches = launches_of(KERNELS_16_128)
    print(f"  train_loop from the files, {LOADER_WORKERS} workers and "
          f"device_prefetch, launches: {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    _log_checked(trainer, "bf16 files")
    return trainer, launches


@phase("LMDB")
def lmdb_phase(torch, trainer, workdir):
    """The port's fake_lmdb installed as ``lmdb`` (the card's machine has no
    lmdb package); ``prepare`` over the fixture's 128^2 HR images at sizes
    16, 128 into PNG directories and into an LMDB (the port's PNG codec
    encodes and decodes here); the LMDB dataset's val items bit-equal to
    the PNG dataset's; two bf16 train steps at batch 4 from the LMDB
    dataset through train_loop (counters zeroed just before; finite losses,
    every parameter with a finite gradient that moved, K1, K2, K4-K6
    launched)."""
    import itertools

    import numpy as np

    from sr3_tpu_torch.data import fake_lmdb
    from sr3_tpu_torch.data.loader import DataLoader
    from sr3_tpu_torch.data.lrhr import LRHRDataset
    from sr3_tpu_torch.data.prepare import prepare

    if "lmdb" in sys.modules:
        raise AssertionError("an lmdb module is already imported")
    sys.modules["lmdb"] = fake_lmdb
    try:
        src = os.path.join(FIXTURES, "hr_128")
        roots = {kind: os.path.join(workdir, kind) for kind in ("img", "lmdb")}
        with contextlib.redirect_stdout(io.StringIO()) as said:
            prepare(src, roots["img"], sizes=(16, 128))
            prepare(src, roots["lmdb"], sizes=(16, 128), lmdb_save=True)
        sets = {kind: LRHRDataset(root, kind, 16, 128, split="val",
                                  need_LR=True)
                for kind, root in roots.items()}
        items = {kind: [ds[i] for i in range(len(ds))]
                 for kind, ds in sets.items()}
        equal = len(items["img"]) == len(items["lmdb"]) > 0 and all(
            np.array_equal(a[k], c[k]) for a, c in zip(*items.values())
            for k in ("LR", "SR", "HR"))
        print(f"  {said.getvalue().strip().replace(chr(10), '; ')}; LMDB store "
              f"{os.path.getsize(os.path.join(roots['lmdb'], 'data.pkl')) / 1e3:.1f} kB; "
              f"{len(items['lmdb'])} val items bit-equal to the PNG "
              f"directories': {equal}", flush=True)
        if not equal:
            raise AssertionError("the LMDB items differ from the PNG items")
        train = LRHRDataset(roots["lmdb"], "lmdb", 16, 128, split="train")
        b = trainer.opt["datasets"]["train"]["batch_size"]
        loader = DataLoader(train, b, shuffle=True, drop_last=True,
                            num_workers=2)
        batches = list(itertools.islice(_epochs(loader), 2))
        opt = trainer.opt
        trainer.begin_step = trainer.step
        opt["train"]["n_iter"] = trainer.step + len(batches)
        opt["train"]["print_freq"] = 1
        launches = _train_loop_checked(torch, trainer, opt, batches,
                                       KERNELS_16_128)
    finally:
        del sys.modules["lmdb"]
    return launches


@phase("FID")
def fid_phase(torch, results):
    """The proxy-FID extractor (RandomFeatureExtractor, seed 0, width 192)
    on FID_IMAGES seeded synthetic 128^2 images on the card in float32:
    features within FID_TOL of max|f| of the same module on the CPU;
    images/s at batch FID_BATCH; ``python -m sr3_tpu_torch.fid_eval -p``
    phase 19's results (in-process): a finite proxy-FID; ``--extractor
    inception`` raises the ImportError that names torchvision."""
    import math

    import numpy as np

    import sr3_tpu_torch.fid_eval as fid_eval
    from sr3_tpu_torch.utils.fid import RandomFeatureExtractor

    images = np.random.default_rng(42).integers(
        0, 256, (FID_IMAGES, 128, 128, 3), dtype=np.uint8)
    card = RandomFeatureExtractor(seed=0, width=192)
    if next(card.parameters()).device.type != "cuda":
        raise AssertionError("the extractor is not on the card")
    feats = card(images, FID_BATCH)
    ref = RandomFeatureExtractor(seed=0, width=192, device="cpu")(
        images, FID_BATCH)
    err = np.abs(feats - ref).max() / np.abs(ref).max()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        card(images, FID_BATCH)
    torch.cuda.synchronize()
    ips = 3 * FID_IMAGES / (time.perf_counter() - t0)
    print(f"  RandomFeatureExtractor(0, 192) float32 on "
          f"{next(card.parameters()).device}: features {feats.shape}, "
          f"card vs CPU {err:.3e} of max|f| (tol {FID_TOL:g}); "
          f"{ips:.1f} images/s at batch {FID_BATCH} (uint8 host images "
          f"in, host features out)", flush=True)
    if not err <= FID_TOL:
        raise AssertionError(f"extractor features {err} > {FID_TOL}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fid_eval.main(["-p", results])
    line = out.getvalue().strip()
    print(f"  sr3_tpu_torch.fid_eval -p <phase 19's results>: {line}",
          flush=True)
    if not (line.startswith("# proxy-FID (seed 0, width 192, 2 real / 2 "
                            "fake): ")
            and math.isfinite(float(line.rsplit(":", 1)[1]))):
        raise AssertionError(f"fid_eval printed {line!r}")
    try:
        fid_eval.main(["-p", results, "--extractor", "inception"])
    except ImportError as e:
        if "torchvision" not in str(e):
            raise
        print(f"  --extractor inception: ImportError {e}", flush=True)
    else:
        raise AssertionError("--extractor inception ran without torchvision")


# ------------------------------------ the last drivers and configs (39-41)
# configs/sr_sr3_64_512.json: the reference's own 512^2 config (63.7M
# parameters, five levels, one res block, 16 groups, attention only in the
# mid block, remat, dropout 0.2); its K1 sites are the attention model's
# (K1_SHAPES_512), its K2 and K3 sites among K2_SITES_512 and K3_SHAPES
CONFIG_512_NOATTN = os.path.join(ROOT, "configs", "sr_sr3_64_512.json")
# sampler tool phase: the 16->128 model, random weights, on the fixture's
# val images at T=20: the first sampler listed twice
SAMPLER_SPECS = ["ddpm:20", "ddpm:20", "ddim:5"]
BENCH_LINES = ["train_step_throughput", "train_step_loader_throughput",
               "sampling_ddim50_eta1_throughput",
               "sampling_dpmpp50_throughput", "sampling_2000step_throughput"]


@phase("64->512 attention-free")
def noattn_512_phase(torch):
    """configs/sr_sr3_64_512.json at full width: its K1 / K2 / K3 sites
    among those phases 3 and 10 check; the float32 batch-1 forward on the
    card against the CPU (FORWARD_TOL); TRAIN_STEPS_512 bf16 remat train
    steps at batch 2 through train_loop (K3 and K4-K6 exactly as often as
    the model's sites say); run_sr of 2 images at T=10; the median ms of a
    batch-8 512^2 p_sample_step, its busy share, peak memory and MFU from
    the counted FLOPs. Returns the launches of the train and serving
    runs."""
    import numpy as np

    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.models.unet import SelfAttention
    from sr3_tpu_torch.training.evaluation import GroupedEvaluator

    k1 = sorted(set(k1_sites(torch, CONFIG_512_NOATTN)))
    k2 = set(k2_sites(torch, CONFIG_512_NOATTN))
    k3 = set(k3_shapes(torch, CONFIG_512_NOATTN))
    same = k1 == sorted(K1_SHAPES_512)
    print(f"  K1 shapes {len(k1)} (sr_sr3_64_512_attn's: {same}); K2 sites "
          f"{sorted(k2)}; K3 maps {sorted(k3)}", flush=True)
    if not same or k2 - set(K2_SITES_512) or k3 - set(K3_SHAPES):
        raise AssertionError("a K1, K2 or K3 site of sr_sr3_64_512 is not "
                             "among those phases 3 and 10 check")

    net = _forward_vs_cpu(torch, CONFIG_512_NOATTN)
    n = sum(p.numel() for p in net.parameters())
    if n != 63_659_203:
        raise AssertionError(f"expected 63,659,203 parameters, got {n:,d}")
    del net

    trainer, opt = _train_trainer(torch, CONFIG_512_NOATTN, TRAIN_STEPS_512)
    b = opt["datasets"]["train"]["batch_size"]
    net = trainer.netG
    n_attn = sum(isinstance(m, SelfAttention) for m in net.modules())
    sites = k3_sites(opt)
    print(f"  train-phase Trainer: compute {net.dtype}, batch {b}, dropout "
          f"{opt['model']['unet']['dropout']}, remat {net.remat}, {n_attn} "
          f"attention call and {sites} statistics-route GroupNorms per "
          f"forward", flush=True)
    if net.dtype != torch.bfloat16 or b != 2 or not net.remat:
        raise AssertionError("sr_sr3_64_512 trains at batch 2, bf16, remat")
    loader = _synthetic_batches(np, TRAIN_STEPS_512, b, seed=40, lr_size=64)
    train = _train_loop_checked(torch, trainer, opt, loader,
                                ONE_DEVICE_KERNELS)
    print(f"  K2 launches in training {train['group_norm']}", flush=True)
    _remat_launches_checked(train, sites, n_attn, TRAIN_STEPS_512)
    _gn_bwd_launches_checked(torch, train, CONFIG_512_NOATTN,
                             TRAIN_STEPS_512)
    del trainer, net
    torch.cuda.empty_cache()

    trainer = _serving_trainer(CONFIG_512_NOATTN)
    items = _upsampled_items(torch, 2, seed=41, lr=64, hr=512)
    ev = GroupedEvaluator(trainer, group_size=2)
    for c in counters():
        c.n = 0
    outs = [o for _, o in ev.run_sr(iter(items))]
    serving = forward_launches()
    finite = all(np.isfinite(o).all() for o in outs)
    print(f"  run_sr {trainer.netG.dtype} B=2, T=10: {len(outs)} images of "
          f"{outs[0].shape}, finite {finite}; launches {serving}",
          flush=True)
    if len(outs) != 2 or outs[0].shape != (512, 512, 3) or not finite:
        raise AssertionError("sr_sr3_64_512 serving outputs")
    if min(serving.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {serving}")

    bt = BATCH_TIME
    sched = make_schedule(trainer.opt["model"]["beta_schedule"]["val"]
                          | {"n_timestep": 2000}, "cuda")
    net = trainer._eval_params()
    gd = torch.Generator(device="cuda").manual_seed(42)
    cond = torch.rand(bt, 3, 512, 512, device="cuda", generator=gd) * 2 - 1
    img = torch.randn(bt, 3, 512, 512, device="cuda", generator=gd)
    t_iter = iter(range(1999, -1, -1))
    step = lambda: trainer.diffusion.p_sample_step(
        net, sched, img, next(t_iter), cond, generator=gd)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_each(torch, step, TIME_STEPS_512)
        step_ms = float(np.median(ms))
        peak = _peak_gib(torch)
        wall, busy = _profile_steps(torch, step, PROFILE_STEPS_512)
    print(f"  UNet step (p_sample_step) B={bt} 512^2 {net.dtype}: median "
          f"{step_ms:.3f} ms/step over {len(ms)} steps (min {min(ms):.3f}, "
          f"max {max(ms):.3f}); busy {100 * busy / wall:.1f}%; peak device "
          f"memory {peak:.2f} GiB; 2000-step throughput extrapolated "
          f"{bt / (2000 * step_ms / 1000):.5f} img/s", flush=True)
    mfu = _mfu(CONFIG_512_NOATTN, bt, step_ms)
    if not 0 < mfu <= 1:
        raise AssertionError(f"MFU {mfu}")
    del trainer, ev, net, cond, img
    torch.cuda.empty_cache()
    return {"64_512_noattn_train": train, "64_512_noattn_serving": serving}


@phase("sampler tool")
def sampler_eval_phase(torch, workdir):
    """python -m sr3_tpu_torch.sampler_eval (in-process) on a random-weight
    .pth of the 16->128 model saved here, the fixture's first two val
    images, T=20, SAMPLER_SPECS, 2 reps; counters zeroed just before, every
    forward kernel launched; finite [image][rep] grids, and the repeated
    sampler's scores equal to the first's, its deltas exactly 0."""
    import numpy as np

    from sr3_tpu_torch import sampler_eval
    from sr3_tpu_torch.models.networks import define_G

    opt = _load_opt()
    opt["datasets"]["val"].update(dataroot=FIXTURES, datatype="img",
                                  data_len=2)
    cfg = os.path.join(workdir, "sampler_eval.json")
    with open(cfg, "w") as f:
        json.dump(opt, f)
    prefix = os.path.join(workdir, "I0_E0")
    net = define_G(opt, device="cpu", seed=5).denoise_fn
    torch.save(net.state_dict(), prefix + "_gen.pth")
    out = os.path.join(workdir, "sampler_eval_out.json")
    for c in counters():
        c.n = 0
    rows = sampler_eval.main([
        "--config", cfg, "--resume", prefix, "--timesteps", "20",
        "--samplers", *SAMPLER_SPECS, "--eta", "1", "--reps", "2",
        "--out", out])
    launches = forward_launches()
    with open(out) as f:
        report = json.load(f)
    first, again = rows[0], rows[1]
    deltas = {k: v for k, v in again.items() if k.startswith("d_")}
    print(f"  rows {[r['sampler'] for r in rows]}, avg PSNR "
          f"{[r['avg_psnr_db'] for r in rows]}, seconds "
          f"{[r['sample_seconds_total'] for r in rows]}; the repeated "
          f"sampler's deltas {deltas}; launches {launches}", flush=True)
    if report["results"] != rows or len(rows) != len(SAMPLER_SPECS):
        raise AssertionError("the artifact does not hold the rows")
    for r in rows:
        grid = np.asarray(r["psnr_db"])
        if grid.shape != (2, 2) or not np.isfinite(grid).all():
            raise AssertionError(f"{r['sampler']}: PSNR grid {grid}")
    if again["psnr_db"] != first["psnr_db"] or \
            again["ssim"] != first["ssim"] or len(deltas) != 6 or \
            any(v != 0 for v in deltas.values()):
        raise AssertionError(f"the repeated sampler differs: {deltas}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    return launches


@phase("bench")
def bench_phase(torch):
    """python -m sr3_tpu_torch.bench in a subprocess, default config, with
    BENCH_STEPS=200: its five lines in the JAX bench's order, every number
    finite (value, vs_baseline, batch and step times positive), 0 < mfu <=
    1 on the train and headline lines, the card's name on every line."""
    import math

    env = dict(os.environ, BENCH_STEPS="200", PYTHONPATH=ROOT)
    env.pop("SR3_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-m", "sr3_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            print("  " + line, flush=True)
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith("{")]
    for m in lines:
        print("  " + json.dumps(m), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"bench exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    want = [f"sr_sr3_16_128_{k}" for k in BENCH_LINES]
    if [m["metric"] for m in lines] != want:
        raise AssertionError(f"bench lines {[m['metric'] for m in lines]}")
    name = torch.cuda.get_device_name(0)
    for m in lines:
        nums = {k: v for k, v in m.items() if isinstance(v, (int, float))
                and not isinstance(v, bool)}
        bad = [k for k, v in nums.items() if not math.isfinite(v) or v < 0
               or (k in ("value", "vs_baseline", "batch", "step_ms")
                   and v <= 0)]
        if bad or m["device"] != name:
            raise AssertionError(f"{m['metric']}: {bad}, device "
                                 f"{m['device']}")
    for m in (lines[0], lines[-1]):
        if not (m["mfu"] is not None and 0 < m["mfu"] <= 1):
            raise AssertionError(f"{m['metric']}: mfu {m['mfu']}")
    return lines


# ---------------------------------------------------------------------------
# The parallel phases (30-33): two ranks started by parallel_phase through
# torch.distributed.run, each running ``chip_smoke.py --rank DIR
# BACKEND`` (rank_main): nccl with one card a rank where the machine has two
# or more, else gloo with both ranks on the one card.

PAR_RANKS = 2
PAR_STEPS = 3
PAR_TIMEOUT = 420
SPACE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SPACE_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
KERNELS_SPACE = ("gn_silu_conv3x3_halo", "gn_stats", "flash_attention_fwd")
KERNELS_SPACE_TRAIN = KERNELS_SPACE + ("flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq")


def _rank_print(*a):
    print(f"[rank {os.environ.get('RANK')}]", *a, flush=True)


def _sha(torch, tensors):
    """sha256 of the bytes of ``tensors`` (a bit-equality checksum)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rank_collectives(torch, dist, device, backend):
    """The collectives the port uses (all_reduce SUM and MAX, all_gather,
    barrier) on tensors on the card, each result checked."""
    r, n = dist.get_rank(), dist.get_world_size()
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        t = torch.full((5, 3), r + 1, dtype=dt, device=device)
        dist.all_reduce(t)
        want = n * (n + 1) / 2
        parts = [torch.empty(4, dtype=dt, device=device) for _ in range(n)]
        dist.all_gather(parts, torch.full((4,), r, dtype=dt, device=device))
        ok = (t.float() == want).all().item() and all(
            (p.float() == i).all().item() for i, p in enumerate(parts))
        if not ok:
            raise AssertionError(f"{backend} collectives on {dt} CUDA "
                                 f"tensors gave wrong results")
    t = torch.tensor([r], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    dist.barrier()
    _rank_print(f"{backend}: all_reduce (SUM, MAX) and all_gather of "
                f"float32 / bfloat16 / int64 tensors on {device}: ok")


def _injected(torch, b, size, seed, rows):
    """Global seeded draws of a b-image batch (noise, sqrt-gamma) cut to
    ``rows``, and a dropout_mask stand-in drawing call k's global mask from
    seed + k and cutting it to ``rows``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn(b, 3, size, size, device="cuda", generator=g)
    gamma = 0.4 + 0.5 * torch.rand(b, 1, device="cuda", generator=g)
    calls = [0]

    def mask(x, keep, generator=None):
        calls[0] += 1
        gm = torch.Generator(device="cuda").manual_seed(seed + calls[0])
        shape = (b,) + tuple(x.shape[1:])
        return (torch.rand(shape, device="cuda", generator=gm) < keep)[rows]

    return {"noise": noise[rows].contiguous(),
            "sqrt_gamma": gamma[rows].contiguous()}, mask


def _injected_loss(torch, trainer, batch, rows, seed):
    """One float32 optimize_parameters step with injected global draws cut
    to ``rows``; returns the logged loss (the data-group mean)."""
    import functools

    from sr3_tpu_torch.ops import dropout as port_dropout

    injected, mask = _injected(torch, 4, 128, seed, rows)
    saved = port_dropout.dropout_mask
    port_dropout.dropout_mask = mask
    trainer.diffusion.p_losses = functools.partial(
        trainer.diffusion.p_losses, injected=injected)
    try:
        trainer.feed_data(batch)
        trainer.optimize_parameters()
    finally:
        port_dropout.dropout_mask = saved
        del trainer.diffusion.p_losses
    return trainer.get_current_log()["l_pix"]


def _grads(trainer):
    """{name: float32 gradient on the host} of the trainer's UNet."""
    return {n: p.grad.detach().float().cpu()
            for n, p in trainer.netG.named_parameters() if p.grad is not None}


def rank_data(torch, backend, device, out_dir):
    """sr_sr3_16_128 at full width under data = 2: global batch 4 (2 a
    rank), bf16, PAR_STEPS train steps; per step the parameters' checksum,
    the data-mean loss, ms and the all-reduced bytes; then PAR_STEPS
    float32 steps with injected global draws: their losses, and the
    primary saves the all-reduced gradients of the first to
    ``out_dir/grads_data2.pt`` (both against one process's)."""
    import numpy as np

    from sr3_tpu_torch.parallel.mesh import init_mesh, shard_batch
    from sr3_tpu_torch.training.trainer import create_model

    mesh = init_mesh({"data": 2}, backend=backend, device=device)
    _rank_print(f"data phase: {mesh}")
    opt = _load_opt(phase="train", config=CONFIG)
    opt["parallel"] = {"data": 2}
    trainer = create_model(opt, mesh=mesh)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   "train")
    batches = _synthetic_batches(np, PAR_STEPS, 4, seed=30)
    torch.cuda.reset_peak_memory_stats()
    for c in counters():
        c.n = 0
    sums, losses, ms = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.feed_data(shard_batch(b, mesh))
        trainer.optimize_parameters()
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
        losses.append(trainer.get_current_log()["l_pix"])
        sums.append(_sha(torch, trainer.netG.parameters()))
    launches = launches_of(KERNELS_16_128)
    out = {"checksums": sums, "losses": losses, "ms": ms,
           "reduced_bytes": trainer.reduced_bytes, "launches": launches,
           "peak_gib": _peak_gib(torch)}
    _rank_print(f"  bf16 train steps at 2 a rank: losses {losses}; ms "
                f"{[round(x, 1) for x in ms]}; all-reduced "
                f"{trainer.reduced_bytes / 1e6:.1f} MB a step; checksums "
                f"{sums}; peak {out['peak_gib']:.2f} GiB; launches {launches}")
    if min(launches.values()) <= 0 or not np.isfinite(losses).all():
        raise AssertionError(f"data phase: launches {launches}, losses "
                             f"{losses}")
    del trainer
    torch.cuda.empty_cache()
    opt = _load_opt(dtype="float32", phase="train", config=CONFIG)
    opt["parallel"] = {"data": 2}
    trainer = create_model(opt, mesh=mesh)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   "train")
    rows = slice(2 * mesh.data.rank, 2 * mesh.data.rank + 2)
    out["f32_losses"] = []
    for i, b in enumerate(batches):
        out["f32_losses"].append(_injected_loss(
            torch, trainer, shard_batch(b, mesh), rows, 31 + 100 * i))
        if i == 0 and mesh.is_primary:
            torch.save(_grads(trainer),
                       os.path.join(out_dir, "grads_data2.pt"))
    _rank_print(f"  float32 steps with injected global draws: losses "
                f"{out['f32_losses']}")
    del trainer
    torch.cuda.empty_cache()
    return out


def _state_bytes(trainer):
    """Bytes of the parameters, the Adam moments and the EMA."""
    n = sum(p.numel() * p.element_size() for p in trainer.netG.parameters())
    n += sum(t.numel() * t.element_size()
             for st in trainer.optimizer.state.values()
             for t in st.values() if t.dim() > 0)
    if trainer.ema is not None:
        n += sum(t.numel() * t.element_size() for t in trainer.ema.values())
    return n


def rank_model(torch, backend, device):
    """sr_sr3_16_128 under model = 2: the float32 forward of the sharded
    UNet against the unsharded one (FORWARD_TOL_MODEL), one bf16 train
    step with EMA, and the parameter + Adam + EMA bytes a rank."""
    import numpy as np

    from sr3_tpu_torch.models.networks import count_params, define_G
    from sr3_tpu_torch.parallel.mesh import init_mesh
    from sr3_tpu_torch.training.trainer import create_model

    mesh = init_mesh({"model": 2}, backend=backend, device=device)
    _rank_print(f"model phase: {mesh}")
    net = define_G(_load_opt(dtype="float32", config=CONFIG),
                   device=device, seed=0).denoise_fn
    n_full = count_params(net)
    g = torch.Generator(device="cuda").manual_seed(40)
    x = torch.randn(2, 6, 128, 128, device="cuda", generator=g)
    cond = torch.tensor([0.3, 0.8], device="cuda")
    with torch.inference_mode():
        ref = net(x, cond)
    net.set_parallel(mesh)
    for c in counters():
        c.n = 0
    with torch.inference_mode():
        got = net(x, cond)
    launches = launches_of(FORWARD_KERNELS)
    rel, _ = rel_err(got, ref)
    _rank_print(f"  float32 forward B=2, sharded against unsharded: rel "
                f"{rel:.3e} tol {SPACE_TOL['float32']:g}; launches "
                f"{launches}; {count_params(net):,d} of {n_full:,d} "
                f"parameters on this rank")
    if not rel <= SPACE_TOL["float32"] or min(launches.values()) <= 0:
        raise AssertionError(f"model forward: rel {rel}, {launches}")
    del net, ref, got
    opt = _load_opt(phase="train", config=CONFIG)
    opt["parallel"] = {"model": 2}
    opt["train"]["ema_scheduler"] = {"use_ema": True, "ema_decay": 0.9999,
                                     "step_start_ema": 0}
    trainer = create_model(opt, mesh=mesh)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   "train")
    (b,) = _synthetic_batches(np, 1, 4, seed=41)
    torch.cuda.reset_peak_memory_stats()
    for c in counters():
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.feed_data(b)
    trainer.optimize_parameters()
    loss = trainer.get_current_log()["l_pix"]
    torch.cuda.synchronize()
    ms = 1000 * (time.perf_counter() - t0)
    train_launches = launches_of(KERNELS_16_128)
    state = _state_bytes(trainer)
    full = n_full * (4 + 8 + 4)
    out = {"forward_rel": rel, "launches": train_launches, "ms": ms,
           "loss": loss, "state_bytes": state, "full_state_bytes": full,
           "peak_gib": _peak_gib(torch), "forward_launches": launches}
    _rank_print(f"  bf16 train step, batch 4: loss {loss:.5f}, {ms:.1f} ms "
                f"(first step), peak {out['peak_gib']:.2f} GiB; parameter + "
                f"Adam + EMA {state / 1e6:.1f} MB a rank against "
                f"{full / 1e6:.1f} MB on one device; launches "
                f"{train_launches}")
    if not np.isfinite(loss) or min(train_launches.values()) <= 0:
        raise AssertionError(f"model step: loss {loss}, {train_launches}")
    del trainer
    torch.cuda.empty_cache()
    return out


def _halo_recorder(conv_fused):
    """Wrap K1's halo entry so that each (shape, C_out, dtype, halo rows,
    residual, bias) it launches with is recorded; returns the record."""
    seen = {}
    launch = conv_fused._fwd_halo

    def recorded(x, top, bottom, mult, add, weight, bias, residual):
        key = (tuple(x.shape), int(weight.shape[0]), str(x.dtype)[6:],
               top is not None, bottom is not None, residual is not None)
        seen[key] = seen.get(key, 0) + 1
        return launch(x, top, bottom, mult, add, weight, bias, residual)

    conv_fused._fwd_halo = recorded
    return seen, launch


def _check_halo_sites(torch, conv_fused, launch, seen, errs):
    """Every recorded halo-entry site against the plain version on seeded
    inputs of its shape (error relative to max|plain| within SPACE_TOL);
    returns the bf16 tiles those checks launched."""
    checked = {}
    g = torch.Generator(device="cuda").manual_seed(50)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    cl = torch.channels_last
    for (shape, cout, dt, top, bottom, res), n in sorted(seen.items()):
        dtype = getattr(torch, dt)
        b, cin, h, w = shape
        row = lambda on: (r(b, cin, 1, w).to(dtype).contiguous(
            memory_format=cl) if on else None)
        args = (r(*shape).to(dtype).contiguous(memory_format=cl), row(top),
                row(bottom), 1 + 0.3 * r(b, cin), 0.2 * r(b, cin),
                (r(cout, cin, 3, 3) / (3 * cin ** 0.5)).to(dtype)
                .contiguous(memory_format=cl), 0.1 * r(cout),
                r(b, cout, h, w).to(dtype).contiguous(memory_format=cl)
                if res else None)
        conv_fused.bf16_tile_launches(reset=True)
        out = launch(*args)
        ref = conv_fused.gn_silu_conv3x3_halo_plain(*args)
        torch.cuda.synchronize()
        for k, v in conv_fused.bf16_tile_launches().items():
            if v:
                checked[k] = True
        rel, absd = rel_err(out, ref)
        e = errs.setdefault(dt, [0.0, 0.0, 0])
        e[0], e[1], e[2] = max(e[0], absd), max(e[1], rel), e[2] + 1
        ok = rel <= SPACE_TOL[dt]
        _rank_print(f"  halo K1 {dt} {b}x{cin}x{h}x{w}->{cout} top {top} "
                    f"bottom {bottom} ({n} launches on the paths): rel "
                    f"{rel:.3e} abs {absd:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"halo K1 {dt} {shape}->{cout}: rel {rel}")
        del args, out, ref
    return set(checked)


def _space_grads(torch, diffusion, sched, batch, seed):
    """(loss, {name: gradient}) of one p_losses with a generator of
    ``seed``; on a space mesh the gradients summed over the ranks."""
    import torch.distributed as dist

    net = diffusion.denoise_fn.train()
    net.zero_grad(set_to_none=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    loss = diffusion.p_losses(net, sched, batch, g)
    loss.backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    if net.space is not None:
        for t in grads.values():
            dist.all_reduce(t, group=net.space.group)
    return loss.item(), grads


def rank_space(torch, backend, device):
    """sr_sr3_64_512_attn under space = 2 (and the batch-8 1024^2 step of
    sr_sr3_128_1024): every forward and step against the same module
    unsharded, run first on the same rank; every halo-entry site checked
    against the plain version; peak memory a rank."""
    import numpy as np

    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.models.schedule import make_schedule
    from sr3_tpu_torch.ops import conv_fused
    from sr3_tpu_torch.parallel.mesh import init_mesh

    mesh = init_mesh({"space": 2}, backend=backend, device=device)
    _rank_print(f"space phase: {mesh}")
    seen, launch = _halo_recorder(conv_fused)
    used = set()  # the bf16 tiles the sharded runs launched

    def tiles():
        return {k for k, v in conv_fused.bf16_tile_launches(reset=True)
                .items() if v}

    out, cl = {}, torch.channels_last
    g = torch.Generator(device="cuda").manual_seed(60)
    for dt, b in (("bfloat16", 8), ("float32", 1)):
        opt = _load_opt(dtype=dt, phase="train", config=CONFIG_512)
        diffusion = define_G(opt, device=device, seed=0)
        net = diffusion.denoise_fn.eval()
        x = torch.randn(b, 6, 512, 512, device="cuda", generator=g)
        cond = torch.rand(b, device="cuda", generator=g)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ref = net(x, cond)
        ref_peak = _peak_gib(torch)
        sched = make_schedule(opt["model"]["beta_schedule"]["train"],
                              "cuda")
        batch = {k: (torch.rand(2, 3, 512, 512, device="cuda", generator=g)
                     * 2 - 1).contiguous(memory_format=cl)
                 for k in ("HR", "SR")}
        torch.cuda.reset_peak_memory_stats()
        ref_grads = _space_grads(torch, diffusion, sched, batch, 61)
        ref_train_peak = _peak_gib(torch)
        net.set_parallel(mesh)
        net.eval()
        torch.cuda.reset_peak_memory_stats()
        for c in counters():
            c.n = 0
        tiles()
        with torch.inference_mode():
            got = net(x, cond)
        serving = launches_of(KERNELS_SPACE)
        rel, _ = rel_err(got, ref)
        key = f"{dt}_b{b}"
        out[key] = {"rel": rel, "launches": serving,
                    "peak_gib": _peak_gib(torch),
                    "unsharded_peak_gib": ref_peak}
        if dt == "bfloat16":
            with torch.inference_mode():
                step = _time_each(torch, lambda: net(x, cond), 3)
            out[key]["ms"] = step
        used |= tiles()
        _rank_print(f"  {dt} forward B={b} at 512^2, sharded against "
                    f"unsharded: rel {rel:.3e} tol {SPACE_TOL[dt]:g}; peak "
                    f"{out[key]['peak_gib']:.2f} GiB (unsharded "
                    f"{ref_peak:.2f}); ms "
                    f"{out[key].get('ms')}; launches {serving}")
        if not rel <= SPACE_TOL[dt] or min(serving.values()) <= 0:
            raise AssertionError(f"space forward {dt}: rel {rel}, {serving}")
        del ref, got
        for c in counters():
            c.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = _space_grads(torch, diffusion, sched, batch, 61)
        torch.cuda.synchronize()
        train_ms = 1000 * (time.perf_counter() - t0)
        train = launches_of(KERNELS_SPACE_TRAIN)
        used |= tiles()
        loss_rel, worst, worst_rel = _compare_grads((loss, grads), ref_grads)
        out[f"{dt}_train"] = {"loss_rel": loss_rel, "worst_rel": worst_rel,
                              "launches": train, "ms": train_ms,
                              "peak_gib": _peak_gib(torch),
                              "unsharded_peak_gib": ref_train_peak}
        _rank_print(f"  {dt} loss and backward, batch 2, remat, sharded "
                    f"against unsharded: loss rel {loss_rel:.3e}, worst of "
                    f"{len(grads)} gradients {worst} rel {worst_rel:.3e} tol "
                    f"{SPACE_GRAD_TOL[dt]:g}; {train_ms:.1f} ms, peak "
                    f"{_peak_gib(torch):.2f} GiB (unsharded "
                    f"{ref_train_peak:.2f}); launches {train}")
        if not (loss_rel <= SPACE_GRAD_TOL[dt]
                and worst_rel <= SPACE_GRAD_TOL[dt]) or \
                min(train.values()) <= 0:
            raise AssertionError(f"space gradients {dt}: {loss_rel}, {worst} "
                                 f"{worst_rel}, {train}")
        del diffusion, net, grads, ref_grads, batch
        torch.cuda.empty_cache()
    # the 128->1024 batch-8 step
    opt = _load_opt(dtype="bfloat16", config=CONFIG_1024)
    net = define_G(opt, device=device, seed=0).denoise_fn.eval()
    net.set_parallel(mesh)
    x = torch.randn(8, 6, 1024, 1024, device="cuda", generator=g)
    cond = torch.rand(8, device="cuda", generator=g)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters():
        c.n = 0
    tiles()
    with torch.inference_mode():
        y = net(x, cond)
        launches = launches_of(KERNELS_SPACE)
        step = _time_each(torch, lambda: net(x, cond), 2)
    used |= tiles()
    out["1024"] = {"launches": launches, "ms": step,
                   "peak_gib": _peak_gib(torch),
                   "finite": bool(torch.isfinite(y).all().item())}
    _rank_print(f"  bf16 batch-8 1024^2 UNet step under space 2: ms "
                f"{[round(s, 2) for s in step]}, peak {_peak_gib(torch):.2f} "
                f"GiB a rank (one device: 8.24 GiB, PERF.md); launches "
                f"{launches}")
    if not out["1024"]["finite"] or min(launches.values()) <= 0:
        raise AssertionError(f"1024 step: {out['1024']}")
    del net, x, y
    torch.cuda.empty_cache()
    errs = {}
    conv_fused._fwd_halo = launch
    checked = _check_halo_sites(torch, conv_fused, launch, seen, errs)
    out["halo"] = {"sites": len(seen), "errs": errs,
                   "tiles_used": sorted(used), "tiles_checked":
                   sorted(checked)}
    if not used <= checked:
        raise AssertionError(f"halo K1 tiles launched but not checked: "
                             f"{used - checked}")
    return out


def rank_main(out_dir, backend):
    """One rank of the parallel phases (started by parallel_phase)."""
    import torch
    import torch.distributed as dist

    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", local if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sr3_tpu_torch.ops import _build

    _build.load_library()
    dist.init_process_group(backend, init_method="env://")
    _rank_print(f"{backend}, {dist.get_world_size()} ranks, this one on "
                f"{device} ({torch.cuda.get_device_name(device)})")
    rank_collectives(torch, dist, device, backend)
    res = {"data": rank_data(torch, backend, device, out_dir),
           "model": rank_model(torch, backend, device),
           "space": rank_space(torch, backend, device)}
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _run_ranks(out_dir, backend):
    """``chip_smoke.py --rank out_dir backend`` on PAR_RANKS local ranks
    through ``torch.distributed.run --standalone`` (which stops the other
    ranks when one fails); prints their output, raises if one failed. The
    whole process group is killed after PAR_TIMEOUT seconds."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={PAR_RANKS}", os.path.abspath(__file__),
           "--rank", out_dir, backend]
    env = dict(os.environ, PYTHONPATH=ROOT,
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1)
                                       // PAR_RANKS)))
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=PAR_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        print(text[-8000:], flush=True)
        raise AssertionError(f"ranks still running after {PAR_TIMEOUT} s")
    print(text, end="", flush=True)
    if proc.returncode:
        raise AssertionError(f"the ranks exited with {proc.returncode}")


@phase("parallel ranks")
def parallel_phase(torch):
    """Phases 30-33: two ranks (rank_main) run the data-parallel,
    tensor-parallel and spatial paths; their output is printed here and
    their results held against each other and against one process."""
    import tempfile

    import numpy as np

    n = torch.cuda.device_count()
    backend = "nccl" if n >= PAR_RANKS else "gloo"
    print(f"  {PAR_RANKS} ranks over {backend}: " + (
        "one card each" if backend == "nccl" else
        f"both on the one card ({torch.cuda.get_device_name(0)})"),
        flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _run_ranks(tmp, backend)
        res = []
        for r in range(PAR_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        grads_data2 = torch.load(os.path.join(tmp, "grads_data2.pt"))
    data = [r["data"] for r in res]
    if data[0]["checksums"] != data[1]["checksums"]:
        raise AssertionError(f"parameters differ across data ranks: "
                             f"{[d['checksums'] for d in data]}")
    print(f"  data: parameters bit-equal across ranks after each of "
          f"{PAR_STEPS} steps ({data[0]['checksums']})", flush=True)
    # one process, the same injected global draws, float32: every step's
    # loss, and the first step's gradients (Adam's update does not see a
    # reduction that forgets to divide, the gradients do)
    from sr3_tpu_torch.training.trainer import create_model

    opt = _load_opt(dtype="float32", phase="train", config=CONFIG)
    trainer = create_model(opt)
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                                   "train")
    ones = []
    for i, b in enumerate(_synthetic_batches(np, PAR_STEPS, 4, seed=30)):
        ones.append(_injected_loss(torch, trainer, b, slice(0, 4),
                                   31 + 100 * i))
        if i == 0:
            grads_one = _grads(trainer)
    rels = [abs(a - b) / abs(b) for a, b in zip(data[0]["f32_losses"], ones)]
    print(f"  data: float32 losses over 2 ranks {data[0]['f32_losses']} "
          f"against one process {ones}: rel {[f'{r:.3e}' for r in rels]} "
          f"tol 1e-4", flush=True)
    if set(grads_data2) != set(grads_one):
        raise AssertionError(f"data-parallel gradients: leaves differ: "
                             f"{set(grads_data2) ^ set(grads_one)}")
    worst, where = 0.0, None
    for name, g in grads_one.items():
        rel = float((grads_data2[name] - g).abs().max()
                    / g.abs().max().clamp_min(1e-30))
        if rel >= worst:
            worst, where = rel, name
    print(f"  data: float32 all-reduced gradients of step 1 against one "
          f"process: worst of {len(grads_one)} leaves {where} rel "
          f"{worst:.3e} of its max|g|, tol 1e-4", flush=True)
    if not (len(rels) == PAR_STEPS and max(rels) <= 1e-4 and worst <= 1e-4):
        raise AssertionError(f"data-parallel float32 steps: loss rel {rels}, "
                             f"gradient rel {worst} ({where})")
    del trainer
    torch.cuda.empty_cache()
    return res[0], backend


@phase("K1 halo entry timing")
def halo_timing_phase(torch):
    """K1's halo entry at a 64->512 serving shard under space = 2 (bf16,
    8x64x256x512->64, both halo rows, residual) beside its plain version
    and beside K1's own entry (its statistics launch and conv) on a map of
    the shard's shape; bound_ms as the other kernels'."""
    from sr3_tpu_torch.ops import conv_fused

    g = torch.Generator(device="cuda").manual_seed(70)
    dt, cl = torch.bfloat16, torch.channels_last
    b, cin, cout, h, w = 8, 64, 64, 256, 512
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    row = lambda: r(b, cin, 1, w).to(dt).contiguous(memory_format=cl)
    wt = (r(cout, cin, 3, 3) / (3 * cin ** 0.5)).to(dt).contiguous(
        memory_format=cl)
    x = r(b, cin, h, w).to(dt).contiguous(memory_format=cl)
    res = r(b, cout, h, w).to(dt).contiguous(memory_format=cl)
    args = (x, row(), row(), 1 + 0.3 * r(b, cin), 0.2 * r(b, cin), wt,
            0.1 * r(cout), res)
    shape = f"{b}x{cin}x{h}x{w}->{cout} +halo rows+residual"
    flops = 2 * b * h * w * cin * cout * 9
    nbytes = 2 * (b * h * w * (cin + 2 * cout) + 2 * b * w * cin
                  + cout * 9 * cin) + 4 * (2 * b * cin + cout)
    out = _time_entry(torch, "gn_silu_conv3x3_halo", shape,
                      lambda: conv_fused.gn_silu_conv3x3_halo(*args),
                      lambda: conv_fused.gn_silu_conv3x3_halo_plain(*args),
                      None, flops, nbytes)
    gw, gb = 1 + 0.2 * r(cin), 0.1 * r(cin)
    pb = 0.5 * r(b, cin)
    k1 = _time_entry(
        torch, "gn_silu_conv3x3 (its own entry, same shape)",
        f"{b}x{cin}x{h}x{w}->{cout} +film+residual",
        lambda: conv_fused.gn_silu_conv3x3(x, gw, gb, wt, args[6], 16,
                                           pre_bias=pb, residual=res),
        lambda: conv_fused.gn_silu_conv3x3_plain(x, gw, gb, wt, args[6], 16,
                                                 pre_bias=pb, residual=res),
        None, flops, nbytes - 4 * b * w * cin)
    out["k1_same_shape_ms"] = k1["ms"]
    out["k1_same_shape_device_ms"] = k1["device_ms"]
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    results = os.path.join(workdir, "results")
    try:
        device_phase(torch)
        build_phase()
        errs = {}
        # the SR3 16->128 serving and training paths
        checked_tiles, checked_clusters, checked_k4, checked_bwd = \
            kernel_phase(torch, errs)
        k1_class_phase(checked_tiles, "phase 3")
        k4_class_phase(checked_k4, "phase 3")
        bwd_class_phase(checked_bwd, "phase 3")
        gn_launch_phase(torch)
        trainer = model_phase(torch)
        serving = serving_phase(torch, trainer)
        times = timing_phase(torch, trainer)
        trace_phase(torch, trainer, workdir)
        strided = strided_phase(torch, trainer)
        val = val_phase(torch, trainer, results)
        fid_phase(torch, results)
        del trainer
        trainer, launches_128 = training_phase(torch)
        grad_check_phase(torch)
        _, train_times = train_timing_phase(torch, trainer)
        times.update(train_times)
        f32_state_bytes = _optimizer_state_bytes(trainer)
        del trainer
        # the host data pipeline from the committed PNGs, and LMDB
        trainer, launches_files = loader_phase(torch, workdir)
        launches_lmdb = lmdb_phase(torch, trainer, workdir)
        del trainer
        torch.cuda.empty_cache()
        # the SR3 64->512 training path, and its serving path
        k3_phase(torch, errs)
        long_k4, long_bwd = long_attention_phase(torch, errs)
        checked_k4 |= long_k4
        checked_bwd |= long_bwd
        k4_class_phase(checked_k4, "phase 3")
        bwd_class_phase(checked_bwd, "phase 3")
        trainer, launches = training_512_phase(torch)
        grad_check_512_phase(torch)
        bf16_attention_grad_phase(torch)
        train_timing_512_phase(torch, trainer)
        del trainer
        serving_512 = serving_512_phase(torch)
        timings = kernel_timing_512_phase(torch)
        launches_adm, timings_adm = adm_phase(torch)
        timings_k1 = k1_class_timing_phase(torch)
        k4_class_phase(checked_k4, "phase 11")
        # the rest of the sampling surface: ddpm, unconditional
        ddpm = ddpm_phase(torch)
        uncond = uncond_phase(torch)
        timings_ddpm_128 = kernel_timing_ddpm_128_phase(torch, errs,
                                                        checked_bwd)
        bwd_class_phase(checked_bwd, "phase 11")
        # the 128->1024 stage, the cascade, the bf16 first moment and the
        # device-resident dataset
        model_1024_phase(torch)
        paths = {"128_1024_serving": serving_1024_phase(torch),
                 "128_1024_train": training_1024_phase(torch),
                 "cascade_128_1024": cascade_phase(torch),
                 "16_128_train_mu_bf16": mu_bf16_phase(torch,
                                                       f32_state_bytes),
                 "16_128_train_device_data": resident_phase(torch)}
        timings_1024 = kernel_timing_1024_phase(torch)
        # the reference's attention-free 512^2 config, the sampler tool and
        # the bench
        paths.update(noattn_512_phase(torch))
        paths["16_128_sampler_eval"] = sampler_eval_phase(torch, workdir)
        torch.cuda.empty_cache()
        bench_phase(torch)
        k1_class_phase(checked_tiles, "phase 3")
        k2_cluster_phase(checked_clusters)
        k4_class_phase(checked_k4, "phase 17")
        bwd_class_phase(checked_bwd, "phase 22")
        # the parallel paths (two ranks) and K1's halo entry
        par, backend = parallel_phase(torch)
        timings["gn_silu_conv3x3_halo"] = halo_timing_phase(torch)
    except Exception:  # report any phase's failure, print no result
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    halo = par["space"]["halo"]["errs"]
    errs["gn_silu_conv3x3_halo"] = {
        "max_abs_err": max(e[0] for e in halo.values()),
        "max_rel_err": max(e[1] for e in halo.values())}
    launches["gn_silu_conv3x3_halo"] = \
        par["space"]["bfloat16_b8"]["launches"]["gn_silu_conv3x3_halo"]
    new_paths = {
        "16_128_train_data2": par["data"]["launches"],
        "16_128_train_model2": par["model"]["launches"],
        "16_128_forward_model2": par["model"]["forward_launches"],
        "64_512_serving_space2": par["space"]["bfloat16_b8"]["launches"],
        "64_512_train_space2": par["space"]["bfloat16_train"]["launches"],
        "128_1024_serving_space2": par["space"]["1024"]["launches"],
        "16_128_train_files": launches_files,
        "16_128_train_lmdb": launches_lmdb,
        "adm_128_512_serving": launches_adm}
    kernels = []
    for name, (source, replaces, routes) in KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "route_by_dtype": routes,
            "source": source, "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": errs[name]["max_abs_err"],
            "max_rel_err": errs[name]["max_rel_err"],
            **timings[name],
            "launches_16_128_train": launches_128.get(name, 0),
            "launches_16_128_serving": serving.get(name, 0),
            "launches_64_512_serving": serving_512.get(name, 0),
            "launches_16_128_val": val.get(name, 0),
            "launches_ddpm_16_128_serving": ddpm["serving"].get(name, 0),
            "launches_ddpm_16_128_train": ddpm["train"].get(name, 0),
            **{f"launches_{k}": v.get(name, 0) for k, v in uncond.items()},
            **{"launches_16_128_" + label.lower().replace(" ", "_")
               .replace("+", "p").replace("-", "_"): v.get(name, 0)
               for label, v in strided.items()},
        }
        entry.update({f"launches_{k}": v.get(name, 0)
                      for k, v in paths.items()})
        entry.update({f"launches_{k}": v.get(name, 0)
                      for k, v in new_paths.items()})
        entry["parallel_backend"] = backend
        if name in timings_ddpm_128:
            entry["timings_sample_ddpm_128"] = timings_ddpm_128[name]
        if name in timings_1024:
            entry["timings_128_1024"] = timings_1024[name]
        if name == "gn_silu_conv3x3":
            entry["timings_adm_128_512"] = timings_adm
            entry["timings_k1_classes"] = timings_k1
        if name in times:
            entry["ms_16_128"], entry["plain_ms_16_128"] = times[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--rank"]:  # one rank of parallel_phase
        sys.exit(rank_main(*sys.argv[2:4]))
    sys.exit(main())
