"""Smoke run of the PyTorch/CUDA port (small_vision_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. build     nvcc builds every kernel under small_vision_tpu_torch/csrc/
               (refused where ptxas serialised wgmma products for a
               divergent path, C7520), with its seconds and ptxas's
               registers, spills and notes of each attention kernel at
               three and four 64-column tiles a head, and of the f32
               attention kernels on 3xTF32 wgmma at N = 40 and 56.
  2. kernels   each kernel against its plain PyTorch version on the card,
               with its time, the plain version's, one library call's and
               the bound: the forwards K1, K3, K7 at the shapes of the
               UMD-B/4@64 sampler at batch 64 (L = 260 and 257; K1 and K3
               also at the training shapes; K7 also at the shape of phase
               6, and timed there too), the backwards K2, K4, K8 at the
               training shapes (per-branch batch 128, L = 68, 164, 257),
               each launched twice to show equal bits (K2 three times in a
               row, and twice at once on two streams at (128, 257)
               modulated and (128, 68), which must give the bits of the
               same two launches in turn; K8 also at L = 65 and at (8,
               1,024), past its old limit, and with the time of each of
               its two kernels), the fused MLP and MHA (K5, K6) at both,
               each launched twice to show equal bits and with the time of
               each of its kernels (K5's two, K6's three), K5 also at
               width 1,024 with hidden 4,096, and the seven arms of the
               ablation kernel (K9) at the tool's two shapes, each
               launched twice to show equal bits. K1 and K2 also at the
               widths of UMD-S (384) and runlocal (64), timed, and of the
               probe's quick config (32) and ViT-G (1,664), checked; K3
               and K4 at head dims 128, 192 and 256 (6, 4 and 3 heads at
               768), timed beside SDPA and its backward, and at 8, 16, 80,
               104, 136, 200 and 248, checked; each at the sampler's and
               the training shapes, launched twice (K2 three times, and
               twice at once on two streams). K6, K7, K8 and the seven
               arms of K9 at head dims 80 (16 heads at 1,280, ViT-H's),
               128, 192 and 256 (6, 4 and 3 heads at 768), timed beside
               their library calls and bounds (K6 and K7 at the sampler's
               and the training shapes, K6 at 80 also at ViT-H/14@224's
               (64, 256), K8 at the training shapes, K9 at the tool's
               two), and at 8, 16, 88, 104, 136, 200 and 248, checked,
               each launched twice to show equal bits; every attention
               kernel at head dim 256 at (4, 1,024) and (1, 4,096), and K6
               at width 1,024 in 4 heads of 256, checked. The shapes the
               GEMM's tails and the padded heads opened, each timed: K5 at
               ViT-mu's 32 -> 128 at (64, 196) and (64, 197), at SigLIP
               So400m's 1,152 -> 4,304 at (64, 256) and at 36 -> 150 (run
               on copies padded to 40 -> 152) at (64, 197); K6 at width
               32 in 2 heads of 16 at (64, 196) and (64, 197), and on a
               tensor rank's 3 of 12 heads of 32 (96 columns) and 3 of 32
               heads of 12 (36 columns, run at 48) at width 384; K3, K4
               and K6-K9 at head dim 12 (32 heads at 384, `heads=32` on
               UMD-S; run on heads zero-padded to 16) and K3, K4 at head
               dim 4 (32 heads at 128). Head dims 264 and 0 must make each
               of the six wrappers raise, with no launch, and 12 launch
               each once. K1-K4 in f32 (their f32 instances, "*_f32" in
               the kernels line) at the model's shapes, timed beside their
               f32 bounds, plain versions and library calls in f32 (y and
               dx within 1e-5 of their largest value, the sums, o, dq, dk
               and dv within 1e-4; K1 and K3 two launches, K2 three and
               two on two streams at once, K4 two, giving equal bits); K1
               and K2 in bf16 and f32 at widths 1, 36, 100, 1,000, 2,080,
               4,096 and 8,192 (timed at 36, 2,080 and 4,096) and f32 K3,
               K4, K7 and K8 at head dims 12, 192 and 768, checked. K5-K8
               in f32 (their f32 instances) at the sampler's (64, 260) and
               the training shapes (128, L = 68, 164, 257), timed beside
               their f32 bounds, plain versions and library calls (K5:
               F.linear, tanh gelu, F.linear; K6: SDPA between F.linear
               projections; K7, K8: SDPA and its backward; f32, TF32
               off): K5, K6 and K7 within 1e-5 of the output's largest
               value, K8 within 1e-4 of each gradient's, two launches
               giving equal bits, each with the time of each of its
               kernels; K5 also at 36 -> 150 (unpadded), K8 also at (128,
               65) and (8, 1,024), K6 also at head dim 12 (`heads=32` at
               384), 384 (`heads=2`) and on a tensor rank's 6 of 12 heads,
               checked. K3, K4, K7 and K8 in f32 (on the TF32 tensor
               cores) also against the float64 plain version at every
               shape they are checked at: the run fails past 1e-5 of each
               output's largest value (the backwards': floored at 1e-2 of
               the largest of the three); their entries carry that error,
               the plain f32 version's, and as `bound_ms` the bound of the
               TF32 passes they take (a forward's scores six, its e V
               three; a backward's five products three each) at 495
               TFLOP/s, with the f32 FMA bound of the same products as
               `bound_f32_fma_ms`.
  3. model     at full width (depth cut to 2 + 1), on the card (kernels)
               against the CPU (plain versions), same weights and inputs,
               under attn_impl "pallas" and "pallas_fused": the sampler's
               forward, and one training step's loss and gradients at
               batch 8 with injected draws; then the same under the model
               settings: `heads=6`, `scan=True` under "nothing_saveable"
               and "save_attn_mlp", attn_impl "xla" and "flax", and
               dropout 0.1 under "pallas_fused" with injected keep masks
               (no K5: the fused MLP steps aside), each with its launches.
  4. train     the full UMD-B/4@64 training step at batch 256 on synthetic
               data through `train_and_evaluate` (what the CLI runs), from
               `init_train_params` weights, under both settings: 1 warm-up
               and 12 timed steps, whose img/s is the median of 3 windows
               of 2 steps, requalified (`utils/windows.py`: another 3
               windows while their spread exceeds 2 %, at most once; a
               sampler reading and the latent step with the encode
               never: their windows are long; printed with the windows,
               spread and `host_contended`);
               finite, falling losses, changed parameters, and exactly
               the kernel launches per step the model says. Every
               end-to-end img/s below (the sampler's, the settings' (a)
               and (c), the latent steps') is read the same way (a
               sampler window is one call).
  4b. settings the model settings through the normal entry points: (a)
               UMD-B/4@64 under `heads=6,scan=True` (remat
               "nothing_saveable") through `train_and_evaluate` at batch
               256, 1 warm-up and 5 timed steps, finite, falling losses,
               K1 128, K2 64, K3 64, K4 32 a step, the peak memory beside
               phase train's; (b) one 25-step sampler call at batch 64
               under `heads=6` (416 K3 at head dim 128); (c) UMD-S/4@64
               at batch 256, 1 warm-up and 5 steps; (d) `cli.py` on
               `ae_i1k.py:runlocal,total_steps=3` (width 64, head dim 16);
               (e) UMD-L/2@256 under `scan=True` at the config's batch of
               1,024 (512 if it runs out of memory), 1 warm-up and 1
               timed step, with its peak memory.
  4d. heads    UMD-B/4@64 at full width under `heads=4` (4 heads of 192)
               and `heads=3` (3 of 256): the depth-2+1 model and one
               training step on the card against the CPU under "pallas"
               and "pallas_fused" (phase model's bounds), full-depth
               training at batch 256 under "pallas" through
               `train_and_evaluate` (requalified img/s, peak memory, K1
               64, K3 32, K2 64, K4 32 a step), and one 25-step sampler
               call at batch 64 under each setting (K1 832 and K3 416; K1
               832, K6 416 and K5 416), beside phase train's and
               serve's 12-head readings. It runs after phase serve.
  4e. shapes   the shapes K5 and K6 took once their GEMM took tails
               along K and N, and the attention kernels once their
               wrappers zero-padded heads to a multiple of 8: (a)
               UMD-S/4@64 under `heads=32` (32 heads of 12 at width 384):
               the depth-2+1 model and one training step on the card
               against the CPU under "pallas" and "pallas_fused" (phase
               model's bounds and launches), full-depth training at batch
               256 under "pallas" through `train_and_evaluate`
               (requalified img/s beside phase settings (c)'s UMD-S with 6
               heads of 64, K1 64, K3 32, K2 64, K4 32 a step), and one
               25-step sampler call at batch 64 under each setting (K3 at
               head dim 12; K5 on 384 -> 1,536 and K6 on 32 heads of 12);
               (b) ViT-mu/16@224 (width 32, depth 1, MLP 128, 2 heads of
               16) under "pallas_fused": "map" and "tok" at depth 2 and
               batch 2 on the card against the CPU (phase classifier's
               bounds), and its full-depth forward at batch 64, timed as
               phase classifier times, with its K5 and K6 launches. It
               runs after phase heads.
  4f. f32      UMD-B/4@64 under `dtype_mm="float32"` (the upstream
               reference's precision), TF32 off (held), under "pallas":
               (a) the depth-2+1 model and one training step on the card
               against the CPU's plain f32 path within 1e-3 of the largest
               prediction and of each gradient leaf's largest value (loss
               1e-4), the launches exact (K1-K4's f32 instances); (b)
               full-depth training at batch 256 through
               `train_and_evaluate` (finite, falling losses, requalified
               img/s, peak memory, K1 64, K3 32, K2 64, K4 32 a step, all
               in f32) beside phase train's bf16 reading; (c) one 25-step
               sampler call at batch 64 (K1 832, K3 416 in f32); (d)
               under "pallas_fused" the same: the depth-2+1 check, 1
               warm-up and 3 timed full-depth training steps (K1 64, K6
               32, K5 32, K2 64, K3 32, K4 32 a step, all in f32), one
               25-step sampler call (K1 832, K6 416, K5 416 in f32). It
               runs after phase shapes.
  4c. classifier the ViT classifier (`models.vit._ViT`) built by name,
               `models.get_model_module("vit").Model(variant=...,
               num_classes=1000, head_zeroinit=False)`, at 224 px, every
               leaf drawn (`convert.init_params`): (a) ViT-B/16 (pool "map" and "tok", L =
               196 and 197) under "pallas" and "pallas_fused" and ViT-H/14
               (L = 256, head dim 80: K6, and K3/K4 in its backward) under
               "pallas_fused", full width at depth 2 and batch 2, on the
               card against the CPU: the logits within 3e-2 of their max
               and the gradients of a softmax cross-entropy within 5e-2 of
               each leaf's max (phase model's bounds), with the launches of
               the forward and backward; (b) the full-depth forwards at
               batch 64 (B/16 under both settings, H/14 under
               "pallas_fused"): requalified img/s over windows of 8
               forwards (2 at 512, 1 at 518; on weights of the same means
               and spreads drawn
               on the card), the launches of a forward, the peak memory; (c)
               one 25-step `heads=6` sampler call under "pallas_fused" at
               batch 64 (416 K6 at head dim 128) beside phase settings
               (b)'s under "pallas".
  5. serve     the port's HTTP sampling server at full UMD-B/4@64 size from
               seeded random weights: three concurrent requests (16, 16, 32
               images) coalesce into one 125-step DDIM call of batch 64; the
               kernel launch counts of that call must be what the model says
               (and no backward kernel). Then one such call under
               "pallas_fused" through `build_sample_callable`, counted the
               same way.
  6. unpacked  `ops.attention.fused_attention`, the [B, L, H, D] entry
               point that no module of the model calls, forward and
               backward through autograd at the decoder's training shape,
               in bf16 and in f32: one K7 and one K8 launch each, against
               the CPU.
  7. ablate    the attention-ablation tool
               (`tools/ablate_attention_kernel.py::main`) at its two shapes:
               the seven arms of K9, 21 launches each, beside K3 and SDPA.
  8. data      the input pipeline on the card: an `arrays` dataset of
               4,096 seeded 64x64 training images and 512 validation
               images written with `write_arrays`, and UMD-B/4@64 trained
               on it at batch 256 through `train_and_evaluate` on
               `ae_i1k.py:data=arrays:<dir>` under "pallas" (1 warm-up and
               5 timed steps, `val` and `mae_val` of 2 batches at step
               6): finite, falling losses, the launches per step the model
               says, the first step's `_id`s the source's (seed, epoch 0)
               permutation, the evaluators on `validation/`; its img/s
               beside phase train's synthetic-fed reading; `TrainIterator`
               alone over the same source (batch 256, 16 workers) in
               img/s; and, where PIL is installed, 256 seeded 500x375
               JPEGs (quality 90) through
               `decode_jpeg_and_inception_crop(size=64)` on the host stage
               with 16 workers, in img/s, with the decoder that ran.
  9. resume    full-width UMD-B/4@64 at batch 256 (with an EMA) through
               `train_and_evaluate` with a workdir: run A trains 6 steps
               with a checkpoint every 3 and the `val` and `mae_val`
               evaluators (2 batches each) at step 6; run B stops after
               step 3's checkpoint and a fresh call on its workdir resumes
               at step 4. The two step-6 states (with the EMA) must be
               equal bit for bit,
               the metrics file complete and finite, and a planted
               half-written checkpoint directory ignored and removed. Also
               times one `save` (the loop's blocking part and the
               background write).
 10. quant     the int8 matmul (`ops/quant.py`, `torch._int_mm`) at the
               MLP's two shapes of the training step, (128 x 257, 768) @
               (768, 3,072) and (128 x 257, 3,072) @ (3,072, 768): the
               quantized operands equal to the CPU's, the int32
               accumulator bit-equal to the CPU's exact integer product
               at every 8th row,
               the output within one bf16 ulp, timed beside bf16
               F.linear; then the train run of phase train under
               `quant=int8_mlp` and a 25-step sampler call under
               `int8_all`, under both settings, each beside its bf16
               reading of this call (the sampler's in ms a forward), with
               the launches the precedence gives (the int8 MLP
               wins over K5; the fused MHA, K6, ignores `int8_all`).
 11. evals     an arrays dataset of 10 colour-coded classes (2,050
               training images, 2,560 validation images): the config's
               `fewshot_lsr` evaluator through `from_config` on a UMD-B/4@64
               train state of seeded weights (shots 5 and 100: both solver
               branches; one seed), with its accuracy, time and launches;
               `classification` on the same source (the nearest training
               class centre on pre_logits); seeded InceptionV3 on the card
               against the CPU; `compute_reference_stats` over the
               validation split into an npz, and the split's FID against
               it near 0; then a `diffusion_sampling` evaluator with
               `inception_reference_path` set through
               `train_and_evaluate`'s `handle_eval_results`: a finite,
               non-negative FID and an IS in [1, 1,008] logged.
 11b. eval_only `tools/eval_only.py` on phase resume's workdir (its
               step-6 checkpoint, full width and depth) with
               `eval_ae_i1k.py` (125 sampling steps): a diffusion_sampling
               evaluator of 64 samples scored (FID, IS) against phase
               evals' reference statistics with the seeded InceptionV3,
               and the transfer suite (5 shots) on ten seeded arrays
               stand-ins of 4-13 colour-coded classes; each evaluator's
               wall seconds and K1, K3 counted; every accuracy above
               chance, FID and IS finite.
 11c. export   from the same workdir: `export_sampler --weights_out`
               writes the EMA's .npz; a `SamplerServer` built by `serve
               --workdir` answers three coalesced requests, bit-equal to
               `build_sample_callable` on that .npz; the exported sampler
               (`torch.export`: one DDIM step with the kernels as
               operators, the loop and the draws in the loader), `baked`
               and `arg` with a bfloat16 sidecar under "pallas" and `arg`
               under "pallas_fused", each at 25 steps and
               bit-equal to the live callable at the same seed and
               launching the model's kernels; its
               size, export and load seconds, and (baked) its img/s
               beside the live callable's.
 12. latent    UMD-L/2@256 on Stable Diffusion VAE latents (width 1,024,
               24 + 8 blocks, 16 heads; seeded model and VAE): the SD-width
               VAE's encode_moments and decode on two 256x256 images on the
               card against the CPU (f32, TF32 off); one training step of
               the model at depth 2 + 1 with the VAE encode inside, card
               against CPU; 4 steps (1 warm-up, 3 timed, each a window)
               at full depth
               through `train_and_evaluate` on
               `ae_i1k.py:variant=L/2,size=256,latent_diffusion=True,
               data=synthetic` at batch LATENT_BATCH (finite, falling
               losses, the launches per step the model gives, img/s, peak
               memory, the encode's ms a step by CUDA events); the depth
               2 + 1 step also under "pallas_fused" against the CPU, and 1
               warm-up and 3 timed full-depth steps at batch LATENT_BATCH
               under "pallas_fused" (K5 and K6 at width 1,024 on a model
               path; finite losses, the launches per step), beside the
               "pallas" reading; one 125-step
               `uncond_eps` call of `make_eval_fns` at batch 64 with its
               decode (uint8 (64, 256, 256, 3), K1 8,064 and K3 4,032
               launches, the decode's share). Phase `kernels` also runs
               its checks of K1-K4 and K6 at width 1,024 (16 heads): K1
               and K3 at the sampler's (64, 260) and (64, 257), K1-K4 at
               this phase's per-branch batch and L = 68, 164, 257, K6 at
               the sampler's shapes. Then precomputed latents: the JAX
               writer's TFRecord shard in tests/data read through the
               `latents` source (no TensorFlow), `precompute_latents` of
               256 seeded 256 px images x 4 views through the seeded VAE
               into an arrays split (img/s), UMD-L/2@256 trained on it
               with `use_preprocessed_latents` at batch 256 (img/s, peak
               memory, K1-K4 a step, beside the step with the encode), and
               the largest power-of-two batch that fits.
 13. probe     the linear probe (`linear_ae.train_and_evaluate`,
               `configs/ae_i1k_lp.py` with the decoded-image pp of an
               arrays source) on phase evals' 10 classes, the backbone
               from phase resume's step-6 checkpoint: stopped after its
               step-3 checkpoint and resumed, then `classification` on
               validation/; finite losses, the checkpoint, the frozen
               forward's K1 and K3 launches.
 14. parallel  the parallel layer on the one card. (a) The production
               route: `python -c` running `launch.main` (the launcher's
               entry, under SLURM_PROCID=0, SLURM_NTASKS=1 and
               SV_COORDINATOR_ADDRESS on localhost) on
               `ae_i1k.py:fsdp=True,total_steps=2,batch_size=256,
               eval_steps=-1` with a workdir: NCCL with one rank, against
               `cli.main` without a process group, the two processes at
               once and beside (b): the losses and the
               step-2 checkpoint (params, mu, nu) bit-equal, the launches
               of 2 scan=True steps, img/s and peak memory. (b) Two
               processes sharing the card over gloo, started by
               `tools/dryrun_multichip.spawn` (each a fresh interpreter
               with a time limit of PARALLEL_TIMEOUT, killed on it, which
               fails the phase; the kernels were built before, so no two
               processes run nvcc): an fsdp=2 (`fully_sharded`) run of the
               same config for 2 steps through `train_and_evaluate`, each
               process on its rows of a seeded global batch of 256 with
               injected draws, against the single-process run on the card
               (losses, step-1 gradients from Adam's nu, parameters after
               2 steps), with each process's peak memory, its parameters
               and optimizer state, and the host time of its collectives;
               then the same run under ZeRO-1 (replicated parameters,
               sharded optimizer state) and under sharded parameters with
               a replicated optimizer state, each process's state bytes
               equal to its placement's and beside one process's, the
               worst element's leaf, gradients and bf16 spacing printed;
               and a pipe=2 run (scan=True, pipe_stages=2, 8 microbatches,
               batch 256): the forward's prediction and the first step's
               loss and gradients against the unpipelined scan=True step,
               within phase model's bounds. K1-K4 launched in every
               process, the counts the schedule gives. The times are host
               clock; the two processes time-slice the card.
 15. tensor    tensor parallelism (the Megatron block) on the one card,
               spawned as phase parallel's (b) with PARALLEL_TIMEOUT:
               UMD-B/4@64 at full width and depth at batch 64 on a seeded
               batch with injected draws, 2 steps through
               `train_and_evaluate` (the two-process and the
               four-process set at once, beside phase parallel's (b)):
               (a) `tensor_parallel` (T = 2, the
               optimizer state replicated) under `pallas` and (b) under
               `pallas_fused` in two processes, (c) `tp_fsdp` on fsdp 2 x
               tensor 2 in four (2 steps), (d) `val` (2 batches) under
               (a)'s placement; each against the one-process run on the
               card: the losses within rtol 2e-4 and atol 1e-5
               (tests/test_fsdp_equivalence.py's bound) and equal on the
               two tensor ranks of a batch shard, each process's launches
               those of one process, K3/K4 on 6 heads, K6 on (768 -> 384)
               projections and K5 on hidden 1,536 under (b), its state
               bytes those of the placement; each process's step ms and
               the share of its collectives (host clock, each collective
               bracketed by device synchronisations). Phase `kernels`
               holds K6 on a rank's 6 of 12 heads at (64, 260) and
               (128, 257), timed beside the square K6.
Then it prints the card's name and power limit, one JSON line of the
kernels, and as its last line {"ok": true, "device": {...}}. Without a CUDA
device it exits non-zero and prints no result.
"""

import collections
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense tensor-core bf16
F32_FLOPS = 67e12           # f32 outside the tensor cores
TF32_FLOPS = 495e12         # dense tensor-core TF32 (K3, K4, K7, K8 in f32)
# TF32 passes of the f32 attention kernels, each 2 B H L^2 D operations:
# the forwards' two products take nine (the scores six, e V three), the
# backwards' five take three each (3xTF32).
F32_FWD_PASSES, F32_BWD_PASSES = 9, 15

BATCH = 64
WIDTH, HEADS = 768, 12
SEQ_ENC, SEQ_DEC = 260, 257   # 256 patches + 4 cls; 256 patches + 1 rep
SAMPLER_FORWARDS = 126        # 125 DDIM steps + the final t=0 step
BLOCKS = 12 + 4               # encoder + decoder blocks of UMD-B/4
TRAIN_BATCH = 256             # per card; each branch gets half
TRAIN_SEQS = (68, 164, 257)   # MAE encoder, diffusion encoder, decoders
MLP_DIM = 3072
TRAIN_STEPS = 6               # 1 warm-up + 5 timed
DATA_TRAIN, DATA_VAL = 4096, 512   # phase data: arrays examples, 64x64x3
DATA_WORKERS = 16             # the config's input.num_workers
JPEGS, JPEG_HW = 256, (375, 500)   # phase data: the JPEG reading
# K2 by launches alone (`device_ms`) at (128, L, 768) modulated, before its
# tickets moved into the launch's scratch: PR 10's measuring call, NVIDIA
# H100 80GB HBM3, 700.00 W.
K2_DEVICE_MS_BEFORE = {68: 0.0198, 164: 0.0448, 257: 0.0650}
ATTN_IMPLS = ("pallas", "pallas_fused")
# Kernel launches of one block applied once, with gradients (training) and
# without (the sampler). Under "pallas_fused" the fused forwards replace
# the packed attention's, which then runs in the backward only: FusedMHA
# recomputes its reference composition there (K3) and differentiates it
# (K4).
BLOCK_TRAIN_LAUNCHES = {
    "pallas": {"ln_modulate_fwd": 2, "ln_modulate_bwd": 2,
               "attention_packed_fwd": 1, "attention_packed_bwd": 1},
    "pallas_fused": {"ln_modulate_fwd": 2, "ln_modulate_bwd": 2,
                     "fused_mha_fwd": 1, "fused_mlp_fwd": 1,
                     "attention_packed_fwd": 1, "attention_packed_bwd": 1},
}
BLOCK_SAMPLE_LAUNCHES = {
    "pallas": {"ln_modulate_fwd": 2, "attention_packed_fwd": 1},
    "pallas_fused": {"ln_modulate_fwd": 2, "fused_mha_fwd": 1,
                     "fused_mlp_fwd": 1},
}
# Under an int8 `quant` (phase quant) the int8 MLP wins over the fused one,
# so no K5 runs; the attention core stays in bf16 (K3, K4), and under
# "pallas_fused" the fused MHA (K6) ignores `int8_all` and runs as before.
BLOCK_TRAIN_LAUNCHES_INT8 = {
    a: {k: v for k, v in per.items() if k != "fused_mlp_fwd"}
    for a, per in BLOCK_TRAIN_LAUNCHES.items()}
BLOCK_SAMPLE_LAUNCHES_INT8 = {
    a: {k: v for k, v in per.items() if k != "fused_mlp_fwd"}
    for a, per in BLOCK_SAMPLE_LAUNCHES.items()}


# An end-to-end img/s reading is the median of WINDOWS windows of
# WINDOW_STEPS training steps (a sampler window: one call), requalified by
# `utils/windows.py` when their spread exceeds 2 %: a training run takes
# enough steps for every retry, 1 + 2 x 3 x (1 + retries). The script's
# time limit allows a sampler reading (3 calls of 2-4 s) SAMPLER_RETRIES,
# and the latent step with the encode (2.4 s, a window of one step) none.
WINDOWS, WINDOW_STEPS, WINDOW_RETRIES = 3, 2, 1
SAMPLER_RETRIES = 0


def window_run_steps(retries=WINDOW_RETRIES, window_steps=WINDOW_STEPS):
  return 1 + window_steps * WINDOWS * (1 + retries)


def qualified_steps(history, batch, retries=WINDOW_RETRIES,
                    window_steps=WINDOW_STEPS):
  """`windows.requalify` over a run's steps after the warm-up one: window
  k is steps 2 + 2k and 3 + 2k (of `window_steps` = 2), its rate the batch
  over their host time (each step ends in a device synchronisation) and
  their wait for the batch."""
  from small_vision_tpu_torch.utils import windows
  timed = history[1:]
  pool = iter(range(len(timed) // window_steps))

  def run_windows(n):
    out = []
    for _ in range(n):
      ws = timed[next(pool) * window_steps:][:window_steps]
      out.append(batch * len(ws) * 1e3 / sum(h["ms"] + h["data_ms"]
                                             for h in ws))
    return out
  rates, info = windows.requalify(run_windows, WINDOWS,
                                  max_retries=retries)
  return {"median": float(np.median(rates)),
          "windows": [round(float(r), 3) for r in rates],
          "spread_pct": round(windows.spread_pct(rates), 2), **info}


def qualified_calls(call, images, retries=WINDOW_RETRIES):
  """`windows.qualified_median` of `images` / the host time of `call()`
  (a sampler call ends in a device-to-host copy)."""
  from small_vision_tpu_torch.utils import windows

  def one():
    t0 = time.perf_counter()
    call()
    return images / (time.perf_counter() - t0)
  return windows.qualified_median(one, WINDOWS, max_retries=retries)


def qual_text(q):
  return (f"median {q['median']:.2f} img/s (windows {q['windows']}, "
          f"spread_pct {q['spread_pct']}, requalify_retries "
          f"{q['requalify_retries']}, host_contended {q['host_contended']})")


def _times(per_block, n):
  return {k: n * v for k, v in per_block.items()}


def fail(msg):
  print(f"FAILED: {msg}", flush=True)
  sys.exit(1)


_START = time.perf_counter()


def mark(phase):
  """Prints the seconds since the script started, once `phase` is done
  (the script's time limit is shared by every phase)."""
  print(f"[time] {phase} done at {time.perf_counter() - _START:.1f} s",
        flush=True)


def time_ms(fn, iters=50, warmup=3):
  """Mean device time of one call, by CUDA events over `iters` calls."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def phase_build(build):
  t0 = time.perf_counter()
  libs = build.build_all()
  print(f"[build] {len(libs)} kernel libraries ({', '.join(sorted(libs))}) "
        f"built in {time.perf_counter() - t0:.2f} s", flush=True)
  # ptxas's report of the attention kernels at three and four 64-column
  # tiles a head (head dims 136 to 256) and past four (the wide kernels);
  # the build refuses a library with wgmma products serialised for a
  # divergent path (C7520).
  for stem in sorted(libs):
    for name, r in build.ptxas_report(build.build_log(stem)).items():
      kernel = _kernel_instance(name)
      if kernel and (kernel[1] is None or kernel[1] >= 3):
        print(f"[build] {stem}: {kernel[0]}: {r['registers']} registers, "
              f"spill stores {r['spill_stores']} B, loads "
              f"{r['spill_loads']} B, notes {r['notes'] or 'none'}",
              flush=True)
  # The f32 attention kernels on 3xTF32 wgmma (K3's and K7's forward,
  # K4's and K8's backwards), an instance a key chunk width N: those of
  # the training and sampler shapes (40 at L = 68, 56 at 164, 257 and
  # 260).
  for stem in ("attention_packed_f32", "attention_unpacked_f32"):
    for name, r in build.ptxas_report(build.build_log(stem)).items():
      m = re.search(r"(attn_f32x3_[a-z]+_kernel)I.*?ELi(\d+)E", name)
      if m and m.group(2) in ("40", "56"):
        print(f"[build] {stem}: {m.group(1)}<N={m.group(2)}>: "
              f"{r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B, notes "
              f"{r['notes'] or 'none'}", flush=True)


def _kernel_instance(mangled):
  """(readable name, tiles a head) of an attention kernel's mangled name,
  its template's last int argument being the 64-column tiles of a head
  (None for the wide-head kernels, which take any count past four); None
  for other kernels."""
  wide = re.search(r"\d+((?:attn|attention|fused_mha)[a-z_]*_wide[a-z_]*)"
                   r"(?:IN4sm90(\d+)|ILb(\d)E)?", mangled)
  if wide:  # a policy's name is as long as its length prefix says
    n = int(wide.group(2) or 0)
    arg = (mangled[wide.end():wide.end() + n] if n else
           {"0": "false", "1": "true"}.get(wide.group(3)))
    return (f"{wide.group(1)}<{arg}>" if arg else wide.group(1)), None
  m = re.search(r"\d+((?:attn|attention|fused_mha)[a-z_0-9]*?)I("
                r"(?:N4sm90\d+\w+?E)?(?:L[ib]\d+E)+)E", mangled)
  if not m:
    return None
  ints = [int(i) for i in re.findall(r"Li(\d+)E", m.group(2))]
  policy = re.search(r"N4sm90\d+(\w+?)E", m.group(2))
  args = ([policy.group(1)] if policy else []) + [str(i) for i in ints] + [
      b == "1" and "true" or "false" for b in re.findall(r"Lb(\d)E",
                                                         m.group(2))]
  return f"{m.group(1)}<{', '.join(args)}>", ints[-1]


def _bound(bytes_moved, ops, peak):
  """(least ms, "bytes" or "operations"): the larger of the bytes over the
  memory rate and the operations over the peak rate of their type."""
  bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
  ops_ms = ops / peak * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def sdpa_backend(q, k, v):
  """The backend that `scaled_dot_product_attention`'s dispatcher picks for
  q, k, v, as `torch._fused_sdp_choice` reports it (flash takes head dims
  up to 256 only): "flash_attention", "efficient_attention", "math",
  "cudnn_attention", or "unknown" where this PyTorch has no such query."""
  choice = getattr(torch, "_fused_sdp_choice", None)
  if choice is None:
    return "unknown"
  from torch.nn.attention import SDPBackend
  names = {int(b): n.lower() for n, b in SDPBackend.__members__.items()}
  return names.get(int(choice(q, k, v)), "unknown")


def model_shapes(train_batch):
  """(batch, length) of a block's calls: the sampler's encoder and decoder
  at batch 64, and the three training shapes at the per-branch batch."""
  return ((BATCH, SEQ_ENC), (BATCH, SEQ_DEC)) + tuple(
      (train_batch, l) for l in TRAIN_SEQS)


def _named(name, dtype):
  """A kernel's name in the kernels line and its launch count: `name`,
  or its f32 instance's."""
  return name + "_f32" if dtype == torch.float32 else name


def check_ln(ln, card, width=WIDTH, train_batch=TRAIN_BATCH // 2,
             timed=True, dtype=torch.bfloat16, shapes=None):
  """K1 in `dtype` against its plain version, modulated and not, two
  launches giving equal bits, at `shapes` (by default
  `model_shapes(train_batch)`); returns its kernels-line entry (times of
  the modulated call at the first shape on top, the others' under
  `by_len`; the sampler's decoder shape and, with `timed` False, every
  shape checked only)."""
  gen = torch.Generator(device="cuda").manual_seed(0)
  randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
  gamma = 1.0 + 0.1 * randn(width)
  beta = 0.1 * randn(width)
  name = _named(ln.NAME, dtype)
  max_err, timing, by_len = 0.0, None, {}
  for b, seq in shapes or model_shapes(train_batch):
    # shift/scale as the block makes them: column slices of the AdaLN output.
    mods = (0.5 * randn(b, 6 * width)).to(dtype)
    shift, scale = mods.chunk(6, dim=-1)[:2]
    x = (2.0 * randn(b, seq, width) + 0.5).to(dtype)
    for mod in ((shift, scale), (None, None)):
      args = (x, gamma, beta, *mod)
      got = ln.ln_modulate_fwd(*args)
      again = ln.ln_modulate_fwd(*args)
      ref = ln.ln_modulate_plain(*args).float()
      torch.cuda.synchronize()
      if not torch.equal(got, again):
        fail(f"{name} B={b} L={seq} D={width}: two launches differ")
      err = (got.float() - ref).abs()
      if dtype == torch.float32:
        # f32 throughout; the row's two sums in another order: 1e-5 of
        # the largest output.
        bad = (err > 1e-5 * ref.abs().max()).sum().item()
        what = "over 1e-5 of max |y|"
      else:
        # One bf16 ulp of the output (2^-7 relative), plus f32 rounding of
        # the O(1) intermediates, which may tip a value across a bf16 tie.
        bad = (err > 2.0**-7 * ref.abs() + 1e-5).sum().item()
        what = "over 1 bf16 ulp"
      max_err = max(max_err, err.max().item())
      print(f"[kernels] {name} B={b} L={seq} D={width} "
            f"modulate={mod[0] is not None}: max abs err "
            f"{err.max().item():.3e}, {bad} elements {what}, two "
            "launches equal", flush=True)
      if bad:
        fail(f"{name} disagrees with its plain version ({bad})")
    if (b, seq) == (BATCH, SEQ_DEC) or not timed:
      continue  # the decoder's sampler shape is checked, not timed
    args = (x, gamma, beta, shift, scale)
    g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
    n, esize = b * seq * width, x.element_size()
    bytes_moved = 2 * n * esize + 2 * width * 4 + 2 * b * width * esize
    bound_ms, bound_by = _bound(bytes_moved, 9 * n, F32_FLOPS)
    # 200 launches, as for K3 (50 read 0.023 and 0.057 ms at (128, 68,
    # 1024) in two calls). A call's host time, 24-44 us by K3's reading
    # below, is as long as K1's launch at these shapes: `ms` may read the
    # host's rate of calls rather than the card's time.
    entry = dict(
        ms=time_ms(lambda: ln.ln_modulate_fwd(*args), iters=200),
        plain_ms=time_ms(lambda: ln.ln_modulate_plain(*args)),
        library_ms=time_ms(lambda: torch.nn.functional.layer_norm(
            x, (width,), g16, b16, 1e-6) * (1 + scale[:, None])
                           + shift[:, None], iters=200),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {name} B={b} L={seq} D={width} modulated: "
          f"{_fmt(entry)} (layer_norm+modulate as library; {bytes_moved} "
          f"bytes) on {card}", flush=True)
    if timing is None:
      timing = entry
    else:
      by_len[seq] = entry
  if not timed:
    return dict(max_abs_err=max_err)
  return dict(name=name, route="cuda",
              source="small_vision_tpu_torch/csrc/ln_modulate.cu",
              replaces="small_vision_tpu/ops/layernorm.py:78",
              max_abs_err=max_err, **timing, by_len=by_len)


def check_attention(attn, card, width=WIDTH, heads=HEADS,
                    train_batch=TRAIN_BATCH // 2, timed=True, shapes=None,
                    dtype=torch.bfloat16):
  """K3 in `dtype` against its plain version at `shapes`, by default
  `model_shapes(train_batch)` (the sampler's shapes, batch 64, L = 260 and
  257, and the training shapes, L = 68, 164, 257), two launches giving
  equal bits at each; returns its kernels-line entry (times at the first
  timed shape on top, the others' under `by_len`; the decoder's sampler
  shape is checked, not timed)."""
  gen = torch.Generator(device="cuda").manual_seed(1)
  head_dim = width // heads
  name = _named(attn.NAME, dtype)
  f32 = dtype == torch.float32
  max_err, timing, by_len, f64 = 0.0, None, {}, [0.0, 0.0]
  for b, seq in shapes or model_shapes(train_batch):
    q, k, v = (torch.randn(b, seq, width, generator=gen,
                           device="cuda").to(dtype)
               for _ in range(3))
    got = attn.attention_packed_fwd(q, k, v, heads)
    again = attn.attention_packed_fwd(q, k, v, heads)
    ref = attn.attention_packed_plain(q, k, v, heads).float()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
      fail(f"{name} B={b} L={seq} H={heads}: two launches differ")
    err = (got.float() - ref).abs()
    exact = ""
    if f32:
      # f32 throughout: score and value sums over D and L in another
      # order, through exp2 of scores of a few units: 1e-4 of the largest
      # output; and the 3xTF32 products within F64_TOL of float64.
      bad = (err > 1e-4 * ref.abs().max()).sum().item()
      exact = _f64_forward(name, b, seq, heads, got, ref,
                           attn.attention_packed_plain(
                               *(t.double() for t in (q, k, v)), heads), f64)
    else:
      # Two bf16 ulps at unit magnitude (outputs are convex mixes of N(0,1)
      # values): the f32 score sums run in another order, which may round a
      # weight e to the neighbouring bf16 value, and o itself is bf16.
      bad = (err > 1e-2 + 1e-2 * ref.abs()).sum().item()
    max_err = max(max_err, err.max().item())
    print(f"[kernels] {name} B={b} L={seq} H={heads}: max abs "
          f"err {err.max().item():.3e}, {bad} elements over tolerance, two "
          f"launches equal{exact}", flush=True)
    if bad:
      fail(f"{name} disagrees with its plain version ({bad})")
    if (b, seq) == (BATCH, SEQ_DEC) or not timed:
      continue  # the decoder's sampler shape is checked, not timed
    split = lambda t: t.view(b, seq, heads, head_dim).transpose(1, 2)
    one_pass = 2 * b * heads * seq * seq * head_dim
    bound_ms, bound_by, extra = _attn_bound(
        4 * b * seq * width * q.element_size(), 2 * one_pass, f32,
        F32_FWD_PASSES * one_pass)
    # 200 launches: at L=68 a launch takes 0.05 ms, and 50 of them read
    # two clock states apart from call to call.
    entry = dict(
        ms=time_ms(lambda: attn.attention_packed_fwd(q, k, v, heads),
                   iters=200),
        plain_ms=time_ms(lambda: attn.attention_packed_plain(q, k, v, heads),
                         iters=10),
        library_ms=time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                split(q), split(k), split(v)), iters=200),
        library_backend=sdpa_backend(split(q), split(k), split(v)),
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    print(f"[kernels] {name} B={b} L={seq} H={heads} "
          f"D={head_dim}: {_fmt(entry)} (sdpa as library) on {card}",
          flush=True)
    if timing is None:
      timing = entry
    else:
      by_len[seq] = entry
  exact = dict(f64_err=f64[0], plain_f64_err=f64[1]) if f32 else {}
  if not timed:
    return dict(max_abs_err=max_err, **exact)
  if f32:
    return dict(name=name, route="cuda",
                source="small_vision_tpu_torch/csrc/attention_packed_f32.cu",
                replaces="small_vision_tpu/ops/attention.py:312",
                max_abs_err=max_err, **exact, **timing, by_len=by_len)
  # Host time of one call at a shape the card finishes at once (one batch
  # element, 64 tokens): the wrapper's checks, the encoding of the three
  # tensor maps and the launch, best of 5 runs of 500 calls.
  small = [t[:1, :64].contiguous() for t in (q, k, v)]
  runs = []
  for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
      attn.attention_packed_fwd(*small, heads)
    runs.append((time.perf_counter() - t0) / 500 * 1e6)
  torch.cuda.synchronize()
  print(f"[kernels] attention_packed_fwd host time a call (1, 64, {width}): "
        f"{min(runs):.2f} us", flush=True)
  return dict(name=attn.NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_packed.cu",
              replaces="small_vision_tpu/ops/attention.py:312",
              max_abs_err=max_err, **timing, by_len=by_len,
              host_us=min(runs))


def check_ln_bwd(ln, card, width=WIDTH, b=TRAIN_BATCH // 2, timed=True,
                 dtype=torch.bfloat16, seqs=TRAIN_SEQS):
  """K2 in `dtype` against its plain version at the training shapes
  (per-branch batch `b`, L = `seqs`, by default 68, 164, 257), modulated
  and not, three launches in a row giving equal bits, two at once on two
  streams giving the bits of the same two in turn; timed beside its bound
  and its library call."""
  gen = torch.Generator(device="cuda").manual_seed(2)
  randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
  gamma = 1.0 + 0.1 * randn(width)
  beta = 0.1 * randn(width)
  mods = (0.5 * randn(b, 6 * width)).to(dtype)
  shift, scale = mods.chunk(6, dim=-1)[:2]
  name = _named(ln.BWD_NAME, dtype)
  max_err, by_len, cases = 0.0, {}, {}
  for seq in seqs:
    x = (2.0 * randn(b, seq, width) + 0.5).to(dtype)
    dy = randn(b, seq, width).to(dtype)
    mean = torch.empty(b, seq, device="cuda")
    rstd = torch.empty_like(mean)
    ln.ln_modulate_fwd(x, gamma, beta, shift, scale, mean=mean, rstd=rstd)
    for sc in (scale, None):
      args = (x, dy, mean, rstd, gamma, beta, sc)
      cases[(seq, sc is not None)] = args
      # Three launches in a row: the sums' fixed order, and each launch
      # zeroing its own ticket counters.
      got = ln.ln_modulate_bwd(*args)
      again = [ln.ln_modulate_bwd(*args) for _ in range(2)]
      want = ln.ln_modulate_bwd_plain(*args)
      torch.cuda.synchronize()
      if not all(torch.equal(g, a) for other in again
                 for g, a in zip(got, other) if g is not None):
        fail(f"{name} B={b} L={seq} D={width}: three launches differ")
      dx, dx_want = got[0].float(), want[0].float()
      err = (dx - dx_want).abs()
      # dx: in bf16 one bf16 ulp (rounding either way) plus f32 noise, in
      # f32 1e-5 of the largest (the row's two sums in another order); the
      # sums: f32 sums of 128*L O(1) terms in another order, relative to
      # the largest.
      if dtype == torch.float32:
        bad = int((err > 1e-5 * dx_want.abs().max()).sum())
      else:
        bad = int((err > 2.0**-7 * dx_want.abs() + 1e-3).sum())
      worst = err.max().item()
      for g, w in zip(got[1:], want[1:]):
        if w is not None:
          e = (g - w).abs().max().item()
          worst = max(worst, e)
          bad += int(e > 1e-4 * w.abs().max().item())
      max_err = max(max_err, worst)
      print(f"[kernels] {name} B={b} L={seq} D={width} modulate="
            f"{sc is not None}: max abs err {worst:.3e}, {bad} over "
            "tolerance, three launches equal", flush=True)
      if bad:
        fail(f"{name} disagrees with its plain version ({bad})")
    if not timed:
      continue
    args = (x, dy, mean, rstd, gamma, beta, scale)
    # The library yardstick: autograd of F.layer_norm + modulate, on a
    # retained graph.
    xg = x.clone().requires_grad_()
    g16 = gamma.to(dtype).requires_grad_()
    b16 = beta.to(dtype).requires_grad_()
    sh, scl = (t.clone().requires_grad_() for t in (shift, scale))
    y = (torch.nn.functional.layer_norm(xg, (width,), g16, b16, 1e-6)
         * (1 + scl[:, None]) + sh[:, None])
    n, esize = b * seq * width, x.element_size()
    bound_ms, bound_by = _bound(
        3 * n * esize + 2 * b * seq * 4 + 4 * width * 4 + b * width * esize
        + 2 * b * width * 4, 14 * n, F32_FLOPS)
    # `ms` times calls through the wrapper, as for every other kernel. A
    # call's checks and allocations can take as long on the host as K2 on
    # the card, so `device_ms` also times launches into buffers made once.
    by_len[seq] = dict(
        ms=time_ms(lambda: ln.ln_modulate_bwd(*args)),
        device_ms=time_ms(ln.ln_modulate_bwd_timer(*args)),
        plain_ms=time_ms(lambda: ln.ln_modulate_bwd_plain(*args), iters=10),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y, (xg, g16, b16, sh, scl), dy, retain_graph=True)),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {name} B={b} L={seq} D={width} modulated: "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in by_len[seq].items())
          + (f" (device_ms before the tickets moved into the launch's "
             f"scratch, PR 10: {K2_DEVICE_MS_BEFORE[seq]:.4f})"
             if width == WIDTH and dtype == torch.bfloat16 else "")
          + f" on {card}", flush=True)
  _check_ln_bwd_two_streams(ln, [cases[(seqs[-1], True)],
                                 cases[(seqs[0], False)]])
  if not timed:
    return dict(max_abs_err=max_err)
  return dict(name=name, route="cuda",
              source="small_vision_tpu_torch/csrc/ln_modulate_bwd.cu",
              replaces="small_vision_tpu/ops/layernorm.py:185",
              max_abs_err=max_err, **by_len[seqs[-1]],
              by_len=by_len)


def _check_ln_bwd_two_streams(ln, cases):
  """Two K2 launches in flight at once on two streams give the bits of the
  same two launches in turn: each launch's ticket counters are its own."""
  in_turn = [ln.ln_modulate_bwd(*args) for args in cases]
  start = torch.cuda.current_stream()
  for rnd in range(5):
    streams = [torch.cuda.Stream() for _ in cases]
    got = []
    for stream, args in zip(streams, cases):
      stream.wait_stream(start)
      with torch.cuda.stream(stream):
        got.append(ln.ln_modulate_bwd(*args))
    for stream in streams:
      start.wait_stream(stream)
    torch.cuda.synchronize()
    for want, outs in zip(in_turn, got):
      if not all(torch.equal(w, g) for w, g in zip(want, outs)
                 if w is not None):
        fail(f"ln_modulate_bwd on two streams at once (round {rnd}) differs "
             "from the same launches in turn")
  shapes = ", ".join(f"({a[0].shape[0]}, {a[0].shape[1]}, {a[0].shape[2]})"
                     f"{' modulated' if a[6] is not None else ''}"
                     for a in cases)
  print(f"[kernels] ln_modulate_bwd on two streams at once, {shapes}: the "
        "bits of the same launches in turn, 5 rounds", flush=True)


# K4's and K8's f32 instances against the float64 plain version: within
# F64_TOL of each output's largest value (floored at 1e-2 of the largest
# of the three), their products 3xTF32 on the tensor cores.
F64_TOL = 1e-5


def _f64_errors(got, plain, exact):
  """(the kernel's, the plain f32 version's) worst error against `exact`,
  the float64 plain version's outputs, each relative to the output's
  largest value floored at 1e-2 of the largest of the three."""
  top = max(x.abs().max().item() for x in exact)
  rel = lambda outs: max(
      (o.double() - x).abs().max().item() / max(x.abs().max().item(),
                                                1e-2 * top)
      for o, x in zip(outs, exact))
  return rel(got), rel(plain)


def _attn_bound(bytes_moved, products, f32, tf32_ops):
  """(bound_ms, bound_by, extra fields) of an attention kernel that moves
  `bytes_moved` and whose products are `products` operations: in bf16 at
  the bf16 tensor cores' peak; in f32 at the TF32 tensor cores' peak for
  the `tf32_ops` operations of the TF32 passes it takes, with the f32 FMA
  bound of the products beside it as `bound_f32_fma_ms`."""
  if not f32:
    return (*_bound(bytes_moved, products, BF16_FLOPS), {})
  return (*_bound(bytes_moved, tf32_ops, TF32_FLOPS),
          {"bound_f32_fma_ms": _bound(bytes_moved, products, F32_FLOPS)[0]})


def _f64_forward(name, b, seq, heads, got, ref, exact, f64):
  """Holds an f32 forward (K3's, K7's: 3xTF32) against the float64 plain
  version's output `exact`, within F64_TOL of its largest value (the plain
  f32 version `ref` beside it); f64 keeps the worst [kernel, plain] so
  far. Returns the text of the reading."""
  errs = _f64_errors([got], [ref], [exact])
  f64[:] = [max(a, e) for a, e in zip(f64, errs)]
  if errs[0] > F64_TOL:
    fail(f"{name} B={b} L={seq} H={heads} is {errs[0]:.3e} off the f64 "
         "plain version")
  return (f"; against f64 {errs[0]:.3e} of the output's largest (the plain "
          f"f32 version {errs[1]:.3e}; tolerance {F64_TOL})")


def check_attention_bwd(attn, card, width=WIDTH, heads=HEADS,
                        b=TRAIN_BATCH // 2, timed=True, shapes=None,
                        dtype=torch.bfloat16):
  """K4 in `dtype` against its plain version at `shapes`, by default the
  training shapes (per-branch batch `b`, L = 68, 164, 257), two launches
  giving equal bits; timed there where `timed`."""
  gen = torch.Generator(device="cuda").manual_seed(3)
  head_dim = width // heads
  name = _named(attn.BWD_NAME, dtype)
  f32 = dtype == torch.float32
  max_err, by_len, f64 = 0.0, {}, [0.0, 0.0]
  for b, seq in shapes or tuple((b, l) for l in TRAIN_SEQS):
    q, k, v, do = (torch.randn(b, seq, width, generator=gen,
                               device="cuda").to(dtype)
                   for _ in range(4))
    got = attn.attention_packed_bwd(q, k, v, do, heads)
    again = attn.attention_packed_bwd(q, k, v, do, heads)
    want = attn.attention_packed_bwd_plain(q, k, v, do, heads)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
      fail(f"{name} B={b} L={seq} H={heads}: two launches differ")
    worst, bad = 0.0, 0
    top = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
      # bf16: bf16 outputs of f32 sums over L; a sum in another order may
      # flip the bf16 rounding of an e, dO*r or dS input of a product: a
      # few bf16 ulps of the largest output. f32: the same sums in another
      # order, nothing rounded to bf16: 1e-4 of the largest output. dq and
      # dk vanish at L = 1 (one key: dS is 0 but for roundings), so each
      # output's scale is floored at 1e-3 of the largest of the three, as
      # in the card tests.
      e = (g.float() - w.float()).abs().max().item()
      worst = max(worst, e)
      bad += int(e > (1e-4 if f32 else 2.0**-6) * max(
          w.float().abs().max().item(), 1e-3 * top))
    max_err = max(max_err, worst)
    exact = ""
    if f32:
      errs = _f64_errors(got, want, attn.attention_packed_bwd_plain(
          *(t.double() for t in (q, k, v, do)), heads))
      f64 = [max(a, e) for a, e in zip(f64, errs)]
      exact = (f"; against f64 {errs[0]:.3e} of each output's largest "
               f"(the plain f32 version {errs[1]:.3e}; tolerance {F64_TOL})")
    print(f"[kernels] {name} B={b} L={seq} H={heads}: max "
          f"abs err {worst:.3e}, {bad} outputs over tolerance, two launches "
          f"equal{exact}", flush=True)
    if bad:
      fail(f"{name} disagrees with its plain version ({bad})")
    if f32 and f64[0] > F64_TOL:
      fail(f"{name} B={b} L={seq} H={heads} is {f64[0]:.3e} off the f64 "
           "plain version")
    if not timed:
      continue
    split = lambda t: t.view(b, seq, heads, head_dim).transpose(1, 2)
    qs, ks, vs = (split(t).detach().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    dos = split(do)
    one_pass = 2 * b * heads * seq * seq * head_dim
    bound_ms, bound_by, extra = _attn_bound(
        7 * b * seq * width * q.element_size(), 5 * one_pass, f32,
        F32_BWD_PASSES * one_pass)
    by_len[seq] = dict(
        ms=time_ms(lambda: attn.attention_packed_bwd(q, k, v, do, heads)),
        plain_ms=time_ms(lambda: attn.attention_packed_bwd_plain(
            q, k, v, do, heads), iters=5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dos, retain_graph=True)),
        library_backend=sdpa_backend(qs, ks, vs),
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    print(f"[kernels] {name} B={b} L={seq} H={heads} "
          f"D={head_dim}: " + ", ".join(
              f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
              for k, v in by_len[seq].items()) + f" on {card}", flush=True)
  exact = dict(f64_err=f64[0], plain_f64_err=f64[1]) if f32 else {}
  if not timed:
    return dict(max_abs_err=max_err, **exact)
  return dict(name=name, route="cuda",
              source=("small_vision_tpu_torch/csrc/attention_packed_f32.cu"
                      if f32 else
                      "small_vision_tpu_torch/csrc/attention_packed_bwd.cu"),
              replaces="small_vision_tpu/ops/attention.py:411",
              max_abs_err=max_err, **exact, **by_len[TRAIN_SEQS[-1]],
              by_len=by_len)


def _fmt(entry):
  show = lambda v: (f"{v:.4f}" if isinstance(v, float) else
                    f"({_fmt(v)})" if isinstance(v, dict) else f"{v}")
  return ", ".join(f"{k} {show(v)}" for k, v in entry.items())


def _close_to_max(got, want, ulps):
  """(max abs err, ok): within `ulps` bf16 ulps of the largest value of
  `want`, an ulp taken as 2^-7 of it (the spacing of bf16 values lies
  between 2^-8 and 2^-7 of their magnitude)."""
  got, want = got.float(), want.float()
  err = (got - want).abs().max().item()
  return err, err <= ulps * 2.0**-7 * want.abs().max().item()


# (batch, length) of the fused kernels' calls: the sampler's encoder and
# decoder, and the three training shapes.
FUSED_SHAPES = model_shapes(TRAIN_BATCH // 2)
# K5's (batch, length, width, hidden width): those at width 768, one at
# UMD-L/2's width 1,024, ViT-mu/16@224's 32 -> 128 ("map" and "tok": one
# stage of 64 whose upper half TMA fills with zeros), SigLIP So400m's
# 1,152 -> 4,304 (a hidden width that is a multiple of 8, not of 64) and
# 36 -> 150, which the wrapper runs on copies padded to 40 -> 152.
VIT_MU_SHAPES = ((BATCH, 196), (BATCH, 197))
FUSED_SHAPES_MLP = tuple((b, l, WIDTH, MLP_DIM) for b, l in FUSED_SHAPES) + (
    (BATCH, SEQ_DEC, 1024, 4096),) + tuple(
        (b, l, 32, 128) for b, l in VIT_MU_SHAPES) + (
            (BATCH, 256, 1152, 4304), (BATCH, 197, 36, 150))
# K5 in f32: the sampler's and the training shapes at width 768, and 36 ->
# 150 (no multiple of 4: scalar loads, nothing padded).
FUSED_SHAPES_MLP_F32 = tuple((b, l, WIDTH, MLP_DIM) for b, l in
                             FUSED_SHAPES) + ((BATCH, 197, 36, 150),)


def check_fused_mlp(fb, card, dtype=torch.bfloat16, shapes=FUSED_SHAPES_MLP):
  """K5 in `dtype` against its plain version at `shapes`: by default the
  sampler's and training shapes, two launches giving equal bits, with the
  time of each of its two launches, and the other widths of
  FUSED_SHAPES_MLP (UMD-L/2's, ViT-mu's, So400m's and a padded one), the
  same."""
  gen = torch.Generator(device="cuda").manual_seed(4)
  randn = lambda *s, std=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * std).to(dtype)
  lin = torch.nn.functional.linear
  f32 = dtype == torch.float32
  name = _named(fb.MLP_NAME, dtype)

  def weights(width, hidden):
    return (randn(width, hidden, std=width**-0.5), randn(hidden, std=0.1),
            randn(hidden, width, std=hidden**-0.5), randn(width, std=0.1))

  params = {}
  max_err, by_shape = 0.0, {}
  for b, seq, width, hidden in shapes:
    if (width, hidden) not in params:
      params[(width, hidden)] = weights(width, hidden)
    w1, b1, w2, b2 = params[(width, hidden)]
    x = randn(b, seq, width)
    args = (x, w1, b1, w2, b2)
    got = fb.fused_mlp_fwd(*args)
    again = fb.fused_mlp_fwd(*args)
    want = fb.fused_mlp_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
      fail(f"{name} B={b} L={seq} D={width}: two launches differ")
    if f32:
      # f32 throughout; the sums over the width and the hidden width in
      # another order: 1e-5 of the largest output.
      err = (got - want).abs().max().item()
      ok, what = err <= 1e-5 * want.abs().max().item(), "1e-5 of the max"
    else:
      # bf16 hidden activations and outputs on both sides; f32 sums over
      # the width and the hidden width in another order may flip the
      # rounding of a hidden value, which moves an output by about one
      # bf16 ulp: allow two ulps of the largest output.
      err, ok = _close_to_max(got, want, 2)
      what = "2 bf16 ulps of the max"
    max_err = max(max_err, err)
    print(f"[kernels] {name} B={b} L={seq} D={width}: max abs err "
          f"{err:.3e} of max {want.float().abs().max().item():.3e} (tolerance "
          f"{what}), two launches equal", flush=True)
    if not ok:
      fail(f"{name} disagrees with its plain version ({err:.3e})")
    rows = b * seq
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    bytes_moved = (2 * rows * width + 2 * width * hidden + hidden
                   + width) * x.element_size()
    flops = 4 * rows * width * hidden
    bound_ms, bound_by = _bound(bytes_moved, flops,
                                F32_FLOPS if f32 else BF16_FLOPS)
    # The model width's shapes by (batch, length), the others' by their
    # width (and hidden width, where it is not four times the width).
    key = f"{b}x{seq}" if width == WIDTH else f"{b}x{seq}_D{width}" + (
        "" if hidden == 4 * width else f"_H{hidden}")
    by_shape[key] = dict(
        ms=time_ms(lambda: fb.fused_mlp_fwd(*args), iters=20),
        plain_ms=time_ms(lambda: fb.fused_mlp_plain(*args), iters=3,
                         warmup=1),
        library_ms=time_ms(lambda: lin(torch.nn.functional.gelu(
            lin(x, w1t, b1), approximate="tanh"), w2t, b2), iters=20),
        bound_ms=bound_ms, bound_by=bound_by)
    # The two launches of one call, each timed alone.
    stages = fb.fused_mlp_stages(*args)
    by_shape[key]["stage_ms"] = {
        stage: time_ms(launch, iters=20) for stage, launch in stages.items()}
    print(f"[kernels] {name} B={b} L={seq} D={width} hidden="
          f"{hidden}: {_fmt(by_shape[key])} ({bytes_moved} bytes, "
          f"{flops} flops) on {card}", flush=True)
  return dict(name=name, route="cuda",
              source=("small_vision_tpu_torch/csrc/fused_mlp_f32.cu" if f32
                      else "small_vision_tpu_torch/csrc/fused_mlp.cu"),
              replaces="small_vision_tpu/ops/fused_block.py:185",
              max_abs_err=max_err, **by_shape[f"{BATCH}x{SEQ_ENC}"],
              by_shape=by_shape)


def check_fused_mha(fb, card, width=WIDTH, heads=HEADS,
                    shapes=FUSED_SHAPES, rank_heads=None, timed=True,
                    dtype=torch.bfloat16):
  """K6 in `dtype` against its plain version at `shapes` (by default the
  sampler's and training shapes); two launches must give equal bits; timed
  beside its library call and bound where `timed`. `rank_heads`: a tensor
  rank's heads of `heads` (phase tensor's entry, non-square projections
  (width, rank_heads * head dim) and back)."""
  gen = torch.Generator(device="cuda").manual_seed(5)
  randn = lambda *s, std=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * std).to(dtype)
  f32 = dtype == torch.float32
  name = _named(fb.MHA_NAME, dtype)
  head_dim = width // heads
  heads = rank_heads or heads
  hd = heads * head_dim
  params = []
  for _ in range(3):
    params += [randn(width, hd, std=width**-0.5), randn(hd, std=0.1)]
  params += [randn(hd, width, std=hd**-0.5), randn(width, std=0.1)]
  wq, bq, wk, bk, wv, bv, wo, bo = params
  lin = torch.nn.functional.linear
  wts = [w.t().contiguous() for w in (wq, wk, wv, wo)]
  max_err, by_shape = 0.0, {}
  max_len = fb.fused_mha_max_len(head_dim, f32)
  for b, seq in shapes:
    x = randn(b, seq, width)
    args = (x, *params, heads)
    got = fb.fused_mha_fwd(*args)
    again = fb.fused_mha_fwd(*args)
    want = fb.fused_mha_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
      fail(f"{name} B={b} L={seq} D={width}: two launches differ")
    if f32:
      # f32 throughout (the max-shift softmax on both sides); sums over the
      # width, D and L in another order: 1e-5 of the largest output.
      err = (got - want).abs().max().item()
      ok, what = err <= 1e-5 * want.abs().max().item(), "1e-5 of the max"
    else:
      # q, k, v, the probabilities, the head outputs and the output round
      # to bf16 on both sides; sums in another order may flip an inner
      # rounding, which moves an output by about one bf16 ulp: allow two
      # ulps of the largest output.
      err, ok = _close_to_max(got, want, 2)
      what = "2 bf16 ulps of the max"
    max_err = max(max_err, err)
    print(f"[kernels] {name} B={b} L={seq} D={width} H={heads}x"
          f"{head_dim}: max abs err "
          f"{err:.3e} of max {want.float().abs().max().item():.3e} "
          f"(tolerance {what}), two launches equal; L up to "
          f"{max_len} at head dim {head_dim}", flush=True)
    if not ok:
      fail(f"{name} disagrees with its plain version ({err:.3e})")
    if not timed:
      continue

    def library():
      split = lambda t: t.view(b, seq, heads, head_dim).transpose(1, 2)
      q, k, v = (split(lin(x, w, bias)) for w, bias in
                 zip(wts[:3], (bq, bk, bv)))
      o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
      return lin(o.transpose(1, 2).reshape(b, seq, hd), wts[3], bo)

    bytes_moved = (2 * b * seq * width + 4 * width * hd + 3 * hd
                   + width) * x.element_size()
    flops = (8 * b * seq * width * hd
             + 4 * b * heads * seq * seq * head_dim)
    bound_ms, bound_by = _bound(bytes_moved, flops,
                                F32_FLOPS if f32 else BF16_FLOPS)
    by_shape[f"{b}x{seq}"] = dict(
        ms=time_ms(lambda: fb.fused_mha_fwd(*args), iters=20),
        plain_ms=time_ms(lambda: fb.fused_mha_plain(*args), iters=3,
                         warmup=1),
        library_ms=time_ms(library, iters=20),
        library_backend=sdpa_backend(
            *[x.new_empty(b, seq, heads, head_dim).transpose(1, 2)] * 3),
        bound_ms=bound_ms, bound_by=bound_by)
    # The three launches of one call, each timed alone.
    stages = fb.fused_mha_stages(*args)
    by_shape[f"{b}x{seq}"]["stage_ms"] = {
        stage: time_ms(launch, iters=20) for stage, launch in stages.items()}
    print(f"[kernels] {name} B={b} L={seq} D={width} H={heads}x"
          f"{head_dim}: {_fmt(by_shape[f'{b}x{seq}'])} ({bytes_moved} bytes, {flops} "
          f"flops) on {card}", flush=True)
  return dict(name=name, route="cuda",
              source=("small_vision_tpu_torch/csrc/fused_mha_f32.cu" if f32
                      else "small_vision_tpu_torch/csrc/fused_mha.cu"),
              replaces="small_vision_tpu/ops/fused_block.py:68",
              max_abs_err=max_err, max_len=max_len,
              **by_shape.get("{}x{}".format(*shapes[0]), {}),
              **({"by_shape": by_shape} if timed else {}))


# K7's shapes at head dim 64: the sampler's, and the shape phase
# `unpacked` launches it at (the ablation tool's L = 257).
UNPACKED_SHAPES = ((BATCH, SEQ_ENC), (BATCH, SEQ_DEC),
                   (TRAIN_BATCH // 2, TRAIN_SEQS[-1]))


# K7 and K8 in f32: the sampler's shape and the training shapes.
UNPACKED_SHAPES_F32 = ((BATCH, SEQ_ENC),) + tuple(
    (TRAIN_BATCH // 2, l) for l in TRAIN_SEQS)


def check_attention_unpacked(attn, card, width=WIDTH, heads=HEADS,
                             shapes=UNPACKED_SHAPES, timed=True,
                             dtype=torch.bfloat16):
  """K7 in `dtype` on [B, L, heads, width / heads] against its plain
  version at `shapes`, two launches giving equal bits; where `timed`,
  timed at each but the decoder's sampler shape."""
  gen = torch.Generator(device="cuda").manual_seed(6)
  head_dim = width // heads
  f32 = dtype == torch.float32
  name = _named(attn.UNPACKED_NAME, dtype)
  max_err, by_shape, f64 = 0.0, {}, [0.0, 0.0]
  max_len = (attn._unpacked_f32_lib()[1] if f32
             else attn._unpacked_lib()[1](head_dim))
  for b, seq in shapes:
    q, k, v = (torch.randn(b, seq, heads, head_dim, generator=gen,
                           device="cuda").to(dtype)
               for _ in range(3))
    got = attn.attention_unpacked_fwd(q, k, v)
    again = attn.attention_unpacked_fwd(q, k, v)
    ref = attn.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
      fail(f"{name} B={b} L={seq}: two launches differ")
    err = (got.float() - ref).abs()
    exact = ""
    if f32:
      # f32 throughout, the max-shift softmax on both sides; score and
      # value sums in another order: 1e-5 of the largest output; and the
      # 3xTF32 products within F64_TOL of float64.
      bad = (err > 1e-5 * ref.abs().max()).sum().item()
      exact = _f64_forward(name, b, seq, heads, got, ref, attn.attention_plain(
          *(t.double() for t in (q, k, v))), f64)
    else:
      # Two bf16 ulps at unit magnitude (outputs are convex mixes of N(0,1)
      # values): the f32 score sums run in another order, which may round
      # a probability to the neighbouring bf16 value, and o itself is bf16.
      bad = (err > 1e-2 + 1e-2 * ref.abs()).sum().item()
    max_err = max(max_err, err.max().item())
    print(f"[kernels] {name} B={b} L={seq} H={heads} "
          f"D={head_dim}: max abs err {err.max().item():.3e}, {bad} elements "
          f"over tolerance, two launches equal; L up to {max_len}{exact}",
          flush=True)
    if bad:
      fail(f"{name} disagrees with its plain version ({bad})")
    if not timed or (seq == SEQ_DEC and b == BATCH):
      continue
    heads_first = lambda t: t.transpose(1, 2)
    bytes_moved = 4 * b * seq * width * q.element_size()
    one_pass = 2 * b * heads * seq * seq * head_dim
    flops = 2 * one_pass
    bound_ms, bound_by, extra = _attn_bound(bytes_moved, flops, f32,
                                            F32_FWD_PASSES * one_pass)
    by_shape[f"{b}x{seq}"] = dict(
        ms=time_ms(lambda: attn.attention_unpacked_fwd(q, k, v)),
        plain_ms=time_ms(lambda: attn.attention_plain(q, k, v), iters=10),
        library_ms=time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                heads_first(q), heads_first(k), heads_first(v))),
        library_backend=sdpa_backend(heads_first(q), heads_first(k),
                                     heads_first(v)),
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    print(f"[kernels] {name} B={b} L={seq} H={heads} "
          f"D={head_dim}: {_fmt(by_shape[f'{b}x{seq}'])} ({bytes_moved} "
          f"bytes, {flops} flops) on {card}", flush=True)
  exact = dict(f64_err=f64[0], plain_f64_err=f64[1]) if f32 else {}
  return dict(name=name, route="cuda",
              source=("small_vision_tpu_torch/csrc/attention_unpacked_f32.cu"
                      if f32 else
                      "small_vision_tpu_torch/csrc/attention_unpacked.cu"),
              replaces="small_vision_tpu/ops/attention.py:79",
              max_abs_err=max_err, max_len=max_len, **exact,
              **by_shape.get(f"{BATCH}x{SEQ_ENC}", {}),
              **({"by_shape": by_shape} if timed else {}))


# K8's extra lengths, each checked but not timed: (batch, length). 65 is
# one key past a 64-row tile; 1,024 is past the 704 the kernel once took.
K8_EDGE_SHAPES = ((TRAIN_BATCH // 2, 65), (8, 1024))


K8_SHAPES = tuple((TRAIN_BATCH // 2, l) for l in TRAIN_SEQS) + K8_EDGE_SHAPES


def check_attention_unpacked_bwd(attn, card, width=WIDTH, heads=HEADS,
                                 shapes=K8_SHAPES, timed=True,
                                 dtype=torch.bfloat16):
  """K8 in `dtype` on [B, L, heads, width / heads] against its plain
  version at `shapes` (by default the training shapes, a ragged length and
  one past its old length limit), two launches giving equal bits; where
  `timed`, timed at the training shapes, with the time of each of its
  kernels (two, f32 three)."""
  gen = torch.Generator(device="cuda").manual_seed(7)
  head_dim = width // heads
  f32 = dtype == torch.float32
  name = _named(attn.UNPACKED_BWD_NAME, dtype)
  max_err, by_len, f64 = 0.0, {}, [0.0, 0.0]
  max_len = (attn._unpacked_f32_lib() if f32 else attn._unpacked_bwd_lib())[1]
  for b, seq in shapes:
    q, k, v, do = (torch.randn(b, seq, heads, head_dim, generator=gen,
                               device="cuda").to(dtype)
                   for _ in range(4))
    got = attn.attention_unpacked_bwd(q, k, v, do)
    again = attn.attention_unpacked_bwd(q, k, v, do)
    want = attn.attention_bwd_plain(q, k, v, do)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
      fail(f"{name} B={b} L={seq}: two launches differ")
    worst, bad = 0.0, 0
    top = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
      # bf16 outputs of f32 sums over L; a sum in another order may flip
      # the bf16 rounding of a P or dS input of a product: a few bf16 ulps
      # of the largest output, floored at 1e-3 of the largest of the three
      # (dq and dk vanish at L = 1), as in check_attention_bwd. f32: the
      # same sums in another order, nothing rounded to bf16: 1e-4 of each
      # gradient's largest value (K4 f32's bound).
      e = (g.float() - w.float()).abs().max().item()
      worst = max(worst, e)
      bad += int(e > (1e-4 if f32 else 2.0**-6) * max(
          w.float().abs().max().item(), 1e-3 * top))
    max_err = max(max_err, worst)
    exact = ""
    if f32:
      errs = _f64_errors(got, want, attn.attention_bwd_plain(
          *(t.double() for t in (q, k, v, do))))
      f64 = [max(a, e) for a, e in zip(f64, errs)]
      exact = (f"; against f64 {errs[0]:.3e} of each output's largest "
               f"(the plain f32 version {errs[1]:.3e}; tolerance {F64_TOL})")
    print(f"[kernels] {name} B={b} L={seq} H={heads} "
          f"D={head_dim}: max abs err {worst:.3e}, {bad} outputs over "
          f"tolerance, two launches equal; L up to {max_len}{exact}",
          flush=True)
    if bad:
      fail(f"{name} disagrees with its plain version ({bad})")
    if f32 and f64[0] > F64_TOL:
      fail(f"{name} B={b} L={seq} H={heads} is {f64[0]:.3e} off the f64 "
           "plain version")
    if not timed or b != TRAIN_BATCH // 2 or seq not in TRAIN_SEQS:
      continue
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    dos = do.transpose(1, 2)
    one_pass = 2 * b * heads * seq * seq * head_dim
    bound_ms, bound_by, extra = _attn_bound(
        7 * b * seq * width * q.element_size(), 5 * one_pass, f32,
        F32_BWD_PASSES * one_pass)
    by_len[seq] = dict(
        ms=time_ms(lambda: attn.attention_unpacked_bwd(q, k, v, do)),
        plain_ms=time_ms(lambda: attn.attention_bwd_plain(q, k, v, do),
                         iters=5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dos, retain_graph=True)),
        library_backend=sdpa_backend(qs, ks, vs),
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    # The kernels of one call, each timed alone, in order (each reads the
    # statistics an earlier one wrote in its warm-up).
    stages = attn.attention_unpacked_bwd_stages(q, k, v, do)
    by_len[seq]["stage_ms"] = {
        stage: time_ms(launch) for stage, launch in stages.items()}
    print(f"[kernels] {name} B={b} L={seq} H={heads} "
          f"D={head_dim}: {_fmt(by_len[seq])} on {card}", flush=True)
  return dict(name=name, route="cuda",
              source=("small_vision_tpu_torch/csrc/attention_unpacked_f32.cu"
                      if f32 else
                      "small_vision_tpu_torch/csrc/attention_unpacked_bwd.cu"),
              replaces="small_vision_tpu/ops/attention.py:162",
              max_abs_err=max_err, max_len=max_len,
              **(dict(f64_err=f64[0], plain_f64_err=f64[1]) if f32 else {}),
              **by_len.get(TRAIN_SEQS[-1], {}),
              **({"by_len": by_len} if timed else {}))


ABLATE_SHAPES = ((128, 257), (128, 164))  # the ablation tool's (B, L)
# Tolerance of each arm of K9 in bf16 ulps of the largest output (an ulp
# taken as 2^-7 of it). The softmax arms and nosoftmax round p to bf16 on
# both sides from f32 scores summed in another order, which may flip a p
# to its neighbour, and the output is bf16: two ulps. nomm has no sum whose
# order could differ (e = exp(0) = 1, the row sum is L, one exact product):
# half an ulp, one rounding. bf16exp rounds the shifted score to bf16
# before exp, so a flipped rounding moves that e by up to 2^-8 |S - m|, a
# few per cent for the far keys: four ulps.
ABLATE_ULPS = {"prod": 2, "nosoftmax": 2, "nomm": 0.5, "bf16exp": 4,
               "exp2": 2, "mulmask": 2, "nomax": 2}


def check_attention_ablate(attn, card, width=WIDTH, heads=HEADS,
                           shapes=ABLATE_SHAPES, timed=True,
                           timed_shapes=ABLATE_SHAPES, arms=None):
  """K9, all seven arms (or `arms`) on (B, L, width) with `heads` heads at
  `shapes`, against its plain version, two launches of each giving equal
  bits; where
  `timed`, each arm timed at those of `timed_shapes` (by default the
  tool's two shapes, ABLATE_SHAPES). Returns its kernels-line entry (times
  of `prod` at L = 257, or at the first timed shape, on top, every arm's
  under `by_shape`)."""
  gen = torch.Generator(device="cuda").manual_seed(9)
  head_dim = width // heads
  max_err, by_shape = 0.0, {}
  max_len = attn._ablate_lib()[1](head_dim)
  for b, seq in shapes:
    q, k, v = (torch.randn(b, seq, width, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    split = lambda t: t.view(b, seq, heads, head_dim).transpose(1, 2)
    timing = timed and (b, seq) in timed_shapes
    timings = {}
    for arm in arms or attn.ABLATE_VARIANTS:
      got = attn.attention_ablate_fwd(q, k, v, heads, arm)
      again = attn.attention_ablate_fwd(q, k, v, heads, arm)
      want = attn.attention_ablate_plain(q, k, v, heads, arm)
      torch.cuda.synchronize()
      if not torch.equal(got, again):
        fail(f"attention_ablate {arm} L={seq}: two launches differ")
      err, ok = _close_to_max(got, want, ABLATE_ULPS[arm])
      max_err = max(max_err, err)
      if timing:
        timings[arm] = dict(
            ms=time_ms(lambda: attn.attention_ablate_fwd(q, k, v, heads, arm),
                       iters=20),
            plain_ms=time_ms(lambda: attn.attention_ablate_plain(
                q, k, v, heads, arm), iters=3, warmup=1),
            max_abs_err=err)
      print(f"[kernels] attention_ablate {arm} B={b} L={seq} H={heads} "
            f"D={head_dim}: max abs err {err:.3e} of max "
            f"{want.float().abs().max().item():.3e} (tolerance "
            f"{ABLATE_ULPS[arm]} bf16 ulps of the max), two launches equal"
            + (f"; {_fmt(timings[arm])}" if timing else ""), flush=True)
      if not ok:
        fail(f"attention_ablate {arm} L={seq} disagrees with its plain "
             f"version ({err:.3e})")
    if not timing:
      continue
    bytes_moved = 4 * b * seq * width * 2
    flops = 4 * b * heads * seq * seq * head_dim
    bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v)), iters=20)
    backend = sdpa_backend(split(q), split(k), split(v))
    by_shape[f"{b}x{seq}"] = dict(arms=timings, library_ms=library_ms,
                                  library_backend=backend,
                                  bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] attention_ablate B={b} L={seq} H={heads} D={head_dim}: "
          f"sdpa ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bytes_moved} bytes, {flops} flops); L up to {max_len} on "
          f"{card}", flush=True)
  entry = dict(name=attn.ABLATE_NAME, route="cuda",
               source="small_vision_tpu_torch/csrc/attention_ablate.cu",
               replaces="scripts/ablate_attention_kernel.py:46",
               max_abs_err=max_err, max_len=max_len)
  if timed and by_shape:
    top = by_shape.get("128x257") or next(iter(by_shape.values()))
    entry.update(ms=top["arms"]["prod"]["ms"],
                 plain_ms=top["arms"]["prod"]["plain_ms"],
                 library_ms=top["library_ms"],
                 library_backend=top["library_backend"],
                 bound_ms=top["bound_ms"],
                 bound_by=top["bound_by"], by_shape=by_shape)
  return entry


# K6-K9 at head dims other than 64 (phase kernels): (head dim, heads,
# timed). ViT-H's 80 (16 heads at 1,280, the classifier's K6), the
# `heads=6` setting's 128 (6 heads at 768), the `heads=4` and `heads=3`
# settings' 192 and 256 (three and four 64-column tiles a head) and
# `heads=32`'s 12 at UMD-S's 384 (run on heads zero-padded to 16) are timed;
# the narrow 8 and 16 (the quick configs' widths), ViT-g's and ViT-G's 88
# and 104 (16 heads at 1,408 and 1,664), and 136, 200 and 248 (8 heads; a
# ragged last tile of 8, 8 and 56 columns) are checked. Each at the
# sampler's (64, 260) and the training shapes (128, L = 68, 164, 257); K6
# at 80 also at ViT-H/14@224's (64, 256).
WIDE_HEAD_DIMS = ((80, 16, True), (128, 6, True), (192, 4, True),
                  (256, 3, True), (12, 32, True), (8, 8, False),
                  (16, 4, False), (88, 16, False), (104, 16, False),
                  (136, 8, False), (200, 8, False), (248, 8, False))
# K3 and K4 at head dims other than 64 (phase kernels): (width, heads,
# timed), each at the sampler's and the training shapes. 128, 192 and 256
# (`heads=6`, `heads=4`, `heads=3` at width 768), 12 (`heads=32` at UMD-S's
# 384) and 4 (32 heads at 128; both on heads zero-padded to a multiple of
# 8) timed beside SDPA; 8, 16, 80 and 104 (the quick configs, ViT-H,
# ViT-G) and 136, 200 and 248 (a ragged last tile) checked.
PACKED_HEAD_DIMS = ((768, 6, True), (768, 4, True), (768, 3, True),
                    (384, 32, True), (128, 32, True),
                    (32, 4, False), (64, 4, False), (1280, 16, False),
                    (1664, 16, False), (1088, 8, False), (1600, 8, False),
                    (1984, 8, False))
# Every attention kernel at head dim 256 (`heads=3` at width 768) past the
# lengths of the model (phase kernels, checked): (width, heads, (batch,
# length)s).
WIDE_LONG = (WIDTH, 3, ((4, 1024), (1, 4096)))
WIDE_SHAPES = ((BATCH, SEQ_ENC),) + tuple((TRAIN_BATCH // 2, l)
                                          for l in TRAIN_SEQS)
# K3, K6, K7 and K9's seven arms past the lengths whose K and V they keep
# resident (320 keys at head dims up to 64, 384 above), where K and V
# stream through a ring, each timed (phase kernels): (width, heads, (batch,
# length)s). ViT-L/16@512's 16 heads of 64 ("map" 1,024, "tok" 1,025),
# ViT-H/14@518's 16 heads of 80 (1,369), and the limit the forwards share
# with K4 and K8, 4,096, at UMD-B's 12 heads of 64.
# K6 on a tensor rank's narrow shards at width 384 (phase kernels, timed):
# (heads, rank's heads, (batch, length)s). 3 of 12 heads of 32 (UMD-S under
# `heads=12` over a tensor group of four: 96 columns) and 3 of `heads=32`'s
# 32 heads of 12 (36 columns, run at 48).
NARROW_SHARDS = ((12, 3), (32, 3))
NARROW_SHARD_SHAPES = ((BATCH, SEQ_ENC), (TRAIN_BATCH // 2, SEQ_DEC))
LONG_ATTENTION = ((1024, 16, ((BATCH, 1024), (BATCH, 1025))),
                  (1280, 16, ((BATCH, 1369),)),
                  (WIDTH, HEADS, ((4, 4096),)))


# Every attention kernel past head dim 256, the kernels' wide path (phase
# kernels): (head dim, heads, timed). `heads=2`'s 384 and `heads=1`'s 768
# at width 768, timed at the sampler's (64, 260) and the decoder's training
# shape (128, 257) beside bound and SDPA (its efficient or math backend:
# flash takes head dims up to 256), checked at (128, 68) and (128, 164);
# 264 (a ragged fifth 64-column tile), 520 (a ragged ninth), 1,024 (UMD-L's
# width in one head), 1,664 (ViT-G's) and 2,048 (the limit), in two heads,
# checked at WIDER_CHECK_SHAPES. K9's seven arms at 520, its prod and exp2
# arms at the others.
WIDER_HEAD_DIMS = ((384, 2, True), (768, 1, True), (264, 2, False),
                   (520, 2, False), (1024, 2, False), (1664, 2, False),
                   (2048, 2, False))
WIDER_TIMED = ((BATCH, SEQ_ENC), (TRAIN_BATCH // 2, TRAIN_SEQS[-1]))
WIDER_CHECKED = tuple((TRAIN_BATCH // 2, l) for l in TRAIN_SEQS[:-1])
WIDER_CHECK_SHAPES = ((4, 65), (2, 257))
# One head of 1,024 and one of 2,048 at batch 1 from one key to the limit,
# every attention kernel, checked: (head dim, lengths).
WIDER_LONG = ((1024, (1, 65, 1024, 4096)), (2048, (1, 65, 1024, 4096)))
# K1 and K2 at the widths that the bf16 instances do not take (phase
# kernels), in bf16 and f32: (width, timed). One column, 36 (the narrow
# model of the CPU tests), 100 (4-element vectors), 1,000 (not a multiple
# of 32), 2,080 (two warps a row), 4,096 and 8,192 (eight warps a row,
# MAX_WIDTH); timed at 36, 2,080 and 4,096. K1 at the sampler's (64, 260)
# and the decoder's training shape (128, 257), K2 at the latter.
NEW_LN_WIDTHS = ((1, False), (36, True), (100, False), (1000, False),
                 (2080, True), (4096, True), (8192, False))
NEW_WIDTH_SHAPES = ((BATCH, SEQ_ENC), (TRAIN_BATCH // 2, SEQ_DEC))
# K3 and K4 in f32 at head dims other than 64, checked: (width, heads,
# (batch, length)s). `heads=32`'s 12 at UMD-S's 384 and `heads=4`'s 192 at
# the sampler's and the decoder's training shape, `heads=1`'s 768 (twelve
# column chunks a head, each recomputing the scores) at WIDER_CHECK_SHAPES.
F32_HEAD_DIMS = ((384, 32, NEW_WIDTH_SHAPES), (768, 4, NEW_WIDTH_SHAPES),
                 (768, 1, WIDER_CHECK_SHAPES))


def _wide_head_entries(attn, fb, card, width, heads, timed_shapes,
                       checked_shapes, arms):
  """{kernel name: its kernels-line entry} of K3, K4, K6, K7, K8 and K9
  (`arms`, None for all seven) at `heads` heads of width // heads: timed
  at `timed_shapes` beside bound and library, and checked against the
  plain versions, two launches equal, there and at `checked_shapes`."""
  names = (attn.NAME, attn.BWD_NAME, fb.MHA_NAME, attn.UNPACKED_NAME,
           attn.UNPACKED_BWD_NAME, attn.ABLATE_NAME)
  out = {}
  for shapes, timed in ((timed_shapes, True), (checked_shapes, False)):
    if not shapes:
      continue
    entries = (
        check_attention(attn, card, width, heads, timed=timed,
                        shapes=shapes),
        check_attention_bwd(attn, card, width, heads, timed=timed,
                            shapes=shapes),
        check_fused_mha(fb, card, width, heads, shapes, timed=timed),
        check_attention_unpacked(attn, card, width, heads, shapes, timed),
        check_attention_unpacked_bwd(attn, card, width, heads, shapes,
                                     timed),
        check_attention_ablate(attn, card, width, heads, shapes, timed,
                               timed_shapes=shapes, arms=arms))
    for name, entry in zip(names, entries):
      got = out.setdefault(name, {})
      err = max(got.get("max_abs_err", 0.0), entry["max_abs_err"])
      got.update(entry, max_abs_err=err)
  return out


def _attention_wrappers(attn, fb, head_dim, heads):
  """(name, a call of that wrapper on zeros of `heads` heads of
  `head_dim`) for each of K3, K4 and K6-K9."""
  width = heads * head_dim
  t4 = torch.zeros(1, 20, heads, head_dim, dtype=torch.bfloat16,
                   device="cuda")
  t3 = t4.reshape(1, 20, width)
  w = torch.zeros(width, width, dtype=torch.bfloat16, device="cuda")
  bias = torch.zeros(width, dtype=torch.bfloat16, device="cuda")
  return (
      (attn.NAME, lambda: attn.attention_packed(t3, t3, t3, heads)),
      (attn.BWD_NAME,
       lambda: attn.attention_packed_bwd(t3, t3, t3, t3, heads)),
      (fb.MHA_NAME, lambda: fb.fused_mha(t3, *(w, bias) * 4, heads)),
      (attn.UNPACKED_NAME, lambda: attn.fused_attention(t4, t4, t4)),
      (attn.UNPACKED_BWD_NAME,
       lambda: attn.attention_unpacked_bwd(t4, t4, t4, t4)),
      (attn.ABLATE_NAME,
       lambda: attn.attention_ablate(t3, t3, t3, heads, "prod")))


def check_refused_head_dims(attn, fb, build):
  """A head dim of 2,056 and of 0 must make each of K3, K4 and K6-K9's
  wrappers raise ValueError, with no launch and no CPU run; one of 12
  (`heads=32` at UMD-S's 384, run on heads zero-padded to 16) must launch
  each of their kernels once."""
  build.reset_launches()
  for head_dim, heads in ((2056, 1), (0, 8)):
    for name, fn in _attention_wrappers(attn, fb, head_dim, heads):
      try:
        fn()
      except ValueError as e:
        if f"head dim {head_dim}" not in str(e):
          fail(f"{name} at head dim {head_dim}: {e}")
      else:
        fail(f"{name} took head dim {head_dim}")
  if build.LAUNCHES:
    fail(f"refused head dims launched {dict(build.LAUNCHES)}")
  taken = _attention_wrappers(attn, fb, 12, 32)
  for _, fn in taken:
    fn()
  torch.cuda.synchronize()
  if dict(build.LAUNCHES) != {name: 1 for name, _ in taken}:
    fail(f"head dim 12 launched {dict(build.LAUNCHES)}, not each kernel "
         "once")
  print("[kernels] K3, K4, K6, K7, K8 and K9 refuse head dims 2,056 and 0 "
        "(ValueError, no launch) and take 12 (one launch each)", flush=True)


def _train_step_grads(config, params, images, draws, dev):
  """(loss, [(flax name, f32 gradient on the CPU)]) of one training step's
  forward and backward on `dev`, from `params` with injected draws."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.train import train_ae

  model = train_ae.build_model(config, device=dev, trainable=True)
  model.load_state_dict(convert.params_from_jax(params, model))
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(config, names, total_steps=10, warmup_steps=1)
  state = train_ae.init_train_state(model, opt, config, device=dev)
  step = train_ae.make_update_fn(model, opt, config, device_pp=None)
  loss, grads = step.loss_and_grads(
      state, {"image": torch.from_numpy(images)},
      {k: v if k == "dropout" else torch.from_numpy(v)
       for k, v in draws.items()})
  return float(loss), [(n, g.float().cpu()) for n, g in zip(names, grads)]


def _dropout_masks(rng, config, n, rate):
  """The keep masks of one training step's forward, in the order it takes
  them: the MAE branch (encoder at 4 + 64 tokens, decoder at 1 + 256),
  then the diffusion branch (encoder at 4 + 160), three a block (attention
  branch, MLP hidden, MLP branch), as bool numpy arrays."""
  model = config["model"]
  width, hidden = WIDTH, MLP_DIM
  masks = []
  for enc_len in (68, 164):
    for depth, seq in ((model["depth"], enc_len),
                       (model["dec_depth"], SEQ_DEC)):
      for _ in range(depth):
        for d in (width, hidden, width):
          masks.append(rng.random((n, seq, d)) >= rate)
  return masks


# phase_model's bounds (forward, loss, gradients), relative to the largest
# prediction, the CPU's loss and each leaf's largest gradient. bf16: a few
# bf16 roundings (2^-8 each) that the two devices' summation orders place
# differently, through three blocks and the head. f32 (dtype_mm="float32",
# TF32 off on the card): the same f32 arithmetic in another summation
# order, nothing rounded to bf16; 1e-3 leaves room for the orders of the
# card's and the CPU's matmuls over 768 and 3,072 terms in three blocks and
# their backward.
MODEL_BOUNDS = (3e-2, 1e-2, 5e-2)
MODEL_BOUNDS_F32 = (1e-3, 1e-4, 1e-3)


def phase_model(build, card, attn_impl, setting="", extra="", model=None,
                per_block=None, dropout=0.0, bounds=MODEL_BOUNDS):
  """Full-width model at depth 2 + 1 under `attn_impl` (and the config
  string `extra`, the model's fields `model`): card (kernels) against CPU
  (plain), the sampler's forward and one training step's loss and
  gradients, with `per_block` the launches a block makes in the step,
  within `bounds` (MODEL_BOUNDS, or MODEL_BOUNDS_F32 in f32)."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae

  config = ae_i1k.get_config(f"batch_size=8,attn_impl={attn_impl}{extra}")
  config["model"].update(depth=2, dec_depth=1, dropout=dropout,
                         **(model or {}))
  label = f"{attn_impl}{' ' + setting if setting else ''}"
  params = convert.init_params(config, seed=1)
  rng = np.random.default_rng(2)
  x_t = rng.standard_normal((3, 64, 64, 3), dtype=np.float32)
  t = np.array([1, 500, 1000])  # the sampler feeds t + 1 for t in 0..999
  preds = {}
  for dev in ("cpu", "cuda"):
    model = train_ae.build_model(config, device=dev)
    model.load_state_dict(convert.params_from_jax(params, model))
    with torch.inference_mode():
      preds[dev] = model(torch.from_numpy(x_t).to(dev),
                         t=torch.from_numpy(t).to(dev))[0].cpu()
  err = (preds["cuda"] - preds["cpu"]).abs().max().item()
  scale = preds["cpu"].abs().max().item()
  variant = f"UMD-{config['model']['variant']}"
  print(f"[model] {label}: forward (3, 64, 64, 3) of {variant} at full "
        f"width, depth 2+1, t = {t.tolist()}: max abs err {err:.3e} of max "
        f"|pred| {scale:.3e}", flush=True)
  # MODEL_BOUNDS: bf16 matmuls summed in another order on the two devices:
  # a few bf16 roundings (2^-8 relative each) through three blocks and the
  # head (f32: MODEL_BOUNDS_F32).
  if not err <= bounds[0] * scale:
    fail(f"model forward on the card differs from the CPU by {err:.3e}")

  # One training step at batch 8 (4 + 4), with draws made here.
  n = 8 // 2
  draws = {"t": rng.integers(0, 1000, (n,)),
           "noise": rng.standard_normal((n, 64, 64, 3), dtype=np.float32),
           "mae_noise": rng.random((n, 256), dtype=np.float32),
           "dit_noise": rng.random((n, 256), dtype=np.float32)}
  if dropout:
    draws["dropout"] = _dropout_masks(rng, config, n, dropout)
  images = rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
  loss_cpu, grads_cpu = _train_step_grads(config, params, images, draws,
                                          "cpu")
  build.reset_launches()
  loss_gpu, grads_gpu = _train_step_grads(config, params, images, draws,
                                          "cuda")
  launches = dict(build.LAUNCHES)
  # Two branches of 2 + 1 blocks.
  want = _times(per_block or BLOCK_TRAIN_LAUNCHES[attn_impl], 6)
  if launches != want:
    fail(f"training step launches {launches} != {want}")
  # Each leaf's gradient relative to its largest element, with a floor of
  # 1e-3 of the largest gradient of any leaf for the leaves whose gradient
  # is 0 analytically and round-off in practice (the key biases: a shift of
  # all of a query's scores does not change its softmax). bf16 activations
  # and bf16 K2/K4 outputs, rounded at ties that the two sides' summation
  # orders split differently: a few bf16 roundings (2^-8 each) per leaf.
  top = max(g.abs().max().item() for _, g in grads_cpu)
  worst, worst_name = 0.0, None
  for (name, gc), (_, gg) in zip(grads_cpu, grads_gpu):
    rel = ((gg - gc).abs().max().item()
           / max(gc.abs().max().item(), 1e-3 * top))
    if rel > worst:
      worst, worst_name = rel, name
  loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  print(f"[model] {label}: training step (8, 64, 64, 3) of {variant} at "
        f"full width, depth 2+1: loss card {loss_gpu:.6f}, cpu "
        f"{loss_cpu:.6f} "
        f"(rel {loss_rel:.2e}); "
        f"{len(grads_cpu)} gradient leaves, worst leaf-relative err "
        f"{worst:.3e} ({worst_name}); launches {launches} on {card}",
        flush=True)
  # The loss is an f32 mean over bf16 predictions (see the forward above).
  if not loss_rel <= bounds[1]:
    fail(f"training loss on the card differs from the CPU by {loss_rel:.2e}")
  if not worst <= bounds[2]:
    fail(f"training gradients on the card differ from the CPU: {worst:.3e} "
         f"of leaf max at {worst_name}")


def phase_train(build, card, attn_impl, quant="", tag="train", extra="",
                per_block=None, variant="B/4", windows=False, model=None,
                steps=TRAIN_STEPS):
  """The full UMD-<variant>@64 training step at batch 256 through
  `train_and_evaluate`, on synthetic data from `init_train_params`, under
  `attn_impl` (and the model's `quant`, phase quant; the config string
  `extra` and a block's launches `per_block`, phase settings; the model's
  fields `model`, phase f32); with its peak memory. With `windows` the
  run is `window_run_steps()` long and its img/s the requalified median of
  its windows (`qualified_steps`); without, `steps` long (1 warm-up)."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae

  steps = window_run_steps() if windows else steps
  config = ae_i1k.get_config(
      f"variant={variant},size=64,data=synthetic,batch_size={TRAIN_BATCH},"
      f"total_steps={steps},log_steps=1,eval_steps=-1,"
      f"attn_impl={attn_impl},quant={quant}{extra}")
  config["model"].update(model or {})
  what = f"{attn_impl}{', ' + quant if quant else ''}{extra}" + "".join(
      f", {k}={v}" for k, v in (model or {}).items())
  if variant != "B/4":
    what = f"UMD-{variant} {what}"
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  build.reset_launches()
  train_state, history = train_ae.train_and_evaluate(
      config, device="cuda",
      log=lambda s: print(f"[{tag}] {what}: {s}", flush=True))
  launches = dict(build.LAUNCHES)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  n_params = sum(p.numel() for p in train_state["params"])
  del train_state
  torch.cuda.empty_cache()

  timed = history[1:]
  ms = sum(h["ms"] for h in timed) / len(timed)
  print(f"[{tag}] {what}: UMD-{variant}@64, {n_params} parameters, batch "
        f"{TRAIN_BATCH}: {len(timed)} timed steps, mean {ms:.2f} ms/step (min "
        f"{min(h['ms'] for h in timed):.2f}, max "
        f"{max(h['ms'] for h in timed):.2f}) = {TRAIN_BATCH / ms * 1e3:.2f} "
        f"img/s; peak memory {peak_gb:.2f} GB (max_memory_allocated); "
        f"waiting for the batch {max(h['data_ms'] for h in timed):.3f} "
        f"ms at most on {card}", flush=True)
  if len(history) != steps:
    fail(f"{len(history)} steps ran, not {steps}")
  losses = [h["training_loss"] for h in history]
  if not all(np.isfinite(losses)):
    fail(f"non-finite training loss: {losses}")
  if not losses[-1] < losses[0]:
    fail(f"the training loss did not fall: {losses}")
  # Step 1 runs at learning rate 0 (warm-up starts at 0), so its parameter
  # norm is the initial one; the last step's must differ from it.
  if not (history[-1]["l2_params"] != history[0]["l2_params"]
          and history[-1]["l2_updates"] > 0):
    fail("the parameters did not change")
  # Two branches of 12 + 4 blocks a step.
  per_block = per_block or (BLOCK_TRAIN_LAUNCHES_INT8 if quant else
                            BLOCK_TRAIN_LAUNCHES)[attn_impl]
  want = _times(per_block, 2 * BLOCKS * steps)
  print(f"[{tag}] {what}: kernel launches in {steps} steps: "
        f"{launches}, model says {want}", flush=True)
  if launches != want:
    fail(f"launch counts {launches} != {want}")
  data_ms = sum(h["data_ms"] for h in timed) / len(timed)
  out = {"img_per_s": TRAIN_BATCH / (ms + data_ms) * 1e3, "ms": ms,
         "data_ms": data_ms, "launches": launches, "peak_gb": peak_gb,
         "steps": steps}
  if windows:
    out["qual"] = qualified_steps(history, TRAIN_BATCH)
    out["img_per_s"] = out["qual"]["median"]
    print(f"[{tag}] {what}: training {qual_text(out['qual'])} on {card}",
          flush=True)
  return out


def _check_images(images, n):
  if images.shape != (n, 64, 64, 3) or images.dtype != np.uint8:
    fail(f"bad images {images.shape} {images.dtype} for n={n}")
  flat = images.reshape(n, -1)
  if np.any(flat.max(axis=1) == flat.min(axis=1)):
    fail("a constant image came back")


# The sampler calls off the main path (phases settings (b), classifier
# (c), heads, shapes and quant) take SIDE_SAMPLER_STEPS DDIM steps; they are
# compared with the 125-step calls of phase serve in ms a forward.
SIDE_SAMPLER_STEPS = 25


def _fwd_ms(call):
  """ms a forward of a sampler call's reading (`steps` + 1 forwards)."""
  return call["s"] * 1e3 / (call.get("steps", 125) + 1)


def _warm_sampler(config, params):
  """The warm-up before a timed sampler call: one 2-step call of the same
  config and weights (cuBLAS handles, the allocator, kernel loads at the
  call's shapes), not a 125-step one."""
  from small_vision_tpu_torch.tools import export_sampler

  warm = dict(config, diff_schedule=dict(config["diff_schedule"],
                                         sampling_timesteps=2))
  export_sampler.build_sample_callable(warm, params, fn="uncond_eps",
                                       batch_size=BATCH, device="cuda")(12345)
  torch.cuda.synchronize()


def phase_sample_call(build, card, attn_impl, quant="", tag="serve",
                      extra="", windows=False, steps=125, model=None,
                      per_block=None):
  """One sampler call of `steps` DDIM steps (the config's 125, or
  SIDE_SAMPLER_STEPS) at batch 64 under `attn_impl` (and the model's
  `quant`, phase quant; the config string `extra`, phase settings; the
  model's fields `model` and a block's launches `per_block`, phase f32),
  through `build_sample_callable` (what the server calls), with its ms a
  forward; with `windows`, then the requalified median of single
  calls."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.tools import export_sampler

  config = ae_i1k.get_config(f"variant=B/4,size=64,samples_per_call={BATCH},"
                             f"attn_impl={attn_impl},quant={quant}{extra}")
  config["model"].update(model or {})
  config["diff_schedule"] = dict(config["diff_schedule"],
                                 sampling_timesteps=steps)
  what = f"{attn_impl}{', ' + quant if quant else ''}{extra}" + "".join(
      f", {k}={v}" for k, v in (model or {}).items())
  params = _card_params(config, seed=0)
  sample = export_sampler.build_sample_callable(
      config, params, fn="uncond_eps", batch_size=BATCH, device="cuda")
  _warm_sampler(config, params)
  build.reset_launches()
  t0 = time.perf_counter()
  images = sample(1)  # returns numpy: ends in a device-to-host copy
  sampler_s = time.perf_counter() - t0
  launches = dict(build.LAUNCHES)
  fwd_ms = sampler_s * 1e3 / (steps + 1)
  print(f"[{tag}] {what}: one {steps}-step sampler call {sampler_s:.3f} s "
        f"= {BATCH / sampler_s:.2f} img/s at batch {BATCH}, {fwd_ms:.2f} ms "
        f"a forward on {card}", flush=True)
  _check_images(images, BATCH)
  per_block = per_block or (BLOCK_SAMPLE_LAUNCHES_INT8 if quant else
                            BLOCK_SAMPLE_LAUNCHES)[attn_impl]
  want = _times(per_block, BLOCKS * (steps + 1))
  print(f"[{tag}] {what}: kernel launches in the call: {launches}, "
        f"model says {want} and no other kernel", flush=True)
  if launches != want:  # no K3, K2, K4, K7, K8
    fail(f"launch counts {launches} != {want}")
  out = {"launches": launches, "img_per_s": BATCH / sampler_s,
         "s": sampler_s, "steps": steps, "fwd_ms": fwd_ms}
  if windows:
    out["qual"] = qualified_calls(lambda: sample(2), BATCH, SAMPLER_RETRIES)
    out["img_per_s"] = out["qual"]["median"]
    print(f"[{tag}] {what}: sampler {qual_text(out['qual'])} at batch "
          f"{BATCH} on {card}", flush=True)
  return out


def phase_unpacked(build, attn, card, dtype=torch.bfloat16):
  """`fused_attention` on [B, L, H, D] in `dtype`, which no module of the
  model calls: forward and backward through autograd at the decoder's
  training shape, against the plain versions on the CPU."""
  gen = torch.Generator().manual_seed(8)
  b, seq, head_dim = TRAIN_BATCH // 2, TRAIN_SEQS[-1], WIDTH // HEADS
  q, k, v, do = (torch.randn(b, seq, HEADS, head_dim, generator=gen)
                 .to(dtype) for _ in range(4))
  results = {}
  for dev in ("cpu", "cuda"):
    args = [t.to(dev).clone().requires_grad_() for t in (q, k, v)]
    if dev == "cuda":
      build.reset_launches()
    out = attn.fused_attention(*args)
    out.backward(do.to(dev))
    if dev == "cuda":
      torch.cuda.synchronize()
      launches = dict(build.LAUNCHES)
    results[dev] = [out.detach().float().cpu()] + [a.grad.float().cpu()
                                                   for a in args]
  want = {_named(attn.UNPACKED_NAME, dtype): 1,
          _named(attn.UNPACKED_BWD_NAME, dtype): 1}
  worst = 0.0
  for c, g in zip(results["cpu"], results["cuda"]):
    # As in the kernels phase: a few bf16 ulps of the largest value (f32:
    # 1e-4 of it, the backward's bound).
    worst = max(worst, (c - g).abs().max().item() / c.abs().max().item())
  tol = 1e-4 if dtype == torch.float32 else 2.0**-6
  print(f"[unpacked] fused_attention ({b}, {seq}, {HEADS}, {head_dim}) "
        f"{str(dtype).replace('torch.', '')} forward and backward: worst "
        f"error {worst:.3e} of each tensor's max against the CPU (tolerance "
        f"{tol:g}); launches {launches} on {card}", flush=True)
  if launches != want:
    fail(f"fused_attention launches {launches} != {want}")
  if not worst <= tol:
    fail(f"fused_attention on the card differs from the CPU by {worst:.3e}")
  return launches


def phase_ablate(build, attn, card):
  """The ablation tool's `main` on the card: seven arms of K9 at two shapes,
  a warm-up and 20 timed launches each, and K3 beside them."""
  from small_vision_tpu_torch.tools import ablate_attention_kernel as tool

  build.reset_launches()
  results = tool.main([])
  launches = dict(build.LAUNCHES)
  per_timing = tool.N + 1
  want = {attn.ABLATE_NAME: len(attn.ABLATE_VARIANTS) * len(tool.SHAPES)
          * per_timing, attn.NAME: len(tool.SHAPES) * per_timing}
  print(f"[ablate] kernel launches of the tool: {launches}, expected {want} "
        f"on {card}", flush=True)
  if launches != want:
    fail(f"ablation tool launches {launches} != {want}")
  if not all(np.isfinite(t) and t > 0 for t in results.values()):
    fail(f"ablation tool times not positive and finite: {results}")
  return launches


def _wrap(module, name, make):
  """Replaces `module.name` by `make(original)`; returns the undo."""
  original = getattr(module, name)
  setattr(module, name, make(original))
  return lambda: setattr(module, name, original)


# Drawn weight trees kept between the phases that draw the same one, up to
# DRAWN_BYTES of host memory (the least recently used dropped first):
# numpy draws UMD-L/2's 611 M leaves in seconds, and phases draw one tree
# again and again (every training run's `init_train_params`, the
# classifier checks' depth-2 ViT-H/14 at 224 and at 518).
_DRAWN = collections.OrderedDict()
DRAWN_BYTES = 12e9


def _card_params(config, seed):
  """`convert.init_params`'s tree for the config's model (each leaf normal
  at convert's mean and std for its name, in the config's layout), drawn
  on the card by torch from `seed`: the weights of the paths that no CPU
  reference reads (the timed classifier forwards, the sampler calls of
  `phase_sample_call`, the latent sampler), where numpy takes seconds a
  tree."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.utils.trees import recover_tree

  shapes = convert._unrolled_shapes(config)
  names = sorted(shapes)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  values = []
  for name in names:
    std, mean = convert._std_and_mean(name, shapes[name])
    values.append(torch.randn(shapes[name], generator=gen, device="cuda")
                  * std + mean)
  return convert._in_config_layout(config, recover_tree(names, values))


def _tree_copy(tree):
  """The tree's dicts anew, its arrays shared."""
  return {k: _tree_copy(v) if isinstance(v, dict) else v
          for k, v in tree.items()}


def _tree_bytes(tree):
  return sum(_tree_bytes(v) if isinstance(v, dict) else v.nbytes
             for v in tree.values())


def _kept_draws(draw):
  """`draw` (`convert.init_params` or `init_train_params`) that keeps its
  trees. A tree is a function of the seed, the model's leaves and their
  shapes and the classifier head's `head_zeroinit`, drawn in the unrolled
  layout and then stacked where the config's model has `scan`; so the
  unrolled tree is kept, and a call with the same key gets its arrays in
  new dicts, in the config's layout (a phase may replace a leaf, as
  `_classifier_params` the posemb; none writes into an array)."""
  from small_vision_tpu_torch import convert

  def kept(config, seed):
    model = config.get("model", {})
    unrolled = dict(config, model={**model, "scan": False})
    key = (draw.__name__, int(seed), config.get("model_name", "ae"),
           model.get("head_zeroinit", True),
           tuple(sorted(convert._unrolled_shapes(unrolled).items())))
    if key not in _DRAWN:
      _DRAWN[key] = draw(unrolled, seed)
      while (len(_DRAWN) > 1 and sum(map(_tree_bytes, _DRAWN.values()))
             > DRAWN_BYTES):
        _DRAWN.popitem(last=False)
    _DRAWN.move_to_end(key)
    return convert._in_config_layout(config, _tree_copy(_DRAWN[key]))
  return kept


def keep_draws():
  """Installs `_kept_draws` over `convert.init_params` and
  `init_train_params` for the rest of this process."""
  from small_vision_tpu_torch import convert
  for name in ("init_params", "init_train_params"):
    _wrap(convert, name, _kept_draws)


def phase_data(build, card, synthetic):
  """The input pipeline on the card at full UMD-B/4@64 width; see the
  module's docstring. `synthetic`: phase train's "pallas" reading."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.data import arrays, core, pipeline
  from small_vision_tpu_torch.train import train_ae

  root = tempfile.mkdtemp(prefix="sv_data_")
  try:
    rng = np.random.default_rng(11)
    for split, n in (("train", DATA_TRAIN), ("validation", DATA_VAL)):
      arrays.write_arrays(
          os.path.join(root, split),
          rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
          rng.integers(0, 1000, (n,)))
    config = ae_i1k.get_config(
        f"variant=B/4,size=64,data=arrays:{root},batch_size={TRAIN_BATCH},"
        f"total_steps={TRAIN_STEPS},log_steps=1,eval_steps={TRAIN_STEPS},"
        "attn_impl=pallas")
    del config["evals"]["fewshot"]  # the probe has a phase of its own
    for ev in config["evals"].values():
      ev["num_batches"] = 2
    if config["input"]["num_workers"] != DATA_WORKERS:
      fail(f"the config's num_workers is {config['input']['num_workers']}")

    # What the loop fed its first step, and which splits the run opened.
    first_ids, opened = [], []

    def record_ids(make_update_fn):
      def make(*args, **kw):
        update_fn = make_update_fn(*args, **kw)

        def update(state, batch, *a, **k):
          if not first_ids:
            first_ids.append(batch["_id"].cpu().numpy())
          return update_fn(state, batch, *a, **k)
        return update
      return make

    def record_splits(init):
      def wrapped(self, **kw):
        init(self, **kw)
        opened.append((kw.get("split", "train"), self.root,
                       self.total_examples))
      return wrapped

    undo = [_wrap(train_ae, "make_update_fn", record_ids),
            _wrap(arrays.DataSource, "__init__", record_splits)]
    try:
      build.reset_launches()
      state, history = train_ae.train_and_evaluate(
          config, device="cuda",
          log=lambda s: print(f"[data] arrays: {s}", flush=True))
      launches = dict(build.LAUNCHES)
    finally:
      for u in undo:
        u()
    del state
    torch.cuda.empty_cache()

    losses = [h["training_loss"] for h in history]
    if len(history) != TRAIN_STEPS or not all(np.isfinite(losses)):
      fail(f"arrays run: {len(history)} steps, losses {losses}")
    if not losses[-1] < losses[0]:
      fail(f"arrays run: the training loss did not fall: {losses}")
    want = _times(BLOCK_TRAIN_LAUNCHES["pallas"], 2 * BLOCKS * TRAIN_STEPS)
    for k, v in _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * 4).items():
      want[k] += v  # val and mae_val, 2 batches each, one forward a batch
    if launches != want:
      fail(f"arrays run launches {launches} != {want}")
    order = [int(ex["_id"]) for ex in core.get(f"arrays:{root}").examples(
        seed=int(config["input"].get("seed", 0)), epoch=0)]
    if not first_ids or first_ids[0].tolist() != order[:TRAIN_BATCH]:
      fail("the first step's _ids are not the arrays source's (seed, "
           "epoch 0) permutation")
    val_dir = os.path.join(root, "validation")
    splits = sorted((s, os.path.basename(r), n) for s, r, n in opened)
    if splits != [("train", "train", DATA_TRAIN)] + [
        ("validation", "validation", DATA_VAL)] * len(config["evals"]):
      fail(f"the run opened {splits}; want train/ once and {val_dir} once "
           "an evaluator")
    timed = history[1:]
    ms = sum(h["ms"] for h in timed) / len(timed)
    data_ms = sum(h["data_ms"] for h in timed) / len(timed)
    img_per_s = TRAIN_BATCH / (ms + data_ms) * 1e3
    print(f"[data] arrays-fed UMD-B/4@64 at batch {TRAIN_BATCH}: "
          f"{len(timed)} timed steps, mean {ms:.2f} ms a step + "
          f"{data_ms:.3f} ms waiting for its batch = {img_per_s:.2f} img/s; "
          f"synthetic-fed (phase train, this call) {synthetic['ms']:.2f} + "
          f"{synthetic['data_ms']:.3f} ms = {synthetic['img_per_s']:.2f} "
          f"img/s; launches {launches}; first step's _ids the (seed, epoch "
          f"0) permutation; evaluators on {val_dir} on {card}", flush=True)

    # The host pipeline alone: one epoch through TrainIterator.
    nproc = len(os.sched_getaffinity(0))
    it = pipeline.TrainIterator(core.get(f"arrays:{root}"),
                                config["input"]["pp"], TRAIN_BATCH,
                                device="cuda", num_workers=DATA_WORKERS,
                                prefetch=config["input"]["prefetch_to_device"])
    batches = iter(it)
    next(batches)
    torch.cuda.synchronize()
    n = 2 * DATA_TRAIN // TRAIN_BATCH  # two epochs
    t0 = time.perf_counter()
    for _ in range(n):
      batch = next(batches)
    torch.cuda.synchronize()
    host_img_per_s = n * TRAIN_BATCH / (time.perf_counter() - t0)
    batches.close()
    if batch["image"].shape != (TRAIN_BATCH, 64, 64, 3) or not \
        batch["image"].is_cuda:
      fail(f"TrainIterator gave {batch['image'].shape} on "
           f"{batch['image'].device}")
    print(f"[data] TrainIterator alone over arrays/train at batch "
          f"{TRAIN_BATCH}, {DATA_WORKERS} workers, onto the card: "
          f"{host_img_per_s:.2f} img/s ({n} batches); nproc {nproc} on "
          f"{card}", flush=True)
    return {"launches": launches, "img_per_s": img_per_s, "ms": ms,
            "data_ms": data_ms, "host_img_per_s": host_img_per_s,
            "jpeg": _jpeg_reading(card), "nproc": nproc}
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _jpeg_reading(card):
  """`decode_jpeg_and_inception_crop(size=64)` over 256 seeded 500x375
  JPEGs on the host stage with 16 workers: img/s and the decoder that ran;
  None where PIL, which writes the JPEGs, is not installed."""
  import importlib.util
  if importlib.util.find_spec("PIL") is None:
    print("[data] JPEG reading not taken: PIL is not installed on this "
          "machine, and it is what writes the JPEGs (and decodes them where "
          "the native decoder is unavailable)", flush=True)
    return None
  from PIL import Image
  from small_vision_tpu_torch.data import native_jpeg, pipeline
  from small_vision_tpu_torch.pp import builder

  rng = np.random.default_rng(12)
  h, w = JPEG_HW
  base = rng.integers(0, 256, (JPEGS, h // 25, w // 25, 3), dtype=np.uint8)
  raws = []
  for i in range(JPEGS):
    img = Image.fromarray(base[i]).resize((w, h), Image.BILINEAR)
    noise = rng.integers(0, 32, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img) // 2 + noise).save(buf, format="JPEG",
                                                       quality=90)
    raws.append(buf.getvalue())
  host_fn, _ = builder.get_preprocess_fn(
      'decode_jpeg_and_inception_crop(size=64)|keep("image")')
  decoder = native_jpeg.status()

  def run():
    host = pipeline._HostPipeline(
        lambda: ({"image": r, "_id": np.int64(i)} for i, r in
                 enumerate(raws)),
        host_fn, TRAIN_BATCH, num_workers=DATA_WORKERS,
        drop_remainder=False)
    return [b["image"] for b in host]

  run()  # builds the native decoder where it can
  reps, t0 = 3, time.perf_counter()
  for _ in range(reps):
    out = np.concatenate(run())
  img_per_s = reps * JPEGS / (time.perf_counter() - t0)
  if out.shape != (JPEGS, 64, 64, 3) or out.dtype != np.uint8 or \
      not out.any():
    fail(f"JPEG reading gave {out.shape} {out.dtype}")
  print(f"[data] decode_jpeg_and_inception_crop(size=64) of {JPEGS} "
        f"{w}x{h} JPEGs (quality 90) on the host stage, "
        f"{DATA_WORKERS} workers: {img_per_s:.2f} img/s, decoder {decoder}, "
        f"{reps} passes; nproc {len(os.sched_getaffinity(0))} on {card}",
        flush=True)
  return {"img_per_s": img_per_s, "decoder": decoder}


def _stop_after_checkpoint(step):
  """A `log` callback that ends a run when step `step + 1` reports, as a
  crash would, once the checkpoint of step `step` has landed."""
  from small_vision_tpu_torch.utils import checkpoint as ckpt_lib

  class Stopped(Exception):
    pass

  def log(line):
    if line.startswith(f"step {step + 1}/"):
      for t in threading.enumerate():
        if t.name == ckpt_lib.WRITER_THREAD:
          t.join()
      raise Stopped
  return log, Stopped


def phase_resume(build, card, no_ckpt_img_per_s, keep_dir):
  """Checkpoint, evaluators and resume at full width; see the module's
  docstring. Run B's step-6 checkpoint moves to `keep_dir`/checkpoints,
  the pretrain workdir of phase probe."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae
  from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
  from small_vision_tpu_torch.utils.chrono import Chrono

  steps, every = TRAIN_STEPS, 3

  def make_config():
    config = ae_i1k.get_config(
        f"variant=B/4,size=64,data=synthetic,batch_size={TRAIN_BATCH},"
        f"total_steps={steps},log_steps=1,ckpt_steps={every},"
        f"eval_steps={steps}")
    del config["evals"]["fewshot"]  # the probe has a phase of its own
    for ev in config["evals"].values():
      ev["num_batches"] = 2
    # An EMA, so that the run's workdir serves as phases eval_only and
    # export read it (`export_sampler.load_params` takes `ema_params`).
    config["ema_decay"] = 1e-4
    return config

  root = tempfile.mkdtemp(prefix="sv_resume_")
  try:
    dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
    # A save that never completed: a directory that was not renamed.
    planted = os.path.join(dir_a, "checkpoints", "2.tmp")
    os.makedirs(planted)
    with open(os.path.join(planted, "params.npz"), "wb") as f:
      f.write(b"half-written")

    say = lambda tag: lambda s: print(f"[resume] {tag}: {s}", flush=True)
    build.reset_launches()
    state_a, hist_a = train_ae.train_and_evaluate(make_config(), dir_a,
                                                  device="cuda", log=say("A"))
    launches = dict(build.LAUNCHES)
    # 6 training steps, and 2 evaluators x 2 batches of one forward without
    # gradients each.
    want = _times(BLOCK_TRAIN_LAUNCHES["pallas"], 2 * BLOCKS * steps)
    for k, v in _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * 4).items():
      want[k] += v
    if launches != want:
      fail(f"run A launches {launches} != {want}")
    left = sorted(os.listdir(os.path.join(dir_a, "checkpoints")))
    if left != [str(steps)]:
      fail(f"run A left checkpoints {left}, not the newest alone: the planted "
           "directory was not removed, or the rolling one was kept")
    # 1.7 GB each: keep the temporary directory small.
    shutil.rmtree(os.path.join(dir_a, "checkpoints"))

    stop_log, stopped = _stop_after_checkpoint(every)
    try:
      train_ae.train_and_evaluate(make_config(), dir_b, device="cuda",
                                  log=stop_log)
      fail("run B did not stop")
    except stopped:
      pass
    torch.cuda.empty_cache()
    notes = []

    def log_b(line):
      notes.append(line)
      say("B")(line)
    state_b, hist_b = train_ae.train_and_evaluate(make_config(), dir_b,
                                                  device="cuda", log=log_b)
    if not any(f"Resumed from step {every}" in n for n in notes):
      fail(f"run B did not resume from step {every}: {notes[:4]}")
    if [h["step"] for h in hist_b] != list(range(every + 1, steps + 1)):
      fail(f"run B ran steps {[h['step'] for h in hist_b]}")
    shutil.move(os.path.join(dir_b, "checkpoints"),
                os.path.join(keep_dir, "checkpoints"))
    shutil.rmtree(dir_b)
    for what, a, b in (("params", state_a["params"], state_b["params"]),
                       ("mu", state_a["opt"]["mu"], state_b["opt"]["mu"]),
                       ("nu", state_a["opt"]["nu"], state_b["opt"]["nu"]),
                       ("ema", state_a["ema_params"],
                        state_b["ema_params"])):
      differing = sum(not torch.equal(x, y) for x, y in zip(a, b))
      if differing:
        fail(f"resume: {differing} of {len(a)} {what} tensors differ between "
             "the straight and the resumed run")
    print(f"[resume] step-{steps} parameters, mu, nu and EMA of the resumed run "
          f"equal the straight run's bit for bit ({len(state_a['params'])} "
          "tensors each)", flush=True)

    rows = [json.loads(l) for l in
            open(os.path.join(dir_a, "sv_tpu_metrics.txt"))]
    merged = {}
    for r in rows:
      merged.update(r)
    for key in ("training_loss", "z/img_per_sec", "val/loss",
                "mae_val/masked_mse"):
      values = [r[key] for r in rows if key in r]
      if not values or not all(np.isfinite(values)):
        fail(f"metrics file: {key} missing or not finite ({values})")
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
      fail(f"metrics file rows {[r['step'] for r in rows]}")
    print(f"[resume] metrics at step {steps}: training_loss "
          f"{merged['training_loss']:.6f}, val/loss {merged['val/loss']:.6f}, "
          f"mae_val/masked_mse {merged['mae_val/masked_mse']:.6f}, "
          f"z/img_per_sec {merged['z/img_per_sec']:.2f}", flush=True)

    # One save, timed: the loop's part and the writer's.
    config = make_config()
    names = [n for n, _ in train_ae.named_params(
        train_ae.build_model(config, device="meta"))]
    ckpt = train_ae.checkpoint_state(state_a, names, Chrono(device="cuda"))
    n_bytes = sum(t.numel() * t.element_size() for entry in ckpt.values()
                  for t in entry.values() if isinstance(t, torch.Tensor))
    mngr = ckpt_lib.make_manager(os.path.join(root, "timing"))
    timing = []
    for i in (1, 2):  # the first save also pins its host buffers
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      ckpt_lib.save(mngr, ckpt, i)
      torch.cuda.synchronize()
      copied_s = time.perf_counter() - t0
      ckpt_lib.wait_until_finished(mngr)
      timing.append(dict(blocking_s=mngr.last_blocking_s, copied_s=copied_s,
                         write_s=mngr.last_write_s))
      print(f"[resume] save {i} of {n_bytes / 1e9:.3f} GB: the loop blocked "
            f"{mngr.last_blocking_s * 1e3:.1f} ms, the host copies done "
            f"after {copied_s * 1e3:.1f} ms, the background write "
            f"{mngr.last_write_s:.3f} s on {card}", flush=True)
    timed = hist_a[1:]
    ms = sum(h["ms"] for h in timed) / len(timed)
    print(f"[resume] run A, a checkpoint every {every} steps: "
          f"{TRAIN_BATCH / ms * 1e3:.2f} img/s by the steps' own clock "
          f"(the step after a save, {hist_a[every]['ms']:.2f} ms, waits for "
          f"its copies), {merged['z/img_per_sec']:.2f} by Chrono at step "
          f"{steps}; without checkpoints (phase train) "
          f"{no_ckpt_img_per_s:.2f} img/s on {card}", flush=True)
    return {"launches": launches, "save": timing,
            "img_per_s": TRAIN_BATCH / ms * 1e3}
  finally:
    shutil.rmtree(root, ignore_errors=True)


def phase_serve(build, card):
  """The main path: HTTP server, three requests, one 125-step call."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.tools import export_sampler, serve
  from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

  config = ae_i1k.get_config(f"variant=B/4,size=64,samples_per_call={BATCH}")
  t0 = time.perf_counter()
  params = convert.init_params(config, seed=0)
  sample = export_sampler.build_sample_callable(
      config, params, fn="uncond_eps", batch_size=BATCH, device="cuda")
  n_params = sum(a.size for _, a in tree_flatten_with_names(params))
  print(f"[serve] UMD-B/4@64, {n_params} parameters from seed 0, loaded in "
        f"{time.perf_counter() - t0:.2f} s", flush=True)
  t0 = time.perf_counter()
  sample(12345)  # warm-up call: cuBLAS handles, allocator, kernel loads
  print(f"[serve] warm-up sampler call {time.perf_counter() - t0:.2f} s",
        flush=True)

  server = serve.SamplerServer(sample, BATCH, max_wait_ms=2000.0)
  httpd = serve.make_http_server(server, 0, host="127.0.0.1")
  http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  http_thread.start()
  url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
  sizes = (16, 16, 32)
  results, errors = [None] * len(sizes), []

  def request(i):
    try:
      body = json.dumps({"n": sizes[i]}).encode()
      req = urllib.request.Request(url, data=body, method="POST")
      with urllib.request.urlopen(req, timeout=600) as resp:
        results[i] = np.load(io.BytesIO(resp.read()))["images"]
    except Exception as e:  # noqa: BLE001 -- reported as the phase's failure
      errors.append(f"request {i}: {e!r}")

  try:
    build.reset_launches()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=request, args=(i,))
               for i in range(len(sizes))]
    for c in clients:
      c.start()
    for c in clients:
      c.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    stats = server.stats_snapshot()
  finally:
    httpd.shutdown()
    httpd.server_close()
    server.close(drain=False)

  if errors or any(c.is_alive() for c in clients):
    fail(f"requests did not complete: {errors}")
  sampler_s = stats["sampler_ms_last"] / 1e3
  print(f"[serve] pallas: {len(sizes)} requests {sizes} in {stats['batches']} "
        f"sampler call(s): {wall:.3f} s wall, sampler call {sampler_s:.3f} s "
        f"= {BATCH / sampler_s:.2f} img/s at batch {BATCH} on {card}",
        flush=True)
  if stats["batches"] != 1:
    fail(f"requests coalesced into {stats['batches']} calls, not 1")
  for n, images in zip(sizes, results):
    _check_images(images, n)
  want = _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * SAMPLER_FORWARDS)
  print(f"[serve] pallas: kernel launches in the call: {launches}, model "
        f"says {want} and no other kernel", flush=True)
  if launches != want:  # no backward and no fused kernel
    fail(f"launch counts {launches} != {want}")
  qual = qualified_calls(lambda: sample(2), BATCH, SAMPLER_RETRIES)
  print(f"[serve] pallas: sampler {qual_text(qual)} at batch {BATCH} "
        f"(single calls of the server's sampler) on {card}", flush=True)
  return {"launches": launches, "img_per_s": qual["median"],
          "s": sampler_s, "qual": qual}


# Phase quant: the MLP's two products at the training step's decoder rows
# (per-branch batch 128 x L 257), and the settings it drives.
QUANT_TRAIN, QUANT_SAMPLE = "int8_mlp", "int8_all"
INT8_SHAPES = ((TRAIN_BATCH // 2 * SEQ_DEC, WIDTH, MLP_DIM),
               (TRAIN_BATCH // 2 * SEQ_DEC, MLP_DIM, WIDTH))


def _bf16_ulp(t):
  """One bf16 ulp at each element's magnitude (0 where it is 0)."""
  t = t.float()
  _, e = torch.frexp(t)
  return torch.where(t != 0, torch.ldexp(torch.ones_like(t), e - 8),
                     torch.zeros_like(t))


# Every INT8_ROW_STEP-th row of the int32 accumulator and the output is
# held against the CPU's exact int64 product (all columns, the full
# contraction): all 32,896 rows take 34 s of the host, more than the
# script's time limit leaves.
INT8_ROW_STEP = 8


def check_int8_dot(card):
  """`int8_dot` on the card at the MLP's shapes against the plain integer
  version on the CPU, on the same operands (the accumulator and the
  output at every INT8_ROW_STEP-th row); timed beside bf16 F.linear."""
  from small_vision_tpu_torch.ops import quant

  gen = torch.Generator(device="cuda").manual_seed(13)
  readings = []
  for m, k, n in INT8_SHAPES:
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(
        torch.bfloat16)
    ops = quant.quantized_operands(x, w)
    plain_ops = quant.quantized_operands(x.cpu(), w.cpu())
    for name, got, want in zip(("xq", "sx", "wq", "sw"), ops, plain_ops):
      if not torch.equal(got.cpu(), want):
        fail(f"int8 ({m}, {k}) @ ({k}, {n}): {name} on the card differs "
             "from the CPU's")
    acc = quant.int_matmul(ops[0], ops[2])
    rows = slice(None, None, INT8_ROW_STEP)
    t0 = time.perf_counter()
    acc_plain = quant.int_matmul(plain_ops[0][rows], plain_ops[2])
    plain_s = time.perf_counter() - t0
    if not torch.equal(acc.cpu()[rows], acc_plain):
      fail(f"int8 ({m}, {k}) @ ({k}, {n}): the int32 accumulator differs "
           "from the plain integer version")
    y = quant.int8_dot(x, w).float().cpu()[rows]
    y_plain = ((acc_plain.float() * plain_ops[1][rows]) * plain_ops[3]).to(
        torch.bfloat16)
    over = ((y - y_plain.float()).abs() > _bf16_ulp(y_plain)).sum().item()
    if over:
      fail(f"int8 ({m}, {k}) @ ({k}, {n}): {over} outputs more than one "
           "bf16 ulp from the plain version")
    wt = w.t().contiguous()  # nn.Linear's (out, in) weight
    xq, wq = ops[0], ops[2]
    wq_rows = wq.contiguous()  # the other layout of B, for comparison
    reading = dict(
        shape=(m, k, n), int8_dot_ms=time_ms(lambda: quant.int8_dot(x, w)),
        int_mm_ms=time_ms(lambda: torch._int_mm(xq, wq)),
        int_mm_row_major_ms=time_ms(lambda: torch._int_mm(xq, wq_rows)),
        linear_ms=time_ms(lambda: torch.nn.functional.linear(x, wt)),
        plain_s=plain_s, acc_max=int(acc.abs().max()))
    ops_count = 2.0 * m * k * n
    print(f"[quant] int8_dot ({m}, {k}) @ ({k}, {n}) bf16: int32 "
          f"accumulator bit-equal to the CPU's int64 product at every "
          f"{INT8_ROW_STEP}th row ({plain_s:.1f} s there; |acc| up to "
          f"{reading['acc_max']}), output within one "
          f"bf16 ulp; int8_dot {reading['int8_dot_ms']:.4f} ms (quantize + "
          f"_int_mm + rescale), _int_mm alone {reading['int_mm_ms']:.4f} ms "
          f"= {ops_count / reading['int_mm_ms'] / 1e9:.1f} TOPS (B "
          f"row-major instead: {reading['int_mm_row_major_ms']:.4f} ms), bf16 "
          f"F.linear {reading['linear_ms']:.4f} ms = "
          f"{ops_count / reading['linear_ms'] / 1e9:.1f} TFLOP/s on {card}",
          flush=True)
    readings.append(reading)
  return readings


def phase_quant(build, card, train, serve):
  """The int8 matmul, and UMD-B/4@64 trained (`int8_mlp`) and sampled
  (`int8_all`) under both settings; `train` and `serve` are the bf16
  readings of this call."""
  matmuls = check_int8_dot(card)
  out = {"matmuls": matmuls, "train": {}, "serve": {}}
  for a in ATTN_IMPLS:
    q = phase_train(build, card, a, quant=QUANT_TRAIN, tag="quant")
    print(f"[quant] {a}: training {QUANT_TRAIN} {q['img_per_s']:.2f} img/s "
          f"({q['ms']:.2f} ms a step) against bf16 "
          f"{train[a]['img_per_s']:.2f} img/s ({train[a]['ms']:.2f} ms, "
          f"phase train) = {q['img_per_s'] / train[a]['img_per_s']:.3f}x on "
          f"{card}", flush=True)
    out["train"][a] = q
  for a in ATTN_IMPLS:
    q = phase_sample_call(build, card, a, quant=QUANT_SAMPLE, tag="quant",
                          steps=SIDE_SAMPLER_STEPS)
    print(f"[quant] {a}: sampler {QUANT_SAMPLE} {q['fwd_ms']:.2f} ms a "
          f"forward ({q['steps']}-step call {q['s']:.3f} s) against bf16 "
          f"{_fwd_ms(serve[a]):.2f} ms ({serve[a]['s']:.3f} s a 125-step "
          f"call, phase serve) = {_fwd_ms(serve[a]) / q['fwd_ms']:.3f}x on "
          f"{card}", flush=True)
    out["serve"][a] = q
  return out


# Phase evals: an arrays dataset of colour-coded classes, 205 training
# examples a class (100 shots need 100), and a validation split of more
# than 2,048 images (pool3's dimension: its covariance can be full rank).
EVAL_CLASSES, EVAL_PER_CLASS, EVAL_VAL = 10, 205, 2560
FEWSHOT_SHOTS = (5, 100)  # 50 rows < D = 769: the kernel form; 1,000: XᵀX
FID_BATCH, FID_SAMPLES = 256, 64
# The FID of a set against its own statistics is 0 in exact arithmetic;
# the two computations share their batches, so their moments are equal and
# what remains is sqrtm's error on sigma², whose smallest eigenvalues are
# the squares of sigma's (a CPU rehearsal at 300 images: 2.9e-5 of the
# trace).
SELF_FID_BOUND = 1e-3  # of tr(sigma)
# Seeded InceptionV3, card against CPU, relative to the output's largest
# magnitude: f32 on both (TF32 off) in other summation orders through 94
# convolutions (PR 12's dev call read 4.2e-7).
INCEPTION_TOL = 1e-5


def _eval_arrays(root):
  from small_vision_tpu_torch.data import arrays
  rng = np.random.default_rng(21)
  colours = rng.integers(40, 216, (EVAL_CLASSES, 3))

  def images(labels):
    noise = rng.integers(-40, 41, (len(labels), 64, 64, 3))
    return np.clip(colours[labels][:, None, None, :] + noise, 0,
                   255).astype(np.uint8)
  train = np.repeat(np.arange(EVAL_CLASSES), EVAL_PER_CLASS)
  rng.shuffle(train)
  val = rng.integers(0, EVAL_CLASSES, EVAL_VAL)
  for split, labels in (("train", train), ("validation", val)):
    arrays.write_arrays(os.path.join(root, split), images(labels), labels)


def phase_evals(build, card, keep_ref=None):
  """The few-shot probe, classification, InceptionV3 and FID/IS on the card
  at UMD-B/4@64; see the module's docstring. The reference statistics are
  copied to `keep_ref` (phase eval_only scores against them)."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.data import core, pipeline
  from small_vision_tpu_torch.evaluators import common as eval_common
  from small_vision_tpu_torch.evaluators import fid, inception
  from small_vision_tpu_torch.train import train_ae
  from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

  root = tempfile.mkdtemp(prefix="sv_evals_")
  try:
    _eval_arrays(root)
    config = ae_i1k.get_config(f"variant=B/4,size=64,data=arrays:{root},"
                               f"batch_size={TRAIN_BATCH}")
    # One seed of the config's three: each seed reruns the same forwards.
    probe_cfg = dict(config["evals"]["fewshot"], shots=FEWSHOT_SHOTS,
                     num_seeds=1)
    params = convert.init_params(config, seed=0)
    model = train_ae.build_model(config, device="cuda", trainable=True)
    model.load_state_dict(convert.params_from_jax(params, model))
    names = [n for n, _ in train_ae.named_params(model)]
    opt = train_ae.make_optimizer(config, names, 10, 1)
    state = train_ae.init_train_state(model, opt, config, device="cuda")
    eval_fns = train_ae.make_eval_fns(model, config)

    # The few-shot probe, as the config builds it.
    (_, probe, _, prefix), = eval_common.from_config(
        dict(config, evals={"fewshot": probe_cfg}), eval_fns, "cuda")
    build.reset_launches()
    t0 = time.perf_counter()
    accs = dict(probe.run(state))
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = {"fewshot": dict(build.LAUNCHES)}
    seeds = probe_cfg["num_seeds"]
    batches = seeds * (-(-EVAL_CLASSES * EVAL_PER_CLASS // TRAIN_BATCH)
                       + -(-EVAL_VAL // TRAIN_BATCH))
    want = _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * batches)
    print(f"[evals] fewshot_lsr ({seeds} seeds, shots {FEWSHOT_SHOTS}, "
          f"{EVAL_CLASSES} classes, {EVAL_CLASSES * EVAL_PER_CLASS} training "
          f"and {EVAL_VAL} test images, batch {TRAIN_BATCH}): "
          + ", ".join(f"{prefix}{k} {v:.4f}" for k, v in accs.items())
          + f"; {probe_s:.2f} s; launches {launches['fewshot']}, model says "
          f"{want} on {card}", flush=True)
    if launches["fewshot"] != want:
      fail(f"few-shot launches {launches['fewshot']} != {want}")
    if len(accs) != seeds * len(FEWSHOT_SHOTS) or not all(
        0.0 <= v <= 1.0 for v in accs.values()):
      fail(f"few-shot accuracies {accs}")
    best = max(v for k, v in accs.items() if "_100shot" in k)
    if not best > 2.0 / EVAL_CLASSES:
      fail(f"the 100-shot probe is at chance ({best}) on colour-coded "
           "classes")

    # Classification on the same source: the nearest class centre of the
    # training features, as a linear head on pre_logits.
    x_tr, y_tr = probe.get_repr(state, probe._get_dataset(
        *probe_cfg["datasets"]["imagenet"])[0])
    centres = torch.stack([x_tr[y_tr == c].mean(0)
                           for c in range(EVAL_CLASSES)])
    bias = -0.5 * (centres ** 2).sum(dim=1)

    def centroid_logits(train_state, batch):
      _, out = eval_fns["predict"](train_state, batch)
      return out["pre_logits"].float() @ centres.T + bias, out
    cls_cfg = dict(type="classification", pred="centroids",
                   data=dict(name=f"arrays:{root}", split="validation"),
                   pp_fn=config["evals"]["val"]["pp_fn"], log_steps=10_000)
    (_, cls, _, _), = eval_common.from_config(
        dict(config, evals={"cls": cls_cfg}),
        dict(eval_fns, centroids=centroid_logits), "cuda")
    build.reset_launches()
    t0 = time.perf_counter()
    cls_out = dict(cls.run(state))
    cls_s = time.perf_counter() - t0
    launches["classification"] = dict(build.LAUNCHES)
    print(f"[evals] classification on validation/ ({EVAL_VAL} images), "
          f"nearest training centre on pre_logits: prec@1 "
          f"{cls_out['prec@1']:.4f}, loss {cls_out['loss']:.4f}; "
          f"{cls_s:.2f} s on {card}", flush=True)
    if not (0.0 <= cls_out["prec@1"] <= 1.0 and np.isfinite(cls_out["loss"])):
      fail(f"classification gave {cls_out}")
    del model, opt, state, eval_fns, probe, cls, x_tr, centres
    torch.cuda.empty_cache()

    # Seeded InceptionV3: the card against the CPU.
    val_src = core.get(f"arrays:{root}", split="validation")
    iterate, _, _ = pipeline.make_for_inference(val_src, "", FID_BATCH)

    def val_chunks():
      for b in iterate():
        yield b["image"][b["_mask"] > 0]
    val_images = np.concatenate(list(val_chunks()))
    x = torch.from_numpy(val_images[:4])
    outs = {}
    for dev in ("cpu", "cuda"):
      net = inception.init_params(device=dev, seed=0)
      with fid._full_f32(), torch.inference_mode():
        outs[dev] = [t.cpu() for t in net(fid._resize_299(x.to(dev)))]
    errs = [(g - c).abs().max().item() / c.abs().max().item()
            for g, c in zip(outs["cuda"], outs["cpu"])]
    print(f"[evals] seeded InceptionV3, 4 images at 299: card against CPU, "
          f"pool3 {errs[0]:.3e}, logits {errs[1]:.3e} of their max (bound "
          f"{INCEPTION_TOL:g}) on {card}", flush=True)
    if not max(errs) <= INCEPTION_TOL:
      fail(f"InceptionV3 on the card differs from the CPU by {errs}")

    # Reference statistics of the validation split, and the split against
    # them.
    ref_path = os.path.join(root, "fid_ref.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, sigma = fid.compute_reference_stats(val_chunks(), ref_path,
                                            batch_size=FID_BATCH)
    ref_s = time.perf_counter() - t0
    with np.load(ref_path) as d:
      if d["mu"].shape != (2048,) or d["sigma"].shape != (2048, 2048) or \
          not (np.isfinite(d["mu"]).all() and np.isfinite(d["sigma"]).all()):
        fail(f"reference statistics {d['mu'].shape} {d['sigma'].shape}")
    t0 = time.perf_counter()
    self_fid, self_is = fid.create_fid_score_fn(FID_BATCH, ref_path)(
        val_images)
    self_s = time.perf_counter() - t0
    trace = float(np.trace(sigma))
    print(f"[evals] compute_reference_stats over validation/ ({EVAL_VAL} "
          f"images, batch {FID_BATCH}): {ref_s:.2f} s, tr(sigma) "
          f"{trace:.4f}; the split against its own statistics: FID "
          f"{self_fid:.6g} (bound {SELF_FID_BOUND:g} x tr(sigma) = "
          f"{SELF_FID_BOUND * trace:.4f}), IS {self_is:.4f}, {self_s:.2f} s "
          f"on {card}", flush=True)
    if not abs(self_fid) <= SELF_FID_BOUND * trace:
      fail(f"the FID of the reference images against their own statistics "
           f"is {self_fid}")
    if keep_ref:
      shutil.copy(ref_path, keep_ref)

    # A sampling evaluator scored through the trainer's handle_eval_results.
    scfg = ae_i1k.get_config(
        f"variant=B/4,size=64,data=arrays:{root},use_labels=True,"
        f"batch_size={TRAIN_BATCH},total_steps=1,samples_per_call={BATCH},"
        f"total_samples={FID_SAMPLES},fid_stats={ref_path},"
        f"fid_batch={FID_BATCH}")
    scfg["evals"] = {"sample_cond": scfg["evals"]["sample_cond"]}
    scfg["force_eval"] = True
    scfg["model_init"] = os.path.join(root, "init.npz")
    np.savez(scfg["model_init"], **dict(tree_flatten_with_names(
        convert.init_params(scfg, seed=0))))
    workdir = os.path.join(root, "run")
    build.reset_launches()
    t0 = time.perf_counter()
    train_ae.train_and_evaluate(
        scfg, workdir, device="cuda",
        log=lambda s: print(f"[evals] sampling: {s}", flush=True))
    sample_s = time.perf_counter() - t0
    launches["sampling"] = dict(build.LAUNCHES)
    calls = FID_SAMPLES // BATCH
    want = _times(BLOCK_SAMPLE_LAUNCHES["pallas"],
                  BLOCKS * SAMPLER_FORWARDS * calls)
    rows = [json.loads(l) for l in
            open(os.path.join(workdir, "sv_tpu_metrics.txt"))]
    merged = {k: v for r in rows for k, v in r.items()}
    fid_key = "sample_cond/fid_samples_fid_score"
    is_key = "sample_cond/fid_samples_inception_score"
    if fid_key not in merged or is_key not in merged:
      fail(f"handle_eval_results logged no FID/IS: {sorted(merged)}")
    fid_score, is_score = merged[fid_key], merged[is_key]
    print(f"[evals] diffusion_sampling ({FID_SAMPLES} samples in {calls} "
          f"calls of {BATCH}) through handle_eval_results: {fid_key} "
          f"{fid_score:.4f}, {is_key} {is_score:.4f}; {sample_s:.2f} s with "
          f"the model's set-up; launches {launches['sampling']}, model says "
          f"{want} on {card}", flush=True)
    if not (np.isfinite(fid_score) and fid_score >= 0.0):
      fail(f"FID {fid_score}")
    if not 1.0 <= is_score <= 1008.0:
      fail(f"IS {is_score}")
    if launches["sampling"] != want:
      fail(f"sampling launches {launches['sampling']} != {want}")
    if not os.path.exists(os.path.join(workdir, "sample_cond_samples",
                                       "samples_0.npz")):
      fail("the samples were not saved")
    return {"launches": launches, "fewshot": accs, "fewshot_s": probe_s,
            "classification": cls_out, "classification_s": cls_s,
            "ref_s": ref_s, "self_fid": self_fid, "fid": fid_score,
            "is": is_score}
  finally:
    shutil.rmtree(root, ignore_errors=True)


# UMD-L/2@256, the latent path (phase latent) and the linear probe (phase
# probe); the width-1,024 rows of phase kernels.
L2_WIDTH, L2_HEADS = 1024, 16
L2_BLOCKS = 24 + 8            # encoder + decoder blocks of UMD-L/2
# Per card. Reckoned before the first run: 611 M parameters at 14 bytes
# each (f32 weights and gradients, Adam's bf16 mu and f32 nu) are 8.6 GB;
# the activations kept for the backward, ~40 bytes a token and block at
# width 1,024 over 1,844 (MAE branch) + 2,996 (diffusion branch) tokens x
# blocks an image, ~0.2 GB an image: 256 images need ~60 GB, 512 do not
# fit in 80 GB. The config's global 1,024 is a multi-card batch.
LATENT_BATCH = 256
# Its token counts are UMD-B/4@64's, TRAIN_SEQS: 32x32 latents at patch 2
# give 256 patches, as 64 px images at patch 4 do.
LATENT_STEPS = 6              # 1 warm-up + 5 timed
LATENT_FUSED_STEPS = 4        # under "pallas_fused": 1 warm-up + 3 timed
LATENT_SIZE = 256
# The SD VAE (channels 128-512) in f32 on the card (cuDNN, TF32 off)
# against the CPU, relative to each output's largest magnitude: two orders
# of summation through 30 convolutions (CPU tests at width 32: ~1e-6).
VAE_TOL = 1e-4
PROBE_STEPS, PROBE_CKPT = 6, 3


def _cuda_timer():
  """(wrap, times): `wrap(fn)` is `fn` with each call timed by CUDA events
  into `times` (ms, read once the device is synchronised)."""
  events = []

  def wrap(fn):
    def timed(*a, **kw):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      out = fn(*a, **kw)
      end.record()
      events.append((start, end))
      return out
    return timed

  def times():
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]
  return wrap, times


def _vae_flops(model, image_size):
  """Multiply-adds x 2 of the convolutions and the mid attentions of the
  encoder and the decoder for one image, from their shapes."""
  counts = {"encoder": 0, "decoder": 0}

  def hook(part):
    def count(mod, inputs, out):
      if isinstance(mod, torch.nn.Conv2d):
        k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels
        counts[part] += 2 * out.numel() * k
      elif isinstance(mod, torch.nn.Linear):
        counts[part] += 2 * out.numel() * mod.in_features
      else:  # AttnBlock: the two (hw x hw x c) products
        _, c, h, w = inputs[0].shape
        counts[part] += 2 * 2 * (h * w) ** 2 * c
    return count
  handles = []
  for part in counts:
    for mod in getattr(model, part).modules():
      if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)) or \
          type(mod).__name__ == "AttnBlock":
        handles.append(mod.register_forward_hook(hook(part)))
  with torch.no_grad():
    z = model.encoder(torch.zeros(1, 3, image_size, image_size,
                                  device="meta"))
    model.decoder(z[:, :4])
  for h in handles:
    h.remove()
  return counts


def _hold_vae(card):
  """The SD-width VAE on two seeded 256x256 images: encode_moments and
  decode on the card against the CPU (f32, TF32 off)."""
  from small_vision_tpu_torch.models import vae as vae_lib

  rng = np.random.default_rng(31)
  images = rng.uniform(-1, 1, (2, LATENT_SIZE, LATENT_SIZE, 3)).astype(
      np.float32)
  z = (rng.standard_normal((2, 32, 32, 4)) * 0.8).astype(np.float32)
  with torch.device("meta"):
    model = vae_lib.AutoencoderKL()
  model = vae_lib.init_vae_params(
      model.to_empty(device="cpu").requires_grad_(False), seed=0)
  outs = {}
  for dev in ("cpu", "cuda"):
    model = model.to(dev)
    with torch.no_grad():
      mean, logvar = model.encode_moments(torch.from_numpy(images).to(dev))
      x = model.decode(torch.from_numpy(z).to(dev))
    outs[dev] = [t.float().cpu() for t in (mean, logvar, x)]
  flops = _vae_flops(model.to("meta"), LATENT_SIZE)
  del model
  errs = [(g - c).abs().max().item() / c.abs().max().item()
          for g, c in zip(outs["cuda"], outs["cpu"])]
  print(f"[latent] SD VAE (128, 256, 512, 512), 2 images of "
        f"{LATENT_SIZE}x{LATENT_SIZE}, card against CPU: mean {errs[0]:.3e},"
        f" logvar {errs[1]:.3e}, decode {errs[2]:.3e} of their max (bound "
        f"{VAE_TOL:g}) on {card}", flush=True)
  if not max(errs) <= VAE_TOL:
    fail(f"the VAE on the card differs from the CPU by {errs}")
  print(f"[latent] SD VAE operations an image at {LATENT_SIZE} px (from the "
        f"layers' shapes): encoder {flops['encoder'] / 1e12:.4f} TFLOP, "
        f"decoder {flops['decoder'] / 1e12:.4f} TFLOP", flush=True)
  return errs, flops


def _latent_step_grads(config, params, images, draws, dev):
  """(loss, [(name, f32 gradient on the CPU)]) of one latent training step
  on `dev`, the seeded SD VAE encoding inside it."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.models import vae as vae_lib
  from small_vision_tpu_torch.train import train_ae

  model = train_ae.build_model(config, device=dev, trainable=True)
  model.load_state_dict(convert.params_from_jax(params, model))
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(config, names, total_steps=10, warmup_steps=1)
  state = train_ae.init_train_state(model, opt, config, device=dev)
  state["vae_params"], encode, _ = vae_lib.load_vae(device=dev)
  step = train_ae.make_update_fn(model, opt, config, None, vae_encode=encode)
  loss, grads = step.loss_and_grads(
      state, {"image": torch.from_numpy(images)},
      {k: torch.from_numpy(v) for k, v in draws.items()})
  return float(loss), [(n, g.float().cpu()) for n, g in zip(names, grads)]


def _hold_latent_step(build, card, attn_impl="pallas"):
  """UMD-L/2 at full width, depth 2 + 1, one latent training step at batch
  4 with injected draws (the VAE's noise too) under `attn_impl`: card
  against CPU."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k

  config = ae_i1k.get_config(
      "variant=L/2,size=256,latent_diffusion=True,batch_size=4,"
      f"attn_impl={attn_impl}")
  config["model"].update(depth=2, dec_depth=1)
  params = convert.init_params(config, seed=1)
  rng = np.random.default_rng(32)
  n = 2
  draws = {"t": rng.integers(0, 1000, (n,)),
           "noise": rng.standard_normal((n, 32, 32, 4), dtype=np.float32),
           "vae_noise": rng.standard_normal((4, 32, 32, 4),
                                            dtype=np.float32),
           "mae_noise": rng.random((n, 256), dtype=np.float32),
           "dit_noise": rng.random((n, 256), dtype=np.float32)}
  images = rng.uniform(-1, 1, (4, LATENT_SIZE, LATENT_SIZE, 3)).astype(
      np.float32)
  loss_cpu, grads_cpu = _latent_step_grads(config, params, images, draws,
                                           "cpu")
  build.reset_launches()
  loss_gpu, grads_gpu = _latent_step_grads(config, params, images, draws,
                                           "cuda")
  launches = dict(build.LAUNCHES)
  # Two branches of 2 + 1 blocks.
  want = _times(BLOCK_TRAIN_LAUNCHES[attn_impl], 6)
  if launches != want:
    fail(f"latent training step launches {launches} != {want}")
  # As phase model: each leaf relative to its largest element, floored at
  # 1e-3 of the largest gradient; bf16 activations on both sides, rounded
  # at ties that the two summation orders split differently.
  top = max(g.abs().max().item() for _, g in grads_cpu)
  worst, worst_name = 0.0, None
  for (name, gc), (_, gg) in zip(grads_cpu, grads_gpu):
    rel = ((gg - gc).abs().max().item()
           / max(gc.abs().max().item(), 1e-3 * top))
    if rel > worst:
      worst, worst_name = rel, name
  loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  print(f"[latent] L/2 training step under {attn_impl} at width {L2_WIDTH}, "
        f"depth 2+1, batch 4 of {LATENT_SIZE} px with the VAE encode "
        f"inside: loss card "
        f"{loss_gpu:.6f}, cpu {loss_cpu:.6f} (rel {loss_rel:.2e}); "
        f"{len(grads_cpu)} gradient leaves, worst leaf-relative err "
        f"{worst:.3e} ({worst_name}); launches {launches} on {card}",
        flush=True)
  if not loss_rel <= 1e-2:
    fail(f"latent training loss on the card differs from the CPU by "
         f"{loss_rel:.2e}")
  if not worst <= 5e-2:
    fail(f"latent training gradients on the card differ from the CPU: "
         f"{worst:.3e} of leaf max at {worst_name}")


def _latent_train(build, card, batch=LATENT_BATCH, steps=LATENT_STEPS,
                  extra="", per_block=None, tag="latent", falling=True,
                  windows_retries=None, window_steps=WINDOW_STEPS):
  """Full-width, full-depth UMD-L/2@256 through `train_and_evaluate`, the
  VAE encode timed inside each step (at `batch`, for `steps` steps, with
  the config string `extra` and a block's launches `per_block`); finite
  losses that fall over the run (with `falling`). With `windows_retries`
  the run is `window_run_steps(windows_retries, window_steps)` long and
  its img/s the
  requalified median of its windows."""
  if windows_retries is not None:
    steps = window_run_steps(windows_retries, window_steps)
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.models import vae as vae_lib
  from small_vision_tpu_torch.train import train_ae

  config = ae_i1k.get_config(
      f"variant=L/2,size={LATENT_SIZE},latent_diffusion=True,data=synthetic,"
      f"batch_size={batch},total_steps={steps},log_steps=1,"
      f"eval_steps=-1{extra}")
  per_block = per_block or BLOCK_TRAIN_LAUNCHES["pallas"]
  wrap, encode_ms = _cuda_timer()

  def timed_load(load):
    def load_vae(*a, **kw):
      params, encode, decode = load(*a, **kw)
      return params, wrap(encode), decode
    return load_vae
  undo = _wrap(vae_lib, "load_vae", timed_load)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  build.reset_launches()
  try:
    train_state, history = train_ae.train_and_evaluate(
        config, device="cuda",
        log=lambda s: print(f"[{tag}] train{extra}: {s}", flush=True))
  finally:
    undo()
  launches = dict(build.LAUNCHES)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  n_params = sum(p.numel() for p in train_state["params"])
  n_vae = sum(p.numel() for p in train_state["vae_params"].values())
  del train_state
  torch.cuda.empty_cache()
  enc = encode_ms()
  if len(history) != steps or len(enc) != steps:
    fail(f"{len(history)} steps and {len(enc)} encodes ran, not "
         f"{steps}")
  timed = history[1:]
  ms = sum(h["ms"] for h in timed) / len(timed)
  enc_ms = sum(enc[1:]) / len(timed)
  print(f"[{tag}] train{extra}: UMD-L/2@{LATENT_SIZE} on (32, 32, 4) "
        "latents, "
        f"{n_params} parameters (+ {n_vae} frozen VAE), batch "
        f"{batch}: {len(timed)} timed steps, mean {ms:.2f} ms/step "
        f"(min {min(h['ms'] for h in timed):.2f}, max "
        f"{max(h['ms'] for h in timed):.2f}) = {batch / ms * 1e3:.2f} "
        f"img/s; the VAE encode {enc_ms:.2f} ms a step by CUDA events "
        f"({enc_ms / ms * 100:.1f} % of the step); peak memory "
        f"{peak_gb:.2f} GB (max_memory_allocated); waiting for the batch "
        f"{max(h['data_ms'] for h in timed):.3f} ms at most on {card}",
        flush=True)
  losses = [h["training_loss"] for h in history]
  if not all(np.isfinite(losses)):
    fail(f"non-finite latent training loss: {losses}")
  if falling and not losses[-1] < losses[0]:
    fail(f"the latent training loss did not fall: {losses}")
  if not (history[-1]["l2_params"] != history[0]["l2_params"]
          and history[-1]["l2_updates"] > 0):
    fail("the L/2 parameters did not change")
  want = _times(per_block, 2 * L2_BLOCKS * steps)
  per_step = _times(per_block, 2 * L2_BLOCKS)
  print(f"[{tag}] train{extra}: kernel launches in {steps} steps: "
        f"{launches}, model says {want} ({per_step} a step)", flush=True)
  if launches != want:
    fail(f"latent training launch counts {launches} != {want}")
  out = {"launches": launches, "ms": ms, "img_per_s": batch / ms * 1e3,
         "encode_ms": enc_ms, "peak_gb": peak_gb, "losses": losses,
         "steps": steps}
  if windows_retries is not None:
    out["qual"] = qualified_steps(history, batch, windows_retries,
                                  window_steps)
    out["img_per_s"] = out["qual"]["median"]
    print(f"[{tag}] train{extra}: training {qual_text(out['qual'])} at "
          f"batch {batch} on {card}", flush=True)
  return out


def _latent_sample(build, card):
  """One 125-step `uncond_eps` call of `make_eval_fns` at batch 64 on the
  latent path, its VAE decode timed by CUDA events."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.models import vae as vae_lib
  from small_vision_tpu_torch.ops import diffusion as gd_lib
  from small_vision_tpu_torch.train import train_ae

  config = ae_i1k.get_config(
      f"variant=L/2,size={LATENT_SIZE},latent_diffusion=True,"
      f"samples_per_call={BATCH}")
  model = train_ae.build_model(config, device="cuda")
  model.load_state_dict(convert.params_from_jax(
      _card_params(config, seed=0), model))
  vae_params, encode, decode = vae_lib.load_vae(device="cuda")
  wrap, decode_ms = _cuda_timer()
  state = {"gd": gd_lib.GaussianDiffusion.create("linear", 1000,
                                                 device="cuda"),
           "vae_params": vae_params}
  warm = dict(config, diff_schedule=dict(config["diff_schedule"],
                                         sampling_timesteps=2))
  train_ae.make_eval_fns(model, warm, encode, decode)["uncond_eps"](
      state, torch.Generator(device="cuda").manual_seed(5))
  sample = train_ae.make_eval_fns(model, config, encode,
                                  wrap(decode))["uncond_eps"]
  torch.cuda.synchronize()
  build.reset_launches()
  t0 = time.perf_counter()
  out = sample(state, torch.Generator(device="cuda").manual_seed(1))
  images = out["fid_samples"].cpu().numpy()
  sampler_s = time.perf_counter() - t0
  launches = dict(build.LAUNCHES)
  dec_s = sum(decode_ms()) / 1e3
  print(f"[latent] sampler: one 125-step uncond_eps call at batch {BATCH}, "
        f"latents decoded: {sampler_s:.3f} s = {BATCH / sampler_s:.2f} "
        f"img/s; the VAE decode {dec_s:.3f} s by CUDA events "
        f"({dec_s / sampler_s * 100:.1f} % of the call) on {card}",
        flush=True)
  if images.shape != (BATCH, LATENT_SIZE, LATENT_SIZE, 3) or \
      images.dtype != np.uint8:
    fail(f"latent samples {images.shape} {images.dtype}")
  flat = images.reshape(BATCH, -1)
  if np.any(flat.max(axis=1) == flat.min(axis=1)):
    fail("a constant latent sample came back")
  want = _times(BLOCK_SAMPLE_LAUNCHES["pallas"], L2_BLOCKS * SAMPLER_FORWARDS)
  print(f"[latent] sampler: kernel launches in the call: {launches}, model "
        f"says {want} and no other kernel", flush=True)
  if launches != want:
    fail(f"latent sampler launch counts {launches} != {want}")
  del model, state, vae_params
  torch.cuda.empty_cache()
  return {"launches": launches, "s": sampler_s, "img_per_s":
          BATCH / sampler_s, "decode_s": dec_s}


def phase_latent(build, card):
  """The latent path at UMD-L/2@256; see the module's docstring."""
  vae_errs, flops = _hold_vae(card)
  for attn_impl in ATTN_IMPLS:
    _hold_latent_step(build, card, attn_impl)
  # Windows of one 2.4 s step: 1 warm-up and 3 timed steps.
  train = _latent_train(build, card, windows_retries=0, window_steps=1)
  # K5 and K6 at width 1,024 on a model path. Over 1 warm-up and 3 steps
  # the loss need not fall (phase settings (e)): finite losses and changed
  # parameters are held.
  fused = _latent_train(build, card, steps=LATENT_FUSED_STEPS,
                        extra=",attn_impl=pallas_fused",
                        per_block=BLOCK_TRAIN_LAUNCHES["pallas_fused"],
                        falling=False)
  print(f"[latent] train under pallas_fused: {fused['ms']:.2f} ms/step, "
        f"the VAE encode {fused['encode_ms']:.2f} ms "
        f"({fused['encode_ms'] / fused['ms'] * 100:.1f} %), against pallas "
        f"{train['ms']:.2f} ms/step ({fused['ms'] / train['ms']:.4f} of "
        f"it) on {card}", flush=True)
  sample = _latent_sample(build, card)
  enc_tflops = (flops["encoder"] * LATENT_BATCH
                / (train["encode_ms"] / 1e3) / 1e12)
  dec_tflops = flops["decoder"] * BATCH / sample["decode_s"] / 1e12
  print(f"[latent] the VAE in f32 (TF32 off): encode {enc_tflops:.2f} "
        f"TFLOP/s, decode {dec_tflops:.2f} TFLOP/s, against the card's "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s f32 peak, on {card}", flush=True)
  return {"train": train, "train_fused": fused, "sample": sample,
          "vae_errs": vae_errs,
          "flops": flops, "encode_tflops": enc_tflops,
          "decode_tflops": dec_tflops}


PRECOMPUTE_IMAGES, PRECOMPUTE_VIEWS = 256, 4
PRECOMPUTE_BATCH = 256
FIXTURE_PATTERN = os.path.join("tests", "data", "latents_fixture-*.tfrecord")
FIXTURE_RECORDS, FIXTURE_BATCH = 4, 2


def _fixture_latents(k, b):
  """The latents of the fixture's k-th batch, as
  tests/test_torch_latents.py's `fixture_latents` draws them."""
  return np.random.default_rng(1000 + k).standard_normal(
      (b, 32, 32, 4)).astype(np.float32)


def _read_fixture(card):
  """The TFRecord shard that the JAX writer wrote (tests/data; the CPU
  test compares its records with a fresh write), read here through the
  `latents` source without TensorFlow, every CRC checked."""
  from small_vision_tpu_torch.data import core
  repo = os.path.dirname(os.path.abspath(__file__))
  src = core.get("latents", pattern=os.path.join(repo, FIXTURE_PATTERN),
                 check_data_crc=True)
  got = list(src.examples(ordered=True))
  want = np.concatenate([_fixture_latents(k, FIXTURE_BATCH) for k in
                         range(FIXTURE_RECORDS // FIXTURE_BATCH)])
  tf_loaded = "tensorflow" in sys.modules
  print(f"[latent] the JAX writer's TFRecord shard ({FIXTURE_PATTERN}) "
        f"through the latents source: {len(got)} records, CRCs checked, "
        f"tensorflow imported: {tf_loaded}", flush=True)
  if len(got) != FIXTURE_RECORDS or tf_loaded:
    fail(f"the fixture read {len(got)} records (tensorflow: {tf_loaded})")
  for i, ex in enumerate(got):
    if not (np.array_equal(ex["image"], want[i]) and ex["label"] == 3 * i + 1
            and ex["_id"] == i):
      fail(f"fixture record {i} differs from the JAX writer's")


def _precompute(card, root):
  """`precompute_latents` of 256 seeded 256 px images (the synthetic
  source), 4 views, through the seeded SD VAE at batch 256, into the
  arrays split `root`/train."""
  from small_vision_tpu_torch.data import core
  from small_vision_tpu_torch.data import latents
  from small_vision_tpu_torch.models import vae as vae_lib

  src = core.get("synthetic", img_size=LATENT_SIZE,
                 num_examples=PRECOMPUTE_IMAGES, pool=PRECOMPUTE_IMAGES,
                 split="train")
  params, encode, _ = vae_lib.load_vae(device="cuda")

  def vae_encode(images, generator):
    x = torch.from_numpy(images).to("cuda", non_blocking=True)
    x = x.float() / 127.5 - 1.0
    return encode(params, generator, x)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  n = latents.precompute_latents(src, vae_encode, os.path.join(root, "train"),
                                 batch_size=PRECOMPUTE_BATCH,
                                 views=PRECOMPUTE_VIEWS)
  s = time.perf_counter() - t0
  z = np.load(os.path.join(root, "train", "images.npy"), mmap_mode="r")
  print(f"[latent] precompute_latents: {PRECOMPUTE_IMAGES} images x "
        f"{PRECOMPUTE_VIEWS} views through the SD VAE at batch "
        f"{PRECOMPUTE_BATCH}: {n} latents {tuple(z.shape)} in {s:.2f} s = "
        f"{n / s:.2f} img/s (host source, encode, memmap write) on {card}",
        flush=True)
  if z.shape != (PRECOMPUTE_IMAGES * PRECOMPUTE_VIEWS, 32, 32, 4) or \
      not np.isfinite(z[::97]).all():
    fail(f"precomputed latents {z.shape}")
  del params
  torch.cuda.empty_cache()
  return {"s": s, "img_per_s": n / s, "n": n}


def _latent_pre_train(build, card, root, batch, steps, windows_retries=None):
  """UMD-L/2@256 at full width and depth through `train_and_evaluate` on
  the precomputed latents (`data=arrays:<root>`, pp keep, and
  `use_preprocessed_latents`): no encode in the step."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae

  if windows_retries is not None:
    steps = window_run_steps(windows_retries)
  config = ae_i1k.get_config(
      f"variant=L/2,size={LATENT_SIZE},latent_diffusion=True,"
      f"use_preprocessed_latents=True,data=arrays:{root},batch_size={batch},"
      f"total_steps={steps},log_steps=1,eval_steps=-1")
  config["input"]["pp"] = 'keep("image", "label")'
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  build.reset_launches()
  train_state, history = train_ae.train_and_evaluate(
      config, device="cuda",
      log=lambda s: print(f"[latent] precomputed, batch {batch}: {s}",
                          flush=True))
  launches = dict(build.LAUNCHES)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  del train_state
  torch.cuda.empty_cache()
  losses = [h["training_loss"] for h in history]
  if len(history) != steps or not all(np.isfinite(losses)):
    fail(f"latent training on precomputed latents: {losses}")
  want = _times(BLOCK_TRAIN_LAUNCHES["pallas"], 2 * L2_BLOCKS * steps)
  if launches != want:
    fail(f"latent training on precomputed latents: launches {launches} != "
         f"{want}")
  timed = history[1:]
  ms = sum(h["ms"] for h in timed) / len(timed)
  out = {"launches": launches, "ms": ms, "peak_gb": peak_gb, "steps": steps,
         "img_per_s": batch / ms * 1e3, "losses": losses, "batch": batch}
  line = (f"[latent] precomputed latents, UMD-L/2@{LATENT_SIZE} at batch "
          f"{batch}: {len(timed)} timed steps, mean {ms:.2f} ms/step; peak "
          f"{peak_gb:.2f} GB; launches {launches} (model says {want})")
  if windows_retries is not None:
    out["qual"] = qualified_steps(history, batch, windows_retries)
    out["img_per_s"] = out["qual"]["median"]
    line += f"; training {qual_text(out['qual'])}"
  print(line + f" on {card}", flush=True)
  return out


def phase_latent_pre(build, card, with_encode):
  """Precomputed latents: the JAX writer's TFRecords read without TF, the
  writer on the card, UMD-L/2@256 trained on its output at batch 256
  (beside `with_encode`, phase latent's reading with the encode in the
  step), then the largest power-of-two batch that fits."""
  _read_fixture(card)
  root = tempfile.mkdtemp(prefix="sv_latents_")
  try:
    pre = _precompute(card, root)
    train = _latent_pre_train(build, card, root, LATENT_BATCH, None,
                              windows_retries=WINDOW_RETRIES)
    if not train["losses"][-1] < train["losses"][0]:
      fail(f"latent training on precomputed latents did not fall: "
           f"{train['losses']}")
    print(f"[latent] step on precomputed latents {train['ms']:.2f} ms, "
          f"{train['img_per_s']:.2f} img/s, peak {train['peak_gb']:.2f} GB "
          f"against {with_encode['ms']:.2f} ms, {with_encode['img_per_s']:.2f}"
          f" img/s, peak {with_encode['peak_gb']:.2f} GB with the encode, at "
          f"batch {LATENT_BATCH} on {card}", flush=True)
    largest, oom = LATENT_BATCH, None
    batch = 2 * LATENT_BATCH
    while oom is None and batch <= PRECOMPUTE_IMAGES * PRECOMPUTE_VIEWS:
      try:
        got = _latent_pre_train(build, card, root, batch, 2)
        largest, train[f"batch_{batch}"] = batch, got
        batch *= 2
      except torch.cuda.OutOfMemoryError as e:
        oom = batch
        print(f"[latent] precomputed latents at batch {batch}: out of "
              f"memory ({str(e).splitlines()[0]})", flush=True)
      gc.collect()
      torch.cuda.empty_cache()
    print(f"[latent] precomputed latents: the largest power-of-two batch "
          f"that fits is {largest}"
          + (f" (out of memory at {oom})" if oom else "") + f" on {card}",
          flush=True)
    return {"precompute": pre, "train": train, "largest": largest,
            "oom_at": oom}
  finally:
    shutil.rmtree(root, ignore_errors=True)


TRANSFER_TRAIN, TRANSFER_TEST, TRANSFER_SHOTS = 8, 4, 5
EVAL_ONLY_SAMPLES = 64       # within the script's time limit


def _transfer_arrays(root):
  """Seeded `arrays` stand-ins of the ten transfer datasets: dataset i has
  4 + i colour-coded classes, 64x64 images."""
  from small_vision_tpu_torch.configs import eval_ae_i1k
  from small_vision_tpu_torch.data import arrays
  rng = np.random.default_rng(23)
  classes = {}
  for i, name in enumerate(eval_ae_i1k.TRANSFER_DATASETS):
    nc = classes[name] = 4 + i
    colours = rng.integers(30, 226, (nc, 3))
    for split, per in (("train", TRANSFER_TRAIN),
                       ("validation", TRANSFER_TEST)):
      labels = np.repeat(np.arange(nc), per)
      noise = rng.integers(-30, 31, (len(labels), 64, 64, 3))
      images = np.clip(colours[labels][:, None, None, :] + noise, 0,
                       255).astype(np.uint8)
      arrays.write_arrays(os.path.join(root, name, split), images, labels)
  return classes


def phase_eval_only(build, card, workdir, ref_stats):
  """`tools/eval_only.py` on phase resume's workdir (UMD-B/4@64 at full
  width and depth, step 6): `eval_ae_i1k.py` with 125 sampling steps, a
  `diffusion_sampling` evaluator of 64 samples scored against phase
  evals' reference statistics with the seeded InceptionV3, and the
  transfer suite on ten seeded stand-ins."""
  from small_vision_tpu_torch.configs import parse_config
  from small_vision_tpu_torch.tools import eval_only

  root = tempfile.mkdtemp(prefix="sv_transfer_")
  try:
    classes = _transfer_arrays(root)
    config = parse_config(
        f"eval_ae_i1k.py:variant=B/4,size=64,use_labels=False,"
        f"batch_size={TRAIN_BATCH},sampling_timesteps=125,"
        f"total_samples={EVAL_ONLY_SAMPLES},transfer=True,"
        f"transfer_root={root},data=synthetic")
    transfer = dict(config["evals"]["transfer"], shots=(TRANSFER_SHOTS,),
                    num_seeds=1)
    sampling = dict(type="diffusion_sampling", pred="uncond_eps",
                    total_samples=EVAL_ONLY_SAMPLES, log_steps=25_000)
    # ema_decay: the train state holds the checkpoint's EMA, which the
    # sampling evaluator samples with.
    config.update(evals={"transfer": transfer, "sample_uncond": sampling},
                  num_samples_per_call=BATCH, fid_batch_size=FID_BATCH,
                  inception_reference_path=ref_stats, ema_decay=1e-4)
    marks = []

    def log(line):
      marks.append((time.perf_counter(), line))
      print(f"[eval_only] {line}", flush=True)
    build.reset_launches()
    t0 = time.perf_counter()
    eval_only.run(config, workdir, device="cuda", log=log)
    total_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    starts = [(t, line.split()[1]) for t, line in marks
              if "evaluation (forced)" in line]
    seconds = {name: (starts[i + 1][0] if i + 1 < len(starts)
                      else t0 + total_s) - t
               for i, (t, name) in enumerate(starts)}
    rows = [json.loads(l) for l in
            open(os.path.join(workdir, "sv_tpu_metrics.txt"))]
    merged = {k: v for r in rows for k, v in r.items()}
    if not any("Resumed from step 6" in line for _, line in marks):
      fail("eval_only did not load the workdir's step-6 checkpoint")
    accs = {}
    for name, nc in classes.items():
      keys = [k for k in merged if k.endswith(
          f"{name}_{TRANSFER_SHOTS}shot-seed-0") and k.startswith("transfer")]
      if not keys:
        fail(f"eval_only logged no transfer accuracy for {name}")
      accs[name] = merged[keys[0]]
      if not (np.isfinite(accs[name]) and accs[name] > 1.0 / nc):
        fail(f"transfer {name}: accuracy {accs[name]} at or below chance "
             f"(1/{nc})")
    fid_key = "sample_uncond/fid_samples_fid_score"
    is_key = "sample_uncond/fid_samples_inception_score"
    if fid_key not in merged or is_key not in merged:
      fail(f"eval_only logged no FID/IS: {sorted(merged)}")
    fid_score, is_score = merged[fid_key], merged[is_key]
    if not (np.isfinite(fid_score) and fid_score >= 0.0
            and 1.0 <= is_score <= 1008.0):
      fail(f"eval_only FID {fid_score}, IS {is_score}")
    for k in ("ln_modulate_fwd", "attention_packed_fwd"):
      if not launches.get(k):
        fail(f"eval_only ran no {k}")
    print(f"[eval_only] on {workdir} (step 6): transfer ({TRANSFER_SHOTS} "
          f"shots, ten stand-ins of 4-13 classes) "
          + ", ".join(f"{n} {a:.4f}" for n, a in accs.items())
          + f"; {fid_key} {fid_score:.4f}, {is_key} {is_score:.4f} "
          f"({EVAL_ONLY_SAMPLES} samples, 125 steps); wall s "
          + ", ".join(f"{n} {v:.2f}" for n, v in seconds.items())
          + f", all {total_s:.2f}; launches {launches} on {card}",
          flush=True)
    return {"launches": launches, "seconds": seconds, "s": total_s,
            "transfer": accs, "fid": fid_score, "is": is_score}
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _same_rows(results, ref):
  """The results, each placed where its first image sits in `ref`, are
  `ref` (the server fills one batch with the requests in turn)."""
  def offset(r):
    hits = [o for o in range(len(ref)) if np.array_equal(ref[o], r[0])]
    return hits[0] if hits else -1
  ordered = sorted(results, key=offset)
  return min(map(offset, results)) >= 0 and np.array_equal(
      np.concatenate(ordered), ref)


EXPORT_STEPS = 25             # the exported artifacts' sampler calls


def phase_export(build, card, workdir):
  """The server and the exported sampler from phase resume's workdir
  (UMD-B/4@64, step 6, its EMA): a `SamplerServer` built by `serve
  --workdir` answers three coalesced requests, bit-equal to
  `build_sample_callable` on the .npz that `export_sampler --weights_out`
  wrote; the exported sampler (`baked` and `arg` with a bfloat16 sidecar
  under "pallas", `arg` under "pallas_fused") bit-equal to the live
  callable at the same seed, its operators counted as kernel launches."""
  import argparse as argparse_lib
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.tools import export_sampler, serve
  from small_vision_tpu_torch.utils import checkpoint as ckpt_lib

  spec = f"ae_i1k.py:variant=B/4,size=64,samples_per_call={BATCH}"
  tmp = tempfile.mkdtemp(prefix="sv_export_")
  try:
    npz = os.path.join(tmp, "ema.npz")
    export_sampler.main(["--config", spec, "--workdir", workdir,
                         "--weights_out", npz])
    args = argparse_lib.Namespace(config=spec, workdir=workdir, weights="",
                                  artifact="", no_ema=False, fn="uncond_eps",
                                  batch_size=BATCH, device="cuda")
    sample, batch = serve.build_sample_fn(args)
    server = serve.SamplerServer(sample, batch, max_wait_ms=2000.0)
    sizes, results, errors = (16, 16, 32), [None] * 3, []

    def request(i):
      try:
        results[i] = server.sample(sizes[i])
      except Exception as e:  # noqa: BLE001 -- the phase's failure
        errors.append(repr(e))
    build.reset_launches()
    clients = [threading.Thread(target=request, args=(i,)) for i in range(3)]
    for c in clients:
      c.start()
    for c in clients:
      c.join(timeout=900)
    stats = server.stats_snapshot()
    server.close(drain=False)
    launches = {"workdir_server": dict(build.LAUNCHES)}
    if errors or stats["batches"] != 1:
      fail(f"serve --workdir: {errors}, {stats['batches']} batches")
    config = ae_i1k.get_config(spec.split(":", 1)[1])
    weights = ckpt_lib.load_params_npz(npz)
    live = export_sampler.build_sample_callable(config, weights,
                                                batch_size=BATCH)
    ref = live(1)  # the server's first unseeded batch takes seed 1
    if not _same_rows(results, ref):
      fail("serve --workdir: the images differ from build_sample_callable "
           "on export_sampler's .npz")
    print(f"[serve] --workdir {workdir} (ema_params @ step 6): 3 requests "
          f"{sizes} in one call, bit-equal to build_sample_callable on the "
          f"--weights_out .npz; launches {launches['workdir_server']} on "
          f"{card}", flush=True)

    out = {"launches": launches}
    cases = (("baked", "pallas", None), ("arg_bf16", "pallas", "bfloat16"),
             ("arg_fused", "pallas_fused", None))
    for name, attn_impl, store in cases:
      cfg = ae_i1k.get_config(f"variant=B/4,size=64,samples_per_call="
                              f"{BATCH},attn_impl={attn_impl}")
      # The artifacts' calls at EXPORT_STEPS (the ladder is baked into an
      # artifact at export), each held against the live callable's.
      steps = EXPORT_STEPS
      cfg["diff_schedule"] = dict(cfg["diff_schedule"],
                                  sampling_timesteps=steps)
      path = os.path.join(tmp, f"{name}.pt2")
      side = os.path.join(tmp, f"{name}.npz") if name != "baked" else None
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      export_sampler.export_sampler(
          cfg, weights, path, batch_size=BATCH,
          weights_mode="baked" if side is None else "arg", weights_out=side,
          weights_dtype=store)
      export_s = time.perf_counter() - t0
      t0 = time.perf_counter()
      exported = export_sampler.load_exported(path, weights=side)
      load_s = time.perf_counter() - t0
      live_w = weights if store is None else ckpt_lib.load_params_npz(side)
      live = export_sampler.build_sample_callable(cfg, live_w,
                                                  batch_size=BATCH)
      build.reset_launches()
      got = exported(7)
      launches[name] = dict(build.LAUNCHES)
      want = live(7)
      per_call = _times(BLOCK_SAMPLE_LAUNCHES[attn_impl],
                        BLOCKS * (steps + 1))
      size = os.path.getsize(path) + (os.path.getsize(side) if side else 0)
      rates = ""
      q_exp = q_live = None
      if name == "baked":  # img/s of the artifact beside the live callable
        # No requalification (the script's time limit): the windows and
        # their spread are printed.
        q_exp = qualified_calls(lambda: exported(3), BATCH, 0)
        q_live = qualified_calls(lambda: live(3), BATCH, 0)
        rates = (f"; exported {qual_text(q_exp)}; live "
                 f"{qual_text(q_live)} at batch {BATCH}")
      print(f"[serve] exported sampler {name} ({attn_impl}): "
            f"{os.path.getsize(path) / 1e6:.1f} MB"
            + (f" + sidecar {os.path.getsize(side) / 1e6:.1f} MB" if side
               else "")
            + f"; export {export_s:.2f} s, load {load_s:.2f} s; one "
            f"{steps}-step call bit-equal to the live callable: {np.array_equal(got, want)}; "
            f"launches {launches[name]} (model says {per_call}){rates} on "
            f"{card}", flush=True)
      if not np.array_equal(got, want):
        fail(f"exported sampler {name}: the images differ from the live "
             "callable's")
      _check_images(got, BATCH)
      if launches[name] != per_call:
        fail(f"exported sampler {name}: launches {launches[name]} != "
             f"{per_call}")
      out[name] = {"export_s": export_s, "load_s": load_s, "bytes": size,
                   "qual": q_exp, "live_qual": q_live}
      os.remove(path)
    return out
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


def phase_probe(build, card, backbone_dir):
  """The linear probe through `linear_ae.train_and_evaluate` on the 10
  colour-coded classes of phase evals, the backbone from phase resume's
  checkpoint: stopped after its step-3 checkpoint and resumed, then the
  classification evaluator on validation/."""
  from small_vision_tpu_torch.configs import ae_i1k_lp
  from small_vision_tpu_torch.train import linear_ae

  root = tempfile.mkdtemp(prefix="sv_probe_")
  try:
    _eval_arrays(root)
    config = ae_i1k_lp.get_config(
        f"variant=B/4,size=64,data=arrays:{root},batch_size={TRAIN_BATCH},"
        f"pretrain_workdir={backbone_dir}")
    # The decoded images of an arrays source: the JAX config's decode and
    # crop stages have no work here (it has no arrays branch; ae_i1k.py's
    # arrays branch drops them the same way).
    config["input"]["pp"] = ('flip_lr|value_range(-1, 1)|onehot(1000, '
                             'key="label", key_result="labels")'
                             '|keep("image", "labels")')
    val = dict(config["evals"]["val"],
               pp_fn='value_range(-1, 1)|keep("image", "label")',
               log_steps=PROBE_STEPS)
    config["evals"] = {"val": val}
    del config["total_epochs"]
    config.update(total_steps=PROBE_STEPS, ckpt_steps=PROBE_CKPT,
                  log_training_steps=1)
    workdir = os.path.join(root, "probe_run")
    stop_log, stopped = _stop_after_checkpoint(PROBE_CKPT)
    say = lambda s: print(f"[probe] {s}", flush=True)

    def log_a(line):
      say(line)
      stop_log(line.replace("probe step", "step"))
    try:
      linear_ae.train_and_evaluate(config, workdir, device="cuda",
                                   log=log_a)
      fail("the probe run did not stop")
    except stopped:
      pass
    notes = []
    build.reset_launches()
    t0 = time.perf_counter()
    state, history = linear_ae.train_and_evaluate(
        config, workdir, device="cuda",
        log=lambda s: (notes.append(s), say(s)))
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if not any(f"Probe resumed from step {PROBE_CKPT}" in n for n in notes):
      fail(f"the probe did not resume from step {PROBE_CKPT}: {notes[:3]}")
    if [h["step"] for h in history] != list(range(PROBE_CKPT + 1,
                                                  PROBE_STEPS + 1)):
      fail(f"the resumed probe ran steps {[h['step'] for h in history]}")
    saved = sorted(os.listdir(os.path.join(workdir, "probe", "checkpoints")))
    if saved != [str(PROBE_STEPS)]:
      fail(f"probe checkpoints {saved}")
    losses = [h["training_loss"] for h in history]
    evals = history[-1].get("evals", {})
    print(f"[probe] linear probe on the frozen UMD-B/4@64 of phase resume, "
          f"batch {TRAIN_BATCH}, steps {PROBE_CKPT + 1}-{PROBE_STEPS} after "
          f"the resume: losses {[round(l, 4) for l in losses]}; "
          f"classification on validation/ ({EVAL_VAL} images) "
          + ", ".join(f"{k} {v:.4f}" for k, v in evals.items())
          + f"; {probe_s:.2f} s with the set-up; launches {launches} on "
          f"{card}", flush=True)
    if not all(np.isfinite(losses)):
      fail(f"non-finite probe loss {losses}")
    if not (0.0 <= evals.get("val/prec@1", -1) <= 1.0
            and np.isfinite(evals.get("val/loss", np.nan))):
      fail(f"probe classification gave {evals}")
    # The frozen forward (12 + 4 blocks, no gradients) once a step and once
    # for each of the evaluator's batches.
    forwards = (PROBE_STEPS - PROBE_CKPT) + -(-EVAL_VAL // TRAIN_BATCH)
    want = _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * forwards)
    if launches != want:
      fail(f"probe launches {launches} != {want}")
    del state
    return {"launches": launches, "s": probe_s, "evals": evals,
            "losses": losses}
  finally:
    shutil.rmtree(root, ignore_errors=True)


# A block's launches in a training step under remat ("nothing_saveable"
# and "save_attn_mlp", phase model and settings): the checkpointed region
# runs its forward again in the backward, K1 and K3 (K3's recompute for a
# saved attn_out is dry under "save_attn_mlp": it launches nothing).
BLOCK_TRAIN_LAUNCHES_REMAT = {
    "nothing_saveable": {"ln_modulate_fwd": 4, "ln_modulate_bwd": 2,
                         "attention_packed_fwd": 2,
                         "attention_packed_bwd": 1},
    "save_attn_mlp": {"ln_modulate_fwd": 4, "ln_modulate_bwd": 2,
                      "attention_packed_fwd": 1, "attention_packed_bwd": 1},
}
# Under "xla" and "flax" the attention is matmuls and a softmax: K1 and K2
# only. With dropout > 0 the fused MLP steps aside: no K5.
BLOCK_TRAIN_LAUNCHES_REF = {"ln_modulate_fwd": 2, "ln_modulate_bwd": 2}
BLOCK_TRAIN_LAUNCHES_DROPOUT_FUSED = {
    k: v for k, v in BLOCK_TRAIN_LAUNCHES["pallas_fused"].items()
    if k != "fused_mlp_fwd"}
# The model settings phase model holds on the card against the CPU:
# (label, attn_impl, config string, model fields, launches a block, rate).
MODEL_SETTINGS = (
    ("heads=6", "pallas", ",heads=6", None, None, 0.0),
    ("scan nothing_saveable", "pallas", ",scan=True", None,
     BLOCK_TRAIN_LAUNCHES_REMAT["nothing_saveable"], 0.0),
    ("scan save_attn_mlp", "pallas", ",scan=True",
     {"remat_policy": "save_attn_mlp"},
     BLOCK_TRAIN_LAUNCHES_REMAT["save_attn_mlp"], 0.0),
    ("", "xla", "", None, BLOCK_TRAIN_LAUNCHES_REF, 0.0),
    ("", "flax", "", None, BLOCK_TRAIN_LAUNCHES_REF, 0.0),
    ("dropout 0.1", "pallas_fused", "", None,
     BLOCK_TRAIN_LAUNCHES_DROPOUT_FUSED, 0.1),
)
SETTINGS_L2_BATCH = 1024      # the config's batch, phase settings (e)
SETTINGS_L2_STEPS = 2         # 1 warm-up + 1 timed: a memory reading
RUNLOCAL_STEPS = 3


def _runlocal_cli(build, card):
  """`cli.py --config ae_i1k.py:runlocal,total_steps=3` in this process,
  on the card (width 64: K1 and K2 at 64, K3 and K4 at head dim 16),
  with the launches its 3 steps make."""
  from small_vision_tpu_torch import cli

  build.reset_launches()
  t0 = time.perf_counter()
  cli.main(["--config", f"ae_i1k.py:runlocal,total_steps={RUNLOCAL_STEPS}"])
  s = time.perf_counter() - t0
  launches = dict(build.LAUNCHES)
  # Two branches of 2 + 1 blocks a step.
  want = _times(BLOCK_TRAIN_LAUNCHES["pallas"], 2 * 3 * RUNLOCAL_STEPS)
  print(f"[settings] (d) runlocal through cli.py: {RUNLOCAL_STEPS} steps in "
        f"{s:.2f} s; launches {launches}, model says {want} on {card}",
        flush=True)
  if launches != want:
    fail(f"runlocal launch counts {launches} != {want}")
  return {"launches": launches, "s": s}


def phase_settings(build, card):
  """The model settings at full width through the normal entry points:
  (a) UMD-B/4@64 under `heads=6,scan=True` (remat "nothing_saveable"),
  (b) one sampler call under `heads=6`, (c) UMD-S/4@64, (d) runlocal
  through cli.py, (e) UMD-L/2@256 under `scan=True` at the config's batch
  of 1,024."""
  per_remat = BLOCK_TRAIN_LAUNCHES_REMAT["nothing_saveable"]
  out = {"a": phase_train(build, card, "pallas", tag="settings",
                          extra=",heads=6,scan=True", per_block=per_remat,
                          windows=True)}
  per_step = _times(per_remat, 2 * BLOCKS)
  print(f"[settings] (a) heads=6,scan=True: {per_step} launches a step "
        f"(phase train: {_times(BLOCK_TRAIN_LAUNCHES['pallas'], 2 * BLOCKS)})"
        f"; peak {out['a']['peak_gb']:.2f} GB", flush=True)
  out["b"] = phase_sample_call(build, card, "pallas", tag="settings",
                               steps=SIDE_SAMPLER_STEPS,
                               extra=",heads=6")
  out["c"] = phase_train(build, card, "pallas", tag="settings",
                         variant="S/4", windows=True)
  out["d"] = _runlocal_cli(build, card)
  # Two steps past the warm-up one cannot show a fall: step 3's loss
  # rises above step 1's at any batch (phase train's does, and falls by
  # step 6), here by more (0.68 to 6.85 at the config's lr, to 4.68 at a
  # quarter of it, my chip runs). So (e) holds finite losses and changed
  # parameters.
  oom = None
  for batch in (SETTINGS_L2_BATCH, SETTINGS_L2_BATCH // 2):
    try:
      out["e"] = _latent_train(build, card, batch, SETTINGS_L2_STEPS,
                               ",scan=True", per_remat, tag="settings",
                               falling=False)
      out["e"].update(batch=batch, oom_at=oom)
      break
    except torch.cuda.OutOfMemoryError as e:
      oom = batch
      print(f"[settings] (e) UMD-L/2 scan=True at batch {batch}: out of "
            f"memory ({str(e).splitlines()[0]})", flush=True)
    gc.collect()  # the failed run's tensors, held by the traceback
    torch.cuda.empty_cache()
  if "e" not in out:
    fail("UMD-L/2 under scan=True ran out of memory at batch "
         f"{SETTINGS_L2_BATCH // 2} too")
  return out


# ---------------------------------------------------------------------------
# Phase heads: UMD-B/4@64 at full width under `heads=4` (4 heads of 192)
# and `heads=3` (3 heads of 256), whose heads are three and four 64-column
# tiles in every attention kernel, and under `heads=2` (2 heads of 384) and
# `heads=1` (one of 768), six and twelve tiles: the kernels' wide path (S
# summed over the tiles in a loop, the outputs' columns split across CTAs).

HEADS_SETTINGS = (4, 3, 2, 1)


def phase_heads(build, card):
  """Under each of HEADS_SETTINGS: (a) the depth-2+1 model and one
  training step on the card against the CPU under "pallas" and
  "pallas_fused" (phase model's bounds and launches); (b) full-depth
  UMD-B/4@64 at batch 256 under "pallas" through `train_and_evaluate`
  (finite, falling losses, requalified img/s, peak memory, K1 64, K3 32,
  K2 64, K4 32 a step); (c) one 25-step sampler call at batch 64 under
  each setting (K1 832 and K3 416; K1 832, K6 416 and K5 416)."""
  out = {}
  for heads in HEADS_SETTINGS:
    extra = f",heads={heads}"
    label = f"heads={heads} (head dim {WIDTH // heads})"
    for attn_impl in ATTN_IMPLS:
      phase_model(build, card, attn_impl, label, extra)
    got = {"train": phase_train(build, card, "pallas", tag="heads",
                                extra=extra, windows=True)}
    for attn_impl in ATTN_IMPLS:
      got[attn_impl] = phase_sample_call(build, card, attn_impl,
                                         tag="heads", extra=extra,
                                         steps=SIDE_SAMPLER_STEPS)
    out[heads] = got
  return out


# ---------------------------------------------------------------------------
# Phase shapes: UMD-S/4@64 under `heads=32` (32 heads of 12 at width 384,
# run on heads zero-padded to 16) and ViT-mu/16@224 (width 32, MLP 128, 2
# heads of 16: K5's and K6's GEMM on tails along K and N) under
# "pallas_fused".

SHAPES_S4 = ",variant=S/4,heads=32"
VIT_MU = "mu/16"


def phase_shapes(build, card, settings):
  """(a) UMD-S/4@64 under `heads=32`: the depth-2+1 model and one training
  step on the card against the CPU under "pallas" and "pallas_fused"
  (phase model's bounds and launches); full-depth training at batch 256
  under "pallas" through `train_and_evaluate` (finite, falling losses,
  requalified img/s, K1 64, K3 32, K2 64, K4 32 a step), beside phase
  settings (c)'s UMD-S/4@64 of 6 heads of 64; one 25-step sampler call at
  batch 64 under each setting (K1 832 and K3 416; K1 832, K6 416 and K5
  416). (b) ViT-mu/16@224 under "pallas_fused": "map" and "tok"
  at depth 2 on the card against the CPU (phase classifier's bounds and
  launches), and its full-depth forward at batch 64, timed as phase
  classifier times, with its K5 and K6 launches."""
  from small_vision_tpu_torch.ops import fused_block as fb

  out = {}
  label = "UMD-S/4 heads=32 (head dim 12)"
  for attn_impl in ATTN_IMPLS:
    phase_model(build, card, attn_impl, label, SHAPES_S4)
  out["train"] = phase_train(build, card, "pallas", tag="shapes",
                             extra=",heads=32", variant="S/4", windows=True)
  for attn_impl in ATTN_IMPLS:
    out[attn_impl] = phase_sample_call(build, card, attn_impl, tag="shapes",
                                       extra=SHAPES_S4,
                                       steps=SIDE_SAMPLER_STEPS)
  per_step = _times(BLOCK_TRAIN_LAUNCHES["pallas"], 2 * BLOCKS)
  print(f"[shapes] (a) {label}: training under pallas "
        f"{qual_text(out['train']['qual'])}, peak "
        f"{out['train']['peak_gb']:.2f} GB, launches a step {per_step} "
        f"(phase settings (c), 6 heads of 64: "
        f"{settings['c']['img_per_s']:.2f} img/s, peak "
        f"{settings['c']['peak_gb']:.2f} GB); sampler "
        + ", ".join(f"{a} {out[a]['fwd_ms']:.2f} ms a forward"
                    for a in ATTN_IMPLS)
        + f" ({SIDE_SAMPLER_STEPS}-step calls) on {card}", flush=True)
  out["cls_checks"] = {
      pool: _hold_classifier(build, card, VIT_MU, "pallas_fused", pool,
                             CLS_SIZE, exact=True) for pool in ("map", "tok")}
  params = _classifier_params(_classifier_kw(VIT_MU, "pallas_fused"), seed=9,
                              card=True)
  out["cls"] = _time_classifier(build, card, VIT_MU, "pallas_fused",
                                CLS_SIZE, CLS_FORWARDS, params)
  got = out["cls"]["launches"]
  print(f"[shapes] (b) ViT-{VIT_MU}@{CLS_SIZE} under pallas_fused: "
        f"{qual_text(out['cls']['qual'])} at batch {CLS_BATCH}; a forward "
        f"launches K5 {got.get(fb.MLP_NAME, 0)} times and K6 "
        f"{got.get(fb.MHA_NAME, 0)} on {card}", flush=True)
  return out


# ---------------------------------------------------------------------------
# Phase f32: UMD-B/4@64 under `dtype_mm="float32"` (the upstream
# reference's precision), "pallas" and "pallas_fused": K1-K6 in f32, on
# the card in f32 (TF32 off).

F32_MODEL = {"dtype_mm": "float32"}
# A block's launches in f32: the f32 instances of the bf16 ones, under
# each setting ("pallas": K1-K4; "pallas_fused": K1, K2, K5, K6 and the
# backward's K3 and K4).
BLOCK_TRAIN_LAUNCHES_F32 = {
    a: {_named(k, torch.float32): v for k, v in per.items()}
    for a, per in BLOCK_TRAIN_LAUNCHES.items()}
BLOCK_SAMPLE_LAUNCHES_F32 = {
    a: {_named(k, torch.float32): v for k, v in per.items()}
    for a, per in BLOCK_SAMPLE_LAUNCHES.items()}
# The fused f32 training run: 1 warm-up and 3 timed steps (each a window
# of one step), as phase latent's fused UMD-L/2 reading.
F32_FUSED_STEPS = 4


def phase_f32(build, card):
  """UMD-B/4@64 under `dtype_mm="float32"`, on the card with TF32 off
  (held: it must be off when the phase runs). Under "pallas": (a) the
  depth-2+1 model and one training step on the card against the CPU's
  plain f32 path within MODEL_BOUNDS_F32, the launches exact (the f32
  instances of K1-K4 only); (b) full-depth training at batch 256 through
  `train_and_evaluate` (finite, falling losses, requalified img/s, peak
  memory, K1 64, K3 32, K2 64, K4 32 launches a step, all in f32); (c)
  one 25-step sampler call at batch 64 (K1 832, K3 416, in f32). (d) Under
  "pallas_fused" the same three: the depth-2+1 check, F32_FUSED_STEPS
  full-depth training steps (K1 64, K6 32, K5 32, K2 64, K3 32, K4 32 a
  step, all in f32) and one 25-step sampler call (K1 832, K6 416, K5 416,
  in f32)."""
  if (torch.backends.cuda.matmul.allow_tf32
      or torch.backends.cudnn.allow_tf32
      or torch.get_float32_matmul_precision() != "highest"):
    fail("TF32 is on: the f32 model's products would not be f32")
  out = {}
  for attn_impl in ATTN_IMPLS:
    per_block = BLOCK_TRAIN_LAUNCHES_F32[attn_impl]
    phase_model(build, card, attn_impl, "dtype_mm=float32", model=F32_MODEL,
                per_block=per_block, bounds=MODEL_BOUNDS_F32)
    fused = attn_impl == "pallas_fused"
    out[attn_impl] = {
        "train": phase_train(build, card, attn_impl, tag="f32",
                             per_block=per_block, windows=not fused,
                             model=F32_MODEL, steps=F32_FUSED_STEPS),
        "sampler": phase_sample_call(
            build, card, attn_impl, tag="f32", steps=SIDE_SAMPLER_STEPS,
            model=F32_MODEL,
            per_block=BLOCK_SAMPLE_LAUNCHES_F32[attn_impl])}
  return out


# ---------------------------------------------------------------------------
# Phase classifier: the ViT classifier (models/vit.py's `_ViT`) at 224 px
# and at the ViT paper's fine-tuning resolutions.

CLS_SIZE, CLS_CLASSES = 224, 1000
CLS_BATCH = 64                # the full-depth forwards' batch
# (a): card against CPU at batch 2: the CPU's depth-2 passes at 512 and
# 518 px take much of the script's time limit.
CLS_CHECK_BATCH, CLS_CHECK_DEPTH = 2, 2
CLS_FORWARDS = 8              # forwards in one timed window of (b) at 224
# (a): (variant, attn_impl, pool_type, image size) held on the card
# against the CPU. At 224 "map" at patch 16 is L = 196, "tok" 197;
# ViT-H/14 is L = 256, head dim 80 (K6 under pallas_fused; K3/K4 of its
# backward). ViT-L/16@512 is 32 x 32 patches (L = 1,025 with the class
# token) and ViT-H/14@518 37 x 37 (1,369): K3, K4 and K6 past the lengths
# whose K and V stay resident.
CLS_CHECKS = (("B/16", "pallas", "map", 224), ("B/16", "pallas", "tok", 224),
              ("B/16", "pallas_fused", "map", 224),
              ("B/16", "pallas_fused", "tok", 224),
              ("H/14", "pallas_fused", "map", 224),
              ("L/16", "pallas", "tok", 512), ("H/14", "pallas", "map", 518),
              ("H/14", "pallas_fused", "map", 518))
# (b): full depth and width, timed (the factory's default pool, "gap"):
# (variant, attn_impl, image size, forwards in a timed window).
CLS_TIMED = (("B/16", "pallas", 224, CLS_FORWARDS),
             ("B/16", "pallas_fused", 224, CLS_FORWARDS),
             ("H/14", "pallas_fused", 224, CLS_FORWARDS),
             ("L/16", "pallas", 512, 2), ("L/16", "pallas_fused", 512, 2),
             ("H/14", "pallas", 518, 1), ("H/14", "pallas_fused", 518, 1))


def _classifier(kw, params, device, trainable=False):
  """`models.get_model_module("vit").Model(**kw)` on `device`, its
  weights the flax-named tree `params`."""
  from small_vision_tpu_torch import convert, models

  with torch.device(device):
    model = models.get_model_module("vit").Model(**kw)
  model.load_state_dict(convert.params_from_jax(params, model))
  return model.train(trainable).requires_grad_(trainable)


def _classifier_kw(variant, attn_impl, **kw):
  return dict(variant=variant, num_classes=CLS_CLASSES, head_zeroinit=False,
              attn_impl=attn_impl, **kw)


def _classifier_params(kw, seed, card=False):
  """Every leaf drawn by `convert.init_params` at 224 px (with `card`, by
  `_card_params` on the card); at another `kw["image_size"]` the learned
  posemb is carried from the 224 grid to the model's by `resample_posemb`,
  as a hi-res fine-tune from a 224 checkpoint does."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.models import vit

  config = {"model_name": "vit", "model": dict(kw, image_size=CLS_SIZE)}
  params = (_card_params if card else convert.init_params)(config, seed)
  size = kw.get("image_size", CLS_SIZE)
  if size != CLS_SIZE:
    grid = size // vit.decode_variant(kw["variant"])["patch_size"][0]
    old = params["pos_embedding"]
    old = old.cpu() if card else torch.from_numpy(old)
    new = vit.resample_posemb(old, torch.zeros(1, grid * grid, old.shape[-1]))
    params["pos_embedding"] = new.cuda() if card else new.numpy()
  return params


def _classifier_gflop(variant, size):
  """GFLOP of one image's forward through ViT-<variant>'s encoder at
  `size` px (the "gap" pool: no class token): each block's matmuls, 2 L
  (4 W^2 + 2 W mlp), and its attention, 4 L^2 W."""
  from small_vision_tpu_torch.models import vit

  v = vit.decode_variant(variant)
  w, seq = v["width"], (size // v["patch_size"][0]) ** 2
  return v["depth"] * (2 * seq * (4 * w * w + 2 * w * v["mlp_dim"])
                       + 4 * seq * seq * w) / 1e9


def _leaf_worst(grads, ref, top, skip=()):
  """(worst leaf-relative error, its leaf) of `grads` against `ref`, each
  leaf relative to its largest element in `ref`, floored at 1e-3 of `top`
  (the largest gradient), as phase model; leaves in `skip` left out."""
  worst, worst_name = 0.0, None
  for (name, gr), (_, g) in zip(ref, grads):
    if name in skip:
      continue
    rel = ((g - gr).abs().max().item()
           / max(gr.abs().max().item(), 1e-3 * top))
    if rel > worst:
      worst, worst_name = rel, name
  return worst, worst_name


def _hold_classifier(build, card, variant, attn_impl, pool_type, size,
                     exact=False):
  """ViT-<variant>@<size> at full width and depth 2, card (kernels)
  against CPU (plain versions), the same weights (drawn at 224,
  `_classifier_params`) and images: the logits and the gradients of a
  softmax cross-entropy, with the launches of the card's forward and
  backward. With `exact`, the card is also held against the CPU in f32
  (the function without bf16 roundings), every leaf within the same
  bounds; a leaf whose f32 gradient is rounding noise (at most 1e-6 of
  the largest: the key biases, 0 analytically) is held against f32 alone,
  since its bf16 gradients on both sides are noise as large as their
  bound (2-4e-5 of the largest gradient at ViT-mu's width 32)."""
  kw = _classifier_kw(variant, attn_impl, pool_type=pool_type,
                      depth=CLS_CHECK_DEPTH, image_size=size)
  params = _classifier_params(kw, seed=7)
  rng = np.random.default_rng(8)
  images = rng.uniform(-1, 1, (CLS_CHECK_BATCH, size, size, 3)
                       ).astype(np.float32)
  labels = rng.integers(0, CLS_CLASSES, CLS_CHECK_BATCH)
  got, runs = {}, {"cpu": ("cpu", kw), "cuda": ("cuda", kw)}
  if exact:
    runs["f32"] = ("cpu", dict(kw, dtype_mm="float32"))
  for key, (dev, model_kw) in runs.items():
    model = _classifier(model_kw, params, dev, trainable=True)
    build.reset_launches()
    logits, out = model(torch.from_numpy(images).to(dev))
    torch.nn.functional.cross_entropy(
        logits.float(), torch.from_numpy(labels).to(dev)).backward()
    got[key] = (logits.detach().float().cpu(),
                [(n, p.grad.float().cpu())
                 for n, p in sorted(model.named_parameters())],
                dict(build.LAUNCHES),
                out["with_posemb"].shape[1] + (pool_type == "tok"))
  (l_cpu, g_cpu, _, seq), (l_gpu, g_gpu, launches, _) = got["cpu"], got["cuda"]
  want = _times(BLOCK_TRAIN_LAUNCHES[attn_impl], CLS_CHECK_DEPTH)
  label = f"ViT-{variant}@{size} {attn_impl} pool {pool_type}"
  if launches != want:
    fail(f"{label}: launches {launches} != {want}")
  err = (l_gpu - l_cpu).abs().max().item()
  scale = l_cpu.abs().max().item()
  # Each leaf relative to its largest element, floored at 1e-3 of the
  # largest gradient (the key biases' are 0 analytically), as phase model.
  top = max(g.abs().max().item() for _, g in g_cpu)
  noise = ()
  if exact:
    l_f32, g_f32 = got["f32"][:2]
    top32 = max(g.abs().max().item() for _, g in g_f32)
    noise = {n for n, g in g_f32 if g.abs().max().item() <= 1e-6 * top32}
    err32 = (l_gpu - l_f32).abs().max().item()
    worst32, worst32_name = _leaf_worst(g_gpu, g_f32, top32)
  worst, worst_name = _leaf_worst(g_gpu, g_cpu, top, noise)
  print(f"[classifier] (a) {label}, depth {CLS_CHECK_DEPTH}, L = {seq}, "
        f"batch {CLS_CHECK_BATCH}: logits max abs err {err:.3e} of max "
        f"{scale:.3e}; {len(g_cpu)} gradient leaves, worst leaf-relative err "
        f"{worst:.3e} ({worst_name})"
        + (f" ({len(noise)} leaves of rounding noise held against f32 "
           f"alone); against the CPU in f32: logits {err32:.3e}, worst leaf "
           f"{worst32:.3e} ({worst32_name})" if exact else "")
        + f"; launches {launches} on {card}", flush=True)
  if not (torch.isfinite(l_gpu).all() and err <= 3e-2 * scale):
    fail(f"{label}: logits on the card differ from the CPU by {err:.3e}")
  if not worst <= 5e-2:
    fail(f"{label}: gradients on the card differ from the CPU: {worst:.3e} "
         f"of leaf max at {worst_name}")
  if exact and not (err32 <= 3e-2 * scale and worst32 <= 5e-2):
    fail(f"{label}: the card differs from the CPU in f32: logits "
         f"{err32:.3e}, gradients {worst32:.3e} of leaf max at "
         f"{worst32_name}")
  return {"err": err, "worst_grad": worst, "launches": launches}


def _time_classifier(build, card, variant, attn_impl, size, forwards,
                     params):
  """The full-depth, full-width ViT-<variant>@<size> forward at batch 64
  on the card, on `params` (`_classifier_params`): its launches,
  requalified img/s (windows of `forwards` forwards), its GFLOP an image
  and peak memory."""
  kw = _classifier_kw(variant, attn_impl, image_size=size)
  model = _classifier(kw, params, "cuda")
  depth = model.Transformer.depth
  gflop = _classifier_gflop(variant, size)
  x = torch.from_numpy(np.random.default_rng(10).uniform(
      -1, 1, (CLS_BATCH, size, size, 3)).astype(np.float32)).cuda()
  label = f"ViT-{variant}@{size} {attn_impl}"
  with torch.inference_mode():
    model(x)  # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    logits, _ = model(x)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = _times(BLOCK_SAMPLE_LAUNCHES[attn_impl], depth)
    if launches != want:
      fail(f"{label}: forward launches {launches} != {want}")
    if logits.shape != (CLS_BATCH, CLS_CLASSES) or not torch.isfinite(
        logits.float()).all():
      fail(f"{label}: bad logits {tuple(logits.shape)}")
    torch.cuda.reset_peak_memory_stats()

    def call():
      for _ in range(forwards):
        model(x)
      torch.cuda.synchronize()
    qual = qualified_calls(call, forwards * CLS_BATCH)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  tflops = gflop * qual["median"] / 1e3
  print(f"[classifier] (b) {label}, depth {depth}, batch {CLS_BATCH}: "
        f"{qual_text(qual)}; {gflop:.1f} GFLOP an image, {tflops:.1f} "
        f"TFLOP/s; launches a forward {launches}; peak {peak_gb:.2f} GB on "
        f"{card}", flush=True)
  del model
  gc.collect()
  torch.cuda.empty_cache()
  return {"qual": qual, "img_per_s": qual["median"], "launches": launches,
          "peak_gb": peak_gb, "depth": depth, "gflop": gflop,
          "tflops": tflops}


def phase_classifier(build, card, settings):
  """(a) ViT-B/16 and ViT-H/14 @224, ViT-L/16@512 and ViT-H/14@518 at full
  width, depth 2, on the card against the CPU; (b) their full-depth
  forwards at batch 64, timed; (c) one `heads=6` sampler call under
  "pallas_fused" (K6 at head dim 128) beside phase settings (b)'s under
  "pallas"."""
  out = {"checks": {f"{v}@{n} {a} {p}": _hold_classifier(build, card, v, a,
                                                          p, n)
                    for v, a, p, n in CLS_CHECKS}}
  out["timed"], drawn = {}, {}
  for v, a, n, forwards in CLS_TIMED:
    if (v, n) not in drawn:  # both settings run the same weights
      drawn = {(v, n): _classifier_params(_classifier_kw(
          v, a, image_size=n), seed=9, card=True)}
    out["timed"][f"{v}@{n} {a}"] = _time_classifier(
        build, card, v, a, n, forwards, drawn[(v, n)])
  del drawn
  out["sampler"] = phase_sample_call(build, card, "pallas_fused",
                                     tag="classifier", extra=",heads=6",
                                     steps=SIDE_SAMPLER_STEPS)
  print(f"[classifier] (c) heads=6 sampler under pallas_fused: "
        f"{out['sampler']['fwd_ms']:.2f} ms a forward, "
        f"{out['sampler']['s']:.3f} s a {SIDE_SAMPLER_STEPS}-step call "
        f"(pallas, phase settings (b): {settings['b']['fwd_ms']:.2f} ms); "
        f"{out['sampler']['launches'].get('fused_mha_fwd', 0)} K6 launches "
        f"at head dim 128 on {card}", flush=True)
  return out


# ---------------------------------------------------------------------------
# Phase parallel: the parallel layer on the one card.

PARALLEL_STEPS = 2           # within the script's time limit
PARALLEL_TIMEOUT = 360.0      # s: each spawned process set is killed on it
# torch's CPU threads in each process that phases parallel and tensor start:
# ten of them run at once on the host's cores.
CHILD_THREADS = 2
PIPE_MICROBATCHES = 8
PARALLEL_CONFIG = (f"fsdp=True,size=64,data=synthetic,batch_size={TRAIN_BATCH},"
                   f"total_steps={PARALLEL_STEPS},log_steps=1,eval_steps=-1")


def _parallel_plan(path, batch=TRAIN_BATCH, steps=PARALLEL_STEPS):
  """Seeded batches and draws of the fsdp run: global images and, per
  branch, the draws of the single-process step on [every process's
  diffusion rows, then every process's MAE rows]."""
  rng = np.random.default_rng(15)
  n = batch // 2
  plan = {}
  for s in range(steps):
    plan[f"image{s}"] = rng.uniform(-1, 1, (batch, 64, 64, 3)).astype(
        np.float32)
    plan[f"t{s}"] = rng.integers(0, 1000, (n,))
    plan[f"noise{s}"] = rng.standard_normal((n, 64, 64, 3), dtype=np.float32)
    plan[f"mae_noise{s}"] = rng.random((n, 256), dtype=np.float32)
    plan[f"dit_noise{s}"] = rng.random((n, 256), dtype=np.float32)
  np.savez(path, **plan)


def _injected_trainer(plan, index, count, record, batch=TRAIN_BATCH,
                      time_layout=True):
  """`train_ae.make_update_fn` with this process's rows of the plan's batch
  (its share of the diffusion rows, then of the MAE rows), the matching
  draws, no device pp, and records: the layout, the full `nu` after step 1
  (the step-1 gradients), and (`time_layout`) the host time of the
  layout's collectives."""
  from small_vision_tpu_torch.parallel.sharding import ShardedParams
  from small_vision_tpu_torch.train import train_ae
  orig = train_ae.make_update_fn

  def make(model, opt, config, device_pp, **kw):
    update = orig(model, opt, config, None, **kw)
    layout = kw.get("layout")
    record["layout"] = layout
    nl = ml = batch // 2 // count

    def update_fn(train_state, _, draws=None, *, with_l2=False):
      s = len(record.setdefault("meas", []))
      rows = np.r_[index * nl:(index + 1) * nl,
                   batch // 2 + index * ml:batch // 2 + (index + 1) * ml]
      draws = {k: plan[f"{k}{s}"][index * nl:(index + 1) * nl]
               for k in ("t", "noise", "mae_noise", "dit_noise")}
      meas = update(train_state, {"image": plan[f"image{s}"][rows]}, draws,
                    with_l2=with_l2)
      record["meas"].append(meas)
      if s == 0:
        nu = train_state["opt"]["nu"]
        record["nu1"] = [t.float().cpu() for t in (
            layout.full(nu, opt=True) if layout is not None else nu)]
      return meas
    return update_fn

  def timed(method):
    def wrapper(self, *a):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = method(self, *a)
      torch.cuda.synchronize()
      record["coll_ms"][-1] += (time.perf_counter() - t0) * 1e3
      return out
    return wrapper
  if not time_layout:
    return make, lambda: None
  record["coll_ms"] = []
  gather, reduce = ShardedParams.gather, ShardedParams.reduce_grads

  def gather_timed(self, shards):
    record["coll_ms"].append(0.0)
    return timed(gather)(self, shards)
  ShardedParams.gather = gather_timed
  ShardedParams.reduce_grads = timed(reduce)
  return make, lambda: (setattr(ShardedParams, "gather", gather),
                        setattr(ShardedParams, "reduce_grads", reduce))


# Phase parallel's placements beside fsdp=True's (fully_sharded parameters
# and optimizer state): ZeRO-1, and sharded parameters with JAX's default
# replicated optimizer state.
PLACEMENTS = {"zero1": {"param_sharding": "replicated"},
              "sharded_params": {"optim_sharding": "replicated"}}


def _fsdp_run(plan_path, index, count, device, mesh=None, placement=None):
  """The 3-step fsdp=True run through `train_and_evaluate` on the plan
  (with `placement`'s strategies over fsdp=True's); returns what the phase
  compares and reports, with the state bytes the layout's placements give
  (f32 parameters, bf16 mu, f32 nu)."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.ops import _build as build
  from small_vision_tpu_torch.parallel import sharding as sharding_lib
  from small_vision_tpu_torch.train import train_ae
  plan = dict(np.load(plan_path))
  record = {}
  make, restore = _injected_trainer(plan, index, count, record)
  orig = train_ae.make_update_fn
  train_ae.make_update_fn = make
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  build.reset_launches()
  config = ae_i1k.get_config(PARALLEL_CONFIG)
  config.update(placement or {})
  try:
    state, history = train_ae.train_and_evaluate(
        config, device=device, log=lambda s: None, mesh=mesh)
  finally:
    train_ae.make_update_fn = orig
    restore()
  launches = dict(build.LAUNCHES)
  layout = record["layout"]
  params = state["params"] if layout is None else layout.full(
      state["params"])
  opt = state["opt"]
  state_bytes = sum(t.numel() * t.element_size() for t in (
      list(state["params"]) + list(opt["mu"]) + list(opt["nu"])))
  if layout is None:
    n_params = n_opt = sum(int(p.numel()) for p in state["params"])
  else:
    n_params = sum(int(np.prod(s)) for s in (
        sharding_lib.shard_shape(f, sp, mesh) for f, sp in zip(
            layout.full_shapes, layout.specs)))
    n_opt = sum(int(np.prod(s)) for s in layout.opt_shapes())
  return {"losses": [float(m["training_loss"]) for m in record["meas"]],
          "expect_bytes": 4 * n_params + (2 + 4) * n_opt,
          "names": list(layout.names) if layout is not None else None,
          "params": [p.detach().float().cpu() for p in params],
          "nu1": record["nu1"], "launches": launches,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "state_gb": state_bytes / 1e9,
          "step_ms": [h["ms"] for h in history],
          "coll_ms": record["coll_ms"]}


def _pipe_config(pipe):
  from small_vision_tpu_torch.configs import ae_i1k
  config = ae_i1k.get_config(
      f"scan=True,size=64,data=synthetic,batch_size={TRAIN_BATCH},"
      f"total_steps={PARALLEL_STEPS},eval_steps=-1")
  if pipe:
    config["model"].update(pipe_stages=2,
                           pipe_microbatches=PIPE_MICROBATCHES)
    config.update(param_sharding="pipeline", optim_sharding="pipeline")
  return config


def _pipe_step(plan_path, device, mesh=None):
  """The first step's forward prediction (the sampler's call, x_t at t),
  loss and gradients (full leaves) under `scan=True`: pipelined on a
  `pipe` mesh, or not."""
  from small_vision_tpu_torch.ops import _build as build
  from small_vision_tpu_torch.parallel import ctx
  from small_vision_tpu_torch.train import train_ae
  plan = dict(np.load(plan_path))
  config = _pipe_config(mesh is not None)
  run = train_ae.setup_training(config, device, lambda s: None, mesh)
  model, layout = run["model"], run["layout"]
  draws = {k: torch.from_numpy(plan[f"{k}0"]).to(device)
           for k in ("t", "noise", "mae_noise", "dit_noise")}
  x_t = torch.from_numpy(plan["image1"]).to(device)
  t = torch.from_numpy(plan["t1"][:TRAIN_BATCH // 2]).to(device)
  t = torch.cat([t, t])
  build.reset_launches()
  with ctx.activate_mesh(mesh):
    with torch.inference_mode():
      pred = model(x_t, t=t + 1)[0].float().cpu()
    step = train_ae.make_update_fn(model, run["opt"], config, None,
                                   layout=layout, mesh=mesh)
    loss, grads = step.loss_and_grads(
        run["train_state"], {"image": torch.from_numpy(plan["image0"]).to(
            device)}, draws)
  launches = dict(build.LAUNCHES)
  if layout is not None:
    grads = layout.full(grads)
  return {"pred": pred, "loss": float(loss), "launches": launches,
          "grads": [g.float().cpu() for g in grads], "names": run["names"]}


def parallel_worker(rank, n, device, tmp):
  """A process of phase parallel's (b): the fsdp=2 run, then the pipe=2
  step; writes its results to `tmp`."""
  from small_vision_tpu_torch.parallel import collectives
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  keep_draws()  # its four runs start from one tree
  plan = os.path.join(tmp, "plan.npz")
  mesh = mesh_lib.make_mesh(fsdp=0)
  out = _fsdp_run(plan, *mesh.batch_shard(), device, mesh)
  out["transport"] = collectives.transport(mesh.group("fsdp"))
  torch.save(out, os.path.join(tmp, f"fsdp_rank{rank}.pt"))
  del out
  torch.cuda.empty_cache()
  for name, placement in PLACEMENTS.items():
    out = _fsdp_run(plan, *mesh.batch_shard(), device, mesh, placement)
    out["transport"] = collectives.transport(mesh.group("fsdp"))
    torch.save(out, os.path.join(tmp, f"{name}_rank{rank}.pt"))
    del out
    torch.cuda.empty_cache()
  mesh = mesh_lib.make_mesh(pipe=2)
  out = _pipe_step(plan, device, mesh)
  out["transport"] = collectives.transport(mesh.group("pipe"))
  torch.save(out, os.path.join(tmp, f"pipe_rank{rank}.pt"))


def _leaf_rel(got, want):
  """The worst leaf-relative gradient difference (phase model's measure:
  each leaf relative to its largest element, floored at 1e-3 of the
  largest of any leaf)."""
  top = max(w.abs().max().item() for w in want)
  return max((g - w).abs().max().item() / max(w.abs().max().item(),
                                               1e-3 * top)
             for g, w in zip(got, want))


def _launch_cli(entry, argv, env, tmp):
  """`entry` ("launch" or "cli") of the port in a fresh process on the
  card, with its kernel launches; returns (stdout, launches)."""
  code = (f"import sys, json\nfrom small_vision_tpu_torch import {entry}\n"
          "from small_vision_tpu_torch.ops import _build\n"
          f"{entry}.main(sys.argv[1:])\n"
          "print('LAUNCHES ' + json.dumps(dict(_build.LAUNCHES)))\n")
  repo = os.path.dirname(os.path.abspath(__file__))
  env = dict(os.environ, **env)
  env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
  try:
    proc = subprocess.run([sys.executable, "-c", code] + argv, env=env,
                          cwd=repo, capture_output=True, text=True,
                          timeout=PARALLEL_TIMEOUT)
  except subprocess.TimeoutExpired:
    fail(f"parallel (a): {entry} did not end within {PARALLEL_TIMEOUT} s")
  if proc.returncode != 0:
    fail(f"parallel (a): {entry} failed:\n{proc.stdout[-2000:]}\n"
         f"{proc.stderr[-3000:]}")
  line = [l for l in proc.stdout.splitlines() if l.startswith("LAUNCHES ")]
  return proc.stdout, json.loads(line[-1][len("LAUNCHES "):])


def _in_thread(fn, *args):
  """Starts `fn(*args)` in a thread; returns a join that gives its result,
  or raises what it raised (a `fail` in the thread included)."""
  box = {}

  def run():
    try:
      box["out"] = fn(*args)
    except BaseException as e:  # noqa: BLE001 -- raised again in join
      box["error"] = e
  # Not a daemon: on a failure the interpreter waits for it, so the
  # processes it started are stopped (`spawn` kills its own on the way
  # out, `subprocess.run` on its time limit).
  thread = threading.Thread(target=run)
  thread.start()

  def join():
    thread.join()
    if "error" in box:
      raise box["error"]
    return box["out"]
  return join


def _free_port():
  import socket
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _parallel_production(card):
  """(a) `launch` -> `cli` on fsdp=True under NCCL with one rank, against
  `cli` without a process group: the step-3 checkpoints and the losses
  bit-equal."""
  tmp = tempfile.mkdtemp(prefix="sv_parallel_a_")
  try:
    argv = ["--config", f"ae_i1k.py:{PARALLEL_CONFIG}"]
    env = {"SLURM_PROCID": "0", "SLURM_NTASKS": "1", "SLURM_LOCALID": "0",
           "SV_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}"}
    threads = {"OMP_NUM_THREADS": str(CHILD_THREADS)}
    runs = {}

    def run(entry, extra_env):
      work = os.path.join(tmp, entry)
      t0 = time.perf_counter()
      out, launches = _launch_cli(entry, argv + ["--workdir", work],
                                  extra_env, tmp)
      line = [l for l in out.splitlines() if "img/s at batch" in l][-1]
      return {
          "s": time.perf_counter() - t0, "line": line, "launches": launches,
          "img_per_s": float(line.split(" img/s")[0].split()[-1]),
          "peak_gb": float(line.split("peak ")[1].split(" GB")[0]),
          "ckpt": {n: dict(np.load(os.path.join(
              work, "checkpoints", str(PARALLEL_STEPS), f"{n}.npz")))
                   for n in ("params", "opt")},
          "losses": [json.loads(l)["training_loss"] for l in open(
              os.path.join(work, "sv_tpu_metrics.txt"))
                     if "training_loss" in l]}
    # The two processes at once (each ~8 s to reach the card, most of the
    # rest host work): their img/s share the card and the host.
    joins = {entry: _in_thread(run, entry, extra_env)
             for entry, extra_env in (("launch", {**env, **threads}),
                                      ("cli", threads))}
    for entry, join in joins.items():
      runs[entry] = join()
      print(f"[parallel] (a) {entry}: {runs[entry]['line']}; "
            f"{runs[entry]['s']:.1f} s with the process's start (launch and "
            f"cli at once, beside phase parallel's (b))", flush=True)
    a, b = runs["launch"], runs["cli"]
    if a["losses"] != b["losses"] or len(a["losses"]) != PARALLEL_STEPS:
      fail(f"parallel (a): NCCL losses {a['losses']} != {b['losses']}")
    for entry in ("params", "opt"):
      for k, v in b["ckpt"][entry].items():
        if not np.array_equal(a["ckpt"][entry][k], v):
          fail(f"parallel (a): checkpoint {entry}/{k} differs under NCCL")
    per_step = _times(BLOCK_TRAIN_LAUNCHES_REMAT["nothing_saveable"],
                      2 * BLOCKS * PARALLEL_STEPS)
    for entry in runs:
      if runs[entry]["launches"] != per_step:
        fail(f"parallel (a) {entry}: launches {runs[entry]['launches']} != "
             f"{per_step}")
    print(f"[parallel] (a) fsdp=True through launch on NCCL (world size 1) "
          f"against cli without a process group: {PARALLEL_STEPS} losses "
          f"{a['losses']} and the step-{PARALLEL_STEPS} checkpoint "
          f"(params, mu, nu) bit-equal; launches {a['launches']}; "
          f"{a['img_per_s']:.2f} img/s (without: {b['img_per_s']:.2f}), peak "
          f"{a['peak_gb']:.2f} GB, on {card}", flush=True)
    return runs
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


def phase_parallel(build, card, then=None):
  """Phase parallel: (a) the production route with one rank on NCCL, and
  (b) real sharding and a real pipeline in two processes sharing the card
  over gloo (`tools/dryrun_multichip.spawn`: each process is started with
  a time limit and killed on it, which fails the phase)."""
  from small_vision_tpu_torch.parallel import pipeline as pl
  from small_vision_tpu_torch.tools import dryrun_multichip
  torch.cuda.empty_cache()
  # (a)'s two processes run while this process computes (b)'s references
  # and (b)'s two processes run.
  production = _in_thread(_parallel_production, card)
  out = {}

  tmp = tempfile.mkdtemp(prefix="sv_parallel_b_")
  try:
    plan = os.path.join(tmp, "plan.npz")
    _parallel_plan(plan)
    # The single-process references on the card, then the two processes.
    ref = _fsdp_run(plan, 0, 1, "cuda")
    ref_pipe = _pipe_step(plan, "cuda")
    torch.cuda.empty_cache()
    if then is not None:  # phase tensor's start, beside (b)
      then()
    t0 = time.perf_counter()
    dryrun_multichip.spawn("chip_smoke:parallel_worker", 2, args=(tmp,),
                           device="cuda", timeout=PARALLEL_TIMEOUT,
                           threads=CHILD_THREADS)
    out["b_s"] = time.perf_counter() - t0
    fsdp = [torch.load(os.path.join(tmp, f"fsdp_rank{r}.pt"))
            for r in range(2)]
    placed = {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"))
                     for r in range(2)] for name in PLACEMENTS}
    pipe = [torch.load(os.path.join(tmp, f"pipe_rank{r}.pt"))
            for r in range(2)]
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  out["a"] = production()

  # (b) fsdp=2 and the two other placements against one process at batch
  # 256: phase model's loss bound (1e-2 relative: bf16 predictions summed
  # in another order), the step-1 gradients (from Adam's nu) within its
  # leaf-relative 5e-2 (also tests/test_torch_train_step.py's bf16 bound),
  # and the parameters after the last step: 98 % of the elements within 1 %
  # of lr, every one within 4 lr. That is not test_torch_train_step's bound
  # (5 % of lr for every element, f32 against JAX at width 64): here the
  # step runs in bf16 at full width, and an element whose step-1 gradient
  # is below the bf16 round-off of its leaf's largest gradient has no sign
  # of its own, so Adam's normalised step (about lr) may go either way in
  # either run; two steps at lr > 0 move it by 4 lr at most (the run
  # takes one: step 1 runs at lr 0). The phase
  # prints the worst element, both runs' step-1 gradient there and that
  # round-off (NVIDIA H100 80GB HBM3, 700 W: 1.028 lr at most, 99.03 %
  # within 1 % of lr, at an element whose step-1 gradient, 4.3e-7, is
  # below its leaf's bf16 spacing of 6.1e-5).
  per_step = _times(BLOCK_TRAIN_LAUNCHES_REMAT["nothing_saveable"],
                    2 * BLOCKS * PARALLEL_STEPS)
  b2 = 0.95
  g_ref = [torch.sqrt(v / (1 - b2)) for v in ref["nu1"]]
  lr = 15e-5 * TRAIN_BATCH / 256
  for r, got in [(r, g) for r, g in enumerate(fsdp)] + [
      (f"{r} {name}", g) for name, gs in placed.items()
      for r, g in enumerate(gs)]:
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        ref["losses"]))
    g_got = [torch.sqrt(v / (1 - b2)) for v in got["nu1"]]
    g_rel = _leaf_rel(g_got, g_ref)
    diff = torch.cat([(p - q).abs().flatten() for p, q in zip(
        got["params"], ref["params"])])
    _worst_element(got, ref, g_got, g_ref, lr, r, card)
    print(f"[parallel] (b) fsdp=2 process {r} ({got['transport']}): "
          f"state {got['state_gb']:.3f} GB, the placement says "
          f"{got['expect_bytes'] / 1e9:.3f} (one process "
          f"{ref['state_gb']:.3f})", flush=True)
    if abs(got["state_gb"] * 1e9 - got["expect_bytes"]) > 0.5:
      fail(f"parallel (b) process {r}: state bytes "
           f"{got['state_gb'] * 1e9:.0f} != the placement's "
           f"{got['expect_bytes']}")
    print(f"[parallel] (b) fsdp=2 process {r} ({got['transport']}): losses "
          f"{got['losses']} (one process {ref['losses']}, worst rel "
          f"{loss_rel:.2e}); step-1 gradients worst leaf-relative "
          f"{g_rel:.3e}; step-{PARALLEL_STEPS} parameters: max |diff| "
          f"{diff.max().item() / lr:.3f} lr, {(diff <= 1e-2 * lr).float().mean().item() * 100:.2f} % "
          f"within 1 % of lr; launches {got['launches']}; peak "
          f"{got['peak_gb']:.2f} GB (one process {ref['peak_gb']:.2f}); "
          f"parameters and optimizer state {got['state_gb']:.3f} GB (one "
          f"process {ref['state_gb']:.3f}); steps {got['step_ms']} ms, of "
          f"which collectives {got['coll_ms']} ms; host clock, two "
          f"processes time-slicing one card; on {card}", flush=True)
    if not loss_rel <= 1e-2:
      fail(f"parallel (b) fsdp=2: losses differ by {loss_rel:.2e}")
    if not g_rel <= 5e-2:
      fail(f"parallel (b) fsdp=2: step-1 gradients differ by {g_rel:.3e}")
    if got["launches"] != per_step:
      fail(f"parallel (b) fsdp=2 process {r}: launches {got['launches']} "
           f"!= {per_step}")
    if not (diff.max().item() <= 4 * lr
            and (diff <= 1e-2 * lr).float().mean().item() >= 0.98):
      fail(f"parallel (b) fsdp=2: parameters differ by "
           f"{diff.max().item() / lr:.3f} lr")
    if r in (0, 1) and not got["state_gb"] < 0.6 * ref["state_gb"]:
      fail(f"parallel (b) fsdp=2: process {r} holds {got['state_gb']:.3f} "
           f"GB of state, one process {ref['state_gb']:.3f}")
  for gs in [fsdp] + list(placed.values()):
    if not all(torch.equal(p, q) for p, q in zip(gs[0]["params"],
                                                  gs[1]["params"])):
      fail("parallel (b): the two processes end with other parameters")

  # (b) pipe=2 against the unpipelined scan=True step: phase model's
  # bounds (forward 3e-2 of the largest |pred|, loss 1e-2 relative,
  # gradients 5e-2 leaf-relative).
  ticks = PIPE_MICROBATCHES + 1
  per_rank = {k: v * ticks * BLOCKS // 2 for k, v in (
      BLOCK_SAMPLE_LAUNCHES["pallas"].items())}
  for k, v in BLOCK_TRAIN_LAUNCHES_REMAT["nothing_saveable"].items():
    per_rank[k] = per_rank.get(k, 0) + 2 * v * ticks * BLOCKS // 2
  scale = ref_pipe["pred"].abs().max().item()
  for r, got in enumerate(pipe):
    err = (got["pred"] - ref_pipe["pred"]).abs().max().item()
    loss_rel = abs(got["loss"] - ref_pipe["loss"]) / abs(ref_pipe["loss"])
    g_rel = _leaf_rel(got["grads"], ref_pipe["grads"])
    print(f"[parallel] (b) pipe=2 process {r} ({got['transport']}), "
          f"{PIPE_MICROBATCHES} microbatches, bubble "
          f"{pl.bubble_fraction(2, PIPE_MICROBATCHES):.4f}: forward max abs "
          f"err {err:.3e} of {scale:.3e}; loss {got['loss']:.6f} (scan=True "
          f"{ref_pipe['loss']:.6f}, rel {loss_rel:.2e}); gradients worst "
          f"leaf-relative {g_rel:.3e}; launches {got['launches']} (model "
          f"says {per_rank}); on {card}", flush=True)
    if not err <= 3e-2 * scale:
      fail(f"parallel (b) pipe=2: forward differs by {err:.3e}")
    if not loss_rel <= 1e-2:
      fail(f"parallel (b) pipe=2: loss differs by {loss_rel:.2e}")
    if not g_rel <= 5e-2:
      fail(f"parallel (b) pipe=2: gradients differ by {g_rel:.3e}")
    if got["launches"] != per_rank:
      fail(f"parallel (b) pipe=2 process {r}: launches {got['launches']} "
           f"!= {per_rank}")
  out.update(ref=ref, fsdp=fsdp, pipe=pipe, placed=placed)
  return out


# ---------------------------------------------------------------------------
# Phase tensor: tensor parallelism (the Megatron block) on the one card.

TENSOR_BATCH = 64           # the collectives go through the host over gloo
TENSOR_STEPS = 2             # within the script's time limit
TENSOR_FSDP_STEPS = 2
TENSOR_HEADS = HEADS // 2   # a rank's heads at T = 2
# The trainer's loss bound against one process (tests/test_fsdp_equivalence.py).
TENSOR_RTOL, TENSOR_ATOL = 2e-4, 1e-5
TENSOR_CASES = {
    # name: (processes, attn_impl, steps, the config's placement, with val)
    "a": (2, "pallas", TENSOR_STEPS,
          dict(mesh_tensor=2, param_sharding="tensor_parallel"), True),
    "b": (2, "pallas_fused", TENSOR_STEPS,
          dict(mesh_tensor=2, param_sharding="tensor_parallel"), False),
    "c": (4, "pallas", TENSOR_FSDP_STEPS,
          dict(mesh_fsdp=2, mesh_tensor=2, param_sharding="tp_fsdp",
               optim_sharding="tp_fsdp"), False),
}


def _tensor_config(attn_impl, steps, placement, with_val):
  """UMD-B/4@64 at full width and depth at batch TENSOR_BATCH, with
  `placement`; `val` alone (2 batches) at the last step, or no
  evaluators."""
  from small_vision_tpu_torch.configs import ae_i1k
  config = ae_i1k.get_config(
      f"variant=B/4,size=64,data=synthetic,batch_size={TENSOR_BATCH},"
      f"total_steps={steps},log_steps=1,attn_impl={attn_impl},"
      f"eval_steps={steps if with_val else -1}")
  if with_val:
    config["evals"] = {"val": dict(config["evals"]["val"], num_batches=2)}
  config.update(placement, save_ckpt=False)
  return config


def _tensor_run(plan_path, index, count, device, case, mesh=None,
                workdir=None):
  """Case `case` of TENSOR_CASES through `train_and_evaluate` on the
  plan's batch (this process's rows, `_injected_trainer`), one process
  without a `mesh`. Returns the losses, the launches, the head counts and
  projection shapes the kernels ran on, the state bytes held and those the
  layout's placements give, the step times, the host time of the
  collectives a step (each bracketed by device synchronisations), and the
  `val` metrics (on the process that writes them)."""
  from small_vision_tpu_torch.ops import _build as build
  from small_vision_tpu_torch.ops import attention as attn_lib
  from small_vision_tpu_torch.ops import fused_block as fb_lib
  from small_vision_tpu_torch.parallel import collectives
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  from small_vision_tpu_torch.parallel import sharding as sharding_lib
  from small_vision_tpu_torch.train import train_ae
  _, attn_impl, steps, placement, with_val = TENSOR_CASES[case]
  plan = dict(np.load(plan_path))
  record = {"coll_ms": [], "shapes": set()}
  make, restore = _injected_trainer(plan, index, count, record,
                                    batch=TENSOR_BATCH, time_layout=False)
  wrapped = []

  def wrap(module, name, note):
    orig = getattr(module, name)

    def call(*a):
      record["shapes"].add(note(*a))
      return orig(*a)
    setattr(module, name, call)
    wrapped.append((module, name, orig))
  wrap(attn_lib, "attention_packed_fwd", lambda q, k, v, h: ("K3 heads", h))
  wrap(attn_lib, "attention_packed_bwd",
       lambda q, k, v, do, h: ("K4 heads", h))
  wrap(fb_lib, "fused_mha_fwd", lambda x, wq, *a: (
      "K6 heads, x, wq, wo", a[-1], tuple(x.shape[-1:]), tuple(wq.shape),
      tuple(a[-3].shape)))
  wrap(fb_lib, "fused_mlp_fwd", lambda x, w1, b1, w2, b2: (
      "K5 w1, w2", tuple(w1.shape), tuple(w2.shape)))
  for name in ("all_reduce", "all_gather", "reduce_scatter"):
    orig = getattr(collectives, name)

    def timed(*a, _orig=orig, **kw):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = _orig(*a, **kw)
      torch.cuda.synchronize()
      if record.get("in_step"):
        record["coll_ms"][-1] += (time.perf_counter() - t0) * 1e3
      return out
    setattr(collectives, name, timed)
    wrapped.append((collectives, name, orig))
  orig_make = train_ae.make_update_fn

  def make_counted(*a, **kw):
    update = make(*a, **kw)

    def update_fn(*b, **bkw):
      record["coll_ms"].append(0.0)
      record["in_step"] = True
      try:
        return update(*b, **bkw)
      finally:
        record["in_step"] = False
        record["train_launches"] = dict(build.LAUNCHES)
    return update_fn
  train_ae.make_update_fn = make_counted
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  build.reset_launches()
  config = _tensor_config(attn_impl, steps, placement, with_val)
  if mesh is None:  # one process: no placement
    for key in placement:
      config.pop(key)
  try:
    state, history = train_ae.train_and_evaluate(
        config, workdir, device=device, log=lambda s: None, mesh=mesh)
  finally:
    train_ae.make_update_fn = orig_make
    restore()
    for module, name, orig in wrapped:
      setattr(module, name, orig)
  launches = dict(build.LAUNCHES)
  layout = record["layout"]
  opt = state["opt"]
  state_bytes = sum(t.numel() * t.element_size() for t in (
      list(state["params"]) + list(opt["mu"]) + list(opt["nu"])))
  if layout is None:
    n_params = n_opt = sum(int(p.numel()) for p in state["params"])
  else:
    n_params = sum(int(np.prod(sharding_lib.shard_shape(f, sp, mesh)))
                   for f, sp in zip(layout.full_shapes, layout.specs))
    n_opt = sum(int(np.prod(s)) for s in layout.opt_shapes())
  val = {}  # process 0 writes the metrics
  metrics = os.path.join(workdir or "", "sv_tpu_metrics.txt")
  if with_val and mesh_lib.process_index() == 0 and os.path.exists(metrics):
    with open(metrics) as f:
      for line in f:
        row = json.loads(line)
        val.update({k: v for k, v in row.items() if k.startswith("val/")})
  return {"losses": [float(m["training_loss"]) for m in record["meas"]],
          "launches": launches, "train_launches": record["train_launches"],
          "shapes": sorted(record["shapes"]),
          "state_bytes": state_bytes,
          "expect_bytes": 4 * n_params + (2 + 4) * n_opt,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "step_ms": [h["ms"] for h in history],
          "coll_ms": record["coll_ms"], "val": val}


def tensor_worker(rank, n, device, tmp):
  """A process of phase tensor: the cases of TENSOR_CASES with n
  processes; writes each one's results to `tmp`."""
  from small_vision_tpu_torch.parallel import collectives
  from small_vision_tpu_torch.train import train_ae
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  keep_draws()  # its cases start from one tree
  for case, (procs, attn_impl, steps, placement, with_val) in (
      TENSOR_CASES.items()):
    if procs != n:
      continue
    config = _tensor_config(attn_impl, steps, placement, with_val)
    mesh = train_ae.build_mesh(config)
    workdir = os.path.join(tmp, f"work_{case}") if with_val else None
    out = _tensor_run(os.path.join(tmp, "plan.npz"), *mesh.batch_shard(),
                      device, case, mesh, workdir)
    out["mesh"] = dict(mesh.shape)
    out["transport"] = collectives.transport(mesh.group("tensor"))
    torch.save(out, os.path.join(tmp, f"tensor_{case}_rank{rank}.pt"))
    del out
    torch.cuda.empty_cache()


def tensor_start(build):
  """Phase tensor's first half: the one-process references on the card in
  this process, then the two-process and the four-process set started at
  once (each timed from its start), beside phase parallel's (b). Returns
  the join that waits for them: (references, the processes' results,
  their seconds)."""
  from small_vision_tpu_torch.tools import dryrun_multichip
  tmp = tempfile.mkdtemp(prefix="sv_tensor_")
  try:
    plan = os.path.join(tmp, "plan.npz")
    _parallel_plan(plan, TENSOR_BATCH, TENSOR_STEPS)
    ref = {case: _tensor_run(plan, 0, 1, "cuda", case,
                             workdir=os.path.join(tmp, f"single_{case}"))
           for case in ("a", "b")}
    torch.cuda.empty_cache()
  except BaseException:
    shutil.rmtree(tmp, ignore_errors=True)
    raise

  def run(n):
    t0 = time.perf_counter()
    dryrun_multichip.spawn("chip_smoke:tensor_worker", n, args=(tmp,),
                           device="cuda", timeout=PARALLEL_TIMEOUT,
                           threads=CHILD_THREADS)
    return time.perf_counter() - t0
  joins = {n: _in_thread(run, n) for n in (2, 4)}

  def join():
    try:
      seconds = {n: j() for n, j in joins.items()}
      got = {case: [torch.load(os.path.join(tmp, f"tensor_{case}_rank{r}.pt"),
                               weights_only=False) for r in range(procs)]
             for case, (procs, *_) in TENSOR_CASES.items()}
    finally:
      shutil.rmtree(tmp, ignore_errors=True)
    return ref, got, seconds
  return join


def phase_tensor(build, card, started):
  """Phase tensor: UMD-B/4@64 at full width and depth under
  `tensor_parallel` (T = 2, the Megatron block: K1-K4 on a rank's 6 heads,
  K5/K6 on its shard under "pallas_fused") in two processes sharing the
  card over gloo, and under `tp_fsdp` (fsdp 2 x tensor 2) in four, each
  against the one-process run on the card: the losses within
  tests/test_fsdp_equivalence.py's bound, equal on the tensor ranks of a
  batch shard, the launches per process those of one process, the head
  counts and shard shapes the kernels ran on, the state bytes equal to the
  placement's, and (a)'s `val` equal to one process's. `started`: the join
  of `tensor_start`."""
  ref, got, seconds = started()
  ref["c"] = ref["a"]  # the same one-process run; (c) takes 2 of its steps
  for case, (procs, attn_impl, steps, placement, with_val) in (
      TENSOR_CASES.items()):
    want = ref[case]
    per_step = _times(BLOCK_TRAIN_LAUNCHES[attn_impl], 2 * BLOCKS * steps)
    for r, g in enumerate(got[case]):
      losses, ref_losses = np.array(g["losses"]), np.array(
          want["losses"][:steps])
      worst = float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses)))
      coll = [c / m for c, m in zip(g["coll_ms"], g["step_ms"])]
      print(f"[tensor] ({case}) {attn_impl} mesh {g['mesh']} process {r} "
            f"({g['transport']}): losses {g['losses']} (one process "
            f"{want['losses'][:steps]}, worst rel {worst:.2e}); launches "
            f"in the steps {g['train_launches']}, in all {g['launches']}; "
            f"kernels ran on {g['shapes']}; state "
            f"{g['state_bytes']} bytes, the placement says "
            f"{g['expect_bytes']} (one process {want['state_bytes']}); "
            f"peak {g['peak_gb']:.2f} GB; steps "
            + ", ".join(f"{m:.1f}" for m in g["step_ms"])
            + " ms, collectives " + ", ".join(f"{c:.1f}" for c in g["coll_ms"])
            + " ms (" + ", ".join(f"{c * 100:.1f}" for c in coll)
            + f" %; host clock, {procs} processes time-slicing the card); "
            f"on {card}", flush=True)
      np.testing.assert_allclose(losses, ref_losses, rtol=TENSOR_RTOL,
                                 atol=TENSOR_ATOL,
                                 err_msg=f"phase tensor ({case}) losses")
      partner = got[case][r ^ 1]  # the other tensor rank of its batch shard
      if g["losses"] != partner["losses"]:
        fail(f"tensor ({case}): tensor ranks {r} and {r ^ 1} disagree")
      if g["train_launches"] != per_step:
        fail(f"tensor ({case}) process {r}: the steps' launches "
             f"{g['train_launches']} != {per_step}")
      if with_val and g["launches"] != want["launches"]:
        fail(f"tensor ({case}) process {r}: launches with val "
             f"{g['launches']} != one process's {want['launches']}")
      heads = {s[1] for s in g["shapes"] if s[0].startswith(("K3", "K4"))}
      if heads != {TENSOR_HEADS}:
        fail(f"tensor ({case}): K3/K4 ran on {heads} heads")
      if attn_impl == "pallas_fused":
        hd = TENSOR_HEADS * 64
        k6 = {s[1:] for s in g["shapes"] if s[0].startswith("K6")}
        k5 = {s[1:] for s in g["shapes"] if s[0].startswith("K5")}
        if k6 != {(TENSOR_HEADS, (WIDTH,), (WIDTH, hd), (hd, WIDTH))}:
          fail(f"tensor ({case}): K6 ran on {k6}")
        if k5 != {((WIDTH, MLP_DIM // 2), (MLP_DIM // 2, WIDTH))}:
          fail(f"tensor ({case}): K5 ran on {k5}")
      if g["state_bytes"] != g["expect_bytes"]:
        fail(f"tensor ({case}) process {r}: state bytes {g['state_bytes']} "
             f"!= the placement's {g['expect_bytes']}")
      if not g["state_bytes"] < want["state_bytes"]:
        fail(f"tensor ({case}): process {r} holds no less than one process")
      if with_val and r == 0:
        print(f"[tensor] ({case}) val: {g['val']} (one process "
              f"{want['val']}) on {card}", flush=True)
        if not g["val"] or sorted(g["val"]) != sorted(want["val"]):
          fail(f"tensor ({case}): val gave {g['val']}, one process "
               f"{want['val']}")
        for k, v in want["val"].items():
          np.testing.assert_allclose(g["val"][k], v, rtol=TENSOR_RTOL,
                                     atol=TENSOR_ATOL,
                                     err_msg=f"phase tensor val {k}")
  print(f"[tensor] two processes {seconds[2]:.1f} s, four {seconds[4]:.1f} "
        f"s from their start, the six at once and beside phase parallel's "
        f"(b); on {card}", flush=True)
  return {"ref": ref, "got": got, "seconds": seconds}


def _bf16_spacing(x):
  """The spacing of bf16 numbers at |x| (2^-7 of its power of two)."""
  return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 0.0


def _worst_element(got, ref, g_got, g_ref, lr, r, card):
  """The leaf and element whose step-3 parameter differs most between a
  run and one process, both runs' step-1 gradient there (|g| from Adam's
  nu) and the bf16 spacing at that leaf's largest gradient and parameter:
  a gradient below the former is round-off, with no sign of its own."""
  best = (-1.0, None, None)
  for i, (p, q) in enumerate(zip(got["params"], ref["params"])):
    d = (p - q).abs()
    if d.max().item() > best[0]:
      best = (d.max().item(), i, int(d.argmax()))
  d, i, flat = best
  name = (got.get("names") or [str(i)])[i] if got.get("names") else str(i)
  gg, gr = g_got[i].flatten()[flat].item(), g_ref[i].flatten()[flat].item()
  g_top = g_ref[i].abs().max().item()
  p_top = ref["params"][i].abs().max().item()
  spacing = _bf16_spacing(g_top)
  print(f"[parallel] (b) process {r}: worst element {name}[{flat}] "
        f"(of {ref['params'][i].numel()}), {d / lr:.3f} lr; step-1 |grad| "
        f"there {gg:.3e} (one process {gr:.3e}); the leaf's largest |grad| "
        f"{g_top:.3e}, bf16 spacing there {spacing:.3e}; its largest |param| "
        f"{p_top:.3e}, bf16 spacing {_bf16_spacing(p_top):.3e}: "
        + ("round-off (the gradient is below the spacing)" if max(gg, gr)
           < spacing else "NOT round-off")
        + f" on {card}", flush=True)


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs on the GPU only",
          file=sys.stderr)
    return 1
  from small_vision_tpu_torch.ops import _build as build
  from small_vision_tpu_torch.ops import attention as attn
  from small_vision_tpu_torch.ops import fused_block as fb
  from small_vision_tpu_torch.ops import layernorm as ln

  # f32 comparisons on the card stay in full f32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  print(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {card}", flush=True)

  phase_build(build)
  mark("build")
  keep_draws()
  kernels = [check_ln(ln, card), check_attention(attn, card),
             check_ln_bwd(ln, card), check_attention_bwd(attn, card),
             check_fused_mlp(fb, card), check_fused_mha(fb, card),
             check_attention_unpacked(attn, card),
             check_attention_unpacked_bwd(attn, card),
             check_attention_ablate(attn, card)]
  mark("kernels at the model's shapes")
  # UMD-L/2's width: K1-K4 at the latent sampler's shapes and the latent
  # step's per-branch batch, K6 at the sampler's shapes.
  b_latent = LATENT_BATCH // 2
  wide = [check_ln(ln, card, L2_WIDTH, b_latent),
          check_attention(attn, card, L2_WIDTH, L2_HEADS, b_latent),
          check_ln_bwd(ln, card, L2_WIDTH, b_latent),
          check_attention_bwd(attn, card, L2_WIDTH, L2_HEADS, b_latent),
          check_fused_mha(fb, card, L2_WIDTH, L2_HEADS, FUSED_SHAPES[:2])]
  # K6 on a tensor rank's 6 of 12 heads at width 768 (phase tensor's
  # shard), at the sampler's shape and the decoder's training shape.
  k6_rank = check_fused_mha(fb, card, WIDTH, HEADS, ((BATCH, SEQ_ENC),
                                                     (128, SEQ_DEC)),
                            rank_heads=HEADS // 2)
  for k in kernels:
    if k["name"] == k6_rank["name"]:
      k[f"tensor_rank_{HEADS // 2}_heads"] = {
          key: v for key, v in k6_rank.items()
          if key not in ("name", "route", "source", "replaces")}
    for w in wide:
      if w["name"] == k["name"]:
        k[f"width_{L2_WIDTH}"] = {
            key: v for key, v in w.items()
            if key not in ("name", "route", "source", "replaces")}
  # The settings' shapes (phase settings): K1 and K2 at UMD-S's width 384
  # and runlocal's 64, timed; at 32 (the probe's quick config) and 1,664
  # (ViT-G), checked. K3 and K4 at PACKED_HEAD_DIMS: head dims 128, 192
  # and 256 (heads=6, 4 and 3 at width 768), timed beside SDPA; at 8, 16,
  # 80, 104, 136, 200 and 248, checked. Each at the sampler's and the
  # training shapes.
  mark("kernels at width 1,024 and a rank's heads")
  more = {}
  for width, timed in ((384, True), (64, True), (32, False), (1664, False)):
    more[f"width_{width}"] = {
        ln.NAME: check_ln(ln, card, width, timed=timed),
        ln.BWD_NAME: check_ln_bwd(ln, card, width, timed=timed)}
  for width, heads, timed in PACKED_HEAD_DIMS:
    more[f"head_dim_{width // heads}"] = {
        attn.NAME: check_attention(attn, card, width, heads, timed=timed),
        attn.BWD_NAME: check_attention_bwd(attn, card, width, heads,
                                           timed=timed)}
  # K6-K9 at head dims 80, 128, 192 and 256 (timed; K9's arms at the
  # tool's two shapes, at 192 and 256 at all four) and 8, 16, 88, 104,
  # 136, 200 and 248 (checked).
  for head_dim, heads, timed in WIDE_HEAD_DIMS:
    width = heads * head_dim
    k6_shapes = WIDE_SHAPES + (((BATCH, 256),) if head_dim == 80 else ())
    more.setdefault(f"head_dim_{head_dim}", {}).update({e["name"]: e for e in (
        check_fused_mha(fb, card, width, heads, k6_shapes, timed=timed),
        check_attention_unpacked(attn, card, width, heads, WIDE_SHAPES, timed),
        check_attention_unpacked_bwd(attn, card, width, heads, WIDE_SHAPES,
                                     timed),
        check_attention_ablate(
            attn, card, width, heads, WIDE_SHAPES, timed,
            timed_shapes=WIDE_SHAPES if head_dim > 128 else ABLATE_SHAPES))})
  # K6 at ViT-mu's width 32 in 2 heads of 16 at ViT-mu/16@224's shapes,
  # and on a tensor rank's narrow shards at width 384 (NARROW_SHARDS).
  more["width_32_2x16"] = {fb.MHA_NAME: check_fused_mha(
      fb, card, 32, 2, VIT_MU_SHAPES)}
  for heads, rank in NARROW_SHARDS:
    more[f"tensor_rank_{rank}_of_{heads}_heads_width_384"] = {
        fb.MHA_NAME: check_fused_mha(fb, card, 384, heads,
                                     NARROW_SHARD_SHAPES, rank_heads=rank)}
  mark("kernels at the widths and head dims")
  # The long heads: "long_<heads>x<head dim>" in the kernels line.
  for width, heads, shapes in LONG_ATTENTION:
    more[f"long_{heads}x{width // heads}"] = {e["name"]: e for e in (
        check_attention(attn, card, width, heads, shapes=shapes),
        check_fused_mha(fb, card, width, heads, shapes),
        check_attention_unpacked(attn, card, width, heads, shapes),
        check_attention_ablate(attn, card, width, heads, shapes,
                               timed_shapes=shapes))}
  # Head dim 256 (`heads=3`) at the long lengths, every attention kernel,
  # checked; K6 at UMD-L's width 1,024 in 4 heads of 256, checked.
  width, heads, shapes = WIDE_LONG
  more[f"long_{heads}x{width // heads}"] = {
      attn.NAME: check_attention(attn, card, width, heads, timed=False,
                                 shapes=shapes),
      attn.BWD_NAME: check_attention_bwd(attn, card, width, heads,
                                         timed=False, shapes=shapes),
      fb.MHA_NAME: check_fused_mha(fb, card, width, heads, shapes=shapes,
                                   timed=False),
      attn.UNPACKED_NAME: check_attention_unpacked(
          attn, card, width, heads, shapes=shapes, timed=False),
      attn.UNPACKED_BWD_NAME: check_attention_unpacked_bwd(
          attn, card, width, heads, shapes=shapes, timed=False),
      attn.ABLATE_NAME: check_attention_ablate(
          attn, card, width, heads, shapes=shapes, timed=False)}
  more["width_1024_4x256"] = {fb.MHA_NAME: check_fused_mha(
      fb, card, L2_WIDTH, 4, FUSED_SHAPES[:1], timed=False)}
  mark("kernels at the long lengths")
  # Past head dim 256: "head_dim_<D>" (WIDER_HEAD_DIMS) and "long_1x<D>"
  # (WIDER_LONG) in the kernels line.
  for head_dim, heads, timed in WIDER_HEAD_DIMS:
    more[f"head_dim_{head_dim}"] = _wide_head_entries(
        attn, fb, card, heads * head_dim, heads,
        WIDER_TIMED if timed else (),
        WIDER_CHECKED if timed else WIDER_CHECK_SHAPES,
        None if head_dim == 520 else ("prod", "exp2"))
  for head_dim, lens in WIDER_LONG:
    more[f"long_1x{head_dim}"] = _wide_head_entries(
        attn, fb, card, head_dim, 1, (), tuple((1, l) for l in lens),
        ("prod", "exp2"))
  mark("kernels past head dim 256")
  # K1-K4 in f32 at the main path's shapes (phase f32's), timed beside
  # their bounds (f32: 67 TFLOP/s or 3.35 TB/s), plain versions and
  # library calls in f32: "*_f32" in the kernels line.
  f32 = torch.float32
  kernels += [check_ln(ln, card, dtype=f32),
              check_attention(attn, card, dtype=f32),
              check_ln_bwd(ln, card, dtype=f32),
              check_attention_bwd(attn, card, dtype=f32)]
  # K1 and K2 at the widths the bf16 instances do not take, in bf16 and
  # f32 ("width_<D>" in the kernels line), and f32 K3/K4 at head dims 12,
  # 192 and 768 ("head_dim_<D>").
  for width, timed in NEW_LN_WIDTHS:
    for dtype in (torch.bfloat16, f32):
      more.setdefault(f"width_{width}", {}).update({
          _named(ln.NAME, dtype): check_ln(ln, card, width, timed=timed,
                                           dtype=dtype,
                                           shapes=NEW_WIDTH_SHAPES),
          _named(ln.BWD_NAME, dtype): check_ln_bwd(
              ln, card, width, timed=timed, dtype=dtype,
              seqs=(SEQ_DEC,))})
  for width, heads, shapes in F32_HEAD_DIMS:
    more.setdefault(f"head_dim_{width // heads}", {}).update({
        attn.NAME_F32: check_attention(attn, card, width, heads,
                                       timed=False, shapes=shapes,
                                       dtype=f32),
        attn.BWD_NAME_F32: check_attention_bwd(attn, card, width, heads,
                                               timed=False, shapes=shapes,
                                               dtype=f32),
        attn.UNPACKED_NAME_F32: check_attention_unpacked(
            attn, card, width, heads, shapes, False, f32),
        attn.UNPACKED_BWD_NAME_F32: check_attention_unpacked_bwd(
            attn, card, width, heads, shapes, False, f32)})
  mark("kernels K1-K4 in f32")
  # K5-K8 in f32 at the main path's shapes (phase f32's "pallas_fused"
  # and phase unpacked's f32 call), timed beside their f32 bounds, plain
  # versions and library calls (F.linear, tanh gelu, F.linear; SDPA
  # between F.linear projections; SDPA and its backward; all in f32, TF32
  # off); K5 also at 36 -> 150, unpadded. K6 in f32 at `heads=32`'s head
  # dim 12 at UMD-S's 384, at `heads=2`'s 384 (past 256) and on a tensor
  # rank's 6 of 12 heads (non-square projections), checked.
  kernels += [check_fused_mlp(fb, card, f32, FUSED_SHAPES_MLP_F32),
              check_fused_mha(fb, card, shapes=WIDE_SHAPES, dtype=f32),
              check_attention_unpacked(attn, card, shapes=UNPACKED_SHAPES_F32,
                                       dtype=f32),
              check_attention_unpacked_bwd(attn, card, dtype=f32)]
  for key, width, heads, rank in (("head_dim_12", 384, 32, None),
                                  ("head_dim_384", WIDTH, 2, None),
                                  (f"tensor_rank_{HEADS // 2}_heads", WIDTH,
                                   HEADS, HEADS // 2)):
    more.setdefault(key, {})[fb.MHA_NAME_F32] = check_fused_mha(
        fb, card, width, heads, NEW_WIDTH_SHAPES, rank_heads=rank,
        timed=False, dtype=f32)
  gc.collect()
  torch.cuda.empty_cache()  # the plain versions' (B, H, L, L) scores
  check_refused_head_dims(attn, fb, build)
  for k in kernels:
    for key, entries in more.items():
      if k["name"] in entries:
        k[key] = {n: v for n, v in entries[k["name"]].items()
                  if n not in ("name", "route", "source", "replaces")}
  mark("kernels")
  for attn_impl in ATTN_IMPLS:
    phase_model(build, card, attn_impl)
  for label, attn_impl, extra, model, per_block, rate in MODEL_SETTINGS:
    phase_model(build, card, attn_impl, label, extra, model, per_block,
                rate)
  mark("model")
  train = {a: phase_train(build, card, a, windows=True) for a in ATTN_IMPLS}
  mark("train")
  settings = phase_settings(build, card)
  mark("settings")
  classifier = phase_classifier(build, card, settings)
  mark("classifier")
  serve = {"pallas": phase_serve(build, card),
           "pallas_fused": phase_sample_call(build, card, "pallas_fused",
                                             windows=True)}
  mark("serve")
  by_heads = phase_heads(build, card)
  mark("heads")
  shapes = phase_shapes(build, card, settings)
  mark("shapes")
  by_f32 = phase_f32(build, card)
  mark("f32")
  data = phase_data(build, card, train["pallas"])
  mark("data")
  unpacked = phase_unpacked(build, attn, card)
  unpacked_f32 = phase_unpacked(build, attn, card, torch.float32)
  ablate = phase_ablate(build, attn, card)
  mark("unpacked, ablate")
  backbone = tempfile.mkdtemp(prefix="sv_backbone_")
  try:
    resume = phase_resume(build, card, train["pallas"]["img_per_s"],
                          backbone)
    mark("resume")
    quant = phase_quant(build, card, train, serve)
    mark("quant")
    ref_stats = os.path.join(backbone, "fid_ref.npz")
    evals = phase_evals(build, card, keep_ref=ref_stats)
    mark("evals")
    eval_o = phase_eval_only(build, card, backbone, ref_stats)
    export = phase_export(build, card, backbone)
    mark("eval_only, export")
    latent = phase_latent(build, card)
    latent_pre = phase_latent_pre(build, card, latent["train"])
    mark("latent")
    probe = phase_probe(build, card, backbone)
  finally:
    shutil.rmtree(backbone, ignore_errors=True)
  _DRAWN.clear()  # host memory for the processes below
  started = {}
  parallel = phase_parallel(
      build, card, then=lambda: started.update(tensor=tensor_start(build)))
  mark("probe, parallel")
  tensor = phase_tensor(build, card, started["tensor"])
  mark("tensor")
  for k in kernels:
    # Launches on the paths driven above, each counted from 0: the sampler
    # call and the training run under "pallas", the same two under
    # "pallas_fused", the training run on an arrays source (phase data),
    # `fused_attention` for the two kernels that no module of the model
    # calls, the ablation tool, run A of the resume phase (6 training
    # steps and the two evaluators), the int8 training runs and sampler
    # calls (phase quant), the few-shot probe, classification and the
    # scored sampling evaluator (phase evals), UMD-L/2@256's latent
    # training run and sampler call (phase latent), and the linear probe's
    # resumed run with its evaluator (phase probe), eval_only on phase
    # resume's workdir, the server built from that workdir and the three
    # exported samplers' calls (phase export), and UMD-L/2 trained on
    # precomputed latents (phase latent). `launches` is the largest of
    # them: the count on the path that runs the kernel most.
    name = k["name"]
    k["launches_by_path"] = {
        **{f"serve_{a}": serve[a]["launches"].get(name, 0)
           for a in ATTN_IMPLS},
        **{f"train_{a}_{train[a]['steps']}_steps":
           train[a]["launches"].get(name, 0) for a in ATTN_IMPLS},
        "data": data["launches"].get(name, 0),
        "fused_attention": unpacked.get(name, 0),
        "fused_attention_f32": unpacked_f32.get(name, 0),
        "ablate": ablate.get(name, 0),
        "resume": resume["launches"].get(name, 0),
        **{f"quant_train_{a}_{QUANT_TRAIN}":
           quant["train"][a]["launches"].get(name, 0) for a in ATTN_IMPLS},
        **{f"quant_serve_{a}_{QUANT_SAMPLE}":
           quant["serve"][a]["launches"].get(name, 0) for a in ATTN_IMPLS},
        **{f"evals_{path}": n.get(name, 0)
           for path, n in evals["launches"].items()},
        f"latent_train_{latent['train']['steps']}_steps":
            latent["train"]["launches"].get(name, 0),
        f"latent_train_pallas_fused_{latent['train_fused']['steps']}_steps":
            latent["train_fused"]["launches"].get(name, 0),
        f"latent_precomputed_{latent_pre['train']['steps']}_steps":
            latent_pre["train"]["launches"].get(name, 0),
        "eval_only": eval_o["launches"].get(name, 0),
        **{f"export_{path}": n.get(name, 0)
           for path, n in export["launches"].items()},
        "latent_sampler": latent["sample"]["launches"].get(name, 0),
        "probe": probe["launches"].get(name, 0),
        f"settings_a_heads6_scan_{settings['a']['steps']}_steps":
            settings["a"]["launches"].get(name, 0),
        "settings_b_sampler_heads6": settings["b"]["launches"].get(name, 0),
        f"settings_c_umd_s_{settings['c']['steps']}_steps":
            settings["c"]["launches"].get(name, 0),
        f"settings_d_runlocal_{RUNLOCAL_STEPS}_steps":
            settings["d"]["launches"].get(name, 0),
        f"settings_e_l2_scan_{SETTINGS_L2_STEPS}_steps":
            settings["e"]["launches"].get(name, 0),
        **{f"classifier_{key.replace(' ', '_').replace('/', '')}_forward":
           got["launches"].get(name, 0)
           for key, got in classifier["timed"].items()},
        "classifier_sampler_heads6_fused":
            classifier["sampler"]["launches"].get(name, 0),
        **{f"heads{h}_train_pallas_{got['train']['steps']}_steps":
           got["train"]["launches"].get(name, 0)
           for h, got in by_heads.items()},
        **{f"heads{h}_sampler_{a}": got[a]["launches"].get(name, 0)
           for h, got in by_heads.items() for a in ATTN_IMPLS},
        f"shapes_umd_s_heads32_train_pallas_{shapes['train']['steps']}_steps":
            shapes["train"]["launches"].get(name, 0),
        **{f"shapes_umd_s_heads32_sampler_{a}":
           shapes[a]["launches"].get(name, 0) for a in ATTN_IMPLS},
        "shapes_vit_mu_forward_pallas_fused":
            shapes["cls"]["launches"].get(name, 0),
        **{f"f32_train_{a}_{by_f32[a]['train']['steps']}_steps":
           by_f32[a]["train"]["launches"].get(name, 0) for a in ATTN_IMPLS},
        **{f"f32_sampler_{a}": by_f32[a]["sampler"]["launches"].get(name, 0)
           for a in ATTN_IMPLS},
        f"parallel_a_nccl_{PARALLEL_STEPS}_steps":
            parallel["a"]["launch"]["launches"].get(name, 0),
        **{f"parallel_b_fsdp2_process{r}_{PARALLEL_STEPS}_steps":
           got["launches"].get(name, 0)
           for r, got in enumerate(parallel["fsdp"])},
        **{f"parallel_b_pipe2_process{r}": got["launches"].get(name, 0)
           for r, got in enumerate(parallel["pipe"])},
        **{f"parallel_b_{p}_process{r}_{PARALLEL_STEPS}_steps":
           got["launches"].get(name, 0)
           for p, gs in parallel["placed"].items()
           for r, got in enumerate(gs)},
        **{f"tensor_{case}_{TENSOR_CASES[case][1]}_process{r}_"
           f"{TENSOR_CASES[case][2]}_steps": got["launches"].get(name, 0)
           for case, gs in tensor["got"].items()
           for r, got in enumerate(gs)}}
    k["launches"] = max(k["launches_by_path"].values())
    if not k["launches"]:
      fail(f"{name} was launched on no path")
  for a in ATTN_IMPLS:
    print(f"[result] {a}: training {qual_text(train[a]['qual'])}, "
          f"{train[a]['ms']:.2f} ms/step at batch {TRAIN_BATCH}; sampler "
          f"{qual_text(serve[a]['qual'])}, {serve[a]['s']:.3f} s a call "
          f"at batch {BATCH}; on {card}", flush=True)
  jpeg = data["jpeg"]
  print(f"[result] data: arrays-fed training {data['img_per_s']:.2f} img/s "
        f"(synthetic-fed {train['pallas']['img_per_s']:.2f}); TrainIterator "
        f"alone {data['host_img_per_s']:.2f} img/s; JPEG decode and crop "
        + (f"{jpeg['img_per_s']:.2f} img/s ({jpeg['decoder']})" if jpeg
           else "not taken (no PIL)")
        + f"; nproc {data['nproc']}; on {card}", flush=True)
  for a in ATTN_IMPLS:
    print(f"[result] quant {a}: training {QUANT_TRAIN} "
          f"{quant['train'][a]['img_per_s']:.2f} img/s (bf16 "
          f"{train[a]['img_per_s']:.2f}); sampler {QUANT_SAMPLE} "
          f"{quant['serve'][a]['fwd_ms']:.2f} ms a forward (bf16 "
          f"{_fwd_ms(serve[a]):.2f}); on {card}", flush=True)
  print("[result] quant int8_dot: " + "; ".join(
      f"{r['shape']}: {r['int8_dot_ms']:.4f} ms (_int_mm "
      f"{r['int_mm_ms']:.4f}), bf16 F.linear {r['linear_ms']:.4f}"
      for r in quant["matmuls"]) + f"; on {card}", flush=True)
  print(f"[result] evals: fewshot {evals['fewshot_s']:.2f} s "
        f"({max(evals['fewshot'].values()):.4f} best), classification "
        f"{evals['classification_s']:.2f} s (prec@1 "
        f"{evals['classification']['prec@1']:.4f}), reference statistics "
        f"{evals['ref_s']:.2f} s, self-FID {evals['self_fid']:.6g}, samples' "
        f"FID {evals['fid']:.4f}, IS {evals['is']:.4f}; on {card}",
        flush=True)

  ex, lp = export, latent_pre
  print(f"[result] eval_only: wall s " + ", ".join(
      f"{n} {v:.2f}" for n, v in eval_o["seconds"].items())
        + f" (all {eval_o['s']:.2f}); FID {eval_o['fid']:.4f}, IS "
        f"{eval_o['is']:.4f}; transfer {min(eval_o['transfer'].values()):.4f}"
        f"-{max(eval_o['transfer'].values()):.4f}; exported sampler "
        + "; ".join(f"{n}: {v['bytes'] / 1e6:.1f} MB, export "
                    f"{v['export_s']:.2f} s, load {v['load_s']:.2f} s"
                    for n, v in ex.items() if n != "launches")
        + f"; baked {qual_text(ex['baked']['qual'])} against live "
        f"{qual_text(ex['baked']['live_qual'])}; on {card}", flush=True)
  print(f"[result] precomputed latents: precompute "
        f"{lp['precompute']['img_per_s']:.2f} img/s; UMD-L/2@{LATENT_SIZE} "
        f"on them at batch {LATENT_BATCH} {qual_text(lp['train']['qual'])}, "
        f"{lp['train']['ms']:.2f} ms/step, peak {lp['train']['peak_gb']:.2f} "
        f"GB (with the encode {qual_text(latent['train']['qual'])}); the "
        f"largest power-of-two batch that fits {lp['largest']}"
        + (f" (out of memory at {lp['oom_at']})" if lp["oom_at"] else "")
        + f"; on {card}", flush=True)
  lt, ls, lf = latent["train"], latent["sample"], latent["train_fused"]
  print(f"[result] latent UMD-L/2@{LATENT_SIZE}: training "
        f"{lt['img_per_s']:.2f} img/s, {lt['ms']:.2f} ms/step at batch "
        f"{LATENT_BATCH}, the VAE encode {lt['encode_ms']:.2f} ms "
        f"({lt['encode_ms'] / lt['ms'] * 100:.1f} %), peak "
        f"{lt['peak_gb']:.2f} GB; under pallas_fused {lf['ms']:.2f} ms/step "
        f"({lf['steps'] - 1} timed), the encode {lf['encode_ms']:.2f} ms; "
        f"sampler {ls['s']:.3f} s a call "
        f"({ls['img_per_s']:.2f} img/s) at batch {BATCH}, the decode "
        f"{ls['decode_s']:.3f} s ({ls['decode_s'] / ls['s'] * 100:.1f} %); "
        f"probe {probe['s']:.2f} s ("
        + ", ".join(f"{k} {v:.4f}" for k, v in probe["evals"].items())
        + f"); on {card}", flush=True)

  sa, sc, se = settings["a"], settings["c"], settings["e"]
  print(f"[result] settings: (a) UMD-B/4@64 heads=6,scan=True "
        f"{qual_text(sa['qual'])}, {sa['ms']:.2f} ms/step, peak "
        f"{sa['peak_gb']:.2f} GB (phase train: "
        f"{train['pallas']['img_per_s']:.2f} img/s, peak "
        f"{train['pallas']['peak_gb']:.2f} GB); (b) sampler heads=6 "
        f"{settings['b']['fwd_ms']:.2f} ms a forward, "
        f"{settings['b']['s']:.3f} s a {SIDE_SAMPLER_STEPS}-step call (12 "
        f"heads: {_fwd_ms(serve['pallas']):.2f}); (c) UMD-S/4@64 "
        f"{qual_text(sc['qual'])}, peak {sc['peak_gb']:.2f} GB; (d) "
        f"runlocal {settings['d']['s']:.2f} s for {RUNLOCAL_STEPS} steps; "
        f"(e) UMD-L/2@{LATENT_SIZE} scan=True batch {se['batch']} "
        f"{se['img_per_s']:.2f} img/s, {se['ms']:.2f} ms/step, peak "
        f"{se['peak_gb']:.2f} GB"
        + (f" (out of memory at {se['oom_at']})" if se["oom_at"] else "")
        + f"; on {card}", flush=True)

  cs = classifier["sampler"]
  print("[result] classifier: " + "; ".join(
      f"ViT-{key} forward {qual_text(got['qual'])} at batch {CLS_BATCH}, "
      f"{got['tflops']:.1f} TFLOP/s, peak {got['peak_gb']:.2f} GB, "
      f"launches {got['launches']}"
      for key, got in classifier["timed"].items())
        + f"; heads=6 sampler under pallas_fused {cs['fwd_ms']:.2f} ms a "
        f"forward ({cs['launches'].get('fused_mha_fwd', 0)} K6 at head dim "
        f"128; pallas {settings['b']['fwd_ms']:.2f}); on {card}", flush=True)

  print("[result] heads: " + "; ".join(
      f"heads={h} (head dim {WIDTH // h}): training under pallas "
      f"{qual_text(got['train']['qual'])}, "
      f"{got['train']['ms']:.2f} ms/step, "
      f"peak {got['train']['peak_gb']:.2f} GB; sampler "
      + ", ".join(f"{a} {got[a]['fwd_ms']:.2f} ms a forward"
                  for a in ATTN_IMPLS)
      for h, got in by_heads.items())
        + f" (12 heads: training {train['pallas']['img_per_s']:.2f} img/s, "
        f"peak {train['pallas']['peak_gb']:.2f} GB; sampler " + ", ".join(
            f"{a} {_fwd_ms(serve[a]):.2f}" for a in ATTN_IMPLS)
        + f"); on {card}", flush=True)

  st, cm = shapes["train"], shapes["cls"]
  print(f"[result] shapes: (a) UMD-S/4@64 heads=32 (head dim 12): training "
        f"under pallas {qual_text(st['qual'])}, {st['ms']:.2f} ms/step, peak "
        f"{st['peak_gb']:.2f} GB; sampler " + ", ".join(
            f"{a} {shapes[a]['fwd_ms']:.2f} ms a forward" for a in ATTN_IMPLS)
        + f" (settings (c) UMD-S/4@64, 6 heads of 64: training "
        f"{settings['c']['img_per_s']:.2f} img/s); (b) ViT-{VIT_MU}@{CLS_SIZE}"
        f" forward under pallas_fused {qual_text(cm['qual'])} at batch "
        f"{CLS_BATCH}, launches {cm['launches']}; on {card}", flush=True)

  ft, fs = by_f32["pallas"]["train"], by_f32["pallas"]["sampler"]
  fft, ffs = by_f32["pallas_fused"]["train"], by_f32["pallas_fused"]["sampler"]
  print(f"[result] f32: UMD-B/4@64 dtype_mm=float32 under pallas: training "
        f"{qual_text(ft['qual'])}, {ft['ms']:.2f} ms/step, peak "
        f"{ft['peak_gb']:.2f} GB (bf16, phase train: "
        f"{train['pallas']['img_per_s']:.2f} img/s, "
        f"peak {train['pallas']['peak_gb']:.2f} GB); sampler "
        f"{fs['fwd_ms']:.2f} ms a forward, {fs['s']:.3f} s a "
        f"{SIDE_SAMPLER_STEPS}-step call (bf16, phase serve: "
        f"{_fwd_ms(serve['pallas']):.2f}); launches a training step "
        + str({k: v // ft["steps"] for k, v in ft["launches"].items()})
        + f"; under pallas_fused: training {fft['img_per_s']:.2f} img/s, "
        f"{fft['ms']:.2f} ms/step ({fft['steps'] - 1} timed), peak "
        f"{fft['peak_gb']:.2f} GB (bf16, phase train: "
        f"{train['pallas_fused']['img_per_s']:.2f} img/s); sampler "
        f"{ffs['fwd_ms']:.2f} ms a forward, {ffs['s']:.3f} s a "
        f"{SIDE_SAMPLER_STEPS}-step call (bf16, phase serve: "
        f"{_fwd_ms(serve['pallas_fused']):.2f}); launches a training step "
        + str({k: v // fft["steps"] for k, v in fft["launches"].items()})
        + f"; on {card}", flush=True)

  pa, pf, pp = parallel["a"], parallel["fsdp"], parallel["pipe"]
  print(f"[result] parallel: (a) fsdp=True on NCCL, one rank "
        f"{pa['launch']['img_per_s']:.2f} img/s, peak "
        f"{pa['launch']['peak_gb']:.2f} GB (no process group "
        f"{pa['cli']['img_per_s']:.2f} img/s; phase train "
        f"{train['pallas']['img_per_s']:.2f}, settings (a) heads=6,scan=True "
        f"{sa['img_per_s']:.2f}); (b) fsdp=2 on gloo, two processes "
        f"time-slicing the card: peak "
        + ", ".join(f"{g['peak_gb']:.2f}" for g in pf)
        + f" GB a process (one process {parallel['ref']['peak_gb']:.2f}), "
        f"parameters and optimizer state "
        + ", ".join(f"{g['state_gb']:.3f}" for g in pf)
        + f" GB (one process {parallel['ref']['state_gb']:.3f}), "
        f"collectives " + ", ".join(
            f"{np.mean(g['coll_ms'][1:]):.1f}" for g in pf)
        + " ms a step after the first (host clock); state a process: "
        + "; ".join(f"{p} " + ", ".join(f"{g['state_gb']:.3f}" for g in gs)
                    + " GB" for p, gs in parallel["placed"].items())
        + "; pipe=2 bubble "
        f"1/{PIPE_MICROBATCHES + 1}; (b)'s two processes {parallel['b_s']:.1f}"
        f" s from their start; on {card}", flush=True)

  tg = tensor["got"]
  print("[result] tensor: " + "; ".join(
      f"({case}) {TENSOR_CASES[case][1]} mesh {gs[0]['mesh']}: steps "
      + ", ".join(f"{np.mean(g['step_ms'][1:]):.1f}" for g in gs)
      + " ms a process after the first, collectives "
      + ", ".join(f"{np.sum(g['coll_ms'][1:]) / np.sum(g['step_ms'][1:]):.1%}"
                  for g in gs)
      + " of them; state " + ", ".join(f"{g['state_bytes'] / 1e9:.3f}"
                                         for g in gs)
      + f" GB a process (one process "
      f"{tensor['ref'][case]['state_bytes'] / 1e9:.3f})"
      for case, gs in tg.items())
        + f"; host clock, the processes time-slicing the card over gloo; "
        f"on {card}", flush=True)

  print(card, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
