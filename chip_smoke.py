#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``causalvae_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no final line):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every kernel from ``causalvae_tpu_torch/csrc`` (one nvcc per source,
   in parallel), timed, with ptxas' register/spill summary;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving and training paths give it, f32 with TF32 off and bf16 for
   attention and the stage kernels (tolerances in each check's docstring);
   the attention dropout masks of the forward and both backward kernels
   read out and compared with the plain mask exactly; the attention
   forward and backward (tensor cores, 3xTF32 in f32) also at N around
   their 64-row tiles (forward D 8-64, backward D 8-32), bit-equal from
   launch to launch, timed in f32 and bf16 beside SDPA and both of their
   bounds (the forward at rates 0 and 0.1, also at serving's bucket 1);
   the BN kernels'
   channels-last entries; the stage forward and backward at the 14 shapes
   of the packed-fused step, lifted (and the backward's wgrad-only entry,
   bit for bit its dW and db), and the fine-grid stage forward, dgrad and
   wgrad at the same 14 shapes (base kernels; time, real-work bound and the
   fine-grid cuDNN call per shape, the 14-shape sums beside the lifted
   ones'; the dgrad's dx, dmul and dadd and the wgrad's dW and db each,
   equal bits run to run; the wgrad beside the lifted wgrad-only entry at
   each shape); times
   of each kernel, its plain version and
   the library call that computes the same function (where one exists),
   beside the least time the card could take (``bound_ms``); the BN kernels
   at the largest shape and the fine-grid stage kernels at the 14 shapes
   also timed in bf16, beside their bf16 bounds and library calls (cuDNN's
   bf16 calls on the fine grid; the records' ``*_bf16`` and ``*_14*``);
   the ELBO terms' forward and backward kernels (rows 5 and 5b) in f32 and
   bf16 recon at ragged lengths and offset views (the backward bit for bit
   the plain backward's), one launch a call, timed with the L2 cold in a
   CUDA graph beside the earlier two-launch forward and the plain ATen
   backward, and one forward and backward of the function profiled against
   the same function as the port ran it before (``check_elbo``);
4. the serving path: the full-width 768x1280 vessel CausalViTVAE with seeded
   weights on the card, served by ``BatchingEngine(vae_endpoints(...))`` to
   concurrent clients (every endpoint) and over HTTP; the attention launch
   counter is zeroed just before and read just after, and must show 6
   launches per encoder pass; then a ``torch.profiler`` breakdown of one
   bucket-8 reconstruct by kernel, with the device's idle share;
5. serving, card against CPU: encode and decode of one sample through the
   same seeded model on both (plain versions on the CPU), max|Δ| <= 1e-3
   max|ref| + 1e-6 with TF32 off;
4b. serving in bf16 (``compute_dtype``): the same seeded model computing in
   bf16 behind ``BatchingEngine``, reconstruct and do_t at buckets 1 and 8,
   6 attention launches per encoder pass, every one on bf16 operands (the
   ``*_BF16`` counters beside each ``LAUNCHES``), latencies beside phase 4's;
6. the training path: the same model in train mode (dropout 0.1, f32, TF32
   off) takes six steps of ``make_vae_step`` with the clipped Adam of
   bench.py on bench.py's batch-8 batch; every launch counter is zeroed just
   before and read just after and must show, per step, 6 attention forward
   and 6 backward launches, 18 of each BN kernel and 1 ELBO forward and 1
   ELBO backward launch; losses
   finite and falling; step time, peak memory and a profiled step;
6b. the same six steps in bf16, counts held to phase 6's and every bf16
   twin to its total (the ELBO kernels' on the bf16 recon), parameters and
   gradients
   f32; 6c. bf16 against f32 on the card: the eval reconstruction and one
   step's loss terms from the same weights and batch, and phases 6 and 6b's
   loss trajectories (``BF16_*`` bounds); 6d. ``remat_blocks``: one bf16
   step bit-equal to the plain one (generators too), then three steps with
   12 attention forwards each, peak memory and step time;
7. training, card against CPU: from the same seeded weights, steps at
   batch 8, dropout off, the same injected noise, on both: with the vessel
   loss, the loss terms (rel 1e-4) and the gradients below the decoder's
   BatchNorm chain; with the KL term alone, the gradients of the attention
   blocks, the encoder adapter and the stem (1e-3 max|ref|);
8. the packed training path: the phase-packed model with ``packed_io`` and
   ``fused_stages`` (bench.py's flagship configuration plus the stage
   kernels) takes six steps as in phase 6 on the host-packed batch; counts
   zeroed before and read after: per step 14 fine-grid stage forward, 14
   fine-grid dgrad and 14 fine-grid wgrad launches (0 lifted forward, 0 full
   lifted backward, 0 wgrad-only entry), 6 + 6 attention, 18 bn_stats, 9
   bn_bwd, 1 + 1 ELBO; losses
   finite and falling; step time, peak memory, a profiled step with the
   stage kernels' share; 8b. the same in bf16 (every stage, BN and
   attention launch on bf16 operands); then, timing only, the same step with
   ``fused_stages=False`` (cuDNN convolutions in the packed layout);
9. packed-fused against spatial on the card (``phase_packed_check``): one
   eval forward and one step under each of phase 7's losses (the stem
   convs' gradients at their own, stated tolerance);
10. the vessel training entry point (``phase_train_vessel``): the data
   pipeline's device transform on the card against the CPU; then the port's
   CLI in-process at 768x1280 on the synthetic corpus, in a temporary
   directory removed at the end: ``train vessel`` for 2 epochs,
   ``--resume`` to 3 (one loop step profiled), ``serve vessel --ckpt``, one
   ``--packed-io`` epoch, and one ``--dtype bfloat16`` epoch served by
   ``serve vessel --ckpt``; counts zeroed before and read after each,
   held to exact counts per train step (phases 6 and 8) and per val batch;
   losses finite, the run's files present, the resume at epoch 2 with the
   best-val watermark, the restored model's encode equal to the trained
   one's bit for bit; per epoch its wall time, steps, batch building,
   val, checkpoint writes and the loop's step time;
11. k-fold at full width (``phase_kfold``): ``train_kfold`` with 5 folds of
   the vessel model in lockstep, batch 8, 2 epochs, on the synthetic corpus
   (n = 96) preprocessed on the card, checkpoints per fold in a temporary
   directory; counts held per lockstep step (5 x phase 6's) and per val pass
   (5 x 6 attention forwards, no ELBO kernel: the masked loss); the lockstep
   step time beside phase 6's, peak memory, the checkpoint writes' seconds
   and bytes per epoch, each fold's losses; fold 0 after two steps against a
   lone make_vae_step run of the same steps; then the five models served
   by ``BatchingEngine(ensemble_endpoints(...))`` (``uncertainty``
   batch-leading), latencies at buckets 1 and 8, and the report functions
   (``ensemble_sigma_by_treatment``, ``pairwise_snr``, ``mc_decode_stats``,
   ``predictions_by_treatment``) with their counts;
12. the CLI's ``kfold --verify``, ``kfold`` and ``vessel-report`` in process
   on the card (the CLI's small model, 96x160, n = 96), counts held, the
   seven CSV files with their headers and row counts;
13. a file-backed corpus (``phase_file_corpus``): the native loader
   (``causalvae_tpu_torch/native``) built with g++; 1024 TIFF files of
   960x1600 and their CSV written in a temporary directory (most Deflate +
   predictor 2, two each of LZW 8- and 16-bit, PackBits, uncompressed 8-bit
   and float32); ``load_raw`` of each format equal to the array written with
   tifffile and PIL blocked; ``decode_image`` against the card's resize and
   min-max, and ``iterate_batches(use_native=True)`` against the in-memory
   path on the card (share of mask pixels that differ); the loader's
   images/s at 1, 4 and all threads, no sample all zeros; one epoch of
   ``train vessel --csv --data`` at 768x1280 (493 steps), counts held per
   step and per val batch, its ``EpochClock`` split, then ``serve vessel
   --ckpt``; ``kfold --verify`` and ``vessel-report`` on the same files;
14. the deployment bundle (``phase_export``): the seeded flagship at
   768x1280 (f32) exported in a temporary directory by the CLI's ``export
   vessel --buckets 1``, then every endpoint but do_t at bucket 8 with
   ``export_endpoints`` into a second bundle (do_t at bucket 1 only), the
   export seconds per endpoint and bucket, the program and params bytes;
   both bundles loaded here, each endpoint at each of its buckets against the eager endpoints of the same weights
   (``EXPORT_TOL``, under cuDNN's deterministic algorithms; without them
   eager against eager once, for the spread of cuDNN's f32 algorithms), the
   attention counter zeroed before and read after each call, the exported
   call's launches equal to the eager call's (6 per encoder pass);
   reconstruct latency at buckets 1 and 8, exported against eager, in
   turns, beside the card's name and power limit;
15. the MNIST study (``phase_mnist``), through the port's CLI in-process in
   a temporary directory, every kernel counter zeroed before and read after
   (each must read 0: no ported kernel lies on the MNIST path): the card's
   ``synthetic_mnist(1024, seed=42)`` held to the sha1 of the reference
   corpus (``MNIST_SHA1``; the card's PIL version printed), its host
   morphology measured and then read from the cache, bit for bit; ``train
   mnist`` 3 epochs of 8 steps at batch 128, ``--resume`` to 4, ``train
   mnist-bayes`` 2 epochs (losses finite, the resume at epoch 3, the
   restored VAE's encode bit-equal, the step time on the host clock,
   images/s, the ``EpochClock`` split, the pair file's bytes); one
   adversarial step at batch 32, card against CPU, C1 and C4 (loss terms rel
   1e-4, every gradient leaf 1e-3 of its max|ref|); ``serve --ckpt
   --smoke`` of both; ``BatchingEngine(vae_endpoints(...))`` with five
   endpoints for C1 and six for C4, reconstruct latency at buckets 1 and
   32; ``export mnist --ckpt --buckets 1 8`` (seconds, bytes), the bundle
   against eager under ``cudnn.deterministic``; then one fresh process
   serves phase 14's vessel bundle and this one with ``serve
   --export-dir --smoke`` and must import nothing of
   ``causalvae_tpu_torch.models``.

The second-to-last line of standard output is the card's name and power
limit, the line before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
from torch.nn import functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores, HBM3 bandwidth; TF32 on the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
# data-sheet boost clock and SM count, for per-score work by count (not measured)
SM_COUNT, SM_CLOCK = 132, 1.98e9
TIMED_SHAPE = (64, 961, 32)  # batch 8: B*H = 8*8, N = 961, D = 32
FWD_SHAPES = [(64, 961, 32), (256, 961, 32), (6, 17, 32), (3, 241, 16)] + [
    (3, n, d) for n in (1, 63, 65, 129) for d in (8, 16, 32, 64)]  # around the 64-key tiles
FWD_TIMED = [(8, 961, 32), TIMED_SHAPE, (256, 961, 32)]  # serving bucket 1, batch 8, 32
BWD_SHAPES = [(64, 961, 32), (6, 17, 32), (3, 241, 16)] + [
    (3, n, d) for n in (1, 63, 65, 129) for d in (8, 16, 32)]  # around the 64-row tiles
TRAIN_RATE = 0.1  # the vessel model's attention dropout
TRAIN_BATCH = 8
TRAIN_STEPS = 6
# every train-mode BatchNorm input of the vessel model at batch 8, (N, C, S):
# the five stem stages, the five decoder stages, the three ResBlocks (two BNs
# each, at their stage's shape) and the two adapters; the last decoder stage
# (8, 16, 768*1280) is the largest and the one timed
BN_SHAPES = [(8, 32, 384 * 640), (8, 64, 192 * 320), (8, 128, 96 * 160),
             (8, 256, 48 * 80), (8, 256, 24 * 40), (8, 128, 48 * 80),
             (8, 64, 96 * 160), (8, 32, 192 * 320), (8, 16, 384 * 640),
             (8, 16, 768 * 1280), (8, 512, 1), (8, 256, 1)]
ELBO_N = 8 * 768 * 1280  # the vessel batch's pixels
# phase 3's ELBO lengths: the vessel batch, ragged ones around its 4- and
# 8-element vectors, the CLI's small model's batch plus a tail, a few elements
ELBO_CASES = (ELBO_N, ELBO_N - 37, 8 * 96 * 160 + 37, 1000, 7, 1)
L2_SETS = 4  # input sets a timed run takes in turn: 4 x 47-63 MB, past the 50 MB L2
GRAPH_CALLS = 100  # calls in the CUDA graph whose replays are timed
FULL_PASS_US = 5.0  # a kernel this long or longer counts as a pass over the batch
# per training step of the full model: 6 blocks; 16 four-dimensional BNs + 2
# adapter BNs; one loss; the spatial form has no stage
PER_STEP = {"attention_fwd": 6, "attention_bwd": 6, "bn_stats": 18, "bn_bwd": 18,
            "elbo_terms": 1, "elbo_terms_bwd": 1, "stage_fwd": 0, "stage_fwd_fine": 0,
            "stage_bwd": 0, "stage_dgrad_fine": 0, "stage_wgrad_fine": 0, "stage_bwd_wgrad": 0}
# card-vs-CPU training steps: the batch, and the gradients compared per loss
CHECK_BATCH = 8
CHECK_GRADS = {
    "vessel": ["backbone.dec_bns.4.scale", "backbone.dec_bns.4.bias",
               "backbone.dec_out.weight", "backbone.dec_out.bias"],
    "kld": ["backbone.blocks.0.attn.qkv.weight", "backbone.blocks.5.attn.qkv.weight",
            "enc_adapter_fc1.weight", "enc_adapter_bn.scale", "backbone.stem_bns.4.scale"]}
GRAD_TOL = 1e-3  # of max|ref|, as the serving check holds its outputs
# the phase-packed model of bench.py's flagship step with the stage kernels
PACKED = dict(packed=True, packed_io=True, fused_stages=True)
# per step of the packed-fused model: 10 of the 18 BNs take the (N, C, S) or
# (M, C) bn_bwd kernel; the 8 whose affine is a stage prologue differentiate
# their statistics elementwise; the 14 stage forwards, dgrads and wgrads run
# on the fine grid (no lifted stage kernel: neither the lifted forward, the
# full lifted backward nor its wgrad-only entry)
PER_STEP_PACKED = {"attention_fwd": 6, "attention_bwd": 6, "bn_stats": 18, "bn_bwd": 9,
                   "elbo_terms": 1, "elbo_terms_bwd": 1, "stage_fwd": 0, "stage_fwd_fine": 14,
                   "stage_bwd": 0, "stage_dgrad_fine": 14, "stage_wgrad_fine": 14,
                   "stage_bwd_wgrad": 0}
# the stem convs whose gradients come from the stem stage backward. They lie
# below three BatchNorm backwards (BN1-BN3), where the full-width f32 step is
# ill-conditioned: phase 7 measures the spatial model's own card-vs-CPU spread
# there (not held), and phase 9 holds them at STEM_GRAD_TOL
STEM_GRADS = ["backbone.stem_convs.1.weight", "backbone.stem_convs.2.weight"]
STEM_GRAD_TOL = 1e-2  # of max|ref|: ~3x the spatial model's own spread (PERF.md)
# packed-fused against spatial, the gradients per loss: phase 7's, and under
# the KL term the stem convs
PACKED_CHECK_GRADS = {"vessel": CHECK_GRADS["vessel"],
                      "kld": CHECK_GRADS["kld"] + STEM_GRADS}
# the 14 stage calls of one packed-fused forward at batch 8: name, x (B, H, W,
# Ci), Co, K, pad_lo, prologue slope (None: no prologue), and how the kernel
# is lifted (ops/subpixel.py _tap_index recipe, levels) for the real work
STAGE_SHAPES = [
    ("stem conv 1", (8, 96, 160, 512), 256, 2, 1, 0.01, "stem", 2),
    ("stem conv 2", (8, 96, 160, 256), 128, 2, 1, 0.01, "stem", 1),
    ("dec_ct[0]", (8, 24, 40, 256), 512, 2, 0, None, "convT", 0),
    ("dec_res[0] conv0", (8, 48, 80, 128), 128, 3, 1, 0.01, "conv", 0),
    ("dec_res[0] conv1", (8, 48, 80, 128), 128, 3, 1, 0.2, "conv", 0),
    ("dec_ct[1]", (8, 48, 80, 128), 256, 2, 0, None, "convT", 0),
    ("dec_res[1] conv0", (8, 48, 80, 256), 256, 3, 1, 0.01, "conv", 1),
    ("dec_res[1] conv1", (8, 48, 80, 256), 256, 3, 1, 0.2, "conv", 1),
    ("dec_ct[2]", (8, 48, 80, 256), 512, 2, 0, None, "convT", 1),
    ("dec_res[2] conv0", (8, 96, 160, 128), 128, 3, 1, 0.01, "conv", 1),
    ("dec_res[2] conv1", (8, 96, 160, 128), 128, 3, 1, 0.2, "conv", 1),
    ("dec_ct[3]", (8, 96, 160, 128), 256, 2, 0, None, "convT", 1),
    ("dec_ct[4]", (8, 96, 160, 256), 1024, 2, 0, None, "convT", 2),
    ("dec_out", (8, 96, 160, 1024), 64, 3, 1, 0.01, "conv", 3),
]
# phase 10, train vessel through the CLI: the synthetic corpus (96x160 masks)
# at the model's 768x1280; n = 32 gives 8 train steps (17 samples x 4 augs)
# and 2 val batches (8 + 2) an epoch, n = 16 (the packed epoch) 6 and 1 (4)
VESSEL_HW = (768, 1280)
VESSEL_N, VESSEL_N_PACKED = 32, 16
VESSEL_DISK = 8 * 2**30  # two 1.3 GB checkpoints, each beside its temporary copy
# per val batch (eval forward, no gradient): 6 attention forwards and the
# ELBO terms; eval BatchNorm runs on running statistics (no BN kernel); the
# packed-fused model adds its 14 fine-grid stage forwards
PER_VAL = {"attention_fwd": 6, "elbo_terms": 1, "elbo_terms_bwd": 0}
PER_VAL_PACKED = dict(PER_VAL, stage_fwd_fine=14)
# the kernels that count their bf16 launches apart (``*_BF16`` beside each
# counter): in a bf16 run every launch of theirs takes bf16 operands, in an
# f32 run none; the ELBO kernels' bf16 launches are those on a bf16 recon (x
# stays f32)
BF16_TWINS = {"attention_fwd": "attention_fwd_bf16", "attention_bwd": "attention_bwd_bf16",
              "bn_stats": "bn_stats_bf16", "bn_bwd": "bn_bwd_bf16",
              "elbo_terms": "elbo_terms_bf16", "elbo_terms_bwd": "elbo_terms_bwd_bf16",
              "stage_fwd_fine": "stage_fwd_fine_bf16",
              "stage_dgrad_fine": "stage_dgrad_fine_bf16",
              "stage_wgrad_fine": "stage_wgrad_fine_bf16"}
# remat_blocks recomputes each block's forward in the backward: 12 attention
# forwards a step, the rest as the plain step
PER_STEP_REMAT = dict(PER_STEP, attention_fwd=12)
REMAT_STEPS = 3
# bf16 against f32 on the card, the same weights and batch: the eval
# reconstruction (mean|d| / mean|ref|, max|d| / max|ref|), the loss terms of
# one step (rel), and the six-step loss trajectories of phases 6 and 6b step
# by step (rel). Bounds about 2.5x the readings of the first run (PERF.md):
# 9.27e-3 and 1.44e-2, 1.90e-3 (kld), 3.77e-3 (step 3)
BF16_RECON_TOL = (2.5e-2, 4e-2)
BF16_TERMS_REL = 5e-3
BF16_TRAJ_REL = 1e-2
# phase 11, k-fold at full width: the synthetic corpus (n = 96, 19 groups; the
# smallest class has 2 members, sklearn's rules met) at 768x1280, 5 folds of
# 76-77 train samples (9 lockstep steps of batch 8 an epoch) and 19-20 val
# samples (one padded batch of 20 a fold), 2 epochs, checkpoints every epoch
# (5 folds x latest + best, 1.23 GB each, beside one temporary copy)
KFOLD_N, KFOLD_K, KFOLD_BATCH, KFOLD_EPOCHS = 96, 5, 8, 2
KFOLD_DISK = 16 * 2**30
# per fold per val pass: the eval forward with the sample mask (the plain
# masked loss terms, no ELBO kernel; eval BatchNorm: no BN kernel)
PER_VAL_KFOLD = {"attention_fwd": 6}
# fold 0 after two lockstep steps against a lone run of the same steps: the
# kernels and cuDNN's deterministic algorithms repeat their bits, so
# bit-equality is expected; the bound, of each tensor's max|ref|, says how far
# it may miss
KFOLD_ALONE_TOL = 1e-6
KFOLD_CLI_N = 96  # phase 12: the CLI's small model at 96x160
# phase 13, a file-backed corpus in the reference's layout (a CSV of ``Image
# ID,group_name,<features>``, ``*.vessel.mip.tiff`` files named by ID): the
# masks and features of ``synthetic_corpus(n=1024)`` (19 groups) as 16-bit
# images with intensities, a ramp and seeded noise, at 960x1600. That size is
# this script's choice, not the real data's: it makes the resize to 768x1280
# do real work. Files 0-9 are two each of LZW 8-bit, LZW 16-bit + predictor
# 2, PackBits 8-bit, uncompressed 8-bit and float32; the rest Deflate (zlib
# level 1) + predictor 2, in 64-row strips. 986 train samples x 4 augs = 493
# steps of 8; 19 val samples = 3 val batches (8 and 8 native, 3 on the host path)
FILE_N, FILE_HW = 1024, (960, 1600)
FILE_FORMATS = ("lzw8", "lzw8", "lzw16", "lzw16", "packbits", "packbits", "u8", "u8",
                "f32", "f32")
FILE_DISK = 12 * 2**30  # ~2.5 GB of files; two 1.23 GB checkpoints beside their copies
FILE_CHECK_N = 32  # (d): the first 32 files, every format among them
FILE_RESIZE_TOL = 1e-5  # (d): decode_image against the card's resize + min-max, max|d|
# (d): share of binarized pixels that may differ between the native route and
# make_preprocess on the card (each must lie within 1e-5 of its image's mean)
FILE_FLIP_MAX = 1e-4
LOADER_BATCHES = 64  # (e): batches of 8 at 4 and at cpu_count threads
LOADER_BATCHES_ONE_THREAD = 16  # (e): at 1 thread (~21 images/s: 6 s, not 24)
# (g): vessel-report's fold batch; the CLI's 4 makes 1025 small-model fold
# steps, 27 s more than at 16 on an H100 80GB HBM3 (95.0 against 68.3 s).
# What (g) is for is the load_raw preload of the 1024 files; phase 12
# drives the batch of 4
FILE_REPORT_BATCH = 16
STAGE_RECORD = "dec_out"            # the JSON record's shape (the largest forward)
STAGE_LIBRARY = ("dec_out", "dec_ct[4]")  # shapes timed beside plain and library


def log(*args):
    print(*args, flush=True)


def with_dtype(per: dict, bf16: bool) -> dict:
    """``per`` (launches per step or per val batch) with the bf16 twins'
    counts: all of the kernel's launches in a bf16 run, none in an f32 one."""
    return {**per, **{twin: per.get(name, 0) if bf16 else 0
                      for name, twin in BF16_TWINS.items()}}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype=torch.float32) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    flops over the type's peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_core_bound(nbytes: float, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by, cuda_core_ms) of attention products: f32-accurate
    products can run on the tensor cores as 3xTF32, so the f32 figure for the
    operations is the lesser of 3x the flops at the TF32 rate and the flops at
    the CUDA-core rate (``cuda_core_ms``, returned beside it); bf16 at its
    tensor-core rate."""
    cuda_core_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_ops = (min(3 * flops / PEAK_TF32 * 1e3, cuda_core_ms) if dtype == torch.float32
             else flops / PEAK_FLOPS[dtype] * 1e3)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (cuda_core_ms,)


def attention_bound_ms(bh: int, n: int, d: int, dtype) -> tuple:
    """Forward: q, k, v read and o written once, plus the f32 lse, against
    4*BH*N*N*D flops -> (bound_ms, bound_by, cuda_core_ms)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return tensor_core_bound(4 * bh * n * d * elt + bh * n * 4, 4 * bh * n * n * d, dtype)


def attention_bwd_bound_ms(bh: int, n: int, d: int, dtype) -> tuple:
    """Backward: q, k, v, o, do and the f32 lse read, dq, dk, dv written,
    against 10*BH*N*N*D flops -> (bound_ms, bound_by, cuda_core_ms)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return tensor_core_bound(8 * bh * n * d * elt + bh * n * 4, 10 * bh * n * n * d, dtype)


def score_work_ms(bh: int, n: int) -> tuple:
    """By count, not measured: (exps, MUFU ms, hash ms) of the forward's
    per-score work, one exp2 per score at 16 a clock per SM and, with dropout,
    one hash of ~12 integer operations per score at 64 a clock per SM, on
    SM_COUNT SMs at SM_CLOCK."""
    scores = bh * n * n
    return (scores, scores / (16 * SM_COUNT * SM_CLOCK) * 1e3,
            12 * scores / (64 * SM_COUNT * SM_CLOCK) * 1e3)


def check(name: str, err: float, tol: float):
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err:.3e} > tol {tol:.3e}")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_attention_fwd(attention, gen, dev):
    """The forward kernel (tensor cores, 3xTF32 in f32) against
    attention_reference at rate 0 (serving) and at the training rate, f32
    (TF32 off; o and lse within 2e-5 max|ref| + 1e-6) and bf16 (against f32
    on the bf16 values, 2e-2), at the training shapes, small ones and N around
    the 64-key tiles (1, 63, 65, 129) for D 8, 16, 32, 64. At (64, 961, 32),
    rate 0.1, f32 and bf16: two launches give equal bits. Timed at serving's
    bucket 1 (8, 961, 32), training's batch 8 (64, 961, 32) and (256, 961,
    32), rates 0 and 0.1, f32 and bf16, beside SDPA (at rate 0.1 with its own
    random bits: a time yardstick only), both bounds and the per-score work by
    count."""
    record = {}
    for bh, n, d in FWD_SHAPES:
        q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev) for _ in range(3))
        for rate in (0.0, TRAIN_RATE):
            o, lse = attention.attention_fwd(q, k, v, rate, 7)
            torch.cuda.synchronize()
            ro, rlse = attention.attention_reference(q, k, v, rate, 7)
            err, err_lse = max_err(o, ro), max_err(lse, rlse)
            tol = 2e-5 * float(ro.abs().max()) + 1e-6
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            ob, lseb = attention.attention_fwd(qb, kb, vb, rate, 7)
            torch.cuda.synchronize()
            rb, _ = attention.attention_reference(*(t.float() for t in (qb, kb, vb)),
                                                  rate, 7)
            err_bf16 = max_err(ob, rb)
            log(f"[kernels] attention_fwd {(bh, n, d)} rate {rate}: f32 max|d| {err:.3e} "
                f"(tol {tol:.3e}), lse {err_lse:.3e}; bf16 max|d| {err_bf16:.3e} (tol 2e-2)")
            check(f"attention_fwd {(bh, n, d)} rate {rate} f32", err, tol)
            check(f"attention_fwd {(bh, n, d)} rate {rate} lse", err_lse,
                  2e-5 * float(rlse.abs().max()) + 1e-6)
            check(f"attention_fwd {(bh, n, d)} rate {rate} bf16", err_bf16, 2e-2)
            if (bh, n, d) == TIMED_SHAPE and rate == 0.0:
                record.update(max_abs_err=err, max_abs_err_bf16=err_bf16)
            if (bh, n, d) == TIMED_SHAPE and rate == TRAIN_RATE:
                again = (attention.attention_fwd(q, k, v, rate, 7)
                         + attention.attention_fwd(qb, kb, vb, rate, 7))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip((o, lse, ob, lseb), again)):
                    raise AssertionError("attention_fwd: two launches differ")
                log(f"[kernels] attention_fwd {(bh, n, d)} rate {rate}: two launches "
                    f"bit-equal in f32 and bf16 (o and lse)")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for bh, n, d in FWD_TIMED:
            q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev, dtype) for _ in range(3))
            q4, k4, v4 = (t.view(bh // 8, 8, n, d) for t in (q, k, v))
            bnd, by, cuda_core = attention_bound_ms(bh, n, d, dtype)
            exps, mufu_ms, hash_ms = score_work_ms(bh, n)
            for rate in (0.0, TRAIN_RATE):
                ms = cuda_ms(lambda: attention.attention_fwd(q, k, v, rate, 7))
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                     dropout_p=rate))
                plain = None
                if (bh, n, d) == TIMED_SHAPE:
                    plain = cuda_ms(lambda: attention.attention_reference(q, k, v, rate, 7),
                                    iters=20 if rate == 0.0 else 5)
                log(f"[kernels] attention_fwd {tag} {(bh, n, d)} rate {rate}: kernel "
                    f"{ms:.4f} ms, plain "
                    f"{'not timed' if plain is None else f'{plain:.4f} ms'}, library "
                    f"(SDPA, dropout_p {rate}) {lib:.4f} ms, bound {bnd:.4f} ms ({by}"
                    f"{'; 3xTF32 on the tensor cores' if dtype == torch.float32 else ''}), "
                    f"f32 on the CUDA cores {cuda_core:.4f} ms, kernel/bound {ms / bnd:.2f}; "
                    f"by count, not measured: {exps / 1e6:.1f} M exp2 (~{mufu_ms:.4f} ms "
                    f"of MUFU){f', one hash a score (~{hash_ms:.4f} ms of issue)' if rate else ''}")
                if (bh, n, d) != TIMED_SHAPE:
                    continue
                drop = "" if rate == 0.0 else "_dropout"
                if dtype == torch.float32:
                    record.update({f"ms{drop}": ms, f"plain_ms{drop}": plain,
                                   f"library_ms{drop}": lib})
                    record.update(bound_ms=bnd, bound_by=by, bound_cuda_core_ms=cuda_core)
                else:
                    record.update({f"ms_bf16{drop}": ms, f"plain_ms_bf16{drop}": plain,
                                   f"library_ms_bf16{drop}": lib, "bound_ms_bf16": bnd})
    return record


def check_attention_masks(attention, dev, shape=TIMED_SHAPE):
    """The dropout masks the kernels apply, read out exactly and compared
    with the plain version's mask at the training shape (64, 961, 32): with
    q = k = 0 every probability is 1/N, so one-hot v (forward), one-hot do
    (dk/dv kernel) and one-hot k with v[:, 0] = do[:, 0] = 1 (dq kernel) turn
    each 32-column block of the mask into the outputs."""
    bh, n, d = shape
    rate, seed = TRAIN_RATE, 2**31 + 11
    keep_ref = attention.dropout_keep(seed, bh, n, dev) >= attention.keep_threshold(rate)
    zeros = torch.zeros(bh, n, d, device=dev)
    eye = torch.eye(d, device=dev)
    masks = {name: torch.zeros(bh, n, n, dtype=torch.bool, device=dev)
             for name in ("fwd", "bwd_dkdv", "bwd_dq")}
    ones0 = zeros.clone()
    ones0[:, :, 0] = 1.0
    o1, lse1 = attention.attention_fwd(zeros, zeros, ones0, rate, seed)
    scale = 1.0 / math.sqrt(d)
    for j0 in range(0, n, d):
        w = min(d, n - j0)
        onehot = zeros.clone()
        onehot[:, j0:j0 + w, :w] = eye[:w, :w]
        o, lse = attention.attention_fwd(zeros, zeros, onehot, rate, seed)
        masks["fwd"][:, :, j0:j0 + w] = (o[:, :, :w] * n * (1 - rate)) > 0.5
        # dv[j, c] = keep(j0 + c, j) / (N (1 - rate)) for do one-hot over rows
        _, _, dv = attention.attention_bwd(zeros, zeros, zeros, o, lse, onehot, rate, seed)
        masks["bwd_dkdv"][:, j0:j0 + w, :] = (dv[:, :, :w] * n * (1 - rate) > 0.5).transpose(1, 2)
        # dq[i, c] = scale / N * (keep(i, j0 + c) / (1 - rate) - delta_i)
        dq, _, _ = attention.attention_bwd(zeros, onehot, ones0, o1, lse1, ones0, rate, seed)
        kept = (dq[:, :, :w] * n / scale + o1[:, :, :1]) * (1 - rate)
        masks["bwd_dq"][:, :, j0:j0 + w] = kept > 0.5
    torch.cuda.synchronize()
    for name, m in masks.items():
        diff = int((m != keep_ref).sum())
        log(f"[kernels] dropout mask of {name} at {shape}, rate {rate}, seed {seed}: "
            f"{diff} of {m.numel()} entries differ from the plain mask "
            f"(kept fraction {float(m.float().mean()):.4f})")
        if diff:
            raise AssertionError(f"the {name} kernel's dropout mask differs from the plain one")


def check_attention_bwd(attention, gen, dev):
    """The backward kernels against attention_bwd_reference at rate 0 and the
    training rate, at the training shape, small ones and N around the 64-row
    tiles (1, 63, 65, 129) for D 8, 16, 32: f32 (max|d| <= 1e-4 max|ref| + 1e-6:
    3xTF32 products, sums in another order) and bf16 (against f32 on the bf16
    values, 1e-2 max|ref| + 1e-3: the outputs' bf16 rounding). At (64, 961, 32),
    rate 0.1, f32 and bf16: two launches give equal bits; timed beside the plain
    version, SDPA's autograd backward and both bounds (3xTF32 on the tensor
    cores, f32 on the CUDA cores)."""
    record = {}
    for bh, n, d in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(bh, n, d, generator=gen).to(dev, dtype)
                           for _ in range(4))
            for rate in (0.0, TRAIN_RATE):
                o, lse = attention.attention_fwd(q, k, v, rate, 5)
                grads = attention.attention_bwd(q, k, v, o, lse, do, rate, 5)
                torch.cuda.synchronize()
                want = attention.attention_bwd_reference(
                    *(t.float() for t in (q, k, v, o)), lse, do.float(), rate, 5)
                rel, floor = (1e-4, 1e-6) if dtype == torch.float32 else (1e-2, 1e-3)
                errs = [max_err(g, w) for g, w in zip(grads, want)]
                tols = [rel * float(w.abs().max()) + floor for w in want]
                log(f"[kernels] attention_bwd {str(dtype)[6:]} {(bh, n, d)} rate {rate}: "
                    f"max|d| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                    f"(tol {tols[0]:.3e} {tols[1]:.3e} {tols[2]:.3e})")
                for name, e, t in zip(("dq", "dk", "dv"), errs, tols):
                    check(f"attention_bwd {name} {(bh, n, d)} {dtype} rate {rate}", e, t)
                if (bh, n, d) != TIMED_SHAPE or rate == 0.0:
                    continue
                again = attention.attention_bwd(q, k, v, o, lse, do, rate, 5)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"attention_bwd {dtype}: two launches differ")
                ms = cuda_ms(lambda: attention.attention_bwd(q, k, v, o, lse, do, rate, 5))
                plain = cuda_ms(lambda: attention.attention_bwd_reference(
                    q, k, v, o, lse, do, rate, 5), iters=5)
                q4, k4, v4 = (t.view(bh // 8, 8, n, d).detach().requires_grad_(True)
                              for t in (q, k, v))
                out4 = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate)
                do4 = do.view(bh // 8, 8, n, d)
                lib = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                          retain_graph=True))
                bnd, by, cuda_core = attention_bwd_bound_ms(bh, n, d, dtype)
                log(f"[kernels] attention_bwd {str(dtype)[6:]} {(bh, n, d)} rate {rate}: "
                    f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library (SDPA autograd "
                    f"backward, dropout {rate}) {lib:.4f} ms, bound {bnd:.4f} ms ({by}"
                    f"{'; 3xTF32 on the tensor cores' if dtype == torch.float32 else ''}), "
                    f"f32 on the CUDA cores {cuda_core:.4f} ms, kernel/bound {ms / bnd:.2f}, "
                    f"two launches bit-equal")
                if dtype == torch.float32:
                    record.update(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                                  library_ms=lib, bound_ms=bnd, bound_by=by,
                                  bound_cuda_core_ms=cuda_core)
                else:
                    record.update(max_abs_err_bf16=max(errs), ms_bf16=ms,
                                  plain_ms_bf16=plain, library_ms_bf16=lib,
                                  bound_ms_bf16=bnd)
    return record


def check_bn(batchnorm, gen, dev):
    """Both BN kernels against their plain versions at every train-mode BN
    shape of the batch-8 step (f32; |d| <= 1e-5 of the per-channel sum of
    absolute terms, whatever the cancellation: the sums run in another
    order); timed at the largest, (8, 16, 768*1280), beside
    torch.var_mean(x, (0, 2, 3), correction=0) for the statistics and
    torch.batch_norm_backward_reduce (SyncBatchNorm's reduction: Σdy·x̂ as
    its grad_weight, Σdy as its grad_bias) for the backward, held to the
    kernel's sums at the same tolerance."""
    recs = {}
    for n, c, s in BN_SHAPES:
        x = (torch.randn(n, c, s, generator=gen) * 2 + 1).to(dev)
        dy = torch.randn(n, c, s, generator=gen).to(dev)
        sums = batchnorm.bn_stats(x)
        cnt = n * s
        mean = sums[0] / cnt
        inv = torch.rsqrt(torch.clamp(sums[1] / cnt - mean * mean, min=0.0) + 1e-5)
        bsums = batchnorm.bn_bwd_sums(dy, x, mean, inv)
        torch.cuda.synchronize()
        ref_s = batchnorm.bn_stats_reference(x)
        ref_b = batchnorm.bn_bwd_reference(dy, x, mean, inv)
        xhat = (x - mean.view(1, -1, 1)) * inv.view(1, -1, 1)
        abs_s = torch.stack([x.abs().sum((0, 2)), (x * x).sum((0, 2))])
        abs_b = torch.stack([dy.abs().sum((0, 2)), (dy * xhat).abs().sum((0, 2))])
        ratio_s = float(((sums - ref_s).abs() / abs_s).max())
        ratio_b = float(((bsums - ref_b).abs() / abs_b).max())
        log(f"[kernels] bn {(n, c, s)}: stats max|d|/sum|term| {ratio_s:.3e}, "
            f"bwd {ratio_b:.3e} (tol 1e-5)")
        check(f"bn_stats {(n, c, s)}", ratio_s, 1e-5)
        check(f"bn_bwd {(n, c, s)}", ratio_b, 1e-5)
        if (n, c, s) == BN_SHAPES[9]:
            elems = n * c * s
            ms = cuda_ms(lambda: batchnorm.bn_stats(x))
            plain = cuda_ms(lambda: batchnorm.bn_stats_reference(x))
            x4 = x.view(n, c, 768, 1280)
            lib = cuda_ms(lambda: torch.var_mean(x4, (0, 2, 3), correction=0))
            bnd, by = bound(elems * 4 + 2 * c * 4, 3 * elems)
            recs["bn_stats"] = dict(max_abs_err=max_err(sums, ref_s), ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=bnd, bound_by=by)
            ms = cuda_ms(lambda: batchnorm.bn_bwd_sums(dy, x, mean, inv))
            plain = cuda_ms(lambda: batchnorm.bn_bwd_reference(dy, x, mean, inv))
            dy4, ones = dy.view(n, c, 768, 1280), torch.ones(c, device=dev)

            def library():
                return torch.batch_norm_backward_reduce(dy4, x4, mean, inv, ones,
                                                        False, True, True)

            _, _, lib_w, lib_b = library()
            ratio_lib = float(((torch.stack([lib_b, lib_w]) - bsums).abs() / abs_b).max())
            log(f"[kernels] bn_bwd {(n, c, s)}: batch_norm_backward_reduce against the "
                f"kernel max|d|/sum|term| {ratio_lib:.3e} (tol 1e-5)")
            check(f"batch_norm_backward_reduce {(n, c, s)}", ratio_lib, 1e-5)
            lib = cuda_ms(library)
            bnd, by = bound(2 * elems * 4 + 4 * c * 4, 5 * elems)
            recs["bn_bwd"] = dict(max_abs_err=max_err(bsums, ref_b), ms=ms, plain_ms=plain,
                                  library_ms=lib, bound_ms=bnd, bound_by=by)
            for name, r in recs.items():
                log(f"[kernels] {name} {(n, c, s)} f32: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}), kernel/bound "
                    f"{r['ms'] / r['bound_ms']:.2f}")
            check_bn_bf16(batchnorm, recs, x, dy, mean, inv)
    return recs


def check_bn_bf16(batchnorm, recs, x, dy, mean, inv):
    """Both BN kernels on the bf16 rounding of the largest shape's x and dy
    (the bf16 model's BatchNorm inputs): against their plain versions on the
    same bf16 values (the f32 tolerance, 1e-5 of the per-channel sum of
    absolute terms), then timed beside the plain versions, the library calls
    on the bf16 tensors and the bounds (2-byte elements read, f32 sums);
    added to the records as ``*_bf16``."""
    n, c, s = x.shape
    xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    xf, dyf = xb.float(), dyb.float()
    xhat = (xf - mean.view(1, -1, 1)) * inv.view(1, -1, 1)
    abs_s = torch.stack([xf.abs().sum((0, 2)), (xf * xf).sum((0, 2))])
    abs_b = torch.stack([dyf.abs().sum((0, 2)), (dyf * xhat).abs().sum((0, 2))])
    sums, bsums = batchnorm.bn_stats(xb), batchnorm.bn_bwd_sums(dyb, xb, mean, inv)
    torch.cuda.synchronize()
    ref_s = batchnorm.bn_stats_reference(xb)
    ref_b = batchnorm.bn_bwd_reference(dyb, xb, mean, inv)
    ratio_s = float(((sums - ref_s).abs() / abs_s).max())
    ratio_b = float(((bsums - ref_b).abs() / abs_b).max())
    check(f"bn_stats bf16 {(n, c, s)}", ratio_s, 1e-5)
    check(f"bn_bwd bf16 {(n, c, s)}", ratio_b, 1e-5)
    x4, dy4 = xb.view(n, c, 768, 1280), dyb.view(n, c, 768, 1280)
    ones = torch.ones(c, device=x.device)
    elems = n * c * s
    timed = {
        "bn_stats": (ratio_s, max_err(sums, ref_s), lambda: batchnorm.bn_stats(xb),
                     lambda: batchnorm.bn_stats_reference(xb),
                     lambda: torch.var_mean(x4, (0, 2, 3), correction=0),
                     bound(elems * 2 + 2 * c * 4, 3 * elems)),
        "bn_bwd": (ratio_b, max_err(bsums, ref_b), lambda: batchnorm.bn_bwd_sums(dyb, xb, mean, inv),
                   lambda: batchnorm.bn_bwd_reference(dyb, xb, mean, inv),
                   lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, inv, ones,
                                                            False, True, True),
                   bound(2 * elems * 2 + 4 * c * 4, 5 * elems))}
    for name, (ratio, err, kernel, plain, library, (bnd, by)) in timed.items():
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        lib_ms = cuda_ms(library)
        recs[name].update(max_abs_err_bf16=err, ms_bf16=ms, plain_ms_bf16=plain_ms,
                          library_ms_bf16=lib_ms, bound_ms_bf16=bnd)
        log(f"[kernels] {name} {(n, c, s)} bf16: max|d|/sum|term| {ratio:.3e} (tol 1e-5); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}), kernel/bound {ms / bnd:.2f}")


def graph_ms(calls: list) -> float:
    """Device time of one call with the L2 cold: GRAPH_CALLS calls taking
    ``calls`` (one per input set, L2_SETS sets) in turn, captured into a CUDA
    graph after a warm-up on the capture's side stream; CUDA events around
    three replays, over the calls replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(GRAPH_CALLS):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * GRAPH_CALLS)
    del graph
    torch.cuda.empty_cache()
    return ms


def in_turns(calls_a: list, calls_b: list) -> tuple:
    """``graph_ms`` of two versions in turns (a, b, b, a), after one reading
    of a that is dropped (a first reading after idle ran 14% above a's
    second on an H100): the mean of each version's two readings."""
    warm, a1, b1, b2, a2 = (graph_ms(c) for c in (calls_a, calls_a, calls_b, calls_b,
                                                  calls_a))
    log(f"[kernels] in turns (a, b, b, a) after a dropped {warm:.5f}: {a1:.5f}, {b1:.5f}, "
        f"{b2:.5f}, {a2:.5f} ms")
    return (a1 + a2) / 2, (b1 + b2) / 2


def profile_kernels(calls: list, rounds: int = 2) -> dict:
    """The device kernels of one call by torch.profiler, over ``rounds``
    rounds of ``calls`` (one per input set, so the L2 is cold): per call,
    their number, how many ran FULL_PASS_US or longer (a pass over the
    vessel batch cannot take less), their summed device time, and the
    kernels by name (count, ms)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    per = rounds * len(calls)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    if not kernels:
        raise AssertionError("the profile holds no device kernel")
    us = [e.time_range.elapsed_us() for e in kernels]
    by_name = {}
    for e, t in zip(kernels, us):
        count, total = by_name.get(e.name[:60], (0, 0.0))
        by_name[e.name[:60]] = (count + 1, total + t)
    return {"kernels": len(kernels) / per,
            "full_size": sum(t >= FULL_PASS_US for t in us) / per,
            "device_ms": sum(us) / 1e3 / per,
            "by_name": {k: (c / per, t / 1e3 / per) for k, (c, t) in by_name.items()}}


def twopass_forward(lib, r, x, pw):
    """The earlier two-launch forward (``csrc/elbo_terms_twopass.cu``, this
    script's yardstick) on flat float32 r and x with its own grid and
    scratch: (2,) [recon_loss, sparsity]."""
    n = r.numel()
    blocks = min(1024, -(-n // 1024))
    partials = torch.empty(2 * blocks, dtype=torch.float32, device=r.device)
    out = torch.empty(2, dtype=torch.float32, device=r.device)
    err = lib.elbo_terms_twopass(r.data_ptr(), x.data_ptr(), pw.data_ptr(), n,
                                 partials.data_ptr(), blocks, out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"elbo_terms_twopass launch failed: cudaError {err}")
    return out


def twopass_library():
    """``csrc/elbo_terms_twopass.cu`` loaded, its entry's argtypes set."""
    import ctypes

    from causalvae_tpu_torch.ops.kernels import _build

    lib = _build.load("elbo_terms_twopass")
    lib.elbo_terms_twopass.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                       + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.elbo_terms_twopass.restype = ctypes.c_int
    return lib


class TwoPassTerms(torch.autograd.Function):
    """The ELBO terms as the port ran them before the one-launch kernels:
    pos_weight(x) in ATen, recon cast to float32, the two-launch forward, and
    the plain backward's ATen passes on the card."""

    @staticmethod
    def forward(ctx, recon, x, elbo, lib):
        pw = elbo.pos_weight(x)
        ctx.save_for_backward(recon, x, pw)
        ctx.elbo = elbo
        return twopass_forward(lib, recon.detach().float().contiguous().view(-1),
                               x.float().contiguous().view(-1), pw)

    @staticmethod
    def backward(ctx, g):
        recon, x, pw = ctx.saved_tensors
        return ctx.elbo._plain_bwd(g, recon, x, pw)[0], None, None, None


def ulps_apart(a: float, b: float) -> int:
    """How many float32 values lie between a and b (0: equal)."""
    ia, ib = (int(np.array([v], np.float32).view(np.int32)[0]) for v in (a, b))
    return abs(ia - ib)


def check_elbo(elbo, gen, dev):
    """Rows 5 and 5b, the ELBO terms' forward (``elbo_terms``) and backward
    (``elbo_terms_bwd``) kernels, f32 and bf16 recon (x f32), at the vessel
    batch, ragged lengths and views offset by one element (recon and x
    both: the vector path after a scalar head; recon alone: every element
    on the scalar path):

    - the forward with pos_weight inside and with the caller's, against the
      plain version on the card (rel 1e-5: sums of non-negative terms in
      another order; the plain version on the bf16 values in f32), its pw
      within 1 float32 ulp of ``pos_weight(x)`` (0 expected on a mask);
    - the backward against the plain backward on CPU copies, bit for bit
      (d recon in recon's type, d x);
    - each call exactly one launch, counted bf16 where recon is bf16; equal
      bits on a repeat and for two calls back to back on one stream.

    Timed at the vessel batch (n = ELBO_N), L2 cold (``graph_ms``: L2_SETS
    input sets in a CUDA graph of GRAPH_CALLS calls), in turns
    (``in_turns``) with the earlier two-launch forward (the yardstick; in
    bf16 after the cast to f32 that the earlier wrapper made), the plain
    versions (the plain backward is
    the earlier backward's ATen passes), the eager back-to-back reading of
    ``cuda_ms`` (host-bound), the bounds, and an ATen ``sum`` over the same
    63 MB as the card's read rate (not the same function). Then one forward
    and backward of ``vessel_recon_terms_fused``, and of the same function
    as the port ran it before (``TwoPassTerms``), profiled: device kernels,
    full-size passes, device time."""
    lib = twopass_library()
    counts = lambda: (elbo.LAUNCHES, elbo.LAUNCHES_BF16, elbo.BWD_LAUNCHES,
                      elbo.BWD_LAUNCHES_BF16)
    g = torch.tensor([0.7, 0.3, 0.0], device=dev)
    recs = {"elbo_terms": {"library_ms": None}, "elbo_terms_bwd": {"library_ms": None}}
    for dtype in (torch.float32, torch.bfloat16):
        tag, bf16 = str(dtype)[6:], dtype == torch.bfloat16
        for n in ELBO_CASES:
            for r_off, x_off in ((0, 0), (1, 1), (1, 0)):
                if n == ELBO_N and (r_off, x_off) == (1, 0):
                    continue  # every element on the scalar path: checked at the others
                xs = (torch.rand(n + x_off, generator=gen) > 0.9).float().to(dev)[x_off:]
                rs = torch.randn(n + r_off, generator=gen).to(dev, dtype)[r_off:]
                rs[: min(n, 3)] = torch.tensor([0.0, -0.0, 0.05][: min(n, 3)], dtype=dtype)
                pw = elbo.pos_weight(xs)
                before = counts()
                got = elbo.elbo_terms(rs, xs)
                given = elbo.elbo_terms(rs, xs, pw)
                again = elbo.elbo_terms(rs, xs)
                d_r, d_x = elbo.elbo_terms_bwd(g, rs, xs, got[2], True, True)
                d_r2, _ = elbo.elbo_terms_bwd(g, rs, xs, got[2])
                torch.cuda.synchronize()
                moved = tuple(b - a for a, b in zip(before, counts()))
                if moved != (3, 3 * bf16, 2, 2 * bf16):
                    raise AssertionError(f"elbo {tag} n={n}: launches moved by {moved}")
                want = elbo._plain_terms(rs, xs, pw)
                rel = max(float(((o[:2] - want[:2]).abs() / want[:2].abs().clamp_min(1e-30)).max())
                          for o in (got, given))
                ulps = ulps_apart(float(got[2]), float(pw))
                ref_r, ref_x = elbo._plain_bwd(g.cpu(), rs.cpu(), xs.cpu(), got[2].cpu(),
                                               True, True)
                same_bwd = (torch.equal(d_r.cpu(), ref_r) and torch.equal(d_x.cpu(), ref_x)
                            and d_r.dtype == dtype and torch.equal(d_r, d_r2))
                log(f"[kernels] elbo_terms {tag} n={n} offsets {(r_off, x_off)}: "
                    f"{got.tolist()} vs plain {want.tolist()}, max rel {rel:.3e} (tol 1e-5), "
                    f"pw {ulps} ulp from pos_weight, given pw equal "
                    f"{float(given[2]) == float(pw)}, repeat equal "
                    f"{bool(torch.equal(got, again))}; backward bit-equal to the plain "
                    f"backward on the CPU {same_bwd}; launches {moved}")
                check(f"elbo_terms {tag} n={n} {(r_off, x_off)}", rel, 1e-5)
                if ulps > 1 or float(given[2]) != float(pw):
                    raise AssertionError(f"elbo_terms {tag} n={n}: pw {float(got[2])!r}, "
                                         f"given {float(given[2])!r}, pos_weight {float(pw)!r}")
                if not torch.equal(got, again):
                    raise AssertionError(f"elbo_terms {tag} n={n}: two runs differ")
                if not same_bwd:
                    raise AssertionError(f"elbo_terms_bwd {tag} n={n} {(r_off, x_off)}: not "
                                         f"the plain backward's bits")
                if n == ELBO_N and r_off == 0:
                    recs["elbo_terms"]["max_abs_err" + "_bf16" * bf16] = max_err(got[:2],
                                                                                  want[:2])
                    recs["elbo_terms_bwd"]["max_abs_err" + "_bf16" * bf16] = max(
                        max_err(d_r.cpu(), ref_r), max_err(d_x.cpu(), ref_x))
        del xs, rs, got, given, again, d_r, d_x, d_r2, ref_r, ref_x
        time_elbo(elbo, lib, gen, dev, dtype, g, recs)
    n = ELBO_N
    big = [torch.randn(2 * n, generator=gen).to(dev) for _ in range(L2_SETS)]
    aten_sum = graph_ms([lambda b=b: b.sum() for b in big])
    del big
    recs["elbo_terms"]["aten_sum_63MB_ms"] = aten_sum
    log(f"[kernels] ATen sum over {2 * n * 4} bytes (f32, L2 cold; not the same function, "
        f"the card's read rate): {aten_sum:.4f} ms = {2 * n * 4 / aten_sum / 1e9:.3f} TB/s")
    torch.cuda.empty_cache()
    return recs


def time_elbo(elbo, lib, gen, dev, dtype, g, recs):
    """check_elbo's timings and profiles at the vessel batch for one recon type."""
    n, bf16 = ELBO_N, dtype == torch.bfloat16
    tag, sfx = str(dtype)[6:], "_bf16" * bf16
    sets = [((torch.rand(n, generator=gen) > 0.9).float().to(dev),
             torch.randn(n, generator=gen).to(dev, dtype)) for _ in range(L2_SETS)]
    pws = [elbo.pos_weight(x) for x, _ in sets]
    elt = 2 if bf16 else 4
    fwd_bound, fwd_by = bound(n * (elt + 4) + 12, 12 * n)
    bwd_bound, bwd_by = bound(n * (2 * elt + 4) + 20, 12 * n)
    new_fwd, old_fwd = in_turns(
        [lambda x=x, r=r: elbo.elbo_terms(r, x) for x, r in sets],
        [lambda x=x, r=r, pw=pw: twopass_forward(lib, r.float(), x, pw)
         for (x, r), pw in zip(sets, pws)])
    new_bwd, old_bwd = in_turns(
        [lambda x=x, r=r, pw=pw: elbo.elbo_terms_bwd(g, r, x, pw)
         for (x, r), pw in zip(sets, pws)],
        [lambda x=x, r=r, pw=pw: elbo._plain_bwd(g, r, x, pw) for (x, r), pw in zip(sets, pws)])
    x0, r0 = sets[0]
    eager_new = cuda_ms(lambda: elbo.elbo_terms(r0, x0))
    eager_old = cuda_ms(lambda: twopass_forward(lib, r0.float(), x0, pws[0]))
    plain_fwd = cuda_ms(lambda: elbo._plain_terms(r0, x0, elbo.pos_weight(x0)))
    plain_bwd = cuda_ms(lambda: elbo._plain_bwd(g, r0, x0, pws[0]))
    recs["elbo_terms"].update({
        "ms" + sfx: new_fwd, "bound_ms" + sfx: fwd_bound, "plain_ms" + sfx: plain_fwd,
        "twopass_ms" + sfx: old_fwd, "eager_ms" + sfx: eager_new,
        "twopass_eager_ms" + sfx: eager_old})
    recs["elbo_terms_bwd"].update({
        "ms" + sfx: new_bwd, "bound_ms" + sfx: bwd_bound, "plain_ms" + sfx: plain_bwd,
        "plain_graph_ms" + sfx: old_bwd})
    if not bf16:
        recs["elbo_terms"]["bound_by"], recs["elbo_terms_bwd"]["bound_by"] = fwd_by, bwd_by
    log(f"[kernels] elbo_terms {tag} n={n}, L2 cold (CUDA graph of {GRAPH_CALLS} calls over "
        f"{L2_SETS} input sets; grid {elbo._device_scratch(dev)[0]} blocks): kernel "
        f"{new_fwd:.4f} ms, the earlier two-launch forward {old_fwd:.4f} ms{' (with the cast to f32)' * bf16}, bound {fwd_bound:.4f} ms "
        f"({fwd_by}), kernel/bound {new_fwd / fwd_bound:.2f}; eager back to back (cuda_ms, "
        f"the host's rate): kernel {eager_new:.4f} ms, earlier {eager_old:.4f} ms; plain "
        f"{plain_fwd:.4f} ms; library none")
    log(f"[kernels] elbo_terms_bwd {tag} n={n}, L2 cold: kernel {new_bwd:.4f} ms, the plain "
        f"backward's ATen passes (the earlier backward) {old_bwd:.4f} ms (eager "
        f"{plain_bwd:.4f} ms), bound {bwd_bound:.4f} ms ({bwd_by}), kernel/bound "
        f"{new_bwd / bwd_bound:.2f}; library none")
    grads = [torch.tensor(0.7, device=dev), torch.tensor(0.3, device=dev)]
    leaves = [r.detach().requires_grad_(True) for _, r in sets]

    def fused(x, r):
        torch.autograd.backward(elbo.vessel_recon_terms_fused(r, x), grads)
        r.grad = None

    def earlier(x, r):
        out = TwoPassTerms.apply(r, x, elbo, lib)
        torch.autograd.backward([out[0], out[1]], grads)
        r.grad = None

    for name, fn in (("one-launch", fused), ("earlier", earlier)):
        prof = profile_kernels([lambda x=x, r=r: fn(x, r) for (x, _), r in zip(sets, leaves)])
        recs["elbo_terms"][f"function_{name}{sfx}"] = {
            k: prof[k] for k in ("kernels", "full_size", "device_ms")}
        log(f"[kernels] vessel_recon_terms_fused forward + backward {tag}, {name} kernels: "
            f"{prof['kernels']:g} device kernels, {prof['full_size']:g} of them >= "
            f"{FULL_PASS_US} us, {prof['device_ms']:.4f} ms device time; "
            + "; ".join(f"{k} x{c:g} {t:.4f} ms" for k, (c, t) in prof["by_name"].items()))
    del sets, pws, leaves
    torch.cuda.empty_cache()


def check_bn_rows(batchnorm, gen, dev):
    """The channels-last BN entries (the packed model's NHWC BatchNorms)
    against their plain versions at the (M, C) shapes of the packed step:
    |d| <= 1e-5 of the per-channel sum of absolute terms."""
    for m, c in ((8 * 96 * 160, 512), (8 * 96 * 160, 1024), (8 * 48 * 80, 256),
                 (8 * 24 * 40, 256)):
        x = (torch.randn(m, c, generator=gen) * 2 + 1).to(dev)
        dy = torch.randn(m, c, generator=gen).to(dev)
        sums = batchnorm.bn_stats_rows(x)
        mean = sums[0] / m
        inv = torch.rsqrt(torch.clamp(sums[1] / m - mean * mean, min=0.0) + 1e-5)
        bsums = batchnorm.bn_bwd_sums_rows(dy, x, mean, inv)
        torch.cuda.synchronize()
        xhat = (x - mean) * inv
        ref_s = torch.stack([x.sum(0), (x * x).sum(0)])
        ref_b = torch.stack([dy.sum(0), (dy * xhat).sum(0)])
        abs_s = torch.stack([x.abs().sum(0), (x * x).sum(0)])
        abs_b = torch.stack([dy.abs().sum(0), (dy * xhat).abs().sum(0)])
        ratio_s = float(((sums - ref_s).abs() / abs_s).max())
        ratio_b = float(((bsums - ref_b).abs() / abs_b).max())
        log(f"[kernels] bn rows {(m, c)}: stats max|d|/sum|term| {ratio_s:.3e}, "
            f"bwd {ratio_b:.3e} (tol 1e-5)")
        check(f"bn_stats_rows {(m, c)}", ratio_s, 1e-5)
        check(f"bn_bwd_rows {(m, c)}", ratio_b, 1e-5)
        if c == 1024:
            ms = cuda_ms(lambda: batchnorm.bn_stats_rows(x))
            ms_b = cuda_ms(lambda: batchnorm.bn_bwd_sums_rows(dy, x, mean, inv))
            log(f"[kernels] bn rows {(m, c)} f32: stats {ms:.4f} ms (bound "
                f"{bound(m * c * 4, 3 * m * c)[0]:.4f}), bwd {ms_b:.4f} ms (bound "
                f"{bound(2 * m * c * 4, 5 * m * c)[0]:.4f})")


def stage_real_fraction(recipe: str, levels: int) -> float:
    """Share of the lifted kernel's blocks that are not structural zeros
    (every stage's base kernel is 3x3)."""
    from causalvae_tpu_torch.ops.subpixel import _tap_index

    idx, _ = _tap_index(recipe, 3, levels)
    return float((idx > 0).float().mean())


def stage_work(stage, x_shape, co_packed, recipe, levels, prologue=True, elt=4) -> dict:
    """The base conv behind one packed stage call and the work its function
    needs: base Ci and Co, output levels, the real flops (2 * outputs * 9
    taps * Ci * Co for conv and stem; convT 9 taps per input pixel over its
    four outputs; the dgrad and the wgrad each the same), and the bytes, with
    ``elt`` bytes an element of x, y, dy, dx and the kernel the kernels read
    (4 for f32, 2 for bf16; mul, add, bias, dW, db, dmul and dadd are f32),
    of the forward (x, mul, add, base kernel, bias read once, y written
    once), of the backward (x, dy, mul, add, kernel read; dx, dW, db, dmul,
    dadd written), of the dgrad (dy and the kernel read, dx written; with a
    prologue also x, mul and add read and dmul, dadd written) and of the
    wgrad (x, dy read, with a prologue mul and add; dW and db written)."""
    b, hc, wc, ci_p = x_shape
    lout = stage.out_levels(recipe, levels)
    ci, co = ci_p >> (2 * levels), co_packed >> (2 * lout)
    grid_lv = levels if recipe == "convT" else lout
    pixels = b * (hc << grid_lv) * (wc << grid_lv)
    elems_x, elems_y, elems_w = b * hc * wc * ci_p, b * hc * wc * co_packed, 9 * ci * co
    affine = 2 * ci_p if prologue else 0
    return dict(ci=ci, co=co, lout=lout, flops=2 * pixels * 9 * ci * co,
                bytes_fwd=elt * (elems_x + elems_y + elems_w) + 4 * (2 * ci_p + co_packed),
                bytes_bwd=(elt * (2 * elems_x + elems_y + elems_w)
                           + 4 * (elems_w + 3 * ci_p + co_packed)),
                bytes_dgrad=(elt * (elems_y + elems_w + elems_x + (elems_x if prologue else 0))
                             + 4 * 2 * affine),
                bytes_wgrad=elt * (elems_x + elems_y) + 4 * (affine + elems_w + co_packed))


def check_stage(stage, gen, dev):
    """Both stage kernels against stage_reference and its autograd backward
    at the 14 shapes of the packed-fused step, f32 (TF32 off; max|d| <=
    1e-4 max|ref|: sums of up to 9216 products in another order) and bf16
    (against the plain version in f32 on the bf16 values, 1e-2 max|ref|:
    the kernel rounds the activation and its outputs to bf16). Random dense
    kernels at the lifted shapes. Every shape timed in f32 (the per-step
    sum); at dec_out and dec_ct[4] also the plain version and, labelled
    lifted, the old library yardstick: F.conv2d with the lifted kernel on
    the pre-activated, pre-padded input in channels-last (forward) and that
    conv's autograd backward. The records' bounds count the real work and
    the bytes of the path's function (``stage_work``); the lifted work's
    bound stays beside it as ``bound_ms_lifted``. The wgrad-only entry
    (``stage_bwd_wgrad``, the lifted wgrad that the fine wgrad replaced)
    must give stage_bwd's dW and db bit for bit (the same kernels); it is
    timed at every shape too (the yardstick of check_stage_wgrad_fine), and
    at dec_out beside its plain version (the autograd of stage_reference in
    the kernel and the bias alone)."""
    recs = {}
    totals = {"fwd": 0.0, "bwd": 0.0, "wgrad": 0.0, "lifted": 0.0, "real": 0.0,
              "wgrad_by_shape": {}}
    for name, (b, h, w, ci), co, k, pad_lo, slope, recipe, levels in STAGE_SHAPES:
        prologue = slope is not None
        slope = 0.01 if slope is None else slope
        x32 = torch.randn(b, h, w, ci, generator=gen).to(dev)
        kern32 = (torch.randn(k, k, ci, co, generator=gen) * (k * k * ci) ** -0.5).to(dev)
        bias = torch.randn(co, generator=gen).to(dev)
        dy32 = torch.randn(b, h, w, co, generator=gen).to(dev)
        mul = (torch.rand(ci, generator=gen) + 0.5).to(dev) if prologue else torch.ones(ci, device=dev)
        add = torch.randn(ci, generator=gen).to(dev) if prologue else torch.zeros(ci, device=dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            x, kern, dy = (t.to(dtype) for t in (x32, kern32, dy32))
            y = stage.stage_fwd(x, mul, add, kern, bias, slope, pad_lo, prologue)
            grads = stage.stage_bwd(x, dy, mul, add, kern, slope, pad_lo, prologue)
            wgrads = stage.stage_bwd_wgrad(x, dy, mul, add, kern, slope, pad_lo, prologue)
            torch.cuda.synchronize()
            if not (torch.equal(wgrads[0], grads[1]) and torch.equal(wgrads[1], grads[2])):
                raise AssertionError(f"stage {name} {dtype}: stage_bwd_wgrad's dW/db differ "
                                     "from stage_bwd's")
            del wgrads
            xf, kf, dyf = x.float(), kern.float(), dy.float()
            want = (stage.stage_reference(xf, mul, add, kf, bias, slope, pad_lo, prologue),
                    *stage.stage_bwd_reference(xf, dyf, mul, add, kf, slope, pad_lo, prologue))
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            parts = []
            for term, got, ref in zip(("y", "dx", "dW", "db", "dmul", "dadd"), (y, *grads), want):
                err, scale = max_err(got, ref), float(ref.abs().max())
                parts.append(f"{term} {err:.2e}/{rel * scale + 1e-6:.2e}")
                check(f"stage {name} {dtype} {term}", err, rel * scale + 1e-6)
                errs[dtype, term] = err
            log(f"[kernels] stage {name} {str(dtype)[6:]} x {(b, h, w, ci)} -> {co} K{k} "
                f"pad {pad_lo} prologue {prologue}: max|d|/tol " + ", ".join(parts))
            del y, grads, want
        x, kern, dy = x32, kern32, dy32
        flops = 2 * b * h * w * k * k * ci * co
        real = stage_real_fraction(recipe, levels)
        ms_f = cuda_ms(lambda: stage.stage_fwd(x, mul, add, kern, bias, slope, pad_lo,
                                               prologue), iters=10, warmup=2)
        ms_b = cuda_ms(lambda: stage.stage_bwd(x, dy, mul, add, kern, slope, pad_lo,
                                               prologue), iters=10, warmup=2)
        ms_wg = cuda_ms(lambda: stage.stage_bwd_wgrad(x, dy, mul, add, kern, slope, pad_lo,
                                                      prologue), iters=10, warmup=2)
        elems_x, elems_y, elems_w = b * h * w * ci, b * h * w * co, k * k * ci * co
        bnd_f, by_f = bound(4 * (elems_x + elems_y + elems_w + 2 * ci + co), flops)
        bnd_b, by_b = bound(4 * (2 * elems_x + elems_y + 2 * elems_w + 3 * ci + co), 2 * flops)
        totals["fwd"] += ms_f
        totals["bwd"] += ms_b
        totals["wgrad"] += ms_wg
        totals["wgrad_by_shape"][name] = ms_wg
        totals["lifted"] += flops
        totals["real"] += flops * real
        log(f"[kernels] stage {name} f32: forward {ms_f:.4f} ms (bound {bnd_f:.4f}, {by_f}; "
            f"{flops / ms_f / 1e9:.1f} TFLOP/s lifted), backward {ms_b:.4f} ms (bound "
            f"{bnd_b:.4f}), wgrad-only entry {ms_wg:.4f} ms; lifted {flops / 1e9:.1f} GFLOP "
            f"forward, real work {flops * real / 1e9:.2f} GFLOP ({real:.4f} of it)")
        if name in STAGE_LIBRARY:
            pre = x * mul + add
            act = torch.where(pre >= 0, pre, slope * pre) if prologue else x
            hi = k - 1 - pad_lo
            a_pad = F.pad(act, (0, 0, pad_lo, hi, pad_lo, hi)).permute(0, 3, 1, 2)
            a_pad = a_pad.detach().requires_grad_(True)
            w_oihw = kern.permute(3, 2, 0, 1).contiguous().detach().requires_grad_(True)
            b_lib = bias.detach().clone().requires_grad_(True)
            y_lib = F.conv2d(a_pad, w_oihw, b_lib)
            dy_lib = dy.permute(0, 3, 1, 2)
            lib_f = cuda_ms(lambda: F.conv2d(a_pad, w_oihw, b_lib), iters=10, warmup=2)
            lib_b = cuda_ms(lambda: torch.autograd.grad(y_lib, (a_pad, w_oihw, b_lib), dy_lib,
                                                        retain_graph=True), iters=10, warmup=2)
            plain_f = cuda_ms(lambda: stage.stage_reference(x, mul, add, kern, bias, slope,
                                                            pad_lo, prologue), iters=10, warmup=2)
            leaves = [t.detach().requires_grad_(True) for t in (x, mul, add, kern, bias)]
            y_ref = stage.stage_reference(*leaves, slope, pad_lo, prologue)
            plain_b = cuda_ms(lambda: torch.autograd.grad(y_ref, leaves, dy, retain_graph=True,
                                                          allow_unused=True), iters=10, warmup=2)
            log(f"[kernels] stage {name} f32: plain forward {plain_f:.4f} ms, backward "
                f"{plain_b:.4f} ms; library (lifted kernel) F.conv2d channels-last forward "
                f"{lib_f:.4f} ms, autograd backward {lib_b:.4f} ms")
            plain_wg = cuda_ms(lambda: torch.autograd.grad(
                y_ref, leaves[3:], dy, retain_graph=True), iters=10, warmup=2)
            log(f"[kernels] stage {name} f32: plain wgrad (autograd in kernel and bias) "
                f"{plain_wg:.4f} ms")
            if name == STAGE_RECORD:
                work = stage_work(stage, (b, h, w, ci), co, recipe, levels, prologue)
                real_f = bound(work["bytes_fwd"], work["flops"])
                real_b = bound(work["bytes_bwd"], 2 * work["flops"])
                real_wg = bound(work["bytes_wgrad"], work["flops"])
                recs["stage_fwd"] = dict(max_abs_err=errs[torch.float32, "y"], ms=ms_f,
                                         plain_ms=plain_f, bound_ms=real_f[0],
                                         bound_by=real_f[1], bound_ms_lifted=bnd_f,
                                         library_ms_lifted=lib_f)
                recs["stage_bwd"] = dict(
                    max_abs_err=max(errs[torch.float32, t] for t in
                                    ("dx", "dW", "db", "dmul", "dadd")),
                    ms=ms_b, plain_ms=plain_b, bound_ms=real_b[0], bound_by=real_b[1],
                    bound_ms_lifted=bnd_b, library_ms_lifted=lib_b)
                recs["stage_bwd_wgrad"] = dict(
                    max_abs_err=max(errs[torch.float32, t] for t in ("dW", "db")),
                    ms=ms_wg, plain_ms=plain_wg, bound_ms=real_wg[0], bound_by=real_wg[1])
            del a_pad, w_oihw, y_lib, leaves, y_ref
        del x32, kern32, dy32, x, kern, dy
        torch.cuda.empty_cache()
    log(f"[kernels] stage, the 14 shapes of one batch-8 step in f32: forward "
        f"{totals['fwd']:.3f} ms, backward {totals['bwd']:.3f} ms, wgrad-only entry "
        f"{totals['wgrad']:.3f} ms; lifted "
        f"{totals['lifted'] / 1e9:.1f} GFLOP per forward (real work "
        f"{totals['real'] / 1e9:.1f}), forward bound of the lifted work "
        f"{totals['lifted'] / 67e12 * 1e3:.3f} ms")
    return recs, totals


def check_stage_fine(stage, gen, dev, lifted_fwd_ms: float):
    """The fine-grid stage forward against stage_fine_reference at the 14
    shapes of the packed-fused step, with random base kernels (3, 3, Ci, Co)
    and packed-width mul/add/bias: f32 (TF32 off; max|d| <= 1e-4 max|ref|:
    sums of up to 9 * 512 products in another order) and bf16 (against the
    plain version in f32 on the bf16 values, 1e-2 max|ref|: the kernel rounds
    the activation and its outputs to bf16). Every shape timed in f32 beside
    its bound (real work and bytes, ``stage_work``) and the library call on
    the fine grid: F.conv2d / F.conv_transpose2d of the base kernel on the
    unpacked, pre-activated input (channels-last, TF32 off); at dec_out and
    dec_ct[4] also the plain version and that library call's autograd
    backward (row 7's yardstick). The 14-shape sum is logged beside the
    lifted kernel's (``lifted_fwd_ms``, the same run). Returns the
    stage_fwd_fine record and {shape: (library forward ms, library backward
    ms)} at the STAGE_LIBRARY shapes."""
    from causalvae_tpu_torch.ops.subpixel import depth_to_space_n

    recs, lib_times = {}, {}
    total = {"ms": 0.0, "bound": 0.0, "lib": 0.0, "ms_bf16": 0.0, "bound_bf16": 0.0,
             "lib_bf16": 0.0}
    for name, (b, h, w, ci_p), co_p, _, _, slope, recipe, levels in STAGE_SHAPES:
        prologue = slope is not None
        slope = 0.01 if slope is None else slope
        work = stage_work(stage, (b, h, w, ci_p), co_p, recipe, levels)
        work_bf16 = stage_work(stage, (b, h, w, ci_p), co_p, recipe, levels, elt=2)
        ci, co = work["ci"], work["co"]
        x32 = torch.randn(b, h, w, ci_p, generator=gen).to(dev)
        w32 = (torch.randn(3, 3, ci, co, generator=gen) * (9 * ci) ** -0.5).to(dev)
        bias = torch.randn(co_p, generator=gen).to(dev)
        mul = ((torch.rand(ci_p, generator=gen) + 0.5).to(dev) if prologue
               else torch.ones(ci_p, device=dev))
        add = torch.randn(ci_p, generator=gen).to(dev) if prologue else torch.zeros(ci_p, device=dev)
        args = (slope, recipe, levels, prologue)
        parts, err32 = [], None
        for dtype in (torch.float32, torch.bfloat16):
            x, wk = x32.to(dtype), w32.to(dtype)
            y = stage.stage_fwd_fine(x, mul, add, wk, bias, *args)
            torch.cuda.synchronize()
            ref = stage.stage_fine_reference(x.float(), mul, add, wk.float(), bias, *args)
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            if y.shape != ref.shape or y.dtype != dtype:
                raise AssertionError(f"stage_fwd_fine {name}: {tuple(y.shape)} {y.dtype}, "
                                     f"want {tuple(ref.shape)} {dtype}")
            err, tol = max_err(y, ref), rel * float(ref.abs().max()) + 1e-6
            parts.append(f"{str(dtype)[6:]} max|d| {err:.2e} (tol {tol:.2e})")
            check(f"stage_fwd_fine {name} {dtype}", err, tol)
            if dtype == torch.float32:
                err32 = err
            del y, ref
        x, wk = x32, w32
        ms = cuda_ms(lambda: stage.stage_fwd_fine(x, mul, add, wk, bias, *args),
                     iters=10, warmup=2)
        bnd, by = bound(work["bytes_fwd"], work["flops"])
        # the library call: the base conv on the unpacked, pre-activated fine input
        pre = x * mul + add
        act = torch.where(pre >= 0, pre, slope * pre) if prologue else x
        a_fine = depth_to_space_n(act, levels).permute(0, 3, 1, 2)
        bias_base = bias[:co]
        if recipe == "convT":
            w_lib = wk.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)

            def library(a=a_fine, wl=w_lib, bl=bias_base):
                return F.conv_transpose2d(a, wl, bl, stride=2, padding=1, output_padding=1)
        else:
            w_lib = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            stride = 2 if recipe == "stem" else 1

            def library(a=a_fine, wl=w_lib, bl=bias_base):
                return F.conv2d(a, wl, bl, stride=stride, padding=1)

        lib = cuda_ms(library, iters=10, warmup=2)
        # bf16: the kernel on bf16 x and kernel, cuDNN on the bf16 fine input
        xb, wkb = x.to(torch.bfloat16), wk.to(torch.bfloat16)
        ms_b = cuda_ms(lambda: stage.stage_fwd_fine(xb, mul, add, wkb, bias, *args),
                       iters=10, warmup=2)
        bnd_b, _ = bound(work_bf16["bytes_fwd"], work_bf16["flops"], torch.bfloat16)
        lib_args = (a_fine.to(torch.bfloat16), w_lib.to(torch.bfloat16),
                    bias_base.to(torch.bfloat16))
        lib_b = cuda_ms(lambda: library(*lib_args), iters=10, warmup=2)
        for key, val in (("ms", ms), ("bound", bnd), ("lib", lib), ("ms_bf16", ms_b),
                         ("bound_bf16", bnd_b), ("lib_bf16", lib_b)):
            total[key] += val
        log(f"[kernels] stage_fine {name} {recipe} L{levels} base {ci}->{co} prologue "
            f"{prologue}: {', '.join(parts)}; f32 {ms:.4f} ms, real {work['flops'] / 1e9:.2f} "
            f"GFLOP, {work['bytes_fwd'] / 1e6:.1f} MB, bound {bnd:.4f} ms ({by}), kernel/bound "
            f"{ms / bnd:.2f}; library (fine grid, base kernel) {lib:.4f} ms; bf16 {ms_b:.4f} "
            f"ms, bound {bnd_b:.4f} ms, library {lib_b:.4f} ms")
        if name in STAGE_LIBRARY:
            plain = cuda_ms(lambda: stage.stage_fine_reference(x, mul, add, wk, bias, *args),
                            iters=10, warmup=2)
            a_leaf = a_fine.detach().requires_grad_(True)
            w_leaf = w_lib.detach().requires_grad_(True)
            b_leaf = bias_base.detach().clone().requires_grad_(True)
            y_lib = library(a_leaf, w_leaf, b_leaf)
            dy = torch.randn_like(y_lib)
            lib_b = cuda_ms(lambda: torch.autograd.grad(y_lib, (a_leaf, w_leaf, b_leaf), dy,
                                                        retain_graph=True), iters=10, warmup=2)
            lib_times[name] = (lib, lib_b)
            log(f"[kernels] stage_fine {name} f32: plain {plain:.4f} ms; library backward "
                f"(fine grid autograd) {lib_b:.4f} ms")
            if name == STAGE_RECORD:
                recs["stage_fwd_fine"] = dict(max_abs_err=err32, ms=ms, plain_ms=plain,
                                              library_ms=lib, bound_ms=bnd, bound_by=by,
                                              ms_bf16=ms_b, library_ms_bf16=lib_b,
                                              bound_ms_bf16=bnd_b)
            del a_leaf, w_leaf, b_leaf, y_lib, dy
        del x32, w32, x, wk, pre, act, a_fine, w_lib, xb, wkb, lib_args
        torch.cuda.empty_cache()
    log(f"[kernels] stage forward, the 14 shapes of one batch-8 step in f32: fine-grid "
        f"kernel {total['ms']:.3f} ms, lifted kernel {lifted_fwd_ms:.3f} ms (same run), "
        f"bound of the real work {total['bound']:.3f} ms, library on the fine grid "
        f"{total['lib']:.3f} ms; in bf16: kernel {total['ms_bf16']:.3f} ms, bound "
        f"{total['bound_bf16']:.3f} ms, library {total['lib_bf16']:.3f} ms")
    recs["stage_fwd_fine"].update(fourteen_shape_sums(total))
    return recs, lib_times


def check_stage_dgrad_fine(stage, gen, dev, lifted_bwd_ms: float):
    """The fine-grid stage dgrad against stage_dgrad_fine_reference at the 14
    shapes of the packed-fused step, with random base kernels and
    packed-width mul/add, each of dx, dmul and dadd: f32 (TF32 off; max|d|
    <= 1e-4 max|ref|: sums of up to 9 * 256 products, and dmul/dadd over
    millions of pixels, in another order) and bf16 (against the plain
    version in f32 on the bf16 values, 1e-2 max|ref|: dx rounds to bf16);
    two launches on the same inputs give the same bits. Every shape timed in
    f32 beside its bound (real work and the dgrad's bytes, ``stage_work``)
    and, as the library yardstick (timed only), cuDNN's dgrad alone on the
    fine grid: aten.convolution_backward(output_mask=[True, False, False])
    of the base conv on the unpacked, pre-activated input, channels-last
    (``fine_library``). At dec_out and dec_ct[4] also the plain version.
    The 14-shape sum is logged beside the lifted backward's
    (``lifted_bwd_ms``: the same run). Returns the stage_dgrad_fine record."""
    recs = {}
    total = {"ms": 0.0, "bound": 0.0, "lib": 0.0, "ms_bf16": 0.0, "bound_bf16": 0.0,
             "lib_bf16": 0.0}
    for name, (b, h, w, ci_p), co_p, _, _, slope, recipe, levels in STAGE_SHAPES:
        prologue = slope is not None
        slope = 0.01 if slope is None else slope
        work = stage_work(stage, (b, h, w, ci_p), co_p, recipe, levels, prologue)
        work_bf16 = stage_work(stage, (b, h, w, ci_p), co_p, recipe, levels, prologue, elt=2)
        ci, co = work["ci"], work["co"]
        x32 = torch.randn(b, h, w, ci_p, generator=gen).to(dev)
        w32 = (torch.randn(3, 3, ci, co, generator=gen) * (9 * ci) ** -0.5).to(dev)
        dy32 = torch.randn(b, h, w, co_p, generator=gen).to(dev)
        mul = ((torch.rand(ci_p, generator=gen) + 0.5).to(dev) if prologue
               else torch.ones(ci_p, device=dev))
        add = torch.randn(ci_p, generator=gen).to(dev) if prologue else torch.zeros(ci_p, device=dev)
        args = (slope, recipe, levels, prologue)
        parts, err32 = [], {}
        for dtype in (torch.float32, torch.bfloat16):
            x, wk, dy = (t.to(dtype) for t in (x32, w32, dy32))
            got = stage.stage_dgrad_fine(x, dy, mul, add, wk, *args)
            again = stage.stage_dgrad_fine(x, dy, mul, add, wk, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"stage_dgrad_fine {name} {dtype}: two launches differ")
            ref = stage.stage_dgrad_fine_reference(x.float(), dy.float(), mul, add, wk.float(),
                                                   *args)
            if got[0].dtype != dtype:
                raise AssertionError(f"stage_dgrad_fine {name}: dx {got[0].dtype}, want {dtype}")
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            for term, g, r in zip(("dx", "dmul", "dadd"), got, ref):
                if g.shape != r.shape:
                    raise AssertionError(f"stage_dgrad_fine {name} {term}: {tuple(g.shape)}, "
                                         f"want {tuple(r.shape)}")
                err, tol = max_err(g, r), rel * float(r.abs().max()) + 1e-6
                parts.append(f"{str(dtype)[6:]} {term} {err:.2e}/{tol:.2e}")
                check(f"stage_dgrad_fine {name} {dtype} {term}", err, tol)
                if dtype == torch.float32:
                    err32[term] = err
            del got, again, ref
        x, wk, dy = x32, w32, dy32
        ms = cuda_ms(lambda: stage.stage_dgrad_fine(x, dy, mul, add, wk, *args),
                     iters=10, warmup=2)
        bnd, by = bound(work["bytes_dgrad"], work["flops"])
        library = fine_library(x, dy, mul, add, wk, slope, recipe, levels, work["lout"],
                               prologue)
        lib = cuda_ms(lambda: library([True, False, False]), iters=10, warmup=2)
        xb, wkb, dyb = (t.to(torch.bfloat16) for t in (x, wk, dy))
        ms_b = cuda_ms(lambda: stage.stage_dgrad_fine(xb, dyb, mul, add, wkb, *args),
                       iters=10, warmup=2)
        bnd_b, _ = bound(work_bf16["bytes_dgrad"], work_bf16["flops"], torch.bfloat16)
        library_b = fine_library(xb, dyb, mul, add, wkb, slope, recipe, levels, work["lout"],
                                 prologue)
        lib_b = cuda_ms(lambda: library_b([True, False, False]), iters=10, warmup=2)
        for key, val in (("ms", ms), ("bound", bnd), ("lib", lib), ("ms_bf16", ms_b),
                         ("bound_bf16", bnd_b), ("lib_bf16", lib_b)):
            total[key] += val
        log(f"[kernels] stage_dgrad_fine {name} {recipe} L{levels} base {ci}->{co} prologue "
            f"{prologue}: {', '.join(parts)} (max|d|/tol), repeat equal; f32 {ms:.4f} ms, "
            f"real {work['flops'] / 1e9:.2f} GFLOP, {work['bytes_dgrad'] / 1e6:.1f} MB, bound "
            f"{bnd:.4f} ms ({by}), kernel/bound {ms / bnd:.2f}; library (cuDNN on the fine "
            f"grid) dgrad {lib:.4f} ms; bf16 {ms_b:.4f} ms, bound {bnd_b:.4f} ms, cuDNN "
            f"{lib_b:.4f} ms")
        if name in STAGE_LIBRARY:
            plain = cuda_ms(lambda: stage.stage_dgrad_fine_reference(x, dy, mul, add, wk, *args),
                            iters=10, warmup=2)
            log(f"[kernels] stage_dgrad_fine {name} f32: plain {plain:.4f} ms")
            if name == STAGE_RECORD:
                recs["stage_dgrad_fine"] = dict(max_abs_err=max(err32.values()), ms=ms,
                                                plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                                bound_by=by, ms_bf16=ms_b, library_ms_bf16=lib_b,
                                                bound_ms_bf16=bnd_b)
        del x32, w32, dy32, x, wk, dy, library, xb, wkb, dyb, library_b
        torch.cuda.empty_cache()
    log(f"[kernels] stage dgrad, the 14 shapes of one batch-8 step in f32: fine-grid kernel "
        f"{total['ms']:.3f} ms, bound of the real work {total['bound']:.3f} ms, cuDNN dgrad "
        f"on the fine grid {total['lib']:.3f} ms; the same run's lifted backward "
        f"{lifted_bwd_ms:.3f} ms; in bf16: kernel {total['ms_bf16']:.3f} ms, bound "
        f"{total['bound_bf16']:.3f} ms, cuDNN {total['lib_bf16']:.3f} ms")
    recs["stage_dgrad_fine"].update(fourteen_shape_sums(total))
    return recs


def fourteen_shape_sums(total: dict) -> dict:
    """A fine-grid stage record's sums over the 14 shapes of one step, f32
    and bf16: the kernel's time, its bound and the cuDNN call's time."""
    return {f"{k}_14{dt}": total[f"{src}{dt}"] for dt in ("", "_bf16")
            for k, src in (("ms", "ms"), ("bound_ms", "bound"), ("library_ms", "lib"))}


def fine_library(x, dy, mul, add, wk, slope, recipe, levels, lout, prologue):
    """cuDNN on the fine grid (timed only, never on a path): a function of an
    output mask that runs aten.convolution_backward of the base conv on the
    unpacked, pre-activated input, channels-last ([True, False, False]: the
    dgrad alone; [False, True, True]: dW and db alone)."""
    from causalvae_tpu_torch.ops.subpixel import depth_to_space_n

    pre = x * mul + add
    act = (torch.where(pre >= 0, pre, slope * pre) if prologue else x).to(x.dtype)
    a_fine = depth_to_space_n(act, levels).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    dy_fine = depth_to_space_n(dy, lout).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    convt = recipe == "convT"
    w_lib = (wk.permute(2, 3, 0, 1) if convt else wk.permute(3, 2, 0, 1)).contiguous(
        memory_format=torch.channels_last)
    stride = 1 if recipe == "conv" else 2
    co = w_lib.shape[1] if convt else w_lib.shape[0]

    def library(mask):
        return torch.ops.aten.convolution_backward(
            dy_fine, a_fine, w_lib, [co], [stride, stride], [1, 1], [1, 1], convt,
            [1, 1] if convt else [0, 0], 1, mask)

    return library


def check_stage_wgrad_fine(stage, gen, dev, lifted_wgrad_ms: dict):
    """The fine-grid stage wgrad against stage_wgrad_fine_reference at the 14
    shapes of the packed-fused step, with packed-width mul/add, dW and db
    each: f32 (TF32 off; max|d| <= 1e-4 max|ref|: sums over up to 7.9 M
    pixels in another order) and bf16 (against the plain version in f32 on
    the bf16 values, 1e-2 max|ref|: the activation rounds to bf16); two
    launches on the same inputs give the same bits. Every shape timed in f32
    beside its bound (real work and the wgrad's bytes, ``stage_work``), the
    lifted wgrad-only entry's time at the same shape (``lifted_wgrad_ms``:
    the same run) and, as the library yardstick (timed only), cuDNN's wgrad
    alone on the fine grid (``fine_library([False, True, True])``). At
    dec_out and dec_ct[4] also the plain version. Returns the
    stage_wgrad_fine record and {shape: cuDNN wgrad ms} at the STAGE_LIBRARY
    shapes."""
    recs, lib_wgrad = {}, {}
    total = {"ms": 0.0, "bound": 0.0, "lib": 0.0, "lifted": 0.0, "ms_bf16": 0.0,
             "bound_bf16": 0.0, "lib_bf16": 0.0}
    faster = 0
    for name, (b, h, w, ci_p), co_p, _, _, slope, recipe, levels in STAGE_SHAPES:
        prologue = slope is not None
        slope = 0.01 if slope is None else slope
        work = stage_work(stage, (b, h, w, ci_p), co_p, recipe, levels, prologue)
        work_bf16 = stage_work(stage, (b, h, w, ci_p), co_p, recipe, levels, prologue, elt=2)
        ci, co = work["ci"], work["co"]
        x32 = torch.randn(b, h, w, ci_p, generator=gen).to(dev)
        w32 = (torch.randn(3, 3, ci, co, generator=gen) * (9 * ci) ** -0.5).to(dev)
        dy32 = torch.randn(b, h, w, co_p, generator=gen).to(dev)
        mul = ((torch.rand(ci_p, generator=gen) + 0.5).to(dev) if prologue
               else torch.ones(ci_p, device=dev))
        add = torch.randn(ci_p, generator=gen).to(dev) if prologue else torch.zeros(ci_p, device=dev)
        args = (slope, recipe, levels, prologue)
        parts, err32 = [], {}
        for dtype in (torch.float32, torch.bfloat16):
            x, wk, dy = (t.to(dtype) for t in (x32, w32, dy32))
            got = stage.stage_wgrad_fine(x, dy, mul, add, wk, *args)
            again = stage.stage_wgrad_fine(x, dy, mul, add, wk, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"stage_wgrad_fine {name} {dtype}: two launches differ")
            ref = stage.stage_wgrad_fine_reference(x.float(), dy.float(), mul, add, wk.float(),
                                                   *args)
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            for term, g, r in zip(("dW", "db"), got, ref):
                if g.shape != r.shape or g.dtype != torch.float32:
                    raise AssertionError(f"stage_wgrad_fine {name} {term}: {tuple(g.shape)} "
                                         f"{g.dtype}, want {tuple(r.shape)} float32")
                err, tol = max_err(g, r), rel * float(r.abs().max()) + 1e-6
                parts.append(f"{str(dtype)[6:]} {term} {err:.2e}/{tol:.2e}")
                check(f"stage_wgrad_fine {name} {dtype} {term}", err, tol)
                if dtype == torch.float32:
                    err32[term] = err
            del got, again, ref
        x, wk, dy = x32, w32, dy32
        ms = cuda_ms(lambda: stage.stage_wgrad_fine(x, dy, mul, add, wk, *args),
                     iters=10, warmup=2)
        bnd, by = bound(work["bytes_wgrad"], work["flops"])
        library = fine_library(x, dy, mul, add, wk, slope, recipe, levels, work["lout"],
                               prologue)
        lib = cuda_ms(lambda: library([False, True, True]), iters=10, warmup=2)
        xb, wkb, dyb = (t.to(torch.bfloat16) for t in (x, wk, dy))
        ms_b = cuda_ms(lambda: stage.stage_wgrad_fine(xb, dyb, mul, add, wkb, *args),
                       iters=10, warmup=2)
        bnd_b, _ = bound(work_bf16["bytes_wgrad"], work_bf16["flops"], torch.bfloat16)
        library_b = fine_library(xb, dyb, mul, add, wkb, slope, recipe, levels, work["lout"],
                                 prologue)
        lib_b = cuda_ms(lambda: library_b([False, True, True]), iters=10, warmup=2)
        lifted = lifted_wgrad_ms[name]
        faster += ms < lifted
        for key, val in (("ms", ms), ("bound", bnd), ("lib", lib), ("lifted", lifted),
                         ("ms_bf16", ms_b), ("bound_bf16", bnd_b), ("lib_bf16", lib_b)):
            total[key] += val
        log(f"[kernels] stage_wgrad_fine {name} {recipe} L{levels} base {ci}->{co} prologue "
            f"{prologue}: {', '.join(parts)} (max|d|/tol), repeat equal; f32 {ms:.4f} ms, "
            f"real {work['flops'] / 1e9:.2f} GFLOP, {work['bytes_wgrad'] / 1e6:.1f} MB, bound "
            f"{bnd:.4f} ms ({by}), kernel/bound {ms / bnd:.2f}; lifted wgrad-only entry "
            f"{lifted:.4f} ms; library (cuDNN on the fine grid) wgrad {lib:.4f} ms; bf16 "
            f"{ms_b:.4f} ms, bound {bnd_b:.4f} ms, cuDNN {lib_b:.4f} ms")
        if name in STAGE_LIBRARY:
            plain = cuda_ms(lambda: stage.stage_wgrad_fine_reference(x, dy, mul, add, wk, *args),
                            iters=10, warmup=2)
            lib_wgrad[name] = lib
            log(f"[kernels] stage_wgrad_fine {name} f32: plain {plain:.4f} ms")
            if name == STAGE_RECORD:
                recs["stage_wgrad_fine"] = dict(max_abs_err=max(err32.values()), ms=ms,
                                                plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                                bound_by=by, ms_bf16=ms_b, library_ms_bf16=lib_b,
                                                bound_ms_bf16=bnd_b)
        del x32, w32, dy32, x, wk, dy, library, xb, wkb, dyb, library_b
        torch.cuda.empty_cache()
    log(f"[kernels] stage wgrad, the 14 shapes of one batch-8 step in f32: fine-grid kernel "
        f"{total['ms']:.3f} ms, bound of the real work {total['bound']:.3f} ms, cuDNN wgrad "
        f"on the fine grid {total['lib']:.3f} ms, the same run's lifted wgrad-only entry "
        f"{total['lifted']:.3f} ms; the fine kernel faster than the lifted one at {faster} of "
        f"{len(STAGE_SHAPES)} shapes; in bf16: kernel {total['ms_bf16']:.3f} ms, bound "
        f"{total['bound_bf16']:.3f} ms, cuDNN {total['lib_bf16']:.3f} ms")
    recs["stage_wgrad_fine"].update(fourteen_shape_sums(total))
    return recs, lib_wgrad


def phase_kernels(kernels):
    """Phase 3: every kernel against its plain version, then timed."""
    attention, batchnorm, elbo = kernels["attention"], kernels["batchnorm"], kernels["elbo"]
    stage = kernels["stage"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    recs = {"attention_fwd": check_attention_fwd(attention, gen, dev)}
    check_attention_masks(attention, dev)
    recs["attention_bwd"] = check_attention_bwd(attention, gen, dev)
    recs.update(check_bn(batchnorm, gen, dev))
    check_bn_rows(batchnorm, gen, dev)
    recs.update(check_elbo(elbo, gen, dev))
    lifted, totals = check_stage(stage, gen, dev)
    fine, lib_times = check_stage_fine(stage, gen, dev, totals["fwd"])
    dgrad = check_stage_dgrad_fine(stage, gen, dev, totals["bwd"])
    wgrad, lib_wgrad = check_stage_wgrad_fine(stage, gen, dev, totals["wgrad_by_shape"])
    # rows 6-7's library call is the path's function on the fine grid
    lib_f, lib_b = lib_times[STAGE_RECORD]
    lifted["stage_fwd"]["library_ms"] = lib_f
    lifted["stage_bwd"]["library_ms"] = lib_b
    lifted["stage_bwd_wgrad"]["library_ms"] = lib_wgrad[STAGE_RECORD]
    recs.update(lifted)
    recs.update(fine)
    recs.update(dgrad)
    recs.update(wgrad)
    torch.cuda.empty_cache()
    return recs


def phase_serve(attention, serving_model, vae_endpoints, BatchingEngine, H, depth):
    """Phase 4: the full-width model served to concurrent clients and HTTP."""
    t0 = time.perf_counter()
    model, img_hw = serving_model(device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve] CausalViTVAE {img_hw} on {torch.cuda.get_device_name(0)}: "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    eps = vae_endpoints(model)
    encoder_calls = [0]
    lock = threading.Lock()
    for name in ("encode", "reconstruct", "do_t"):
        inner = eps[name].fn

        def counted(mdl, *args, _inner=inner):
            with lock:
                encoder_calls[0] += 1
            return _inner(mdl, *args)

        eps[name].fn = counted
    rng = np.random.default_rng(1)
    h, w = img_hw
    m_dim, t_dim, z_dim = model.m_dim, model.t_dim, model.z_dim

    def x_(b):
        return (rng.random((b, h, w, 1)) > 0.85).astype(np.float32)

    def m_(b):
        return rng.standard_normal((b, m_dim)).astype(np.float32)

    def t_(b):
        return np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, b)]

    requests = [("reconstruct", (x_(1), m_(1), t_(1))),
                ("reconstruct", (x_(3), m_(3), t_(3))),
                ("reconstruct", (x_(8), m_(8), t_(8))),
                ("encode", (x_(2), m_(2), t_(2))),
                ("decode", (m_(2), rng.standard_normal((2, z_dim)).astype(np.float32))),
                ("predict_m", (t_(4),)),
                ("uncertainty", (t_(4),)),
                ("do_t", (x_(1), m_(1), t_(1)))]
    expect = {"reconstruct": lambda b: [(b, h, w, 1)],
              "encode": lambda b: [(b, z_dim), (b, z_dim)],
              "decode": lambda b: [(b, h, w, 1)],
              "predict_m": lambda b: [(b, m_dim)],
              "uncertainty": lambda b: [(b, m_dim), (b, m_dim)],
              "do_t": lambda b: [(b, t_dim, h, w, 1)]}

    engine = BatchingEngine(eps)
    srv = H.serve(engine, port=0, background=True)
    port = srv.server_address[1]
    try:
        attention.LAUNCHES = 0  # main path starts here
        results = [None] * len(requests)
        errors = []

        def client(i):
            try:
                results[i] = engine.infer(requests[i][0], *requests[i][1])
            except Exception as e:  # reported below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        log(f"[serve] {len(requests)} concurrent requests answered in "
            f"{time.perf_counter() - t0:.2f} s")
        for (name, args), out in zip(requests, results):
            outs = list(out) if isinstance(out, tuple) else [out]
            shapes = [tuple(o.shape) for o in outs]
            if shapes != expect[name](args[0].shape[0]) or not all(
                    np.isfinite(o).all() for o in outs):
                raise AssertionError(f"{name}: shapes {shapes} or non-finite values")
        x1, m1, t1 = requests[0][1]
        (http_rec,) = H.request_npz("127.0.0.1", port, "reconstruct", [x1, m1, t1],
                                    timeout=300)
        direct = results[0]
        scale = float(np.abs(direct).max())
        if http_rec.shape != direct.shape or float(np.abs(http_rec - direct).max()) > 1e-3 * scale + 1e-6:
            raise AssertionError("HTTP reconstruct disagrees with the engine's")
        log(f"[serve] HTTP round trip on port {port}: reconstruct {http_rec.shape} ok")
        latency = {}
        for b in (1, 8):
            xb, mb, tb = x_(b), m_(b), t_(b)
            engine.infer("reconstruct", xb, mb, tb)  # warm
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                engine.infer("reconstruct", xb, mb, tb)
                times.append((time.perf_counter() - t0) * 1e3)
            latency[b] = statistics.median(times)
        torch.cuda.synchronize()
        launches = attention.LAUNCHES  # main path ends here
        stats = dict(engine.stats)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    log(f"[serve] engine stats {json.dumps(stats)}")
    log(f"[serve] reconstruct latency (host clock, median of 5): bucket 1 "
        f"{latency[1]:.2f} ms, bucket 8 {latency[8]:.2f} ms")
    log(f"[serve] attention launches {launches} for {encoder_calls[0]} encoder passes "
        f"(depth {depth})")
    if launches == 0 or launches != depth * encoder_calls[0]:
        raise AssertionError(f"expected {depth} attention launches per encoder pass, "
                             f"got {launches} for {encoder_calls[0]}")
    profile_reconstruct(eps["reconstruct"], x_(8), m_(8), t_(8))
    del model, eps
    torch.cuda.empty_cache()
    return launches, latency


def phase_serve_bf16(port, attention, vae_endpoints, BatchingEngine, depth, f32_latency):
    """Phase 4b: the same seeded full-width model computing in bf16, served by
    BatchingEngine: reconstruct and do_t at buckets 1 and 8, the attention
    counts zeroed before and read after, held to ``depth`` launches per
    encoder pass, every one on bf16 operands; the outputs bf16 on the card
    and finite float32 numpy from the engine; latencies beside phase 4's f32
    reconstruct."""
    model, (h, w) = port["vessel_model"](device="cuda", seed=0,
                                         cfg=port["VesselConfig"](compute_dtype="bfloat16"))
    eps = vae_endpoints(model)
    rng = np.random.default_rng(5)
    t_dim = model.t_dim

    def args(b):
        return ((rng.random((b, h, w, 1)) > 0.85).astype(np.float32),
                rng.standard_normal((b, model.m_dim)).astype(np.float32),
                np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, b)])

    with torch.inference_mode():
        probe = eps["reconstruct"](*(torch.from_numpy(a).cuda() for a in args(1)))
    if probe.dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 model reconstructs in {probe.dtype}")
    engine = BatchingEngine(eps, buckets=(1, 8))
    latency, total = {}, {"attention_fwd": 0, "attention_fwd_bf16": 0}
    try:
        for name in ("reconstruct", "do_t"):
            for b in (1, 8):
                a = args(b)
                engine.infer(name, *a)  # warm
                attention.LAUNCHES = attention.LAUNCHES_BF16 = 0  # main path starts here
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    out = engine.infer(name, *a)
                    times.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                launches = (attention.LAUNCHES, attention.LAUNCHES_BF16)  # main path ends
                want = (b, h, w, 1) if name == "reconstruct" else (b, t_dim, h, w, 1)
                if out.shape != want or out.dtype != np.float32 or not np.isfinite(out).all():
                    raise AssertionError(f"bf16 {name} bucket {b}: {out.shape} {out.dtype}")
                if launches != (3 * depth, 3 * depth):
                    raise AssertionError(f"bf16 {name} bucket {b}: attention launches (all, "
                                         f"bf16) {launches}, expected {3 * depth} each")
                latency[name, b] = statistics.median(times)
                total["attention_fwd"] += launches[0]
                total["attention_fwd_bf16"] += launches[1]
        stats = dict(engine.stats)
    finally:
        engine.close()
    log(f"[serve-bf16] engine stats {json.dumps(stats)}; {depth} attention launches per "
        f"encoder pass, all on bf16 operands")
    for b in (1, 8):
        log(f"[serve-bf16] bucket {b} (host clock, median of 3): reconstruct "
            f"{latency['reconstruct', b]:.2f} ms (f32, phase 4: {f32_latency[b]:.2f} ms), "
            f"do_t over {t_dim} targets {latency['do_t', b]:.2f} ms")
    del model, eps
    torch.cuda.empty_cache()
    return total


def phase_bf16_check(port, f32_losses, bf16_losses):
    """bf16 against f32 on the card: the same seeded weights, bench.py's batch
    8 (numpy seed 1), the same eps, dropout 0, TF32 off: the eval
    reconstruction (BF16_RECON_TOL: mean and max relative) and the loss terms
    of one make_vae_step (BF16_TERMS_REL); then phases 6 and 6b's six-step
    loss trajectories (the same weights, batch, generators and dropout
    masks) step by step (BF16_TRAJ_REL)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg = port["VesselConfig"](compute_dtype=dtype)
        model, hw = port["vessel_model"](device="cuda", seed=0, dropout=0.0, cfg=cfg)
        batch = {k: v.cuda() for k, v in bench_batch(CHECK_BATCH, hw, 1).items()}
        eps = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (CHECK_BATCH, cfg.z_dim)).astype(np.float32)).cuda()
        with torch.no_grad():
            rec = model.eval()(batch["x"], batch["m"], batch["t"], eps=eps).recon_x
        opt = port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                  mu_dtype=getattr(torch, cfg.adam_mu_dtype))
        step = port["make_vae_step"](model, port["vessel_loss_fn"](cfg), opt)
        metrics = {k: float(v) for k, v in step(batch, eps=eps).items()}
        results[dtype] = (rec.float().cpu(), rec.dtype, metrics)
        log(f"[bf16-check] {dtype} step, batch {CHECK_BATCH}: {json.dumps(metrics)}")
        del model, opt, step, batch
        torch.cuda.empty_cache()
    (ref, ref_dt, ref_met), (got, got_dt, got_met) = results["float32"], results["bfloat16"]
    mean = float((got - ref).abs().mean() / ref.abs().mean())
    mx = float((got - ref).abs().max() / ref.abs().max())
    log(f"[bf16-check] eval recon, bf16 ({got_dt}) against f32 ({ref_dt}): mean|d|/mean|ref| "
        f"{mean:.3e} (tol {BF16_RECON_TOL[0]:.0e}), max|d|/max|ref| {mx:.3e} (tol "
        f"{BF16_RECON_TOL[1]:.0e})")
    if got_dt != torch.bfloat16 or ref_dt != torch.float32 or not torch.isfinite(got).all():
        raise AssertionError(f"recon dtypes {got_dt}, {ref_dt} or non-finite values")
    check("bf16 eval recon mean", mean, BF16_RECON_TOL[0])
    check("bf16 eval recon max", mx, BF16_RECON_TOL[1])
    for k, v in ref_met.items():
        rel = abs(got_met[k] - v) / abs(v)
        log(f"[bf16-check] step {k}: bf16 {got_met[k]:.8g} f32 {v:.8g} rel {rel:.3e} "
            f"(tol {BF16_TERMS_REL:.0e})")
        check(f"bf16 step {k}", rel, BF16_TERMS_REL)
    rels = [abs(b - a) / abs(a) for a, b in zip(f32_losses, bf16_losses)]
    log(f"[bf16-check] six-step loss trajectory, f32 {json.dumps(f32_losses)}, bf16 "
        f"{json.dumps(bf16_losses)}: rel per step {json.dumps([round(r, 8) for r in rels])} "
        f"(tol {BF16_TRAJ_REL:.0e})")
    check("bf16 loss trajectory", max(rels), BF16_TRAJ_REL)


def phase_remat(port, counters, plain_stats):
    """remat_blocks on the card, bf16, spatial: the plain model and the remat
    model, the same seeded weights, batch, generators (torch's seeded 0) and
    dropout 0.1, one step each: equal metrics and gradients bit for bit, and
    the CPU generator and the card's default one in the same state after
    both; then the remat model's REMAT_STEPS steps with the counts zeroed
    before and read after (12 attention forwards a step: each block's
    forward again in the backward), the peak memory beside phase 6b's plain
    bf16 step and the step time."""
    cfg = port["VesselConfig"](compute_dtype="bfloat16")
    runs = {}
    for remat in (False, True):
        model, img_hw = port["vessel_model"](device="cuda", seed=0, dropout=TRAIN_RATE,
                                             cfg=cfg, remat_blocks=remat)
        opt = port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                  mu_dtype=getattr(torch, cfg.adam_mu_dtype))
        step = port["make_vae_step"](model, port["vessel_loss_fn"](cfg), opt)
        batch = train_batch(port, img_hw, False)
        gen = torch.Generator().manual_seed(0)
        torch.manual_seed(0)
        if remat:
            for c in counters.values():
                c.reset()  # main path starts here
            torch.cuda.reset_peak_memory_stats()
        metrics = step(batch, generator=gen)
        torch.cuda.synchronize()
        runs[remat] = ({k: v.cpu() for k, v in metrics.items()},
                       {n: p.grad.cpu() for n, p in model.named_parameters()},
                       gen.get_state(), torch.cuda.get_rng_state())
        if not remat:
            del model, opt, step, batch
            torch.cuda.empty_cache()
    (m0, g0, c0, d0), (m1, g1, c1, d1) = runs[False], runs[True]
    same = (all(torch.equal(m0[k], m1[k]) for k in m0)
            and all(torch.equal(g0[n], g1[n]) for n in g0))
    log(f"[remat] one bf16 step with and without remat_blocks: metrics and all {len(g0)} "
        f"gradients equal bit for bit: {same}; generators equal after: CPU "
        f"{torch.equal(c0, c1)}, card {torch.equal(d0, d1)}")
    if not (same and torch.equal(c0, c1) and torch.equal(d0, d1)):
        raise AssertionError("remat_blocks changed the step or the generators' states")
    times = []
    for _ in range(REMAT_STEPS - 1):
        t0 = time.perf_counter()
        float(step(batch, generator=gen)["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = {name: c.read() for name, c in counters.items()}  # main path ends
    peak = torch.cuda.max_memory_allocated()
    want = with_dtype(PER_STEP_REMAT, True)
    log(f"[remat] launches over {REMAT_STEPS} steps: {json.dumps(launches)}")
    for name in counters:
        if launches[name] != want.get(name, 0) * REMAT_STEPS:
            raise AssertionError(f"remat {name}: {launches[name]} launches in {REMAT_STEPS} "
                                 f"steps, expected {want.get(name, 0)} per step")
    log(f"[remat] bf16 spatial step with remat_blocks: median of steps 1-{REMAT_STEPS - 1} "
        f"{statistics.median(times):.2f} ms (plain bf16, phase 6b: "
        f"{plain_stats['step_ms']:.2f} ms); peak device memory {peak / 2**30:.3f} GiB "
        f"({peak} bytes; plain bf16 {plain_stats['peak_bytes'] / 2**30:.3f} GiB)")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return launches, {"step_ms": statistics.median(times), "peak_bytes": peak}


def log_breakdown(prof, calls: int, wall_ms: float, title: str, top: int = 12):
    """Device time by kernel over a profiled window of ``calls`` calls, and
    the device's idle share of the host-clock wall time."""
    kernels, ranges = [], []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # a user annotation (record_function, e.g. Optimizer.step) spans the
        # kernels inside it: listed apart, not added to the busy time
        annotation = getattr(e, "is_user_annotation", False) or e.key.startswith(
            ("Optimizer.", "ProfilerStep"))
        (ranges if annotation else kernels).append(e)
    dev_ms = {e.key: e.self_device_time_total / 1e3 / calls for e in kernels}
    busy = sum(dev_ms.values())
    if busy == 0.0:
        raise AssertionError(f"{title}: the profile holds no device time")
    for e in ranges:
        log(f"[profile] annotated range {e.key}: {e.device_time_total / 1e3 / calls:.3f} "
            f"ms/call of device time inside it")
    log(f"[profile] {title}: wall {wall_ms:.2f} ms/call, device busy "
        f"{busy:.2f} ms/call, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {ms:8.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return dev_ms


def profile_reconstruct(endpoint, x, m, t, calls: int = 3, top: int = 12):
    """Where the time of a bucket-8 reconstruct goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    args = [torch.from_numpy(a).cuda() for a in (x, m, t)]
    with torch.inference_mode():
        for _ in range(2):
            endpoint(*args).cpu()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                endpoint(*args).cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    log_breakdown(prof, calls, wall_ms, "reconstruct bucket 8", top)


def phase_cpu_check(serving_model):
    """Phase 5: one sample through the same seeded model on the card and the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, img_hw = serving_model(device="cuda", seed=0)
    cpu, _ = serving_model(device="cpu", seed=0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.random((1, *img_hw, 1)) > 0.85).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((1, gpu.m_dim)).astype(np.float32))
    t = torch.from_numpy(np.eye(gpu.t_dim, dtype=np.float32)[[3]])
    with torch.inference_mode():
        c_mu, c_lv = cpu.encode(x, m, t)
        c_rec = cpu.decode(m, c_mu)
        g_mu, g_lv = gpu.encode(x.cuda(), m.cuda(), t.cuda())
        g_rec = gpu.decode(m.cuda(), c_mu.cuda())
    torch.cuda.synchronize()
    for name, g, c in (("mu", g_mu, c_mu), ("logvar", g_lv, c_lv), ("recon", g_rec, c_rec)):
        err = float((g.cpu() - c).abs().max())
        tol = 1e-3 * float(c.abs().max()) + 1e-6
        log(f"[cpu-check] {name}: max|d| {err:.3e} (tol {tol:.3e}), "
            f"max|ref| {float(c.abs().max()):.3e}")
        if not err <= tol or not torch.isfinite(g).all():
            raise AssertionError(f"card and CPU disagree on {name}")


def bench_batch(b: int, img_hw, seed: int):
    """The synthetic batch of bench.py's flagship step: x = (U[0,1) > 0.9)
    NHWC, m ~ N(0, 1), t one-hot over 19, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    x = (rng.random((b, *img_hw, 1)) > 0.9).astype(np.float32)
    m = rng.standard_normal((b, 12)).astype(np.float32)
    t = np.eye(19, dtype=np.float32)[rng.integers(0, 19, b)]
    return {k: torch.from_numpy(v) for k, v in (("x", x), ("m", m), ("t", t))}


def train_batch(port, img_hw, packed_io: bool):
    """bench.py's batch-8 batch on the card; with ``packed_io`` its images
    packed on the host with space_to_depth_n(x, 3), as bench.py packs them."""
    batch = bench_batch(TRAIN_BATCH, img_hw, 0)
    if packed_io:
        batch["x"] = torch.from_numpy(port["space_to_depth_n"](batch["x"].numpy(), 3))
    return {k: v.cuda() for k, v in batch.items()}


def phase_train(port, counters, layout=None, per_step=PER_STEP, tag="train",
                steps=TRAIN_STEPS, profile_step=True, dtype="float32"):
    """The training path: the full-width model (``layout``: the vit.py
    formulation options; spatial by default) at compute ``dtype``, seeded
    weights, dropout 0.1 (torch's generators seeded 0 first, so runs of two
    dtypes draw the same masks), TF32 off, takes ``steps`` steps of
    make_vae_step with the clipped bf16-moment Adam on bench.py's batch (the
    same batch every step); counts zeroed before and read after and held to
    ``per_step`` and its bf16 twins (skipped when ``counters`` is None: a
    timing-only run); every loss finite and the last below the first; step
    time, peak memory, a profiled step with its idle share."""
    from torch.profiler import ProfilerActivity, profile

    layout = layout or {}
    cfg = port["VesselConfig"](compute_dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, img_hw = port["vessel_model"](device="cuda", seed=0, dropout=TRAIN_RATE,
                                         cfg=cfg, **layout)
    opt = port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                              mu_dtype=getattr(torch, cfg.adam_mu_dtype))
    step = port["make_vae_step"](model, port["vessel_loss_fn"](cfg), opt)
    batch = train_batch(port, img_hw, layout.get("packed_io", False))
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    torch.cuda.synchronize()
    log(f"[{tag}] CausalViTVAE {img_hw} {json.dumps(layout)} {dtype}, batch {TRAIN_BATCH} "
        f"x {tuple(batch['x'].shape)}, dropout {TRAIN_RATE}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    per_step = with_dtype(per_step, dtype == "bfloat16")
    for c in (counters or {}).values():
        c.reset()  # main path starts here
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = step(batch, generator=gen)
        vals = {k: float(v) for k, v in metrics.items()}  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(vals["loss"])
        log(f"[{tag}] step {i}: {json.dumps(vals)} ({times[-1]:.1f} ms)")
    torch.cuda.synchronize()
    launches = {name: c.read() for name, c in (counters or {}).items()}  # main path ends
    peak = torch.cuda.max_memory_allocated()
    if counters is not None:
        log(f"[{tag}] launches over {steps} steps: {json.dumps(launches)}")
        for name in counters:
            if launches[name] != per_step.get(name, 0) * steps:
                raise AssertionError(f"{name}: {launches[name]} launches in {steps} "
                                     f"steps, expected {per_step.get(name, 0)} per step")
    grads = {p.grad.dtype for p in model.parameters() if p.grad is not None}
    if grads != {torch.float32} or any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError(f"{tag}: parameters or gradients not all float32 ({grads})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not decreasing: {losses}")
    stats = {"step_ms": statistics.median(times[1:]), "first_ms": times[0],
             "peak_bytes": peak, "losses": losses}
    log(f"[{tag}] step time (host clock after synchronize): median of steps 1-"
        f"{steps - 1} {stats['step_ms']:.2f} ms, first step {times[0]:.2f} ms; peak device "
        f"memory {peak / 2**30:.3f} GiB ({peak} bytes); loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}")
    if profile_step:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(batch, generator=gen)["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = log_breakdown(prof, 1, wall_ms, f"{tag} step, batch {TRAIN_BATCH}", top=20)
        stage_ms = sum(ms for name, ms in dev_ms.items() if any(
            s in name for s in ("conv_gemm_kernel", "wgrad_kernel", "colsum_kernel",
                                "::fold_kernel", "fine_gemm_kernel", "fine_direct_kernel",
                                "fold_rows_kernel", "wgrad_gemm_kernel",
                                "wgrad_direct_kernel")))
        busy = sum(dev_ms.values())
        log(f"[profile] {tag}: stage kernels {stage_ms:.3f} ms of device busy "
            f"{busy:.3f} ms ({100 * stage_ms / busy:.1f}%)")
        elbo = {e.key[:48]: (e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages() if "elbo" in e.key and e.key in dev_ms}
        launched = sum(e.count for e in prof.key_averages() if e.key in dev_ms)
        log(f"[profile] {tag}: ELBO kernels (launches, ms) {json.dumps(elbo)}; "
            f"{launched} device kernels in the step")
        stats["idle_share"] = max(0.0, 1 - busy / wall_ms)
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return launches, stats


def phase_train_cpu_check(port):
    """Phase 7: training, card against CPU. From the same seeded weights,
    make_vae_step at batch CHECK_BATCH (bench.py's batch, numpy seed 1),
    dropout off, the same injected eps, TF32 off, runs one step on the card
    and one on the CPU (plain versions there) for each of two losses:

    - the vessel loss: the loss terms agree to rel 1e-4; the gradients of the
      last decoder BatchNorm and the output convolution (through the ELBO
      and BN backward kernels) to GRAD_TOL;
    - the KL term alone, the one term whose gradient reaches the encoder
      without the decoder: the gradients of the first and last attention
      blocks' qkv (through all six attention backward launches), the
      encoder adapter and its BatchNorm, and the stem's last BatchNorm, to
      GRAD_TOL.

    Under the whole vessel loss the gradients above the decoder's BatchNorm
    chain (decoder_input and the whole encoder) are ill-conditioned in f32
    at this width: each BN backward removes most of dy and leaves a small
    remainder of large cancelling terms, so two f32 runs differ there by
    percents and such a comparison cannot tell a wrong kernel from rounding.
    At batch 2 the KL term is ill-conditioned too (the 2-sample adapter
    BatchNorm's backward cancels), hence batch 8."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = port["VesselConfig"]()
    vessel = port["vessel_loss_fn"](cfg)

    def kld_only(out, batch):
        _, metrics = vessel(out, batch)
        return metrics["kld"], metrics

    results = {}
    for loss_name, loss_fn in (("vessel", vessel), ("kld", kld_only)):
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            model, hw = port["vessel_model"](device=dev, seed=0, dropout=0.0)
            opt = port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                      mu_dtype=getattr(torch, cfg.adam_mu_dtype))
            step = port["make_vae_step"](model, loss_fn, opt)
            batch = {k: v.to(dev) for k, v in bench_batch(CHECK_BATCH, hw, 1).items()}
            eps = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (CHECK_BATCH, cfg.z_dim)).astype(np.float32))
            metrics = {k: float(v) for k, v in step(batch, eps=eps.to(dev)).items()}
            named = dict(model.named_parameters())
            measured = CHECK_GRADS[loss_name] + (STEM_GRADS if loss_name == "kld" else [])
            results[loss_name, dev] = (metrics, {n: named[n].grad.detach().cpu()
                                                 for n in measured})
            log(f"[train-cpu-check] {dev} step {hw} batch {CHECK_BATCH}, loss {loss_name}: "
                f"{json.dumps(metrics)} ({time.perf_counter() - t0:.1f} s with set-up)")
            del model, opt, step, batch
            torch.cuda.empty_cache()
    (g_met, _), (c_met, _) = results["vessel", "cuda"], results["vessel", "cpu"]
    for k, ref in c_met.items():
        err = abs(g_met[k] - ref)
        log(f"[train-cpu-check] {k}: card {g_met[k]:.8g} cpu {ref:.8g} rel {err / abs(ref):.3e}")
        check(f"train step {k}", err, 1e-4 * abs(ref))
    for loss_name, names in CHECK_GRADS.items():
        g_grads, c_grads = results[loss_name, "cuda"][1], results[loss_name, "cpu"][1]
        for n in names:
            g, c = g_grads[n], c_grads[n]
            err, ref = float((g - c).abs().max()), float(c.abs().max())
            log(f"[train-cpu-check] loss {loss_name}, grad {n}: card-cpu max|d| {err:.3e} "
                f"({err / ref:.3e} of max|ref| {ref:.3e}; tol {GRAD_TOL:.0e})")
            if not torch.isfinite(g).all() or ref == 0.0:
                raise AssertionError(f"card gradient {n} not finite, or the CPU's zero")
            check(f"loss {loss_name}, grad {n}", err, GRAD_TOL * ref)
    g_grads, c_grads = results["kld", "cuda"][1], results["kld", "cpu"][1]
    for n in STEM_GRADS:  # measured, not held: the spread phase 9's STEM_GRAD_TOL covers
        err, ref = float((g_grads[n] - c_grads[n]).abs().max()), float(c_grads[n].abs().max())
        log(f"[train-cpu-check] loss kld, grad {n} (spread, not held): card-cpu max|d| "
            f"{err:.3e} ({err / ref:.3e} of max|ref| {ref:.3e})")


def phase_packed_check(port):
    """Phase 9: the packed-fused model against the spatial one, both on the
    card, from the same seeded weights (the two formulations share every
    parameter), dropout 0, the same injected eps, bench.py's batch 8 (numpy
    seed 1; the packed side gets it packed with space_to_depth_n), TF32 off:

    - one eval forward: the reconstruction (unpacked) within 1e-3 max|ref|;
    - one make_vae_step under each of phase 7's losses: the loss terms to
      rel 1e-4 (vessel loss) and the gradients of PACKED_CHECK_GRADS to
      GRAD_TOL (the vessel loss's through dec_out's stage backward and the
      last BN's affine), the KL term's stem convs 1 and 2 (through the stem
      stage backward) to STEM_GRAD_TOL: below three BatchNorm backwards two
      f32 runs of the same spatial model differ there by up to ~3e-3 of
      max|ref| (phase 7 logs its card-vs-CPU spread)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = port["VesselConfig"]()
    vessel = port["vessel_loss_fn"](cfg)

    def kld_only(out, batch):
        _, metrics = vessel(out, batch)
        return metrics["kld"], metrics

    layouts = {"spatial": {}, "packed": PACKED}
    results = {}
    for loss_name, loss_fn in (("eval", None), ("vessel", vessel), ("kld", kld_only)):
        for name, layout in layouts.items():
            model, hw = port["vessel_model"](device="cuda", seed=0, dropout=0.0, **layout)
            batch = bench_batch(CHECK_BATCH, hw, 1)
            if layout:
                batch["x"] = torch.from_numpy(port["space_to_depth_n"](batch["x"].numpy(), 3))
            batch = {k: v.cuda() for k, v in batch.items()}
            eps = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (CHECK_BATCH, cfg.z_dim)).astype(np.float32)).cuda()
            if loss_fn is None:
                with torch.no_grad():
                    rec = model.eval()(batch["x"], batch["m"], batch["t"], eps=eps).recon_x
                if layout:
                    rec = port["depth_to_space_n"](rec, 3)
                results[loss_name, name] = rec.cpu()
            else:
                opt = port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                          mu_dtype=getattr(torch, cfg.adam_mu_dtype))
                step = port["make_vae_step"](model, loss_fn, opt)
                metrics = {k: float(v) for k, v in step(batch, eps=eps).items()}
                named = dict(model.named_parameters())
                results[loss_name, name] = (metrics, {
                    n: named[n].grad.detach().cpu() for n in PACKED_CHECK_GRADS[loss_name]})
                log(f"[packed-check] {name} step, loss {loss_name}: {json.dumps(metrics)}")
            del model, batch
            torch.cuda.empty_cache()
    ref, got = results["eval", "spatial"], results["eval", "packed"]
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    log(f"[packed-check] eval recon: max|d| {err:.3e} (tol {1e-3 * scale + 1e-6:.3e}), "
        f"max|ref| {scale:.3e}")
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"packed recon {tuple(got.shape)} vs {tuple(ref.shape)}")
    check("packed eval recon", err, 1e-3 * scale + 1e-6)
    (s_met, _), (p_met, _) = results["vessel", "spatial"], results["vessel", "packed"]
    for k, v in s_met.items():
        log(f"[packed-check] {k}: packed {p_met[k]:.8g} spatial {v:.8g} "
            f"rel {abs(p_met[k] - v) / abs(v):.3e}")
        check(f"packed step {k}", abs(p_met[k] - v), 1e-4 * abs(v))
    for loss_name, names in PACKED_CHECK_GRADS.items():
        s_grads, p_grads = results[loss_name, "spatial"][1], results[loss_name, "packed"][1]
        for n in names:
            g, c = p_grads[n], s_grads[n]
            err, ref_max = float((g - c).abs().max()), float(c.abs().max())
            tol = STEM_GRAD_TOL if n in STEM_GRADS else GRAD_TOL
            log(f"[packed-check] loss {loss_name}, grad {n}: packed-spatial max|d| "
                f"{err:.3e} ({err / ref_max:.3e} of max|ref| {ref_max:.3e}; tol {tol:.0e})")
            if not torch.isfinite(g).all() or ref_max == 0.0:
                raise AssertionError(f"packed gradient {n} not finite, or the spatial zero")
            check(f"packed loss {loss_name}, grad {n}", err, tol * ref_max)


def check_preprocess(make_preprocess, corpus):
    """The device transform of the vessel pipeline on the card against the
    CPU, one batch at 768x1280 (the corpus' 96x160 masks and random images,
    all four aug modes): binarized masks equal except at pixels whose
    normalized value (the CPU's, float64) lies within 1e-5 of its image's
    mean; those pixels are counted."""
    rng = np.random.default_rng(4)
    raw = np.concatenate([corpus.raw_images[:4],
                          rng.random((4, *corpus.raw_images.shape[1:]), dtype=np.float32)])
    aug = np.array([0, 1, 2, 3, 3, 2, 1, 0])
    hw = VESSEL_HW
    gpu = make_preprocess(hw, "cuda")(torch.from_numpy(raw), torch.from_numpy(aug)).cpu()
    cpu = make_preprocess(hw, "cpu")(torch.from_numpy(raw), torch.from_numpy(aug))
    img = F.interpolate(torch.from_numpy(raw)[:, None], size=hw, mode="bilinear",
                        align_corners=False, antialias=True)[:, 0].double()
    for i, a in enumerate(aug):
        if a in (1, 3):
            img[i] = img[i].flip(-1)
        if a in (2, 3):
            img[i] = img[i].flip(-2)
    lo, hi = img.amin(dim=(1, 2), keepdim=True), img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) / (hi - lo)
    near = (img - img.mean(dim=(1, 2), keepdim=True)).abs() <= 1e-5
    off = (gpu[..., 0] != cpu[..., 0])
    log(f"[preprocess] card vs CPU, {tuple(gpu.shape)}: {int(off.sum())} mask pixels "
        f"differ, {int(near.sum())} pixels lie within 1e-5 of their threshold, "
        f"{int((off & ~near).sum())} differ away from it")
    if (off & ~near).any() or gpu.shape != (len(raw), *hw, 1):
        raise AssertionError("make_preprocess: card and CPU masks disagree")


def log_epochs(tag: str, log_, phase6_step_ms: float):
    """Where each epoch of a train vessel run went (the loop's EpochClock)."""
    for rec in log_.clock.records:
        steps = rec["steps"]
        step_ms = statistics.median(rec["step_ms"])
        log(f"[{tag}] epoch {rec['epoch']}: wall {rec['wall_s']:.3f} s, {steps} steps, "
            f"train steps {rec.get('step_s', 0):.3f} s, building batches "
            f"{1e3 * rec.get('batch_s', 0) / steps:.2f} ms/step (host), val "
            f"{rec.get('val_s', 0):.3f} s, checkpoint writes {rec.get('checkpoint_s', 0):.3f} s; "
            f"loop step median {step_ms:.2f} ms on the device clock (phase 6: "
            f"{phase6_step_ms:.2f} ms), first {rec['step_ms'][0]:.2f} ms")
    ips = [r["images_per_sec"] for r in log_.history if "images_per_sec" in r]
    log(f"[{tag}] images_per_sec {ips[-1]:.3f} (StepTimer, synchronised, steps 3 on, "
        f"val and checkpoint writes included)")


def _files_gib(run_dir: str, prefix: str) -> str:
    import os

    names = sorted(n for n in os.listdir(run_dir) if n.startswith(prefix))
    return ", ".join(f"{n} {os.path.getsize(os.path.join(run_dir, n)) / 2**30:.3f} GiB"
                     for n in names)


def phase_train_vessel(port, counters, phase6_step_ms: float):
    """Phase 10: the vessel training entry point in-process, at 768x1280:
    ``train vessel`` for 2 epochs on the synthetic corpus, then ``--resume``
    to 3 (its 5th optimizer step profiled), ``serve vessel --ckpt``, one
    ``--packed-io`` epoch, and one ``--dtype bfloat16`` epoch (n = 16) whose
    checkpoint ``serve vessel --ckpt`` serves (in f32); counts zeroed before each and held to exact
    counts per train step and per val batch; losses finite; the run files
    present; the resumed run starts at epoch 2 with the best-val watermark;
    the restored model's encode of one batch equals the in-memory model's bit
    for bit."""
    import os
    import shutil
    import tempfile

    from torch.optim.optimizer import register_optimizer_step_post_hook
    from torch.profiler import ProfilerActivity, profile

    main, vessel = port["cli_main"], port["vessel"]
    check_preprocess(vessel.make_preprocess, vessel.synthetic_corpus(n=8, seed=0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_vessel_")
    free = shutil.disk_usage(tmp).free
    log(f"[train-vessel] run directories under {tmp}: {free / 2**30:.1f} GiB free")
    if free < VESSEL_DISK:
        shutil.rmtree(tmp)
        raise AssertionError(f"{free / 2**30:.1f} GiB free for checkpoints, "
                             f"{VESSEL_DISK / 2**30:.0f} GiB needed")
    hw_args = ["--img-hw", str(VESSEL_HW[0]), str(VESSEL_HW[1])]
    by_run = {}

    def counted(tag, argv, n_synthetic, per_step, per_val, epochs, extra=None):
        """Run the CLI with the counts zeroed; hold them to per-step and
        per-val-batch counts over ``epochs`` epochs, plus ``extra``."""
        corpus = vessel.synthetic_corpus(n=n_synthetic, seed=0)
        steps = len(corpus.splits["train"]) * 4 // TRAIN_BATCH
        val = -(-len(corpus.splits["val"]) // TRAIN_BATCH)
        for c in counters.values():
            c.reset()  # main path starts here
        t0 = time.perf_counter()
        out = main(["--out", tmp, "--n-synthetic", str(n_synthetic), *argv])
        torch.cuda.synchronize()
        launches = {name: c.read() for name, c in counters.items()}  # main path ends
        log(f"[{tag}] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; launches "
            f"{json.dumps(launches)} for {epochs} epochs of {steps} steps and {val} val batches")
        for name in counters:
            want = epochs * (steps * per_step.get(name, 0) + val * per_val.get(name, 0))
            want += (extra or {}).get(name, 0)
            if launches[name] != want:
                raise AssertionError(f"{tag} {name}: {launches[name]} launches, expected "
                                     f"{want} ({per_step.get(name, 0)} per step, "
                                     f"{per_val.get(name, 0)} per val batch)")
        by_run[tag] = launches
        if out is not None:
            for rec in out[2].clock.records:
                if rec["steps"] != steps:
                    raise AssertionError(f"{tag}: {rec['steps']} steps in an epoch, expected {steps}")
        return out

    try:
        run = os.path.join(tmp, "train_vessel")
        model, opt, log1 = counted("train-vessel", ["train", "vessel", *hw_args, "--epochs", "2"],
                                   VESSEL_N, PER_STEP, PER_VAL, 2)
        losses = [v for r in log1.history for k, v in r.items() if k.endswith("loss")]
        if len(losses) != 4 or not all(np.isfinite(losses)):
            raise AssertionError(f"train vessel losses {losses}")
        for name in ("metrics.jsonl", "latest.pt", "latest.meta.json", "best.pt",
                     "best.meta.json"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"train vessel wrote no {name}")
        log_epochs("train-vessel", log1, phase6_step_ms)
        log(f"[train-vessel] metrics {json.dumps(log1.history)}")
        log(f"[train-vessel] checkpoints: {_files_gib(run, 'latest')}; {_files_gib(run, 'best')}")
        # the restored model encodes as the in-memory one did, bit for bit
        batch = next(vessel.iterate_batches(vessel.synthetic_corpus(n=VESSEL_N, seed=0),
                                            "val", TRAIN_BATCH, VESSEL_HW, augment=False,
                                            device="cuda"))
        with torch.no_grad():
            mu, lv = model.eval().encode(batch["x"], batch["m"], batch["t"])
        del model, opt
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, _ = port["serving_model"](VESSEL_HW, "cuda", ckpt=run)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            mu2, lv2 = restored.encode(batch["x"], batch["m"], batch["t"])
        same = torch.equal(mu, mu2) and torch.equal(lv, lv2)
        log(f"[train-vessel] serving model built and latest loaded in {load_s:.3f} s; "
            f"its encode of a val batch equals the in-memory model's bit for bit: {same}")
        if not same:
            raise AssertionError("the restored model encodes otherwise than the trained one")
        del restored
        torch.cuda.empty_cache()
        best = json.loads(open(os.path.join(run, "best.meta.json")).read())

        # resume to epoch 3; the loop step from the 4th optimizer step's end
        # to the 5th's profiled (the profiler started and stopped by a hook)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        marks = []

        def hook(*_):
            marks.append(None)
            if len(marks) == 4:
                prof.start()
                marks[-1] = time.perf_counter()
            elif len(marks) == 5:
                marks[-1] = time.perf_counter()
                prof.stop()

        handle = register_optimizer_step_post_hook(hook)
        try:
            model, opt, log2 = counted(
                "train-vessel-resume",
                ["train", "vessel", *hw_args, "--epochs", "3", "--resume"],
                VESSEL_N, PER_STEP, PER_VAL, 1)
        finally:
            handle.remove()
        if [r["step"] for r in log2.history] != [2, 2, -1]:
            raise AssertionError(f"the resumed run logged {log2.history}")
        val2 = log2.history[1]["val_loss"]
        best2 = json.loads(open(os.path.join(run, "best.meta.json")).read())
        want_best = best if val2 >= best["val_loss"] else {"epoch": 2, "val_loss": val2}
        if best2 != want_best or not np.isfinite(log2.history[0]["train_loss"]):
            raise AssertionError(f"best after resume {best2}, expected {want_best}")
        log(f"[train-vessel-resume] started at epoch 2, best {best} -> {best2}; "
            f"checkpoint load {log2.clock.restore_s:.3f} s ({_files_gib(run, 'latest.pt')})")
        log_epochs("train-vessel-resume (profiled)", log2, phase6_step_ms)
        dev_ms = log_breakdown(prof, 1, (marks[4] - marks[3]) * 1e3,
                               "train vessel loop step (resume, 5th step)", top=8)
        if not dev_ms:
            raise AssertionError("the profiled loop step recorded no kernel")
        del model, opt
        torch.cuda.empty_cache()

        # predict_m and a bucket-1 reconstruct: one encoder pass
        counted("serve-vessel-ckpt", ["serve", "vessel", "--ckpt", run, *hw_args, "--smoke"],
                VESSEL_N, {}, {}, 0, extra={"attention_fwd": PER_VAL["attention_fwd"]})
        shutil.rmtree(run)

        model, opt, log3 = counted(
            "train-vessel-packed", ["train", "vessel", *hw_args, "--epochs", "1", "--packed-io"],
            VESSEL_N_PACKED, PER_STEP_PACKED, PER_VAL_PACKED, 1)
        if not np.isfinite(log3.history[0]["train_loss"]):
            raise AssertionError(f"packed train vessel losses {log3.history}")
        log_epochs("train-vessel-packed", log3, phase6_step_ms)
        del model, opt
        torch.cuda.empty_cache()
        shutil.rmtree(run)

        # one bf16 epoch, and its checkpoint (float32 parameters) served
        model, opt, log4 = counted(
            "train-vessel-bf16", ["train", "vessel", *hw_args, "--epochs", "1",
                                  "--dtype", "bfloat16"],
            VESSEL_N_PACKED, with_dtype(PER_STEP, True), with_dtype(PER_VAL, True), 1)
        if (model.dtype != torch.bfloat16 or any(p.dtype != torch.float32
                                                 for p in model.parameters())
                or not np.isfinite([log4.history[0]["train_loss"],
                                    log4.history[1]["val_loss"]]).all()):
            raise AssertionError(f"bf16 train vessel: {model.dtype}, {log4.history}")
        log_epochs("train-vessel-bf16", log4, phase6_step_ms)
        del model, opt
        torch.cuda.empty_cache()
        counted("serve-vessel-ckpt-bf16", ["serve", "vessel", "--ckpt", run, *hw_args,
                                           "--smoke"],
                VESSEL_N_PACKED, {}, {}, 0, extra={"attention_fwd": PER_VAL["attention_fwd"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {name: sum(r[name] for r in by_run.values()) for name in counters}


def _expect_counts(tag: str, launches: dict, want: dict):
    for name in launches:
        if launches[name] != want.get(name, 0):
            raise AssertionError(f"{tag} {name}: {launches[name]} launches, expected "
                                 f"{want.get(name, 0)}")


def _kfold_want(per_step: dict, per_val: dict, epochs: int, steps: int, folds: int,
                extra=None) -> dict:
    """Launches of ``epochs`` epochs of lockstep steps and val passes."""
    names = set(per_step) | set(per_val) | set(extra or {})
    return {n: epochs * folds * (steps * per_step.get(n, 0) + per_val.get(n, 0))
            + (extra or {}).get(n, 0) for n in names}


def phase_kfold(port, counters, phase6_stats):
    """Phase 11: ``train_kfold`` at full width, then the five fold models
    served and reported. KFOLD_K folds of the vessel model (768x1280, f32,
    dropout 0.1, weights from seeds 0-4), batch KFOLD_BATCH, KFOLD_EPOCHS
    epochs on the synthetic corpus (KFOLD_N masks, 19 groups) preprocessed
    on the card, checkpoints per fold in a temporary directory (removed
    after); the noise handed in from a seeded generator of the card, the
    lockstep step timed between its draws (a synchronise before each).
    Counts zeroed before and read after, held to KFOLD_K times PER_STEP per
    lockstep step and KFOLD_K times PER_VAL_KFOLD per val pass. Each fold's
    train and val loss finite. Fold 0 after two steps equals a lone
    make_vae_step run from the same weights, batches, noise and generators
    (its parameters and BatchNorm statistics within KFOLD_ALONE_TOL of each
    tensor's max|ref|, bits equal expected). Those two steps, in both runs,
    take cuDNN's deterministic algorithms (``cudnn.deterministic``, switched
    off when the third step's noise is drawn): the default f32 weight
    gradient (``wgrad_alg0_engine``) sums with atomics, so two runs of one
    step differ in their last bits, and Adam turns such differences of
    near-zero gradients into steps of about lr (first run: 3 of 200 tensors
    equal, 9.6e-3 of max|ref| apart). The lockstep step time is the median of
    the later steps, on cuDNN's default algorithms as phase 6's. Then ``ensemble_endpoints``
    behind ``BatchingEngine`` to concurrent clients (``uncertainty``
    batch-leading, each client's rows its own), latencies at buckets 1 and
    8, ``ensemble_sigma_by_treatment``, ``pairwise_snr``, ``mc_decode_stats``
    (n_mc 8) and ``predictions_by_treatment``, with their counts."""
    import os
    import shutil
    import tempfile

    from causalvae_tpu_torch.analysis.vessel_report import predictions_by_treatment
    from causalvae_tpu_torch.scm import ensemble as E
    from causalvae_tpu_torch.scm import uncertainty as U
    from causalvae_tpu_torch.serve.endpoints import ensemble_endpoints
    from causalvae_tpu_torch.serve.engine import BatchingEngine
    from causalvae_tpu_torch.train import kfold as KF
    from causalvae_tpu_torch.train.checkpoints import CheckpointBook

    vessel, cfg = port["vessel"], port["VesselConfig"]()
    K, B = KFOLD_K, KFOLD_BATCH
    corpus = vessel.synthetic_corpus(n=KFOLD_N, seed=0)
    t0 = time.perf_counter()
    x = vessel.make_preprocess(VESSEL_HW, "cuda")(torch.from_numpy(corpus.raw_images),
                                                  torch.zeros(KFOLD_N, dtype=torch.int32))
    data = {"x": x, "m": torch.from_numpy(corpus.m).cuda(),
            "t": torch.from_numpy(corpus.one_hot_t(np.arange(KFOLD_N))).cuda()}
    torch.cuda.synchronize()
    plan = KF.stratified_kfold(corpus.t_idx, K, cfg.kfold_seed)
    steps = KF.FoldBatcher(plan, B).steps_per_epoch()
    val_len = max(len(v) for v in plan.val_idx)
    log(f"[kfold] corpus n = {KFOLD_N} ({corpus.t_dim} groups, class sizes "
        f"{np.bincount(corpus.t_idx).tolist()}) preprocessed on the card to "
        f"{tuple(x.shape)} in {time.perf_counter() - t0:.2f} s; {K} folds: train "
        f"{[len(v) for v in plan.train_idx]}, val {[len(v) for v in plan.val_idx]} "
        f"(one val batch of {val_len} a fold); {steps} lockstep steps an epoch")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_kfold_")
    free = shutil.disk_usage(tmp).free
    log(f"[kfold] checkpoints under {tmp}: {free / 2**30:.1f} GiB free")
    if free < KFOLD_DISK:
        shutil.rmtree(tmp)
        raise AssertionError(f"{free / 2**30:.1f} GiB free for the fold checkpoints, "
                             f"{KFOLD_DISK / 2**30:.0f} GiB needed")
    models = []

    def init_one(f):
        model, _ = port["vessel_model"](device="cuda", seed=f, dropout=TRAIN_RATE, cfg=cfg)
        models.append(model)
        return model

    def make_optimizer(model):
        return port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                   mu_dtype=getattr(torch, cfg.adam_mu_dtype))

    gen = torch.Generator(device="cuda").manual_seed(11)
    draws, marks, snapshot = [], [], {}

    def noise():
        """(K, B, z) per lockstep step, (K, val_len, z) per val pass; fold
        0's state copied before the third step."""
        i = -1
        while True:
            i += 1
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if i == 2:
                snapshot.update({k: v.detach().clone()
                                 for k, v in models[0].state_dict().items()})
                torch.backends.cudnn.deterministic = False
            rows = val_len if i % (steps + 1) == steps else B
            draws.append(torch.randn(K, rows, cfg.z_dim, device="cuda", generator=gen))
            yield draws[-1]

    writes = []
    end_of_epoch = CheckpointBook.end_of_epoch

    def timed_end_of_epoch(book, model, optimizer, epoch, val_loss=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end_of_epoch(book, model, optimizer, epoch, val_loss)
        written = ["latest.pt"] + (["best.pt"] if book.best_val == val_loss else [])
        writes.append((epoch, time.perf_counter() - t0,
                       sum(os.path.getsize(os.path.join(book.run_dir, n)) for n in written),
                       len(written)))

    CheckpointBook.end_of_epoch = timed_end_of_epoch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.deterministic = True
    try:
        for c in counters.values():
            c.reset()  # main path starts here
        t0 = time.perf_counter()
        models_out, plan2, history = KF.train_kfold(
            init_one=init_one, make_optimizer=make_optimizer,
            loss_fn=port["vessel_loss_fn"](cfg), data=data, labels=corpus.t_idx,
            epochs=KFOLD_EPOCHS, batch_size=B, n_folds=K, seed=cfg.kfold_seed,
            checkpoint_dir=tmp, noise=noise())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.read() for name, c in counters.items()}  # main path ends
        peak = torch.cuda.max_memory_allocated()
        files = sorted(os.path.join(r, n) for r, _, ns in os.walk(tmp) for n in ns)
        log(f"[kfold] train_kfold: {KFOLD_EPOCHS} epochs in {wall:.2f} s (5 models built "
            f"inside); launches {json.dumps(launches)}; {len(files)} files, "
            f"{sum(os.path.getsize(f) for f in files) / 2**30:.3f} GiB on disk")
    finally:
        torch.backends.cudnn.deterministic = False
        CheckpointBook.end_of_epoch = end_of_epoch
        shutil.rmtree(tmp, ignore_errors=True)
    _expect_counts("kfold", launches, _kfold_want(PER_STEP, PER_VAL_KFOLD, KFOLD_EPOCHS,
                                                  steps, K))
    if list(models_out) != models or len(draws) != KFOLD_EPOCHS * (steps + 1):
        raise AssertionError("train_kfold did not train the models it built, or drew "
                             f"{len(draws)} noise tensors")
    # lockstep steps: from one draw to the next, within an epoch's train
    # steps; the first two (cuDNN deterministic) apart
    step_ms = [1e3 * (marks[i + 1] - marks[i]) for i in range(len(marks) - 1)
               if i % (steps + 1) < steps]
    single = phase6_stats["step_ms"]
    log(f"[kfold] lockstep step of {K} folds (host clock, synchronised, batches gathered "
        f"on the card): median {statistics.median(step_ms[2:]):.2f} ms over steps 2-"
        f"{len(step_ms) - 1}, {statistics.median(step_ms[2:]) / K:.2f} ms a fold; steps "
        f"0-1 (cuDNN deterministic) {step_ms[0]:.2f}, {step_ms[1]:.2f} ms; phase 6's "
        f"single step {single:.2f} ms ({K} x = {K * single:.2f} ms); "
        f"peak device memory {peak / 2**30:.3f} GiB ({peak} bytes; phase 6: "
        f"{phase6_stats['peak_bytes'] / 2**30:.3f} GiB)")
    for epoch in range(KFOLD_EPOCHS):
        mine = [w for w in writes if w[0] == epoch]
        log(f"[kfold] epoch {epoch} checkpoint writes: {sum(w[3] for w in mine)} files, "
            f"{sum(w[2] for w in mine) / 2**30:.3f} GiB in {sum(w[1] for w in mine):.2f} s "
            f"({', '.join(f'{w[1]:.2f}' for w in mine)} s per fold)")
    for rec in history:
        tr, va = rec["train"]["loss"], rec["val"]["loss"]
        log(f"[kfold] epoch {rec['epoch']}: train loss per fold {tr.tolist()}, val loss "
            f"{va.tolist()}")
        if not (np.isfinite(tr).all() and np.isfinite(va).all() and tr.shape == (K,)):
            raise AssertionError(f"k-fold losses {rec}")

    # fold independence: fold 0's first two steps alone
    lone, _ = port["vessel_model"](device="cuda", seed=0, dropout=TRAIN_RATE, cfg=cfg)
    step = port["make_vae_step"](lone, port["vessel_loss_fn"](cfg), make_optimizer(lone))
    batcher = KF.FoldBatcher(plan, B, cfg.kfold_seed)
    lone_gen = torch.Generator().manual_seed(cfg.kfold_seed)
    caller = torch.cuda.get_rng_state()
    torch.backends.cudnn.deterministic = True
    torch.cuda.manual_seed(cfg.kfold_seed)  # fold 0's state of the card's generator
    lone_ms = []
    for s in range(2):
        idx = torch.from_numpy(batcher.next_indices()[0]).cuda()
        t0 = time.perf_counter()
        step({k: v[idx] for k, v in data.items()}, generator=lone_gen, eps=draws[s][0])
        torch.cuda.synchronize()
        lone_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.set_rng_state(caller)
    worst, equal = 0.0, 0
    for k, v in lone.state_dict().items():
        ref = snapshot[k]
        equal += int(torch.equal(v, ref))
        if v.dtype.is_floating_point:
            scale = float(ref.abs().max()) or 1.0
            worst = max(worst, float((v - ref).abs().max()) / scale)
    log(f"[kfold] fold 0 after two lockstep steps against a lone make_vae_step run "
        f"(same weights, batches, noise, generators): {equal} of {len(snapshot)} tensors "
        f"equal bit for bit, worst max|d|/max|ref| {worst:.3e} (tol {KFOLD_ALONE_TOL}); "
        f"lone steps {', '.join(f'{t:.2f}' for t in lone_ms)} ms (cuDNN deterministic)")
    torch.backends.cudnn.deterministic = False
    if not worst <= KFOLD_ALONE_TOL:
        raise AssertionError("fold 0 of the lockstep run differs from the lone run")
    del lone, step, snapshot
    torch.cuda.empty_cache()

    # the ensemble served and reported
    ens = E.stack_fold_variables(models)
    eps = ensemble_endpoints(ens)
    rng = np.random.default_rng(12)
    t_all = np.eye(corpus.t_dim, dtype=np.float32)
    requests = [("uncertainty", (t_all[i: i + 1],)) for i in range(4)] + [
        ("predict_m", (t_all[4:7],)),
        ("decode", (rng.standard_normal((2, cfg.m_dim)).astype(np.float32),
                    rng.standard_normal((2, cfg.z_dim)).astype(np.float32)))]
    for c in counters.values():
        c.reset()  # main path starts here
    with torch.no_grad():
        un_mu, un_sigma = (a.cpu().numpy() for a in E.ensemble_morph_distribution(
            ens, torch.from_numpy(t_all).cuda()))
    results, errors = [None] * len(requests), []
    latency = {}
    with BatchingEngine(eps) as engine:
        def client(i):
            try:
                results[i] = engine.infer(requests[i][0], *requests[i][1])
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        for b in (1, 8):
            args = {"decode": (rng.standard_normal((b, cfg.m_dim)).astype(np.float32),
                               rng.standard_normal((b, cfg.z_dim)).astype(np.float32)),
                    "uncertainty": (t_all[:b],)}
            for name, a in args.items():
                engine.infer(name, *a)  # warm
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    engine.infer(name, *a)
                    times.append(1e3 * (time.perf_counter() - t0))
                latency[name, b] = statistics.median(times)
        stats = dict(engine.stats)
    h, w = VESSEL_HW
    for (name, args), out in zip(requests, results):
        n = args[0].shape[0]
        shapes = [o.shape for o in out]
        want = {"uncertainty": [(n, K, cfg.m_dim)] * 2, "predict_m": [(n, cfg.m_dim)] * 2,
                "decode": [(n, h, w, 1)] * 2}[name]
        if shapes != want or not all(np.isfinite(o).all() for o in out):
            raise AssertionError(f"ensemble {name}: shapes {shapes}, expected {want}")
    for i in range(4):  # each client's own row, batch-leading
        mu, sigma = results[i]
        if not (np.allclose(mu[0], un_mu[:, i], rtol=1e-6, atol=1e-7)
                and np.allclose(sigma[0], un_sigma[:, i], rtol=1e-6, atol=1e-7)):
            raise AssertionError(f"ensemble uncertainty: client {i} got other rows")
    log(f"[kfold-serve] ensemble_endpoints of {K} folds behind BatchingEngine: "
        f"{len(requests)} concurrent requests answered, uncertainty batch-leading "
        f"(1, {K}, {cfg.m_dim}) per client; engine stats {json.dumps(stats)}; latency "
        f"(host clock, median of 5): " + ", ".join(
            f"{name} bucket {b} {ms:.2f} ms" for (name, b), ms in sorted(latency.items())))

    with torch.no_grad():
        mu, sigma = U.ensemble_sigma_by_treatment(ens, corpus.t_dim)
        snr = U.pairwise_snr(mu, sigma, torch.from_numpy(corpus.scaler_scale).cuda())
        xb, mb, tb = (data[k][:2] for k in ("x", "m", "t"))
        z_mu, z_lv = ens[0].encode(xb, mb, tb)
        mc_mean, mc_std = U.mc_decode_stats(ens[0], mb, z_mu, z_lv,
                                            torch.Generator(device="cuda").manual_seed(3),
                                            n_mc=8)
    pred = predictions_by_treatment(ens[0], data["x"], corpus.m, corpus.one_hot_t(
        np.arange(KFOLD_N)), corpus.t_idx, corpus.group_names,
        [f"feat{i}" for i in range(cfg.m_dim)])
    torch.cuda.synchronize()
    launches_serve = {name: c.read() for name, c in counters.items()}  # main path ends
    # predictions: one eval forward per 16 samples; the encode before the MC decodes
    _expect_counts("kfold-serve", launches_serve, {
        "attention_fwd": cfg.vit_depth * (-(-KFOLD_N // 16) + 1)})
    diag = torch.diagonal(snr, dim1=0, dim2=1)
    checks = {"sigma (T, m) finite, > 0": tuple(sigma.shape) == (corpus.t_dim, cfg.m_dim)
              and bool(torch.isfinite(sigma).all() and (sigma > 0).all()),
              "snr (T, T, m) finite, 0 on the diagonal": tuple(snr.shape) == (
                  corpus.t_dim, corpus.t_dim, cfg.m_dim) and bool(torch.isfinite(snr).all())
              and float(diag.abs().max()) == 0.0,
              "mc (2, H, W, 1) finite, std >= 0": tuple(mc_mean.shape) == (2, h, w, 1)
              and bool(torch.isfinite(mc_mean).all() and (mc_std >= 0).all()),
              "predictions finite": len(pred["rows"]) == len(set(corpus.t_idx)) * cfg.m_dim
              and bool(np.isfinite(pred["per_sample_mu"]).all())}
    log(f"[kfold-report] launches {json.dumps(launches_serve)}; {json.dumps(checks)}; "
        f"snr max {float(snr.max()):.4g}, mc std mean {float(mc_std.mean()):.4g}")
    if not all(checks.values()):
        raise AssertionError(f"ensemble report: {checks}")
    del models, models_out, ens, eps, data
    torch.cuda.empty_cache()
    return ({n: launches[n] + launches_serve[n] for n in counters},
            {"step_ms": statistics.median(step_ms[2:]), "peak_bytes": peak,
             "latency": {f"{n}_{b}": ms for (n, b), ms in latency.items()}})


def phase_kfold_cli(port, counters):
    """Phase 12: the CLI's ``kfold --verify``, ``kfold --folds 5 --epochs 1``
    and ``vessel-report --epochs 1`` in process on the card (the CLI's small
    model at 96x160, the synthetic corpus n = KFOLD_CLI_N) in a temporary
    directory; counts zeroed before and read after each, held per lockstep
    step (the depth-2 model: 2 + 2 attention, 18 + 18 BN, 1 + 1 ELBO a fold),
    per val pass (2 attention forwards a fold) and, in the report, per
    16-sample batch of predictions (2 attention forwards); the seven CSV
    files present with their headers and row counts."""
    import contextlib
    import io
    import shutil
    import tempfile

    from causalvae_tpu_torch.train import kfold as KF

    main, vessel = port["cli_main"], port["vessel"]
    corpus = vessel.synthetic_corpus(n=KFOLD_CLI_N, seed=0)
    K, depth = KFOLD_K, 2
    steps = KF.FoldBatcher(KF.stratified_kfold(corpus.t_idx, K, 42), 4).steps_per_epoch()
    per_step = {"attention_fwd": depth, "attention_bwd": depth, "bn_stats": 18,
                "bn_bwd": 18, "elbo_terms": 1, "elbo_terms_bwd": 1}
    per_val = {"attention_fwd": depth}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kfold_cli_")
    by_run = {}
    base = ["--out", tmp, "--n-synthetic", str(KFOLD_CLI_N)]

    def counted(tag, argv, want):
        for c in counters.values():
            c.reset()  # main path starts here
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = main(base + argv)
        torch.cuda.synchronize()
        launches = {name: c.read() for name, c in counters.items()}  # main path ends
        log(f"[{tag}] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; launches "
            f"{json.dumps(launches)}")
        _expect_counts(tag, launches, want)
        by_run[tag] = launches
        return result, out.getvalue()

    try:
        _, text = counted("kfold-verify", ["kfold", "--verify", "--folds", str(K)], {})
        report = json.loads(text)
        if sorted(report) != [f"fold_{f}" for f in range(K)]:
            raise AssertionError(f"kfold --verify printed {text[:200]}")
        (models, plan, _, history), text = counted(
            "kfold-cli", ["kfold", "--folds", str(K), "--epochs", "1"],
            _kfold_want(per_step, per_val, 1, steps, K))
        if not all(np.isfinite(history[0][s]["loss"]).all() for s in ("train", "val")):
            raise AssertionError(f"kfold losses {history}")
        log(f"[kfold-cli] {text.strip().splitlines()[-1]}")
        written, text = counted(
            "vessel-report", ["vessel-report", "--folds", str(K), "--epochs", "1"],
            _kfold_want(per_step, per_val, 1, steps, K, extra={
                "attention_fwd": depth * -(-KFOLD_CLI_N // 16)}))
        log(f"[vessel-report] {text.strip().splitlines()[-1]}")
        want = report_csv_want(corpus.t_dim, corpus.m.shape[1], len(set(corpus.t_idx)))
        got = report_csv_got(written)
        log(f"[vessel-report] CSV files (header, rows): {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"vessel-report CSV files {got}, expected {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {name: sum(r[name] for r in by_run.values()) for name in counters}


# ---------------------------------------------------------------------------
# Phase 13: a file-backed corpus
# ---------------------------------------------------------------------------

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (TIFF 6.0, section 13): 9- to 12-bit codes packed MSB first,
    Clear (256) first and whenever the table fills, EOI (257) last; the code
    width grows one code before the table needs it, as libtiff reads it."""
    table, nxt, bits = {}, 258, 9
    codes, widths = [256], [9]
    w = data[0] if data else None
    for ch in data[1:]:
        c = table.get((w << 8) | ch)
        if c is not None:
            w = c
            continue
        codes.append(w)
        widths.append(bits)
        table[(w << 8) | ch] = nxt
        nxt += 1
        if nxt == (1 << bits) and bits < 12:
            bits += 1
        if nxt == 4094:
            codes.append(256)
            widths.append(bits)
            table, nxt, bits = {}, 258, 9
        w = ch
    if w is not None:
        codes.append(w)
        widths.append(bits)
    codes.append(257)
    widths.append(bits)
    c = np.asarray(codes, np.int64)[:, None]
    n = np.asarray(widths, np.int64)[:, None]
    shift = n - 1 - np.arange(12)
    stream = (c >> np.maximum(shift, 0)) & 1
    return np.packbits(stream[shift >= 0].astype(np.uint8)).tobytes()


def packbits_encode(row: bytes) -> bytes:
    """PackBits (TIFF 6.0, section 9) of one row: runs of 3 or more equal
    bytes as replicate packets, the rest as literal packets, 128 bytes at
    most each."""
    a = np.frombuffer(row, np.uint8)
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]]).tolist()
    ends = starts[1:] + [len(a)]
    out = bytearray()

    def literal(lo, hi):
        for j in range(lo, hi, 128):
            chunk = row[j:min(j + 128, hi)]
            out.append(len(chunk) - 1)
            out.extend(chunk)

    lit = None
    for s, e in zip(starts, ends):
        if e - s < 3:
            lit = s if lit is None else lit
            continue
        if lit is not None:
            literal(lit, s)
            lit = None
        while e - s >= 2:
            k = min(e - s, 128)
            out.extend((257 - k, row[s]))
            s += k
        if e - s == 1:
            literal(s, e)
    if lit is not None:
        literal(lit, len(a))
    return bytes(out)


def write_tiff(path: str, arr: np.ndarray, compression: int, predictor: int = 1,
               rows: int = 64) -> int:
    """A little-endian grayscale TIFF of ``arr`` (uint8, uint16 or float32)
    in strips of ``rows`` rows: compression 1 (none), 5 (LZW), 8 (Deflate,
    zlib level 1) or 32773 (PackBits, row by row); predictor 2 is horizontal
    differencing. Returns the bytes written."""
    import struct
    import zlib

    h, w = arr.shape
    strips = []
    for y in range(0, h, rows):
        block = arr[y:y + rows]
        if predictor == 2:  # differences wrap in the unsigned type
            block = np.concatenate([block[:, :1], np.diff(block, axis=1)], axis=1)
        raw = block.astype(block.dtype.newbyteorder("<")).tobytes()
        if compression == 5:
            raw = lzw_encode(raw)
        elif compression == 8:
            raw = zlib.compress(raw, 1)
        elif compression == 32773:
            step = w * arr.itemsize
            raw = b"".join(packbits_encode(raw[i:i + step]) for i in range(0, len(raw), step))
        strips.append(raw)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8 * arr.itemsize),
               (259, 3, 1, compression), (262, 3, 1, 1), (277, 3, 1, 1), (278, 4, 1, rows),
               (339, 3, 1, 3 if arr.dtype == np.float32 else 1)]
    if predictor != 1:
        entries.append((317, 3, 1, predictor))
    ns = len(strips)
    arrays_at = 8 + 2 + 12 * (len(entries) + 2) + 4
    data_at = arrays_at + (8 * ns if ns > 1 else 0)
    offsets = (data_at + np.cumsum([0] + [len(s) for s in strips[:-1]])).tolist()
    counts = [len(s) for s in strips]
    if ns > 1:
        entries += [(273, 4, ns, arrays_at), (279, 4, ns, arrays_at + 4 * ns)]
        arrays = struct.pack(f"<{ns}I{ns}I", *offsets, *counts)
    else:
        entries += [(273, 4, 1, data_at), (279, 4, 1, counts[0])]
        arrays = b""
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", *e) for e in sorted(entries)) + struct.pack("<I", 0)
    head = b"II" + struct.pack("<HI", 42, 8) + ifd + arrays
    with open(path, "wb") as f:
        f.write(head)
        for s in strips:
            f.write(s)
    return len(head) + sum(counts)


# compression and predictor of each format of the corpus
FILE_CODECS = {"deflate16": (8, 2), "lzw8": (5, 1), "lzw16": (5, 2), "packbits": (32773, 1),
               "u8": (1, 1), "f32": (1, 1)}


def file_image(fmt: str, mask: np.ndarray, base: float, gain: float, ramp: np.ndarray,
               noise: np.ndarray) -> np.ndarray:
    """One corpus image at FILE_HW: a 96x160 mask upscaled 10x, times
    ``gain``, on ``base`` plus a horizontal ramp, plus noise; 16-bit, or as
    ``fmt`` stores it (8-bit: 16 levels; float32: scaled to [0, 1])."""
    H, W = FILE_HW
    up = np.repeat(np.repeat(mask, H // mask.shape[0], 0), W // mask.shape[1], 1)
    u16 = np.clip(base + ramp + gain * up + noise, 0, 65535).astype(np.uint16)
    if fmt == "f32":
        return (u16 / np.float32(65535)).astype(np.float32)
    if fmt in ("lzw8", "packbits", "u8"):
        return ((u16 >> 12) << 4).astype(np.uint8)
    return u16


def write_file_corpus(root: str, vessel) -> dict:
    """Phase 13(b): the corpus under ``root``; returns its CSV path, the
    files' paths and formats, the arrays of the first FILE_CHECK_N as
    written, and the bytes on disk."""
    import csv
    import os
    from concurrent.futures import ThreadPoolExecutor

    syn = vessel.synthetic_corpus(n=FILE_N, seed=0)
    rng = np.random.default_rng(13)
    H, W = FILE_HW
    noise = rng.normal(0.0, 600.0, (H + 64, W + 64)).astype(np.float32)
    ramp = np.linspace(0.0, 3000.0, W, dtype=np.float32)[None, :]
    base = rng.uniform(1500.0, 4000.0, FILE_N)
    gain = rng.uniform(15000.0, 45000.0, FILE_N)
    shift = rng.integers(0, 64, (FILE_N, 2))
    fmts = list(FILE_FORMATS) + ["deflate16"] * (FILE_N - len(FILE_FORMATS))
    paths = [os.path.join(root, f"H11-{700000 + i}.vessel.mip.tiff") for i in range(FILE_N)]

    def write(i):
        r, c = shift[i]
        arr = file_image(fmts[i], syn.raw_images[i], base[i], gain[i], ramp,
                         noise[r:r + H, c:c + W])
        return (arr if i < FILE_CHECK_N else None), write_tiff(paths[i], arr, *FILE_CODECS[fmts[i]])

    # the slow pure-Python encoders (LZW, PackBits) first, beside the rest
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        done = list(pool.map(write, range(FILE_N)))
    csv_path = os.path.join(root, "vessel_meta.csv")
    with open(csv_path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Image ID", "group_name", *vessel.FEATURE_COLUMNS])
        for i in range(FILE_N):
            out.writerow([700000 + i, syn.group_names[syn.t_idx[i]],
                          *(repr(float(v)) for v in syn.m_raw[i])])
    return {"csv": csv_path, "paths": paths, "formats": fmts,
            "arrays": [a for a, _ in done[:FILE_CHECK_N]],
            "bytes": sum(n for _, n in done) + os.path.getsize(csv_path)}


def check_file_decode(vessel, files):
    """Phase 13(c): for the first file of each format, ``load_raw`` equals
    the array written, bit for bit, with tifffile and PIL blocked."""
    import importlib.util

    names = ("tifffile", "PIL", "PIL.Image")
    present = {m: importlib.util.find_spec(m) is not None for m in names[:2]}
    saved = {m: sys.modules.get(m) for m in names}
    sys.modules.update(dict.fromkeys(names, None))
    ms = {}
    try:
        for fmt in dict.fromkeys(files["formats"]):
            i = files["formats"].index(fmt)
            t0 = time.perf_counter()
            got = vessel.load_raw(files["paths"][i])
            ms[fmt] = round(1e3 * (time.perf_counter() - t0), 2)
            want = files["arrays"][i].astype(np.float32)
            if got.dtype != np.float32 or not np.array_equal(got, want):
                raise AssertionError(f"load_raw of the {fmt} file {i} differs from the array "
                                     f"written ({got.dtype}, {got.shape})")
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    log(f"[file-corpus] load_raw equals the array written, bit for bit, for one file of "
        f"each format, with tifffile and PIL blocked (ms each: {json.dumps(ms)}); on this "
        f"machine: {json.dumps(present)}")


def normalized(raw: torch.Tensor, aug) -> torch.Tensor:
    """Resize (antialiased bilinear) to VESSEL_HW, flip by aug, min-max: the
    device transform before its binarize, on the card, in float64 after
    the resize."""
    img = F.interpolate(raw[:, None], size=VESSEL_HW, mode="bilinear", align_corners=False,
                        antialias=True)[:, 0].double()
    for i, a in enumerate(aug):
        if a in (1, 3):
            img[i] = img[i].flip(-1)
        if a in (2, 3):
            img[i] = img[i].flip(-2)
    lo, hi = img.amin(dim=(1, 2), keepdim=True), img.amax(dim=(1, 2), keepdim=True)
    return (img - lo) / (hi - lo)


def check_file_transform(vessel, native, corpus, files):
    """Phase 13(d): ``decode_image`` of 8 files (flips 0-3) against the
    card's resize and min-max of the arrays written (max|d| <=
    FILE_RESIZE_TOL); then ``iterate_batches(use_native=True)`` over the
    first FILE_CHECK_N files against ``iterate_batches`` on an in-memory
    corpus of the same arrays (``make_preprocess`` on the card): m, t and
    labels equal, binarized pixels differing only within 1e-5 of their
    image's mean and at most FILE_FLIP_MAX of them."""
    import dataclasses

    aug = [0, 1, 2, 3, 0, 1, 2, 3]
    got = np.stack([native.decode_image(p, VESSEL_HW, binarize=False, flip_mode=a)
                    for p, a in zip(files["paths"][:8], aug)])
    raw = torch.from_numpy(np.stack([a.astype(np.float32) for a in files["arrays"][:8]]))
    want = normalized(raw.cuda(), aug).float().cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"[file-corpus] decode_image (resize {FILE_HW} -> {VESSEL_HW}, flips 0-3, min-max) of "
        f"files 0-7 against the card's F.interpolate(antialias=True) + min-max: max|d| "
        f"{err:.3e} (bound {FILE_RESIZE_TOL:.0e})")
    check("decode_image against the card's resize", err, FILE_RESIZE_TOL)

    K = FILE_CHECK_N
    sub = dataclasses.replace(corpus, paths=corpus.paths[:K], m=corpus.m[:K],
                              t_idx=corpus.t_idx[:K],
                              splits={"train": np.arange(K, dtype=np.int32)})
    mem = dataclasses.replace(sub, paths=[""] * K, raw_images=np.stack(
        [a.astype(np.float32) for a in files["arrays"]]))
    pairs = np.stack(np.meshgrid(np.arange(K), np.arange(4), indexing="ij"), -1).reshape(-1, 2)
    np.random.default_rng(0).shuffle(pairs)
    kw = dict(shuffle_seed=0, device="cuda")
    off = near = total = 0
    batches = zip(vessel.iterate_batches(sub, "train", TRAIN_BATCH, VESSEL_HW, use_native=True,
                                         **kw),
                  vessel.iterate_batches(mem, "train", TRAIN_BATCH, VESSEL_HW, **kw))
    for k, (a, b) in enumerate(batches):
        if not (np.array_equal(a["labels"], b["labels"]) and torch.equal(a["m"], b["m"])
                and torch.equal(a["t"], b["t"])):
            raise AssertionError(f"batch {k}: m, t or labels differ between the routes")
        chunk = pairs[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH]
        img = normalized(torch.from_numpy(mem.raw_images[chunk[:, 0]]).cuda(), chunk[:, 1])
        close = (img - img.mean(dim=(1, 2), keepdim=True)).abs() <= 1e-5
        differ = a["x"][..., 0] != b["x"][..., 0]
        if (differ & ~close).any():
            raise AssertionError(f"batch {k}: {int((differ & ~close).sum())} mask pixels differ "
                                 "away from their image's mean")
        off, near, total = off + int(differ.sum()), near + int(close.sum()), total + differ.numel()
    share = off / total
    log(f"[file-corpus] iterate_batches native (files) against in-memory (make_preprocess on "
        f"the card), {len(pairs) // TRAIN_BATCH} batches of {TRAIN_BATCH}: m, t, labels "
        f"equal; {off} of {total} mask pixels differ (share {share:.3e}, bound "
        f"{FILE_FLIP_MAX:.0e}), {near} pixels lie within 1e-5 of their threshold")
    if share > FILE_FLIP_MAX:
        raise AssertionError(f"{share:.3e} of the mask pixels differ")


def loader_throughput(native, paths):
    """Phase 13(e): ``NativeBatchLoader`` alone, batches of 8 at VESSEL_HW
    (binarized, flips by position): LOADER_BATCHES_ONE_THREAD at 1 thread,
    then LOADER_BATCHES at 4 and at cpu_count threads, samples 0-511 and
    512-1023 between those two, so that every file is decoded and none may
    come back all zeros."""
    import os

    n = LOADER_BATCHES * TRAIN_BATCH
    rates = {}
    for threads, first, count in ((1, 0, LOADER_BATCHES_ONE_THREAD * TRAIN_BATCH), (4, 0, n),
                                  (os.cpu_count(), n, n)):
        order = np.arange(first, first + count, dtype=np.int32) % len(paths)
        loader = native.NativeBatchLoader(paths, order, VESSEL_HW, TRAIN_BATCH,
                                          augs=order % 4, binarize=True, n_threads=threads)
        zeros, seen = [], 0
        t0 = time.perf_counter()
        try:
            for data, idx in loader:
                seen += len(idx)
                zeros += idx[data.reshape(len(idx), -1).max(1) == 0].tolist()
        finally:
            loader.close()
        secs = time.perf_counter() - t0
        rates[threads] = seen / secs
        log(f"[file-corpus] NativeBatchLoader, {threads} threads: {seen} images in "
            f"{secs:.3f} s = {rates[threads]:.1f} images/s ({seen // TRAIN_BATCH} batches of "
            f"{TRAIN_BATCH}, {FILE_HW} -> {VESSEL_HW})")
        if seen != count or zeros:
            raise AssertionError(f"{seen} of {count} images; samples all zeros: {zeros}")
    log(f"[file-corpus] host: os.cpu_count() {os.cpu_count()}, "
        f"{len(os.sched_getaffinity(0))} in this process' affinity")
    return rates


def report_csv_want(T: int, M: int, present: int) -> dict:
    """The header and row count of each CSV file ``vessel-report`` writes."""
    return {"predictions_by_treatment": ("treatment,feature,mean,std,n", present * M),
            "uncertainty_by_treatment": ("treatment,feature,pred_mean,aleatoric_sigma", T * M),
            "feature_stats": ("treatment,feature,mean_real,sigma_real", T * M),
            "pairwise_snr": ("treatment_a,treatment_b,feature,snr", T * (T - 1) * M),
            "all_pairwise_report": ("treatment_a,treatment_b,feature,diff,abs_diff",
                                    T * (T - 1) * M),
            "pairwise_report_formatted": ("treatment_a,treatment_b,rank,feature,diff",
                                          T * (T - 1) * 3),
            "significant_changes": ("treatment,vs,feature,snr,delta", 10)}


def report_csv_got(written) -> dict:
    import csv
    import os

    got = {}
    for path in written:
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        got[os.path.basename(path)[:-4]] = (",".join(rows[0]), len(rows) - 1)
    return got


def phase_file_corpus(port, counters, phase6_step_ms: float):
    """Phase 13: a file-backed corpus. (a) Build the native loader with g++;
    (b) write FILE_N TIFF files and their CSV in a temporary directory;
    (c) ``load_raw`` of each format bit for bit; (d) the native transform
    against the card's; (e) the loader's images/s; (f) one epoch of ``train
    vessel --csv --data`` at 768x1280 (f32, batch 8), counts held per step
    and per val batch, then ``serve vessel --ckpt``; (g) ``kfold --verify``
    and ``vessel-report`` on the same files, counts and CSV files held;
    (h) the directory removed."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from causalvae_tpu_torch import native
    from causalvae_tpu_torch.train import kfold as KF

    main, vessel = port["cli_main"], port["vessel"]
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    secs = native.build()
    if not native.available():
        raise AssertionError(f"the native loader does not load: {native.build_error()}")
    log(f"[file-corpus] native loader built with {gxx.stdout.splitlines()[0]} in {secs:.2f} s: "
        f"{native.library_path().name}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_file_corpus_")
    by_run = {}

    def counted(tag, argv, want):
        for c in counters.values():
            c.reset()  # main path starts here
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = main(["--out", os.path.join(tmp, "out"), *argv])
        torch.cuda.synchronize()
        launches = {name: c.read() for name, c in counters.items()}  # main path ends
        log(f"[{tag}] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; launches "
            f"{json.dumps(launches)}")
        _expect_counts(tag, launches, want)
        by_run[tag] = launches
        return result, out.getvalue()

    try:
        free = shutil.disk_usage(tmp).free
        log(f"[file-corpus] corpus and run directories under {tmp}: {free / 2**30:.1f} GiB free")
        if free < FILE_DISK:
            raise AssertionError(f"{free / 2**30:.1f} GiB free, {FILE_DISK / 2**30:.0f} GiB needed")
        root = os.path.join(tmp, "tree")
        os.makedirs(root)
        t0 = time.perf_counter()
        files = write_file_corpus(root, vessel)
        log(f"[file-corpus] wrote {FILE_N} TIFF files ({FILE_HW[0]}x{FILE_HW[1]}; formats "
            f"{json.dumps({f: files['formats'].count(f) for f in dict.fromkeys(files['formats'])})}"
            f") and the CSV in {time.perf_counter() - t0:.1f} s: {files['bytes']} bytes on disk "
            f"({files['bytes'] / 2**30:.3f} GiB)")
        csv_args = ["--csv", files["csv"], "--data", root]
        corpus = vessel.scan_corpus(files["csv"], root)
        if corpus.paths != files["paths"]:
            raise AssertionError("scan_corpus does not read the corpus in file order")

        check_file_decode(vessel, files)
        check_file_transform(vessel, native, corpus, files)
        rates = loader_throughput(native, files["paths"])

        steps = len(corpus.splits["train"]) * 4 // TRAIN_BATCH
        val = -(-len(corpus.splits["val"]) // TRAIN_BATCH)
        want = {n: steps * PER_STEP.get(n, 0) + val * PER_VAL.get(n, 0) for n in counters}
        (model, opt, log_), _ = counted("file-epoch", ["train", "vessel", *csv_args,
                                                       "--epochs", "1"], want)
        run = os.path.join(tmp, "out", "train_vessel")
        if log_.clock.records[0]["steps"] != steps or not np.isfinite(
                [log_.history[0]["train_loss"], log_.history[1]["val_loss"]]).all():
            raise AssertionError(f"train vessel on the files: {log_.clock.records[0]['steps']} "
                                 f"steps (expected {steps}), {log_.history}")
        for name in ("metrics.jsonl", "latest.pt", "latest.meta.json", "best.pt",
                     "best.meta.json"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"train vessel wrote no {name}")
        log_epochs("file-epoch", log_, phase6_step_ms)
        step_ms = statistics.median(log_.clock.records[0]["step_ms"])
        log(f"[file-epoch] {steps} steps and {val} val batches; the loop needs "
            f"{TRAIN_BATCH} images per {step_ms:.2f} ms step = "
            f"{TRAIN_BATCH / step_ms * 1e3:.1f} images/s; the loader alone gives "
            + ", ".join(f"{r:.1f} at {t} threads" for t, r in rates.items()))
        log(f"[file-epoch] metrics {json.dumps(log_.history)}")
        del model, opt
        torch.cuda.empty_cache()
        _, text = counted("file-serve", ["serve", "vessel", "--ckpt", run, "--img-hw",
                                         str(VESSEL_HW[0]), str(VESSEL_HW[1]), "--smoke"],
                          {"attention_fwd": PER_VAL["attention_fwd"]})
        res = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
        if res.get("smoke") != "ok" or res.get("reconstruct_shape") != [1, *VESSEL_HW, 1]:
            raise AssertionError(f"serve vessel --ckpt: {res}")
        log(f"[file-serve] {json.dumps(res)}")
        shutil.rmtree(run)

        K, depth = KFOLD_K, 2
        _, text = counted("file-kfold-verify", ["kfold", "--verify", "--folds", str(K),
                                                *csv_args], {})
        if sorted(json.loads(text)) != [f"fold_{f}" for f in range(K)]:
            raise AssertionError(f"kfold --verify printed {text[:200]}")
        kf_steps = KF.FoldBatcher(KF.stratified_kfold(corpus.t_idx, K, 42),
                                  FILE_REPORT_BATCH).steps_per_epoch()
        per_step = {"attention_fwd": depth, "attention_bwd": depth, "bn_stats": 18,
                    "bn_bwd": 18, "elbo_terms": 1, "elbo_terms_bwd": 1}
        written, text = counted(
            "file-vessel-report", ["vessel-report", "--folds", str(K), "--epochs", "1",
                                   "--batch-size", str(FILE_REPORT_BATCH), "--img-hw", "96",
                                   "160", *csv_args],
            _kfold_want(per_step, {"attention_fwd": depth}, 1, kf_steps, K, extra={
                "attention_fwd": depth * -(-FILE_N // 16)}))
        got = report_csv_got(written)
        want_csv = report_csv_want(corpus.t_dim, corpus.m.shape[1], len(set(corpus.t_idx)))
        log(f"[file-vessel-report] {text.strip().splitlines()[-1]}; CSV files (header, rows): "
            f"{json.dumps(got)}")
        if got != want_csv:
            raise AssertionError(f"vessel-report CSV files {got}, expected {want_csv}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {name: sum(r[name] for r in by_run.values()) for name in counters}


# phase 14: the deployment bundle of the flagship: ``export vessel --buckets 1``
# through the CLI, then every endpoint but do_t at bucket 8 into a second
# bundle (do_t's program unrolls 19 decodes: 23.5-27.1 s to export a bucket on
# an H100 machine, so it is exported at bucket 1 only)
EXPORT_BUCKETS = (1, 8)
EXPORT_TOL = 1e-5  # of max|ref|: the same kernels and ATen calls as eager; equal bits expected
# under cudnn.deterministic (without it cuDNN's f32 algorithms differ run to run)
ENCODER_ENDPOINTS = ("encode", "reconstruct", "do_t")  # one encoder pass per call
# bundles served from one fresh process (phase 15: the vessel's of phase 14,
# then the MNIST one), which must import no model code
SERVE_BUNDLE_PROBE = r"""
import json, sys
from causalvae_tpu_torch.cli.main import main
for workload, out in zip(sys.argv[1::2], sys.argv[2::2]):
    main(["serve", workload, "--export-dir", out, "--smoke", "--buckets", "1", "8"])
models = sorted(m for m in sys.modules if m.startswith("causalvae_tpu_torch.models"))
print(json.dumps({"models_imported": models}))
sys.exit(1 if models else 0)
"""


def phase_export(port, attention, depth: int, smi: str, root: str) -> dict:
    """Phase 14: ``export vessel --buckets 1`` of the seeded flagship at
    768x1280 (f32, on the card) through the CLI into ``<root>/export_vessel``
    (kept for phase 15's fresh-process smoke), then the same weights' five
    endpoints other than do_t at bucket 8 with ``export_endpoints`` into
    ``<root>/export_vessel_8``; export seconds per endpoint and bucket,
    program and params bytes; ``load_exported`` here, each endpoint at
    buckets 1 and 8 (do_t at 1) against the eager endpoints of the same
    weights (``EXPORT_TOL``; TF32 off, cuDNN's deterministic algorithms), the
    attention counter zeroed before and read after each call, the exported
    call held to exactly the eager call's launches (``depth`` per encoder
    pass); without the deterministic algorithms, eager against eager and
    exported against eager once; reconstruct latency, exported against
    eager, in turns. Returns the exported calls' launches."""
    import os

    from causalvae_tpu_torch.cli.main import export_summary
    from causalvae_tpu_torch.serve.endpoints import endpoint_arg_specs, vae_endpoints
    from causalvae_tpu_torch.serve.export import export_endpoints, load_exported

    t0 = time.perf_counter()
    summary = port["cli_main"](["--out", root, "export", "vessel", "--buckets", "1"])
    log(f"[export] export vessel --buckets 1: {time.perf_counter() - t0:.1f} s in all; "
        f"params file {summary['params_bytes']} bytes")
    model, (h, w) = port["serving_model"](device="cuda", seed=0)
    eps = vae_endpoints(model)
    out8 = os.path.join(root, "export_vessel_8")
    t0 = time.perf_counter()
    manifest = export_endpoints({n: fn for n, fn in eps.items() if n != "do_t"},
                                endpoint_arg_specs(model, img_hw=(h, w)), out8, buckets=(8,),
                                metadata={"workload": "vessel", "img_hw": [h, w]})
    summary8 = export_summary(out8, manifest)
    log(f"[export] export_endpoints, every endpoint but do_t at bucket 8: "
        f"{time.perf_counter() - t0:.1f} s in all; params file {summary8['params_bytes']} bytes")
    for bundle_summary in (summary, summary8):
        for name, info in bundle_summary["endpoints"].items():
            log(f"[export] {name}: programs {info['bytes']} bytes; export + save seconds "
                f"by bucket {json.dumps(info['export_s'])}")

    t0 = time.perf_counter()
    bundles = {1: load_exported(summary["export_dir"]), 8: load_exported(out8)}
    log(f"[export] load_exported of both bundles on {bundles[1].device}: "
        f"{time.perf_counter() - t0:.1f} s")
    ladders = {name: (1,) if name == "do_t" else EXPORT_BUCKETS for name in eps}
    rng = np.random.default_rng(14)
    m_dim, t_dim, z_dim = model.m_dim, model.t_dim, model.z_dim

    def args(name, b):
        x = (rng.random((b, h, w, 1)) > 0.85).astype(np.float32)
        m = rng.standard_normal((b, m_dim)).astype(np.float32)
        t = np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, b)]
        z = rng.standard_normal((b, z_dim)).astype(np.float32)
        return {"decode": (m, z), "predict_m": (t,), "uncertainty": (t,)}.get(
            name, (x, m, t))

    def counted(fn, a):
        attention.LAUNCHES = 0
        with torch.inference_mode():
            got = fn(*a)
        torch.cuda.synchronize()
        return got, attention.LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    exported_launches = 0
    for name in sorted(eps):
        for b in ladders[name]:
            a = tuple(torch.from_numpy(x).cuda() for x in args(name, b))
            bundles[b].call(name, *a)  # load the program, warm
            want, n_eager = counted(eps[name], a)
            got, n_exported = counted(lambda *x: bundles[b].call(name, *x), a)
            exported_launches += n_exported
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            errs = [max_err(g, r) for g, r in zip(got, want)]
            scale = max(float(r.abs().max()) for r in want)
            equal = all(torch.equal(g, r) for g, r in zip(got, want))
            log(f"[export] {name} bucket {b}: max|d| {max(errs):.3e} of max|ref| "
                f"{scale:.3e} (bit-equal {equal}); attention launches exported "
                f"{n_exported}, eager {n_eager}")
            if [tuple(g.shape) for g in got] != [tuple(r.shape) for r in want]:
                raise AssertionError(f"export {name} bucket {b}: shapes differ")
            if max(errs) > EXPORT_TOL * scale:
                raise AssertionError(f"export {name} bucket {b}: max|d| {max(errs):.3e}")
            n_want = depth if name in ENCODER_ENDPOINTS else 0
            if n_exported != n_eager or n_eager != n_want:
                raise AssertionError(f"export {name} bucket {b}: attention launches "
                                     f"{n_exported} exported, {n_eager} eager, "
                                     f"{n_want} expected")
    torch.backends.cudnn.deterministic = False
    a = tuple(torch.from_numpy(x).cuda() for x in args("reconstruct", 8))
    with torch.inference_mode():
        first, again, exported = (eps["reconstruct"](*a), eps["reconstruct"](*a),
                                  bundles[8].call("reconstruct", *a))
    log(f"[export] without cudnn.deterministic, reconstruct bucket 8: eager against "
        f"eager max|d| {max_err(again, first):.3e}, exported against eager "
        f"{max_err(exported, first):.3e}")

    latency = {}
    for b in EXPORT_BUCKETS:
        a = tuple(torch.from_numpy(x).cuda() for x in args("reconstruct", b))
        calls = {"eager": lambda: eps["reconstruct"](*a),
                 "exported": lambda: bundles[b].call("reconstruct", *a)}
        times = {k: [] for k in calls}
        with torch.inference_mode():
            for i in range(5):
                for k in (("eager", "exported") if i % 2 == 0 else ("exported", "eager")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    calls[k]()
                    torch.cuda.synchronize()
                    times[k].append((time.perf_counter() - t0) * 1e3)
        latency[b] = {k: statistics.median(v) for k, v in times.items()}
        log(f"[export] reconstruct bucket {b} (host clock, median of 5, in turns): "
            f"exported {latency[b]['exported']:.2f} ms, eager {latency[b]['eager']:.2f} ms "
            f"({smi})")
    del model, eps, bundles
    torch.cuda.empty_cache()
    return {"attention_fwd": exported_launches}


# phase 15: the MNIST study (C1 mnist, C4 mnist-bayes) at MnistConfig's
# widths: batch 128, z 10, m 12, t 10, 28x28; the CLI's synthetic corpus
MNIST_N = 1024
# sha1 of synthetic_mnist(1024, seed=42)'s images and labels as drawn where the
# reference was recorded: PIL 12.1.0 with FreeType 2.14.1 (load_default() is a
# FreeType font there); the card's PIL must draw the same glyphs
MNIST_SHA1 = "5a4941710a3e42731944bdf52d074c8322144f55"
MNIST_M_SHA1 = "ff0b4ec2931899ddf42d6639b9449460eb42be0d"  # its 12 features there (logged)
MNIST_EPOCHS = 3  # train mnist 3 epochs of 8 steps, then --resume to 4
MNIST_BAYES_EPOCHS = 2
MNIST_CHECK_BATCH = 32  # (c): one step, card against CPU
MNIST_TERMS_REL = 1e-4  # (c): the loss terms, as phase 7
MNIST_GRAD_TOL = 1e-3  # (c): each gradient leaf, of its max|ref|, as phase 7
MNIST_SERVE_BUCKETS = (1, 32)  # (d): reconstruct latency through the engine
MNIST_EXPORT_BUCKETS = (1, 8)


def mnist_cli(main, argv) -> tuple:
    """(return value, standard output) of the port's CLI in-process; the
    output is logged too."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    {line}")
    return out, text


def phase_mnist(port, counters, smi: str, vessel_bundle: str) -> dict:
    """Phase 15: the MNIST study on the card through the port's CLI
    in-process, in a temporary directory. (a) the corpus: the card's
    ``synthetic_mnist(1024, seed=42)`` held to ``MNIST_SHA1`` (the card's PIL
    version printed), ``build_morph_mnist`` measured on the host then read
    back from the cache, bit for bit, the host seconds of each; (b)
    ``train mnist`` for 3 epochs of 8 steps at batch 128, ``--resume`` to 4,
    ``train mnist-bayes`` for 2: losses finite, the resume at epoch 3, the
    restored VAE's encode bit-equal to the trained one's, the step time
    (host clock, synchronised, median of steps 1-7), images/s, the
    ``EpochClock`` split and the pair file's size; (c) one adversarial step
    at batch 32 from one set of seeded weights and one injected noise on the
    card and on the CPU, TF32 off, C1 and C4: the loss terms at rel 1e-4,
    every gradient leaf of both models at 1e-3 of its max|ref|; (d) ``serve
    --ckpt --smoke`` of both, ``BatchingEngine(vae_endpoints(...))`` with
    five endpoints for C1 and six for C4, reconstruct latency at buckets 1
    and 32, ``export mnist --ckpt --buckets 1 8`` (seconds and bytes), every
    endpoint of the bundle at both buckets against eager under
    ``cudnn.deterministic``, and one fresh process serving phase 14's
    vessel bundle and this one from ``--export-dir`` without importing
    ``causalvae_tpu_torch.models``. Every kernel counter is zeroed before
    (a)-(d) and read after them: the MNIST path launches none of the ported
    kernels. Returns those counts."""
    import hashlib
    import os
    import shutil
    import tempfile

    import PIL
    from PIL import features

    from causalvae_tpu_torch.config import MnistConfig
    from causalvae_tpu_torch.data import mnist as DM
    from causalvae_tpu_torch.models.heads import LatentDiscriminator
    from causalvae_tpu_torch.models.vae import CausalConvVAE, seeded_init_
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.serve.engine import BatchingEngine
    from causalvae_tpu_torch.serve.export import load_exported
    from causalvae_tpu_torch.train.loop import make_mnist_adversarial_step

    main = port["cli_main"]
    cfg = MnistConfig()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mnist_")
    t_phase = time.perf_counter()
    try:
        for c in counters.values():
            c.reset()  # the MNIST path starts here
        # (a) the corpus and its morphology
        t0 = time.perf_counter()
        images, labels = DM.synthetic_mnist(MNIST_N, seed=42)
        draw_s = time.perf_counter() - t0
        digest = hashlib.sha1(images.tobytes() + labels.tobytes()).hexdigest()
        log(f"[mnist-corpus] synthetic_mnist({MNIST_N}, seed=42) in {draw_s:.3f} s with PIL "
            f"{PIL.__version__}, FreeType {features.version('freetype2')}: sha1 {digest} "
            f"(reference {MNIST_SHA1}: PIL 12.1.0, FreeType 2.14.1)")
        if digest != MNIST_SHA1:
            raise AssertionError("the card's PIL draws another synthetic MNIST corpus")
        cache = os.path.join(tmp, "morph_cache_12.npz")
        t0 = time.perf_counter()
        ds = DM.build_morph_mnist(images, labels, cache_path=cache)
        measure_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = DM.build_morph_mnist(images, labels, cache_path=cache)
        cached_s = time.perf_counter() - t0
        m_digest = hashlib.sha1(ds.m.tobytes()).hexdigest()
        log(f"[mnist-corpus] build_morph_mnist: measured on the host in {measure_s:.3f} s "
            f"({1e3 * measure_s / MNIST_N:.3f} ms an image), from the cache in {cached_s:.3f} s, "
            f"equal bits {np.array_equal(ds.m, again.m)}; m sha1 {m_digest} (reference "
            f"{MNIST_M_SHA1}: {m_digest == MNIST_M_SHA1})")
        if not np.array_equal(ds.m, again.m) or not np.isfinite(ds.m).all():
            raise AssertionError("build_morph_mnist: the cache gave other m")

        # (b) training through the CLI
        base = ["--out", tmp, "--n-synthetic", str(MNIST_N)]
        run = os.path.join(tmp, "train_mnist")
        steps = MNIST_N // cfg.batch_size
        t0 = time.perf_counter()
        (vae, disc, vae_opt, d_opt, log1), _ = mnist_cli(
            main, base + ["train", "mnist", "--epochs", str(MNIST_EPOCHS)])
        train_s = time.perf_counter() - t0
        hist = [r for r in log1.history if r["step"] >= 0]
        losses = [r[k] for r in hist for k in ("loss", "d_loss")]
        if [r["step"] for r in hist] != list(range(MNIST_EPOCHS)) or not np.isfinite(losses).all():
            raise AssertionError(f"train mnist history {log1.history}")
        for rec in log1.clock.records:
            if rec["steps"] != steps:
                raise AssertionError(f"train mnist: {rec['steps']} steps in an epoch, not {steps}")
            log(f"[mnist-train] epoch {rec['epoch']}: wall {rec['wall_s']:.3f} s, "
                f"{rec['steps']} steps, train steps {rec.get('step_s', 0):.3f} s, building "
                f"batches {1e3 * rec.get('batch_s', 0) / rec['steps']:.3f} ms/step, checkpoint "
                f"writes {rec.get('checkpoint_s', 0):.3f} s, loop step median "
                f"{statistics.median(rec['step_ms']):.3f} ms (device clock)")
        ips = log1.history[-1]["images_per_sec"]
        pair = os.path.getsize(os.path.join(run, "latest.pt"))
        log(f"[mnist-train] train mnist {MNIST_EPOCHS} epochs of {steps} steps at batch "
            f"{cfg.batch_size}: {train_s:.2f} s with the CLI's set-up; losses "
            f"{json.dumps(hist)}; images_per_sec {ips:.1f} (StepTimer); the pair's "
            f"latest.pt {pair} bytes")

        # the restored VAE encodes as the trained one
        data = {k: torch.from_numpy(getattr(ds, k)).cuda() for k in ("x", "m", "t")}
        b = {k: v[:cfg.batch_size] for k, v in data.items()}
        with torch.no_grad():
            mu, lv = vae.eval().encode(b["x"], b["m"], b["t"])
            restored, _ = port["serving_model"](device="cuda", ckpt=run, workload="mnist")
            mu2, lv2 = restored.encode(b["x"], b["m"], b["t"])
        same = torch.equal(mu, mu2) and torch.equal(lv, lv2)
        log(f"[mnist-train] the restored VAE's encode equals the trained one's: {same}")
        if not same:
            raise AssertionError("the restored MNIST VAE encodes otherwise")

        # the step alone, host clock around each synchronised step
        step = make_mnist_adversarial_step(vae, disc, vae_opt, d_opt, cfg)
        gen = torch.Generator().manual_seed(0)
        times = []
        for sel in ds.batch_indices(cfg.batch_size, np.random.default_rng(1)):
            idx = torch.from_numpy(sel).cuda()
            batch = {k: v[idx] for k, v in data.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times[1:])
        log(f"[mnist-train] adversarial step at batch {cfg.batch_size} (host clock, "
            f"synchronised, median of steps 1-{len(times) - 1}): {step_ms:.3f} ms, "
            f"{1e3 * cfg.batch_size / step_ms:.1f} images/s; first {times[0]:.3f} ms ({smi})")
        (_, _, vopt2, _, log2), _ = mnist_cli(
            main, base + ["train", "mnist", "--epochs", str(MNIST_EPOCHS + 1), "--resume"])
        rows = [r for r in log2.history if r["step"] >= 0]
        counts = [g["count"] for g in vopt2.param_groups]
        log(f"[mnist-train] --resume: epochs {[r['step'] for r in rows]}, restore "
            f"{log2.clock.restore_s:.3f} s, optimizer count {counts}")
        if [r["step"] for r in rows] != [MNIST_EPOCHS] or counts != [(MNIST_EPOCHS + 1) * steps] \
                or not np.isfinite(rows[0]["loss"]):
            raise AssertionError(f"train mnist --resume: {log2.history}, count {counts}")
        (bvae, *_, log3), _ = mnist_cli(
            main, base + ["train", "mnist-bayes", "--epochs", str(MNIST_BAYES_EPOCHS)])
        rows = [r for r in log3.history if r["step"] >= 0]
        log(f"[mnist-train] train mnist-bayes: {json.dumps(rows)}")
        if len(rows) != MNIST_BAYES_EPOCHS or not all(
                np.isfinite([r["loss"], r["d_loss"]]).all() for r in rows):
            raise AssertionError(f"train mnist-bayes: {log3.history}")
        del vae, disc, vae_opt, d_opt, step, bvae

        # (c) card against CPU: one step from the same weights and noise
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sel = next(ds.batch_indices(MNIST_CHECK_BATCH, np.random.default_rng(2)))
        eps = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (4, MNIST_CHECK_BATCH, cfg.z_dim)).astype(np.float32))
        for bayes in (False, True):
            got = {}
            for dev in ("cuda", "cpu"):
                v = seeded_init_(CausalConvVAE(gaussian_mechanism=bayes, decode_real_m=bayes,
                                               device=dev), 7)
                d = seeded_init_(LatentDiscriminator(device=dev), 8)
                opts = [port["ClippedAdam"](mod.parameters(), cfg.lr, None, torch.float32)
                        for mod in (v, d)]
                st = make_mnist_adversarial_step(v, d, *opts, cfg, bayesian=bayes)
                met = st({k: torch.from_numpy(getattr(ds, k)[sel]).to(dev)
                          for k in ("x", "m", "t")}, eps=eps)
                grads = {f"{tag}.{n}": p.grad.detach().cpu() for tag, mod in (("vae", v), ("disc", d))
                         for n, p in mod.named_parameters()}
                got[dev] = ({k: float(x) for k, x in met.items()}, grads)
            (g_met, g_grads), (c_met, c_grads) = got["cuda"], got["cpu"]
            worst = max(abs(g_met[k] - c_met[k]) / abs(c_met[k]) for k in c_met)
            log(f"[mnist-cpu-check] {'C4' if bayes else 'C1'} batch {MNIST_CHECK_BATCH}: card "
                f"{json.dumps(g_met)}; worst term rel {worst:.3e} (tol {MNIST_TERMS_REL:.0e})")
            for k, ref in c_met.items():
                check(f"mnist step {k}", abs(g_met[k] - ref), MNIST_TERMS_REL * abs(ref))
            ratios = {}
            for n, c in c_grads.items():
                g = g_grads[n]
                err, ref = float((g - c).abs().max()), float(c.abs().max())
                if not torch.isfinite(g).all() or ref == 0.0:
                    raise AssertionError(f"mnist card gradient {n} not finite, or the CPU's zero")
                check(f"mnist grad {n}", err, MNIST_GRAD_TOL * ref)
                ratios[n] = err / ref
            n_worst = max(ratios, key=ratios.get)
            log(f"[mnist-cpu-check] {len(ratios)} gradient leaves held at {MNIST_GRAD_TOL:.0e} "
                f"of max|ref|; worst {n_worst} {ratios[n_worst]:.3e}")

        # (d) serving, export and the bundle
        runs = {"mnist": run, "mnist-bayes": os.path.join(tmp, "train_mnist-bayes")}
        for wl, rd in runs.items():
            _, text = mnist_cli(main, ["serve", wl, "--ckpt", rd, "--smoke", "--buckets", "1", "8"])
            smoke = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
            if smoke.get("smoke") != "ok" or smoke.get("reconstruct_shape") != [1, 28, 28, 1]:
                raise AssertionError(f"serve {wl} --ckpt --smoke: {smoke}")
        rng = np.random.default_rng(15)

        def args(name, b):
            x = ds.x[:b]
            m = rng.standard_normal((b, cfg.m_dim)).astype(np.float32)
            t = np.eye(cfg.t_dim, dtype=np.float32)[rng.integers(0, cfg.t_dim, b)]
            z = rng.standard_normal((b, cfg.z_dim)).astype(np.float32)
            return {"decode": (m, z), "predict_m": (t,), "uncertainty": (t,)}.get(
                name, (x, m, t))

        for wl, rd in runs.items():
            model, _ = port["serving_model"](device="cuda", ckpt=rd, workload=wl)
            eps_ = vae_endpoints(model)
            want = ["decode", "do_t", "encode", "predict_m", "reconstruct"] + (
                ["uncertainty"] if wl == "mnist-bayes" else [])
            if sorted(eps_) != want:
                raise AssertionError(f"{wl}: endpoints {sorted(eps_)}, expected {want}")
            engine = BatchingEngine(eps_, buckets=MNIST_SERVE_BUCKETS)
            try:
                lat = {}
                for b in MNIST_SERVE_BUCKETS:
                    a = args("reconstruct", b)
                    out = engine.infer("reconstruct", *a)
                    if np.asarray(out).shape != (b, 28, 28, 1) or not np.isfinite(out).all():
                        raise AssertionError(f"{wl} reconstruct bucket {b}: {np.asarray(out).shape}")
                    ts = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        engine.infer("reconstruct", *a)
                        ts.append((time.perf_counter() - t0) * 1e3)
                    lat[b] = statistics.median(ts)
                for name in want:
                    out = engine.infer(name, *args(name, 3))
                    outs = out if isinstance(out, tuple) else (out,)
                    if not all(np.isfinite(np.asarray(o)).all() for o in outs):
                        raise AssertionError(f"{wl} {name}: non-finite")
                stats = dict(engine.stats)
            finally:
                engine.close()
            log(f"[mnist-serve] {wl}: BatchingEngine over {want}; reconstruct latency (host "
                f"clock, median of 5) " + ", ".join(f"bucket {b} {v:.3f} ms" for b, v in lat.items())
                + f" ({smi}); engine stats {json.dumps(stats)}")
            del model, eps_

        t0 = time.perf_counter()
        summary, _ = mnist_cli(main, ["--out", tmp, "export", "mnist", "--ckpt", run, "--buckets",
                                      *map(str, MNIST_EXPORT_BUCKETS)])
        export_s = time.perf_counter() - t0
        out_dir = summary["export_dir"]
        log(f"[mnist-export] export mnist --ckpt --buckets 1 8: {export_s:.2f} s in all; params "
            f"{summary['params_bytes']} bytes; programs " + ", ".join(
                f"{n} {i['bytes']} bytes ({', '.join(f'b{b} {s:.2f} s' for b, s in i['export_s'].items())})"
                for n, i in summary["endpoints"].items()))
        bundle = load_exported(out_dir)
        model, _ = port["serving_model"](device="cuda", ckpt=run, workload="mnist")
        eager = vae_endpoints(model)
        torch.backends.cudnn.deterministic = True
        try:
            for name in sorted(eager):
                for b in MNIST_EXPORT_BUCKETS:
                    a = tuple(torch.from_numpy(x).cuda() for x in args(name, b))
                    with torch.inference_mode():
                        ref = eager[name](*a)
                        got = bundle.call(name, *a)
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    got = got if isinstance(got, tuple) else (got,)
                    err = max(max_err(g, r) for g, r in zip(got, ref))
                    scale = max(float(r.abs().max()) for r in ref)
                    equal = all(torch.equal(g, r) for g, r in zip(got, ref))
                    log(f"[mnist-export] {name} bucket {b}: max|d| {err:.3e} of max|ref| "
                        f"{scale:.3e} (bit-equal {equal})")
                    if [tuple(g.shape) for g in got] != [tuple(r.shape) for r in ref] \
                            or err > EXPORT_TOL * scale:
                        raise AssertionError(f"mnist bundle {name} bucket {b}: max|d| {err:.3e}")
        finally:
            torch.backends.cudnn.deterministic = False
        del bundle, model, eager
        launches = {name: c.read() for name, c in counters.items()}  # the MNIST path ends
        log(f"[mnist] launches of every ported kernel over (a)-(d): {json.dumps(launches)}")
        if any(launches.values()):
            raise AssertionError(f"the MNIST path launched a ported kernel: {launches}")

        # both bundles from one fresh process, without the model code
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", SERVE_BUNDLE_PROBE, "vessel", vessel_bundle,
                               "mnist", out_dir],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(lines) < 3:
            raise AssertionError(f"serve --export-dir in a fresh process: exit "
                                 f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        (v_smoke, m_smoke), probe = map(json.loads, lines[-3:-1]), json.loads(lines[-1])
        if (v_smoke.get("smoke") != "ok" or v_smoke.get("reconstruct_shape") != [1, *VESSEL_HW, 1]
                or m_smoke.get("smoke") != "ok"
                or m_smoke.get("reconstruct_shape") != [1, 28, 28, 1]
                or probe["models_imported"]):
            raise AssertionError(f"serve --export-dir: {v_smoke}, {m_smoke}, {probe}")
        log(f"[export-serve] one fresh process, {time.perf_counter() - t0:.1f} s: serve vessel "
            f"--export-dir {json.dumps(v_smoke)}; serve mnist --export-dir "
            f"{json.dumps(m_smoke)}; causalvae_tpu_torch.models imported: none")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[mnist] phase 15 {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


class Counter:
    """Reset and read one kernel's module-level launch counter."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr

    def reset(self):
        setattr(self.module, self.attr, 0)

    def read(self) -> int:
        return getattr(self.module, self.attr)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from causalvae_tpu_torch.cli.main import main as cli_main
        from causalvae_tpu_torch.cli.main import serving_model
        from causalvae_tpu_torch.data import vessel
        from causalvae_tpu_torch.config import VesselConfig
        from causalvae_tpu_torch.models.vit import vessel_model
        from causalvae_tpu_torch.ops.kernels import (_build, attention, batchnorm, elbo,
                                                     stage)
        from causalvae_tpu_torch.ops.subpixel import depth_to_space_n, space_to_depth_n
        from causalvae_tpu_torch.serve import http as H
        from causalvae_tpu_torch.serve.endpoints import vae_endpoints
        from causalvae_tpu_torch.serve.engine import BatchingEngine
        from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
        from causalvae_tpu_torch.train.state import ClippedAdam
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e}); run from the "
              "repository root", file=sys.stderr)
        return 3
    port = dict(vessel_model=vessel_model, VesselConfig=VesselConfig,
                make_vae_step=make_vae_step, vessel_loss_fn=vessel_loss_fn,
                ClippedAdam=ClippedAdam, space_to_depth_n=space_to_depth_n,
                depth_to_space_n=depth_to_space_n, cli_main=cli_main, vessel=vessel,
                serving_model=serving_model)
    counters = {"attention_fwd": Counter(attention, "LAUNCHES"),
                "attention_bwd": Counter(attention, "BWD_LAUNCHES"),
                "bn_stats": Counter(batchnorm, "STATS_LAUNCHES"),
                "bn_bwd": Counter(batchnorm, "BWD_LAUNCHES"),
                "elbo_terms": Counter(elbo, "LAUNCHES"),
                "elbo_terms_bwd": Counter(elbo, "BWD_LAUNCHES"),
                "stage_fwd": Counter(stage, "FWD_LAUNCHES"),
                "stage_fwd_fine": Counter(stage, "FINE_FWD_LAUNCHES"),
                "stage_bwd": Counter(stage, "BWD_LAUNCHES"),
                "stage_dgrad_fine": Counter(stage, "FINE_DGRAD_LAUNCHES"),
                "stage_wgrad_fine": Counter(stage, "FINE_WGRAD_LAUNCHES"),
                "stage_bwd_wgrad": Counter(stage, "WGRAD_LAUNCHES")}
    for name, twin in BF16_TWINS.items():
        counters[twin] = Counter(counters[name].module, counters[name].attr + "_BF16")
    t_start = time.perf_counter()
    export_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")  # phases 14 and 15
    try:
        smi = smi_line()
        log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        built = _build.build()
        log(f"[build] {json.dumps(built)}; all kernels ready in "
            f"{time.perf_counter() - t0:.1f} s")
        for name in _build.sources():
            for line in _build.log_path(name).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
        t0 = time.perf_counter()
        recs = phase_kernels({"attention": attention, "batchnorm": batchnorm,
                              "elbo": elbo, "stage": stage})
        log(f"[time] kernels phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        depth = VesselConfig().vit_depth
        serve_launches, serve_latency = phase_serve(attention, serving_model, vae_endpoints,
                                                    BatchingEngine, H, depth)
        phase_cpu_check(serving_model)
        serve_bf16_launches = phase_serve_bf16(port, attention, vae_endpoints,
                                               BatchingEngine, depth, serve_latency)
        log(f"[time] serving phases {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_launches, train_stats = phase_train(port, counters)
        train_bf16_launches, train_bf16_stats = phase_train(port, counters, tag="train-bf16",
                                                            dtype="bfloat16")
        phase_bf16_check(port, train_stats["losses"], train_bf16_stats["losses"])
        remat_launches, remat_stats = phase_remat(port, counters, train_bf16_stats)
        log(f"[time] training phases (f32, bf16, bf16 against f32, remat) "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_train_cpu_check(port)
        log(f"[time] training card-vs-CPU phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        packed_launches, packed_stats = phase_train(
            port, counters, PACKED, PER_STEP_PACKED, "train-packed-fused")
        packed_bf16_launches, packed_bf16_stats = phase_train(
            port, counters, PACKED, PER_STEP_PACKED, "train-packed-fused-bf16",
            dtype="bfloat16")
        _, cudnn_stats = phase_train(
            port, None, dict(PACKED, fused_stages=False), tag="train-packed-cudnn",
            steps=4, profile_step=False)
        log(f"[time] packed training phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_packed_check(port)
        log(f"[time] packed-vs-spatial phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        vessel_launches = phase_train_vessel(port, counters, train_stats["step_ms"])
        log(f"[time] train vessel phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        kfold_launches, kfold_stats = phase_kfold(port, counters, train_stats)
        log(f"[time] k-fold phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        kfold_cli_launches = phase_kfold_cli(port, counters)
        log(f"[time] k-fold CLI phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        file_launches = phase_file_corpus(port, counters, train_stats["step_ms"])
        log(f"[time] file-backed corpus phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        export_launches = phase_export(port, attention, depth, smi, export_dir)
        log(f"[time] export phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mnist_launches = phase_mnist(port, counters, smi,
                                     os.path.join(export_dir, "export_vessel"))
        log(f"[time] MNIST phase {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    steps = {"spatial": train_stats, "spatial bf16": train_bf16_stats,
             "spatial bf16 remat": remat_stats, "packed-fused": packed_stats,
             "packed-fused bf16": packed_bf16_stats, "packed-cuDNN": cudnn_stats,
             f"k-fold lockstep ({KFOLD_K} folds)": kfold_stats}
    log(f"[time] total {time.perf_counter() - t_start:.1f} s; training step (ms, peak "
        f"bytes, idle share of the profiled step): " + "; ".join(
            f"{k} {v['step_ms']:.2f}, {v['peak_bytes']}, {v.get('idle_share', 'not profiled')}"
            for k, v in steps.items()))
    runs = {"serve": {"attention_fwd": serve_launches}, "serve_bf16": serve_bf16_launches,
            "train": train_launches, "train_bf16": train_bf16_launches,
            "remat": remat_launches, "train_packed": packed_launches,
            "train_packed_bf16": packed_bf16_launches, "train_vessel": vessel_launches,
            "kfold": kfold_launches, "kfold_cli": kfold_cli_launches,
            "file_corpus": file_launches, "export": export_launches,
            "mnist": mnist_launches}
    sources = {"attention_fwd": ("attention_fwd.cu", "attention.py:134"),
               "attention_bwd": ("attention_bwd.cu", "attention.py:181"),
               "bn_stats": ("bn_reduce.cu", "batchnorm.py:78"),
               "bn_bwd": ("bn_reduce.cu", "batchnorm.py:97"),
               "elbo_terms": ("elbo_terms.cu", "elbo.py:48"),
               "elbo_terms_bwd": ("elbo_terms.cu", "elbo.py:127"),
               "stage_fwd": ("stage_fwd.cu", "stage.py:227"),
               "stage_fwd_fine": ("stage_fwd_fine.cu", "stage.py:227"),
               "stage_bwd": ("stage_bwd.cu", "stage.py:347"),
               "stage_dgrad_fine": ("stage_dgrad_fine.cu", "stage.py:347"),
               "stage_wgrad_fine": ("stage_wgrad_fine.cu", "stage.py:347"),
               "stage_bwd_wgrad": ("stage_bwd.cu", "stage.py:347")}
    kernels = []
    for name, (src, tpu) in sources.items():
        paths = {path: r.get(name, 0) for path, r in runs.items()}
        bf16 = ({"launches_bf16_by_path": {path: r.get(BF16_TWINS[name], 0)
                                           for path, r in runs.items()}}
                if name in BF16_TWINS else {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"causalvae_tpu_torch/csrc/{src}",
            "replaces": f"causalvae_tpu/ops/kernels/{tpu}",
            "launches": sum(paths.values()), "launches_by_path": paths, **bf16,
            **recs[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
