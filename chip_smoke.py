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
   their 64-row tiles (forward D 8-64, backward D 8-32), and around their
   64- and 32-row tiles at head dims 20, 24, 48 (padded), 64, 128 and 256
   (the wide plans) and at BH 65537, bit-equal from launch to launch,
   timed in f32 and bf16 beside SDPA and both of their bounds (the forward
   at rates 0 and 0.1, also at serving's bucket 1; both at the flagship's
   4, 2 and 1 heads); from a padded head dim of 128 on the bf16 forward is
   the large-D kernel (``csrc/attention_fwd_large.cu``), whose f32 path is
   held and timed there too, beside the wide and deep plans f32 keeps;
   the BN kernels'
   channels-last entries; the stage forward and backward at the 14 shapes
   of the packed-fused step, lifted (and the backward's wgrad-only entry,
   bit for bit its dW and db), and the fine-grid stage forward, dgrad and
   wgrad at the same 14 shapes (base kernels; time, real-work bound and the
   fine-grid cuDNN call per shape, the 14-shape sums beside the lifted
   ones'; the dgrad's dx, dmul and dadd and the wgrad's dW and db each,
   equal bits run to run; the wgrad beside the lifted wgrad-only entry at
   each shape); ``SubpixelConvTranspose2x(use_bias=False)`` at dec_ct[4]'s
   shape through the stage op against its plain version, one launch; times
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
   the vessel model in lockstep, batch 8, 1 epoch, on the synthetic corpus
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
   (``causalvae_tpu_torch/native``) built with g++; 128 TIFF files of
   960x1600 and their CSV written in a temporary directory (most Deflate +
   predictor 2, two each of LZW 8- and 16-bit, PackBits, uncompressed 8-bit
   and float32); ``load_raw`` of each format equal to the array written with
   tifffile and PIL blocked; ``decode_image`` against the card's resize and
   min-max, and ``iterate_batches(use_native=True)`` against the in-memory
   path on the card (share of mask pixels that differ); the loader's
   images/s at 1, 4 and all threads, no sample all zeros; one epoch of
   ``train vessel --csv --data`` at 768x1280 (~54 steps), counts held per
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
   against eager under ``cudnn.deterministic``; (e) the models in bf16
   (``phase_mnist_bf16``): C1 and C4 graphed (S = 8) held bit for bit to
   their eager steps, the f32 and bf16 steps timed in turns eager and
   graphed, busy, idle and peak; one bf16 step of C1, C4 and C5 and the
   C3 and C6 forwards card against CPU at stated bounds, the card's f32
   run as the control that misses; every counter 0; then one fresh process
   serves phase 14's vessel bundle and this one with ``serve
   --export-dir --smoke`` and must import nothing of
   ``causalvae_tpu_torch.models``;
16. the MNIST analysis study (``phase_study``), every kernel counter zeroed
   before and read after (each must read 0): the device morphology
   (``build_morph_mnist(use_device_extractor=True)``, 12 and 16 features)
   over ``synthetic_mnist(STUDY_N, seed=42)`` in 512-image chunks, seconds,
   images/s and peak memory; 2048 of those images against the port's own
   CPU run (integer-derived features equal, the others within 1e-5, the Hu
   entries by ``tests/test_morphology.py``'s rule) and against the host
   oracle (the count of entries outside its bounds equal to the CPU run's),
   the host extractor timed on them; then through the CLI in-process
   ``analyze all --epochs 1`` (its JSON keys) and each ``counterfactual``
   mode (each PNG's size), seconds of each; ``train cvae --epochs 1``, the
   CVAE step on the host clock and images/s, and one step card against CPU
   from the same seeded weights (loss terms rel 1e-4, gradients 1e-3 of
   max|ref|);
17. the latent translator and the causal cascade (``phase_translator_cascade``),
   every kernel counter zeroed before each part and read after it, in a
   temporary directory: 32 multi-page TIFF stacks of 6 pages of 968x1280
   written (LZW, PackBits, uncompressed, float32 and one single-page file
   among Deflate ones) beside their CSV; the native page walk
   (``decode_pages``, ``decode_mip``) bit for bit with tifffile and PIL
   blocked, its seconds a stack; the translator's ``iterate_images`` at
   384x640 card against CPU, ``train_vit_vae`` (the translator ViTVAE at
   its full widths, batch 8, 2 epochs) with 6 + 6 attention and 18 + 18 BN
   launches a step, its step time and peak memory, one step card against
   CPU under the KL term, ``extract_vit_latents`` (6 attention forwards a
   batch) into the ridge translation, and the CLI's ``train vit`` and
   ``translate`` (``trackA_ranking.csv``); the cascade's batches on the card
   (standardised; the eval route against CPU), ``train_cascade`` (C10 at
   512x960, batch 4, 2 epochs, no kernel launched), one C10 step card
   against CPU, and the CLI's ``train cascade`` and ``cascade --csv --data``
   (``sensitivity_ranking.csv``);
18. C7 and the reference-checkpoint converters (``phase_vessel_cnn``), every
   kernel counter zeroed before each part and read after it: a seeded
   reference-layout C7 (``RefVesselVAE``, VesselConfig's widths) saved as
   ``{"model_state_dict": ...}`` and loaded into the port's C7 on the card by
   ``load_torch_checkpoint`` + ``port_vessel_cnn_checkpoint`` (nothing
   skipped; seconds, bytes), its eval encode, predict_m and decode against
   the mirror on the card; the six endpoints behind ``BatchingEngine`` at
   buckets 1 and 8 (0 launches); training at batch 8, 768x1280: spatial f32
   6 steps, packed f32 and spatial bf16 3 steps each, with 15 + 15 BN and 1
   + 1 ELBO launches a step, step times and peaks, and one step card against
   CPU at batch 4; a reference-layout C9 file at the 24x40 grid loaded into
   ``vessel_model()`` (only the not-instantiated latent heads skipped; 6
   attention launches a reconstruct) and a ViTVAE-layout file at 24x40 into
   the translator's ViTVAE at 384x640 (the positional embedding resized;
   one ``extract_vit_latents`` batch);
19. the analysis modules and data parallelism (``phase_analysis_parallel``),
   every kernel counter zeroed before each part and read after it: the
   flagship C9's latents of 64 images through ``encode_corpus`` (6
   attention launches a chunk of 32); C1's latents of
   ``synthetic_mnist(2048, 42)`` into PCA, exact t-SNE, the linear probe,
   the classifier's real-vs-fake features and the outliers on the card,
   against the port's CPU run; ``m_influence_check`` on C9, the feature
   ensemble over ``predictions_by_treatment``, the baseline report, the
   reliability gate and ``fix_csv_names``; the eight charts read back;
   ``profile_trace`` around a reconstruct; two spawned ranks on the one card
   (gloo) taking the flagship's step at 2 x 4 through
   ``make_vae_step(mesh=...)`` against the one-process batch-8 step (6, 6,
   18, 18, 1, 1 launches a step a rank; BatchNorm statistics bit-equal on
   both ranks), the gradient all-reduce's ms and each rank's peak, and in
   the same ranks C10 at 512x960 taking ``train_cascade``'s step at 2 x 2
   (its mechanism's BatchNorm over the whole batch; 0 launches; the running
   statistics bit-equal on both ranks) against the one-process batch-4
   step; one NCCL rank through ``make_shard_map_step``;
20. the scanned trainer (``phase_scan``, ``train/scan_loop.py``), S steps a
   CUDA-graph replay, under cuDNN's deterministic algorithms with TF32 off:
   ``ClippedAdam``'s bias corrections on the card against the CPU; C1 with
   its discriminator at batch 128, S = 8 over 19 steps (0 launches of every
   kernel); the flagship at batch 8, S = 4 over 5 steps, spatial f32 and
   bf16, one group packed-fused f32, bf16 with ``remat_blocks`` (12
   attention forwards a step), and S = 2 over 4 steps at 4, 2 and 1 heads
   in f32 and bf16 (head dims 64-256: the wide attention plans), each f32
   head count then served at bucket 8; each graphed from the same start
   as the same steps run eagerly and held to them bit for bit (every
   step's metrics, the parameters, the optimizer moments), every kernel
   counter zeroed before the graphed run and read after it (the per-step
   launches times the steps plus the one warm-up step), one replay a group,
   capture seconds, peak; per-step host-clock times graphed and eager in
   turns, and a profiled group of each (C1 and spatial f32: device busy,
   idle share); then the
   CLI's ``train vessel --scan-steps 4`` (one epoch at 768x1280 on the
   synthetic corpus, resumed eagerly to a second from its checkpoint) and
   ``train mnist --scan-steps 8`` (three epochs of one group).

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
# the head dims of the wide plans and the wrapper's padding: 20,
# 24 and 48 padded to 32 and 64, 64 the backward's wide plan, 128 and 256
# both wide plans; N around the 64-row and the wide plans' 32-row tiles; one
# BH past gridDim.y's 65535 at a small N
NEW_HEAD_DIMS = (20, 24, 48, 64, 128, 256)
NEW_DIM_N = (1, 33, 63, 129)  # one row past a 32-row tile, 31 and 63 in the last, 1
BIG_BH_SHAPE = (65537, 9, 64)
FWD_SHAPES = [(64, 961, 32), (256, 961, 32), (6, 17, 32), (3, 241, 16)] + [
    (3, n, d) for n in (1, 63, 65, 129) for d in (8, 16, 32, 64)] + [  # around the 64-key tiles
    (3, n, d) for n in NEW_DIM_N for d in NEW_HEAD_DIMS if d != 64] + [BIG_BH_SHAPE]
FWD_TIMED = [(8, 961, 32), TIMED_SHAPE, (256, 961, 32)]  # serving bucket 1, batch 8, 32
BWD_SHAPES = [(64, 961, 32), (6, 17, 32), (3, 241, 16)] + [
    (3, n, d) for n in (1, 63, 65, 129) for d in (8, 16, 32)] + [  # around the 64-row tiles
    (3, n, d) for n in NEW_DIM_N for d in NEW_HEAD_DIMS] + [BIG_BH_SHAPE]
# the flagship's attention at batch 8 and 4, 2, 1 heads of embed 256 (the
# same work as TIMED_SHAPE), and at embed 384 and 8 heads (D = 48, run at 64:
# the wrapper's pad and slices are inside the timed call): timed beside the
# bounds (of the true D), the plain version, SDPA
HEAD_TIMED = [(32, 961, 64), (16, 961, 128), (8, 961, 256), (64, 961, 48)]
# the deep plan (D > 256, padded to a multiple of 64 by the wrapper; 32 rows a
# block up to 512, 16 above, to the limit 1344): held at N around its 16- and
# 32-row blocks and 32-row tiles, and at the flagship's batch 8 with one head
# of embed 384, 512 and 1024, timed (DEEP_TIMED, into the records'
# "deep_head_dims" and the kernels record's attention_*_deep entries)
DEEP_HEAD_DIMS = (257, 320, 512, 576, 1024, 1344)
DEEP_DIM_N = (1, 33, 65)
DEEP_TIMED = [(8, 961, 384), (8, 961, 512), (8, 961, 1024)]
FWD_SHAPES += [(3, n, d) for n in DEEP_DIM_N for d in DEEP_HEAD_DIMS]
BWD_SHAPES += [(3, n, d) for n in DEEP_DIM_N for d in DEEP_HEAD_DIMS]
# the large-D forward (csrc/attention_fwd_large.cu): from a padded D of 128 on,
# bf16 runs it through the wrapper and its f32 path (3xTF32, slower there than
# the wide and deep plans, which f32 keeps) runs through attention_fwd_large;
# both held at every such shape of FWD_SHAPES, with two head dims the wrapper
# pads to 128 and 256, and timed at HEAD_TIMED and DEEP_TIMED
FWD_SHAPES += [(3, 33, 100), (3, 33, 200)]
TRAIN_RATE = 0.1  # the vessel model's attention dropout
TRAIN_BATCH = 8
TRAIN_STEPS = 6
# every train-mode BatchNorm input of the vessel model at batch 8, (N, C, S):
# the five stem stages, the five decoder stages, the three ResBlocks (two BNs
# each, at their stage's shape) and the two adapters; the last decoder stage
# (8, 16, 768*1280) is the largest and the one timed; then those of C7's
# spatial step at batch 8 (phase 18) that the vessel model lacks: its
# 512-channel stages at 24x40, 12x20 and 6x10 and its two BatchNorm1d (1024)
BN_SHAPES = [(8, 32, 384 * 640), (8, 64, 192 * 320), (8, 128, 96 * 160),
             (8, 256, 48 * 80), (8, 256, 24 * 40), (8, 128, 48 * 80),
             (8, 64, 96 * 160), (8, 32, 192 * 320), (8, 16, 384 * 640),
             (8, 16, 768 * 1280), (8, 512, 1), (8, 256, 1),
             (8, 512, 24 * 40), (8, 512, 12 * 20), (8, 512, 6 * 10), (8, 1024, 1)]
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
# samples (one padded batch of 20 a fold), 1 epoch (at 2 the phase took
# 65.9-74.2 s on an H100; one leaves phase 17 its time, and fold 0 is still
# held to a lone run over its first two steps), checkpoints every epoch (5
# folds x latest + best, 1.23 GB each, beside one temporary copy)
KFOLD_N, KFOLD_K, KFOLD_BATCH, KFOLD_EPOCHS = 96, 5, 8, 1
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
# masks and features of ``synthetic_corpus(n=FILE_N)`` (19 groups) as 16-bit
# images with intensities, a ramp and seeded noise, at 960x1600. That size is
# this script's choice, not the real data's: it makes the resize to 768x1280
# do real work. Files 0-9 are two each of LZW 8-bit, LZW 16-bit + predictor
# 2, PackBits 8-bit, uncompressed 8-bit and float32; the rest Deflate (zlib
# level 1) + predictor 2, in 64-row strips. At n = 512, 474 train samples x 4
# augs made 237 steps of 8; the phase counts its steps and val batches from
# the corpus' splits.
# 1024 files took 28.5 s to write and a 493-step epoch 57-81 s on an H100
# machine; 512 left phase 16 its time (87-96 s for the phase), 256 phase 18
# (a 109-step epoch in a 64-77 s phase); 128 left the bf16 MNIST cases,
# C10's mesh step and the use_bias check their time (a 45-step epoch in a
# 44-48 s phase); 80 leave the deep attention plan's cases theirs (64 would
# hold 18 of the 19 groups, and `serve vessel --ckpt` builds 19, as JAX's)
FILE_N, FILE_HW = 80, (960, 1600)
FILE_FORMATS = ("lzw8", "lzw8", "lzw16", "lzw16", "packbits", "packbits", "u8", "u8",
                "f32", "f32")
FILE_DISK = 12 * 2**30  # ~1.25 GB of files; two 1.23 GB checkpoints beside their copies
FILE_CHECK_N = 32  # (d): the first 32 files, every format among them
FILE_RESIZE_TOL = 1e-5  # (d): decode_image against the card's resize + min-max, max|d|
# (d): share of binarized pixels that may differ between the native route and
# make_preprocess on the card (each must lie within 1e-5 of its image's mean)
FILE_FLIP_MAX = 1e-4
LOADER_BATCHES = FILE_N // 16  # (e): batches of 8 at 4 and at cpu_count threads
LOADER_BATCHES_ONE_THREAD = 16  # (e): at 1 thread (~21 images/s: 6 s, not 24)
# (g): vessel-report's fold batch; the CLI's 4 made 1025 small-model fold
# steps at 1024 files, 27 s more than at 16 on an H100 80GB HBM3 (95.0
# against 68.3 s).
# What (g) is for is the load_raw preload of the files; phase 12
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
    on the bf16 values, 2e-2), at the training shapes, small ones, N around
    the 64-key tiles (1, 63, 65, 129) for D 8, 16, 32, 64, N around the
    64- and 32-key tiles for the padded and wide head dims (NEW_HEAD_DIMS),
    and BH 65537. Every shape, rate and dtype: two launches give equal bits.
    Timed at serving's bucket 1 (8, 961, 32), training's batch 8 (64, 961,
    32), (256, 961, 32) and the flagship's attention at 4, 2 and 1 heads
    and a padded D = 48 (HEAD_TIMED), rates 0 and 0.1, f32 and bf16, beside SDPA (at rate 0.1
    with its own random bits: a time yardstick only), both bounds and the
    per-score work by count; the plain version at (64, 961, 32) and
    HEAD_TIMED; the deep plan at DEEP_HEAD_DIMS and N in DEEP_DIM_N, and
    timed at DEEP_TIMED the same way (into "deep_head_dims"). From a padded
    D of 128 on, bf16 runs the large-D kernel (csrc/attention_fwd_large.cu)
    through the wrapper, and its f32 path runs through attention_fwd_large
    beside the plan f32 keeps: held at the same tolerance, two launches
    bit-equal, timed at HEAD_TIMED and DEEP_TIMED ("ms_large")."""
    record = {"head_dims": {}, "deep_head_dims": {}}
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
            again = (attention.attention_fwd(q, k, v, rate, 7)
                     + attention.attention_fwd(qb, kb, vb, rate, 7))
            large = attention.kernel_head_dim(d) >= attention.LARGE_MIN_D
            if large:  # the large-D kernel's f32 path: o, lse and two launches
                ol, lsel = attention.attention_fwd_large(q, k, v, rate, 7)
                again += attention.attention_fwd_large(q, k, v, rate, 7)
            torch.cuda.synchronize()
            outs = (o, lse, ob, lseb) + ((ol, lsel) if large else ())
            same = all(torch.equal(a, b) for a, b in zip(outs, again))
            log(f"[kernels] attention_fwd {(bh, n, d)} rate {rate}: f32 max|d| {err:.3e} "
                f"(tol {tol:.3e}), lse {err_lse:.3e}; bf16 max|d| {err_bf16:.3e} (tol 2e-2)"
                f"{' (attention_fwd_large)' if large else ''}"
                + (f"; attention_fwd_large f32 max|d| {max_err(ol, ro):.3e}, lse "
                   f"{max_err(lsel, rlse):.3e}" if large else "")
                + f"; two launches bit-equal in f32 and bf16 (o and lse): {same}")
            if large:
                check(f"attention_fwd_large {(bh, n, d)} rate {rate} f32", max_err(ol, ro), tol)
                check(f"attention_fwd_large {(bh, n, d)} rate {rate} lse", max_err(lsel, rlse),
                      2e-5 * float(rlse.abs().max()) + 1e-6)
            check(f"attention_fwd {(bh, n, d)} rate {rate} f32", err, tol)
            check(f"attention_fwd {(bh, n, d)} rate {rate} lse", err_lse,
                  2e-5 * float(rlse.abs().max()) + 1e-6)
            check(f"attention_fwd {(bh, n, d)} rate {rate} bf16", err_bf16, 2e-2)
            if not same:
                raise AssertionError(f"attention_fwd {(bh, n, d)} rate {rate}: two launches "
                                     f"differ")
            if (bh, n, d) == TIMED_SHAPE and rate == 0.0:
                record.update(max_abs_err=err, max_abs_err_bf16=err_bf16)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for bh, n, d in FWD_TIMED + HEAD_TIMED + DEEP_TIMED:
            q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev, dtype) for _ in range(3))
            q4, k4, v4 = (t.view(bh // 8, 8, n, d) for t in (q, k, v))
            bnd, by, cuda_core = attention_bound_ms(bh, n, d, dtype)
            exps, mufu_ms, hash_ms = score_work_ms(bh, n)
            for rate in (0.0, TRAIN_RATE):
                held = None
                if (bh, n, d) in HEAD_TIMED + DEEP_TIMED:  # not among FWD_SHAPES: held here
                    o, _ = attention.attention_fwd(q, k, v, rate, 7)
                    ro, _ = attention.attention_reference(q.float(), k.float(), v.float(),
                                                          rate, 7)
                    held = max_err(o, ro)
                    check(f"attention_fwd {tag} {(bh, n, d)} rate {rate}", held,
                          2e-5 * float(ro.abs().max()) + 1e-6 if dtype == torch.float32
                          else 2e-2)
                ms = cuda_ms(lambda: attention.attention_fwd(q, k, v, rate, 7))
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                     dropout_p=rate))
                large = (held is not None and dtype == torch.float32
                         and attention.kernel_head_dim(d) >= attention.LARGE_MIN_D)
                if large:  # the large-D kernel's f32 path beside the plan f32 keeps
                    ol, _ = attention.attention_fwd_large(q, k, v, rate, 7)
                    held_large = max_err(ol, ro)
                    check(f"attention_fwd_large f32 {(bh, n, d)} rate {rate}", held_large,
                          2e-5 * float(ro.abs().max()) + 1e-6)
                    ms_large = cuda_ms(lambda: attention.attention_fwd_large(q, k, v, rate, 7))
                    log(f"[kernels] attention_fwd_large f32 {(bh, n, d)} rate {rate}: "
                        f"{ms_large:.4f} ms (max|d| {held_large:.3e}), the plan f32 keeps "
                        f"{ms:.4f} ms")
                plain = None
                if (bh, n, d) == TIMED_SHAPE or (bh, n, d) in HEAD_TIMED + DEEP_TIMED:
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
                drop = "" if rate == 0.0 else "_dropout"
                if (bh, n, d) in HEAD_TIMED + DEEP_TIMED:
                    rec = record["head_dims" if (bh, n, d) in HEAD_TIMED else
                                 "deep_head_dims"].setdefault(f"{bh}x{n}x{d}", {})
                    bf = "" if dtype == torch.float32 else "_bf16"
                    rec.update({f"ms{bf}{drop}": ms, f"plain_ms{bf}{drop}": plain,
                                f"library_ms{bf}{drop}": lib, f"bound_ms{bf}": bnd,
                                f"bound_by{bf}": by, f"max_abs_err{bf}{drop}": held})
                    if large:
                        rec.update({f"ms_large{drop}": ms_large,
                                    f"max_abs_err_large{drop}": held_large})
                if (bh, n, d) != TIMED_SHAPE:
                    continue
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


# At N = 1 the backward's dq and dk are 0 in exact arithmetic (see
# zero_grad_tols): both sides give rounding noise of about 1e-7 of the size
# of what rounds, at every D, which an absolute floor of 1e-6 does not bound
# (D = 32 read 5.2e-7 on one draw and 1.4e-6 on another). In f32 they are
# held to ZERO_GRAD_REL of that size: 1e-5, about 50x the largest noise
# read (2.1e-7 of it, dq at D = 128) and about 50x below what one TF32 pass
# (2^-11 of it) would give. bf16 keeps its rule (its 1e-3 floor bounds it).
ZERO_GRAD_REL = 1e-5


def zero_grad_tols(q, k, v, do, rel: float) -> tuple:
    """At N = 1, p = 1 and dp = delta (= do . v, dropped or scaled alike),
    so dq and dk are 0 in exact arithmetic: the kernel's and the plain
    version's values are both the f32 rounding of dp - delta, D terms each,
    and max|ref| is that noise. There they are held to ``rel`` of the size of
    what rounds, scale * max_i sum_d |do_id v_id| * max|k| (dq) or max|q| (dk),
    plus 1e-6 (the floor of the f32 rule)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv_terms = float((do.float() * v.float()).abs().sum(-1).max()) * scale
    return (rel * dv_terms * float(k.float().abs().max()) + 1e-6,
            rel * dv_terms * float(q.float().abs().max()) + 1e-6)


def check_attention_bwd(attention, gen, dev):
    """The backward kernels against attention_bwd_reference at rate 0 and the
    training rate, at the training shape, small ones, N around the 64-row
    tiles (1, 63, 65, 129) for D 8, 16, 32, N around the 64- and 32-row
    tiles for the padded and wide head dims (NEW_HEAD_DIMS) and BH 65537: f32
    (max|d| <= 1e-4 max|ref| + 1e-6: 3xTF32 products, sums in another order)
    and bf16 (against f32 on the bf16 values, 1e-2 max|ref| + 1e-3: the
    outputs' bf16 rounding); in f32 at N = 1, dq and dk by
    ``zero_grad_tols`` where that bound is the larger (both are rounding
    noise of a 0 there). Every
    shape, dtype and rate: two launches give equal bits. Timed at (64, 961,
    32) and HEAD_TIMED, rate 0.1, beside the plain version, SDPA's autograd
    backward and both bounds (3xTF32 on the tensor cores, f32 on the CUDA
    cores); the deep plan at DEEP_HEAD_DIMS and N in DEEP_DIM_N, timed at
    DEEP_TIMED (into "deep_head_dims")."""
    record = {"head_dims": {}, "deep_head_dims": {}}
    for bh, n, d in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(bh, n, d, generator=gen).to(dev, dtype)
                           for _ in range(4))
            for rate in (0.0, TRAIN_RATE):
                o, lse = attention.attention_fwd(q, k, v, rate, 5)
                grads = attention.attention_bwd(q, k, v, o, lse, do, rate, 5)
                again = attention.attention_bwd(q, k, v, o, lse, do, rate, 5)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                want = attention.attention_bwd_reference(
                    *(t.float() for t in (q, k, v, o)), lse, do.float(), rate, 5)
                rel, floor = (1e-4, 1e-6) if dtype == torch.float32 else (1e-2, 1e-3)
                errs = [max_err(g, w) for g, w in zip(grads, want)]
                tols = [rel * float(w.abs().max()) + floor for w in want]
                if n == 1 and dtype == torch.float32:
                    zq, zk = zero_grad_tols(q, k, v, do, ZERO_GRAD_REL)
                    tols[0], tols[1] = max(tols[0], zq), max(tols[1], zk)
                log(f"[kernels] attention_bwd {str(dtype)[6:]} {(bh, n, d)} rate {rate}: "
                    f"max|d| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                    f"(tol {tols[0]:.3e} {tols[1]:.3e} {tols[2]:.3e}); two launches "
                    f"bit-equal: {same}")
                for name, e, t in zip(("dq", "dk", "dv"), errs, tols):
                    check(f"attention_bwd {name} {(bh, n, d)} {dtype} rate {rate}", e, t)
                if not same:
                    raise AssertionError(f"attention_bwd {(bh, n, d)} {dtype} rate {rate}: "
                                         f"two launches differ")
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in [TIMED_SHAPE] + HEAD_TIMED + DEEP_TIMED:
            rate = TRAIN_RATE
            q, k, v, do = (torch.randn(bh, n, d, generator=gen).to(dev, dtype)
                           for _ in range(4))
            o, lse = attention.attention_fwd(q, k, v, rate, 5)
            grads = attention.attention_bwd(q, k, v, o, lse, do, rate, 5)
            want = attention.attention_bwd_reference(
                *(t.float() for t in (q, k, v, o)), lse, do.float(), rate, 5)
            errs = [max_err(g, w) for g, w in zip(grads, want)]
            rel, floor = (1e-4, 1e-6) if dtype == torch.float32 else (1e-2, 1e-3)
            for name, e, w in zip(("dq", "dk", "dv"), errs, want):
                check(f"attention_bwd {name} {(bh, n, d)} {dtype} rate {rate}", e,
                      rel * float(w.abs().max()) + floor)
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
                f"f32 on the CUDA cores {cuda_core:.4f} ms, kernel/bound {ms / bnd:.2f}")
            if (bh, n, d) in HEAD_TIMED + DEEP_TIMED:
                bf = "" if dtype == torch.float32 else "_bf16"
                record["head_dims" if (bh, n, d) in HEAD_TIMED else "deep_head_dims"
                       ].setdefault(f"{bh}x{n}x{d}", {}).update({
                    f"ms{bf}": ms, f"plain_ms{bf}": plain, f"library_ms{bf}": lib,
                    f"bound_ms{bf}": bnd, f"bound_by{bf}": by,
                    f"max_abs_err{bf}": max(errs)})
                continue
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


# the (M, C) inputs of C7's packed step at batch 8 (phase 18) that the list
# above lacks: encoder stages 1-2 (levels 1 and 0 at 96x160), 4-6 and decoder
# stages 0-1 at 24x40, 12x20 and 6x10, decoder stages 3-4 at 96x160 and
# stage 5 (level 1 at 192x320); (8*96*160, 512) and (8*48*80, 256) are there
C7_ROWS_SHAPES = ((8 * 96 * 160, 256), (8 * 96 * 160, 128), (8 * 24 * 40, 512),
                  (8 * 12 * 20, 512), (8 * 6 * 10, 512), (8 * 192 * 320, 128))


def check_bn_rows(batchnorm, gen, dev):
    """The channels-last BN entries (the packed model's NHWC BatchNorms)
    against their plain versions at the (M, C) shapes of the packed step
    (``C7_ROWS_SHAPES`` those of C7's at batch 8): |d| <= 1e-5 of the
    per-channel sum of absolute terms."""
    for m, c in ((8 * 96 * 160, 512), (8 * 96 * 160, 1024), (8 * 48 * 80, 256),
                 (8 * 24 * 40, 256)) + C7_ROWS_SHAPES:
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


def check_subpixel_without_bias(stage, gen, dev):
    """``SubpixelConvTranspose2x(use_bias=False)`` at dec_ct[4]'s shape (base
    16 -> 16 channels, input packed twice): one ``nhwc(...,
    use_pallas=True)`` call, which takes the stage op with JAX's zero bias,
    against the op's plain version (``stage_fine_reference``, no prologue,
    a zero bias) on the same input and kernel, f32 with TF32 off at the
    fine-grid forward's 1e-4 of max|ref|; exactly one ``stage_fwd_fine``
    launch, and the module holds no bias."""
    from causalvae_tpu_torch.ops.subpixel import SubpixelConvTranspose2x

    t0 = time.perf_counter()
    _, (b, h, w, ci_p), co_p, _, _, _, recipe, levels = next(
        s for s in STAGE_SHAPES if s[0] == "dec_ct[4]")
    ci, co = ci_p // 4 ** levels, co_p // 4 ** (levels + 1)
    m = SubpixelConvTranspose2x(ci, co, use_bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (9 * co) ** -0.5)
    m.to(dev)
    x = torch.randn(b, h, w, ci_p, generator=gen).to(dev)
    before = stage.FINE_FWD_LAUNCHES
    with torch.no_grad():
        y = m.nhwc(x, phase_output=True, in_levels=levels, use_pallas=True)
        torch.cuda.synchronize()
        launches = stage.FINE_FWD_LAUNCHES - before
        ref = stage.stage_fine_reference(x, torch.ones(ci_p, device=dev),
                                         torch.zeros(ci_p, device=dev),
                                         m.weight.permute(2, 3, 0, 1),
                                         torch.zeros(co_p, device=dev), 0.01, recipe, levels,
                                         has_prologue=False)
    err, tol = max_err(y, ref), 1e-4 * float(ref.abs().max()) + 1e-6
    log(f"[kernels] SubpixelConvTranspose2x(use_bias=False) at dec_ct[4] ({tuple(x.shape)} "
        f"-> {tuple(y.shape)}): through the stage op max|d| {err:.2e} (tol {tol:.2e}) against "
        f"its plain version; stage_fwd_fine launches {launches}; parameters "
        f"{sorted(k for k, _ in m.named_parameters())}")
    check("subpixel use_bias=False", err, tol)
    if launches != 1 or m.bias is not None or y.shape != ref.shape:
        raise AssertionError(f"SubpixelConvTranspose2x(use_bias=False): {launches} launches, "
                             f"bias {m.bias}, shape {tuple(y.shape)}")
    log(f"[time] subpixel use_bias=False check {time.perf_counter() - t0:.1f} s")
    del m, x, y, ref


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
    check_subpixel_without_bias(stage, gen, dev)
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
    """A little-endian grayscale TIFF of ``arr`` (uint8, uint16 or float32):
    (h, w) one page, (P, h, w) a stack of P pages chained by their IFDs; in
    strips of ``rows`` rows, compression 1 (none), 5 (LZW), 8 (Deflate, zlib
    level 1) or 32773 (PackBits, row by row); predictor 2 is horizontal
    differencing. Each page's strips come before its IFD. Returns the bytes
    written."""
    import struct
    import zlib

    pages = arr[None] if arr.ndim == 2 else arr
    _, h, w = pages.shape
    out = bytearray(b"II" + struct.pack("<HI", 42, 0))
    link_at = 4  # where the offset of the next IFD goes
    for page in pages:
        strips = []
        for y in range(0, h, rows):
            block = page[y:y + rows]
            if predictor == 2:  # differences wrap in the unsigned type
                block = np.concatenate([block[:, :1], np.diff(block, axis=1)], axis=1)
            raw = block.astype(block.dtype.newbyteorder("<")).tobytes()
            if compression == 5:
                raw = lzw_encode(raw)
            elif compression == 8:
                raw = zlib.compress(raw, 1)
            elif compression == 32773:
                step = w * arr.itemsize
                raw = b"".join(packbits_encode(raw[i:i + step])
                               for i in range(0, len(raw), step))
            strips.append(raw)
        offsets, counts = [], []
        for st in strips:
            offsets.append(len(out))
            counts.append(len(st))
            out += st
        if len(out) % 2:
            out += b"\0"  # an IFD and its arrays start on a word boundary
        entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8 * arr.itemsize),
                   (259, 3, 1, compression), (262, 3, 1, 1), (277, 3, 1, 1),
                   (278, 4, 1, rows), (339, 3, 1, 3 if arr.dtype == np.float32 else 1)]
        if predictor != 1:
            entries.append((317, 3, 1, predictor))
        ns = len(strips)
        if ns > 1:
            arrays_at = len(out)
            out += struct.pack(f"<{ns}I{ns}I", *offsets, *counts)
            entries += [(273, 4, ns, arrays_at), (279, 4, ns, arrays_at + 4 * ns)]
        else:
            entries += [(273, 4, 1, offsets[0]), (279, 4, 1, counts[0])]
        ifd_at = len(out)
        struct.pack_into("<I", out, link_at, ifd_at)
        out += struct.pack("<H", len(entries)) + b"".join(
            struct.pack("<HHII", *e) for e in sorted(entries))
        link_at = len(out)
        out += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(out)
    return len(out)


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


class decoders_blocked:
    """Inside the block, ``import tifffile`` and ``import PIL`` fail (their
    ``sys.modules`` entries None); ``present`` says which are installed."""

    NAMES = ("tifffile", "PIL", "PIL.Image")

    def __enter__(self):
        import importlib.util

        self.present = {m: importlib.util.find_spec(m) is not None for m in self.NAMES[:2]}
        self.saved = {m: sys.modules.get(m) for m in self.NAMES}
        sys.modules.update(dict.fromkeys(self.NAMES, None))
        return self

    def __exit__(self, *exc):
        for m, mod in self.saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
        return False


def check_file_decode(vessel, files):
    """Phase 13(c): for the first file of each format, ``load_raw`` equals
    the array written, bit for bit, with tifffile and PIL blocked."""
    ms = {}
    with decoders_blocked() as blocked:
        for fmt in dict.fromkeys(files["formats"]):
            i = files["formats"].index(fmt)
            t0 = time.perf_counter()
            got = vessel.load_raw(files["paths"][i])
            ms[fmt] = round(1e3 * (time.perf_counter() - t0), 2)
            want = files["arrays"][i].astype(np.float32)
            if got.dtype != np.float32 or not np.array_equal(got, want):
                raise AssertionError(f"load_raw of the {fmt} file {i} differs from the array "
                                     f"written ({got.dtype}, {got.shape})")
    log(f"[file-corpus] load_raw equals the array written, bit for bit, for one file of "
        f"each format, with tifffile and PIL blocked (ms each: {json.dumps(ms)}); on this "
        f"machine: {json.dumps(blocked.present)}")


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
    then LOADER_BATCHES at 4 and at cpu_count threads, samples 0-255 and
    256-511 between those two, so that every file is decoded and none may
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
# (e) the MNIST models in bf16 (``dtype``): C1 and C4 graphed (S = 8 over 19
# steps, as phase 20's C1) against their eager steps bit for bit; the f32
# and bf16 steps timed in turns, eager and graphed; one bf16 step of C1, C4
# and C5 at batch 32 and the C3 and C6 forwards, card against CPU, each
# beside the card's f32 run as the control that must miss a bound (C1 and
# C4: kld and morph). The bounds are tests/test_torch_mnist_bf16.py's (the
# port's bf16 against JAX's on the CPU) but the weights': cuDNN's and
# oneDNN's bf16 weight gradients of the encoder's convolutions differ by up
# to 3.4e-2 in relative L2 (C4, on an H100 80GB HBM3 at 700 W), where the
# port and JAX on the CPU differ by 1.6e-2
MNIST_BF16_SCAN = (8, 19)
MNIST_BF16_TURNS = 2  # rounds of one group each way, the order reversed every round
MNIST_BF16_TERMS_REL = {"loss": 6e-4, "recon": 6e-4, "kld": 5e-4, "morph": 1e-5,
                        "adv": 5e-3, "d_loss": 1e-3}
MNIST_BF16_WEIGHT_L2, MNIST_BF16_BIAS_L2 = 6e-2, 0.15  # relative L2 of a gradient leaf
MNIST_BF16_LAST_BIAS_REL = 5e-2  # dec_conv2.bias, against the card's f32 step
# the forwards' (mean, max) relative bounds, card against CPU, set from a run
# on an H100 80GB HBM3 at 700 W (batch 32): C3's log-probabilities read mean 1.25e-3
# (the f32 control 1.96e-3), its feature and C6's image equal bits (the
# controls 4.78e-3 and 1.48e-3)
MNIST_BF16_FWD_TOL = {"recon": (1e-3, 1e-2), "out": (1.6e-3, 1e-2)}


def mnist_cli(main, argv, echo: bool = True) -> tuple:
    """(return value, standard output) of the port's CLI in-process; the
    output is logged too (``echo=False``: its line count only)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    text = buf.getvalue()
    for line in text.splitlines() if echo else [f"({len(text.splitlines())} lines)"]:
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
        t0 = time.perf_counter()
        phase_mnist_bf16(port, counters, smi, ds)
        log(f"[time] MNIST bf16 cases {time.perf_counter() - t0:.1f} s")

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

def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def _mean_max_rel(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(mean|d| / mean|ref|, max|d| / max|ref|) in float32."""
    d = (got.float() - ref.float()).abs()
    return float(d.mean() / ref.float().abs().mean()), float(d.max() / ref.float().abs().max())


def _bf16_step_misses(met: dict, grads: dict, ref_met: dict, ref_grads: dict,
                      last_bias: str, f32_grads=None) -> tuple:
    """(the bounds a step misses, its worst readings): the loss terms
    (``MNIST_BF16_TERMS_REL``), each weight's and each bias's gradient in
    relative L2 against the CPU's bf16 step; ``last_bias`` (the image's
    cotangent summed) against ``f32_grads``, the card's f32 step, where
    given."""
    missed, worst = [], {"terms": 0.0, "weights": 0.0, "biases": 0.0, "last_bias": 0.0}
    for k, v in ref_met.items():
        rel = abs(met[k] - v) / abs(v)
        worst["terms"] = max(worst["terms"], rel / MNIST_BF16_TERMS_REL[k])
        if rel > MNIST_BF16_TERMS_REL[k]:
            missed.append(k)
    for n, r in ref_grads.items():
        g = grads[n]
        if not torch.isfinite(g).all():
            raise AssertionError(f"bf16 step gradient {n} is not finite")
        if n == last_bias:
            if f32_grads is not None:
                ref = float(f32_grads[n].double().sum())
                worst["last_bias"] = abs(float(g.double().sum()) - ref) / abs(ref)
                if worst["last_bias"] > MNIST_BF16_LAST_BIAS_REL:
                    missed.append(n)
            continue
        group, bound = (("biases", MNIST_BF16_BIAS_L2) if n.endswith("bias")
                        else ("weights", MNIST_BF16_WEIGHT_L2))
        rel = _rel_l2(g, r)
        worst[group] = max(worst[group], rel)
        if rel > bound:
            missed.append(n)
    return missed, worst


def phase_mnist_bf16(port, counters, smi: str, ds):
    """Phase 15 (e): the MNIST models at ``dtype`` bfloat16 on the card.
    (1) C1 and C4 with their discriminator, ``ScanTrainer`` S = 8 over 19
    steps (``_scan_case``: graphed against eager bit for bit, 0 launches of
    every kernel, per-step ms, busy, idle share and peak); (2) the f32 and
    bf16 steps of both, eager and graphed, one group of 8 each way per
    round in turns, the order reversed every round (host clock, the card's
    default algorithms); (3) TF32 off, one step at batch 32 of C1, C4 and C5
    (``make_simple_vae_step``, BCE + KLD) from seeded weights with one set
    of bf16 noise, and the C3 and C6 forwards, the card's bf16 against the
    CPU's bf16 at ``MNIST_BF16_*`` bounds, the card's f32 run as the control
    that must miss one. Every counter is zeroed before (2) and read after
    (3): none of the ported kernels runs."""
    from causalvae_tpu_torch.config import MnistConfig
    from causalvae_tpu_torch.models.heads import LatentDiscriminator, SimpleClassifier
    from causalvae_tpu_torch.models.vae import (CausalConvVAE, ConditionalVAE, MDecoder,
                                                seeded_init_)
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.train.loop import (make_mnist_adversarial_step,
                                                make_simple_vae_step)
    from causalvae_tpu_torch.train.scan_loop import ScanTrainer

    cfg, ClippedAdam, bf = MnistConfig(), port["ClippedAdam"], torch.bfloat16
    names = {False: "C1", True: "C4"}

    def pair_build(bayes, dtype, dev="cuda"):
        def build(models=None):
            if models is None:
                models = [seeded_init_(CausalConvVAE(gaussian_mechanism=bayes,
                                                     decode_real_m=bayes, dtype=dtype,
                                                     device=dev), 0),
                          seeded_init_(LatentDiscriminator(dtype=dtype, device=dev), 1)]
            vae, disc = models
            vopt = ClippedAdam(vae.parameters(), cfg.lr, None, torch.float32)
            dopt = ClippedAdam(disc.parameters(), cfg.lr, None, torch.float32)
            return ([(vae, vopt), (disc, dopt)],
                    make_mnist_adversarial_step(vae, disc, vopt, dopt, cfg, bayesian=bayes))
        return build

    # (1) graphed against eager, bit for bit
    S, n = MNIST_BF16_SCAN
    batches = _scan_batches("mnist", n)
    recs = {}
    for bayes in (False, True):
        tag = f"mnist {names[bayes]} bf16"
        recs[tag] = _scan_case(tag, pair_build(bayes, bf), batches, S, {}, counters, smi,
                               ScanTrainer)

    # (2) f32 and bf16 in turns
    for c in counters.values():
        c.reset()  # the bf16 MNIST paths start here
    group = batches[:S]
    runs = {}
    for bayes in (False, True):
        for dtype in (torch.float32, bf):
            states, step = pair_build(bayes, dtype)()
            trainer = ScanTrainer(step, n_states=2, steps_per_dispatch=S)
            gen = torch.Generator().manual_seed(0)
            trainer.run_group(states, group, gen)  # warm-up and capture
            for b in group:
                step(b, generator=gen)  # the eager path warm
            runs[names[bayes], str(dtype)[6:]] = (states, step, trainer, gen)
    order = [(key, kind) for kind in ("eager", "graphed") for key in runs]
    times = {(key, kind): [] for key, kind in order}
    for r in range(MNIST_BF16_TURNS):
        for key, kind in (order if r % 2 == 0 else order[::-1]):
            states, step, trainer, gen = runs[key]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "eager":
                for b in group:
                    step(b, generator=gen)
            else:
                trainer.run_group(states, group, gen)
            torch.cuda.synchronize()
            times[key, kind].append((time.perf_counter() - t0) * 1e3 / S)
    for bayes in (False, True):
        nm = names[bayes]
        rec = recs[f"mnist {nm} bf16"]
        log(f"[mnist-bf16] {nm} step at batch {cfg.batch_size}, ms a step (host clock, median "
            f"of {MNIST_BF16_TURNS} groups of {S} in turns): " + ", ".join(
                f"{dt} {kind} {statistics.median(times[(nm, dt), kind]):.3f}"
                for dt in ("float32", "bfloat16") for kind in ("eager", "graphed"))
            + f"; bf16 graphed busy {rec['graphed_busy_ms']:.3f} ms, idle "
            f"{rec['graphed_idle']:.3f}, eager busy {rec['eager_busy_ms']:.3f} ms, idle "
            f"{rec['eager_idle']:.3f}; bf16 peak {rec['peak_bytes'] / 2**20:.1f} MiB graphed, "
            f"{rec['eager_peak_bytes'] / 2**20:.1f} MiB eager ({smi})")
    del runs

    # (3) card against CPU, bf16, the card's f32 as the control
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sel = next(ds.batch_indices(MNIST_CHECK_BATCH, np.random.default_rng(2)))
    rng = np.random.default_rng(3)
    eps = torch.from_numpy(rng.standard_normal((4, MNIST_CHECK_BATCH, cfg.z_dim)).astype(
        np.float32)).to(bf).float()  # bf16 values, as a bf16 draw gives
    batch = {k: torch.from_numpy(getattr(ds, k)[sel]) for k in ("x", "m", "t")}

    def cvae_loss(out, b):
        recon, mu, logvar = out
        return L.cvae_loss(recon, b["x"], mu, logvar, beta=1.0)

    def run_step(case, dev, dtype):
        if case == "C5":
            model = seeded_init_(ConditionalVAE(dtype=dtype, device=dev), 7)
            met = make_simple_vae_step(model, cvae_loss, ClippedAdam(
                model.parameters(), 1e-3, None, torch.float32))(
                {k: batch[k].to(dev) for k in ("x", "t")}, eps=eps[0])
            mods = (("vae", model),)
        else:
            (vs, ds_), step = pair_build(case == "C4", dtype, dev)()
            met = step({k: v.to(dev) for k, v in batch.items()}, eps=eps)
            mods = (("vae", vs[0]), ("disc", ds_[0]))
        return ({k: float(v) for k, v in met.items()},
                {f"{tag}.{n}": p.grad.detach().cpu() for tag, mod in mods
                 for n, p in mod.named_parameters()})

    failures = []  # every case reads out before the phase fails
    for case in ("C1", "C4", "C5"):
        ref_met, ref_grads = run_step(case, "cpu", bf)
        got_met, got_grads = run_step(case, "cuda", bf)
        f32_met, f32_grads = run_step(case, "cuda", torch.float32)
        last = "vae.dec_conv2.bias"
        missed, worst = _bf16_step_misses(got_met, got_grads, ref_met, ref_grads, last,
                                          f32_grads)
        ctl_missed, ctl_worst = _bf16_step_misses(f32_met, f32_grads, ref_met, ref_grads, last)
        log(f"[mnist-bf16] {case} bf16 step at batch {MNIST_CHECK_BATCH}, card against CPU: "
            f"terms {json.dumps(got_met)} vs {json.dumps(ref_met)}; worst readings "
            f"{json.dumps(worst)} (terms as a share of their bound); the card's f32 control "
            f"{json.dumps(ctl_worst)}, missing {ctl_missed}")
        if missed:
            failures.append(f"{case} bf16 step, card against CPU: {missed}")
        must_miss = {"kld", "morph"} if case != "C5" else set()
        if not ctl_missed or not must_miss <= set(ctl_missed):
            failures.append(f"{case}: the card's f32 step misses only {ctl_missed}")

    x, m, t = (batch[k].numpy() for k in ("x", "m", "t"))
    forwards = {"C3": (lambda dt, dev: SimpleClassifier(dtype=dt, device=dev),
                       lambda mod, dev: mod(torch.from_numpy(x).to(dev)), ("out", "out")),
                "C6": (lambda dt, dev: MDecoder(12, 10, dtype=dt, device=dev),
                       lambda mod, dev: (mod(torch.from_numpy(m).to(dev),
                                             torch.from_numpy(t).to(dev)),), ("recon",))}
    for case, (make, call, kinds) in forwards.items():
        outs = {}
        for dev, dt in (("cpu", bf), ("cuda", bf), ("cuda", torch.float32)):
            mod = seeded_init_(make(dt, dev), 9)
            with torch.no_grad():
                outs[dev, dt] = [o.cpu() for o in call(mod, dev)]
        for i, kind in enumerate(kinds):
            ref, got, ctl = (outs[k][i] for k in (("cpu", bf), ("cuda", bf),
                                                  ("cuda", torch.float32)))
            tol = MNIST_BF16_FWD_TOL[kind]
            (mean, mx), (c_mean, _) = _mean_max_rel(got, ref), _mean_max_rel(ctl, ref)
            log(f"[mnist-bf16] {case} forward output {i} in bf16, card against CPU: mean "
                f"{mean:.3e}, max {mx:.3e} (bound {tol}); the card's f32 control mean "
                f"{c_mean:.3e}")
            if got.dtype != bf or mean > tol[0] or mx > tol[1] or c_mean <= tol[0]:
                failures.append(f"{case} bf16 forward {i}: {got.dtype}, mean {mean:.3e}, "
                                f"max {mx:.3e}, control {c_mean:.3e}")
    if failures:
        raise AssertionError("; ".join(failures))
    launches = {name: c.read() for name, c in counters.items()}  # the bf16 MNIST paths end
    log(f"[mnist-bf16] launches of every ported kernel over (2)-(3): {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"the bf16 MNIST paths launched a ported kernel: {launches}")
    torch.cuda.empty_cache()


# phase 16: the MNIST analysis study. The device morphology at half MNIST's
# train count (the synthetic corpus stands in for the IDX files, at their
# shape), then the CLI's analyze, counterfactual and train cvae on the CLI's
# synthetic corpus (--n-synthetic 1024)
STUDY_N = 30000  # half of it: 60,000 took 10.2 s to synthesise on the host
STUDY_CHECK_N = 2048  # (a): card against the port's CPU run and the host oracle
STUDY_CHUNK = 512  # build_morph_mnist's chunk
STUDY_FEAT_TOL = 1e-5  # the non-Hu features, card against CPU (ratios and f32 sums)
STUDY_HU_SKIP, STUDY_HU_TOL = 0.6, 1e-2  # tests/test_morphology.py:132-139
STUDY_HOST_TOL = {12: 5e-3, 16: 1e-2}  # tests/test_morphology.py:125-139
ANALYZE_KEYS = ["mechanism", "phase1", "importance", "residual", "gradcam", "independence",
                "uncertainty", "causal", "mediation"]
# (width, height) of each figure: 28x28 cells 4 pixels apart
STUDY_PNGS = {"gradcam_per_class.png": (28, 10 * 28 + 9 * 4),
              "do_t_grid.png": (11 * 28 + 10 * 4, 6 * 28 + 5 * 4),
              **{f"do_m_f{f}.png": (5 * 28 + 4 * 4, 28) for f in range(12)},
              "z_permute.png": (2 * 28 + 4, 4 * 28 + 3 * 4),
              "recon_triptych.png": (3 * 28 + 2 * 4, 4 * 28 + 3 * 4)}
CVAE_CHECK_BATCH = 32
CVAE_TERMS_REL = 1e-4  # (c): as phase 15's step
CVAE_GRAD_TOL = 1e-3


def png_size(path: str) -> tuple:
    """(width, height) from a PNG's IHDR."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def hu_mask(ref: np.ndarray, n: int) -> np.ndarray:
    """Entries of (N, n) features that a comparison skips: the Hu entries
    whose value is above STUDY_HU_SKIP (invariants near the 1e-6 floor)."""
    skip = np.zeros(ref.shape, bool)
    if n == 16:
        skip[:, 9:] = np.abs(ref[:, 9:]) > STUDY_HU_SKIP
    return skip


def integer_measures(mo, imgs: torch.Tensor) -> dict:
    """The measures the features are made of that are integers (and the EDT
    maximum, the root of one): equal on every device, where the features'
    ratios and sums may differ by an ulp."""
    binary = imgs > 0.2
    mask = mo.largest_component(binary)
    ends, junctions = mo.skeleton_endpoints_junctions(mo.skeletonize(binary))
    return {"largest_component": mask, "euler_number": mo.euler_number(mask),
            "convex_area": mo.convex_area(mask), "edt_max": mo.edt_max(binary),
            "endpoints": ends, "junctions": junctions}


def phase_study(port, counters, smi: str) -> dict:
    """Phase 16: the MNIST analysis study on the card. (a) the device
    morphology: ``build_morph_mnist(use_device_extractor=True)`` with 12 and
    with 16 features over ``synthetic_mnist(STUDY_N, seed=42)``, 512 images a
    chunk, seconds, images/s and peak memory (of the whole run and of one
    chunk); its first 2048 images against the port's CPU run: the integer
    measures (``integer_measures``) equal, the features of
    ``features12_batch`` / ``features16_batch`` within 1e-5 outside the Hu
    entries, the Hu entries at most 0.6 within 1e-2; and against
    ``morphology_host`` (the entries outside
    ``STUDY_HOST_TOL``, Hu rule applied, counted on the card and on the CPU:
    equal counts), the host extractor's seconds on them; (b) through the CLI
    in a temporary directory: ``analyze all --epochs 1`` (the JSON's keys,
    ``gradcam_per_class.png``) and ``counterfactual`` do-t, do-m, z-permute,
    recon (each PNG's size), the seconds of each; (c) ``train cvae --epochs
    1``, the step on the host clock (synchronised, median of steps 1-7) and
    images/s, and one step at batch 32 from seeded weights on the card and
    on the CPU, TF32 off: loss terms rel 1e-4, every gradient leaf 1e-3 of
    its max|ref|. Every kernel counter is zeroed before (a) and read after
    (c): the study launches none of the ported kernels. Returns the counts."""
    import os
    import shutil
    import tempfile

    from causalvae_tpu_torch.data import mnist as DM
    from causalvae_tpu_torch.models.vae import ConditionalVAE, seeded_init_
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.ops import morphology as MO
    from causalvae_tpu_torch.ops import morphology_host as MH
    from causalvae_tpu_torch.train.loop import make_simple_vae_step

    main = port["cli_main"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_study_")
    t_phase = time.perf_counter()
    try:
        for c in counters.values():
            c.reset()  # the study's path starts here
        # (a) the device morphology at MNIST's count
        t0 = time.perf_counter()
        images, labels = DM.synthetic_mnist(STUDY_N, seed=42)
        log(f"[study-morph] synthetic_mnist({STUDY_N}, seed=42) in "
            f"{time.perf_counter() - t0:.2f} s on the host")
        sample = images[:STUDY_CHECK_N]
        for n in (12, 16):
            fn = MO.features12_batch if n == 12 else MO.features16_batch
            fn(images[:STUDY_CHUNK], device="cuda")  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            fn(images[:STUDY_CHUNK], device="cuda")
            torch.cuda.synchronize()
            chunk_s = time.perf_counter() - t0
            chunk_peak = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ds = DM.build_morph_mnist(images, labels, n_features=n, use_device_extractor=True)
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            if ds.m.shape != (STUDY_N, n) or not np.isfinite(ds.m).all():
                raise AssertionError(f"device morphology: m {ds.m.shape}, finite "
                                     f"{np.isfinite(ds.m).all()}")
            log(f"[study-morph] features{n}: build_morph_mnist(use_device_extractor=True) "
                f"over {STUDY_N} images in {-(-STUDY_N // STUDY_CHUNK)} chunks of "
                f"{STUDY_CHUNK}: {secs:.2f} s, {STUDY_N / secs:.0f} images/s, peak "
                f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB before; one chunk "
                f"{1e3 * chunk_s:.1f} ms, peak {chunk_peak / 2**20:.1f} MiB ({smi})")
            card = ds.m[:STUDY_CHECK_N]
            t0 = time.perf_counter()
            cpu = np.concatenate([fn(sample[s:s + STUDY_CHUNK], device="cpu").numpy()
                                  for s in range(0, STUDY_CHECK_N, STUDY_CHUNK)])
            cpu_s = time.perf_counter() - t0
            plain = slice(0, 9 if n == 16 else 12)
            feat_err = float(np.abs(card[:, plain] - cpu[:, plain]).max())
            hu_err = 0.0
            if n == 16:
                keep = ~hu_mask(cpu, n)[:, 9:]
                hu_err = float(np.abs(card[:, 9:] - cpu[:, 9:])[keep].max())
            log(f"[study-morph] features{n}, {STUDY_CHECK_N} images, card against the CPU "
                f"run ({cpu_s:.2f} s on the CPU): non-Hu features max|d| {feat_err:.3e} (tol "
                f"{STUDY_FEAT_TOL:.0e})" + (f"; Hu entries <= {STUDY_HU_SKIP} max|d| "
                                            f"{hu_err:.3e} (tol {STUDY_HU_TOL:.0e})"
                                            if n == 16 else ""))
            check(f"features{n} card vs CPU", feat_err, STUDY_FEAT_TOL)
            check(f"features{n} Hu card vs CPU", hu_err, STUDY_HU_TOL)
            t0 = time.perf_counter()
            host = MH.extract_features_batch(sample, n)
            host_s = time.perf_counter() - t0
            skip = hu_mask(host, n)
            outside = {name: int(((np.abs(v - host) > STUDY_HOST_TOL[n]) & ~skip).sum())
                       for name, v in (("card", card), ("cpu", cpu))}
            log(f"[study-morph] features{n} against morphology_host ({host_s:.2f} s on the "
                f"host, {1e3 * host_s / STUDY_CHECK_N:.3f} ms an image): entries outside "
                f"{STUDY_HOST_TOL[n]:.0e} card {outside['card']}, CPU {outside['cpu']} of "
                f"{int((~skip).sum())}")
            if outside["card"] != outside["cpu"]:
                raise AssertionError(f"features{n}: the card disagrees with the host oracle "
                                     f"where the CPU run does not: {outside}")
        t0 = time.perf_counter()
        on_card = integer_measures(MO, torch.from_numpy(sample).cuda())
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = integer_measures(MO, torch.from_numpy(sample))
        cpu_s = time.perf_counter() - t0
        unequal = {k: int((v.cpu() != on_cpu[k]).sum()) for k, v in on_card.items()}
        log(f"[study-morph] integer measures of {STUDY_CHECK_N} images, card "
            f"({card_s:.2f} s) against CPU ({cpu_s:.2f} s), unequal entries: "
            f"{json.dumps(unequal)}")
        if any(unequal.values()):
            raise AssertionError(f"integer measures differ between card and CPU: {unequal}")
        del images, ds, card, cpu, host, on_card, on_cpu

        # (b) the analyses and counterfactuals through the CLI
        base = ["--out", tmp, "--n-synthetic", str(MNIST_N)]
        t0 = time.perf_counter()
        out, _ = mnist_cli(main, base + ["analyze", "all", "--epochs", "1"], echo=False)
        analyze_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "analyze_all.json")) as f:
            saved = json.load(f)
        if list(saved) != ANALYZE_KEYS or list(out) != ANALYZE_KEYS:
            raise AssertionError(f"analyze all wrote keys {list(saved)}, not {ANALYZE_KEYS}")
        log(f"[study-cli] analyze all --epochs 1: {analyze_s:.2f} s (the corpus, its host "
            f"morphology and one training epoch included); keys "
            + json.dumps({k: list(v) if isinstance(v, dict) else type(v).__name__
                          for k, v in saved.items()}))
        for mode in ("do-t", "do-m", "z-permute", "recon"):
            t0 = time.perf_counter()
            mnist_cli(main, base + ["counterfactual", mode, "--epochs", "1"])
            log(f"[study-cli] counterfactual {mode} --epochs 1: "
                f"{time.perf_counter() - t0:.2f} s")
        sizes = {}
        for name, want in STUDY_PNGS.items():
            path = os.path.join(tmp, name)
            sizes[name] = png_size(path) if os.path.exists(path) else None
            if sizes[name] != want:
                raise AssertionError(f"{name}: size {sizes[name]}, expected {want}")
        log(f"[study-cli] {len(sizes)} PNG files, (width, height): {json.dumps(sizes)}")

        # (c) train cvae, its step, and card against CPU
        t0 = time.perf_counter()
        (model, opt, log_), _ = mnist_cli(main, base + ["train", "cvae", "--epochs", "1"])
        train_s = time.perf_counter() - t0
        rows = [r for r in log_.history if r["step"] >= 0]
        if len(rows) != 1 or not np.isfinite(rows[0]["train_loss"]):
            raise AssertionError(f"train cvae: {log_.history}")
        ds = DM.build_morph_mnist(*DM.synthetic_mnist(MNIST_N, seed=42),
                                  cache_path=os.path.join(tmp, "morph_cache_12.npz"))
        data = {k: torch.from_numpy(getattr(ds, k)).cuda() for k in ("x", "t")}

        def loss_fn(outputs, batch):
            return L.cvae_loss(outputs[0], batch["x"], outputs[1], outputs[2])

        step = make_simple_vae_step(model, loss_fn, opt)
        gen = torch.Generator().manual_seed(0)
        times = []
        for sel in ds.batch_indices(128, np.random.default_rng(1)):
            idx = torch.from_numpy(sel).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step({k: v[idx] for k, v in data.items()}, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times[1:])
        log(f"[study-cvae] train cvae --epochs 1: {train_s:.2f} s with the CLI's set-up, "
            f"{json.dumps(rows)}; the CVAE step at batch 128 (host clock, synchronised, "
            f"median of steps 1-{len(times) - 1}): {step_ms:.3f} ms, "
            f"{128e3 / step_ms:.1f} images/s; first {times[0]:.3f} ms ({smi})")
        del model, opt, step

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sel = next(ds.batch_indices(CVAE_CHECK_BATCH, np.random.default_rng(2)))
        eps = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (CVAE_CHECK_BATCH, 10)).astype(np.float32))
        got = {}
        for dev in ("cuda", "cpu"):
            cvae = seeded_init_(ConditionalVAE(device=dev), 7)
            st = make_simple_vae_step(cvae, loss_fn, port["ClippedAdam"](
                cvae.parameters(), 1e-3, None, torch.float32))
            met = st({k: torch.from_numpy(getattr(ds, k)[sel]).to(dev) for k in ("x", "t")},
                     eps=eps)
            got[dev] = ({k: float(v) for k, v in met.items()},
                        {n: p.grad.detach().cpu() for n, p in cvae.named_parameters()})
        (g_met, g_grads), (c_met, c_grads) = got["cuda"], got["cpu"]
        worst = max(abs(g_met[k] - c_met[k]) / abs(c_met[k]) for k in c_met)
        log(f"[study-cvae] step 0 at batch {CVAE_CHECK_BATCH}, card {json.dumps(g_met)}; "
            f"worst term rel {worst:.3e} (tol {CVAE_TERMS_REL:.0e})")
        for k, ref in c_met.items():
            check(f"cvae step {k}", abs(g_met[k] - ref), CVAE_TERMS_REL * abs(ref))
        ratios = {}
        for n, c in c_grads.items():
            err, ref = float((g_grads[n] - c).abs().max()), float(c.abs().max())
            if not torch.isfinite(g_grads[n]).all() or ref == 0.0:
                raise AssertionError(f"cvae card gradient {n} not finite, or the CPU's zero")
            check(f"cvae grad {n}", err, CVAE_GRAD_TOL * ref)
            ratios[n] = err / ref
        n_worst = max(ratios, key=ratios.get)
        log(f"[study-cvae] {len(ratios)} gradient leaves held at {CVAE_GRAD_TOL:.0e} of "
            f"max|ref|; worst {n_worst} {ratios[n_worst]:.3e}")
        launches = {name: c.read() for name, c in counters.items()}  # the study's path ends
        log(f"[study] launches of every ported kernel over (a)-(c): {json.dumps(launches)}")
        if any(launches.values()):
            raise AssertionError(f"the study launched a ported kernel: {launches}")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[study] phase 16 {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# Phase 17: the latent translator and the causal cascade (SURVEY workload 5)
# ---------------------------------------------------------------------------

# (a) 3-D TIFF stacks in the references' layout: ``*.vessel.tiff`` named by
# ID beside a CSV of ``Image ID,group_name,<features>`` (the masks, features
# and groups of ``synthetic_corpus(n=32)``). Each stack holds STACK_PAGES
# pages of STACK_HW uint16: the mask upscaled 10x8 on a base and a ramp, each
# page another weight and noise. That size is this script's choice, not the
# real data's: the cascade's 100-px crops leave 768x1280, the flagship's
# size. Stack 0 is LZW + predictor 2, 1 PackBits, 2 uncompressed, 3 float32
# (scaled to [0, 1]), 4 a single page; the rest Deflate (zlib level 1) +
# predictor 2, in 64-row strips.
STACK_N, STACK_PAGES, STACK_HW = 32, 6, (968, 1280)
STACK_FORMATS = ("lzw16", "packbits", "u16", "f32", "deflate16")
STACK_ONE_PAGE = 4  # the index of the single-page file
TRANSLATOR_HW = (384, 640)  # the translator's resolution for a file corpus
# (c): iterate_images, card against CPU, of max|ref|. The first card run read
# 1.025e-5 (H100, 700 W): the antialiased 968x1280 -> 384x640 resize (~6x6
# taps an output) sums in another order on the card; the phase logs both
# sides against a float64 CPU run of the same transform
TRANSLATOR_PRE_TOL = 3e-5
VIT_BATCH, VIT_EPOCHS = 8, 1  # (c): 4 steps an epoch on the 32 stacks
# per train_vit_vae step (the translator ViTVAE: depth 6, dec_res_stages 4):
# 6 attention forwards and backwards, and one BN reduction each way per
# train-mode BatchNorm: 5 stem, 5 decoder, 4 ResBlocks x 2 = 18
PER_STEP_VIT = {"attention_fwd": 6, "attention_bwd": 6, "bn_stats": 18, "bn_bwd": 18}
PER_STEP_VIT_SMALL = dict(PER_STEP_VIT, attention_fwd=2, attention_bwd=2)  # translate's
VIT_TERMS_REL, VIT_GRAD_TOL = 1e-4, 1e-3  # (c): as phase 7
TRANSLATE_CLI_N = 32  # (c): train vit and translate on synthetic_corpus(n=32), batch 4
CASCADE_HW, CASCADE_BATCH, CASCADE_EPOCHS = (512, 960), 4, 1
CASCADE_STAT_TOL = 1e-3  # (d): each augmented image's mean within 1e-3 of 0, std of 1
# (d): the eval route, card against CPU, of max|ref|. The first card run read
# 2.08e-5 (1.427e-4 of 6.873; H100, 700 W): the antialiased 768x1280 ->
# 512x960 resize rounds at ~1e-5 of the intensities' range on either side,
# and the standardisation divides that by the image's std; the phase logs
# both sides against a float64 CPU run
CASCADE_PRE_TOL = 5e-5
CASCADE_TERMS_REL, CASCADE_GRAD_TOL = 1e-4, 1e-3  # (d): one step, card against CPU
CASCADE_BN_FED = "mechanism.shared.0.bias"  # feeds the BatchNorm: gradient 0 up to rounding


def stack_array(i: int, fmt: str, mask: np.ndarray) -> np.ndarray:
    """Stack i of phase 17, (P, H, W) uint16 (float32 in [0, 1] for "f32")."""
    H, W = STACK_HW
    pages = 1 if i == STACK_ONE_PAGE else STACK_PAGES
    rng = np.random.default_rng(1700 + i)
    up = np.zeros((H, W), np.float32)
    up[4:964] = np.repeat(np.repeat(mask, 10, 0), 8, 1)  # 96x160 -> 960x1280
    ramp = np.linspace(0.0, 600.0, W, dtype=np.float32)[None, :]
    base, gain = rng.uniform(150.0, 500.0), rng.uniform(1500.0, 3500.0)
    out = np.empty((pages, H, W), np.uint16)
    for p in range(pages):
        page = base + ramp + gain * rng.uniform(0.3, 1.0) * up
        page += 250.0 * rng.standard_normal((H, W), dtype=np.float32)
        out[p] = np.clip(page, 0, 65535)
    if fmt == "f32":
        return (out / np.float32(65535)).astype(np.float32)
    return out


def write_stacks(root: str, vessel) -> dict:
    """Phase 17(a): the stacks and their CSV under ``root``; returns the CSV
    path, the paths, formats and arrays written, the bytes on disk and the
    seconds taken."""
    import csv
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    syn = vessel.synthetic_corpus(n=STACK_N, seed=0)
    fmts = list(STACK_FORMATS) + ["deflate16"] * (STACK_N - len(STACK_FORMATS))
    paths = [os.path.join(root, f"H12-{800000 + i}.vessel.tiff") for i in range(STACK_N)]

    def write(i):
        arr = stack_array(i, fmts[i], syn.raw_images[i])
        return arr, write_tiff(paths[i], arr if len(arr) > 1 else arr[0], *FILE_CODECS[
            {"u16": "u8"}.get(fmts[i], fmts[i])])

    # the pure-Python LZW and PackBits encoders first, beside the rest
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        done = list(pool.map(write, range(STACK_N)))
    csv_path = os.path.join(root, "stacks_meta.csv")
    with open(csv_path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Image ID", "group_name", *vessel.FEATURE_COLUMNS])
        for i in range(STACK_N):
            out.writerow([800000 + i, syn.group_names[syn.t_idx[i]],
                          *(repr(float(v)) for v in syn.m_raw[i])])
    return {"csv": csv_path, "paths": paths, "formats": fmts, "arrays": [a for a, _ in done],
            "bytes": sum(n for _, n in done) + os.path.getsize(csv_path),
            "seconds": time.perf_counter() - t0}


def check_page_walk(native, stacks) -> dict:
    """Phase 17(b): with tifffile and PIL blocked, ``decode_pages`` of each
    stack equals the array written and ``decode_mip`` its maximum over pages,
    bit for bit; returns the seconds per stack of each."""
    secs = {"decode_pages": [], "decode_mip": []}
    with decoders_blocked() as blocked:
        for path, arr, fmt in zip(stacks["paths"], stacks["arrays"], stacks["formats"]):
            want = arr.astype(np.float32)
            t0 = time.perf_counter()
            got = native.decode_pages(path)
            t1 = time.perf_counter()
            mip = native.decode_mip(path)
            secs["decode_pages"].append(t1 - t0)
            secs["decode_mip"].append(time.perf_counter() - t1)
            if not np.array_equal(got, want) or not np.array_equal(mip, want.max(axis=0)):
                raise AssertionError(f"the page walk of {path} ({fmt}, {arr.shape}) differs "
                                     "from the array written")
    per = {k: statistics.median(v) for k, v in secs.items()}
    log(f"[stacks] decode_pages and decode_mip of {len(stacks['paths'])} stacks equal the "
        f"arrays written and their maxima, bit for bit, with tifffile and PIL blocked "
        f"(here: {json.dumps(blocked.present)}); seconds a stack, median (max): "
        + ", ".join(f"{k} {per[k]:.4f} ({max(secs[k]):.4f})" for k in secs)
        + f"; a {STACK_PAGES}-page stack holds {STACK_PAGES * np.prod(STACK_HW) * 2 / 1e6:.1f} "
        f"MB of uint16, {STACK_PAGES * np.prod(STACK_HW) * 2 / 1e6 / per['decode_mip']:.0f} "
        f"MB/s through decode_mip")
    return per


def translator_f64(TR, raw: torch.Tensor, hw) -> torch.Tensor:
    """The translator's transform of (B, h, w) in float64 on the CPU: clip to
    the 0.5 / 99.5 percentiles, scale to [0, 1], antialiased resize."""
    img = raw.double()
    flat = img.reshape(len(img), -1)
    lo, hi = (TR.percentile(flat, q)[:, None, None] for q in (0.5, 99.5))
    img = (torch.minimum(torch.maximum(img, lo), hi) - lo) / torch.where(hi == lo, 1e-5, hi - lo)
    return F.interpolate(img[:, None], size=hw, mode="bilinear", align_corners=False,
                         antialias=True)[:, 0, ..., None]


def cascade_f64(raw: torch.Tensor, hw) -> torch.Tensor:
    """The cascade's eval transform of (B, h, w) in float64 on the CPU:
    antialiased resize, per-image standardisation (biased std)."""
    img = F.interpolate(raw.double()[:, None], size=hw, mode="bilinear",
                        align_corners=False, antialias=True)[:, 0]
    mean = img.mean(dim=(1, 2), keepdim=True)
    return ((img - mean) / (img.std(dim=(1, 2), keepdim=True, correction=0) + 1e-5))[..., None]


def _step_on(dev: str, model_fn, step_fn, adam, batch: dict, eps: torch.Tensor, names=None):
    """One step of ``step_fn(model, adam(...))`` from ``model_fn(dev)`` on
    ``dev``: (metrics as floats, {name: grad on the CPU} of the parameters
    whose names start with ``names``, all without it)."""
    model = model_fn(dev)
    opt = adam(model.parameters(), 1e-4, None, torch.float32)
    met = step_fn(model, opt)({k: v.to(dev) for k, v in batch.items()}, eps=eps.to(dev))
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if names is None or n.startswith(names)}
    return {k: float(v) for k, v in met.items()}, grads


def _hold_step(tag: str, got: dict, terms_rel: float, grad_tol, skip=()):
    """Card against CPU: each loss term within ``terms_rel`` of the CPU's,
    each gradient leaf within ``grad_tol`` of its max|ref| (a number, or a
    function of the leaf's name), but ``skip``; the five worst leaves are
    logged before any is held."""
    (g_met, g_grads), (c_met, c_grads) = got["cuda"], got["cpu"]
    worst = max(abs(g_met[k] - c_met[k]) / abs(c_met[k]) for k in c_met)
    log(f"[{tag}] card {json.dumps(g_met)}; worst term rel {worst:.3e} (tol {terms_rel:.0e})")
    for k, ref in c_met.items():
        check(f"{tag} {k}", abs(g_met[k] - ref), terms_rel * abs(ref))
    tol = grad_tol if callable(grad_tol) else (lambda n: grad_tol)
    held = {}
    for n, c in c_grads.items():
        err, ref = float((g_grads[n] - c).abs().max()), float(c.abs().max())
        if not torch.isfinite(g_grads[n]).all():
            raise AssertionError(f"{tag}: card gradient {n} not finite")
        if n in skip:
            log(f"[{tag}] {n} (not held: its gradient is 0 up to rounding): card "
                f"max|g| {float(g_grads[n].abs().max()):.3e}, CPU {ref:.3e}")
            continue
        if ref == 0.0:
            raise AssertionError(f"{tag}: the CPU gradient {n} is 0")
        held[n] = (err, ref)
    ranked = sorted(held, key=lambda n: -held[n][0] / held[n][1])
    log(f"[{tag}] {len(held)} gradient leaves held, of max|ref|; worst: " + ", ".join(
        f"{n} {held[n][0] / held[n][1]:.3e} (tol {tol(n):.0e})" for n in ranked[:5]))
    for n, (err, ref) in held.items():
        check(f"{tag} grad {n}", err, tol(n) * ref)


def _step_times(log_) -> str:
    """A run's loop: the period of a step on the device clock (median of
    every step after each epoch's first; batch building included) and the
    step call on the host clock (the loop's mean, the first steps included)."""
    dev = [ms for rec in log_.clock.records for ms in rec["step_ms"][1:]]
    host = sum(r.get("step_s", 0.0) for r in log_.clock.records)
    steps = sum(r["steps"] for r in log_.clock.records)
    return (f"step period {statistics.median(dev):.2f} ms on the device clock (median of "
            f"{len(dev)}, batches built in it), the step call {1e3 * host / steps:.2f} ms on "
            f"the host (mean, the first included), first period "
            f"{log_.clock.records[0]['step_ms'][0]:.2f} ms")


def time_step(step, batch: dict, n: int = 6) -> str:
    """A train step alone on one batch, synchronised: the median over steps
    1 to n - 1 on the host clock and between CUDA events around it."""
    host, dev = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(batch)
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        dev.append(start.elapsed_time(end))
    return (f"the step alone on one batch (synchronised, median of {n - 1} after the "
            f"first): {statistics.median(host[1:]):.2f} ms on the host clock, "
            f"{statistics.median(dev[1:]):.2f} ms between CUDA events")


def phase_translator_cascade(port, counters, smi: str) -> dict:
    """Phase 17: the latent translator and the causal cascade at full width,
    in a temporary directory removed at the end; every kernel counter zeroed
    before each part and read after it.

    (a) STACK_N stacks written (``write_stacks``); (b) the native page walk
    bit for bit (``check_page_walk``); (c) the translator: ``scan_image_roots``
    + ``match_table`` + ``iterate_images`` at 384x640 on the card against the
    port's CPU run, no sample all zeros, no load failure; ``train_vit_vae``
    (the translator ViTVAE at its full widths, batch 8, VIT_EPOCHS epochs of 4 steps)
    with exact counts per step (``PER_STEP_VIT``), finite losses, the step on
    the device and host clocks and the peak memory; one step card against
    CPU from seeded weights, dropout off, the same noise (the loss terms rel
    1e-4; under the KL term alone the attention blocks' gradients 1e-3 of
    max|ref|); ``extract_vit_latents`` (6 attention forwards a batch) into
    ``fit_translator``, ``group_contrasts`` and ``bootstrap_topk_stability``;
    then the CLI's ``train vit --epochs 1`` and ``translate --epochs 1`` on
    the synthetic corpus (counts, ``trackA_ranking.csv``). (d) the cascade:
    ``scan_cascade_corpus`` on the stacks; ``iterate_batches(train=True)`` on
    the card (finite, each image standardised) and the eval route card
    against CPU; ``train_cascade`` at 512x960, batch 4, CASCADE_EPOCHS epochs (every
    counter 0, the step time, the peak memory); one C10 step card against
    CPU (terms rel 1e-4, gradients 1e-3 of max|ref|); the CLI's ``train
    cascade --epochs 1`` and ``cascade --csv --data --epochs 1``
    (``sensitivity_ranking.csv``). Returns the launches summed over the
    parts."""
    import contextlib
    import csv
    import dataclasses
    import io
    from concurrent.futures import ThreadPoolExecutor

    from causalvae_tpu_torch import native
    from causalvae_tpu_torch.analysis import translate as TA
    from causalvae_tpu_torch.data import cascade as CA
    from causalvae_tpu_torch.data import translator as TR
    from causalvae_tpu_torch.models.vae import CausalBioVAE, seeded_init_
    from causalvae_tpu_torch.models.vit import ViTVAE
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.train import workloads as W
    from causalvae_tpu_torch.train.loop import make_simple_vae_step, make_vae_step

    main, vessel, adam = port["cli_main"], port["vessel"], port["ClippedAdam"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stacks_")
    by_part = {}
    t_phase = time.perf_counter()

    @contextlib.contextmanager
    def part(tag: str, want: dict):
        for c in counters.values():
            c.reset()  # this part's path starts here
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        launches = {name: c.read() for name, c in counters.items()}  # and ends here
        log(f"[{tag}] {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}")
        _expect_counts(tag, launches, want)
        by_part[tag] = launches

    def cli(tag: str, argv: list, want: dict):
        out = io.StringIO()
        with part(tag, want), contextlib.redirect_stdout(out):
            result = main(["--out", os.path.join(tmp, "out"), *argv])
        return result, out.getvalue()

    def ranking_csv(name: str, header: list):
        with open(os.path.join(tmp, "out", name)) as f:
            rows = list(csv.DictReader(f))
        if not rows or list(rows[0]) != header or len(rows) != len(vessel.FEATURE_COLUMNS):
            raise AssertionError(f"{name}: {len(rows)} rows, header "
                                 f"{list(rows[0]) if rows else None}")
        log(f"[{name}] header {header}, {len(rows)} rows; first {json.dumps(rows[0])}")

    try:
        secs = native.build()  # built by phase 13 unless this phase runs alone
        failures = TR.LOAD_FAILURES
        root = os.path.join(tmp, "stacks")
        os.makedirs(root)
        # (a) the stacks
        stacks = write_stacks(root, vessel)
        log(f"[stacks] native loader ready ({secs:.2f} s of g++ here); wrote {STACK_N} "
            f"stacks of {STACK_PAGES} pages of {STACK_HW[0]}x"
            f"{STACK_HW[1]} (one of 1 page; formats "
            f"{json.dumps({f: stacks['formats'].count(f) for f in dict.fromkeys(stacks['formats'])})}"
            f") and the CSV in {stacks['seconds']:.1f} s: {stacks['bytes']} bytes on disk")
        # (b) the page walk
        page_walk = check_page_walk(native, stacks)

        # (c) the translator
        with open(stacks["csv"], newline="") as f:
            rows = list(csv.DictReader(f))
        path_map = TR.scan_image_roots(root)
        kept = TR.match_table(rows, path_map)
        if [r["Image ID"] for r in kept] != [str(800000 + i) for i in range(STACK_N)]:
            raise AssertionError(f"match_table kept {len(kept)} of {STACK_N} rows")
        with part("translator-images", {}):
            t0 = time.perf_counter()
            card = [b["x"] for b in TR.iterate_images(kept, path_map, VIT_BATCH, TRANSLATOR_HW,
                                                      device="cuda")]
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        with ThreadPoolExecutor(os.cpu_count()) as pool:
            mips = np.stack(list(pool.map(
                lambda r: TR.mip(TR.load_stack(path_map[r["Image ID"]])), kept)))
        t0 = time.perf_counter()
        cpu = [b["x"] for b in TR.iterate_images(kept, path_map, VIT_BATCH, TRANSLATOR_HW,
                                                 raw_images=mips, device="cpu")]
        cpu_s = time.perf_counter() - t0
        ref64 = translator_f64(TR, torch.from_numpy(mips[:VIT_BATCH]), TRANSLATOR_HW)
        off64 = {name: float((x[:VIT_BATCH].cpu().double() - ref64).abs().max())
                 for name, x in (("card", card[0]), ("cpu", cpu[0]))}
        x_card = torch.cat(card)
        err = max(float((g.cpu() - c).abs().max()) for g, c in zip(card, cpu))
        ref = max(float(c.abs().max()) for c in cpu)
        zeros = int((x_card.flatten(1).amax(dim=1) == 0).sum())
        log(f"[translator-images] {STACK_N} stacks -> MIP -> percentile clip -> {TRANSLATOR_HW}: "
            f"card {card_s:.2f} s from the files, CPU {cpu_s:.2f} s from the MIPs; card "
            f"against CPU max|d| {err:.3e} (tol {TRANSLATOR_PRE_TOL:.0e} of max|ref| {ref:.3f}); "
            f"the first batch against a float64 CPU run: card {off64['card']:.3e}, CPU "
            f"{off64['cpu']:.3e}; samples all zeros: {zeros}")
        check("translator images card vs CPU", err, TRANSLATOR_PRE_TOL * ref)
        if zeros or x_card.shape != (STACK_N, *TRANSLATOR_HW, 1):
            raise AssertionError(f"iterate_images: {zeros} samples all zeros, {x_card.shape}")

        def vit_batches(epoch):
            return TR.iterate_images(kept, path_map, VIT_BATCH, TRANSLATOR_HW, raw_images=mips,
                                     device="cuda")

        steps = VIT_EPOCHS * STACK_N // VIT_BATCH
        torch.cuda.reset_peak_memory_stats()
        with part("train-vit-vae", {n: steps * v for n, v in PER_STEP_VIT.items()}):
            vit, vopt, vlog = W.train_vit_vae(vit_batches, TRANSLATOR_HW, epochs=VIT_EPOCHS,
                                              device="cuda")
        peak = torch.cuda.max_memory_allocated()

        def vit_loss(o, b):
            return L.vit_vae_loss(o[0], b["x"], o[2], o[3])

        vit_alone = time_step(make_simple_vae_step(
            vit, vit_loss, vopt, arg_names=("x",), needs_dropout=True, has_batch_stats=True,
            train_kw=True), {"x": x_card[:VIT_BATCH]})
        losses = [r["train_loss"] for r in vlog.history if r["step"] >= 0]
        if len(losses) != VIT_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"train_vit_vae: {vlog.history}")
        log(f"[train-vit-vae] ViTVAE {TRANSLATOR_HW} (embed 256, depth 6, 8 heads, MLP 512, "
            f"latent 512, dec_res_stages 4; {sum(p.numel() for p in vit.parameters())} "
            f"parameters), batch {VIT_BATCH}, {steps} steps: losses {losses}; "
            f"{_step_times(vlog)}; {vit_alone}; peak {peak / 2**30:.3f} GiB ({smi})")

        # one step card against CPU under the KL term alone: its loss terms are
        # vit_vae_loss's, and its gradient reaches the blocks without the decoder
        def kld_alone(o, b):
            _, met = L.vit_vae_loss(o[0], b["x"], o[2], o[3])
            return met["kld"], met

        eps = torch.from_numpy(np.random.default_rng(17).standard_normal(
            (VIT_BATCH, 512)).astype(np.float32))
        got = {dev: _step_on(
            dev, lambda d: seeded_init_(ViTVAE(img_size=TRANSLATOR_HW, dropout=0.0,
                                               dec_res_stages=4, device=d), 7),
            lambda m_, o: make_simple_vae_step(m_, kld_alone, o, arg_names=("x",),
                                               needs_dropout=True, has_batch_stats=True,
                                               train_kw=True),
            adam, {"x": cpu[0]}, eps, names="blocks.") for dev in ("cuda", "cpu")}
        _hold_step("vit-step-vs-cpu", got, VIT_TERMS_REL, VIT_GRAD_TOL)
        torch.cuda.empty_cache()

        n_batches = -(-STACK_N // VIT_BATCH)
        with part("extract-vit-latents", {"attention_fwd": n_batches * 6}):
            z = W.extract_vit_latents(vit, vit_batches(0))
        names = [f"feat{i}" for i in range(len(vessel.FEATURE_COLUMNS))]
        m = np.asarray([[float(r[c]) for c in vessel.FEATURE_COLUMNS] for r in kept])
        groups = sorted({r["group_name"] for r in kept})
        g_idx = np.asarray([groups.index(r["group_name"]) for r in kept])
        t0 = time.perf_counter()
        rep = TA.fit_translator(z, m, names)
        contrasts = TA.group_contrasts(z, g_idx, groups)
        stability = TA.bootstrap_topk_stability(z, m, names, n_boot=20)
        if z.shape != (STACK_N, 512) or not np.isfinite(z).all():
            raise AssertionError(f"extract_vit_latents: {z.shape}")
        log(f"[translate-analysis] z {z.shape}; fit_translator, group_contrasts ({len(contrasts)} "
            f"groups), bootstrap_topk_stability (20 resamples) in "
            f"{time.perf_counter() - t0:.2f} s on the host; ranking {rep['ranking'][:4]}..., "
            f"LOOCV R² {min(rep['r2'].values()):.3f}..{max(rep['r2'].values()):.3f}; top-5 "
            f"frequency {json.dumps(dict(list(stability.items())[:3]))}")
        del vit, vopt, card, x_card
        torch.cuda.empty_cache()

        syn = ["--n-synthetic", str(TRANSLATE_CLI_N)]
        vit_steps = TRANSLATE_CLI_N // 4
        (_, _, tlog), _ = cli("cli-train-vit", syn + ["train", "vit", "--epochs", "1"],
                              {n: vit_steps * v for n, v in PER_STEP_VIT.items()})
        log(f"[cli-train-vit] train vit --epochs 1: {json.dumps(tlog.history)}")
        want = {n: vit_steps * v for n, v in PER_STEP_VIT_SMALL.items()}
        want["attention_fwd"] += 2 * (TRANSLATE_CLI_N // 4)  # the latents, depth 2
        cli("cli-translate", syn + ["translate", "--epochs", "1"], want)
        ranking_csv("trackA_ranking.csv", ["feature", "r2", "corr"])

        # (d) the cascade
        corpus = CA.scan_cascade_corpus(stacks["csv"], [root])
        if sorted(corpus.paths) != sorted(stacks["paths"]):
            raise AssertionError(f"scan_cascade_corpus matched {len(corpus.paths)} stacks")
        with part("cascade-batches", {}):
            t0 = time.perf_counter()
            xs = torch.cat([b["x"] for b in CA.iterate_batches(
                corpus, CASCADE_BATCH, CASCADE_HW, train=True, device="cuda")])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            ev_card = [b["x"] for b in CA.iterate_batches(corpus, CASCADE_BATCH, CASCADE_HW,
                                                          train=False, device="cuda")]
        flat = xs.flatten(1).double()
        mean_err = float(flat.mean(dim=1).abs().max())
        std_err = float((flat.std(dim=1, correction=0) - 1).abs().max())
        if not torch.isfinite(xs).all() or xs.shape != (STACK_N, *CASCADE_HW, 1):
            raise AssertionError(f"cascade train batches: {xs.shape}, finite "
                                 f"{bool(torch.isfinite(xs).all())}")
        check("cascade image mean", mean_err, CASCADE_STAT_TOL)
        check("cascade image std", std_err, CASCADE_STAT_TOL)
        with ThreadPoolExecutor(os.cpu_count()) as pool:
            mipped = dataclasses.replace(corpus, raw_images=np.stack(list(pool.map(
                lambda p: CA.crop_and_clip(CA.load_mip_paged(p)), corpus.paths))))
        ev_cpu = [b["x"] for b in CA.iterate_batches(mipped, CASCADE_BATCH, CASCADE_HW,
                                                     train=False, device="cpu")]
        err = max(float((g.cpu() - c).abs().max()) for g, c in zip(ev_card, ev_cpu))
        ref = max(float(c.abs().max()) for c in ev_cpu)
        ref64 = cascade_f64(torch.from_numpy(mipped.raw_images[:CASCADE_BATCH]), CASCADE_HW)
        off64 = {name: float((x.cpu().double() - ref64).abs().max())
                 for name, x in (("card", ev_card[0]), ("cpu", ev_cpu[0]))}
        log(f"[cascade-batches] {STACK_N} stacks -> page-by-page MIP -> crop and clip -> "
            f"{CASCADE_HW}, augmented on the card in {train_s:.2f} s (decode included): each "
            f"image's |mean| <= {mean_err:.3e}, |std - 1| <= {std_err:.3e} (tol "
            f"{CASCADE_STAT_TOL:.0e}); the eval route card against CPU max|d| {err:.3e} (tol "
            f"{CASCADE_PRE_TOL:.0e} of max|ref| {ref:.3f}); the first batch against a "
            f"float64 CPU run: card {off64['card']:.3e}, CPU {off64['cpu']:.3e}")
        check("cascade eval route card vs CPU", err, CASCADE_PRE_TOL * ref)
        del xs, ev_card
        torch.cuda.reset_peak_memory_stats()
        with part("train-cascade", {}):
            c10, copt, clog = W.train_cascade(corpus, img_hw=CASCADE_HW,
                                              batch_size=CASCADE_BATCH,
                                              epochs=CASCADE_EPOCHS, device="cuda")
            c10_alone = time_step(make_vae_step(
                c10, lambda out, b: L.cascade_loss(out, b["x"], b["m"]), copt),
                {k: v.to(next(c10.parameters()).device) for k, v in (
                    ("x", ev_cpu[0]), ("m", torch.from_numpy(corpus.m[:CASCADE_BATCH])),
                    ("t", torch.from_numpy(corpus.t_idx[:CASCADE_BATCH].astype(np.int64))))})
        peak = torch.cuda.max_memory_allocated()
        losses = [r["train_loss"] for r in clog.history if r["step"] >= 0]
        if len(losses) != CASCADE_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"train_cascade: {clog.history}")
        batch_ms = [1e3 * r.get("batch_s", 0.0) / r["steps"] for r in clog.clock.records]
        log(f"[train-cascade] CausalBioVAE (C10; {sum(p.numel() for p in c10.parameters())} "
            f"parameters) at {CASCADE_HW}, batch {CASCADE_BATCH}, "
            f"{CASCADE_EPOCHS * (STACK_N // CASCADE_BATCH)} steps: losses {losses}; "
            f"{_step_times(clog)}; building batches (decode, MIP, augment) "
            f"{', '.join(f'{b:.1f}' for b in batch_ms)} ms a step; {c10_alone}; peak "
            f"{peak / 2**30:.3f} GiB "
            f"({smi})")
        del c10, copt
        batch = {"x": ev_cpu[0], "m": torch.from_numpy(corpus.m[:CASCADE_BATCH]),
                 "t": torch.from_numpy(corpus.t_idx[:CASCADE_BATCH].astype(np.int64))}
        eps = torch.from_numpy(np.random.default_rng(18).standard_normal(
            (CASCADE_BATCH, 64)).astype(np.float32))
        got = {dev: _step_on(
            dev, lambda d: seeded_init_(CausalBioVAE(m_dim=corpus.m.shape[1],
                                                     t_dim=len(corpus.group_names),
                                                     device=d), 7),
            lambda m_, o: make_vae_step(m_, lambda out, b: L.cascade_loss(out, b["x"], b["m"]),
                                        o), adam, batch, eps) for dev in ("cuda", "cpu")}
        _hold_step("cascade-step-vs-cpu", got, CASCADE_TERMS_REL, CASCADE_GRAD_TOL,
                   skip=(CASCADE_BN_FED,))

        (_, _, cl), _ = cli("cli-train-cascade", ["train", "cascade", "--epochs", "1"], {})
        log(f"[cli-train-cascade] train cascade --epochs 1: {json.dumps(cl.history)}")
        cli("cli-cascade", ["cascade", "--csv", stacks["csv"], "--data", root, "--epochs", "1"],
            {})
        ranking_csv("sensitivity_ranking.csv", ["feature", "importance"])
        if TR.LOAD_FAILURES != failures:
            raise AssertionError(f"load_stack fell back to zeros {TR.LOAD_FAILURES - failures} "
                                 "times")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[translator-cascade] phase 17 {time.perf_counter() - t_phase:.1f} s; page walk "
        f"{json.dumps({k: round(v, 4) for k, v in page_walk.items()})} s a stack ({smi})")
    return {name: sum(r[name] for r in by_part.values()) for name in counters}



# phase 18: C7 (the reference's CNN vessel VAE) and the reference-checkpoint
# converters at full width. C7 at VesselConfig's widths: 768x1280, z 128, the
# (6, 10) grid. Per C7 train step: one BN reduction each way per train-mode
# BatchNorm (7 encoder, enc_fc_bn, dec_fc_bn, 6 decoder: 15; the channels-last
# entries in the packed form's NHWC ones) and the ELBO terms once each way
C7_GRID = (6, 10)
PER_STEP_C7 = {"bn_stats": 15, "bn_bwd": 15, "elbo_terms": 1, "elbo_terms_bwd": 1}
C7_BATCH, C7_STEPS, C7_SHORT_STEPS = 8, 6, 3  # (c): spatial f32; packed f32 and bf16
C7_SERVE_BUCKETS = (1, 8)
# (a): the port's C7 against the reference mirror on the card, eval mode, TF32
# off, of max|ref|: the same cuDNN convolutions in the same NCHW layout; only
# the fc layers' sums run in another order (the NHWC flatten). The phase logs
# both sides against the mirror in float64: the first card runs read 1.2e-7
# of max|ref| between them and <= 1.4e-7 from float64 on either side (H100
# 80GB HBM3, 700 W)
C7_MIRROR_TOL = 1e-5
# (c): one step of the vessel loss, spatial and packed on the card against
# the spatial one on the CPU, as phase 7 holds it: the terms and the
# gradients below the decoder's BatchNorm chain; batch 4,
# because at batch 2 a BatchNorm1d's backward is exactly 0 (x-hat = ±1)
C7_CHECK_BATCH = 4
C7_TERMS_REL, C7_GRAD_TOL = 1e-4, 1e-3
# (c): the KL term alone, through the encoder, at the training batch: the
# card's port, spatial and packed, in f32 against the reference mirror's
# float64 step on the card (the same weights; its gradients carried to the
# port's names by the converter's map); every encoder leaf but the biases
# that feed a BatchNorm (their gradient is 0 up to rounding) held, of
# max|ref|. The fc leaves at C7_GRAD_TOL; the conv stages' at
# C7_ENC_GRAD_TOL. Their gradient under the KL term alone is a small
# residual of the BatchNorm2d backwards, so it is ill-conditioned in f32
# whatever computes it: over six seeds at batch 8, both forms on the card
# missed float64 by up to 5.9e-2 there (enc_convs.6.weight; 1.0e-2-5.9e-2
# the worst leaf of each run), the port on the CPU (no cuDNN) by 2.8e-2 on
# the seed held here, and the fc leaves by <= 1.5e-5 (H100 80GB HBM3, 700
# W; PERF.md). A wiring fault (a permutation, a lost term) misses by O(1)
C7_KLD_SEEDS = (3,)
C7_ENC_CONV = ("enc_convs.", "enc_bns.")
C7_ENC_GRAD_TOL = 1e-1

# (d): the vessel ViT's token grid in a reference checkpoint (768x1280 / 32),
# and the translator's (384x640 / 32)
VIT_REF_GRID, VIT_TRANSLATOR_GRID = (24, 40), (12, 20)


class RefVesselVAE(torch.nn.Module):
    """The reference CausalVesselVAE's module list in plain torch, NCHW (ref
    vessel_analysis/00_core/models.py:9-166, the live ``dec_conv``; as
    ``tests/test_port_vessel_cnn.py`` writes it): the state-dict layout
    that reference checkpoints hold."""

    def __init__(self, m_dim=12, t_dim=19, z_dim=128, grid=C7_GRID):
        nn = torch.nn
        super().__init__()
        self.grid = grid
        layers, prev = [], 1
        for c in (32, 64, 128, 256, 512, 512, 512):
            layers += [nn.Conv2d(prev, c, 4, 2, 1), nn.BatchNorm2d(c), nn.LeakyReLU(0.2)]
            prev = c
        layers.append(nn.Flatten())
        self.enc_conv = nn.Sequential(*layers)
        flat = 512 * grid[0] * grid[1]
        self.enc_fc = nn.Sequential(nn.Linear(flat + m_dim + t_dim, 1024), nn.BatchNorm1d(1024),
                                    nn.LeakyReLU(0.2), nn.Linear(1024, 2 * z_dim))
        self.morph_predictor_shared = nn.Sequential(
            nn.Linear(t_dim, 64), nn.LeakyReLU(0.2), nn.Linear(64, 64), nn.LeakyReLU(0.2))
        self.morph_predictor_mu = nn.Linear(64, m_dim)
        self.morph_predictor_logvar = nn.Linear(64, m_dim)
        self.dec_fc = nn.Sequential(nn.Linear(m_dim + z_dim, 1024), nn.BatchNorm1d(1024),
                                    nn.LeakyReLU(0.2), nn.Linear(1024, flat), nn.ReLU())
        layers, prev = [], 512
        for c in (512, 512, 256, 128, 64, 32):
            layers += [nn.Upsample(scale_factor=2, mode="nearest"), nn.Conv2d(prev, c, 3, 1, 1),
                       nn.BatchNorm2d(c), nn.ReLU()]
            prev = c
        layers += [nn.Upsample(scale_factor=2, mode="nearest"), nn.Conv2d(prev, 1, 3, 1, 1),
                   nn.Sigmoid()]
        self.dec_conv = nn.Sequential(*layers)

    def encode(self, x, m, t):
        mu, logvar = self.enc_fc(torch.cat([self.enc_conv(x), m, t], dim=1)).chunk(2, dim=1)
        return torch.clamp(mu, -100, 100), torch.clamp(logvar, -10, 10)

    def predict_m(self, t):
        return self.morph_predictor_mu(self.morph_predictor_shared(t))

    def decode(self, m, z):
        return self.dec_conv(self.dec_fc(torch.cat([m, z], dim=1)).view(-1, 512, *self.grid))


def seeded_mirror() -> RefVesselVAE:
    """Phase 18's reference C7 on the CPU: seeded, its BatchNorms given
    non-trivial affines and running statistics."""
    torch.manual_seed(1800)
    ref = RefVesselVAE()
    gen = torch.Generator().manual_seed(1801)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = mod.num_features
                mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
    return ref


def c7_kld_vs_f64(state: dict, batch: int, seed: int, devices=("cuda",)) -> dict:
    """The KL term alone through C7's encoder in train mode, from the
    reference state dict ``state`` on ``bench_batch(batch, VESSEL_HW,
    seed)``: the reference mirror in float64 on the card, then the port's
    C7 (spatial and packed) in f32 on each of ``devices``. Returns
    {(device, packed): (kld / kld64 - 1, {leaf: (max|d|, max|ref|)})} for
    every encoder leaf of the port, the mirror's gradients carried to the
    port's names by ``causal_vessel_vae_name_maps``."""
    from causalvae_tpu_torch.models.vae import CausalVesselVAE
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.train import port_maps as PP

    b = bench_batch(batch, VESSEL_HW, seed)
    ref = RefVesselVAE(grid=C7_GRID)
    ref.load_state_dict(state)
    ref = ref.to("cuda", torch.float64).train()
    x64 = b["x"].to("cuda", torch.float64).permute(0, 3, 1, 2)  # the mirror takes NCHW
    mu, lv = ref.encode(x64, *(b[k].to("cuda", torch.float64) for k in ("m", "t")))
    kld64 = -0.5 * (1.0 + lv - mu * mu - torch.exp(lv)).sum()
    ref.zero_grad(set_to_none=True)
    kld64.backward()
    grads = {n: p.grad for n, p in ref.named_parameters()}
    want = {pk: conv(grads[rk]).cpu() for pk, (rk, conv)
            in PP.causal_vessel_vae_name_maps(C7_GRID)[0].items() if pk.startswith("enc_")}
    kld64 = float(kld64.detach())
    del ref, grads, x64, mu, lv
    out = {}
    for dev in devices:
        for packed in (False, True):
            model = CausalVesselVAE(grid_hw=C7_GRID, packed=packed, device=dev)
            sd, skipped = PP.port_vessel_cnn_checkpoint(model, state, C7_GRID)
            if skipped:
                raise AssertionError(f"port_vessel_cnn_checkpoint skipped {skipped}")
            model.load_state_dict(sd, strict=True)
            model.train()
            kld = L.kld_sum(*model.encode(*(b[k].to(dev) for k in ("x", "m", "t"))))
            kld.backward()
            got = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                   if n.startswith("enc_")}
            if sorted(got) != sorted(want):
                raise AssertionError(f"C7 encoder leaves {sorted(got)} against {sorted(want)}")
            out[dev, packed] = (float(kld.detach()) / kld64 - 1.0, {
                n: (float((got[n].double() - want[n]).abs().max()), float(want[n].abs().max()))
                for n in want})
            del model, sd, kld, got
    torch.cuda.empty_cache()
    return out


def seeded_reference_state(maps, shapes: dict, seed: int) -> dict:
    """A reference-layout state dict for the name maps ``maps`` (parameters,
    running statistics): each reference key with the shape of its port key
    (the converters keep shapes), or ``shapes``' own entry where the port
    model has none, seeded: N(0, 0.02²), running variances U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for pk, (rk, _) in {**maps[0], **maps[1]}.items():
        shape = shapes[pk]
        state[rk] = (0.5 + torch.rand(shape, generator=gen) if rk.endswith("running_var")
                     else 0.02 * torch.randn(shape, generator=gen))
    return state


def phase_vessel_cnn(port, counters, smi: str) -> dict:
    """Phase 18: C7 and the reference-checkpoint converters at full width, in
    a temporary directory removed at the end; every kernel counter zeroed
    before each part and read after it.

    (a) The reference mirror (``RefVesselVAE``) at VesselConfig's widths,
    seeded, its BatchNorms given non-trivial statistics, saved as
    ``{"model_state_dict": ...}``; ``load_torch_checkpoint`` +
    ``port_vessel_cnn_checkpoint`` into the port's C7 on the card, nothing
    skipped, seconds and bytes; eval ``encode``, ``predict_m`` and
    ``decode`` at batch 2, spatial and packed, against the mirror on the
    card (``C7_MIRROR_TOL``; both sides against the mirror in float64
    logged). (b) ``vae_endpoints``
    of it behind ``BatchingEngine`` at buckets 1 and 8: six endpoints, the
    median of 5 ``reconstruct`` latencies a bucket, 0 launches of every
    kernel. (c) Training at batch 8, 768x1280, the clipped bf16-moment Adam:
    spatial f32 6 steps (``PER_STEP_C7`` a step), losses finite and falling,
    the step alone on the host clock and between CUDA events, peak memory;
    packed f32 and spatial bf16 3 steps each, timed, counted, peaks; one
    step at batch ``C7_CHECK_BATCH``, spatial and packed on the card, against
    the spatial one on the CPU (the vessel loss: the terms and the gradients
    below the decoder's BatchNorm chain); the KL
    term alone through the encoder at batch 8, spatial and packed, against
    the mirror's float64 step on the card (``c7_kld_vs_f64``; the conv
    stages at ``C7_ENC_GRAD_TOL``, the fc layers at ``C7_GRAD_TOL``, the
    biases that feed a BatchNorm logged, not held). (d) A reference-layout C9 state dict at the 24x40 grid (keys and
    shapes from the converter's own map, seeded values) loaded into
    ``vessel_model()`` by ``port_vitvae_checkpoint(causal=True)``: only the
    not-instantiated ``fc_mu``/``fc_var`` rows skipped, every entry equal to
    its converted source, ``reconstruct`` at bucket 1 with 6 attention
    launches; a ViTVAE-layout file at 24x40 loaded into the translator's
    ViTVAE at 384x640 (``src_grid``/``dst_grid``: the positional embedding
    resized, ``decoder_input`` skipped by shape, as JAX does) and one
    ``extract_vit_latents`` batch (6 attention launches). Returns the
    launches summed over the parts."""
    import contextlib
    import copy

    from causalvae_tpu_torch.models.vae import CausalVesselVAE, seeded_init_
    from causalvae_tpu_torch.models.vit import ViTVAE
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.serve.engine import BatchingEngine
    from causalvae_tpu_torch.train import checkpoints as PC
    from causalvae_tpu_torch.train import port_maps as PP
    from causalvae_tpu_torch.train import workloads as W
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn

    adam, cfg = port["ClippedAdam"], port["VesselConfig"]()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_c7_")
    by_part = {}
    t_phase = time.perf_counter()

    @contextlib.contextmanager
    def part(tag: str, want: dict):
        for c in counters.values():
            c.reset()  # this part's path starts here
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        launches = {name: c.read() for name, c in counters.items()}  # and ends here
        log(f"[{tag}] {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}")
        _expect_counts(tag, launches, want)
        by_part[tag] = launches

    def save(name: str, state: dict) -> str:
        path = os.path.join(tmp, name)
        torch.save({"model_state_dict": state}, path)
        return path

    seeded = seeded_init_(CausalVesselVAE(grid_hw=C7_GRID, device="cpu"), 18).state_dict()

    def c7(dev, packed=False, dtype=torch.float32):
        """C7 on ``dev`` with the seeded weights (drawn once: the same in
        every form and dtype)."""
        model = CausalVesselVAE(grid_hw=C7_GRID, packed=packed, dtype=dtype, device=dev)
        model.load_state_dict(seeded)
        return model

    try:
        # (a) a reference-layout C7 checkpoint
        ref = seeded_mirror()
        path = save("c7_reference.pt", ref.state_dict())
        t0 = time.perf_counter()
        state = PC.load_torch_checkpoint(path)
        model = CausalVesselVAE(grid_hw=C7_GRID, device="cuda")
        sd, skipped = PP.port_vessel_cnn_checkpoint(model, state, C7_GRID)
        model.load_state_dict(sd, strict=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[c7-load] reference C7 (RefVesselVAE, {n_params} parameters) "
            f"{os.path.getsize(path)} bytes: load_torch_checkpoint + port_vessel_cnn_checkpoint "
            f"+ load_state_dict on the card in {load_s:.2f} s; skipped {skipped}")
        if skipped:
            raise AssertionError(f"port_vessel_cnn_checkpoint skipped {skipped}")
        model.eval()
        ref = ref.cuda().eval()
        ref64 = copy.deepcopy(ref).double()
        b2 = {k: v.cuda() for k, v in bench_batch(2, VESSEL_HW, 18).items()}
        z = torch.from_numpy(np.random.default_rng(18).standard_normal(
            (2, cfg.z_dim)).astype(np.float32)).cuda()

        def outputs(mdl, nchw, dt):
            x, m, t = (b2[k].to(dt) for k in ("x", "m", "t"))
            mu, logvar = mdl.encode(x.permute(0, 3, 1, 2) if nchw else x, m, t)
            rec = mdl.decode(m, z.to(dt))
            return {"mu": mu, "logvar": logvar, "m": mdl.predict_m(t),
                    "recon": rec.permute(0, 2, 3, 1) if nchw else rec}

        packed_model = CausalVesselVAE(grid_hw=C7_GRID, packed=True, device="cuda")
        packed_model.load_state_dict(sd, strict=True)
        packed_model.eval()
        with part("c7-vs-mirror", {}), torch.no_grad():
            want = outputs(ref, True, torch.float32)
            want64 = outputs(ref64, True, torch.float64)
            got = {False: outputs(model, False, torch.float32),
                   True: outputs(packed_model, False, torch.float32)}
        for k, w in want.items():
            ref_max = float(w.abs().max())
            for packed, g in got.items():
                err = max_err(g[k], w)
                log(f"[c7-vs-mirror] packed={packed} {k}: max|d| {err:.3e} of max|ref| "
                    f"{ref_max:.4g} (tol {C7_MIRROR_TOL:.0e} of it); against the mirror in "
                    f"float64: port {float((g[k].double() - want64[k]).abs().max()):.3e}, "
                    f"mirror {float((w.double() - want64[k]).abs().max()):.3e}")
                check(f"C7 packed={packed} {k} against the reference mirror", err,
                      C7_MIRROR_TOL * ref_max)
        del ref, ref64, packed_model

        # (b) served
        eps = vae_endpoints(model)
        if sorted(eps) != ["decode", "do_t", "encode", "predict_m", "reconstruct",
                           "uncertainty"]:
            raise AssertionError(f"C7 endpoints {sorted(eps)}")
        rng = np.random.default_rng(19)

        def args(name, b):
            x = (rng.random((b, *VESSEL_HW, 1)) > 0.85).astype(np.float32)
            m = rng.standard_normal((b, cfg.m_dim)).astype(np.float32)
            t = np.eye(cfg.t_dim, dtype=np.float32)[rng.integers(0, cfg.t_dim, b)]
            zz = rng.standard_normal((b, cfg.z_dim)).astype(np.float32)
            return {"decode": (m, zz), "predict_m": (t,), "uncertainty": (t,)}.get(
                name, (x, m, t))

        lat = {}
        with part("c7-serve", {}):
            engine = BatchingEngine(eps, buckets=C7_SERVE_BUCKETS)
            try:
                for b in C7_SERVE_BUCKETS:
                    a = args("reconstruct", b)
                    out = engine.infer("reconstruct", *a)
                    if np.asarray(out).shape != (b, *VESSEL_HW, 1) or not np.isfinite(out).all():
                        raise AssertionError(f"C7 reconstruct bucket {b}: {np.asarray(out).shape}")
                    ts = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        engine.infer("reconstruct", *a)
                        ts.append((time.perf_counter() - t0) * 1e3)
                    lat[b] = statistics.median(ts)
                for name in sorted(eps):
                    outs = engine.infer(name, *args(name, 3))
                    outs = outs if isinstance(outs, tuple) else (outs,)
                    if not all(np.isfinite(np.asarray(o)).all() for o in outs):
                        raise AssertionError(f"C7 {name}: non-finite")
                stats = dict(engine.stats)
            finally:
                engine.close()
        log(f"[c7-serve] BatchingEngine over {sorted(eps)}; reconstruct latency (host clock, "
            f"median of 5) " + ", ".join(f"bucket {b} {v:.2f} ms" for b, v in lat.items())
            + f" ({smi}); engine stats {json.dumps(stats)}")
        del model, eps
        torch.cuda.empty_cache()

        # (c) trained
        batch = {k: v.cuda() for k, v in bench_batch(C7_BATCH, VESSEL_HW, 0).items()}
        runs = (("c7-train", False, torch.float32, C7_STEPS),
                ("c7-train-packed", True, torch.float32, C7_SHORT_STEPS),
                ("c7-train-bf16", False, torch.bfloat16, C7_SHORT_STEPS))
        for tag, packed, dtype, steps in runs:
            torch.cuda.reset_peak_memory_stats()
            model = c7("cuda", packed, dtype)
            opt = adam(model.parameters(), cfg.lr, cfg.grad_clip_norm,
                       mu_dtype=getattr(torch, cfg.adam_mu_dtype))
            step = make_vae_step(model, vessel_loss_fn(cfg), opt)
            gen = torch.Generator().manual_seed(0)
            losses, times = [], []
            want = with_dtype(PER_STEP_C7, dtype == torch.bfloat16)
            with part(tag, {n: steps * v for n, v in want.items()}):
                for _ in range(steps):
                    t0 = time.perf_counter()
                    losses.append(float(step(batch, generator=gen)["loss"]))  # synchronises
                    times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            if not np.isfinite(losses).all() or (steps == C7_STEPS and not losses[-1] < losses[0]):
                raise AssertionError(f"{tag}: losses {losses}")
            alone = (time_step(lambda b_: step(b_, generator=gen), batch)
                     if tag == "c7-train" else "")
            log(f"[{tag}] CausalVesselVAE (C7; {sum(p.numel() for p in model.parameters())} "
                f"parameters) {VESSEL_HW}, packed={packed}, {str(dtype)[6:]}, batch {C7_BATCH}: "
                f"losses {[f'{v:.6g}' for v in losses]}; step on the host clock (synchronised) "
                f"median of steps 1-{steps - 1} {statistics.median(times[1:]):.2f} ms, first "
                f"{times[0]:.2f} ms; {alone}; peak {peak / 2**30:.3f} GiB ({peak} bytes; {smi})")
            del model, opt, step
            torch.cuda.empty_cache()

        b4 = bench_batch(C7_CHECK_BATCH, VESSEL_HW, 3)
        eps_c = torch.from_numpy(np.random.default_rng(20).standard_normal(
            (C7_CHECK_BATCH, cfg.z_dim)).astype(np.float32))
        t0 = time.perf_counter()

        def vessel_step(m_, o):
            return make_vae_step(m_, vessel_loss_fn(cfg), o)

        tail = ("dec_out.", "morph.")
        got = {dev: _step_on(dev, c7, vessel_step, adam, b4, eps_c, names=tail)
               for dev in ("cuda", "cpu")}
        _hold_step("c7-step-vs-cpu", got, C7_TERMS_REL, C7_GRAD_TOL)
        packed_card = _step_on("cuda", lambda dev: c7(dev, packed=True), vessel_step, adam, b4,
                               eps_c, names=tail)
        _hold_step("c7-packed-step-vs-cpu", {"cuda": packed_card, "cpu": got["cpu"]},
                   C7_TERMS_REL, C7_GRAD_TOL)
        log(f"[c7-step-vs-cpu] one step at batch {C7_CHECK_BATCH}, spatial on the card and "
            f"the CPU, packed on the card, in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        state = PC.load_torch_checkpoint(path)
        skip = tuple(f"enc_convs.{i}.bias" for i in range(7)) + ("enc_fc1.bias",)
        for seed in C7_KLD_SEEDS:
            for (_, packed), (rel, leaves) in c7_kld_vs_f64(state, C7_BATCH, seed).items():
                tag = f"c7-kld-vs-f64 packed={packed} seed {seed}"
                log(f"[{tag}] kld against float64 rel {rel:.3e} (tol {C7_TERMS_REL:.0e}); "
                    "not held (0 up to rounding): " + ", ".join(
                        f"{n} max|d| {leaves[n][0]:.3e} (max|ref| {leaves[n][1]:.3e})"
                        for n in skip))
                check(f"{tag} kld", abs(rel), C7_TERMS_REL)
                held = {n: e / r for n, (e, r) in leaves.items() if n not in skip}
                log(f"[{tag}] {len(held)} gradient leaves held, of max|ref| (tol "
                    f"{C7_ENC_GRAD_TOL:.0e} for {C7_ENC_CONV}, else {C7_GRAD_TOL:.0e}): "
                    + ", ".join(f"{n} {v:.3e}" for n, v in
                                sorted(held.items(), key=lambda kv: -kv[1])))
                for n, v in held.items():
                    check(f"{tag} grad {n}", v, C7_ENC_GRAD_TOL if n.startswith(C7_ENC_CONV)
                          else C7_GRAD_TOL)
        log(f"[c7-kld-vs-f64] batch {C7_BATCH}, seeds {C7_KLD_SEEDS}, both forms, in "
            f"{time.perf_counter() - t0:.1f} s")
        del state

        # (d) the ViT converters at full size: C9 from a reference-layout file
        vit, hw = port["vessel_model"](device="cuda", seed=None)
        target = vit.state_dict()
        maps = PP.causal_vitvae_name_maps(depth=cfg.vit_depth, embed_dim=cfg.vit_embed_dim,
                                          grid_hw=VIT_REF_GRID)
        heads = {"weight": (cfg.vit_latent_dim, cfg.vit_embed_dim), "bias": (cfg.vit_latent_dim,)}
        shapes = {k: target[k].shape if k in target else heads[k.rsplit(".", 1)[1]]
                  for k in {**maps[0], **maps[1]}}
        src = seeded_reference_state(maps, shapes, 1802)
        path = save("c9_reference.pt", src)
        t0 = time.perf_counter()
        state = PC.load_torch_checkpoint(path)
        sd, skipped = PP.port_vitvae_checkpoint(vit, state, causal=True, depth=cfg.vit_depth,
                                                embed_dim=cfg.vit_embed_dim,
                                                grid_hw=VIT_REF_GRID)
        vit.load_state_dict(sd, strict=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in vit.parameters())
        absent = {k for k in maps[0] if k.startswith(("backbone.fc_mu.", "backbone.fc_var."))}
        if {k for k, _ in skipped} != absent or {r for _, r in skipped} != {"not-instantiated"}:
            raise AssertionError(f"port_vitvae_checkpoint (C9) skipped {skipped}")
        loaded = vit.state_dict()
        for k, (rk, conv) in {**maps[0], **maps[1]}.items():
            if k in loaded and not torch.equal(loaded[k].cpu(), conv(src[rk])):
                raise AssertionError(f"C9 {k}: not the converted reference entry {rk}")
        log(f"[c9-load] a reference-layout C9 state dict at the {VIT_REF_GRID} grid "
            f"({n_params} parameters), {os.path.getsize(path)} bytes: loaded into "
            f"vessel_model() on the card in {load_s:.2f} s; skipped {skipped}; every entry "
            f"equal to its converted source")
        rec = vae_endpoints(vit)["reconstruct"]
        with part("c9-reconstruct", {"attention_fwd": cfg.vit_depth}), torch.inference_mode():
            out = rec(*(torch.from_numpy(a).cuda() for a in args("reconstruct", 1)))
        if out.shape != (1, *hw, 1) or not torch.isfinite(out).all():
            raise AssertionError(f"C9 reconstruct: {tuple(out.shape)}")
        del vit, target, src, state, sd, loaded, rec
        torch.cuda.empty_cache()

        # the latent translator's ViTVAE from a ViTVAE-layout file at 24x40
        maps = PP.vitvae_name_maps(depth=cfg.vit_depth, embed_dim=cfg.vit_embed_dim,
                                   dec_res_stages=4, grid_hw=VIT_REF_GRID)
        big = ViTVAE(img_size=tuple(32 * g for g in VIT_REF_GRID), dec_res_stages=4,
                     device="cuda")
        src = seeded_reference_state(maps, {k: v.shape for k, v in big.state_dict().items()},
                                     1803)
        del big
        path = save("vitvae_reference.pt", src)
        vit = ViTVAE(img_size=TRANSLATOR_HW, dec_res_stages=4, device="cuda")
        t0 = time.perf_counter()
        state = PC.load_torch_checkpoint(path)
        sd, skipped = PP.port_vitvae_checkpoint(vit, state, depth=cfg.vit_depth,
                                                embed_dim=cfg.vit_embed_dim, dec_res_stages=4,
                                                src_grid=VIT_REF_GRID,
                                                dst_grid=VIT_TRANSLATOR_GRID)
        vit.load_state_dict(sd, strict=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if [(k, r.split(" ")[0]) for k, r in skipped] != [("decoder_input.weight", "shape"),
                                                          ("decoder_input.bias", "shape")]:
            raise AssertionError(f"port_vitvae_checkpoint (translator) skipped {skipped}")
        pos = vit.pos_embedding.detach().cpu()
        pos_cpu = PC.interpolate_pos_embedding(src["pos_embedding"], VIT_REF_GRID,
                                               VIT_TRANSLATOR_GRID)
        if pos.shape != (1, 241, cfg.vit_embed_dim) or not torch.equal(pos, pos_cpu):
            raise AssertionError(f"the resized positional embedding {tuple(pos.shape)} is not "
                                 f"the CPU resize of the file's {tuple(pos_cpu.shape)}")
        log(f"[translator-load] a ViTVAE-layout state dict at {VIT_REF_GRID} "
            f"({os.path.getsize(path)} bytes) into the translator's ViTVAE at {TRANSLATOR_HW} "
            f"in {load_s:.2f} s: pos_embedding resized {VIT_REF_GRID} -> {VIT_TRANSLATOR_GRID}; "
            f"skipped {skipped}")
        x8 = torch.from_numpy(np.random.default_rng(21).random(
            (8, *TRANSLATOR_HW, 1), dtype=np.float32))
        with part("translator-latents", {"attention_fwd": cfg.vit_depth}):
            zl = W.extract_vit_latents(vit, [{"x": x8}])
        if zl.shape != (8, 512) or not np.isfinite(zl).all():
            raise AssertionError(f"extract_vit_latents: {zl.shape}")
        del vit, src, state, sd
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[vessel-cnn] phase 18 {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {name: sum(r[name] for r in by_part.values()) for name in counters}


# --------------------------------------------------------------------------
# phase 19: the analysis modules and data parallelism. The flagship C9 at its
# published widths, seeded; C1 at MnistConfig's on synthetic_mnist(2048).
# --------------------------------------------------------------------------

LATENT_N = 64           # (a): C9 latents of synthetic vessel images
LATENT_CHUNK = 32       # encode_corpus chunk: 6 attention launches a chunk
STUDY_LATENT_N = 2048   # (a): C1 latents of synthetic_mnist(2048, 42)
TSNE_CHECK_N = 256      # (a): t-SNE card against CPU on the first 256 latents
TSNE_MOVES = 2          # (a): CPU runs from the init moved by 1e-6 relative
TSNE_KL_REL = 0.02      # (a): the card's final KL within 2% of the CPU runs' range
TSNE_TRUST_TOL = 0.01   # (a): trustworthiness (k = 5), card against CPU
PCA_REL = 1e-5          # (a): PCA card against CPU, of max|ref|
CLF_FEAT_TOL = 1e-4     # (a): classifier features card against CPU, of max|ref|
DP_STEPS = 3            # (e): steps of the 2 x 4 mesh step at dropout 0
DP_SEED = 19
DP_TERMS_REL = 1e-5     # (e): the first step's loss terms, mesh against one process
DP_SPREAD_X = 4.0       # (e): parameters within 4x the one-process step's largest spread
PER_STEP_DP = {"attention_fwd": 6, "attention_bwd": 6, "bn_stats": 18, "bn_bwd": 18,
               "elbo_terms": 1, "elbo_terms_bwd": 1}
DP_JOIN_S = 300         # (e): a rank that has not reported by then fails the phase
# (e) C10 (CausalBioVAE, train_cascade's model and optimizer) at the cascade's
# 512x960, batch 4 as 2 x 2 in the same two ranks, DP_STEPS steps of
# cascade_loss: the mechanism's PlainBatchNorm sums its statistics over the
# ranks; held as the flagship (first-step terms DP_TERMS_REL, later terms and
# parameters DP_SPREAD_X x the one-process step's spread under permuted rows)
DP_C10 = dict(m_dim=12, t_dim=19, z_dim=64)
DP_C10_HW, DP_C10_BATCH, DP_C10_LR = (512, 960), 4, 1e-3


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8 of an 8-bit PNG with filter-0 rows."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, ctype = head
    ch = {0: 1, 2: 3}[ctype]
    img = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)[:, 1:]
    return img.reshape(h, w, ch)[..., 0] if ch == 1 else img.reshape(h, w, ch)


def trustworthiness(x: np.ndarray, emb: np.ndarray, k: int = 5) -> float:
    """sklearn ``manifold.trustworthiness(x, emb, n_neighbors=k)`` in numpy:
    1 - 2 / (n k (2n - 3k - 1)) * sum over each point's k nearest in the
    embedding of (its rank among the input's neighbours - k), where above k."""
    x = np.asarray(x, np.float64)
    e = np.asarray(emb, np.float64)
    n = len(x)
    dx = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(dx, np.inf)
    order = np.argsort(dx, axis=1)
    rank = np.empty((n, n), np.int64)
    rank[np.arange(n)[:, None], order] = np.arange(1, n + 1)[None, :]
    de = ((e[:, None, :] - e[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(de, np.inf)
    near = np.argsort(de, axis=1)[:, :k]
    r = rank[np.arange(n)[:, None], near] - k
    return float(1.0 - (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))) * r[r > 0].sum())


def _dp_rank(rank: int, world: int, port_num: int, spec: dict, results):
    """One rank of phase 19 (e), a process of its own on the card: the
    flagship's spatial f32 step on its 4 rows of the batch of 8 through
    ``make_vae_step(mesh=...)`` over a gloo group of ``world`` ranks."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port_num))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from causalvae_tpu_torch.config import VesselConfig
        from causalvae_tpu_torch.models.vit import MultiHeadAttention, vessel_model
        from causalvae_tpu_torch.ops.kernels import attention, batchnorm, elbo
        from causalvae_tpu_torch.parallel.mesh import (all_reduce_sum, make_mesh, replicate,
                                                       shard_batch)
        from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
        from causalvae_tpu_torch.train.state import ClippedAdam

        mesh = make_mesh(world, backend="gloo", device="cuda:0")
        cfg = VesselConfig()
        counters = {"attention_fwd": (attention, "LAUNCHES"),
                    "attention_bwd": (attention, "BWD_LAUNCHES"),
                    "bn_stats": (batchnorm, "STATS_LAUNCHES"),
                    "bn_bwd": (batchnorm, "BWD_LAUNCHES"),
                    "elbo_terms": (elbo, "LAUNCHES"), "elbo_terms_bwd": (elbo, "BWD_LAUNCHES")}
        state0 = torch.load(spec["state0"])
        data = torch.load(spec["batch"])
        grads1 = torch.load(spec["grads1"])
        model, _ = vessel_model(seed=None, dropout=0.0)
        model.load_state_dict(state0)
        replicate(model, mesh)
        local = shard_batch({k: data[k] for k in ("x", "m", "t")}, mesh)
        eps = shard_batch(data["eps"], mesh)
        step = make_vae_step(model, vessel_loss_fn(cfg),
                             ClippedAdam(model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                         torch.bfloat16), mesh=mesh)
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        metrics, step_ms, grad_errs = [], [], None
        for _ in range(spec["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(local, eps=eps)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in met.items()})
            if grad_errs is None:  # the whole batch's gradient, after the all-reduce
                grad_errs = {n: float((p.grad - grads1[n].cuda()).abs().max())
                             for n, p in model.named_parameters()}
        del grads1
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        ref = torch.load(spec["ref"])
        errs = {k: float((v.float() - ref[k].cuda().float()).abs().max())
                for k, v in model.state_dict().items()}
        buffers = {k: v.cpu().numpy() for k, v in model.named_buffers()}  # no tensors in the queue
        import hashlib

        digest = hashlib.sha1(b"".join(p.detach().cpu().numpy().tobytes()
                                       for p in model.parameters())).hexdigest()
        # the flagship's dropout (0.1): one step from the same weights, the
        # noise and masks drawn from the seeds the one-process step used
        model.load_state_dict(state0)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.dropout = spec["dropout"]
            elif isinstance(m, torch.nn.Dropout):
                m.p = spec["dropout"]
        step = make_vae_step(model, vessel_loss_fn(cfg),
                             ClippedAdam(model.parameters(), cfg.lr, cfg.grad_clip_norm,
                                         torch.bfloat16), mesh=mesh)
        torch.manual_seed(spec["seed"])
        met = step(local, generator=torch.Generator().manual_seed(spec["seed"]))
        dropped = {k: float(v) for k, v in met.items()}
        launches_all = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        # the step's one gradient all-reduce, alone: 131.7 M floats through gloo
        buf = torch.ones(sum(p.numel() for p in model.parameters()), device=mesh.device)
        reduce_ms, numel = [], buf.numel()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_sum(buf, mesh)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        del model, step, buf
        torch.cuda.empty_cache()
        c10 = _dp_c10(spec["c10"], mesh, counters)
        torch.distributed.destroy_process_group()
        results.put((rank, dict(metrics=metrics, step_ms=step_ms, grad_errs=grad_errs,
                                launches=launches,
                                launches_all=launches_all, peak=peak, errs=errs,
                                buffers=buffers, digest=digest, dropped=dropped,
                                reduce_ms=reduce_ms, numel=numel, c10=c10)))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def dp_c10_reference(tmp: str) -> tuple:
    """Phase 19 (e)'s C10 case in this process: seeded C10 at DP_C10_HW, a
    batch of DP_C10_BATCH with its noise, DP_STEPS one-process steps (the
    reference the ranks are held to), and the same steps on the batch's rows
    reversed and shuffled (the spread the reordered sums give). Returns
    (the ranks' spec, the reference record)."""
    from causalvae_tpu_torch.models.vae import CausalBioVAE, seeded_init_

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = seeded_init_(CausalBioVAE(**DP_C10, device="cuda"), DP_SEED)
    state0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(DP_SEED)
    b = DP_C10_BATCH
    batch = {"x": torch.from_numpy(rng.standard_normal((b, *DP_C10_HW, 1)).astype(np.float32)),
             "m": torch.from_numpy(rng.random((b, DP_C10["m_dim"]), dtype=np.float32)),
             "t": torch.from_numpy(rng.integers(0, DP_C10["t_dim"], b).astype(np.int32)),
             "eps": torch.from_numpy(rng.standard_normal((b, DP_C10["z_dim"])).astype(
                 np.float32))}

    def one_process(rows=None):
        model.load_state_dict(state0)
        step = _c10_step(model)
        bb = {k: (v if rows is None else v[rows]).cuda() for k, v in batch.items()}
        metrics = [{k: float(v) for k, v in step(bb, eps=bb["eps"]).items()}
                   for _ in range(DP_STEPS)]
        return metrics, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    ref_metrics, ref_state = one_process()
    spread, metric_spread = {}, {}
    for rows in (torch.arange(b - 1, -1, -1),
                 torch.from_numpy(np.random.default_rng(4).permutation(b))):
        p_metrics, p_state = one_process(rows)
        for k, v in ref_state.items():
            spread[k] = max(spread.get(k, 0.0), float((p_state[k].float() - v.float()).abs().max()))
        for s_, met in enumerate(p_metrics):
            for k, v in met.items():
                metric_spread[s_, k] = max(metric_spread.get((s_, k), 0.0),
                                           abs(v - ref_metrics[s_][k]))
    paths = {name: os.path.join(tmp, f"c10_{name}.pt") for name in ("state0", "ref", "batch")}
    torch.save(state0, paths["state0"])
    torch.save(ref_state, paths["ref"])
    torch.save(batch, paths["batch"])
    del model
    torch.cuda.empty_cache()
    return (dict(paths, steps=DP_STEPS),
            dict(metrics=ref_metrics, spread=spread, metric_spread=metric_spread,
                 seconds=time.perf_counter() - t0))


def dp_c10_check(ref: dict, r0: dict, r1: dict, smi: str):
    """The ranks' C10 steps against the one-process steps: no kernel
    launched (C10 runs none), the first step's terms within DP_TERMS_REL,
    the later ones and every state entry within DP_SPREAD_X times the
    permuted-rows spread, the mechanism's running statistics and the
    metrics equal on both ranks."""
    for r in (r0, r1):
        _expect_counts("data-parallel C10 rank", r["launches"], {})
    if r0["metrics"] != r1["metrics"]:
        raise AssertionError(f"C10: the ranks' metrics differ: {r0['metrics']}, {r1['metrics']}")
    if sorted(r0["buffers"]) != ["mechanism.shared_bn.0.mean", "mechanism.shared_bn.0.var"]:
        raise AssertionError(f"C10 buffers {sorted(r0['buffers'])}")
    for k, v in r0["buffers"].items():
        if not np.array_equal(v, r1["buffers"][k]):
            raise AssertionError(f"C10: the running statistics {k} differ between the ranks")
    for k, v in ref["metrics"][0].items():
        check(f"data-parallel C10 step 1 {k}", abs(r0["metrics"][0][k] - v),
              DP_TERMS_REL * abs(v))
    for s in range(1, DP_STEPS):
        for k, v in ref["metrics"][s].items():
            check(f"data-parallel C10 step {s + 1} {k}", abs(r0["metrics"][s][k] - v),
                  DP_SPREAD_X * ref["metric_spread"][s, k] + DP_TERMS_REL * abs(v))
    max_spread = max(ref["spread"].values())
    for k, e in r0["errs"].items():
        check(f"data-parallel C10 {k} after {DP_STEPS} steps", e, DP_SPREAD_X * max_spread)
    log(f"[data-parallel] C10 at {DP_C10_HW[0]}x{DP_C10_HW[1]}, batch {DP_C10_BATCH} as 2 x "
        f"{DP_C10_BATCH // 2} (gloo, the same two ranks), {DP_STEPS} steps of cascade_loss: "
        f"terms {json.dumps(r0['metrics'])} vs one process {json.dumps(ref['metrics'])}; "
        f"state after the steps max|mesh - one| {max(r0['errs'].values()):.3e}, max|permuted - "
        f"one| {max_spread:.3e}; the mechanism's running statistics bit-equal on both ranks; "
        f"0 launches ({smi})")
    log(f"[time] data-parallel C10 {ref['seconds'] + r0['seconds']:.1f} s (one-process "
        f"reference {ref['seconds']:.1f} s, rank 0's part {r0['seconds']:.1f} s)")


def _c10_step(model, mesh=None):
    """``make_vae_step`` of C10 as ``train_cascade`` builds it (cascade_loss,
    plain Adam at DP_C10_LR), over ``mesh`` where given."""
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.train.loop import make_vae_step
    from causalvae_tpu_torch.train.state import ClippedAdam

    return make_vae_step(model, lambda out, b: L.cascade_loss(out, b["x"], b["m"]),
                         ClippedAdam(model.parameters(), DP_C10_LR, None, torch.float32),
                         mesh=mesh)


def _dp_c10(spec: dict, mesh, counters: dict) -> dict:
    """A rank's C10 part of phase 19 (e): ``spec["steps"]`` mesh steps of
    C10 from ``spec["state0"]`` on this rank's rows of ``spec["batch"]``
    with its noise; the launches of every counter, the metrics, each
    state entry's max|d| from ``spec["ref"]`` (the one-process steps), the
    buffers (the mechanism's running statistics) and the seconds."""
    from causalvae_tpu_torch.models.vae import CausalBioVAE
    from causalvae_tpu_torch.parallel.mesh import replicate, shard_batch

    t0 = time.perf_counter()
    model = CausalBioVAE(**DP_C10, device=mesh.device)
    model.load_state_dict(torch.load(spec["state0"]))
    replicate(model, mesh)
    data = torch.load(spec["batch"])
    local = shard_batch({k: data[k] for k in ("x", "m", "t")}, mesh)
    eps = shard_batch(data["eps"], mesh)
    step = _c10_step(model, mesh)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    metrics = [{k: float(v) for k, v in step(local, eps=eps).items()}
               for _ in range(spec["steps"])]
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    ref = torch.load(spec["ref"])
    errs = {k: float((v.float() - ref[k].cuda().float()).abs().max())
            for k, v in model.state_dict().items()}
    return dict(metrics=metrics, launches=launches, errs=errs,
                buffers={k: v.cpu().numpy() for k, v in model.named_buffers()},
                seconds=time.perf_counter() - t0)


def phase_analysis_parallel(port, counters, smi: str) -> tuple:
    """Phase 19: the analysis modules and data parallelism on the card, every
    kernel counter zeroed before each part and read after it; returns the
    launches of the analysis parts and of the data-parallel ones.

    (a) Latent diagnostics: the flagship C9, seeded, on ``LATENT_N``
    synthetic vessel images through ``encode_corpus`` in chunks of
    ``LATENT_CHUNK`` (6 attention launches a chunk, none of any other
    kernel); C1 at MnistConfig's widths on ``synthetic_mnist(2048, 42)``
    (the device morphology's m): ``encode_corpus``, then on the card
    ``pca_embedding``, ``exact_tsne`` (perplexity 30, timed),
    ``probe_fold_accuracies``, ``real_vs_fake_embedding`` of a seeded
    ``SimpleClassifier`` (real images against the C1 decodes) and
    ``centroid_outliers``, each against the port's own CPU run on the same
    inputs: PCA within ``PCA_REL``, the probe's fold accuracies equal, the
    classifier's features within ``CLF_FEAT_TOL``, the outliers equal;
    t-SNE on the first ``TSNE_CHECK_N`` latents from the shared
    initialisation: the final KL within ``TSNE_KL_REL`` of the range of the
    CPU's runs (the init and ``TSNE_MOVES`` moves of it by 1e-6: the
    descent is chaotic), trustworthiness (k = 5, ``trustworthiness`` here)
    within ``TSNE_TRUST_TOL``; at N = 2048 the card's trustworthiness at
    least the PCA embedding's. (b) The vessel report at full width:
    ``m_influence_check`` on C9 at batch 4 (6 attention launches, the
    abduction's); ``discriminative_feature_ensemble`` over
    ``predictions_by_treatment``'s per-sample m_mu of the ``LATENT_N``
    images; ``full_report_vs_baseline`` and ``reliability_gate`` from
    ``ensemble_sigma_by_treatment`` of two seeded members (0 launches);
    ``fix_csv_names`` on a pairwise CSV written here. (c) The eight charts,
    each PNG's size from the chart's layout and its marks read back.
    (d) ``profile_trace`` around one C9 ``reconstruct`` at bucket 1: the
    trace names ``cvae::attention_fwd``. (e) Two ranks on the one card
    (gloo; spawned processes, the kernels built in phase 2): the flagship's
    spatial f32 step (TF32 off, the vessel loss, clip 5.0, the bf16 first
    moment) at the global batch of 8 as 2 x 4 through ``make_vae_step(mesh=
    ...)``, ``DP_STEPS`` steps at dropout 0 from the same weights and noise
    as the one-process batch-8 step: the first step's loss terms within
    ``DP_TERMS_REL``; the one-process step against itself with the batch's
    rows permuted (reversed, shuffled: the same sums in other orders) gives
    each quantity's spread, and the first step's gradients (each leaf) and
    the later steps' loss terms are held within ``DP_SPREAD_X`` times their
    own spread, every parameter after the last step within ``DP_SPREAD_X``
    times the largest parameter spread (Adam moves a leaf by up to lr a
    step on rounding alone, whichever leaf the rounding lands on); the
    BatchNorm running statistics and the parameters bit-equal on the two
    ranks; ``PER_STEP_DP`` launches a step a rank; then one step at the
    flagship's dropout 0.1 from the same seeds as a one-process step: the
    loss terms within ``DP_TERMS_REL`` (the masks and noise are the whole
    batch's); the step time a rank, the 131.7 M-float all-reduce through
    gloo, each rank's peak. (f) NCCL: one rank, ``make_mesh()`` (a group of
    one), one ``make_shard_map_step`` step of the flagship at batch 4."""
    import contextlib
    import copy

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from causalvae_tpu_torch.analysis import latent_viz as LV
    from causalvae_tpu_torch.analysis import plots as PL
    from causalvae_tpu_torch.analysis import vessel_report as VR
    from causalvae_tpu_torch.config import MnistConfig
    from causalvae_tpu_torch.data import mnist as DM
    from causalvae_tpu_torch.models.heads import SimpleClassifier
    from causalvae_tpu_torch.models.vae import CausalConvVAE, seeded_init_
    from causalvae_tpu_torch.models.vit import MultiHeadAttention
    from causalvae_tpu_torch.parallel.mesh import free_port, make_mesh, shard_batch
    from causalvae_tpu_torch.parallel.shard_step import make_shard_map_step
    from causalvae_tpu_torch.scm.uncertainty import ensemble_sigma_by_treatment
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.utils.metrics import profile_trace, write_csv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = port["VesselConfig"]()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p19_")
    analysis, dp = {}, {}
    t_phase = time.perf_counter()

    @contextlib.contextmanager
    def part(tag: str, want: dict, into: dict):
        for c in counters.values():
            c.reset()  # this part's path starts here
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        launches = {name: c.read() for name, c in counters.items()}  # and ends here
        log(f"[{tag}] {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}")
        _expect_counts(tag, launches, want)
        into[tag] = launches

    try:
        # (a) latent diagnostics: C9 at full width
        c9, hw = port["vessel_model"](seed=DP_SEED)
        vb = bench_batch(LATENT_N, hw, 7)
        x9, m9, t9 = (vb[k].numpy() for k in ("x", "m", "t"))
        chunks = -(-LATENT_N // LATENT_CHUNK)
        with part("latent-c9", {"attention_fwd": cfg.vit_depth * chunks}, analysis):
            t0 = time.perf_counter()
            z9 = LV.encode_corpus(c9, x9, m9, t9, batch_size=LATENT_CHUNK)
            c9_s = time.perf_counter() - t0
        if z9.shape != (LATENT_N, cfg.z_dim) or not np.isfinite(z9).all():
            raise AssertionError(f"C9 encode_corpus: {z9.shape}")
        log(f"[latent-c9] encode_corpus of {LATENT_N} images at {hw} in chunks of "
            f"{LATENT_CHUNK}: {c9_s:.2f} s")

        # C1 at MnistConfig's widths on synthetic_mnist(2048, 42)
        mcfg = MnistConfig()
        images, labels = DM.synthetic_mnist(STUDY_LATENT_N, seed=42)
        ds = DM.build_morph_mnist(images, labels, use_device_extractor=True)
        c1 = seeded_init_(CausalConvVAE(device="cuda"), 7)
        clf = {dev: seeded_init_(SimpleClassifier(device=dev), 8) for dev in ("cuda", "cpu")}
        with part("latent-c1", {}, analysis):
            z1 = LV.encode_corpus(c1, ds.x, ds.m, ds.t, batch_size=512)
            with torch.no_grad():
                fake = c1.decode(torch.from_numpy(ds.m[:512]).cuda(),
                                 torch.from_numpy(z1[:512]).cuda()).cpu().numpy()
            t0 = time.perf_counter()
            emb, ratio = LV.pca_embedding(z1, device="cuda")
            pca_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tsne = LV.exact_tsne(z1, 30.0, device="cuda")
            tsne_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            folds = LV.probe_fold_accuracies(z1, labels, device="cuda")
            probe_s = time.perf_counter() - t0
            real_f, fake_f = LV.real_vs_fake_embedding(clf["cuda"], ds.x[:512], fake)
        if z1.shape != (STUDY_LATENT_N, mcfg.z_dim) or not np.isfinite(z1).all():
            raise AssertionError(f"C1 encode_corpus: {z1.shape}")
        emb_cpu, ratio_cpu = LV.pca_embedding(z1, device="cpu")
        check("pca card against CPU", float(np.abs(emb - emb_cpu).max()),
              PCA_REL * float(np.abs(emb_cpu).max()))
        check("pca ratios card against CPU", float(np.abs(ratio - ratio_cpu).max()), 1e-6)
        folds_cpu = LV.probe_fold_accuracies(z1, labels, device="cpu")
        if folds != folds_cpu:
            raise AssertionError(f"probe folds: card {folds}, CPU {folds_cpu}")
        real_c, fake_c = LV.real_vs_fake_embedding(clf["cpu"], ds.x[:512], fake)
        for name, got, want in (("real", real_f, real_c), ("fake", fake_f, fake_c)):
            check(f"classifier features ({name}) card against CPU",
                  float(np.abs(got - want).max()), CLF_FEAT_TOL * float(np.abs(want).max()))
        outliers = LV.centroid_outliers(real_f, labels[:512], top_k=8)
        outliers_cpu = LV.centroid_outliers(real_c, labels[:512], top_k=8)
        if any(not np.array_equal(outliers[c], outliers_cpu[c]) for c in outliers_cpu):
            raise AssertionError("centroid_outliers differ between card and CPU features")
        if tsne.embedding.shape != (STUDY_LATENT_N, 2) or not np.isfinite(tsne.kl_divergence):
            raise AssertionError(f"exact_tsne at {STUDY_LATENT_N}: {tsne.embedding.shape}, "
                                 f"KL {tsne.kl_divergence}")
        trust_tsne = trustworthiness(z1, tsne.embedding)
        trust_pca = trustworthiness(z1, emb)
        if not trust_tsne >= trust_pca:
            raise AssertionError(f"t-SNE trustworthiness {trust_tsne:.4f} below PCA's "
                                 f"{trust_pca:.4f}")
        zs = z1[:TSNE_CHECK_N]
        init = LV.tsne_init(zs)
        t0 = time.perf_counter()
        card = LV.exact_tsne(zs, 30.0, device="cuda", init=init)
        small_card_s = time.perf_counter() - t0
        cpu_runs, cpu_s = [], []
        for k in range(TSNE_MOVES + 1):
            moved = init if k == 0 else (init * (1 + 1e-6 * np.random.default_rng(k)
                                                 .standard_normal(init.shape))).astype(np.float32)
            t0 = time.perf_counter()
            cpu_runs.append(LV.exact_tsne(zs, 30.0, device="cpu", init=moved))
            cpu_s.append(time.perf_counter() - t0)
        kls = [r.kl_divergence for r in cpu_runs]
        lo, hi = (1 - TSNE_KL_REL) * min(kls), (1 + TSNE_KL_REL) * max(kls)
        if not lo <= card.kl_divergence <= hi:
            raise AssertionError(f"t-SNE KL at N={TSNE_CHECK_N}: card {card.kl_divergence:.5f} "
                                 f"outside [{lo:.5f}, {hi:.5f}] (CPU runs {kls})")
        trust_card = trustworthiness(zs, card.embedding)
        trust_cpu = trustworthiness(zs, cpu_runs[0].embedding)
        check("t-SNE trustworthiness card against CPU", abs(trust_card - trust_cpu),
              TSNE_TRUST_TOL)
        log(f"[latent-c1] z {z1.shape}; pca {pca_s:.3f} s, ratios {ratio.tolist()}; exact "
            f"t-SNE at N={STUDY_LATENT_N} on the card {tsne_s:.2f} s ({tsne.n_iter + 1} "
            f"iterations), KL {tsne.kl_divergence:.5f}, trustworthiness {trust_tsne:.4f} "
            f"(PCA {trust_pca:.4f}); at N={TSNE_CHECK_N}: card {small_card_s:.2f} s KL "
            f"{card.kl_divergence:.5f} trust {trust_card:.4f}, CPU {[f'{s:.2f}' for s in cpu_s]} "
            f"s KL {[f'{k:.5f}' for k in kls]} trust {trust_cpu:.4f}; probe folds {folds} "
            f"({probe_s:.2f} s), equal on the CPU; classifier features and outliers equal "
            f"({smi})")

        # (b) the vessel report at full width
        with part("m-influence", {"attention_fwd": cfg.vit_depth}, analysis):
            infl = VR.m_influence_check(c9, x9[:4], m9[:4], t9[:4])
        if infl["verdict"] != "OK" or not np.isfinite(infl["m_to_z_weight_ratio"]):
            raise AssertionError(f"m_influence_check: {infl}")
        t_idx = np.random.default_rng(5).integers(0, 4, LATENT_N)  # four seeded groups
        groups = [f"g{g}" for g in range(4)]
        feats = [f"m{f}" for f in range(cfg.m_dim)]
        batch_rows = 16
        with part("vessel-report", {"attention_fwd": cfg.vit_depth * -(-LATENT_N // batch_rows)},
                  analysis):
            preds = VR.predictions_by_treatment(c9, x9, m9, t9, t_idx, groups, feats,
                                             batch_size=batch_rows)
            t0 = time.perf_counter()
            ens = VR.discriminative_feature_ensemble(preds["per_sample_mu"], t_idx, feats)
            ens_s = time.perf_counter() - t0
            member2 = copy.deepcopy(c9)  # a second member: its own seeded mechanism
            seeded_init_(member2.morph, DP_SEED + 1)
            with torch.no_grad():
                mu, sigma = ensemble_sigma_by_treatment(torch.nn.ModuleList([c9, member2]),
                                                        cfg.t_dim)
            mu, sigma = mu.cpu().numpy(), sigma.cpu().numpy()
        del member2
        if sorted(ens["consensus_ranking"]) != sorted(feats):
            raise AssertionError(f"consensus ranking {ens['consensus_ranking']}")
        rows = VR.full_report_vs_baseline(mu, sigma, 0, [f"t{g}" for g in range(cfg.t_dim)],
                                          feats)
        gate = VR.reliability_gate(np.ones_like(sigma) * 0.5, sigma,
                                   [f"t{g}" for g in range(cfg.t_dim)], feats)
        if (len(rows) != (cfg.t_dim - 1) * cfg.m_dim or len(gate) != cfg.t_dim * cfg.m_dim
                or not all(np.isfinite(r["score"]) for r in rows)
                or {r["category"] for r in gate} - {"reliable", "marginal", "unreliable"}):
            raise AssertionError(f"report rows {len(rows)}, gate rows {len(gate)}")
        pair_csv = os.path.join(tmp, "all_pairwise_report.csv")
        write_csv(pair_csv, [{"Treatment_From": a, "Treatment_To": b, "Feature": f,
                              "SNR": float(r)} for a in range(3) for b in range(3) if a != b
                             for f, r in zip(feats[:2], (1.5, 0.5))])
        fixed = VR.fix_csv_names(pair_csv, groups)
        text = open(pair_csv).read()
        if fixed != 24 or "g2,g1" not in text or VR.fix_csv_names(pair_csv, groups) != 0:
            raise AssertionError(f"fix_csv_names: {fixed} cells;\n{text}")
        log(f"[vessel-report] m_influence_check (C9, batch 4): {json.dumps(infl)}; "
            f"predictions_by_treatment of {LATENT_N} images; the ensemble in {ens_s:.2f} s: "
            f"{ens['consensus_ranking'][:4]}...; full_report_vs_baseline {len(rows)} rows, "
            f"reliability_gate {len(gate)} rows; fix_csv_names rewrote {fixed} cells")

        # (c) the eight charts
        with part("charts", {}, analysis):
            t0 = time.perf_counter()
            pngs = {}
            mus = preds["per_sample_mu"]
            by_group = {g: mus[t_idx == i] for i, g in enumerate(groups)}
            real_by_group = {g: m9[t_idx == i, 0] for i, g in enumerate(groups)}
            imp = ens["rf_importance"]

            def chart(name, fn, *args, **kw):
                pngs[name] = os.path.join(tmp, f"{name}.png")
                fn(*args, pngs[name], **kw)

            chart("heatmap", PL.heatmap, sigma)
            chart("ranked_bar", PL.ranked_bar, imp)
            f_max = max(ens["anova_f"].values()) or 1.0
            chart("phase_bars", PL.phase_comparison_bars, {
                "features": feats, "phase1_norm": {f: imp[f] / max(imp.values()) for f in feats},
                "phase2_norm": {f: ens["anova_f"][f] / f_max for f in feats},
                "rank_correlation": 0.0})
            chart("scatter", PL.scatter_diag, sigma.ravel(), np.ones(sigma.size) * 0.5,
                  xlabel="sigma", ylabel="r2", hline=0.6)
            chart("embedding", PL.embedding_scatter, tsne.embedding, labels,
                  highlight_idx=np.concatenate(list(outliers.values())))
            chart("broken", PL.predictions_broken_axis, {g: v[:, 0] for g, v in by_group.items()})
            chart("grid", PL.per_feature_prediction_grid, by_group, feats)
            chart("overlap", PL.overlap_distributions, real_by_group,
                  {g: v[:, 0] for g, v in by_group.items()})
            charts_s = time.perf_counter() - t0
        M, S, H_ = PL.MARGIN, PL.SLOT, PL.PLOT_H
        n_rows = -(-cfg.m_dim // 4)
        grid_w = len(groups) * S
        want_shape = {
            "heatmap": (2 * M + cfg.t_dim * PL.CELL, 2 * M + cfg.m_dim * PL.CELL),
            "ranked_bar": (2 * M + H_, 2 * M + cfg.m_dim * S),
            "phase_bars": (2 * M + H_, 2 * M + cfg.m_dim * S),
            "scatter": (2 * M + H_, 2 * M + PL.SCATTER_W),
            "embedding": (2 * M + PL.SCATTER_W, 2 * M + PL.SCATTER_W),
            "grid": (M + n_rows * (PL.GRID_PANEL_H + M), M + 4 * (grid_w + M)),
            "overlap": (2 * M + H_, 2 * M + len(groups) * S)}
        broken = PL.broken_axis_split(mus[:, 0]) is not None
        want_shape["broken"] = ((3 * M + PL.BROKEN_TOP_H * 4) if broken else (2 * M + H_),
                                2 * M + len(groups) * S)
        marks = {"heatmap": PL.colormap("viridis", 1.0)[()], "ranked_bar": PL.BAR,
                 "phase_bars": PL.TAB10[1], "scatter": PL.RED, "embedding": PL.TAB10[0],
                 "broken": PL.BLACK, "grid": PL.TAB10[0], "overlap": PL.BOX_PRED}
        for name, path in pngs.items():
            img = read_png(path)
            if img.shape != want_shape[name] + (3,):
                raise AssertionError(f"{name}.png is {img.shape}, expected {want_shape[name]}")
            if not np.all(img == np.asarray(marks[name], np.uint8), axis=-1).any():
                raise AssertionError(f"{name}.png has no mark of colour {marks[name]}")
        log(f"[charts] eight PNGs in {charts_s:.2f} s: " + ", ".join(
            f"{n} {read_png(p).shape[1]}x{read_png(p).shape[0]}" for n, p in pngs.items()))

        # (d) profile_trace around one reconstruct at bucket 1
        endpoints = vae_endpoints(c9)
        x1, m1, t1 = (torch.from_numpy(a[:1]).cuda() for a in (x9, m9, t9))
        endpoints["reconstruct"](x1, m1, t1)  # warm
        trace_dir = os.path.join(tmp, "trace")
        with part("profile-trace", {"attention_fwd": cfg.vit_depth}, analysis):
            with profile_trace(trace_dir):
                endpoints["reconstruct"](x1, m1, t1)
                torch.cuda.synchronize()
        (trace,) = os.listdir(trace_dir)
        trace_path = os.path.join(trace_dir, trace)
        if "cvae::attention_fwd" not in open(trace_path).read():
            raise AssertionError(f"{trace} does not name cvae::attention_fwd")
        log(f"[profile-trace] {trace}: {os.path.getsize(trace_path)} bytes, names "
            "cvae::attention_fwd")
        del endpoints, c1, clf, ds, images

        # (e) two ranks on the one card
        step_batch = {k: v for k, v in bench_batch(TRAIN_BATCH, hw, 0).items()}
        step_batch["eps"] = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (TRAIN_BATCH, cfg.z_dim)).astype(np.float32))
        state0 = {k: v.detach().cpu().clone() for k, v in c9.state_dict().items()}
        perm = torch.from_numpy(np.random.default_rng(4).permutation(TRAIN_BATCH))

        def one_process(rows=None, steps=DP_STEPS, dropout=0.0, seed=None):
            c9.load_state_dict(state0)
            for mod in c9.modules():
                if isinstance(mod, MultiHeadAttention):
                    mod.dropout = dropout
                elif isinstance(mod, torch.nn.Dropout):
                    mod.p = dropout
            step = port["make_vae_step"](c9, port["vessel_loss_fn"](cfg), port["ClippedAdam"](
                c9.parameters(), cfg.lr, cfg.grad_clip_norm, torch.bfloat16))
            b = {k: (v if rows is None else v[rows]).cuda() for k, v in step_batch.items()}
            out, ms, grads = [], [], None
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if seed is None:
                    met = step(b, eps=b["eps"])
                else:
                    torch.manual_seed(seed)
                    met = step(b, generator=torch.Generator().manual_seed(seed))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                out.append({k: float(v) for k, v in met.items()})
                if grads is None:
                    grads = {n: p.grad.detach().cpu() for n, p in c9.named_parameters()}
            return out, ms, {k: v.detach().cpu() for k, v in c9.state_dict().items()}, grads

        ref_metrics, ref_ms, ref_state, ref_grads = one_process()
        perms = [torch.arange(TRAIN_BATCH - 1, -1, -1), perm]  # rows reversed, shuffled
        spread, metric_spread, grad_spread = {}, {}, {}
        for rows in perms:
            p_metrics, _, p_state, p_grads = one_process(rows)
            for k, v in ref_state.items():
                spread[k] = max(spread.get(k, 0.0),
                                float((p_state[k].float() - v.float()).abs().max()))
            for n, g in ref_grads.items():
                grad_spread[n] = max(grad_spread.get(n, 0.0), float((p_grads[n] - g).abs().max()))
            for s_, met in enumerate(p_metrics):
                for k, v in met.items():
                    metric_spread[s_, k] = max(metric_spread.get((s_, k), 0.0),
                                               abs(v - ref_metrics[s_][k]))
            del p_state, p_grads
        dropped_ref, _, _, _ = one_process(steps=1, dropout=TRAIN_RATE, seed=DP_SEED)
        state_path, ref_path = os.path.join(tmp, "state0.pt"), os.path.join(tmp, "ref.pt")
        grads_path = os.path.join(tmp, "grads1.pt")
        torch.save(state0, state_path)
        torch.save(ref_state, ref_path)
        torch.save(ref_grads, grads_path)
        torch.save(step_batch, os.path.join(tmp, "batch.pt"))
        c9.load_state_dict(state0)
        del ref_state
        torch.cuda.empty_cache()
        c10_spec, c10_ref = dp_c10_reference(tmp)
        spec = dict(state0=state_path, ref=ref_path, grads1=grads_path,
                    batch=os.path.join(tmp, "batch.pt"), steps=DP_STEPS, dropout=TRAIN_RATE,
                    seed=DP_SEED, c10=c10_spec)
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        port_num = free_port()
        procs = [ctx.Process(target=_dp_rank, args=(r, 2, port_num, spec, results), daemon=True)
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                r, out = results.get(timeout=DP_JOIN_S)
                if isinstance(out, str):
                    raise AssertionError(f"data-parallel rank {r} failed:\n{out}")
                got[r] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        dp_s = time.perf_counter() - t0
        r0, r1 = got[0], got[1]
        want = {k: v * DP_STEPS for k, v in PER_STEP_DP.items()}
        for r in (r0, r1):
            _expect_counts("data-parallel rank", r["launches"], want)
            _expect_counts("data-parallel rank with dropout", r["launches_all"],
                           {k: v * (DP_STEPS + 1) for k, v in PER_STEP_DP.items()})
        if r0["digest"] != r1["digest"]:
            raise AssertionError("the two ranks' parameters differ")
        for k, v in r0["buffers"].items():
            if not np.array_equal(v, r1["buffers"][k]):
                raise AssertionError(f"BatchNorm statistics {k} differ between the ranks")
        for k, v in ref_metrics[0].items():
            check(f"data-parallel step 1 {k}", abs(r0["metrics"][0][k] - v), DP_TERMS_REL * abs(v))
        for s in range(1, DP_STEPS):
            for k, v in ref_metrics[s].items():
                check(f"data-parallel step {s + 1} {k}", abs(r0["metrics"][s][k] - v),
                      DP_SPREAD_X * metric_spread[s, k] + DP_TERMS_REL * abs(v))
        grad_ratio = max(e / max(grad_spread[n], 1e-30) for n, e in r0["grad_errs"].items())
        for n, e in r0["grad_errs"].items():
            check(f"data-parallel step-1 gradient {n}", e,
                  DP_SPREAD_X * grad_spread[n] + 1e-6 * float(ref_grads[n].abs().max()))
        # Adam turns rounding-sized gradient differences into moves of up to
        # lr a step, whichever leaf they land on: the reordered sums' largest
        # move over all leaves is the yardstick, not each leaf's own draw
        max_spread = max(spread.values())
        ratios = sorted(((r0["errs"][k] / max(spread[k], 1e-12), k) for k in spread),
                        reverse=True)
        worst = ratios[0][0]
        log(f"[data-parallel] parameters after {DP_STEPS} steps: max|mesh - one| "
            f"{max(r0['errs'].values()):.3e}, max|permuted - one| {max_spread:.3e}; "
            f"{sum(r0['errs'][k] <= spread[k] for k in spread)} of {len(spread)} leaves "
            f"within their own permuted spread; the largest ratios: " + "; ".join(
                f"{k} {r0['errs'][k]:.3e} / {spread[k]:.3e}" for _, k in ratios[:4]))
        for k, e in r0["errs"].items():
            check(f"data-parallel {k} after {DP_STEPS} steps", e, DP_SPREAD_X * max_spread)
        for k, v in dropped_ref[0].items():
            check(f"data-parallel dropout step {k}", abs(r0["dropped"][k] - v),
                  DP_TERMS_REL * abs(v))
        dp["data-parallel"] = r0["launches_all"]
        log(f"[data-parallel] 2 ranks (gloo) on one card, batch {TRAIN_BATCH} as 2 x "
            f"{TRAIN_BATCH // 2}, {DP_STEPS} steps at dropout 0 + 1 at {TRAIN_RATE}, in "
            f"{dp_s:.1f} s with start-up: step ms rank 0 {[f'{x:.1f}' for x in r0['step_ms']]}, "
            f"rank 1 {[f'{x:.1f}' for x in r1['step_ms']]} (one process, batch 8: "
            f"{[f'{x:.1f}' for x in ref_ms]}); all-reduce of {r0['numel']} floats "
            f"{[f'{x:.1f}' for x in r0['reduce_ms']]} ms; peak rank 0 {r0['peak']} B, rank 1 "
            f"{r1['peak']} B; step-1 terms {json.dumps(r0['metrics'][0])} vs "
            f"{json.dumps(ref_metrics[0])}; step-1 gradients at worst {grad_ratio:.3f} x "
            f"their leaf's spread; parameters at worst {worst:.3f} x their leaf's "
            f"spread under permuted rows, within {DP_SPREAD_X} x the largest "
            f"({max_spread:.3e}); dropout step {json.dumps(r0['dropped'])} vs "
            f"{json.dumps(dropped_ref[0])}; ranks bit-equal ({smi})")

        dp_c10_check(c10_ref, r0["c10"], r1["c10"], smi)

        # (f) NCCL: a group of one
        with part("nccl", PER_STEP_DP, dp):
            mesh = make_mesh()
            if mesh.backend != "nccl" or mesh.size != 1:
                raise AssertionError(f"make_mesh(): {mesh}")
            c9.load_state_dict(state0)
            opt = port["ClippedAdam"](c9.parameters(), cfg.lr, cfg.grad_clip_norm,
                                      torch.bfloat16)
            loss = port["vessel_loss_fn"](cfg)

            def loss_fn(model, b, generator):
                model.train()
                return loss(model(b["x"], b["m"], b["t"], generator=generator), b)[0]

            nccl_loss = make_shard_map_step(loss_fn, mesh)(
                c9, opt, shard_batch({k: step_batch[k][:4] for k in ("x", "m", "t")}, mesh),
                torch.Generator().manual_seed(1))
            dist.destroy_process_group()
        if not np.isfinite(float(nccl_loss)):
            raise AssertionError(f"NCCL step loss {float(nccl_loss)}")
        log(f"[nccl] make_mesh() -> NCCL, world size 1; one make_shard_map_step step of the "
            f"flagship at batch 4: loss {float(nccl_loss):.2f}")
        del c9, opt
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[analysis-parallel] phase 19 {time.perf_counter() - t_phase:.1f} s ({smi})")

    def total(parts):
        return {name: sum(r[name] for r in parts.values()) for name in counters}

    return total(analysis), {name: sum(r.get(name, 0) for r in dp.values())
                             for name in counters}


# phase 20: the scanned trainer (train/scan_loop.py), S steps a CUDA-graph
# replay: C1 at MnistConfig's widths, batch 128, S = 8 over 19 steps (two
# groups and a ragged tail of 3); the flagship at batch 8, S = 4 over 5 steps
# (a group and a tail of 1) spatial f32 and bf16, one
# group packed-fused f32; then the CLI's train vessel --scan-steps 4 (resumed
# eagerly) and train mnist --scan-steps 8
SCAN_MNIST = (8, 19)
SCAN_VESSEL = (4, 5)
SCAN_PACKED = (4, 4)
SCAN_REMAT = (4, 5)  # the flagship bf16 with remat_blocks: a group and a tail of 1
# the flagship at 4, 2 and 1 heads of embed 256 (head dims 64, 128, 256), f32
# and bf16: S = 2 over 2 steps (4 until the deep plan's cases came), not
# profiled; timed at 2 and 1 heads (the large-D forward's head dims in bf16),
# not at 4; then served once at bucket 8
SCAN_HEADS = (2, 2)
HEAD_WIDTHS = (4, 2, 1)
# the flagship at embed 512 and one head (head dim 512: the deep attention
# plan; in bf16 the large-D forward), f32 and bf16, as the head counts above;
# served at bucket 8
DEEP_EMBED = 512
SCAN_TIMED_ROUNDS = 1  # timing: eager, graphed, graphed, eager groups, once
SCAN_BC_STEPS = 20000  # ClippedAdam's bias corrections, card against CPU, counts 1..


def _scan_batches(kind: str, n: int, img_hw=None, packed_io=False) -> list:
    """``n`` distinct batches made on the card from a seeded generator there:
    the vessel's as bench.py's (x = U[0,1) > 0.9, m ~ N(0, 1), one-hot t
    over 19; packed with space_to_depth_n(x, 3) for ``packed_io``), MNIST's
    uniform images, N(0, 1) morphology and one-hot digits."""
    from causalvae_tpu_torch.ops.subpixel import space_to_depth_n

    g = torch.Generator(device="cuda").manual_seed(20)
    shape, m_dim, t_dim = ((TRAIN_BATCH, *img_hw, 1), 12, 19) if kind == "vessel" else \
        ((128, 28, 28, 1), 12, 10)
    out = []
    for _ in range(n):
        x = torch.rand(shape, generator=g, device="cuda")
        if kind == "vessel":
            x = (x > 0.9).float()
            if packed_io:
                x = space_to_depth_n(x, 3)
        t = torch.randint(0, t_dim, (shape[0],), generator=g, device="cuda")
        out.append({"x": x, "m": torch.randn((shape[0], m_dim), generator=g, device="cuda"),
                    "t": F.one_hot(t, t_dim).float()})
    return out


def _device_busy_ms(prof) -> float:
    """Sum of the kernels' device time in a profile (annotations apart)."""
    busy = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.key.startswith(
                ("Optimizer.", "ProfilerStep")):
            continue
        busy += e.self_device_time_total / 1e3
    return busy


class deterministic:
    """cuDNN's deterministic algorithms and torch's (``index_add_``, the
    backward of the packed stems' lifted-kernel gather, sorts instead of
    adding atomically), TF32 off, within the block."""

    def __enter__(self):
        self.before = (torch.backends.cudnn.deterministic,
                       torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.before[0]
        torch.use_deterministic_algorithms(self.before[1], warn_only=self.before[2])
        return False


def _state_diff(tag: str, want, states) -> list:
    """The state entries (parameters, buffers, optimizer moments) that differ
    from ``want``, with max|d| and max|ref|, for the log."""
    out = []
    for (sd, moments), (m, o) in zip(want, states):
        got = m.state_dict()
        for k, v in sd.items():
            if not torch.equal(v, got[k]):
                out.append((k, float((v.float() - got[k].float()).abs().max()),
                            float(v.float().abs().max())))
        for i, ((mu, nu), st) in enumerate(zip(moments, o.state.values())):
            for name, a, b in (("mu", mu, st["mu"]), ("nu", nu, st["nu"])):
                if not torch.equal(a, b):
                    out.append((f"moment {i} {name}", float((a.float() - b.float()).abs().max()),
                                float(a.float().abs().max())))
    if out:
        log(f"[scan] {tag}: {len(out)} state entries differ, the first: {out[:6]}")
    return out


def _scan_case(tag: str, build, batches: list, S: int, per_step: dict, counters, smi: str,
               ScanTrainer, profiled: bool = True, timed: bool = True) -> dict:
    """One model of phase 20. ``build(models=None)`` -> (states, step) from
    the same seeded start (given models: a fresh optimizer and step for
    them). Under ``deterministic``: (1) eager, the steps one by one from the
    start, generators seeded (the CPU one 0, torch's 0); (2) graphed, from
    the same start, ``ScanTrainer(step, S)`` over the same batches, every
    counter zeroed before and read after (the main path): the per-step
    launches times the steps plus the warm-up step, exactly; one replay a
    group; every step's metrics, the parameters, buffers and optimizer
    moments held to (1) bit for bit. Then with the card's default
    algorithms (as phase 6 runs): (3) a new trainer captured, a group eager
    and a group graphed in turns, per step on the host clock after a
    synchronise; (4) with ``profiled``, one eager group and one replay
    profiled: device busy and idle share. Returns the record."""
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    rec = {"S": S, "steps": n}
    parts, t_part = {}, time.perf_counter()
    with deterministic():
        # (1) eager from the start
        states, step = build()
        parts["build"] = time.perf_counter() - t_part
        start = [{k: v.clone() for k, v in m.state_dict().items()} for m, _ in states]
        torch.cuda.synchronize()
        rec["eager_resident_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        gen = torch.Generator().manual_seed(0)
        torch.manual_seed(0)
        eager = []
        t0 = time.perf_counter()
        for b in batches:
            eager.append({k: v.detach().clone() for k, v in step(b, generator=gen).items()})
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        _expect_counts(f"{tag} eager", {k: c.read() for k, c in counters.items()},
                       {k: v * n for k, v in per_step.items()})
        rec["eager_peak_bytes"] = torch.cuda.max_memory_allocated()
        want = [({k: v.clone() for k, v in m.state_dict().items()},
                 [(st["mu"].clone(), st["nu"].clone()) for st in o.state.values()])
                for m, o in states]
        # (2) graphed from the same start
        for (m, _), sd in zip(states, start):
            m.load_state_dict(sd)
            m.zero_grad(set_to_none=True)
        states, step = build(models=[m for m, _ in states])
        del start
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        rec["resident_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()  # main path starts here
        gen = torch.Generator().manual_seed(0)
        torch.manual_seed(0)
        trainer = ScanTrainer(step, n_states=len(states), steps_per_dispatch=S)
        graphed, groups = [], 0
        t0 = time.perf_counter()
        for i in range(0, n, S):
            out = trainer.run_group(states, batches[i:i + S], gen)
            graphed += [{k: v[j].clone() for k, v in out.items()}
                        for j in range(len(out["loss"]))]
            groups += 1
        torch.cuda.synchronize()
        graphed_s = time.perf_counter() - t0
        parts["eager"], parts["graphed"] = eager_s, graphed_s
        launches = rec["launches"] = {k: c.read() for k, c in counters.items()}  # main path ends
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    _expect_counts(f"{tag} graphed", launches,
                   {k: v * (n + trainer.warmup_steps) for k, v in per_step.items()})
    replays = sum(p.replays for p in trainer.programs.values())
    if replays != groups or trainer.warmup_steps != 1:
        raise AssertionError(f"{tag}: {replays} replays for {groups} groups, "
                             f"{trainer.warmup_steps} warm-up steps")
    rec["capture_s"] = {size: p.capture_s for size, p in trainer.programs.items()}
    first_diff = next(((i, k, float(a[k]), float(b[k])) for i, (a, b) in
                       enumerate(zip(eager, graphed)) for k in a if not torch.equal(a[k], b[k])),
                      None)
    state_diff = _state_diff(tag, want, states)
    rec["bit_equal"] = first_diff is None and not state_diff
    log(f"[scan] {tag}: {n} steps, S = {S}: {groups} groups, {replays} replays, warm-up "
        f"{trainer.warmup_steps} step; capture s {json.dumps(rec['capture_s'])}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})} (every other counter 0); "
        f"eager {eager_s:.2f} s, graphed {graphed_s:.2f} s (warm-up and capture included); "
        f"peak {rec['peak_bytes'] / 2**30:.3f} GiB graphed ({rec['resident_bytes'] / 2**30:.3f}"
        f" resident before), {rec['eager_peak_bytes'] / 2**30:.3f} GiB eager "
        f"({rec['eager_resident_bytes'] / 2**30:.3f}); graphed against eager, every step's "
        f"metrics and the final state bit-equal: {rec['bit_equal']} (first differing metric "
        f"{first_diff}; {len(state_diff)} state entries differ)")
    log(f"[scan] {tag}: losses {[round(float(m['loss']), 4) for m in eager]}")
    del want, trainer
    if not rec["bit_equal"]:
        raise AssertionError(f"{tag}: the graphed steps are not the eager steps' bits "
                             f"(first {first_diff}, {len(state_diff)} state entries)")
    if not all(np.isfinite(float(m["loss"])) for m in graphed):
        raise AssertionError(f"{tag}: a loss is not finite")
    if not timed:
        log(f"[scan] {tag}: seconds by part "
            f"{json.dumps({k: round(v, 2) for k, v in parts.items()})}; not timed")
        del states, step
        torch.cuda.empty_cache()
        return rec
    # (3) timing in turns on full groups, the card's default algorithms
    t_part = time.perf_counter()
    group = batches[:S]
    trainer = ScanTrainer(step, n_states=len(states), steps_per_dispatch=S)
    trainer.run_group(states, group, gen)  # warm-up and capture
    rec["timed_capture_s"] = trainer.programs[S].capture_s
    times = {"eager": [], "graphed": []}

    def run(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "eager":
            for b in group:
                step(b, generator=gen)
        else:
            trainer.run_group(states, group, gen)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3 / S)

    run("eager")  # the default algorithms' first eager steps
    times["eager"].clear()
    for _ in range(SCAN_TIMED_ROUNDS):
        for kind in ("eager", "graphed", "graphed", "eager"):
            run(kind)
    rec["step_ms"] = {k: statistics.median(v) for k, v in times.items()}
    # (4) a group of each profiled (the card's activity only)
    parts["timing"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    for kind in ("eager", "graphed") if profiled else ():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(kind)
        wall = times[kind].pop() * S
        busy = _device_busy_ms(prof)
        if busy == 0.0:
            raise AssertionError(f"{tag}: the profile of a {kind} group holds no device time")
        rec[f"{kind}_busy_ms"] = busy / S
        rec[f"{kind}_idle"] = max(0.0, 1 - busy / wall)
        log(f"[scan] {tag}: profiled {kind} group of {S}: wall {wall / S:.3f} ms a step, "
            f"device busy {busy / S:.3f} ms a step, idle share {rec[f'{kind}_idle']:.3f}")
    parts["profile"] = time.perf_counter() - t_part
    log(f"[scan] {tag}: seconds by part {json.dumps({k: round(v, 2) for k, v in parts.items()})}")
    log(f"[scan] {tag}: step ms (host clock, median of {2 * SCAN_TIMED_ROUNDS} groups in "
        f"turns, the card's default algorithms; capture {rec['timed_capture_s']:.3f} s): "
        f"graphed {rec['step_ms']['graphed']:.3f}, eager {rec['step_ms']['eager']:.3f} "
        f"({json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})}; {smi})")
    del trainer, states, step
    torch.cuda.empty_cache()
    return rec


def check_bias_correction():
    """ClippedAdam's bias corrections 1 - b^t computed on the card (float64
    power rounded to float32) against the same on the CPU, t = 1..
    SCAN_BC_STEPS: equal bits expected (CUDA's float64 pow is within 1 ulp
    of float64, far inside float32's rounding)."""
    from causalvae_tpu_torch.train import state as S

    t = torch.arange(1, SCAN_BC_STEPS + 1, dtype=torch.int64)
    diff = {}
    for name, b in (("b1", S._B1_F32), ("b2", S._B2_F32)):
        cpu = 1 - torch.pow(b, t.double()).float()
        card = (1 - torch.pow(b, t.cuda().double()).float()).cpu()
        diff[name] = int((cpu != card).sum())
    log(f"[scan] ClippedAdam bias corrections card against CPU, t = 1..{SCAN_BC_STEPS}: "
        f"counts that differ {json.dumps(diff)}")
    if any(diff.values()):
        raise AssertionError(f"bias corrections differ on the card: {diff}")


def serve_at_heads(port, heads: int, counters, embed: int = 256) -> dict:
    """The seeded flagship at ``heads`` heads of ``embed`` (f32, eval) served
    through ``BatchingEngine`` at bucket 8: one reconstruct of 8 images
    after a warm call, every counter zeroed before and read after (6
    attention forwards, nothing else), the output finite NHWC float32.
    Returns the launches."""
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.serve.engine import BatchingEngine

    cfg = port["VesselConfig"](vit_heads=heads, vit_embed_dim=embed)
    model, (h, w) = port["vessel_model"](device="cuda", seed=0, cfg=cfg)
    rng = np.random.default_rng(heads)
    args = ((rng.random((8, h, w, 1)) > 0.85).astype(np.float32),
            rng.standard_normal((8, model.m_dim)).astype(np.float32),
            np.eye(model.t_dim, dtype=np.float32)[rng.integers(0, model.t_dim, 8)])
    engine = BatchingEngine(vae_endpoints(model), buckets=(8,))
    try:
        engine.infer("reconstruct", *args)  # warm
        for c in counters.values():
            c.reset()  # main path starts here
        t0 = time.perf_counter()
        out = engine.infer("reconstruct", *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.read() for k, c in counters.items()}  # main path ends
    finally:
        engine.close()
    _expect_counts(f"serve heads {heads} embed {embed}", launches,
                   {"attention_fwd": cfg.vit_depth})
    if out.shape != (8, h, w, 1) or out.dtype != np.float32 or not np.isfinite(out).all():
        raise AssertionError(f"serve heads {heads} embed {embed}: {out.shape} {out.dtype}, "
                             f"finite {np.isfinite(out).all()}")
    log(f"[scan] served at {heads} heads of embed {embed} (head dim {embed // heads}), bucket 8: "
        f"reconstruct {ms:.2f} ms (host clock, one call after a warm one), launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, output finite {out.shape}")
    del model, engine
    torch.cuda.empty_cache()
    return launches


def phase_scan(port, counters, smi: str) -> dict:
    """Phase 20: the scanned trainer, S training steps a CUDA-graph replay
    (``train/scan_loop.py``). Cases (``_scan_case``: graphed against the same
    steps run eagerly from the same start, bit for bit; launches exact;
    timing in turns; busy and idle share; peak; capture seconds): C1 with
    its discriminator (0 launches of every kernel), the flagship spatial
    f32 and bf16, packed-fused f32, spatial bf16 with ``remat_blocks`` (12
    attention forwards a step), and spatial f32 and bf16 at 4, 2 and 1 heads
    (the wide attention plans) and f32 and bf16 at embed 512 and one head
    (head dim 512: the deep plan, 6 + 6 of its launches a step; in bf16 at
    2 and 1 heads and at embed 512 the forward's 6 are the large-D
    kernel's, counted apart); of the
    flagship's cases only spatial f32 is profiled; each f32 head count is
    served at bucket 8 (``serve_at_heads``). Then the CLI in a temporary directory:
    ``train vessel --scan-steps 4`` one epoch on the synthetic corpus at
    768x1280 (launches: the steps and one warm-up step, the val batches),
    resumed eagerly to a second epoch from its checkpoint, and ``train
    mnist --scan-steps 8`` three epochs of one group. Returns the launches
    of the graphed runs (the main path), and those of the embed-512 runs."""
    import shutil
    import tempfile

    from causalvae_tpu_torch.config import MnistConfig
    from causalvae_tpu_torch.models.heads import LatentDiscriminator
    from causalvae_tpu_torch.models.vae import CausalConvVAE, seeded_init_
    from causalvae_tpu_torch.train.loop import make_mnist_adversarial_step
    from causalvae_tpu_torch.train.scan_loop import ScanTrainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ClippedAdam = port["ClippedAdam"]
    check_bias_correction()
    records, by_run, deep_runs = {}, {}, []
    mcfg = MnistConfig()

    def build_mnist(models=None):
        if models is None:
            models = [seeded_init_(CausalConvVAE(m_dim=mcfg.m_dim, t_dim=mcfg.t_dim,
                                                 z_dim=mcfg.z_dim, device="cuda"), 0),
                      seeded_init_(LatentDiscriminator(t_dim=mcfg.t_dim, z_dim=mcfg.z_dim,
                                                       device="cuda"), 1)]
        vae, disc = models
        vopt = ClippedAdam(vae.parameters(), mcfg.lr, None, torch.float32)
        dopt = ClippedAdam(disc.parameters(), mcfg.lr, None, torch.float32)
        return ([(vae, vopt), (disc, dopt)],
                make_mnist_adversarial_step(vae, disc, vopt, dopt, mcfg))

    S, n = SCAN_MNIST
    t0 = time.perf_counter()
    records["mnist C1"] = _scan_case("mnist C1", build_mnist, _scan_batches("mnist", n), S,
                                     {}, counters, smi, ScanTrainer)
    by_run["mnist"] = records["mnist C1"]["launches"]
    log(f"[time] scan mnist {time.perf_counter() - t0:.1f} s")

    # the seeded weights by embed dim (the same in every formulation, dtype and head count)
    seeds = {}
    for tag, layout, dtype, (S, n), heads, embed in (
            ("vessel spatial f32", {}, "float32", SCAN_VESSEL, None, 256),
            ("vessel spatial bf16", {}, "bfloat16", SCAN_VESSEL, None, 256),
            ("vessel packed-fused f32", PACKED, "float32", SCAN_PACKED, None, 256),
            ("vessel spatial bf16 remat", {"remat_blocks": True}, "bfloat16", SCAN_REMAT,
             None, 256)) + tuple(
            (f"vessel spatial {tag} {h} heads", {}, dtype, SCAN_HEADS, h, 256)
            for h in HEAD_WIDTHS for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))
    ) + tuple((f"vessel spatial {tag} embed {DEEP_EMBED} 1 head", {}, dtype, SCAN_HEADS, 1,
               DEEP_EMBED) for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))):
        t0 = time.perf_counter()
        cfg = port["VesselConfig"](compute_dtype=dtype, vit_heads=heads or 8,
                                   vit_embed_dim=embed)
        seeded = seeds.setdefault(embed, {})

        def build_vessel(models=None, layout=layout, cfg=cfg, seeded=seeded, embed=embed):
            if models is None:
                # the embed-512 weights: torch's initialisation on the card, seeded
                # (the host's numpy draws of them took ~12 s)
                torch.manual_seed(0)
                model, _ = port["vessel_model"](
                    device="cuda", seed=None if seeded or embed == DEEP_EMBED else 0,
                    dropout=TRAIN_RATE, cfg=cfg, **layout)
                if seeded:
                    model.load_state_dict(seeded)
                else:
                    seeded.update({k: v.clone() for k, v in model.state_dict().items()})
            else:
                (model,) = models
            opt = ClippedAdam(model.parameters(), cfg.lr, cfg.grad_clip_norm,
                              mu_dtype=getattr(torch, cfg.adam_mu_dtype))
            return [(model, opt)], port["make_vae_step"](
                model, port["vessel_loss_fn"](cfg), opt)

        per_step = with_dtype(PER_STEP_REMAT if layout.get("remat_blocks") else
                              PER_STEP_PACKED if layout else PER_STEP, dtype == "bfloat16")
        if dtype == "bfloat16" and embed // cfg.vit_heads >= 128:  # the large-D forward
            per_step = dict(per_step, attention_fwd_large=per_step["attention_fwd"])
        batches = _scan_batches("vessel", n, VESSEL_HW, layout.get("packed_io", False))
        records[tag] = _scan_case(tag, build_vessel, batches, S, per_step, counters, smi,
                                  ScanTrainer, profiled=tag == "vessel spatial f32",
                                  timed=not heads or heads <= 2)
        by_run[tag] = records[tag]["launches"]
        del batches
        torch.cuda.empty_cache()
        log(f"[time] scan {tag} {time.perf_counter() - t0:.1f} s")
        if embed == DEEP_EMBED:
            deep_runs.append(tag)
        if heads and dtype == "float32":
            t0 = time.perf_counter()
            run = f"serve heads {heads} embed {embed}"
            by_run[run] = serve_at_heads(port, heads, counters, embed)
            if embed == DEEP_EMBED:
                deep_runs.append(run)
            log(f"[time] {run} {time.perf_counter() - t0:.1f} s")
    del seeds

    # the CLI: train vessel --scan-steps 4, resumed eagerly; train mnist --scan-steps 8
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < VESSEL_DISK:
            raise AssertionError(f"{free / 2**30:.1f} GiB free for checkpoints, "
                                 f"{VESSEL_DISK / 2**30:.0f} GiB needed")
        main, vessel = port["cli_main"], port["vessel"]
        corpus = vessel.synthetic_corpus(n=VESSEL_N, seed=0)
        steps = len(corpus.splits["train"]) * 4 // TRAIN_BATCH
        val = -(-len(corpus.splits["val"]) // TRAIN_BATCH)
        hw = ["--img-hw", str(VESSEL_HW[0]), str(VESSEL_HW[1])]
        for c in counters.values():
            c.reset()
        model, opt, lg = main(["--out", tmp, "--n-synthetic", str(VESSEL_N), "train",
                               "vessel", *hw, "--epochs", "1", "--scan-steps", "4"])
        torch.cuda.synchronize()
        launches = {k: c.read() for k, c in counters.items()}
        by_run["cli vessel"] = launches
        tr = lg.trainer
        want = {k: (steps + tr.warmup_steps) * PER_STEP.get(k, 0)
                + val * PER_VAL.get(k, 0) for k in counters}
        _expect_counts("scan cli vessel", launches, want)
        replays = {size: p.replays for size, p in tr.programs.items()}
        if sum(size * r for size, r in replays.items()) != steps:
            raise AssertionError(f"train vessel --scan-steps 4: replays {replays} for "
                                 f"{steps} steps")
        rec = lg.clock.records[0]
        log(f"[scan] train vessel --scan-steps 4, 1 epoch of {steps} steps ({replays} "
            f"replays by group size, capture s "
            f"{json.dumps({k: p.capture_s for k, p in tr.programs.items()})}) and {val} "
            f"val batches: {json.dumps({k: v for k, v in rec.items() if k != 'step_ms'})}"
            f"; group ms {[round(x, 1) for x in rec.get('step_ms', [])]}; launches "
            f"{json.dumps(launches)}")
        count = int(opt.state_dict()["param_groups"][0]["count"])
        del model, opt, lg, tr
        torch.cuda.empty_cache()
        for c in counters.values():
            c.reset()
        model, opt, lg = main(["--out", tmp, "--n-synthetic", str(VESSEL_N), "train",
                               "vessel", *hw, "--epochs", "2", "--resume"])
        torch.cuda.synchronize()
        launches = {k: c.read() for k, c in counters.items()}
        _expect_counts("scan cli vessel resumed eagerly", launches,
                       {k: steps * PER_STEP.get(k, 0) + val * PER_VAL.get(k, 0)
                        for k in counters})
        count2 = int(opt.state_dict()["param_groups"][0]["count"])
        losses = [v for r in lg.history for k, v in r.items() if k.endswith("loss")]
        log(f"[scan] resumed eagerly to epoch 2: Adam count {count} -> {count2}; "
            f"losses {losses}")
        if count != steps or count2 != 2 * steps or not all(np.isfinite(losses)):
            raise AssertionError(f"scan cli vessel: counts {count}, {count2}, "
                                 f"losses {losses}")
        del model, opt, lg
        torch.cuda.empty_cache()
        for c in counters.values():
            c.reset()
        out = main(["--out", tmp, "--n-synthetic", "1024", "train", "mnist", "--epochs",
                    "3", "--scan-steps", "8"])
        torch.cuda.synchronize()
        launches = {k: c.read() for k, c in counters.items()}
        _expect_counts("scan cli mnist", launches, {})
        lg = out[4]
        replays = {k: p.replays for k, p in lg.trainer.programs.items()}
        log(f"[scan] train mnist --scan-steps 8, 3 epochs of 8 steps: replays {replays}; "
            f"epochs (wall s, group ms on the device clock) "
            f"{[(round(r['wall_s'], 3), [round(x, 2) for x in r.get('step_ms', [])]) for r in lg.clock.records]}"
            f"; images/s {lg.history[-1].get('images_per_sec')} (StepTimer, from the 3rd group)")
        if replays != {8: 3} or [r["steps"] for r in lg.clock.records] != [8, 8, 8]:
            raise AssertionError(f"train mnist --scan-steps 8: replays {replays}, epochs "
                                 f"{lg.clock.records}")
        del out, lg
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[time] scan CLI {time.perf_counter() - t0:.1f} s")
    def busy(r, kind):
        if f"{kind}_busy_ms" not in r:
            return "not profiled"
        return f"busy {r[f'{kind}_busy_ms']:.3f}, idle {r[f'{kind}_idle']:.3f}"

    log(f"[scan] summary ({smi}): " + "; ".join(
        f"{k}: " + (f"graphed {r['step_ms']['graphed']:.3f} ms/step ({busy(r, 'graphed')}), "
                    f"eager {r['step_ms']['eager']:.3f} ({busy(r, 'eager')}), "
                    if "step_ms" in r else "not timed, ")
        + f"peak {r['peak_bytes'] / 2**30:.3f} / {r['eager_peak_bytes'] / 2**30:.3f} GiB, "
        f"capture {json.dumps({s: round(v, 2) for s, v in r['capture_s'].items()})} s"
        for k, r in records.items()))
    log(f"[scan] phase 20 {time.perf_counter() - t_phase:.1f} s ({smi})")
    deep = {name: sum(by_run[r].get(name, 0) for r in deep_runs) for name in counters}
    log(f"[scan] the deep attention plan's launches (embed {DEEP_EMBED}, one head: "
        f"{', '.join(deep_runs)}): {json.dumps({k: v for k, v in deep.items() if v})}")
    return ({name: sum(r.get(name, 0) for r in by_run.values()) for name in counters}, deep)


def seeded_once(vessel_model):
    """``vessel_model`` whose seeded weights are drawn once per seed and
    parameter shapes and loaded into every later model of that seed:
    ``seeded_init_`` draws the 131.7 M weights with numpy, ~4 s a model, and
    the copy kept on the host is the same weights (every formulation and
    dtype shares them; ``seed=None`` passes through)."""
    from causalvae_tpu_torch.models.vae import seeded_init_

    cache = {}

    def build(img_hw=None, device=None, seed=0, **kw):
        model, hw = vessel_model(img_hw, device, seed=None, **kw)
        if seed is None:
            return model, hw
        key = (seed, tuple((k, tuple(v.shape)) for k, v in model.state_dict().items()))
        if key not in cache:
            seeded_init_(model, seed)
            cache[key] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(cache[key])
        return model, hw

    return build


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
    port = dict(vessel_model=seeded_once(vessel_model), VesselConfig=VesselConfig,
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
                "stage_bwd_wgrad": Counter(stage, "WGRAD_LAUNCHES"),
                "attention_fwd_large": Counter(attention, "LARGE_LAUNCHES")}
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
        t0 = time.perf_counter()
        study_launches = phase_study(port, counters, smi)
        log(f"[time] MNIST study phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        workload5_launches = phase_translator_cascade(port, counters, smi)
        log(f"[time] translator and cascade phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c7_launches = phase_vessel_cnn(port, counters, smi)
        log(f"[time] C7 and reference checkpoints phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        analysis_launches, dp_launches = phase_analysis_parallel(port, counters, smi)
        log(f"[time] analysis and data-parallel phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scan_launches, deep_launches = phase_scan(port, counters, smi)
        log(f"[time] scanned trainer phase {time.perf_counter() - t0:.1f} s")
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
            "mnist": mnist_launches, "mnist_study": study_launches,
            "translator_cascade": workload5_launches, "vessel_cnn": c7_launches,
            "analysis": analysis_launches, "data_parallel": dp_launches,
            "scan": scan_launches}
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
    # the deep plan (head dims above 256; the same sources and counters): its
    # launches those of the embed-512 runs of phase 20 (the forward's less the
    # large-D kernel's, which takes the bf16 runs), its numbers phase 3's at the
    # flagship's batch 8, one head of embed 512
    for name in ("attention_fwd", "attention_bwd"):
        rec = recs[name]["deep_head_dims"][f"8x961x{DEEP_EMBED}"]
        tpu = sources[name][1]
        large = deep_launches["attention_fwd_large"] if name == "attention_fwd" else 0
        kernels.append({
            "name": f"{name}_deep", "route": "cuda",
            "source": f"causalvae_tpu_torch/csrc/{name}_deep.cu",
            "replaces": f"causalvae_tpu/ops/kernels/{tpu}",
            "launches": deep_launches[name] - large,
            "launches_bf16": deep_launches[BF16_TWINS[name]] - large,
            "shape": [8, 961, DEEP_EMBED],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "deep_head_dims": recs[name]["deep_head_dims"]})
    # the large-D forward (bf16 from a padded D of 128 on): its launches those of
    # phase 20's bf16 runs at 2 and 1 heads and at embed 512, its numbers phase
    # 3's at the flagship's batch 8, one head of embed 256, bf16, rate 0; its
    # f32 path's times beside them ("f32"; the plans f32 keeps are faster)
    rec = recs["attention_fwd"]["head_dims"]["8x961x256"]
    paths = {path: r.get("attention_fwd_large", 0) for path, r in runs.items()}
    timed = {**recs["attention_fwd"]["head_dims"], **recs["attention_fwd"]["deep_head_dims"]}
    kernels.append({
        "name": "attention_fwd_large", "route": "cuda",
        "source": "causalvae_tpu_torch/csrc/attention_fwd_large.cu",
        "replaces": f"causalvae_tpu/ops/kernels/{sources['attention_fwd'][1]}",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "shape": [8, 961, 256], "dtype": "bfloat16",
        "max_abs_err": rec["max_abs_err_bf16"], "ms": rec["ms_bf16"],
        "plain_ms": rec["plain_ms_bf16"], "library_ms": rec["library_ms_bf16"],
        "bound_ms": rec["bound_ms_bf16"], "bound_by": rec["bound_by_bf16"],
        "f32": {k: rec[k] for k in ("ms_large", "ms_large_dropout", "max_abs_err_large",
                                    "ms", "bound_ms")},
        "large_head_dims": {shape: {k: v for k, v in r.items() if "bf16" in k or "large" in k}
                            for shape, r in timed.items() if shape.split("x")[2] not in
                            ("64", "48")}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
