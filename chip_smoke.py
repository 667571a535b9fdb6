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
   read out and compared with the plain mask exactly; the BN kernels'
   channels-last entries; the stage forward and backward at the 14 shapes
   of the packed-fused step; times of each kernel, its plain version and
   the library call that computes the same function (where one exists),
   beside the least time the card could take (``bound_ms``);
4. the serving path: the full-width 768x1280 vessel CausalViTVAE with seeded
   weights on the card, served by ``BatchingEngine(vae_endpoints(...))`` to
   concurrent clients (every endpoint) and over HTTP; the attention launch
   counter is zeroed just before and read just after, and must show 6
   launches per encoder pass; then a ``torch.profiler`` breakdown of one
   bucket-8 reconstruct by kernel, with the device's idle share;
5. serving, card against CPU: encode and decode of one sample through the
   same seeded model on both (plain versions on the CPU), max|Δ| <= 1e-3
   max|ref| + 1e-6 with TF32 off;
6. the training path: the same model in train mode (dropout 0.1, f32, TF32
   off) takes six steps of ``make_vae_step`` with the clipped Adam of
   bench.py on bench.py's batch-8 batch; every launch counter is zeroed just
   before and read just after and must show, per step, 6 attention forward
   and 6 backward launches, 18 of each BN kernel and 1 ELBO launch; losses
   finite and falling; step time, peak memory and a profiled step;
7. training, card against CPU: from the same seeded weights, steps at
   batch 8, dropout off, the same injected noise, on both: with the vessel
   loss, the loss terms (rel 1e-4) and the gradients below the decoder's
   BatchNorm chain; with the KL term alone, the gradients of the attention
   blocks, the encoder adapter and the stem (1e-3 max|ref|);
8. the packed training path: the phase-packed model with ``packed_io`` and
   ``fused_stages`` (bench.py's flagship configuration plus the stage
   kernels) takes six steps as in phase 6 on the host-packed batch; counts
   zeroed before and read after: per step 14 stage forward and 14 stage
   backward launches, 6 + 6 attention, 18 bn_stats, 9 bn_bwd, 1 ELBO; losses
   finite and falling; step time, peak memory, a profiled step with the
   stage kernels' share; then, timing only, the same step with
   ``fused_stages=False`` (cuDNN convolutions in the packed layout);
9. packed-fused against spatial on the card (``phase_packed_check``): one
   eval forward and one step under each of phase 7's losses (the stem
   convs' gradients at their own, stated tolerance).

The second-to-last line of standard output is the card's name and power
limit, the line before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch
from torch.nn import functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
ATTN_SHAPES = [(64, 961, 32), (256, 961, 32), (6, 17, 32), (3, 241, 16)]
TIMED_SHAPE = (64, 961, 32)  # batch 8: B*H = 8*8, N = 961, D = 32
BWD_SHAPES = [(64, 961, 32), (6, 17, 32), (3, 241, 16)]
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
# per training step of the full model: 6 blocks; 16 four-dimensional BNs + 2
# adapter BNs; one loss; the spatial form has no stage
PER_STEP = {"attention_fwd": 6, "attention_bwd": 6, "bn_stats": 18, "bn_bwd": 18,
            "elbo_terms": 1, "stage_fwd": 0, "stage_bwd": 0}
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
# their statistics elementwise
PER_STEP_PACKED = {"attention_fwd": 6, "attention_bwd": 6, "bn_stats": 18, "bn_bwd": 9,
                   "elbo_terms": 1, "stage_fwd": 14, "stage_bwd": 14}
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
STAGE_RECORD = "dec_out"            # the JSON record's shape (the largest forward)
STAGE_LIBRARY = ("dec_out", "dec_ct[4]")  # shapes timed beside plain and library


def log(*args):
    print(*args, flush=True)


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


def attention_bound_ms(bh: int, n: int, d: int, dtype) -> tuple:
    """Forward: q, k, v read and o written once, plus the f32 lse, against
    4*BH*N*N*D flops."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return bound(4 * bh * n * d * elt + bh * n * 4, 4 * bh * n * n * d, dtype)


def attention_bwd_bound_ms(bh: int, n: int, d: int, dtype) -> tuple:
    """Backward: q, k, v, o, do and the f32 lse read, dq, dk, dv written,
    against 10*BH*N*N*D flops."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return bound(8 * bh * n * d * elt + bh * n * 4, 10 * bh * n * n * d, dtype)


def check(name: str, err: float, tol: float):
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err:.3e} > tol {tol:.3e}")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_attention_fwd(attention, gen, dev):
    """The forward kernel against attention_reference at rate 0 (serving) and
    at the training rate, f32 (TF32 off) and bf16; timed at (64, 961, 32)."""
    record = None
    for bh, n, d in ATTN_SHAPES:
        q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev) for _ in range(3))
        for rate in (0.0, TRAIN_RATE):
            o, lse = attention.attention_fwd(q, k, v, rate, 7)
            torch.cuda.synchronize()
            ro, rlse = attention.attention_reference(q, k, v, rate, 7)
            err, err_lse = max_err(o, ro), max_err(lse, rlse)
            tol = 2e-5 * float(ro.abs().max()) + 1e-6
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            ob, _ = attention.attention_fwd(qb, kb, vb, rate, 7)
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
                record = {"max_abs_err": err}
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in ((8, 961, 32), TIMED_SHAPE, (256, 961, 32)):
            q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev, dtype) for _ in range(3))
            q4, k4, v4 = (t.view(bh // 8, 8, n, d) for t in (q, k, v))
            ms = cuda_ms(lambda: attention.attention_fwd(q, k, v))
            plain = cuda_ms(lambda: attention.attention_reference(q, k, v))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            bnd, by = attention_bound_ms(bh, n, d, dtype)
            log(f"[kernels] attention_fwd {str(dtype)[6:]} {(bh, n, d)}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, library (SDPA) {lib:.4f} ms, bound {bnd:.4f} ms "
                f"({by}), kernel/bound {ms / bnd:.2f}")
            if dtype == torch.float32 and (bh, n, d) == TIMED_SHAPE:
                record.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                              bound_by=by)
                ms_drop = cuda_ms(lambda: attention.attention_fwd(q, k, v, TRAIN_RATE, 7))
                plain_drop = cuda_ms(
                    lambda: attention.attention_reference(q, k, v, TRAIN_RATE, 7), iters=5)
                log(f"[kernels] attention_fwd f32 {(bh, n, d)} rate {TRAIN_RATE} (training): "
                    f"kernel {ms_drop:.4f} ms, plain {plain_drop:.4f} ms")
                record.update(ms_dropout=ms_drop, plain_ms_dropout=plain_drop)
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
    training rate, f32 (max|d| <= 1e-4 max|ref| + 1e-6: sums over N in
    another order) and bf16 (against f32 on the bf16 values, 1e-2 max|ref| +
    1e-3: the outputs' bf16 rounding); timed at (64, 961, 32) f32, rate 0.1,
    beside SDPA's autograd backward."""
    record = None
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
                if (bh, n, d) == TIMED_SHAPE and dtype == torch.float32 and rate > 0:
                    record = {"max_abs_err": max(errs)}
                    ms = cuda_ms(lambda: attention.attention_bwd(q, k, v, o, lse, do, rate, 5))
                    plain = cuda_ms(lambda: attention.attention_bwd_reference(
                        q, k, v, o, lse, do, rate, 5), iters=5)
                    q4, k4, v4 = (t.view(bh // 8, 8, n, d).detach().requires_grad_(True)
                                  for t in (q, k, v))
                    out4 = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate)
                    do4 = do.view(bh // 8, 8, n, d)
                    lib = cuda_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                              retain_graph=True))
                    bnd, by = attention_bwd_bound_ms(bh, n, d, dtype)
                    log(f"[kernels] attention_bwd f32 {(bh, n, d)} rate {rate}: kernel "
                        f"{ms:.4f} ms, plain {plain:.4f} ms, library (SDPA autograd "
                        f"backward, dropout {rate}) {lib:.4f} ms, bound {bnd:.4f} ms ({by}), "
                        f"kernel/bound {ms / bnd:.2f}")
                    record.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                  bound_by=by)
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
    return recs


def check_elbo(elbo, gen, dev):
    """The ELBO kernel against its plain version at the vessel batch and at
    ragged lengths (rel 1e-5: sums of non-negative terms in another order);
    deterministic from run to run; timed at the vessel batch."""
    record = None
    for n in (ELBO_N, ELBO_N - 37, 1000, 1):
        x = (torch.rand(n, generator=gen) > 0.9).float().to(dev)
        recon = torch.randn(n, generator=gen).to(dev)
        pw = elbo.pos_weight(x)
        got = elbo.elbo_terms(recon, x, pw)
        again = elbo.elbo_terms(recon, x, pw)
        torch.cuda.synchronize()
        want = elbo._plain_terms(recon, x, pw)
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        log(f"[kernels] elbo_terms n={n}: {got.tolist()} vs plain {want.tolist()}, "
            f"max rel {rel:.3e} (tol 1e-5), repeat equal {bool(torch.equal(got, again))}")
        check(f"elbo_terms n={n}", rel, 1e-5)
        if not torch.equal(got, again):
            raise AssertionError("elbo_terms differs between two runs on the same input")
        if n == ELBO_N:
            ms = cuda_ms(lambda: elbo.elbo_terms(recon, x, pw))
            plain = cuda_ms(lambda: elbo._plain_terms(recon, x, pw))
            bnd, by = bound(2 * n * 4 + 4 + 8, 8 * n)
            record = dict(max_abs_err=max_err(got, want), ms=ms, plain_ms=plain,
                          library_ms=None, bound_ms=bnd, bound_by=by)
            log(f"[kernels] elbo_terms f32 n={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"library none, bound {bnd:.4f} ms ({by}), kernel/bound {ms / bnd:.2f}")
    return record


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


def check_stage(stage, gen, dev):
    """Both stage kernels against stage_reference and its autograd backward
    at the 14 shapes of the packed-fused step, f32 (TF32 off; max|d| <=
    1e-4 max|ref|: sums of up to 9216 products in another order) and bf16
    (against the plain version in f32 on the bf16 values, 1e-2 max|ref|:
    the kernel rounds the activation and its outputs to bf16). Random dense
    kernels at the lifted shapes. Every shape timed in f32 (the per-step
    sum); at dec_out and dec_ct[4] also the plain version and the library
    yardstick: F.conv2d on the pre-activated, pre-padded input in
    channels-last (forward) and that conv's autograd backward."""
    recs, totals = {}, {"fwd": 0.0, "bwd": 0.0, "lifted": 0.0, "real": 0.0}
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
            torch.cuda.synchronize()
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
        elems_x, elems_y, elems_w = b * h * w * ci, b * h * w * co, k * k * ci * co
        bnd_f, by_f = bound(4 * (elems_x + elems_y + elems_w + 2 * ci + co), flops)
        bnd_b, by_b = bound(4 * (2 * elems_x + elems_y + 2 * elems_w + 3 * ci + co), 2 * flops)
        totals["fwd"] += ms_f
        totals["bwd"] += ms_b
        totals["lifted"] += flops
        totals["real"] += flops * real
        log(f"[kernels] stage {name} f32: forward {ms_f:.4f} ms (bound {bnd_f:.4f}, {by_f}; "
            f"{flops / ms_f / 1e9:.1f} TFLOP/s lifted), backward {ms_b:.4f} ms (bound "
            f"{bnd_b:.4f}); lifted {flops / 1e9:.1f} GFLOP forward, real work "
            f"{flops * real / 1e9:.2f} GFLOP ({real:.4f} of it)")
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
                f"{plain_b:.4f} ms; library F.conv2d channels-last forward {lib_f:.4f} ms, "
                f"autograd backward {lib_b:.4f} ms")
            if name == STAGE_RECORD:
                recs["stage_fwd"] = dict(max_abs_err=errs[torch.float32, "y"], ms=ms_f,
                                         plain_ms=plain_f, library_ms=lib_f, bound_ms=bnd_f,
                                         bound_by=by_f)
                recs["stage_bwd"] = dict(
                    max_abs_err=max(errs[torch.float32, t] for t in
                                    ("dx", "dW", "db", "dmul", "dadd")),
                    ms=ms_b, plain_ms=plain_b, library_ms=lib_b, bound_ms=bnd_b,
                    bound_by=by_b)
            del a_pad, w_oihw, y_lib, leaves, y_ref
        del x32, kern32, dy32, x, kern, dy
        torch.cuda.empty_cache()
    log(f"[kernels] stage, the 14 shapes of one batch-8 step in f32: forward "
        f"{totals['fwd']:.3f} ms, backward {totals['bwd']:.3f} ms; lifted "
        f"{totals['lifted'] / 1e9:.1f} GFLOP per forward (real work "
        f"{totals['real'] / 1e9:.1f}), forward bound {totals['lifted'] / 67e12 * 1e3:.3f} ms")
    return recs


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
    recs["elbo_terms"] = check_elbo(elbo, gen, dev)
    recs.update(check_stage(stage, gen, dev))
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
    return launches


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
                steps=TRAIN_STEPS, profile_step=True):
    """The training path: the full-width model (``layout``: the vit.py
    formulation options; spatial by default), seeded weights, dropout 0.1,
    f32 with TF32 off, takes ``steps`` steps of make_vae_step with the
    clipped bf16-moment Adam on bench.py's batch (the same batch every step);
    counts zeroed before and read after and held to ``per_step`` (skipped
    when ``counters`` is None: a timing-only run); every loss finite and the
    last below the first; step time, peak memory, a profiled step."""
    from torch.profiler import ProfilerActivity, profile

    layout = layout or {}
    cfg = port["VesselConfig"]()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, img_hw = port["vessel_model"](device="cuda", seed=0, dropout=TRAIN_RATE, **layout)
    opt = port["ClippedAdam"](model.parameters(), cfg.lr, cfg.grad_clip_norm,
                              mu_dtype=getattr(torch, cfg.adam_mu_dtype))
    step = port["make_vae_step"](model, port["vessel_loss_fn"](cfg), opt)
    batch = train_batch(port, img_hw, layout.get("packed_io", False))
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    log(f"[{tag}] CausalViTVAE {img_hw} {json.dumps(layout)}, batch {TRAIN_BATCH} "
        f"x {tuple(batch['x'].shape)}, dropout {TRAIN_RATE}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
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
        for name, per in per_step.items():
            if launches[name] != per * steps:
                raise AssertionError(f"{name}: {launches[name]} launches in {steps} "
                                     f"steps, expected {per} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not decreasing: {losses}")
    log(f"[{tag}] step time (host clock after synchronize): median of steps 1-"
        f"{steps - 1} {statistics.median(times[1:]):.2f} ms, first step "
        f"{times[0]:.2f} ms; peak device memory {peak / 2**30:.3f} GiB "
        f"({peak} bytes); loss {losses[0]:.6g} -> {losses[-1]:.6g}")
    if profile_step:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(batch, generator=gen)["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = log_breakdown(prof, 1, wall_ms, f"{tag} step, batch {TRAIN_BATCH}", top=20)
        stage_ms = sum(ms for name, ms in dev_ms.items() if any(
            s in name for s in ("conv_gemm_kernel", "wgrad_kernel", "colsum_kernel",
                                "::fold_kernel")))
        log(f"[profile] {tag}: stage kernels {stage_ms:.3f} ms of device busy "
            f"{sum(dev_ms.values()):.3f} ms ({100 * stage_ms / sum(dev_ms.values()):.1f}%)")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return launches, {"step_ms": statistics.median(times[1:]), "peak_bytes": peak}


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
        from causalvae_tpu_torch.cli.main import serving_model, vessel_model
        from causalvae_tpu_torch.config import VesselConfig
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
                depth_to_space_n=depth_to_space_n)
    counters = {"attention_fwd": Counter(attention, "LAUNCHES"),
                "attention_bwd": Counter(attention, "BWD_LAUNCHES"),
                "bn_stats": Counter(batchnorm, "STATS_LAUNCHES"),
                "bn_bwd": Counter(batchnorm, "BWD_LAUNCHES"),
                "elbo_terms": Counter(elbo, "LAUNCHES"),
                "stage_fwd": Counter(stage, "FWD_LAUNCHES"),
                "stage_bwd": Counter(stage, "BWD_LAUNCHES")}
    t_start = time.perf_counter()
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
        serve_launches = phase_serve(attention, serving_model, vae_endpoints,
                                     BatchingEngine, H, VesselConfig().vit_depth)
        phase_cpu_check(serving_model)
        log(f"[time] serving phases {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_launches, train_stats = phase_train(port, counters)
        log(f"[time] training phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_train_cpu_check(port)
        log(f"[time] training card-vs-CPU phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        packed_launches, packed_stats = phase_train(
            port, counters, PACKED, PER_STEP_PACKED, "train-packed-fused")
        _, cudnn_stats = phase_train(
            port, None, dict(PACKED, fused_stages=False), tag="train-packed-cudnn",
            steps=4, profile_step=False)
        log(f"[time] packed training phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_packed_check(port)
        log(f"[time] packed-vs-spatial phase {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"[time] total {time.perf_counter() - t_start:.1f} s; training step (ms, peak "
        f"bytes): spatial {train_stats['step_ms']:.2f}, {train_stats['peak_bytes']}; "
        f"packed-fused {packed_stats['step_ms']:.2f}, {packed_stats['peak_bytes']}; "
        f"packed-cuDNN {cudnn_stats['step_ms']:.2f}, {cudnn_stats['peak_bytes']}")
    paths = {name: {"serve": serve_launches if name == "attention_fwd" else 0,
                    "train": train_launches[name],
                    "train_packed": packed_launches[name]} for name in counters}
    sources = {"attention_fwd": ("attention_fwd.cu", "attention.py:134"),
               "attention_bwd": ("attention_bwd.cu", "attention.py:181"),
               "bn_stats": ("bn_reduce.cu", "batchnorm.py:78"),
               "bn_bwd": ("bn_reduce.cu", "batchnorm.py:97"),
               "elbo_terms": ("elbo_terms.cu", "elbo.py:48"),
               "stage_fwd": ("stage_fwd.cu", "stage.py:227"),
               "stage_bwd": ("stage_bwd.cu", "stage.py:347")}
    kernels = []
    for name, (src, tpu) in sources.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"causalvae_tpu_torch/csrc/{src}",
            "replaces": f"causalvae_tpu/ops/kernels/{tpu}",
            "launches": sum(paths[name].values()), "launches_by_path": paths[name],
            **recs[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
