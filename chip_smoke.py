#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``causalvae_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no final line):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every kernel from ``causalvae_tpu_torch/csrc`` (one nvcc per source,
   in parallel), timed, with ptxas' register/spill summary;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it, f32 with TF32 off (max|Δ| <= 2e-5 max|ref| +
   1e-6) and bf16 against the f32 plain version on the bf16-rounded inputs
   (max|Δ| <= 2e-2); times of the kernel, the plain version and the library
   call that computes the same function, beside the least time the card
   could take (``bound_ms``);
4. the main path: the full-width 768x1280 vessel CausalViTVAE with seeded
   weights on the card, served by ``BatchingEngine(vae_endpoints(...))`` to
   concurrent clients (every endpoint) and over HTTP; launch counters are
   zeroed just before and read just after, and must show 6 attention
   launches per encoder pass; then a ``torch.profiler`` breakdown of one
   bucket-8 reconstruct by kernel, with the device's idle share;
5. the card against the CPU: encode and decode of one sample through the
   same seeded model on both (plain attention on the CPU), max|Δ| <= 1e-3
   max|ref| + 1e-6 with TF32 off.

The second-to-last line of standard output is the card's name and power
limit, the line before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
ATTN_SHAPES = [(64, 961, 32), (256, 961, 32), (6, 17, 32), (3, 241, 16)]
TIMED_SHAPE = (64, 961, 32)  # batch 8 of the serving path: B*H = 8*8, N = 961, D = 32


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


def attention_bound_ms(bh: int, n: int, d: int, dtype) -> tuple:
    """(bound_ms, bound_by): each input read once and each output written
    once over the memory rate, against 4*BH*N*N*D flops over the type's peak."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * bh * n * d * elt + bh * n * 4  # q, k, v, o + f32 lse
    flops = 4 * bh * n * n * d
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(attention):
    """Phase 3: the attention kernel against attention_reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    record = None
    for bh, n, d in ATTN_SHAPES:
        q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev) for _ in range(3))
        o, lse = attention.attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ro, rlse = attention.attention_reference(q, k, v)
        err = float((o - ro).abs().max())
        err_lse = float((lse - rlse).abs().max())
        tol = 2e-5 * float(ro.abs().max()) + 1e-6
        tol_lse = 2e-5 * float(rlse.abs().max()) + 1e-6
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        ob, _ = attention.attention_fwd(qb, kb, vb)
        torch.cuda.synchronize()
        rb, _ = attention.attention_reference(*(t.float() for t in (qb, kb, vb)))
        err_bf16 = float((ob.float() - rb).abs().max())
        log(f"[kernels] attention_fwd {(bh, n, d)}: f32 max|d| {err:.3e} (tol {tol:.3e}), "
            f"lse {err_lse:.3e} (tol {tol_lse:.3e}); bf16 max|d| {err_bf16:.3e} (tol 2e-2)")
        if not (err <= tol and err_lse <= tol_lse and err_bf16 <= 2e-2):
            raise AssertionError(f"attention_fwd disagrees with its plain version at {(bh, n, d)}")
        if (bh, n, d) == TIMED_SHAPE:
            record = {"max_abs_err": err}
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in ((8, 961, 32), TIMED_SHAPE, (256, 961, 32)):
            q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev, dtype) for _ in range(3))
            q4, k4, v4 = (t.view(bh // 8, 8, n, d) for t in (q, k, v))
            ms = cuda_ms(lambda: attention.attention_fwd(q, k, v))
            plain = cuda_ms(lambda: attention.attention_reference(q, k, v))
            lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4))
            bound, by = attention_bound_ms(bh, n, d, dtype)
            log(f"[kernels] attention_fwd {str(dtype)[6:]} {(bh, n, d)}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, library (SDPA) {lib:.4f} ms, bound {bound:.4f} ms "
                f"({by}), kernel/bound {ms / bound:.2f}")
            if dtype == torch.float32 and (bh, n, d) == TIMED_SHAPE:
                record.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                              bound_by=by)
    return record


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


def profile_reconstruct(endpoint, x, m, t, calls: int = 3, top: int = 12):
    """Where the time of a bucket-8 reconstruct goes: device time by kernel
    (torch.profiler), and the device's idle share of the host-clock wall."""
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = {e.key: e.self_device_time_total / 1e3 / calls for e in kernels}
    busy = sum(dev_ms.values())
    log(f"[profile] reconstruct bucket 8: wall {wall_ms:.2f} ms/call, device busy "
        f"{busy:.2f} ms/call, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {ms:8.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from causalvae_tpu_torch.cli.main import serving_model
        from causalvae_tpu_torch.config import VesselConfig
        from causalvae_tpu_torch.ops.kernels import _build, attention
        from causalvae_tpu_torch.serve import http as H
        from causalvae_tpu_torch.serve.endpoints import vae_endpoints
        from causalvae_tpu_torch.serve.engine import BatchingEngine
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e}); run from the "
              "repository root", file=sys.stderr)
        return 3
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
        rec = phase_kernels(attention)
        launches = phase_serve(attention, serving_model, vae_endpoints,
                               BatchingEngine, H, VesselConfig().vit_depth)
        phase_cpu_check(serving_model)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = [{
        "name": "attention_fwd", "route": "cuda",
        "source": "causalvae_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "causalvae_tpu/ops/kernels/attention.py:134",
        "launches": launches, **rec,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
