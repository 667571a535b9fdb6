#!/usr/bin/env python3
"""The attention kernels' narrow plan against their wide plan at the same
shape, in one process on one GPU.

    python3 ab_attention_plans.py

The forward takes its narrow plan up to D = 64 and the backward up to
D = 32 (``ATTN_FWD_NARROW_MAX_D``, ``ATTN_BWD_NARROW_MAX_D`` in
``csrc/attention_fwd.cu`` and ``attention_bwd.cu``). This script builds both
sources a second time with those limits lowered to 16 (into
``build/plans/``), so that D = 32 and 64 run the wide plan, and swaps the
two libraries under the wrappers of ``ops/kernels/attention.py``. At the
flagship's attention shapes, (64, 961, 32) at 8 heads and (32, 961, 64) at
4, in float32 and bfloat16: the forward at rates 0 and 0.1, the backward at
0.1. Each plan is first held to the plain version (the forward's o within
2e-5 max|ref| + 1e-6 in f32, 2e-2 in bf16; dq, dk, dv within 1e-4 max|ref|
+ 1e-6 in f32, 1e-2 max|ref| + 1e-3 in bf16) at those shapes and at N = 1,
63, 65, 129. Then timed in turns narrow, wide, wide, narrow, twice, each
turn 50 calls after 5 warm-up calls between two CUDA events, milliseconds a
call. Prints the card's name and power limit, then one JSON line (per case:
each turn's reading and the median of each plan).
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

CALLS, WARM = 50, 5
LOWERED = {"attention_fwd": "-DATTN_FWD_NARROW_MAX_D=16",
           "attention_bwd": "-DATTN_BWD_NARROW_MAX_D=16"}
TIMED = [(64, 961, 32), (32, 961, 64)]
CHECKED = TIMED + [(3, n, d) for n in (1, 63, 65, 129) for d in (32, 64)]
RATE = 0.1


def build_wide(_build) -> dict:
    """name -> the library built with the narrow plan's limit lowered, all
    compiled in parallel."""
    out_dir = _build.BUILD_DIR.parent / "plans"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, flag in LOWERED.items():
        out = out_dir / f"lib{name}-wide.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, flag, "-o", str(out),
               str(_build.SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def use(_build, libs: dict):
    """Put ``libs`` (name -> CDLL) under the wrappers."""
    _build._libs.update(libs)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(attention, plan: str, gen):
    for bh, n, d in CHECKED:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype)
                           for _ in range(4))
            f32 = dtype == torch.float32
            for rate in (0.0, RATE):
                o, lse = attention.attention_fwd(q, k, v, rate, 7)
                ro, _ = attention.attention_reference(q.float(), k.float(), v.float(), rate, 7)
                tol = 2e-5 * float(ro.abs().max()) + 1e-6 if f32 else 2e-2
                if max_err(o, ro) > tol:
                    raise SystemExit(f"{plan} forward {(bh, n, d)} {dtype} rate {rate}: "
                                     f"{max_err(o, ro):.3e} > {tol:.3e}")
            if n == 1:  # dq, dk are rounding noise of 0 there (chip_smoke.py)
                continue
            o, lse = attention.attention_fwd(q, k, v, RATE, 5)
            grads = attention.attention_bwd(q, k, v, o, lse, do, RATE, 5)
            want = attention.attention_bwd_reference(
                *(t.float() for t in (q, k, v, o)), lse, do.float(), RATE, 5)
            rel, floor = (1e-4, 1e-6) if f32 else (1e-2, 1e-3)
            for name, g, w in zip(("dq", "dk", "dv"), grads, want):
                tol = rel * float(w.abs().max()) + floor
                if max_err(g, w) > tol:
                    raise SystemExit(f"{plan} backward {name} {(bh, n, d)} {dtype}: "
                                     f"{max_err(g, w):.3e} > {tol:.3e}")


def cases(attention, gen) -> dict:
    """name -> zero-argument call at a timed shape."""
    out = {}
    for bh, n, d in TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{bh}x{n}x{d} {str(dtype)[6:]}"
            q, k, v, do = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype)
                           for _ in range(4))
            for rate in (0.0, RATE):
                out[f"fwd {tag} rate {rate}"] = (
                    lambda q=q, k=k, v=v, rate=rate: attention.attention_fwd(q, k, v, rate, 7))
            o, lse = attention.attention_fwd(q, k, v, RATE, 5)
            out[f"bwd {tag} rate {RATE}"] = (
                lambda q=q, k=k, v=v, o=o, lse=lse, do=do:
                attention.attention_bwd(q, k, v, o, lse, do, RATE, 5))
    return out


def turn(fn) -> float:
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from causalvae_tpu_torch.ops.kernels import _build, attention

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(list(LOWERED))
    plans = {"narrow": {n: _build.load(n) for n in LOWERED}, "wide": build_wide(_build)}
    for plan, libs in plans.items():
        use(_build, libs)
        check(attention, plan, torch.Generator().manual_seed(0))
    calls = cases(attention, torch.Generator().manual_seed(1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    out = {}
    for name, fn in calls.items():
        readings = {"narrow": [], "wide": []}
        for plan in ("narrow", "wide", "wide", "narrow") * 2:
            use(_build, plans[plan])
            readings[plan].append(turn(fn))
        med = {p: statistics.median(r) for p, r in readings.items()}
        out[name] = {"ms": readings, "median_ms": med,
                     "wide_over_narrow": med["wide"] / med["narrow"]}
        print(f"{name}: narrow {med['narrow']:.4f} ms, wide {med['wide']:.4f} ms "
              f"(wide/narrow {med['wide'] / med['narrow']:.3f}; turns "
              f"{[round(x, 4) for x in readings['narrow']]} "
              f"{[round(x, 4) for x in readings['wide']]})", flush=True)
    print(smi)
    print(json.dumps({"card": smi, "calls_per_turn": CALLS, "cases": out}))
    return 0 if all(math.isfinite(c["wide_over_narrow"]) for c in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
