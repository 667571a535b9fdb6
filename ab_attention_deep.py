#!/usr/bin/env python3
"""Where the attention kernels' deep plan (head dims above 256) spends its
time, in one process on one GPU.

    python3 ab_attention_deep.py

Builds ``csrc/attention_fwd_deep.cu`` and ``attention_bwd_deep.cu`` again
from patched copies of ``csrc/`` (into ``build/deep_variants/``), one
variant each, all compiled in parallel, and times every variant against the
unpatched build in turns (base, variant, variant, base, twice; each turn 20
calls after 3 warm-up calls between two CUDA events, milliseconds a call) at
the flagship's batch 8 with one head of embed 384, 512 and 1024, (8, 961,
D), float32 and bfloat16, the forward (float32 only: bfloat16 runs
``attention_fwd_large.cu`` there) and the backward at rate 0.1:

- ``no_mma``: the mma instructions removed, and with them the fragment
  loads and TF32 splits that only feed them;
- ``no_loads``: the ring's cp.async copies removed (the kernels read stale
  shared memory);
- ``no_barriers``: the barrier of each ring step removed;
- ``no_split``: the f32 operands' low TF32 halves set to 0 (the splits'
  cost; the three mma of each f32 product still run);
- ``warps8``: R / 4 warps a block, four a row group of 16 (8 at R = 32,
  where the sources have 4), each 16 rows x 8 columns of a score tile and
  16 x 16 of a chunk; timed at D <= 512 only (at R = 16 it is 4 warps too).

Every variant but ``warps8`` computes wrong results by design: only its
time is read. The base and ``warps8`` builds are first held to the plain
versions at (3, 65, 512) (o within 2e-5 max|ref| + 1e-6 in f32, 2e-2 in
bf16; dq, dk, dv within 1e-4 max|ref| + 1e-6 in f32, 1e-2 max|ref| + 1e-3
in bf16). Prints the card's name and power limit, then one JSON line (per
case: each turn's reading and the median of each side).
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys

import torch

CALLS, WARM, ROUNDS = 20, 3, 2
RATE = 0.1
TIMED = [(8, 961, 384), (8, 961, 512), (8, 961, 1024)]
CHECKED = (3, 65, 512)
SOURCES = ("attention_fwd_deep", "attention_bwd_deep")
R16 = "R / 16 * 128"  # warps8's threads a block
PATCHES = {
    "no_mma": [("mma_tf32.cuh", '  asm("mma.sync', '  if (0) asm("mma.sync', 1)],
    "no_loads": [("attention_tiles.cuh", "    tf32::cp_async16(dst + r * stride + c * E,",
                  "    if (0) tf32::cp_async16(dst + r * stride + c * E,", 1)],
    "no_barriers": [("attention_tiles.cuh", "  tf32::cp_async_wait<NS - 2>();\n  __syncthreads();",
                     "  tf32::cp_async_wait<NS - 2>();", 1)],
    "no_split": [("mma_tf32.cuh", "  lo = kSplit ? to_tf32(x - __uint_as_float(hi)) : 0u;",
                  "  lo = 0u;", 1)],
    "warps8": [
        ("attention_tiles.cuh", "  for (int i = threadIdx.x; i < rows * ch; i += THREADS) {",
         "  for (int i = threadIdx.x; i < rows * ch; i += blockDim.x) {", 1),
        ("attention_tiles.cuh", "  for (int i = threadIdx.x; i < R * pairs; i += THREADS) {",
         "  for (int i = threadIdx.x; i < R * pairs; i += blockDim.x) {", 1),
        ("attention_fwd_deep.cu", "__launch_bounds__(THREADS)", f"__launch_bounds__({R16})", 1),
        ("attention_fwd_deep.cu", "constexpr int NTW = RG;", "constexpr int NTW = 1;", 1),
        ("attention_fwd_deep.cu", "constexpr int NCW = 2 * RG;", "constexpr int NCW = 2;", 1),
        ("attention_fwd_deep.cu", "constexpr int TPR = THREADS / R;",
         f"constexpr int TPR = {R16} / R;", 1),
        ("attention_fwd_deep.cu", "i += THREADS) acc[i]", "i += blockDim.x) acc[i]", 1),
        ("attention_fwd_deep.cu", "THREADS, bytes, stream", f"{R16}, bytes, stream", 1),
        ("attention_bwd_deep.cu", "__launch_bounds__(THREADS)", f"__launch_bounds__({R16})", 2),
        ("attention_bwd_deep.cu", "NTW = RG, NCW = 2 * RG", "NTW = 1, NCW = 2", 2),
        ("attention_bwd_deep.cu", "i += THREADS) acc", "i += blockDim.x) acc", 2),
        ("attention_bwd_deep.cu", "THREADS, dkdv_bytes", f"{R16}, dkdv_bytes", 1),
        ("attention_bwd_deep.cu", "THREADS, dq_bytes", f"{R16}, dq_bytes", 1),
    ],
}


def build_variants(_build) -> dict:
    """variant -> (forward library, backward library); the base is the
    checkout's own build."""
    root = _build.BUILD_DIR.parent / "deep_variants"
    nvcc = _build.nvcc_path()
    procs = {}
    for name, patches in PATCHES.items():
        src = root / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.SRC_DIR, src)
        for file, old, new, count in patches:
            text = (src / file).read_text()
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times in {file}, "
                                   f"not {count}")
            (src / file).write_text(text.replace(old, new))
        for s in SOURCES:
            out = src / f"lib{s}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(out), str(src / f"{s}.cu")]
            procs[name, s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True), out)
    _build.build(list(SOURCES))
    libs = {"base": tuple(ctypes.CDLL(str(_build.library_path(s))) for s in SOURCES)}
    for (name, s), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{s}:\n{log}")
    for name in PATCHES:
        libs[name] = tuple(ctypes.CDLL(str(root / name / f"lib{s}.so")) for s in SOURCES)
    return libs


def calls(pa, libs, q, k, v, o, lse, do):
    """(forward call, backward call) of one build's C entries."""
    fwd_lib, bwd_lib = libs
    bh, n, d = q.shape
    ints = [ctypes.c_int] * 4
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
            ctypes.c_uint, ctypes.c_void_p]
    fwd_lib.attention_fwd_deep.argtypes = [ctypes.c_void_p] * 5 + ints + tail
    bwd_lib.attention_bwd_deep.argtypes = [ctypes.c_void_p] * 9 + ints + tail
    dtype = 0 if q.dtype == torch.float32 else 1
    seed = torch.full((), 5, dtype=torch.int64, device=q.device)
    thresh = pa.keep_threshold(RATE)
    fo, flse = torch.empty_like(q), torch.empty(bh, n, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        err = fwd_lib.attention_fwd_deep(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), fo.data_ptr(), flse.data_ptr(), bh, n,
            d, dtype, 1 / math.sqrt(d), 1, seed.data_ptr(), thresh, 1 - RATE, 0, stream)
        if err:
            raise RuntimeError(f"attention_fwd_deep: cudaError {err}")
        return fo, flse

    def bwd():
        err = bwd_lib.attention_bwd_deep(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, n, d, dtype,
            1 / math.sqrt(d), 1, seed.data_ptr(), thresh, 1 / (1 - RATE), 0, stream)
        if err:
            raise RuntimeError(f"attention_bwd_deep: cudaError {err}")
        return dq, dk, dv

    return fwd, bwd


def inputs(pa, shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v, do = (torch.randn(*shape, generator=g).to("cuda", dtype) for _ in range(4))
    o, lse = pa.attention_fwd(q, k, v, RATE, 5)
    return q, k, v, o, lse, do


def hold(pa, name, libs):
    """The build's outputs at CHECKED against the plain versions."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, o, lse, do = inputs(pa, CHECKED, dtype)
        fwd, bwd = calls(pa, libs, q, k, v, o, lse, do)
        got_o = fwd()[0] if dtype == torch.float32 else None
        grads = bwd()
        torch.cuda.synchronize()
        ro, _ = pa.attention_reference(q.float(), k.float(), v.float(), RATE, 5)
        want = pa.attention_bwd_reference(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                          RATE, 5)
        f32 = dtype == torch.float32
        checks = [(got_o, ro, 2e-5, 1e-6)] if f32 else []
        checks += [(g, w, 1e-4 if f32 else 1e-2, 1e-6 if f32 else 1e-3)
                   for g, w in zip(grads, want)]
        for got, ref, rel, floor in checks:
            err = float((got.float() - ref).abs().max())
            if not err <= rel * float(ref.abs().max()) + floor:
                raise AssertionError(f"{name} {dtype}: max|d| {err:.3e} past its bound")


def ms(fn) -> float:
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
        print("ab_attention_deep: needs a CUDA GPU", file=sys.stderr)
        return 2
    from causalvae_tpu_torch.ops.kernels import _build
    from causalvae_tpu_torch.ops.kernels import attention as pa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    libs = build_variants(_build)
    for name in ("base", "warps8"):
        hold(pa, name, libs[name])
    result = {}
    for shape in TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            ins = inputs(pa, shape, dtype)
            base = calls(pa, libs["base"], *ins)
            for name in PATCHES:
                if name == "warps8" and shape[2] > 512:
                    continue
                var = calls(pa, libs[name], *ins)
                turns = {"base": {"fwd": [], "bwd": []}, name: {"fwd": [], "bwd": []}}
                for _ in range(ROUNDS):
                    for side, (fwd, bwd) in (("base", base), (name, var), (name, var),
                                             ("base", base)):
                        if dtype == torch.float32:
                            turns[side]["fwd"].append(ms(fwd))
                        turns[side]["bwd"].append(ms(bwd))
                med = {s: {w: statistics.median(x) for w, x in t.items() if x}
                       for s, t in turns.items()}
                key = f"{shape} {str(dtype)[6:]} {name}"
                result[key] = {"turns": turns, "median": med}
                fwd_line = (f"fwd base {med['base']['fwd']:.4f} ms, {name} "
                            f"{med[name]['fwd']:.4f} "
                            f"({med[name]['fwd'] / med['base']['fwd']:.3f}x); "
                            if dtype == torch.float32 else "")
                print(f"{key}: {fwd_line}bwd base {med['base']['bwd']:.4f}, {name} "
                      f"{med[name]['bwd']:.4f} ({med[name]['bwd'] / med['base']['bwd']:.3f}x)",
                      flush=True)
    print(smi.stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
