#!/usr/bin/env python3
"""The large-D attention forward (``csrc/attention_fwd_large.cu``) against the
plans it replaces, in one process on one GPU, in turns, with the L2 cold.

    python3 ab_attention_fwd_large.py --extract REV   # where git is: the old plans' sources
    python3 ab_attention_fwd_large.py                 # on the GPU

``--extract REV`` writes ``git show REV:`` of the forward's sources before
the large-D kernel (``attention_fwd.cu`` with the wide plan,
``attention_fwd_deep.cu`` and the headers they include) into
``build/ab_fwd_large/parent/`` (``build/`` is in ``.gitignore``). The run
then builds them and the checkout's ``attention_fwd_large.cu`` with the
flags of ``ops/kernels/_build.py``, all in parallel, holds both to the plain
version at (3, 65, 256) and (3, 65, 512) (o within 2e-5 max|ref| + 1e-6 in
f32, 2e-2 in bf16), and times them at the flagship's batch 8 with 2 heads of
embed 256 (16, 961, 128), one head of 256, 384, 512 and 1024 (8, 961, D),
float32 and bfloat16, rates 0 and 0.1: in turns old, new, new, old, twice;
each turn the mean of 20 calls, each timed alone between two CUDA events
after a 256 MB buffer is written (the L2 holds 50 MB), after 3 warm-up calls.

Where the new kernel's time goes, from patched copies of ``csrc/`` built
into ``build/ab_fwd_large/<variant>/`` and timed against the unpatched
build in the same turns (each computes wrong results by design; only its
time is read):

- ``no_exchange``: the cluster's sum of the partial score tiles and its
  barriers removed (each CTA goes on with its own partial);
- ``no_prepare``: the f32 key and value tiles' split into (hi, lo) planes
  removed (the products read stale planes);
- ``no_mma``: the mma instructions removed, and with them the fragment
  loads that only feed them;
- ``gather_only`` and ``scatter_only``: the partial tiles summed by a
  gather in every CTA, or by a reduce-scatter and a gather, at every
  cluster size (the source takes the gather up to C = 2); these two give
  the source's bits;
- ``f32_dc64``: f32 CTAs of 64 columns up to D = 512 (twice the cluster,
  110 KB of shared memory, two CTAs an SM), the source's DC = 128 above.

Prints the card's name and power limit first, then one line a case, then
one JSON line (per case: each side's turns and medians).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

CALLS, WARM, ROUNDS = 20, 3, 2
TIMED = [(16, 961, 128), (8, 961, 256), (8, 961, 384), (8, 961, 512), (8, 961, 1024)]
CHECKED = [(3, 65, 256), (3, 65, 512)]
OLD_SOURCES = ("attention_fwd", "attention_fwd_deep")
OLD_FILES = ("attention_fwd.cu", "attention_fwd_deep.cu", "attention_tiles.cuh",
             "mma_tf32.cuh", "dropout_hash.cuh")
NEW = "attention_fwd_large"
ROOT = Path(__file__).resolve().parent / "build" / "ab_fwd_large"
PATCHES = {
    "no_exchange": [("attention_fwd_large.cu", "    if (csize > 1) {\n#pragma unroll\n",
                     "    if (0) {\n#pragma unroll\n", 1),
                    ("attention_fwd_large.cu", "    if (csize > 1) {\n      cluster_wait();",
                     "    if (0) {\n      cluster_wait();", 1),
                    ("attention_fwd_large.cu", "pv_chunks(it - 1, 0, scatter ? 1 : NCH);",
                     "pv_chunks(it - 1, 0, NCH);", 1)],
    "no_prepare": [("attention_fwd_large.cu",
                    "      for (int i = threadIdx.x; i < KT * (width / 4); i += THREADS) {",
                    "      for (int i = threadIdx.x; i < 0; i += THREADS) {", 1),
                   ("attention_fwd_large.cu",
                    "      for (int i = threadIdx.x; i < (KT / 2) * width; i += THREADS) {",
                    "      for (int i = threadIdx.x; i < 0; i += THREADS) {", 1)],
    "no_mma": [("attention_fwd_large.cu", '  asm volatile(\n      "mma.sync',
                '  if (0) asm volatile(\n      "mma.sync', 1),
               ("mma_tf32.cuh", '  asm("mma.sync', '  if (0) asm("mma.sync', 1)],
    "gather_only": [("attention_fwd_large.cu", "constexpr int SCATTER_MIN_CLUSTER = 3;",
                     "constexpr int SCATTER_MIN_CLUSTER = 9;", 1)],
    "scatter_only": [("attention_fwd_large.cu", "constexpr int SCATTER_MIN_CLUSTER = 3;",
                      "constexpr int SCATTER_MIN_CLUSTER = 2;", 1)],
    "f32_dc64": [("attention_fwd_large.cu", "  if (d <= 1024)\n    return launch_large",
                  "  if (F32 && d <= 512)\n    return launch_large<T, 64, 32, kDrop>(q, k, v, o, "
                  "lse, bh, n, d, scale, seed, thresh, keep_prob, bh0, stream);\n"
                  "  if (d <= 1024)\n    return launch_large", 1)],
}


def extract(rev: str):
    """The old plans' sources at ``rev`` into ROOT/parent."""
    dst = ROOT / "parent"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for f in OLD_FILES:
        text = subprocess.run(["git", "show", f"{rev}:causalvae_tpu_torch/csrc/{f}"],
                              capture_output=True, text=True, check=True).stdout
        (dst / f).write_text(text)
    (dst / "REV").write_text(rev + "\n")
    print(f"wrote {len(OLD_FILES)} files of {rev} into {dst}")


def build(_build) -> dict:
    """name -> library: 'old' and 'old_deep' (the parent's), 'new' (the
    checkout's) and each patched variant of the new one."""
    nvcc = _build.nvcc_path()
    jobs = {"old": (ROOT / "parent", "attention_fwd"),
            "old_deep": (ROOT / "parent", "attention_fwd_deep")}
    for name, patches in PATCHES.items():
        src = ROOT / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.SRC_DIR, src)
        for file, old, new, count in patches:
            text = (src / file).read_text()
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times in {file}, "
                                   f"not {count}")
            (src / file).write_text(text.replace(old, new))
        jobs[name] = (src, NEW)
    procs = {}
    for name, (src, stem) in jobs.items():
        out = src / f"lib{stem}-{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(out), str(src / f"{stem}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    _build.build([NEW])
    libs = {"new": ctypes.CDLL(str(_build.library_path(NEW)))}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def entry(libs, name, d):
    """The C entry of build ``name`` at head dim d (the parent's deep plan above 256)."""
    if name == "old":
        lib, sym = (libs["old_deep"], "attention_fwd_deep") if d > 256 else (libs["old"],
                                                                              "attention_fwd")
    else:
        lib, sym = libs[name], NEW
    fn = getattr(lib, sym)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
        ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(pa, libs, name, q, k, v, rate):
    """A closure running build ``name`` on (q, k, v) at ``rate``."""
    bh, n, d = q.shape
    fn = entry(libs, name, d)
    o, lse = torch.empty_like(q), torch.empty(bh, n, device=q.device)
    seed = torch.full((), 5, dtype=torch.int64, device=q.device)
    on = int(rate > 0)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, d,
            0 if q.dtype == torch.float32 else 1, 1 / math.sqrt(d), on,
            seed.data_ptr() if on else None, pa.keep_threshold(rate) if on else 0, 1 - rate, 0)

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} at {tuple(q.shape)}: cudaError {err}")
        return o, lse

    return run


def hold(pa, libs):
    for shape in CHECKED:
        g = torch.Generator().manual_seed(sum(shape))
        q, k, v = (torch.randn(*shape, generator=g).to("cuda") for _ in range(3))
        ref, _ = pa.attention_reference(q.double(), k.double(), v.double(), 0.1, 5)
        for dtype, rel, floor in ((torch.float32, 2e-5, 1e-6), (torch.bfloat16, 0.0, 2e-2)):
            ins = [t.to(dtype) for t in (q, k, v)]
            if dtype != torch.float32:
                ref, _ = pa.attention_reference(*(t.double() for t in ins), 0.1, 5)
            for name in ("old", "new", "f32_dc64"):
                o, _ = call(pa, libs, name, *ins, 0.1)()
                torch.cuda.synchronize()
                err = float((o.double() - ref).abs().max())
                if not err <= rel * float(ref.abs().max()) + floor:
                    raise AssertionError(f"{name} {shape} {dtype}: max|d| {err:.3e} past its "
                                         f"bound")


def cold_ms(fn, flush) -> float:
    """Mean time of one call with the L2 cold: each call alone between two
    events, after ``flush`` is written."""
    for _ in range(WARM):
        fn()
    events = []
    for _ in range(CALLS):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / CALLS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extract", metavar="REV", help="write REV's old-plan sources and stop")
    args = ap.parse_args()
    if args.extract:
        extract(args.extract)
        return 0
    if not torch.cuda.is_available():
        print("ab_attention_fwd_large: needs a CUDA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "parent" / "REV").exists():
        print(f"ab_attention_fwd_large: no old sources in {ROOT / 'parent'}; run with "
              f"--extract REV first", file=sys.stderr)
        return 2
    from causalvae_tpu_torch.ops.kernels import _build
    from causalvae_tpu_torch.ops.kernels import attention as pa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"old plans: {(ROOT / 'parent' / 'REV').read_text().strip()}", flush=True)
    libs = build(_build)
    hold(pa, libs)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    result = {}
    for shape in TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(sum(shape))
            q, k, v = (torch.randn(*shape, generator=g).to("cuda", dtype) for _ in range(3))
            for rate in (0.0, 0.1):
                fns = {name: call(pa, libs, name, q, k, v, rate)
                       for name in ("old", "new", *PATCHES)}
                turns = {name: [] for name in fns}
                for _ in range(ROUNDS):
                    for side in ("old", "new", "new", "old"):
                        turns[side].append(cold_ms(fns[side], flush))
                    for name in PATCHES:
                        for side in ("new", name, name, "new"):
                            turns[side].append(cold_ms(fns[side], flush))
                med = {s: statistics.median(x) for s, x in turns.items()}
                key = f"{shape} {str(dtype)[6:]} rate {rate}"
                result[key] = {"turns": turns, "median": med}
                print(f"{key}: old {med['old']:.4f} ms, new {med['new']:.4f} ms "
                      f"(new/old {med['new'] / med['old']:.3f}); "
                      + ", ".join(f"{n} {med[n]:.4f} ({med[n] / med['new']:.3f}x new)"
                                  for n in PATCHES), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
