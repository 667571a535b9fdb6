#!/usr/bin/env python3
"""Host cost per call of four kernel wrappers, a parent checkout's against
this checkout's, in one process on one GPU.

    python3 ab_op_host_cost.py PARENT_CHECKOUT

Loads the parent's ``causalvae_tpu_torch/ops/kernels/{attention, batchnorm,
elbo, stage}.py`` as standalone modules beside this checkout's package (the
parent's wrappers launch through ctypes; this checkout's through the ``cvae``
operators). Both launch the same kernels, built once from this checkout's
``csrc`` (which must equal the parent's: the script checks). Times
``attention_fwd``, ``bn_stats``, ``elbo_terms`` and ``stage_fwd_fine`` at
small shapes, where the device finishes a launch before the host issues the
next, so a loop of calls measures the host: in turns parent, change, change,
parent, twice, each turn 2000 calls after 200 warm-up calls and ending in a
synchronise, microseconds per call on the host clock. Checks that both sides
give the same bits. Prints the card's name and power limit, then one JSON
line (per wrapper: each turn's reading and the median of each side).
"""

from __future__ import annotations

import filecmp
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

CALLS, WARM = 2000, 200
NAMES = ("attention", "batchnorm", "elbo", "stage")


def load_parent(checkout: Path, name: str):
    path = checkout / "causalvae_tpu_torch" / "ops" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def calls(mods) -> dict:
    """name -> zero-argument call of the wrapper at its small shape."""
    attention, batchnorm, elbo, stage = (mods[n] for n in NAMES)
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    q, k, v = r(8, 64, 32), r(8, 64, 32), r(8, 64, 32)
    x3 = r(8, 16, 1024)
    recon, x = r(8, 32, 32, 1), (r(8, 32, 32, 1) > 1.0).float()
    xs, mul, add, w, b = r(1, 8, 8, 16), r(16), r(16), r(3, 3, 16, 16), r(16)
    return {"attention_fwd": lambda: attention.attention_fwd(q, k, v)[0],
            "bn_stats": lambda: batchnorm.bn_stats(x3),
            "elbo_terms": lambda: elbo.elbo_terms(recon, x),
            "stage_fwd_fine": lambda: stage.stage_fwd_fine(xs, mul, add, w, b, 0.01,
                                                           "conv", 0)}


def turn(fn) -> float:
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main(parent: str) -> int:
    here = Path(__file__).resolve().parent
    parent_dir = Path(parent).resolve()
    cmp = filecmp.dircmp(here / "causalvae_tpu_torch" / "csrc",
                         parent_dir / "causalvae_tpu_torch" / "csrc")
    if cmp.left_only or cmp.right_only or cmp.diff_files:
        raise SystemExit(f"csrc differs from the parent's: {cmp.diff_files} "
                         f"{cmp.left_only} {cmp.right_only}")
    sys.path.insert(0, str(here))
    from causalvae_tpu_torch.ops.kernels import _build

    _build.build()
    change = {n: __import__(f"causalvae_tpu_torch.ops.kernels.{n}", fromlist=[n])
              for n in NAMES}
    sides = {"parent": calls({n: load_parent(parent_dir, n) for n in NAMES}),
             "change": calls(change)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    out = {}
    for name in sides["parent"]:
        a, b = sides["parent"][name](), sides["change"][name]()
        if not torch.equal(a, b):
            raise SystemExit(f"{name}: the two sides differ")
        readings = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent") * 2:
            readings[side].append(turn(sides[side][name]))
        out[name] = {"us_per_call": readings,
                     "median": {s: statistics.median(v) for s, v in readings.items()}}
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1]))
