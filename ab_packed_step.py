#!/usr/bin/env python3
"""Time the packed-fused training step of two checkouts on one GPU, in turns.

    python3 ab_packed_step.py OLD_CHECKOUT NEW_CHECKOUT

Runs OLD, NEW, NEW, OLD, each in a child process (``--one DIR``) that
imports the port and ``chip_smoke.py`` from DIR and trains the phase-packed
model (``packed``, ``packed_io``, ``fused_stages``) as ``chip_smoke.py``
phase 8 does: six steps at batch 8 on bench.py's batch, f32, TF32 off, step
time on the host clock after a synchronise (median of steps 1-5), peak
device memory, and one profiled step (device busy time, idle share, the
stage kernels' share). Each child builds the kernels of its own checkout.
Prints the card's name and power limit and the lines each turn logged.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

KEEP = ("step time", "idle share", "stage kernels", "AB ")


def one(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import json

    import torch

    import causalvae_tpu_torch
    import chip_smoke as cs
    from causalvae_tpu_torch.models.vit import vessel_model
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.ops.subpixel import depth_to_space_n, space_to_depth_n
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
    from causalvae_tpu_torch.train.state import ClippedAdam

    if not Path(causalvae_tpu_torch.__file__).resolve().is_relative_to(Path(checkout).resolve()):
        raise RuntimeError(f"imported the port from {causalvae_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port = dict(vessel_model=vessel_model, VesselConfig=VesselConfig,
                make_vae_step=make_vae_step, vessel_loss_fn=vessel_loss_fn,
                ClippedAdam=ClippedAdam, space_to_depth_n=space_to_depth_n,
                depth_to_space_n=depth_to_space_n)
    _, stats = cs.phase_train(port, None, cs.PACKED, tag=f"packed-fused {checkout}")
    print("AB", checkout, json.dumps(stats), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    for checkout in (old, new, new, old):
        run = subprocess.run([sys.executable, __file__, "--one", checkout],
                             capture_output=True, text=True, timeout=900)
        for line in run.stdout.splitlines():
            if any(k in line for k in KEEP):
                print(line, flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
