#!/usr/bin/env python3
"""How far C7's f32 encoder gradients under the KL term alone land from a
float64 step, over seeds, batch sizes, both formulations and both devices.

    python3 c7_kld_conditioning.py [--seeds 0 1 2 3 4 5] [--cpu-seed 3]

The reference-layout C7 of ``chip_smoke.py`` phase 18 (``seeded_mirror``)
at VesselConfig's widths (768x1280, z 128, grid (6, 10)); for each seed a
``bench_batch`` at batch 8 (and seed 3 at batch 4), the reference module's
float64 step on the card against the port's C7 in f32 (spatial and
packed) on the card, and at ``--cpu-seed`` also on the CPU
(``chip_smoke.c7_kld_vs_f64``; TF32 off). Prints, per run, KL's relative
difference and the worst leaves (max|d| of max|ref|, the biases that feed a
BatchNorm left out), then the card's name and power limit, then one JSON
line: the worst reading of each leaf over the batch-8 card runs. Phase 18's
``C7_ENC_GRAD_TOL`` is set from these readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as C

SKIP = tuple(f"enc_convs.{i}.bias" for i in range(7)) + ("enc_fc1.bias",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--cpu-seed", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("c7_kld_conditioning: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = C.seeded_mirror().state_dict()
    runs = [(8, s, ("cuda",)) for s in args.seeds] + [(4, 3, ("cuda",)),
                                                      (8, args.cpu_seed, ("cpu",))]
    worst = {}
    for batch, seed, devices in runs:
        t0 = time.perf_counter()
        for (dev, packed), (rel, leaves) in C.c7_kld_vs_f64(state, batch, seed,
                                                             devices).items():
            held = {n: e / r for n, (e, r) in leaves.items() if n not in SKIP}
            ranked = sorted(held.items(), key=lambda kv: -kv[1])
            print(f"batch {batch} seed {seed} {dev} packed={packed}: kld rel {rel:.3e}; "
                  "worst " + ", ".join(f"{n} {v:.3e}" for n, v in ranked[:6]), flush=True)
            if batch == 8 and dev == "cuda":
                for n, v in held.items():
                    worst[n] = max(worst.get(n, 0.0), v)
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    print(C.smi_line())
    print(json.dumps({"batch8_card_worst": dict(sorted(worst.items(), key=lambda kv: -kv[1]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
