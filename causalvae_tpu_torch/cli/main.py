"""Command line of the port (``causalvae_tpu/cli/main.py``): ``train vessel``
and ``serve vessel``.

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        train vessel [--epochs N] [--batch-size B] [--csv CSV --data ROOT]
        [--resume] [--img-hw H W] [--packed-io] [--dtype float32|bfloat16]
        [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main serve vessel [--ckpt RUN_DIR]
        [--device cuda|cpu] [--img-hw H W] [--buckets 1 2 4 8 16 32]
        [--seed 0] [--smoke] [--host 127.0.0.1] [--port 8900]

``train vessel`` trains the vessel ``CausalViTVAE`` (``VesselConfig``
widths) into ``<out>/train_vessel``: metrics, checkpoints (``latest``,
``best``, ``epoch_N``) and sample reconstructions. Without ``--csv`` and
``--data`` it trains on ``synthetic_corpus(n=--n-synthetic)`` (96x160
masks), at 96x160 unless ``--img-hw`` says otherwise; a file corpus trains
at 768x1280. ``--resume`` continues from ``latest``. ``--packed-io`` trains
the phase-packed model with the stage kernels (the same parameters).
``--dtype bfloat16`` computes every layer in bfloat16 on float32 parameters
(``VesselConfig.compute_dtype``; the JAX package's TPU production setting);
its checkpoints hold float32 parameters as a float32 run's do.

``serve vessel`` serves the model restored from ``RUN_DIR``'s ``latest``
checkpoint (of either formulation and dtype) in the spatial form, in float32, or, without
``--ckpt``, weights made from ``--seed``. ``--smoke`` starts on an
ephemeral port, round-trips a ``predict_m`` and a ``reconstruct`` request
over HTTP, prints one JSON line and exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.device import DeviceLike
from causalvae_tpu_torch.models.vit import vessel_model


def serving_model(img_hw: Optional[Sequence[int]] = None,
                  device: DeviceLike = None, seed: int = 0,
                  ckpt: Optional[str] = None):
    """(model, img_hw): ``vessel_model`` in eval mode; with ``ckpt`` (a
    run directory of ``train vessel``) its ``latest`` parameters, loaded
    strictly into the spatial form, else the weights of ``seed``."""
    model, hw = vessel_model(img_hw, device, None if ckpt else seed)
    if ckpt:
        from causalvae_tpu_torch.train.checkpoints import CheckpointBook

        if not os.path.isdir(ckpt):
            raise FileNotFoundError(f"--ckpt {ckpt}: no such run directory")
        CheckpointBook(ckpt).restore("latest", model)
    return model.eval(), hw


def _vessel_corpus(cfg: VesselConfig, n_synthetic: int):
    from causalvae_tpu_torch.data import vessel

    if cfg.data_csv:
        return vessel.scan_corpus(cfg.data_csv, cfg.data_root)
    return vessel.synthetic_corpus(n=n_synthetic, hw=(96, 160), seed=0)


def cmd_train(args):
    """Train the vessel model; returns ``train_vessel``'s (model, optimizer,
    logger)."""
    from causalvae_tpu_torch.train import workloads as W

    run_dir = os.path.join(args.out, f"train_{args.workload}")
    given = {"epochs": args.epochs, "batch_size": args.batch_size}
    cfg = dataclasses.replace(VesselConfig(), data_csv=args.csv, data_root=args.data,
                              compute_dtype=args.dtype,
                              **{k: v for k, v in given.items() if v is not None})
    corpus = _vessel_corpus(cfg, args.n_synthetic)
    if args.img_hw:
        hw = tuple(args.img_hw)
    elif corpus.raw_images is not None:
        hw = (96, 160)
    else:
        hw = (cfg.img_height, cfg.img_width)
    result = W.train_vessel(corpus, cfg, img_hw=hw, run_dir=run_dir,
                            resume=args.resume, packed_io=args.packed_io,
                            device=args.device)
    print(f"[train] artifacts in {run_dir}", flush=True)
    return result


def cmd_serve(args):
    """HTTP serving: dynamic-batching engine behind /v1/<endpoint> (.npz)."""
    from causalvae_tpu_torch.serve import http as H
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.serve.engine import BatchingEngine

    model, img_hw = serving_model(args.img_hw, args.device, args.seed, args.ckpt)
    source = (f"parameters restored from {args.ckpt}" if args.ckpt else
              f"seeded weights (seed {args.seed}; no checkpoint)")
    print(f"[serve] vessel CausalViTVAE {img_hw[0]}x{img_hw[1]} on "
          f"{next(model.parameters()).device}, {source}", flush=True)
    engine = BatchingEngine(vae_endpoints(model), buckets=tuple(args.buckets))
    if not args.smoke:
        H.serve(engine, host=args.host, port=args.port)
        return
    srv = H.serve(engine, port=0, background=True)
    port = srv.server_address[1]
    try:
        rng = np.random.default_rng(args.seed)
        t = np.eye(model.t_dim, dtype=np.float32)[:3]
        m_hat = H.request_npz("127.0.0.1", port, "predict_m", [t])[0]
        x = rng.random((1, *img_hw, 1), dtype=np.float32)
        m = rng.standard_normal((1, model.m_dim), dtype=np.float32)
        recon = H.request_npz("127.0.0.1", port, "reconstruct", [x, m, t[:1]])[0]
        if not (np.isfinite(m_hat).all() and np.isfinite(recon).all()):
            raise RuntimeError("smoke: non-finite outputs")
        print(json.dumps({
            "smoke": "ok", "port": port,
            "predict_m_shape": list(m_hat.shape),
            "reconstruct_shape": list(recon.shape),
            "engine_stats": dict(engine.stats),
        }))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("causalvae-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="results")
    p.add_argument("--n-synthetic", type=int, default=1024)
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train the vessel model")
    tr.add_argument("workload", choices=["vessel"])
    tr.add_argument("--epochs", type=int)
    tr.add_argument("--batch-size", type=int)
    tr.add_argument("--csv", help="feature table of a file corpus (with --data)")
    tr.add_argument("--data", help="TIFF tree of a file corpus (with --csv)")
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--img-hw", type=int, nargs=2, metavar=("H", "W"),
                    help="training resolution (default 96x160 for the "
                    "synthetic corpus, 768x1280 for a file corpus)")
    tr.add_argument("--packed-io", action="store_true",
                    help="train the phase-packed model with the stage "
                    "kernels on device-packed images (the same parameters)")
    tr.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                    help="vessel compute dtype (bfloat16: every layer in bf16, "
                    "parameters, losses and optimizer math stay float32)")
    tr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    tr.set_defaults(fn=cmd_train)
    sv = sub.add_parser("serve", help="HTTP inference serving "
                        "(dynamic-batching engine, .npz protocol)")
    sv.add_argument("workload", choices=["vessel"])
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    sv.add_argument("--img-hw", type=int, nargs=2, metavar=("H", "W"))
    sv.add_argument("--buckets", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    sv.add_argument("--ckpt", metavar="RUN_DIR",
                    help="serve the latest checkpoint of a train vessel run")
    sv.add_argument("--seed", type=int, default=0,
                    help="seed of the served weights without --ckpt")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8900)
    sv.add_argument("--smoke", action="store_true",
                    help="start on an ephemeral port, round-trip two "
                    "requests, exit")
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "train" and (args.csv is None) != (args.data is None):
        parser.error("train: --csv and --data go together")
    return args.fn(args)


if __name__ == "__main__":
    main()
