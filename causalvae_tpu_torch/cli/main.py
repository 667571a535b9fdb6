"""Command line of the port (``causalvae_tpu/cli/main.py``); so far ``serve vessel``.

    python -m causalvae_tpu_torch.cli.main serve vessel [--device cuda|cpu]
        [--img-hw H W] [--buckets 1 2 4 8 16 32] [--seed 0] [--smoke]
        [--host 127.0.0.1] [--port 8900]

Serves the vessel ``CausalViTVAE`` (``VesselConfig`` widths) with weights
made from ``--seed``; restoring a trained checkpoint (``--ckpt``) comes with
the training slice. ``--smoke`` starts on an ephemeral port, round-trips a
``predict_m`` and a ``reconstruct`` request over HTTP, prints one JSON line
and exits.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from causalvae_tpu_torch.device import DeviceLike


def serving_model(img_hw: Optional[Sequence[int]] = None,
                  device: DeviceLike = None, seed: int = 0):
    """(model, img_hw): the vessel CausalViTVAE at ``VesselConfig`` widths,
    weights from ``seed`` (``models.vae.seeded_init_``), in eval mode."""
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vae import seeded_init_
    from causalvae_tpu_torch.models.vit import CausalViTVAE

    cfg = VesselConfig()
    hw: Tuple[int, int] = (tuple(img_hw) if img_hw
                           else (cfg.img_height, cfg.img_width))
    model = CausalViTVAE(
        img_size=hw, m_dim=cfg.m_dim, t_dim=cfg.t_dim, z_dim=cfg.z_dim,
        vit_latent_dim=cfg.vit_latent_dim, embed_dim=cfg.vit_embed_dim,
        depth=cfg.vit_depth, heads=cfg.vit_heads, mlp_dim=cfg.vit_mlp_dim,
        device=device)
    seeded_init_(model, seed)
    return model.eval(), hw


def cmd_serve(args):
    """HTTP serving: dynamic-batching engine behind /v1/<endpoint> (.npz)."""
    from causalvae_tpu_torch.serve import http as H
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.serve.engine import BatchingEngine

    model, img_hw = serving_model(args.img_hw, args.device, args.seed)
    print(f"[serve] vessel CausalViTVAE {img_hw[0]}x{img_hw[1]} on "
          f"{next(model.parameters()).device}, seeded weights (seed "
          f"{args.seed}; no checkpoint)", flush=True)
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
    sub = p.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve", help="HTTP inference serving "
                        "(dynamic-batching engine, .npz protocol)")
    sv.add_argument("workload", choices=["vessel"])
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    sv.add_argument("--img-hw", type=int, nargs=2, metavar=("H", "W"))
    sv.add_argument("--buckets", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    sv.add_argument("--seed", type=int, default=0,
                    help="seed of the served weights")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8900)
    sv.add_argument("--smoke", action="store_true",
                    help="start on an ephemeral port, round-trip two "
                    "requests, exit")
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
