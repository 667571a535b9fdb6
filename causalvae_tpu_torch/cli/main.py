"""Command line of the port (``causalvae_tpu/cli/main.py``): ``train``,
``serve`` and ``export`` of the MNIST (``mnist``, ``mnist-bayes``) and
vessel workloads, ``kfold`` and ``vessel-report``.

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        train mnist|mnist-bayes [--epochs N] [--batch-size B] [--data IDX_DIR]
        [--resume] [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        train vessel [--epochs N] [--batch-size B] [--csv CSV --data ROOT]
        [--resume] [--img-hw H W] [--packed-io] [--dtype float32|bfloat16]
        [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main serve [mnist|mnist-bayes|vessel]
        [--ckpt RUN_DIR | --export-dir DIR] [--device cuda|cpu] [--img-hw H W]
        [--buckets 1 2 4 8 16 32] [--seed 0] [--smoke] [--host 127.0.0.1]
        [--port 8900]

    python -m causalvae_tpu_torch.cli.main [--out results] export
        mnist|mnist-bayes|vessel [--ckpt RUN_DIR] [--seed 0] [--buckets 1 8 32]
        [--img-hw H W] [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main kfold [--epochs N] [--folds K]
        [--batch-size B] [--verify] [--img-hw H W] [--csv CSV --data ROOT]
        [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main vessel-report [--epochs N]
        [--folds K] [--batch-size B] [--img-hw H W] [--csv CSV --data ROOT]
        [--device cuda|cpu]

``train mnist`` trains the MNIST ``CausalConvVAE`` (C1; ``mnist-bayes``:
C4, the Gaussian mechanism) against its latent discriminator
(``MnistConfig``: batch 128, z 10, m 12, t 10, lr 1e-3, 100 epochs) into
``<out>/train_<workload>``: ``metrics.jsonl`` and the pair's checkpoints
(``latest``, ``epoch_N`` every 50). It reads the IDX files of ``--data`` or,
without it, ``synthetic_mnist(--n-synthetic, seed=42)``; the 12-feature
morphology is measured on the host once and cached in
``<out>/morph_cache_12.npz``. ``--resume`` continues from ``latest``.

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

``serve`` (the workload defaults to ``mnist``, as in the JAX CLI) serves
the model restored from ``RUN_DIR``'s ``latest`` checkpoint (MNIST: the VAE
half of the pair; vessel: of either formulation and dtype, in the spatial
form, in float32), or, without ``--ckpt``, weights made from ``--seed``:
five endpoints for ``mnist``, six (with ``uncertainty``) for the others. ``--smoke`` starts on an
ephemeral port, round-trips a ``predict_m`` and a ``reconstruct`` request
over HTTP, prints one JSON line and exits. ``--export-dir`` serves a bundle
of ``export`` instead (``serve/export.py``): no model is built and no model
code is imported; the shapes come from the bundle's manifest, and the
bundle decides the workload (a workload named beside it must be the
bundle's). ``--img-hw`` is the vessel's: MNIST is 28x28.

``export`` exports the endpoints of the model ``serve`` would serve (``--ckpt`` or ``--seed``) with ``torch.export`` at the
``--buckets`` ladder into ``<out>/export_<workload>`` (the programs plus one
shared weights file), on ``--device``, and prints the bundle's directory,
platform and each endpoint's buckets and program bytes as JSON.

``kfold`` trains ``--folds`` stratified folds in lockstep
(``train/kfold.py``) of a small ``CausalViTVAE`` (z 32, embed 64, depth 2,
4 heads, MLP 128, ViT latent 64; float32) on the unaugmented corpus,
preprocessed once on the device, at the resolution ``train vessel`` picks;
checkpoints per fold under ``<out>/kfold/fold_<f>``. ``--verify`` prints
the folds' class coverage as JSON and trains nothing. ``vessel-report``
trains the same folds and writes the uncertainty -> SNR chain of CSV files
into ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from causalvae_tpu_torch.config import MnistConfig, VesselConfig
from causalvae_tpu_torch.device import DeviceLike, resolve_device

MNIST_WORKLOADS = ("mnist", "mnist-bayes")


def serving_model(img_hw: Optional[Sequence[int]] = None,
                  device: DeviceLike = None, seed: int = 0,
                  ckpt: Optional[str] = None, workload: str = "vessel"):
    """(model, img_hw) in eval mode: the vessel ``vessel_model`` or, for an
    MNIST workload, ``CausalConvVAE`` (C1, or C4 for ``mnist-bayes``) at
    ``MnistConfig``'s widths (28x28; ``img_hw`` is the vessel's). With
    ``ckpt`` (a run directory of ``train``) its ``latest`` parameters, loaded
    strictly (the vessel into the spatial form; MNIST the pair's ``vae``),
    else the weights of ``seed``."""
    from causalvae_tpu_torch.train.checkpoints import CheckpointBook

    if ckpt and not os.path.isdir(ckpt):
        raise FileNotFoundError(f"--ckpt {ckpt}: no such run directory")
    if workload in MNIST_WORKLOADS:
        from causalvae_tpu_torch.models.vae import CausalConvVAE, seeded_init_

        cfg = MnistConfig()
        bayes = workload == "mnist-bayes"
        model = CausalConvVAE(m_dim=cfg.m_dim, t_dim=cfg.t_dim, z_dim=cfg.z_dim,
                              gaussian_mechanism=bayes, decode_real_m=bayes, device=device)
        if ckpt:
            CheckpointBook(ckpt).restore("latest", {"vae": (model, None)})
        else:
            seeded_init_(model, seed)
        return model.eval(), tuple(cfg.image_hw)
    from causalvae_tpu_torch.models.vit import vessel_model

    model, hw = vessel_model(img_hw, device, None if ckpt else seed)
    if ckpt:
        CheckpointBook(ckpt).restore("latest", model)
    return model.eval(), hw


def _mnist_dataset(args, n_features: int = 12):
    """The MNIST corpus of ``--data`` (IDX files) or the synthetic one, its
    morphology cached in ``<out>/morph_cache_<n_features>.npz``."""
    from causalvae_tpu_torch.data.mnist import (build_morph_mnist, load_mnist_dir,
                                                synthetic_mnist)

    if args.data:
        images, labels = load_mnist_dir(args.data, train=True)
    else:
        images, labels = synthetic_mnist(args.n_synthetic, seed=42)
    cache = os.path.join(args.out, f"morph_cache_{n_features}.npz")
    return build_morph_mnist(images, labels, n_features=n_features, cache_path=cache)


def _vessel_corpus(cfg: VesselConfig, n_synthetic: int):
    from causalvae_tpu_torch.data import vessel

    if cfg.data_csv:
        return vessel.scan_corpus(cfg.data_csv, cfg.data_root)
    return vessel.synthetic_corpus(n=n_synthetic, hw=(96, 160), seed=0)


def cmd_train(args):
    """Train a workload; returns ``train_mnist``'s (vae, disc, vae_opt,
    d_opt, logger) or ``train_vessel``'s (model, optimizer, logger)."""
    from causalvae_tpu_torch.train import workloads as W

    run_dir = os.path.join(args.out, f"train_{args.workload}")
    if args.workload in MNIST_WORKLOADS:
        given = {"epochs": args.epochs, "batch_size": args.batch_size}
        cfg = dataclasses.replace(MnistConfig(),
                                  **{k: v for k, v in given.items() if v is not None})
        result = W.train_mnist(_mnist_dataset(args), cfg,
                               bayesian=args.workload == "mnist-bayes", run_dir=run_dir,
                               resume=args.resume, device=args.device)
        print(f"[train] artifacts in {run_dir}", flush=True)
        return result
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


def _kfold_train(args, corpus, n_folds: int):
    """The lockstep fold training of ``kfold`` and ``vessel-report`` ->
    (models, plan, data, history)."""
    import torch

    from causalvae_tpu_torch.data.vessel import load_raw, make_preprocess
    from causalvae_tpu_torch.models.vae import seeded_init_
    from causalvae_tpu_torch.models.vit import CausalViTVAE
    from causalvae_tpu_torch.train import kfold as KF
    from causalvae_tpu_torch.train.loop import vessel_loss_fn
    from causalvae_tpu_torch.train.state import ClippedAdam

    cfg = VesselConfig()
    if args.img_hw:
        hw = tuple(args.img_hw)
    elif corpus.raw_images is not None:
        hw = (96, 160)
    else:
        hw = (cfg.img_height, cfg.img_width)
    dev = resolve_device(args.device)
    # the corpus preprocessed once on the device, unaugmented (the
    # reference's k-fold trainer trains on mode 'all' without augmentation);
    # a file corpus decoded on every core (the native decoder releases the
    # GIL: 1024 Deflate files of 960x1600 took ~40 s on one core of an H100
    # machine's host)
    if corpus.raw_images is not None:
        raw = corpus.raw_images
    else:
        with ThreadPoolExecutor(os.cpu_count()) as pool:
            raw = np.stack(list(pool.map(load_raw, corpus.paths)))
    n = len(corpus.t_idx)
    x = make_preprocess(hw, dev)(torch.from_numpy(np.asarray(raw, np.float32)),
                                 torch.zeros(n, dtype=torch.int32))
    data = {"x": x, "m": corpus.m, "t": corpus.one_hot_t(np.arange(n))}

    def init_one(f):
        model = CausalViTVAE(img_size=hw, m_dim=corpus.m.shape[1], t_dim=corpus.t_dim,
                             z_dim=32, embed_dim=64, depth=2, heads=4, mlp_dim=128,
                             vit_latent_dim=64, device=dev)
        return seeded_init_(model, cfg.kfold_seed + f)

    models, plan, history = KF.train_kfold(
        init_one=init_one,
        make_optimizer=lambda m: ClippedAdam(m.parameters(), cfg.lr, cfg.grad_clip_norm,
                                             mu_dtype=getattr(torch, cfg.adam_mu_dtype)),
        loss_fn=vessel_loss_fn(cfg), data=data, labels=corpus.t_idx,
        epochs=args.epochs or 5, batch_size=args.batch_size or 4, n_folds=n_folds,
        seed=cfg.kfold_seed, checkpoint_dir=os.path.join(args.out, "kfold"), log_every=1)
    return models, plan, data, history


def _corpus_of(args):
    cfg = dataclasses.replace(VesselConfig(), data_csv=args.csv, data_root=args.data)
    return _vessel_corpus(cfg, args.n_synthetic)


def cmd_kfold(args):
    """``--verify``: print the folds' class coverage as JSON (returns None);
    else train the folds and return ``_kfold_train``'s result."""
    from causalvae_tpu_torch.train import kfold as KF

    corpus = _corpus_of(args)
    if args.verify:
        plan = KF.stratified_kfold(corpus.t_idx, args.folds, seed=VesselConfig.kfold_seed)
        print(json.dumps(KF.verify_stratification(plan, corpus.group_names), indent=1))
        return None
    result = _kfold_train(args, corpus, args.folds)
    val = result[3][-1]["val"]
    print(f"[kfold] {args.folds} folds trained in lockstep; final val losses: "
          f"{val['loss'] if val else 'n/a'}", flush=True)
    return result


def cmd_vessel_report(args):
    """The vessel uncertainty -> SNR chain: k-fold training, then the CSV
    files predictions_by_treatment, uncertainty_by_treatment, feature_stats,
    pairwise_snr, all_pairwise_report, pairwise_report_formatted (the top 3
    features per pair) and significant_changes. Returns the paths written."""
    import torch

    from causalvae_tpu_torch.analysis.kfold_eval import (ensemble_pairwise_report,
                                                         top_k_per_pair)
    from causalvae_tpu_torch.analysis.vessel_report import (
        predictions_by_treatment, uncertainty_by_treatment_rows)
    from causalvae_tpu_torch.scm.uncertainty import (ensemble_sigma_by_treatment,
                                                     pairwise_snr, significant_changes)
    from causalvae_tpu_torch.utils.metrics import write_csv

    corpus = _corpus_of(args)
    models, plan, data, _ = _kfold_train(args, corpus, args.folds)
    names = [f"feat{i}" for i in range(corpus.m.shape[1])]
    groups = list(corpus.group_names)
    os.makedirs(args.out, exist_ok=True)
    written = []

    def write(name, rows):
        path = os.path.join(args.out, f"{name}.csv")
        write_csv(path, rows)
        written.append(path)

    # stage 1: per-treatment predictions of the fold-0 model
    pred = predictions_by_treatment(models[0], data["x"], data["m"], data["t"],
                                    corpus.t_idx, groups, names)
    write("predictions_by_treatment", pred["rows"])

    # stage 2: the ensemble's aleatoric sigma per treatment
    write("uncertainty_by_treatment", uncertainty_by_treatment_rows(models, groups, names))

    # stage 3: stats and SNR in real units through the corpus' scaler
    with torch.no_grad():
        mu, sigma = ensemble_sigma_by_treatment(models, corpus.t_dim)
    mu, sigma = mu.cpu().numpy(), sigma.cpu().numpy()
    mu_real = mu * corpus.scaler_scale + corpus.scaler_mean
    write("feature_stats",
          [{"treatment": groups[g], "feature": names[f],
            "mean_real": float(mu_real[g, f]),
            "sigma_real": float(sigma[g, f] * corpus.scaler_scale[f])}
           for g in range(len(groups)) for f in range(len(names))])
    snr = pairwise_snr(torch.from_numpy(mu), torch.from_numpy(sigma),
                       scale=torch.from_numpy(corpus.scaler_scale)).numpy()
    write("pairwise_snr",
          [{"treatment_a": groups[i], "treatment_b": groups[j],
            "feature": names[f], "snr": float(snr[i, j, f])}
           for i in range(len(groups)) for j in range(len(groups)) if i != j
           for f in range(len(names))])

    # stage 4: the ensemble's pairwise M' differences and their top 3
    rows = ensemble_pairwise_report(models, corpus.t_dim, groups, names)
    write("all_pairwise_report", rows)
    write("pairwise_report_formatted",
          [{"treatment_a": a, "treatment_b": b, "rank": r + 1,
            "feature": row["feature"], "diff": row["diff"]}
           for (a, b), rs in top_k_per_pair(rows, k=3).items() for r, row in enumerate(rs)])

    # stage 5: the most significant changes
    write("significant_changes", significant_changes(snr, mu_real, groups, names, top_k=10))
    print(f"[vessel-report] {len(written)} CSV artifacts in {args.out}", flush=True)
    return written


def cmd_export(args):
    """Export the served model's endpoints into ``<out>/export_vessel``;
    prints and returns the bundle's summary."""
    from causalvae_tpu_torch.serve.endpoints import endpoint_arg_specs, vae_endpoints
    from causalvae_tpu_torch.serve.export import export_endpoints

    model, img_hw = serving_model(args.img_hw, args.device, args.seed, args.ckpt,
                                  args.workload)
    out = os.path.join(args.out, f"export_{args.workload}")
    manifest = export_endpoints(
        vae_endpoints(model), endpoint_arg_specs(model, img_hw=img_hw), out,
        buckets=tuple(args.buckets),
        metadata={"workload": args.workload, "img_hw": list(img_hw)})
    summary = export_summary(out, manifest)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


def export_summary(out: str, manifest: dict) -> dict:
    """A bundle's directory, platform, params bytes, and each endpoint's
    buckets, program bytes and export seconds."""
    ents = manifest["endpoints"]
    params = {e["params_file"] for e in ents.values()}
    return {
        "export_dir": out,
        "platform": manifest["platform"],
        "params_bytes": sum(os.path.getsize(os.path.join(out, p)) for p in params),
        "endpoints": {n: {"buckets": manifest["buckets"],
                          "bytes": sum(os.path.getsize(os.path.join(out, f))
                                       for f in ents[n]["files"].values()),
                          "export_s": ents[n]["export_s"]} for n in sorted(ents)},
    }


def cmd_serve(args):
    """HTTP serving: dynamic-batching engine behind /v1/<endpoint> (.npz),
    over the model's endpoints or, with ``--export-dir``, a bundle's."""
    from causalvae_tpu_torch.serve import http as H
    from causalvae_tpu_torch.serve.engine import BatchingEngine

    if args.export_dir:
        from causalvae_tpu_torch.serve.export import load_exported

        bundle = load_exported(args.export_dir, args.device)
        endpoints = bundle.as_endpoints()
        shapes = {n: tuple(tuple(s) for s in e["arg_shapes"])
                  for n, e in bundle.manifest["endpoints"].items()}
        held = bundle.manifest.get("metadata", {}).get("workload")
        if args.workload and args.workload != held:
            raise ValueError(f"serve {args.workload}: the bundle in {args.export_dir} "
                             f"holds the {held} workload")
        print(f"[serve] {held} bundle {args.export_dir} ({bundle.manifest['device_name']}, "
              f"buckets {bundle.manifest['buckets']}) on {bundle.device}", flush=True)
    else:
        from causalvae_tpu_torch.serve.endpoints import endpoint_arg_specs, vae_endpoints

        model, img_hw = serving_model(args.img_hw, args.device, args.seed, args.ckpt,
                                      args.workload)
        source = (f"parameters restored from {args.ckpt}" if args.ckpt else
                  f"seeded weights (seed {args.seed}; no checkpoint)")
        print(f"[serve] {args.workload} {type(model).__name__} {img_hw[0]}x{img_hw[1]} on "
              f"{next(model.parameters()).device}, {source}", flush=True)
        endpoints = vae_endpoints(model)
        shapes = endpoint_arg_specs(model, img_hw=img_hw)
    engine = BatchingEngine(endpoints, buckets=tuple(args.buckets))
    if not args.smoke:
        H.serve(engine, host=args.host, port=args.port)
        return
    srv = H.serve(engine, port=0, background=True)
    port = srv.server_address[1]
    try:
        rng = np.random.default_rng(args.seed)
        img, (m_dim,), (t_dim,) = shapes["reconstruct"]
        t = np.eye(t_dim, dtype=np.float32)[:3]
        m_hat = H.request_npz("127.0.0.1", port, "predict_m", [t])[0]
        x = rng.random((1, *img), dtype=np.float32)
        m = rng.standard_normal((1, m_dim), dtype=np.float32)
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
    tr = sub.add_parser("train", help="train a workload")
    tr.add_argument("workload", choices=["mnist", "mnist-bayes", "vessel"])
    tr.add_argument("--epochs", type=int)
    tr.add_argument("--batch-size", type=int)
    tr.add_argument("--csv", help="vessel: feature table of a file corpus (with --data)")
    tr.add_argument("--data", help="vessel: TIFF tree of a file corpus (with --csv); "
                    "mnist: directory of the IDX files")
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
    sv.add_argument("workload", nargs="?", choices=["mnist", "mnist-bayes", "vessel"],
                    help="default mnist; with --export-dir the bundle's")
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    sv.add_argument("--img-hw", type=int, nargs=2, metavar=("H", "W"))
    sv.add_argument("--buckets", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    sv.add_argument("--ckpt", metavar="RUN_DIR",
                    help="serve the latest checkpoint of a train run")
    sv.add_argument("--export-dir", metavar="DIR",
                    help="serve a bundle of export (no model code)")
    sv.add_argument("--seed", type=int, default=0,
                    help="seed of the served weights without --ckpt")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8900)
    sv.add_argument("--smoke", action="store_true",
                    help="start on an ephemeral port, round-trip two "
                    "requests, exit")
    sv.set_defaults(fn=cmd_serve)
    ex = sub.add_parser("export", help="export the serving endpoints with "
                        "torch.export (programs + one weights file + manifest)")
    ex.add_argument("workload", choices=["mnist", "mnist-bayes", "vessel"])
    ex.add_argument("--ckpt", metavar="RUN_DIR",
                    help="export the latest checkpoint of a train run")
    ex.add_argument("--seed", type=int, default=0,
                    help="seed of the exported weights without --ckpt")
    ex.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32],
                    help="static batch-size ladder to export")
    ex.add_argument("--img-hw", type=int, nargs=2, metavar=("H", "W"))
    ex.add_argument("--device", default="cuda",
                    help="torch device of the bundle (default cuda; cpu for tests)")
    ex.set_defaults(fn=cmd_export)
    k = sub.add_parser("kfold", help="train stratified folds in lockstep")
    k.add_argument("--epochs", type=int, help="default 5")
    k.add_argument("--folds", type=int, default=5)
    k.add_argument("--batch-size", type=int, help="default 4")
    k.add_argument("--verify", action="store_true",
                   help="print the folds' class coverage as JSON, train nothing")
    vr = sub.add_parser("vessel-report", help="k-fold training, then the "
                        "uncertainty -> SNR CSV files")
    vr.add_argument("--epochs", type=int, help="default 5")
    vr.add_argument("--folds", type=int, default=5)
    vr.add_argument("--batch-size", type=int, help="default 4")
    for sp, fn in ((k, cmd_kfold), (vr, cmd_vessel_report)):
        sp.add_argument("--img-hw", type=int, nargs=2, metavar=("H", "W"),
                        help="training resolution (default as train vessel's)")
        sp.add_argument("--csv", help="feature table of a file corpus (with --data)")
        sp.add_argument("--data", help="TIFF tree of a file corpus (with --csv)")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
        sp.set_defaults(fn=fn)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "serve" and args.export_dir and args.ckpt:
        parser.error("serve: --ckpt and --export-dir exclude each other")
    if args.cmd == "serve" and not args.export_dir and args.workload is None:
        args.workload = "mnist"  # the JAX CLI's default
    mnist = getattr(args, "workload", None) in MNIST_WORKLOADS
    if args.cmd == "train" and mnist and (args.csv or args.img_hw or args.packed_io
                                          or args.dtype != "float32"):
        parser.error(f"train {args.workload}: --csv, --img-hw, --packed-io and --dtype "
                     "are the vessel workload's")
    if args.cmd in ("serve", "export") and mnist and args.img_hw:
        parser.error(f"{args.cmd} {args.workload}: --img-hw is the vessel workload's "
                     "(MNIST is 28x28)")
    if (args.cmd not in ("serve", "export") and not mnist
            and (args.csv is None) != (args.data is None)):
        parser.error(f"{args.cmd}: --csv and --data go together")
    return args.fn(args)


if __name__ == "__main__":
    main()
