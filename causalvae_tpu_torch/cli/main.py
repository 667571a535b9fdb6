"""Command line of the port (``causalvae_tpu/cli/main.py``): ``train``,
``serve`` and ``export`` of the MNIST (``mnist``, ``mnist-bayes``) and
vessel workloads, ``train cvae``, the MNIST study's ``analyze`` and
``counterfactual``, ``kfold`` and ``vessel-report``, and the latent
translator's and causal cascade's ``train vit``, ``translate``, ``train
cascade`` and ``cascade``.

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        train mnist|mnist-bayes|cvae [--epochs N] [--batch-size B]
        [--data IDX_DIR] [--resume] [--scan-steps S] [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        train vit|cascade [--epochs N] [--batch-size B] [--csv CSV --data ROOT]
        [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        translate|cascade [--epochs N] [--batch-size B] [--csv CSV --data ROOT]
        [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        analyze mechanism|residual|importance|gradcam|independence|
        uncertainty|causal|mediation|all [--epochs N] [--pair A B]
        [--bayesian] [--print-data] [--data IDX_DIR] [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        counterfactual do-t|do-m|z-permute|recon [--epochs N]
        [--data IDX_DIR] [--device cuda|cpu]

    python -m causalvae_tpu_torch.cli.main [--out results] [--n-synthetic 1024]
        train vessel [--epochs N] [--batch-size B] [--csv CSV --data ROOT]
        [--resume] [--img-hw H W] [--packed-io] [--dtype float32|bfloat16]
        [--scan-steps S] [--device cuda|cpu]

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
``--scan-steps S`` (``mnist``, ``mnist-bayes`` and ``vessel``) runs S train
steps a dispatch: one CUDA-graph replay a group of S batches
(``train/scan_loop.py``), the same run as without it; 0 (the default) is a
dispatch a step. The other workloads refuse it (the JAX CLI ignores it
there).

``train cvae`` trains the conditional VAE (C5, z 10, batch 128 unless
``--batch-size``, lr 1e-3, 30 epochs unless ``--epochs``) on the same corpus
into ``<out>/train_cvae``; ``--resume`` is refused (JAX's trainer ignores
it and starts over).

``analyze`` trains the MNIST model (C1, or C4 with ``--bayesian``) for
``--epochs`` (3) without a run directory, then runs the named analysis, or
all of them: ``mechanism`` (R² of f(T), phase-1 sensitivity),
``importance`` (phase 2: the device morphology of 10 x 32 decodes against
phase 1; ``--print-data`` prints both raw), ``residual`` (a classifier on
X - X̂), ``gradcam`` (its per-class CAMs, ``gradcam_per_class.png``),
``independence`` (the M and (M, T) probes), ``uncertainty`` (sigma(T) of
C4), ``causal`` (effect and refuters for the digits ``--pair``) and
``mediation`` (the pair's M/Z split). It prints and writes
``<out>/analyze_<what>.json`` with the JAX CLI's keys. ``counterfactual``
trains C1 the same way and draws one figure of the first six images:
``do_t_grid.png`` (every target digit), ``do_m_f<f>.png`` (each feature of
the first image swept over -2..2), ``z_permute.png`` or
``recon_triptych.png`` (original | reconstruction | |residual|).

``train vit`` pretrains the latent translator's ``ViTVAE`` (the
``dec_res_stages=4`` variant, latent 128, default widths; 20 epochs, batch 4
unless given) at 96x160 on the vessel corpus (``--csv``/``--data`` or the
synthetic one), every sample unaugmented, into ``<out>/train_vit``.
``translate`` trains a small such ``ViTVAE`` (latent 64, embed 64, depth 2,
4 heads, MLP 128; 10 epochs) at 96x160 on the synthetic corpus or 384x640
on a file corpus into ``<out>/train_vit``, encodes every sample (mu), fits
the LOOCV ridge translation Z -> M and writes ``<out>/trackA_ranking.csv``
(feature, r2, corr). ``train cascade`` trains the cascade's
``CausalBioVAE`` (C10) at 128x192 (20 epochs, batch 4) on
``scan_cascade_corpus(--csv, --data)`` (``*.vessel.tiff`` stacks) or the
synthetic cascade corpus (n = 40) into ``<out>/train_cascade``; ``cascade``
does the same for 10 epochs, then ranks each feature's sensitivity to T
against condition 0 into ``<out>/sensitivity_ranking.csv`` (feature,
importance). These four refuse ``--resume`` (JAX's trainers start over).

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


def _cascade_corpus(args):
    from causalvae_tpu_torch.data.cascade import (scan_cascade_corpus,
                                                  synthetic_cascade_corpus)

    if args.csv and args.data:
        return scan_cascade_corpus(args.csv, [args.data])
    return synthetic_cascade_corpus()


def _vit_batches(corpus, batch_size: int, hw, device, drop_remainder: bool = True,
                 shuffle: bool = True):
    """``batches(epoch)`` of the vessel corpus' every sample, unaugmented, as
    the JAX CLI feeds the ViT-VAE (shuffled by the epoch unless not)."""
    from causalvae_tpu_torch.data.vessel import iterate_batches

    def batches(epoch: int):
        return iterate_batches(corpus, "all", batch_size, hw,
                               shuffle_seed=epoch if shuffle else None, augment=False,
                               drop_remainder=drop_remainder, device=device)

    return batches


def cmd_train(args):
    """Train a workload; returns ``train_mnist``'s (vae, disc, vae_opt,
    d_opt, logger), or the (model, optimizer, logger) of ``train_cvae``,
    ``train_vessel``, ``train_vit_vae`` or ``train_cascade``."""
    from causalvae_tpu_torch.train import workloads as W

    run_dir = os.path.join(args.out, f"train_{args.workload}")
    if args.workload == "cvae":
        result = W.train_cvae(_mnist_dataset(args), epochs=args.epochs or 30,
                              batch_size=args.batch_size or 128, run_dir=run_dir,
                              device=args.device)
        print(f"[train] artifacts in {run_dir}", flush=True)
        return result
    if args.workload == "vit":
        hw = (96, 160)
        result = W.train_vit_vae(
            _vit_batches(_corpus_of(args), args.batch_size or 4, hw,
                         resolve_device(args.device)),
            hw, latent_dim=128, epochs=args.epochs or 20, run_dir=run_dir,
            device=args.device)
        print(f"[train] artifacts in {run_dir}", flush=True)
        return result
    if args.workload == "cascade":
        result = W.train_cascade(_cascade_corpus(args), img_hw=(128, 192),
                                 epochs=args.epochs or 20, batch_size=args.batch_size or 4,
                                 run_dir=run_dir, device=args.device)
        print(f"[train] artifacts in {run_dir}", flush=True)
        return result
    if args.workload in MNIST_WORKLOADS:
        given = {"epochs": args.epochs, "batch_size": args.batch_size}
        cfg = dataclasses.replace(MnistConfig(),
                                  **{k: v for k, v in given.items() if v is not None})
        result = W.train_mnist(_mnist_dataset(args), cfg,
                               bayesian=args.workload == "mnist-bayes", run_dir=run_dir,
                               resume=args.resume, device=args.device,
                               scan_steps=args.scan_steps)
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
                            device=args.device, scan_steps=args.scan_steps)
    print(f"[train] artifacts in {run_dir}", flush=True)
    return result


def _kfold_train(args, corpus, n_folds: int):
    """The lockstep fold training of ``kfold`` and ``vessel-report`` ->
    (models, plan, data, history)."""
    import torch

    from causalvae_tpu_torch.data.vessel import load_raw, make_preprocess
    from causalvae_tpu_torch.models.vae import flax_init_
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
        return flax_init_(model, cfg.kfold_seed + f)

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


def _trained_mnist(args, bayesian: bool = False):
    """(corpus, C1/C4 VAE) of ``train_mnist`` for ``--epochs`` (3) on the
    CLI's corpus, without a run directory, in eval mode."""
    from causalvae_tpu_torch.train import workloads as W

    ds = _mnist_dataset(args)
    cfg = dataclasses.replace(MnistConfig(), epochs=args.epochs or 3)
    vae = W.train_mnist(ds, cfg, bayesian=bayesian, run_dir=None, device=args.device)[0]
    return ds, vae.eval()


def cmd_analyze(args):
    """The analysis battery over a freshly trained MNIST model; prints and
    writes ``analyze_<what>.json`` and returns its dict."""
    import torch

    from causalvae_tpu_torch.config import FEATURE_NAMES_12

    ds, vae = _trained_mnist(args, bayesian=args.bayesian)
    dev = next(vae.parameters()).device
    names = list(FEATURE_NAMES_12)
    t_dim, z_dim = vae.t_dim, vae.z_dim
    out = {}

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    if args.what in ("mechanism", "all"):
        from causalvae_tpu_torch.analysis.mechanism import mechanism_validity, phase1_importance

        out["mechanism"] = mechanism_validity(vae, ds.m, ds.t, names)
        out["phase1"] = {k: v for k, v in phase1_importance(vae, t_dim, names).items()
                         if k != "predictions"}
    if args.what in ("importance", "all"):
        from causalvae_tpu_torch.analysis.importance import compare_phases, phase2_importance
        from causalvae_tpu_torch.analysis.mechanism import phase1_importance

        z = torch.randn((32, z_dim), generator=torch.Generator().manual_seed(999)).to(dev)

        def decode_fn(t_eye, z_samples):
            m_hat = vae.predict_m(t_eye)  # (T, m)
            return torch.stack([vae.decode(m_t.expand(z_samples.shape[0], -1), z_samples)
                                for m_t in m_hat])

        p1 = phase1_importance(vae, t_dim, names)
        with torch.no_grad():
            p2 = phase2_importance(decode_fn, z, t_dim, n_features=12, feature_names=names)
        out["importance"] = {
            "phase1_ranking": p1["ranking"],
            "phase2_ranking": p2["ranking"],
            "comparison": compare_phases(p1, p2, names),
        }
        if args.print_data:
            out["importance"]["raw"] = {"phase1_sensitivity": p1["sensitivity"],
                                        "phase2_sensitivity": p2["sensitivity"]}
            print(f"{'feature':<14s} {'phase1_raw':>12s} {'phase2_raw':>12s}")
            for n in names:
                print(f"{n:<14s} {p1['sensitivity'][n]:>12.6f} {p2['sensitivity'][n]:>12.6f}")
    if args.what in ("residual", "all"):
        from causalvae_tpu_torch.analysis.residual import residual_leakage_analysis

        r = residual_leakage_analysis(vae, ds.x, ds.m, ds.t, ds.labels, epochs=3)
        out["residual"] = {"accuracy": r["accuracy"], "verdict": r["verdict"]}
    if args.what in ("gradcam", "all"):
        from causalvae_tpu_torch.analysis.gradcam import per_class_mean_cam
        from causalvae_tpu_torch.analysis.plots import mip_quality_grid
        from causalvae_tpu_torch.analysis.residual import compute_residuals, train_classifier_on

        # where T-information leaks into X - X̂, per digit (A3)
        res = compute_residuals(vae, on_dev(ds.x[:256]), on_dev(ds.m[:256]),
                                on_dev(ds.t[:256]),
                                generator=torch.Generator().manual_seed(0)).cpu().numpy()
        clf, _ = train_classifier_on(res, ds.labels[:256], epochs=3, device=dev)
        cams = per_class_mean_cam(clf, res, ds.labels[:256])
        os.makedirs(args.out, exist_ok=True)
        mip_quality_grid(cams, [str(c) for c in range(10)],
                         os.path.join(args.out, "gradcam_per_class.png"), per_group=1)
        out["gradcam"] = {"per_class_cam_shape": list(cams.shape),
                          "artifact": "gradcam_per_class.png"}
    if args.what in ("independence", "all"):
        from causalvae_tpu_torch.analysis.independence import conditional_independence_test

        out["independence"] = conditional_independence_test(ds.x, ds.m, ds.t, epochs=5,
                                                            device=dev)
    if args.what in ("uncertainty", "all"):
        from causalvae_tpu_torch.analysis.mechanism import uncertainty_table

        if vae.gaussian_mechanism:
            out["uncertainty"] = uncertainty_table(vae, t_dim, names)["per_condition"]
        else:
            out["uncertainty"] = "deterministic mechanism (train mnist-bayes for sigma)"
    if args.what in ("causal", "all"):
        from causalvae_tpu_torch.analysis.causal_checks import causal_validation_report

        by_cond = {c: ds.m[ds.labels == c] for c in range(10)}
        a, b = args.pair
        out["causal"] = causal_validation_report(by_cond, a, b, names)
    if args.what in ("mediation", "all"):
        # the M/Z decomposition of the pair's image change (I7)
        from causalvae_tpu_torch.scm.intervene import (abduct, mediation_contributions,
                                                       predict_m)

        a, b = args.pair
        ia = np.nonzero(ds.labels == a)[0][:40]
        ib = np.nonzero(ds.labels == b)[0][:40]
        with torch.no_grad():
            za = abduct(vae, on_dev(ds.x[ia]), on_dev(ds.m[ia]), on_dev(ds.t[ia]))
            zb = abduct(vae, on_dev(ds.x[ib]), on_dev(ds.m[ib]), on_dev(ds.t[ib]))
            m_ab = predict_m(vae, torch.eye(t_dim, device=dev))
            res = mediation_contributions(vae, m_ab[a], m_ab[b], za, zb,
                                          torch.Generator().manual_seed(0), n_mc=50)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        fpct = res["feature_contribution_pct"].mean(axis=0)
        out["mediation"] = {
            "pair": [a, b],
            "m_pct_mean": float(res["m_contribution_pct"].mean()),
            "m_pct_std": float(res["m_contribution_pct"].std()),
            "z_pct_mean": float(res["z_contribution_pct"].mean()),
            "z_pct_std": float(res["z_contribution_pct"].std()),
            "feature_pct": {n: float(v) for n, v in zip(names, fpct)},
        }
    print(json.dumps(out, indent=1, default=str), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"analyze_{args.what}.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


def cmd_counterfactual(args):
    """One counterfactual figure of the first six corpus images from a
    freshly trained C1; returns the path written (``do-m``: the paths)."""
    import torch

    from causalvae_tpu_torch.analysis import plots
    from causalvae_tpu_torch.scm import intervene as I

    ds, vae = _trained_mnist(args)
    dev = next(vae.parameters()).device
    x, m, t = (torch.from_numpy(getattr(ds, k)[:6]).to(dev) for k in ("x", "m", "t"))
    os.makedirs(args.out, exist_ok=True)

    def path(name):
        return os.path.join(args.out, name)

    with torch.no_grad():
        if args.mode == "do-t":
            grid = I.do_t_grid(vae, x, m, t, torch.eye(10, device=dev)).cpu().numpy()
            plots.intervention_grid(ds.x[:6], grid, path("do_t_grid.png"))
            print(f"[counterfactual] grid {grid.shape} -> do_t_grid.png", flush=True)
            return path("do_t_grid.png")
        if args.mode == "do-m":
            sweep = torch.linspace(-2.0, 2.0, 5)
            out = I.do_m_sweep(vae, x[:1], m[:1], t[:1], torch.arange(m.shape[1]),
                               sweep).cpu().numpy()
            written = []
            for f in range(out.shape[1]):
                written.append(path(f"do_m_f{f}.png"))
                plots.sweep_strip(out[0, f], sweep.numpy(), written[-1], feature_name=str(f))
            print(f"[counterfactual] sweeps {out.shape} -> do_m_f*.png", flush=True)
            return written
        if args.mode == "z-permute":
            perm = torch.from_numpy(np.roll(np.arange(6), 1))
            out = I.z_permute_decode(vae, x, m, t, perm).cpu().numpy()
            plots.recon_triptych(ds.x[:4], out[:4], path("z_permute.png"))
            print(f"[counterfactual] z-permute {out.shape} -> z_permute.png", flush=True)
            return path("z_permute.png")
        # recon: original | reconstruction | |residual|
        recon = vae(x[:4], m[:4], t[:4], generator=torch.Generator().manual_seed(0)
                    ).recon_x.cpu().numpy()
        plots.recon_triptych(ds.x[:4], recon, path("recon_triptych.png"),
                             uncertainty=np.abs(ds.x[:4] - recon))
        print(f"[counterfactual] recon {recon.shape} -> recon_triptych.png", flush=True)
        return path("recon_triptych.png")


def cmd_translate(args):
    """The latent translator end to end: train a small ViT-VAE, encode every
    sample (mu), fit the LOOCV ridge Z -> M, write ``trackA_ranking.csv``;
    returns ``fit_translator``'s report."""
    from causalvae_tpu_torch.analysis.translate import fit_translator
    from causalvae_tpu_torch.models.vae import flax_init_
    from causalvae_tpu_torch.models.vit import ViTVAE
    from causalvae_tpu_torch.train import workloads as W
    from causalvae_tpu_torch.utils.metrics import write_csv

    dev = resolve_device(args.device)
    corpus = _corpus_of(args)
    hw = (96, 160) if corpus.raw_images is not None else (384, 640)
    bs = args.batch_size or 4
    model = flax_init_(ViTVAE(img_size=hw, latent_dim=64, embed_dim=64, depth=2, heads=4,
                              mlp_dim=128, dec_res_stages=4, device=dev), 42)
    W.train_vit_vae(_vit_batches(corpus, bs, hw, dev), hw, epochs=args.epochs or 10,
                    model=model, run_dir=os.path.join(args.out, "train_vit"))
    # M from the same batches as the latents, so that Z and M pair up
    ms = []

    def batches():
        for b in _vit_batches(corpus, bs, hw, dev, drop_remainder=False, shuffle=False)(0):
            ms.append(b["m"].cpu().numpy())
            yield b

    z = W.extract_vit_latents(model, batches())
    m = np.concatenate(ms)
    names = [f"feat{i}" for i in range(corpus.m.shape[1])]
    rep = fit_translator(z, m, names)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trackA_ranking.csv")
    write_csv(path, [{"feature": n, "r2": rep["r2"][n], "corr": rep["corr"][n]}
                     for n in rep["ranking"]])
    print(json.dumps({"ranking": rep["ranking"], "r2": rep["r2"]}, indent=1))
    print(f"[translate] -> {path}", flush=True)
    return rep


def cmd_cascade(args):
    """The causal cascade end to end: train C10, then each condition's
    predicted M against condition 0, ranked, into
    ``sensitivity_ranking.csv``; returns ``cascade_sensitivity``'s report."""
    from causalvae_tpu_torch.analysis.mechanism import cascade_sensitivity
    from causalvae_tpu_torch.train import workloads as W
    from causalvae_tpu_torch.utils.metrics import write_csv

    corpus = _cascade_corpus(args)
    model, _, _ = W.train_cascade(corpus, img_hw=(128, 192), epochs=args.epochs or 10,
                                  batch_size=args.batch_size or 4,
                                  run_dir=os.path.join(args.out, "train_cascade"),
                                  device=args.device)
    names = [f"feat{i}" for i in range(corpus.m.shape[1])]
    rep = cascade_sensitivity(model, len(corpus.group_names), control_idx=0,
                              feature_names=names)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "sensitivity_ranking.csv")
    write_csv(path, [{"feature": n, "importance": rep["importance"][n]}
                     for n in rep["ranking"]])
    print(json.dumps({"ranking": rep["ranking"]}, indent=1))
    print(f"[cascade] -> {path}", flush=True)
    return rep


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("causalvae-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="results")
    p.add_argument("--n-synthetic", type=int, default=1024)
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train a workload")
    tr.add_argument("workload", choices=["mnist", "mnist-bayes", "cvae", "vessel", "vit",
                                         "cascade"])
    tr.add_argument("--epochs", type=int)
    tr.add_argument("--batch-size", type=int)
    tr.add_argument("--csv", help="vessel, vit, cascade: feature table of a file "
                    "corpus (with --data)")
    tr.add_argument("--data", help="vessel, vit, cascade: TIFF tree of a file corpus "
                    "(with --csv); mnist: directory of the IDX files")
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
    tr.add_argument("--scan-steps", type=int, default=0, metavar="S",
                    help="mnist, mnist-bayes, vessel: S train steps a dispatch "
                    "(one CUDA-graph replay a group); 0: one a step")
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
    an = sub.add_parser("analyze", help="the MNIST analysis battery over a "
                        "freshly trained model -> analyze_<what>.json")
    an.add_argument("what", choices=["mechanism", "residual", "importance", "gradcam",
                                     "independence", "uncertainty", "causal", "mediation",
                                     "all"])
    an.add_argument("--pair", type=int, nargs=2, default=(1, 8),
                    help="the two digits of causal and mediation")
    an.add_argument("--bayesian", action="store_true",
                    help="train the Gaussian-mechanism model (C4; the uncertainty table)")
    an.add_argument("--print-data", action="store_true",
                    help="print the raw phase-1 / phase-2 sensitivities")
    an.set_defaults(fn=cmd_analyze)
    cf = sub.add_parser("counterfactual", help="one counterfactual figure of a "
                        "freshly trained MNIST model")
    cf.add_argument("mode", choices=["do-t", "do-m", "z-permute", "recon"])
    cf.set_defaults(fn=cmd_counterfactual)
    for sp in (an, cf):
        sp.add_argument("--epochs", type=int, help="training epochs (default 3)")
        sp.add_argument("--data", help="directory of the MNIST IDX files")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    tl = sub.add_parser("translate", help="train a small ViT-VAE, ridge-translate "
                        "its latents to M -> trackA_ranking.csv")
    ca = sub.add_parser("cascade", help="train the cascade VAE (C10), rank M's "
                        "sensitivity to T -> sensitivity_ranking.csv")
    for sp, fn in ((tl, cmd_translate), (ca, cmd_cascade)):
        sp.add_argument("--epochs", type=int, help="default 10")
        sp.add_argument("--batch-size", type=int, help="default 4")
        sp.add_argument("--csv", help="feature table of a file corpus (with --data)")
        sp.add_argument("--data", help="TIFF tree of a file corpus (with --csv)")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
        sp.set_defaults(fn=fn)
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
    mnist = (getattr(args, "workload", None) in MNIST_WORKLOADS + ("cvae",)
             or args.cmd in ("analyze", "counterfactual"))
    if args.cmd == "train" and args.workload in ("cvae", "vit", "cascade") and args.resume:
        parser.error(f"train {args.workload}: --resume is not supported (the JAX trainer "
                     "starts over)")
    if args.cmd == "train" and args.scan_steps < 0:
        parser.error(f"train {args.workload}: --scan-steps must be >= 0")
    if args.cmd == "train" and args.scan_steps and args.workload in ("cvae", "vit", "cascade"):
        parser.error(f"train {args.workload}: --scan-steps is the mnist, mnist-bayes and "
                     "vessel workloads'")
    if args.cmd == "train" and args.workload in ("vit", "cascade") and (
            args.img_hw or args.packed_io or args.dtype != "float32"):
        parser.error(f"train {args.workload}: --img-hw, --packed-io and --dtype are the "
                     "vessel workload's")
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
