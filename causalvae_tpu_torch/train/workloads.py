"""The trainers (``causalvae_tpu/train/workloads.py`` ``train_mnist``,
``train_cvae``, ``train_vessel``, ``train_vit_vae``, ``extract_vit_latents``,
``train_cascade`` and ``_generic_train``).

``train_mnist`` trains the MNIST causal VAE (C1, or C4 with ``bayesian``)
against its latent discriminator: the corpus moved to the device once and
indexed per batch in the numpy order of ``MorphDataset.batches`` with
``default_rng(cfg.seed)``, one ``make_mnist_adversarial_step`` a batch, the
pair checkpointed every epoch (``latest``) and every 50 (``epoch_N``), and
``resume`` from ``latest``. Both optimizers are plain Adam
(``ClippedAdam(lr, None, float32)``: ``optax.adam``). No val pass.
``train_cvae`` trains the conditional VAE (C5) the same way, one model and
one plain Adam, each epoch in the order of ``default_rng(seed + epoch)``.
``train_vit_vae`` pretrains the latent translator's ``ViTVAE`` (its
``dec_res_stages=4`` variant) on mean MSE + beta·KLD with plain Adam (lr
1e-4) in train mode (dropout, batch statistics), and ``extract_vit_latents``
encodes a corpus with it (eval, no gradient; mu). ``train_cascade`` trains
the cascade's ``CausalBioVAE`` (C10) with plain Adam (lr 1e-3) on augmented
batches of ``data/cascade.py``. All three checkpoint every epoch
(``latest``) and every 50, with no resume and no val pass, as JAX's.

Per epoch: train steps on ``iterate_batches(corpus, "train", ...)``
(shuffle seed 1000 + epoch, the 4x augmented pair space), then the val
batches (no augmentation, the last batch smaller), then the logger (the
epoch's last train metrics as ``train_*``, the mean val loss as
``val_loss``), then the checkpoint cadence of ``CheckpointBook`` and, every
``period`` epochs, the sample-reconstruction PNG; ``images_per_sec`` at the
end. Metrics stay on the device until the epoch's end.

Where JAX threads ``PRNGKey(42)`` through the steps, the port threads a CPU
``torch.Generator`` seeded 42 (the reparameterisation noise and one
attention-dropout seed per layer per step; ``nn.Dropout`` draws from the
device's own generator). As JAX's key, it is not checkpointed: a resumed
run restarts it from the seed. ``noise`` hands in the eps of every train
step and val batch, in the order the loop takes them (tests pass the JAX
side's).

``scan_steps`` > 0 (``train_mnist``, ``train_vessel``; the CLI's ``train
--scan-steps``) runs each epoch's train steps through ``ScanTrainer``
(``train/scan_loop.py``): groups of ``scan_steps`` batches, each one
CUDA-graph replay on the card (the eager loop over the group on the CPU),
with the same draws in the same order as the eager loop, so the run equals
the eager one; ``EpochClock`` and ``StepTimer`` tick once a group, the val
pass stays eager. 0 keeps one dispatch a batch.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from causalvae_tpu_torch.config import MnistConfig, VesselConfig
from causalvae_tpu_torch.device import DeviceLike, module_device
from causalvae_tpu_torch.train.checkpoints import CheckpointBook, device_of
from causalvae_tpu_torch.train.loop import (make_mnist_adversarial_step,
                                            make_simple_vae_step, make_vae_eval_step,
                                            make_vae_step, vessel_loss_fn)
from causalvae_tpu_torch.train.state import ClippedAdam
from causalvae_tpu_torch.utils.metrics import (EpochClock, MetricLogger, StepTimer,
                                               to_host)


def _generic_train(
    model, optimizer: Optional[torch.optim.Optimizer], step, eval_step, epochs: int,
    train_iter: Callable[[int], Iterator[Dict]],
    val_iter: Optional[Callable[[], Iterator[Dict]]],
    *, seed: int, run_dir: Optional[str], period: int, resume: bool,
    batch_size_of: Callable[[Dict], int],
    artifact_cb: Optional[Callable[[int], None]] = None,
    noise: Optional[Iterator[torch.Tensor]] = None,
    prefix: str = "train_",
    scan_steps: int = 0,
) -> MetricLogger:
    """The epoch loop; returns the logger, with the ``EpochClock`` of the
    run as ``logger.clock`` (its ``restore_s``: the seconds of the resume's
    load, None without one). ``model`` and ``optimizer`` are what the
    checkpoint book saves: one module and its optimizer, or named
    (module, optimizer) parts with ``optimizer`` None. The train metrics are
    logged under ``prefix``. ``scan_steps`` > 0 runs the train steps in
    groups through a ``ScanTrainer`` (``logger.trainer``)."""
    gen = torch.Generator().manual_seed(seed)
    device = device_of(model)
    states = tuple(model.values()) if isinstance(model, dict) else ((model, optimizer),)
    trainer = None
    if scan_steps > 0:
        from causalvae_tpu_torch.train.scan_loop import ScanTrainer

        trainer = ScanTrainer(step, n_states=len(states), steps_per_dispatch=scan_steps)

    def eps():
        return None if noise is None else next(noise)

    book = CheckpointBook(run_dir, period=period) if run_dir else None
    clock = EpochClock(device)
    start_epoch = 0
    if book and resume:
        t0 = time.perf_counter()
        start_epoch = book.restore_latest(model, optimizer)
        clock.restore_s = clock.since(t0)

    logger = MetricLogger(run_dir)
    logger.clock, logger.trainer = clock, trainer
    timer = StepTimer(device=device)
    for epoch in range(start_epoch, epochs):
        clock.start()
        metrics = None
        batches = iter(train_iter(epoch))
        while trainer is None:
            with clock.part("batch"):
                batch = next(batches, None)
            if batch is None:
                break
            with clock.part("step"):
                metrics = step(batch, generator=gen, eps=eps())
            clock.step_done()
            timer.tick(batch_size_of(batch))
        while trainer is not None:
            with clock.part("batch"):
                group = [{k: v for k, v in b.items() if k != "labels"}
                         for b in itertools.islice(batches, scan_steps)]
            if not group:
                break
            with clock.part("step"):
                stacked = trainer.run_group(states, group, gen, None if noise is None
                                            else [next(noise) for _ in group])
                metrics = {k: v[-1] for k, v in stacked.items()}
            clock.step_done(len(group))
            timer.tick(sum(batch_size_of(b) for b in group))
        metrics = to_host(metrics)  # the epoch's one read of the train metrics
        logger.log(epoch, metrics, prefix=prefix)
        logger.print_epoch(epoch, metrics)
        val_loss = None
        if eval_step and val_iter:
            with clock.part("val"):
                vals = [eval_step(batch, generator=gen, eps=eps())["loss"]
                        for batch in val_iter()]
                if vals:
                    val_loss = float(np.mean(torch.stack(vals).cpu().numpy()))
            if vals:
                logger.log(epoch, {"loss": val_loss}, prefix="val_")
        if book:
            with clock.part("checkpoint"):
                book.end_of_epoch(model, optimizer, epoch, val_loss)
        if artifact_cb and period and (epoch + 1) % period == 0:
            with clock.part("artifact"):
                artifact_cb(epoch)
        clock.end(epoch)
    logger.log(-1, {"images_per_sec": timer.images_per_sec})
    return logger


def train_mnist(
    dataset,
    cfg: MnistConfig = MnistConfig(),
    *,
    bayesian: bool = False,
    run_dir: Optional[str] = None,
    epochs: Optional[int] = None,
    resume: bool = False,
    device: DeviceLike = None,
    noise: Optional[Iterator[torch.Tensor]] = None,
    models: Optional[Tuple[nn.Module, nn.Module]] = None,
    scan_steps: int = 0,
):
    """Adversarial MNIST causal-VAE training (T1, ref mnist_test/01
    train.py:11-103; the Bayesian C4 with ``bayesian``, ref mnist_test/06
    train.py) -> (vae, disc, vae_opt, d_opt, logger).

    ``CausalConvVAE`` at ``cfg``'s widths and ``LatentDiscriminator`` on
    ``device`` (``cuda`` unless "cpu"), weights from ``flax_init_(vae,
    cfg.seed)`` and ``flax_init_(disc, cfg.seed + 1)``; a given ``models``
    pair (vae, disc) keeps its weights and device. ``noise`` hands in
    each step's (4, B, z) eps in order (tests pass JAX's draws); otherwise a
    CPU generator seeded ``cfg.seed`` draws them. ``scan_steps`` > 0:
    ``scan_steps`` steps a dispatch (``train/scan_loop.py``)."""
    from causalvae_tpu_torch.models.heads import LatentDiscriminator
    from causalvae_tpu_torch.models.vae import CausalConvVAE, flax_init_

    epochs = epochs or cfg.epochs
    if models is None:
        models = (flax_init_(CausalConvVAE(
            m_dim=cfg.m_dim, t_dim=cfg.t_dim, z_dim=cfg.z_dim, gaussian_mechanism=bayesian,
            decode_real_m=bayesian, device=device), cfg.seed),
            flax_init_(LatentDiscriminator(t_dim=cfg.t_dim, z_dim=cfg.z_dim, device=device),
                       cfg.seed + 1))
    vae, disc = models
    vae_opt = ClippedAdam(vae.parameters(), cfg.lr, None, mu_dtype=torch.float32)
    d_opt = ClippedAdam(disc.parameters(), cfg.lr, None, mu_dtype=torch.float32)
    step = make_mnist_adversarial_step(vae, disc, vae_opt, d_opt, cfg, bayesian=bayesian)
    dev = module_device(vae)
    data = {k: torch.from_numpy(np.ascontiguousarray(getattr(dataset, k))).to(dev)
            for k in ("x", "m", "t")}
    rng = np.random.default_rng(cfg.seed)  # one generator for the run, as JAX's

    def train_iter(epoch):
        for sel in dataset.batch_indices(cfg.batch_size, rng):
            idx = torch.from_numpy(sel).to(dev)
            yield {k: v[idx] for k, v in data.items()}

    logger = _generic_train(
        {"vae": (vae, vae_opt), "disc": (disc, d_opt)}, None, step, None, epochs,
        train_iter=train_iter, val_iter=None, seed=cfg.seed, run_dir=run_dir, period=50,
        resume=resume, batch_size_of=lambda b: len(b["m"]), noise=noise, prefix="",
        scan_steps=scan_steps)
    return vae, disc, vae_opt, d_opt, logger


def train_cvae(dataset, *, t_dim: int = 10, z_dim: int = 10, epochs: int = 30,
               batch_size: int = 128, lr: float = 1e-3, beta: float = 1.0,
               run_dir: Optional[str] = None, seed: int = 42, device: DeviceLike = None,
               model: Optional[nn.Module] = None,
               noise: Optional[Iterator[torch.Tensor]] = None):
    """Plain conditional VAE T -> X (T5, ref mnist_test/03 cvae_train.py:11-59)
    -> (model, optimizer, logger).

    ``ConditionalVAE`` on ``device`` (``cuda`` unless "cpu"), weights from
    ``flax_init_(model, seed)`` unless ``model`` is given (its weights and
    device kept); BCE_sum + beta·KLD (``cvae_loss``), plain Adam (``optax.adam``:
    ``ClippedAdam(lr, None, float32)``), epoch e in the order of
    ``default_rng(seed + e)`` with the last partial batch dropped; checkpoints
    every epoch (``latest``) and every 50, no resume, as JAX's
    ``_generic_train`` gives it. ``noise`` hands in each step's (B, z) eps."""
    from causalvae_tpu_torch.models.vae import ConditionalVAE, flax_init_
    from causalvae_tpu_torch.ops import losses as L

    if model is None:
        model = flax_init_(ConditionalVAE(t_dim=t_dim, z_dim=z_dim, device=device), seed)
    dev = module_device(model)
    optimizer = ClippedAdam(model.parameters(), lr, None, mu_dtype=torch.float32)

    def loss_fn(outputs, batch):
        recon, mu, logvar = outputs
        return L.cvae_loss(recon, batch["x"], mu, logvar, beta=beta)

    step = make_simple_vae_step(model, loss_fn, optimizer, arg_names=("x", "t"))
    data = {k: torch.from_numpy(np.ascontiguousarray(getattr(dataset, k))).to(dev)
            for k in ("x", "t")}

    def train_iter(epoch):
        for sel in dataset.batch_indices(batch_size, np.random.default_rng(seed + epoch)):
            idx = torch.from_numpy(sel).to(dev)
            yield {k: v[idx] for k, v in data.items()}

    logger = _generic_train(
        model, optimizer, step, None, epochs, train_iter=train_iter, val_iter=None,
        seed=seed, run_dir=run_dir, period=50, resume=False,
        batch_size_of=lambda b: len(b["t"]), noise=noise)
    return model, optimizer, logger


def train_vessel(
    corpus,
    cfg: VesselConfig = VesselConfig(),
    *,
    model: Optional[nn.Module] = None,
    img_hw: Optional[Tuple[int, int]] = None,
    run_dir: Optional[str] = None,
    epochs: Optional[int] = None,
    resume: bool = False,
    period: int = 50,
    packed_io: bool = False,
    device: DeviceLike = None,
    noise: Optional[Iterator[torch.Tensor]] = None,
    scan_steps: int = 0,
):
    """Vessel CausalViTVAE training with the weighted/sparsity/NLL objective
    -> (model, optimizer, logger).

    Without ``model``: the vessel CausalViTVAE at ``cfg``'s widths and
    ``compute_dtype`` (float32 parameters either way) and the corpus' m and
    t sizes, dropout 0.1, on ``device`` (``cuda`` unless
    "cpu"), weights from ``flax_init_(model, 42)``; ``packed_io`` builds it
    phase-packed with ``packed_io`` and ``fused_stages`` and feeds it
    ``space_to_depth_n(x, 3)``, packed on the device (the losses are
    pixel-permutation-invariant). A given ``model`` keeps its weights and
    device. The optimizer is ``ClippedAdam(lr, grad_clip_norm, mu_dtype)``.
    ``period`` sets the periodic checkpoint and sample-recon PNG cadence.
    ``scan_steps`` > 0: ``scan_steps`` train steps a dispatch
    (``train/scan_loop.py``)."""
    from causalvae_tpu_torch.data.vessel import iterate_batches
    from causalvae_tpu_torch.models.vae import flax_init_
    from causalvae_tpu_torch.models.vit import vessel_model
    from causalvae_tpu_torch.ops.subpixel import depth_to_space_n, space_to_depth_n

    img_hw = tuple(img_hw or (cfg.img_height, cfg.img_width))
    epochs = epochs or cfg.epochs
    if model is None:
        sized = dataclasses.replace(cfg, m_dim=corpus.m.shape[1], t_dim=corpus.t_dim)
        model, _ = vessel_model(img_hw, device, seed=None, packed=packed_io,
                                packed_io=packed_io, fused_stages=packed_io, cfg=sized)
        flax_init_(model, 42)
    dev = module_device(model)
    optimizer = ClippedAdam(model.parameters(), cfg.lr, cfg.grad_clip_norm,
                            mu_dtype=getattr(torch, cfg.adam_mu_dtype))

    def pack(b):
        if not packed_io:
            return b
        return {**b, "x": space_to_depth_n(b["x"], 3)}

    loss_fn = vessel_loss_fn(cfg)
    step = make_vae_step(model, loss_fn, optimizer)
    eval_step = make_vae_eval_step(model, loss_fn)

    artifact_cb = None
    if run_dir:
        # sample-recon PNG every `period` epochs: the first 4 rows of a batch of 2
        b0 = pack(next(iterate_batches(corpus, "train", 2, img_hw, shuffle_seed=0,
                                       device=dev)))
        sample = {k: v[:4] for k, v in b0.items() if k != "labels"}

        def artifact_cb(epoch):
            from causalvae_tpu_torch.analysis.plots import recon_triptych

            model.eval()
            with torch.no_grad():
                out = model(sample["x"], sample["m"], sample["t"],
                            generator=torch.Generator().manual_seed(0))
            xs, recon = sample["x"], out.recon_x
            if packed_io:
                xs, recon = depth_to_space_n(xs, 3), depth_to_space_n(recon, 3)
            recon_triptych(xs.cpu().numpy(), recon.float().cpu().numpy(),
                           os.path.join(run_dir, f"recon_epoch_{epoch + 1}.png"))

    logger = _generic_train(
        model, optimizer, step, eval_step, epochs,
        train_iter=lambda e: map(pack, iterate_batches(
            corpus, "train", cfg.batch_size, img_hw, shuffle_seed=1000 + e,
            device=dev)),
        val_iter=lambda: map(pack, iterate_batches(
            corpus, "val", cfg.batch_size, img_hw, augment=False,
            drop_remainder=False, device=dev)),
        seed=42, run_dir=run_dir, period=period, resume=resume,
        batch_size_of=lambda b: len(b["m"]),
        artifact_cb=artifact_cb, noise=noise, scan_steps=scan_steps,
    )
    return model, optimizer, logger


def train_vit_vae(batches_fn: Callable[[int], Iterator[Dict]], img_hw: Tuple[int, int], *,
                  latent_dim: int = 512, epochs: int = 50, lr: float = 1e-4,
                  beta: float = 1.0, run_dir: Optional[str] = None, seed: int = 42,
                  model: Optional[nn.Module] = None, device: DeviceLike = None,
                  noise: Optional[Iterator[torch.Tensor]] = None):
    """ViT-VAE pretraining, mean MSE + beta·KLD (T6, ref latent_translator/
    engine.py:6-36) -> (model, optimizer, logger). ``batches_fn(epoch)``
    yields {'x': (B, H, W, 1)} on the model's device.

    Without ``model``: the translator variant ``ViTVAE(img_hw, latent_dim,
    dec_res_stages=4)`` at its default widths (embed 256, depth 6, 8 heads,
    MLP 512, dropout 0.1) on ``device`` (``cuda`` unless "cpu"), weights from
    ``flax_init_(model, seed)``; a given ``model`` keeps its weights and
    device. Plain Adam (``optax.adam``: ``ClippedAdam(lr, None, float32)``);
    ``make_simple_vae_step`` with JAX's options (train mode, dropout, batch
    statistics). ``noise`` hands in each step's (B, latent) eps."""
    from causalvae_tpu_torch.models.vae import flax_init_
    from causalvae_tpu_torch.models.vit import ViTVAE
    from causalvae_tpu_torch.ops import losses as L

    if model is None:
        model = flax_init_(ViTVAE(img_size=img_hw, latent_dim=latent_dim,
                                  dec_res_stages=4, device=device), seed)
    optimizer = ClippedAdam(model.parameters(), lr, None, mu_dtype=torch.float32)

    def loss_fn(outputs, batch):
        recon, _, mu, logvar = outputs
        return L.vit_vae_loss(recon, batch["x"], mu, logvar, beta=beta)

    step = make_simple_vae_step(model, loss_fn, optimizer, arg_names=("x",),
                                needs_dropout=True, has_batch_stats=True, train_kw=True)
    logger = _generic_train(
        model, optimizer, step, None, epochs, train_iter=batches_fn, val_iter=None,
        seed=seed, run_dir=run_dir, period=50, resume=False,
        batch_size_of=lambda b: len(b["x"]), noise=noise)
    return model, optimizer, logger


@torch.no_grad()
def extract_vit_latents(model: nn.Module, batches) -> np.ndarray:
    """mu of every image, (N, latent) float32 on the host: the model in eval
    mode, no gradient, one encode per batch of {'x': (B, H, W, 1)} (T6, ref
    engine.py:38-52). The weights live in the module, so JAX's ``state``
    argument has no counterpart."""
    model.eval()
    dev = module_device(model)
    return np.concatenate([model.encode(batch["x"].to(dev))[0].float().cpu().numpy()
                           for batch in batches])


def train_cascade(corpus, *, img_hw: Tuple[int, int] = (512, 960), z_dim: int = 64,
                  epochs: int = 50, batch_size: int = 4, lr: float = 1e-3,
                  gamma: float = 2000.0, run_dir: Optional[str] = None, seed: int = 42,
                  device: DeviceLike = None, model: Optional[nn.Module] = None,
                  noise: Optional[Iterator[torch.Tensor]] = None,
                  aug_params: Optional[Iterator[Dict[str, torch.Tensor]]] = None):
    """Cascade VAE training (T7, ref causal_cascade/train.py:1-39) -> (model,
    optimizer, logger).

    ``CausalBioVAE`` (C10) with the corpus' m and t sizes on ``device``
    (``cuda`` unless "cpu"), weights from ``flax_init_(model, seed)``
    unless ``model`` is given (its weights and device kept); MSE_sum +
    gamma·MSE(M', M)_sum + KLD (``cascade_loss``), plain Adam, epoch e on
    ``data/cascade.py`` ``iterate_batches(train=True, seed=seed + e)`` (the
    remainder dropped); ``make_vae_step`` (train mode: the mechanism's
    BatchNorm on batch statistics). ``noise`` hands in each step's (B, z) eps
    and ``aug_params`` each batch's augmentation (tests pass JAX's)."""
    from causalvae_tpu_torch.data.cascade import iterate_batches
    from causalvae_tpu_torch.models.vae import CausalBioVAE, flax_init_
    from causalvae_tpu_torch.ops import losses as L

    if model is None:
        model = flax_init_(CausalBioVAE(m_dim=corpus.m.shape[1],
                                        t_dim=len(corpus.group_names), z_dim=z_dim,
                                        device=device), seed)
    dev = module_device(model)
    optimizer = ClippedAdam(model.parameters(), lr, None, mu_dtype=torch.float32)

    def loss_fn(out, batch):
        return L.cascade_loss(out, batch["x"], batch["m"], gamma=gamma)

    step = make_vae_step(model, loss_fn, optimizer)
    logger = _generic_train(
        model, optimizer, step, None, epochs,
        train_iter=lambda e: iterate_batches(corpus, batch_size, img_hw, train=True,
                                             seed=seed + e, device=dev,
                                             aug_params=aug_params),
        val_iter=None, seed=seed, run_dir=run_dir, period=50, resume=False,
        batch_size_of=lambda b: len(b["m"]), noise=noise)
    return model, optimizer, logger
