"""Train and eval steps (``causalvae_tpu/train/loop.py``).

``make_mnist_adversarial_step`` is the MNIST step of two models and two
optimizers (the latent discriminator first, then the VAE through the
updated discriminator).
``make_vae_step`` is the counterpart of the JAX generic single-optimizer VAE
step that ``bench.py`` drives for the vessel flagship: the model in train
mode (batch-statistics BatchNorm, dropout), the loss, the backward pass, the
optimizer step (``train/state.py`` ``ClippedAdam``: global-norm clipping and
Adam) and the running-statistics update (inside each ``BatchNorm``). Where
JAX threads an explicit PRNG key, the port takes an explicit CPU
``torch.Generator``: it draws the reparameterisation noise and one attention
dropout seed per layer; ``nn.Dropout`` (positional and MLP dropout) draws from
torch's own generator of the device. Tests hand both frameworks the same
noise through ``eps``.
A model that computes in bfloat16 (``VesselConfig.compute_dtype``) keeps
float32 parameters: the backward carries every gradient through the layers'
casts to the float32 leaves, and the optimizer's clip and update run in
float32 as for a float32 model.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn


def batch_args(batch) -> Tuple:
    """Standard batch layout: dict with x (NHWC), m, t."""
    return batch["x"], batch["m"], batch["t"]


def make_vae_step(model: nn.Module, loss_fn: Callable,
                  optimizer: torch.optim.Optimizer):
    """One training step: ``step(batch, generator=None, eps=None)`` -> the
    loss function's metrics (detached 0-d tensors).

    loss_fn(out, batch) -> (total, metrics). ``eps`` (B, z) replaces the
    drawn reparameterisation noise."""

    def step(batch, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(*batch_args(batch), eps=eps, generator=generator)
        total, metrics = loss_fn(out, batch)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_vae_eval_step(model: nn.Module, loss_fn: Callable):
    """Eval step: the model in eval mode (running statistics, no dropout),
    no gradient; ``step(batch, generator=None, eps=None)`` -> metrics."""

    def step(batch, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out = model(*batch_args(batch), eps=eps, generator=generator)
            _, metrics = loss_fn(out, batch)
        return metrics

    return step


def vessel_loss_fn(cfg):
    """loss_fn(out, batch) of the vessel objective with ``cfg``'s weights
    (``bench.py``'s flagship loss). A batch's sample mask ``w`` (k-fold's
    padded val batch; 1 real, 0 padding) reaches the loss, which then takes
    its plain masked form."""
    from causalvae_tpu_torch.ops import losses as L

    def loss_fn(out, batch):
        return L.vessel_loss(out, batch["x"], batch["m"], beta=cfg.beta,
                             lambda_morph=cfg.lambda_morph,
                             lambda_sparsity=cfg.lambda_sparsity,
                             w=batch.get("w"))

    return loss_fn


def make_mnist_adversarial_step(vae: nn.Module, disc: nn.Module,
                                vae_opt: torch.optim.Optimizer,
                                d_opt: torch.optim.Optimizer, cfg,
                                bayesian: bool = False):
    """One adversarial MNIST step (ref mnist_test/01 train.py:34-93):
    ``step(batch, generator=None, eps=None)`` -> the VAE loss's metrics and
    ``d_loss`` (detached 0-d tensors).

    1. D is trained to classify T from a detached z sample, and D's
       optimizer steps;
    2. the VAE is trained on BCE + beta·KLD + morph + confusion through the
       *updated* D (``mnist_bayes_vae_loss`` with ``bayesian``).

    The noise is four (B, z) draws a step, in JAX's key order ``r_enc``,
    ``r_d``, ``r_vae``, ``r_conf``: ``eps`` of shape (4, B, z), or four
    draws from ``generator`` (a CPU ``torch.Generator``). JAX's phase 1 runs
    the whole forward on ``r_enc`` but reads only mu and logvar, which do not
    depend on the noise; the port calls ``encode`` alone there (the same
    mu and logvar) and ``r_enc``'s draw is made and left unused. Phase 1
    runs without gradient up to z, so D's loss never reaches the encoder;
    phase 2 differentiates the VAE's parameters alone
    (``torch.autograd.grad``), so D's ``.grad`` keeps phase 1's gradients
    and D's next step sees no gradient of the VAE's loss."""
    from causalvae_tpu_torch.models.vae import reparameterize
    from causalvae_tpu_torch.ops import losses as L

    vae_params = list(vae.parameters())

    def step(batch, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        x, m, t = batch_args(batch)
        if eps is None:
            eps = torch.randn((4, x.shape[0], vae.z_dim), generator=generator,
                              device="cpu" if generator is None else generator.device)
        eps = eps.to(x.device, torch.float32)
        _, e_d, e_vae, e_conf = eps
        t_idx = t.argmax(dim=1)
        vae.train()
        disc.train()

        # phase 1: the discriminator on a detached z sample
        with torch.no_grad():
            mu, logvar = vae.encode(x, m, t)
            z_detached = reparameterize(mu, logvar, eps=e_d)
        d_opt.zero_grad(set_to_none=True)
        d_loss = L.discriminator_ce(disc(z_detached), t_idx)
        d_loss.backward()
        d_opt.step()

        # phase 2: the VAE against the updated discriminator
        out = vae(x, m, t, eps=e_vae)
        z_sample = reparameterize(out.mu, out.logvar, eps=e_conf)
        d_logits_fake = disc(z_sample)
        if bayesian:
            total, metrics = L.mnist_bayes_vae_loss(
                out, x, m, d_logits_fake, beta=cfg.beta, lambda_adv=cfg.lambda_adv,
                t_dim=cfg.t_dim)
        else:
            total, metrics = L.mnist_vae_loss(
                out, x, m, d_logits_fake, beta=cfg.beta, lambda_adv=cfg.lambda_adv,
                lambda_morph=cfg.lambda_morph, t_dim=cfg.t_dim)
        grads = torch.autograd.grad(total, vae_params, allow_unused=True)
        for p, g in zip(vae_params, grads):
            p.grad = g
        vae_opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["d_loss"] = d_loss.detach()
        return metrics

    return step
