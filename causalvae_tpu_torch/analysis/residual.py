"""Residual-leakage analysis: can T be read off X - X̂? (A2)
(``causalvae_tpu/analysis/residual.py``).

A ``SimpleClassifier`` is trained on residual images to predict the digit;
low accuracy means the morphology M captured the class-relevant structure.
PASS < 20%, WARN < 50%, else FAIL. The classifier trains with plain Adam
(``ClippedAdam(lr, None)``, optax's ``adam``) in the batch order of
``numpy.random.default_rng(seed)``, as JAX's does; the corpus sits on the
device once. Where JAX splits a PRNG key per batch for the
reparameterisation noise, the port draws from one CPU ``torch.Generator``
seeded ``seed``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from causalvae_tpu_torch.device import DeviceLike, module_device, resolve_device


@torch.no_grad()
def compute_residuals(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """X - X̂ of one batched reconstruction, z sampled with ``eps`` or from
    ``generator``."""
    out = model(x, m, t, eps=eps, generator=generator)
    return x - out.recon_x


def make_classifier_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """``step(batch)`` on {"x", "labels"} -> {"loss": NLL, "acc"} (detached
    0-d tensors), after one optimizer step."""

    def step(batch) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        _, logp = model(batch["x"])
        labels = batch["labels"].long()
        nll = -logp.gather(1, labels[:, None]).mean()
        nll.backward()
        optimizer.step()
        acc = (logp.argmax(dim=-1) == labels).float().mean()
        return {"loss": nll.detach(), "acc": acc.detach()}

    return step


def train_classifier_on(
    x: np.ndarray, labels: np.ndarray, *, epochs: int = 10, batch_size: int = 128,
    lr: float = 1e-3, seed: int = 0, n_classes: int = 10, device: DeviceLike = None,
    model: Optional[nn.Module] = None,
) -> Tuple[nn.Module, float]:
    """Train the eval CNN on (x, labels) -> (model, the last step's train
    accuracy). Weights from ``flax_init_(classifier, seed)`` on ``device``
    unless ``model`` is given (its weights and device kept)."""
    from causalvae_tpu_torch.models.heads import SimpleClassifier
    from causalvae_tpu_torch.models.vae import flax_init_
    from causalvae_tpu_torch.train.state import ClippedAdam

    if model is None:
        model = flax_init_(SimpleClassifier(n_classes, device=resolve_device(device)), seed)
    dev = module_device(model)
    xs = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    ys = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    step = make_classifier_step(model, ClippedAdam(model.parameters(), lr, None,
                                                   mu_dtype=torch.float32))
    rng = np.random.default_rng(seed)
    n = len(x)
    batch_size = min(batch_size, n)  # corpora smaller than one batch
    metrics = None
    for _ in range(epochs):
        idx = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = torch.from_numpy(idx[s:s + batch_size]).to(dev)
            metrics = step({"x": xs[sel], "labels": ys[sel]})
    return model.eval(), 0.0 if metrics is None else float(metrics["acc"])


@torch.no_grad()
def evaluate_classifier(model: nn.Module, x: np.ndarray, labels: np.ndarray,
                        batch_size: int = 512) -> float:
    """Accuracy of ``model`` (eval mode) over (x, labels)."""
    dev = module_device(model)
    model.eval()
    correct = 0
    for s in range(0, len(x), batch_size):
        _, logp = model(torch.from_numpy(np.ascontiguousarray(x[s:s + batch_size],
                                                              np.float32)).to(dev))
        lb = torch.from_numpy(np.asarray(labels[s:s + batch_size], np.int64)).to(dev)
        correct += int((logp.argmax(dim=-1) == lb).sum())
    return correct / len(x)


def residual_leakage_analysis(
    vae_model, x: np.ndarray, m: np.ndarray, t: np.ndarray, labels: np.ndarray, *,
    epochs: int = 10, seed: int = 0, split: float = 0.8, batch_size: int = 256,
) -> Dict:
    """The A2 pipeline on the VAE's device: residuals in batches of
    ``batch_size``, a classifier on the first ``split`` of them, its
    accuracy on the rest and the verdict."""
    dev = module_device(vae_model)
    vae_model.eval()
    gen = torch.Generator().manual_seed(seed)

    def on_dev(a, s):
        return torch.from_numpy(np.ascontiguousarray(a[s:s + batch_size], np.float32)).to(dev)

    residuals = np.concatenate([
        compute_residuals(vae_model, on_dev(x, s), on_dev(m, s), on_dev(t, s),
                          generator=gen).cpu().numpy()
        for s in range(0, len(x), batch_size)])
    n_train = int(len(residuals) * split)
    model, _ = train_classifier_on(residuals[:n_train], labels[:n_train], epochs=epochs,
                                   seed=seed, n_classes=int(labels.max()) + 1, device=dev)
    acc = evaluate_classifier(model, residuals[n_train:], labels[n_train:])
    verdict = "PASS" if acc < 0.20 else ("WARN" if acc < 0.50 else "FAIL")
    return {"accuracy": acc, "verdict": verdict, "residuals": residuals,
            "classifier": model}
