"""Conditional-independence probe: does T add information beyond M? (A9)
(``causalvae_tpu/analysis/independence.py``).

Trains two ``MDecoder`` probes, M -> X and (M, T) -> X, and compares their
held-out (last 20%) MSE. If mse_augmented < 0.95 * mse_baseline,
conditional independence X ⫫ T | M is rejected (T still carries image
information that M does not mediate). Each probe trains with plain Adam
(``ClippedAdam(lr, None)``, optax's ``adam``) in the batch order of
``numpy.random.default_rng(seed)``, as JAX's does; the data sit on the
device once and each batch is indexed there.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from causalvae_tpu_torch.device import DeviceLike, module_device, resolve_device


def _train_probe(
    x: np.ndarray, m: np.ndarray, t: Optional[np.ndarray], *,
    epochs: int, batch_size: int, lr: float, seed: int,
    device: DeviceLike = None, model: Optional[nn.Module] = None,
) -> float:
    """Train an MDecoder probe (weights from ``flax_init_(probe, seed)``
    on ``device`` unless ``model`` is given, which keeps its weights and
    device) on the first 80% of the rows; returns the held-out test MSE."""
    from causalvae_tpu_torch.models.vae import MDecoder, flax_init_
    from causalvae_tpu_torch.train.state import ClippedAdam

    n_train = int(len(x) * 0.8)
    if model is None:
        model = flax_init_(MDecoder(m.shape[1], 0 if t is None else t.shape[1],
                                    device=resolve_device(device)), seed)
    dev = module_device(model)
    data = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
            for k, v in (("x", x), ("m", m), ("t", t)) if v is not None}
    opt = ClippedAdam(model.parameters(), lr, None, mu_dtype=torch.float32)

    def mse(sel):
        recon = model(data["m"][sel], data["t"][sel] if t is not None else None)
        return ((recon - data["x"][sel]) ** 2).mean()

    model.train()
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        idx = rng.permutation(n_train)
        for s in range(0, n_train - batch_size + 1, batch_size):
            sel = torch.from_numpy(idx[s:s + batch_size]).to(dev)
            opt.zero_grad(set_to_none=True)
            mse(sel).backward()
            opt.step()
    with torch.no_grad():
        return float(mse(slice(n_train, None)))


def conditional_independence_test(
    x: np.ndarray, m: np.ndarray, t: np.ndarray, *,
    epochs: int = 20, batch_size: int = 128, lr: float = 1e-3, seed: int = 0,
    threshold: float = 0.95, device: DeviceLike = None,
) -> Dict:
    """The A9 experiment on ``device`` (``cuda`` unless "cpu"): both MSEs,
    their ratio as M's share, and the reference's verdict."""
    mse_baseline = _train_probe(x, m, None, epochs=epochs, batch_size=batch_size, lr=lr,
                                seed=seed, device=device)
    mse_augmented = _train_probe(x, m, t, epochs=epochs, batch_size=batch_size, lr=lr,
                                 seed=seed + 1, device=device)
    rejected = mse_augmented < threshold * mse_baseline
    m_explains = (1.0 - (mse_baseline - mse_augmented) / mse_baseline
                  if mse_baseline > 0 else float("nan"))
    return {
        "mse_m_only": mse_baseline,
        "mse_m_and_t": mse_augmented,
        "independence_rejected": bool(rejected),
        "m_information_fraction": float(m_explains),
        "verdict": "T adds information (M incomplete)" if rejected
        else "M captures the class-relevant structure",
    }
