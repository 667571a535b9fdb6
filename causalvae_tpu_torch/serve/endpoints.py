"""Inference endpoints for serving a causal VAE (``causalvae_tpu/serve/endpoints.py``).

Each endpoint is a ``BoundEndpoint``: a function ``(model, *tensors) ->
tensors`` (batch on axis 0 of every argument) bound to the model it serves.
The endpoints: encode, decode, predict_m, reconstruct, do_t (the
counterfactual grid over every treatment target) and, for a model whose
mechanism head is Gaussian, uncertainty (its sigma): six for the vessel
models and the MNIST C4, five for the deterministic C1.
``ensemble_endpoints`` serves a k-fold ensemble (an ``nn.ModuleList`` of
fold models, ``scm/ensemble.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from causalvae_tpu_torch.device import module_device
from causalvae_tpu_torch.scm import ensemble as E
from causalvae_tpu_torch.scm import intervene as I

Endpoint = Callable[..., object]


class BoundEndpoint:
    """An endpoint as ``fn(model, *tensors)`` plus the model it is bound to.
    The model's weights stay on its device; ``device`` is where the engine
    puts the request tensors. Instances are directly callable
    (``ep(*tensors)``)."""

    __slots__ = ("fn", "model")

    def __init__(self, fn: Callable, model: nn.Module):
        self.fn = fn
        self.model = model

    @property
    def device(self) -> torch.device:
        return module_device(self.model)

    def __call__(self, *args):
        return self.fn(self.model, *args)


def vae_endpoints(model: nn.Module, *,
                  t_targets: Optional[torch.Tensor] = None) -> Dict[str, Endpoint]:
    """Serving endpoints for one model with ``encode(x, m, t)``,
    ``decode(m, z)``, ``predict_m(t)`` and a ``morph`` head; ``uncertainty``
    only where that head is Gaussian (``morph.gaussian``), as JAX probes
    its head's output.

    Puts the model in eval mode. ``t_targets`` fixes the do_t target set
    (default: the identity over all t_dim conditions, "every treatment")."""
    model.eval()
    device = module_device(model)
    if t_targets is None:
        t_targets = torch.eye(int(model.t_dim))
    t_targets = torch.as_tensor(t_targets, dtype=torch.float32, device=device)

    def encode(mdl, x, m, t):
        """(mu, logvar) of q(z | x, m, t)."""
        return mdl.encode(x, m, t)

    def decode(mdl, m, z):
        """x' = decode(m, z)."""
        return mdl.decode(m, z)

    def predict_m(mdl, t):
        """Mechanism mean M' = f(T)."""
        return mdl.predict_m(t)

    def reconstruct(mdl, x, m, t):
        """Mean-abducted reconstruction: decode(m, E[z | x, m, t])."""
        mu, _ = mdl.encode(x, m, t)
        return mdl.decode(m, mu)

    def do_t(mdl, x, m, t):
        """Counterfactual grid (B, n_targets, *image)."""
        return I.do_t_grid(mdl, x, m, t, t_targets)

    def uncertainty(mdl, t):
        """(m_mu, m_sigma) of P(M | T)."""
        m_mu, m_logvar = mdl.morph(t)
        return m_mu, torch.exp(0.5 * m_logvar.clamp(-10.0, 10.0))

    fns = [("encode", encode), ("decode", decode), ("predict_m", predict_m),
           ("reconstruct", reconstruct), ("do_t", do_t)]
    if model.morph.gaussian:
        fns.append(("uncertainty", uncertainty))
    return {name: BoundEndpoint(fn, model) for name, fn in fns}


def ensemble_endpoints(models: nn.ModuleList) -> Dict[str, Endpoint]:
    """Serving endpoints over a k-fold ensemble; puts the members in eval
    mode. ``decode`` and ``predict_m`` return (mean, spread) across the
    members. ``uncertainty`` returns the members' (m_mu, m_sigma)
    batch-leading, (B, K, m) each: the engine scatters a coalesced result by
    axis 0, so the scm layer's member-leading (K, B, m) would hand each
    client member slices of other clients' rows."""
    models.eval()

    def decode(mdl, m, z):
        return E.ensemble_decode(mdl, m, z)

    def predict_m(mdl, t):
        return E.ensemble_predict_m(mdl, t)

    def uncertainty(mdl, t):
        m_mu, m_sigma = E.ensemble_morph_distribution(mdl, t)
        return m_mu.transpose(0, 1), m_sigma.transpose(0, 1)

    return {name: BoundEndpoint(fn, models)
            for name, fn in (("decode", decode), ("predict_m", predict_m),
                             ("uncertainty", uncertainty))}


def endpoint_arg_specs(model, *, m_dim: Optional[int] = None,
                       t_dim: Optional[int] = None, z_dim: Optional[int] = None,
                       img_hw=None, channels: int = 1) -> Dict[str, tuple]:
    """Per-sample (batch-axis-stripped) argument shapes for each endpoint."""
    m_dim = int(m_dim if m_dim is not None else model.m_dim)
    t_dim = int(t_dim if t_dim is not None else model.t_dim)
    z_dim = int(z_dim if z_dim is not None else model.z_dim)
    if img_hw is None:
        img_hw = tuple(getattr(model, "img_size", (28, 28)))
    img = (*img_hw, channels)
    return {
        "encode": (img, (m_dim,), (t_dim,)),
        "decode": ((m_dim,), (z_dim,)),
        "predict_m": ((t_dim,),),
        "reconstruct": (img, (m_dim,), (t_dim,)),
        "do_t": (img, (m_dim,), (t_dim,)),
        "uncertainty": ((t_dim,),),
    }
