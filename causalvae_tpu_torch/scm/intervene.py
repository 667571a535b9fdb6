"""Abduction / intervention / prediction (``causalvae_tpu/scm/intervene.py``).

    ABDUCTION    z ~ q(z | x, m, t)     (mean or sampled)
    INTERVENTION do(M := m')  or  do(T := t') with m' = f(t')
    PREDICTION   x' = decode(m', z)

Model-agnostic: any module with ``encode(x, m, t)``, ``decode(m, z)`` and
``predict_m(t)`` works. The weights live in the module, so the JAX
``variables`` argument has no counterpart here. Where JAX ``vmap``s over
targets, features, sweep values or Monte-Carlo samples, the port loops
and stacks, one decode per point, in JAX's output layout.
"""

from __future__ import annotations

from typing import Optional

import torch


def abduct(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Infer the exogenous style z: the posterior mean by default, a sample
    when ``generator`` is given."""
    mu, logvar = model.encode(x, m, t)
    if generator is None:
        return mu
    # imported here: serving (which abducts the mean) loads no model code
    from causalvae_tpu_torch.models.vae import reparameterize

    return reparameterize(mu, logvar, generator=generator)


def decode(model, m: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return model.decode(m, z)


def predict_m(model, t: torch.Tensor) -> torch.Tensor:
    """Mechanism mean M' = f(T) (do(T) propagation through the SCM)."""
    return model.predict_m(t)


def do_t_grid(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
              t_targets: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """do(T) intervention grid: for every source's abducted z and every target
    condition t', x' = decode(f(t'), z). Returns (S, T, H, W, C).

    The JAX ``vmap`` over targets is a loop here, one decode of the S sources
    per target, so peak memory is that of one S-row decode."""
    z = abduct(model, x, m, t, generator)  # (S, z)
    m_targets = predict_m(model, t_targets)  # (T, m)
    grid = [decode(model, m_t.expand(z.shape[0], -1), z) for m_t in m_targets]
    return torch.stack(grid, dim=1)


def intervention_matrix(model, m: torch.Tensor, t_targets: torch.Tensor) -> torch.Tensor:
    """The per-(source, target) orig / pred / diff morphology table: orig =
    the source's measured M, pred = the mechanism's M'(t_target), diff =
    pred - orig. m: (S, F); t_targets: (T, t_dim). Returns (S, T, 3, F)."""
    pred = predict_m(model, t_targets)  # (T, F)
    orig = m[:, None, :].expand(m.shape[0], *pred.shape)
    predb = pred[None].expand_as(orig)
    return torch.stack([orig, predb, predb - orig], dim=2)


def do_m_sweep(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
               feature_idx: torch.Tensor, sweep_values: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """do(M_f := v) sweep: set feature f of every source's m to each value
    and decode with the abducted z. Returns (S, n_features, n_values, H, W, C)."""
    z = abduct(model, x, m, t, generator)  # (S, z)
    out = []
    for f in torch.as_tensor(feature_idx).tolist():
        per_value = []
        for v in torch.as_tensor(sweep_values, dtype=m.dtype).to(m.device):
            m_prime = m.clone()
            m_prime[:, f] = v
            per_value.append(decode(model, m_prime, z))
        out.append(torch.stack(per_value))  # (V, S, H, W, C)
    return torch.stack(out).permute(2, 0, 1, 3, 4, 5)


def z_permute_decode(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                     perm: torch.Tensor, z_scale: float = 1.0) -> torch.Tensor:
    """Swap the abducted z across the batch, keep each sample's own M' =
    f(t); optionally scale z. Identity must follow M, not z."""
    z = abduct(model, x, m, t) * z_scale
    m_hat = predict_m(model, t)
    return decode(model, m_hat, z[torch.as_tensor(perm, device=z.device)])


def m_z_cross_grid(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor
                   ) -> torch.Tensor:
    """decode(M'_i, z_j) for all pairs. Returns (n_m, n_z, H, W, C)."""
    z = abduct(model, x, m, t)
    m_hat = predict_m(model, t)
    return torch.stack([decode(model, m_i.expand(z.shape[0], -1), z) for m_i in m_hat])


def mediation_contributions(model, m_a: torch.Tensor, m_b: torch.Tensor,
                            z_pool_a: torch.Tensor, z_pool_b: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            n_mc: int = 50) -> dict:
    """Monte-Carlo mediation decomposition of the image change A -> B: the
    total change ||x_B - x_A||, the M-swap and Z-swap contributions, and
    each feature's single-swap contribution, in percent of the total. z_a
    is bootstrapped from A's abducted-z pool and z_b from B's (indices drawn
    from ``generator``); m_a / m_b are the mechanism's outputs f(t). Each
    decode takes the n_mc samples as one batch (eval mode: rows are
    independent)."""
    dev = z_pool_a.device
    ia = torch.randint(0, z_pool_a.shape[0], (n_mc,), generator=generator,
                       device=generator.device if generator is not None else dev)
    ib = torch.randint(0, z_pool_b.shape[0], (n_mc,), generator=generator,
                       device=generator.device if generator is not None else dev)
    z_as, z_bs = z_pool_a[ia.to(dev)], z_pool_b[ib.to(dev)]

    def dec(mm, zz):
        return decode(model, mm.expand(n_mc, -1), zz)

    def dist(a, b):
        return torch.linalg.vector_norm((a - b).reshape(n_mc, -1), dim=1)

    base = dec(m_a, z_as)
    totals = dist(dec(m_b, z_bs), base)
    m_contrib = dist(dec(m_b, z_as), base)
    z_contrib = dist(dec(m_a, z_bs), base)
    per_feature = []
    for f in range(m_a.shape[-1]):
        m_f = m_a.clone()
        m_f[f] = m_b[f]
        per_feature.append(dist(dec(m_f, z_as), base))
    per_feature = torch.stack(per_feature, dim=1)  # (n_mc, F)
    safe = torch.where(totals > 0, totals, torch.ones_like(totals))
    return {
        "total": totals,
        "m_contribution_pct": 100.0 * m_contrib / safe,
        "z_contribution_pct": 100.0 * z_contrib / safe,
        "feature_contribution_pct": 100.0 * per_feature / safe[:, None],
    }


def diff_map(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor, *,
             shift: float = 5.0, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
    """|decode(M + shift, z) - decode(M, z)| per pixel."""
    z = abduct(model, x, m, t, generator)
    base = decode(model, m, z)
    shifted = decode(model, m + shift, z)
    return (shifted - base).abs()
