"""Port parity of the losses and the ELBO kernel's plain side (CPU).

Every loss of ``causalvae_tpu_torch.ops.losses`` against the JAX function of
the same name on the same numpy inputs, with and without a sample mask ``w``
where the JAX function takes one: rel 1e-5 (f32 sums in another order,
nothing else differs). The ELBO terms (``ops/kernels/elbo.py``, plain version
on the CPU) against the JAX Pallas kernel in interpret mode
(``vessel_recon_terms_fused(force_pallas=True)``) and ``reference_terms`` at a
ragged size, value rel 1e-5 and gradient max|Δ| <= 1e-5 max|ref|. The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.models.vae import VAEOutput as JaxVAEOutput
from causalvae_tpu.ops import losses as JL
from causalvae_tpu.ops.kernels import elbo as JE

from causalvae_tpu_torch.models.vae import VAEOutput
from causalvae_tpu_torch.ops import losses as PL
from causalvae_tpu_torch.ops.kernels import elbo as PE

from torch_port_helpers import close

B = 4


def _rel(got, want, rel=1e-5):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    assert abs(got - want) <= rel * abs(want) + 1e-6, (got, want)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed=0, hw=(12, 20)):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        recon01=rng.uniform(0.01, 0.99, (B, *hw, 1)).astype(np.float32),
        recon=f(B, *hw, 1),
        x01=rng.random((B, *hw, 1)).astype(np.float32),
        xbin=(rng.random((B, *hw, 1)) > 0.8).astype(np.float32),
        mu=f(B, 8), logvar=0.5 * f(B, 8), m=f(B, 12), m_mu=f(B, 12),
        m_logvar=0.3 * f(B, 12), logits=f(B, 10),
        t_idx=rng.integers(0, 10, B), w=np.array([1.0, 0.0, 1.0, 1.0], np.float32))


def _outs(d, recon_key):
    args = (d[recon_key], d["m_mu"], d["mu"], d["logvar"], d["m_mu"], d["m_logvar"])
    return JaxVAEOutput(*(jnp.asarray(a) for a in args)), VAEOutput(*(_t(a) for a in args))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["bce_sum", "kld_sum", "mse_sum", "gaussian_nll_sum"])
def test_elementwise_losses_match_jax(name, masked):
    d = _inputs(1)
    args = {"bce_sum": ("recon01", "x01"), "kld_sum": ("mu", "logvar"),
            "mse_sum": ("m", "m_mu"),
            "gaussian_nll_sum": ("m", "m_mu", "m_logvar")}[name]
    w = d["w"] if masked else None
    want = getattr(JL, name)(*(jnp.asarray(d[a]) for a in args),
                             None if w is None else jnp.asarray(w))
    got = getattr(PL, name)(*(_t(d[a]) for a in args), None if w is None else _t(w))
    _rel(got, want)


def test_discriminator_ce_and_confusion_kl_match_jax():
    d = _inputs(2)
    _rel(PL.discriminator_ce(_t(d["logits"]), _t(d["t_idx"])),
         JL.discriminator_ce(jnp.asarray(d["logits"]), jnp.asarray(d["t_idx"])))
    _rel(PL.confusion_kl(_t(d["logits"]), 10),
         JL.confusion_kl(jnp.asarray(d["logits"]), 10))


@pytest.mark.parametrize("masked", [False, True])
def test_mnist_vae_losses_match_jax(masked):
    d = _inputs(3)
    jo, po = _outs(d, "recon01")
    w = d["w"] if masked else None
    want_t, want = JL.mnist_vae_loss(
        jo, jnp.asarray(d["x01"]), jnp.asarray(d["m_mu"][:, ::-1]),
        jnp.asarray(d["logits"]), w=None if w is None else jnp.asarray(w))
    got_t, got = PL.mnist_vae_loss(
        po, _t(d["x01"]), _t(d["m_mu"][:, ::-1].copy()), _t(d["logits"]),
        w=None if w is None else _t(w))
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], want[k])
    _rel(got_t, want_t)
    if not masked:
        want_t, want = JL.mnist_bayes_vae_loss(jo, jnp.asarray(d["x01"]),
                                               jnp.asarray(d["m"]),
                                               jnp.asarray(d["logits"]))
        got_t, got = PL.mnist_bayes_vae_loss(po, _t(d["x01"]), _t(d["m"]),
                                             _t(d["logits"]))
        for k in want:
            _rel(got[k], want[k])


@pytest.mark.parametrize("masked", [False, True])
def test_vessel_recon_terms_match_jax(masked):
    d = _inputs(4)
    w = d["w"] if masked else None
    want = JL.vessel_recon_terms(jnp.asarray(d["recon"]), jnp.asarray(d["xbin"]),
                                 None if w is None else jnp.asarray(w))
    got = PL.vessel_recon_terms(_t(d["recon"]), _t(d["xbin"]),
                                None if w is None else _t(w))
    for g, wv in zip(got, want):
        _rel(g, wv)


@pytest.mark.parametrize("masked", [False, True])
def test_vessel_loss_value_and_recon_grad_match_jax(masked):
    """The unmasked form goes through the ELBO kernel's autograd Function,
    the masked one through the plain terms; both match JAX in value and in
    the gradient with respect to the reconstruction."""
    d = _inputs(5)
    w = d["w"] if masked else None
    kw = dict(beta=0.5, lambda_morph=1e4, lambda_sparsity=0.3)

    def jax_total(recon):
        out = JaxVAEOutput(recon, *(jnp.asarray(d[k]) for k in
                                    ("m_mu", "mu", "logvar", "m_mu", "m_logvar")))
        return JL.vessel_loss(out, jnp.asarray(d["xbin"]), jnp.asarray(d["m"]),
                              w=None if w is None else jnp.asarray(w), **kw)

    (want_t, want), want_g = jax.value_and_grad(jax_total, has_aux=True)(
        jnp.asarray(d["recon"]))
    recon = _t(d["recon"]).clone().requires_grad_(True)
    out = VAEOutput(recon, *(_t(d[k]) for k in ("m_mu", "mu", "logvar", "m_mu",
                                                "m_logvar")))
    got_t, got = PL.vessel_loss(out, _t(d["xbin"]), _t(d["m"]),
                                w=None if w is None else _t(w), **kw)
    got_t.backward()
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], want[k])
    close(recon.grad, want_g, rel=1e-5, abs_=1e-7)


def test_cvae_cascade_and_vit_losses_match_jax():
    d = _inputs(6)
    jo, po = _outs(d, "recon01")
    pairs = [
        (JL.cvae_loss(*(jnp.asarray(d[k]) for k in ("recon01", "x01", "mu", "logvar"))),
         PL.cvae_loss(*(_t(d[k]) for k in ("recon01", "x01", "mu", "logvar")))),
        (JL.cascade_loss(jo, jnp.asarray(d["x01"]), jnp.asarray(d["m"])),
         PL.cascade_loss(po, _t(d["x01"]), _t(d["m"]))),
        (JL.vit_vae_loss(*(jnp.asarray(d[k]) for k in ("recon", "x01", "mu", "logvar")),
                         beta=0.7),
         PL.vit_vae_loss(*(_t(d[k]) for k in ("recon", "x01", "mu", "logvar")),
                         beta=0.7)),
    ]
    for (want_t, want), (got_t, got) in pairs:
        assert set(got) == set(want)
        _rel(got_t, want_t)
        for k in want:
            _rel(got[k], want[k])


@pytest.mark.parametrize("shape", [(3, 37, 53, 1), (2, 96, 128, 1)])
def test_elbo_terms_match_pallas_interpret_and_reference(shape):
    """Value and gradient at a ragged size (37·53·3 elements: not a multiple
    of the JAX kernel's (512, 128) block) and a block-aligned one."""
    rng = np.random.default_rng(7)
    x = (rng.random(shape) > 0.8).astype(np.float32)
    recon = rng.standard_normal(shape).astype(np.float32)

    def jax_loss(fused):
        def f(r):
            if fused:
                rl, sp = JE.vessel_recon_terms_fused(r, jnp.asarray(x), force_pallas=True)
            else:
                rl, sp = JE.reference_terms(r, jnp.asarray(x))
            return rl + 0.3 * sp, (rl, sp)

        return jax.value_and_grad(f, has_aux=True)(jnp.asarray(recon))

    r = _t(recon).clone().requires_grad_(True)
    rl, sp = PE.vessel_recon_terms_fused(r, _t(x))
    (rl + 0.3 * sp).backward()
    ref_rl, ref_sp = PE.reference_terms(_t(recon), _t(x))
    for fused in (True, False):
        (_, (want_rl, want_sp)), want_g = jax_loss(fused)
        _rel(rl, want_rl)
        _rel(sp, want_sp)
        _rel(ref_rl, want_rl)
        _rel(ref_sp, want_sp)
        close(r.grad, want_g, rel=1e-5, abs_=1e-7)


def test_elbo_pos_weight_and_x_gradient():
    """pos_weight clamps to [1, 50] with no gradient; the x gradient is the
    JAX custom VJP's."""
    assert float(PE.pos_weight(torch.zeros(10))) == 50.0
    assert float(PE.pos_weight(torch.ones(10))) == 1.0
    rng = np.random.default_rng(8)
    x = (rng.random((2, 9, 11, 1)) > 0.7).astype(np.float32)
    recon = rng.standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda xx: JE.vessel_recon_terms_fused(
        jnp.asarray(recon), xx, force_pallas=True)[0])(jnp.asarray(x))
    xt = _t(x).clone().requires_grad_(True)
    PE.vessel_recon_terms_fused(_t(recon), xt)[0].backward()
    close(xt.grad, want, rel=1e-5, abs_=1e-7)


def test_elbo_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    x = _t((rng.random((2, 5, 7, 1)) > 0.5).astype(np.float32))
    recon = _t(rng.standard_normal((2, 5, 7, 1)).astype(np.float32))
    before = PE.LAUNCHES
    out = PE.elbo_terms(recon, x, PE.pos_weight(x))
    assert torch.equal(out, PE._plain_terms(recon, x, PE.pos_weight(x)))
    assert PE.LAUNCHES == before
    with pytest.raises(ValueError, match="differ"):
        PE.elbo_terms(recon, x[:1], PE.pos_weight(x))
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PE.elbo_terms(meta, meta, torch.ones((), device="meta"))
