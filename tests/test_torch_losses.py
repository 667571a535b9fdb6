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


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> int:
    """Largest distance in bf16 steps between two bf16 arrays (the bf16 bit
    patterns read as sign-magnitude integers)."""
    def ordered(bits):
        bits = bits.astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    g = got.view(torch.int16).numpy().astype(np.uint16)
    w = np.asarray(want).view(np.uint16)
    return int(np.abs(ordered(g) - ordered(w)).max())


@pytest.mark.parametrize("shape", [(3, 37, 53, 1), (2, 96, 128, 1)])
def test_elbo_terms_bf16_recon_match_pallas_interpret_and_reference(shape):
    """A bf16 recon (the bf16 model's output, read by the kernel as it is):
    the port's terms against the JAX Pallas kernel in interpret mode and
    ``reference_terms`` on the same bf16 values, rel 1e-5; d recon, in bf16,
    within 1 bf16 ulp of JAX's (the same f32 formula, rounded to bf16 once
    on each side)."""
    rng = np.random.default_rng(11)
    x = (rng.random(shape) > 0.8).astype(np.float32)
    recon = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    r = torch.from_numpy(np.array(recon.astype(jnp.float32))).to(torch.bfloat16)
    r.requires_grad_(True)
    rl, sp = PE.vessel_recon_terms_fused(r, _t(x))
    (rl + 0.3 * sp).backward()
    assert r.grad.dtype == torch.bfloat16
    for fused in (True, False):
        def f(rr):
            if fused:
                a, b = JE.vessel_recon_terms_fused(rr, jnp.asarray(x), force_pallas=True)
            else:
                a, b = JE.reference_terms(rr, jnp.asarray(x))
            return a + 0.3 * b, (a, b)

        (_, (want_rl, want_sp)), want_g = jax.value_and_grad(f, has_aux=True)(recon)
        _rel(rl, want_rl)
        _rel(sp, want_sp)
        assert want_g.dtype == jnp.bfloat16
        assert _bf16_ulps(r.grad, want_g) <= 1


def test_elbo_pos_weight_inside_equals_given():
    """``elbo_terms(recon, x)`` (pos_weight computed with the sums, the route
    of ``vessel_recon_terms_fused``) equals ``elbo_terms(recon, x,
    pos_weight(x))``, pw included as out[2], f32 and bf16 recon; and the
    autograd function's gradients are ``elbo_terms_bwd``'s with that pw."""
    rng = np.random.default_rng(12)
    x = _t((rng.random((2, 13, 17, 1)) > 0.7).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        recon = _t(rng.standard_normal((2, 13, 17, 1)).astype(np.float32)).to(dtype)
        inside = PE.elbo_terms(recon, x)
        assert torch.equal(inside, PE.elbo_terms(recon, x, PE.pos_weight(x)))
        assert float(inside[2]) == float(PE.pos_weight(x))
        r = recon.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        rl, sp = PE.vessel_recon_terms_fused(r, xx)
        torch.autograd.backward([rl, sp], [torch.tensor(0.7), torch.tensor(0.3)])
        d_r, d_x = PE.elbo_terms_bwd(torch.tensor([0.7, 0.3, 0.0]), recon, x, inside[2],
                                     True, True)
        assert torch.equal(r.grad, d_r) and torch.equal(xx.grad, d_x)
        assert d_r.dtype == dtype and d_x.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 7, 1000, 8 * 96 * 160 + 37])
def test_elbo_offset_view_and_ragged_length(n):
    """Views offset by one element (recon and x both, recon alone) at ragged
    lengths through the plain versions: the same bits as on contiguous
    copies, forward and backward, and the JAX reference's sums (rel 1e-5)
    and custom-VJP gradient (max|Δ| <= 1e-5 max|ref|)."""
    rng = np.random.default_rng(n)
    xs = (rng.random(n + 1) > 0.9).astype(np.float32)
    rs = rng.standard_normal(n + 1).astype(np.float32)
    rs[1:1 + min(n, 3)] = [0.0, -0.0, 0.05][: min(n, 3)]  # sign at +-0
    g = torch.tensor([0.7, 0.3, 0.0])
    want_rl, want_sp = JE.reference_terms(jnp.asarray(rs[1:]), jnp.asarray(xs[1:]))

    def jax_loss(r):
        rl, sp = JE.vessel_recon_terms_fused(r, jnp.asarray(xs[1:]), force_pallas=True)
        return 0.7 * rl + 0.3 * sp

    want_g = jax.grad(jax_loss)(jnp.asarray(rs[1:]))
    r_view = torch.from_numpy(rs)[1:]
    for x_view in (torch.from_numpy(xs)[1:], torch.from_numpy(xs[1:].copy())):
        assert r_view.storage_offset() == 1
        out = PE.elbo_terms(r_view, x_view)
        assert torch.equal(out, PE.elbo_terms(r_view.clone(), x_view.clone()))
        _rel(out[0], want_rl)
        _rel(out[1], want_sp)
        d_r, d_x = PE.elbo_terms_bwd(g, r_view, x_view, out[2], True, True)
        c_r, c_x = PE.elbo_terms_bwd(g, r_view.clone(), x_view.clone(), out[2], True, True)
        assert torch.equal(d_r, c_r) and torch.equal(d_x, c_x)
        close(d_r, want_g, rel=1e-5, abs_=1e-7)


def test_elbo_backward_arguments():
    """The backward on the CPU: nothing asked gives (None, None), each output
    only where asked, in recon's and x's types (a float16 x cast back); its
    shapes and devices checked as the forward's."""
    rng = np.random.default_rng(13)
    x = _t((rng.random((3, 5)) > 0.5).astype(np.float32))
    recon = _t(rng.standard_normal((3, 5)).astype(np.float32))
    g, pw = torch.tensor([1.0, 0.5, 0.0]), PE.pos_weight(x)
    assert PE.elbo_terms_bwd(g, recon, x, pw, False, False) == (None, None)
    d_r, d_x = PE.elbo_terms_bwd(g, recon, x, pw)
    assert d_x is None and d_r.shape == recon.shape
    d_r16, d_x16 = PE.elbo_terms_bwd(g, recon, x.half(), pw, False, True)
    assert d_r16 is None and d_x16.dtype == torch.float16
    with pytest.raises(ValueError, match="differ"):
        PE.elbo_terms_bwd(g, recon, x[:1], pw)
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PE.elbo_terms_bwd(g, meta, meta, pw)
