"""The MNIST-side models at ``dtype`` bfloat16 against the JAX package's, on
the CPU: ``LatentDiscriminator`` (C2), ``SimpleClassifier`` (C3),
``DAGMechanism``, ``CausalConvVAE`` (C1, C4), ``ConditionalVAE`` (C5) and
``MDecoder`` (C6); one ``make_mnist_adversarial_step`` of C1 and of C4,
one ``make_simple_vae_step`` of C5; and the scanned trainer on the C1 bf16
step.

Both sides hold the same float32 parameters (JAX's init, perturbed, carried
across by ``from_jax_variables``), except ``DAGMechanism``, whose JAX
parameters are bf16 (it creates them in ``dtype``) and whose port leaves
are bf16 too. The JAX side is compiled without XLA's excess precision
(``test_torch_bf16._jit``: every op rounds to its dtype). The noise is
JAX's bf16 draw, passed as ``eps``.

Errors are relative as in ``tests/test_torch_bf16.py`` (mean|Δ|/mean|ref|,
max|Δ|/max|ref|). Per module, the bound (``TOL``) is ~1.3-2x the worst
reading here [in brackets: bf16 port against bf16 JAX; then the f32
control, which must miss the mean bound]:

- the images (C1, C4, C5, C6 ``recon``): mean 2e-3, max 1e-2 [<= 1.65e-3,
  4.2e-3; control >= 2.55e-3];
- the other outputs of C1, C4, C5 (mu, logvar, m_hat, m_mu, m_logvar), the
  classifier's feature and log-probabilities, and the discriminator's
  logits: mean 1.2e-3 (the discriminator 2.5e-3), max 1e-2 [equal bits
  but C5's mu 1e-5 and the classifier's log-probabilities 5.8e-4, the
  discriminator 1.3e-3; control >= 2.25e-3, the discriminator's 4.8e-3];
- ``DAGMechanism`` (deterministic and Gaussian): mean 5e-4, max 2e-3
  [equal bits; control >= 1.0e-3].

The steps, batch 8, held by group [bf16 port against bf16 JAX; then the
port's f32 step, the control]:

- the loss terms, relative: loss 6e-4, recon 6e-4, kld 5e-4, morph 1e-5,
  adv 5e-3, d_loss 1e-3 [<= 2.8e-4, 2.4e-4, 1.8e-4, 1.8e-7, 2.15e-3,
  3.4e-4; control misses kld (2.1e-3) and morph (>= 2.4e-5) in C1 and C4];
- each VAE weight, relative L2: 3e-2 [<= 1.6e-2; control up to 8e-2, the
  encoder's convolutions missing in all three models];
- each VAE bias but the last transposed conv's: 0.15 [<= 6.5e-2, as the
  control's];
- the last transposed conv's bias: its gradient is the sum of the image's
  cotangent over 8·784 entries, which JAX sums in bfloat16 (3.2-3.9x off
  its own f32 sum). Held to the port's f32 step instead, at 5% [< 1%];
- the discriminator's output layer, relative L2: 3.5e-3 [<= 2.3e-3;
  control 4.7e-3]; its hidden layers 0.15 [~0.1: JAX's bf16 backward of
  the discriminator on this batch lands 9% from its own f32 one, where the
  port's bf16 and f32 agree to 0.3%].

The scanned trainer (``train/scan_loop.py``; on the CPU its program loops
the eager step) runs the C1 bf16 step bit for bit as the eager steps do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from causalvae_tpu.config import MnistConfig as JaxMnistConfig
from causalvae_tpu.models import heads as jheads
from causalvae_tpu.models import mechanism as jmech
from causalvae_tpu.models import vae as jvae
from causalvae_tpu.ops import losses as JL
from causalvae_tpu.train.loop import make_mnist_adversarial_step as jax_adv_step
from causalvae_tpu.train.loop import make_simple_vae_step as jax_simple_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.config import MnistConfig
from causalvae_tpu_torch.models import heads as pheads
from causalvae_tpu_torch.models import mechanism as pmech
from causalvae_tpu_torch.models import vae as pvae
from causalvae_tpu_torch.ops import losses as L
from causalvae_tpu_torch.train import scan_loop as PS
from causalvae_tpu_torch.train.loop import make_mnist_adversarial_step, make_simple_vae_step
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from test_torch_bf16 import _apply, _bf16_values, _errs, _jit, _t
from torch_port_helpers import init_jax, load_port, to_numpy_tree, two_threads  # noqa: F401

BF = torch.bfloat16
B = 8
TOL = {"recon": (2e-3, 1e-2), "out": (1.2e-3, 1e-2), "disc": (2.5e-3, 1e-2),
       "dag": (5e-4, 2e-3)}
TERMS_REL = {"loss": 6e-4, "recon": 6e-4, "kld": 5e-4, "morph": 1e-5, "adv": 5e-3,
             "d_loss": 1e-3}
WEIGHT_L2, BIAS_L2, LAST_BIAS_REL = 3e-2, 0.15, 5e-2
DISC_OUT_L2, DISC_HIDDEN_L2 = 3.5e-3, 0.15
GRAPH = (("t", 3), ("m", 4), ("u", 2))
ADJ = np.array([[0, 1, 1], [0, 0, 1], [0, 0, 0]], np.float32)


def _pair(make_port, variables, call):
    """``call`` of the port module in bf16 and in f32 (the control)."""
    out = {}
    for dt in (BF, torch.float32):
        m = load_port(make_port(dt), variables)
        with torch.no_grad():
            out[dt] = call(m)
    return out[BF], out[torch.float32]


def _hold(got, control, want, tol):
    mean, mx = _errs(got, want)
    assert got.dtype == BF and str(want.dtype) == "bfloat16", (got.dtype, want.dtype)
    assert mean <= tol[0] and mx <= tol[1], f"mean {mean:.3e} max {mx:.3e} vs {tol}"
    assert control.dtype == torch.float32
    assert _errs(control, want)[0] > tol[0], "the f32 control meets the bf16 bound"


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((B, 28, 28, 1), dtype=np.float32),
            rng.standard_normal((B, 12)).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)])


def test_latent_discriminator_bf16_matches_jax():
    z = _bf16_values(np.random.default_rng(0).standard_normal((16, 10)))
    v = init_jax(jheads.LatentDiscriminator(), jnp.zeros((1, 10)), seed=1, jit=True)
    want = _apply(jheads.LatentDiscriminator(dtype=jnp.bfloat16), v, jnp.asarray(z))
    got, control = _pair(lambda dt: pheads.LatentDiscriminator(dtype=dt, device="cpu"), v,
                         lambda m: m(_t(z)))
    _hold(got, control, want, TOL["disc"])


def test_simple_classifier_bf16_matches_jax():
    """The feature and the log-probabilities, which JAX's max-pools and
    log-softmax compute in bf16."""
    x = _inputs()[0]
    v = init_jax(jheads.SimpleClassifier(), jnp.zeros((1, 28, 28, 1)), seed=2, jit=True)
    want = _apply(jheads.SimpleClassifier(dtype=jnp.bfloat16), v, jnp.asarray(x))
    got, control = _pair(lambda dt: pheads.SimpleClassifier(dtype=dt, device="cpu"), v,
                         lambda m: m(_t(x)))
    for g, c, w in zip(got, control, want):
        _hold(g, c, w, TOL["out"])


@pytest.mark.parametrize("gaussian", [False, True])
def test_dag_mechanism_bf16_matches_jax(gaussian):
    """JAX creates the parameters in bf16: carried across as bf16 leaves
    (``from_jax_variables`` widens them to float32 on the way, exactly)."""
    vals = _bf16_values(np.random.default_rng(1).standard_normal((16, 9)))
    jm = jmech.DAGMechanism(factors=GRAPH, adjacency=ADJ, hidden=48, gaussian=gaussian,
                            dtype=jnp.bfloat16)
    v = init_jax(jm, jnp.zeros((1, 9)), seed=3, jit=True)
    v = to_numpy_tree(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v))
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(v)} == {"bfloat16"}
    want = _apply(jm, v, jnp.asarray(vals))
    port = pmech.DAGMechanism(GRAPH, ADJ, hidden=48, gaussian=gaussian, dtype=BF)
    state = from_jax_variables(port, v)
    assert {t.dtype for t in state.values()} == {BF}
    got, control = _pair(lambda dt: pmech.DAGMechanism(GRAPH, ADJ, hidden=48,
                                                       gaussian=gaussian, dtype=dt),
                         v, lambda m: m(_t(vals)))
    for g, c, w in zip(*(o if gaussian else (o,) for o in (got, control, want))):
        _hold(g, c, w, TOL["dag"])


def _outputs(out):
    return tuple(a for a in out if a is not None)


@pytest.mark.parametrize("family", ["C1", "C4", "C5", "C6"])
def test_mnist_vae_bf16_matches_jax(family):
    """The whole model in bf16 with JAX's bf16 noise: the image at the
    ``recon`` bound, every other output at ``out``'s."""
    x, m, t = _inputs(1)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, (B, 10), jnp.bfloat16).astype(jnp.float32))
    if family in ("C1", "C4"):
        kw = dict(gaussian_mechanism=family == "C4", decode_real_m=family == "C4")
        v = _conv_vae_variables(family == "C4")
        want = _outputs(_apply(jvae.CausalConvVAE(**kw, dtype=jnp.bfloat16), v, jnp.asarray(x),
                               jnp.asarray(m), jnp.asarray(t), rng=key))
        got, control = _pair(lambda dt: pvae.CausalConvVAE(**kw, dtype=dt, device="cpu"), v,
                             lambda mm: _outputs(mm(_t(x), _t(m), _t(t), eps=_t(eps))))
    elif family == "C5":
        v = init_jax(jvae.ConditionalVAE(), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, 10)),
                     rng=key, seed=6, jit=True)
        want = _apply(jvae.ConditionalVAE(dtype=jnp.bfloat16), v, jnp.asarray(x),
                      jnp.asarray(t), rng=key)
        got, control = _pair(lambda dt: pvae.ConditionalVAE(dtype=dt, device="cpu"), v,
                             lambda mm: mm(_t(x), _t(t), eps=_t(eps)))
    else:
        v = init_jax(jvae.MDecoder(), jnp.zeros((1, 12)), jnp.zeros((1, 10)), seed=8, jit=True)
        want = (_apply(jvae.MDecoder(dtype=jnp.bfloat16), v, jnp.asarray(m), jnp.asarray(t)),)
        got, control = _pair(lambda dt: pvae.MDecoder(12, 10, dtype=dt, device="cpu"), v,
                             lambda mm: (mm(_t(m), _t(t)),))
    assert len(got) == len(want)
    for i, (g, c, w) in enumerate(zip(got, control, want)):
        _hold(g, c, w, TOL["recon" if i == 0 else "out"])


def _capture():
    """A pass-through optax stage that keeps the gradients in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _step_batch():
    rng = np.random.default_rng(0)
    return {"x": (rng.random((B, 28, 28, 1)) > 0.7).astype(np.float32),
            "m": rng.standard_normal((B, 12)).astype(np.float32),
            "t": np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]}


def _bf16_draws(keys, z):
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        k, (B, z), jnp.bfloat16).astype(jnp.float32)) for k in keys]))


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _vae_misses(model, want, last_bias, f32_grads=None):
    """The VAE's leaves whose gradient breaks its group's bound; the last
    transposed conv's bias is held to ``f32_grads`` (the port's f32 step)."""
    missed = []
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        if name == last_bias:
            if f32_grads is not None:
                ref = float(f32_grads[name].double().sum())
                if abs(float(p.grad.double().sum()) - ref) > LAST_BIAS_REL * abs(ref):
                    missed.append(name)
        elif _rel_l2(p.grad, want[name]) > (BIAS_L2 if name.endswith("bias") else WEIGHT_L2):
            missed.append(name)
    return missed


def _term_misses(met, jmet):
    assert set(met) == set(jmet)
    return [k for k in jmet
            if abs(float(met[k]) - float(jmet[k])) > TERMS_REL[k] * abs(float(jmet[k]))]


@functools.lru_cache(maxsize=None)
def _conv_vae_variables(bayes):
    """C1's (C4's with ``bayes``) JAX variables, perturbed."""
    kw = dict(gaussian_mechanism=bayes, decode_real_m=bayes)
    return init_jax(jvae.CausalConvVAE(**kw), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, 12)),
                    jnp.zeros((1, 10)), rng=jax.random.PRNGKey(0), seed=0, jit=True)


@functools.lru_cache(maxsize=None)
def _jax_adv_step(bayes):
    """JAX's bf16 adversarial step: (VAE variables, D variables, metrics,
    VAE gradients, D gradients, noise)."""
    kw = dict(gaussian_mechanism=bayes, decode_real_m=bayes)
    jcfg = JaxMnistConfig()
    vv = _conv_vae_variables(bayes)
    dv = init_jax(jheads.LatentDiscriminator(), jnp.zeros((1, jcfg.z_dim)), seed=10, jit=True)
    tx = optax.chain(_capture(), optax.adam(jcfg.lr))
    key = jax.random.PRNGKey(3)
    step = jax_adv_step(jvae.CausalConvVAE(**kw, dtype=jnp.bfloat16),
                        jheads.LatentDiscriminator(dtype=jnp.bfloat16), jcfg, bayesian=bayes)
    vs, ds, jmet = _jit(step, TrainState.create(vv, tx), TrainState.create(dv, tx),
                        {k: jnp.asarray(a) for k, a in _step_batch().items()}, key)
    return (vv, dv, {k: float(a) for k, a in jmet.items()}, to_numpy_tree(vs.opt_state[0]),
            to_numpy_tree(ds.opt_state[0]), _bf16_draws(jax.random.split(key, 4), jcfg.z_dim))


def _port_adv_step(bayes, dtype):
    vv, dv, _, _, _, eps = _jax_adv_step(bayes)
    cfg = MnistConfig()
    kw = dict(gaussian_mechanism=bayes, decode_real_m=bayes)
    pv = load_port(pvae.CausalConvVAE(**kw, dtype=dtype, device="cpu"), vv)
    pd = load_port(pheads.LatentDiscriminator(dtype=dtype, device="cpu"), dv)
    step = make_mnist_adversarial_step(
        pv, pd, ClippedAdam(pv.parameters(), cfg.lr, None, torch.float32),
        ClippedAdam(pd.parameters(), cfg.lr, None, torch.float32), cfg, bayesian=bayes)
    met = step({k: torch.from_numpy(a) for k, a in _step_batch().items()}, eps=eps)
    return met, pv, pd


@pytest.mark.parametrize("bayes", [False, True], ids=["C1", "C4"])
def test_adversarial_step_bf16_matches_jax(bayes):
    _, _, jmet, jvg, jdg, _ = _jax_adv_step(bayes)
    met, pv, pd = _port_adv_step(bayes, BF)
    met32, pv32, pd32 = _port_adv_step(bayes, torch.float32)
    vae_want = from_jax_variables(pv, {"params": jvg})
    disc_want = from_jax_variables(pd, {"params": jdg})
    f32 = {n: p.grad for n, p in pv32.named_parameters()}
    assert _term_misses(met, jmet) == []
    assert _vae_misses(pv, vae_want, "dec_conv2.bias", f32) == []
    for name, p in pd.named_parameters():
        bound = DISC_OUT_L2 if name.startswith("out.") else DISC_HIDDEN_L2
        assert _rel_l2(p.grad, disc_want[name]) <= bound, name

    # the control: the f32 step misses kld, morph and the encoder's weights
    assert {"kld", "morph"} <= set(_term_misses(met32, jmet))
    assert {"enc_conv1.weight", "enc_conv2.weight"} <= set(
        _vae_misses(pv32, vae_want, "dec_conv2.bias"))
    assert _rel_l2(pd32.out.weight.grad, disc_want["out.weight"]) > DISC_OUT_L2


def test_simple_vae_step_bf16_matches_jax():
    """C5's ``make_simple_vae_step`` in bf16 (BCE + KLD), with JAX's bf16
    noise on its ``r_model`` key."""
    x, _, t = _inputs(2)
    b = {"x": (x > 0.7).astype(np.float32), "t": t}
    v = init_jax(jvae.ConditionalVAE(), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, 10)),
                 rng=jax.random.PRNGKey(0), seed=6, jit=True)
    key = jax.random.PRNGKey(9)

    def jloss(out, batch):
        recon, mu, logvar = out
        return JL.cvae_loss(recon, batch["x"], mu, logvar, beta=1.0)

    state, jmet = _jit(jax_simple_step(jvae.ConditionalVAE(dtype=jnp.bfloat16), jloss),
                       TrainState.create(v, optax.chain(_capture(), optax.adam(1e-3))),
                       {k: jnp.asarray(a) for k, a in b.items()}, key)
    eps = _bf16_draws(jax.random.split(key)[:1], 10)[0]

    def ploss(out, batch):
        recon, mu, logvar = out
        return L.cvae_loss(recon, batch["x"], mu, logvar, beta=1.0)

    runs = {}
    for dt in (BF, torch.float32):
        pm = load_port(pvae.ConditionalVAE(dtype=dt, device="cpu"), v)
        met = make_simple_vae_step(pm, ploss, ClippedAdam(pm.parameters(), 1e-3, None,
                                                          torch.float32))(
            {k: torch.from_numpy(a) for k, a in b.items()}, eps=eps)
        runs[dt] = (met, pm)
    want = from_jax_variables(runs[BF][1], {"params": to_numpy_tree(state.opt_state[0])})
    f32 = {n: p.grad for n, p in runs[torch.float32][1].named_parameters()}
    assert _term_misses(runs[BF][0], jmet) == []
    assert _vae_misses(runs[BF][1], want, "dec_conv2.bias", f32) == []
    assert {"enc_conv1.weight", "dec_fc.weight"} <= set(
        _vae_misses(runs[torch.float32][1], want, "dec_conv2.bias"))


def _c1_bf16_run(scan):
    """Six C1 bf16 steps from flax_init_, eager or through the scanned
    trainer (S = 4: a group and a ragged tail), noise drawn from one CPU
    generator."""
    cfg = MnistConfig()
    vae = pvae.flax_init_(pvae.CausalConvVAE(dtype=BF, device="cpu"), 0)
    disc = pvae.flax_init_(pheads.LatentDiscriminator(dtype=BF, device="cpu"), 1)
    vopt = ClippedAdam(vae.parameters(), cfg.lr, None, torch.float32)
    dopt = ClippedAdam(disc.parameters(), cfg.lr, None, torch.float32)
    step = make_mnist_adversarial_step(vae, disc, vopt, dopt, cfg)
    rng = np.random.default_rng(4)
    batches = [{k: torch.from_numpy(a) for k, a in _step_batch().items()} for _ in range(6)]
    for b in batches:
        b["x"] = b["x"][torch.from_numpy(rng.permutation(B))]
    gen = torch.Generator().manual_seed(2)
    if scan:
        last = PS.ScanTrainer(step, 2, 4).run_epoch([(vae, vopt), (disc, dopt)], iter(batches),
                                                    gen)
    else:
        for b in batches:
            last = step(b, generator=gen)
    return last, vae.state_dict(), disc.state_dict(), vopt.state_dict(), gen.get_state()


def test_scanned_c1_bf16_step_equals_eager_bit_for_bit():
    eager, scanned = _c1_bf16_run(False), _c1_bf16_run(True)
    for k, v in eager[0].items():
        assert torch.equal(scanned[0][k], v), k
    for e, s in zip(eager[1:3], scanned[1:3]):
        for k, v in e.items():
            assert torch.equal(s[k], v), k
    for k, st in eager[3]["state"].items():
        for kk, t in st.items():
            assert torch.equal(scanned[3]["state"][k][kk], t), (k, kk)
    assert torch.equal(eager[4], scanned[4])
