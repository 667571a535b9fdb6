"""The port at ``compute_dtype`` bfloat16 against the JAX package at
``dtype=jnp.bfloat16``, and ``remat_blocks``, on the CPU.

Both sides hold the same float32 parameters (the JAX init, perturbed,
carried over by ``from_jax_variables``) and take the same inputs, already
rounded to bfloat16 where the model feeds a module a bfloat16 tensor. The
JAX attention runs its Pallas kernel in interpret mode (``flash_attention``
forced to it by the ``pallas_attention`` fixture; on the CPU the JAX package
would take its XLA formulation, whose dropout mask is not the hash), except
in the f32 remat step, which keeps tests/test_torch_train.py's setting.
The JAX side is compiled without XLA's excess precision (``_jit``), so
every op rounds its result to bf16 as op-by-op dispatch does (equal bits),
the rounding a bf16 flax model defines and the port follows. That kernel rounds the
probabilities to bfloat16 before P·V; the port's plain version keeps them
in float32, so attention agrees less closely than the other layers.

Errors are relative: ``mean`` is mean|Δ| / mean|ref| and ``max`` is
max|Δ| / max|ref|. Per module (``TOL``), each bound is about 2-3x the
worst reading of this file's cases (readings in brackets, bf16 port
against bf16 JAX; then the f32 control):

- ResBlock, spatial and NHWC at levels 0 and 1, with and without the stage
  op, train and eval: mean 1.5e-3, max 1.6e-2 [mean <= 5.7e-4, max <=
  5.4e-3; the fused stages bit for bit]; control mean >= 2.6e-3;
- MultiHeadAttention, dropout 0 and 0.1: mean 4e-3 [<= 2.3e-3]; control
  >= 6.2e-3;
- ViTBlock (eval): mean 3e-3 [2.1e-3]; control 4.2e-3;
- MorphPredictor: mean 2.5e-3 [1.1e-3]; control 4.6e-3;
- the stem (``tokens`` at depth 0): eval mean 1e-3 [<= 1.6e-4], train mean
  4e-3 [<= 2.2e-3], max 1.6e-2; control eval 2.4e-3, train 6.5e-3;
- BatchNorm (2-D and 4-D, train and eval): equal bits and dtype; the f32
  module misses that in eval.

The control is the port's float32 module on the same inputs: it must miss
the mean bound, so these tests tell bfloat16 semantics from float32.

Deeper, the rounding differences compound and the control lands as close
to JAX's bfloat16 result as the port's bfloat16 does, so the decoder, the
whole model and the step are held to bounds alone, with every output
bfloat16 and every gradient float32:

- decoder (``decode``, spatial and packed-fused): eval mean 5e-3, max 2e-2
  [<= 2.0e-3, 5.9e-3]; train mean 2e-2, max 4e-2 [<= 9.2e-3, 1.5e-2];
- the whole CausalViTVAE at depth 2, batch 8: eval mean 1.5e-2, max 3e-2
  [<= 8.5e-3, 1.3e-2]; train mean 4e-2, max 6e-2 [<= 2.2e-2, 2.9e-2];
- one ``make_vae_step`` at batch 8 (dropout 0, the same noise), held by
  group, each group's bound set from its readings (the port's bf16 step
  against JAX's; then the port's f32 step, the control, against JAX's
  bf16 one):

  - the loss terms, relative: loss 1.5e-4 [5.9e-5; control 2.5e-4], morph
    1e-4 [2.7e-5; 2.1e-4], recon 6e-4 [3.0e-4; 6.2e-4], sparsity 1.5e-4
    [6.3e-5; 9.0e-5], kld 3e-3 [1.3e-3; 6.8e-4];
  - the output layers' gradients (``morph.mu``, ``morph.logvar``,
    ``dec_out.weight``: one op from the loss), relative L2 of the group
    4e-3 [3.0e-3; 5.0e-3];
  - the rest of the morphology head (no BatchNorm backward): mean 1e-2 per
    leaf [<= 4.3e-3];
  - relative L2 per leaf: the ViT blocks' Dense and LayerNorm leaves 0.4
    [<= 0.32; control up to 0.50], the adapters 0.35 [<= 0.24], the other
    leaves (stem, tokens, decoder, BatchNorms) 0.45 [<= 0.34]; the median of
    those 88 leaves 0.3 [0.23].

  The control misses the loss and morph terms, the output layers and one
  ViT block leaf, so the step tells bf16 from f32. Below the BatchNorm
  chain the two frameworks' bf16 gradients differ from each other by about
  as much as each differs from f32 (JAX's bf16 against JAX's f32: median
  0.24), which is why those bounds are wide; a leaf's gradient scaled by
  1.5 misses them (95 of the 96 leaves held, all but stem_bns.3.scale). Not held to JAX: the biases of the convolutions and Dense layers
  that feed a BatchNorm, whose gradient is 0 up to rounding; and
  ``dec_out.bias``, whose gradient is the sum of the output's cotangent
  over the batch and the image. The f64 sum of JAX's own bf16 cotangent
  (406.48) is the witness: the port's bf16 step gives 400, within 3%
  [1.6%], and JAX's bf16 step -15616 (its bf16 reduction of 49152 terms).

``remat_blocks``: the port's step with it equals the step without it bit for
bit (loss, every gradient, the updated parameters), and leaves its own
generator and torch's default one in the same state; in f32 its step
equals JAX's ``remat_blocks=True`` step within ``tests/test_torch_train.py``'s
tolerances. The CLI's ``--dtype``, and the serving endpoints' output dtypes
at bf16 (JAX's), end the file.
"""

import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.config import VesselConfig as JaxVesselConfig
from causalvae_tpu.models import mechanism as jmech
from causalvae_tpu.models import vit as jvit
from causalvae_tpu.models.vae import VAEOutput as JaxVAEOutput
from causalvae_tpu.ops import losses as JL
from causalvae_tpu.ops.kernels import attention as jattn
from causalvae_tpu.ops.kernels import batchnorm as jbn
from causalvae_tpu.serve.endpoints import vae_endpoints as jax_endpoints

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.models import vit as pvit
from causalvae_tpu_torch.models.mechanism import MorphPredictor
from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm
from causalvae_tpu_torch.serve.endpoints import vae_endpoints
from causalvae_tpu_torch.serve.engine import BatchingEngine
from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from test_torch_train import _grad_rel
from torch_port_helpers import SMALL, inputs, load_port, perturb, to_numpy_tree

BF = torch.bfloat16
TOL = {  # (mean, max) relative bounds, see the docstring
    "resblock": (1.5e-3, 1.6e-2), "attention": (4e-3, 1.6e-2),
    "vit_block": (3e-3, 1.6e-2), "morph": (2.5e-3, 1.6e-2),
    "stem_eval": (1e-3, 1.6e-2), "stem_train": (4e-3, 1.6e-2),
    "decoder_eval": (5e-3, 2e-2), "decoder_train": (2e-2, 4e-2),
    "model_eval": (1.5e-2, 3e-2), "model_train": (4e-2, 6e-2),
}
STEP_TERMS_REL = {"loss": 1.5e-4, "morph": 1e-4, "recon": 6e-4, "sparsity": 1.5e-4,
                  "kld": 3e-3}
OUTPUT_GRADS = re.compile(r"morph\.(mu|logvar)\..*|backbone\.dec_out\.weight")
OUTPUT_GRAD_L2, MORPH_GRAD_MEAN, GRAD_L2_MEDIAN, DEC_OUT_BIAS_REL = 4e-3, 1e-2, 0.3, 3e-2
GRAD_L2 = ((re.compile(r"backbone\.blocks\.\d\..*"), 0.4),  # per leaf, the first match
           (re.compile(r"(enc|dec)_adapter_.*"), 0.35), (re.compile(r".*"), 0.45))
SEEDS = []  # the dropout seeds the JAX attention was called with


@pytest.fixture
def pallas_attention(monkeypatch):
    """JAX's attention through its Pallas kernel in interpret mode, recording
    the dropout seed it draws (the port's module then takes that seed)."""
    real = jattn.flash_attention

    def forced(q, k, v, *, dropout_rate=0.0, dropout_seed=None, force_pallas=False):
        if dropout_seed is not None:
            SEEDS.append(int(dropout_seed))
        return real(q, k, v, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                    force_pallas=True)

    SEEDS.clear()
    monkeypatch.setattr(jattn, "flash_attention", forced)


def _init(module, *args, seed=0, **kw):
    """torch_port_helpers.init_jax with the init jitted (JAX's eager CPU
    dispatch compiles every op of a first call)."""
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(functools.partial(module.init, **kw))(
        {"params": key, "dropout": key}, *args)
    return perturb(variables, seed + 1)


def _jit(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: every op rounds
    its result to its dtype, as op-by-op dispatch does (flax's definition of
    the bf16 model, equal bits); the default ``jit`` may keep a fused chain
    of bf16 ops in f32."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _apply(module, variables, *args, **kw):
    """``module.apply(variables, *args, **kw)`` through ``_jit``."""
    return _jit(functools.partial(module.apply, **kw), variables, *args)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bf16_values(a):
    """float32 numpy holding the bfloat16 rounding of ``a``."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _errs(got, want):
    """(mean|Δ|/mean|ref|, max|Δ|/max|ref|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.float32) - want)
    return float(d.mean() / np.abs(want).mean()), float(d.max() / np.abs(want).max())


def _held(got, want, tol):
    mean, mx = _errs(got, want)
    assert got.dtype == BF and str(want.dtype) == "bfloat16", (got.dtype, want.dtype)
    assert mean <= tol[0] and mx <= tol[1], f"mean {mean:.3e} max {mx:.3e} vs {tol}"


def _control_misses(got, want, tol):
    mean, _ = _errs(got, want)
    assert got.dtype == torch.float32
    assert mean > tol[0], f"the f32 control meets the bf16 bound: mean {mean:.3e} <= {tol[0]}"


def _pair(make_port, variables, train, call):
    """The port module in bf16 and in f32 (the control), both run by
    ``call(module, dtype)`` without gradient."""
    out = {}
    for dt in (BF, torch.float32):
        m = load_port(make_port(dt), variables).train(train)
        with torch.no_grad():
            out[dt] = call(m, dt)
    return out[BF], out[torch.float32]


@functools.lru_cache(maxsize=None)
def _resblock_variables(c):
    """A ResBlock's variables (the same tree at every packing level)."""
    return _init(jvit.ResBlock(c), jnp.zeros((2, 6, 10, c)))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("levels,prologue,fused", [
    (None, False, False), (0, False, False), (0, True, False), (0, False, True),
    (0, True, True), (1, False, False), (1, True, False), (1, False, True), (1, True, True)])
def test_resblock_bf16_matches_jax(levels, prologue, fused, train):
    """ResBlock in bf16: the spatial form (levels None) and the JAX call at
    packing levels 0 and 1, with a preceding BatchNorm's prologue and with
    the internal one fused (the stage op), train and eval."""
    c, lv = 8, levels or 0
    rng = np.random.default_rng(10 * lv + 2 * prologue + fused)
    x = _bf16_values(rng.standard_normal((2, 6, 10, c * 4 ** lv)))
    v = _resblock_variables(c)
    pro = None
    if prologue:
        pro = ((rng.random(c * 4 ** lv) + 0.5).astype(np.float32),
               rng.standard_normal(c * 4 ** lv).astype(np.float32), 0.01)
    jm = jvit.ResBlock(c, dtype=jnp.bfloat16)
    jpro = None if pro is None else (jnp.asarray(pro[0]), jnp.asarray(pro[1]), 0.01)
    xb = jnp.asarray(x, jnp.bfloat16)
    if train:
        want, _ = _apply(jm, v, xb, train=True, levels=lv, prologue=jpro, fused=fused,
                         mutable=["batch_stats"])
    else:
        want = _apply(jm, v, xb, levels=lv, prologue=jpro, fused=fused)

    def call(m, dt):
        if levels is None:
            return m(_t(x, dt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ppro = None if pro is None else (_t(pro[0]), _t(pro[1]), 0.01)
        return m.nhwc(_t(x, dt), levels=lv, prologue=ppro, fused=fused)

    got, control = _pair(lambda dt: pvit.ResBlock(c, dt), v, train, call)
    _held(got, want, TOL["resblock"])
    _control_misses(control, want, TOL["resblock"])


@pytest.mark.parametrize("rate,train", [(0.0, False), (0.0, True), (0.1, True)])
def test_attention_bf16_matches_jax(pallas_attention, rate, train):
    """MultiHeadAttention in bf16 against JAX's with the Pallas kernel; with
    dropout the port takes the seed JAX drew (the hash mask is the same)."""
    x = _bf16_values(np.random.default_rng(1).standard_normal((2, 17, 32)))
    v = _init(jvit.MultiHeadAttention(32, 4, rate), jnp.asarray(x))
    want = jvit.MultiHeadAttention(32, 4, rate, dtype=jnp.bfloat16).apply(  # op by op: the
        v, jnp.asarray(x, jnp.bfloat16), train=train,     # seed JAX draws is read out
        rngs={"dropout": jax.random.PRNGKey(3)})
    seed = SEEDS[-1] if rate and train else None
    assert (seed is not None) == bool(rate and train)
    got, control = _pair(lambda dt: pvit.MultiHeadAttention(32, 4, rate, dt), v, train,
                         lambda m, dt: m(_t(x, dt), seed=seed))
    _held(got, want, TOL["attention"])
    _control_misses(control, want, TOL["attention"])


def test_vit_block_bf16_matches_jax(pallas_attention):
    """ViTBlock in bf16 (LayerNorms in f32 with a bf16 output, exact GELU on
    bf16), eval."""
    x = _bf16_values(np.random.default_rng(2).standard_normal((2, 17, 32)))
    v = _init(jvit.ViTBlock(32, 4, 64), jnp.asarray(x))
    want = _apply(jvit.ViTBlock(32, 4, 64, dtype=jnp.bfloat16), v, jnp.asarray(x, jnp.bfloat16))
    got, control = _pair(lambda dt: pvit.ViTBlock(32, 4, 64, 0.1, dt), v, False,
                         lambda m, dt: m(_t(x, dt)))
    _held(got, want, TOL["vit_block"])
    _control_misses(control, want, TOL["vit_block"])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(6, 16), (3, 5, 7, 6)])
def test_batchnorm_bf16_matches_jax_bit_for_bit(shape, train):
    """BatchNorm(dtype=bf16) on a bf16 input: statistics and affine in f32,
    the output cast to bf16, equal to JAX's bits; the running statistics
    stay f32. The f32 module's output (f32) differs in eval."""
    x = _bf16_values((np.random.default_rng(4).standard_normal(shape) * 2 + 1))
    v = _init(jbn.BatchNorm(), jnp.asarray(x), use_running_average=True)
    jm, xb = jbn.BatchNorm(dtype=jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    if train:
        want, mut = _apply(jm, v, xb, use_running_average=False, mutable=["batch_stats"])
    else:
        want = _apply(jm, v, xb, use_running_average=True)
    spatial = len(shape) == 4

    def call(m, dt):
        xin = _t(x, BF).permute(0, 3, 1, 2) if spatial else _t(x, BF)
        y = m(xin)
        return (y.permute(0, 2, 3, 1) if spatial else y), m

    (got, pm), (control, _) = _pair(lambda dt: BatchNorm(shape[-1], dtype=dt), v, train, call)
    assert got.dtype == BF and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert pm.mean.dtype == pm.var.dtype == pm.scale.dtype == torch.float32
    if train:
        np.testing.assert_allclose(pm.mean.numpy(), mut["batch_stats"]["mean"], rtol=1e-5)
        np.testing.assert_allclose(pm.var.numpy(), mut["batch_stats"]["var"], rtol=1e-5)
    else:
        assert control.dtype == torch.float32 and not np.array_equal(
            control.numpy(), np.asarray(want.astype(jnp.float32)))


def test_morph_predictor_bf16_matches_jax():
    t = np.eye(19, dtype=np.float32)[[0, 3, 7, 18]]
    kw = dict(m_dim=12, hidden=(64, 64), gaussian=True, activation="leaky_relu",
              logvar_clip=10.0)
    v = _init(jmech.MorphPredictor(**kw), jnp.asarray(t))
    want = _apply(jmech.MorphPredictor(**kw, dtype=jnp.bfloat16), v, jnp.asarray(t))
    port_kw = {k: a for k, a in kw.items() if k != "m_dim"}
    got, control = _pair(lambda dt: MorphPredictor(19, 12, **port_kw, dtype=dt), v, False,
                         lambda m, dt: m(_t(t)))
    for g, c, w in zip(got, control, want):
        _held(g, w, TOL["morph"])
        _control_misses(c, w, TOL["morph"])


VIT = dict(img_size=(64, 96), latent_dim=32, embed_dim=32, heads=4, mlp_dim=64, dropout=0.0)


@pytest.mark.parametrize("layout", [dict(packed=False), dict(packed=True, fused_stages=True)])
def test_stem_and_decoder_bf16_match_jax(pallas_attention, layout):
    """The stem (``tokens`` of a depth-0 ViTVAE, the CLS row left out) and the
    decoder (``decode`` of a latent), spatial and packed-fused, eval and
    train (batch 8); the stem also against the f32 control."""
    kw = dict(VIT, depth=0, **layout)
    v = _init(jvit.ViTVAE(**kw), jnp.zeros((1, 64, 96, 1)), rng=jax.random.PRNGKey(0),
                 seed=3)
    jm = jvit.ViTVAE(**kw, dtype=jnp.bfloat16)
    x, _, _ = inputs(8, seed=2)
    z = np.random.default_rng(1).standard_normal((8, 32)).astype(np.float32)
    for train in (False, True):
        mode = "train" if train else "eval"
        if train:
            tok, _ = _apply(jm, v, x, train=True, method=jm.tokens, mutable=["batch_stats"])
            rec, _ = _apply(jm, v, z, train=True, method=jm.decode, mutable=["batch_stats"])
        else:
            tok = _apply(jm, v, x, method=jm.tokens)
            rec = _apply(jm, v, z, method=jm.decode)
        (g_tok, g_rec), (c_tok, _) = _pair(
            lambda dt: pvit.ViTVAE(**kw, dtype=dt, device="cpu"), v, train,
            lambda m, dt: (m.tokens(_t(x)), m.decode(_t(z))))
        _held(g_tok[:, 1:], tok[:, 1:], TOL[f"stem_{mode}"])
        _control_misses(c_tok[:, 1:], tok[:, 1:], TOL[f"stem_{mode}"])
        _held(g_rec, rec, TOL[f"decoder_{mode}"])


def _jax_fwd(mdl, x, m, t, eps, train=False):
    """The JAX forward with given noise, drawn as ``reparameterize`` draws it:
    in mu's dtype."""
    mu, logvar = mdl.encode(x, m, t, train=train)
    z = mu + eps.astype(mu.dtype) * jnp.exp(0.5 * logvar)
    m_mu, m_logvar = mdl.morph(t)
    recon = mdl.decode(m.astype(z.dtype), z, train=train)
    return JaxVAEOutput(recon, m_mu, mu, logvar, m_mu, m_logvar)


@functools.lru_cache(maxsize=None)
def _small_variables():
    """The SMALL model's perturbed JAX variables (tests/test_torch_train.py's
    model and seed); the packed and remat models have the same tree."""
    h, w = SMALL["img_size"]
    jm = jvit.CausalViTVAE(**SMALL, dropout=0.0, packed=False)
    return _init(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)), jnp.zeros((1, 19)),
                    rng=jax.random.PRNGKey(0), train=False, seed=0)


@pytest.mark.parametrize("layout", [dict(packed=False), dict(packed=True, fused_stages=True)])
def test_causal_vit_vae_bf16_forward_matches_jax(pallas_attention, layout):
    """The whole CausalViTVAE at depth 2 in bf16, batch 8, the same noise,
    eval and train (dropout 0): every output bf16 and within the model
    bounds; the parameters stay f32."""
    v = _small_variables()
    jm = jvit.CausalViTVAE(**SMALL, dropout=0.0, dtype=jnp.bfloat16, **layout)
    x, m, t = inputs(8, seed=6)
    x = (x > 0.9).astype(np.float32)
    eps = np.random.default_rng(8).standard_normal((8, SMALL["z_dim"])).astype(np.float32)
    pm = load_port(pvit.CausalViTVAE(**SMALL, dropout=0.0, dtype=BF, device="cpu",
                                     **layout), v)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    for train in (False, True):
        if train:
            want, _ = _apply(jm, v, x, m, t, eps, method=functools.partial(_jax_fwd, train=True),
                             mutable=["batch_stats"])
        else:
            want = _apply(jm, v, x, m, t, eps, method=functools.partial(_jax_fwd, train=False))
        with torch.no_grad():
            out = pm.train(train)(_t(x), _t(m), _t(t), eps=_t(eps))
        for field in ("recon_x", "mu", "logvar", "m_mu", "m_logvar"):
            _held(getattr(out, field), getattr(want, field),
                  TOL["model_train" if train else "model_eval"])


def _jax_grads(jm, v, b):
    """JAX's vessel loss terms and gradients in the parameters, one step in
    train mode with the batch's noise, through ``_jit``."""
    cfg = JaxVesselConfig()

    def value_and_grad(v, b):
        def loss(p):
            out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, b["x"], b["m"],
                              b["t"], b["eps"], True, method=_jax_fwd, mutable=["batch_stats"])
            return JL.vessel_loss(out, b["x"], b["m"], beta=cfg.beta,
                                  lambda_morph=cfg.lambda_morph,
                                  lambda_sparsity=cfg.lambda_sparsity)

        return jax.value_and_grad(loss, has_aux=True)(v["params"])

    return _jit(value_and_grad, v, b)


# biases whose gradient is 0 up to rounding (a BatchNorm follows), and the
# output conv's bias, held to the f64 sum of the output's cotangent instead
NOT_HELD = re.compile(r"backbone\.(stem_convs\.\d|dec_ct\.\d|dec_res\.\d\.conv\d|to_latent|"
                      r"dec_out)\.bias|(enc|dec)_adapter_fc1\.bias")


def _jax_output_cotangent(jm, v, b):
    """JAX's bf16 cotangent of ``recon_x`` in the step's loss, through
    ``_jit``: the dec_out bias's gradient is its sum."""
    cfg = JaxVesselConfig()

    def cotangent(v, b):
        out, _ = jm.apply(v, b["x"], b["m"], b["t"], b["eps"], True, method=_jax_fwd,
                          mutable=["batch_stats"])
        return jax.grad(lambda r: JL.vessel_loss(
            out._replace(recon_x=r), b["x"], b["m"], beta=cfg.beta,
            lambda_morph=cfg.lambda_morph, lambda_sparsity=cfg.lambda_sparsity)[0])(out.recon_x)

    return _jit(cotangent, v, b)


def _port_step(v, b, dtype):
    """The port's model at ``dtype`` on ``v``, one make_vae_step on ``b``:
    (metrics, model, optimizer)."""
    pm = load_port(pvit.CausalViTVAE(**SMALL, dropout=0.0, dtype=dtype, device="cpu"), v)
    opt = ClippedAdam(pm.parameters(), 1e-4, 5.0, BF)
    met = make_vae_step(pm, vessel_loss_fn(VesselConfig()), opt)(
        {k: torch.from_numpy(a) for k, a in b.items()}, eps=torch.from_numpy(b["eps"]))
    return met, pm, opt


def _step_misses(met, grads, named, want):
    """The bounds of the bf16 step (see the docstring) that this step
    misses, by name; asserts nothing."""
    missed = [k for k, ref in want.items()
              if abs(float(met[k]) - float(ref)) > STEP_TERMS_REL[k] * abs(float(ref))]
    out = [n for n in grads if OUTPUT_GRADS.fullmatch(n)]
    num = sum(float((named[n].grad.double() - grads[n].double()).square().sum()) for n in out)
    den = sum(float(grads[n].double().square().sum()) for n in out)
    if len(out) != 5 or (num / den) ** 0.5 > OUTPUT_GRAD_L2:
        missed.append("output_grads")
    l2 = []
    for name, g in grads.items():
        p = named[name]
        if name.startswith("morph."):
            if _errs(p.grad, g.numpy())[0] > MORPH_GRAD_MEAN:
                missed.append(name)
        elif not NOT_HELD.fullmatch(name):
            l2.append(float((p.grad.double() - g.double()).norm() / g.double().norm()))
            if l2[-1] > next(bound for rx, bound in GRAD_L2 if rx.fullmatch(name)):
                missed.append(name)
    if len(l2) != 88 or float(np.median(l2)) > GRAD_L2_MEDIAN:
        missed.append(f"median of {len(l2)}")
    return missed


def test_vae_step_bf16_matches_jax(pallas_attention):
    """One make_vae_step in bf16 against JAX's bf16 loss and gradients, by
    group (bounds in the docstring), with the port's f32 step as the
    control that misses them; dec_out.bias against the f64 sum of JAX's
    cotangent; every gradient and updated parameter f32, Adam's mu bf16."""
    v = _small_variables()
    jm = jvit.CausalViTVAE(**SMALL, packed=False, dropout=0.0, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    h, w = SMALL["img_size"]
    b = {"x": (rng.random((8, h, w, 1)) > 0.9).astype(np.float32),
         "m": rng.standard_normal((8, 12)).astype(np.float32),
         "t": np.eye(19, dtype=np.float32)[rng.integers(0, 19, 8)],
         "eps": rng.standard_normal((8, SMALL["z_dim"])).astype(np.float32)}

    (_, want), jgrads = _jax_grads(jm, v, b)
    met, pm, opt = _port_step(v, b, BF)
    grads = from_jax_variables(pm, {"params": to_numpy_tree(jgrads)})
    named = dict(pm.named_parameters())
    for name, p in named.items():
        assert p.dtype == p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        assert opt.state[p]["mu"].dtype == BF and opt.state[p]["nu"].dtype == torch.float32
    assert sorted(want) == sorted(STEP_TERMS_REL)
    assert _step_misses(met, grads, named, want) == []

    witness = float(np.asarray(_jax_output_cotangent(jm, v, b), np.float64).sum())
    got, theirs = float(named["backbone.dec_out.bias"].grad), float(grads["backbone.dec_out.bias"])
    assert abs(got - witness) <= DEC_OUT_BIAS_REL * abs(witness), (got, witness)
    assert abs(theirs - witness) > abs(witness), (theirs, witness)  # why it is not held to JAX

    met32, pm32, _ = _port_step(v, b, torch.float32)
    missed = _step_misses(met32, grads, dict(pm32.named_parameters()), want)
    assert {"loss", "morph", "output_grads"} <= set(missed), missed


def _remat_step(remat, dtype, steps=2):
    """The port's SMALL model (seeded weights, dropout 0.1) taking ``steps``
    steps with remat_blocks on or off from the same generators; returns the
    metrics, the gradients, the parameters and the generators' states."""
    from causalvae_tpu_torch.models.vae import seeded_init_

    torch.manual_seed(0)
    pm = seeded_init_(pvit.CausalViTVAE(**SMALL, remat_blocks=remat, dtype=dtype,
                                        device="cpu"), 5)
    opt = ClippedAdam(pm.parameters(), 1e-3, 5.0, BF)
    step = make_vae_step(pm, vessel_loss_fn(VesselConfig()), opt)
    gen = torch.Generator().manual_seed(1)
    x, m, t = inputs(4, seed=6)
    batch = {"x": _t((x > 0.9).astype(np.float32)), "m": _t(m), "t": _t(t)}
    mets = [step(batch, generator=gen) for _ in range(steps)]
    return (mets, {n: p.grad.clone() for n, p in pm.named_parameters()},
            {n: p.detach().clone() for n, p in pm.named_parameters()},
            gen.get_state(), torch.get_rng_state())


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_remat_step_equals_plain_step_bit_for_bit(dtype):
    """remat_blocks recomputes the blocks in the backward with the same
    attention seeds (drawn before the checkpointed call) and the same
    nn.Dropout masks (checkpoint restores torch's generator): two steps with
    dropout 0.1 give the same metrics, gradients and parameters, and leave
    both generators where the plain step leaves them."""
    a, b = _remat_step(False, dtype), _remat_step(True, dtype)
    for ma, mb in zip(a[0], b[0]):
        assert all(torch.equal(ma[k], mb[k]) for k in ma), (ma, mb)
    for da, db in zip(a[1:3], b[1:3]):
        assert all(torch.equal(da[n], db[n]) for n in da)
    assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])


def test_remat_launches_the_attention_forward_twice(monkeypatch):
    """With remat_blocks the backward recomputes each block: the attention
    forward runs twice per block in a step, the backward once."""
    from causalvae_tpu_torch.ops.kernels import attention as pa

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = pa.attention_fwd, pa.attention_bwd

    def count_fwd(*args, **kw):
        calls["fwd"] += 1
        return fwd(*args, **kw)

    def count_bwd(*args, **kw):
        calls["bwd"] += 1
        return bwd(*args, **kw)

    monkeypatch.setattr(pa, "attention_fwd", count_fwd)
    monkeypatch.setattr(pa, "attention_bwd", count_bwd)
    for remat, want in ((False, 2), (True, 4)):
        calls.update(fwd=0, bwd=0)
        _remat_step(remat, BF, steps=1)
        assert calls == {"fwd": want, "bwd": 2}, (remat, calls)


def test_remat_step_matches_jax_remat_model():
    """f32, dropout 0: the port's remat step against JAX's
    ``remat_blocks=True`` gradients, by tests/test_torch_train.py's rule
    (rel 1e-4 or 3e-3 of each leaf's max|ref|, plus 1e-6 of the largest
    gradient), and the loss terms to rel 1e-4."""
    from torch_port_helpers import close

    v = _small_variables()  # the plain model's tree; remat names its leaves alike
    jm = jvit.CausalViTVAE(**SMALL, packed=False, dropout=0.0, remat_blocks=True)
    rng = np.random.default_rng(0)
    h, w = SMALL["img_size"]
    b = {"x": (rng.random((4, h, w, 1)) > 0.9).astype(np.float32),
         "m": rng.standard_normal((4, 12)).astype(np.float32),
         "t": np.eye(19, dtype=np.float32)[rng.integers(0, 19, 4)],
         "eps": rng.standard_normal((4, SMALL["z_dim"])).astype(np.float32)}

    (_, want), jgrads = _jax_grads(jm, v, b)
    pm = load_port(pvit.CausalViTVAE(**SMALL, dropout=0.0, remat_blocks=True,
                                     device="cpu"), v)
    opt = ClippedAdam(pm.parameters(), 1e-4, 5.0, BF)
    met = make_vae_step(pm, vessel_loss_fn(VesselConfig()), opt)(
        {k: torch.from_numpy(a) for k, a in b.items()}, eps=torch.from_numpy(b["eps"]))
    for k, ref in want.items():
        assert abs(float(met[k]) - float(ref)) <= 1e-4 * abs(float(ref)), k
    grads = from_jax_variables(pm, {"params": to_numpy_tree(jgrads)})
    named = dict(pm.named_parameters())
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        close(named[name].grad, g.numpy(), rel=_grad_rel(name), abs_=floor)


def _cli(out, *args):
    from causalvae_tpu_torch.cli.main import main

    return main(["--out", str(out), "--n-synthetic", "8", *args])


def test_cli_train_bf16_and_serve_its_checkpoint(tmp_path, capsys):
    """``train vessel --dtype bfloat16`` trains the bf16 model (float32
    parameters and checkpoint), and ``serve vessel --ckpt`` serves it."""
    model, opt, log = _cli(tmp_path, "train", "vessel", "--img-hw", "96", "160",
                           "--epochs", "1", "--dtype", "bfloat16", "--device", "cpu")
    assert model.dtype == BF and model.backbone.blocks[0].fc1.dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(log.history[0]["train_loss"]) and np.isfinite(log.history[1]["val_loss"])
    saved = torch.load(tmp_path / "train_vessel" / "latest.pt", map_location="cpu",
                       weights_only=False)
    floats = [t for t in saved["model"].values() if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    capsys.readouterr()
    _cli(tmp_path, "serve", "vessel", "--ckpt", str(tmp_path / "train_vessel"), "--smoke",
         "--device", "cpu", "--img-hw", "96", "160", "--buckets", "1", "4")
    res = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert res["smoke"] == "ok" and res["reconstruct_shape"] == [1, 96, 160, 1]


def test_cli_rejects_another_dtype(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _cli(tmp_path, "train", "vessel", "--dtype", "float16", "--device", "cpu")
    assert e.value.code == 2 and "--dtype" in capsys.readouterr().err


def test_bf16_endpoints_keep_jax_dtypes(pallas_attention):
    """The six endpoints of a bf16 model answer in JAX's dtypes (bf16
    everywhere; JAX's read by ``jax.eval_shape``), reconstruct within the
    model's eval bounds of JAX's; the engine hands the answers back as
    float32 numpy arrays of the same values."""
    v = _small_variables()
    jm = jvit.CausalViTVAE(**SMALL, packed=False, dtype=jnp.bfloat16)
    pm = load_port(pvit.CausalViTVAE(**SMALL, dtype=BF, device="cpu"), v)
    jeps, peps = jax_endpoints(jm, v), vae_endpoints(pm)
    x, m, t = inputs(2, seed=6)
    z = np.random.default_rng(8).standard_normal((2, SMALL["z_dim"])).astype(np.float32)
    args = {"encode": (x, m, t), "decode": (m, z), "predict_m": (t,),
            "reconstruct": (x, m, t), "do_t": (x, m, t), "uncertainty": (t,)}
    assert sorted(peps) == sorted(jeps) == sorted(args)
    for name, a in args.items():
        want = jax.eval_shape(jeps[name].fn, v, *a)
        with torch.inference_mode():
            got = peps[name](*(torch.from_numpy(arr) for arr in a))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want], name
        assert [str(g.dtype)[6:] for g in got] == [str(w.dtype) for w in want] == [
            "bfloat16"] * len(want), name
    want = _jit(jeps["reconstruct"].fn, v, x, m, t)
    with torch.inference_mode():
        direct = peps["reconstruct"](*(torch.from_numpy(arr) for arr in (x, m, t)))
    _held(direct, want, TOL["model_eval"])
    engine = BatchingEngine(peps, buckets=(1, 2))
    try:
        out = engine.infer("reconstruct", x, m, t)
    finally:
        engine.close()
    assert out.dtype == np.float32 and np.array_equal(out, direct.float().numpy())
