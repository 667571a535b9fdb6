"""The port's CNN vessel VAE (C7, ``models/vae.py CausalVesselVAE``) against
the JAX package's on the CPU, at the JAX tests' small size: 128x256 images
(a (1, 2) grid, so the NHWC flatten order shows), z 16, the vessel m 12 / t
19. JAX's weights (its own initialisation, perturbed by
``torch_port_helpers.init_jax``'s rule) are carried across by
``from_jax_variables``; JAX's noise is injected.

Tolerances, each with its worst reading here:
- the 4x4 stem's lifted kernel (``lifted_kernel(w, "stem", L)``, L = 1-3)
  against the JAX chain ``consume_once`` + ``lift_once``: equal; its packed
  call against the spatial conv, packed afterwards: 1e-5 max|ref|
  [1.9e-7];
- eval ``encode`` / ``predict_m`` / ``decode``, spatial and packed, each
  against JAX's same form: 1e-5 max|ref| + 1e-6 [2.4e-6 of max|ref|];
- the train-mode forward, both forms: 1e-4 max|ref| + 1e-6 [3.2e-5], its
  running statistics 1e-5 max|ref| + 1e-6. Batch statistics of 4 samples through 15
  BatchNorms: from the reference's initialisation, a float64 run of the
  reference mirror puts the port 4-6e-6 and JAX 7-8e-6 of max|ref| away;
- one ``make_vae_step`` with ``vessel_loss`` against JAX's step on the same
  noise (``train/parity.py`` ``make_vessel_parity_step``) and against the
  reference mirror's step in float64: see its docstring;
- bf16 (``dtype=bfloat16``) per module (``BF16_MODULES``: encoder stages,
  the fc head, decoder stages, the output head, the mechanism) against
  JAX's bf16 model compiled op by op (``test_torch_bf16._jit``): each output
  bf16 within its mean relative bound, which the f32 port on the same
  weights misses, and 1e-2 of max|ref| (two bf16 ulps);
- the six endpoints of ``vae_endpoints`` against JAX's: 1e-5 max|ref| + 1e-6
  [1.7e-6].
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from causalvae_tpu.config import VesselConfig as JaxVesselConfig
from causalvae_tpu.models.vae import CausalVesselVAE as JaxC7
from causalvae_tpu.ops import subpixel as jsub
from causalvae_tpu.serve.endpoints import vae_endpoints as jax_endpoints
from causalvae_tpu.train.parity import make_vessel_parity_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.models.vae import CausalVesselVAE
from causalvae_tpu_torch.ops import subpixel as psub
from causalvae_tpu_torch.serve.endpoints import endpoint_arg_specs, vae_endpoints
from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam
from test_torch_bf16 import _errs, _jit
from torch_port_helpers import close, load_port, perturb, to_numpy_tree, two_threads  # noqa: F401

HW, GRID, Z, B = (128, 256), (1, 2), 16, 4
FWD = dict(rel=1e-5, abs_=1e-6)
TRAIN = dict(rel=1e-4, abs_=1e-6)  # batch statistics of 4 samples through 15 BatchNorms
EXACT = ("dec_out.", "morph.")  # leaves no BatchNorm backward reaches
STEP_B = 8  # VesselConfig's batch
BF16_MAX = 1e-2  # max|Δ| / max|ref| of a bf16 module: two bf16 ulps


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def jax_c7_models_and_init():
    """{packed: JAX C7}, and its initial variables (the same parameters serve
    both forms), the init jitted."""
    models = {p: JaxC7(z_dim=Z, grid_hw=GRID, packed=p) for p in (False, True)}
    key = jax.random.PRNGKey(0)
    v = jax.jit(functools.partial(models[False].init, train=False))(
        {"params": key}, jnp.zeros((1, *HW, 1)), jnp.zeros((1, 12)), jnp.zeros((1, 19)),
        rng=key)
    return models, to_numpy_tree(v)


@pytest.fixture(scope="module")
def jax_c7():
    """The JAX models and their variables perturbed (``init_jax``'s rule)."""
    models, v = jax_c7_models_and_init()
    return models, perturb(v, 1)


def _port(v, packed=False, dtype=torch.float32):
    return load_port(CausalVesselVAE(z_dim=Z, grid_hw=GRID, packed=packed, dtype=dtype,
                                     device="cpu"), v)


def _inputs(b=B, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, *HW, 1)) > 0.8).astype(np.float32) * rng.random((b, *HW, 1),
                                                                       dtype=np.float32)
    m = rng.standard_normal((b, 12), dtype=np.float32)
    t = np.eye(19, dtype=np.float32)[rng.integers(0, 19, b)]
    z = rng.standard_normal((b, Z), dtype=np.float32)
    return x, m, t, z


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_4x4_stem_lifting_equals_the_jax_chain(levels):
    w = np.random.default_rng(levels).standard_normal((4, 4, 3, 2)).astype(np.float32)
    want, pl = jsub.consume_once(jnp.asarray(w), 1)
    for _ in range(levels - 1):
        want, pl = jsub.lift_once(want, pl)
    got, got_pl = psub.lifted_kernel(_t(w), "stem", levels)
    assert got_pl == pl
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_4x4_stem_packed_call_equals_the_spatial_conv(levels):
    """``LiftableStemConv(ksize=4).nhwc(x packed L times, in_levels=L)`` is
    the stride-2 conv of the image, its output packed L - 1 times."""
    rng = np.random.default_rng(10 + levels)
    conv = psub.LiftableStemConv(3, 5, ksize=4)
    with torch.no_grad():
        conv.weight.copy_(_t(rng.standard_normal((5, 3, 4, 4)).astype(np.float32)))
        conv.bias.copy_(_t(rng.standard_normal(5).astype(np.float32)))
        x = _t(rng.standard_normal((2, 32, 48, 3)).astype(np.float32))
        want = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = conv.nhwc(psub.space_to_depth_n(x, levels), in_levels=levels)
    close(got, psub.space_to_depth_n(want, levels - 1).numpy(), rel=1e-5, abs_=0.0)


@pytest.mark.parametrize("packed", [False, True], ids=["spatial", "packed"])
def test_from_jax_variables_is_strict(jax_c7, packed):
    """Every JAX leaf lands once in a state dict the model loads strictly;
    a missing leaf and a wrong shape raise."""
    _, v = jax_c7
    pm = CausalVesselVAE(z_dim=Z, grid_hw=GRID, packed=packed, device="cpu")
    sd = from_jax_variables(pm, v)
    pm.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves == len(pm.state_dict())
    params = dict(v["params"])
    params.pop("dec_out")
    with pytest.raises(KeyError, match="dec_out"):
        from_jax_variables(pm, {"params": params, "batch_stats": v["batch_stats"]})
    params = dict(v["params"], enc_fc2={"kernel": np.zeros((1024, 2 * Z + 2), np.float32),
                                        "bias": np.zeros(2 * Z + 2, np.float32)})
    with pytest.raises(ValueError, match="enc_fc2"):
        from_jax_variables(pm, {"params": params, "batch_stats": v["batch_stats"]})


@pytest.mark.parametrize("packed", [False, True], ids=["spatial", "packed"])
def test_eval_encode_predict_m_decode_match_jax(jax_c7, packed):
    models, v = jax_c7
    jm, pm = models[packed], _port(v, packed)
    x, m, t, z = _inputs(seed=4)
    mu, logvar = jax.jit(functools.partial(jm.apply, method=jm.encode))(
        v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t))
    recon = jax.jit(functools.partial(jm.apply, method=jm.decode))(
        v, jnp.asarray(m), jnp.asarray(z))
    m_pred = jm.apply(v, jnp.asarray(t), method=jm.predict_m)
    with torch.no_grad():
        got_mu, got_logvar = pm.encode(_t(x), _t(m), _t(t))
        got_recon = pm.decode(_t(m), _t(z))
        close(got_mu, mu, **FWD)
        close(got_logvar, logvar, **FWD)
        close(got_recon, recon, **FWD)
        close(pm.predict_m(_t(t)), m_pred, **FWD)
    assert got_recon.shape == (B, *HW, 1) and pm.img_size == HW


@pytest.mark.parametrize("packed", [False, True], ids=["spatial", "packed"])
def test_train_forward_and_running_statistics_match_jax(jax_c7, packed):
    """The train-mode forward (batch statistics in all 15 BatchNorms) with
    JAX's noise: every output, and the running statistics after it."""
    models, v = jax_c7
    jm, pm = models[packed], _port(v, packed).train()
    x, m, t, _ = _inputs(seed=5)
    key = jax.random.PRNGKey(6)
    eps = np.asarray(jax.random.normal(key, (B, Z)))
    want, mutated = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t), rng=key)
    got = pm(_t(x), _t(m), _t(t), eps=_t(eps))
    for name in ("recon_x", "m_hat", "mu", "logvar", "m_mu", "m_logvar"):
        close(getattr(got, name), getattr(want, name), **TRAIN)
    stats = from_jax_variables(pm, {"params": v["params"],
                                    "batch_stats": to_numpy_tree(mutated["batch_stats"])})
    running = [k for k in stats if k.endswith((".mean", ".var"))]
    assert len(running) == 30
    for k in running:
        close(pm.state_dict()[k], stats[k].numpy(), **FWD)


def _f64_step_grads(ref, batch, eps):
    """Gradients of the vessel loss (the reference loop's form,
    ``train/parity.py`` ``torch_vessel_step``) of the reference mirror in
    float64, train mode, in the port's names and layouts."""
    import torch.nn.functional as F

    from causalvae_tpu_torch.train.port_maps import causal_vessel_vae_name_maps

    r = ref.double().train()
    x, m, t, e = (_t(a).double() for a in (batch["x"], batch["m"], batch["t"], eps))
    x = x.permute(0, 3, 1, 2)
    mu, logvar = r.encode(x, m, t)
    m_mu, m_logvar = r.morph(t)
    recon = r.decode(m, mu + e * torch.exp(0.5 * logvar))
    frac = x.sum() / (x.numel() + 1e-6)
    pw = torch.clamp((1.0 - frac) / (frac + 1e-6), 1.0, 50.0)
    cfg = VesselConfig()
    loss = (torch.sum(F.mse_loss(recon, x, reduction="none") * (1.0 + (pw - 1.0) * x))
            - cfg.beta * 0.5 * torch.sum(1 + logvar - mu.pow(2) - logvar.exp())
            + cfg.lambda_morph * 0.5 * torch.sum(m_logvar + (m - m_mu) ** 2 / torch.exp(m_logvar))
            + cfg.lambda_sparsity * torch.sum(torch.abs(recon) * (x < 0.1).double()))
    loss.backward()
    params = dict(r.named_parameters())
    return {k: conv(params[tk].grad) for k, (tk, conv) in
            causal_vessel_vae_name_maps(GRID)[0].items()}


def test_vae_step_with_the_vessel_loss_matches_jax_and_float64():
    """One ``make_vae_step`` (train mode, ``vessel_loss``, ``ClippedAdam``)
    from the reference's own initialisation (``train/parity.py``
    ``build_torch_vessel``, carried in by each package's converter, as the
    JAX parity harness does), batch ``STEP_B``, against JAX's vessel step
    on the same batch and noise (its gradients captured by a pass-through
    optax stage) and against the reference mirror's step in float64.

    The loss terms rel 1e-4 of JAX's. Each gradient leaf against the
    float64 step at the ``ROADMAP.md`` rule, of its max|ref| plus 1e-6 of
    the largest gradient: 1e-4 for ``EXACT`` (no BatchNorm backward between
    them and the loss), 3e-3 above [worst 3.1e-3 of max|ref|,
    ``dec_fc2.weight``, inside the 1e-6 floor]; ``EXACT`` also against JAX
    at 1e-4. Above the BatchNorm chain the port and JAX differ by more than
    3e-3 at some leaves [2.7e-2, ``dec_convs.1.weight``]; at each of those,
    JAX is the side further from float64 (its f32 BatchNorm sums are the
    less exact, ``ROADMAP.md``, "Tolerances"). The tiny grid makes the
    step ill-conditioned in f32: nearest upsampling of a (1, 2) map leaves
    the first decoder BatchNorms near-constant channels, where the fast
    batch variance E[x²] - E[x]² (JAX's, kept) cancels. From JAX's lecun
    initialisation, perturbed, both packages miss float64 by up to 16%
    (``dec_convs.1.weight``).
    """
    from causalvae_tpu.train.parity import build_torch_vessel
    from causalvae_tpu.train.port_maps import port_vessel_cnn_checkpoint as jax_port

    from causalvae_tpu_torch.train.port_maps import port_vessel_cnn_checkpoint

    models, v0 = jax_c7_models_and_init()
    ref = build_torch_vessel(z_dim=Z, grid=GRID, seed=0)
    state = {k: a.detach().clone() for k, a in ref.state_dict().items()}
    v, skipped = jax_port(v0, {k: a.numpy() for k, a in state.items()}, GRID)
    assert skipped == []
    x, m, t, eps = _inputs(b=STEP_B, seed=7)
    batch = {"x": (x > 0.1).astype(np.float32), "m": m, "t": t}
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    jstate = TrainState.create(v, optax.chain(capture, optax.clip_by_global_norm(5.0),
                                              optax.adam(1e-4)))
    jstate, jmet = jax.jit(make_vessel_parity_step(models[False], JaxVesselConfig()))(
        jstate, {**{k: jnp.asarray(a) for k, a in batch.items()}, "eps": jnp.asarray(eps)})
    pm = CausalVesselVAE(z_dim=Z, grid_hw=GRID, device="cpu")
    sd, skipped = port_vessel_cnn_checkpoint(pm, state, GRID)
    assert skipped == []
    pm.load_state_dict(sd, strict=True)
    opt = ClippedAdam(pm.parameters(), 1e-4, 5.0, mu_dtype=torch.float32)
    pmet = make_vae_step(pm, vessel_loss_fn(VesselConfig()), opt)(
        {k: _t(a) for k, a in batch.items()}, eps=_t(eps))
    assert set(pmet) == set(jmet) == {"loss", "recon", "kld", "morph", "sparsity"}
    for k in jmet:
        assert abs(float(pmet[k]) - float(jmet[k])) <= 1e-4 * abs(float(jmet[k])), k
    jgrads = from_jax_variables(pm, {"params": to_numpy_tree(jstate.opt_state[0])})
    f64 = _f64_step_grads(ref, batch, eps)
    top = max(float(g.abs().max()) for g in f64.values())
    apart = {}
    for name, p in pm.named_parameters():
        exact = name.startswith(EXACT)
        close(p.grad, f64[name].numpy(), rel=1e-4 if exact else 3e-3, abs_=1e-6 * top)
        if exact:
            close(p.grad, jgrads[name].numpy(), rel=1e-4, abs_=1e-6 * top)
            continue
        ref = float(f64[name].abs().max())
        gap = float((p.grad.double() - jgrads[name].double()).abs().max())
        if gap > 3e-3 * ref + 1e-6 * top:  # then JAX is the side further from float64
            apart[name] = (float((jgrads[name].double() - f64[name]).abs().max()) / ref,
                           float((p.grad.double() - f64[name]).abs().max()) / ref)
    assert all(jax_err > port_err for jax_err, port_err in apart.values()), apart
    stats = from_jax_variables(pm, {"params": to_numpy_tree(jstate.params),
                                    "batch_stats": to_numpy_tree(jstate.batch_stats)})
    for k in stats:
        if k.endswith((".mean", ".var")):
            close(pm.state_dict()[k], stats[k].numpy(), **FWD)


def _jax_enc_stage(mdl, x, i, lv):
    return jax.nn.leaky_relu(mdl.enc_bns[i](mdl.enc_convs[i](x, in_levels=lv),
                                            use_running_average=True,
                                            groups=4 ** max(lv - 1, 0)), 0.2)


def _port_enc_stage(m, x, i, lv):
    if lv == 0:  # the spatial form's NCHW call
        h = m.enc_bns[i](m.enc_convs[i](x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    else:
        h = m.enc_bns[i].nhwc(m.enc_convs[i].nhwc(x, in_levels=lv), groups=4 ** (lv - 1))
    return torch.nn.functional.leaky_relu(h, 0.2)


def _jax_dec_stage(mdl, h, i):
    from causalvae_tpu.models.vae import upsample2x_nearest

    h = upsample2x_nearest(h)
    if i == len(mdl.DEC_CH):
        return jax.nn.sigmoid(mdl.dec_out(h))
    return jax.nn.relu(mdl.dec_bns[i](mdl.dec_convs[i](h), use_running_average=True))


def _port_dec_stage(m, h, i):
    from causalvae_tpu_torch.models.vae import upsample2x_nearest

    h = upsample2x_nearest(h.permute(0, 3, 1, 2))
    if i == len(m.DEC_CH):
        return torch.sigmoid(m.dec_out(h)).permute(0, 2, 3, 1)
    return torch.relu(m.dec_bns[i](m.dec_convs[i](h))).permute(0, 2, 3, 1)


def _jax_head(mdl, h):
    h = jax.nn.leaky_relu(mdl.enc_fc_bn(mdl.enc_fc1(h), use_running_average=True), 0.2)
    mu, logvar = jnp.split(mdl.enc_fc2(h), 2, axis=1)
    return jnp.clip(mu, -100.0, 100.0), jnp.clip(logvar, -10.0, 10.0)


def _port_head(m, h):
    h = torch.nn.functional.leaky_relu(m.enc_fc_bn(m.enc_fc1(h)), 0.2)
    mu, logvar = m.enc_fc2(h).chunk(2, dim=1)
    return mu.clamp(-100.0, 100.0), logvar.clamp(-10.0, 10.0)


# (JAX call, port call, input shape, mean bound) of each module of C7
BF16_MODULES = {
    "enc_stage0": (functools.partial(_jax_enc_stage, i=0, lv=0),
                   functools.partial(_port_enc_stage, i=0, lv=0), (2, *HW, 1), 5e-4),
    "enc_stage0_packed": (functools.partial(_jax_enc_stage, i=0, lv=3),
                          functools.partial(_port_enc_stage, i=0, lv=3), (2, 16, 32, 64),
                          5e-4),
    "enc_stage1_packed": (functools.partial(_jax_enc_stage, i=1, lv=2),
                          functools.partial(_port_enc_stage, i=1, lv=2), (2, 16, 32, 512),
                          5e-4),
    "enc_stage3": (functools.partial(_jax_enc_stage, i=3, lv=0),
                   functools.partial(_port_enc_stage, i=3, lv=0), (2, 16, 32, 128),
                   5e-4),
    "enc_head": (_jax_head, _port_head, (2, 512 * 2 + 12 + 19), 1.5e-3),
    "dec_stage0": (functools.partial(_jax_dec_stage, i=0), functools.partial(_port_dec_stage, i=0),
                   (2, *GRID, 512), 5e-4),
    "dec_stage5": (functools.partial(_jax_dec_stage, i=5), functools.partial(_port_dec_stage, i=5),
                   (2, 32, 64, 64), 5e-4),
    "dec_out": (functools.partial(_jax_dec_stage, i=6), functools.partial(_port_dec_stage, i=6),
                (2, 64, 128, 32), 1.8e-3),
    "mechanism": (lambda mdl, t: mdl.predict_m(t), lambda m, t: m.predict_m(t), (2, 19),
                  2e-3),
}


@pytest.mark.parametrize("module", list(BF16_MODULES))
def test_bf16_modules_match_jax_with_an_f32_control(jax_c7, module):
    """``dtype=bfloat16``, eval mode, per module of C7 (an encoder stage,
    spatial and packed; the fc head with its clamps; a decoder stage; the
    output head; the mechanism) on bf16-valued inputs: the port's output
    bf16, its mean|Δ| / mean|ref| within the module's bound and its max|Δ| /
    max|ref| within ``BF16_MAX`` (two bf16 ulps) of JAX's bf16 model
    compiled op by op; the f32 port on the same weights (the control)
    misses the mean bound. Readings (bf16 / control mean): the encoder stages 1.9-2.1e-4 /
    3.0-3.1e-3, the head 3.5-6.1e-4 / 4.3-5.4e-3, the decoder stages 0-1e-7 /
    2.9-3.1e-3, the output head 1.54e-3 / 2.18e-3, the mechanism 0.6-1.1e-3 /
    3.1-4.3e-3. Through the whole encoder the two cannot be told apart
    (mu 4.7-5.4e-3 / 5.7-7.9e-3), as ``ROADMAP.md`` says of the ViT."""
    from test_torch_bf16 import _bf16_values

    _, v = jax_c7
    jax_call, port_call, shape, mean_tol = BF16_MODULES[module]
    jm = JaxC7(z_dim=Z, grid_hw=GRID, packed=False, dtype=jnp.bfloat16)
    rng = np.random.default_rng(sorted(BF16_MODULES).index(module))
    x = _bf16_values(rng.standard_normal(shape))
    if module.startswith("dec"):
        x = np.abs(x)  # a decoder stage reads a ReLU's output
    if module == "mechanism":
        x = np.eye(19, dtype=np.float32)[rng.integers(0, 19, 2)]
    want = _jit(lambda vv, xx: jm.apply(vv, xx, method=jax_call), v,
                jnp.asarray(x, jnp.bfloat16))
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            out = port_call(_port(v, dtype=dt), _t(x).to(dt))
        outs[dt] = out if isinstance(out, tuple) else (out,)
    for i, w in enumerate(want if isinstance(want, tuple) else (want,)):
        ref = np.asarray(w.astype(jnp.float32))
        got = outs[torch.bfloat16][i]
        assert got.dtype == torch.bfloat16
        mean, mx = _errs(got.float(), ref)
        ctrl, _ = _errs(outs[torch.float32][i], ref)
        assert mean <= mean_tol and mx <= BF16_MAX, (i, mean, mx)
        assert ctrl > mean_tol, (i, ctrl)


@pytest.mark.parametrize("name", ["encode", "decode", "predict_m", "reconstruct", "do_t",
                                  "uncertainty"])
def test_endpoints_match_jax(jax_c7, name):
    """C7's mechanism head is Gaussian: six endpoints, each against JAX's
    (do_t over three targets)."""
    models, v = jax_c7
    targets = np.eye(19, dtype=np.float32)[[0, 7, 18]]
    pm = _port(v)
    peps = vae_endpoints(pm, t_targets=_t(targets))
    assert sorted(peps) == ["decode", "do_t", "encode", "predict_m", "reconstruct",
                            "uncertainty"]
    assert endpoint_arg_specs(pm)["encode"] == ((*HW, 1), (12,), (19,))
    jep = jax_endpoints(models[False], v, t_targets=jnp.asarray(targets))[name]
    x, m, t, z = _inputs(b=2, seed=9)
    args = {"encode": (x, m, t), "decode": (m, z), "predict_m": (t,),
            "reconstruct": (x, m, t), "do_t": (x, m, t), "uncertainty": (t,)}[name]
    want = jax.jit(jep.fn)(jep.params, *(jnp.asarray(a) for a in args))
    with torch.inference_mode():
        got = peps[name](*(_t(a) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, **FWD)
