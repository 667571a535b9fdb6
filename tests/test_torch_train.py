"""Port parity of the training slice: the optimizer and the vessel train step.

``ClippedAdam`` against optax ``chain(clip_by_global_norm(5), adam(lr,
mu_dtype=bf16))``, the chain of ``bench.py``'s flagship step; the port's
``make_vae_step`` against ``make_vit_parity_step`` (the JAX vessel step with
injected noise) on the small CausalViTVAE of ``torch_port_helpers`` in the
spatial form, dropout 0, f32 on the CPU, same weights and batch and noise.

Tolerances: step-0 loss and metrics rel < 1e-4 (the sums run in another
order, nothing else differs); batch statistics rel 1e-5; parameters after a
step within 2·lr (Adam's first step moves every entry by about ±lr, so an
entry whose tiny gradient differs in sign by rounding may land 2·lr away),
and every leaf with a gradient above 1 moved by lr at its largest entry; the
stored bfloat16 first moment as the gradient plus one bfloat16 step (2^-8);
the 2-step loss trajectory rel < 1e-3 (``results/parity_horizon_cpu.json``
holds step 0 to 1e-4 and C9 trajectories to 2e-2 in f32).

Gradients, each leaf within ``rel`` of its max|ref| plus 1e-6 of the
largest gradient of the model. ``rel`` is 1e-4 for the leaves no BatchNorm
backward reaches (``EXACT``: the output convolution, the last BatchNorm's
scale, the morphology MLP; worst seen 2.8e-6, ``dec_out.bias``) and 3e-3 for
the others (worst seen 2.2e-3, ``dec_adapter_bn.scale``; then
``dec_res.1.bn0.scale`` 2.1e-3 and ``decoder_input.bias`` 2.0e-3). Rel 1e-4
does not hold there, and the JAX side is the less exact one: the BatchNorm
backward's per-channel Σdy at the decoder tail cancels, and the JAX f32 sum
of it is much further from a float64 sum than the port's
(``test_jax_reference_bn_sum_is_the_less_exact``). That error enters every
dx upstream. The biases of the convolutions before a BatchNorm have an
analytic gradient of 0; both sides give rounding noise there, under the
1e-6 floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from causalvae_tpu.config import VesselConfig as JaxVesselConfig
from causalvae_tpu.models.vae import VAEOutput as JaxVAEOutput
from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE
from causalvae_tpu.ops import losses as JL
from causalvae_tpu.train.parity_vit import make_vit_parity_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.ops.subpixel import space_to_depth_n
from causalvae_tpu_torch.train.loop import (make_vae_eval_step, make_vae_step,
                                            vessel_loss_fn)
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from torch_port_helpers import SMALL, close, init_jax, to_numpy_tree

LR = 1e-4
B = 4
# leaves whose gradient passes no BatchNorm backward (see the docstring)
EXACT = ("backbone.dec_out.", "backbone.dec_bns.4.scale", "morph.")


def _grad_rel(name):
    return 1e-4 if name.startswith(EXACT) else 3e-3


def _batches(steps, seed=0):
    rng = np.random.default_rng(seed)
    h, w = SMALL["img_size"]
    out = []
    for _ in range(steps):
        out.append({
            "x": (rng.random((B, h, w, 1)) > 0.9).astype(np.float32),
            "m": rng.standard_normal((B, 12)).astype(np.float32),
            "t": np.eye(19, dtype=np.float32)[rng.integers(0, 19, B)],
            "eps": rng.standard_normal((B, SMALL["z_dim"])).astype(np.float32),
        })
    return out


def _tx():
    return optax.chain(optax.clip_by_global_norm(5.0),
                       optax.adam(LR, mu_dtype=jnp.bfloat16))


def _jax_fwd(mdl, x, m, t, eps):
    mu, logvar = mdl.encode(x, m, t, train=True)
    z = mu + eps * jnp.exp(0.5 * logvar)
    m_mu, m_logvar = mdl.morph(t)
    recon = mdl.decode(m.astype(z.dtype), z, train=True)
    return JaxVAEOutput(recon, m_mu, mu, logvar, m_mu, m_logvar)


def _jax_side(steps):
    """JAX model, initial variables (numpy), the step-0 gradients and batch
    stats, and the per-step metrics and final state of make_vit_parity_step."""
    jm = JaxCausalViTVAE(**SMALL, packed=False, dropout=0.0)
    h, w = SMALL["img_size"]
    variables = init_jax(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)),
                         jnp.zeros((1, 19)), rng=jax.random.PRNGKey(0),
                         train=False, seed=0)
    cfg = JaxVesselConfig()
    batches = _batches(steps)

    @jax.jit
    def grads_fn(params, stats, b):
        def loss(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, b["x"], b["m"],
                                b["t"], b["eps"], method=_jax_fwd,
                                mutable=["batch_stats"])
            total, metrics = JL.vessel_loss(out, b["x"], b["m"], beta=cfg.beta,
                                            lambda_morph=cfg.lambda_morph,
                                            lambda_sparsity=cfg.lambda_sparsity)
            return total, (metrics, mut["batch_stats"])

        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (_, stats0)), grads0 = grads_fn(variables["params"], variables["batch_stats"],
                                        batches[0])
    step = jax.jit(make_vit_parity_step(jm, cfg))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), _tx())
    metrics, states = [], []
    for b in batches:
        state, met = step(state, b)
        metrics.append({k: float(v) for k, v in met.items()})
        states.append(state)
    return dict(variables=variables, batches=batches, grads0=to_numpy_tree(grads0),
                stats0=to_numpy_tree(stats0), metrics=metrics,
                params1=to_numpy_tree(states[0].params),
                mu1=jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                           states[0].opt_state[1][0].mu))


def _port_side(variables, batches):
    pm = CausalViTVAE(**SMALL, dropout=0.0, device="cpu")
    pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
    opt = ClippedAdam(pm.parameters(), LR, 5.0, torch.bfloat16)
    step = make_vae_step(pm, vessel_loss_fn(VesselConfig()), opt)
    return pm, opt, step


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax2():
    return _jax_side(2)


def test_step0_loss_grads_and_stats_match_jax(jax2):
    pm, opt, step = _port_side(jax2["variables"], jax2["batches"])
    p0 = {n: p.detach().clone() for n, p in pm.named_parameters()}
    b = _tb(jax2["batches"][0])
    met = step(b, eps=b["eps"])
    want = jax2["metrics"][0]
    assert set(met) == set(want)
    for k, v in want.items():
        assert abs(float(met[k]) - v) <= 1e-4 * abs(v), (k, float(met[k]), v)
    grads = from_jax_variables(pm, {"params": jax2["grads0"]})
    named = dict(pm.named_parameters())
    assert set(grads) == set(named)
    assert any(n.startswith(EXACT) for n in named)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        close(named[name].grad, g.numpy(), rel=_grad_rel(name), abs_=floor)
    stats = from_jax_variables(pm, {"params": jax2["grads0"],
                                    "batch_stats": jax2["stats0"]})
    for name, buf in pm.named_buffers():
        close(buf, stats[name].numpy(), rel=1e-5, abs_=1e-7)
    # the optimizer's state and update: mu = (1 - b1)·clip·g, stored in bf16
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in named.values())))
    clip = min(1.0, 5.0 / norm)
    mu1 = from_jax_variables(pm, {"params": jax2["mu1"]})
    params1 = from_jax_variables(pm, {"params": jax2["params1"]})
    for name, p in named.items():
        mu = opt.state[p]["mu"]
        assert mu.dtype == torch.bfloat16
        close(mu.float(), mu1[name].numpy(), rel=_grad_rel(name) + 2.0 ** -7,
              abs_=0.1 * clip * floor)
        close(p, params1[name].numpy(), rel=0.0, abs_=2 * LR)
        if float(p.grad.abs().max()) > 1.0:
            moved = float((p.detach() - p0[name]).abs().max())
            assert abs(moved - LR) <= 1e-2 * LR, (name, moved)


@pytest.mark.parametrize("fused_stages", [False, True])
@pytest.mark.parametrize("packed_io", [False, True])
def test_packed_step_matches_jax(jax2, fused_stages, packed_io):
    """The phase-packed model, one step: the loss terms, every leaf's
    gradient (the rule above) and the updated batch statistics against the
    JAX packed model of the same options, from the spatial tests' variables
    (the packed model's tree is the same and loads strictly) and first batch;
    with ``packed_io`` both take the images space_to_depth_n(x, 3)-packed.
    On the CPU the port's stage op and BatchNorm run their plain versions;
    the JAX model's fused stages run its XLA formulation (its Pallas gates
    admit TPUs only). The rule holds at this configuration; at depth 1 the
    JAX reference's BatchNorm sums put the spatial port outside it as well,
    so the packed variants are held where the spatial one is."""
    kw = dict(SMALL)
    opts = dict(packed=True, packed_io=packed_io, fused_stages=fused_stages)
    jm = JaxCausalViTVAE(**kw, **opts, dropout=0.0)
    variables = jax2["variables"]
    b = dict(jax2["batches"][0])
    if packed_io:
        b["x"] = np.asarray(space_to_depth_n(b["x"], 3))
    cfg = JaxVesselConfig()

    @jax.jit
    def grads_fn(params, stats):
        def loss(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, b["x"], b["m"],
                                b["t"], b["eps"], method=_jax_fwd, mutable=["batch_stats"])
            total, metrics = JL.vessel_loss(out, b["x"], b["m"], beta=cfg.beta,
                                            lambda_morph=cfg.lambda_morph,
                                            lambda_sparsity=cfg.lambda_sparsity)
            return total, (metrics, mut["batch_stats"])

        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (want, jstats)), jgrads = grads_fn(variables["params"], variables["batch_stats"])
    pm = CausalViTVAE(**kw, **opts, dropout=0.0, device="cpu")
    pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
    step = make_vae_step(pm, vessel_loss_fn(VesselConfig()),
                         ClippedAdam(pm.parameters(), LR, 5.0, torch.bfloat16))
    tb = _tb(b)
    got = step(tb, eps=tb["eps"])
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * abs(float(v)), (k, float(got[k]), v)
    grads = from_jax_variables(pm, {"params": to_numpy_tree(jgrads)})
    named = dict(pm.named_parameters())
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        close(named[name].grad, g.numpy(), rel=_grad_rel(name), abs_=floor)
    stats = from_jax_variables(pm, {"params": to_numpy_tree(jgrads),
                                    "batch_stats": to_numpy_tree(jstats)})
    for name, buf in pm.named_buffers():
        close(buf, stats[name].numpy(), rel=1e-5, abs_=1e-7)


def test_jax_reference_bn_sum_is_the_less_exact(jax2, monkeypatch):
    """The reason for the gradient tolerance: at the decoder tail
    (``dec_bns.4``, the first BatchNorm backward) the JAX Σdy (its dbias)
    is further from a float64 sum of the port's dy than the port's own f32
    sum, by more than 100x."""
    from causalvae_tpu_torch.ops.kernels import batchnorm as pb

    seen = []
    orig = pb.bn_bwd_sums

    def spy(dy3, x3, mean, inv):
        out = orig(dy3, x3, mean, inv)
        seen.append((dy3.double().sum(dim=(0, 2)), out[0].double()))
        return out

    monkeypatch.setattr(pb, "bn_bwd_sums", spy)
    pm, _, step = _port_side(jax2["variables"], jax2["batches"])
    b = _tb(jax2["batches"][0])
    step(b, eps=b["eps"])
    exact, port = seen[0]
    jax_sum = from_jax_variables(pm, {"params": jax2["grads0"]})[
        "backbone.dec_bns.4.bias"].double()
    port_err = float((port - exact).abs().max())
    jax_err = float((jax_sum - exact).abs().max())
    assert 100 * port_err < jax_err, (port_err, jax_err)


def test_two_step_trajectory_matches_jax(jax2):
    _, _, step = _port_side(jax2["variables"], jax2["batches"])
    for b, want in zip(jax2["batches"], jax2["metrics"]):
        tb = _tb(b)
        got = step(tb, eps=tb["eps"])
        for k, v in want.items():
            assert abs(float(got[k]) - v) <= 1e-3 * abs(v), (k, float(got[k]), v)


@pytest.mark.slow
def test_eight_step_trajectory_matches_jax():
    ref = _jax_side(8)
    _, _, step = _port_side(ref["variables"], ref["batches"])
    for b, want in zip(ref["batches"], ref["metrics"]):
        tb = _tb(b)
        got = step(tb, eps=tb["eps"])
        for k, v in want.items():
            assert abs(float(got[k]) - v) <= 1e-3 * abs(v), (k, float(got[k]), v)


def _grads(rng, scale):
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in ((5, 3), (7,), (2, 4, 3))]


def test_clipped_adam_matches_optax_three_steps():
    """Three steps, the first two with ‖g‖ above 5 (clipped), the third
    below; parameters, the stored bfloat16 mu and the f32 nu agree."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,), (2, 4, 3))]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ClippedAdam(params, LR, 5.0, torch.bfloat16)
    tx = _tx()
    update = jax.jit(tx.update)  # as the JAX train steps run it
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    norms = []
    for scale in (3.0, 1.5, 0.05):
        g = _grads(rng, scale)
        norms.append(float(np.sqrt(sum((a * a).sum() for a in g))))
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        got_norm = float(opt.step())
        upd, state = update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        assert abs(got_norm - norms[-1]) <= 1e-6 * norms[-1]
        for p, want in zip(params, jp):  # a few f32 ulps of the O(1) params
            close(p, np.asarray(want), rel=1e-6, abs_=0.0)
    assert norms[0] > 5.0 and norms[1] > 5.0 and norms[2] < 5.0
    mu = state[1][0].mu
    for p, want_mu, want_nu in zip(params, mu, state[1][0].nu):
        assert opt.state[p]["mu"].dtype == torch.bfloat16
        assert want_mu.dtype == jnp.bfloat16
        # equal up to one bfloat16 rounding step (2^-8 relative)
        np.testing.assert_allclose(opt.state[p]["mu"].float().numpy(),
                                   np.asarray(want_mu.astype(jnp.float32)),
                                   rtol=2.0 ** -8, atol=0.0)
        close(opt.state[p]["nu"], np.asarray(want_nu), rel=1e-6, abs_=0.0)


def test_clip_has_no_epsilon_and_skips_small_norms():
    """optax rescales by max_norm/‖g‖ exactly and leaves ‖g‖ < max_norm
    untouched (torch's clip_grad_norm_ adds 1e-6); with lr 1 and one step the
    update is the sign pattern Adam gives, so the clip shows in nu."""
    for scale, clipped in ((10.0, True), (1.0, False)):
        p = torch.nn.Parameter(torch.zeros(4))
        p.grad = torch.full((4,), scale / 2)  # ‖g‖ = scale
        opt = ClippedAdam([p], 1.0, 5.0, torch.bfloat16)
        opt.step()
        g_used = 2.5 if clipped else scale / 2
        torch.testing.assert_close(opt.state[p]["nu"],
                                   torch.full((4,), 0.001 * g_used ** 2),
                                   rtol=1e-6, atol=0.0)


def test_from_jax_variables_maps_a_params_only_tree(jax2):
    pm = CausalViTVAE(**SMALL, dropout=0.0, device="cpu")
    grads = from_jax_variables(pm, {"params": jax2["grads0"]})
    assert set(grads) == {k for k, _ in pm.named_parameters()}
    assert not any(k.endswith((".mean", ".var")) for k in grads)


def test_eval_step_uses_running_stats_and_keeps_them(jax2):
    """make_vae_eval_step: eval mode (running statistics, no update), no
    gradient; the same eps gives the JAX eval forward's loss."""
    jm = JaxCausalViTVAE(**SMALL, packed=False, dropout=0.0)
    v = jax2["variables"]
    b = jax2["batches"][0]
    cfg = JaxVesselConfig()

    def fwd(mdl, x, m, t, eps):
        mu, logvar = mdl.encode(x, m, t, train=False)
        z = mu + eps * jnp.exp(0.5 * logvar)
        m_mu, m_logvar = mdl.morph(t)
        return JaxVAEOutput(mdl.decode(m, z, train=False), m_mu, mu, logvar,
                            m_mu, m_logvar)

    out = jm.apply(v, b["x"], b["m"], b["t"], b["eps"], method=fwd)
    _, want = JL.vessel_loss(out, b["x"], b["m"], beta=cfg.beta,
                             lambda_morph=cfg.lambda_morph,
                             lambda_sparsity=cfg.lambda_sparsity)
    pm, _, _ = _port_side(v, jax2["batches"])
    before = {k: t.clone() for k, t in pm.named_buffers()}
    tb = _tb(b)
    got = make_vae_eval_step(pm, vessel_loss_fn(VesselConfig()))(tb, eps=tb["eps"])
    for k, val in want.items():
        assert abs(float(got[k]) - float(val)) <= 1e-4 * abs(float(val)), k
    assert all(torch.equal(t, before[k]) for k, t in pm.named_buffers())
    assert all(p.grad is None for p in pm.parameters())


def test_step_with_dropout_is_reproducible_from_the_generator():
    """Train mode with dropout 0.1: the same generator seed (and torch seed,
    for nn.Dropout) gives the same step; another seed another one."""
    x = np.random.default_rng(4).random((2, *SMALL["img_size"], 1)) > 0.9
    batch = {"x": torch.from_numpy(x.astype(np.float32)),
             "m": torch.zeros(2, 12), "t": torch.eye(19)[:2]}

    def run(seed):
        torch.manual_seed(0)
        pm = CausalViTVAE(**SMALL, device="cpu")
        opt = ClippedAdam(pm.parameters(), LR, 5.0, torch.bfloat16)
        step = make_vae_step(pm, vessel_loss_fn(VesselConfig()), opt)
        return float(step(batch, generator=torch.Generator().manual_seed(seed))["loss"])

    assert run(1) == run(1)
    assert run(1) != run(2)
