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


def _ulp_moved(tree, seed):
    """Every f32 leaf moved by one ulp of its own size (x * (1 +/- 2^-23),
    the sign drawn per entry from ``seed``)."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        sign = rng.choice(np.array([-1.0, 1.0], np.float32), a.shape)
        return (a * (1 + np.float32(2 ** -23) * sign)).astype(np.float32)

    return jax.tree_util.tree_map(move, tree)


@pytest.fixture(scope="module")
def one_head64():
    """The small model at ``embed_dim=64, heads=1`` (head dim 64, the
    kernels' wide plans on the card), weights from ``from_jax_variables``
    (the qkv DenseGeneral layout at one head), one step of each side: the
    vessel objective's metrics and gradients, the gradients under its KL term
    alone, and JAX's gradients at its weights moved by one ulp (three sign
    patterns), all as port-named tensors."""
    return _one_head_case(embed_dim=64)


@pytest.fixture(scope="module")
def one_head320():
    """As ``one_head64`` at ``embed_dim=320, heads=1`` and depth 1: head dim
    320, past the wide plans' 256 (the deep plan on the card; on the CPU the
    plain versions through the wrapper, whose padding leaves 320 as it is),
    and the forward's output beside JAX's."""
    return _one_head_case(embed_dim=320, depth=1)


def _one_head_case(**widths):
    kw = dict(SMALL, heads=1, **widths)
    jm = JaxCausalViTVAE(**kw, packed=False, dropout=0.0)
    h, w = kw["img_size"]
    variables = init_jax(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)),
                         jnp.zeros((1, 19)), rng=jax.random.PRNGKey(0), train=False,
                         seed=0, jit=True)
    b = _batches(1, seed=5)[0]
    cfg = JaxVesselConfig()

    @jax.jit
    def grads(params, stats):
        def loss(p, term):
            out, _ = jm.apply({"params": p, "batch_stats": stats}, b["x"], b["m"], b["t"],
                              b["eps"], method=_jax_fwd, mutable=["batch_stats"])
            total, metrics = JL.vessel_loss(out, b["x"], b["m"], beta=cfg.beta,
                                            lambda_morph=cfg.lambda_morph,
                                            lambda_sparsity=cfg.lambda_sparsity)
            return (total if term is None else metrics[term]), metrics

        (_, metrics), full = jax.value_and_grad(loss, has_aux=True)(params, None)
        kld = jax.grad(lambda p: loss(p, "kld")[0])(params)
        return metrics, full, kld

    stats = variables["batch_stats"]
    want, jfull, jkld = grads(variables["params"], stats)
    pm = CausalViTVAE(**kw, dropout=0.0, device="cpu")
    pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
    jout, _ = jm.apply(variables, b["x"], b["m"], b["t"], b["eps"], method=_jax_fwd,
                       mutable=["batch_stats"])
    pm.train()
    with torch.no_grad():
        tb = _tb(b)
        mu, logvar = pm.encode(tb["x"], tb["m"], tb["t"])
        recon = pm.decode(tb["m"], mu + tb["eps"] * torch.exp(0.5 * logvar))
    forward = {"mu": (mu, jout.mu), "logvar": (logvar, jout.logvar),
               "recon": (recon, jout.recon_x)}

    def as_port(g):
        return from_jax_variables(pm, {"params": to_numpy_tree(g)})

    moved = [grads(_ulp_moved(variables["params"], seed), stats) for seed in range(3)]
    moved = {"full": [as_port(m[1]) for m in moved], "kld": [as_port(m[2]) for m in moved]}
    vessel = vessel_loss_fn(VesselConfig())
    port, metrics = {}, {}
    for term in ("full", "kld"):
        pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
        assert pm.backbone.blocks[0].attn.heads == 1

        def loss_fn(out, batch, term=term):
            total, metrics = vessel(out, batch)
            return (total if term == "full" else metrics["kld"]), metrics

        for p in pm.parameters():
            p.grad = None
        step = make_vae_step(pm, loss_fn, ClippedAdam(pm.parameters(), LR, 5.0,
                                                      torch.bfloat16))
        tb = _tb(b)
        metrics[term] = step(tb, eps=tb["eps"])
        port[term] = {n: None if p.grad is None else p.grad.clone()
                      for n, p in pm.named_parameters()}
    return dict(want={k: float(v) for k, v in want.items()}, metrics=metrics["full"], port=port,
                jax={"full": as_port(jfull), "kld": as_port(jkld)}, moved=moved,
                forward=forward, kw=kw, variables=to_numpy_tree(variables), batch=b)


# the layers whose output feeds a BatchNorm: their biases have an analytic
# gradient of 0, rounding noise on both sides
_BN_FED = ("backbone.stem_convs.", "backbone.dec_ct.", "enc_adapter_fc1.",
           "dec_adapter_fc1.", *(f"backbone.dec_res.{i}.conv" for i in range(3)))


def _bn_fed_bias(name):
    return name.startswith(_BN_FED) and name.endswith(".bias")


def test_one_head_of_width_64_step_matches_jax(one_head64):
    """One step at ``embed_dim=64, heads=1`` against JAX's: the loss terms
    of the vessel objective to rel 1e-4, and the gradients under its KL term
    alone, which reach the encoder only (the attention's backward at D = 64
    in both blocks), each leaf within 1e-4 of its max|ref| plus 1e-6 of the
    largest gradient (``tests/test_torch_vit.py``'s rel). The whole
    objective's gradients are held in the next test. The biases feeding a
    BatchNorm have an analytic gradient of 0 (the normalisation removes
    them): both sides there are rounding noise, held to 1e-5 of the largest
    gradient."""
    _hold_one_head_step(one_head64)


def _hold_one_head_step(case, stem_rel=1e-4):
    got, want = case["metrics"], case["want"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - v) <= 1e-4 * abs(v), (k, float(got[k]), v)
    grads, port = case["jax"]["kld"], case["port"]["kld"]
    top = max(float(g.abs().max()) for g in grads.values())
    reached = 0
    for name, g in grads.items():
        pg = port[name]
        if pg is None:  # the decoder: the KL term does not reach it
            assert not g.any(), name
        elif _bn_fed_bias(name):
            assert max(float(pg.abs().max()), float(g.abs().max())) <= 1e-5 * top, name
        else:
            close(pg, g.numpy(), rel=stem_rel if name.startswith(_STEM) else 1e-4,
                  abs_=1e-6 * top)
            reached += 1
    last = max(int(k.split(".")[2]) for k in port if k.startswith("backbone.blocks."))
    assert reached >= 30 and port[f"backbone.blocks.{last}.attn.qkv.weight"] is not None


def test_one_head_of_width_64_gradients_within_jax_rounding_spread(one_head64):
    """The whole objective's gradients at ``embed_dim=64, heads=1``. At this
    point of the weights they move by up to ~2% of a leaf's max|ref| when
    JAX's own weights move by one ulp (``_ulp_moved``: a leaky ReLU's slope
    or the sparsity term's sign switching for an entry that rounding moves
    across 0), so no rel-1e-4 rule can hold between two f32 programs there;
    the test shows that spread (at least 1% at some leaf, where the
    docstring of this module holds the D = 8 model to 3e-3) and holds each
    port leaf within twice the largest of the three moved runs' distance
    from JAX, plus 1e-4 of its max|ref| and 1e-6 of the largest gradient.
    Leaves that no leaky ReLU or sign reaches (``EXACT``) stay at rel 1e-4."""
    assert _hold_one_head_gradients(one_head64) >= 1e-2


def _hold_one_head_gradients(case) -> float:
    """Holds the whole objective's gradients as the test above says;
    returns the largest spread of JAX's moved runs over a leaf's max|ref|."""
    grads, port, moved = case["jax"]["full"], case["port"]["full"], case["moved"]["full"]
    top = max(float(g.abs().max()) for g in grads.values())
    spread_max = 0.0
    for name, g in grads.items():
        pg = port[name]
        if _bn_fed_bias(name):
            assert max(float(pg.abs().max()), float(g.abs().max())) <= 1e-5 * top, name
            continue
        ref = float(g.abs().max())
        spread = max(float((m[name] - g).abs().max()) for m in moved)
        spread_max = max(spread_max, spread / ref)
        rel = 1e-4 if name.startswith(EXACT) else 1e-4 + 2 * spread / ref
        close(pg, g.numpy(), rel=rel, abs_=1e-6 * top)
    return spread_max


def test_one_head_of_width_320_forward_matches_jax(one_head320):
    """The train-mode forward at ``embed_dim=320, heads=1`` (head dim 320,
    above the wide plans' 256) from ``from_jax_variables``' weights: mu and
    logvar (through the attention) and the reconstruction against JAX's
    within 1e-4 of their max|ref| (``tests/test_torch_vit.py``'s rel)."""
    for name, (got, want) in one_head320["forward"].items():
        close(got, np.asarray(want), rel=1e-4, abs_=1e-6)


# the conv stem below the transformer
_STEM = ("backbone.stem_convs.", "backbone.stem_bns.")


def test_one_head_of_width_320_step_matches_jax(one_head320):
    """One step at ``embed_dim=320, heads=1``, depth 1, against JAX's, under
    the rule of ``test_one_head_of_width_64_step_matches_jax``: loss terms to
    rel 1e-4, the KL term's gradients (the attention's backward at D = 320)
    leaf by leaf to 1e-4 of max|ref| plus 1e-6 of the largest, except the
    conv stem's leaves, held to 1e-2. There the reference is the less exact
    side: JAX's f32 step sits up to 4.8e-3 of max|ref| from the float64
    model (``stem_convs.2``), from its f32 batch statistics, and the port's
    f32 step within 1e-4 (the next test). The attention's leaves and
    everything above the stem hold at 1e-4."""
    _hold_one_head_step(one_head320, stem_rel=1e-2)


def _stats_f64(x, use_pallas, groups):
    """``_stats`` of the JAX BatchNorm (its jnp branch) with the sums in
    float64, the statistics returned in float32."""
    c = x.shape[-1] // groups
    n = x.size // c
    xf = x.astype(jnp.float64)
    axes = tuple(range(x.ndim - 1))
    mean = jnp.sum(xf, axis=axes).reshape(groups, c).sum(0) / n
    var = jnp.maximum(jnp.sum(xf * xf, axis=axes).reshape(groups, c).sum(0) / n
                      - mean * mean, 0.0)
    return mean.astype(jnp.float32), var.astype(jnp.float32)


def _jax_kld_grads(case, dtype):
    """JAX's gradients under the KL term alone at the case's weights and
    batch, computing in ``dtype``, as port-named float64 arrays."""
    jm = JaxCausalViTVAE(**case["kw"], packed=False, dropout=0.0, dtype=dtype)
    b = {k: jnp.asarray(v, dtype) for k, v in case["batch"].items()}
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), case["variables"])
    cfg = JaxVesselConfig()

    def kld(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, b["x"], b["m"],
                          b["t"], b["eps"], method=_jax_fwd, mutable=["batch_stats"])
        return JL.vessel_loss(out, b["x"], b["m"], beta=cfg.beta,
                              lambda_morph=cfg.lambda_morph,
                              lambda_sparsity=cfg.lambda_sparsity)[1]["kld"]

    g = to_numpy_tree(jax.jit(jax.grad(kld))(v["params"]))
    pm = CausalViTVAE(**case["kw"], dropout=0.0, device="cpu").double()
    return {k: t.numpy() for k, t in from_jax_variables(pm, {"params": g}).items()}


def test_one_head_of_width_320_stem_rounding_is_jax_f32_batch_statistics(one_head320,
                                                                         monkeypatch):
    """Where the stem's 4.8e-3 comes from. The JAX model run wholly in
    float64 (``jax.enable_x64``, every ``jnp.float32`` of the package read
    as float64) is the exact side: the port's f32 KL-term gradients sit
    within 1e-4 of its max|ref| plus 1e-6 of the largest gradient at
    every leaf (``_hold_one_head_step``'s rule; read: 2.1e-5 of max|ref| at
    the stem), JAX's own f32 step misses
    1e-4 at the stem (read: 4.8e-3, ``stem_convs.2``), and JAX's f32 step
    with only its BatchNorm statistics (``_stats``: Σx and Σx² in f32,
    var = E[x²] - E[x]²) summed in float64, the control, holds 1e-4 there
    (read: 9e-6). The rounding is in the reference's f32 batch
    statistics, not in the port."""
    from causalvae_tpu.ops.kernels import batchnorm as kb

    with jax.enable_x64(True):
        with monkeypatch.context() as mp:
            mp.setattr(jnp, "float32", jnp.float64)
            exact = _jax_kld_grads(one_head320, jnp.float64)
        with monkeypatch.context() as mp:
            mp.setattr(kb, "_stats", _stats_f64)
            control = _jax_kld_grads(one_head320, jnp.float32)
    port, jax32 = one_head320["port"]["kld"], one_head320["jax"]["kld"]

    top = max(float(np.abs(g).max()) for g in exact.values())

    def worst(grads, names):
        """The largest error over the rule's bound (1e-4 of the leaf's
        max|ref| plus 1e-6 of the largest gradient)."""
        return max(float(np.abs(np.asarray(grads[n], np.float64) - exact[n]).max())
                   / (1e-4 * float(np.abs(exact[n]).max()) + 1e-6 * top) for n in names)

    held = [n for n, g in port.items() if g is not None and not _bn_fed_bias(n)]
    stem = [n for n in held if n.startswith(_STEM)]
    assert len(stem) == 15 and len(held) >= 30
    assert worst({n: port[n].numpy() for n in held}, held) <= 1.0
    assert worst(jax32, stem) > 10.0
    assert worst(control, stem) <= 1.0


def test_one_head_of_width_320_gradients_within_jax_rounding_spread(one_head320):
    """The whole objective's gradients at ``embed_dim=320, heads=1`` under
    the rule of ``test_one_head_of_width_64_gradients_within_jax_rounding_spread``:
    each leaf within twice the spread of JAX's own one-ulp-moved runs plus
    1e-4 of its max|ref|, the ``EXACT`` leaves at 1e-4."""
    _hold_one_head_gradients(one_head320)


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


def test_clipped_adam_state_dict_carries_the_step_count():
    """After n steps, a fresh optimizer loaded from ``state_dict()`` takes
    step n+1 bit for bit as the unbroken run does (the bias correction
    continues from n, the first moment stays bfloat16)."""
    import copy

    rng = np.random.default_rng(1)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,), (2, 4, 3))]
    grads = [_grads(rng, scale) for scale in (3.0, 0.5, 0.05, 0.2)]

    def step(opt, params, g):
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        opt.step()

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ClippedAdam(params, LR, 5.0, torch.bfloat16)
    for g in grads[:3]:
        step(opt, params, g)
    saved = copy.deepcopy(opt.state_dict())
    at_n = [p.detach().clone() for p in params]

    def resume(state_dict):
        resumed = [torch.nn.Parameter(p.clone()) for p in at_n]
        opt2 = ClippedAdam(resumed, LR, 5.0, torch.bfloat16)
        opt2.load_state_dict(state_dict)
        step(opt2, resumed, grads[3])
        return resumed, opt2

    step(opt, params, grads[3])
    resumed, opt2 = resume(saved)
    assert [g["count"] for g in opt2.param_groups] == [4]
    for p, q in zip(params, resumed):
        assert torch.equal(p, q)
        assert opt2.state[q]["mu"].dtype == torch.bfloat16
        for key in ("mu", "nu"):
            assert torch.equal(opt.state[p][key], opt2.state[q][key]), key
    # the count is what carries it: the same moments restarted at count 0
    # (the optimizer before it kept the count in its state) step elsewhere
    saved["param_groups"][0]["count"] = 0
    restarted, _ = resume(saved)
    assert not all(torch.equal(p, q) for p, q in zip(params, restarted))


def test_clipped_adam_updates_a_leaf_without_a_gradient_as_optax():
    """A leaf left out of the loss on one step (``.grad`` None after
    ``zero_grad``) is optax's zero gradient: its moments decay and it moves.
    Three steps of a small model whose second step skips one leaf, against
    optax ``chain(clip_by_global_norm(5), adam(lr, mu_dtype=bf16))`` given a
    zero gradient for it; the tolerance of the three-step test above."""
    rng = np.random.default_rng(2)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (3,), (3, 2))]
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ClippedAdam(params, LR, 5.0, torch.bfloat16)
    tx = _tx()
    update = jax.jit(tx.update)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    for i, x in enumerate(xs):
        use_head = i != 1  # step 1 leaves the last leaf out of the loss
        opt.zero_grad(set_to_none=True)
        h = torch.from_numpy(x) @ params[0] + params[1]
        loss = 30.0 * ((h @ params[2]).square().sum() if use_head else h.square().sum())
        loss.backward()
        assert (params[2].grad is None) == (not use_head)
        g = [np.zeros_like(p0[k]) if p.grad is None else p.grad.numpy().copy()
             for k, p in enumerate(params)]
        before = params[2].detach().clone()
        opt.step()
        assert float((params[2].detach() - before).abs().min()) > 0.1 * LR  # it moved
        upd, state = update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, want in zip(params, jp):
            close(p, np.asarray(want), rel=1e-6, abs_=0.0)
    for p, want_mu, want_nu in zip(params, state[1][0].mu, state[1][0].nu):
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
