"""Port parity: causalvae_tpu_torch models against the JAX models on the CPU.

Same weights (JAX init, perturbed, carried over by ``from_jax_variables``)
and the same numpy inputs through both; f32 tolerance
max|Δ| <= 1e-4 * max|ref| + 1e-5 (sums run in another order in the two
frameworks, nothing else differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.models import vit as jvit
from causalvae_tpu.models import vae as jvae
from causalvae_tpu.ops import subpixel as jsub
from causalvae_tpu.ops.kernels import batchnorm as jbn

from causalvae_tpu_torch.models import vae as pvae
from causalvae_tpu_torch.models import vit as pvit
from causalvae_tpu_torch.ops import subpixel as psub
from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm
from causalvae_tpu_torch.train.port_maps import from_jax_variables

from torch_port_helpers import SMALL, close, init_jax, inputs, load_port, small_causal_pair


@pytest.fixture(scope="module")
def causal():
    return small_causal_pair(seed=0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("method", ["encode", "decode", "predict_m", "morph"])
def test_causal_vit_vae_matches_jax(causal, method):
    jm, v, pm = causal
    x, m, t = inputs(3)
    z = np.random.default_rng(9).standard_normal((3, SMALL["z_dim"])).astype(np.float32)
    with torch.inference_mode():
        if method == "encode":
            want = jm.apply(v, x, m, t, method=jm.encode)
            got = pm.encode(_t(x), _t(m), _t(t))
        elif method == "decode":
            want = (jm.apply(v, m, z, method=jm.decode),)
            got = (pm.decode(_t(m), _t(z)),)
        elif method == "predict_m":
            want = (jm.apply(v, t, method=jm.predict_m),)
            got = (pm.predict_m(_t(t)),)
        else:
            want = jm.apply(v, t, method=lambda mdl, t_: mdl.morph(t_))
            got = pm.morph(_t(t))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


def test_causal_forward_with_given_eps_matches_jax(causal):
    """forward() with the JAX noise handed in: VAEOutput fields agree."""
    jm, v, pm = causal
    x, m, t = inputs(2, seed=4)
    eps = np.random.default_rng(5).standard_normal((2, SMALL["z_dim"])).astype(np.float32)
    mu, logvar = jm.apply(v, x, m, t, method=jm.encode)
    z = np.asarray(mu) + eps * np.exp(0.5 * np.asarray(logvar))
    want_recon = jm.apply(v, m, z, method=jm.decode)
    with torch.inference_mode():
        out = pm(_t(x), _t(m), _t(t), eps=_t(eps))
    close(out.recon_x, want_recon)
    close(out.mu, mu)
    close(out.logvar, logvar)
    assert out.m_mu is out.m_hat


@pytest.mark.parametrize("dec_res_stages", [3, 4])
def test_vit_vae_matches_jax(dec_res_stages):
    kw = dict(img_size=(64, 96), latent_dim=32, embed_dim=32, depth=2, heads=4,
              mlp_dim=64, dec_res_stages=dec_res_stages)
    jm = jvit.ViTVAE(**kw, packed=False)
    variables = init_jax(jm, jnp.zeros((1, 64, 96, 1)),
                         rng=jax.random.PRNGKey(0), seed=dec_res_stages)
    pm = load_port(pvit.ViTVAE(**kw, device="cpu"), variables)
    assert len(pm.dec_res) == dec_res_stages
    x, _, _ = inputs(2)
    z = np.random.default_rng(1).standard_normal((2, 32)).astype(np.float32)
    with torch.inference_mode():
        got_mu, got_lv = pm.encode(_t(x))
        got_rec = pm.decode(_t(z))
    want_mu, want_lv = jm.apply(variables, x, method=jm.encode)
    close(got_mu, want_mu)
    close(got_lv, want_lv)
    close(got_rec, jm.apply(variables, z, method=jm.decode))


@pytest.mark.parametrize("fused_stages", [False, True])
@pytest.mark.parametrize("packed_io", [False, True])
def test_packed_causal_vit_vae_matches_jax(fused_stages, packed_io):
    """The phase-packed model (``packed=True``) in eval mode against the JAX
    packed model of the same options, depth 1: the packed JAX variables load
    strictly (same tree as the spatial model's), and encode, decode and the
    forward with given noise agree; with ``packed_io`` the image goes in
    ``space_to_depth_n(x, 3)``-packed and the reconstruction comes out so."""
    kw = dict(SMALL, depth=1)
    h, w = kw["img_size"]
    jm = jvit.CausalViTVAE(**kw, packed=True, packed_io=packed_io,
                           fused_stages=fused_stages)
    x0 = jnp.zeros((1, h // 8, w // 8, 64) if packed_io else (1, h, w, 1))
    v = init_jax(jm, x0, jnp.zeros((1, 12)), jnp.zeros((1, 19)),
                 rng=jax.random.PRNGKey(0), train=False, seed=2)
    pm = load_port(pvit.CausalViTVAE(**kw, packed=True, packed_io=packed_io,
                                     fused_stages=fused_stages, device="cpu"), v)
    x, m, t = inputs(3, seed=6)
    if packed_io:
        x = np.asarray(psub.space_to_depth_n(x, 3))
    eps = np.random.default_rng(8).standard_normal((3, kw["z_dim"])).astype(np.float32)
    mu, logvar = jm.apply(v, x, m, t, method=jm.encode)
    z = np.asarray(mu) + eps * np.exp(0.5 * np.asarray(logvar))
    want_recon = jm.apply(v, m, z, method=jm.decode)
    with torch.inference_mode():
        out = pm(_t(x), _t(m), _t(t), eps=_t(eps))
        dec = pm.decode(_t(m), _t(z))
    assert out.recon_x.shape == want_recon.shape == (
        (3, h // 8, w // 8, 64) if packed_io else (3, h, w, 1))
    close(out.mu, mu)
    close(out.logvar, logvar)
    close(out.recon_x, want_recon)
    close(dec, want_recon)


def test_packed_options_need_packed():
    with pytest.raises(ValueError, match="packed=True"):
        pvit.ViTVAE(img_size=(64, 96), embed_dim=32, depth=1, heads=4, mlp_dim=64,
                    fused_stages=True, device="cpu")


def test_vessel_model_builds_the_packed_formulation_with_the_same_weights():
    """``cli.main.vessel_model`` passes the layout options through, and the
    seeded weights do not depend on them (chip_smoke compares the two)."""
    from causalvae_tpu_torch.cli.main import vessel_model

    spatial, _ = vessel_model((64, 96), device="cpu", seed=3)
    packed, _ = vessel_model((64, 96), device="cpu", seed=3, packed=True,
                             packed_io=True, fused_stages=True)
    bb = packed.backbone
    assert (bb.packed, bb.packed_io, bb.fused_stages) == (True, True, True)
    assert not spatial.backbone.packed
    for (ka, ta), (kb, tb) in zip(spatial.state_dict().items(), packed.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    x, m, t = inputs(2)
    with torch.inference_mode():
        out = packed.eval()(_t(psub.space_to_depth_n(x, 3)), _t(m), _t(t),
                            eps=torch.zeros(2, packed.z_dim))
    assert out.recon_x.shape == (2, 8, 12, 64) and torch.isfinite(out.recon_x).all()


def test_converter_consumes_every_leaf_once(causal):
    _, v, pm = causal
    sd = from_jax_variables(pm, v)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(pm.state_dict())
    assert set(sd) == set(pm.state_dict())


def test_converter_rejects_missing_extra_and_misshapen_leaves(causal):
    _, v, pm = causal
    params = dict(v["params"])
    extra = {"params": {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        from_jax_variables(pm, extra)
    missing = {"params": {k: w for k, w in params.items() if k != "morph"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="morph"):
        from_jax_variables(pm, missing)
    bad = {**params, "dec_adapter_fc2": {
        "kernel": np.zeros((3, 3), np.float32),
        "bias": params["dec_adapter_fc2"]["bias"]}}
    with pytest.raises(ValueError, match="dec_adapter_fc2"):
        from_jax_variables(pm, {"params": bad, "batch_stats": v["batch_stats"]})


def test_wrapped_backbone_has_no_latent_heads(causal):
    """CausalViTVAE's JAX variables have no backbone/fc_mu or fc_var
    (encode_cls never creates them); the port neither has nor needs them."""
    _, v, pm = causal
    assert "fc_mu" not in v["params"]["backbone"]
    assert "fc_var" not in v["params"]["backbone"]
    assert not any(k.startswith(("backbone.fc_mu", "backbone.fc_var"))
                   for k in pm.state_dict())


def test_qkv_weight_is_densegeneral_kernel_reshaped(causal):
    """qkv DenseGeneral kernel (E, 3, H, D) -> Linear weight reshape(E, 3E).T."""
    _, v, pm = causal
    kern = v["params"]["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"]
    e = kern.shape[0]
    assert kern.shape == (e, 3, 4, e // 4)
    w = pm.backbone.blocks[0].attn.qkv.weight.detach().numpy()
    np.testing.assert_array_equal(w, kern.reshape(e, 3 * e).T)


def test_decoder_input_output_is_viewed_nhwc(causal):
    """The JAX decoder reshapes decoder_input's output row-major NHWC
    (B, gh, gw, E); the NCHW port must view it that way and then permute,
    never view(B, E, gh, gw) (the round-5 port bug)."""
    _, _, pm = causal
    bb = pm.backbone
    gh, gw = bb.grid_hw
    e = bb.embed_dim
    seen = {}
    hook = bb.dec_ct[0].register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].clone()))
    try:
        with torch.no_grad():
            lin = bb.decoder_input
            saved = lin.weight.clone(), lin.bias.clone()
            lin.weight.zero_()
            lin.bias.copy_(torch.arange(lin.bias.numel(), dtype=torch.float32))
            bb.eval().decode(torch.zeros(1, lin.in_features))
            lin.weight.copy_(saved[0])
            lin.bias.copy_(saved[1])
    finally:
        hook.remove()
    want = torch.arange(gh * gw * e, dtype=torch.float32).view(1, gh, gw, e)
    assert torch.equal(seen["x"], want.permute(0, 3, 1, 2))


def test_adapter_clips_match_jax(causal):
    """C9 clips logvar to ±10 and mu to ±100: blow up the encoder adapter's
    output bias and both frameworks saturate at the same values."""
    jm, v, pm = causal
    v2 = jax.tree_util.tree_map(np.copy, v)
    bias = v2["params"]["enc_adapter_fc2"]["bias"]
    bias[: SMALL["z_dim"]] = np.linspace(-500, 500, SMALL["z_dim"])
    bias[SMALL["z_dim"]:] = np.linspace(-50, 50, SMALL["z_dim"])
    pm2 = load_port(pvit.CausalViTVAE(**SMALL, device="cpu"), v2)
    x, m, t = inputs(2)
    with torch.inference_mode():
        mu, logvar = pm2.encode(_t(x), _t(m), _t(t))
    assert float(mu.abs().max()) == 100.0 and float(logvar.abs().max()) == 10.0
    want_mu, want_lv = jm.apply(v2, x, m, t, method=jm.encode)
    close(mu, want_mu)
    close(logvar, want_lv)


def test_resblock_slope_matches_jax():
    """ResBlock uses LeakyReLU 0.2 (the stem and decoder use 0.01)."""
    jm = jvit.ResBlock(8)
    x = np.random.default_rng(0).standard_normal((2, 6, 10, 8)).astype(np.float32)
    variables = init_jax(jm, jnp.asarray(x))
    pm = load_port(pvit.ResBlock(8), variables)
    with torch.inference_mode():
        got = pm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jm.apply(variables, x))


def test_vit_block_gelu_and_layernorm_eps_match_jax():
    """Exact GELU and LayerNorm eps 1e-5: tokens with a variance near eps
    make a wrong eps visible."""
    jm = jvit.ViTBlock(16, 4, 32)
    x = (1e-3 * np.random.default_rng(1).standard_normal((2, 7, 16))).astype(np.float32)
    variables = init_jax(jm, jnp.asarray(x))
    pm = load_port(pvit.ViTBlock(16, 4, 32), variables)
    assert pm.norm1.eps == pm.norm2.eps == 1e-5
    with torch.inference_mode():
        got = pm(_t(x))
    close(got, jm.apply(variables, x))


def test_batchnorm_eval_matches_jax_and_train_raises():
    """Eval parity, and train-mode parity (train mode no longer raises since
    the training slice): batch statistics, y and the running-statistics
    update against the JAX BatchNorm with ``mutable=["batch_stats"]``."""
    x = np.random.default_rng(2).standard_normal((3, 5, 7, 6)).astype(np.float32)
    jm = jbn.BatchNorm()
    variables = init_jax(jm, jnp.asarray(x), use_running_average=True)
    pm = load_port(BatchNorm(6), variables)
    with torch.inference_mode():
        got = pm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jm.apply(variables, x, use_running_average=True))
    want, mutated = jm.apply(variables, x, use_running_average=False,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = pm.train()(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, want)
    close(pm.mean, mutated["batch_stats"]["mean"])
    close(pm.var, mutated["batch_stats"]["var"])


@pytest.mark.parametrize("kind", ["conv", "conv_t_subpixel", "conv_t_plain", "stem", "conv3x3"])
def test_conv_layers_match_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    if kind == "conv":
        jm, pm = jvae.conv(5, 4, 2, 1), pvae.conv(3, 5, 4, 2, 1)
    elif kind == "conv_t_subpixel":
        jm, pm = jvae.conv_t(5, 3, 2, 1, output_padding=1), pvae.conv_t(3, 5, 3, 2, 1, 1)
        assert isinstance(pm, psub.SubpixelConvTranspose2x)
    elif kind == "conv_t_plain":
        jm, pm = jvae.conv_t(5, 4, 2, 1), pvae.conv_t(3, 5, 4, 2, 1)
    elif kind == "stem":
        jm, pm = jsub.LiftableStemConv(5), psub.LiftableStemConv(3, 5)
    else:
        jm, pm = jsub.PhaseableConv3x3(5), psub.PhaseableConv3x3(3, 5)
    variables = init_jax(jm, jnp.asarray(x))
    pm = load_port(pm, variables)
    with torch.inference_mode():
        got = pm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jm.apply(variables, x))


def test_reparameterize_uses_given_eps_or_generator():
    mu = torch.tensor([[0.5, -1.0]])
    logvar = torch.tensor([[0.0, 2.0]])
    eps = torch.tensor([[1.0, -2.0]])
    z = pvae.reparameterize(mu, logvar, eps=eps)
    torch.testing.assert_close(z, mu + eps * torch.exp(0.5 * logvar))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    torch.testing.assert_close(pvae.reparameterize(mu, logvar, generator=g1),
                               pvae.reparameterize(mu, logvar, generator=g2))


def test_seeded_init_is_deterministic_and_finite():
    a = pvae.seeded_init_(pvit.CausalViTVAE(**SMALL, device="cpu"), 11).eval()
    b = pvae.seeded_init_(pvit.CausalViTVAE(**SMALL, device="cpu"), 11).eval()
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    assert (a.backbone.dec_bns[0].var > 0).all()
    x, m, t = inputs(2)
    with torch.inference_mode():
        out = a(_t(x), _t(m), _t(t), eps=torch.zeros(2, SMALL["z_dim"]))
    assert torch.isfinite(out.recon_x).all() and out.recon_x.shape == (2, 64, 96, 1)
