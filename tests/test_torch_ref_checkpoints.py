"""The port's converters of reference PyTorch checkpoints
(``train/checkpoints.py`` ``load_torch_checkpoint``, ``smart_port``,
``interpolate_pos_embedding``; ``train/port_maps.py`` ``port_*_checkpoint``)
against the JAX package's, on the CPU.

For each ported model family, C1, C4, C5, C7, C8 (the vessel backbone,
``dec_res_stages`` 3, and the latent translator's, 4), C9 and C10, a
reference-layout torch model is built (the JAX package's own builders,
``train/parity.py`` and ``train/parity_vit.py``, or the torch classes of
``tests/test_port*.py``) with seeded weights and non-trivial BatchNorm
statistics. Then:
- bits: the port's converter output equals, leaf for leaf,
  ``from_jax_variables(model, <JAX port_*_checkpoint>(JAX's initial
  variables, the same state dict))``, the port model started from those
  same initial variables, so entries the converters skip compare too; a
  resized positional embedding within 2e-6 of JAX's; ``skipped`` names the
  same entries with the same kind of reason;
- outputs: the converted port model's eval outputs against the reference
  model's, max|Δ| <= 1e-5 max|ref| + 1e-6 [worst 9.8e-7 of max|ref|,
  the translator's ViTVAE];
- ``interpolate_pos_embedding`` against JAX's ``jax.image.resize(...,
  "bicubic")`` at down, up and non-integer scales within 2e-6 [1.2e-6];
- ``load_torch_checkpoint`` reads a bare state dict and one under
  ``model_state_dict``; ``smart_port`` skips a missing key and a wrong
  shape (the entry keeps its value) as JAX's does, and raises ``KeyError``
  under ``strict=True``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from causalvae_tpu.models import vae as jvae
from causalvae_tpu.models import vit as jvit
from causalvae_tpu.train import checkpoints as JC
from causalvae_tpu.train import port_maps as JP
from causalvae_tpu.train.parity import build_torch_mnist, build_torch_vessel
from causalvae_tpu.train.parity_vit import build_torch_causal_vit

from causalvae_tpu_torch.models import vae as pvae
from causalvae_tpu_torch.models import vit as pvit
from causalvae_tpu_torch.train import checkpoints as PC
from causalvae_tpu_torch.train import port_maps as PP
from test_port import TorchViTVAE
from test_port_mnist import TorchCausalVAE
from test_port_small_models import TorchCascade, TorchCVAE
from torch_port_helpers import SMALL, close, load_port, to_numpy_tree, two_threads  # noqa: F401

OUT = dict(rel=1e-5, abs_=1e-6)
RESIZE_ABS = 2e-6
VIT = dict(embed_dim=32, depth=2, heads=4, mlp_dim=64)  # the small ViTs (SMALL's widths)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _stats(ref: nn.Module, seed: int) -> nn.Module:
    """Non-trivial BatchNorm affine and running statistics, then eval mode."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                n = mod.num_features
                mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                mod.bias.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    return ref.eval()


def _jax_init(module, *args, **kw):
    key = jax.random.PRNGKey(0)
    return to_numpy_tree(jax.jit(functools.partial(module.init, **kw))(
        {"params": key, "dropout": key}, *args))


def _inputs(b, hw, m_dim, t_dim, z_dim, seed=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((b, *hw, 1), dtype=np.float32),
            "m": rng.standard_normal((b, m_dim), dtype=np.float32),
            "t": np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, b)],
            "z": rng.standard_normal((b, z_dim), dtype=np.float32)}


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


# each family: () -> (reference model, JAX init variables, JAX converter call
# (variables, numpy state) -> (variables, skipped), port model, port
# converter call (model, state) -> (state_dict, skipped), [(name, reference
# call, port call)] of eval outputs on _inputs)
def _c1(gaussian):
    if gaussian:
        torch.manual_seed(0)
        ref = TorchCausalVAE(gaussian=True).eval()
    else:
        ref, _ = build_torch_mnist(seed=0)
        ref.eval()
    jm = jvae.CausalConvVAE(gaussian_mechanism=gaussian, decode_real_m=gaussian)
    v = _jax_init(jm, jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, 12)), jnp.zeros((1, 10)),
                  rng=jax.random.PRNGKey(0))
    pm = pvae.CausalConvVAE(gaussian_mechanism=gaussian, decode_real_m=gaussian, device="cpu")
    outputs = [("encode", lambda r, i: r.encode(_nchw(i["x"]), _t(i["m"]), _t(i["t"])),
                lambda p, i: p.encode(_t(i["x"]), _t(i["m"]), _t(i["t"]))),
               ("decode", lambda r, i: _nhwc(r.decode(_t(i["m"]), _t(i["z"]))),
                lambda p, i: p.decode(_t(i["m"]), _t(i["z"])))]
    if gaussian:
        outputs.append(("predict_m", lambda r, i: r.predict_m(_t(i["t"])),
                        lambda p, i: p.predict_m(_t(i["t"]))))
    return (ref, v, functools.partial(JP.port_mnist_checkpoint, gaussian=gaussian), pm,
            functools.partial(PP.port_mnist_checkpoint, gaussian=gaussian), outputs,
            dict(b=3, hw=(28, 28), m_dim=12, t_dim=10, z_dim=10))


def _c5():
    torch.manual_seed(0)
    ref = TorchCVAE().eval()
    jm = jvae.ConditionalVAE()
    v = _jax_init(jm, jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, 10)), rng=jax.random.PRNGKey(0))
    outputs = [("encode", lambda r, i: r.encode(_nchw(i["x"]), _t(i["t"])),
                lambda p, i: p.encode(_t(i["x"]), _t(i["t"]))),
               ("decode", lambda r, i: _nhwc(r.decode(_t(i["z"]), _t(i["t"]))),
                lambda p, i: p.decode(_t(i["z"]), _t(i["t"])))]
    return (ref, v, lambda v_, s: JP.port_simple_checkpoint(v_, s, JP.conditional_vae_name_maps()),
            pvae.ConditionalVAE(device="cpu"),
            lambda p, s: PP.port_simple_checkpoint(p, s, PP.conditional_vae_name_maps()),
            outputs, dict(b=3, hw=(28, 28), m_dim=12, t_dim=10, z_dim=10))


def _c7():
    grid = (1, 2)
    ref = _stats(build_torch_vessel(z_dim=16, grid=grid, seed=0), 1)
    jm = jvae.CausalVesselVAE(z_dim=16, grid_hw=grid, packed=False)
    v = _jax_init(jm, jnp.zeros((1, 128, 256, 1)), jnp.zeros((1, 12)), jnp.zeros((1, 19)),
                  rng=jax.random.PRNGKey(0), train=False)
    outputs = [("encode", lambda r, i: r.encode(_nchw(i["x"]), _t(i["m"]), _t(i["t"])),
                lambda p, i: p.encode(_t(i["x"]), _t(i["m"]), _t(i["t"]))),
               ("morph", lambda r, i: r.morph(_t(i["t"])), lambda p, i: p.morph(_t(i["t"]))),
               ("decode", lambda r, i: _nhwc(r.decode(_t(i["m"]), _t(i["z"]))),
                lambda p, i: p.decode(_t(i["m"]), _t(i["z"])))]
    return (ref, v, lambda v_, s: JP.port_vessel_cnn_checkpoint(v_, s, grid),
            pvae.CausalVesselVAE(z_dim=16, grid_hw=grid, device="cpu"),
            lambda p, s: PP.port_vessel_cnn_checkpoint(p, s, grid), outputs,
            dict(b=3, hw=(128, 256), m_dim=12, t_dim=19, z_dim=16))


def _vit_outputs():
    return [("encode", lambda r, i: r.encode(_nchw(i["x"])), lambda p, i: p.encode(_t(i["x"]))),
            ("decode", lambda r, i: _nhwc(r.decode(_t(i["z"]))),
             lambda p, i: p.decode(_t(i["z"])))]


class _Backbone(nn.Module):
    """The vessel ViTVAE (``build_torch_causal_vit``'s backbone) with the
    reference ViTVAE's ``encode`` (CLS through ``fc_mu`` and ``fc_var``)."""

    def __init__(self, backbone):
        super().__init__()
        self.inner = backbone

    def state_dict(self, *a, **kw):
        return self.inner.state_dict(*a, **kw)

    def encode(self, x):
        cls = self.inner.cls(x)
        return self.inner.fc_mu(cls), self.inner.fc_var(cls)

    def decode(self, z):
        return self.inner.decode(z)


def _c8(dec_res_stages, img=(64, 96), dst_img=None):
    """C8 at ``img``; with ``dst_img`` the port and JAX models are built at
    another size, so the positional embedding is resized on the way."""
    dst = dst_img or img
    if dec_res_stages == 3:
        ref = _stats(_Backbone(build_torch_causal_vit(img_size=img, z_dim=8, vit_latent=32,
                                                      **VIT).backbone), 2)
        latent = 32
    else:
        torch.manual_seed(0)
        ref = _stats(TorchViTVAE(n_res=4), 3)  # 64x64, latent 16
        img, dst, latent = (64, 64), (64, 64), 16
    kw = dict(img_size=dst, latent_dim=latent, dec_res_stages=dec_res_stages, **VIT)
    jm = jvit.ViTVAE(packed=False, **kw)
    v = _jax_init(jm, jnp.zeros((1, *dst, 1)), rng=jax.random.PRNGKey(0), train=False)
    src_grid, dst_grid = (img[0] // 32, img[1] // 32), (dst[0] // 32, dst[1] // 32)
    grids = dict(src_grid=src_grid, dst_grid=dst_grid) if dst != img else dict(grid_hw=src_grid)
    conv = dict(depth=2, embed_dim=32, dec_res_stages=dec_res_stages, **grids)
    return (ref, v, functools.partial(JP.port_vitvae_checkpoint, heads=4, **conv),
            pvit.ViTVAE(**kw, device="cpu"),
            functools.partial(PP.port_vitvae_checkpoint, **conv), _vit_outputs(),
            dict(b=2, hw=img, m_dim=12, t_dim=19, z_dim=latent))


def _c9():
    ref = _stats(build_torch_causal_vit(img_size=SMALL["img_size"], z_dim=SMALL["z_dim"],
                                        vit_latent=SMALL["vit_latent_dim"], **VIT), 4)
    jm = jvit.CausalViTVAE(**SMALL, packed=False)
    h, w = SMALL["img_size"]
    v = _jax_init(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)), jnp.zeros((1, 19)),
                  rng=jax.random.PRNGKey(0), train=False)
    conv = dict(causal=True, depth=2, embed_dim=32, grid_hw=(h // 32, w // 32))
    outputs = [("encode", lambda r, i: r.encode(_nchw(i["x"]), _t(i["m"]), _t(i["t"])),
                lambda p, i: p.encode(_t(i["x"]), _t(i["m"]), _t(i["t"]))),
               ("morph", lambda r, i: r.morph(_t(i["t"])), lambda p, i: p.morph(_t(i["t"]))),
               ("decode", lambda r, i: _nhwc(r.decode(_t(i["m"]), _t(i["z"]))),
                lambda p, i: p.decode(_t(i["m"]), _t(i["z"])))]
    return (ref, v, functools.partial(JP.port_vitvae_checkpoint, heads=4, **conv),
            pvit.CausalViTVAE(**SMALL, device="cpu"),
            functools.partial(PP.port_vitvae_checkpoint, **conv), outputs,
            dict(b=2, hw=SMALL["img_size"], m_dim=12, t_dim=19, z_dim=SMALL["z_dim"]))


def _c10():
    torch.manual_seed(0)
    ref = _stats(TorchCascade(m_dim=12, t_dim=19, latent=16), 5)
    jm = jvae.CausalBioVAE(z_dim=16)
    v = _jax_init(jm, jnp.zeros((1, 64, 64, 1)), jnp.zeros((1, 12)), jnp.zeros((1,), jnp.int32),
                  rng=jax.random.PRNGKey(0), train=False)
    outputs = [("encode", lambda r, i: r.encode(_nchw(i["x"]), _t(i["m"]), _t(i["t"])),
                lambda p, i: p.encode(_t(i["x"]), _t(i["m"]), _t(i["t"]))),
               ("mechanism", lambda r, i: r.mechanism(_t(i["t"])),
                lambda p, i: p.predict_m(_t(i["t"]))),
               ("decode", lambda r, i: _nhwc(r.decode(_t(i["z"]), _t(i["m"]), (64, 64))),
                lambda p, i: p.decode(_t(i["z"]), _t(i["m"]), (64, 64)))]
    return (ref, v, lambda v_, s: JP.port_simple_checkpoint(v_, s, JP.cascade_vae_name_maps()),
            pvae.CausalBioVAE(z_dim=16, device="cpu"),
            lambda p, s: PP.port_simple_checkpoint(p, s, PP.cascade_vae_name_maps()),
            outputs, dict(b=3, hw=(64, 64), m_dim=12, t_dim=19, z_dim=16))


FAMILIES = {
    "C1": functools.partial(_c1, False), "C4": functools.partial(_c1, True), "C5": _c5,
    "C7": _c7, "C8-vessel": functools.partial(_c8, 3), "C8-translator": functools.partial(_c8, 4),
    "C9": _c9, "C10": _c10,
    "C8-resized": functools.partial(_c8, 3, img=(64, 96), dst_img=(96, 128)),
}


@functools.lru_cache(maxsize=None)
def _ported(family):
    """(reference, port model loaded from the converter's output, the port's
    (state dict, skipped), JAX's converted state dict for that model and its
    skipped, outputs, input sizes)."""
    ref, v0, jax_port, pm, port, outputs, sizes = FAMILIES[family]()
    state = ref.state_dict()
    jv, jskipped = jax_port(v0, {k: a.detach().numpy() for k, a in state.items()})
    load_port(pm, v0)  # the port model starts from JAX's initial variables
    sd, skipped = port(pm, state)
    pm.load_state_dict(sd, strict=True)
    return ref, pm.eval(), sd, skipped, from_jax(pm, jv), jskipped, outputs, sizes


def from_jax(pm, variables):
    from causalvae_tpu_torch.train.port_maps import from_jax_variables

    return from_jax_variables(pm, to_numpy_tree(variables))


def _port_name(pm, flax_key):
    """The port key of a JAX flat key ("backbone/fc_mu/kernel" ->
    "backbone.fc_mu.weight")."""
    *path, leaf = flax_key.split("/")
    mod_path = PP._module_path(pm, tuple(path))
    try:
        layer_norm = isinstance(pm.get_submodule(mod_path), nn.LayerNorm)
    except AttributeError:  # a module the port model does not have
        layer_norm = False
    if leaf == "kernel" or (leaf == "scale" and layer_norm):
        leaf = "weight"
    return f"{mod_path}.{leaf}"


def _kind(reason):
    return reason.split(" ")[0].replace("-in-flax", "")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_equals_jax_converter_then_from_jax_variables(family):
    _, pm, sd, skipped, want, jskipped, _, _ = _ported(family)
    assert sorted(sd) == sorted(want) == sorted(pm.state_dict())
    for k, a in want.items():
        if k.endswith("pos_embedding") and family == "C8-resized":
            close(sd[k], a.numpy(), rel=0.0, abs_=RESIZE_ABS)
            continue
        assert sd[k].dtype == a.dtype and torch.equal(sd[k], a), k
    assert [(k, _kind(r)) for k, r in skipped] == [(_port_name(pm, k), _kind(r))
                                                   for k, r in jskipped]
    expected = {"C9": {("backbone.fc_mu.weight", "not-instantiated"),
                       ("backbone.fc_mu.bias", "not-instantiated"),
                       ("backbone.fc_var.weight", "not-instantiated"),
                       ("backbone.fc_var.bias", "not-instantiated")},
                "C8-resized": {("decoder_input.weight", "shape"), ("decoder_input.bias", "shape")}}
    assert {(k, _kind(r)) for k, r in skipped} == expected.get(family, set())


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "C8-resized"])
def test_converted_model_matches_the_reference_model(family):
    ref, pm, _, _, _, _, outputs, sizes = _ported(family)
    inputs = _inputs(**sizes)
    with torch.no_grad():
        for name, ref_call, port_call in outputs:
            want, got = ref_call(ref, inputs), port_call(pm, inputs)
            if not isinstance(want, tuple):
                want, got = (want,), (got,)
            assert len(want) == len(got), name
            for w, g in zip(want, got):
                close(g, w.numpy(), **OUT)


@pytest.mark.parametrize("src,dst", [((24, 40), (12, 20)), ((24, 40), (16, 27)),
                                     ((8, 8), (13, 5)), ((12, 20), (24, 40))])
def test_interpolate_pos_embedding_matches_jax(src, dst):
    """Down (the vessel ViT's 24x40 grid into the translator's 12x20), a
    non-integer scale, mixed, and up; the CLS token passes unchanged."""
    pos = np.random.default_rng(src[0] + dst[1]).standard_normal(
        (1, src[0] * src[1] + 1, 16)).astype(np.float32)
    want = np.asarray(JC.interpolate_pos_embedding(pos, src, dst))
    got = PC.interpolate_pos_embedding(_t(pos), src, dst)
    assert got.shape == want.shape == (1, dst[0] * dst[1] + 1, 16)
    assert torch.equal(got[:, 0], _t(pos)[:, 0])
    close(got, want, rel=0.0, abs_=RESIZE_ABS)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "model_state_dict"])
def test_load_torch_checkpoint_reads_both_file_forms(tmp_path, wrapped):
    ref = build_torch_vessel(z_dim=16, grid=(1, 2), seed=0)
    sd = ref.state_dict()
    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": sd, "epoch": 3} if wrapped else sd, path)
    got = PC.load_torch_checkpoint(path)
    want = JC.load_torch_checkpoint(path)
    assert list(got) == list(want) == list(sd)
    for k, a in got.items():
        assert a.device.type == "cpu" and not a.requires_grad
        np.testing.assert_array_equal(a.numpy(), want[k])


def test_smart_port_skips_a_missing_key_and_a_wrong_shape_as_jax_does():
    """strict=False: an absent reference key and a reference tensor of
    another shape are skipped and reported, their entries keep the target's
    value; the rest is ported. strict=True raises KeyError for the absent
    key, as JAX's does."""
    ref = build_torch_vessel(z_dim=16, grid=(1, 2), seed=0)
    state = {k: a.detach().clone() for k, a in ref.state_dict().items()}
    del state["enc_fc.3.bias"]
    state["dec_conv.1.weight"] = torch.zeros(512, 512, 3, 2)
    pm = pvae.CausalVesselVAE(z_dim=16, grid_hw=(1, 2), device="cpu")
    before = {k: a.clone() for k, a in pm.state_dict().items()}
    sd, skipped = PP.port_vessel_cnn_checkpoint(pm, state, (1, 2))
    assert skipped == [("enc_fc2.bias", "missing"),
                       ("dec_convs.0.weight", "shape (512, 512, 3, 2) != (512, 512, 3, 3)")]
    for k, _ in skipped:
        assert torch.equal(sd[k], before[k]), k
    assert torch.equal(sd["dec_convs.0.bias"], state["dec_conv.1.bias"])
    jm = jvae.CausalVesselVAE(z_dim=16, grid_hw=(1, 2), packed=False)
    v = _jax_init(jm, jnp.zeros((1, 128, 256, 1)), jnp.zeros((1, 12)), jnp.zeros((1, 19)),
                  rng=jax.random.PRNGKey(0), train=False)
    _, jskipped = JP.port_vessel_cnn_checkpoint(v, {k: a.numpy() for k, a in state.items()},
                                                (1, 2))
    assert [(_port_name(pm, k), _kind(r)) for k, r in jskipped] == [
        (k, _kind(r)) for k, r in skipped]
    name_map = PP.causal_vessel_vae_name_maps((1, 2))[0]
    with pytest.raises(KeyError, match="enc_fc.3.bias"):
        PC.smart_port(pm.state_dict(), state, name_map, strict=True)
    with pytest.raises(KeyError, match="enc_fc.3.bias"):
        JC.smart_port(JC.flatten_params(v["params"]), {k: a.numpy() for k, a in state.items()},
                      JP.causal_vessel_vae_name_maps((1, 2))[0], strict=True)
