"""Port parity of ``ops/subpixel.py``: the phase-packing functions and the
three conv classes in their packed (``nhwc``) form, against the JAX package.

Kernel transforms (``phase_kernel_2x``, ``lift_once``, ``consume_once``) only
move entries, so they are held exactly; so are ``space_to_depth_n``/
``depth_to_space_n`` (pure reshapes, torch and numpy). Convolutions (``same_conv``
and the classes) are held at the port's f32 tolerance, max|Δ| <= 1e-4
max|ref| + 1e-5 (sums in another order); their weight gradients, through the
gathered lifted kernel into the torch-layout leaf, likewise against
``jax.grad`` of the JAX module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops import subpixel as jsub

from causalvae_tpu_torch.ops import subpixel as psub

from torch_port_helpers import close, init_jax, load_port


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_phase_kernel_2x_matches_jax():
    w = _rng(0).standard_normal((3, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(psub.phase_kernel_2x(_t(w)).numpy(),
                                  np.asarray(jsub.phase_kernel_2x(jnp.asarray(w))))


@pytest.mark.parametrize("k,pad_lo", [(3, 1), (2, 0), (2, 1)])
@pytest.mark.parametrize("fn", ["lift_once", "consume_once"])
def test_lift_and_consume_match_jax(k, pad_lo, fn):
    w = _rng(k + pad_lo).standard_normal((k, k, 3, 2)).astype(np.float32)
    want, want_pl = getattr(jsub, fn)(jnp.asarray(w), pad_lo)
    got, got_pl = getattr(psub, fn)(_t(w), pad_lo)
    assert got_pl == want_pl
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_space_depth_n_match_jax_on_torch_and_numpy(n):
    x = _rng(n).standard_normal((2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jsub.space_to_depth_n(jnp.asarray(x), n))
    np.testing.assert_array_equal(psub.space_to_depth_n(x, n), want)
    np.testing.assert_array_equal(psub.space_to_depth_n(_t(x), n).numpy(), want)
    np.testing.assert_array_equal(psub.depth_to_space_n(want, n), x)
    np.testing.assert_array_equal(psub.depth_to_space_n(_t(want), n).numpy(), x)
    y = _t(x)
    for _ in range(n):
        y = psub.space_to_depth_2x(y)
    np.testing.assert_array_equal(y.numpy(), want)
    for _ in range(n):
        y = psub.depth_to_space_2x(y)
    np.testing.assert_array_equal(y.numpy(), x)


@pytest.mark.parametrize("k,pad_lo", [(3, 1), (2, 0), (2, 1)])
def test_same_conv_matches_jax(k, pad_lo):
    rng = _rng(10 + k + pad_lo)
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8, 5)).astype(np.float32)
    close(psub.same_conv(_t(x), _t(w), pad_lo),
          jsub.same_conv(jnp.asarray(x), jnp.asarray(w), pad_lo))


@pytest.mark.parametrize("recipe,k,levels", [("conv", 3, 1), ("conv", 3, 3), ("convT", 3, 0),
                                             ("convT", 3, 2), ("stem", 3, 1), ("stem", 3, 3)])
def test_lifted_kernel_gather_equals_the_lifting_chain(recipe, k, levels):
    """The one-gather lifted kernel equals the JAX chain of lifting
    functions on the same (JAX-layout) kernel, entry for entry."""
    w = _rng(levels).standard_normal((k, k, 3, 2)).astype(np.float32)
    lifts = levels
    if recipe == "conv":
        want, pl = jnp.asarray(w), 1
    elif recipe == "stem":
        want, pl = jsub.consume_once(jnp.asarray(w), 1)
        lifts = levels - 1
    else:  # w is the transposed conv's (3, 3, C_out, C_in) kernel
        want, pl = jsub.phase_kernel_2x(jnp.asarray(w)), 0
    for _ in range(lifts):
        want, pl = jsub.lift_once(want, pl)
    blocks = _t(w.transpose(0, 1, 3, 2)) if recipe == "convT" else _t(w)
    got, got_pl = psub.lifted_kernel(blocks, recipe, levels)
    assert got_pl == pl
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lifted_kernel_trains_after_an_inference_mode_call():
    """The cached tap index made under torch.inference_mode (serving) must
    not be an inference tensor: a later training call backpropagates."""
    psub._tap_index.cache_clear()
    w = torch.randn(3, 3, 2, 3, requires_grad=True)
    with torch.inference_mode():
        psub.lifted_kernel(w.detach(), "conv", 2)
    pk, _ = psub.lifted_kernel(w, "conv", 2)
    pk.sum().backward()
    # each base tap appears once per (input phase, output phase) pair it serves
    assert w.grad.shape == w.shape and float(w.grad.min()) > 0


def _packed_input(levels, c, seed, hw=(4, 6)):
    return _rng(seed).standard_normal((2, *hw, c * 4 ** levels)).astype(np.float32)


def _prologue(c, levels, seed):
    rng = _rng(seed)
    mul = (rng.random(c) + 0.5).astype(np.float32)
    add = rng.standard_normal(c).astype(np.float32)
    g = 4 ** levels
    return np.tile(mul, g), np.tile(add, g)


# (class, JAX call kwargs, real input channels, features)
CASES = [
    ("subpixel", dict(phase_output=False, in_levels=0), 6, 5),
    ("subpixel", dict(phase_output=True, in_levels=1), 6, 5),
    ("subpixel", dict(phase_output=True, in_levels=2, use_pallas=True), 4, 3),
    ("phaseable", dict(levels=0), 5, 4),
    ("phaseable", dict(levels=2), 4, 3),
    ("phaseable", dict(levels=1, prologue=0.2), 5, 4),
    ("stem", dict(in_levels=0), 5, 4),
    ("stem", dict(in_levels=1), 5, 4),
    ("stem", dict(in_levels=3, prologue=0.01), 3, 4),
]


@pytest.mark.parametrize("kind,kw,c_in,feat", CASES)
def test_classes_packed_call_and_weight_grads_match_jax(kind, kw, c_in, feat):
    """``nhwc(x, **JAX arguments)`` against the JAX module's call, and the
    gradients of a nonlinear loss in the port's weight and bias leaves
    against ``jax.grad`` of the same loss in the JAX kernel and bias."""
    kw = dict(kw)
    levels = kw.get("in_levels", kw.get("levels", 0))
    x = _packed_input(levels, c_in, seed=len(kw) + c_in)
    jcls, pcls = {"subpixel": (jsub.SubpixelConvTranspose2x, psub.SubpixelConvTranspose2x),
                  "phaseable": (jsub.PhaseableConv3x3, psub.PhaseableConv3x3),
                  "stem": (jsub.LiftableStemConv, psub.LiftableStemConv)}[kind]
    slope = kw.pop("prologue", None)
    jkw, pkw = dict(kw), dict(kw)
    if slope is not None:
        mul, add = _prologue(c_in, levels, seed=3)
        jkw["prologue"] = (jnp.asarray(mul), jnp.asarray(add), slope)
        pkw["prologue"] = (_t(mul), _t(add), slope)
    jm = jcls(feat)
    variables = init_jax(jm, jnp.asarray(x), **jkw)
    pm = load_port(pcls(c_in, feat), variables)
    want = jm.apply(variables, jnp.asarray(x), **jkw)
    got = pm.nhwc(_t(x), **pkw)
    close(got, want)

    def jloss(params):
        y = jm.apply({"params": params}, jnp.asarray(x), **jkw)
        return jnp.sum(jnp.sin(y))

    jgrad = jax.grad(jloss)(variables["params"])
    torch.sin(pm.nhwc(_t(x), **pkw)).sum().backward()
    kernel = np.asarray(jgrad["kernel"])
    close(pm.weight.grad, kernel.transpose(3, 2, 0, 1))
    close(pm.bias.grad, np.asarray(jgrad["bias"]))
