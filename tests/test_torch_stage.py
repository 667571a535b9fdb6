"""Port parity of the fused stage op (``ops/kernels/stage.py``) against the
JAX package's Pallas stage kernels, run in interpret mode on the CPU.

The port's ``affine_act_conv`` on CPU tensors runs the plain version
(``stage_reference``, and ``stage_bwd_reference`` in its autograd backward);
it is held to JAX ``_stage_call(..., interpret=True)`` for y and to
``_stage_bwd_call(..., interpret=True)`` for (dx, dW, db, dmul, dadd), for
K2 pad 0, K2 pad 1 and K3 pad 1, with and without the prologue, at
(2, 6, 10, 16) -> 24, ragged against every tile. Tolerance: max|Δ| <= 1e-4
max|ref| + 1e-5 (f32 sums in another order). The CUDA kernels are held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops.kernels import stage as jstage

from causalvae_tpu_torch.ops.kernels import stage as pstage

from torch_port_helpers import close

SHAPE = (2, 6, 10, 16)
CO = 24


def _case(k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    mul = (rng.random(SHAPE[-1]) + 0.5).astype(np.float32)
    add = rng.standard_normal(SHAPE[-1]).astype(np.float32)
    w = (rng.standard_normal((k, k, SHAPE[-1], CO)) * 0.2).astype(np.float32)
    b = rng.standard_normal(CO).astype(np.float32)
    dy = rng.standard_normal(SHAPE[:3] + (CO,)).astype(np.float32)
    return x, mul, add, w, b, dy


def _t(a, grad=False):
    return torch.from_numpy(a.copy()).requires_grad_(grad)


@pytest.mark.parametrize("k,pad_lo", [(2, 0), (2, 1), (3, 1)])
@pytest.mark.parametrize("prologue", [True, False])
def test_affine_act_conv_and_its_backward_match_the_pallas_kernels(k, pad_lo, prologue):
    x, mul, add, w, b, dy = _case(k, seed=10 * k + pad_lo)
    if not prologue:
        mul, add = np.ones_like(mul), np.zeros_like(add)
    slope = 0.2
    want_y = jstage._stage_call(
        jnp.asarray(x), jnp.asarray(mul), jnp.asarray(add), jnp.asarray(w),
        jnp.asarray(b), slope=slope, pad_lo=pad_lo, has_prologue=prologue,
        interpret=True)
    want = jstage._stage_bwd_call(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(mul), jnp.asarray(add),
        jnp.asarray(w), slope=slope, pad_lo=pad_lo, has_prologue=prologue,
        interpret=True)
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    mt, at = (_t(mul, True), _t(add, True)) if prologue else (None, None)
    before = (pstage.FWD_LAUNCHES, pstage.BWD_LAUNCHES)
    y = pstage.affine_act_conv(xt, mt, at, wt, bt, slope=slope, pad_lo=pad_lo)
    y.backward(_t(dy))
    assert (pstage.FWD_LAUNCHES, pstage.BWD_LAUNCHES) == before  # CPU: plain version
    close(y, want_y)
    dx, dw, db, dmul, dadd = (np.asarray(a) for a in want)
    close(xt.grad, dx)
    close(wt.grad, dw)
    close(bt.grad, db.ravel())
    if prologue:
        close(mt.grad, dmul.ravel())
        close(at.grad, dadd.ravel())


def test_stage_bwd_reference_returns_zero_affine_grads_without_prologue():
    x, mul, add, w, _, dy = _case(3, seed=5)
    dx, dw, db, dmul, dadd = pstage.stage_bwd(_t(x), _t(dy), _t(mul), _t(add), _t(w),
                                              0.01, 1, has_prologue=False)
    assert torch.equal(dmul, torch.zeros(SHAPE[-1])) and torch.equal(dadd, dmul)
    assert dx.shape == SHAPE and dw.shape == w.shape and db.shape == (CO,)


def test_padding_is_zero_after_the_activation():
    """An out-of-image tap adds 0, not leaky(add): with x = 0 inside, every
    in-image tap reads leaky(add) and the border outputs see fewer taps."""
    x = torch.zeros(1, 3, 4, 2)
    add = torch.tensor([1.0, 2.0])
    w = torch.ones(3, 3, 2, 1)
    y = pstage.affine_act_conv(x, torch.ones(2), add, w, torch.zeros(1), pad_lo=1)
    taps = torch.tensor([[4, 6, 6, 4], [6, 9, 9, 6], [4, 6, 6, 4]], dtype=torch.float32)
    torch.testing.assert_close(y[0, :, :, 0], 3.0 * taps)


def test_stage_rejects_bad_shapes():
    with pytest.raises(ValueError, match="pad_lo"):
        pstage.stage_fwd(torch.zeros(1, 2, 2, 3), torch.ones(3), torch.zeros(3),
                         torch.zeros(2, 2, 3, 4), torch.zeros(4), 0.01, 2)
    with pytest.raises(ValueError, match="Ci"):
        pstage.stage_fwd(torch.zeros(1, 2, 2, 3), torch.ones(3), torch.zeros(3),
                         torch.zeros(2, 2, 5, 4), torch.zeros(4), 0.01, 0)


# the fine-grid forward (``stage_fine_reference``/``stage_fwd_fine``): every
# (recipe, input levels) of the packed-fused model's stage calls
FINE_CASES = [("conv", 0), ("conv", 1), ("conv", 3), ("stem", 1), ("stem", 2), ("stem", 3),
              ("convT", 0), ("convT", 1), ("convT", 2)]


def _fine_case(recipe, levels, seed, ci=3, co=4, hw=(3, 5)):
    """Packed x (2, *hw, 4^levels ci), packed-width mul/add/bias, base kernel
    (3, 3, ci, co), and dy at the packed output's shape, from numpy."""
    rng = np.random.default_rng(seed)
    lout = pstage.out_levels(recipe, levels)
    n = ci << 2 * levels
    x = rng.standard_normal((2, *hw, n)).astype(np.float32)
    mul = (rng.random(n) + 0.5).astype(np.float32)
    add = rng.standard_normal(n).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
    b = rng.standard_normal(co << 2 * lout).astype(np.float32)
    dy = rng.standard_normal((2, *hw, co << 2 * lout)).astype(np.float32)
    return x, mul, add, w, b, dy


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_fine_reference_equals_the_lifted_stage(recipe, levels, prologue):
    """The module's own conv on the fine grid (unpack, conv, pack) equals the
    lifted stage on the packed tensor, ``stage_reference`` on
    ``lifted_kernel(w, recipe, levels)``: max|Δ| <= 1e-5 max|ref| (f32 sums
    in another order; the lifted kernel adds structural zeros only)."""
    from causalvae_tpu_torch.ops.subpixel import lifted_kernel

    x, mul, add, w, b, _ = _fine_case(recipe, levels, seed=levels + 10 * len(recipe))
    pk, pl = lifted_kernel(_t(w), recipe, levels)
    want = pstage.stage_reference(_t(x), _t(mul), _t(add), pk, _t(b), 0.2, pl, prologue)
    before = pstage.FINE_FWD_LAUNCHES
    got = pstage.stage_fwd_fine(_t(x), _t(mul), _t(add), _t(w), _t(b), 0.2, recipe, levels,
                                prologue)
    assert pstage.FINE_FWD_LAUNCHES == before  # CPU: the plain version
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("recipe,levels", [("conv", 1), ("stem", 2), ("convT", 1)])
def test_stage_fine_reference_matches_the_pallas_kernel(recipe, levels):
    """Against JAX ``_stage_call(..., interpret=True)`` on the kernel lifted
    by the JAX package's own lifting functions (the convT kernel in its
    (3, 3, C_out, C_in) layout): max|Δ| <= 1e-4 max|ref| + 1e-5."""
    from causalvae_tpu.ops import subpixel as jsub

    x, mul, add, w, b, _ = _fine_case(recipe, levels, seed=3 + levels)
    if recipe == "conv":
        jk, pl, lifts = jnp.asarray(w), 1, levels
    elif recipe == "stem":
        (jk, pl), lifts = jsub.consume_once(jnp.asarray(w), 1), levels - 1
    else:
        jk, pl, lifts = jsub.phase_kernel_2x(jnp.asarray(w.transpose(0, 1, 3, 2))), 0, levels
    for _ in range(lifts):
        jk, pl = jsub.lift_once(jk, pl)
    want = jstage._stage_call(jnp.asarray(x), jnp.asarray(mul), jnp.asarray(add), jk,
                              jnp.asarray(b), slope=0.01, pad_lo=pl, has_prologue=True,
                              interpret=True)
    got = pstage.stage_fwd_fine(_t(x), _t(mul), _t(add), _t(w), _t(b), 0.01, recipe, levels)
    close(got, want)


@pytest.mark.parametrize("recipe,levels", [("conv", 2), ("stem", 1), ("convT", 1)])
@pytest.mark.parametrize("prologue", [True, False])
def test_affine_act_conv_fine_gradients_are_the_lifted_ops(recipe, levels, prologue):
    """The fine op's backward gives the lifted op's gradients: from the same
    dy, those of x, mul and add (the fine-grid dgrad), of the base weight
    leaf (the fine-grid wgrad; the lifted op's reaches it through the lifted
    kernel's gather) and of the bias, each within 1e-5 max|ref| (sums in
    another order)."""
    from causalvae_tpu_torch.ops.subpixel import lifted_kernel

    x, mul, add, w, b, dy = _fine_case(recipe, levels, seed=20 + levels)
    grads = []
    for fine in (False, True):
        leaves = [_t(a, True) for a in (x, mul, add, w, b)]
        xt, mt, at, wt, bt = leaves
        if not prologue:
            mt = at = None
        if fine:
            y = pstage.affine_act_conv_fine(xt, mt, at, wt, bt, slope=0.2, recipe=recipe,
                                            levels=levels)
        else:
            pk, pl = lifted_kernel(wt, recipe, levels)
            y = pstage.affine_act_conv(xt, mt, at, pk, bt, slope=0.2, pad_lo=pl)
        y.backward(_t(dy))
        grads.append([t.grad for t in leaves])
    for name, lifted, fine in zip(("x", "mul", "add", "w", "b"), *grads):
        if lifted is None:
            assert fine is None and not prologue
        else:
            err = float((fine - lifted).abs().max())
            assert err <= 1e-5 * float(lifted.abs().max()), (name, err)


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
def test_dgrad_transposes_each_recipe_into_another(recipe, levels):
    """The map the dgrad kernel runs: da, the gradient of the fine-grid conv
    in its input, is the forward's fine-grid conv of dy with the recipe
    ``_TRANSPOSED[recipe]`` (conv -> conv, stem -> convT, convT -> stem) and
    the kernel ``stage_dgrad_weight`` (3, 3, Co, Ci), from dy's packing
    levels to x's: max|Δ| <= 1e-5 max|ref|."""
    x, mul, add, w, _, dy = _fine_case(recipe, levels, seed=40 + levels)
    da, _, _ = pstage.stage_dgrad_fine_reference(_t(x), _t(dy), _t(mul), _t(add), _t(w),
                                                 0.2, recipe, levels, has_prologue=False)
    lout = pstage.out_levels(recipe, levels)
    n = dy.shape[-1]
    wt = pstage.stage_dgrad_weight(_t(w), recipe)
    assert wt.shape == (3, 3, w.shape[3], w.shape[2])
    got = pstage.stage_fine_reference(_t(dy), torch.ones(n), torch.zeros(n), wt,
                                      torch.zeros(x.shape[-1]), 0.2,
                                      pstage._TRANSPOSED[recipe], lout, has_prologue=False)
    assert pstage.out_levels(pstage._TRANSPOSED[recipe], lout) == levels
    assert got.shape == da.shape
    assert float((got - da).abs().max()) <= 1e-5 * float(da.abs().max())


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_dgrad_fine_reference_equals_the_lifted_backward(recipe, levels, prologue):
    """dx, dmul and dadd of the fine-grid stage (``stage_dgrad_fine`` on CPU
    tensors: its plain version) equal ``stage_bwd_reference``'s on the lifted
    kernel: max|Δ| <= 1e-5 max|ref| (f32 sums in another order; the lifted
    kernel adds structural zeros only); dmul and dadd zeros without a
    prologue."""
    from causalvae_tpu_torch.ops.subpixel import lifted_kernel

    x, mul, add, w, _, dy = _fine_case(recipe, levels, seed=30 + levels + 10 * len(recipe))
    pk, pl = lifted_kernel(_t(w), recipe, levels)
    want = pstage.stage_bwd_reference(_t(x), _t(dy), _t(mul), _t(add), pk, 0.2, pl, prologue)
    before = pstage.FINE_DGRAD_LAUNCHES
    got = pstage.stage_dgrad_fine(_t(x), _t(dy), _t(mul), _t(add), _t(w), 0.2, recipe, levels,
                                  prologue)
    assert pstage.FINE_DGRAD_LAUNCHES == before  # CPU: the plain version
    for name, g, ref in zip(("dx", "dmul", "dadd"), got, (want[0], want[3], want[4])):
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        err = float((g - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)
    if not prologue:
        assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("recipe,levels", [("conv", 1), ("stem", 2), ("convT", 1)])
def test_stage_dgrad_fine_reference_matches_the_pallas_kernel(recipe, levels):
    """dx, dmul and dadd against JAX ``_stage_bwd_call(..., interpret=True)``
    on the kernel lifted by the JAX package's own lifting functions (as in
    the forward's test above): max|Δ| <= 1e-4 max|ref| + 1e-5."""
    from causalvae_tpu.ops import subpixel as jsub

    x, mul, add, w, _, dy = _fine_case(recipe, levels, seed=7 + levels)
    if recipe == "conv":
        jk, pl, lifts = jnp.asarray(w), 1, levels
    elif recipe == "stem":
        (jk, pl), lifts = jsub.consume_once(jnp.asarray(w), 1), levels - 1
    else:
        jk, pl, lifts = jsub.phase_kernel_2x(jnp.asarray(w.transpose(0, 1, 3, 2))), 0, levels
    for _ in range(lifts):
        jk, pl = jsub.lift_once(jk, pl)
    want = jstage._stage_bwd_call(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(mul),
                                  jnp.asarray(add), jk, slope=0.01, pad_lo=pl,
                                  has_prologue=True, interpret=True)
    dx, dmul, dadd = pstage.stage_dgrad_fine(_t(x), _t(dy), _t(mul), _t(add), _t(w), 0.01,
                                             recipe, levels)
    close(dx, np.asarray(want[0]))
    close(dmul, np.asarray(want[3]).ravel())
    close(dadd, np.asarray(want[4]).ravel())


def test_stage_dgrad_fine_rejects_bad_shapes():
    x = torch.zeros(1, 2, 2, 12)
    ones, zeros = torch.ones(12), torch.zeros(12)
    w = torch.zeros(3, 3, 3, 2)
    with pytest.raises(ValueError, match="dy"):
        pstage.stage_dgrad_fine(x, torch.zeros(1, 2, 2, 2), ones, zeros, w, 0.01, "conv", 1)
    with pytest.raises(ValueError, match="4\\^1"):
        pstage.stage_dgrad_fine(x, torch.zeros(1, 2, 2, 8), ones, zeros,
                                torch.zeros(3, 3, 4, 2), 0.01, "conv", 1)
    with pytest.raises(ValueError, match="mul"):
        pstage.stage_dgrad_fine(x, torch.zeros(1, 2, 2, 8), ones[:3], zeros, w, 0.01,
                                "conv", 1)
    with pytest.raises(ValueError, match="recipe"):
        pstage.stage_dgrad_fine(x, torch.zeros(1, 2, 2, 8), ones, zeros, w, 0.01, "deconv", 1)


def test_stage_bwd_wgrad_is_stage_bwd_without_its_dgrad():
    """The wgrad-only entry on CPU tensors: ``stage_bwd``'s dW and db, bit
    for bit, from the plain version (no launch counted)."""
    x, mul, add, w, _, dy = _case(3, seed=6)
    args = (_t(x), _t(dy), _t(mul), _t(add), _t(w), 0.2, 1)
    before = (pstage.WGRAD_LAUNCHES, pstage.BWD_LAUNCHES)
    dw, db = pstage.stage_bwd_wgrad(*args)
    assert (pstage.WGRAD_LAUNCHES, pstage.BWD_LAUNCHES) == before
    _, want_dw, want_db, _, _ = pstage.stage_bwd(*args)
    assert torch.equal(dw, want_dw) and torch.equal(db, want_db)
    with pytest.raises(ValueError, match="dy"):
        pstage.stage_bwd_wgrad(_t(x), _t(dy[..., :3]), *args[2:])


def test_stage_fine_rejects_bad_shapes():
    x = torch.zeros(1, 2, 2, 12)
    ones, zeros = torch.ones(12), torch.zeros(12)
    with pytest.raises(ValueError, match="4\\^1"):
        pstage.stage_fwd_fine(x, ones, zeros, torch.zeros(3, 3, 4, 2), torch.zeros(8), 0.01,
                              "conv", 1)
    with pytest.raises(ValueError, match="bias"):
        pstage.stage_fwd_fine(x, ones, zeros, torch.zeros(3, 3, 3, 2), torch.zeros(2), 0.01,
                              "conv", 1)
    with pytest.raises(ValueError, match="recipe"):
        pstage.stage_fwd_fine(x, ones, zeros, torch.zeros(3, 3, 3, 2), torch.zeros(8), 0.01,
                              "deconv", 1)
    with pytest.raises(ValueError, match="no packed output"):
        pstage.stage_fwd_fine(torch.zeros(1, 2, 2, 3), ones[:3], zeros[:3],
                              torch.zeros(3, 3, 3, 2), torch.zeros(2), 0.01, "stem", 0)


def _lifted_wgrad(x, dy, mul, add, w, recipe, levels, prologue, slope=0.2):
    """(dW, db) of the lifted stage: ``stage_bwd_reference``'s dW on
    ``lifted_kernel(w, recipe, levels)``, carried back to the base weight
    through the gather's autograd, and its db."""
    from causalvae_tpu_torch.ops.subpixel import lifted_kernel

    wt = _t(w, True)
    pk, pl = lifted_kernel(wt, recipe, levels)
    _, dw_lifted, db, _, _ = pstage.stage_bwd_reference(_t(x), _t(dy), _t(mul), _t(add),
                                                        pk.detach(), slope, pl, prologue)
    (dw,) = torch.autograd.grad(pk, wt, dw_lifted)
    return dw, db


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_wgrad_fine_reference_equals_the_lifted_backward(recipe, levels, prologue):
    """dW and db of the fine-grid stage (``stage_wgrad_fine`` on CPU tensors:
    its plain version) equal the lifted backward's, dW carried back through
    the lifted kernel's gather: max|Δ| <= 1e-5 max|ref| (f32 sums in another
    order; the lifted kernel adds structural zeros only)."""
    x, mul, add, w, _, dy = _fine_case(recipe, levels, seed=50 + levels + 10 * len(recipe))
    want_dw, want_db = _lifted_wgrad(x, dy, mul, add, w, recipe, levels, prologue)
    before = pstage.FINE_WGRAD_LAUNCHES
    dw, db = pstage.stage_wgrad_fine(_t(x), _t(dy), _t(mul), _t(add), _t(w), 0.2, recipe,
                                     levels, prologue)
    assert pstage.FINE_WGRAD_LAUNCHES == before  # CPU: the plain version
    for name, got, ref in (("dW", dw, want_dw), ("db", db, want_db)):
        assert got.shape == ref.shape and got.dtype == torch.float32, name
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)


@pytest.mark.parametrize("recipe,levels", [("conv", 1), ("stem", 2), ("convT", 1)])
def test_stage_wgrad_fine_reference_matches_the_pallas_kernel(recipe, levels):
    """dW and db against JAX ``_stage_bwd_call(..., interpret=True)`` on the
    kernel lifted by the JAX package's own lifting functions, its dW carried
    back to the base weight by ``jax.vjp`` of that lifting chain (the convT
    kernel in its (3, 3, C_out, C_in) layout, so the orientation of the
    port's convT dW is decided here): max|Δ| <= 1e-4 max|ref| + 1e-5."""
    import jax

    from causalvae_tpu.ops import subpixel as jsub

    x, mul, add, w, _, dy = _fine_case(recipe, levels, seed=11 + levels)

    def lift(base):
        if recipe == "conv":
            jk, pl, lifts = base, 1, levels
        elif recipe == "stem":
            (jk, pl), lifts = jsub.consume_once(base, 1), levels - 1
        else:
            jk, pl, lifts = jsub.phase_kernel_2x(base.transpose(0, 1, 3, 2)), 0, levels
        for _ in range(lifts):
            jk, pl = jsub.lift_once(jk, pl)
        return jk, pl

    _, pl = lift(jnp.asarray(w))
    jk, back = jax.vjp(lambda base: lift(base)[0], jnp.asarray(w))
    want = jstage._stage_bwd_call(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(mul),
                                  jnp.asarray(add), jk, slope=0.01, pad_lo=pl,
                                  has_prologue=True, interpret=True)
    (want_dw,) = back(want[1])
    dw, db = pstage.stage_wgrad_fine(_t(x), _t(dy), _t(mul), _t(add), _t(w), 0.01, recipe,
                                     levels)
    close(dw, np.asarray(want_dw))
    close(db, np.asarray(want[2]).ravel())


def test_stage_wgrad_fine_rejects_bad_shapes():
    x = torch.zeros(1, 2, 2, 12)
    ones, zeros = torch.ones(12), torch.zeros(12)
    w = torch.zeros(3, 3, 3, 2)
    with pytest.raises(ValueError, match="dy"):
        pstage.stage_wgrad_fine(x, torch.zeros(1, 2, 2, 2), ones, zeros, w, 0.01, "conv", 1)
    with pytest.raises(ValueError, match="4\\^1"):
        pstage.stage_wgrad_fine(x, torch.zeros(1, 2, 2, 8), ones, zeros,
                                torch.zeros(3, 3, 4, 2), 0.01, "conv", 1)
    with pytest.raises(ValueError, match="add"):
        pstage.stage_wgrad_fine(x, torch.zeros(1, 2, 2, 8), ones, zeros[:5], w, 0.01,
                                "conv", 1)
    with pytest.raises(ValueError, match="recipe"):
        pstage.stage_wgrad_fine(x, torch.zeros(1, 2, 2, 8), ones, zeros, w, 0.01, "deconv", 1)
    with pytest.raises(ValueError, match="no packed output"):
        pstage.stage_wgrad_fine(torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2, 2), ones[:3],
                                zeros[:3], torch.zeros(3, 3, 3, 2), 0.01, "stem", 0)
