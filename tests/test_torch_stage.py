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
