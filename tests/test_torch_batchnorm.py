"""Port parity of train-mode BatchNorm (CPU side of the BN kernels).

On the CPU ``bn_stats``/``bn_bwd_sums`` take their plain versions; ``bn_train``
and the ``BatchNorm`` module are held to the JAX package: its Pallas
lane-dense reductions in interpret mode (``bn_train(..., use_pallas=True)``)
for C in {16, 32, 64}, its jnp formulation (``use_pallas=False``) for
C in {128, 256}, and flax ``nn.BatchNorm`` for the 2-D adapter case. Checked:
y, the batch mean and biased var, the running-statistics update, dx, dscale
and dbias, with the port's f32 parity tolerance (``close()`` defaults:
max|Δ| <= 1e-4 max|ref| + 1e-5). The phase-packed model's
``BatchNorm.nhwc`` (``groups``, ``emit_affine``) is held to the JAX module
called with the same arguments, in train and eval mode: y or (mul, add), the
running statistics (rel 1e-5), and the gradients in x, scale and bias of a
nonlinear loss (for ``emit_affine``, of x·mul + add, so the gradient runs
through the batch statistics). The CUDA kernels are held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from causalvae_tpu.ops.kernels.batchnorm import BatchNorm as JaxBatchNorm
from causalvae_tpu.ops.kernels.batchnorm import bn_train as jax_bn_train

from causalvae_tpu_torch.ops.kernels import batchnorm as pb

from torch_port_helpers import close


def _data(shape, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = rng.random(c).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("c,use_pallas", [(16, True), (32, True), (64, True),
                                          (128, False), (256, False)])
def test_bn_train_matches_jax(c, use_pallas):
    shape = (2, 6, 8, c)  # NHWC; size % 128 == 0 for the lane-dense view
    x, scale, bias, dy = _data(shape, c, seed=c)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    (y, mean, var), vjp = jax.vjp(
        lambda a, s, b: jax_bn_train(a, s, b, 1e-5, use_pallas), jx, js, jb)
    dx, ds, db = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))

    xt = _nchw(x).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    gy, gmean, gvar = pb.bn_train(xt, st, bt, 1e-5)
    gy.backward(_nchw(dy))
    close(_nhwc(gy), y)
    close(gmean, mean)
    close(gvar, var)
    close(_nhwc(xt.grad), dx)
    close(st.grad, ds)
    close(bt.grad, db)


def test_batchnorm_module_running_stats_match_jax_module():
    """The module's train forward updates mean/var as the JAX module does
    (ra = 0.9·ra + 0.1·batch, biased var) and returns the same y."""
    shape = (3, 5, 7, 16)
    x, scale, bias, _ = _data(shape, 16, seed=1)
    rng = np.random.default_rng(2)
    stats = {"mean": (0.2 * rng.standard_normal(16)).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
    y, mut = JaxBatchNorm().apply(variables, jnp.asarray(x), use_running_average=False,
                                  mutable=["batch_stats"])
    m = pb.BatchNorm(16)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.copy_(torch.from_numpy(stats["mean"]))
        m.var.copy_(torch.from_numpy(stats["var"]))
    got = m.train()(_nchw(x))
    close(_nhwc(got), y)
    close(m.mean, mut["batch_stats"]["mean"], rel=1e-5, abs_=1e-7)
    close(m.var, mut["batch_stats"]["var"], rel=1e-5, abs_=1e-7)


def test_adapter_batchnorm_2d_matches_flax():
    """(B, C) adapter BatchNorm (S = 1) against flax nn.BatchNorm(0.9, 1e-5):
    y, running stats, and the gradients of a nonlinear loss."""
    b, c = 8, 48
    x, scale, bias, _ = _data((b, c), c, seed=3)
    ref = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}

    def f(params, xx):
        y, mut = ref.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           xx, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * jnp.cos(0.3 * y)), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    m = pb.BatchNorm(c)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m.train()(xt)
    (torch.sin(out) * torch.cos(0.3 * out)).sum().backward()
    close(out, y)
    close(m.mean, stats["mean"])
    close(m.var, stats["var"])
    close(xt.grad, gx)
    close(m.scale.grad, gp["scale"])
    close(m.bias.grad, gp["bias"])


def _jax_bn_variables(c, seed):
    rng = np.random.default_rng(seed)
    return {"params": {"scale": (rng.random(c) + 0.5).astype(np.float32),
                       "bias": rng.standard_normal(c).astype(np.float32)},
            "batch_stats": {"mean": (0.2 * rng.standard_normal(c)).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}


def _port_bn(variables, c):
    m = pb.BatchNorm(c)
    with torch.no_grad():
        for name, coll in (("scale", "params"), ("bias", "params"),
                           ("mean", "batch_stats"), ("var", "batch_stats")):
            getattr(m, name).copy_(torch.from_numpy(variables[coll][name]))
    return m


@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("train", [True, False])
def test_nhwc_groups_match_jax(groups, train):
    """``BatchNorm.nhwc(x, groups)`` on a phase-packed NHWC tensor against the
    JAX module's call with ``groups``: y, the running statistics after a
    train-mode call, and the gradients of a nonlinear loss in x, scale and
    bias (through the grouped batch statistics in train mode)."""
    c = 6
    x = (np.random.default_rng(groups).standard_normal((2, 3, 5, c * groups)) * 2 + 1
         ).astype(np.float32)
    variables = _jax_bn_variables(c, seed=groups)

    def f(params, xx):
        y, mut = JaxBatchNorm().apply({"params": params,
                                       "batch_stats": variables["batch_stats"]},
                                      xx, use_running_average=not train, groups=groups,
                                      mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y)), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    m = _port_bn(variables, c).train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m.nhwc(xt, groups=groups)
    torch.sin(out).sum().backward()
    close(out, y)
    close(m.mean, stats["mean"], rel=1e-5, abs_=1e-7)
    close(m.var, stats["var"], rel=1e-5, abs_=1e-7)
    close(xt.grad, gx)
    close(m.scale.grad, gp["scale"])
    close(m.bias.grad, gp["bias"])


@pytest.mark.parametrize("groups", [1, 16])
@pytest.mark.parametrize("train", [True, False])
def test_emit_affine_matches_jax_with_the_gradient_through_mul_add(groups, train):
    """``emit_affine``: the per-real-channel (mul, add), the running-stat
    update, and the gradient of a loss of x·mul + add (tiled, as the stage
    prologue uses them) in x, scale and bias: in train mode it reaches x
    through the differentiable batch statistics as well as directly."""
    c = 5
    x = (np.random.default_rng(7 + groups).standard_normal((2, 4, 3, c * groups)) * 2 - 1
         ).astype(np.float32)
    variables = _jax_bn_variables(c, seed=3 + groups)

    def f(params, xx):
        (mul, add), mut = JaxBatchNorm().apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xx,
            use_running_average=not train, groups=groups, emit_affine=True,
            mutable=["batch_stats"])
        pre = xx * jnp.tile(mul, groups) + jnp.tile(add, groups)
        return jnp.sum(jnp.sin(pre) * pre), (mul, add, mut["batch_stats"])

    (_, (mul, add, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    m = _port_bn(variables, c).train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = pb.BWD_LAUNCHES
    pmul, padd = m.nhwc(xt, groups=groups, emit_affine=True)
    pre = xt * pmul.repeat(groups) + padd.repeat(groups)
    (torch.sin(pre) * pre).sum().backward()
    assert pb.BWD_LAUNCHES == before  # the statistics' gradient is elementwise
    close(pmul, mul)
    close(padd, add)
    close(m.mean, stats["mean"], rel=1e-5, abs_=1e-7)
    close(m.var, stats["var"], rel=1e-5, abs_=1e-7)
    close(xt.grad, gx)
    close(m.scale.grad, gp["scale"])
    close(m.bias.grad, gp["bias"])


def test_rows_sums_are_the_plain_versions():
    x = torch.randn(30, 7, generator=torch.Generator().manual_seed(1))
    before = (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES)
    torch.testing.assert_close(pb.bn_stats_rows(x), torch.stack([x.sum(0), (x * x).sum(0)]))
    mean, inv = torch.randn(7), torch.rand(7) + 0.5
    torch.testing.assert_close(pb.bn_bwd_sums_rows(x, x, mean, inv),
                               torch.stack([x.sum(0), (x * (x - mean) * inv).sum(0)]))
    assert (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES) == before


def test_cpu_sums_are_the_plain_versions():
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    x3 = x.view(2, 3, 20)
    before = (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES)
    assert torch.equal(pb.bn_stats(x3), pb.bn_stats_reference(x3))
    mean, inv = torch.randn(3), torch.rand(3) + 0.5
    assert torch.equal(pb.bn_bwd_sums(x3, x3, mean, inv),
                       pb.bn_bwd_reference(x3, x3, mean, inv))
    assert (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES) == before
    torch.testing.assert_close(pb.bn_stats_reference(x3)[0], x.sum(dim=(0, 2, 3)))


def test_variance_is_clamped_and_bf16_keeps_its_dtype():
    """var = max(E[x²] − E[x]², 0): a constant channel gives var 0, not a
    small negative; a bfloat16 input gives a bfloat16 output and f32 stats."""
    x = torch.full((4, 2, 3, 3), 3.1)
    _, _, var = pb.bn_train(x, torch.ones(2), torch.zeros(2), 1e-5)
    assert (var >= 0).all()
    xb = torch.randn(2, 4, 3, 3).to(torch.bfloat16)
    y, mean, var = pb.bn_train(xb, torch.ones(4), torch.zeros(4), 1e-5)
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32


def test_bn_rejects_other_ranks():
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        pb.bn_train(torch.zeros(2, 3, 4), torch.ones(3), torch.zeros(3), 1e-5)
