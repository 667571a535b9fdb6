"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for a GPU in a fixture and skips without one
(so on a CPU-only machine they skip with that reason). Run them on a machine
with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from causalvae_tpu_torch.ops.kernels import attention as pa
from causalvae_tpu_torch.ops.kernels import batchnorm as pb
from causalvae_tpu_torch.ops.kernels import elbo as pe

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the stage's plain version is a conv
    return torch.device("cuda")


@pytest.mark.parametrize("bh,n,d", [(64, 961, 32), (6, 17, 32), (3, 241, 16), (2, 65, 8), (2, 100, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_reference(gpu, bh, n, d, dtype):
    g = torch.Generator(device="cpu").manual_seed(bh * n + d)
    q, k, v = (torch.randn(bh, n, d, generator=g).to(gpu, dtype) for _ in range(3))
    before = pa.LAUNCHES
    o, lse = pa.attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    ro, rlse = pa.attention_reference(*(t.float() for t in (q, k, v)))
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        assert float((o - ro).abs().max()) <= 2e-5 * float(ro.abs().max()) + 1e-6
        assert float((lse - rlse).abs().max()) <= 2e-5 * float(rlse.abs().max()) + 1e-6
    else:
        assert float((o.float() - ro).abs().max()) <= 2e-2


def _bwd_inputs(gpu, bh, n, d, dtype, rate, seed):
    g = torch.Generator(device="cpu").manual_seed(bh * n + d + 1)
    q, k, v, do = (torch.randn(bh, n, d, generator=g).to(gpu, dtype) for _ in range(4))
    o, lse = pa.attention_reference(q, k, v, rate, seed)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("bh,n,d", [(64, 961, 32), (6, 17, 32), (3, 241, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_dropout_fwd_and_bwd_kernels_match_reference(gpu, bh, n, d, dtype,
                                                               rate):
    """Forward with the hash dropout and the backward kernels against the
    plain versions on the same inputs (f32: max|Δ| <= 2e-5 max|ref| + 1e-6
    forward, 1e-4 max|ref| + 1e-6 backward, sums over N keys in another
    order; bf16: the plain version in f32 on the bf16 values, 1e-2 max|ref|
    + 1e-3, the outputs' bf16 rounding)."""
    seed = 2**31 + 3
    q, k, v, o, lse, do = _bwd_inputs(gpu, bh, n, d, dtype, rate, seed)
    before = (pa.LAUNCHES, pa.BWD_LAUNCHES)
    ko, klse = pa.attention_fwd(q, k, v, rate, seed)
    grads = pa.attention_bwd(q, k, v, o, lse, do, rate, seed)
    torch.cuda.synchronize()
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    f32 = [t.float() for t in (q, k, v, o, do)]
    ro, rlse = pa.attention_reference(*f32[:3], rate, seed)
    want = pa.attention_bwd_reference(*f32[:4], lse, f32[4], rate, seed)
    fwd_rel, bwd_rel, floor = ((2e-5, 1e-4, 1e-6) if dtype == torch.float32
                               else (1e-2, 1e-2, 1e-3))
    for got, ref, rel in [(ko, ro, fwd_rel), (klse, rlse, 2e-5)] + [
            (gr, w, bwd_rel) for gr, w in zip(grads, want)]:
        assert got.shape == ref.shape
        err = float((got.float() - ref).abs().max())
        assert err <= rel * float(ref.abs().max()) + floor, (err, float(ref.abs().max()))


def test_attention_bwd_rejects_head_dim_64(gpu):
    q = torch.zeros(2, 10, 64, device=gpu)
    lse = torch.zeros(2, 10, device=gpu)
    with pytest.raises(ValueError, match="head dim"):
        pa.attention_bwd(q, q, q, q, lse, q)


@pytest.mark.parametrize("shape", [(8, 16, 96, 160), (8, 512, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernels_match_reference(gpu, shape, dtype):
    """Σx, Σx² and Σdy, Σdy·x̂ per channel against the plain sums on the
    same inputs: |Δ| <= 1e-5 Σ|term| per channel (f32 sums in another order;
    bounded by the absolute sum, whatever the cancellation)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn(*shape, generator=g) * 2 + 1).to(gpu, dtype)
    dy = torch.randn(*shape, generator=g).to(gpu, dtype)
    x3 = x.view(shape[0], shape[1], -1)
    dy3 = dy.view_as(x3)
    before = (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES)
    s = pb.bn_stats(x3)
    mean = s[0] / (x3.shape[0] * x3.shape[2])
    inv = torch.rsqrt(torch.clamp(s[1] / (x3.shape[0] * x3.shape[2]) - mean * mean, min=0)
                      + 1e-5)
    b = pb.bn_bwd_sums(dy3, x3, mean, inv)
    torch.cuda.synchronize()
    assert (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    xf, dyf = x3.float(), dy3.float()
    xhat = (xf - mean.view(1, -1, 1)) * inv.view(1, -1, 1)
    for got, ref, absum in (
            (s, pb.bn_stats_reference(x3), torch.stack([xf.abs().sum((0, 2)),
                                                        (xf * xf).sum((0, 2))])),
            (b, pb.bn_bwd_reference(dy3, x3, mean, inv),
             torch.stack([dyf.abs().sum((0, 2)), (dyf * xhat).abs().sum((0, 2))]))):
        assert ((got - ref).abs() <= 1e-5 * absum + 1e-6).all()


@pytest.mark.parametrize("m,c", [(8 * 96 * 160, 64), (8 * 48 * 80, 256), (1000, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_rows_kernels_match_reference(gpu, m, c, dtype):
    """The channels-last entries over (M, C) rows (the packed model's NHWC
    BatchNorms) against the plain sums: |Δ| <= 1e-5 Σ|term| per channel."""
    g = torch.Generator(device="cpu").manual_seed(m + c)
    x = (torch.randn(m, c, generator=g) * 2 + 1).to(gpu, dtype)
    dy = torch.randn(m, c, generator=g).to(gpu, dtype)
    before = (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES)
    s = pb.bn_stats_rows(x)
    mean = s[0] / m
    inv = torch.rsqrt(torch.clamp(s[1] / m - mean * mean, min=0) + 1e-5)
    b = pb.bn_bwd_sums_rows(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert (pb.STATS_LAUNCHES, pb.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean) * inv
    for got, ref, absum in (
            (s, torch.stack([xf.sum(0), (xf * xf).sum(0)]),
             torch.stack([xf.abs().sum(0), (xf * xf).sum(0)])),
            (b, torch.stack([dyf.sum(0), (dyf * xhat).sum(0)]),
             torch.stack([dyf.abs().sum(0), (dyf * xhat).abs().sum(0)]))):
        assert ((got - ref).abs() <= 1e-5 * absum + 1e-6).all()


# (B, H, W, Ci, Co, K, pad_lo): two small shapes with ragged tiles and the
# full-width dec_out stage
STAGE_SHAPES = [(2, 6, 10, 16, 24, 2, 0), (3, 7, 9, 40, 136, 3, 1),
                (8, 96, 160, 1024, 64, 3, 1)]


@pytest.mark.parametrize("shape", STAGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_kernels_match_reference(gpu, shape, dtype, prologue):
    """Stage forward and backward against ``stage_reference`` and its
    autograd backward in f32 on the same (dtype-rounded) values: f32
    max|Δ| <= 1e-4 max|ref| (sums in another order); bf16 1e-2 max|ref|
    (outputs and the activation round to bf16)."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    b, h, w, ci, co, k, pad_lo = shape
    g = torch.Generator(device="cpu").manual_seed(ci * co + k)
    x = torch.randn(b, h, w, ci, generator=g).to(gpu, dtype)
    kern = (torch.randn(k, k, ci, co, generator=g) * (k * k * ci) ** -0.5).to(gpu, dtype)
    bias = torch.randn(co, generator=g).to(gpu)
    dy = torch.randn(b, h, w, co, generator=g).to(gpu, dtype)
    mul = (torch.rand(ci, generator=g) + 0.5).to(gpu) if prologue else torch.ones(ci, device=gpu)
    add = torch.randn(ci, generator=g).to(gpu) if prologue else torch.zeros(ci, device=gpu)
    before = (ps.FWD_LAUNCHES, ps.BWD_LAUNCHES)
    y = ps.stage_fwd(x, mul, add, kern, bias, 0.2, pad_lo, prologue)
    grads = ps.stage_bwd(x, dy, mul, add, kern, 0.2, pad_lo, prologue)
    torch.cuda.synchronize()
    assert (ps.FWD_LAUNCHES, ps.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    f32 = [t.float() for t in (x, kern, dy)]
    want_y = ps.stage_reference(f32[0], mul, add, f32[1], bias, 0.2, pad_lo, prologue)
    want = ps.stage_bwd_reference(f32[0], f32[2], mul, add, f32[1], 0.2, pad_lo, prologue)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    assert y.dtype == dtype and grads[0].dtype == dtype
    for name, got, ref in zip(("y", "dx", "dW", "db", "dmul", "dadd"), (y, *grads),
                              (want_y, *want)):
        assert got.shape == ref.shape, name
        err = float((got.float() - ref.float()).abs().max())
        assert err <= rel * float(ref.abs().max()) + 1e-6, (name, err)


@pytest.mark.parametrize("n", [1, 1000, 8 * 96 * 160 + 37])
def test_elbo_kernel_matches_reference(gpu, n):
    """Both sums at a ragged length against the plain version (rel 1e-5:
    sums of non-negative terms in another order)."""
    g = torch.Generator(device="cpu").manual_seed(n)
    x = (torch.rand(n, generator=g) > 0.9).float().to(gpu)
    recon = torch.randn(n, generator=g).to(gpu)
    pw = pe.pos_weight(x)
    before = pe.LAUNCHES
    got = pe.elbo_terms(recon, x, pw)
    torch.cuda.synchronize()
    assert pe.LAUNCHES == before + 1
    want = pe._plain_terms(recon, x, pw)
    assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all(), (got, want)
    again = pe.elbo_terms(recon, x, pw)
    assert torch.equal(got, again)  # deterministic: no atomics
