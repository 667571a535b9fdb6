"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for a GPU in a fixture and skips without one
(so on a CPU-only machine they skip with that reason). Run them on a machine
with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from causalvae_tpu_torch.ops.kernels import attention as pa
from causalvae_tpu_torch.ops.kernels import batchnorm as pb
from causalvae_tpu_torch.ops.kernels import elbo as pe
from torch_op_cases import CASE_IDS, DTYPES, case

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


@pytest.mark.parametrize("n", [1, 63, 65, 129])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_fwd_tensor_cores_at_ragged_n(gpu, n, d, dtype, rate):
    """The tensor-core forward at N around its 64-key tiles (a last tile of 1
    key, none, 63 keys) and every head dim, against the plain version on the
    same inputs (f32: o and lse within 2e-5 max|ref| + 1e-6, 3xTF32 products
    summed in another order; bf16: the plain version in f32 on the bf16
    values, 2e-2, the output's bf16 rounding)."""
    seed = 2**31 + 13
    g = torch.Generator(device="cpu").manual_seed(n * d)
    q, k, v = (torch.randn(3, n, d, generator=g).to(gpu, dtype) for _ in range(3))
    o, lse = pa.attention_fwd(q, k, v, rate, seed)
    torch.cuda.synchronize()
    ro, rlse = pa.attention_reference(*(t.float() for t in (q, k, v)), rate, seed)
    assert o.shape == ro.shape and o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        assert float((o - ro).abs().max()) <= 2e-5 * float(ro.abs().max()) + 1e-6
        assert float((lse - rlse).abs().max()) <= 2e-5 * float(rlse.abs().max()) + 1e-6
    else:
        assert float((o.float() - ro).abs().max()) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_fwd_two_launches_give_equal_bits(gpu, dtype):
    """No atomics and sums in a fixed order: the training shape twice, with
    dropout, gives the same o and lse bits."""
    g = torch.Generator(device="cpu").manual_seed(19)
    q, k, v = (torch.randn(64, 961, 32, generator=g).to(gpu, dtype) for _ in range(3))
    first = pa.attention_fwd(q, k, v, 0.1, 17)
    second = pa.attention_fwd(q, k, v, 0.1, 17)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("n", [1, 63, 65, 129])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bwd_tensor_cores_at_ragged_n(gpu, n, d, dtype, rate):
    """The tensor-core backward at N around its 64-row tiles (a last tile of
    1 row, none, 63 rows) and every head dim, against the plain version on
    the same inputs (f32: 1e-4 max|ref| + 1e-6, 3xTF32 products summed in
    another order; bf16: the plain version in f32 on the bf16 values, 1e-2
    max|ref| + 1e-3, the outputs' bf16 rounding)."""
    seed = 2**31 + 9
    q, k, v, o, lse, do = _bwd_inputs(gpu, 3, n, d, dtype, rate, seed)
    grads = pa.attention_bwd(q, k, v, o, lse, do, rate, seed)
    torch.cuda.synchronize()
    want = pa.attention_bwd_reference(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                      rate, seed)
    rel, floor = (1e-4, 1e-6) if dtype == torch.float32 else (1e-2, 1e-3)
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape and got.dtype == dtype
        err = float((got.float() - ref).abs().max())
        assert err <= rel * float(ref.abs().max()) + floor, (err, float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_two_launches_give_equal_bits(gpu, dtype):
    """No atomics and sums in a fixed order: the training shape twice, with
    dropout, gives the same bits."""
    q, k, v, o, lse, do = _bwd_inputs(gpu, 64, 961, 32, dtype, 0.1, 17)
    first = pa.attention_bwd(q, k, v, o, lse, do, 0.1, 17)
    second = pa.attention_bwd(q, k, v, o, lse, do, 0.1, 17)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_on_the_card_never_takes_the_plain_version(gpu, monkeypatch):
    """A CUDA tensor launches the kernels (the counters move) and never calls
    a plain version, also through the autograd Function."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(pa, "attention_bwd_reference", refuse)
    monkeypatch.setattr(pa, "attention_reference", refuse)
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn(2, 3, 65, 16, generator=g).to(gpu).requires_grad_(True)
               for _ in range(3))
    before = (pa.LAUNCHES, pa.BWD_LAUNCHES)
    out = pa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for t in (q, k, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


@pytest.mark.parametrize("d", [20, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_at_head_dims_up_to_256(gpu, d, dtype, rate):
    """Both kernels at a padded head dim (20 -> 32) and the wide plans (64
    backward; 128 and 256 both ways), N = 65 and 129 (ragged 32- and 64-row
    tiles), against the plain versions at the tolerances above, one launch
    each a call, two launches bit-equal."""
    _hold_kernels_at_head_dim(gpu, d, dtype, rate)


def _hold_kernels_at_head_dim(gpu, d, dtype, rate):
    seed = 2**31 + 29
    for n in (65, 129):
        q, k, v, o, lse, do = _bwd_inputs(gpu, 3, n, d, dtype, rate, seed)
        before = (pa.LAUNCHES, pa.BWD_LAUNCHES)
        fwd = pa.attention_fwd(q, k, v, rate, seed)
        fwd_again = pa.attention_fwd(q, k, v, rate, seed)
        grads = pa.attention_bwd(q, k, v, o, lse, do, rate, seed)
        again = pa.attention_bwd(q, k, v, o, lse, do, rate, seed)
        torch.cuda.synchronize()
        assert (pa.LAUNCHES, pa.BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
        assert all(torch.equal(a, b) for a, b in zip(fwd + grads, fwd_again + again))
        ro, rlse = pa.attention_reference(*(t.float() for t in (q, k, v)), rate, seed)
        want = pa.attention_bwd_reference(*(t.float() for t in (q, k, v, o)), lse,
                                          do.float(), rate, seed)
        ko, klse = fwd
        assert ko.shape == q.shape and ko.dtype == dtype
        if dtype == torch.float32:
            assert float((ko - ro).abs().max()) <= 2e-5 * float(ro.abs().max()) + 1e-6
            assert float((klse - rlse).abs().max()) <= 2e-5 * float(rlse.abs().max()) + 1e-6
        else:
            assert float((ko.float() - ro).abs().max()) <= 2e-2
        rel, floor = (1e-4, 1e-6) if dtype == torch.float32 else (1e-2, 1e-3)
        for got, ref in zip(grads, want):
            assert got.shape == ref.shape and got.dtype == dtype
            err = float((got.float() - ref).abs().max())
            assert err <= rel * float(ref.abs().max()) + floor, (n, err)


@pytest.mark.parametrize("d", [257, 320, 384, 512, 1024, pa.MAX_HEAD_DIM])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_at_deep_head_dims(gpu, d, dtype, rate):
    """The deep plan above 256 (257 padded to 320, R = 32 rows a block up to
    512, 16 above, the limit 1344), N = 65 and 129, BH 3, against the plain
    versions at the tolerances above, one launch each a call, two launches
    bit-equal."""
    _hold_kernels_at_head_dim(gpu, d, dtype, rate)


@pytest.mark.parametrize("d", [200, 320, 1088, pa.MAX_HEAD_DIM])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_fwd_large_in_both_dtypes(gpu, d, dtype):
    """``csrc/attention_fwd_large.cu`` through ``attention_fwd_large`` in
    f32 (3xTF32, which ``attention_fwd`` leaves to the wide and deep plans)
    and bf16, rate 0.1, N = 65 and 129: D 200 padded to 256 (a cluster of
    2), 320 (3 CTAs, the last slice 64 columns wide), 1088 (192-column
    slices, the last 128 wide) and the limit 1344 (the largest cluster, 7
    CTAs); o and lse against the plain version at phase 3's tolerances (f32
    2e-5 max|ref| + 1e-6; bf16 2e-2), two launches bit-equal, each counted
    in ``LARGE_LAUNCHES``."""
    seed, rate = 2**31 + 31, 0.1
    for n in (65, 129):
        g = torch.Generator(device="cpu").manual_seed(n + d)
        q, k, v = (torch.randn(3, n, d, generator=g).to(gpu, dtype) for _ in range(3))
        before = pa.LARGE_LAUNCHES
        o, lse = pa.attention_fwd_large(q, k, v, rate, seed)
        again = pa.attention_fwd_large(q, k, v, rate, seed)
        torch.cuda.synchronize()
        assert pa.LARGE_LAUNCHES == before + 2
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        ro, rlse = pa.attention_reference(*(t.float() for t in (q, k, v)), rate, seed)
        assert o.shape == q.shape and o.dtype == dtype
        if dtype == torch.float32:
            assert float((o - ro).abs().max()) <= 2e-5 * float(ro.abs().max()) + 1e-6
            assert float((lse - rlse).abs().max()) <= 2e-5 * float(rlse.abs().max()) + 1e-6
        else:
            assert float((o.float() - ro).abs().max()) <= 2e-2


def test_attention_fwd_takes_the_large_kernel_in_bf16_only(gpu):
    """The forward's dispatch by padded head dim and dtype: bf16 from 128
    on launches ``attention_fwd_large``, f32 there and bf16 below it do
    not."""
    for d, dtype, large in ((128, torch.bfloat16, 1), (512, torch.bfloat16, 1),
                            (128, torch.float32, 0), (512, torch.float32, 0),
                            (64, torch.bfloat16, 0)):
        q = torch.randn(2, 33, d, device=gpu).to(dtype)
        before = (pa.LAUNCHES, pa.LARGE_LAUNCHES)
        pa.attention_fwd(q, q, q)
        torch.cuda.synchronize()
        assert (pa.LAUNCHES, pa.LARGE_LAUNCHES) == (before[0] + 1, before[1] + large), d


def test_attention_rejects_head_dims_past_the_limit(gpu):
    d = pa.MAX_HEAD_DIM + 1
    q = torch.zeros(2, 10, d, device=gpu)
    lse = torch.zeros(2, 10, device=gpu)
    with pytest.raises(ValueError, match=f"head dim {d} outside the kernels' 1..{d - 1} "
                                         r"\(above it the deep plan's dK/dV block passes"):
        pa.attention_fwd(q, q, q)
    with pytest.raises(ValueError, match=f"head dim {d}"):
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


def _elbo_inputs(gpu, n, offset, dtype):
    """A {0, 1} mask x and a recon (±0 among its first values), each a view
    offset by ``offset`` elements into a larger tensor on the card."""
    g = torch.Generator(device="cpu").manual_seed(n + 7 * offset)
    x = (torch.rand(n + offset, generator=g) > 0.9).float().to(gpu)[offset:]
    recon = torch.randn(n + offset, generator=g).to(gpu, dtype)[offset:]
    recon[: min(n, 2)] = torch.tensor([0.0, -0.0][: min(n, 2)], dtype=dtype)
    return recon, x


def _ulps(a: float, b: float) -> int:
    ia, ib = (int(np.array([v], np.float32).view(np.int32)[0]) for v in (a, b))
    return abs(ia - ib)


@pytest.mark.parametrize("n", [1, 7, 1000, 8 * 96 * 160 + 37])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elbo_forward_one_launch(gpu, n, offset, dtype):
    """The one-launch forward, pos_weight inside and given, at ragged lengths
    and views offset by one element, f32 and bf16 recon: both sums within
    rel 1e-5 of the plain version (on the bf16 values in f32), pw within 1
    float32 ulp of ``pos_weight(x)``, exactly one launch a call (bf16
    counted apart), equal bits on a repeat and for two calls back to back on
    one stream."""
    recon, x = _elbo_inputs(gpu, n, offset, dtype)
    pw = pe.pos_weight(x)
    before = (pe.LAUNCHES, pe.LAUNCHES_BF16)
    got = pe.elbo_terms(recon, x)
    torch.cuda.synchronize()
    assert (pe.LAUNCHES, pe.LAUNCHES_BF16) == (before[0] + 1,
                                               before[1] + (dtype == torch.bfloat16))
    given = pe.elbo_terms(recon, x, pw)
    a, b = pe.elbo_terms(recon, x), pe.elbo_terms(recon, x)
    torch.cuda.synchronize()
    want = pe._plain_terms(recon, x, pw)
    for out in (got, given):
        assert ((out[:2] - want[:2]).abs() <= 1e-5 * want[:2].abs() + 1e-6).all(), (out, want)
    assert _ulps(float(got[2]), float(pw)) <= 1 and float(given[2]) == float(pw)
    assert torch.equal(got, a) and torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 7, 1000, 8 * 96 * 160 + 37])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elbo_backward_bit_for_bit(gpu, n, offset, dtype):
    """The one-launch backward: d recon (in recon's type) and d x bit for
    bit the plain backward's on CPU copies, d recon alone likewise, one
    launch a call (bf16 counted apart), and through autograd one forward and
    one backward launch a ``vessel_recon_terms_fused`` step."""
    recon, x = _elbo_inputs(gpu, n, offset, dtype)
    g = torch.tensor([0.7, -0.3, 0.0], device=gpu)
    pw = pe.elbo_terms(recon, x)[2]  # the pw autograd's backward reads
    before = (pe.BWD_LAUNCHES, pe.BWD_LAUNCHES_BF16)
    d_r, d_x = pe.elbo_terms_bwd(g, recon, x, pw, True, True)
    only_r, none_x = pe.elbo_terms_bwd(g, recon, x, pw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (pe.BWD_LAUNCHES, pe.BWD_LAUNCHES_BF16) == (before[0] + 2, before[1] + 2 * bf16)
    ref_r, ref_x = pe._plain_bwd(g.cpu(), recon.cpu(), x.cpu(), pw.cpu(), True, True)
    assert d_r.dtype == dtype and none_x is None
    assert torch.equal(d_r.cpu(), ref_r) and torch.equal(only_r.cpu(), ref_r)
    assert torch.equal(d_x.cpu(), ref_x)
    r = recon.detach().clone().requires_grad_(True)
    counts = (pe.LAUNCHES, pe.BWD_LAUNCHES)
    rl, sp = pe.vessel_recon_terms_fused(r, x)
    (0.7 * rl - 0.3 * sp).backward()
    torch.cuda.synchronize()
    assert (pe.LAUNCHES, pe.BWD_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(r.grad, d_r)


# (recipe, input levels): every recipe at levels 0-3 (stem consumes a level,
# so 1-3)
FINE_CASES = [("conv", 0), ("conv", 1), ("conv", 2), ("conv", 3), ("stem", 1), ("stem", 2),
              ("stem", 3), ("convT", 0), ("convT", 1), ("convT", 2), ("convT", 3)]


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
@pytest.mark.parametrize("ci,co", [(5, 3), (9, 40)])  # direct path (Co <= 16), GEMM path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_fine_kernel_matches_reference(gpu, recipe, levels, ci, co, dtype, prologue):
    """The fine-grid stage forward against ``stage_fine_reference`` in f32 on
    the same (dtype-rounded) values at small ragged shapes (coarse 3 x 5,
    packed-width mul/add/bias): f32 max|Δ| <= 1e-4 max|ref| (sums in another
    order); bf16 1e-2 max|ref| (the activation and the output round to bf16)."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    lout = ps.out_levels(recipe, levels)
    g = torch.Generator(device="cpu").manual_seed(ci * co + 7 * levels)
    x = torch.randn(2, 3, 5, ci << 2 * levels, generator=g).to(gpu, dtype)
    w = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(gpu, dtype)
    bias = torch.randn(co << 2 * lout, generator=g).to(gpu)
    n = x.shape[-1]
    mul = (torch.rand(n, generator=g) + 0.5).to(gpu) if prologue else torch.ones(n, device=gpu)
    add = torch.randn(n, generator=g).to(gpu) if prologue else torch.zeros(n, device=gpu)
    before = ps.FINE_FWD_LAUNCHES
    y = ps.stage_fwd_fine(x, mul, add, w, bias, 0.2, recipe, levels, prologue)
    torch.cuda.synchronize()
    assert ps.FINE_FWD_LAUNCHES == before + 1
    ref = ps.stage_fine_reference(x.float(), mul, add, w.float(), bias, 0.2, recipe, levels,
                                  prologue)
    assert y.dtype == dtype and y.shape == ref.shape
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    err = float((y.float() - ref).abs().max())
    assert err <= rel * float(ref.abs().max()) + 1e-6, err


def _dgrad_inputs(gpu, recipe, levels, ci, co, dtype, prologue, coarse=(2, 3, 5), seed=0):
    from causalvae_tpu_torch.ops.kernels import stage as ps

    lout = ps.out_levels(recipe, levels)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(*coarse, ci << 2 * levels, generator=g).to(gpu, dtype)
    w = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(gpu, dtype)
    dy = torch.randn(*coarse, co << 2 * lout, generator=g).to(gpu, dtype)
    n = x.shape[-1]
    mul = (torch.rand(n, generator=g) + 0.5).to(gpu) if prologue else torch.ones(n, device=gpu)
    add = torch.randn(n, generator=g).to(gpu) if prologue else torch.zeros(n, device=gpu)
    return x, dy, mul, add, w


def _check_dgrad(x, dy, mul, add, w, recipe, levels, prologue):
    """The kernel's (dx, dmul, dadd) against the plain version in f32 on the
    same (dtype-rounded) values, each term: f32 max|Δ| <= 1e-4 max|ref| + 1e-6
    (sums in another order), bf16 1e-2 (dx rounds to bf16); a second launch
    gives the same bits; one launch counted per call."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    before = ps.FINE_DGRAD_LAUNCHES
    got = ps.stage_dgrad_fine(x, dy, mul, add, w, 0.2, recipe, levels, prologue)
    again = ps.stage_dgrad_fine(x, dy, mul, add, w, 0.2, recipe, levels, prologue)
    torch.cuda.synchronize()
    assert ps.FINE_DGRAD_LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ps.stage_dgrad_fine_reference(x.float(), dy.float(), mul, add, w.float(), 0.2,
                                        recipe, levels, prologue)
    assert got[0].dtype == x.dtype and got[1].dtype == got[2].dtype == torch.float32
    rel = 1e-4 if x.dtype == torch.float32 else 1e-2
    for name, g, r in zip(("dx", "dmul", "dadd"), got, ref):
        assert g.shape == r.shape, name
        err = float((g.float() - r).abs().max())
        assert err <= rel * float(r.abs().max()) + 1e-6, (name, err)


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
@pytest.mark.parametrize("ci,co", [(5, 3), (9, 40), (40, 9)])  # direct (Ci <= 16) x2, GEMM
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_dgrad_fine_kernel_matches_reference(gpu, recipe, levels, ci, co, dtype,
                                                   prologue):
    """The fine-grid stage dgrad against ``stage_dgrad_fine_reference`` at
    small ragged shapes (coarse 3 x 5), every recipe and level; the dgrad's
    output channels are the base Ci, so Ci <= 16 takes the direct path."""
    args = _dgrad_inputs(gpu, recipe, levels, ci, co, dtype, prologue, seed=ci * co + levels)
    _check_dgrad(*args, recipe, levels, prologue)


# odd sizes with more tiles or row blocks than the kernel's grid holds at
# once: (recipe, levels, Ci, Co, (B, Hc, Wc))
DGRAD_ODD = [("conv", 3, 5, 3, (2, 61, 67)), ("conv", 0, 16, 1, (3, 37, 43)),
             ("stem", 1, 5, 3, (8, 96, 160)), ("stem", 2, 40, 9, (2, 61, 67)),
             ("convT", 2, 16, 16, (3, 37, 43)), ("convT", 1, 33, 20, (2, 29, 31))]


@pytest.mark.parametrize("recipe,levels,ci,co,coarse", DGRAD_ODD)
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_dgrad_fine_kernel_at_odd_sizes(gpu, recipe, levels, ci, co, coarse, prologue):
    """Ragged tiles at sizes where the direct path's blocks walk over many
    tiles and the GEMM path has many row blocks per phase, f32."""
    args = _dgrad_inputs(gpu, recipe, levels, ci, co, torch.float32, prologue, coarse,
                         seed=levels + ci)
    _check_dgrad(*args, recipe, levels, prologue)


def _check_wgrad(x, dy, mul, add, w, recipe, levels, prologue):
    """The kernel's (dW, db) against the plain version in f32 on the same
    (dtype-rounded) values: f32 max|Δ| <= 1e-4 max|ref| + 1e-6 (sums over
    the pixels in another order), bf16 1e-2 (the activation rounds to bf16);
    a second launch gives the same bits; one launch counted per call."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    before = ps.FINE_WGRAD_LAUNCHES
    got = ps.stage_wgrad_fine(x, dy, mul, add, w, 0.2, recipe, levels, prologue)
    again = ps.stage_wgrad_fine(x, dy, mul, add, w, 0.2, recipe, levels, prologue)
    torch.cuda.synchronize()
    assert ps.FINE_WGRAD_LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ps.stage_wgrad_fine_reference(x.float(), dy.float(), mul, add, w.float(), 0.2,
                                        recipe, levels, prologue)
    rel = 1e-4 if x.dtype == torch.float32 else 1e-2
    for name, g, r in zip(("dW", "db"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        err = float((g - r).abs().max())
        assert err <= rel * float(r.abs().max()) + 1e-6, (name, err)


@pytest.mark.parametrize("recipe,levels", FINE_CASES)
# direct path (Co <= 16; (40, 9) in three channel slices), GEMM path (BN 64, BN 32)
@pytest.mark.parametrize("ci,co", [(16, 1), (5, 3), (40, 9), (9, 40), (40, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_wgrad_fine_kernel_matches_reference(gpu, recipe, levels, ci, co, dtype,
                                                   prologue):
    """The fine-grid stage wgrad against ``stage_wgrad_fine_reference`` at
    small ragged shapes (coarse 3 x 5), every recipe and level, both paths."""
    args = _dgrad_inputs(gpu, recipe, levels, ci, co, dtype, prologue, seed=ci * co + levels)
    _check_wgrad(*args, recipe, levels, prologue)


# odd sizes with more tiles than the direct grid holds at once and many splits
# on the GEMM path: (recipe, levels, Ci, Co, (B, Hc, Wc))
WGRAD_ODD = [("conv", 3, 16, 1, (3, 37, 43)), ("convT", 2, 16, 16, (3, 37, 43)),
             ("stem", 1, 5, 3, (8, 96, 160)), ("stem", 2, 33, 40, (2, 61, 67)),
             ("conv", 0, 40, 130, (8, 61, 67)), ("convT", 1, 33, 20, (2, 29, 31))]


@pytest.mark.parametrize("recipe,levels,ci,co,coarse", WGRAD_ODD)
@pytest.mark.parametrize("prologue", [True, False])
def test_stage_wgrad_fine_kernel_at_odd_sizes(gpu, recipe, levels, ci, co, coarse, prologue):
    """Ragged tiles and splits at sizes where the direct path's blocks walk
    over many tiles and the GEMM path splits each row phase many times, f32."""
    args = _dgrad_inputs(gpu, recipe, levels, ci, co, torch.float32, prologue, coarse,
                         seed=levels + ci + co)
    _check_wgrad(*args, recipe, levels, prologue)


def test_stage_bwd_wgrad_kernel_is_stage_bwd_without_its_dgrad(gpu):
    """The wgrad-only entry gives stage_bwd's dW and db bit for bit (the same
    kernels), counted on its own counter."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(3, 7, 9, 40, generator=g).to(gpu)
    kern = (torch.randn(3, 3, 40, 136, generator=g) * 0.05).to(gpu)
    dy = torch.randn(3, 7, 9, 136, generator=g).to(gpu)
    mul, add = (torch.rand(40, generator=g) + 0.5).to(gpu), torch.randn(40, generator=g).to(gpu)
    before = (ps.WGRAD_LAUNCHES, ps.BWD_LAUNCHES)
    dw, db = ps.stage_bwd_wgrad(x, dy, mul, add, kern, 0.2, 1)
    _, want_dw, want_db, _, _ = ps.stage_bwd(x, dy, mul, add, kern, 0.2, 1)
    torch.cuda.synchronize()
    assert (ps.WGRAD_LAUNCHES, ps.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(dw, want_dw) and torch.equal(db, want_db)


def test_stage_fine_backward_on_the_card_never_takes_the_plain_version(gpu, monkeypatch):
    """The fine op's backward on CUDA tensors launches the fine dgrad and the
    fine wgrad (neither the lifted wgrad-only entry nor the full lifted
    backward) and calls no plain version."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("stage_fine_reference", "stage_dgrad_fine_reference",
                 "stage_wgrad_fine_reference", "stage_bwd_reference"):
        monkeypatch.setattr(ps, name, refuse)
    x = torch.randn(1, 4, 6, 16 * 8, device=gpu, requires_grad=True)
    mul = (torch.rand(16 * 8, device=gpu) + 0.5).requires_grad_(True)
    add = torch.randn(16 * 8, device=gpu, requires_grad=True)
    w = torch.randn(3, 3, 8, 4, device=gpu, requires_grad=True)
    bias = torch.zeros(4 * 16, device=gpu, requires_grad=True)
    counters = ("FINE_DGRAD_LAUNCHES", "FINE_WGRAD_LAUNCHES", "WGRAD_LAUNCHES", "BWD_LAUNCHES")
    before = [getattr(ps, c) for c in counters]
    y = ps.affine_act_conv_fine(x, mul, add, w, bias, recipe="conv", levels=2)
    y.backward(torch.randn_like(y))
    torch.cuda.synchronize()
    assert [getattr(ps, c) for c in counters] == [before[0] + 1, before[1] + 1, before[2],
                                                  before[3]]
    for t in (x, mul, add, w, bias):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


def test_stage_fine_on_the_card_never_takes_the_plain_version(gpu, monkeypatch):
    """A CUDA tensor launches the kernel (the counter moves) and never calls
    ``stage_fine_reference``, also through the differentiable op."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ps, "stage_fine_reference", refuse)
    x = torch.randn(1, 4, 6, 16 * 8, device=gpu)
    w = torch.randn(3, 3, 8, 4, device=gpu)
    bias = torch.zeros(4 * 16, device=gpu)
    before = (ps.FINE_FWD_LAUNCHES, ps.FWD_LAUNCHES)
    y = ps.affine_act_conv_fine(x, None, None, w, bias, recipe="conv", levels=2)
    torch.cuda.synchronize()
    assert (ps.FINE_FWD_LAUNCHES, ps.FWD_LAUNCHES) == (before[0] + 1, before[1])
    assert y.shape == (1, 4, 6, 64) and bool(torch.isfinite(y).all())


# a small vessel model (depth 2, narrow widths) for the bf16 model tests
SMALL_BF16 = dict(vit_embed_dim=32, vit_depth=2, vit_heads=4, vit_mlp_dim=64,
                  vit_latent_dim=32, z_dim=8)
# forward mean and max relative, loss terms rel: about 2.5x the readings on
# an H100 (1.22e-2, 1.97e-2; 3.1e-3, the packed model's kld)
BF16_CARD_CPU = (3e-2, 5e-2, 1e-2)


def _small_bf16(device, packed=False, remat=False, dropout=0.0):
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vit import vessel_model

    cfg = VesselConfig(compute_dtype="bfloat16", **SMALL_BF16)
    layout = dict(packed=True, packed_io=True, fused_stages=True) if packed else {}
    model, _ = vessel_model((64, 96), device, seed=0, dropout=dropout, remat_blocks=remat,
                            cfg=cfg, **layout)
    return model, cfg


def _small_batch(packed, b=4):
    from causalvae_tpu_torch.ops.subpixel import space_to_depth_n

    g = torch.Generator().manual_seed(3)
    x = (torch.rand(b, 64, 96, 1, generator=g) > 0.9).float()
    return {"x": space_to_depth_n(x, 3) if packed else x,
            "m": torch.randn(b, 12, generator=g),
            "t": torch.eye(19)[torch.randint(0, 19, (b,), generator=g)],
            "eps": torch.randn(b, 8, generator=g)}


def _bf16_step(model, cfg, batch, generator=None):
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
    from causalvae_tpu_torch.train.state import ClippedAdam

    opt = ClippedAdam(model.parameters(), cfg.lr, cfg.grad_clip_norm, torch.bfloat16)
    step = make_vae_step(model, vessel_loss_fn(cfg), opt)
    return {k: float(v) for k, v in step(batch, generator=generator,
                                         eps=batch.get("eps")).items()}


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_model_card_against_cpu(gpu, packed):
    """The small bf16 model (spatial, and packed-fused with the stage
    kernels), the same seeded weights and batch on the card and the CPU
    (plain versions there), dropout 0: the eval forward's outputs within
    mean|d|/mean|ref| 3e-2 and max|d|/max|ref| 5e-2 (two bf16 computations
    whose roundings compound differently; ``BF16_CARD_CPU``), bf16 on both;
    one step's loss terms within rel 1e-2. ``-s`` prints the readings."""
    outs, mets = {}, {}
    for dev in ("cpu", gpu):
        model, cfg = _small_bf16(dev, packed)
        batch = {k: v.to(dev) for k, v in _small_batch(packed).items()}
        with torch.no_grad():
            outs[str(dev)] = [t.float().cpu() for t in model.eval()(
                batch["x"], batch["m"], batch["t"], eps=batch["eps"])[:4]]
        mets[str(dev)] = _bf16_step(model, cfg, batch)
    mean_tol, max_tol, terms_tol = BF16_CARD_CPU
    errs = [(float((g - r).abs().mean() / r.abs().mean()), float((g - r).abs().max() / r.abs().max()))
            for g, r in zip(outs["cuda"], outs["cpu"])]
    rels = {k: abs(mets["cuda"][k] - ref) / abs(ref) for k, ref in mets["cpu"].items()}
    print(f"bf16 card against CPU, packed {packed}: forward (mean, max) {errs}; terms {rels}")
    assert all(torch.isfinite(g).all() for g in outs["cuda"])
    assert all(mean <= mean_tol and mx <= max_tol for mean, mx in errs), errs
    assert all(r <= terms_tol for r in rels.values()), rels


def test_bf16_step_on_the_card_never_takes_the_plain_versions(gpu, monkeypatch):
    """A bf16 packed-fused step on the card launches every kernel of its path
    on bf16 operands (the ``*_BF16`` counters move with the totals; the ELBO
    kernels read the bf16 recon, x in f32) and calls no plain version."""
    from causalvae_tpu_torch.ops.kernels import stage as ps

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, names in ((pa, ("attention_reference", "attention_bwd_reference")),
                       (pb, ("bn_stats_reference", "bn_bwd_reference")),
                       (pe, ("_plain_terms", "_plain_bwd")),
                       (ps, ("stage_reference", "stage_bwd_reference", "stage_fine_reference",
                             "stage_dgrad_fine_reference", "stage_wgrad_fine_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    counters = [(pa, "LAUNCHES"), (pa, "BWD_LAUNCHES"), (pb, "STATS_LAUNCHES"),
                (pb, "BWD_LAUNCHES"), (ps, "FINE_FWD_LAUNCHES"), (ps, "FINE_DGRAD_LAUNCHES"),
                (ps, "FINE_WGRAD_LAUNCHES"), (pe, "LAUNCHES"), (pe, "BWD_LAUNCHES")]
    before = [(getattr(m, c), getattr(m, c + "_BF16")) for m, c in counters]
    model, cfg = _small_bf16(gpu, packed=True, dropout=0.1)
    batch = {k: v.to(gpu) for k, v in _small_batch(True).items()}
    met = _bf16_step(model, cfg, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    moved = [(getattr(m, c) - b[0], getattr(m, c + "_BF16") - b[1])
             for (m, c), b in zip(counters, before)]
    # per step: 2 blocks forward and backward, 18 BN statistics, 9 BN
    # backward sums, 14 fine-grid stage forwards, dgrads and wgrads, one ELBO
    # forward and one backward
    assert moved == [(2, 2), (2, 2), (18, 18), (9, 9), (14, 14), (14, 14), (14, 14), (1, 1),
                     (1, 1)], moved
    assert all(v == v for v in met.values())


def test_remat_on_the_card(gpu):
    """remat_blocks on the card, bf16, dropout 0.1: one step launches the
    attention forward twice per block (the backward's recompute) and the
    backward once, and equals the plain step bit for bit (metrics and every
    gradient), leaving the card's and the CPU generator in the same state."""
    runs = {}
    for remat in (False, True):
        model, cfg = _small_bf16(gpu, remat=remat, dropout=0.1)
        batch = {k: v.to(gpu) for k, v in _small_batch(False).items() if k != "eps"}
        gen = torch.Generator().manual_seed(0)
        torch.manual_seed(0)
        before = (pa.LAUNCHES, pa.BWD_LAUNCHES)
        met = _bf16_step(model, cfg, batch, gen)
        torch.cuda.synchronize()
        runs[remat] = (met, (pa.LAUNCHES - before[0], pa.BWD_LAUNCHES - before[1]),
                       {n: p.grad.clone() for n, p in model.named_parameters()},
                       gen.get_state(), torch.cuda.get_rng_state())
    (m0, l0, g0, c0, d0), (m1, l1, g1, c1, d1) = runs[False], runs[True]
    assert l0 == (2, 2) and l1 == (4, 2)
    assert m0 == m1 and all(torch.equal(g0[n], g1[n]) for n in g0)
    assert torch.equal(c0, c1) and torch.equal(d0, d1)


def _kfold_small(device, folds=2, n=11, noise=None):
    """train_kfold, one epoch (one lockstep step and the val pass), of the
    small f32 model (SMALL_BF16's widths, dropout 0) on ``device``, from
    seeded weights, a seeded batch corpus and the given noise."""
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vit import vessel_model
    from causalvae_tpu_torch.train.kfold import train_kfold
    from causalvae_tpu_torch.train.loop import vessel_loss_fn
    from causalvae_tpu_torch.train.state import ClippedAdam

    cfg = VesselConfig(**SMALL_BF16)
    g = torch.Generator().manual_seed(5)
    data = {"x": (torch.rand(n, 64, 96, 1, generator=g) > 0.9).float(),
            "m": torch.randn(n, 12, generator=g),
            "t": torch.eye(19)[torch.arange(n) % 2]}
    return train_kfold(
        init_one=lambda f: vessel_model((64, 96), device, seed=f, dropout=0.0, cfg=cfg)[0],
        make_optimizer=lambda m: ClippedAdam(m.parameters(), cfg.lr, cfg.grad_clip_norm,
                                             torch.bfloat16),
        loss_fn=vessel_loss_fn(cfg), data=data, labels=(torch.arange(n) % 2).numpy(),
        epochs=1, batch_size=4, n_folds=folds, seed=42, noise=noise)


def test_kfold_lockstep_step_card_against_cpu(gpu, monkeypatch):
    """One lockstep step of two folds and their val pass on the card against
    the CPU (plain versions there), the same weights, data and noise: the
    train metrics (the step's, from the same weights) within rel 1e-4, as
    chip_smoke's phase 7 holds a step's loss terms; the val metrics after
    the step (one padded batch a fold, 6 and 5 real samples) within rel
    1e-3, the val sparsity within 5e-3
    (tests/test_torch_kfold.py says why). On the card no plain version
    runs, and the counts are, per fold, 2 attention forwards and backwards,
    18 BN statistics and backward sums and 1 ELBO forward and 1 backward for
    the step, and 2 attention forwards for the val pass (masked: no ELBO
    kernel)."""
    g = torch.Generator().manual_seed(6)
    noise = [torch.randn(2, 4, 8, generator=g), torch.randn(2, 6, 8, generator=g)]
    _, _, cpu = _kfold_small("cpu", noise=iter(noise))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, names in ((pa, ("attention_reference", "attention_bwd_reference")),
                       (pb, ("bn_stats_reference", "bn_bwd_reference")),
                       (pe, ("_plain_terms", "_plain_bwd"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    counters = [(pa, "LAUNCHES"), (pa, "BWD_LAUNCHES"), (pb, "STATS_LAUNCHES"),
                (pb, "BWD_LAUNCHES"), (pe, "LAUNCHES"), (pe, "BWD_LAUNCHES")]
    before = [getattr(m, c) for m, c in counters]
    models, plan, card = _kfold_small(gpu, noise=iter(noise))
    torch.cuda.synchronize()
    moved = [getattr(m, c) - b for (m, c), b in zip(counters, before)]
    assert moved == [2 * (2 + 2), 2 * 2, 2 * 18, 2 * 18, 2 * 1, 2 * 1], moved
    assert sorted(len(v) for v in plan.val_idx) == [5, 6]  # ragged: the mask counts
    for split, rel in (("train", 1e-4), ("val", 1e-3)):
        for k, want in cpu[0][split].items():
            bound = 5e-3 if (split, k) == ("val", "sparsity") else rel
            got = card[0][split][k]
            assert np.isfinite(got).all() and (np.abs(got - want) <= bound * np.abs(want)).all(), (
                split, k, got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASE_IDS)
def test_operator_opcheck_on_the_card(gpu, name, dtype):
    """Each cvae operator's CUDA implementation (the kernel's launch) against
    its schema and its fake kernel (shapes, dtypes, contiguous strides):
    ``torch.library.opcheck`` on CUDA tensors."""
    torch.library.opcheck(*case(name, DTYPES[dtype], "cuda"))


@pytest.mark.parametrize("n_features", [12, 16])
def test_device_morphology_on_the_card(gpu, n_features):
    """The device morphology on the card against its CPU run on 512 random
    digit-like images (a chunk of ``build_morph_mnist``) and the edge
    cases (empty, saturated): the integer measures (largest component,
    Euler number, convex area, skeleton, endpoints, junctions) and the EDT
    maximum equal; the non-Hu features within 1e-5 (a ratio by a constant
    differs by an ulp: CUDA divides by a scalar as a product with its
    reciprocal), the Hu entries at most 0.6 within 1e-2
    (``tests/test_morphology.py:132-139``)."""
    from causalvae_tpu_torch.ops import morphology as mo

    rng = np.random.default_rng(16)
    imgs = np.zeros((514, 28, 28), np.float32)
    for i in range(512):
        r, c = rng.integers(6, 22, 2)
        for _ in range(rng.integers(20, 60)):
            imgs[i, r - 1:r + 2, c - 1:c + 2] = rng.uniform(0.15, 1.0)
            r, c = np.clip(np.array([r, c]) + rng.integers(-1, 2, 2), 1, 26)
    imgs[513] = 0.8
    fn = mo.features12_batch if n_features == 12 else mo.features16_batch
    card = fn(imgs, device="cuda").cpu().numpy()
    cpu = fn(imgs, device="cpu").numpy()
    plain = slice(0, 9 if n_features == 16 else 12)
    np.testing.assert_allclose(card[:, plain], cpu[:, plain], rtol=0, atol=1e-5)
    if n_features == 16:
        keep = np.abs(cpu[:, 9:]) <= 0.6
        np.testing.assert_allclose(card[:, 9:][keep], cpu[:, 9:][keep], rtol=0, atol=1e-2)
    b = torch.from_numpy(imgs > 0.2)
    mask = mo.largest_component(b)
    skel = mo.skeletonize(b)
    for fn_, arg in ((mo.largest_component, b), (mo.skeletonize, b), (mo.edt_max, b),
                     (mo.euler_number, mask), (mo.convex_area, mask),
                     (mo.skeleton_endpoints_junctions, skel)):
        got, want = fn_(arg.to(gpu)), fn_(arg)
        got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn_.__name__


def test_page_walk_on_the_card_machine(gpu, tmp_path):
    """The native page walk built on the card's machine: ``decode_pages`` and
    ``decode_mip`` of multi-page stacks in every codec of chip_smoke's
    writer equal the arrays written and their maxima, bit for bit, with
    tifffile and PIL blocked; a one-page file gives (1, h, w)."""
    import chip_smoke

    from causalvae_tpu_torch import native

    native.build()
    rng = np.random.default_rng(18)
    with chip_smoke.decoders_blocked():
        for fmt, codec in chip_smoke.FILE_CODECS.items():
            for pages in (1, 4):
                u16 = rng.integers(0, 65536, (pages, 130, 90)).astype(np.uint16)
                arr = {"f32": (u16 / np.float32(65535)).astype(np.float32)}.get(fmt, u16)
                if fmt in ("lzw8", "packbits", "u8"):
                    arr = (u16 >> 8).astype(np.uint8)
                path = str(tmp_path / f"{fmt}_{pages}.tiff")
                chip_smoke.write_tiff(path, arr if pages > 1 else arr[0], *codec, rows=32)
                want = arr.astype(np.float32)
                assert np.array_equal(native.decode_pages(path), want), (fmt, pages)
                assert np.array_equal(native.decode_mip(path), want.max(axis=0)), (fmt, pages)


def _launches():
    from causalvae_tpu_torch.ops.kernels import stage as ps

    names = [(pa, "LAUNCHES"), (pa, "BWD_LAUNCHES"), (pb, "STATS_LAUNCHES"),
             (pb, "BWD_LAUNCHES"), (pe, "LAUNCHES"), (pe, "BWD_LAUNCHES"),
             (ps, "FWD_LAUNCHES"), (ps, "FINE_FWD_LAUNCHES"), (ps, "BWD_LAUNCHES"),
             (ps, "FINE_DGRAD_LAUNCHES"), (ps, "FINE_WGRAD_LAUNCHES"), (ps, "WGRAD_LAUNCHES")]
    return [getattr(m, c) for m, c in names]


def test_cascade_step_card_against_cpu_launches_no_kernel(gpu):
    """One ``make_vae_step`` of C10 (64x128, batch 4, seeded weights, the
    same noise) on the card against the CPU: the loss terms within rel 1e-4
    and each gradient leaf within 1e-3 of its max|ref| (as chip_smoke's
    phase 17), but the BatchNorm-fed ``mechanism.shared.0.bias``, whose
    gradient is 0 up to rounding; the card run launches no ported kernel."""
    from causalvae_tpu_torch.models.vae import CausalBioVAE, seeded_init_
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.train.loop import make_vae_step
    from causalvae_tpu_torch.train.state import ClippedAdam

    rng = np.random.default_rng(19)
    batch = {"x": torch.from_numpy(rng.standard_normal((4, 64, 128, 1)).astype(np.float32)),
             "m": torch.from_numpy(rng.random((4, 12), dtype=np.float32)),
             "t": torch.from_numpy(rng.integers(0, 5, 4))}
    eps = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    got = {}
    for dev in ("cuda", "cpu"):
        model = seeded_init_(CausalBioVAE(t_dim=5, device=dev), 3)
        step = make_vae_step(model, lambda o, b: L.cascade_loss(o, b["x"], b["m"]),
                             ClippedAdam(model.parameters(), 1e-3, None, torch.float32))
        before = _launches()
        met = step({k: v.to(dev) for k, v in batch.items()}, eps=eps.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _launches() == before
        got[dev] = ({k: float(v) for k, v in met.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    (g_met, g_grads), (c_met, c_grads) = got["cuda"], got["cpu"]
    for k, want in c_met.items():
        assert abs(g_met[k] - want) <= 1e-4 * abs(want), k
    for n, c in c_grads.items():
        if n != "mechanism.shared.0.bias":
            assert float((g_grads[n] - c).abs().max()) <= 1e-3 * float(c.abs().max()), n


def test_train_vit_vae_counts_on_the_card(gpu):
    """Two ``train_vit_vae`` steps of a small translator ViTVAE (depth 2,
    dec_res_stages 4) on the card: per step 2 attention forwards and 2
    backwards, 18 BN statistics and 18 BN backward sums (5 stem, 5 decoder
    and 4 ResBlocks x 2 BatchNorms), no other kernel; finite losses; then
    ``extract_vit_latents``: 2 attention forwards a batch and nothing else."""
    from causalvae_tpu_torch.models.vae import seeded_init_
    from causalvae_tpu_torch.models.vit import ViTVAE
    from causalvae_tpu_torch.train import workloads as W

    x = torch.rand(4, 64, 96, 1, generator=torch.Generator().manual_seed(5)).to(gpu)
    model = seeded_init_(ViTVAE(img_size=(64, 96), latent_dim=16, embed_dim=32, depth=2,
                                heads=4, mlp_dim=64, dec_res_stages=4, device=gpu), 1)
    before = _launches()
    _, _, log = W.train_vit_vae(lambda e: iter([{"x": x}, {"x": x.flip(1)}]), (64, 96),
                                epochs=1, model=model)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_launches(), before)]
    assert moved == [4, 4, 36, 36] + [0] * 8, moved
    assert np.isfinite(log.history[0]["train_loss"])
    before = _launches()
    z = W.extract_vit_latents(model, [{"x": x}, {"x": x[:2]}])
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [4] + [0] * 11
    assert z.shape == (6, 16) and np.isfinite(z).all()


@pytest.mark.parametrize("packed", [False, True], ids=["spatial", "packed"])
def test_vessel_cnn_step_counts_and_card_against_cpu(gpu, packed):
    """One ``make_vae_step`` of a small C7 (128x256, z 16, seeded weights,
    batch 4, the same noise) on the card: one BN reduction each way per
    train-mode BatchNorm (15; the channels-last entries in the packed form)
    and the ELBO terms once each way, nothing else; against the CPU the loss
    terms within rel 1e-4 and the gradients below the decoder's BatchNorm
    chain (``dec_out``, the mechanism) within 1e-3 of their max|ref|; then
    an eval forward launches no kernel."""
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vae import CausalVesselVAE, seeded_init_
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
    from causalvae_tpu_torch.train.state import ClippedAdam

    g = torch.Generator().manual_seed(7)
    batch = {"x": (torch.rand(4, 128, 256, 1, generator=g) > 0.9).float(),
             "m": torch.randn(4, 12, generator=g),
             "t": torch.eye(19)[torch.randint(0, 19, (4,), generator=g)]}
    eps = torch.randn(4, 16, generator=g)
    cfg = VesselConfig()
    got = {}
    for dev in ("cuda", "cpu"):
        model = seeded_init_(CausalVesselVAE(z_dim=16, grid_hw=(1, 2), packed=packed,
                                             device=dev), 3)
        step = make_vae_step(model, vessel_loss_fn(cfg),
                             ClippedAdam(model.parameters(), 1e-4, 5.0, torch.float32))
        before = _launches()
        met = step({k: v.to(dev) for k, v in batch.items()}, eps=eps.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_launches(), before)] == [0, 0, 15, 15, 1, 1] + [0] * 6
            before = _launches()
            with torch.no_grad():
                model.eval()(batch["x"].to(dev), batch["m"].to(dev), batch["t"].to(dev),
                             eps=eps.to(dev))
            torch.cuda.synchronize()
            assert _launches() == before
        got[dev] = ({k: float(v) for k, v in met.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    (g_met, g_grads), (c_met, c_grads) = got["cuda"], got["cpu"]
    for k, want in c_met.items():
        assert abs(g_met[k] - want) <= 1e-4 * abs(want), k
    for n, c in c_grads.items():
        if n.startswith(("dec_out.", "morph.")):
            assert float((g_grads[n] - c).abs().max()) <= 1e-3 * float(c.abs().max()), n


def test_reference_checkpoint_loads_into_c7_on_the_card(gpu, tmp_path):
    """A reference-layout C7 state dict (``chip_smoke.RefVesselVAE`` at
    128x256, z 16, seeded, its BatchNorms with non-trivial statistics) saved
    under ``model_state_dict``, read by ``load_torch_checkpoint`` and
    converted by ``port_vessel_cnn_checkpoint`` into the port's C7 on the
    card: nothing skipped; eval encode, predict_m and decode within 1e-5 of
    the reference model's max|ref| on the card."""
    from chip_smoke import RefVesselVAE

    from causalvae_tpu_torch.models.vae import CausalVesselVAE
    from causalvae_tpu_torch.train.checkpoints import load_torch_checkpoint
    from causalvae_tpu_torch.train.port_maps import port_vessel_cnn_checkpoint

    torch.manual_seed(0)
    ref = RefVesselVAE(z_dim=16, grid=(1, 2))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.copy_(0.2 * torch.randn(mod.num_features, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.num_features, generator=g))
    path = str(tmp_path / "c7.pt")
    torch.save({"model_state_dict": ref.state_dict()}, path)
    model = CausalVesselVAE(z_dim=16, grid_hw=(1, 2), device=gpu)
    sd, skipped = port_vessel_cnn_checkpoint(model, load_torch_checkpoint(path), (1, 2))
    assert skipped == []
    model.load_state_dict(sd, strict=True)
    ref = ref.to(gpu).eval()
    model.eval()
    x = (torch.rand(2, 128, 256, 1, generator=g) > 0.8).float().to(gpu)
    m, z = torch.randn(2, 12, generator=g).to(gpu), torch.randn(2, 16, generator=g).to(gpu)
    t = torch.eye(19)[[3, 11]].to(gpu)
    with torch.no_grad():
        pairs = [(model.encode(x, m, t), ref.encode(x.permute(0, 3, 1, 2), m, t)),
                 ((model.predict_m(t),), (ref.predict_m(t),)),
                 ((model.decode(m, z),), (ref.decode(m, z).permute(0, 2, 3, 1),))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_attention_dropout_heads_offset_on_the_card(gpu):
    """``bh0`` on the card: the forward and backward kernels at heads
    bh0.. equal the plain versions at bh0, and the rows of one launch over
    the whole batch (a data-parallel rank's heads, 2e-5 max|ref|)."""
    g = torch.Generator(device="cpu").manual_seed(11)
    q, k, v, do = (torch.randn(16, 97, 32, generator=g).to(gpu) for _ in range(4))
    o_all, lse_all = pa.attention_fwd(q, k, v, 0.1, 9)
    o, lse = pa.attention_fwd(q[8:], k[8:], v[8:], 0.1, 9, bh0=8)
    ro, rlse = pa.attention_reference(q[8:], k[8:], v[8:], 0.1, 9, bh0=8)
    for got, want in ((o, ro), (o, o_all[8:]), (lse, rlse), (lse, lse_all[8:])):
        assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max()) + 1e-6
    grads = pa.attention_bwd(q[8:], k[8:], v[8:], o, lse, do[8:], 0.1, 9, bh0=8)
    refs = pa.attention_bwd_reference(q[8:], k[8:], v[8:], o, lse, do[8:], 0.1, 9, bh0=8)
    for got, want in zip(grads, refs):
        assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max()) + 1e-6


def test_profile_trace_names_the_kernel_op(gpu, tmp_path):
    import os

    from causalvae_tpu_torch.utils.metrics import profile_trace

    q = torch.randn(8, 65, 32, device=gpu)
    with profile_trace(str(tmp_path)):
        pa.attention_fwd(q, q, q)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    assert "cvae::attention_fwd" in (tmp_path / name).read_text()


def test_two_gloo_ranks_step_on_one_card(gpu):
    """Two ranks on the one card (gloo: NCCL refuses two ranks on one
    card) take the small CausalViTVAE's global-batch step at dropout 0.1:
    the loss terms within 1e-4 of the one-process step on the card with the
    same seeds, the BatchNorm statistics bit-equal on the two ranks."""
    import torch_parallel_workers as W

    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vae import seeded_init_
    from causalvae_tpu_torch.models.vit import CausalViTVAE
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
    from causalvae_tpu_torch.train.state import ClippedAdam

    pm = CausalViTVAE(**W.SMALL, dropout=0.1, device=gpu)
    seeded_init_(pm, 0)
    state = {k: v.detach().cpu().numpy() for k, v in pm.state_dict().items()}
    rng = np.random.default_rng(0)
    batch = {"x": (rng.random((4, 64, 96, 1)) > 0.9).astype(np.float32),
             "m": rng.standard_normal((4, 12)).astype(np.float32),
             "t": np.eye(19, dtype=np.float32)[rng.integers(0, 19, 4)]}
    ranks = W.spawn([("vae_step", dict(state=state, batches=[batch], dropout=0.1,
                                       seed=3))], device="cuda:0")
    step = make_vae_step(pm, vessel_loss_fn(VesselConfig()),
                         ClippedAdam(pm.parameters(), W.LR, 5.0, torch.bfloat16))
    torch.manual_seed(3)
    want = step({k: torch.from_numpy(v).to(gpu) for k, v in batch.items()},
                generator=torch.Generator().manual_seed(3))
    got = ranks[0][0]["metrics"][0]
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 1e-4 * abs(float(v)), (k, got[k], float(v))
    for name, _ in pm.named_buffers():
        assert np.array_equal(ranks[0][0]["state"][name], ranks[1][0]["state"][name])


def test_attention_seed_is_read_from_device_memory_at_replay(gpu):
    """The attention kernels captured in a CUDA graph with a seed buffer:
    each replay takes the seed the buffer holds then, and gives the outputs
    of an eager launch with that seed (the plain version's mask)."""
    g = torch.Generator(device="cpu").manual_seed(4)
    q, k, v, do = (torch.randn(16, 97, 32, generator=g).to(gpu) for _ in range(4))
    seed = pa.seed_tensor(0, gpu)
    for _ in range(2):  # warm up: build and load the kernels
        o, lse = pa.attention_fwd(q, k, v, 0.1, seed)
        pa.attention_bwd(q, k, v, o, lse, do, 0.1, seed)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = pa.attention_fwd(q, k, v, 0.1, seed)
        grads = pa.attention_bwd(q, k, v, o, lse, do, 0.1, seed)
    for s in (7, 2**31 + 11):
        seed.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        want_o, want_lse = pa.attention_fwd(q, k, v, 0.1, s)
        want = pa.attention_bwd(q, k, v, want_o, want_lse, do, 0.1, s)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        assert all(torch.equal(a, b) for a, b in zip(grads, want))
        ref = pa.attention_reference(q, k, v, 0.1, s)[0]
        assert (o - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_scanned_steps_replay_the_eager_steps_on_the_card(gpu):
    """A small CausalViTVAE with dropout 0.1 (its noise and attention seeds
    drawn from a CPU generator), 5 steps at S = 2: two groups and a tail,
    each one CUDA-graph replay; the metrics of every step and the final
    parameters equal the same steps run eagerly, bit for bit, under cuDNN's
    deterministic algorithms; the launches are the steps' and the warm-up
    step's."""
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vae import seeded_init_
    from causalvae_tpu_torch.models.vit import CausalViTVAE
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
    from causalvae_tpu_torch.train.scan_loop import ScanTrainer
    from causalvae_tpu_torch.train.state import ClippedAdam

    small = dict(img_size=(64, 96), z_dim=8, embed_dim=32, depth=2, heads=4, mlp_dim=64,
                 vit_latent_dim=32)
    rng = np.random.default_rng(0)
    batches = [{"x": torch.from_numpy((rng.random((4, 64, 96, 1)) > 0.9).astype(np.float32)),
                "m": torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32)),
                "t": torch.eye(19)[torch.from_numpy(rng.integers(0, 19, 4))]}
               for _ in range(5)]
    batches = [{k: v.to(gpu) for k, v in b.items()} for b in batches]
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for scan in (False, True):
            model = seeded_init_(CausalViTVAE(**small, dropout=0.1, device=gpu), 0)
            opt = ClippedAdam(model.parameters(), 1e-3, 5.0, torch.bfloat16)
            step = make_vae_step(model, vessel_loss_fn(VesselConfig()), opt)
            gen = torch.Generator().manual_seed(1)
            torch.manual_seed(2)
            before = (pa.LAUNCHES, pa.BWD_LAUNCHES, pe.LAUNCHES, pb.STATS_LAUNCHES)
            if scan:
                tr = ScanTrainer(step, 1, 2)
                metrics = []
                for i in range(0, 5, 2):
                    out = tr.run_group([(model, opt)], batches[i:i + 2], gen)
                    metrics += [{k: v[j].clone() for k, v in out.items()}
                                for j in range(len(out["loss"]))]
                assert {s: p.replays for s, p in tr.programs.items()} == {2: 2, 1: 1}
                steps = 5 + tr.warmup_steps
            else:
                metrics = [step(b, generator=gen) for b in batches]
                steps = 5
            torch.cuda.synchronize()
            after = (pa.LAUNCHES, pa.BWD_LAUNCHES, pe.LAUNCHES, pb.STATS_LAUNCHES)
            assert [a - b for a, b in zip(after, before)] == [2 * steps, 2 * steps, steps,
                                                             18 * steps]
            runs.append((metrics, {k: v.clone() for k, v in model.state_dict().items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (m_eager, s_eager), (m_scan, s_scan) = runs
    for a, b in zip(m_eager, m_scan):
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    assert all(torch.equal(s_eager[k], s_scan[k]) for k in s_eager)
