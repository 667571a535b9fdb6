"""Port parity of the attention forward (CPU side of the CUDA kernel).

On the CPU ``attention_fwd`` takes the plain version ``attention_reference``;
both are held to the JAX Pallas kernel (interpret mode, ``force_pallas=True``)
and to its XLA formulation, with the JAX suite's own tolerance (rtol 2e-4,
atol 2e-5, tests/test_kernels.py); so are the training pieces: the dropout
hash (bit for bit), the forward with dropout and the backward. The CUDA
kernels themselves are compared with the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops.kernels import attention as ka

from causalvae_tpu_torch import device as pdevice
from causalvae_tpu_torch.ops.kernels import attention as pa


def _qkv(b, h, n, d, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,b,h,d", [(17, 2, 4, 32), (241, 2, 4, 32), (64, 1, 3, 16)])
def test_attention_matches_jax(n, b, h, d):
    q, k, v = _qkv(b, h, n, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(ka.flash_attention(jq, jk, jv, force_pallas=True))
    xla = np.asarray(ka._xla_attention(jq, jk, jv, 1.0 / np.sqrt(d)))
    got = pa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    ref, lse = pa.attention_reference(
        *(torch.from_numpy(a.reshape(b * h, n, d)) for a in (q, k, v)))
    for want in (pallas, xla):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(ref.numpy().reshape(b, h, n, d), want,
                                   rtol=2e-4, atol=2e-5)
    # the logsumexp the training slice reuses, against the Pallas kernel's
    _, res = ka._flash_fwd(0.0, jq, jk, jv, jnp.zeros((), jnp.int32))
    jlse = np.asarray(res[4])[:, :n, 0]
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=2e-4, atol=2e-5)


def test_cpu_dispatch_is_the_reference():
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(1, 3, 40, 16, seed=4))
    before = pa.LAUNCHES
    o, lse = pa.attention_fwd(q, k, v)
    ro, rlse = pa.attention_reference(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert o.dtype == torch.float32 and lse.shape == (3, 40)
    assert pa.LAUNCHES == before  # the plain version is not a kernel launch


def test_reference_bf16_keeps_f32_accumulation():
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(1, 2, 33, 32, seed=5))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = pa.attention_reference(qb, kb, vb)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = pa.attention_reference(*(t.float() for t in (qb, kb, vb)))
    assert float((o.float() - ref).abs().max()) <= 2e-2


def test_attention_rejects_bad_inputs():
    q = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="shape"):
        pa.attention_fwd(q, q, torch.zeros(2, 6, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.attention_fwd(q, q, q.half())
    meta = torch.zeros(2, 5, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa.attention_fwd(meta, meta, meta)


def test_cuda_request_without_gpu_raises(monkeypatch):
    """No silent fallback: asking for CUDA where there is none raises."""
    from causalvae_tpu_torch.models.vit import CausalViTVAE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CausalViTVAE(img_size=(64, 96), embed_dim=16, depth=1, heads=2)
    assert pdevice.resolve_device("cpu") == torch.device("cpu")


# --------------------------------------------------------------------------
# Training: the dropout hash and the backward (plain versions on the CPU,
# held to the JAX Pallas kernels in interpret mode, force_pallas=True)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 1, 2**31 + 5, 2**32 - 1])
def test_dropout_hash_is_bit_identical_to_jax(seed):
    """The port's hash equals ``dropout_keep`` element for element over a
    grid of (head, row, column) blocks, seeds at and beyond 2³¹ included."""
    for bh, row0, col0, shape in ((0, 0, 0, (33, 47)), (5, 128, 256, (16, 130)),
                                  (63, 900, 17, (61, 40))):
        want = np.asarray(ka.dropout_keep(jnp.uint32(seed), bh, row0, col0, shape))
        r = torch.arange(row0, row0 + shape[0]).view(-1, 1)
        c = torch.arange(col0, col0 + shape[1]).view(1, -1)
        got = pa.dropout_bits(seed, torch.tensor(bh), r, c).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    for rate in (0.1, 0.25):
        want = np.asarray(ka.keep_from_bits(ka.dropout_keep(jnp.uint32(seed), 2, 0, 0,
                                                            (40, 40)), rate))
        got = (pa.dropout_keep(seed, 3, 40)[2] >= pa.keep_threshold(rate)).numpy()
        np.testing.assert_array_equal(got, want)


def test_dropout_keep_fraction_and_seed_wrap():
    """~Bernoulli(0.9) keeps; a seed taken modulo 2³² gives the same mask (the
    JAX side carries the seed through an int32, bit for bit)."""
    keep = pa.dropout_keep(99, 4, 256) >= pa.keep_threshold(0.1)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    assert torch.equal(pa.dropout_keep(2**32 + 7, 2, 30), pa.dropout_keep(7, 2, 30))
    as_int32 = int(np.asarray(jnp.uint32(2**31 + 5).astype(jnp.int32)))
    assert as_int32 < 0
    assert torch.equal(pa.dropout_keep(as_int32, 2, 30), pa.dropout_keep(2**31 + 5, 2, 30))


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 2**31 + 77)])
@pytest.mark.parametrize("n", [17, 130])
def test_flash_attention_dropout_fwd_bwd_match_pallas(n, rate, seed):
    """Output and (dq, dk, dv) through ``jax.vjp`` of the Pallas kernels
    (interpret mode) against the port's autograd Function on the CPU."""
    b, h, d = 2, 3, 16
    q, k, v = _qkv(b, h, n, d, seed=n)
    g = np.random.default_rng(n + 1).standard_normal((b, h, n, d)).astype(np.float32)
    kw = dict(dropout_rate=rate, dropout_seed=jnp.uint32(seed)) if rate else {}
    want, vjp = jax.vjp(lambda *a: ka.flash_attention(*a, force_pallas=True, **kw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    pkw = dict(dropout_rate=rate, dropout_seed=seed) if rate else {}
    out = pa.flash_attention(*ts, **pkw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)


def test_attention_bwd_reference_is_the_gradient_of_the_forward():
    """The plain backward from the saved lse equals autograd through the
    plain forward, with dropout."""
    q, k, v = (torch.from_numpy(a[0]).requires_grad_(True)
               for a in _qkv(1, 4, 29, 8, seed=11))
    do = torch.randn(4, 29, 8, generator=torch.Generator().manual_seed(3))
    o, lse = pa.attention_reference(q, k, v, 0.2, 5)
    o.backward(do)
    dq, dk, dv = pa.attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                            o.detach(), lse, do, 0.2, 5)
    for got, t in zip((dq, dk, dv), (q, k, v)):
        torch.testing.assert_close(got, t.grad, rtol=1e-5, atol=1e-6)


def test_backward_cpu_dispatch_and_dropout_arguments():
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(1, 2, 12, 8, seed=12))
    o, lse = pa.attention_fwd(q, k, v, 0.1, 3)
    before = (pa.LAUNCHES, pa.BWD_LAUNCHES)
    grads = pa.attention_bwd(q, k, v, o, lse, torch.ones_like(o), 0.1, 3)
    want = pa.attention_bwd_reference(q, k, v, o, lse, torch.ones_like(o), 0.1, 3)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="requires dropout_seed"):
        pa.flash_attention(q[None], k[None], v[None], dropout_rate=0.1)
    with pytest.raises(ValueError, match="outside"):
        pa.attention_fwd(q, k, v, 1.0, 3)
