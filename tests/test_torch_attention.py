"""Port parity of the attention forward (CPU side of the CUDA kernel).

On the CPU ``attention_fwd`` takes the plain version ``attention_reference``;
both are held to the JAX Pallas kernel (interpret mode, ``force_pallas=True``)
and to its XLA formulation, with the JAX suite's own tolerance (rtol 2e-4,
atol 2e-5, tests/test_kernels.py). The CUDA kernel itself is compared with the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

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
