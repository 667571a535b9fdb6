"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for a GPU in a fixture and skips without one
(so on a CPU-only machine they skip with that reason). Run them on a machine
with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from causalvae_tpu_torch.ops.kernels import attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
