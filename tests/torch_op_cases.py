"""Arguments of every ``cvae`` operator (``ops/kernels/registry.py``) at a
small shape that its kernel takes, for ``torch.library.opcheck`` on the CPU
(``tests/test_torch_export.py``, the plain versions) and on the card
(``tests/test_torch_cuda.py``, the kernels). Imports no JAX."""

import torch

from causalvae_tpu_torch.ops.kernels import attention as A
from causalvae_tpu_torch.ops.kernels import elbo as E
from causalvae_tpu_torch.ops.kernels import stage as S

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def op_cases(dtype: torch.dtype, device: str = "cpu"):
    """[(id, operator overload, args)]: every operator, each of its schema's
    options once (dropout, a caller's pos_weight, the gradients asked for,
    the three fine-grid recipes, no prologue; attention at a deep head dim);
    floating inputs of the kernel
    in ``dtype``, the f32 ones (statistics, weights, the mask) in f32."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g).to(device, dt)

    ops = torch.ops.cvae
    thresh = A.keep_threshold(0.1)
    q, k, v = (r(3, 10, 8, dt=dtype) for _ in range(3))
    o, lse = A.attention_reference(q, k, v, 0.1, 5)
    seed = A.seed_tensor(5, q.device)  # the kernels read the dropout seed from device memory
    mean, inv = r(4), r(4).abs() + 0.5
    rec = r(2, 6, 5, 1, dt=dtype)
    x = (r(2, 6, 5, 1) > 0.5).float()
    pw = E.pos_weight(x)
    cases = [
        ("attention_fwd", ops.attention_fwd.default, (q, k, v, 0.0, 0, None, 0)),
        ("attention_fwd-dropout", ops.attention_fwd.default, (q, k, v, 0.1, 1, seed, thresh)),
        ("attention_bwd-dropout", ops.attention_bwd.default,
         (q, k, v, o, lse, r(3, 10, 8, dt=dtype), 0.1, 1, seed, thresh)),
        ("bn_stats", ops.bn_stats.default, (r(2, 4, 9, dt=dtype),)),
        ("bn_bwd_sums", ops.bn_bwd_sums.default,
         (r(2, 4, 9, dt=dtype), r(2, 4, 9, dt=dtype), mean, inv)),
        ("bn_stats_rows", ops.bn_stats_rows.default, (r(20, 4, dt=dtype),)),
        ("bn_bwd_sums_rows", ops.bn_bwd_sums_rows.default,
         (r(20, 4, dt=dtype), r(20, 4, dt=dtype), mean, inv)),
        ("elbo_terms", ops.elbo_terms.default, (rec, x, None)),
        ("elbo_terms-pw", ops.elbo_terms.default, (rec, x, pw)),
        ("elbo_terms_bwd-recon", ops.elbo_terms_bwd.default, (r(3), rec, x, pw, True, False)),
        ("elbo_terms_bwd-both", ops.elbo_terms_bwd.default, (r(3), rec, x, pw, True, True)),
    ]
    for recipe, levels in (("conv", 1), ("stem", 1), ("convT", 0)):
        ci, co, lout = 5, 3, S.out_levels(recipe, levels)
        xs = r(2, 3, 5, ci << (2 * levels), dt=dtype)
        mul, add = r(xs.shape[3]), r(xs.shape[3])
        w, b = r(3, 3, ci, co), r(co << (2 * lout))
        dy = r(2, 3, 5, co << (2 * lout), dt=dtype)
        fine = (0.01, recipe, levels, True)
        cases += [(f"stage_fwd_fine-{recipe}", ops.stage_fwd_fine.default,
                   (xs, mul, add, w, b, *fine)),
                  (f"stage_dgrad_fine-{recipe}", ops.stage_dgrad_fine.default,
                   (xs, dy, mul, add, w, *fine)),
                  (f"stage_wgrad_fine-{recipe}", ops.stage_wgrad_fine.default,
                   (xs, dy, mul, add, w, *fine))]
    xs, ker = r(2, 6, 10, 16, dt=dtype), r(2, 2, 16, 24)
    mul, add, b, dy = r(16), r(16), r(24), r(2, 6, 10, 24, dt=dtype)
    cases += [("stage_fwd", ops.stage_fwd.default, (xs, mul, add, ker, b, 0.01, 0, True)),
              ("stage_bwd", ops.stage_bwd.default, (xs, dy, mul, add, ker, 0.01, 0, True)),
              ("stage_bwd_wgrad-no-prologue", ops.stage_bwd_wgrad.default,
               (xs, dy, mul, add, ker, 0.01, 0, False))]
    # attention at a deep head dim (D > 256: the wrapper pads it to a multiple of 64)
    qd, kd, vd = (r(2, 9, 300, dt=dtype) for _ in range(3))
    od, lsed = A.attention_reference(qd, kd, vd, 0.1, 5)
    cases += [("attention_fwd-deep", ops.attention_fwd.default,
               (qd, kd, vd, 0.1, 1, seed, thresh)),
              ("attention_bwd-deep", ops.attention_bwd.default,
               (qd, kd, vd, od, lsed, r(2, 9, 300, dt=dtype), 0.1, 1, seed, thresh))]
    return cases


CASE_IDS = [c[0] for c in op_cases(torch.float32)]


def case(name: str, dtype: torch.dtype, device: str = "cpu"):
    """(operator, args) of the case ``name``."""
    _, op, args = next(c for c in op_cases(dtype, device) if c[0] == name)
    return op, args
