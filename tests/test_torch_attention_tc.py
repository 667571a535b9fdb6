"""The tensor-core design of the attention backward (``csrc/attention_bwd.cu``,
``csrc/mma_tf32.cuh``), checked on the CPU where the kernel cannot run.

(a) Precision: an emulation of the 3xTF32 products (hi = cvt.rna.tf32(x),
    lo = cvt.rna.tf32(x - hi), a·b ≈ hi·hi + hi·lo + lo·hi summed in f32) run
    through the backward's five products holds 1e-4 max|ref| + 1e-6 against
    ``attention_bwd_reference`` in float64: the card's f32 tolerance.
(b) Index math: a numpy emulation of the kernels' tile loops, one warp's
    ``mma.sync m16n8k8`` fragment maps (the PTX ISA's, CUTLASS's
    ``SM80_16x8x8_F32TF32TF32F32_TN``), the C-to-A relabelling, the ragged last
    tile and the dropout mask, in float64, equals ``attention_bwd_reference``
    in float64 within 1e-5 max|ref|: the narrow plan (64-row tiles, all of D
    in one pass) at D = 8-32 and the wide plan (32-row tiles, dk and dv in
    passes of 64 columns, dq in passes of 128) at D = 64-256; and the
    wrapper's zero padding of another D to the next compiled one.
(c) The JAX ``flash_attention`` backward (``jax.vjp`` of the Pallas kernels in
    interpret mode) against the port's at D = 8, 20, 32, 64 and 128, and
    against the emulated kernels at D = 20 (padded), 64 and 128, with the JAX
    suite's tolerance (rtol 2e-4, atol 2e-5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops.kernels import attention as ka

from causalvae_tpu_torch.ops.kernels import attention as pa

SEED = 2**31 + 21


def _inputs(bh, n, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, n, d)).astype(np.float32).astype(dtype))
            for _ in range(4)]


# --------------------------------------------------------------------------
# (a) 3xTF32 precision
# --------------------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 values: 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """a @ b with TF32 operands: 3xTF32 (split) or one TF32 product, f32 sums."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    out = torch.matmul(a_hi, b_hi)
    if split:
        a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
        out = out + (torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi))
    return out


def bwd_tf32(q, k, v, o, lse, do, rate, seed, split=True):
    """The backward's math with its five products in TF32, the rest in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    mm = lambda a, b: mm_tf32(a, b, split)
    p = torch.exp(mm(q, k.transpose(-1, -2)) * scale - lse[..., None])
    dp = mm(do, v.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = pa._keep_mask(seed, q.shape[0], q.shape[1], rate, q.device)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(pd.transpose(-1, -2), do))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -(1.0 + 2**-11), 3.0,
                      1.0 + 2**-12])
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0, 1.0])
    assert torch.equal(tf32_rna(x), want)  # ties away from zero, either sign
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32_rna(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((y - hi) / y).abs().max()) <= 2**-11


def test_3xtf32_backward_holds_f32_tolerance_and_1xtf32_does_not():
    """(8, 961, 32) at rate 0.1: the split products hold the card's f32
    tolerance (1e-4 max|ref| + 1e-6) against the float64 plain backward; plain
    TF32 (one product each) does not, which is why f32 runs split."""
    bh, n, d, rate = 8, 961, 32, 0.1
    q, k, v, do = _inputs(bh, n, d, seed=1)
    o, lse = pa.attention_reference(q, k, v, rate, SEED)  # the f32 forward's outputs
    want = pa.attention_bwd_reference(*(t.double() for t in (q, k, v, o)), lse.double(),
                                      do.double(), rate, SEED)
    worst = {}
    for split in (True, False):
        got = bwd_tf32(q, k, v, o, lse, do, rate, SEED, split)
        worst[split] = max(float((g.double() - w).abs().max()) / (1e-4 * float(w.abs().max())
                                                                  + 1e-6)
                           for g, w in zip(got, want))
    assert worst[True] <= 1.0, worst
    assert worst[False] > 1.0, worst


# --------------------------------------------------------------------------
# (b) The kernels' tile loops and fragment maps, emulated in numpy
# --------------------------------------------------------------------------

TILE, WARPS = 64, 4
WIDE_ROWS = 32  # rows of a streamed tile in the wide plan (csrc/attention_tiles.cuh)
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
# A (16 x 8): register r of lane (g, t) holds A[g + 8 (r & 1)][t + 4 (r >> 1)]
A_ROW = G[:, None] + 8 * (np.arange(4) & 1)
A_COL = T[:, None] + 4 * (np.arange(4) >> 1)
# B (8 x 8, [k][n]): register r holds B[t + 4 r][g]
B_K = T[:, None] + 4 * np.arange(2)
B_N = np.repeat(G[:, None], 2, axis=1)
# C (16 x 8): register r holds C[g + 8 (r >> 1)][2 t + (r & 1)]
C_ROW = G[:, None] + 8 * (np.arange(4) >> 1)
C_COL = 2 * T[:, None] + (np.arange(4) & 1)
# A fragment from a C fragment, k relabelled: slot t is column 2t, t + 4 is 2t + 1
C_TO_A = [0, 2, 1, 3]
# B rows read in the relabelled order: register r holds row 2t + r
B_K_RELABELLED = 2 * T[:, None] + np.arange(2)


def test_fragment_maps_cover_each_tile_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 8)), (B_K, B_N, (8, 8)),
                              (C_ROW, C_COL, (16, 8))):
        seen = np.zeros(shape, int)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()
    # the relabelled A fragment holds, in slot order, the C elements of its rows
    a_cols = C_COL[:, C_TO_A]
    assert (C_ROW[:, C_TO_A] == A_ROW).all()
    assert (a_cols == np.where(A_COL < 4, 2 * A_COL, 2 * (A_COL - 4) + 1)).all()


def mma(c, a, b):
    """One warp's mma.sync m16n8k8 on per-lane fragments: c (..., 32, 4) +
    A (..., 32, 4) B (..., 32, 2), each rebuilt from its lane map."""
    batch = a.shape[:-2]
    am = np.zeros(batch + (16, 8))
    am[..., A_ROW, A_COL] = a
    bm = np.zeros(batch + (8, 8))
    bm[..., B_K, B_N] = b
    return c + (am @ bm)[..., C_ROW, C_COL]


def frag_b_rows(x, n0, k0):
    """B = X^T from rows of X: b_r = X[n0 + g][k0 + t + 4 r]."""
    return x[..., n0 + B_N, k0 + B_K]


def frag_b_cols(x, k0, n0):
    """B = X with rows relabelled: b_r = X[k0 + 2t + r][n0 + g]."""
    return x[..., k0 + B_K_RELABELLED, n0 + B_N]


def _padded(t, rows):
    """(BH, N, ...) -> (BH, rows, ...) with zeros past N (the zero-filled tiles)."""
    out = np.zeros((t.shape[0], rows) + t.shape[2:])
    out[:, :t.shape[1]] = t
    return out


def padded_call(fn, ts, cut):
    """``fn`` (an emulated kernel on numpy inputs) as the wrapper runs the
    kernels at a head dim D they are not compiled at: the (BH, N, D) tensors
    of ``ts`` zero-padded to ``kernel_head_dim(D)`` (``pad_head_dim``), and
    the first ``cut`` outputs cut back to D."""
    d = ts[0].shape[-1]
    dp = pa.kernel_head_dim(d)
    out = fn(*(pa.pad_head_dim(t, dp).numpy() if t.dim() == 3 else t.numpy() for t in ts))
    return tuple(a[..., :d] if i < cut else a for i, a in enumerate(out))


def bwd_plan(d):
    """(rows a loop step, dk and dv columns a pass, dq columns a pass) of
    ``attention_bwd.cu`` at a compiled head dim: the narrow plan (64, D, D) up
    to 32, the wide plan (32, min(D, 64), min(D, 128)) above."""
    return (TILE, d, d) if d <= 32 else (WIDE_ROWS, min(d, 64), min(d, 128))


def emulate_bwd(q, k, v, o, lse, do, rate, seed, scale=None):
    """dq, dk, dv as delta_kernel, dkdv_kernel and dq_kernel (or, for D > 32,
    dkdv_wide_kernel and dq_wide_kernel) compute them, warp by warp, from
    float64 numpy inputs (BH, N, D); ``scale`` defaults to 1/sqrt(D). Both
    plans give a block 64 rows of its own, 16 a warp; they differ in the rows
    a loop step and in the passes over the output's columns, each of which
    recomputes S and dP."""
    bh, n, d = q.shape
    step, kv_cols, q_cols = bwd_plan(d)
    ks, nts = d // 8, step // 8
    tiles, steps = -(-n // TILE), -(-n // step)
    rows = max(tiles * TILE, steps * step)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qp, kp, vp, dop = (_padded(x, rows) for x in (q, k, v, do))
    lsep = _padded(lse, rows)
    deltap = _padded((do * o).sum(-1), rows)
    keep = np.ones((bh, rows, rows), bool)
    if rate > 0.0:
        keep[:, :n, :n] = pa._keep_mask(seed, bh, n, rate, "cpu").numpy()
    inv_keep = 1.0 / (1.0 - rate)
    hb = np.arange(bh)[:, None, None, None, None]  # batch: (bh, block, warp)
    # a warp's 16 rows: block * 64 + warp * 16, fragment rows from A_ROW / C_ROW
    row0 = (np.arange(tiles)[None, :, None] * TILE
            + np.arange(WARPS)[None, None, :] * 16)[..., None, None]

    def frag_a(x):  # A fragments of each warp's rows: (ks, bh, tiles, warps, 32, 4)
        return np.stack([x[hb, row0 + A_ROW, kk * 8 + A_COL] for kk in range(ks)])

    def store(out, acc, c0, mult):  # C fragments -> columns c0.. of (BH, rows, D)
        for dt in range(len(acc)):
            out[hb, row0 + C_ROW, c0 + dt * 8 + C_COL] = acc[dt] * mult

    # dkdv: warps own keys; the loop runs over query tiles, once per pass
    kf, vf = frag_a(kp), frag_a(vp)
    dk, dv = np.zeros((bh, rows, d)), np.zeros((bh, rows, d))
    key = row0 + C_ROW
    for c0 in range(0, d, kv_cols):
        dk_acc = np.zeros((kv_cols // 8, bh, tiles, WARPS, 32, 4))
        dv_acc = np.zeros_like(dk_acc)
        for it in range(steps):
            q0 = it * step
            qt, dot = qp[:, None, None, q0:q0 + step], dop[:, None, None, q0:q0 + step]
            for nt in range(nts):
                s = np.zeros(kf.shape[1:])
                dp = np.zeros_like(s)
                for kk in range(ks):
                    s = mma(s, kf[kk], frag_b_rows(qt, nt * 8, kk * 8))
                    dp = mma(dp, vf[kk], frag_b_rows(dot, nt * 8, kk * 8))
                query = q0 + nt * 8 + C_COL
                p = np.exp(s * scale - lsep[hb, query])
                p = np.where(query < n, p, 0.0)
                kept = keep[hb, query, key]
                pd = np.where(kept, p * inv_keep, 0.0)
                ds = p * (np.where(kept, dp * inv_keep, 0.0) - deltap[hb, query])
                for dt in range(kv_cols // 8):
                    dv_acc[dt] = mma(dv_acc[dt], pd[..., C_TO_A],
                                     frag_b_cols(dot, nt * 8, c0 + dt * 8))
                    dk_acc[dt] = mma(dk_acc[dt], ds[..., C_TO_A],
                                     frag_b_cols(qt, nt * 8, c0 + dt * 8))
        store(dk, dk_acc, c0, scale)
        store(dv, dv_acc, c0, 1.0)

    # dq: warps own queries; the loop runs over key tiles, once per pass
    qf, of = frag_a(qp), frag_a(dop)
    dq = np.zeros((bh, rows, d))
    query = row0 + C_ROW
    for c0 in range(0, d, q_cols):
        dq_acc = np.zeros((q_cols // 8, bh, tiles, WARPS, 32, 4))
        for it in range(steps):
            k0 = it * step
            kt, vt = kp[:, None, None, k0:k0 + step], vp[:, None, None, k0:k0 + step]
            for nt in range(nts):
                s = np.zeros(qf.shape[1:])
                dp = np.zeros_like(s)
                for kk in range(ks):
                    s = mma(s, qf[kk], frag_b_rows(kt, nt * 8, kk * 8))
                    dp = mma(dp, of[kk], frag_b_rows(vt, nt * 8, kk * 8))
                key = k0 + nt * 8 + C_COL
                p = np.exp(s * scale - lsep[hb, query])
                p = np.where(key < n, p, 0.0)
                dp = np.where(keep[hb, query, key], dp * inv_keep, 0.0)
                ds = p * (dp - deltap[hb, query])
                for dt in range(q_cols // 8):
                    dq_acc[dt] = mma(dq_acc[dt], ds[..., C_TO_A],
                                     frag_b_cols(kt, nt * 8, c0 + dt * 8))
        store(dq, dq_acc, c0, scale)

    return dq[:, :n], dk[:, :n], dv[:, :n]


@pytest.mark.parametrize("n", [1, 17, 65, 241])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
def test_kernel_emulation_equals_the_plain_backward(n, d):
    """Dropout on (rate 0.1): the emulated kernels' dq, dk, dv equal the plain
    backward within 1e-5 max|ref| (both float64: the index math is exact or
    wrong), narrow and wide plans."""
    rate = 0.1
    q, k, v, do = _inputs(3, n, d, seed=n + d, dtype=np.float64)
    o, lse = pa.attention_reference(q, k, v, rate, SEED)
    want = pa.attention_bwd_reference(q, k, v, o, lse, do, rate, SEED)
    got = emulate_bwd(*(t.numpy() for t in (q, k, v, o, lse, do)), rate, SEED)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


@pytest.mark.parametrize("d", [1, 20, 48, 100, 200])
def test_padded_head_dim_emulation_equals_the_plain_backward(d):
    """A head dim the kernels are not compiled at: q, k, v, o and do
    zero-padded to the next compiled one, the emulated kernels there with the
    true D's scale, dq, dk, dv cut back to D: the plain backward at D within
    1e-5 max|ref|, dropout on."""
    n, rate = 70, 0.1
    q, k, v, do = _inputs(2, n, d, seed=d, dtype=np.float64)
    o, lse = pa.attention_reference(q, k, v, rate, SEED)
    want = pa.attention_bwd_reference(q, k, v, o, lse, do, rate, SEED)
    got = padded_call(lambda *a: emulate_bwd(*a, rate, SEED, scale=1.0 / math.sqrt(d)),
                      (q, k, v, o, lse, do), 3)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


def test_kernel_emulation_without_dropout():
    q, k, v, do = _inputs(2, 70, 16, seed=3, dtype=np.float64)
    o, lse = pa.attention_reference(q, k, v)
    want = pa.attention_bwd_reference(q, k, v, o, lse, do)
    got = emulate_bwd(*(t.numpy() for t in (q, k, v, o, lse, do)), 0.0, 0)
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() <= 1e-5 * float(w.abs().max())


# --------------------------------------------------------------------------
# (c) The JAX backward against the port's at head dims 8 and 32
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", [8, 20, 32, 64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_backward_matches_pallas_at_head_dims(d, rate):
    """(dq, dk, dv) through ``jax.vjp`` of the Pallas kernels (interpret mode)
    against the port's autograd Function on the CPU, N = 65; with dropout at
    D = 20, 64 and 128 also against the emulated kernels (D = 20 padded to
    32, 64 and 128 the wide plan) from the Pallas forward's o and lse."""
    b, h, n = 2, 2, 65
    rng = np.random.default_rng(d)
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    kw = dict(dropout_rate=rate, dropout_seed=jnp.uint32(SEED)) if rate else {}
    want, vjp = jax.vjp(lambda *a: ka.flash_attention(*a, force_pallas=True, **kw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    pkw = dict(dropout_rate=rate, dropout_seed=SEED) if rate else {}
    out = pa.flash_attention(*ts, **pkw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
    if rate == 0.0 or d in (8, 32):
        return
    _, res = ka._flash_fwd(rate, *(jnp.asarray(a) for a in (q, k, v)), jnp.uint32(SEED))
    flat = [torch.from_numpy(a.reshape(b * h, n, d).astype(np.float64)) for a in (q, k, v)]
    jo = torch.from_numpy(np.asarray(want).reshape(b * h, n, d).astype(np.float64))
    jlse = torch.from_numpy(np.asarray(res[4])[:, :n, 0].astype(np.float64))
    got = padded_call(lambda *a: emulate_bwd(*a, rate, SEED, scale=1.0 / math.sqrt(d)),
                      (*flat, jo, jlse, torch.from_numpy(g.reshape(b * h, n, d)).double()), 3)
    for a, w in zip(got, want_grads):
        np.testing.assert_allclose(a.reshape(b, h, n, d), np.asarray(w), rtol=2e-4, atol=2e-5)
