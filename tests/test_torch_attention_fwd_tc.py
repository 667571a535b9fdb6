"""The tensor-core design of the attention forward (``csrc/attention_fwd.cu``,
``csrc/attention_tiles.cuh``, ``csrc/mma_tf32.cuh``), checked on the CPU where
the kernel cannot run.

(a) Precision: an emulation of the forward's two products in 3xTF32 (hi =
    cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), a·b ≈ hi·hi + hi·lo + lo·hi
    summed in f32), with the softmax in f32, holds 2e-5 max|ref| + 1e-6 for o
    and lse against ``attention_reference`` in float64: the card's f32
    tolerance. One TF32 product each does not.
(b) Index math: a numpy emulation of the kernel's key-tile loop, one warp's
    ``mma.sync m16n8k8`` fragment maps, the quad max and sum (``__shfl_xor_sync``
    over lanes 1 and 2), the online rescale, the C-to-A relabelling of P, the
    per-tile P V added to o's accumulator, the ragged last tile and the
    dropout mask, in float64, equals ``attention_reference`` in float64
    within 1e-5 max|ref|: the narrow plan (64-key tiles, all of D in one
    pass) at D = 8-64 and the wide plan (32-key tiles, o's columns in passes
    of 128) at D = 128 and 256; and the wrapper's zero padding of another D
    to the next compiled one, with the true D's scale.
(c) The ragged tile's keys are masked before the row max: a row whose real
    scores all lie far below 0 stays finite and right; masking only p after the
    max (the trap) gives NaN there.
(d) The JAX forward (``_flash_fwd``, the Pallas kernel in interpret mode) against
    the emulated kernel, o and lse, with the JAX suite's tolerance (rtol 2e-4,
    atol 2e-5).

The fragment maps and the TF32 rounding are those of the backward's design
tests (``tests/test_torch_attention_tc.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops.kernels import attention as ka

from causalvae_tpu_torch.ops.kernels import attention as pa

from test_torch_attention_tc import (C_COL, C_ROW, C_TO_A, LANE, SEED, TILE, WARPS,
                                     WIDE_ROWS, A_COL, A_ROW, _inputs, _padded,
                                     frag_b_cols, frag_b_rows, mm_tf32, mma, padded_call)

LOG2E = 1.0 / math.log(2.0)
HALF = np.arange(4) >> 1  # C register r holds row g + 8 (r >> 1)


# --------------------------------------------------------------------------
# (a) 3xTF32 precision
# --------------------------------------------------------------------------


def fwd_tf32(q, k, v, rate, seed, split=True):
    """The forward's math in f32 with its two products in TF32: scores in the
    log2 domain, p = 2^(s - m), l from the undropped p, o = (Pa V) / l / keep."""
    s = mm_tf32(q, k.transpose(-1, -2), split) * (LOG2E / math.sqrt(q.shape[-1]))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        p = torch.where(pa._keep_mask(seed, q.shape[0], q.shape[1], rate, q.device), p, 0.0)
    o = mm_tf32(p, v, split) / (l * (1.0 - rate))
    return o, (m[..., 0] + torch.log2(l[..., 0])) * math.log(2.0)


def test_3xtf32_forward_holds_f32_tolerance_and_1xtf32_does_not():
    """(8, 961, 32) at rates 0 and 0.1: the split products hold the card's f32
    tolerance for o and lse (2e-5 max|ref| + 1e-6) against the float64 plain
    forward; plain TF32 misses it, which is why f32 runs split."""
    q, k, v, _ = _inputs(8, 961, 32, seed=4)
    for rate in (0.0, 0.1):
        want = pa.attention_reference(q.double(), k.double(), v.double(), rate, SEED)
        worst = {}
        for split in (True, False):
            got = fwd_tf32(q, k, v, rate, SEED, split)
            worst[split] = max(float((g.double() - w).abs().max())
                               / (2e-5 * float(w.abs().max()) + 1e-6)
                               for g, w in zip(got, want))
        assert worst[True] <= 1.0, (rate, worst)
        assert worst[False] > 1.0, (rate, worst)


# --------------------------------------------------------------------------
# (b) The kernel's tile loop and fragment maps, emulated in numpy
# --------------------------------------------------------------------------


def exp2_ftz(x):
    """ex2.approx.ftz.f32's range: results below 2^-126 flush to 0."""
    y = np.exp2(x)
    return np.where(y < 2.0**-126, 0.0, y)


def quad(x, op):
    """x (..., 32 lanes, k) reduced over each quad of lanes, as two
    __shfl_xor_sync steps (lane ^ 1, then lane ^ 2) leave it in every lane."""
    x = op(x, x[..., LANE ^ 1, :])
    return op(x, x[..., LANE ^ 2, :])


def fwd_plan(d):
    """(keys a loop step, o columns a pass) of ``attention_fwd.cu`` at a
    compiled head dim: the narrow plan (64, D) up to 64, the wide plan (32,
    min(D, FWD_WIDE_COLS = 128)) above."""
    return (TILE, d) if d <= 64 else (WIDE_ROWS, min(d, 128))


def emulate_fwd(q, k, v, rate, seed, mask_before_max=True, scale=None):
    """(o, lse) as attention_fwd_kernel (or, for D > 64,
    attention_fwd_wide_kernel) computes them, warp by warp, from float64 numpy
    inputs (BH, N, D); ``scale`` defaults to 1/sqrt(D). Both plans give a
    block 64 queries, 16 a warp (A fragments from global memory or from the
    block's raw rows: the same maps); they differ in the keys a loop step and
    in the passes over o's columns, each of which recomputes S and the online
    softmax. ``mask_before_max=False`` is the trap of zeroing only p for keys
    past N, after their score 0 joined the max."""
    bh, n, d = q.shape
    key_tile, cols = fwd_plan(d)
    ks, nts = d // 8, key_tile // 8
    tiles, ktiles = -(-n // TILE), -(-n // key_tile)
    rows = max(tiles * TILE, ktiles * key_tile)
    scale_log2 = LOG2E * (1.0 / math.sqrt(d) if scale is None else scale)
    qp, kp, vp = (_padded(x, rows) for x in (q, k, v))
    keep = np.ones((bh, rows, rows), bool)
    if rate > 0.0:
        keep[:, :n, :n] = pa._keep_mask(seed, bh, n, rate, "cpu").numpy()
    hb = np.arange(bh)[:, None, None, None, None]  # batch: (bh, block, warp)
    row0 = (np.arange(tiles)[None, :, None] * TILE
            + np.arange(WARPS)[None, None, :] * 16)[..., None, None]
    qf = np.stack([qp[hb, row0 + A_ROW, kk * 8 + A_COL] for kk in range(ks)])
    query = row0 + C_ROW
    batch = qf.shape[1:-2]
    o = np.zeros((bh, rows, d))
    lse = np.zeros((bh, rows))
    for c0 in range(0, d, cols):  # one pass per `cols` columns of o
        m = np.full(batch + (32, 2), -np.inf)  # per lane and row half
        l = np.zeros(batch + (32, 2))
        acc = np.zeros((cols // 8,) + batch + (32, 4))
        for it in range(ktiles):
            k0 = it * key_tile
            kt = kp[:, None, None, k0:k0 + key_tile]
            vt = vp[:, None, None, k0:k0 + key_tile]
            s = np.zeros((nts,) + batch + (32, 4))
            for nt in range(nts):
                for kk in range(ks):
                    s[nt] = mma(s[nt], qf[kk], frag_b_rows(kt, nt * 8, kk * 8))
            key = k0 + (np.arange(nts) * 8)[:, None, None] + C_COL  # (nt, 32, 4)
            key = key[:, None, None, None]
            s = s * scale_log2
            if mask_before_max:
                s = np.where(key < n, s, -np.inf)
            local = np.stack([s[..., HALF == h].max(axis=(0, -1)) for h in (0, 1)], -1)
            m_new = quad(np.maximum(m, local), np.maximum)
            alpha = exp2_ftz(m - m_new)
            m = m_new
            l = l * alpha
            acc = acc * alpha[..., HALF]
            p = exp2_ftz(s - m[..., HALF])
            if not mask_before_max:
                p = np.where(key < n, p, 0.0)
            l = l + np.stack([p[..., HALF == h].sum(axis=(0, -1)) for h in (0, 1)], -1)
            p = np.where(keep[hb, query, key], p, 0.0)
            pv = np.zeros_like(acc)  # this tile's Pa V, then added to o's accumulator
            for nt in range(nts):
                for dt in range(cols // 8):
                    pv[dt] = mma(pv[dt], p[nt][..., C_TO_A],
                                 frag_b_cols(vt, nt * 8, c0 + dt * 8))
            acc = acc + pv
        l = quad(l, np.add)
        for dt in range(cols // 8):
            o[hb, query, c0 + dt * 8 + C_COL] = acc[dt] / (l[..., HALF] * (1.0 - rate))
        if c0 == 0:  # lanes t = 0 write it, in the first pass
            lse[hb, query] = ((m + np.log2(l)) * math.log(2.0))[..., HALF]
    return o[:, :n], lse[:, :n]


@pytest.mark.parametrize("n", [1, 17, 63, 65, 129])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_emulation_equals_the_plain_forward(n, d, rate):
    """The emulated kernel's o and lse equal the plain forward within 1e-5
    max|ref| (both float64: the index math is exact or wrong), around the
    64-key and 32-key tiles and at every head dim the kernels are compiled
    at, narrow and wide plans."""
    q, k, v, _ = _inputs(3, n, d, seed=n + d, dtype=np.float64)
    want = pa.attention_reference(q, k, v, rate, SEED)
    with np.errstate(invalid="ignore"):
        got = emulate_fwd(*(t.numpy() for t in (q, k, v)), rate, SEED)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


@pytest.mark.parametrize("d", [1, 20, 24, 48, 100, 200])
def test_padded_head_dim_emulation_equals_the_plain_forward(d):
    """A head dim the kernels are not compiled at: the wrapper's zero padding
    to the next compiled one (``kernel_head_dim``, ``pad_head_dim``), the
    emulated kernel there with the true D's scale, and o cut back to D, equal
    the plain forward at D within 1e-5 max|ref|, dropout on."""
    n, rate = 70, 0.1
    q, k, v, _ = _inputs(2, n, d, seed=d, dtype=np.float64)
    want = pa.attention_reference(q, k, v, rate, SEED)
    with np.errstate(invalid="ignore"):
        o, lse = padded_call(
            lambda *a: emulate_fwd(*a, rate, SEED, scale=1.0 / math.sqrt(d)), (q, k, v), 1)
    for g, w in zip((o, lse), want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


# --------------------------------------------------------------------------
# (c) The ragged tile's keys masked before the max
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [65, 129])
def test_row_of_negative_scores_stays_finite(n):
    """Rows whose real scores all lie below -150 in the log2 domain, with a
    last key tile of one real key and 63 zero-filled ones: masking the fake
    keys to -inf before the max keeps them finite and right. Masking only p
    after the max lets a fake score 0 become m, every real 2^(s - m) flushes to
    0, l = 0 and o = NaN: the test shows the trap is real."""
    d = 32
    rng = np.random.default_rng(n)
    k = rng.uniform(0.5, 1.5, (2, n, d))
    v = rng.standard_normal((2, n, d))
    q = rng.standard_normal((2, n, d))
    q[:, ::3] = -40.0  # every third row: q.k / sqrt(D) < -150 for every key
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    want = pa.attention_reference(q, k, v, 0.1, SEED)
    s_max = float((q[:, ::3] @ k.transpose(-1, -2)).amax()) / math.sqrt(d) * LOG2E
    assert s_max < -150.0
    with np.errstate(invalid="ignore", divide="ignore"):
        got = emulate_fwd(q.numpy(), k.numpy(), v.numpy(), 0.1, SEED)
        trap = emulate_fwd(q.numpy(), k.numpy(), v.numpy(), 0.1, SEED,
                           mask_before_max=False)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w.numpy()).max() <= 1e-5 * float(w.abs().max())
    assert np.isnan(trap[0][:, ::3]).all()
    assert np.isfinite(trap[0][:, 1::3]).all()


# --------------------------------------------------------------------------
# (d) The JAX forward against the emulated kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", [8, 20, 64, 128, 256])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_pallas_forward_matches_the_emulated_kernel(d, rate):
    """o and lse of ``_flash_fwd`` (Pallas, interpret mode, the hash mask)
    against the emulated kernel at N = 65 (a ragged last key tile), narrow
    and wide plans, D = 20 through the wrapper's padding to 32."""
    b, h, n = 1, 3, 65
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    out, res = ka._flash_fwd(rate, *(jnp.asarray(a) for a in (q, k, v)), jnp.uint32(SEED))
    jlse = np.asarray(res[4])[:, :n, 0]
    with np.errstate(invalid="ignore"):
        o, lse = padded_call(
            lambda *a: emulate_fwd(*a, rate, SEED, scale=1.0 / math.sqrt(d)),
            [torch.from_numpy(a.reshape(b * h, n, d).astype(np.float64)) for a in (q, k, v)],
            1)
    np.testing.assert_allclose(o.reshape(b, h, n, d), np.asarray(out), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse, jlse, rtol=2e-4, atol=2e-5)
