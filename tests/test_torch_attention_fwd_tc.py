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

(e) The large-D forward (``csrc/attention_fwd_large.cu``: bf16 from a padded
    D of 128 on, the head dim split over a cluster of CTAs): the three
    ``ldmatrix`` address maps on XOR-swizzled tiles read each element of a
    fragment once, without bank conflicts, and give the ``m16n8k16``
    fragments; two n8 C fragments of S are one k16 A fragment of P; a numpy
    emulation of the kernel (each CTA's columns, the partial S summed over
    the cluster in the order 0 ... C-1, the online softmax of the sum, P V a
    tile late, 64 columns at a time), in its bf16 plan and its f32 plan,
    equals the plain forward in float64 within 1e-5 max|ref| at N 1, 17, 65,
    129, padded D 128-1024 (1-8 CTAs, a ragged slice at 320), 1088 and 1344
    (192-column slices), and through the wrapper's padding; and in bf16,
    with P rounded to bf16 as the kernel and the Pallas kernel round it, the
    emulation sits closer to the Pallas forward (interpret mode) than with
    f32 P. The plan's constants (64 queries a cluster; DC 128 / 192; KT)
    are mirrored from the source: change them together.

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

from test_torch_attention_tc import (B_K_RELABELLED, B_N, C_COL, C_ROW, C_TO_A, G, LANE,
                                     SEED, T, TILE, WARPS, WIDE_ROWS, A_COL, A_ROW, _inputs,
                                     _padded, frag_b_cols, frag_b_rows, mm_tf32, mma,
                                     padded_call)

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


# --------------------------------------------------------------------------
# (e) The large-D forward (csrc/attention_fwd_large.cu), emulated in numpy
# --------------------------------------------------------------------------

# csrc/attention_fwd_large.cu: 64 queries a cluster, at most 8 CTAs a cluster;
# (DC columns a CTA, KT keys a tile) by dtype and head dim
BM, MAX_CLUSTER = 64, 8


def large_plan(dp, plan):
    """(DC, KT) of ``dispatch_large`` at padded head dim ``dp``: DC = 128
    up to 1024 and 192 above; KT bf16 64 / 32, f32 32 / 16."""
    wide = dp > 1024
    return (192 if wide else 128), {"bf16": (32 if wide else 64), "f32": (16 if wide else 32)}[plan]


def slices(dp, dc):
    """Each CTA's columns of the head dim: [r DC, min((r + 1) DC, dp))."""
    return [(c0, min(c0 + dc, dp)) for c0 in range(0, dp, dc)]


# mma.sync m16n8k16 (bf16): register i of lane (g, t) holds A[g + 8 (i & 1)][2t + 8 (i >> 1) + h]
# for its halves h; B register j holds B[2t + 8 j + h][g]; C as m16n8k8's.
H2 = np.arange(2)
A16_ROW = np.broadcast_to(G[:, None, None] + 8 * (np.arange(4)[None, :, None] & 1), (32, 4, 2))
A16_COL = 2 * T[:, None, None] + 8 * (np.arange(4)[None, :, None] >> 1) + H2
B16_K = 2 * T[:, None, None] + 8 * np.arange(2)[None, :, None] + H2
B16_N = np.broadcast_to(G[:, None, None], (32, 2, 2))


def mma16(c, a, b):
    """One warp's mma.sync m16n8k16 on per-lane fragments: c (..., 32, 4) +
    A (..., 32, 4, 2) B (..., 32, 2, 2), each rebuilt from its lane map."""
    batch = np.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    am = np.zeros(batch + (16, 16))
    am[..., A16_ROW, A16_COL] = a
    bm = np.zeros(batch + (16, 8))
    bm[..., B16_K, B16_N] = b
    return c + (am @ bm)[..., C_ROW, C_COL]


def swizzled(x, dc):
    """A tile (..., R, W) as cp.async writes it into rows of DC bf16 values:
    16-byte chunk c of row r at chunk c ^ (r & 7)."""
    out = np.zeros(x.shape[:-1] + (dc,))
    r = np.arange(x.shape[-2])[:, None]
    c = np.arange(x.shape[-1])
    out[..., r, ((c // 8) ^ (r & 7)) * 8 + c % 8] = x
    return out


def ldmatrix(tile, rows, chunks, trans=False):
    """ldmatrix.x4 (.trans) of a swizzled tile (..., R, DC): lane L gives the
    address of row rows[L], logical chunk chunks[L] (arrays (..., 32)) of
    matrix L // 8; lane (g, t) receives in register i row g, elements 2t and
    2t + 1 of matrix i (with .trans: column g, rows 2t and 2t + 1).
    -> (..., 32, 4, 2)."""
    pch = chunks ^ (rows & 7)
    mats = tile[..., rows[..., None], pch[..., None] * 8 + np.arange(8)]  # (..., 32, 8)
    mats = mats.reshape(mats.shape[:-2] + (4, 8, 8))
    i = np.arange(4)[None, :, None]
    if trans:
        return mats[..., i, 2 * T[:, None, None] + H2, G[:, None, None]]
    return mats[..., i, G[:, None, None], 2 * T[:, None, None] + H2]


# the lanes' addresses of the kernel's three ldmatrix loads (rows, chunks), each
# relative to its tile's first row and 16-byte chunk
LD_Q = (LANE & 15, LANE >> 4)                                # A of Q K^T
LD_K = ((LANE & 7) + ((LANE >> 4) << 3), (LANE >> 3) & 1)    # B of Q K^T, 2 n-tiles
LD_V = ((LANE & 7) + (((LANE >> 3) & 1) << 3), LANE >> 4)    # B of P V (.trans), 2 n-tiles


def bf16_round(x):
    """Round to bfloat16 (to nearest, ties to even), as __floats2bfloat162_rn."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).double().numpy()


def emulate_fwd_large(q, k, v, rate, seed, plan="bf16", scale=None, round_p=None):
    """(o, lse) as ``attention_fwd_large_kernel`` computes them, CTA by CTA
    of each cluster and warp by warp, from numpy inputs (BH, N, Dp) in
    float64: each CTA's partial S over its columns (bf16 plan: m16n8k16 with
    A and B by ldmatrix from swizzled tiles; f32 plan: m16n8k8 with the k
    index relabelled, slot t column 2t and slot t + 4 column 2t + 1), the
    partials summed in the order 0 ... C-1, the online softmax of the
    summed tile (quad max and sum, keys >= N masked before the max), P as
    m16n8k16 A fragments from two n8 C fragments (bf16 plan; rounded to
    bf16 when ``round_p``, by default in the bf16 plan) or relabelled
    m16n8k8 ones (f32 plan), and each CTA's P V over its columns, 64 at a
    time in a fresh fragment added to o's accumulator, a tile late (while
    the next tile's partials cross the cluster, after which the online
    softmax rescales it)."""
    if round_p is None:
        round_p = plan == "bf16"
    bh, n, dp = q.shape
    dc, kt = large_plan(dp, plan)
    nts = kt // 8
    tiles, ktiles = -(-n // BM), -(-n // kt)
    rows = max(tiles * BM, ktiles * kt)
    scale_log2 = LOG2E * (1.0 / math.sqrt(dp) if scale is None else scale)
    qp, kp, vp = (_padded(x, rows) for x in (q, k, v))
    keep = np.ones((bh, rows, rows), bool)
    if rate > 0.0:
        keep[:, :n, :n] = pa._keep_mask(seed, bh, n, rate, "cpu").numpy()
    hb = np.arange(bh)[:, None, None, None, None]  # batch: (bh, q tile, warp, lane, reg)
    r0 = np.arange(WARPS)[:, None] * 16             # each warp's first row in the tile
    row0 = (np.arange(tiles)[:, None, None] * BM + r0[None])[..., None]
    query = row0 + C_ROW
    qt = qp[:, :tiles * BM].reshape(bh, tiles, BM, dp)  # each cluster's queries
    batch = (bh, tiles, WARPS)
    m = np.full(batch + (32, 2), -np.inf)
    l = np.zeros(batch + (32, 2))
    acc = np.zeros((dp // 8,) + batch + (32, 4))  # o: n-tiles of 8 columns, all CTAs
    ctas = slices(dp, dc)

    def pv_into(acc, p, vt_):
        """acc += P V of one key tile, CTA by CTA, 64 columns at a time in a
        fresh fragment."""
        for c0, c1 in ctas:
            for ch in range(c0, c1, 64):
                pv = np.zeros((8,) + batch + (32, 4))
                if plan == "bf16":
                    vs = swizzled(vt_[..., c0:c1], dc)[:, :, None]
                    for kj in range(nts // 2):  # k-steps of 16 keys
                        pa16 = np.stack([p[2 * kj][..., 0:2], p[2 * kj][..., 2:4],
                                         p[2 * kj + 1][..., 0:2], p[2 * kj + 1][..., 2:4]], -2)
                        for np_ in range(4):
                            b = ldmatrix(vs, kj * 16 + LD_V[0],
                                         (ch - c0) // 8 + np_ * 2 + LD_V[1], trans=True)
                            pv[2 * np_] = mma16(pv[2 * np_], pa16, b[..., :2, :])
                            pv[2 * np_ + 1] = mma16(pv[2 * np_ + 1], pa16, b[..., 2:, :])
                else:
                    for nt in range(nts):  # k-steps of 8 keys, k relabelled
                        for j in range(8):
                            pv[j] = mma(pv[j], p[nt][..., C_TO_A],
                                        frag_b_cols(vt_[:, :, None], nt * 8, ch + j * 8))
                acc[ch // 8:ch // 8 + 8] += pv
        return acc

    prev = None  # the previous tile's (P, v tile): its P V runs during the next exchange
    for it in range(ktiles):
        k0 = it * kt
        kt_, vt_ = kp[:, None, k0:k0 + kt], vp[:, None, k0:k0 + kt]  # (bh, 1, KT, dp)
        parts = []
        for c0, c1 in ctas:
            s = np.zeros((nts,) + batch + (32, 4))
            if plan == "bf16":
                qs = swizzled(qt[..., c0:c1], dc)
                ks = swizzled(kt_[..., c0:c1], dc)[:, :, None]
                for c in range(0, (c1 - c0) // 8, 2):  # k-steps of 16 columns
                    a = ldmatrix(qs, r0 + LD_Q[0], c + LD_Q[1])
                    for np_ in range(nts // 2):
                        b = ldmatrix(ks, np_ * 16 + LD_K[0], c + LD_K[1])
                        s[2 * np_] = mma16(s[2 * np_], a, b[..., :2, :])
                        s[2 * np_ + 1] = mma16(s[2 * np_ + 1], a, b[..., 2:, :])
            else:
                for c in range(c0, c1, 8):  # k-steps of 8 columns, k relabelled
                    a = qt[..., r0[..., None] + A_ROW, c + B_K_RELABELLED[:, [0, 0, 1, 1]]]
                    for nt in range(nts):
                        b = kt_[:, :, None][..., nt * 8 + B_N, c + B_K_RELABELLED]
                        s[nt] = mma(s[nt], a, b)
            parts.append(s)
        if prev is not None:
            acc = pv_into(acc, *prev)
        s = parts[0]
        for part in parts[1:]:  # the cluster's sum, in the order 0 ... C-1
            s = s + part
        key = (k0 + (np.arange(nts) * 8)[:, None, None] + C_COL)[:, None, None, None]
        s = np.where(key < n, s * scale_log2, -np.inf)
        local = np.stack([s[..., HALF == h].max(axis=(0, -1)) for h in (0, 1)], -1)
        m_new = quad(np.maximum(m, local), np.maximum)
        alpha = exp2_ftz(m - m_new)
        m = m_new
        l = l * alpha
        acc = acc * alpha[..., HALF]
        p = exp2_ftz(s - m[..., HALF])
        l = l + np.stack([p[..., HALF == h].sum(axis=(0, -1)) for h in (0, 1)], -1)
        p = np.where(keep[hb, query, key], p, 0.0)
        prev = (bf16_round(p) if round_p else p, vt_)
    acc = pv_into(acc, *prev)
    l = quad(l, np.add)
    o = np.zeros((bh, rows, dp))
    for j in range(dp // 8):
        o[hb, query, j * 8 + C_COL] = acc[j] / (l[..., HALF] * (1.0 - rate))
    lse = np.zeros((bh, rows))
    lse[hb, query] = ((m + np.log2(l)) * math.log(2.0))[..., HALF]
    return o[:, :n], lse[:, :n]


@pytest.mark.parametrize("dc", [128, 192])
def test_large_ldmatrix_maps_read_each_element_once_without_bank_conflicts(dc):
    """The three ldmatrix loads of ``attention_fwd_large_kernel`` on
    swizzled tiles of DC bf16 columns: each reads 32 distinct 16-byte
    chunks (every shared element of a fragment once), each 8x8 matrix's
    rows lie in 8 distinct bank groups (no bank conflict), and the
    registers are the m16n8k16 fragments of the logical tile: A of Q
    (rows r0.., columns c..), B = K^T for two n-tiles of keys, and B = V
    for two n-tiles of columns (.trans)."""
    rng = np.random.default_rng(dc)
    x = rng.standard_normal((64, dc))
    tile = swizzled(x, dc)
    for rows, chunks in (LD_Q, LD_K, LD_V):
        for r0, c0 in ((0, 0), (16, 2), (48, dc // 8 - 2)):
            r, c = r0 + rows, c0 + chunks
            phys = r * (dc // 8) + (c ^ (r & 7))
            assert len(set(phys.tolist())) == 32
            for i in range(4):
                assert len(set((phys[8 * i:8 * i + 8] % 8).tolist())) == 8
    for r0, c in ((0, 0), (16, 4), (48, dc // 8 - 2)):
        a = ldmatrix(tile, r0 + LD_Q[0], c + LD_Q[1])
        assert np.array_equal(a, x[r0 + A16_ROW, c * 8 + A16_COL])
        b = ldmatrix(tile, r0 + LD_K[0], c + LD_K[1])  # B[k][n] = K[n][k]
        for j in range(2):
            assert np.array_equal(b[:, 2 * j:2 * j + 2], x[r0 + 8 * j + B16_N, c * 8 + B16_K])
        b = ldmatrix(tile, r0 + LD_V[0], c + LD_V[1], trans=True)  # B[k][n] = V[k][n]
        for j in range(2):
            assert np.array_equal(b[:, 2 * j:2 * j + 2], x[r0 + B16_K, c * 8 + 8 * j + B16_N])


def test_p_fragments_of_m16n8k16_are_two_c_fragments():
    """The C-to-A map of P without a shuffle: lane (g, t)'s C registers of
    n-tiles 2j and 2j + 1 (keys 16j + 2t (+1) and 16j + 8 + 2t (+1), rows g
    and g + 8) are, in the order (c0 c1), (c2 c3) of the first then of the
    second, its A registers of the k-step over keys 16j .. 16j + 15."""
    rows = np.stack([C_ROW[:, 0:2], C_ROW[:, 2:4], C_ROW[:, 0:2], C_ROW[:, 2:4]], 1)
    cols = np.stack([C_COL[:, 0:2], C_COL[:, 2:4], 8 + C_COL[:, 0:2], 8 + C_COL[:, 2:4]], 1)
    assert np.array_equal(rows, A16_ROW) and np.array_equal(cols, A16_COL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dp", [128, 256, 320, 512, 1024])
@pytest.mark.parametrize("n", [1, 17, 65, 129])
def test_large_emulation_equals_the_plain_forward(n, dp, rate):
    """The emulated large-D forward's o and lse, in both plans (bf16:
    m16n8k16 by ldmatrix; f32: relabelled m16n8k8) with P unrounded, equal
    the plain forward in float64 within 1e-5 max|ref|: one CTA a cluster at
    Dp 128, two at 256, three with a ragged last slice of 64 columns at
    320, four at 512, eight at 1024; N around the 64-query tiles and the
    64-, 32- and 16-key tiles."""
    q, k, v, _ = _inputs(2, n, dp, seed=n + dp, dtype=np.float64)
    want = pa.attention_reference(q, k, v, rate, SEED)
    for plan in ("bf16", "f32"):
        with np.errstate(invalid="ignore"):
            got = emulate_fwd_large(*(t.numpy() for t in (q, k, v)), rate, SEED, plan,
                                    round_p=False)
        for g, w in zip(got, want):
            w = w.numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, plan


@pytest.mark.parametrize("dp", [1088, 1344])
def test_large_emulation_at_the_wide_slices(dp):
    """Above 1024 the CTAs take 192 columns (C = 6 with a ragged slice of
    128 at 1088, C = 7 at the limit 1344) and shorter key tiles: both plans
    equal the plain forward within 1e-5 max|ref|, dropout on."""
    n = 40
    q, k, v, _ = _inputs(1, n, dp, seed=dp, dtype=np.float64)
    assert len(slices(dp, large_plan(dp, "bf16")[0])) <= MAX_CLUSTER
    want = pa.attention_reference(q, k, v, 0.1, SEED)
    for plan in ("bf16", "f32"):
        with np.errstate(invalid="ignore"):
            got = emulate_fwd_large(*(t.numpy() for t in (q, k, v)), 0.1, SEED, plan,
                                    round_p=False)
        for g, w in zip(got, want):
            assert np.abs(g - w.numpy()).max() <= 1e-5 * float(w.abs().max()) + 1e-12, plan


@pytest.mark.parametrize("d", [100, 200, 300])
def test_large_padded_head_dims_equal_the_plain_forward(d):
    """A head dim the kernels are not compiled at, through the wrapper's
    padding (to 128, 256, 320) and the true D's scale, the emulated large-D
    forward (bf16 plan, P unrounded) cut back to D: the plain forward at D
    within 1e-5 max|ref|, dropout on."""
    n, rate = 70, 0.1
    q, k, v, _ = _inputs(2, n, d, seed=d, dtype=np.float64)
    want = pa.attention_reference(q, k, v, rate, SEED)
    with np.errstate(invalid="ignore"):
        got = padded_call(lambda *a: emulate_fwd_large(*a, rate, SEED, "bf16",
                                                       scale=1.0 / math.sqrt(d),
                                                       round_p=False), (q, k, v), 1)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


@pytest.mark.parametrize("d", [128, 320])
def test_large_bf16_p_rounding_follows_the_pallas_kernel(d):
    """bf16 q, k, v at N = 65, rate 0.1: the Pallas forward in interpret
    mode rounds P to bf16 before P V (``p.astype(v.dtype)``). The emulated
    large-D kernel with P rounded to bf16, its o rounded to bf16, sits much
    closer to the Pallas o than the same emulation with f32 P (relative L2
    error at most a quarter of it; read: 3.0e-4 against 2.2e-3 at D 128,
    5.0e-4 against 2.2e-3 at 320, with 0.7% and 1.5% of the elements off by
    a bf16 step against 37%)."""
    b, h, n, rate = 1, 2, 65, 0.1
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out, _ = ka._flash_fwd(rate, jq, jk, jv, jnp.uint32(SEED))
    want = np.asarray(out, np.float32).reshape(b * h, n, d).astype(np.float64)
    ins = [torch.from_numpy(np.asarray(a, np.float32).reshape(b * h, n, d).astype(np.float64))
           for a in (jq, jk, jv)]
    errs = {}
    for round_p in (True, False):
        with np.errstate(invalid="ignore"):
            o, _ = padded_call(lambda *a: emulate_fwd_large(*a, rate, SEED, "bf16",
                                                            scale=1.0 / math.sqrt(d),
                                                            round_p=round_p), ins, 1)
        errs[round_p] = float(np.linalg.norm(bf16_round(o) - want) / np.linalg.norm(want))
    assert errs[True] <= 0.25 * errs[False], errs
    assert errs[True] <= 1e-3, errs
