"""The attention kernels' deep plan (head dims above 256: ``attention_fwd_deep_kernel``
in ``csrc/attention_fwd_deep.cu``, ``dkdv_deep_kernel`` and ``dq_deep_kernel`` in
``csrc/attention_bwd_deep.cu``, their tiles in ``csrc/attention_tiles.cuh``),
checked on the CPU where the kernels cannot run.

(a) The plain versions at D = 264, 320 and 512 (N = 40 and 130, rates 0 and
    0.1) against the JAX Pallas kernels in interpret mode: the forward
    (``force_pallas=True``) and (dq, dk, dv) through ``jax.vjp``, with the JAX
    suite's tolerance (rtol 2e-4, atol 2e-5). In bf16 (D = 320, N = 130, rate
    0.1) the port's plain version on bf16 operands against the Pallas kernel
    in bf16 within a relative L2 error of 3.1e-3 for o and each gradient
    (both round the outputs to bf16, the kernel p too); the f32 plain version
    on the unrounded inputs, the control, misses it.
(b) Index math: a numpy emulation of the deep plan in float64 (R = 32 rows a
    block up to D = 512, 16 above; the loop over tiles of 32 keys or queries;
    d's chunks of 64 columns; each warp's share of the score tile and of a
    chunk's columns through the ``mma.sync m16n8k8`` fragment maps; the score
    tile in shared memory read back as relabelled A fragments; the forward's
    softmax over 128 / R threads a row with partial sums; the f32 accumulators
    in shared memory) equals the plain versions in float64 within 1e-5
    max|ref|, at compiled D (320, 512, 576, 1024, the limit 1344) and padded
    ones (257, 264, 300, 1000), N around 16-, 32-row blocks and 32-row tiles.
(c) The limit: ``MAX_HEAD_DIM`` is the largest multiple of 64 at which the
    deep dK/dV block's shared memory (the kernels' byte counts, mirrored
    here) fits in a block's 227 KB; the large-D forward
    (``csrc/attention_fwd_large.cu``, which bf16 runs from a padded D of
    128 on) fits a cluster of at most 8 CTAs there.

The plan's constants (``DEEP_CHUNK``, ``DEEP_TILE``, ``DEEP_WIDE_MAX_D``,
``DEEP_ST``, the stages) are mirrored from the CUDA sources: change them
together.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops.kernels import attention as ka

from causalvae_tpu_torch.ops.kernels import attention as pa

from test_torch_attention_fwd_tc import LOG2E, exp2_ftz
from test_torch_attention_tc import (A_COL, A_ROW, B_K, B_K_RELABELLED, B_N, C_COL, C_ROW,
                                     C_TO_A, SEED, WARPS, _inputs, _padded, frag_b_cols,
                                     frag_b_rows, mma, padded_call)

# csrc/attention_tiles.cuh, attention_fwd_deep.cu, attention_bwd_deep.cu
DEEP_CHUNK, DEEP_TILE, DEEP_WIDE_MAX_D, DEEP_ST = 64, 32, 512, 40
THREADS, MAX_SMEM = 128, 232448
FWD_DEEP_STAGES, DKDV_DEEP_STAGES, DQ_DEEP_STAGES = 6, 3, 6


def deep_rows(d):
    return 32 if d <= DEEP_WIDE_MAX_D else 16


# --------------------------------------------------------------------------
# (a) The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


def _pallas_and_port(q, k, v, g, rate, dtype=np.float32):
    kw = dict(dropout_rate=rate, dropout_seed=jnp.uint32(SEED)) if rate else {}
    jargs = [jnp.asarray(a, dtype=jnp.bfloat16 if dtype != np.float32 else jnp.float32)
             for a in (q, k, v)]
    want, vjp = jax.vjp(lambda *a: ka.flash_attention(*a, force_pallas=True, **kw), *jargs)
    jgrads = vjp(jnp.asarray(g, dtype=want.dtype))
    return np.asarray(want, np.float32), [np.asarray(x, np.float32) for x in jgrads]


def _port(q, k, v, g, rate, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    pkw = dict(dropout_rate=rate, dropout_seed=SEED) if rate else {}
    out = pa.flash_attention(*ts, **pkw)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n", [40, 130])
@pytest.mark.parametrize("d", [264, 320, 512])
def test_plain_versions_match_pallas_above_256(d, n, rate):
    """o and (dq, dk, dv) of the port's autograd Function on the CPU (the
    plain versions, through the wrapper) against ``jax.vjp`` of the Pallas
    kernels in interpret mode, f32."""
    rng = np.random.default_rng(d + n)
    q, k, v, g = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(4))
    want, want_grads = _pallas_and_port(q, k, v, g, rate)
    got, grads = _port(q, k, v, g, rate)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for a, w in zip(grads, want_grads):
        np.testing.assert_allclose(a, w, rtol=2e-4, atol=2e-5)


def test_plain_versions_match_pallas_in_bf16_with_an_f32_control():
    """D = 320, N = 130, rate 0.1 in bf16: the port's plain versions on bf16
    q, k, v (f32 accumulation, bf16 outputs) against the Pallas kernels in
    bf16, o and each gradient within a relative L2 error of 3.1e-3 (read:
    2.3e-3 to 2.7e-3); the f32 plain versions on the unrounded inputs, the
    control, miss it (read: 3.6e-3 to 4.3e-3): the bound sees the inputs'
    bf16 rounding, which both bf16 sides share. A max-error rule cannot
    tell the two apart: the outputs' own bf16 rounding (2^-9) dominates it."""
    d, n, rate = 320, 130, 0.1
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(4))
    want, want_grads = _pallas_and_port(q, k, v, g, rate, dtype=jnp.bfloat16)

    def worst(got, grads):
        return max(float(np.linalg.norm(a - w) / np.linalg.norm(w))
                   for a, w in zip([got] + grads, [want] + want_grads))

    assert worst(*_port(q, k, v, g, rate, torch.bfloat16)) <= 3.1e-3
    assert worst(*_port(q, k, v, g, rate)) > 3.1e-3


# --------------------------------------------------------------------------
# (b) The deep plan's loops, emulated in numpy
# --------------------------------------------------------------------------

# frag_a_pairs: slot t holds column 2t, slot t + 4 column 2t + 1 (a C fragment's order)
PAIR_ROW, PAIR_COL = C_ROW[:, C_TO_A], C_COL[:, C_TO_A]


def frag_a(x, r0, k0):
    """A fragment of rows r0 + g (+ 8), columns k0 + t (+ 4) of raw rows."""
    return x[..., r0 + A_ROW, k0 + A_COL]


def frag_a_pairs(x, r0, k0):
    return x[..., r0 + PAIR_ROW, k0 + PAIR_COL]


def warps(d):
    """Each warp's (first row, first column of its share of the score tile,
    first column of its share of a chunk) in a block of ``deep_rows(d)``
    rows: R / 16 row groups, 4 / (R / 16) warps a row group."""
    rg = deep_rows(d) // 16
    return [((w % rg) * 16, (w // rg) * rg * 8, (w // rg) * 2 * rg * 8) for w in range(WARPS)]


def deep_scores(a, b, r0, n0, nt):
    """``deep_scores``: nt C fragments of A B^T over one chunk's 64 columns,
    its two halves of 32 in two accumulators, then added."""
    part = np.zeros((2, nt) + np.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (32, 4))
    for kk in range(DEEP_CHUNK // 16):
        for h in range(2):
            k0 = h * DEEP_CHUNK // 2 + kk * 8
            fa = frag_a(a, r0, k0)
            for j in range(nt):
                part[h, j] = mma(part[h, j], fa, frag_b_rows(b, n0 + j * 8, k0))
    return part[0] + part[1]


def deep_tile_product(tile, b, r0, c0, nc):
    """``deep_tile_product``: nc C fragments of (score tile rows) x (chunk)."""
    acc = np.zeros((nc,) + np.broadcast_shapes(tile.shape[:-2], b.shape[:-2]) + (32, 4))
    for kk in range(DEEP_TILE // 8):
        fa = frag_a_pairs(tile, r0, kk * 8)
        for j in range(nc):
            acc[j] = mma(acc[j], fa, frag_b_cols(b, kk * 8, c0 + j * 8))
    return acc


def _chunk(x, c):
    return x[..., c * DEEP_CHUNK:(c + 1) * DEEP_CHUNK]


def _keep(bh, n, rows, rate, seed):
    keep = np.ones((bh, rows, rows), bool)
    if rate > 0.0:
        keep[:, :n, :n] = pa._keep_mask(seed, bh, n, rate, "cpu").numpy()
    return keep


def emulate_fwd_deep(q, k, v, rate, seed, scale=None):
    """(o, lse) as ``attention_fwd_deep_kernel`` computes them from float64
    numpy (BH, N, D), D a multiple of 64 above 256."""
    bh, n, d = q.shape
    r, c_n = deep_rows(d), d // DEEP_CHUNK
    rg, tpr = r // 16, THREADS // r
    blocks, ktiles = -(-n // r), -(-n // DEEP_TILE)
    rows = max(blocks * r, ktiles * DEEP_TILE)
    scale_log2 = LOG2E * (1.0 / math.sqrt(d) if scale is None else scale)
    qp, kp, vp = (_padded(x, rows) for x in (q, k, v))
    keep = _keep(bh, n, rows, rate, seed)
    qb = qp[:, :blocks * r].reshape(bh, blocks, r, d)  # each block's resident q rows
    query = (np.arange(blocks)[:, None] * r + np.arange(r))[None, :, :, None]
    hb = np.arange(bh)[:, None, None, None]
    acc = np.zeros((bh, blocks, r, d))
    m = np.full((bh, blocks, r), -np.inf)
    l = np.zeros((bh, blocks, r, tpr))  # a softmax thread's partial sum
    for it in range(ktiles):
        k0 = it * DEEP_TILE
        kt, vt = kp[:, None, k0:k0 + DEEP_TILE], vp[:, None, k0:k0 + DEEP_TILE]
        sp = np.zeros((bh, blocks, r, DEEP_TILE))
        for r0, n0, _ in warps(d):
            sc = sum(deep_scores(_chunk(qb, c), _chunk(kt, c), r0, n0, rg) for c in range(c_n))
            for j in range(rg):
                key = n0 + j * 8 + C_COL
                sp[..., r0 + C_ROW, key] = np.where(k0 + key < n, sc[j] * scale_log2, -np.inf)
        s = sp.reshape(bh, blocks, r, tpr, DEEP_TILE // tpr)  # thread (row, part), its keys
        mx = np.maximum(m, s.max(axis=(-1, -2)))
        alpha = exp2_ftz(m - mx)
        m = mx
        p = exp2_ftz(s - mx[..., None, None])
        l = l * alpha[..., None] + p.sum(-1)
        p = np.where(keep[hb, query, k0 + np.arange(DEEP_TILE)], p.reshape(sp.shape), 0.0)
        for c in range(c_n):
            for r0, _, c0 in warps(d):
                pv = deep_tile_product(p, _chunk(vt, c), r0, c0, 2 * rg)
                for j in range(2 * rg):
                    rsel, csel = r0 + C_ROW, c * DEEP_CHUNK + c0 + j * 8 + C_COL
                    acc[..., rsel, csel] = acc[..., rsel, csel] * alpha[..., rsel] + pv[j]
    lsum = l.sum(-1)
    o = acc / (lsum * (1.0 - rate))[..., None]
    lse = (m + np.log2(lsum)) * math.log(2.0)
    return o.reshape(bh, -1, d)[:, :n], lse.reshape(bh, -1)[:, :n]


def emulate_bwd_deep(q, k, v, o, lse, do, rate, seed, scale=None):
    """(dq, dk, dv) as delta_kernel, ``dkdv_deep_kernel`` and
    ``dq_deep_kernel`` compute them from float64 numpy inputs."""
    bh, n, d = q.shape
    r, c_n = deep_rows(d), d // DEEP_CHUNK
    rg = r // 16
    blocks, tiles = -(-n // r), -(-n // DEEP_TILE)
    rows = max(blocks * r, tiles * DEEP_TILE)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scale_log2 = scale * LOG2E
    qp, kp, vp, dop = (_padded(x, rows) for x in (q, k, v, do))
    lsep, deltap = _padded(lse, rows), _padded((do * o).sum(-1), rows)
    keep = _keep(bh, n, rows, rate, seed)
    inv_keep = 1.0 / (1.0 - rate)
    hb = np.arange(bh)[:, None, None, None]
    own = np.arange(blocks)[None, :, None, None] * r  # a block's first row

    def blocked(x):
        return x[:, :blocks * r].reshape(bh, blocks, r, d)

    # dkdv: blocks own r keys, the loop over tiles of 32 queries
    kb, vb = blocked(kp), blocked(vp)
    acck, accv = np.zeros((bh, blocks, r, d)), np.zeros((bh, blocks, r, d))
    for it in range(tiles):
        q0 = it * DEEP_TILE
        qt, dot = qp[:, None, q0:q0 + DEEP_TILE], dop[:, None, q0:q0 + DEEP_TILE]
        pds, dss = np.zeros((bh, blocks, r, DEEP_TILE)), np.zeros((bh, blocks, r, DEEP_TILE))
        for r0, n0, _ in warps(d):
            sc = sum(deep_scores(_chunk(kb, c), _chunk(qt, c), r0, n0, rg) for c in range(c_n))
            dp = sum(deep_scores(_chunk(vb, c), _chunk(dot, c), r0, n0, rg) for c in range(c_n))
            for j in range(rg):
                ql = n0 + j * 8 + C_COL
                qg = q0 + ql
                p = np.where(qg < n, exp2_ftz(sc[j] * scale_log2 - lsep[:, qg][:, None] * LOG2E),
                             0.0)
                kept = keep[hb, qg, own + r0 + C_ROW]
                dpv = np.where(kept, dp[j] * inv_keep, 0.0)
                pds[..., r0 + C_ROW, ql] = np.where(kept, p * inv_keep, 0.0)
                dss[..., r0 + C_ROW, ql] = p * (dpv - deltap[:, qg][:, None])
        for c in range(c_n):
            for r0, _, c0 in warps(d):
                fv = deep_tile_product(pds, _chunk(dot, c), r0, c0, 2 * rg)
                fk = deep_tile_product(dss, _chunk(qt, c), r0, c0, 2 * rg)
                for j in range(2 * rg):
                    rsel, csel = r0 + C_ROW, c * DEEP_CHUNK + c0 + j * 8 + C_COL
                    accv[..., rsel, csel] += fv[j]
                    acck[..., rsel, csel] += fk[j]
    dk, dv = acck * scale, accv

    # dq: blocks own r queries, the loop over tiles of 32 keys
    qb, ob = blocked(qp), blocked(dop)
    accq = np.zeros((bh, blocks, r, d))
    for it in range(tiles):
        k0 = it * DEEP_TILE
        kt, vt = kp[:, None, k0:k0 + DEEP_TILE], vp[:, None, k0:k0 + DEEP_TILE]
        dss = np.zeros((bh, blocks, r, DEEP_TILE))
        for r0, n0, _ in warps(d):
            sc = sum(deep_scores(_chunk(qb, c), _chunk(kt, c), r0, n0, rg) for c in range(c_n))
            dp = sum(deep_scores(_chunk(ob, c), _chunk(vt, c), r0, n0, rg) for c in range(c_n))
            row = own + r0 + C_ROW
            for j in range(rg):
                kl = n0 + j * 8 + C_COL
                key = k0 + kl
                p = np.where(key < n, exp2_ftz(sc[j] * scale_log2 - lsep[hb, row] * LOG2E), 0.0)
                dpv = np.where(keep[hb, row, key], dp[j] * inv_keep, 0.0)
                dss[..., r0 + C_ROW, kl] = p * (dpv - deltap[hb, row])
        for c in range(c_n):
            for r0, _, c0 in warps(d):
                f = deep_tile_product(dss, _chunk(kt, c), r0, c0, 2 * rg)
                for j in range(2 * rg):
                    accq[..., r0 + C_ROW, c * DEEP_CHUNK + c0 + j * 8 + C_COL] += f[j]
    dq = accq * scale
    return tuple(x.reshape(bh, -1, d)[:, :n] for x in (dq, dk, dv))


def _hold(got, want):
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


@pytest.mark.parametrize("n,d", [(1, 320), (33, 320), (65, 512), (17, 576), (33, 1024),
                                 (40, 1344)])
def test_deep_emulation_equals_the_plain_versions(n, d):
    """Dropout on (rate 0.1): the emulated deep forward's o and lse and the
    emulated deep backward's dq, dk, dv (from the plain forward's o and lse)
    equal the plain versions within 1e-5 max|ref|, both float64: R = 32 at
    D 320 and 512, 16 at 576, 1024 and the limit 1344; N = 1, a block of 16
    and one past it, one past a 32-row tile and block, two 32-row blocks
    and one past them."""
    rate = 0.1
    q, k, v, do = _inputs(2, n, d, seed=n + d, dtype=np.float64)
    want_fwd = pa.attention_reference(q, k, v, rate, SEED)
    with np.errstate(invalid="ignore"):
        _hold(emulate_fwd_deep(*(t.numpy() for t in (q, k, v)), rate, SEED), want_fwd)
    o, lse = want_fwd
    want = pa.attention_bwd_reference(q, k, v, o, lse, do, rate, SEED)
    _hold(emulate_bwd_deep(*(t.numpy() for t in (q, k, v, o, lse, do)), rate, SEED), want)


@pytest.mark.parametrize("d", [257, 264, 300, 1000])
def test_padded_deep_head_dims_equal_the_plain_versions(d):
    """A head dim above 256 that is no multiple of 64: the wrapper's zero
    padding to the next one (``kernel_head_dim``), the emulated deep kernels
    there with the true D's scale, the outputs cut back to D, rate 0 for the
    forward and 0.1 for the backward."""
    n = 40
    q, k, v, do = _inputs(1, n, d, seed=d, dtype=np.float64)
    assert pa.kernel_head_dim(d) == -(-d // 64) * 64
    scale = 1.0 / math.sqrt(d)
    with np.errstate(invalid="ignore"):
        got = padded_call(lambda *a: emulate_fwd_deep(*a, 0.0, 0, scale=scale), (q, k, v), 1)
    _hold(got, pa.attention_reference(q, k, v))
    o, lse = pa.attention_reference(q, k, v, 0.1, SEED)
    got = padded_call(lambda *a: emulate_bwd_deep(*a, 0.1, SEED, scale=scale),
                      (q, k, v, o, lse, do), 3)
    _hold(got, pa.attention_bwd_reference(q, k, v, o, lse, do, 0.1, SEED))


def test_deep_emulation_matches_pallas_at_512():
    """The Pallas forward's o and lse and its backward through ``jax.vjp``
    (interpret mode, rate 0.1, N = 65) against the emulated deep kernels at
    D = 512, the backward from the Pallas forward's o and lse: rtol 2e-4,
    atol 2e-5."""
    b, h, n, d, rate = 1, 1, 65, 512, 0.1
    rng = np.random.default_rng(d)
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, res = ka._flash_fwd(rate, jq, jk, jv, jnp.uint32(SEED))
    jlse = np.asarray(res[4])[:, :n, 0].astype(np.float64)
    flat = [a.reshape(b * h, n, d).astype(np.float64) for a in (q, k, v)]
    with np.errstate(invalid="ignore"):
        o, lse = emulate_fwd_deep(*flat, rate, SEED)
    np.testing.assert_allclose(o.reshape(b, h, n, d), np.asarray(out), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse, jlse, rtol=2e-4, atol=2e-5)
    _, vjp = jax.vjp(lambda *a: ka.flash_attention(
        *a, force_pallas=True, dropout_rate=rate, dropout_seed=jnp.uint32(SEED)), jq, jk, jv)
    want = vjp(jnp.asarray(g))
    jo = np.asarray(out).reshape(b * h, n, d).astype(np.float64)
    got = emulate_bwd_deep(*flat, jo, jlse, g.reshape(b * h, n, d).astype(np.float64), rate,
                           SEED)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.reshape(b, h, n, d), np.asarray(w), rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# (c) The limit
# --------------------------------------------------------------------------


def chunk_bytes(elt):
    return DEEP_TILE * (DEEP_CHUNK + 16 // elt) * elt


def deep_bytes(d, elt):
    """Dynamic shared memory of the three deep kernels at head dim d
    (``fwd_deep_bytes``, ``dkdv_deep_bytes``, ``dq_deep_bytes``)."""
    r = deep_rows(d)
    return {"fwd": r * (d + 16 // elt) * elt + r * (d + 8) * 4
            + FWD_DEEP_STAGES * chunk_bytes(elt) + r * DEEP_ST * 4 + r * 4,
            "dkdv": 2 * r * (d + 8) * 4 + DKDV_DEEP_STAGES * 2 * chunk_bytes(elt)
            + 2 * r * DEEP_ST * 4,
            "dq": r * (d + 8) * 4 + DQ_DEEP_STAGES * 2 * chunk_bytes(elt) + r * DEEP_ST * 4}


def test_the_limit_is_where_shared_memory_binds():
    """Every deep head dim up to ``MAX_HEAD_DIM`` fits each kernel's block in
    227 KB in f32 and bf16; the next multiple of 64 does not fit the dK/dV
    block in f32; the wrapper pads up to the limit and raises past it,
    naming it and the reason."""
    assert pa.DEEP_CHUNK == DEEP_CHUNK and pa.MAX_HEAD_DIM % DEEP_CHUNK == 0
    for d in range(320, pa.MAX_HEAD_DIM + 1, DEEP_CHUNK):
        for elt in (4, 2):
            assert max(deep_bytes(d, elt).values()) <= MAX_SMEM, (d, elt)
    assert deep_bytes(pa.MAX_HEAD_DIM + DEEP_CHUNK, 4)["dkdv"] > MAX_SMEM
    assert pa.kernel_head_dim(pa.MAX_HEAD_DIM - 63) == pa.MAX_HEAD_DIM
    with pytest.raises(ValueError, match=f"1..{pa.MAX_HEAD_DIM} .*shared memory"):
        pa.kernel_head_dim(pa.MAX_HEAD_DIM + 1)


def large_bytes(dc, kt, elt, cluster):
    """Dynamic shared memory of ``attention_fwd_large_kernel`` (``LargePlan``):
    f32 the q, k and transposed v planes of (hi, lo) pairs and a raw k and v
    tile; bf16 q and two ring stages each of k and v; with a cluster, two
    partial score tiles."""
    ops = ((64 * (dc + 8) + kt * (dc + 8) + dc * (kt + 8)) * 8 + 2 * kt * (dc + 4) * 4
           if elt == 4 else (64 + 4 * kt) * dc * 2)
    return ops + (2 * 64 * kt * 4 if cluster else 0)


def test_the_large_forward_fits_at_every_head_dim():
    """``csrc/attention_fwd_large.cu`` at every padded head dim from 128 to
    ``MAX_HEAD_DIM``: a cluster of at most 8 CTAs (the portable size; DC =
    128 up to 1024, 192 above), each CTA's shared memory within a block's
    227 KB in f32 and bf16, and in bf16 at DC = 128 two CTAs an SM (the
    SM's 228 KB, 1 KB of it reserved a block)."""
    from test_torch_attention_fwd_tc import MAX_CLUSTER, large_plan, slices

    for dp in range(128, pa.MAX_HEAD_DIM + 1, 64):
        for plan, elt in (("f32", 4), ("bf16", 2)):
            dc, kt = large_plan(dp, plan)
            c = len(slices(dp, dc))
            assert c <= MAX_CLUSTER, (dp, plan)
            assert large_bytes(dc, kt, elt, c > 1) <= MAX_SMEM, (dp, plan)
    assert 2 * (large_bytes(128, 64, 2, True) + 1024) <= 228 * 1024
