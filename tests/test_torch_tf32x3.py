"""The accuracy argument of the fp32 attention kernels' products
(``csrc/tf32x3.cuh``), checked in numpy on the CPU.

The fp32 instantiations of K1, K3 and K4 run every product on the tensor
cores as 3xTF32: each fp32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi) (``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, to 10 mantissa bits), and a product accumulates lo_a hi_b + hi_a lo_b
+ hi_a hi_b in fp32.  A numpy model of that (the split bit for bit; each
8-deep mma step's products summed exactly and added to an fp32 accumulator
with one rounding, the hi-hi products in one accumulator and the cross
terms in another, as the kernels keep them) is held to the fp64 product at
K1's tile shapes (a warp's 16 rows of Q against a 64-row K tile at D 64
and 128; P of 16 rows over a 64-key tile against V) within 1e-5 of max
|fp64|, the kernels' tolerance on the card; one TF32 product alone misses
that (those shapes are the mma.sync design's, K3's still).  The hardware
adds of the tensor cores truncate where that model rounds: that is why
the kernels keep each tile's product in accumulators of its own (the card
tests hold the kernels themselves at 1e-5).  The second part models K1's
and K4's wgmma kernels: their tiles (64 rows, 8-deep steps, 32-row kv or q
tiles, D 64 and 128) with truncating adds, a row of 3,072 keys summed tile
by tile, the transposed tile whose 8-row blocks are permuted so that an
accumulator is the next product's A fragment, and the swizzled addressing
of the converters and of K4's fragment reads.
"""

import numpy as np
import pytest

TOL = 1e-5


def tf32(x):
    """``cvt.rna.tf32.f32``: fp32 to 10 mantissa bits, nearest, ties away
    from zero (the low 13 bits of the pattern cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_chain(a_parts, b_parts):
    """sum over the k axis of a (M x K) . b (K x N), 8 k at a time: each
    step's products exactly (fp64), added to an fp32 accumulator; one
    accumulator per list of (a, b) part pairs, summed in fp32 at the end."""
    M, K = a_parts[0][0].shape
    N = b_parts[0][1].shape[1]
    total = np.zeros((M, N), np.float32)
    for pairs in (a_parts, b_parts):
        acc = np.zeros((M, N), np.float32)
        for k0 in range(0, K, 8):
            step = sum(a[:, k0:k0 + 8].astype(np.float64)
                       @ b[k0:k0 + 8].astype(np.float64) for a, b in pairs)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
        total = total + acc
    return total


def product_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return mma_chain([(ah, bh)], [(al, bh), (ah, bl)])


def product_tf32(a, b):
    return mma_chain([(tf32(a), tf32(b))], [(np.zeros_like(a),
                                             np.zeros_like(b))])


def _rel(got, want):
    return np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()


def _operands(name, rng):
    """(A, B) of one of K1's tile products, fp32."""
    if name.startswith("qk"):
        D = int(name[4:])
        q = rng.normal(size=(16, D)).astype(np.float32)
        k = rng.normal(size=(64, D)).astype(np.float32)
        return q, k.T.copy()  # S = Q K^T
    s = rng.normal(size=(16, 64)) * 128 ** -0.5 * 11.0
    p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
    v = rng.normal(size=(64, 128)).astype(np.float32)
    return p, v  # O = P V (before the 1 / l)


@pytest.mark.parametrize("name", ["qk_d64", "qk_d128", "pv_d128"])
def test_3xtf32_holds_fp32_accuracy_where_tf32_misses(name):
    rng = np.random.default_rng(len(name) + 27)
    a, b = _operands(name, rng)
    want = a.astype(np.float64) @ b.astype(np.float64)
    three = _rel(product_3xtf32(a, b), want)
    one = _rel(product_tf32(a, b), want)
    plain = _rel((a @ b).astype(np.float32), want)  # fp32 FMA
    assert three <= TOL, three
    assert one > TOL, one
    assert three < one / 50
    assert plain <= TOL


def test_split_is_exact_to_2_to_the_minus_21():
    """hi + lo equals x within 2^-21 of |x| (lo keeps 11 of the 13 bits hi
    drops), with hi and lo each a tf32 value and the rounding ties away from
    zero."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(
        np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0 ** -21
    assert tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)
    assert tf32(np.float32(-(1 + 2 ** -11))) == np.float32(-(1 + 2 ** -10))


# ------------------------------------------------------------------ wgmma
# K1's and K4's fp32 kernels run the same 3xTF32 products on wgmma: m64nNk8
# tiles (64 rows, 8-deep steps), 32-row kv (K1) or q (K4) tiles, each
# operand split once and each tile's product from zero, added to the running
# sum in fp32.  The tensor cores' adds truncate: the model below truncates
# each step's add toward zero, as the card does, where the one above rounds.


def kpos(r):
    """Position of row r of an 8-row block in a transposed tile's k order
    (``tf32x3::kpos``): 0, 2, 4, 6, 1, 3, 5, 7 in that order."""
    r = np.asarray(r)
    return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2)


def trunc32(x):
    """fp64 to fp32 toward zero (the tensor cores' add)."""
    r = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def wgmma_chain(pairs, acc=None):
    """One accumulator over the k axis of A (M x K) . B (K x N) for each
    (A, B) pair in turn, 8 k a wgmma step: each step's products summed
    exactly and added to the fp32 accumulator with truncation."""
    M, K = pairs[0][0].shape
    N = pairs[0][1].shape[1]
    acc = np.zeros((M, N), np.float32) if acc is None else acc
    for k0 in range(0, K, 8):
        for a, b in pairs:
            step = (a[:, k0:k0 + 8].astype(np.float64)
                    @ b[k0:k0 + 8].astype(np.float64))
            acc = trunc32(acc.astype(np.float64) + step)
    return acc


def tile_3xtf32(a, b):
    """A tile's product as the wgmma kernels form it: the hi-hi chain from
    zero, the two cross terms in an accumulator of their own, summed in
    fp32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return wgmma_chain([(ah, bh)]) + wgmma_chain([(al, bh), (ah, bl)])


@pytest.mark.parametrize("name,M,K,N", [
    ("k1_s_d64", 64, 64, 32),      # S = Q K^T: 64 q rows, D 64, 32 keys
    ("k1_s_d128", 64, 128, 32),    # the same at D 128
    ("k1_pv_d128", 64, 32, 128),   # P V: 32 keys deep, D 128 wide
    ("k4_dv_d128", 64, 32, 64),    # dV^T = dO^T P: 64 d rows, 32 q deep
    ("k4_dv_d64", 64, 32, 32),     # D 64: one 32-column kv chunk
])
def test_wgmma_tiles_hold_fp32_accuracy(name, M, K, N):
    """Each tile product of the redesigned kernels, at their shapes, with
    truncating adds: within 1e-5 of max |fp64|, where one tf32 product
    misses."""
    rng = np.random.default_rng(M + K + N + len(name))

    def probs(rows, cols):  # softmax numerators of scaled scores
        s = rng.normal(size=(rows, cols)) * 11.0 / np.sqrt(128)
        return np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
    if name.startswith("k1_pv"):  # A = P, B = V
        a, b = probs(M, K), rng.normal(size=(K, N)).astype(np.float32)
    elif name.startswith("k4_dv"):  # A = dO^T, B = P (q x kv)
        a, b = rng.normal(size=(M, K)).astype(np.float32), probs(K, N)
    else:  # A = Q, B = K^T
        a = rng.normal(size=(M, K)).astype(np.float32)
        b = rng.normal(size=(K, N)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(tile_3xtf32(a, b), want) <= TOL
    assert _rel(wgmma_chain([(tf32(a), tf32(b))]), want) > TOL


@pytest.mark.parametrize("D", [64, 128])
def test_k1_row_of_tiles_keeps_1e5_with_truncating_adds(D):
    """O of 64 q rows over 3,072 keys in 32-key tiles: each tile's P.V from
    zero (hi-hi and cross terms apart) added to O in fp32 holds 1e-5 of
    max |O| under the tensor cores' truncation, far inside what one chain
    over every tile keeps."""
    rng = np.random.default_rng(D)
    S, BN = 3072, 32
    s = rng.normal(size=(64, S)) * 2.0
    p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
    v = rng.normal(size=(S, D)).astype(np.float32)
    o = np.zeros((64, D), np.float32)
    for k0 in range(0, S, BN):
        o = o + tile_3xtf32(p[:, k0:k0 + BN], v[k0:k0 + BN])
    want = p.astype(np.float64) @ v.astype(np.float64)
    tiles = _rel(o, want)
    one_chain = _rel(tile_3xtf32(p, v), want)
    assert tiles <= TOL, tiles
    assert tiles < one_chain / 10, (tiles, one_chain)


def sw128_f32(row, col):
    """``tf32x3::sw128_f32``: byte offset of fp32 element (row, col) in a
    32-column TMA box written with the 128-byte swizzle."""
    return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4


@pytest.mark.parametrize("D", [64, 128])
def test_swizzled_tiles_and_fragment_reads_address_each_element_once(D):
    """The address arithmetic of the converters and of K4's hand-read A
    fragments, copied from the kernels: a swizzled box keeps each row in
    its 128 bytes, one word an element; the transposed tile puts element
    (r, d) of a 32-row tile at row d, k position kpos(r), one word each;
    and K4's fragment reads of dO^T / Q^T (thread (warp w, lane 4g + t),
    a0 (d 16w + g, q t), a1 (d + 8), a2 (q + 4), a3 (both), one offset a
    thread and a fragment plus 1,024 bytes a k step and two boxes a d
    block) reach each element of the [D/32 boxes][32 q][128 B] row tile
    once, at the (d, q) wgmma's A layout names."""
    for rows in (32, 64):
        offs = sw128_f32(np.arange(rows)[:, None], np.arange(32)[None, :])
        assert sorted(offs.ravel()) == list(range(0, rows * 128, 4))
        assert (offs // 128 == np.arange(rows)[:, None]).all()
    r, d = np.meshgrid(np.arange(32), np.arange(D), indexing="ij")
    offs = sw128_f32(d, kpos(r))
    assert sorted(offs.ravel()) == list(range(0, D * 128, 4))
    order = np.argsort(kpos(np.arange(8)))  # the rows in k order
    assert list(order) == [0, 2, 4, 6, 1, 3, 5, 7]
    BQ = 32
    seen = []
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for i in range(4):
                    dd, q = 16 * w + g + (i & 1) * 8, t + (i >> 1) * 4
                    a_off = (dd // 32) * BQ * 128 + sw128_f32(q, dd % 32)
                    for m in range(D // 64):
                        for kk in range(BQ // 8):
                            want_d, want_q = 64 * m + dd, 8 * kk + q
                            addr = a_off + m * 2 * BQ * 128 + kk * 1024
                            assert addr == (want_d // 32) * BQ * 128 \
                                + sw128_f32(want_q, want_d % 32)
                            seen.append(addr)
    assert sorted(seen) == list(range(0, BQ * D * 4, 4))


def _a_fragments_from_acc(c):
    """The logical A matrix (64 x 8 k) that wgmma reads when each thread
    passes its accumulator's 4 floats of 8 columns of c (64 x 8) as
    (c0, c2, c1, c3): thread (warp w, lane 4g + t) holds c0 (16w + g, 2t),
    c1 (16w + g, 2t + 1), c2 (16w + g + 8, 2t), c3 (16w + g + 8, 2t + 1),
    and wgmma reads a0 (16w + g, k t), a1 (16w + g + 8, t), a2 (16w + g,
    t + 4), a3 (16w + g + 8, t + 4)."""
    a = np.zeros((64, 8), c.dtype)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                r = 16 * w + g
                c0, c1 = c[r, 2 * t], c[r, 2 * t + 1]
                c2, c3 = c[r + 8, 2 * t], c[r + 8, 2 * t + 1]
                a0, a1, a2, a3 = c0, c2, c1, c3
                a[r, t], a[r + 8, t], a[r, t + 4], a[r + 8, t + 4] = (
                    a0, a1, a2, a3)
    return a


@pytest.mark.parametrize("BN,D", [(32, 64), (32, 128), (64, 128)])
def test_permuted_transposed_tile_gives_the_product(BN, D):
    """P (64 x BN, an accumulator) as the register A operand, 8 columns a
    step, against V^T written with each 8-row block of V in the order
    0, 2, 4, 6, 1, 3, 5, 7 (``kpos``): the product is P V."""
    rng = np.random.default_rng(BN + D)
    p = rng.normal(size=(64, BN))
    v = rng.normal(size=(BN, D))
    vt = np.zeros((D, BN))  # the transposed tile: row d, k position kpos(r)
    vt[:, kpos(np.arange(BN))] = v.T
    got = np.zeros((64, D))
    for k0 in range(0, BN, 8):
        a = _a_fragments_from_acc(p[:, k0:k0 + 8])
        b = vt[:, k0:k0 + 8].T  # K-major B: B[k][n] = vt[n][k]
        got += a @ b
        order = [0, 2, 4, 6, 1, 3, 5, 7]
        assert np.array_equal(a, p[:, k0:k0 + 8][:, order])
        assert np.array_equal(b, v[k0:k0 + 8][order])
    assert np.abs(got - p @ v).max() <= 1e-12 * np.abs(p @ v).max()
    unpermuted = np.zeros((64, D))
    for k0 in range(0, BN, 8):
        unpermuted += _a_fragments_from_acc(p[:, k0:k0 + 8]) @ v[k0:k0 + 8]
    assert np.abs(unpermuted - p @ v).max() > 1e-3
