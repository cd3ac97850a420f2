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
that.  The hardware adds of the tensor cores truncate where the model
rounds: that is why the kernels keep each tile's product in accumulators
of its own (the card tests hold the kernels themselves at 1e-5).
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
