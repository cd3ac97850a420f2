"""The PyTorch port's plain ops against the JAX package, on the same numpy
inputs.

Tolerances: fp32 results differ only in summation order (rtol/atol 1e-5);
bf16 results may differ by a rounding of the last bit, so they are held to
2e-2 of max |reference| (bf16 keeps 8 mantissa bits); integer outputs
(int8 weights) are exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from modelcompose_tpu.ops import norms as jnorms
from modelcompose_tpu.ops import quant as jquant
from modelcompose_tpu.ops import rope as jrope
from modelcompose_tpu.ops import routed_lora as jlora

from modelcompose_tpu_torch.ops import norms, quant, rope, routed_lora

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    """The same numpy values as a torch tensor and a JAX array."""
    t_dt, j_dt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a.copy()).to(t_dt), jnp.asarray(a, j_dt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2e-2 * max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 7, 64))
    w = rng.normal(1, 0.5, (64,))
    (tx, jx), (tw, jw) = _pair(x, dtype), _pair(w, dtype)
    got = norms.rms_norm(tx, tw, 1e-5)
    want = jnorms.rms_norm(jx, jw, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


def test_rms_norm_bf16_cast_order():
    """bf16: the normed states round to bf16 BEFORE the weight multiply
    (HF 4.31), so nearly every element matches the JAX package bit for bit,
    which the weight-first order does not."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (4, 33, 128))
    w = rng.normal(1, 0.5, (128,))
    (tx, jx), (tw, jw) = _pair(x, "bfloat16"), _pair(w, "bfloat16")
    want = np.asarray(jnorms.rms_norm(jx, jw, 1e-5)).view(np.uint16)
    got = norms.rms_norm(tx, tw, 1e-5).view(torch.int16).numpy().view(np.uint16)
    xf = tx.float()
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
    wrong = (tw.float() * normed).to(torch.bfloat16)
    wrong = wrong.view(torch.int16).numpy().view(np.uint16)
    assert (got == want).mean() > 0.99
    assert (wrong == want).mean() < (got == want).mean() - 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(2)
    pos = np.stack([np.arange(9), np.arange(9) + 40]).astype(np.int32)
    q = rng.normal(size=(2, 9, 4, 16))
    k = rng.normal(size=(2, 9, 2, 16))
    cos, sin = rope.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = jrope.rope_tables(jnp.asarray(pos), 16, 10000.0)
    _close(cos, jcos, "float32")
    _close(sin, jsin, "float32")
    (tq, jq), (tk, jk) = _pair(q, dtype), _pair(k, dtype)
    got_q, got_k = rope.apply_rope(tq, tk, cos, sin)
    want_q, want_k = jrope.apply_rope(jq, jk, jcos, jsin)
    assert got_q.dtype == tq.dtype and got_k.dtype == tk.dtype
    _close(got_q, want_q, dtype)
    _close(got_k, want_k, dtype)


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_int8_exact(axis):
    w = np.random.default_rng(3).normal(0, 0.02, (3, 48, 40)).astype(np.float32)
    w[0, :, 0] = 0.0  # an all-zero column takes the 1e-8 scale floor
    got = quant.quantize_int8(torch.from_numpy(w), axis=axis)
    want = jquant.quantize_int8(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_fp32_out(dtype):
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.02, (48, 40)).astype(np.float32)
    x = rng.normal(size=(2, 5, 48))
    wq = jquant.quantize_int8(jnp.asarray(w))
    twq = {k: torch.from_numpy(np.array(v)) for k, v in wq.items()}
    tx, jx = _pair(x, dtype)
    got = quant.dequant_matmul(tx, twq, out_dtype=torch.float32)
    want = jquant.dequant_matmul(jx, wq, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    # fp32 out from bf16 operands: exact products, fp32 sums
    _close(got, want, "float32")
    assert quant.dequant_matmul(tx, twq).dtype == tx.dtype


def _lora_inputs(rng, n_a=3, d_in=32, d_out=24, r=4):
    x = rng.normal(size=(2, 6, d_in))
    w = rng.normal(0, 0.1, (d_in, d_out))
    a = rng.uniform(-0.2, 0.2, (n_a, d_in, r))
    b = rng.normal(0, 0.3, (n_a, r, d_out))
    route = np.zeros((2, 6, n_a))
    route[0, :, 0] = 2.0
    route[1, :3, 1] = 2.0
    route[1, 3:, 1:] = 0.5  # multi-hot, as a merged default row
    return x, w, a, b, route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
def test_routed_lora_matmul(dtype, routed, quantized):
    x, w, a, b, route = _lora_inputs(np.random.default_rng(5))
    (tx, jx), (ta, ja), (tb, jb) = (_pair(v, dtype) for v in (x, a, b))
    if quantized:
        jw = jquant.quantize_int8(jnp.asarray(w, jnp.float32))
        tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    else:
        tw, jw = _pair(w, dtype)
    troute, jroute = (torch.from_numpy(route).float(),
                      jnp.asarray(route, jnp.float32)) if routed else (None,
                                                                       None)
    got = routed_lora.routed_lora_matmul(tx, tw, ta, tb, troute)
    want = jlora.routed_lora_matmul(jx, jw, ja, jb, jroute)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


def test_route_weights():
    table = np.random.default_rng(6).normal(size=(5, 3)).astype(np.float32)
    ids = np.array([[0, 2, 4], [1, 1, 3]], np.int32)
    got = routed_lora.route_weights(torch.from_numpy(ids),
                                    torch.from_numpy(table))
    want = jlora.route_weights(jnp.asarray(ids), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _backbone_tree(rng, dtype, quantized, n=2, n_a=3, d=16, inter=24, r=4):
    def lin(d_in, d_out):
        return {"w": rng.normal(0, 0.1, (n, d_in, d_out)),
                "lora_a": rng.uniform(-0.2, 0.2, (n, n_a, d_in, r)),
                "lora_b": rng.normal(0, 0.2, (n, n_a, r, d_out))}
    tree = {"embed_tokens": rng.normal(size=(8, d)),
            "layers": {"input_layernorm": np.ones((n, d)),
                       "post_attention_layernorm": np.ones((n, d)),
                       "attn": {k: lin(d, d) for k in "qkvo"},
                       "mlp": {"gate": lin(d, inter), "up": lin(d, inter),
                               "down": lin(inter, d)}},
            "norm": np.ones(d), "lm_head": rng.normal(size=(d, 8))}
    t_dt, j_dt = DTYPES[dtype]
    jtree = _map(tree, lambda a: jnp.asarray(a, j_dt))
    if quantized:
        jtree = jquant.quantize_backbone(jtree)
    return _to_torch(jtree), jtree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_torch(jtree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return _map(jtree, leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_backbone(dtype):
    tree, jtree = _backbone_tree(np.random.default_rng(7), dtype, False)
    got = quant.quantize_backbone(tree)
    want = jquant.quantize_backbone(jtree)
    for name in ("q", "down"):
        grp = "attn" if name == "q" else "mlp"
        g, w = got["layers"][grp][name], want["layers"][grp][name]
        assert quant.is_quantized(g["w"])
        np.testing.assert_array_equal(g["w"]["q"].numpy(),
                                      np.asarray(w["w"]["q"]))
        np.testing.assert_array_equal(g["w"]["scale"].numpy(),
                                      np.asarray(w["w"]["scale"]))
        _close(g["lora_b"], w["lora_b"], dtype)  # adapters untouched
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(),
                                  np.asarray(want["lm_head"]["q"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_fold_dense(dtype, quantized):
    tree, jtree = _backbone_tree(np.random.default_rng(8), dtype, quantized)
    table = np.array([[2.0, 0, 0.5], [0, 2.0, 0], [0, 0, 2.0]], np.float32)
    got, got_table = routed_lora.fold_dense(tree, table)
    want, want_table = jlora.fold_dense(jtree, jnp.asarray(table))
    np.testing.assert_array_equal(got_table.numpy(), np.asarray(want_table))
    for grp, name in (("attn", "k"), ("mlp", "up")):
        g, w = got["layers"][grp][name]["w"], want["layers"][grp][name]["w"]
        if quantized:
            # int8 requantized from fp32 sums in another order: a value on
            # a rounding boundary may land one step away
            gw = g["q"].float() * g["scale"]
            ww = np.asarray(w["q"], np.float32) * np.asarray(w["scale"])
            step = np.asarray(w["scale"])
            assert np.all(np.abs(gw.numpy() - ww) <= step * 1.001 + 1e-7)
            assert (g["q"].numpy() == np.asarray(w["q"])).mean() > 0.99
        else:
            _close(g, w, dtype)


def test_compact_active_adapters():
    tree, jtree = _backbone_tree(np.random.default_rng(9), "float32", False)
    table = np.array([[0, 0, 1.0], [0, 2.0, 0], [0, 0, 0]], np.float32)
    active = routed_lora.active_adapter_set(table, [0, 1])
    assert active == jlora.active_adapter_set(table, [0, 1]) == (1, 2)
    assert routed_lora.active_adapter_set(torch.from_numpy(table)) == (1, 2)
    got, got_table = routed_lora.compact_active_adapters(tree, table, active)
    want, want_table = jlora.compact_active_adapters(jtree, table, active)
    np.testing.assert_array_equal(got_table.numpy(), np.asarray(want_table))
    g, w = got["layers"]["mlp"]["gate"], want["layers"]["mlp"]["gate"]
    np.testing.assert_array_equal(g["lora_a"].numpy(), np.asarray(w["lora_a"]))
    np.testing.assert_array_equal(g["lora_b"].numpy(), np.asarray(w["lora_b"]))
