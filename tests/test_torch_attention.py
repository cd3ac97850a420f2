"""The port's plain attention against the JAX package.

- K1's plain version (``flash_attention_forward`` on CPU tensors) against the
  Pallas ``_flash_attention_forward`` (interpret mode on the CPU) and
  ``attention_reference``: out and LSE on valid rows only (padding rows are
  a garbage mean of V on both sides).
- K2's plain version (``flash_decode_attention`` on CPU tensors) against the
  Pallas ``flash_decode_attention`` at S = 384, and the port's chunked loop
  against ``decode_attention`` at S = 300 with 128-position chunks (the
  last chunk's start is clamped), on bf16 and int8 layer-stacked caches.

Tolerances: fp32 inputs differ in summation order only (1e-5); bf16
operands are held to 2e-2 of max |reference| (the P cast to bf16 before
the PV product rounds at a different running max).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.core.llama import quantize_kv as jax_quantize_kv

from modelcompose_tpu_torch.ops import attention, flash_attention, flash_decode

# The JAX package's ops/__init__ re-exports functions under the modules'
# names, so the modules are fetched by their dotted paths.
jattn = importlib.import_module("modelcompose_tpu.ops.attention")
jfa = importlib.import_module("modelcompose_tpu.ops.flash_attention")
jfd = importlib.import_module("modelcompose_tpu.ops.flash_decode")

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), JAX_DT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        tol = 2e-2 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


FA_CASES = {
    # name: (B, Lq, S, H, Hkv, D, q_offset, kv lengths per row)
    "ragged_150_padded": (2, 150, 150, 4, 4, 128, 0, (150, 97)),
    "gqa2_d64": (2, 150, 150, 4, 2, 64, 0, (150, 61)),
    "gqa4_q_offset": (2, 96, 224, 8, 2, 64, 128, (224, 200)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_plain_matches_pallas(case, dtype):
    B, Lq, S, H, Hkv, D, q_offset, lengths = FA_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(B, Lq, H, D))
    k = rng.normal(size=(B, S, Hkv, D))
    v = rng.normal(size=(B, S, Hkv, D))
    kv_seg = (np.arange(S)[None] < np.array(lengths)[:, None]).astype(np.int32)
    q_seg = np.ascontiguousarray(kv_seg[:, q_offset:q_offset + Lq])
    scale = D ** -0.5

    out, lse = flash_attention.flash_attention_forward(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), causal=True,
        q_segment_ids=torch.from_numpy(q_seg),
        kv_segment_ids=torch.from_numpy(kv_seg), q_offset=q_offset)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (B, Lq, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Lq)

    j_out, j_lse = jfa._flash_attention_forward(
        _j(q, dtype).swapaxes(1, 2), _j(k, dtype).swapaxes(1, 2),
        _j(v, dtype).swapaxes(1, 2), jnp.asarray(q_seg), jnp.asarray(kv_seg),
        scale, True, q_offset)
    ref = jattn.attention_reference(
        _j(q, "float32"), _j(_f32(_t(k, dtype)), "float32"),
        _j(_f32(_t(v, dtype)), "float32"), causal=True,
        q_segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(kv_seg),
        q_offset=q_offset) if dtype == "float32" else None

    valid = q_seg != 0
    got_rows = _f32(out)[valid]
    _close(got_rows, _f32(j_out.swapaxes(1, 2))[valid], dtype, "out vs pallas")
    # LSE: fp32 statistics of the same (bf16-rounded) operands
    np.testing.assert_allclose(_f32(lse).transpose(0, 2, 1)[valid],
                               _f32(j_lse).transpose(0, 2, 1)[valid],
                               rtol=1e-5, atol=1e-5)
    if ref is not None:
        _close(got_rows, _f32(ref)[valid], dtype, "out vs attention_reference")


def test_flash_bf16_operand_path():
    """The shape of the JAX package's test_flash_bf16_operand_path: bf16
    operands, fp32 accumulation, P cast to bf16; the plain version stays
    within bf16 resolution of the fp32 reference on the same bf16 inputs."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(1, 256, 2, 128)) for _ in range(3))
    qb, kb, vb = (_t(x, "bfloat16") for x in (q, k, v))
    got = flash_attention.flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    want = jattn.attention_reference(*(_j(_f32(x), "float32")
                                       for x in (qb, kb, vb)), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)
    pallas = jfa.flash_attention(*(_j(_f32(x), "bfloat16")
                                   for x in (qb, kb, vb)), causal=True)
    _close(got, pallas, "bfloat16", "plain vs pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dispatch_matches_reference(dtype):
    """attention() on CPU tensors (the flash path's plain versions),
    segment ids and all, against the JAX package's attention() (its XLA
    path off the TPU)."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 40, 4, 16)) for _ in range(3))
    seg = (np.arange(40)[None] < np.array([[40], [23]])).astype(np.int32)
    got = attention.attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              q_segment_ids=torch.from_numpy(seg),
                              kv_segment_ids=torch.from_numpy(seg))
    want = jattn.attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                           q_segment_ids=jnp.asarray(seg),
                           kv_segment_ids=jnp.asarray(seg))
    valid = seg != 0
    _close(_f32(got)[valid], _f32(want)[valid], dtype, "attention()")


def _caches(rng, NL, B, S, Hkv, D, quantized, dtype):
    """The same layer-stacked caches for both packages (int8 quantized once,
    by the JAX package, so both read identical bytes)."""
    k = rng.normal(size=(NL, B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(NL, B, S, Hkv, D)).astype(np.float32)
    if quantized:
        jk = jax_quantize_kv(jnp.asarray(k))
        jv = jax_quantize_kv(jnp.asarray(v))

        def tt(c):
            return {n: torch.from_numpy(np.array(x)) for n, x in c.items()}
        return (tt(jk), tt(jv)), (jk, jv)
    return (_t(k, dtype), _t(v, dtype)), (_j(k, dtype), _j(v, dtype))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(quantized, dtype):
    rng = np.random.default_rng(13)
    NL, B, S, H, Hkv, D = 3, 2, 384, 8, 2, 64
    (tk, tv), (jk, jv) = _caches(rng, NL, B, S, Hkv, D, quantized, dtype)
    q = rng.normal(size=(B, 1, H, D))
    kv_len = np.array([384, 131], np.int32)
    got = flash_decode.flash_decode_attention(
        _t(q, dtype), tk, tv, torch.from_numpy(kv_len), 1, sm_scale=D ** -0.5)
    want = jfd.flash_decode_attention(
        _j(q, dtype), jk, jv, jnp.asarray(kv_len), jnp.int32(1),
        sm_scale=D ** -0.5)
    assert got.shape == (B, 1, H, D) and got.dtype == TORCH_DT[dtype]
    _close(got, want, dtype, "flash decode vs pallas")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_clamped_chunk_matches_jax(quantized, dtype):
    rng = np.random.default_rng(14)
    NL, B, S, H, Hkv, D = 2, 2, 300, 8, 2, 32
    (tk, tv), (jk, jv) = _caches(rng, NL, B, S, Hkv, D, quantized, dtype)
    q = rng.normal(size=(B, 1, H, D))
    kv_len = np.array([300, 190], np.int32)
    want = jattn.decode_attention(_j(q, dtype), jk, jv, jnp.asarray(kv_len),
                                  chunk=128, layer_idx=1)
    for impl in ("auto", "reference"):  # K2's plain version, the loop
        got = attention.decode_attention(
            _t(q, dtype), tk, tv, torch.from_numpy(kv_len), chunk=128,
            layer_idx=1, impl=impl)
        _close(got, want, dtype, f"decode_attention impl={impl}")


def test_decode_attention_unstacked_cache_and_scalar_len():
    """A per-layer cache (no layer axis) and a scalar kv_len, as in the
    JAX package's signature."""
    rng = np.random.default_rng(15)
    k, v = (rng.normal(size=(2, 50, 2, 16)) for _ in range(2))
    q = rng.normal(size=(2, 1, 4, 16))
    got = attention.decode_attention(_t(q, "float32"), _t(k, "float32"),
                                     _t(v, "float32"), 37)
    want = jattn.decode_attention(_j(q, "float32"), _j(k, "float32"),
                                  _j(v, "float32"), 37)
    _close(got, want, "float32", "unstacked")


def test_wrappers_take_plain_path_on_cpu_without_counting():
    q = torch.zeros(1, 4, 2, 64)
    n1 = flash_attention.flash_attention_forward.launches
    n2 = flash_decode.flash_decode_attention.launches
    flash_attention.flash_attention_forward(q, q, q)
    cache = torch.zeros(1, 1, 8, 2, 64)
    flash_decode.flash_decode_attention(q[:, :1], cache, cache,
                                        torch.tensor([3], dtype=torch.int32),
                                        0, sm_scale=0.125)
    assert flash_attention.flash_attention_forward.launches == n1
    assert flash_decode.flash_decode_attention.launches == n2


def test_pallas_interpret_mode_is_on():
    assert jax.default_backend() == "cpu"
    assert jfa._interpret() and jfd._interpret()
