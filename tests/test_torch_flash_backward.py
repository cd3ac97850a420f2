"""The flash-attention backward of the port against the JAX package.

- ``flash_attention_backward_reference`` (K3's and K4's plain versions,
  with Di from the saved output) against the Pallas backward (interpret
  mode on the CPU: ``_fa_bwd``, which runs ``_flash_attention_backward``)
  on the same q/k/v, output, LSE and cotangent;
- the port's ``flash_attention`` autograd (``_FlashAttention``: K1's plain
  forward, K3/K4's plain backward) against the same Pallas forward and
  backward, the ``custom_vjp`` halves that ``jax.vjp`` of the Pallas
  ``flash_attention`` runs.

Cases: causal with ragged segments and the cotangent zeroed on padding
rows, L = 96 and 150, GQA group 2, a query offset, D = 32 and 64; and GQA
group 4 in bf16, where the port sums each group before rounding (a
documented deviation).
Tolerances: fp32 rtol 1e-3 / atol 2e-4 (tests/test_flash_attention.py's
own for the Pallas backward); bf16 5e-2 of max |reference|
(test_flash_bf16_operand_path's: P and dS are rounded to bf16 before the
second products, at different points of a different summation order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu_torch.ops import attention
from modelcompose_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference)

jfa = importlib.import_module("modelcompose_tpu.ops.flash_attention")

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

CASES = {
    # name: (B, Lq, S, H, Hkv, D, q_offset, kv lengths per row)
    "ragged_150_gqa2_d64": (2, 150, 150, 4, 2, 64, 0, (150, 97)),
    "q_offset_96_gqa2_d32": (2, 96, 224, 4, 2, 32, 128, (224, 200)),
    "ragged_96_d32": (2, 96, 96, 4, 4, 32, 0, (96, 61)),
    "gqa4_64_d32": (2, 64, 64, 8, 2, 32, 0, (64, 41)),
}
# The Pallas side runs in interpret mode, a few seconds a case: the first
# two cases cover every listed feature between them.
PALLAS_CASES = ("ragged_150_gqa2_d64", "q_offset_96_gqa2_d32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4,
                                   err_msg=what)
    else:
        tol = 5e-2 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _inputs(case, dtype):
    """Numpy inputs rounded to ``dtype`` once, so both packages read the
    same values: q/k/v, segment ids and a cotangent zero on padding rows."""
    B, Lq, S, H, Hkv, D, q_offset, lengths = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))

    def rnd(*shape):
        return _f32(torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(TORCH_DT[dtype]))
    q, k, v = rnd(B, Lq, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    kv_seg = (np.arange(S)[None] < np.array(lengths)[:, None]).astype(np.int32)
    q_seg = np.ascontiguousarray(kv_seg[:, q_offset:q_offset + Lq])
    do = rnd(B, Lq, H, D) * (q_seg != 0)[..., None, None]
    return q, k, v, do, q_seg, kv_seg, q_offset


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), JAX_DT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PALLAS_CASES)
def test_backward_matches_pallas(case, dtype):
    """One Pallas forward and backward (the two halves of the JAX
    ``custom_vjp``, i.e. ``jax.vjp`` of ``flash_attention``) per case; the
    port's written-out backward and its autograd are both held to it."""
    q, k, v, do, q_seg, kv_seg, q_offset = _inputs(case, dtype)
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jdo = (_j(x, dtype).swapaxes(1, 2) for x in (q, k, v, do))
    out_j, residuals = jfa._fa_fwd(jq, jk, jv, jnp.asarray(q_seg),
                                   jnp.asarray(kv_seg), scale, True, q_offset)
    want = [w.swapaxes(1, 2) for w in
            jfa._fa_bwd(scale, True, q_offset, residuals, jdo)[:3]]
    lse = torch.from_numpy(np.array(residuals[4]))
    seg = dict(q_segment_ids=torch.from_numpy(q_seg),
               kv_segment_ids=torch.from_numpy(kv_seg))

    # the written-out formula on the JAX forward's output and LSE
    got = flash_attention_backward_reference(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        _t(_f32(out_j.swapaxes(1, 2)), dtype), lse, _t(do, dtype),
        causal=True, q_offset=q_offset, sm_scale=scale, **seg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TORCH_DT[dtype]
        _close(g, w, dtype, f"reference {name}")
    assert not _f32(got[0])[q_seg == 0].any()  # padding rows: no gradient

    # autograd through _FlashAttention: the plain K1 forward, K3/K4 backward
    tq, tk, tv = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, q_offset=q_offset, **seg)
    assert out.grad_fn is not None
    valid = q_seg != 0
    _close(_f32(out)[valid], _f32(out_j.swapaxes(1, 2))[valid], dtype, "out")
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do, dtype))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dtype, f"autograd {name}")


def test_gqa_group_sum_matches_pallas_bf16():
    """A documented deviation, pinned: for GQA the JAX backward writes dK
    and dV per q head in the operand dtype and sums each group of heads
    after the kernel (``_flash_attention_backward``: bf16 per-head outputs,
    then ``.sum(axis=2)``), so in bf16 every head's share is rounded before
    the sum.  The port's K4 and its plain version sum the group in the fp32
    accumulators and round once, which is the more accurate of the two.
    With group 4 in bf16 the two agree within the bf16 tolerance (5e-2 of
    max |reference|), as do dQ (no group sum) and the padding rows' zeros."""
    case, dtype = "gqa4_64_d32", "bfloat16"
    q, k, v, do, q_seg, kv_seg, q_offset = _inputs(case, dtype)
    assert q.shape[2] // k.shape[2] == 4
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jdo = (_j(x, dtype).swapaxes(1, 2) for x in (q, k, v, do))
    out_j, residuals = jfa._fa_fwd(jq, jk, jv, jnp.asarray(q_seg),
                                   jnp.asarray(kv_seg), scale, True, q_offset)
    want = [w.swapaxes(1, 2) for w in
            jfa._fa_bwd(scale, True, q_offset, residuals, jdo)[:3]]
    got = flash_attention_backward_reference(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        _t(_f32(out_j.swapaxes(1, 2)), dtype),
        torch.from_numpy(np.array(residuals[4])), _t(do, dtype),
        causal=True, q_offset=q_offset, sm_scale=scale,
        q_segment_ids=torch.from_numpy(q_seg),
        kv_segment_ids=torch.from_numpy(kv_seg))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dtype, f"group-4 {name}")
    for g in got[1:]:  # padding kv rows: no gradient
        assert not _f32(g)[kv_seg == 0].any()


def test_attention_impls_on_cpu():
    """'auto' goes through the autograd Function on a CPU tensor (the
    kernels' plain versions); 'reference' is plain attention under torch
    autograd; both give the same gradients in fp32."""
    q, k, v, do, q_seg, kv_seg, q_offset = _inputs("ragged_96_d32",
                                                   "float32")
    grads = {}
    for impl in ("auto", "reference"):
        tq, tk, tv = (_t(x, "float32").requires_grad_() for x in (q, k, v))
        out = attention.attention(tq, tk, tv,
                                  q_segment_ids=torch.from_numpy(q_seg),
                                  kv_segment_ids=torch.from_numpy(kv_seg),
                                  impl=impl)
        is_flash = type(out.grad_fn).__name__.startswith("_FlashAttention")
        assert is_flash == (impl == "auto")
        grads[impl] = torch.autograd.grad(out, (tq, tk, tv),
                                          _t(do, "float32"))
    for g, w in zip(grads["auto"], grads["reference"]):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        attention.attention(tq, tk, tv, impl="pallas")
