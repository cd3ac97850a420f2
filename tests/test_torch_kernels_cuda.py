"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and nvcc, and skips elsewhere.
On a machine with the card (this file imports no JAX, so the repo's JAX
conftest is left out):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels_cuda.py

Tolerance: bf16 outputs within 2e-2 of max |plain| on valid rows (the
kernel rounds P at a running max and sums in another order); the LSE
within 1e-3 of max(|LSE|, 1) (fp32 statistics of identical operands).
"""

import pytest
import torch

from modelcompose_tpu_torch.core.llama import quantize_kv
from modelcompose_tpu_torch.ops import attention
from modelcompose_tpu_torch.ops.flash_attention import (
    flash_attention_forward, flash_attention_reference)
from modelcompose_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_reference)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("B,Lq,S,H,Hkv,D,q_offset,lengths", [
    (2, 1024, 1024, 32, 32, 128, 0, (1024, 637)),
    (2, 150, 150, 32, 32, 128, 0, (150, 97)),
    (1, 1, 77, 8, 8, 64, 76, (77,)),
    (2, 256, 1024, 32, 8, 128, 768, (1024, 900)),
    (3, 200, 200, 8, 2, 64, 0, (200, 1, 130)),
])
def test_k1_matches_plain(B, Lq, S, H, Hkv, D, q_offset, lengths):
    gen = torch.Generator(device="cuda").manual_seed(Lq + S)
    q = _rnd(gen, B, Lq, H, D)
    k, v = _rnd(gen, B, S, Hkv, D), _rnd(gen, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    valid = q_seg != 0
    assert _rel(out[valid], ref[valid]) <= 2e-2
    got_lse = lse.transpose(1, 2)[valid]
    want_lse = ref_lse.transpose(1, 2)[valid]
    assert (got_lse - want_lse).abs().max().item() <= 1e-3 * max(
        want_lse.abs().max().item(), 1.0)


def test_k1_segments_isolate_packed_samples():
    """Two samples packed in one row (segments 1 and 2) attend only within
    themselves: the second equals the sample run alone."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (_rnd(gen, 1, 192, 4, 64) for _ in range(3))
    seg = torch.cat([torch.ones(80), 2 * torch.ones(112)]).int().cuda()[None]
    out, _ = flash_attention_forward(q, k, v, q_segment_ids=seg,
                                     kv_segment_ids=seg, causal=False)
    alone, _ = flash_attention_forward(
        q[:, 80:].contiguous(), k[:, 80:].contiguous(),
        v[:, 80:].contiguous(), causal=False)
    assert _rel(out[:, 80:], alone) <= 2e-2


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("NL,B,S,H,Hkv,D,kv_len", [
    (4, 2, 1000, 32, 8, 128, (1000, 517)),
    (32, 2, 1056, 32, 32, 128, (660, 630)),
    (2, 3, 257, 8, 1, 64, (1, 256, 257)),
    (3, 1, 100, 16, 8, 64, (100,)),
])
def test_k2_matches_plain(quantized, NL, B, S, H, Hkv, D, kv_len):
    gen = torch.Generator(device="cuda").manual_seed(S)
    q = _rnd(gen, B, 1, H, D)
    k, v = _rnd(gen, NL, B, S, Hkv, D), _rnd(gen, NL, B, S, Hkv, D)
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    for layer in (0, NL - 1):
        out = flash_decode_attention(q, k, v, lens, layer, sm_scale=D ** -0.5)
        ref = flash_decode_reference(q, k, v, lens, layer, sm_scale=D ** -0.5)
        loop = attention.decode_attention(q, k, v, lens, layer_idx=layer,
                                          impl="reference")
        assert _rel(out, ref) <= 2e-2 and _rel(out, loop) <= 2e-2


def test_dispatchers_launch_the_kernels_and_count():
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (_rnd(gen, 2, 64, 4, 64) for _ in range(3))
    n1 = flash_attention_forward.launches
    attention.attention(q, k, v)
    assert flash_attention_forward.launches == n1 + 1
    cache = _rnd(gen, 2, 2, 32, 4, 64)
    n2 = flash_decode_attention.launches
    attention.decode_attention(q[:, :1].contiguous(), cache, cache, 9,
                               layer_idx=1)
    assert flash_decode_attention.launches == n2 + 1
    attention.attention(q, k, v, impl="reference")  # plain: no launch
    assert flash_attention_forward.launches == n1 + 1


def test_wrappers_raise_instead_of_falling_back():
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = _rnd(gen, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        flash_attention_forward(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        odd = _rnd(gen, 1, 16, 2, 96)
        flash_attention_forward(odd, odd, odd)
    with pytest.raises(ValueError):
        flash_attention_forward(q, q.transpose(1, 2), q)
    cache = _rnd(gen, 1, 1, 32, 2, 64)
    with pytest.raises(ValueError):
        flash_decode_attention(q[:, :1].contiguous(), cache, cache,
                               torch.tensor([4], device="cuda"), 0,
                               sm_scale=0.125)  # int64 kv_len
    with pytest.raises(ValueError):
        flash_decode_attention(q[:, :1].contiguous(), cache, cache,
                               torch.tensor([4], dtype=torch.int32,
                                            device="cuda"), 1, sm_scale=0.125)
