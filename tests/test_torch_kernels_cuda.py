"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and nvcc, and skips elsewhere.
On a machine with the card (this file imports no JAX, so the repo's JAX
conftest is left out):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels_cuda.py

Tolerance: bf16 outputs within 2e-2 of max |plain| on valid rows (the
kernel rounds P at a running max and sums in another order); the LSE
within 1e-3 of max(|LSE|, 1) (fp32 statistics of identical operands);
dQ, dK and dV within 2e-2 of max |plain| on valid rows (P and dS are
rounded to bf16 before the second products, the sums run in another
order) and zero on padding rows.  K5 and K6 (the int8 products) and K7
(their dL/dx): a bf16 or fp16 result within 2e-2 of max |plain| (one
rounding of a sum taken in another order), an fp32 result within 1e-5
(int8 and bf16 values are exact in fp32: the summation order alone).
"""

import pytest
import torch

from modelcompose_tpu_torch.core.llama import quantize_kv
from modelcompose_tpu_torch.ops import attention
from modelcompose_tpu_torch.ops.flash_attention import (
    _di, flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_mask_all, flash_attention_backward_reference,
    flash_attention_forward, flash_attention_forward_mask_all,
    flash_attention_reference)
from modelcompose_tpu_torch.ops.flash_decode import (
    _SCRATCH, flash_decode_attention, flash_decode_reference)
from modelcompose_tpu_torch.ops import quant
from modelcompose_tpu_torch.ops.quant import (dequant_matmul,
                                              dequant_matmul_reference,
                                              matmul_f32)

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
    (1, 3328, 3328, 32, 32, 128, 0, (3287,)),  # the MCUB-4 prefill
    (1, 1024, 1024, 32, 32, 128, 0, (650,)),  # a VQA image question
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


def _check_k1(q, k, v, kw, out, lse, tol=2e-2, lse_tol=1e-3):
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    valid = kw["q_segment_ids"] != 0
    assert torch.isfinite(out[valid]).all()
    assert _rel(out[valid], ref[valid]) <= tol
    got_lse = lse.transpose(1, 2)[valid]
    want_lse = ref_lse.transpose(1, 2)[valid]
    assert (got_lse - want_lse).abs().max().item() <= lse_tol * max(
        want_lse.abs().max().item(), 1.0)


def _packed_segments(B, L, bounds):
    """[B, L] segment ids 1, 2, 3... changing at ``bounds`` (the same in
    every row), padding (0) from the last bound on."""
    seg = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    start = 0
    for i, end in enumerate(bounds):
        seg[:, start:end] = i + 1
        start = end
    return seg


@pytest.mark.parametrize("name,B,L,H,Hkv,D,bounds,causal", [
    # Lq and S multiples of neither 128 nor 64
    ("ragged", 1, 77, 4, 4, 64, (77,), True),
    ("ragged_d128", 2, 333, 8, 8, 128, (333,), True),
    # a segment boundary inside a tile; three packed segments in one row
    ("boundary", 1, 256, 4, 4, 128, (100, 256), True),
    ("three_segments", 2, 300, 8, 8, 64, (70, 190, 290), True),
    ("three_segments_full", 2, 300, 8, 8, 128, (70, 190, 290), False),
    # B = 2 where a 128-row TMA box would run into the next batch row
    ("batch_edge", 2, 100, 4, 4, 128, (100,), True),
    # GQA groups 4 and 8, D = 64
    ("gqa4", 1, 260, 32, 8, 128, (260,), True),
    ("gqa8", 2, 200, 32, 4, 128, (150, 200), True),
    ("d64", 2, 513, 16, 16, 64, (513,), True),
])
def test_k1_edges_match_plain(name, B, L, H, Hkv, D, bounds, causal):
    gen = torch.Generator(device="cuda").manual_seed(L * H + D)
    q = _rnd(gen, B, L, H, D)
    k, v = _rnd(gen, B, L, Hkv, D), _rnd(gen, B, L, Hkv, D)
    seg = _packed_segments(B, L, bounds)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = flash_attention_forward(q, k, v, **kw)
    _check_k1(q, k, v, kw, out, lse)
    if name == "batch_edge":  # row 1 alone gives row 1 of the batch
        alone, _ = flash_attention_forward(
            q[1:].contiguous(), k[1:].contiguous(), v[1:].contiguous(),
            causal=True)
        assert torch.equal(alone[0], out[1])


@pytest.mark.parametrize("causal", [True, False])
def test_k1_fast_path_equals_masked_path(causal):
    """Interior tiles skip the per-element mask; forcing the mask on every
    tile gives the same bits, and both match the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (_rnd(gen, 2, 640, 8, 128) for _ in range(3))
    seg = _packed_segments(2, 640, (384, 640))
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    fast = flash_attention_forward(q, k, v, **kw)
    masked = flash_attention_forward_mask_all(q, k, v, **kw)
    assert torch.equal(fast[0], masked[0]) and torch.equal(fast[1], masked[1])
    _check_k1(q, k, v, kw, *fast)


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
    (32, 1, 3328 + 32, 32, 32, 128, (3287,)),  # MCUB-4 decode, first step
    (32, 2, 3328 + 32, 32, 32, 128, (3318, 3300)),
    (32, 3, 3328 + 32, 32, 32, 128, (3287,) * 3),  # MCUB-4 beam search, B=3
    (32, 1, 1024 + 32, 32, 32, 128, (650,)),  # a VQA answer, first step
    (32, 1, 1024 + 32, 32, 32, 128, (665,)),  # and its 16th token
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


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_k2_split_edges_and_groups(quantized, group):
    """kv_len of 1, exactly one split of 128 positions and one +- 1, two
    splits and two +- 1, and several splits, for every GQA group, in one
    batch."""
    D, Hkv = 128, 4
    lens = (1, 127, 128, 129, 256, 255, 257, 700)
    gen = torch.Generator(device="cuda").manual_seed(group)
    q = _rnd(gen, len(lens), 1, Hkv * group, D)
    k, v = (_rnd(gen, 2, len(lens), 700, Hkv, D) for _ in range(2))
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = flash_decode_attention(q, k, v, kv, 1, sm_scale=D ** -0.5)
    ref = flash_decode_reference(q, k, v, kv, 1, sm_scale=D ** -0.5)
    assert torch.isfinite(out).all() and _rel(out, ref) <= 2e-2


def test_beam_gather_on_card_matches_cpu():
    """The in-place parent-beam gather on a bf16 beam cache on the card
    gives the CPU's rows, in the same buffers, and K2 over the gathered
    cache agrees with the plain version over the CPU's."""
    from modelcompose_tpu_torch.core import beam
    from modelcompose_tpu_torch.core.llama import KVCache
    gen = torch.Generator().manual_seed(5)
    k, v = (torch.randn((4, 1, 300, 8, 64), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    cpu = beam._tile_beams(KVCache(k=k, v=v), 3)
    for t in (cpu.k, cpu.v):  # generated rows differ per beam
        t[:, :, 200:230] = torch.randn(t[:, :, 200:230].shape,
                                       generator=gen).to(torch.bfloat16)
    card = KVCache(k=cpu.k.cuda(), v=cpu.v.cuda())
    ptrs = (card.k.data_ptr(), card.v.data_ptr())
    for idx in ([2, 2, 0], [1, 0, 1]):
        beam._gather_beams(cpu, torch.tensor(idx), 200, 230)
        beam._gather_beams(card, torch.tensor(idx, device="cuda"), 200, 230)
        assert torch.equal(card.k.cpu(), cpu.k)
        assert torch.equal(card.v.cpu(), cpu.v)
    assert (card.k.data_ptr(), card.v.data_ptr()) == ptrs
    q = torch.randn((3, 1, 8, 64), generator=gen).to(torch.bfloat16)
    lens = torch.tensor([230] * 3, dtype=torch.int32)
    out = flash_decode_attention(q.cuda(), card.k, card.v, lens.cuda(), 2,
                                 sm_scale=0.125)
    ref = flash_decode_reference(q, cpu.k, cpu.v, lens, 2, sm_scale=0.125)
    assert _rel(out.cpu(), ref) <= 2e-2


def test_k2_counters_reset_between_launches():
    """The fused combine's counters are back at zero after each launch, so
    two launches in a row on the same counters agree."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = _rnd(gen, 2, 1, 8, 128)
    k, v = (quantize_kv(_rnd(gen, 3, 2, 1100, 8, 128)) for _ in range(2))
    kv = torch.tensor([1100, 513], dtype=torch.int32, device="cuda")
    first = flash_decode_attention(q, k, v, kv, 2, sm_scale=0.088)
    second = flash_decode_attention(q, k, v, kv, 2, sm_scale=0.088)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not any(sc[3].any() for key, (_, sc) in _SCRATCH.items()
                   if key[0] == q.device)
    ref = flash_decode_reference(q, k, v, kv, 2, sm_scale=0.088)
    assert _rel(first, ref) <= 2e-2


def test_k2_concurrent_streams_keep_their_own_scratch():
    """Launches of one shape on two streams at once, on different data:
    each stream has its own partials and counters, so both stay right."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = []
    for _ in range(2):
        q = _rnd(gen, 2, 1, 16, 128)
        k, v = (quantize_kv(_rnd(gen, 4, 2, 1500, 16, 128)) for _ in range(2))
        kv = torch.tensor([1500, 777], dtype=torch.int32, device="cuda")
        cases.append((q, k, v, kv))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for layer in range(4):
        for i, (stream, (q, k, v, kv)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                outs[i].append(flash_decode_attention(q, k, v, kv, layer,
                                                      sm_scale=0.088))
    torch.cuda.synchronize()
    for (q, k, v, kv), got in zip(cases, outs):
        for layer, out in enumerate(got):
            ref = flash_decode_reference(q, k, v, kv, layer, sm_scale=0.088)
            assert _rel(out, ref) <= 2e-2
    assert {key[1] for key in _SCRATCH} >= {s.cuda_stream for s in streams}


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
    with pytest.raises(TypeError):  # fp64: no kernel takes it
        flash_attention_forward(q.double(), q.double(), q.double())
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


def _bwd_inputs(gen, B, Lq, S, H, Hkv, D, q_offset, lengths):
    """q/k/v, the kernel forward's out and LSE, and a cotangent zeroed on
    padding rows."""
    q = _rnd(gen, B, Lq, H, D)
    k, v = _rnd(gen, B, S, Hkv, D), _rnd(gen, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    do = _rnd(gen, B, Lq, H, D) * (q_seg != 0)[..., None, None]
    return (q, k, v, out, lse, do.contiguous()), kw


def _check_k3_k4(args, kw, dq, dk, dv, tol=2e-2):
    """dQ, dK and dV against the plain versions on valid rows (within
    ``tol`` of max |plain|), and zero on padding rows (a padding row's P is
    masked to 0 on both sides)."""
    q, k, v, out, lse, do = args
    ref = flash_attention_backward_reference(q, k, v, out, lse, do, **kw)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    q_valid, kv_valid = kw["q_segment_ids"] != 0, kw["kv_segment_ids"] != 0
    for got, want, rows in ((dq, ref[0], q_valid), (dk, ref[1], kv_valid),
                            (dv, ref[2], kv_valid)):
        assert torch.isfinite(got).all()
        assert _rel(got[rows], want[rows]) <= tol
    assert not dq[~q_valid].any()
    assert not dk[~kv_valid].any() and not dv[~kv_valid].any()


@pytest.mark.parametrize("name,B,Lq,S,H,Hkv,D,q_offset,lengths", [
    ("ms_shape", 2, 2048, 2048, 32, 32, 128, 0, (2048, 1391)),
    # the accumulation window's micro-batches
    ("micro_1400", 1, 2048, 2048, 32, 32, 128, 0, (1400,)),
    ("micro_1100", 1, 2048, 2048, 32, 32, 128, 0, (1100,)),
    ("ragged", 2, 150, 150, 32, 32, 128, 0, (150, 97)),
    ("q_offset_gqa4", 2, 256, 1024, 32, 8, 128, 768, (1024, 900)),
    ("gqa8", 2, 300, 300, 32, 4, 128, 0, (300, 211)),
    ("d64_gqa2", 2, 150, 150, 8, 4, 64, 0, (150, 61)),
    ("d64_one_valid_row", 3, 200, 200, 8, 2, 64, 0, (200, 1, 130)),
    # B = 2 with the last row shorter than a tile: a 128-row TMA box of
    # batch row 0 would run into row 1
    ("batch_edge", 2, 100, 100, 4, 4, 128, 0, (100, 100)),
])
def test_k3_k4_match_plain(name, B, Lq, S, H, Hkv, D, q_offset, lengths):
    gen = torch.Generator(device="cuda").manual_seed(Lq + S + D)
    args, kw = _bwd_inputs(gen, B, Lq, S, H, Hkv, D, q_offset, lengths)
    q, k, v, out, lse, do = args
    di = _di(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    _check_k3_k4(args, kw, dq, dk, dv)
    if name == "batch_edge":  # row 1 alone gives row 1 of the batch
        one = [t[1:].contiguous() for t in (q, k, v, do, lse, di)]
        kw1 = dict(kw, q_segment_ids=kw["q_segment_ids"][1:].contiguous(),
                   kv_segment_ids=kw["kv_segment_ids"][1:].contiguous())
        alone = (flash_attention_bwd_dq(*one, **kw1),
                 *flash_attention_bwd_dkv(*one, **kw1))
        for a, batch in zip(alone, (dq, dk, dv)):
            assert torch.equal(a[0], batch[1])


@pytest.mark.parametrize("causal", [True, False])
def test_k3_k4_fast_path_equals_masked_path(causal):
    """Interior tiles skip the per-element mask; forcing the mask on every
    tile gives the same bits for dQ, dK and dV, and both match the plain
    versions.  Two packed segments, one boundary inside a tile, GQA 2."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    B, L, H, Hkv, D = 2, 640, 8, 4, 128
    q = _rnd(gen, B, L, H, D)
    k, v = _rnd(gen, B, L, Hkv, D), _rnd(gen, B, L, Hkv, D)
    seg = _packed_segments(B, L, (384, 600))  # 40 padding rows
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = flash_attention_forward(q, k, v, **kw)
    do = (_rnd(gen, B, L, H, D) * (seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    fast = (flash_attention_bwd_dq(q, k, v, do, lse, di, **kw),
            *flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw))
    masked = flash_attention_bwd_mask_all(q, k, v, do, lse, di, **kw)
    for f, m in zip(fast, masked):
        assert torch.equal(f, m)
    _check_k3_k4((q, k, v, out, lse, do), kw, *fast)


def test_matmul_f32_backward_on_card():
    """The fp32-output GEMM has no derivative of its own: the written-out
    backward gives dX and dW in the operands' dtype, dW only on request."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = _rnd(gen, 3, 40, 64).requires_grad_()
    w = _rnd(gen, 64, 48).requires_grad_()
    g = torch.randn(3, 40, 48, generator=gen, device="cuda")
    y = matmul_f32(x, w)
    assert y.dtype == torch.float32
    y.backward(g)
    want_dx = (g.bfloat16().float() @ w.float().t()).bfloat16()
    want_dw = (x.float().reshape(-1, 64).t()
               @ g.bfloat16().float().reshape(-1, 48)).bfloat16()
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    assert _rel(x.grad, want_dx) <= 1e-2 and _rel(w.grad, want_dw) <= 1e-2
    # the same arithmetic as on the CPU (which the JAX tests hold)
    xc, wc = (t.detach().cpu().requires_grad_() for t in (x, w))
    matmul_f32(xc, wc).backward(g.cpu())
    assert _rel(x.grad.cpu(), xc.grad) <= 1e-2
    assert _rel(w.grad.cpu(), wc.grad) <= 1e-2
    frozen = w.detach()
    x.grad = None
    matmul_f32(x, frozen).backward(g)
    assert x.grad is not None and frozen.grad is None


def test_attention_on_card_is_differentiable_through_k3_k4():
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (_rnd(gen, 2, 96, 4, 64).requires_grad_() for _ in range(3))
    n3, n4 = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
    out = attention.attention(q, k, v)
    assert out.requires_grad and out.grad_fn is not None
    out.float().square().sum().backward()
    assert flash_attention_bwd_dq.launches == n3 + 1
    assert flash_attention_bwd_dkv.launches == n4 + 1
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16
               for t in (q, k, v))
    # the same gradients through the plain path and torch autograd
    q2, k2, v2 = (t.detach().requires_grad_() for t in (q, k, v))
    attention.attention(q2, k2, v2, impl="reference").float().square() \
        .sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert _rel(a.grad, b.grad) <= 3e-2
    assert flash_attention_bwd_dq.launches == n3 + 1  # plain: no launch


def test_backward_wrappers_raise_instead_of_falling_back():
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = _rnd(gen, 1, 16, 2, 64)
    lse = torch.zeros(1, 2, 16, device="cuda")
    for bad in (q.double(), _rnd(gen, 1, 16, 2, 96)):
        lse_b = torch.zeros(1, 2, 16, device="cuda")
        err = TypeError if bad.dtype == torch.float64 else ValueError
        with pytest.raises(err):
            flash_attention_bwd_dq(bad, bad, bad, bad, lse_b, lse_b)
        with pytest.raises(err):
            flash_attention_bwd_dkv(bad, bad, bad, bad, lse_b, lse_b)
    with pytest.raises(ValueError):  # an LSE laid out [B, Lq, H]
        flash_attention_bwd_dq(q, q, q, q, lse.transpose(1, 2), lse)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())


# ---------------------------------------------------------------------------
# The serving path's new inputs: K1 on prefill chunks over the stacked cache,
# K2 over the slot pool, the in-place splice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Lq,S,q_offset", [
    (512, 512, 0), (512, 3072, 2560), (256, 3328, 3072)])
def test_k1_on_a_prefill_chunk_matches_plain(quantized, Lq, S, q_offset):
    """A chunk of a chunked admission: no segment ids, causality bottom-right
    aligned (q_offset = S - Lq), k/v the used prefix of layer 1 of a stacked
    cache of 3,456 positions: a view of the bf16 cache (no copy: the
    wrapper's checks pass on it) or the dequantized prefix of an int8 one."""
    from modelcompose_tpu_torch.core.llama import _used_prefix
    gen = torch.Generator(device="cuda").manual_seed(S + quantized)
    cache = {n: _rnd(gen, 2, 1, 3456, 32, 128) for n in ("k", "v")}
    if quantized:
        cache = {n: quantize_kv(c) for n, c in cache.items()}
    k, v = (_used_prefix(cache[n], 1, S, torch.bfloat16) for n in ("k", "v"))
    if not quantized:
        assert k.data_ptr() == cache["k"][1].data_ptr()  # a view
    q = _rnd(gen, 1, Lq, 32, 128)
    kw = dict(causal=True, q_offset=q_offset)
    before = flash_attention_forward.launches
    out, lse = flash_attention_forward(q, k, v, **kw)
    assert flash_attention_forward.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    assert torch.isfinite(out).all() and _rel(out, ref) <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3 * max(
        ref_lse.abs().max().item(), 1.0)


@pytest.mark.parametrize("quantized", [False, True])
def test_k2_over_the_slot_pool_matches_plain(quantized):
    """8 slots of 3,456 positions with unequal kv_len, idle rows at 1: every
    row finite and within 2e-2 of the plain version."""
    lens = (1, 1, 700, 3300, 1, 40, 2048, 1)
    gen = torch.Generator(device="cuda").manual_seed(3456)
    q = _rnd(gen, 8, 1, 32, 128)
    k, v = (_rnd(gen, 2, 8, 3456, 32, 128) for _ in range(2))
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for layer in (0, 1):
        out = flash_decode_attention(q, k, v, kv, layer, sm_scale=128 ** -0.5)
        ref = flash_decode_reference(q, k, v, kv, layer, sm_scale=128 ** -0.5)
        assert torch.isfinite(out).all() and _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("pool_int8,small_int8", [
    (False, False), (True, True), (True, False)])
def test_splice_on_card_matches_cpu(pool_int8, small_int8):
    """The slot splice on the card writes the CPU's bytes into the pool's
    own buffers.  A bf16 admission into an int8 pool is quantized on the
    card first: the card rounds its scale (amax / 127) apart from the CPU
    in the last place, so there the spliced row is held to the card's own
    ``quantize_kv`` bit for bit and to the CPU's within one int8 step."""
    from modelcompose_tpu_torch.core.llama import KVCache
    gen = torch.Generator().manual_seed(9)

    def cache(batch, quantized):
        parts = [torch.randn((2, batch, 64, 8, 128), generator=gen)
                 .to(torch.bfloat16) for _ in range(2)]
        return [quantize_kv(p) if quantized else p for p in parts]

    def on(parts, device):
        return KVCache(*[{n: t.to(device) for n, t in p.items()}
                         if isinstance(p, dict) else p.to(device)
                         for p in parts])
    big, small = cache(4, pool_int8), cache(1, small_int8)
    cpu, card = on(big, "cpu"), on(big, "cuda")
    ptrs = [t.data_ptr() for p in (card.k, card.v)
            for t in (p.values() if isinstance(p, dict) else [p])]
    cpu.splice(on(small, "cpu"), 2)
    card.splice(on(small, "cuda"), 2)
    requantized = pool_int8 and not small_int8
    for i, (got, want) in enumerate(((card.k, cpu.k), (card.v, cpu.v))):
        if requantized:
            row = quantize_kv(small[i].cuda())
            for n in got:
                assert torch.equal(got[n][:, 2], row[n][:, 0])
                keep = [r for r in range(4) if r != 2]
                assert torch.equal(got[n][:, keep].cpu(), want[n][:, keep])
            assert (got["q"].cpu().int() - want["q"].int()).abs().max() <= 1
            torch.testing.assert_close(got["scale"].cpu(), want["scale"],
                                       rtol=1e-6, atol=0)
            continue
        pairs = [(got[n], want[n]) for n in got] if isinstance(got, dict) \
            else [(got, want)]
        for g, w in pairs:
            assert torch.equal(g.cpu(), w)
    assert ptrs == [t.data_ptr() for p in (card.k, card.v)
                    for t in (p.values() if isinstance(p, dict) else [p])]


# ---------------------------------------------------------------------------
# The EVA and ImageBind towers and the text CLIP encoder on the card against
# the CPU, same weights and inputs, fp32 with TF32 off: within 1e-5 of
# max |CPU output| (summation order of the card's GEMMs and convolutions)
# ---------------------------------------------------------------------------

def _tower_on_both(make, inputs, encode="encode"):
    """(card output, CPU output) of one tower built on the CPU and copied
    to the card."""
    from modelcompose_tpu_torch.tree import tree_map_with_path
    torch.backends.cudnn.allow_tf32 = False
    cpu = make()
    card = make()
    card.params = tree_map_with_path(lambda _, t: t.cuda(), cpu.params)
    want = getattr(cpu, encode)(*inputs)
    got = getattr(card, encode)(*inputs)
    assert got.is_cuda and not want.is_cuda
    return got.cpu(), want


@pytest.mark.parametrize("family", ["eva02", "eva01"])
def test_eva_tower_on_card_matches_cpu(family):
    import dataclasses
    import numpy as np
    from modelcompose_tpu_torch.config import tiny_test_config
    from modelcompose_tpu_torch.models.vision_eva import EvaVisionTower

    def make():
        t = EvaVisionTower("eva-test:64x3", tiny_test_config(),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
        if family == "eva01":
            t.cfg = dataclasses.replace(t.cfg, use_rope=False)
        return t
    pixels = np.random.default_rng(1).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    got, want = _tower_on_both(make, (pixels,))
    assert _rel(got, want) <= 1e-5


def test_imagebind_tower_on_card_matches_cpu():
    import numpy as np
    from modelcompose_tpu_torch.models.audio_imagebind import \
        ImageBindAudioTower

    def make():
        return ImageBindAudioTower("imagebind-test:32x2",
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    mel = make().modal_processor(np.random.default_rng(2).normal(
        size=48000).astype(np.float32) * 0.1)
    got, want = _tower_on_both(make, (mel,))
    assert got.shape == (1, 3, 32) and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("padded", [False, True])
def test_clip_text_on_card_matches_cpu(padded):
    from modelcompose_tpu_torch.models.text_clip import (ClipTextConfig,
                                                         ClipTextEncoder)
    cfg = ClipTextConfig(hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         vocab_size=100, max_position_embeddings=16,
                         projection_dim=32)

    def make():
        return ClipTextEncoder(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    ids = torch.tensor([[5, 6, 7, 99, 0, 0], [8, 9, 10, 11, 12, 99]])
    mask = (torch.arange(6)[None] < torch.tensor([[4], [6]])).long()
    got, want = _tower_on_both(make, (ids, mask if padded else None))
    assert got.shape == (2, 1, 32) and _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# The compiled decode: a DecodeGraph against the eager step it captures, K2
# inside a graph, a capture that syncs, and PointBERT's sampling graph
# ---------------------------------------------------------------------------

# The int8 products of the main path: Vicuna-7B's (q/k/v/o, gate/up, down,
# the lm_head) and the tp 2 and 4 shards' column and row splits.
K5_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
             (4096, 2048), (4096, 1024), (4096, 5504), (4096, 2752),
             (4096, 16000), (4096, 8000), (2048, 4096), (1024, 4096),
             (5504, 4096), (2752, 4096)]


def _k5_inputs(gen, M, K, N, dtype=torch.bfloat16):
    x = torch.randn((M, 1, K), generator=gen, device="cuda").to(dtype)
    wq = {"q": torch.randint(-127, 128, (K, N), generator=gen,
                             device="cuda", dtype=torch.int8),
          "scale": torch.rand((1, N), generator=gen, device="cuda") * 1e-3
          + 1e-4}
    return x, wq


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("K,N", K5_SHAPES)
def test_k5_matches_plain(K, N, M):
    """K5 against the plain product at every main-path shape, with a bf16
    and an fp32 (the lm_head's logits) result; each call one launch."""
    gen = torch.Generator(device="cuda").manual_seed(K + N + M)
    x, wq = _k5_inputs(gen, M, K, N)
    for out in (None, torch.float32):
        n = dequant_matmul.launches
        got = dequant_matmul(x, wq, out_dtype=out)
        want = dequant_matmul_reference(x, wq, out_dtype=out)
        assert dequant_matmul.launches == n + 1
        assert got.shape == want.shape == (M, 1, N)
        assert got.dtype == want.dtype
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


def test_k5_fp16_and_ragged_k():
    """fp16 activations, and K not a multiple of a block's rows."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for K, N, M in ((4096, 4096, 2), (344, 48, 3), (1000, 272, 8),
                    (344, 48, 1), (1000, 272, 2), (11008, 2752, 1)):
        x, wq = _k5_inputs(gen, M, K, N, torch.float16)
        for out in (None, torch.float32):
            got = dequant_matmul(x, wq, out_dtype=out)
            want = dequant_matmul_reference(x, wq, out_dtype=out)
            assert got.dtype == (out or torch.float16)
            assert _rel(got, want) <= (1e-5 if out else 2e-2)


@pytest.mark.parametrize("K,N", [(4096, 2752), (4096, 8000)])
def test_k5_fp16_at_eight_rows(K, N):
    """fp16 activations at the pool's 8 rows on the tp 4 gate/up and
    lm_head shards (N not a multiple of 128)."""
    gen = torch.Generator(device="cuda").manual_seed(K + N)
    x, wq = _k5_inputs(gen, 8, K, N, torch.float16)
    for out in (None, torch.float32):
        got = dequant_matmul(x, wq, out_dtype=out)
        want = dequant_matmul_reference(x, wq, out_dtype=out)
        assert got.dtype == (out or torch.float16)
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


@pytest.mark.parametrize("M,K,N,pad", [(8, 4096, 4096, 8), (8, 4096, 11008, 3),
                                       (5, 1000, 272, 24), (2, 344, 48, 1),
                                       (2, 11008, 4096, 5),
                                       (1, 4096, 32000, 3)])
def test_k5_row_strided_x(M, K, N, pad):
    """x with a row stride past K (a view of wider rows; an odd pad also
    breaks the rows' 16-byte alignment): the rows of B past M stay zero
    and nothing past a row's K columns is read."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + pad)
    wide = torch.randn((M, 1, K + pad), generator=gen, device="cuda").to(
        torch.bfloat16)
    wide[..., K:] = float("nan")  # read past K, it would poison the sums
    x = wide[..., :K]
    _, wq = _k5_inputs(gen, M, K, N)
    for out in (None, torch.float32):
        got = dequant_matmul(x, wq, out_dtype=out)
        want = dequant_matmul_reference(x.contiguous(), wq, out_dtype=out)
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


def test_k5_is_deterministic():
    """Two launches give the same bits: the split-K partials are added in
    split order by the last block of a tile, never by float atomics."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for K, N, M in ((11008, 4096, 8), (4096, 32000, 1), (4096, 1024, 3)):
        x, wq = _k5_inputs(gen, M, K, N)
        first = dequant_matmul(x, wq, out_dtype=torch.float32)
        for _ in range(3):
            assert torch.equal(dequant_matmul(x, wq, out_dtype=torch.float32),
                               first)


def test_k5_large_m_takes_the_plain_product():
    """Above K5_MAX_ROWS rows (prefill sizes) the product is K6's: one K6
    launch and no K5 launch, held to the plain product."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, wq = _k5_inputs(gen, quant.K5_MAX_ROWS + 1, 256, 512)
    n5, n6 = dequant_matmul.launches, quant.w8a16_gemm.launches
    got = dequant_matmul(x, wq, out_dtype=torch.float32)
    assert dequant_matmul.launches == n5
    assert quant.w8a16_gemm.launches == n6 + 1
    want = dequant_matmul_reference(x, wq, out_dtype=torch.float32)
    assert _rel(got, want) <= 1e-5


def test_k5_graph_replays_the_eager_call_and_owns_its_scratch():
    """Three K5 calls captured on one stream, the scratch growing inside
    the capture, then eager calls at a larger shape on that stream (which
    outgrow the stream's own scratch): the replay writes to scratch its
    record keeps, gives the eager outputs bit for bit, and is counted."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [_k5_inputs(gen, M, K, N) for M, K, N in (
        (1, 1024, 4096), (2, 4096, 11008), (4, 4096, 32000))]
    eager = [dequant_matmul(x, wq, out_dtype=torch.float32)
             for x, wq in cases]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        with quant.capturing() as record:
            graph.capture_begin()
            outs = [dequant_matmul(x, wq, out_dtype=torch.float32)
                    for x, wq in cases]
            graph.capture_end()
        assert record.launches == [(1, 1024, 4096), (2, 4096, 11008),
                                   (4, 4096, 32000)]
        assert record.scratch.outgrown  # grown inside the capture
        x, wq = _k5_inputs(gen, 8, 11008, 32000)
        dequant_matmul(x, wq)
        n = dequant_matmul.launches
        graph.replay()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    assert dequant_matmul.launches == n  # a raw replay is the owner's to count
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


def test_k5_in_a_captured_step_is_counted_at_each_replay():
    """A CapturedStep (the base of every graph of the port) records K5's
    launches and adds them to the counter at each replay."""
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, wq = _k5_inputs(gen, 2, 4096, 4096)

    class Step(CapturedStep):
        def _step(self):
            return dequant_matmul(dequant_matmul(x, wq), wq)
    step = Step("cuda")
    want = dequant_matmul(dequant_matmul(x, wq), wq)
    for _ in range(3):
        n = dequant_matmul.launches
        assert torch.equal(step.run(), want)
        assert dequant_matmul.launches == n + 2
    assert step.graph is not None and len(step.k5.launches) == 2


def test_k5_captured_outside_a_record_raises():
    """A K5 launch captured with no record would run uncounted at every
    replay: it raises instead."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, wq = _k5_inputs(gen, 1, 4096, 4096)
    dequant_matmul(x, wq)  # built
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                dequant_matmul(x, wq)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["n_not_16", "q_not_contiguous", "x_fp32",
                                  "x_strided", "scale_bf16", "q_on_cpu"])
def test_k5_rejects(case):
    """What K5 does not take raises, on the card too (no fallback)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, wq = _k5_inputs(gen, 2, 256, 64)
    if case == "n_not_16":
        wq = {"q": wq["q"][:, :40].contiguous(),
              "scale": wq["scale"][:, :40].contiguous()}
    elif case == "q_not_contiguous":
        wq = dict(wq, q=torch.randint(-127, 128, (64, 256), generator=gen,
                                      device="cuda", dtype=torch.int8).t())
    elif case == "x_fp32":
        x = x.float()
    elif case == "x_strided":
        x = torch.zeros((2, 1, 512), dtype=torch.bfloat16,
                        device="cuda")[..., ::2]
    elif case == "scale_bf16":
        wq = dict(wq, scale=wq["scale"].to(torch.bfloat16))
    elif case == "q_on_cpu":
        wq = dict(wq, q=wq["q"].cpu())
    with pytest.raises((TypeError, ValueError)):
        # fp32 x takes the plain product by dtype in dequant_matmul: K5's
        # own wrapper is what refuses it
        quant._k5_call(x, [wq], None)


@pytest.mark.parametrize("M,rows,tile,members", [
    (2, 512, 32, 1),     # not a tile of either kernel
    (3, 512, 512, 1),    # the streaming kernel's tile at three rows
    (1, 100, 512, 1),    # the streaming kernel takes whole 8-row runs
    (2, 512, 128, 2),    # the tensor-core kernel takes one weight
    (2, 520, 128, 1),    # ... whole 16-row steps
    (2, 4096, 128, 1),   # ... and at most 2048 rows a block
    (1, 512, 512, 4)])   # at most three weights a launch
def test_k5_entry_refuses_other_grids(M, rows, tile, members):
    """The C entry refuses a tile, a split or a group the grid rule cannot
    produce (cudaErrorInvalidValue), before launching anything."""
    import ctypes
    from modelcompose_tpu_torch import _build
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, wq = _k5_inputs(gen, M, 4096, 1024)
    part = torch.empty(64 * M * 1024 * members, device="cuda")
    counters = torch.zeros(64 * members, dtype=torch.int32, device="cuda")
    outs = [torch.empty((M, 1024), device="cuda") for _ in range(members)]

    def pointers(ts):
        return (ctypes.c_void_p * members)(*[t.data_ptr() for t in ts])
    err = _build.load("w8a16_gemv").mc_w8a16_gemv(
        x.data_ptr(), members, pointers([wq["q"]] * members),
        pointers([wq["scale"]] * members), pointers(outs),
        (ctypes.c_int * members)(*[1024] * members), part.data_ptr(),
        counters.data_ptr(), M, 4096, 4096, rows, tile, 1, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("K,N", K5_SHAPES)
def test_k5_streaming_kernel_fp16(K, N, M):
    """The streaming kernel (1-2 rows) on fp16 activations at every
    main-path shape, with an fp16 and an fp32 result."""
    gen = torch.Generator(device="cuda").manual_seed(K + N + M + 1)
    x, wq = _k5_inputs(gen, M, K, N, torch.float16)
    for out in (None, torch.float32):
        got = dequant_matmul(x, wq, out_dtype=out)
        want = dequant_matmul_reference(x, wq, out_dtype=out)
        assert got.dtype == (out or torch.float16)
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


# The products that share an input: q/k/v, gate/up and their tp 2 and 4
# column shards, and a ragged K with a narrow member.
K5_GROUPS = [(4096, (4096,) * 3), (4096, (11008,) * 2),
             (4096, (2048,) * 3), (4096, (5504,) * 2), (4096, (1024,) * 3),
             (4096, (2752,) * 2), (1000, (272, 48, 1024))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("K,Ns", K5_GROUPS)
def test_k5_group_matches_plain(K, Ns, M, dtype):
    """One launch for the weights that share x, each member's output held
    to its plain product (bf16/fp16 and fp32 results), and bit-equal to
    nothing else: every member is its own output."""
    from modelcompose_tpu_torch.ops.quant import dequant_matmul_group
    gen = torch.Generator(device="cuda").manual_seed(K + M + len(Ns))
    x, _ = _k5_inputs(gen, M, K, 16, dtype)
    weights = [_k5_inputs(gen, M, K, N)[1] for N in Ns]
    for out in (None, torch.float32):
        n = dequant_matmul.launches
        got = dequant_matmul_group(x, weights, out_dtype=out)
        assert dequant_matmul.launches == n + 1
        for y, wq, N in zip(got, weights, Ns):
            want = dequant_matmul_reference(x, wq, out_dtype=out)
            assert y.shape == want.shape == (M, 1, N)
            assert y.dtype == want.dtype
            assert _rel(y, want) <= (1e-5 if out else 2e-2)


def test_k5_group_row_strided_and_three_rows():
    """A row-strided x at two rows (each member reads only its K columns),
    and at three rows a group is each member's own launch, as before."""
    from modelcompose_tpu_torch.ops.quant import dequant_matmul_group
    gen = torch.Generator(device="cuda").manual_seed(12)
    weights = [_k5_inputs(gen, 2, 4096, N)[1] for N in (4096, 1024, 1024)]
    wide = torch.randn((2, 1, 4096 + 5), generator=gen, device="cuda").to(
        torch.bfloat16)
    wide[..., 4096:] = float("nan")
    x = wide[..., :4096]
    got = dequant_matmul_group(x, weights, out_dtype=torch.float32)
    for y, wq in zip(got, weights):
        want = dequant_matmul_reference(x.contiguous(), wq,
                                        out_dtype=torch.float32)
        assert _rel(y, want) <= 1e-5
    x3 = torch.randn((3, 1, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    n = dequant_matmul.launches
    got = dequant_matmul_group(x3, weights, out_dtype=torch.float32)
    assert dequant_matmul.launches == n + 3
    for y, wq in zip(got, weights):
        assert torch.equal(y, dequant_matmul(x3, wq, out_dtype=torch.float32))


def test_k5_group_is_deterministic_and_replays_bit_for_bit():
    """Grouped launches give the same bits every time, and a captured one
    replays the eager call's bits with scratch its record keeps; the record
    counts the grouped launch once."""
    from modelcompose_tpu_torch.ops.quant import dequant_matmul_group
    gen = torch.Generator(device="cuda").manual_seed(13)
    for M in (1, 2):
        x, _ = _k5_inputs(gen, M, 4096, 16)
        weights = [_k5_inputs(gen, M, 4096, N)[1] for N in (11008, 11008)]
        first = dequant_matmul_group(x, weights, out_dtype=torch.float32)
        for _ in range(3):
            again = dequant_matmul_group(x, weights, out_dtype=torch.float32)
            assert all(torch.equal(a, b) for a, b in zip(again, first))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph = torch.cuda.CUDAGraph()
            with quant.capturing() as record:
                graph.capture_begin()
                outs = dequant_matmul_group(x, weights,
                                            out_dtype=torch.float32)
                graph.capture_end()
            assert record.launches == [(M, 4096, (11008, 11008))]
            graph.replay()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, first))


def test_k5_group_backward_matches_plain():
    """dL/dx through a grouped launch: the members' plain dL/dx summed."""
    from modelcompose_tpu_torch.ops.quant import dequant_matmul_group
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, _ = _k5_inputs(gen, 2, 4096, 16)
    weights = [_k5_inputs(gen, 2, 4096, N)[1] for N in (4096, 1024, 1024)]
    gs = [torch.randn((2, 1, N), generator=gen, device="cuda")
          for N in (4096, 1024, 1024)]
    xr = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        dequant_matmul_group(xr, weights, out_dtype=torch.float32), xr, gs)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        [dequant_matmul_reference(xr, wq, out_dtype=torch.float32)
         for wq in weights], xr, gs)
    assert got.dtype == x.dtype
    assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("out", [None, torch.float32])
def test_k5_backward_matches_plain(out):
    """dL/dx through K5's autograd Function against the plain product's
    autograd, on the same cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    x, wq = _k5_inputs(gen, 4, 4096, 11008)
    g = torch.randn((4, 1, 11008), generator=gen, device="cuda").to(
        out or x.dtype)
    grads = []
    for fn in (dequant_matmul, dequant_matmul_reference):
        xr = x.clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(fn(xr, wq, out_dtype=out), xr, g)
        grads.append(dx)
    assert grads[0].dtype == x.dtype
    assert _rel(grads[0], grads[1]) <= 2e-2



# ---------------------------------------------------------------------------
# K6: the int8 product above K5_MAX_ROWS rows (prefill, chunks, the train
# forward on an int8 base) against the plain product
# ---------------------------------------------------------------------------

# The rows of the main path's products above 8: a tail chunk, a chunk (the
# smallest bucket), the EVA + ImageBind bucket's 698 valid rows, the vision
# pair, MCUB-4's 3,287 in its 3,328 bucket, the train batch; and 9, 37.
K6_ROWS = [9, 37, 256, 512, 698, 2048, 3287, 3328, 4096]


@pytest.mark.parametrize("M", K6_ROWS)
@pytest.mark.parametrize("K,N", K5_SHAPES)
def test_k6_matches_plain(K, N, M):
    """K6 against the plain product at every main-path shape and tp shard
    and every row count above, with a bf16 and an fp32 (the routed LoRA's)
    result; each call one K6 launch and no K5 launch."""
    gen = torch.Generator(device="cuda").manual_seed(K + N + M)
    x, wq = _k5_inputs(gen, M, K, N)
    for out in (None, torch.float32):
        n5, n6 = dequant_matmul.launches, quant.w8a16_gemm.launches
        got = dequant_matmul(x, wq, out_dtype=out)
        assert (dequant_matmul.launches, quant.w8a16_gemm.launches) == (
            n5, n6 + 1)
        want = dequant_matmul_reference(x, wq, out_dtype=out)
        assert got.shape == want.shape == (M, 1, N)
        assert got.dtype == want.dtype
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


@pytest.mark.parametrize("M", [9, 512, 3328])
@pytest.mark.parametrize("K,N", [(4096, 4096), (11008, 4096), (4096, 2752),
                                 (4096, 32000)])
def test_k6_fp16(K, N, M):
    """fp16 activations (the f16 wgmma, the magic-number convert), with an
    fp16 and an fp32 result."""
    gen = torch.Generator(device="cuda").manual_seed(K + N + M + 2)
    x, wq = _k5_inputs(gen, M, K, N, torch.float16)
    for out in (None, torch.float32):
        got = quant.w8a16_gemm(x, wq, out_dtype=out)
        want = dequant_matmul_reference(x, wq, out_dtype=out)
        assert got.dtype == (out or torch.float16)
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


@pytest.mark.parametrize("M,K,N", [(9, 344, 48), (37, 1000, 272),
                                   (130, 2752, 4112), (200, 8, 16),
                                   (1, 4096, 4096), (700, 5504, 2752),
                                   (65, 4104, 8000)])
def test_k6_ragged_edges(M, K, N):
    """M, N and K off every tile edge (zero-filled on load, clipped on
    store; 8-row K, 16-column N), and one row (K6 alone takes any M)."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    x, wq = _k5_inputs(gen, M, K, N)
    for out in (None, torch.float32):
        got = quant.w8a16_gemm(x, wq, out_dtype=out)
        want = dequant_matmul_reference(x, wq, out_dtype=out)
        assert got.shape == (M, 1, N)
        assert _rel(got, want) <= (1e-5 if out else 2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,split", sorted(quant._K6_RATES))
def test_k6_every_block(monkeypatch, rows, split, dtype):
    """Each block and split K6 takes (128 weight columns by 64, 128 or 256
    rows, K split over clusters of 1, 2 or 4), whatever the plan would
    pick, on the card's clusters, at ragged M, N and K: every tile split
    (or, split 1, whole) at 300 rows, whole waves and a split tail at
    3,400 rows (a raster group that does not divide the row tiles), held
    to the plain product."""
    assert (rows, split) in quant._K6_RATES
    plan = quant._k6_plan
    forced = []

    def force(M, K, N, active=None):
        forced.append(plan(M, K, N, active, blocks=[(rows, split)]))
        return forced[-1]
    monkeypatch.setattr(quant, "_k6_plan", force)
    gen = torch.Generator(device="cuda").manual_seed(rows + split)
    for M, K, N in ((300, 4104, 2752), (3400, 4104, 4112)):
        x, wq = _k5_inputs(gen, M, K, N, dtype)
        for out in (None, torch.float32):
            got = quant.w8a16_gemm(x, wq, out_dtype=out)
            want = dequant_matmul_reference(x, wq, out_dtype=out)
            assert _rel(got, want) <= (1e-5 if out else 2e-2)
        tiles = forced[-1].m_tiles * forced[-1].n_tiles
        assert (forced[-1].rows, forced[-1].split) == (rows, split)
        if split > 1:
            assert forced[-1].whole == 0 if M == 300 \
                else 0 < forced[-1].whole < tiles


def test_k6_active_clusters():
    """The card's clusters of each (rows, split), asked once: at least one,
    at most the SMs' worth; the plan on them splits a 512-row chunk's
    4096-wide product over clusters of 256-row blocks."""
    active = quant._k6_active(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert set(active) == set(quant._K6_RATES)
    for (rows, split), n in active.items():
        assert 1 <= n * split <= sms
    assert quant._k6_active(torch.device("cuda")) is active
    chunk = quant._k6_plan(512, 4096, 4096, active)
    assert chunk.rows == 256 and chunk.split > 1


def test_k6_row_strided_x():
    """x with a row stride past K (a view of wider rows, NaN past K): the
    wrapper hands K6 whole rows, and nothing past K is read."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    wide = torch.randn((300, 1, 4096 + 24), generator=gen,
                       device="cuda").to(torch.bfloat16)
    wide[..., 4096:] = float("nan")
    x = wide[..., :4096]
    _, wq = _k5_inputs(gen, 300, 4096, 4096)
    got = dequant_matmul(x, wq, out_dtype=torch.float32)
    want = dequant_matmul_reference(x.contiguous(), wq,
                                    out_dtype=torch.float32)
    assert _rel(got, want) <= 1e-5


def test_k6_is_deterministic():
    """Every output is one block's sum, or a cluster's partial sums added
    in rank order, in a fixed order: repeated launches give the same bits,
    at shapes whose plan splits K (a 512-row chunk, the 3,328 bucket's
    tail) and at ones that do not."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    active = quant._k6_active(torch.device("cuda"))
    assert quant._k6_plan(512, 4096, 4096, active).split > 1
    assert quant._k6_plan(3328, 4096, 4096, active).split > 1
    for M, K, N in ((3328, 11008, 4096), (512, 4096, 32000), (256, 4096,
                                                              11008),
                    (512, 4096, 4096), (3328, 4096, 4096),
                    (300, 4104, 2752)):
        x, wq = _k5_inputs(gen, M, K, N)
        first = dequant_matmul(x, wq, out_dtype=torch.float32)
        for _ in range(3):
            assert torch.equal(dequant_matmul(x, wq, out_dtype=torch.float32),
                               first)


def test_k6_graph_replays_the_eager_call_and_is_counted():
    """K6 launches captured in a record replay the eager calls' bits, at
    shapes whose plan splits K in clusters (the first two) and at one row
    tile; in a CapturedStep each replay adds the recorded launches to K6's
    count."""
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    active = quant._k6_active(torch.device("cuda"))
    assert quant._k6_plan(512, 4096, 4096, active).split > 1
    assert quant._k6_plan(3328, 4096, 11008, active).split > 1
    gen = torch.Generator(device="cuda").manual_seed(18)
    cases = [_k5_inputs(gen, M, K, N) for M, K, N in (
        (512, 4096, 4096), (3328, 4096, 11008), (9, 11008, 4096))]
    eager = [dequant_matmul(x, wq, out_dtype=torch.float32)
             for x, wq in cases]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        with quant.capturing() as record:
            graph.capture_begin()
            outs = [dequant_matmul(x, wq, out_dtype=torch.float32)
                    for x, wq in cases]
            graph.capture_end()
        assert record.gemm == [(512, 4096, 4096), (3328, 4096, 11008),
                               (9, 11008, 4096)]
        assert record.launches == []
        n = quant.w8a16_gemm.launches
        graph.replay()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    assert quant.w8a16_gemm.launches == n  # a raw replay is the owner's
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)

    x, wq = cases[0]

    class Step(CapturedStep):
        def _step(self):
            return dequant_matmul(dequant_matmul(x, wq), wq)
    step = Step("cuda")
    want = dequant_matmul(dequant_matmul(x, wq), wq)
    for _ in range(3):
        n = quant.w8a16_gemm.launches
        assert torch.equal(step.run(), want)
        assert quant.w8a16_gemm.launches == n + 2
    assert step.graph is not None and len(step.k5.gemm) == 2


def test_k6_captured_outside_a_record_raises():
    """A K6 launch captured with no record would run uncounted at every
    replay: it raises instead."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    x, wq = _k5_inputs(gen, 64, 4096, 4096)
    dequant_matmul(x, wq)  # built
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                dequant_matmul(x, wq)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["n_not_16", "k_not_8", "q_not_contiguous",
                                  "x_fp32", "scale_bf16", "q_on_cpu"])
def test_k6_rejects(case):
    """What K6 does not take raises on the card (no fallback)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    x, wq = _k5_inputs(gen, 64, 256, 64)
    if case == "n_not_16":
        wq = {"q": wq["q"][:, :40].contiguous(),
              "scale": wq["scale"][:, :40].contiguous()}
    elif case == "k_not_8":
        x, wq = _k5_inputs(gen, 64, 252, 64)
    elif case == "q_not_contiguous":
        wq = dict(wq, q=torch.randint(-127, 128, (64, 256), generator=gen,
                                      device="cuda", dtype=torch.int8).t())
    elif case == "x_fp32":
        x = x.float()
    elif case == "scale_bf16":
        wq = dict(wq, scale=wq["scale"].to(torch.bfloat16))
    elif case == "q_on_cpu":
        wq = dict(wq, q=wq["q"].cpu())
    with pytest.raises((TypeError, ValueError)):
        # fp32 x takes the plain product by dtype in dequant_matmul: K6's
        # own wrapper is what refuses it
        quant.w8a16_gemm(x, wq)


@pytest.mark.parametrize("rows,K,N,group,split,clusters,whole", [
    (32, 4096, 1024, 4, 1, 8, 8), (192, 4096, 1024, 4, 1, 8, 8),
    (512, 4096, 1024, 4, 1, 8, 8), (256, 4092, 1024, 4, 1, 8, 8),
    (256, 4096, 1000, 4, 1, 8, 8), (256, 4096, 1024, 0, 1, 8, 8),
    (256, 4096, 1024, 1, 3, 2, 0), (256, 4096, 1024, 1, 8, 1, 0),
    (256, 4096, 1024, 1, 1, 0, 8), (256, 4096, 1024, 1, 1, 8, 7),
    (256, 4096, 1024, 1, 2, 4, 8), (256, 4096, 1024, 1, 2, 1, 3),
    (256, 64, 1024, 1, 2, 4, 0), (256, 4096, 1024, 1, 2, 4, -2)])
def test_k6_entry_refuses_other_grids(rows, K, N, group, split, clusters,
                                      whole):
    """The C entry refuses rows and splits the plan cannot produce, a K or
    N TMA cannot read, an empty raster group, no clusters, and schedules
    the plan cannot make (split 1 with a tile not whole, a split with no
    tile or fewer steps to split, whole tiles not whole waves of the
    grid): cudaErrorInvalidValue, before launching anything."""
    from modelcompose_tpu_torch import _build
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((256, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = torch.zeros((K, N), dtype=torch.int8, device="cuda")
    scale = torch.ones(N, device="cuda")
    out = torch.empty((256, N), device="cuda")
    err = _build.load("w8a16_gemm").mc_w8a16_gemm(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), 256, K,
        N, rows, group, split, clusters, whole, 1, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("out", [None, torch.float32])
def test_k6_backward_matches_plain(out):
    """dL/dx through K6's autograd Function (the int8-base train forward)
    against the plain product's autograd, on the same cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    x, wq = _k5_inputs(gen, 1024, 4096, 11008)
    g = torch.randn((1024, 1, 11008), generator=gen, device="cuda").to(
        out or x.dtype)
    grads = []
    for fn in (dequant_matmul, dequant_matmul_reference):
        xr = x.clone().requires_grad_(True)
        y = fn(xr, wq, out_dtype=out)
        (dx,) = torch.autograd.grad(y, xr, g)
        grads.append((y, dx))
    (y6, dx6), (yp, dxp) = grads
    assert dx6.dtype == x.dtype
    assert _rel(y6, yp) <= (1e-5 if out else 2e-2)
    assert _rel(dx6, dxp) <= 2e-2


# ---------------------------------------------------------------------------
# K7: dL/dx of the int8 products (the train step on an int8 base) against
# its plain version; fp32 x on an int8 weight
# ---------------------------------------------------------------------------

# dL/dx's shapes on the train path (M, K, N): dx [M, K] = (g [M, N] *
# scale) @ q [K, N]^T at the DAMC recipes' B=4 x 2,048 and the QLoRA
# recipe's B=16 x 2,048 rows (q/k/v/o, gate/up, down), and the lm_head at a
# loss chunk of 256 positions of one, four and sixteen rows.
K7_SHAPES = [(M, K, N) for M in (8192, 32768)
             for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))] + [
    (M, 4096, 32000) for M in (256, 1024, 4096)]


def _k7_inputs(gen, M, K, N, g_dtype=torch.float32, x_dtype=torch.bfloat16):
    """A cotangent g [M, N] (rows of 1,024-scale values: the logits' and
    the routed products' grads are O(1) after a loss over ~1e3 rows) and
    a weight [K, N] as ``_k5_inputs`` makes it."""
    g = torch.randn((M, N), generator=gen, device="cuda").to(g_dtype)
    _, wq = _k5_inputs(gen, 1, K, N, x_dtype)
    return g, wq


def _k7_plain(g, wq, dtype):
    return quant._dequant_matmul_dx(g, wq["q"], wq["scale"], dtype)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", K7_SHAPES)
def test_k7_matches_plain(M, K, N, g_dtype):
    """K7 against its plain version at every dL/dx shape of the train path,
    with an fp32 (the routed products', the logits') and a bf16 cotangent:
    the same bf16 operands, so only the summation order differs before
    the one rounding to bf16; one K7 launch each."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    g, wq = _k7_inputs(gen, M, K, N, g_dtype)
    n7 = quant.w8a16_dx.launches
    got = quant.w8a16_dx(g, wq, torch.bfloat16)
    assert quant.w8a16_dx.launches == n7 + 1
    want = _k7_plain(g, wq, torch.bfloat16)
    assert got.shape == want.shape == (M, K) and got.dtype == torch.bfloat16
    assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.float16,
                                     torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8192, 4096, 11008), (1024, 4096, 32000),
                                   (700, 11008, 4096)])
def test_k7_fp16(M, K, N, g_dtype):
    """fp16 x (the f16 wgmma, the magic-number convert, dx in fp16) with an
    fp32, fp16 or bf16 cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N + 3)
    g, wq = _k7_inputs(gen, M, K, N, g_dtype, torch.float16)
    got = quant.w8a16_dx(g, wq, torch.float16)
    assert got.dtype == torch.float16
    assert _rel(got, _k7_plain(g, wq, torch.float16)) <= 2e-2


@pytest.mark.parametrize("M,K,N", [(9, 344, 48), (37, 1000, 272),
                                   (130, 2752, 4112), (200, 8, 16),
                                   (1, 4096, 4096), (2, 4096, 11008),
                                   (700, 5504, 2752), (65, 4104, 8000)])
def test_k7_ragged_edges(M, K, N):
    """M, K and N off every tile edge (zero-filled on load, clipped on
    store; 8-column K, 16-deep N) and one or two rows (K7 takes any M)."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N + 5)
    for g_dtype in (torch.float32, torch.bfloat16):
        g, wq = _k7_inputs(gen, M, K, N, g_dtype)
        got = quant.w8a16_dx(g, wq, torch.bfloat16)
        assert got.shape == (M, K)
        assert _rel(got, _k7_plain(g, wq, torch.bfloat16)) <= 2e-2


@pytest.mark.parametrize("rows", [256, 128])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
def test_k7_every_block(monkeypatch, g_dtype, rows):
    """K7's product at each block the plan can pick (``rows`` of the
    scaled cotangent by 128 dx columns) with each cotangent type, at
    ragged M and K with a raster group that does not divide the row
    tiles."""
    assert rows in quant._K7_RATES
    gen = torch.Generator(device="cuda").manual_seed(rows + 7)
    g, wq = _k7_inputs(gen, 700, 2752, 4096, g_dtype)
    monkeypatch.setattr(quant, "_k7_plan", lambda M, K, N: (
        rows, -(-M // rows), -(-K // quant._K7_COLS), 3))
    got = quant.w8a16_dx(g, wq, torch.bfloat16)
    assert _rel(got, _k7_plain(g, wq, torch.bfloat16)) <= 2e-2


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("M,N", [(8192, 4096), (1024, 32000), (37, 272),
                                 (1, 48)])
def test_k7_scale_pass_is_the_plain_one(M, N, g_dtype, x_dtype):
    """K7's first pass alone, gs = T(g * scale), bit-equal to
    ``_scale_cotangent`` for each cotangent and x type, at the train
    shapes and at a ragged N and M, on contiguous rows and on a view of
    wider rows (NaN past N; copied to whole rows first)."""
    gen = torch.Generator(device="cuda").manual_seed(M + N)
    wide = torch.randn((M, N + 64), generator=gen, device="cuda").to(g_dtype)
    wide[:, N:] = float("nan")
    scale = torch.rand((1, N), generator=gen, device="cuda") * 1e-3 + 1e-4
    for g in (wide[:, :N].contiguous(), wide[:, :N]):
        got = quant._k7_scale(g, scale, x_dtype)
        want = quant._scale_cotangent(g, scale, x_dtype)
        assert got.dtype == x_dtype and got.shape == (M, N)
        assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(8192, 4096, 4096), (1024, 4096, 32000),
                                   (512, 4096, 32000), (256, 4096, 32000),
                                   (9, 344, 48)])
def test_k7_product_pass_matches_plain(M, K, N):
    """K7's second pass alone on a given gs against the fp32-accumulated
    product of the same bf16 operands, and the two passes called one by
    one bit-equal to the one call of ``w8a16_dx``."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N + 9)
    g, wq = _k7_inputs(gen, M, K, N)
    gs = quant._k7_scale(g, wq["scale"], torch.bfloat16)
    got = quant._k7_product(gs, wq["q"])
    want = quant._mm_f32(gs, wq["q"].to(torch.bfloat16).t()).bfloat16()
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, quant.w8a16_dx(g, wq, torch.bfloat16))


def test_k7_strided_cotangent():
    """A cotangent that is a view of wider rows (NaN past N) goes to K7 as
    whole rows, and nothing past N is read."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    wide = torch.randn((300, 4096 + 32), generator=gen, device="cuda")
    wide[:, 4096:] = float("nan")
    g = wide[:, :4096]
    _, wq = _k7_inputs(gen, 1, 2048, 4096)
    got = quant.w8a16_dx(g, wq, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, _k7_plain(g.contiguous(), wq, torch.bfloat16)) <= 2e-2


def test_k7_is_deterministic():
    """Every dx is one block's sum in a fixed order (no split of the
    contraction): repeated launches give the same bits; each call of
    ``w8a16_dx`` (both passes) counts one K7 launch."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    for M, K, N in ((8192, 4096, 11008), (1024, 4096, 32000),
                    (256, 4096, 32000), (8192, 11008, 4096)):
        g, wq = _k7_inputs(gen, M, K, N)
        first = quant.w8a16_dx(g, wq, torch.bfloat16)
        for _ in range(3):
            n7 = quant.w8a16_dx.launches
            assert torch.equal(quant.w8a16_dx(g, wq, torch.bfloat16), first)
            assert quant.w8a16_dx.launches == n7 + 1


def test_k7_graph_replays_the_eager_call_and_is_counted():
    """K7 launches captured in a record replay the eager calls' bits; in a
    CapturedStep each replay adds the recorded launches to K7's count,
    those of a backward run on autograd's thread too."""
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    gen = torch.Generator(device="cuda").manual_seed(25)
    cases = [_k7_inputs(gen, M, K, N) for M, K, N in (
        (512, 4096, 4096), (1024, 4096, 32000), (9, 11008, 4096))]
    eager = [quant.w8a16_dx(g, wq, torch.bfloat16) for g, wq in cases]
    # the scaled cotangent of each captured call, by its address
    lib = quant._build.load("w8a16_dx")
    entry, scratch = lib.mc_w8a16_dx, []

    def recording(*args):
        scratch.append(args[3])
        return entry(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        with quant.capturing() as record:
            lib.mc_w8a16_dx = recording
            try:
                graph.capture_begin()
                outs = [quant.w8a16_dx(g, wq, torch.bfloat16)
                        for g, wq in cases]
                graph.capture_end()
            finally:
                lib.mc_w8a16_dx = entry
        assert record.dx == [(512, 4096, 4096), (1024, 4096, 32000),
                             (9, 11008, 4096)]
        assert record.launches == record.gemm == []
        n = quant.w8a16_dx.launches
        graph.replay()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    assert quant.w8a16_dx.launches == n  # a raw replay is the owner's
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)
    # gs came from the graph's private pool
    pool = tuple(graph.pool())
    segments = [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == pool]
    assert len(scratch) == len(cases) and all(
        any(seg["address"] <= p < seg["address"] + seg["total_size"]
            for seg in segments) for p in scratch)
    for g, wq in cases:  # eager calls between replays leave them unchanged
        quant.w8a16_dx(g, wq, torch.bfloat16)
    with torch.cuda.stream(stream):
        graph.replay()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)

    gen = torch.Generator(device="cuda").manual_seed(26)
    x, wq = _k5_inputs(gen, 512, 4096, 4096)
    g = torch.randn((512, 1, 4096), generator=gen, device="cuda")
    x.requires_grad_(True)

    def grad():
        y = dequant_matmul(x, wq, out_dtype=torch.float32)
        return torch.autograd.grad(y, x, g)[0]

    class Step(CapturedStep):
        def _compute(self):  # a backward: the step in grad mode
            return grad()
    step = Step("cuda")
    want = grad()
    for _ in range(3):
        n6, n7 = quant.w8a16_gemm.launches, quant.w8a16_dx.launches
        assert torch.equal(step.run(), want)
        assert (quant.w8a16_gemm.launches, quant.w8a16_dx.launches) == (
            n6 + 1, n7 + 1)
    assert step.graph is not None
    assert len(step.k5.gemm) == len(step.k5.dx) == 1


def test_k7_captured_outside_a_record_raises():
    """A K7 launch captured with no record would run uncounted at every
    replay: it raises instead."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    g, wq = _k7_inputs(gen, 64, 4096, 4096)
    quant.w8a16_dx(g, wq, torch.bfloat16)  # built
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                quant.w8a16_dx(g, wq, torch.bfloat16)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["x_fp32", "g_fp64", "n_not_16", "k_not_8",
                                  "q_not_contiguous", "scale_bf16",
                                  "q_on_cpu"])
def test_k7_rejects(case):
    """What K7 does not take raises on the card (no fallback)."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    g, wq = _k7_inputs(gen, 64, 256, 64)
    dtype = torch.bfloat16
    if case == "x_fp32":
        dtype = torch.float32
    elif case == "g_fp64":
        g = g.double()
    elif case == "n_not_16":
        g = g[:, :40].contiguous()
        wq = {"q": wq["q"][:, :40].contiguous(),
              "scale": wq["scale"][:, :40].contiguous()}
    elif case == "k_not_8":
        _, wq = _k7_inputs(gen, 1, 252, 64)
    elif case == "q_not_contiguous":
        wq = dict(wq, q=torch.randint(-127, 128, (64, 256), generator=gen,
                                      device="cuda", dtype=torch.int8).t())
    elif case == "scale_bf16":
        wq = dict(wq, scale=wq["scale"].to(torch.bfloat16))
    elif case == "q_on_cpu":
        wq = dict(wq, q=wq["q"].cpu())
    with pytest.raises((TypeError, ValueError)):
        quant.w8a16_dx(g, wq, dtype)


@pytest.mark.parametrize("K,N,rows,group,g_type", [
    (4092, 1024, 256, 4, 0), (4096, 1000, 256, 4, 0), (4096, 1024, 256, 0, 0),
    (4096, 1024, 256, 4, 3), (4096, 1024, 64, 4, 0)])
def test_k7_entry_refuses_other_grids(K, N, rows, group, g_type):
    """The C entry refuses a K or N TMA cannot read, an empty raster
    group, an unknown cotangent type and a block of other rows than 128
    or 256 (cudaErrorInvalidValue), before launching anything; so does the
    entry of the pass that reads the refused argument (the first: N and
    the cotangent type; the second: K, N, the rows and the group)."""
    from modelcompose_tpu_torch import _build
    lib = _build.load("w8a16_dx")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.zeros((256, N), device="cuda")
    q = torch.zeros((K, N), dtype=torch.int8, device="cuda")
    scale = torch.ones(N, device="cuda")
    gs = torch.empty((256, N), dtype=torch.bfloat16, device="cuda")
    dx = torch.empty((256, K), dtype=torch.bfloat16, device="cuda")
    err = lib.mc_w8a16_dx(
        g.data_ptr(), q.data_ptr(), scale.data_ptr(), gs.data_ptr(),
        dx.data_ptr(), 256, K, N, rows, group, g_type, 1, stream)
    assert err == 1  # cudaErrorInvalidValue
    if N % 16 or g_type == 3:
        assert lib.mc_w8a16_dx_scale(
            g.data_ptr(), scale.data_ptr(), gs.data_ptr(), 256, N, g_type,
            1, stream) == 1
    if K % 8 or N % 16 or rows not in (128, 256) or group < 1:
        assert lib.mc_w8a16_dx_product(
            gs.data_ptr(), q.data_ptr(), dx.data_ptr(), 256, K, N, rows,
            group, 1, stream) == 1


@pytest.mark.parametrize("M", [9, 1024])
@pytest.mark.parametrize("out", [None, torch.float32])
def test_k7_backward_matches_plain(M, out):
    """dL/dx through ``dequant_matmul``'s autograd Function (K6 forward, K7
    backward; one launch each) against the plain product's autograd, on
    the same cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(29 + M)
    x, wq = _k5_inputs(gen, M, 4096, 11008)
    g = torch.randn((M, 1, 11008), generator=gen, device="cuda").to(
        out or x.dtype)
    n6, n7 = quant.w8a16_gemm.launches, quant.w8a16_dx.launches
    xr = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(dequant_matmul(xr, wq, out_dtype=out), xr, g)
    assert (quant.w8a16_gemm.launches, quant.w8a16_dx.launches) == (
        n6 + 1, n7 + 1)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(dequant_matmul_reference(
        xr, wq, out_dtype=out), xr, g)
    assert dx.dtype == x.dtype
    assert _rel(dx, want) <= 2e-2


@pytest.mark.parametrize("M", [1, 2, 9, 37])
def test_fp32_x_on_card_takes_the_plain_product(M):
    """fp32 x on an int8 weight on the card: the plain product (no K5, K6
    or K7 launch) instead of a refusal, bit-equal to
    ``dequant_matmul_reference``, alone, as a group and through autograd."""
    gen = torch.Generator(device="cuda").manual_seed(30 + M)
    x, wq = _k5_inputs(gen, M, 4096, 4096, torch.float32)
    counts = (dequant_matmul.launches, quant.w8a16_gemm.launches,
              quant.w8a16_dx.launches)
    for out in (None, torch.float32):
        assert torch.equal(dequant_matmul(x, wq, out_dtype=out),
                           dequant_matmul_reference(x, wq, out_dtype=out))
    group = quant.dequant_matmul_group(x, [wq, wq], out_dtype=torch.float32)
    want = dequant_matmul_reference(x, wq, out_dtype=torch.float32)
    assert all(torch.equal(y, want) for y in group)
    xr = x.clone().requires_grad_(True)
    g = torch.randn((M, 1, 4096), generator=gen, device="cuda")
    (dx,) = torch.autograd.grad(dequant_matmul(xr, wq), xr, g)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(dequant_matmul_reference(xr, wq), xr, g)
    assert torch.equal(dx, want)
    assert (dequant_matmul.launches, quant.w8a16_gemm.launches,
            quant.w8a16_dx.launches) == counts


def _tiny_card_backbone(quantized_base):
    """A 2-layer bf16 backbone K2 takes (head_dim 64, GQA group 2), with
    nonzero LoRA B so the adapter branch counts."""
    from modelcompose_tpu_torch.config import tiny_test_config
    from modelcompose_tpu_torch.core.llama import init_params
    from modelcompose_tpu_torch.ops.quant import quantize_backbone
    cfg = tiny_test_config(hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=512, dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = init_params(cfg, gen, "cuda")
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"].normal_(0.0, 0.05, generator=gen)
    if quantized_base:
        params = quantize_backbone(params)
    return cfg, params, gen


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("quantized_base", [False, True])
def test_decode_graph_replays_the_eager_step_bit_for_bit(quantized_base,
                                                          kv_quant, B):
    """Prefill B rows, then 12 greedy steps eagerly and 12 through a
    DecodeGraph: ids equal and logits bit-equal at every step (the same
    kernels on the same addresses' data), and each replay counts the K2
    launches it ran, and with an int8 base the K5 launches: 4 a layer (q/k/v
    and gate/up one launch each) and the lm_head at 1-2 rows, 7 a layer and
    the lm_head at 3."""
    from modelcompose_tpu_torch.core import generate as tgen
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    cfg, params, gen = _tiny_card_backbone(quantized_base)
    L, S = 40, 60
    embeds = _rnd(gen, B, L, cfg.hidden_size)
    lengths = torch.tensor([40, 23, 31][:B], dtype=torch.int32,
                           device="cuda")
    seg = (torch.arange(L, device="cuda")[None] < lengths[:, None]).int()
    table = as_table(cfg.routing_table(), "cuda")
    graph = DecodeGraph(params, cfg, B, S, kv_quant=kv_quant,
                        routing_table=table)
    per_layer = 4 if B <= quant.K5_GROUP_ROWS else 7
    k5_per_step = (per_layer * cfg.num_hidden_layers + 1) \
        if quantized_base else 0
    runs = []
    for cache in (None, graph.cache):
        with torch.no_grad():
            logits, cache = tgen._prefill(params, cfg, embeds, None, table,
                                          seg, lengths, S, kv_quant=kv_quant,
                                          cache=cache)
        kv, steps = lengths, []
        for _ in range(12):
            tokens = logits.argmax(-1)
            if cache is graph.cache:
                n = flash_decode_attention.launches
                n5 = dequant_matmul.launches
                logits = graph(tokens, kv).clone()
                assert flash_decode_attention.launches \
                    == n + cfg.num_hidden_layers
                assert dequant_matmul.launches == n5 + k5_per_step
            else:
                with torch.no_grad():
                    logits, cache, _ = tgen._decode_step(
                        params, cfg, cache, tokens, kv, table)
            kv = kv + 1
            steps.append((tokens, logits))
        runs.append(steps)
    assert graph.graph is not None and len(graph.k2.launches) \
        == cfg.num_hidden_layers
    assert len(graph.k5.launches) == k5_per_step
    for (t_e, l_e), (t_g, l_g) in zip(*runs):
        assert torch.equal(t_e, t_g)
        assert torch.equal(l_e, l_g), (l_e - l_g).abs().max().item()


def test_k2_graph_scratch_outlives_a_launch_at_another_shape():
    """Two graphs of K2 at two shapes captured on one stream, then an
    eager launch at the second shape on that stream (which replaces the
    stream's own scratch): the first graph, replayed after all that,
    still writes its partials to scratch it owns and gives the plain
    version's output."""
    from modelcompose_tpu_torch.ops import flash_decode
    gen = torch.Generator(device="cuda").manual_seed(21)

    def case(B, H, Hkv, S, kv):
        q = _rnd(gen, B, 1, H, 128)
        k, v = (quantize_kv(_rnd(gen, 2, B, S, Hkv, 128)) for _ in range(2))
        return q, k, v, torch.tensor(kv, dtype=torch.int32, device="cuda")
    cases = [case(2, 8, 8, 1100, [1100, 513]), case(1, 16, 8, 700, [650])]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs, outs = [], []
    with torch.cuda.stream(stream):
        for q, k, v, kv in cases:
            flash_decode_attention(q, k, v, kv, 1, sm_scale=0.088)  # warm
            graph = torch.cuda.CUDAGraph()
            with flash_decode.capturing() as record:
                graph.capture_begin()
                outs.append(flash_decode_attention(q, k, v, kv, 1,
                                                   sm_scale=0.088))
                graph.capture_end()
            assert len(record.launches) == 1 and record._scratch
            graphs.append((graph, record))
        q, k, v, kv = cases[1]
        flash_decode_attention(q, k, v, kv, 0, sm_scale=0.088)
        graphs[0][0].replay()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    q, k, v, kv = cases[0]
    ref = flash_decode_reference(q, k, v, kv, 1, sm_scale=0.088)
    assert _rel(outs[0], ref) <= 2e-2
    # a capture outside the record would leave its scratch unowned
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                flash_decode_attention(q, k, v, kv, 1, sm_scale=0.088)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()


def test_a_capture_that_syncs_raises_instead_of_running_eagerly(
        monkeypatch):
    from modelcompose_tpu_torch.core import decode_graph
    cfg, params, _ = _tiny_card_backbone(True)
    graph = decode_graph.DecodeGraph(params, cfg, 1, 32)
    step = decode_graph._decode_step

    def syncing(*args, **kw):
        out = step(*args, **kw)
        out[0].sum().item()  # a host read of a device value
        return out
    monkeypatch.setattr(decode_graph, "_decode_step", syncing)
    tokens = torch.tensor([3], device="cuda")
    kv = torch.tensor([4], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError):
        graph(tokens, kv)
    assert graph.graph is None
    monkeypatch.setattr(decode_graph, "_decode_step", step)
    torch.cuda.synchronize()  # the card still runs work
    assert torch.isfinite(graph(tokens, kv)).all()


def test_fps_graph_equals_the_eager_loop():
    """PointBERT's farthest-point sampling as one graph replay, against the
    eager loop on the card and on the CPU; a second cloud of the shape
    reuses the graph."""
    from modelcompose_tpu_torch.models import point_bert
    gen = torch.Generator(device="cuda").manual_seed(9)
    clouds = [torch.randn((2, 8192, 3), generator=gen, device="cuda")
              for _ in range(2)]
    n = point_bert.farthest_point_sample.captures
    for i, xyz in enumerate(clouds):
        got = point_bert.farthest_point_sample(xyz, 512)
        eager = torch.zeros((2, 512), dtype=torch.int64, device="cuda")
        point_bert._fps_loop(xyz, 0, eager)
        assert torch.equal(got, eager.int())
        assert torch.equal(got.cpu(), point_bert.farthest_point_sample(
            xyz.cpu(), 512))
        assert point_bert.farthest_point_sample.captures <= n + 1


# ---------------------------------------------------------------------------
# The compiled encode and prefill: a PrefillGraph, the chunk-step graphs and
# every tower's TowerGraph against the eager path they capture, bit for bit
# (the same kernels on the same data), with K1's launches counted through
# the replays
# ---------------------------------------------------------------------------

def _prompts(gen, cfg, B, L, lengths):
    embeds = _rnd(gen, B, L, cfg.hidden_size)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    seg = (torch.arange(L, device="cuda")[None] < lengths[:, None]).int()
    return embeds, seg, lengths


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("quantized_base", [False, True])
@pytest.mark.parametrize("into_decode_graph", [False, True])
def test_prefill_graph_replays_the_eager_prefill_bit_for_bit(
        quantized_base, kv_quant, into_decode_graph):
    """Three prompt batches of one shape through a model's prefill graphs
    (the first call eager, the second captures, the third replays), each
    against ``_prefill`` into a fresh cache: logits and the whole cache
    bit-equal, K1 counted once a layer per call."""
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.core.prefill_graph import (
        PrefillGraph, PrefillGraphs, _prefill, prefill)
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    cfg, params, gen = _tiny_card_backbone(quantized_base)
    B, L, S = 2, 40, 60
    table = as_table(cfg.routing_table(), "cuda")
    route = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    graphs = PrefillGraphs()
    decode = DecodeGraph(params, cfg, B, S, kv_quant=kv_quant,
                         routing_table=table) if into_decode_graph else None
    captures = PrefillGraph.captures
    for lengths in ([40, 23], [31, 40], [12, 7]):
        embeds, seg, lens = _prompts(gen, cfg, B, L, lengths)
        with torch.no_grad():
            want, fresh = _prefill(params, cfg, embeds, route, table, seg,
                                   lens, S, kv_quant=kv_quant)
            n = flash_attention_forward.launches
            got, cache = prefill(params, cfg, embeds, route, table, seg,
                                 lens, S, kv_quant=kv_quant, graphs=graphs,
                                 decode_graph=decode)
        assert flash_attention_forward.launches == n + cfg.num_hidden_layers
        assert torch.equal(got, want), (got - want).abs().max().item()
        for a, b in zip(cache.tensors(), fresh.tensors()):
            assert torch.equal(a, b)
        if decode is not None:
            assert cache is decode.cache
    holder = decode.prefills if decode is not None else graphs.one_shot
    (graph,) = holder.values()
    assert PrefillGraph.captures == captures + 1 and graph.calls == 3
    assert len(graph.k1.launches) == cfg.num_hidden_layers
    # every graph of the shared pool gone: the next capture takes a new
    # pool (PyTorch releases the old one and refuses its handle)
    pool = graph.graph.pool()
    holder.clear()
    del graph
    for _ in range(2):
        with torch.no_grad():
            again, _ = prefill(params, cfg, embeds, route, table, seg, lens,
                               S, kv_quant=kv_quant, graphs=graphs,
                               decode_graph=decode)
    assert torch.equal(again, got)
    (graph,) = holder.values()
    assert graph.graph is not None and graph.graph.pool() != pool


@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunk_steps_replay_the_eager_chunked_prefill_bit_for_bit(kv_quant):
    """Three prompts of one bucket through the chunk-step graphs (16, 16
    and a tail of 8) against ``prefill_chunked``'s eager path: logits and
    cache bit-equal, K1 once a layer per chunk."""
    from modelcompose_tpu_torch.core.generate import prefill_chunked
    from modelcompose_tpu_torch.core.prefill_graph import (ChunkStepGraph,
                                                           PrefillGraphs)
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    cfg, params, gen = _tiny_card_backbone(True)
    L, S = 40, 64
    table = as_table(cfg.routing_table(), "cuda")
    graphs = PrefillGraphs()
    captures = ChunkStepGraph.captures
    for n_valid in (40, 29, 33):
        embeds, _, lens = _prompts(gen, cfg, 1, L, [n_valid])
        kw = dict(chunk=16, kv_quant=kv_quant)
        with torch.no_grad():
            want, fresh = prefill_chunked(params, cfg, embeds, None, table,
                                          lens.cpu(), S, **kw)
            n = flash_attention_forward.launches
            got, cache = prefill_chunked(params, cfg, embeds, None, table,
                                         lens.cpu(), S, graphs=graphs, **kw)
        assert flash_attention_forward.launches \
            == n + 3 * cfg.num_hidden_layers
        assert torch.equal(got, want), (got - want).abs().max().item()
        for a, b in zip(cache.tensors(), fresh.tensors()):
            assert torch.equal(a, b)
    (admission,) = graphs.admissions.values()
    assert sorted(admission.steps) == [(0, 16), (16, 16), (32, 8)]
    assert ChunkStepGraph.captures == captures + 3
    assert all(s.graph is not None and s.shared is graphs.shared
               for s in admission.steps.values())


def _tiny_towers():
    """(name, tower, inputs) of every tower kind at its test size, on the
    card, with the inputs of two calls."""
    import numpy as np
    from modelcompose_tpu_torch.config import tiny_test_config
    from modelcompose_tpu_torch.models import (audio_beats, audio_imagebind,
                                               point_bert, text_clip, towers,
                                               video_languagebind,
                                               vision_eva)
    rng = np.random.default_rng(4)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)
    cfg = tiny_test_config()
    text_cfg = text_clip.ClipTextConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, vocab_size=100, max_position_embeddings=16,
        projection_dim=32)
    gen = torch.Generator(device="cuda").manual_seed(6)
    pad = np.zeros((2, 64), bool)
    pad[1, 40:] = True
    clouds = np.concatenate([rnd(2, 64, 3), rng.random((2, 64, 3))], -1)
    return [
        ("clip", towers.ClipVisionTower("test:32x2", cfg, gen, device="cuda"),
         lambda: ((rnd(2, 28, 28, 3),), {})),
        ("beats", audio_beats.BeatsAudioTower("test:16x2", cfg, gen,
                                              device="cuda"),
         lambda: ((rnd(2, 64, 8),), {"audio_padding_mask": pad})),
        ("languagebind", video_languagebind.LanguageBindVideoTower(
            "test:32x3", cfg, gen, device="cuda"),
         lambda: ((rnd(2, 2, 28, 28, 3),), {})),
        ("point_bert", point_bert.PointBertTower("test:16x2", cfg, gen,
                                                 device="cuda"),
         lambda: ((clouds + rnd(2, 64, 6) * 0.01,), {})),
        ("eva", vision_eva.EvaVisionTower("eva-test:64x3", cfg, gen,
                                          device="cuda"),
         lambda: ((rnd(2, 28, 28, 3),), {})),
        ("imagebind", audio_imagebind.ImageBindAudioTower(
            "imagebind-test:32x2", generator=gen, device="cuda"),
         None),
        ("clip_text", text_clip.ClipTextEncoder(text_cfg, generator=gen,
                                                device="cuda"),
         lambda: ((torch.randint(1, 99, (2, 6), generator=gen,
                                 device="cuda"),),
                  {"attention_mask": torch.ones((2, 6), dtype=torch.int64,
                                                device="cuda")})),
    ]


@pytest.mark.parametrize("index", range(7))
def test_tower_graph_replays_the_eager_encode_bit_for_bit(index):
    """Each tower kind's encode through ``TowerGraphs`` three times (eager,
    capture, replay) against the tower's own eager encode: outputs
    bit-equal, one capture.  PointBERT's sampling loop is captured inside
    the tower's graph."""
    import numpy as np
    from modelcompose_tpu_torch.models.towers import TowerGraph, TowerGraphs
    name, tower, make = _tiny_towers()[index]
    if make is None:  # ImageBind's processor gives its mel clips
        wave = np.random.default_rng(8).normal(size=48000) * 0.1
        mel = tower.modal_processor(wave.astype(np.float32))

        def make():
            return ((mel + np.float32(0.01)
                     * np.random.default_rng(9).normal(size=mel.shape)
                     .astype(np.float32),), {})
    graphs = TowerGraphs()
    captures = TowerGraph.captures
    for _ in range(3):
        args, kwargs = make()
        with torch.no_grad():
            want = tower.encode(*args, **kwargs)
            got = graphs.encode(tower, *args, **kwargs)
        if isinstance(want, tuple):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w), name
        else:
            assert got.is_cuda and torch.equal(got, want), name
    assert TowerGraph.captures == captures + 1 and len(graphs) == 1


def test_k1_captured_outside_a_record_raises():
    """A K1 launch captured with no record would run uncounted at every
    replay: it raises instead."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (_rnd(gen, 1, 64, 4, 64) for _ in range(3))
    flash_attention_forward(q, k, v)  # built, attribute set
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                flash_attention_forward(q, k, v)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()


def _tiny_card_trainer(seed=13, quantized_base=False, **tc_kw):
    """A 2-layer bf16 vision DAMC model on the card (head_dim 64, remat:
    K1 twice a layer) with nonzero LoRA B, its stage-2 optimizer and a
    batch of two image samples; ``quantized_base`` quantizes its base as
    ``--quantize_frozen_base`` does, ``tc_kw`` adds to the optimizer's
    settings."""
    import numpy as np
    from modelcompose_tpu_torch.config import tiny_test_config
    from modelcompose_tpu_torch.constants import (IGNORE_INDEX,
                                                  MODAL_TOKEN_INDEXES)
    from modelcompose_tpu_torch.models.model import MultimodalLM
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.train.train_multimodal import make_batch
    cfg = tiny_test_config(hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=512, dtype="bfloat16", remat=True,
                           mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu",
                           local_prefix_tokens=1, local_suffix_tokens=1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MultimodalLM.random_init(cfg, gen, "cuda")
    for grp in ("attn", "mlp"):
        for p in model.params["layers"][grp].values():
            p["lora_b"].normal_(0.0, 0.05, generator=gen)
    if quantized_base:
        model.params = quant.quantize_backbone(model.params)
    rng = np.random.default_rng(seed)
    img = MODAL_TOKEN_INDEXES["vision"]
    ids = [np.concatenate([[1, img], rng.integers(3, 512, n)])
           for n in (40, 23)]
    labels = [np.concatenate([[IGNORE_INDEX] * 12, i[12:]]) for i in ids]
    pixels = rng.random((2, 28, 28, 3)).astype(np.float32)

    def batch(rows):  # (batch, feat_layout) of these samples
        return make_batch(model, {
            "input_ids": [ids[i] for i in rows],
            "labels": [labels[i] for i in rows],
            "modal_inputs": {"vision": pixels[list(rows)]}}, buckets=(64,))
    tc = trainer.TrainConfig(**dict(dict(
        learning_rate=2e-3, warmup_ratio=0.0, total_steps=20,
        weight_decay=0.01, max_grad_norm=1.0), **tc_kw))
    tree = {"backbone": model.params, "projectors": model.projectors}
    tx, _ = trainer.make_optimizer(cfg, tc, tree)
    return cfg, tc, model, tx, batch


def test_train_step_graph_replays_the_eager_step_bit_for_bit():
    """Six steps eagerly and six through a TrainStepGraph (one eager, one
    capture, four replays) from the same weights: losses, every leaf and
    every moment bit-equal; each replay counts K1 twice a layer (remat),
    K3 and K4 once."""
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.tree import tree_leaves
    cfg, tc, model, tx, make = _tiny_card_trainer()
    batch, layout = make((0, 1))
    tree = {"backbone": model.params, "projectors": model.projectors}
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)}
    runs = []
    for graphs in (False, True):
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                t.copy_(start[p])
        state = trainer.init_train_state(cfg, tc, model.params,
                                         model.projectors, tx=tx)
        step = trainer.make_train_step(cfg, tc, tx, graphs=graphs)
        losses = []
        for i in range(6):
            counts = (flash_attention_forward.launches,
                      flash_attention_bwd_dq.launches,
                      flash_attention_bwd_dkv.launches)
            state, loss = step(state, batch, layout)
            losses.append(loss)
            now = (flash_attention_forward.launches,
                   flash_attention_bwd_dq.launches,
                   flash_attention_bwd_dkv.launches)
            n = cfg.num_hidden_layers
            assert [b - a for a, b in zip(counts, now)] == [2 * n, n, n], i
        torch.cuda.synchronize()
        runs.append((losses, {p: t.detach().clone()
                              for p, t in tree_leaves(tree)},
                     [t.clone() for m in ("mu", "nu")
                      for t in state.opt_state[m].values()], step))
    (l_e, p_e, m_e, _), (l_g, p_g, m_g, gstep) = runs
    (graph,) = gstep.graphs.values()
    assert graph.graph is not None and type(graph).replays >= 4
    assert len(graph.k1.launches) == 2 * cfg.num_hidden_layers
    assert len(graph.k1.bwd_dq) == len(graph.k1.bwd_dkv) \
        == cfg.num_hidden_layers
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g)), (l_e, l_g)
    for p in p_e:
        assert torch.equal(p_e[p], p_g[p]), p
    assert all(torch.equal(a, b) for a, b in zip(m_e, m_g))


def test_int8_base_train_step_graph_runs_k6_k7_bit_for_bit():
    """The QLoRA step (int8 base, remat, loss chunks of 16, bf16 first
    moments): six steps eagerly and six through a TrainStepGraph from the
    same weights, losses, leaves and moments bit-equal; every step K6 14
    times a layer + 2 a loss chunk, K7 7 times a layer + 1 a chunk, K1
    twice a layer, K3 and K4 once, no K5 (replays counted from the
    capture's record)."""
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.tree import tree_leaves
    cfg, tc, model, tx, make = _tiny_card_trainer(
        15, quantized_base=True, loss_chunk=16, adam_mu_dtype="bfloat16")
    batch, layout = make((0, 1))
    n = cfg.num_hidden_layers
    chunks = batch["token_ids"].shape[1] // tc.loss_chunk
    want = [14 * n + 2 * chunks, 7 * n + chunks, 0, 2 * n, n, n]
    counters = (quant.w8a16_gemm, quant.w8a16_dx, dequant_matmul,
                flash_attention_forward, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    tree = {"backbone": model.params, "projectors": model.projectors}
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)}
    runs = []
    for graphs in (False, True):
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                t.copy_(start[p])
        state = trainer.init_train_state(cfg, tc, model.params,
                                         model.projectors, tx=tx)
        step = trainer.make_train_step(cfg, tc, tx, graphs=graphs)
        losses = []
        for i in range(6):
            before = [c.launches for c in counters]
            state, loss = step(state, batch, layout)
            losses.append(loss)
            got = [c.launches - b for c, b in zip(counters, before)]
            assert got == want, (i, got, want)
        torch.cuda.synchronize()
        runs.append((losses, {p: t.detach().clone()
                              for p, t in tree_leaves(tree)},
                     [t.clone() for m in ("mu", "nu")
                      for t in state.opt_state[m].values()], step))
    (l_e, p_e, m_e, _), (l_g, p_g, m_g, gstep) = runs
    (graph,) = gstep.graphs.values()
    assert graph.graph is not None
    assert (len(graph.k5.gemm), len(graph.k5.dx)) == tuple(want[:2])
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g)), (l_e, l_g)
    assert all(torch.isfinite(x).all() for x in l_g)
    for p in p_e:
        assert torch.equal(p_e[p], p_g[p]), p
    assert all(torch.equal(a, b) for a, b in zip(m_e, m_g))


def test_accumulation_graphs_replay_the_eager_window_bit_for_bit():
    """Three windows of two micro-batches eagerly and through the grad and
    apply graphs: losses, leaves and moments bit-equal."""
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.tree import tree_leaves
    cfg, tc, model, tx, make = _tiny_card_trainer(14)
    micro = [make((i,)) for i in range(2)]
    tree = {"backbone": model.params, "projectors": model.projectors}
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)}
    runs = []
    for graphs in (False, True):
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                t.copy_(start[p])
        state = trainer.init_train_state(cfg, tc, model.params,
                                         model.projectors, tx=tx)
        grad_fn, apply_fn, _, grad_accum_fn = trainer.make_grad_and_apply(
            cfg, tc, tx, graphs=graphs)
        losses = []
        for _ in range(3):
            loss0, acc = grad_fn(state.params, *micro[0])
            loss1, acc = grad_accum_fn(state.params, acc, *micro[1])
            state = apply_fn(state, acc, scale=0.5)
            losses += [loss0, loss1]
        torch.cuda.synchronize()
        runs.append((losses, {p: t.detach().clone()
                              for p, t in tree_leaves(tree)},
                     [t.clone() for m in ("mu", "nu")
                      for t in state.opt_state[m].values()]))
    (l_e, p_e, m_e), (l_g, p_g, m_g) = runs
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g)), (l_e, l_g)
    for p in p_e:
        assert torch.equal(p_e[p], p_g[p]), p
    assert all(torch.equal(a, b) for a, b in zip(m_e, m_g))


def test_k3_k4_replays_are_counted():
    """flash_attention forward and backward captured by a graph whose
    backward runs on autograd's thread: each replay counts K1, K3 and K4
    once, and the gradients equal the eager ones."""
    from modelcompose_tpu_torch.train.step_graph import TrainStepGraph
    gen = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = (_rnd(gen, 2, 96, 4, 64).requires_grad_() for _ in range(3))
    seg = torch.ones((2, 96), dtype=torch.int32, device="cuda")
    seg[1, 70:] = 0

    def body():
        out = flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
        return torch.autograd.grad(out.float().square().sum(), (q, k, v))
    want = body()
    graph = TrainStepGraph("cuda", None, body)
    for i in range(4):
        counts = (flash_attention_forward.launches,
                  flash_attention_bwd_dq.launches,
                  flash_attention_bwd_dkv.launches)
        got = graph()
        now = (flash_attention_forward.launches,
               flash_attention_bwd_dq.launches,
               flash_attention_bwd_dkv.launches)
        assert [b - a for a, b in zip(counts, now)] == [1, 1, 1], i
        for g, w in zip(got, want):
            assert torch.equal(g, w), i
    assert graph.graph is not None and len(graph.k1.bwd_dq) == 1 \
        and len(graph.k1.bwd_dkv) == 1


def test_k3_k4_captured_outside_a_record_raises():
    """A K3 or K4 launch captured with no record would run uncounted at
    every replay: it raises instead."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (_rnd(gen, 1, 64, 4, 64) for _ in range(4))
    out, lse = flash_attention_forward(q, k, v)
    di = _di(out, do)
    flash_attention_bwd_dq(q, k, v, do, lse, di)  # built, attribute set
    flash_attention_bwd_dkv(q, k, v, do, lse, di)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capturing"):
                flash_attention_bwd_dq(q, k, v, do, lse, di)
            with pytest.raises(RuntimeError, match="capturing"):
                flash_attention_bwd_dkv(q, k, v, do, lse, di)
        finally:
            graph.capture_end()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Graphs under an NCCL process group of one
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_world():
    """An NCCL process group of this one process on a free local port
    (``parallel.distributed.initialize``: the card bound, the world's
    communicator made at once), left after the test."""
    import socket
    from modelcompose_tpu_torch.parallel import distributed
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, backend="nccl")
    import torch.distributed as dist
    yield dist.group.WORLD
    distributed.shutdown()


def test_decode_graph_under_an_nccl_group_replays_the_eager_step(
        nccl_world):
    """Under a model group of one (NCCL), 12 greedy steps eagerly and 12
    through a DecodeGraph made under the group (the vocab lookup's and the
    layers' all-reduces, the logits' all-gather captured): logits
    bit-equal at every step; the graph is keyed by the group and refuses
    a call outside it."""
    from modelcompose_tpu_torch.core import generate as tgen
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraphs
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    from modelcompose_tpu_torch.parallel import tp
    cfg, params, gen = _tiny_card_backbone(True)
    B, L, S = 2, 40, 60
    embeds = _rnd(gen, B, L, cfg.hidden_size)
    lengths = torch.tensor([40, 23], dtype=torch.int32, device="cuda")
    seg = (torch.arange(L, device="cuda")[None] < lengths[:, None]).int()
    table = as_table(cfg.routing_table(), "cuda")
    graphs = DecodeGraphs(2)
    runs = []
    with tp.scope(nccl_world):
        graph = graphs.get(params, cfg, B, S, kv_quant=True,
                           routing_table=table)
        for cache in (None, graph.cache):
            with torch.no_grad():
                logits, cache = tgen._prefill(params, cfg, embeds, None,
                                              table, seg, lengths, S,
                                              kv_quant=True, cache=cache)
            kv, steps = lengths, []
            for _ in range(12):
                tokens = logits.argmax(-1)
                if cache is graph.cache:
                    logits = graph(tokens, kv).clone()
                else:
                    with torch.no_grad():
                        logits, cache, _ = tgen._decode_step(
                            params, cfg, cache, tokens, kv, table)
                kv = kv + 1
                steps.append((tokens, logits))
            runs.append(steps)
    assert graph.graph is not None and graph.group is nccl_world
    for (t_e, l_e), (t_g, l_g) in zip(*runs):
        assert torch.equal(t_e, t_g)
        assert torch.equal(l_e, l_g), (l_e - l_g).abs().max().item()
    assert graphs.get(params, cfg, B, S, kv_quant=True,
                      routing_table=table) is not graph
    with pytest.raises(RuntimeError, match="model group"):
        graph(tokens, kv)


def test_prefill_graph_under_an_nccl_group_replays_the_eager_prefill(
        nccl_world):
    """Under a model group of one (NCCL), three prompt batches through the
    prefill graphs (eager, capture, replay) against ``_prefill`` eagerly
    under the group: logits and cache bit-equal."""
    from modelcompose_tpu_torch.core.prefill_graph import (
        PrefillGraph, PrefillGraphs, _prefill, prefill)
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    from modelcompose_tpu_torch.parallel import tp
    cfg, params, gen = _tiny_card_backbone(True)
    B, L, S = 2, 40, 60
    table = as_table(cfg.routing_table(), "cuda")
    route = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    graphs = PrefillGraphs()
    captures = PrefillGraph.captures
    with tp.scope(nccl_world), torch.no_grad():
        for lengths in ([40, 23], [31, 40], [12, 7]):
            embeds, seg, lens = _prompts(gen, cfg, B, L, lengths)
            want, fresh = _prefill(params, cfg, embeds, route, table, seg,
                                   lens, S, kv_quant=True)
            got, cache = prefill(params, cfg, embeds, route, table, seg,
                                 lens, S, kv_quant=True, graphs=graphs)
            assert torch.equal(got, want), (got - want).abs().max().item()
            for a, b in zip(cache.tensors(), fresh.tensors()):
                assert torch.equal(a, b)
    (graph,) = graphs.one_shot.values()
    assert PrefillGraph.captures == captures + 1 and graph.calls == 3
    assert graph.group is nccl_world


def test_train_step_graph_under_an_nccl_mesh_replays_the_eager_step(
        nccl_world):
    """In a data mesh of one (NCCL; ``make_mesh`` warms its groups), four
    steps eagerly and four through a TrainStepGraph (the valid-target
    count's, every gradient's and the loss's all-reduces captured):
    losses, leaves and moments bit-equal."""
    from modelcompose_tpu_torch.parallel.mesh import make_mesh
    from modelcompose_tpu_torch.train import trainer
    from modelcompose_tpu_torch.tree import tree_leaves
    cfg, tc, model, _, make = _tiny_card_trainer(17)
    batch, layout = make((0, 1))
    tree = {"backbone": model.params, "projectors": model.projectors}
    mesh = make_mesh(1, 1)
    tx, _ = trainer.make_optimizer(cfg, tc, tree, mesh)
    start = {p: t.detach().clone() for p, t in tree_leaves(tree)}
    runs = []
    for graphs in (False, None):  # None: the default, graphs on the card
        with torch.no_grad():
            for p, t in tree_leaves(tree):
                t.copy_(start[p])
        state = trainer.init_train_state(cfg, tc, model.params,
                                         model.projectors, tx=tx)
        step = trainer.make_train_step(cfg, tc, tx, graphs=graphs)
        losses = []
        for _ in range(4):
            state, loss = step(state, batch, layout)
            losses.append(loss)
        torch.cuda.synchronize()
        runs.append((losses, {p: t.detach().clone()
                              for p, t in tree_leaves(tree)},
                     [t.clone() for m in ("mu", "nu")
                      for t in state.opt_state[m].values()], step))
    (l_e, p_e, m_e, estep), (l_g, p_g, m_g, gstep) = runs
    assert len(estep.graphs) == 0
    (graph,) = gstep.graphs.values()
    assert graph.graph is not None and graph.calls == 4
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g)), (l_e, l_g)
    for p in p_e:
        assert torch.equal(p_e[p], p_g[p]), p
    assert all(torch.equal(a, b) for a, b in zip(m_e, m_g))


def test_tp_backward_collectives_on_autograd_thread_are_captured(
        nccl_world):
    """Flash attention between ``copy_to_model`` and ``reduce_from_model``
    under a model group of one, forward and backward captured: the
    backward's all-reduce and K3/K4 run on autograd's thread into the
    capture, each replay counts K1, K3 and K4 once, and the gradients
    equal the eager ones."""
    from modelcompose_tpu_torch.parallel import tp
    from modelcompose_tpu_torch.train.step_graph import TrainStepGraph
    gen = torch.Generator(device="cuda").manual_seed(18)
    q, k, v = (_rnd(gen, 2, 96, 4, 64).requires_grad_() for _ in range(3))

    def body():
        with tp.scope(nccl_world):
            out = flash_attention(tp.copy_to_model(q), k, v)
            out = tp.reduce_from_model(out)
        return torch.autograd.grad(out.float().square().sum(), (q, k, v))
    want = body()
    graph = TrainStepGraph("cuda", None, body)
    for i in range(4):
        counts = (flash_attention_forward.launches,
                  flash_attention_bwd_dq.launches,
                  flash_attention_bwd_dkv.launches)
        got = graph()
        now = (flash_attention_forward.launches,
               flash_attention_bwd_dq.launches,
               flash_attention_bwd_dkv.launches)
        assert [b - a for a, b in zip(counts, now)] == [1, 1, 1], i
        for g, w in zip(got, want):
            assert torch.equal(g, w), i
    assert graph.graph is not None


def test_a_capture_under_a_group_without_its_communicator_raises():
    """A group whose NCCL communicator was never made (a process group not
    bound to the card, a ``new_group`` no collective has run on) and a
    step that reaches the group's first collective only inside the
    capture: the capture raises, no graph is kept and nothing falls back
    to the eager step.  The same step on a group ``make_mesh`` made (its
    communicator warmed there) captures and replays."""
    import socket
    import torch.distributed as dist
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    from modelcompose_tpu_torch.parallel.mesh import make_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")

        class Step(CapturedStep):
            def __init__(self, comm):
                super().__init__("cuda")
                self.comm = comm

            def _step(self):
                y = x * 2
                if torch.cuda.is_current_stream_capturing():
                    parts = [torch.empty_like(y)]
                    dist.all_gather(parts, y, group=self.comm)
                    y = parts[0] + 1
                return y
        cold = Step(dist.new_group([0]))
        with pytest.raises(Exception):
            cold.run()
        assert cold.graph is None
        torch.cuda.synchronize()
        warmed = Step(make_mesh(1, 1).data_group)
        warmed.run()  # the warm-up's result: the eager branch
        x.add_(1)
        assert torch.equal(warmed.run(), x * 2 + 1)  # the replay
        assert warmed.graph is not None
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- K8-K10
# The decode layer's fused passes (ops/decode_fused, csrc/decode_fused.cu)
# at the decode shapes: 1-8 rows, hidden 4,096, the MCUB-4 heads (32 of
# 128) and the tp 2 / tp 4 ranks' (16, 8), a cache of 3,360 positions with
# a different position a row.  K9 and K10 bit-equal to their plain
# versions; K8's sum bit-equal and its normed output within one unit in
# the last place of the activations' type (its sum of squares runs in
# another order).

def _ulps(got, want):
    """The largest distance in units in the last place between two half
    tensors (their 16-bit patterns on a monotone line)."""
    def line(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(got) - line(want)).abs().max().item()


def _fused_counts():
    from modelcompose_tpu_torch.ops import decode_fused
    return (decode_fused.add_rms_norm.launches,
            decode_fused.rope_kv_write.launches,
            decode_fused.silu_mul.launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3, 8])
@pytest.mark.parametrize("H", [4096, 5120, 200])
def test_k8_matches_plain(H, M, residual, dtype):
    """K8 against (x + y, rms_norm(x + y)): the sum bit-equal, the normed
    output within one ulp (a weight of ones: the normed values themselves)
    and, with a random weight, within the half tolerance; one launch."""
    from modelcompose_tpu_torch.ops import decode_fused
    gen = torch.Generator(device="cuda").manual_seed(H + M + residual)
    x = (torch.randn((M, 1, H), generator=gen, device="cuda") * 3).to(dtype)
    y = (torch.randn((M, 1, H), generator=gen, device="cuda") * 3).to(dtype) \
        if residual else None
    for w in (torch.ones(H, device="cuda", dtype=dtype),
              (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
               ).to(dtype)):
        n = decode_fused.add_rms_norm.launches
        s, out = decode_fused.add_rms_norm(x, y, w, 1e-5)
        assert decode_fused.add_rms_norm.launches == n + 1
        want_s, want = decode_fused.add_rms_norm_reference(x, y, w, 1e-5)
        assert s.dtype == out.dtype == dtype
        assert torch.equal(s, want_s)
        if bool((w == 1).all()):
            assert _ulps(out, want) <= 1
        assert _rel(out, want) <= 2e-2


def _k9_case(gen, B, H, Hkv, D, S, NL, int8, dtype, pos_dtype):
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.core.llama import KVCache
    from modelcompose_tpu_torch.ops.rope import rope_tables
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, 1, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, 1, Hkv, D), generator=gen, device="cuda").to(dtype)
    pos = torch.randperm(S, generator=gen, device="cuda")[:B].to(pos_dtype)
    cos, sin = rope_tables(pos[:, None], D)
    cfg = ModelConfig(hidden_size=H * D, num_attention_heads=H,
                      num_key_value_heads=Hkv, num_hidden_layers=NL,
                      dtype="bfloat16" if dtype == torch.bfloat16
                      else "float16")
    caches = [KVCache.zeros(cfg, B, S, quantized=int8, device="cuda")
              for _ in range(2)]
    for c in caches[0].tensors():  # filled, so the writes are what differ
        c.copy_(torch.randint(-100, 100, c.shape, generator=gen,
                              device="cuda").to(c.dtype))
    for a, b in zip(caches[0].tensors(), caches[1].tensors()):
        b.copy_(a)
    return (q, k, v, cos, sin), caches, pos


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3, 8])
@pytest.mark.parametrize("H,Hkv,D", [(32, 32, 128), (16, 16, 128),
                                     (8, 8, 128), (32, 8, 128), (4, 2, 64)])
def test_k9_matches_plain(H, Hkv, D, B, int8, dtype):
    """K9 against apply_rope and the cache writes: the rotated q and the
    whole caches (int8 values and scales, or the half entries) bit-equal,
    over a 3,360-position cache with a different position a row (int32
    and int64 positions); one launch."""
    from modelcompose_tpu_torch.ops import decode_fused
    gen = torch.Generator(device="cuda").manual_seed(H + Hkv + D + B)
    for pos_dtype in (torch.int32, torch.int64):
        args, (kc, pc), pos = _k9_case(gen, B, H, Hkv, D, 3360, 2, int8,
                                       dtype, pos_dtype)
        n = decode_fused.rope_kv_write.launches
        got = decode_fused.rope_kv_write(*args, kc.k, kc.v, 1, pos)
        assert decode_fused.rope_kv_write.launches == n + 1
        want = decode_fused.rope_kv_write_reference(*args, pc.k, pc.v, 1, pos)
        assert got.dtype == dtype and torch.equal(got, want)
        for a, b in zip(kc.tensors(), pc.tensors()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2, 3, 8])
@pytest.mark.parametrize("I", [11008, 5504, 2752, 200])
def test_k10_matches_plain(I, M, dtype):
    """K10 against F.silu(gate) * up, bit-equal; one launch."""
    from modelcompose_tpu_torch.ops import decode_fused
    gen = torch.Generator(device="cuda").manual_seed(I + M)
    gate = (torch.randn((M, 1, I), generator=gen, device="cuda") * 4
            ).to(dtype)
    up = torch.randn((M, 1, I), generator=gen, device="cuda").to(dtype)
    n = decode_fused.silu_mul.launches
    got = decode_fused.silu_mul(gate, up)
    assert decode_fused.silu_mul.launches == n + 1
    assert torch.equal(got, decode_fused.silu_mul_reference(gate, up))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096),
                                 (4096, 2048), (2048, 4096), (4096, 1024)])
def test_k5_half_epilogue_is_the_fp32_output_rounded(K, N, M, dtype):
    """K5 asked for x's type rounds in its epilogue the fp32 value it
    writes when asked for fp32: bit-equal to its fp32 output cast."""
    gen = torch.Generator(device="cuda").manual_seed(K + N + M)
    x, wq = _k5_inputs(gen, M, K, N, dtype)
    got = dequant_matmul(x, wq, out_dtype=dtype)
    assert got.dtype == dtype
    assert torch.equal(got, dequant_matmul(x, wq, out_dtype=torch.float32)
                       .to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("K,Ns", K5_GROUPS)
def test_k5_group_half_epilogue_is_the_fp32_output_rounded(K, Ns, M, dtype):
    """The grouped K5 launch asked for x's type: each member bit-equal to
    its fp32 output cast."""
    gen = torch.Generator(device="cuda").manual_seed(K + sum(Ns) + M)
    x = torch.randn((M, 1, K), generator=gen, device="cuda").to(dtype)
    ws = [_k5_inputs(gen, 1, K, N)[1] for N in Ns]
    got = quant.dequant_matmul_group(x, ws, out_dtype=dtype)
    f32 = quant.dequant_matmul_group(x, ws, out_dtype=torch.float32)
    for a, b in zip(got, f32):
        assert a.dtype == dtype and torch.equal(a, b.to(dtype))


@pytest.mark.parametrize("int8", [False, True])
def test_k8_k9_k10_in_a_graph_replay_at_two_positions(int8):
    """K8, K9 and K10 captured in a CapturedStep (their launches recorded,
    counted at each replay), replayed at two different positions copied
    into the static position buffer: each replay's outputs and cache
    writes bit-equal to eager calls at those positions."""
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    from modelcompose_tpu_torch.ops import decode_fused
    from modelcompose_tpu_torch.ops.rope import rope_tables
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, H, D, S = 2, 32, 128, 3360
    (q, k, v, _, _), (kc, pc), pos = _k9_case(gen, B, H, H, D, S, 2, int8,
                                              torch.bfloat16, torch.int32)
    static_pos = pos.clone()
    x = _rnd(gen, B, 1, 4096)
    y = _rnd(gen, B, 1, 4096)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    gate, up = _rnd(gen, B, 1, 11008), _rnd(gen, B, 1, 11008)

    def step(cache, p):
        cos, sin = rope_tables(p[:, None], D)
        s, h = decode_fused.add_rms_norm(x, y, w, 1e-5)
        qr = decode_fused.rope_kv_write(q, k, v, cos, sin, cache.k, cache.v,
                                        1, p)
        return s, h, qr, decode_fused.silu_mul(gate, up)

    class Step(CapturedStep):
        def _step(self):
            return step(kc, static_pos)
    graph = Step("cuda")
    graph.run()  # eager warm-up and capture
    step(pc, pos)  # the warm-up's writes
    assert graph.graph is not None
    assert (len(graph.k5.norm), len(graph.k5.rope), len(graph.k5.silu)) \
        == (1, 1, 1)
    for new in (pos + 5, pos + 17):
        static_pos.copy_(new)
        before = _fused_counts()
        got = graph.run()
        assert tuple(a - b for a, b in zip(_fused_counts(), before)) \
            == (1, 1, 1)
        want = step(pc, new)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in zip(kc.tensors(), pc.tensors()):
            assert torch.equal(a, b)


def test_fused_kernels_refuse_what_they_do_not_take():
    """On the card a wrapper launches or raises: fp32 activations given to
    it directly, a non-contiguous input, a head dim other than 64 or 128."""
    from modelcompose_tpu_torch.ops import decode_fused
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = _rnd(gen, 2, 1, 4096)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        decode_fused.add_rms_norm(x.float(), None, w.float(), 1e-5)
    with pytest.raises(ValueError):
        decode_fused.add_rms_norm(_rnd(gen, 2, 8192)[:, ::2], None, w, 1e-5)
    with pytest.raises(TypeError):
        decode_fused.silu_mul(x.float(), x.float())
    with pytest.raises(ValueError):
        decode_fused.silu_mul(_rnd(gen, 2, 8192)[:, ::2], x.view(2, 4096))
    for D, strided in ((32, False), (128, True)):
        args, (kc, _), pos = _k9_case(gen, 2, 4, 4, D, 64, 1, True,
                                      torch.bfloat16, torch.int32)
        q = args[0]
        if strided:
            q = torch.cat([q, q], dim=-1)[..., ::2]
        with pytest.raises(ValueError):
            decode_fused.rope_kv_write(q, *args[1:], kc.k, kc.v, 0, pos)
    args, (kc, _), pos = _k9_case(gen, 2, 4, 4, 128, 64, 1, True,
                                  torch.bfloat16, torch.int32)
    with pytest.raises(TypeError):
        decode_fused.rope_kv_write(*(a.float() for a in args[:3]), *args[3:],
                                   kc.k, kc.v, 0, pos)


def _fused_step_counts(n, B):
    """(K8, K9, K10, K5 with K8 in its prologue, with K8 and K9, with
    K10) launches of one fused decode step of an ``n``-layer int8 backbone
    with the dense fold at B rows: at 1-2 rows each norm in the prologue of
    the K5 launch that reads it, RoPE + the cache write in the q/k/v
    launch's epilogue and the SiLU product in the down product's prologue,
    K8 alone only for the final norm; at 3-8 rows K8 2 a layer + 1, K9 and
    K10 once a layer."""
    if B <= quant.K5_GROUP_ROWS:
        return (1, 0, 0, n, n, n)
    return (2 * n + 1, n, n, 0, 0, 0)


def _all_fused_counts():
    from modelcompose_tpu_torch.ops import decode_fused
    return _fused_counts() + (decode_fused.norm_matmul_group.launches,
                              decode_fused.norm_qkv_rope.launches,
                              decode_fused.silu_matmul.launches)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_fused_decode_step_against_the_unfused_step(kv_quant, B):
    """One eager decode step of the tiny int8 backbone with the dense fold
    (no decode table) through K8-K10 and K5's bf16 output (at one row K8,
    K9 and K10 inside K5's launches), against the same step on the unfused
    ops
    (``fused_decode`` off): the launches of ``_fused_step_counts``; logits
    within 2e-2 of max |logit| and the caches within one int8 step (K8's
    normed values may differ by one ulp); through a DecodeGraph the same
    counts at each replay and the logits bit-equal to the eager fused
    step's."""
    from modelcompose_tpu_torch.core import generate as tgen
    from modelcompose_tpu_torch.core import llama as tllama
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    cfg, params, gen = _tiny_card_backbone(True)
    L, S = 40, 60
    embeds = _rnd(gen, B, L, cfg.hidden_size)
    lengths = torch.tensor([40, 23, 31][:B], dtype=torch.int32,
                           device="cuda")
    seg = (torch.arange(L, device="cuda")[None] < lengths[:, None]).int()
    tokens = torch.tensor([7, 9, 11][:B], device="cuda")
    n = cfg.num_hidden_layers
    outs = []
    for fused in (True, False):
        with torch.no_grad():
            _, cache = tgen._prefill(params, cfg, embeds, None, None, seg,
                                     lengths, S, kv_quant=kv_quant)
            before = _all_fused_counts()
            if fused:
                logits, cache, _ = tgen._decode_step(params, cfg, cache,
                                                     tokens, lengths, None)
            else:
                kept = tllama.fused_decode
                tllama.fused_decode = lambda x, impl: False
                try:
                    logits, cache, _ = tgen._decode_step(
                        params, cfg, cache, tokens, lengths, None)
                finally:
                    tllama.fused_decode = kept
        delta = tuple(a - b for a, b in zip(_all_fused_counts(), before))
        assert delta == (_fused_step_counts(n, B) if fused else (0,) * 6)
        outs.append((logits, cache))
    (lf, cf), (lu, cu) = outs
    assert _rel(lf, lu) <= 2e-2
    for a, b in zip(cf.tensors(), cu.tensors()):
        if a.dtype == torch.int8:
            assert (a.int() - b.int()).abs().max().item() <= 1
        else:
            assert _rel(a, b) <= 2e-2
    graph = DecodeGraph(params, cfg, B, S, kv_quant=kv_quant)
    with torch.no_grad():
        tgen._prefill(params, cfg, embeds, None, None, seg, lengths, S,
                      kv_quant=kv_quant, cache=graph.cache)
    for _ in range(3):  # eager (capture), replay, replay
        before = _all_fused_counts()
        got = graph(tokens, lengths).clone()
        assert tuple(a - b for a, b in zip(_all_fused_counts(), before)) \
            == _fused_step_counts(n, B)
    # the replays rewrote the same slots: the logits are the eager step's
    assert torch.equal(got, lf)


# ---------------------------------------------------------------- K8, K9 in K5
# K8 in the prologue of the K5 streaming launch that reads its output, and
# K9 in the epilogue of the q/k/v launch (ops/decode_fused.norm_matmul_group
# and norm_qkv_rope), at the decode shapes of 1-2 rows: Vicuna-7B's q/k/v,
# gate/up and lm_head, the tp 2 / tp 4 ranks' column shards, a head_dim of
# 64 with GQA.  Each is held bit-equal to K8, the grouped K5 and K9 launched
# one after another on the same inputs: s, h where written, every product,
# the rotated q, the whole caches (values and scales).

# (K, member N..., head_dim): q/k/v groups name their head_dim
NORM_GROUPS = {"qkv": (4096, (4096,) * 3, 128),
               "tp2 qkv": (4096, (2048,) * 3, 128),
               "tp4 qkv": (4096, (1024,) * 3, 128),
               "gqa64 qkv": (4096, (2048, 512, 512), 64),
               "gate_up": (4096, (11008,) * 2, None),
               "tp2 gate_up": (4096, (5504,) * 2, None),
               "tp4 gate_up": (4096, (2752,) * 2, None),
               "lm_head": (4096, (32000,), None)}


def _norm_inputs(gen, M, K, Ns, dtype, residual):
    x = (torch.randn((M, 1, K), generator=gen, device="cuda") * 3).to(dtype)
    y = (torch.randn((M, 1, K), generator=gen, device="cuda") * 3).to(dtype) \
        if residual else None
    w = (1 + 0.1 * torch.randn(K, generator=gen, device="cuda")).to(dtype)
    weights = [_k5_inputs(gen, 1, K, N)[1] for N in Ns]
    return x, y, w, weights


def _unfused_products(h, weights, out):
    """The products as the unfused route launches them: one grouped K5 for
    2-3 members, K5 alone for one."""
    if len(weights) == 1:
        return [dequant_matmul(h, weights[0], out_dtype=out)]
    return quant.dequant_matmul_group(h, weights, out_dtype=out)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("group", list(NORM_GROUPS))
def test_norm_k5_matches_k8_then_k5(group, M, dtype, residual):
    """K8 in K5's prologue against K8, then K5: s and h (kept) bit-equal,
    every product bit-equal in x's type and in fp32; one K5 launch counted
    on K5 and on ``norm_matmul_group``, none on K8."""
    from modelcompose_tpu_torch.ops import decode_fused as df
    K, Ns, _ = NORM_GROUPS[group]
    gen = torch.Generator(device="cuda").manual_seed(K + sum(Ns) + M)
    x, y, w, weights = _norm_inputs(gen, M, K, Ns, dtype, residual)
    for out in (dtype, torch.float32):
        before = (dequant_matmul.launches, df.norm_matmul_group.launches,
                  df.add_rms_norm.launches)
        s, h, got = df.norm_matmul_group(x, y, w, 1e-5, weights, out,
                                         keep_h=True)
        assert (dequant_matmul.launches, df.norm_matmul_group.launches,
                df.add_rms_norm.launches) == (before[0] + 1, before[1] + 1,
                                              before[2])
        want_s, want_h = df.add_rms_norm(x, y, w, 1e-5)
        want = _unfused_products(want_h, weights, out)
        assert torch.equal(s, want_s) and torch.equal(h, want_h)
        assert (s is x) == (y is None)
        for a, b in zip(got, want):
            assert a.dtype == out and a.shape == b.shape
            assert torch.equal(a, b)
        _, none, again = df.norm_matmul_group(x, y, w, 1e-5, weights, out)
        assert none is None
        assert all(torch.equal(a, b) for a, b in zip(again, got))


def _rope_case(gen, M, K, Ns, D, dtype, int8, residual, S=3360, NL=2):
    from modelcompose_tpu_torch.config import ModelConfig
    from modelcompose_tpu_torch.core.llama import KVCache
    from modelcompose_tpu_torch.ops.rope import rope_tables
    x, y, w, weights = _norm_inputs(gen, M, K, Ns, dtype, residual)
    Hkv = Ns[1] // D
    cfg = ModelConfig(hidden_size=Ns[0], num_attention_heads=Ns[0] // D,
                      num_key_value_heads=Hkv, num_hidden_layers=NL,
                      dtype="bfloat16" if dtype == torch.bfloat16
                      else "float16")
    caches = [KVCache.zeros(cfg, M, S, quantized=int8, device="cuda")
              for _ in range(2)]
    for c in caches[0].tensors():  # filled, so the writes are what differ
        c.copy_(torch.randint(-100, 100, c.shape, generator=gen,
                              device="cuda").to(c.dtype))
    for a, b in zip(caches[0].tensors(), caches[1].tensors()):
        b.copy_(a)
    pos = torch.randperm(S, generator=gen, device="cuda")[:M]
    cos, sin = rope_tables(pos[:, None], D)
    return (x, y, w, weights), caches, cos, sin, pos


def _k8_k5_k9(x, y, w, weights, rope):
    """K8, the grouped K5 in x's type and K9, launched one after another."""
    from modelcompose_tpu_torch.ops import decode_fused as df
    s, h = df.add_rms_norm(x, y, w, 1e-5)
    q = df.rotate_and_write(
        quant.dequant_matmul_group(h, weights, out_dtype=x.dtype), rope,
        df.rope_kv_write)
    return s, q


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("group", [g for g in NORM_GROUPS
                                   if NORM_GROUPS[g][2]])
def test_norm_qkv_rope_matches_k8_k5_k9(group, M, dtype, int8, residual):
    """K8 in the q/k/v launch's prologue and K9 in its epilogue against K8,
    the grouped K5 and K9 launched in turn, over a 3,360-position cache
    with a different position a row (int32 and int64 positions): s, the
    rotated q and the whole caches (int8 values and scales, or the half
    entries) bit-equal; one K5 launch counted on K5 and on
    ``norm_qkv_rope``, none on K8 or K9."""
    from modelcompose_tpu_torch.ops import decode_fused as df
    K, Ns, D = NORM_GROUPS[group]
    gen = torch.Generator(device="cuda").manual_seed(K + sum(Ns) + M + int8)
    (x, y, w, weights), (fc, pc), cos, sin, pos = _rope_case(
        gen, M, K, Ns, D, dtype, int8, residual)
    for p in (pos.int(), pos):
        before = (dequant_matmul.launches, df.norm_qkv_rope.launches,
                  df.add_rms_norm.launches, df.rope_kv_write.launches)
        s, q = df.norm_qkv_rope(x, y, w, 1e-5, weights, df.RopeWrite(
            cos, sin, fc.k, fc.v, 1, p))
        assert (dequant_matmul.launches, df.norm_qkv_rope.launches,
                df.add_rms_norm.launches, df.rope_kv_write.launches) == (
            before[0] + 1, before[1] + 1, before[2], before[3])
        want_s, want_q = _k8_k5_k9(x, y, w, weights, df.RopeWrite(
            cos, sin, pc.k, pc.v, 1, p))
        assert torch.equal(s, want_s)
        assert q.shape == want_q.shape == (M, 1, Ns[0] // D, D)
        assert q.dtype == dtype and torch.equal(q, want_q)
        for a, b in zip(fc.tensors(), pc.tensors()):
            assert torch.equal(a, b)


def test_norm_qkv_rope_in_a_graph_replay_at_new_positions():
    """The two fused forms captured in a CapturedStep (recorded as K5
    launches and as their own, counted at each replay), replayed at new
    positions copied into the static position buffer: each replay's s, q,
    gate/up products and cache writes bit-equal to K8, K5 and K9 launched
    eagerly at those positions."""
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    from modelcompose_tpu_torch.ops import decode_fused as df
    from modelcompose_tpu_torch.ops.rope import rope_tables
    gen = torch.Generator(device="cuda").manual_seed(21)
    K, Ns, D = NORM_GROUPS["qkv"]
    (x, y, w, weights), (fc, pc), _, _, pos = _rope_case(
        gen, 1, K, Ns, D, torch.bfloat16, True, True)
    up_w = [_k5_inputs(gen, 1, K, 11008)[1] for _ in range(2)]
    static_pos = pos.clone()

    def fused(p):
        cos, sin = rope_tables(p[:, None], D)
        s, q = df.norm_qkv_rope(x, y, w, 1e-5, weights,
                                df.RopeWrite(cos, sin, fc.k, fc.v, 1, p))
        s2, _, gu = df.norm_matmul_group(s, y, w, 1e-5, up_w)
        return [s, q, s2] + gu

    def unfused(p):
        cos, sin = rope_tables(p[:, None], D)
        s, q = _k8_k5_k9(x, y, w, weights,
                         df.RopeWrite(cos, sin, pc.k, pc.v, 1, p))
        s2, h2 = df.add_rms_norm(s, y, w, 1e-5)
        return [s, q, s2] + quant.dequant_matmul_group(h2, up_w,
                                                       out_dtype=x.dtype)

    class Step(CapturedStep):
        def _step(self):
            return tuple(fused(static_pos))
    graph = Step("cuda")
    graph.run()  # eager warm-up and capture
    unfused(pos)  # the warm-up's writes
    assert graph.graph is not None
    assert (len(graph.k5.norm_rope), len(graph.k5.norm_group),
            len(graph.k5.launches)) == (1, 1, 2)
    for new in (pos + 5, pos + 17):
        static_pos.copy_(new)
        before = (dequant_matmul.launches, df.norm_qkv_rope.launches,
                  df.norm_matmul_group.launches)
        got = graph.run()
        assert (dequant_matmul.launches - before[0],
                df.norm_qkv_rope.launches - before[1],
                df.norm_matmul_group.launches - before[2]) == (2, 1, 1)
        for a, b in zip(got, unfused(new)):
            assert torch.equal(a, b)
        for a, b in zip(fc.tensors(), pc.tensors()):
            assert torch.equal(a, b)


def test_fused_k5_raises_and_does_not_fall_back():
    """On the card the fused launch runs or raises: a refused shape raises
    before launching and leaves every count unchanged (no K8, K5 or K9
    launch in its place), and the C entry refuses what the launcher would
    not send (an x of K past 8,192, three rows, a RoPE group of two)."""
    import ctypes
    from modelcompose_tpu_torch import _build
    from modelcompose_tpu_torch.ops import decode_fused as df
    gen = torch.Generator(device="cuda").manual_seed(22)
    (x, y, w, weights), (fc, _), cos, sin, pos = _rope_case(
        gen, 1, 4096, (4096, 1024, 1024), 128, torch.bfloat16, True, True,
        S=64)
    counts = (dequant_matmul.launches, df.add_rms_norm.launches,
              df.rope_kv_write.launches, df.norm_qkv_rope.launches)
    bad = df.RopeWrite(cos[..., :32].contiguous(), sin[..., :32].contiguous(),
                       fc.k, fc.v, 1, pos)
    with pytest.raises(ValueError):
        df.norm_qkv_rope(x, y, w, 1e-5, weights, bad)
    with pytest.raises(ValueError):
        df.norm_qkv_rope(x.expand(3, 1, 4096).contiguous(), None, w, 1e-5,
                         weights, df.RopeWrite(cos, sin, fc.k, fc.v, 1, pos))
    assert (dequant_matmul.launches, df.add_rms_norm.launches,
            df.rope_kv_write.launches, df.norm_qkv_rope.launches) == counts
    lib = _build.load("w8a16_gemv")
    out = torch.empty(1, 4096, dtype=torch.bfloat16, device="cuda")

    def call(M=1, K=4096, n=3, head_dim=128):
        ptrs = (ctypes.c_void_p * n)
        return lib.mc_w8a16_gemv_norm(
            x.data_ptr(), None, w.data_ptr(), None, None, 1e-5, n,
            ptrs(*[wq["q"].data_ptr() for wq in weights[:n]]),
            ptrs(*[wq["scale"].data_ptr() for wq in weights[:n]]),
            ptrs(*[out.data_ptr()] + [None] * (n - 1)),
            (ctypes.c_int * n)(*[4096, 1024, 1024][:n]), None, None, M, K,
            4096, 1, 1, head_dim, cos.data_ptr(), sin.data_ptr(),
            fc.k["q"].data_ptr(), fc.v["q"].data_ptr(),
            fc.k["scale"].data_ptr(), fc.v["scale"].data_ptr(),
            pos.data_ptr(), 1, 64, 8, 1,
            torch.cuda.current_stream().cuda_stream)
    for kw in ({"K": 8200}, {"M": 3}, {"n": 2}, {"head_dim": 96}):
        assert call(**kw) == 1  # cudaErrorInvalidValue
    torch.cuda.synchronize()


# ---------------------------------------------------------------- fp16
# K1-K4 and K2 take fp16 as the JAX kernels take any float type: the
# products are wgmma's .f16 forms (K1, K3, K4), P and dS rounded to fp16
# (its subnormals kept), the outputs stored in fp16; K2 reads an fp16 q and
# an fp16 or int8 cache and works in fp32.  Each at the bf16 tests' shapes
# (the 3,328 bucket, a prefill chunk, the train shapes, the MCUB-4 decode)
# within 2e-2 of its plain version on the same fp16 inputs.

def _rnd_as(gen, dtype, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        dtype)


@pytest.mark.parametrize("B,Lq,S,H,Hkv,D,q_offset,lengths,scale", [
    (1, 3328, 3328, 32, 32, 128, 0, (3287,), 1.0),  # the MCUB-4 prefill
    (2, 150, 150, 32, 32, 128, 0, (150, 97), 1.0),
    (3, 200, 200, 8, 2, 64, 0, (200, 1, 130), 1.0),
    (1, 512, 3072, 32, 32, 128, 2560, (3072,), 1.0),  # a prefill chunk
    (1, 256, 3328, 32, 32, 128, 3072, (3287,), 1.0),  # the last chunk
    # wide logits: most of P lies under fp16's smallest normal (6.1e-5)
    (1, 300, 300, 4, 4, 128, 0, (300,), 4.0),
])
def test_k1_fp16_matches_plain(B, Lq, S, H, Hkv, D, q_offset, lengths,
                               scale):
    gen = torch.Generator(device="cuda").manual_seed(Lq + S + 16)
    f16 = torch.float16
    q = _rnd_as(gen, f16, B, Lq, H, D, scale=scale)
    k, v = _rnd_as(gen, f16, B, S, Hkv, D), _rnd_as(gen, f16, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    n = flash_attention_forward.launches
    out, lse = flash_attention_forward(q, k, v, **kw)
    assert flash_attention_forward.launches == n + 1
    assert out.dtype == f16
    _check_k1(q, k, v, kw, out, lse)


@pytest.mark.parametrize("causal", [True, False])
def test_k1_k3_k4_fp16_fast_path_equals_masked_path(causal):
    """fp16's unmasked fast path bit-equal to every tile through the mask,
    forward and backward."""
    gen = torch.Generator(device="cuda").manual_seed(61)
    f16 = torch.float16
    q, k, v, do = (_rnd_as(gen, f16, 2, 384, 8, 128) for _ in range(4))
    seg = torch.ones((2, 384), dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = flash_attention_forward(q, k, v, **kw)
    out_m, lse_m = flash_attention_forward_mask_all(q, k, v, **kw)
    assert torch.equal(out, out_m) and torch.equal(lse, lse_m)
    di = _di(out, do)
    fast = (flash_attention_bwd_dq(q, k, v, do, lse, di, **kw),
            *flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw))
    for a, b in zip(fast, flash_attention_bwd_mask_all(q, k, v, do, lse, di,
                                                      **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,B,Lq,S,H,Hkv,D,q_offset,lengths", [
    ("ms_shape", 2, 2048, 2048, 32, 32, 128, 0, (2048, 1391)),
    ("micro_1400", 1, 2048, 2048, 32, 32, 128, 0, (1400,)),
    ("q_offset_gqa4", 2, 256, 1024, 32, 8, 128, 768, (1024, 900)),
    ("d64_gqa2", 2, 150, 150, 8, 4, 64, 0, (150, 61)),
])
def test_k3_k4_fp16_match_plain(name, B, Lq, S, H, Hkv, D, q_offset,
                                lengths):
    gen = torch.Generator(device="cuda").manual_seed(Lq + S + D + 16)
    f16 = torch.float16
    q = _rnd_as(gen, f16, B, Lq, H, D)
    k, v = _rnd_as(gen, f16, B, S, Hkv, D), _rnd_as(gen, f16, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    do = (_rnd_as(gen, f16, B, Lq, H, D)
          * (q_seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    n = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == f16
    _check_k3_k4((q, k, v, out, lse, do), kw, dq, dk, dv)


@pytest.mark.parametrize("cache", ["fp16", "int8"])
@pytest.mark.parametrize("NL,B,S,H,Hkv,D,kv_len", [
    (32, 1, 3328 + 32, 32, 32, 128, (3287,)),  # MCUB-4 decode, first step
    (32, 2, 3328 + 32, 32, 32, 128, (3318, 3300)),
    (32, 3, 3328 + 32, 32, 32, 128, (3287,) * 3),  # beams
    (2, 3, 257, 8, 1, 64, (1, 256, 257)),
    (4, 2, 1000, 32, 8, 128, (1000, 517)),
])
def test_k2_fp16_matches_plain(cache, NL, B, S, H, Hkv, D, kv_len):
    gen = torch.Generator(device="cuda").manual_seed(S + 16)
    f16 = torch.float16
    q = _rnd_as(gen, f16, B, 1, H, D)
    k, v = (_rnd_as(gen, f16, NL, B, S, Hkv, D) for _ in range(2))
    if cache == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    for layer in (0, NL - 1):
        n = flash_decode_attention.launches
        out = flash_decode_attention(q, k, v, lens, layer, sm_scale=D ** -0.5)
        assert flash_decode_attention.launches == n + 1
        ref = flash_decode_reference(q, k, v, lens, layer, sm_scale=D ** -0.5)
        assert out.dtype == f16 and torch.isfinite(out).all()
        assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_k2_fp16_split_edges_and_groups(quantized, group):
    D, Hkv = 128, 4
    lens = (1, 127, 128, 129, 256, 700)
    gen = torch.Generator(device="cuda").manual_seed(group + 16)
    f16 = torch.float16
    q = _rnd_as(gen, f16, len(lens), 1, Hkv * group, D)
    k, v = (_rnd_as(gen, f16, 2, len(lens), 700, Hkv, D) for _ in range(2))
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = flash_decode_attention(q, k, v, kv, 1, sm_scale=D ** -0.5)
    ref = flash_decode_reference(q, k, v, kv, 1, sm_scale=D ** -0.5)
    assert torch.isfinite(out).all() and _rel(out, ref) <= 2e-2


def test_bf16_and_fp16_kernels_live_in_one_process_and_one_graph():
    """bf16 and fp16 launches of K1, K3, K4 and K2 interleave in one
    process (one library a source, both types instantiated in it) and in
    one captured CUDA graph: each replay gives the eager launches' bits,
    and the graph's records count both types' launches."""
    from modelcompose_tpu_torch.ops import flash_attention as fa
    from modelcompose_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(71)

    def inputs(dtype):
        q, k, v, do = (_rnd_as(gen, dtype, 1, 256, 4, 128) for _ in range(4))
        cache = _rnd_as(gen, dtype, 2, 1, 300, 4, 128)
        return q, k, v, do, cache
    ins = {dt: inputs(dt) for dt in (torch.bfloat16, torch.float16)}
    lens = torch.tensor([211], dtype=torch.int32, device="cuda")

    def step():
        outs = []
        for q, k, v, do, cache in ins.values():
            out, lse = fa.flash_attention_forward(q, k, v)
            di = _di(out, do)
            outs += [out, fa.flash_attention_bwd_dq(q, k, v, do, lse, di),
                     *fa.flash_attention_bwd_dkv(q, k, v, do, lse, di),
                     fd.flash_decode_attention(q[:, :1].contiguous(), cache,
                                               cache, lens, 1,
                                               sm_scale=0.125)]
        return outs
    eager = step()
    for (q, k, v, _, _), got in zip(ins.values(), (eager[:5], eager[5:])):
        ref, _ = flash_attention_reference(q, k, v)
        assert got[0].dtype == q.dtype and _rel(got[0], ref) <= 2e-2
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()  # warm-up on the capturing stream
        with fa.capturing(side) as k1, fd.capturing() as k2:
            graph.capture_begin()
            static = step()
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert (len(k1.launches), len(k1.bwd_dq), len(k1.bwd_dkv),
            len(k2.launches)) == (2, 2, 2, 2)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            assert torch.equal(a, b)


def test_fp32_attention_on_card_launches():
    """fp32 q, k and v on the card: ``attention`` launches K1 (and K3/K4 in
    its backward) and ``decode_attention`` K2, each once, each within 1e-5
    of its plain version; nothing raises and nothing falls back."""
    gen = torch.Generator(device="cuda").manual_seed(72)
    q, k, v, do = (torch.randn((2, 96, 4, 64), generator=gen, device="cuda")
                   for _ in range(4))
    counts = (flash_attention_forward.launches,
              flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches,
              flash_decode_attention.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    want, lse = flash_attention_reference(q, k, v)
    assert out.dtype == torch.float32 and _rel(out, want) <= 1e-5
    for g, w in zip(grads, flash_attention_backward_reference(
            q, k, v, want, lse, do)):
        assert _rel(g, w) <= 1e-5
    cache = torch.randn((2, 2, 80, 4, 64), generator=gen, device="cuda")
    lens = torch.full((2,), 50, dtype=torch.int32, device="cuda")
    q1 = q[:, :1].contiguous()
    got = attention.decode_attention(q1, cache, cache, lens, layer_idx=1)
    ref = flash_decode_reference(q1, cache, cache, lens, 1, sm_scale=0.125)
    assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-5
    assert (flash_attention_forward.launches,
            flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches,
            flash_decode_attention.launches) == tuple(c + 1 for c in counts)


def test_fp16_refusals_still_raise():
    """An fp16 input the kernels refuse for another reason than its type
    raises on the card: a head dim of 96, k of another type than q, a GQA
    group of 3, a cache of the other half type."""
    gen = torch.Generator(device="cuda").manual_seed(73)
    f16 = torch.float16
    odd = _rnd_as(gen, f16, 1, 16, 2, 96)
    with pytest.raises(ValueError):
        attention.attention(odd, odd, odd)
    q = _rnd_as(gen, f16, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        flash_attention_forward(q, q.bfloat16(), q)
    cache = _rnd_as(gen, f16, 1, 1, 32, 1, 64)
    lens = torch.tensor([4], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        flash_decode_attention(_rnd_as(gen, f16, 1, 1, 3, 64), cache, cache,
                               lens, 0, sm_scale=0.125)
    with pytest.raises(TypeError):
        flash_decode_attention(q[:, :1].contiguous(), cache.bfloat16(),
                               cache.bfloat16(), lens, 0, sm_scale=0.125)


# ---------------------------------------------------------------- K10 in K5
# K10 in the prologue of the down product's K5 streaming launch
# (ops/decode_fused.silu_matmul) at 1-2 rows: Vicuna-7B's down product (K
# 11,008) and its tp 2 / tp 4 row shards (5,504, 2,752), bf16 and fp16,
# held bit-equal to K10 and then K5 on its own plan (the same streaming
# grid), with h written out or not, in the activations' type (the dense
# fold) and fp32 (an adapter branch, a row-split sum).  At two rows K5
# takes the tp 4 shard on the tensor cores, and the fused launch refuses it.

@pytest.mark.parametrize("keep_h", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("K", [11008, 5504, 2752])
def test_silu_in_k5_bit_equal_to_k10_then_k5(K, M, dtype, keep_h):
    from modelcompose_tpu_torch.ops import decode_fused as df
    gen = torch.Generator(device="cuda").manual_seed(K + M)
    N = 4096
    gate = (torch.randn((M, 1, K), generator=gen, device="cuda") * 3).to(
        dtype)
    up = torch.randn((M, 1, K), generator=gen, device="cuda").to(dtype)
    _, wq = _k5_inputs(gen, M, K, N, dtype)
    assert df._silu_streams(M, K, N) == ((K, M) != (2752, 2))
    if (K, M) == (2752, 2):
        before = (dequant_matmul.launches, df.silu_matmul.launches)
        assert not df.silu_fuses(gate, wq)
        with pytest.raises(ValueError):
            df.silu_matmul(gate, up, wq, keep_h=keep_h)
        assert (dequant_matmul.launches, df.silu_matmul.launches) == before
        return
    for out in (dtype, torch.float32):
        before = (dequant_matmul.launches, df.silu_matmul.launches,
                  df.silu_mul.launches)
        h, y = df.silu_matmul(gate, up, wq, out_dtype=out, keep_h=keep_h)
        assert (dequant_matmul.launches - before[0],
                df.silu_matmul.launches - before[1],
                df.silu_mul.launches - before[2]) == (1, 1, 0)
        h_ref = df.silu_mul(gate, up)  # K10
        (y_ref,) = quant._k5(h_ref.view(M, K), [wq], out)
        assert (h is not None) == keep_h
        if keep_h:
            assert torch.equal(h, h_ref)
        assert y.dtype == out and torch.equal(y.view(M, N), y_ref)
        assert _rel(y.view(M, N), dequant_matmul_reference(h_ref, wq, out)
                    .view(M, N)) <= (2e-2 if out != torch.float32 else 1e-5)


def test_silu_in_k5_replays_and_is_counted():
    """The fused launch captured in a CapturedStep: recorded (one K5 launch,
    one ``silu_matmul``), each replay counted and bit-equal to the eager
    call on new inputs."""
    from modelcompose_tpu_torch.core.decode_graph import CapturedStep
    from modelcompose_tpu_torch.ops import decode_fused as df
    gen = torch.Generator(device="cuda").manual_seed(81)
    K, N = 11008, 4096
    gate, up = (torch.randn((1, 1, K), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    _, wq = _k5_inputs(gen, 1, K, N)

    class Step(CapturedStep):
        def _step(self):
            return df.silu_matmul(gate, up, wq)[1]
    graph = Step("cuda")
    graph.run()  # eager warm-up and capture
    assert (len(graph.k5.silu_group), len(graph.k5.launches)) == (1, 1)
    for _ in range(2):
        gate.copy_(torch.randn((1, 1, K), generator=gen,
                               device="cuda").to(torch.bfloat16))
        before = (dequant_matmul.launches, df.silu_matmul.launches)
        got = graph.run().clone()
        assert (dequant_matmul.launches - before[0],
                df.silu_matmul.launches - before[1]) == (1, 1)
        assert torch.equal(got, df.silu_matmul(gate, up, wq)[1])


def test_silu_in_k5_raises_and_does_not_fall_back():
    """A refused input raises before launching and leaves the counts
    unchanged; the C entry refuses three rows, rows that are not whole
    warps' runs and a weight of N % 16."""
    import ctypes
    from modelcompose_tpu_torch import _build
    from modelcompose_tpu_torch.ops import decode_fused as df
    gen = torch.Generator(device="cuda").manual_seed(82)
    K, N = 2752, 4096
    gate = torch.randn((3, 1, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    _, wq = _k5_inputs(gen, 3, K, N)
    counts = (dequant_matmul.launches, df.silu_matmul.launches,
              df.silu_mul.launches)
    with pytest.raises(ValueError):
        df.silu_matmul(gate, gate, wq)
    with pytest.raises(TypeError):
        df.silu_matmul(gate[:1].float(), gate[:1].float(), wq)
    assert (dequant_matmul.launches, df.silu_matmul.launches,
            df.silu_mul.launches) == counts
    lib = _build.load("w8a16_gemv")
    out = torch.empty((3, N), dtype=torch.float32, device="cuda")

    def call(M=1, rows=2752, n=N):
        return lib.mc_w8a16_gemv_silu(
            gate.data_ptr(), gate.data_ptr(), None, wq["q"].data_ptr(),
            wq["scale"].data_ptr(), out.data_ptr(), n, None, None, M, K,
            rows, 1, 0, torch.cuda.current_stream().cuda_stream)
    for kw in ({"M": 3}, {"rows": 100}, {"n": 4090}):
        assert call(**kw) == 1  # cudaErrorInvalidValue
    torch.cuda.synchronize()


# ---------------------------------------------------------------- fp32
# K1-K4 and K2 at fp32 (a float32 model, ``--bf16 False`` training), as the
# JAX kernels take it: K1, K3 and K4 through their fp32 kernels (every
# product 3xTF32, on wgmma in K1 and K4 and on mma.sync in K3; P and dS
# kept fp32), K2 with fp32 loads.
# Each at the bf16 and fp16 tests' shapes within 1e-5 of max |plain| on the
# same fp32 inputs (the plain versions in full fp32: TF32 off), the LSE
# within 1e-5 of max(|LSE|, 1); padding rows' gradients zero.

F32_TOL = 1e-5


def _f32(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


@pytest.mark.parametrize("B,Lq,S,H,Hkv,D,q_offset,lengths", [
    (1, 3328, 3328, 32, 32, 128, 0, (3287,)),  # the MCUB-4 prefill
    (2, 1024, 1024, 32, 32, 128, 0, (1024, 637)),
    (2, 150, 150, 32, 32, 128, 0, (150, 97)),
    (1, 1, 77, 8, 8, 64, 76, (77,)),
    (2, 256, 1024, 32, 8, 128, 768, (1024, 900)),
    (3, 200, 200, 8, 2, 64, 0, (200, 1, 130)),
    (1, 512, 3072, 32, 32, 128, 2560, (3072,)),  # a prefill chunk
    (1, 256, 3328, 32, 32, 128, 3072, (3287,)),  # the last chunk
])
def test_k1_fp32_matches_plain(B, Lq, S, H, Hkv, D, q_offset, lengths):
    gen = torch.Generator(device="cuda").manual_seed(Lq + S + 32)
    q = _f32(gen, B, Lq, H, D)
    k, v = _f32(gen, B, S, Hkv, D), _f32(gen, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    n = flash_attention_forward.launches
    out, lse = flash_attention_forward(q, k, v, **kw)
    assert flash_attention_forward.launches == n + 1
    assert out.dtype == torch.float32
    _check_k1(q, k, v, kw, out, lse, tol=F32_TOL, lse_tol=F32_TOL)


@pytest.mark.parametrize("name,B,L,H,Hkv,D,bounds,causal", [
    ("ragged", 1, 77, 4, 4, 64, (77,), True),
    ("three_segments", 2, 300, 8, 8, 64, (70, 190, 290), True),
    ("boundary_d128", 1, 256, 4, 4, 128, (100, 256), True),
    ("noncausal", 2, 200, 8, 4, 128, (50, 160), False),
])
def test_k1_k3_k4_fp32_segments_and_masks(name, B, L, H, Hkv, D, bounds,
                                          causal):
    """Packed segments, padding, causal and not, forward and backward at
    fp32; the masked-path entries (``mask_all``) bit-equal to the others
    (K1 and K4 skip the mask on interior tiles; K3 masks every element)."""
    gen = torch.Generator(device="cuda").manual_seed(L + D + 33)
    q, do = _f32(gen, B, L, H, D), _f32(gen, B, L, H, D)
    k, v = _f32(gen, B, L, Hkv, D), _f32(gen, B, L, Hkv, D)
    seg = _packed_segments(B, L, bounds)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = flash_attention_forward(q, k, v, **kw)
    _check_k1(q, k, v, kw, out, lse, tol=F32_TOL, lse_tol=F32_TOL)
    do = (do * (seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    _check_k3_k4((q, k, v, out, lse, do), kw, dq, dk, dv, tol=F32_TOL)
    out_m, lse_m = flash_attention_forward_mask_all(q, k, v, **kw)
    assert torch.equal(out, out_m) and torch.equal(lse, lse_m)
    for a, b in zip((dq, dk, dv), flash_attention_bwd_mask_all(
            q, k, v, do, lse, di, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,B,Lq,S,H,Hkv,D,q_offset,lengths", [
    ("ms_shape", 2, 2048, 2048, 32, 32, 128, 0, (2048, 1391)),
    ("micro_1400", 1, 2048, 2048, 32, 32, 128, 0, (1400,)),
    ("ragged", 2, 150, 150, 32, 32, 128, 0, (150, 97)),
    ("q_offset_gqa4", 2, 256, 1024, 32, 8, 128, 768, (1024, 900)),
    ("gqa8", 2, 300, 300, 32, 4, 128, 0, (300, 211)),
    ("d64_gqa2", 2, 150, 150, 8, 4, 64, 0, (150, 61)),
    ("d64_one_valid_row", 3, 200, 200, 8, 2, 64, 0, (200, 1, 130)),
    ("batch_edge", 2, 100, 100, 4, 4, 128, 0, (100, 100)),
])
def test_k3_k4_fp32_match_plain(name, B, Lq, S, H, Hkv, D, q_offset,
                                lengths):
    gen = torch.Generator(device="cuda").manual_seed(Lq + S + D + 32)
    q = _f32(gen, B, Lq, H, D)
    k, v = _f32(gen, B, S, Hkv, D), _f32(gen, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    do = (_f32(gen, B, Lq, H, D) * (q_seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    n = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    _check_k3_k4((q, k, v, out, lse, do), kw, dq, dk, dv, tol=F32_TOL)


# K1's fp32 kernel works in 128-row q blocks over 32-row kv tiles, K4's in
# 64-row kv blocks over 32-row q tiles of every head of the GQA group; the
# edges of those tiles, prefill chunks (q_offset), GQA groups 1, 4 and 8,
# and D 64, each against the plain versions at 1e-5.
@pytest.mark.parametrize("name,B,Lq,S,H,Hkv,D,q_offset,lengths", [
    ("ragged_d128", 2, 161, 161, 8, 8, 128, 0, (161, 95)),
    ("ragged_d64", 2, 97, 97, 8, 8, 64, 0, (97, 40)),
    ("one_tile_each", 1, 31, 33, 4, 4, 128, 2, (33,)),
    ("chunk_q_offset", 1, 96, 613, 8, 8, 128, 517, (613,)),
    ("chunk_d64_gqa4", 2, 70, 330, 16, 4, 64, 260, (330, 300)),
    ("gqa1", 1, 200, 200, 8, 8, 128, 0, (200,)),
    ("gqa4", 2, 130, 130, 16, 4, 128, 0, (130, 77)),
    ("gqa8", 1, 257, 257, 32, 4, 128, 0, (257,)),
    ("gqa8_d64", 1, 65, 65, 16, 2, 64, 0, (65,)),
])
def test_k1_k4_fp32_tile_edges_chunks_and_groups(name, B, Lq, S, H, Hkv, D,
                                                 q_offset, lengths):
    gen = torch.Generator(device="cuda").manual_seed(Lq + 7 * S + D)
    q = _f32(gen, B, Lq, H, D)
    k, v = _f32(gen, B, S, Hkv, D), _f32(gen, B, S, Hkv, D)
    kv_seg = (torch.arange(S, device="cuda")[None]
              < torch.tensor(lengths, device="cuda")[:, None]).int()
    q_seg = kv_seg[:, q_offset:q_offset + Lq].contiguous()
    kw = dict(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              q_offset=q_offset)
    out, lse = flash_attention_forward(q, k, v, **kw)
    _check_k1(q, k, v, kw, out, lse, tol=F32_TOL, lse_tol=F32_TOL)
    do = (_f32(gen, B, Lq, H, D) * (q_seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    _check_k3_k4((q, k, v, out, lse, do), kw, dq, dk, dv, tol=F32_TOL)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_k4_fp32_fast_path_equals_masked_path(causal, D):
    """Interior tiles skip the per-element mask in K1's and K4's fp32
    kernels; forcing the mask on every tile gives the same bits, and both
    match the plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(9 + D)
    q, k, v, do = (_f32(gen, 2, 640, 8, D) for _ in range(4))
    seg = _packed_segments(2, 640, (384, 600))
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = flash_attention_forward(q, k, v, **kw)
    out_m, lse_m = flash_attention_forward_mask_all(q, k, v, **kw)
    assert torch.equal(out, out_m) and torch.equal(lse, lse_m)
    _check_k1(q, k, v, kw, out, lse, tol=F32_TOL, lse_tol=F32_TOL)
    do = (do * (seg != 0)[..., None, None]).contiguous()
    di = _di(out, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
    _, dk_m, dv_m = flash_attention_bwd_mask_all(q, k, v, do, lse, di, **kw)
    assert torch.equal(dk, dk_m) and torch.equal(dv, dv_m)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
    _check_k3_k4((q, k, v, out, lse, do), kw, dq, dk, dv, tol=F32_TOL)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
@pytest.mark.parametrize("NL,B,S,H,Hkv,D,kv_len", [
    (32, 1, 3328 + 32, 32, 32, 128, (3287,)),  # MCUB-4 decode, first step
    (32, 2, 3328 + 32, 32, 32, 128, (3318, 3300)),
    (32, 3, 3328 + 32, 32, 32, 128, (3287,) * 3),  # beams
    (2, 3, 257, 8, 1, 64, (1, 256, 257)),
    (4, 2, 1000, 32, 8, 128, (1000, 517)),
])
def test_k2_fp32_matches_plain(cache, NL, B, S, H, Hkv, D, kv_len):
    gen = torch.Generator(device="cuda").manual_seed(S + 32)
    q = _f32(gen, B, 1, H, D)
    k, v = (_f32(gen, NL, B, S, Hkv, D) for _ in range(2))
    if cache == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    for layer in (0, NL - 1):
        n = flash_decode_attention.launches
        out = flash_decode_attention(q, k, v, lens, layer, sm_scale=D ** -0.5)
        assert flash_decode_attention.launches == n + 1
        ref = flash_decode_reference(q, k, v, lens, layer, sm_scale=D ** -0.5)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        assert _rel(out, ref) <= F32_TOL


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_k2_fp32_split_edges_and_groups(quantized, group):
    D, Hkv = 128, 4
    lens = (1, 127, 128, 129, 256, 700)
    gen = torch.Generator(device="cuda").manual_seed(group + 32)
    q = _f32(gen, len(lens), 1, Hkv * group, D)
    k, v = (_f32(gen, 2, len(lens), 700, Hkv, D) for _ in range(2))
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = flash_decode_attention(q, k, v, kv, 1, sm_scale=D ** -0.5)
    ref = flash_decode_reference(q, k, v, kv, 1, sm_scale=D ** -0.5)
    assert torch.isfinite(out).all() and _rel(out, ref) <= F32_TOL


def test_three_types_live_in_one_process_and_one_graph():
    """bf16, fp16 and fp32 launches of K1, K3, K4 and K2 interleave in one
    process (one library a source) and in one captured CUDA graph: each
    replay gives the eager launches' bits, and the graph's records count
    every type's launches."""
    from modelcompose_tpu_torch.ops import flash_attention as fa
    from modelcompose_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(74)
    types = (torch.bfloat16, torch.float16, torch.float32)
    ins = {dt: [_rnd_as(gen, dt, 1, 256, 4, 128) for _ in range(4)]
           + [_rnd_as(gen, dt, 2, 1, 300, 4, 128)] for dt in types}
    lens = torch.tensor([211], dtype=torch.int32, device="cuda")

    def step():
        outs = []
        for q, k, v, do, cache in ins.values():
            out, lse = fa.flash_attention_forward(q, k, v)
            di = _di(out, do)
            outs += [out, fa.flash_attention_bwd_dq(q, k, v, do, lse, di),
                     *fa.flash_attention_bwd_dkv(q, k, v, do, lse, di),
                     fd.flash_decode_attention(q[:, :1].contiguous(), cache,
                                               cache, lens, 1,
                                               sm_scale=0.125)]
        return outs
    eager = step()
    q, k, v = ins[torch.float32][:3]
    assert eager[10].dtype == torch.float32
    assert _rel(eager[10], flash_attention_reference(q, k, v)[0]) <= F32_TOL
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()  # warm-up on the capturing stream
        with fa.capturing(side) as k1, fd.capturing() as k2:
            graph.capture_begin()
            static = step()
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert (len(k1.launches), len(k1.bwd_dq), len(k1.bwd_dkv),
            len(k2.launches)) == (3, 3, 3, 3)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            assert torch.equal(a, b)


def test_fp32_kernels_raise_instead_of_falling_back():
    """An fp32 input the kernels refuse for another reason than its type
    raises on the card: a head dim of 96, k of another type than q, a GQA
    group of 3, a cache of another type than q."""
    gen = torch.Generator(device="cuda").manual_seed(75)
    odd = _f32(gen, 1, 16, 2, 96)
    with pytest.raises(ValueError):
        attention.attention(odd, odd, odd)
    q = _f32(gen, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        flash_attention_forward(q, q.bfloat16(), q)
    cache = _f32(gen, 1, 1, 32, 1, 64)
    lens = torch.tensor([4], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        flash_decode_attention(_f32(gen, 1, 1, 3, 64), cache, cache, lens, 0,
                               sm_scale=0.125)
    with pytest.raises(TypeError):
        flash_decode_attention(q[:, :1].contiguous(), cache.half(),
                               cache.half(), lens, 0, sm_scale=0.125)
