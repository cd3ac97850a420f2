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
order) and zero on padding rows.
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
from modelcompose_tpu_torch.ops.quant import matmul_f32

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


def _check_k1(q, k, v, kw, out, lse):
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    valid = kw["q_segment_ids"] != 0
    assert torch.isfinite(out[valid]).all()
    assert _rel(out[valid], ref[valid]) <= 2e-2
    got_lse = lse.transpose(1, 2)[valid]
    want_lse = ref_lse.transpose(1, 2)[valid]
    assert (got_lse - want_lse).abs().max().item() <= 1e-3 * max(
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


def _check_k3_k4(args, kw, dq, dk, dv):
    """dQ, dK and dV against the plain versions on valid rows, and zero on
    padding rows (a padding row's P is masked to 0 on both sides)."""
    q, k, v, out, lse, do = args
    ref = flash_attention_backward_reference(q, k, v, out, lse, do, **kw)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    q_valid, kv_valid = kw["q_segment_ids"] != 0, kw["kv_segment_ids"] != 0
    for got, want, rows in ((dq, ref[0], q_valid), (dk, ref[1], kv_valid),
                            (dv, ref[2], kv_valid)):
        assert torch.isfinite(got).all()
        assert _rel(got[rows], want[rows]) <= 2e-2
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
    for bad in (q.float(), _rnd(gen, 1, 16, 2, 96)):
        lse_b = torch.zeros(1, 2, 16, device="cuda")
        err = TypeError if bad.dtype == torch.float32 else ValueError
        with pytest.raises(err):
            flash_attention_bwd_dq(bad, bad, bad, bad, lse_b, lse_b)
        with pytest.raises(err):
            flash_attention_bwd_dkv(bad, bad, bad, bad, lse_b, lse_b)
    with pytest.raises(ValueError):  # an LSE laid out [B, Lq, H]
        flash_attention_bwd_dq(q, q, q, q, lse.transpose(1, 2), lse)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())


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


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("quantized_base", [False, True])
def test_decode_graph_replays_the_eager_step_bit_for_bit(quantized_base,
                                                          kv_quant):
    """Prefill two rows, then 12 greedy steps eagerly and 12 through a
    DecodeGraph: ids equal and logits bit-equal at every step (the same
    kernels on the same addresses' data), and each replay counts the K2
    launches it ran."""
    from modelcompose_tpu_torch.core import generate as tgen
    from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
    from modelcompose_tpu_torch.ops.routed_lora import as_table
    cfg, params, gen = _tiny_card_backbone(quantized_base)
    B, L, S = 2, 40, 60
    embeds = _rnd(gen, B, L, cfg.hidden_size)
    lengths = torch.tensor([40, 23], dtype=torch.int32, device="cuda")
    seg = (torch.arange(L, device="cuda")[None] < lengths[:, None]).int()
    table = as_table(cfg.routing_table(), "cuda")
    graph = DecodeGraph(params, cfg, B, S, kv_quant=kv_quant,
                        routing_table=table)
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
                logits = graph(tokens, kv).clone()
                assert flash_decode_attention.launches \
                    == n + cfg.num_hidden_layers
            else:
                with torch.no_grad():
                    logits, cache, _ = tgen._decode_step(
                        params, cfg, cache, tokens, kv, table)
            kv = kv + 1
            steps.append((tokens, logits))
        runs.append(steps)
    assert graph.graph is not None and len(graph.k2.launches) \
        == cfg.num_hidden_layers
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
