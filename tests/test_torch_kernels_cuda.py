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
