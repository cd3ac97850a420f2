"""K8 and K9 inside K5's streaming launch (``ops/decode_fused.
norm_matmul_group``, ``norm_qkv_rope``; ``csrc/w8a16_gemv.cu``
``mc_w8a16_gemv_norm``) on the CPU: the fused launch's plain version
against the JAX decode layer's sequence, the routing rule, the launcher's
checks and arguments, the replay's counts, and decode steps with the card's
rule emulated.

The JAX sequence is the decode layer's own (``modelcompose_tpu/core/
llama.py`` under ``core/generate._decode_step``): ``rms_norm(x + y)``
(``ops/norms.py``), ``dequant_matmul`` for each member (``ops/quant.py``),
``apply_rope`` (``ops/rope.py``), ``quantize_kv`` and the token scatter.
Inputs are seeded numpy arrays; int8 weights come from the JAX package's
``quantize_int8`` through ``convert.params_from_jax``.  Tolerances,
relative to max |JAX|, as tests/test_torch_decode_fused.py states them for
K8 and K9: 1e-5 in fp32, 2e-2 in bf16; int8 cache values equal wherever
the two scales agree to the bit (within one step elsewhere), the scales
within 1e-5; logits 2e-2 of max |logit| and the greedy ids equal.

The kernel has no CPU build; its card tests (bit-equal to K8, the grouped
K5 and K9 in turn) are in tests/test_torch_kernels_cuda.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.ops import norms as jnorms
from modelcompose_tpu.ops import quant as jquant
from modelcompose_tpu.ops import rope as jrope

from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.convert import params_from_jax
from modelcompose_tpu_torch.core import decode_graph, llama
from modelcompose_tpu_torch.core.decode_graph import _decode_step
from modelcompose_tpu_torch.core.prefill_graph import _prefill
from modelcompose_tpu_torch.ops import _route, decode_fused, quant
from modelcompose_tpu_torch.ops.rope import rope_tables

from test_torch_decode_fused import (DTYPES, LOGIT_TOL, _Card, _close,
                                     _jax_write, _model, _port, _routes, _t)

H = 256  # the hidden width of these tests


def _weights(rng, Ns, K=H):
    """int8 weights [K, N] from the JAX package's quantizer: (JAX dicts,
    port dicts)."""
    jw = [jquant.quantize_int8(jnp.asarray(
        rng.normal(0, 0.05, (K, N)).astype(np.float32)), axis=-2)
        for N in Ns]
    return jw, [params_from_jax(jax.tree.map(np.asarray, w)) for w in jw]


def _xyw(rng, M, residual):
    x = rng.normal(0, 2, (M, 1, H)).astype(np.float32)
    y = rng.normal(0, 2, (M, 1, H)).astype(np.float32) if residual else None
    w = rng.normal(1, 0.1, (H,)).astype(np.float32)
    return x, y, w


def _jax_h(x, y, w, jdt):
    """The JAX layer's residual add and ``rms_norm``: (s, h)."""
    jx = jnp.asarray(x, jdt)
    js = jx if y is None else jx + jnp.asarray(y, jdt)
    return js, jnorms.rms_norm(js, jnp.asarray(w, jdt), 1e-5)


# ---------------------------------------------------------------- plain

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("Ns", [(256, 128, 128), (512, 512)],
                         ids=["qkv_gqa", "gate_up"])
def test_norm_matmul_group_plain_matches_jax(Ns, M, residual, dtype):
    """(s, h, each member's product) of the fused launch's plain version
    against ``rms_norm(x + y)`` and ``dequant_matmul`` per member, with an
    fp32 and an x-typed result; s and h bit-equal to K8's plain version."""
    rng = np.random.default_rng(M + 10 * residual + len(Ns))
    x, y, w = _xyw(rng, M, residual)
    jw, tw = _weights(rng, Ns)
    tdt, jdt = DTYPES[dtype]
    tx, tn = _t(x).to(tdt), _t(w).to(tdt)
    ty = None if y is None else _t(y).to(tdt)
    js, jh = _jax_h(x, y, w, jdt)
    for out in (None, torch.float32):
        s, h, outs = decode_fused.norm_matmul_group_reference(
            tx, ty, tn, 1e-5, tw, out, keep_h=True)
        want_s, want_h = decode_fused.add_rms_norm_reference(tx, ty, tn,
                                                             1e-5)
        assert torch.equal(s, want_s) and torch.equal(h, want_h)
        _close(s, js, dtype)
        _close(h, jh, dtype)
        for got, wq in zip(outs, jw):
            assert got.dtype == (out or tdt) and got.shape == (
                M, 1, wq["q"].shape[1])
            _close(got, jquant.dequant_matmul(
                jh, wq, None if out is None else jnp.float32), dtype)
        assert decode_fused.norm_matmul_group_reference(
            tx, ty, tn, 1e-5, tw, out)[1] is None


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("D,heads,kv_heads", [(64, 4, 2), (128, 2, 1)])
def test_norm_qkv_rope_plain_matches_jax(D, heads, kv_heads, M, dtype,
                                         int8):
    """The q/k/v form at head_dim 64 and 128 with GQA: the rotated q and
    the cache writes of layer 1 of a 2-layer cache, at a different
    position a row, against the JAX sequence (``rms_norm(x + y)``,
    ``dequant_matmul``, ``apply_rope``, ``quantize_kv`` and the scatter);
    bit-equal to K8's, the products' and K9's plain versions in turn."""
    rng = np.random.default_rng(D + M + int8)
    S, NL, layer = 12, 2, 1
    x, y, w = _xyw(rng, M, True)
    Ns = (heads * D, kv_heads * D, kv_heads * D)
    jw, tw = _weights(rng, Ns)
    pos = rng.permutation(S)[:M].astype(np.int32)
    tdt, jdt = DTYPES[dtype]
    cfg = PortConfig(hidden_size=heads * D, num_attention_heads=heads,
                     num_key_value_heads=kv_heads, num_hidden_layers=NL,
                     dtype=dtype)
    cos, sin = rope_tables(_t(pos)[:, None], D)
    got_c, plain_c = (llama.KVCache.zeros(cfg, M, S, quantized=int8,
                                          device="cpu") for _ in range(2))
    args = (_t(x).to(tdt), _t(y).to(tdt), _t(w).to(tdt), 1e-5, tw)
    s, q = decode_fused.norm_qkv_rope(
        *args, decode_fused.RopeWrite(cos, sin, got_c.k, got_c.v, layer,
                                      _t(pos)))
    # the unfused plain route, op for op
    want_s, h = decode_fused.add_rms_norm_reference(*args[:4])
    outs = [quant.dequant_matmul_reference(h, wq, tdt) for wq in tw]
    want_q = decode_fused.rope_kv_write_reference(
        *(o.view(M, 1, -1, D) for o in outs), cos, sin, plain_c.k, plain_c.v,
        layer, _t(pos))
    assert torch.equal(s, want_s) and torch.equal(q, want_q)
    assert q.shape == (M, 1, heads, D) and q.dtype == tdt
    assert all(torch.equal(a, b) for a, b in zip(got_c.tensors(),
                                                 plain_c.tensors()))
    # against the JAX layer
    _, jh = _jax_h(x, y, w, jdt)
    jq, jk, jv = (jquant.dequant_matmul(jh, wq).reshape(M, 1, -1, D)
                  for wq in jw)
    jcos, jsin = jrope.rope_tables(jnp.asarray(pos)[:, None], D)
    jq, jk = jrope.apply_rope(jq, jk, jcos, jsin)
    _close(q, jq, dtype)
    shape = (NL, M, S, kv_heads, D)
    for got, val in ((got_c.k, jk), (got_c.v, jv)):
        zero = {"q": jnp.zeros(shape, jnp.int8),
                "scale": jnp.zeros(shape[:-1] + (1,), jnp.float32)} \
            if int8 else jnp.zeros(shape, jdt)
        want = _jax_write(zero, val, layer, jnp.asarray(pos), M)
        if not int8:
            _close(got, want, dtype)
            continue
        gs, ws = got["scale"].numpy(), np.asarray(want["scale"])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
        gq = got["q"].numpy().astype(np.int32)
        wq = np.asarray(want["q"]).astype(np.int32)
        same = np.broadcast_to(gs == ws, gq.shape)
        np.testing.assert_array_equal(gq[same], wq[same])
        assert np.abs(gq - wq).max() <= 1


# ---------------------------------------------------------------- the rule

def test_the_fusion_rule(monkeypatch):
    """K8 goes into K5's prologue on the card at 1-2 rows of bf16/fp16
    with 2-3 int8 weights and no gradient; not on the CPU, at 3 rows, in
    fp32, with a float weight or one weight, past 8,192 or where x needs a
    gradient.  K9 goes into the epilogue for three members of whole heads
    of 64 or 128."""
    _, tw = _weights(np.random.default_rng(0), (256, 128, 128))
    x = torch.zeros(1, 1, H, dtype=torch.bfloat16)
    assert not decode_fused.norm_fuses(x, tw)  # the CPU
    monkeypatch.setattr(_route, "on_card", lambda t, kernels: kernels
                        in ("products", "decode"))
    assert decode_fused.norm_fuses(x, tw)
    assert decode_fused.norm_fuses(x.half(), tw[:2])
    assert decode_fused.norm_fuses(torch.zeros(2, 1, H, dtype=torch.bfloat16),
                                   tw)
    assert not decode_fused.norm_fuses(
        torch.zeros(3, 1, H, dtype=torch.bfloat16), tw)
    assert not decode_fused.norm_fuses(x.float(), tw)
    assert not decode_fused.norm_fuses(x, tw[:1])
    assert not decode_fused.norm_fuses(x, [torch.zeros(H, 256)] + tw[1:])
    wide = torch.zeros(1, 1, 8200, dtype=torch.bfloat16)
    assert not decode_fused.norm_fuses(wide, tw)
    assert not decode_fused.norm_fuses(x.clone().requires_grad_(True), tw)
    with torch.no_grad():
        assert decode_fused.norm_fuses(x.clone().requires_grad_(True), tw)
    assert decode_fused.rope_fuses(tw, 64) and decode_fused.rope_fuses(tw,
                                                                       128)
    assert not decode_fused.rope_fuses(tw, 32)
    assert not decode_fused.rope_fuses(tw[:2], 64)
    _, odd = _weights(np.random.default_rng(1), (256, 128, 96))
    assert not decode_fused.rope_fuses(odd, 64)


# ---------------------------------------------------------------- launcher

def _fake_lib(monkeypatch):
    """The fused entry without a card: it records its arguments."""
    launched = []

    class Lib:
        def mc_w8a16_gemv_norm(self, *args):
            launched.append(args)
            return 0

        def mc_w8a16_gemv_silu(self, *args):
            launched.append(args)
            return 0
    monkeypatch.setattr(quant._build, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(quant, "_SCRATCH", {})
    return launched


def _rope(M, D, kv_heads, int8, dtype=torch.bfloat16, S=16, NL=2):
    cfg = PortConfig(hidden_size=H, num_attention_heads=H // D,
                     num_key_value_heads=kv_heads, num_hidden_layers=NL,
                     dtype="bfloat16" if dtype == torch.bfloat16
                     else "float16")
    cache = llama.KVCache.zeros(cfg, M, S, quantized=int8, device="cpu")
    pos = torch.arange(M, dtype=torch.int64) + 3
    cos, sin = rope_tables(pos[:, None], D)
    return decode_fused.RopeWrite(cos, sin, cache.k, cache.v, 1, pos)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("M", [1, 2])
def test_fused_launch_arguments_and_counts(monkeypatch, M, rope):
    """The fused entry gets the group's streaming grid (``_k5_group_plan``),
    x, y, the weight, s's and h's buffers (null where not written), every
    member's operands, and with RoPE the head dim, cos, sin, the caches,
    scales and positions, Hkv, S and the layer, with k's and v's outputs
    null; one launch counts on K5 and on its wrapper."""
    launched = _fake_lib(monkeypatch)
    rng = np.random.default_rng(M)
    Ns = (256, 128, 128)
    _, tw = _weights(rng, Ns)
    x, y, w = (_t(a).to(torch.bfloat16) for a in _xyw(rng, M, True))
    k5, wrappers = quant.dequant_matmul.launches, (
        decode_fused.norm_matmul_group.launches,
        decode_fused.norm_qkv_rope.launches)
    if rope:
        r = _rope(M, 64, 2, True)
        s, q = decode_fused._k5_norm(x, y, w, 1e-5, tw, torch.bfloat16, r,
                                     False, decode_fused.norm_qkv_rope)[::2]
        assert [tuple(o.shape) for o in q] == [(M, 1, 256)]
    else:
        s, h, outs = decode_fused._k5_norm(x, y, w, 1e-5, tw, torch.float32,
                                           None, True,
                                           decode_fused.norm_matmul_group)
        assert h.shape == x.shape and [o.dtype for o in outs] == \
            [torch.float32] * 3
    (args,) = launched
    assert quant.dequant_matmul.launches == k5 + 1
    assert (decode_fused.norm_matmul_group.launches,
            decode_fused.norm_qkv_rope.launches) == (
        wrappers[0] + (not rope), wrappers[1] + rope)
    _, rows, splits, tiles = quant._k5_group_plan(M, H, Ns)
    assert args[0] == x.data_ptr() and args[1] == y.data_ptr()
    assert args[2] == w.data_ptr() and args[3] == s.data_ptr()
    assert s is not x and (args[4] is None) == rope
    assert args[5] == pytest.approx(1e-5) and args[6] == 3
    assert list(args[10]) == list(Ns)
    assert (args[11] is None) == (splits == 1)
    assert args[13:19] == (M, H, rows, 1, 1 if rope else 0,
                           64 if rope else 0)
    outs_ptr = list(args[9])
    if rope:
        assert outs_ptr[1:] == [None, None]
        kq, ks = decode_fused._parts(r.cache_k)
        vq, vs = decode_fused._parts(r.cache_v)
        assert args[19:26] == (r.cos.data_ptr(), r.sin.data_ptr(),
                               kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                               vs.data_ptr(), r.pos.data_ptr())
        assert args[26:30] == (1, 16, 2, 1)
    else:
        assert None not in outs_ptr and args[19:26] == (None,) * 7


def test_fused_launch_without_a_residual_returns_x():
    """With no residual the sum is x itself: no buffer, a null pointer."""
    rng = np.random.default_rng(3)
    _, tw = _weights(rng, (256, 256))
    x = _t(rng.normal(size=(1, 1, H)).astype(np.float32)).to(torch.bfloat16)
    w = torch.ones(H, dtype=torch.bfloat16)
    s, h, outs = decode_fused.norm_matmul_group(x, None, w, 1e-5, tw)
    assert s is x and h is None and len(outs) == 2


def test_launcher_refuses_what_the_kernel_does_not_take():
    """Raised before anything is built: H past 8,192, 3 rows, a member's N
    that is not whole heads, a head dim other than 64 or 128, two members
    with RoPE, mixed cache kinds, an fp32 x, an output type other than fp32
    or x's (and fp32 with RoPE)."""
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    _, tw = _weights(rng, (256, 128, 128))
    x = torch.zeros(1, 1, H, dtype=bf)
    w = torch.ones(H, dtype=bf)
    r = _rope(1, 64, 2, True)

    def launch(x=x, w=w, weights=tw, out=bf, rope=r):
        wrapper = decode_fused.norm_matmul_group if rope is None \
            else decode_fused.norm_qkv_rope
        decode_fused._k5_norm(x, None, w, 1e-5, weights, out, rope, False,
                              wrapper)
    wide = torch.zeros(1, 1, 8192 + 64, dtype=bf)
    _, wide_w = _weights(rng, (64, 64), K=8192 + 64)
    with pytest.raises(ValueError, match="8192"):
        launch(x=wide, w=torch.ones(8192 + 64, dtype=bf), weights=wide_w,
               rope=None)
    with pytest.raises(ValueError, match="rows"):
        launch(x=torch.zeros(3, 1, H, dtype=bf))
    _, odd = _weights(rng, (256, 96, 96))
    with pytest.raises(ValueError, match="whole heads"):
        launch(weights=odd)
    with pytest.raises(ValueError, match="head_dim"):
        launch(rope=_rope(1, 32, 2, True))
    with pytest.raises(ValueError, match="three"):
        launch(weights=tw[:2])
    mixed = r._replace(cache_v=_rope(1, 64, 2, False).cache_v)
    with pytest.raises(ValueError, match="two int8 caches"):
        launch(rope=mixed)
    with pytest.raises(TypeError):
        launch(x=x.float(), w=w.float())
    with pytest.raises(TypeError):
        launch(out=torch.float16, rope=None)
    with pytest.raises(ValueError, match="three"):
        launch(out=torch.float32)


def test_replay_counts_the_fused_k5_launches():
    """A replayed graph adds the fused launches its capture recorded
    (``CaptureRecord.norm_group`` / ``norm_rope``) to their wrappers, and
    to K5 those it recorded as K5's."""
    class _Graph:
        def replay(self):
            pass
    step = decode_graph.CapturedStep("cpu")
    step.graph = _Graph()
    step.k1 = types.SimpleNamespace(launches=[], bwd_dq=[], bwd_dkv=[])
    step.k2 = types.SimpleNamespace(launches=[])
    step.k5 = quant.CaptureRecord()
    step.k5.norm_group += [(1, 4096, (11008, 11008))] * 3
    step.k5.norm_rope += [(1, 4096, (4096,) * 3)] * 2
    step.k5.launches += step.k5.norm_group + step.k5.norm_rope
    before = (quant.dequant_matmul.launches,
              decode_fused.norm_matmul_group.launches,
              decode_fused.norm_qkv_rope.launches)
    step.replay()
    after = (quant.dequant_matmul.launches,
             decode_fused.norm_matmul_group.launches,
             decode_fused.norm_qkv_rope.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 3, 2)


# ---------------------------------------------------------------- the step

@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("D,heads,kv_heads", [(64, 4, 2), (128, 2, 1)])
def test_fused_decode_step_against_jax(monkeypatch, D, heads, kv_heads, B,
                                       kv_quant):
    """A decode step of the 2-layer int8 backbone at hidden 256 (head_dim
    64 and 128, GQA) with the dense fold, 1 and 2 rows, int8 and bf16
    caches, under the card's rule: the fused K5 launches (``_routes``),
    logits and cache bit-equal to the CPU path's, the logits within 2e-2
    of the JAX decode step's and the greedy ids equal."""
    cfg, jp, tparams = _model(seed=D + B, heads=heads, kv_heads=kv_heads)
    rng = np.random.default_rng(D + B + kv_quant)
    L, cache_len = 9, 16
    embeds = rng.normal(0, 1, (B, L, H)).astype(np.float32)
    route_ids = np.zeros((B, L), np.int32)
    lengths = np.array([L, 6][:B], np.int32)
    seg = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    table = cfg.routing_table()
    next_tok = rng.integers(3, cfg.vocab_size, B).astype(np.int32)

    def run(card=None):
        _, cache = _prefill(tparams, _port(cfg),
                            _t(embeds).to(torch.bfloat16), _t(route_ids),
                            _t(table), _t(seg), _t(lengths), cache_len,
                            kv_quant=kv_quant)
        if card is not None:
            del card.launches[:]
        logits, cache, _ = _decode_step(tparams, _port(cfg), cache,
                                        _t(next_tok), _t(lengths), None)
        return logits, cache
    plain, plain_cache = run()
    with monkeypatch.context() as m:
        card = _Card(m)
        got, cache = run(card)
        want = _routes(cfg.num_hidden_layers, B, False)
        assert {k: card.count(k) for k in want} == want
    assert torch.equal(got, plain)
    assert all(torch.equal(a, b) for a, b in zip(cache.tensors(),
                                                 plain_cache.tensors()))
    from modelcompose_tpu.core import generate as jgen
    _, jcache = jgen._prefill(jp, cfg, jnp.asarray(embeds, jnp.bfloat16),
                              jnp.asarray(route_ids), table,
                              jnp.asarray(seg), jnp.asarray(lengths),
                              cache_len, "auto", kv_quant)
    jl, _, _ = jgen._decode_step(jp, cfg, jcache, jnp.asarray(next_tok),
                                 jnp.asarray(lengths), None)
    jl = np.asarray(jnp.asarray(jl, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), jl, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(jl).max()))
    np.testing.assert_array_equal(got.float().numpy().argmax(-1),
                                  jl.argmax(-1))


def test_fp32_and_cpu_steps_do_not_fuse(monkeypatch):
    """Under the card's rule an fp32 step runs the unfused ops (no K5 of
    any form, no K8-K10); on the CPU nothing counts at all."""
    cfg, _, tparams = _model(seed=5)
    tokens = _t(np.array([5, 9], np.int32))
    kv = _t(np.array([2, 4], np.int32))
    counts = (decode_fused.norm_matmul_group.launches,
              decode_fused.norm_qkv_rope.launches)
    cache = llama.KVCache.zeros(_port(cfg), 2, 8, quantized=True,
                                device="cpu")
    _decode_step(tparams, _port(cfg), cache, tokens, kv, None)
    assert (decode_fused.norm_matmul_group.launches,
            decode_fused.norm_qkv_rope.launches) == counts
    with monkeypatch.context() as m:
        card = _Card(m)
        f32 = PortConfig.from_dict({**cfg.to_dict(), "dtype": "float32"})
        fparams = jax.tree.map(lambda t: t.float() if t.is_floating_point()
                               else t, tparams)
        cache = llama.KVCache.zeros(f32, 2, 8, quantized=True, device="cpu")
        _decode_step(fparams, f32, cache, tokens, kv, None)
        assert card.launches == []


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3, 8])
def test_smoke_counts_the_routes(B, routed):
    """``chip_smoke._fused_per_step``, which the smoke holds every decode
    step's launches to, counts what the card's rule launches
    (``_routes``), by the wrappers' counters; with ``in_k5`` False the
    launches of K8-K10's own (the separate arm of its A/B)."""
    import chip_smoke
    cfg, _, tparams = _model(seed=B)
    n = cfg.num_hidden_layers
    want = _routes(n, B, routed)
    got = chip_smoke._fused_per_step(tparams, B, routed)
    assert got == {"add_rms_norm": want["K8"], "rope_kv_write": want["K9"],
                   "silu_mul": want["K10"],
                   "norm_matmul_group": want["K8 in K5"],
                   "norm_qkv_rope": want["K8+K9 in K5"],
                   "silu_matmul": want["K10 in K5"]}
    assert chip_smoke._k5_per_step(tparams, B) == want["K5"]
    separate = _routes(n, 8, routed)
    assert chip_smoke._fused_per_step(tparams, B, routed, in_k5=False) == {
        "add_rms_norm": separate["K8"], "rope_kv_write": separate["K9"],
        "silu_mul": n, "norm_matmul_group": 0, "norm_qkv_rope": 0,
        "silu_matmul": 0}


# ------------------------------------------------------- K10 inside K5

# Vicuna-7B's down product (I = 11,008 -> 4,096) and its tp 2 / tp 4 row
# shards, narrowed 64x with the ratios kept (N a multiple of 16)
SILU_SHAPES = {"down": (176, 64), "tp2": (88, 64), "tp4": (48, 64)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("shape", sorted(SILU_SHAPES))
def test_silu_matmul_plain_matches_jax(shape, M, dtype):
    """The fused launch's plain version (``silu_matmul_reference``, and
    ``silu_matmul`` on CPU tensors) against the JAX layer's
    ``jax.nn.silu(gate) * up`` and its ``dequant_matmul`` (fp32 and
    x-typed results); h bit-equal to K10's plain version and the product
    to ``dequant_matmul_reference`` of it."""
    K, N = SILU_SHAPES[shape]
    rng = np.random.default_rng(M + K)
    gate = rng.normal(0, 2, (M, 1, K)).astype(np.float32)
    up = rng.normal(0, 1, (M, 1, K)).astype(np.float32)
    jw, (tw,) = _weights(rng, (N,), K=K)
    tdt, jdt = DTYPES[dtype]
    tg, tu = _t(gate).to(tdt), _t(up).to(tdt)
    jh = jax.nn.silu(jnp.asarray(gate, jdt)) * jnp.asarray(up, jdt)
    for out in (None, torch.float32):
        h, y = decode_fused.silu_matmul_reference(tg, tu, tw, out)
        assert torch.equal(h, decode_fused.silu_mul_reference(tg, tu))
        assert torch.equal(y, quant.dequant_matmul_reference(h, tw, out))
        assert y.dtype == (out or tdt) and y.shape == (M, 1, N)
        _close(h, jh, dtype)
        _close(y, jquant.dequant_matmul(
            jh, jw[0], None if out is None else jnp.float32), dtype)
        kept, y2 = decode_fused.silu_matmul(tg, tu, tw, out, keep_h=True)
        assert torch.equal(kept, h) and torch.equal(y2, y)
        assert decode_fused.silu_matmul(tg, tu, tw, out)[0] is None


def test_the_silu_fusion_rule(monkeypatch):
    """K10 goes into the down product's K5 prologue on the card where K5
    streams that product (one row; two rows of a wide one) of bf16/fp16
    with an int8 weight and no gradient; not on the CPU, at two rows of a
    product K5 takes on the tensor cores, at 3 rows, in fp32, with a float
    weight, where gate needs a gradient, or with K5 switched off
    (``quant.K5_MAX_ROWS`` 0, the A/Bs' plain arm)."""
    _, (tw,) = _weights(np.random.default_rng(0), (64,), K=176)
    g = torch.zeros(1, 1, 176, dtype=torch.bfloat16)
    assert not decode_fused.silu_fuses(g, tw)  # the CPU
    monkeypatch.setattr(_route, "on_card",
                        lambda t, kernels: kernels == "decode")
    assert decode_fused.silu_fuses(g, tw)
    assert decode_fused.silu_fuses(g.half(), tw)
    two = torch.zeros(2, 1, 176, dtype=torch.bfloat16)
    assert quant._k5_plan(2, 176, 64)[0] != quant._STREAM_TILE
    assert not decode_fused.silu_fuses(two, tw)
    wide = {"q": torch.zeros(4096, 4096, dtype=torch.int8),
            "scale": torch.ones(1, 4096)}
    assert quant._k5_plan(2, 4096, 4096)[0] == quant._STREAM_TILE
    assert decode_fused.silu_fuses(torch.zeros(2, 1, 4096,
                                               dtype=torch.bfloat16), wide)
    assert not decode_fused.silu_fuses(
        torch.zeros(3, 1, 176, dtype=torch.bfloat16), tw)
    assert not decode_fused.silu_fuses(g.float(), tw)
    assert not decode_fused.silu_fuses(g, torch.zeros(176, 64))
    assert not decode_fused.silu_fuses(g.clone().requires_grad_(True), tw)
    with torch.no_grad():
        assert decode_fused.silu_fuses(g.clone().requires_grad_(True), tw)
    monkeypatch.setattr(quant, "K5_MAX_ROWS", 0)
    assert not decode_fused.silu_fuses(g, tw)


@pytest.mark.parametrize("keep_h", [False, True])
@pytest.mark.parametrize("M", [1, 2])
def test_silu_launch_arguments_and_counts(monkeypatch, M, keep_h):
    """The fused entry gets gate, up, h's buffer (null where not kept), the
    weight, its scales, the output, N, the split scratch of the down
    product's grid (``_k5_plan``'s, which streams it), M, K, its rows, the
    type flags and the stream; one launch counts on K5 and on
    ``silu_matmul``."""
    launched = _fake_lib(monkeypatch)
    K, N = 11008, 4096
    tw = {"q": torch.zeros((K, N), dtype=torch.int8),
          "scale": torch.ones((1, N), dtype=torch.float32)}
    gate, up = (torch.zeros((M, 1, K), dtype=torch.float16)
                for _ in range(2))
    k5, wrapper = quant.dequant_matmul.launches, \
        decode_fused.silu_matmul.launches
    h, y = decode_fused._k5_silu(gate, up, tw, torch.float32, keep_h)
    (args,) = launched
    assert quant.dequant_matmul.launches == k5 + 1
    assert decode_fused.silu_matmul.launches == wrapper + 1
    assert (h is not None) == keep_h and y.shape == (M, 1, N)
    assert y.dtype == torch.float32
    tile, rows, splits, _ = quant._k5_plan(M, K, N)
    assert tile == quant._STREAM_TILE
    assert args[:6] == (gate.data_ptr(), up.data_ptr(),
                        h.data_ptr() if keep_h else None,
                        tw["q"].data_ptr(), tw["scale"].data_ptr(),
                        y.data_ptr())
    assert args[6] == N and (args[7] is None) == (splits == 1)
    assert args[9:14] == (M, K, rows, 0, 0)


def test_silu_launcher_refuses_what_the_kernel_does_not_take():
    """Raised before anything is built: 3 rows, two rows of a product K5
    takes on the tensor cores, an fp32 gate, an up of another type or
    shape, an output type other than fp32 or gate's, a weight whose rows
    are not gate's width."""
    rng = np.random.default_rng(6)
    _, (tw,) = _weights(rng, (64,), K=176)
    bf = torch.bfloat16
    g = torch.zeros(1, 1, 176, dtype=bf)

    def launch(gate=g, up=None, w=tw, out=bf):
        decode_fused._k5_silu(gate, gate if up is None else up, w, out,
                              False)
    with pytest.raises(ValueError, match="rows"):
        launch(gate=torch.zeros(3, 1, 176, dtype=bf))
    with pytest.raises(ValueError, match="tensor cores"):
        launch(gate=torch.zeros(2, 1, 176, dtype=bf))
    with pytest.raises(TypeError):
        launch(gate=g.float())
    with pytest.raises(TypeError):
        launch(up=g.half())
    with pytest.raises(ValueError):
        launch(up=torch.zeros(1, 1, 160, dtype=bf))
    with pytest.raises(TypeError):
        launch(out=torch.float16)
    _, (narrow,) = _weights(rng, (64,), K=160)
    with pytest.raises(ValueError):
        launch(w=narrow)


def test_replay_counts_the_silu_launches():
    """A replayed graph adds the fused SiLU launches its capture recorded
    (``CaptureRecord.silu_group``) to ``silu_matmul``."""
    class _Graph:
        def replay(self):
            pass
    step = decode_graph.CapturedStep("cpu")
    step.graph = _Graph()
    step.k1 = types.SimpleNamespace(launches=[], bwd_dq=[], bwd_dkv=[])
    step.k2 = types.SimpleNamespace(launches=[])
    step.k5 = quant.CaptureRecord()
    step.k5.silu_group += [(1, 11008, 4096)] * 3
    step.k5.launches += step.k5.silu_group
    before = (quant.dequant_matmul.launches,
              decode_fused.silu_matmul.launches)
    step.replay()
    after = (quant.dequant_matmul.launches,
             decode_fused.silu_matmul.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 3)
