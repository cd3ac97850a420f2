"""The decode layer's fused passes (``ops/decode_fused``: K8 add + RMSNorm,
K9 RoPE + KV-cache write, K10 SiLU product; ``csrc/decode_fused.cu``) on
the CPU: each plain version against the composition of the JAX package's
ops and bit-equal to the port's own, the wrappers' routing and checks, and
the port's decode step with the card's launch rule emulated.

The kernels have no CPU build (their card tests are in
tests/test_torch_kernels_cuda.py).  The emulation (``_Card``) runs the real
dispatch of the decode step on CPU tensors: ``ops/_route.on_card`` says
yes for the products and the decode kernels, and the launchers
``quant._k5`` and ``decode_fused._k8`` / ``_k9`` / ``_k10`` are replaced
by the plain
versions of what they get, each call counted as the launch the card would
make (K5's with the output type it was asked for).  So the launch counts,
the residual carried into the next layer's K8, K5's bf16 output and the
results of the fused route are checked without a card.

Inputs are seeded numpy arrays handed to both packages.  Tolerances,
relative to max |JAX|: 1e-5 in fp32 (one rounding of an fp32 sum taken in
another order), 2e-2 in bf16 and fp16 (a rounding in that type); int8
cache values bit-exact wherever the two scales agree; logits as tests/test_torch_llama.py holds
them (2e-2 bf16).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.core import llama as jllama
from modelcompose_tpu.ops import norms as jnorms
from modelcompose_tpu.ops import quant as jquant
from modelcompose_tpu.ops import rope as jrope

from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.convert import params_from_jax
from modelcompose_tpu_torch.core import decode_graph, llama
from modelcompose_tpu_torch.core.decode_graph import _decode_step
from modelcompose_tpu_torch.core.prefill_graph import _prefill
from modelcompose_tpu_torch.ops import _route, decode_fused, quant
from modelcompose_tpu_torch.ops.norms import rms_norm
from modelcompose_tpu_torch.ops.rope import apply_rope, rope_tables

jgen = importlib.import_module("modelcompose_tpu.core.generate")

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
LOGIT_TOL = 2e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, dtype):
    want = _np(want)
    err = np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL[dtype], err


# ---------------------------------------------------------------- K8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_add_rms_norm_plain_matches_jax(dtype, residual, rows):
    """(x + y, rms_norm(x + y)) against the JAX ``rms_norm`` of the JAX
    sum, and bit-equal to the port's ``rms_norm`` of the port's sum."""
    rng = np.random.default_rng(rows + 10 * residual)
    H = 96
    x = rng.normal(0, 2, (rows, 1, H)).astype(np.float32)
    y = rng.normal(0, 2, (rows, 1, H)).astype(np.float32) if residual \
        else None
    w = rng.normal(1, 0.1, (H,)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    tx, tw = _t(x).to(tdt), _t(w).to(tdt)
    ty = None if y is None else _t(y).to(tdt)
    s, out = decode_fused.add_rms_norm_reference(tx, ty, tw, 1e-5)
    jx = jnp.asarray(x, jdt)
    js = jx if y is None else jx + jnp.asarray(y, jdt)
    _close(s, js, dtype)
    _close(out, jnorms.rms_norm(js, jnp.asarray(w, jdt), 1e-5), dtype)
    want_s = tx if ty is None else tx + ty
    assert torch.equal(s, want_s)
    assert torch.equal(out, rms_norm(want_s, tw, 1e-5))


# ---------------------------------------------------------------- K9

def _rope_inputs(rng, B, H, Hkv, D, S):
    q = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, 1, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, 1, Hkv, D)).astype(np.float32)
    pos = rng.permutation(S)[:B].astype(np.int32)  # a position a row
    return q, k, v, pos


def _jax_write(cache, val, layer, pos, B):
    """The JAX decode layer's write: ``quantize_kv`` into an int8 cache,
    then ``c.at[layer, arange(B), pos].set(val[:, 0])`` (its
    ``scatter_token``)."""
    def scatter(c, x):
        return c.at[layer, jnp.arange(B), pos].set(x[:, 0].astype(c.dtype))
    if isinstance(cache, dict):
        qval = jllama.quantize_kv(val)
        return {part: scatter(cache[part], qval[part]) for part in cache}
    return scatter(cache, val)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,Hkv", [(1, 4, 4), (3, 4, 2), (8, 8, 2)])
def test_rope_kv_write_plain_matches_jax(dtype, int8, B, H, Hkv):
    """``apply_rope`` on q and k, k and v written at a different position a
    row of layer 1 of a 3-layer cache, against the JAX ``apply_rope``,
    ``quantize_kv`` and the JAX layer's token scatter: q and a bf16
    cache's entries within the tolerance, an int8 cache's values equal
    wherever the two scales agree to the bit and within one step where
    they do not, its scales within 1e-5; every other slot untouched."""
    rng = np.random.default_rng(B * H + int8)
    D, S, NL, layer = 16, 12, 3, 1
    q, k, v, pos = _rope_inputs(rng, B, H, Hkv, D, S)
    tdt, jdt = DTYPES[dtype]
    cos, sin = rope_tables(_t(pos)[:, None], D)
    tcache = llama.KVCache.zeros(
        PortConfig(num_hidden_layers=NL, num_attention_heads=H,
                   num_key_value_heads=Hkv, hidden_size=H * D, dtype=dtype),
        B, S, quantized=int8, device="cpu")
    got_q = decode_fused.rope_kv_write_reference(
        _t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), cos, sin, tcache.k,
        tcache.v, layer, _t(pos))
    jcos, jsin = jrope.rope_tables(jnp.asarray(pos)[:, None], D)
    jq, jk = jrope.apply_rope(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                              jcos, jsin)
    _close(got_q, jq, dtype)
    assert got_q.dtype == tdt
    shape = (NL, B, S, Hkv, D)
    for got, val in ((tcache.k, jk), (tcache.v, jnp.asarray(v, jdt))):
        if int8:
            zero = {"q": jnp.zeros(shape, jnp.int8),
                    "scale": jnp.zeros(shape[:-1] + (1,), jnp.float32)}
        else:
            zero = jnp.zeros(shape, jdt)
        want = _jax_write(zero, val, layer, jnp.asarray(pos), B)
        if not int8:
            _close(got, want, dtype)
            continue
        gs, ws = got["scale"].numpy(), np.asarray(want["scale"])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
        gq = got["q"].numpy().astype(np.int32)
        wq = np.asarray(want["q"]).astype(np.int32)
        same = np.broadcast_to(gs == ws, gq.shape)
        assert same.any()
        np.testing.assert_array_equal(gq[same], wq[same])
        assert np.abs(gq - wq).max() <= 1
        # the slots written and nothing else
        written = np.zeros(shape[:-1], bool)
        written[layer, np.arange(B), pos] = True
        assert not gq[~written].any() and not gs[~written].any()


@pytest.mark.parametrize("int8", [False, True])
def test_rope_kv_write_plain_is_the_ports_ops(int8):
    """K9's plain version is bit-equal to the unfused decode layer's
    ``apply_rope`` and its writes (``llama._cache_parts``)."""
    rng = np.random.default_rng(int8)
    B, H, Hkv, D, S, layer = 3, 4, 2, 16, 10, 1
    q, k, v, pos = _rope_inputs(rng, B, H, Hkv, D, S)
    cfg = PortConfig(hidden_size=H * D, num_attention_heads=H,
                     num_key_value_heads=Hkv, num_hidden_layers=2,
                     dtype="bfloat16")
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    cos, sin = rope_tables(_t(pos)[:, None], D)
    a, b = (llama.KVCache.zeros(cfg, B, S, quantized=int8, device="cpu")
            for _ in range(2))
    got = decode_fused.rope_kv_write_reference(tq, tk, tv, cos, sin, a.k,
                                               a.v, layer, _t(pos))
    want, rk = apply_rope(tq, tk, cos, sin)
    rows = torch.arange(B)
    for c, val in llama._cache_parts(b.k, rk) + llama._cache_parts(b.v, tv):
        c[layer, rows, _t(pos)] = val[:, 0].to(c.dtype)
    assert torch.equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))


# ---------------------------------------------------------------- K10

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8])
def test_silu_mul_plain_matches_jax(dtype, rows):
    """``silu(gate) * up`` against ``jax.nn.silu(g) * u``, and bit-equal to
    the port's ``F.silu(gate) * up``."""
    rng = np.random.default_rng(rows)
    g = rng.normal(0, 3, (rows, 1, 200)).astype(np.float32)
    u = rng.normal(0, 1, (rows, 1, 200)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    got = decode_fused.silu_mul_reference(_t(g).to(tdt), _t(u).to(tdt))
    _close(got, jax.nn.silu(jnp.asarray(g, jdt)) * jnp.asarray(u, jdt),
           dtype)
    assert torch.equal(got, F.silu(_t(g).to(tdt)) * _t(u).to(tdt))


# ---------------------------------------------------------------- wrappers

def _counts():
    return (decode_fused.add_rms_norm.launches,
            decode_fused.rope_kv_write.launches,
            decode_fused.silu_mul.launches)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors each wrapper is its plain version and counts no
    launch."""
    rng = np.random.default_rng(0)
    x, y = (_t(rng.normal(size=(2, 1, 64)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    w = torch.ones(64, dtype=torch.bfloat16)
    before = _counts()
    s, out = decode_fused.add_rms_norm(x, y, w, 1e-6)
    assert torch.equal(s, x + y) and torch.equal(out, rms_norm(x + y, w,
                                                               1e-6))
    s, out = decode_fused.add_rms_norm(x, None, w, 1e-6)
    assert s is x and torch.equal(out, rms_norm(x, w, 1e-6))
    assert torch.equal(decode_fused.silu_mul(x, y), F.silu(x) * y)
    q, k, v, pos = _rope_inputs(rng, 2, 4, 2, 16, 8)
    cfg = PortConfig(hidden_size=64, num_attention_heads=4,
                     num_key_value_heads=2, num_hidden_layers=1,
                     dtype="bfloat16")
    cache = llama.KVCache.zeros(cfg, 2, 8, quantized=True, device="cpu")
    cos, sin = rope_tables(_t(pos)[:, None], 16)
    args = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = decode_fused.rope_kv_write(*args, cos, sin, cache.k, cache.v, 0,
                                     _t(pos))
    assert torch.equal(got, apply_rope(args[0], args[1], cos, sin)[0])
    assert _counts() == before


def test_fused_decode_rule(monkeypatch):
    """The decode layer fuses on the card with bf16 or fp16 activations and
    ``attn_impl`` "auto"; "reference", the CPU and fp32 run the unfused
    ops."""
    x = torch.zeros(1, 1, 8, dtype=torch.bfloat16)
    assert not decode_fused.fused_decode(x, "auto")
    monkeypatch.setattr(_route, "on_card",
                        lambda t, kernels: kernels == "decode")
    assert decode_fused.fused_decode(x, "auto")
    assert decode_fused.fused_decode(x.half(), "auto")
    assert not decode_fused.fused_decode(x, "reference")
    assert not decode_fused.fused_decode(x.float(), "auto")


def test_launchers_refuse_what_the_kernels_do_not_take():
    """Each launcher's checks raise before anything is built: fp32
    activations, mixed types, a non-contiguous input, a head dim other than
    64 or 128, a norm width past 8,192, a cache of another type."""
    bf = torch.bfloat16
    x = torch.zeros(2, 1, 64, dtype=bf)
    w = torch.ones(64, dtype=bf)
    with pytest.raises(TypeError):
        decode_fused._k8(x.float(), None, w.float(), 1e-5)
    with pytest.raises(TypeError):
        decode_fused._k8(x, None, w.float(), 1e-5)
    with pytest.raises(ValueError):
        decode_fused._k8(torch.zeros(2, 128, dtype=bf)[:, ::2], None, w,
                         1e-5)
    with pytest.raises(ValueError):
        decode_fused._k8(torch.zeros(1, 8200, dtype=bf), None,
                         torch.ones(8200, dtype=bf), 1e-5)
    with pytest.raises(TypeError):
        decode_fused._k10(x.float(), x.float())
    with pytest.raises(ValueError):
        decode_fused._k10(torch.zeros(2, 128, dtype=bf)[:, ::2],
                          torch.zeros(2, 64, dtype=bf))

    def rope(D=128, dtype=bf, int8=True, strided=False):
        B, H, Hkv, S = 2, 4, 2, 8
        cfg = PortConfig(hidden_size=H * D, num_attention_heads=H,
                         num_key_value_heads=Hkv, num_hidden_layers=1,
                         dtype="bfloat16")
        cache = llama.KVCache.zeros(cfg, B, S, quantized=int8, device="cpu")
        q = torch.zeros(B, 1, H, 2 * D if strided else D, dtype=dtype)
        q = q[..., ::2] if strided else q
        kv = torch.zeros(B, 1, Hkv, D, dtype=dtype)
        cos = torch.zeros(B, 1, D)
        decode_fused._k9(q, kv, kv.clone(), cos, cos.clone(), cache.k,
                         cache.v, 0, torch.zeros(B, dtype=torch.int32))
    with pytest.raises(TypeError):
        rope(dtype=torch.float32)
    with pytest.raises(ValueError):
        rope(D=32)
    with pytest.raises(ValueError):
        rope(strided=True)
    with pytest.raises(ValueError):  # a bf16 cache for fp16 activations
        rope(dtype=torch.float16, int8=False)


def test_replay_counts_the_fused_launches():
    """A replayed graph adds the K8-K10 launches its capture recorded
    (``quant.CaptureRecord.norm`` / ``rope`` / ``silu``) to the
    wrappers' counters."""
    class _Graph:
        def replay(self):
            pass
    step = decode_graph.CapturedStep("cpu")
    step.graph = _Graph()
    step.k1 = type("R", (), {"launches": [], "bwd_dq": [], "bwd_dkv": []})()
    step.k2 = type("R", (), {"launches": []})()
    step.k5 = quant.CaptureRecord()
    step.k5.norm += [(1, 64)] * 5
    step.k5.rope += [(1, 4, 4, 16, 8, True)] * 2
    step.k5.silu += [(1, 1, 128)] * 2
    before = _counts()
    step.replay()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (5, 2, 2)


# ---------------------------------------------------------------- the step

class _Card:
    """The card's launch rule on CPU tensors: ``_route.on_card`` says yes
    for the products and the decode kernels, K5's launcher computes the plain
    products in the output type it was asked for (recorded), K6's (a
    prefill's) the plain product, K8-K10's launchers their plain versions,
    and the fused K5 launchers (K8 in the prologue, K9 in the epilogue with
    ``rope``; K10 in the prologue) the fused launches' plain versions; each
    call counted as one launch, a fused one as "K5" and as "K8 in K5",
    "K8+K9 in K5" or "K10 in K5"."""

    def __init__(self, monkeypatch):
        self.launches = []
        self.k5_out = []
        monkeypatch.setattr(_route, "on_card", lambda x, kernels: kernels
                            in ("products", "decode"))
        monkeypatch.setattr(quant, "_k5", self.k5)
        monkeypatch.setattr(quant, "_k6", self.k6)
        monkeypatch.setattr(decode_fused, "_k5_norm", self.k5_norm)
        monkeypatch.setattr(decode_fused, "_k5_silu", self.k5_silu)
        for name, fn in (("_k8", decode_fused.add_rms_norm_reference),
                         ("_k9", decode_fused.rope_kv_write_reference),
                         ("_k10", decode_fused.silu_mul_reference)):
            monkeypatch.setattr(decode_fused, name,
                                self.counted(name[1:].upper(), fn))

    def k5(self, x2, weights, out_dtype):
        assert x2.shape[0] <= quant.K5_MAX_ROWS
        self.launches.append("K5")
        self.k5_out.append(out_dtype)
        return [quant.dequant_matmul_reference(x2, wq, out_dtype)
                for wq in weights]

    def k5_norm(self, x, y, weight, eps, weights, out_dtype, rope, keep_h,
                wrapper):
        assert x.numel() // x.shape[-1] <= quant.K5_GROUP_ROWS
        self.launches += ["K5", "K8 in K5" if rope is None
                          else "K8+K9 in K5"]
        self.k5_out.append(out_dtype or x.dtype)
        return decode_fused.norm_matmul_group_reference(
            x, y, weight, eps, weights, out_dtype, rope, keep_h)

    def k5_silu(self, gate, up, wq, out_dtype, keep_h):
        assert quant._rows(gate) <= quant.K5_GROUP_ROWS
        self.launches += ["K5", "K10 in K5"]
        self.k5_out.append(out_dtype or gate.dtype)
        h, y = decode_fused.silu_matmul_reference(gate, up, wq, out_dtype)
        return (h if keep_h else None), y

    def k6(self, x2, weights, out_dtype):  # the prefill's products
        self.launches.append("K6")
        return [quant.dequant_matmul_reference(x2, weights[0], out_dtype)]

    def counted(self, name, fn):
        def run(*args):
            self.launches.append(name)
            return fn(*args)
        return run

    def count(self, name):
        return self.launches.count(name)


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _model(seed=0, hidden=256, heads=4, kv_heads=2, dtype="bfloat16"):
    """A 2-layer int8 backbone of ``hidden`` (head_dim hidden / heads: 64
    by default, a width K9 takes) with GQA and nonzero LoRA B."""
    cfg = tiny_test_config(mm_vision_encoder="x", mm_hidden_size=16,
                           dtype=dtype, hidden_size=hidden,
                           intermediate_size=2 * hidden,
                           num_attention_heads=heads,
                           num_key_value_heads=kv_heads)
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(rng.normal(0, 0.05, p["lora_b"].shape),
                                      p["lora_b"].dtype)
    jp = jquant.quantize_backbone(params)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _routes(n, B, routed):
    """The launches of one decode step of an ``n``-layer int8 backbone of
    ``_model``'s width at B rows under the card's rule, by kind: at 1-2
    rows each norm in the prologue of the K5 launch that reads it and, with
    no adapter branch (the dense fold), RoPE and the cache write in the
    q/k/v launch's epilogue, so K8 runs alone only for the final norm and
    K9 only where an adapter branch follows; the SiLU product in the
    prologue of the down product's launch at one row, while at two rows K5
    takes the narrow down product (512 x 256) on the tensor cores and K10
    stays a launch of its own; at 3-8 rows every K8, K9, K10 and K5 launch
    of its own.  K5 counts the fused launches too."""
    if B > quant.K5_GROUP_ROWS:
        return {"K8": 2 * n + 1, "K9": n, "K10": n, "K5": 7 * n + 1,
                "K8 in K5": 0, "K8+K9 in K5": 0, "K10 in K5": 0}
    silu = B == 1
    return {"K8": 1, "K9": n if routed else 0, "K10": 0 if silu else n,
            "K5": 4 * n + 1, "K8 in K5": n if not routed else 2 * n,
            "K8+K9 in K5": 0 if routed else n, "K10 in K5": n if silu else 0}


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("routed", [False, True])
def test_decode_step_with_the_card_rule(monkeypatch, kv_quant, B, routed):
    """A decode step after a prefill whose rows end at different positions,
    with the card's rule emulated (``_routes``): at 1-2 rows the fused K5
    launches (K8 in the prologue; K9 in the q/k/v launch's epilogue with
    no adapter branch; K10 in the down product's prologue), the final norm
    a K8 of its own and, with a routed table, K9 too; at 3 and 8 rows K8 2
    a layer + the final norm, K9 and K10 once a layer, K5 7 a layer + 1.  K5 writes bf16 for every layer
    product where no adapter branch follows (the dense fold: no decode
    table) and fp32 where one does (a routed table), the lm_head fp32;
    logits and cache bit-equal to the CPU path's (the unfused ops), and
    the logits within the bf16 tolerance of the JAX decode step's."""
    cfg, jp, tparams = _model(seed=B)
    rng = np.random.default_rng(B + 10 * kv_quant)
    L, cache_len = 10, 16
    embeds = rng.normal(0, 1, (B, L, cfg.hidden_size)).astype(np.float32)
    route_ids = rng.choice((0, 2), size=(B, L)).astype(np.int32)
    lengths = rng.integers(3, L + 1, B).astype(np.int32)
    lengths[0] = L
    seg = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    table = cfg.routing_table()
    step_table = table if routed else None
    next_tok = rng.integers(3, cfg.vocab_size, B).astype(np.int32)
    n = cfg.num_hidden_layers

    def run(card=None):
        _, cache = _prefill(tparams, _port(cfg),
                            _t(embeds).to(torch.bfloat16), _t(route_ids),
                            _t(table), _t(seg), _t(lengths), cache_len,
                            kv_quant=kv_quant)
        if card is not None:
            del card.launches[:]
        logits, cache, _ = _decode_step(
            tparams, _port(cfg), cache, _t(next_tok), _t(lengths),
            None if step_table is None else _t(step_table))
        return logits, cache
    plain, plain_cache = run()
    with monkeypatch.context() as m:
        card = _Card(m)
        got, cache = run(card)
        want = _routes(n, B, routed)
        assert {k: card.count(k) for k in want} == want
        layer_out = card.k5_out[-want["K5"]:-1]
        assert set(layer_out) == {torch.float32 if routed
                                  else torch.bfloat16}
        assert card.k5_out[-1] == torch.float32
    assert torch.equal(got, plain)
    assert all(torch.equal(a, b) for a, b in zip(cache.tensors(),
                                                 plain_cache.tensors()))
    _, jcache = jgen._prefill(jp, cfg, jnp.asarray(embeds, jnp.bfloat16),
                              jnp.asarray(route_ids), table,
                              jnp.asarray(seg), jnp.asarray(lengths),
                              cache_len, "auto", kv_quant)
    want, _, _ = jgen._decode_step(jp, cfg, jcache, jnp.asarray(next_tok),
                                   jnp.asarray(lengths), step_table)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(want).max()))


def test_reference_and_fp32_steps_stay_unfused(monkeypatch):
    """Under the card's rule, ``attn_impl="reference"`` and fp32
    activations launch none of K8-K10 (and the reference path no K5)."""
    cfg, _, tparams = _model(seed=1)
    B, S = 2, 8
    tokens = _t(np.array([5, 9], np.int32))
    kv = _t(np.array([2, 4], np.int32))
    with monkeypatch.context() as m:
        card = _Card(m)
        cache = llama.KVCache.zeros(_port(cfg), B, S, quantized=True,
                                    device="cpu")
        _decode_step(tparams, _port(cfg), cache, tokens, kv, None,
                     attn_impl="reference")
        assert card.launches == []
        f32 = PortConfig.from_dict({**cfg.to_dict(), "dtype": "float32"})
        fparams = jax.tree.map(lambda t: t.float() if t.is_floating_point()
                               else t, tparams)
        cache = llama.KVCache.zeros(f32, B, S, quantized=True, device="cpu")
        _decode_step(fparams, f32, cache, tokens, kv, None)
        assert card.launches == []
