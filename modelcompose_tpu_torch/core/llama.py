"""Llama backbone with stacked per-modality LoRA adapters (counterpart of
modelcompose_tpu/core/llama.py).

Parameters keep the JAX package's tree as dicts of tensors, with the layer
axis stacked: weights ``[N, d_in, d_out]``, adapters ``[N, A, d_in, r]`` and
``[N, A, r, d_out]``, int8 leaves ``{"q", "scale"}``.  The decoder is an
eager loop over that axis.  The KV cache is preallocated
``[n_layers, B, S_max, Hkv, D]`` (bf16, or int8 with per-vector scales) and
written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.attention import attention, decode_attention
from ..ops.decode_fused import (RopeWrite, add_rms_norm, fused_decode,
                                write_token)
from ..ops.norms import rms_norm
from ..ops.quant import dequant_matmul, is_quantized, matmul_f32, quantize_int8
from ..ops.rope import apply_rope, rope_tables
from ..ops.routed_lora import (as_table, routed_lora_matmul,
                                routed_lora_matmul_group,
                                routed_lora_norm_group, routed_lora_silu)
from ..parallel import tp

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _normal(shape, std, dtype, generator, device):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device) * std


def _init_linear(generator, device, n_layers, n_adapters, d_in, d_out, r,
                 dtype, base_std=0.02):
    """Base weight ~ N(0, base_std); LoRA A ~ kaiming-uniform(a=sqrt(5)) as
    peft initializes it (bound 1/sqrt(d_in)); B = 0.  Sampled directly in
    ``dtype``, so no fp32 copy of a stacked 7B leaf ever exists."""
    bound = float(d_in) ** -0.5
    a = torch.empty((n_layers, n_adapters, d_in, r), dtype=dtype,
                    device=device).uniform_(-bound, bound, generator=generator)
    return {"w": _normal((n_layers, d_in, d_out), base_std, dtype, generator,
                         device),
            "lora_a": a,
            "lora_b": torch.zeros((n_layers, n_adapters, r, d_out),
                                  dtype=dtype, device=device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random backbone parameters made on ``device`` from ``generator``."""
    device = torch.device(device) if device is not None else generator.device
    dtype = torch_dtype(cfg.dtype)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    N = cfg.num_hidden_layers
    A = len(cfg.adapter_names())
    r = cfg.lora_r
    kv_out = cfg.num_key_value_heads * cfg.head_dim

    def linear(d_in, d_out):
        return _init_linear(generator, device, N, A, d_in, d_out, r, dtype)

    params: Params = {
        "embed_tokens": _normal((V, H), 0.02, dtype, generator, device),
        "layers": {
            "input_layernorm": torch.ones((N, H), dtype=dtype, device=device),
            "post_attention_layernorm": torch.ones((N, H), dtype=dtype,
                                                   device=device),
            "attn": {"q": linear(H, H), "k": linear(H, kv_out),
                     "v": linear(H, kv_out), "o": linear(H, H)},
            "mlp": {"gate": linear(H, I), "up": linear(H, I),
                    "down": linear(I, H)},
        },
        "norm": torch.ones((H,), dtype=dtype, device=device),
        "lm_head": _normal((H, V), 0.02, dtype, generator, device),
    }
    params.update(init_soft_tokens(cfg, device))
    return params


def init_soft_tokens(cfg: ModelConfig, device=None) -> Params:
    """The learned per-modality prefix/suffix soft tokens, zero, in
    ``cfg.dtype``: ``{"prefix_tokens": {modal: [P, H]}, "suffix_tokens":
    ...}`` with the empty groups left out."""
    dtype = torch_dtype(cfg.dtype)
    out: Params = {}
    for kind, length in (("prefix_tokens", cfg.prefix_len),
                         ("suffix_tokens", cfg.suffix_len)):
        group = {m: torch.zeros((length(m), cfg.hidden_size), dtype=dtype,
                                device=device)
                 for m in cfg.modalities() if length(m)}
        if group:
            out[kind] = group
    return out


def reinit_lora_a(params: Params, generator: torch.Generator,
                  dtype=None) -> Params:
    """Fresh kaiming-uniform A (bound 1/sqrt(d_in)) for every ``lora_a``
    leaf; B stays as it is.

    A converted HF base has zero LoRA tensors, and training from A = 0 and
    B = 0 gives identically zero LoRA gradients forever (dL/dA is
    proportional to B, dL/dB to A); peft kaiming-initializes A when it
    creates an adapter, and this is that step.  Returns a new tree; the
    other leaves are shared."""
    out = dict(params)
    layers = dict(params["layers"])
    for grp in ("attn", "mlp"):
        group = {}
        for name, p in layers[grp].items():
            la = p["lora_a"]
            bound = float(la.shape[-2]) ** -0.5
            group[name] = {**p, "lora_a": torch.empty(
                la.shape, dtype=dtype or la.dtype, device=la.device).uniform_(
                    -bound, bound, generator=generator)}
        layers[grp] = group
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """k/v are tensors [N_layers, B, S_max, Hkv, D] or, int8-quantized,
    dicts {"q": int8 same shape, "scale": fp32 [..., Hkv, 1]} with one scale
    per cached token-head vector.  The scales factor out of both attention
    products, so decode reads the int8 bytes."""
    k: Any
    v: Any

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
              quantized: bool = False, device=None,
              kv_heads: Optional[int] = None) -> "KVCache":
        """A zero cache; ``kv_heads`` (default the config's) is the heads
        this rank holds: a tensor-parallel rank caches its own heads
        (``local_kv_heads``)."""
        dtype = dtype or torch_dtype(cfg.dtype)
        shape = (cfg.num_hidden_layers, batch, max_len,
                 kv_heads or cfg.num_key_value_heads, cfg.head_dim)
        if quantized:
            def buf():
                return {"q": torch.zeros(shape, dtype=torch.int8,
                                         device=device),
                        "scale": torch.zeros(shape[:-1] + (1,),
                                             dtype=torch.float32,
                                             device=device)}
            return KVCache(k=buf(), v=buf())
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    def tensors(self):
        """The cache's tensors: k and v, or their int8 values and scales."""
        out = []
        for part in (self.k, self.v):
            out += list(part.values()) if isinstance(part, dict) else [part]
        return out

    def splice(self, small: "KVCache", slot: int) -> "KVCache":
        """Copy a batch-1 cache into row ``slot`` of this one, in place.

        A bf16 cache going into an int8 one is quantized here; a chunked
        admission into an int8 pool arrives already quantized
        (``prefill_chunked(kv_quant=True)`` quantizes at append time), and
        so does a one-shot one (``_prefill(kv_quant=True)``): then the
        splice is a plain int8 row copy."""
        for dst, src in ((self.k, small.k), (self.v, small.v)):
            if isinstance(dst, dict):
                if not isinstance(src, dict):
                    src = quantize_kv(src)
                for part in dst:
                    dst[part][:, slot] = src[part][:, 0].to(dst[part].dtype)
            else:
                dst[:, slot] = src[:, 0].to(dst.dtype)
        return self


def local_kv_heads(params: Params, cfg: ModelConfig) -> int:
    """The KV heads of this rank's k weight (all of them unsharded)."""
    w = params["layers"]["attn"]["k"]["w"]
    return (w["q"] if is_quantized(w) else w).shape[-1] // cfg.head_dim


def quantize_kv(val: torch.Tensor):
    """[..., D] -> {'q': int8, 'scale': [..., 1]} per-vector symmetric: the
    weight scheme over the vector axis (one implementation for both)."""
    return quantize_int8(val, axis=-1)


def _cache_parts(cache, val):
    """(destination, source) pairs for a bf16 or an int8 cache."""
    if isinstance(cache, dict):
        qval = quantize_kv(val)
        return [(cache[part], qval[part]) for part in cache]
    return [(cache, val)]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _used_prefix(cache, layer_idx: int, used: int, dtype) -> torch.Tensor:
    """Positions [0, used) of one layer of the stacked cache, [B, used, Hkv,
    D]: of a bf16 cache a view (contiguous at B=1, a leading slice of one
    row), of an int8 cache only that prefix dequantized (q * scale in fp32,
    then ``dtype``)."""
    if isinstance(cache, dict):
        return (cache["q"][layer_idx, :, :used].float()
                * cache["scale"][layer_idx, :, :used]).to(dtype)
    return cache[layer_idx, :, :used].contiguous()


def _unbind_layers(tree, n: int):
    """The stacked layer tree as ``n`` per-layer trees of views, split once
    with ``unbind``: its backward stacks the per-layer gradients into one
    buffer, where indexing each layer would allocate a zero tensor the size
    of the whole stacked leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: part[i] for k, part in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _local_heads(cfg: ModelConfig, q, k) -> Tuple[int, int]:
    """(query heads, KV heads) of this rank's q and k products; raises
    where sharded weights run outside their model group's ``tp.scope``."""
    nh, nkv = q.shape[-1] // cfg.head_dim, k.shape[-1] // cfg.head_dim
    if nh * tp.model_size() != cfg.num_attention_heads:
        raise RuntimeError(
            f"{nh} query heads x a model group of {tp.model_size()} != "
            f"{cfg.num_attention_heads}: run sharded weights inside their "
            "group's tp.scope")
    return nh, nkv


def _layer(cfg: ModelConfig, lp, x, route, cos, sin, *, segment_ids,
           cache: Optional[KVCache], layer_idx: int, cache_write_pos,
           kv_lens, attn_impl: str):
    """One decoder block, in one of four modes:

    - no cache: prefill or training, attention within segment ids;
    - ``cache`` and no ``cache_write_pos``: prefill that also writes this
      layer's k/v at positions [0, L) of the stacked cache;
    - ``cache`` and an int ``cache_write_pos`` with no ``kv_lens``: one
      chunk of a chunked prefill, written at [cache_write_pos, +L), then
      attending causally with that query offset over the used prefix
      [0, cache_write_pos + L) of the cache;
    - ``cache``, ``cache_write_pos`` [B] and ``kv_lens`` [B]: decode of one
      token, written at its slot, attending over the stacked cache.

    Decode is the mode with ``kv_lens`` (the JAX dispatch rule), so a
    1-token chunk never falls into it.

    Under tensor parallelism the head counts are this rank's, read from
    its weights: q/k/v/gate/up are column-split and o/down row-split
    (``parallel="column"`` / ``"row"``, whose products sum over the model
    group before the residual add).  q/k/v and gate/up are products of
    one input each (``routed_lora_matmul_group``): at 1-2 rows on the card
    their int8 base products are one K5 launch each.

    ``attn_impl`` "reference" runs the plain versions of the kernels: of
    attention and of the int8 products (``quant.dequant_matmul``).
    """
    B, L, _ = x.shape
    hd = cfg.head_dim

    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    ap = lp["attn"]

    def lin(p, inp, parallel):
        return routed_lora_matmul(inp, p["w"], p["lora_a"], p["lora_b"],
                                  route, parallel=parallel, impl=attn_impl)

    def lins(ps, inp):  # column-split products of one input
        return routed_lora_matmul_group(inp, ps, route, parallel="column",
                                        impl=attn_impl)

    q, k, v = lins((ap["q"], ap["k"], ap["v"]), h)
    nh, nkv = _local_heads(cfg, q, k)
    q = q.view(B, L, nh, hd)
    k = k.view(B, L, nkv, hd)
    v = v.view(B, L, nkv, hd)
    q, k = apply_rope(q, k, cos, sin)

    if cache is not None and kv_lens is not None:
        # Decode: write the token's slot IN PLACE (cache[layer, b, pos[b]]),
        # which saves a copy of the multi-GB cache per step.
        write_token(cache.k, layer_idx, cache_write_pos, k)
        write_token(cache.v, layer_idx, cache_write_pos, v)
        attn_out = decode_attention(q, cache.k, cache.v, kv_lens,
                                    layer_idx=layer_idx, impl=attn_impl)
    elif cache is not None and cache_write_pos is not None:
        # A prefill chunk: write [off, off + L) in place, then attend with
        # the query offset over the used prefix only (causality would mask
        # the rest of the cache anyway).
        off = int(cache_write_pos)
        used = off + L
        for c, val in _cache_parts(cache.k, k) + _cache_parts(cache.v, v):
            c[layer_idx, :, off:used] = val.to(c.dtype)
        k_used, v_used = (_used_prefix(c, layer_idx, used, x.dtype)
                          for c in (cache.k, cache.v))
        attn_out = attention(q, k_used, v_used, causal=True, q_offset=off,
                             impl=attn_impl)
    else:
        if cache is not None:  # prefill: fill positions [0, L) of this layer
            for c, val in _cache_parts(cache.k, k) + _cache_parts(cache.v, v):
                c[layer_idx, :, :L] = val.to(c.dtype)
        attn_out = attention(q, k, v, causal=True, q_segment_ids=segment_ids,
                             kv_segment_ids=segment_ids, impl=attn_impl)

    x = x + lin(ap["o"], attn_out.reshape(B, L, nh * hd), "row")
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    mp = lp["mlp"]
    gate, up = lins((mp["gate"], mp["up"]), h)
    inter = F.silu(gate) * up
    return x + lin(mp["down"], inter, "row")


def _fused_decode_layer(cfg: ModelConfig, lp, x, res, route, cos, sin, *,
                        cache: KVCache, layer_idx: int, pos, kv_lens):
    """``_layer``'s decode mode on the card (``ops.decode_fused.
    fused_decode``), with the layer's elementwise work fused as the JAX
    program's XLA fusions fuse it: K8 (the residual add and RMSNorm), K9
    (RoPE and the cache write) and K10 (the SiLU product), and the int8
    base products rounding to x's type themselves where nothing follows
    them in fp32 (``rounded``).  At 1-2 rows each norm runs in the
    prologue of the K5 launch that reads it, RoPE with the cache write in
    the epilogue of the q/k/v launch (``routed_lora_norm_group``), and the
    SiLU product in the prologue of the down product's launch
    (``routed_lora_silu``).

    The down product's residual add is carried into the next layer's K8
    (and the final norm's): the layer takes the residual stream ``x`` and
    the previous layer's down output ``res`` (None before the first layer)
    and returns its own pair.  Each sum is ``x + res`` rounded once, as the
    unfused ``x + lin(...)`` rounds it, so the result is ``_layer``'s
    with the normed values within one unit in the last place (K8's sum of
    squares runs in another order)."""
    B = x.shape[0]
    hd = cfg.head_dim
    eps = cfg.rms_norm_eps
    ap, mp = lp["attn"], lp["mlp"]

    def lin(p, inp, parallel):
        return routed_lora_matmul(inp, p["w"], p["lora_a"], p["lora_b"],
                                  route, parallel=parallel, rounded=True)

    def normed(inp, res_in, norm, ps, rope=None):  # column-split products
        return routed_lora_norm_group(inp, res_in, norm, eps, ps, route,
                                      parallel="column", rope=rope)

    qkv = (ap["q"], ap["k"], ap["v"])
    nh, _ = _local_heads(cfg, *(_out_features(p) for p in qkv[:2]))
    x, (q,) = normed(x, res, lp["input_layernorm"], qkv,
                     RopeWrite(cos, sin, cache.k, cache.v, layer_idx, pos))
    attn_out = decode_attention(q, cache.k, cache.v, kv_lens,
                                layer_idx=layer_idx)
    x, (gate, up) = normed(x, lin(ap["o"], attn_out.reshape(B, 1, nh * hd),
                                  "row"),
                           lp["post_attention_layernorm"],
                           (mp["gate"], mp["up"]))
    return x, routed_lora_silu(gate, up, mp["down"], route, parallel="row")


def _out_features(p) -> torch.Tensor:
    """A linear's base weight (its int8 values where quantized): its last
    axis is the product's output columns."""
    w = p["w"]
    return w["q"] if is_quantized(w) else w


def forward_hidden(params: Params, cfg: ModelConfig, inputs_embeds, *,
                   route=None, segment_ids=None, positions=None,
                   cache: Optional[KVCache] = None, cache_write_pos=None,
                   kv_lens=None, attn_impl: str = "auto"
                   ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.

    inputs_embeds: [B, L, H]; route: [B, L, A] adapter weights or None;
    positions: [B, L] absolute positions (default arange).  A decode step
    passes ``cache``, ``cache_write_pos`` and ``kv_lens``; a prefill that
    fills the cache passes only ``cache``; a chunk of a chunked prefill
    passes ``cache`` and its first position as an int ``cache_write_pos``
    (its query offset), and its positions.  With ``cfg.remat`` and no cache
    (training) each layer is checkpointed: its activations are recomputed
    in the backward instead of kept.  Returns (final hidden [B, L, H], the
    cache, updated in place, or None)."""
    B, L, _ = inputs_embeds.shape
    device = inputs_embeds.device
    if positions is None:
        positions = torch.arange(L, device=device).expand(B, L)
    if segment_ids is None:
        segment_ids = torch.ones((B, L), dtype=torch.int32, device=device)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    x = inputs_embeds
    layers = _unbind_layers(params["layers"], cfg.num_hidden_layers)
    group = tp.model_group()  # a recompute in the backward runs in its scope
    if cache is not None and kv_lens is not None \
            and fused_decode(x, attn_impl):
        res = None  # the previous layer's down output, added by K8
        pos = torch.as_tensor(cache_write_pos, device=device)  # K9 reads it
        with tp.scope(group):
            for li, lp in enumerate(layers):
                x, res = _fused_decode_layer(
                    cfg, lp, x, res, route, cos, sin, cache=cache,
                    layer_idx=li, pos=pos, kv_lens=kv_lens)
            return add_rms_norm(x, res, params["norm"],
                                cfg.rms_norm_eps)[1], cache
    for li, lp in enumerate(layers):
        def run(x, lp=lp, li=li):
            with tp.scope(group):
                return _layer(cfg, lp, x, route, cos, sin,
                              segment_ids=segment_ids, cache=cache,
                              layer_idx=li, cache_write_pos=cache_write_pos,
                              kv_lens=kv_lens, attn_impl=attn_impl)
        if cfg.remat and cache is None:
            # No layer draws random numbers, so the recompute needs no
            # saved RNG state (and a captured train step may not read the
            # card's generator state).
            x = checkpoint(run, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = run(x)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps), cache


def logits_from_hidden(params: Params, hidden,
                       impl: str = "auto") -> torch.Tensor:
    """fp32 logits from an fp32 accumulation, int8 lm_head included: a
    product rounded to bf16 before the cast flips near-tied argmaxes.
    Under tensor parallelism each rank computes its vocabulary columns and
    the group gathers the fp32 logits (every rank gets all of them).
    ``impl`` picks an int8 lm_head's product: "auto" (kernel K5 or K6 on
    the card) or "reference" (its plain version), as ``attn_impl`` does."""
    hidden = tp.copy_to_model(hidden)
    if is_quantized(params["lm_head"]):
        logits = dequant_matmul(hidden, params["lm_head"],
                                out_dtype=torch.float32, impl=impl)
    else:
        logits = matmul_f32(hidden, params["lm_head"])
    return tp.gather_vocab(logits)


def forward_hidden_routed(params: Params, cfg: ModelConfig, inputs_embeds, *,
                          route_ids=None, routing_table=None,
                          segment_ids=None, positions=None,
                          cache: Optional[KVCache] = None,
                          cache_write_pos=None, kv_lens=None,
                          attn_impl: str = "auto"):
    """embeds -> last hidden state (no lm_head), with route-class expansion.

    route_ids: [B, L] route classes; routing_table: [n_classes, n_adapters]
    or None (no adapter branch).  When routing is inactive for the config,
    or route_ids is None, the default row applies to every token."""
    route = None
    if routing_table is not None:
        table = as_table(routing_table, inputs_embeds.device)
        B, L, _ = inputs_embeds.shape
        if route_ids is None or not cfg.routing_active():
            route = table[0].expand(B, L, table.shape[1])
        else:
            ids = torch.as_tensor(route_ids, device=table.device)
            route = table[ids.long()]
    return forward_hidden(
        params, cfg, inputs_embeds, route=route, segment_ids=segment_ids,
        positions=positions, cache=cache, cache_write_pos=cache_write_pos,
        kv_lens=kv_lens, attn_impl=attn_impl)


def forward(params: Params, cfg: ModelConfig, inputs_embeds, *,
            route_ids=None, routing_table=None, segment_ids=None,
            positions=None, cache: Optional[KVCache] = None,
            cache_write_pos=None, kv_lens=None, attn_impl: str = "auto"):
    """Full causal-LM forward: embeds -> hidden -> fp32 logits."""
    hidden, cache = forward_hidden_routed(
        params, cfg, inputs_embeds, route_ids=route_ids,
        routing_table=routing_table, segment_ids=segment_ids,
        positions=positions, cache=cache, cache_write_pos=cache_write_pos,
        kv_lens=kv_lens, attn_impl=attn_impl)
    return logits_from_hidden(params, hidden, attn_impl), cache
