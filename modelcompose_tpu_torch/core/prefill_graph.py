"""The prefill as captured CUDA graphs: the one-shot prefill (the port's
counterpart of the JAX package's jitted ``_prefill``) and the chunked
admission's step (of ``_prefill_chunk_step``, static per ``(offset,
chunk)``), each one replay a call, with K1 inside.

A 7B prefill is a few thousand launches (per layer: the int8 base
products (K6, one a weight), the LoRA products, norms, RoPE, the cache
write and K1); a short prompt's device work is smaller than the host's
time to launch them one by one.  Captured once per shape (the capture rules and
the launch counting are ``core/decode_graph.CapturedStep``'s) and
replayed, the card sets the pace.

``PrefillGraph`` owns its static inputs ``inputs_embeds [B, L, H]``,
``route_ids [B, L]`` (when routing is active), ``segment_ids [B, L]`` and
``lengths [B]`` and its static output, the last valid position's fp32
``logits [B, V]``.  The cache it writes is the cache of the decode graph
that decodes the request (the prefill graph is one of that
``DecodeGraph``'s ``prefills``, one per prompt bucket, and goes with it),
or, for a prefill no decode graph follows (one new token, beam search
before its beams are tiled, a slot admission), a cache of
``PrefillGraphs`` shared by its graphs of one cache shape.  The tail
zeroing of a reused cache is captured with the rest.  ``assemble_embeds``
stays outside: its gather indices come from the host's pack plan, and the
graph's input is the assembled embeddings.

``ChunkStepGraph`` is one chunk of a chunked admission: static
``inputs_embeds [1, size, H]`` (and ``route_ids``) in, the chunk's final
hidden states out; the query offset is baked in, as the JAX ``offset`` is
static.  A ``ChunkedAdmission`` holds one persistent admission cache per
``(cache_len, kv_quant)`` (in place of a fresh zero cache a call) and its
chunk steps, one per ``(offset, size)``: 7 of 512 and a ragged tail for a
3,328-position prompt.  The logits of the prompt's last position come from
the chunk's hidden states outside the graph, as in the JAX loop; the
caller's ``tick_cb`` runs between replays.

When to capture: a shape's first call runs eagerly (and builds every
kernel), its second captures (a warm-up on a side stream whose result is
the call's, then the capture), later calls replay; a bucket seen once
pays no capture.  On an H100 a capturing call costs 1.2-2.6 eager calls
(the 7B prefill of 2 x 1,024 positions 0.306-0.444 s against 0.240-0.322 s
eager and 0.129-0.132 s replayed, MCUB-4's 3,328 0.355-0.417 s against
0.231-0.237 s and 0.219-0.221 s, 698 positions 0.215-0.295 s against
0.090-0.130 s and 0.076 s; chip_smoke.py's
``ttft_s_eager_capture_replay``), so capturing at the first call would be
slower than eager.

A graph's transient memory (the fp32 products, the MLP intermediates)
stays reserved in a private pool for the graph's life.  All the prefill
graphs of one ``PrefillGraphs`` (a model's: the one-shot graphs, those in
its decode graphs, the chunk steps) share one pool and one capture stream
(``core/decode_graph.SharedPool``; sound because they replay one after
another, one caller at a time), so a model holds the transients of its
largest prefill once, not once a bucket.

Under a tensor-parallel model group (``--tp``) the graphs capture the
step's collectives with it (core/decode_graph's rules): each graph and
each shared cache belongs to the group it was made under, and is keyed
by it.  Under grad a prefill runs eagerly: ``prefill`` and
``core.generate.prefill_chunked`` then take the functions' own path, as
they do with ``graphs=None`` (which the tests and the smoke's A/B use).
On a CPU tensor the graphs run the same step eagerly into the same
buffers, collectives included.  A capture that fails raises; nothing
falls back to the eager path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..ops.routed_lora import as_table
from ..parallel import tp
from .decode_graph import (CapturedStep, GraphLRU, SharedPool, graph_key,
                           group_key)
from .llama import (KVCache, forward_hidden_routed, local_kv_heads,
                    logits_from_hidden)

PREFILL_GRAPHS = 8  # one-shot graphs on the shared caches a model keeps
ADMISSIONS = 2  # chunked admissions (cache + chunk steps) a model keeps


def _prefill(params, cfg: ModelConfig, inputs_embeds, route_ids,
             routing_table, segment_ids, lengths, max_len: int,
             attn_impl: str = "auto", kv_quant: bool = False, cache=None):
    """Prompt forward that fills a fresh cache, or ``cache`` (an existing
    one of B rows and ``max_len`` positions, a decode graph's): its
    positions [0, L) are written and [L, max_len) zeroed, so it holds what
    a fresh cache would.  Returns (last valid position's fp32 logits [B,
    V], cache)."""
    B, L = inputs_embeds.shape[:2]
    if cache is None:
        cache = KVCache.zeros(cfg, B, max_len, quantized=kv_quant,
                              device=inputs_embeds.device,
                              kv_heads=local_kv_heads(params, cfg))
    else:
        for t in cache.tensors():
            if t.shape[1:3] != (B, max_len):
                raise ValueError(f"cache {tuple(t.shape)} is not {B} rows "
                                 f"of {max_len} positions")
            t[:, :, L:].zero_()
    hidden, cache = forward_hidden_routed(
        params, cfg, inputs_embeds, route_ids=route_ids,
        routing_table=routing_table, segment_ids=segment_ids, cache=cache,
        attn_impl=attn_impl)
    # Only the last valid position feeds decoding: gather it BEFORE the
    # lm_head so prefill skips the [B, L, V] logits product.
    rows = torch.arange(B, device=hidden.device)
    last_h = hidden[rows, lengths.long() - 1][:, None]
    return logits_from_hidden(params, last_h, attn_impl)[:, 0], cache


def _prefill_chunk_step(params, cfg: ModelConfig, cache, embeds_chunk,
                        route_chunk, routing_table, offset: int,
                        attn_impl: str = "auto") -> torch.Tensor:
    """One chunk of a chunked prefill: write k/v at [offset, offset +
    size) of ``cache`` in place and attend causally with query offset
    ``offset``.  Returns the chunk's final hidden states [B, size, H]."""
    size = embeds_chunk.shape[1]
    positions = (offset + torch.arange(size, device=embeds_chunk.device))
    hidden, _ = forward_hidden_routed(
        params, cfg, embeds_chunk, route_ids=route_chunk,
        routing_table=routing_table, positions=positions[None],
        cache=cache, cache_write_pos=offset, attn_impl=attn_impl)
    return hidden


def graphable() -> bool:
    """Whether a prefill may run through a graph here: no grad (a graph
    keeps no autograd record), under a model group or none."""
    return not torch.is_grad_enabled()


def _table(routing_table, device):
    return None if routing_table is None else as_table(routing_table,
                                                       device)


class PrefillGraph(CapturedStep):
    """``_prefill`` of a prompt batch of the shape of ``inputs_embeds`` (its
    rows, its bucket) into ``cache`` (see the module docstring); captured
    at its second call on the card.  Its buffers are made in the caller's grad
    mode and it is called in that mode and in the model group it was made
    under; one thread calls it at a time."""

    capture_at = 2
    in_scope = True
    captures = 0
    replays = 0

    def __init__(self, params, cfg: ModelConfig, cache: KVCache,
                 inputs_embeds, *, routed: bool, routing_table=None,
                 attn_impl: str = "auto", shared: SharedPool = None):
        super().__init__(params["embed_tokens"].device, shared)
        self.params, self.cfg, self.cache = params, cfg, cache
        self.table = _table(routing_table, self.device)
        self.attn_impl = attn_impl
        B, L = inputs_embeds.shape[:2]
        self.cache_len = cache.tensors()[0].shape[2]
        self.embeds = torch.zeros(inputs_embeds.shape,
                                  dtype=inputs_embeds.dtype,
                                  device=self.device)
        self.route_ids = torch.zeros((B, L), dtype=torch.int64,
                                     device=self.device) if routed else None
        self.segment_ids = torch.zeros((B, L), dtype=torch.int32,
                                       device=self.device)
        self.lengths = torch.ones(B, dtype=torch.int32, device=self.device)

    @property
    def logits(self):
        """The static logits [B, V] fp32 (None before the first call)."""
        return self.out

    def __call__(self, inputs_embeds, route_ids, segment_ids,
                 lengths) -> torch.Tensor:
        """The last valid positions' fp32 logits [B, V] of this prompt
        batch, its k/v written into ``cache``: the static buffer,
        rewritten by the next call."""
        _load(self.embeds, inputs_embeds)
        if self.route_ids is not None:
            _load(self.route_ids, route_ids)
        _load(self.segment_ids, segment_ids)
        _load(self.lengths, lengths)
        return self.run()

    def _step(self) -> torch.Tensor:
        return _prefill(self.params, self.cfg, self.embeds, self.route_ids,
                        self.table, self.segment_ids, self.lengths,
                        self.cache_len, self.attn_impl, cache=self.cache)[0]


class ChunkStepGraph(CapturedStep):
    """``_prefill_chunk_step`` of one ``(offset, size)`` chunk into the
    admission's cache: static embeddings (and route ids) in, the chunk's
    hidden states [1, size, H] out.  Captured at its second call, into
    the admission's shared pool."""

    capture_at = 2
    in_scope = True
    captures = 0
    replays = 0

    def __init__(self, admission: "ChunkedAdmission", offset: int,
                 size: int):
        super().__init__(admission.device, admission.shared)
        self.admission, self.offset = admission, offset
        self.embeds = torch.zeros((1, size, admission.cfg.hidden_size),
                                  dtype=admission.dtype, device=self.device)
        self.route_ids = torch.zeros(
            (1, size), dtype=torch.int64,
            device=self.device) if admission.routed else None

    def __call__(self, embeds_chunk, route_chunk) -> torch.Tensor:
        _load(self.embeds, embeds_chunk)
        if self.route_ids is not None:
            _load(self.route_ids, route_chunk)
        return self.run()

    def _step(self) -> torch.Tensor:
        a = self.admission
        return _prefill_chunk_step(a.params, a.cfg, a.cache, self.embeds,
                                   self.route_ids, a.table, self.offset,
                                   a.attn_impl)


class ChunkedAdmission:
    """One persistent admission cache of ``(cache_len, kv_quant)`` and the
    chunk-step graphs that write it, one per ``(offset, size)``, captured
    into ``shared``."""

    def __init__(self, params, cfg: ModelConfig, cache: KVCache, *,
                 dtype, routed: bool, routing_table=None,
                 attn_impl: str = "auto", shared: SharedPool = None):
        self.params, self.cfg, self.cache = params, cfg, cache
        self.device = params["embed_tokens"].device
        self.dtype, self.routed = dtype, routed
        self.table = _table(routing_table, self.device)
        self.attn_impl, self.shared = attn_impl, shared
        self.steps = {}  # (offset, size) -> ChunkStepGraph

    def step(self, offset: int, size: int) -> ChunkStepGraph:
        key = (offset, size)
        if key not in self.steps:
            self.steps[key] = ChunkStepGraph(self, offset, size)
        return self.steps[key]


class PrefillGraphs:
    """A model's prefill graphs on caches of their own: at most ``limit``
    one-shot graphs and ``admissions`` chunked admissions, the least
    recently used dropped first, and the caches they write, one per
    ``(rows, cache_len, kv_quant)``, dropped with the last graph that
    writes it.  A prefill followed by a decode graph keeps its graph in
    that decode graph instead (``DecodeGraph.prefills``).  Every graph made
    here captures into one ``SharedPool``."""

    def __init__(self, limit: int = PREFILL_GRAPHS,
                 admissions: int = ADMISSIONS):
        self.one_shot = GraphLRU(limit)
        self.admissions = GraphLRU(admissions)
        self._caches = {}
        self.shared = SharedPool()

    def __len__(self) -> int:
        return len(self.one_shot) + len(self.admissions)

    def clear(self) -> None:
        self.one_shot.clear()
        self.admissions.clear()
        self._caches.clear()

    def cache(self, params, cfg: ModelConfig, batch: int, cache_len: int,
              kv_quant: bool) -> KVCache:
        """The shared cache of this shape and model group (made when there
        is none)."""
        heads = local_kv_heads(params, cfg)
        key = (id(cfg), batch, cache_len, bool(kv_quant), heads,
               params["embed_tokens"].device,
               torch.is_inference_mode_enabled(),
               group_key(tp.model_group()))
        if key not in self._caches:
            self._caches[key] = KVCache.zeros(
                cfg, batch, cache_len, quantized=kv_quant,
                device=params["embed_tokens"].device, kv_heads=heads)
        return self._caches[key]

    def _prune(self) -> None:
        """Drop the caches no retained graph writes."""
        live = {id(g.cache) for g in self.one_shot.values()} | {
            id(a.cache) for a in self.admissions.values()}
        self._caches = {k: c for k, c in self._caches.items()
                        if id(c) in live}

    def get(self, params, cfg: ModelConfig, inputs_embeds, route_ids,
            routing_table, cache_len: int, *, kv_quant: bool = False,
            attn_impl: str = "auto", decode_graph=None) -> PrefillGraph:
        """The one-shot graph of this prompt shape: in ``decode_graph``'s
        ``prefills`` over its cache when given, else here over the shared
        cache of ``cache_len``."""
        B = inputs_embeds.shape[0]
        key = graph_key(params, cfg, B, cache_len, kv_quant, routing_table,
                        attn_impl) + (tuple(inputs_embeds.shape),
                                      inputs_embeds.dtype,
                                      route_ids is not None)

        def make(cache):
            return lambda: PrefillGraph(
                params, cfg, cache, inputs_embeds,
                routed=route_ids is not None, routing_table=routing_table,
                attn_impl=attn_impl, shared=self.shared)
        if decode_graph is not None:
            return decode_graph.prefills.get_or_make(
                key, make(decode_graph.cache))
        graph = self.one_shot.get_or_make(key, make(self.cache(
            params, cfg, B, cache_len, kv_quant)))
        self._prune()
        return graph

    def chunked(self, params, cfg: ModelConfig, inputs_embeds, route_ids,
                routing_table, cache_len: int, *, kv_quant: bool = False,
                attn_impl: str = "auto") -> ChunkedAdmission:
        """The chunked admission of this cache shape and model group, over
        the shared batch-1 cache of ``cache_len``."""
        key = graph_key(params, cfg, 1, cache_len, kv_quant, routing_table,
                        attn_impl) + (inputs_embeds.dtype,
                                      route_ids is not None)
        admission = self.admissions.get_or_make(key, lambda: ChunkedAdmission(
            params, cfg, self.cache(params, cfg, 1, cache_len, kv_quant),
            dtype=inputs_embeds.dtype, routed=route_ids is not None,
            routing_table=routing_table, attn_impl=attn_impl,
            shared=self.shared))
        self._prune()
        return admission


def prefill(params, cfg: ModelConfig, inputs_embeds, route_ids,
            routing_table, segment_ids, lengths, max_len: int,
            attn_impl: str = "auto", kv_quant: bool = False, *,
            graphs: Optional[PrefillGraphs] = None, decode_graph=None):
    """``_prefill`` into ``decode_graph``'s cache (when given) or a fresh
    one, through a graph of ``graphs`` where one may run (``graphable``):
    (last valid position's fp32 logits [B, V], cache).  Through a graph the
    logits are its static buffer and the cache, without a decode graph, is
    one ``graphs`` shares: read both before the next prefill of the
    shape."""
    cache = None if decode_graph is None else decode_graph.cache
    if graphs is None or not graphable():
        return _prefill(params, cfg, inputs_embeds, route_ids,
                        routing_table, segment_ids, lengths, max_len,
                        attn_impl, kv_quant, cache=cache)
    graph = graphs.get(params, cfg, inputs_embeds, route_ids, routing_table,
                       max_len, kv_quant=kv_quant, attn_impl=attn_impl,
                       decode_graph=decode_graph)
    return graph(inputs_embeds, route_ids, segment_ids, lengths), graph.cache


def _load(dst: torch.Tensor, src) -> None:
    """Copy a tensor or host array into a static buffer."""
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(src)
    dst.copy_(src, non_blocking=src.device == dst.device)
