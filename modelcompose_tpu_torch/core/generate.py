"""Greedy/temperature generation with a preallocated KV cache (counterpart
of modelcompose_tpu/core/generate.py).

Prefill runs the full routed multimodal forward once and fills the cache
(``_prefill``), or in chunks with work between them (``prefill_chunked``,
the slot engine's admission), each through the captured CUDA graphs of a
``PrefillGraphs`` when the caller gives one (core/prefill_graph); decode
steps run with the 'default' route class only, matching the reference's
decode semantics.  ``generate`` keeps
the token choice (argmax, or a draw from an explicit ``torch.Generator``)
and the EOS/done mask on the device, with no per-step host sync, and
fetches the tokens once at the end; with ``device_loop=True`` (the JAX
parameter and default) each step is one replay of a captured CUDA graph
(core/decode_graph), the token choice staying outside it.
``stream_decode`` fetches the [B] token ids every step, since it hands
each token out as it decodes.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.routed_lora import as_table, fold_decode_adapters, fold_dense
from .decode_graph import DecodeGraphs, _decode_step
from .llama import KVCache, local_kv_heads, logits_from_hidden
# _prefill stays importable from here (the eager one-shot prefill)
from .prefill_graph import (PrefillGraphs, _prefill, _prefill_chunk_step,  # noqa: F401
                            graphable, prefill)
from .sampling import categorical, sample_step, top_p_filter


def prefill_chunked(params, cfg: ModelConfig, inputs_embeds, route_ids,
                    routing_table, lengths, cache_len: int,
                    chunk: int = 256, attn_impl: str = "auto",
                    tick_cb=None, kv_quant: bool = False,
                    graphs: Optional[PrefillGraphs] = None):
    """Chunked prefill of one right-padded prompt (the slot engine's
    admission): ``chunk``-position pieces (full chunks, then a ragged
    tail), with ``tick_cb()`` run after each so the caller can interleave
    work.  With ``kv_quant=False`` it gives ``_prefill``'s (last-position
    fp32 logits [1, V], cache); causal masking with the query offset
    exposes exactly the written prefix, so no segment ids are needed.

    ``kv_quant=True`` quantizes each chunk's k/v into an int8 cache at
    append time and later chunks attend over the dequantized prefix (the
    int8-KV decode approximation, one phase earlier): the transient is
    the int8 cache, a quarter of the bf16 one's bytes.

    With ``graphs`` (where a graph may run: ``graphable``) each piece is
    one replay of its ``(offset, size)`` chunk step, and the cache is the
    persistent admission cache ``graphs`` keeps for ``(cache_len,
    kv_quant)``, its tail [L, cache_len) zeroed first, so it holds what a
    fresh cache would: read it before the next admission of the shape.
    ``graphs=None`` writes a fresh cache, launch by launch."""
    B, L, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError("chunked prefill takes one prompt (batch 1)")
    device = inputs_embeds.device
    chunk = max(1, min(chunk, L))
    sizes = [chunk] * (L // chunk) + ([L % chunk] if L % chunk else [])
    if routing_table is not None:
        routing_table = as_table(routing_table, device)
    if route_ids is not None:
        route_ids = _on(route_ids, device)
    admission = None
    if graphs is not None and graphable():
        admission = graphs.chunked(params, cfg, inputs_embeds, route_ids,
                                   routing_table, cache_len,
                                   kv_quant=kv_quant, attn_impl=attn_impl)
        cache = admission.cache
        for t in cache.tensors():
            t[:, :, L:].zero_()
    else:
        cache = KVCache.zeros(cfg, B, cache_len, quantized=kv_quant,
                              device=device,
                              kv_heads=local_kv_heads(params, cfg))
    last_idx = int(_on(lengths, "cpu")[0]) - 1
    logits, off = None, 0
    for size in sizes:
        # write k/v at [off, off + size) in place and attend causally with
        # query offset ``off``
        embeds = inputs_embeds[:, off:off + size]
        rc = None if route_ids is None else route_ids[:, off:off + size]
        if admission is not None:
            hidden = admission.step(off, size)(embeds, rc)
        else:
            hidden = _prefill_chunk_step(params, cfg, cache, embeds, rc,
                                         routing_table, off, attn_impl)
        if off <= last_idx < off + size:
            logits = logits_from_hidden(
                params, hidden[:, last_idx - off][:, None], attn_impl)[:, 0]
        off += size
        if tick_cb is not None:
            tick_cb()
    return logits, cache


def _on(a, device, dtype=None) -> torch.Tensor:
    """An array or tensor as a tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _sync_clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _prepare(inputs_embeds, lengths, segment_ids, route_ids,
             max_new_tokens: int, cache_len: Optional[int]):
    """Defaults and device placement shared by generate and beam search:
    (cache_len, lengths int32, segment_ids int32, route_ids)."""
    L, device = inputs_embeds.shape[1], inputs_embeds.device
    if cache_len is None:
        cache_len = L + max_new_tokens
    lengths = _on(lengths, device, torch.int32)
    if segment_ids is None:
        segment_ids = (torch.arange(L, device=device)[None]
                       < lengths[:, None]).to(torch.int32)
    else:
        segment_ids = _on(segment_ids, device, torch.int32)
    if route_ids is not None:
        route_ids = _on(route_ids, device)
    return cache_len, lengths, segment_ids, route_ids


def _eos(cfg: ModelConfig, eos_token_id: Optional[int]) -> Optional[int]:
    """The id that ends a row: ``eos_token_id`` when given, else the
    config's (None: no row ends early)."""
    return cfg.eos_token_id if eos_token_id is None else eos_token_id


def _decode_tables(routing_table, device):
    """(prefill table, decode table) on ``device``: decode skips the
    adapter branch (None) when the default row is all zero, as it is for
    dense-folded params, instead of multiplying it by zero."""
    if routing_table is None:
        return None, None
    table = as_table(routing_table, device)
    return table, (table if bool(table[0].any()) else None)


def generate(params, cfg: ModelConfig, inputs_embeds, *, lengths,
             route_ids=None, routing_table=None, segment_ids=None,
             max_new_tokens: int = 128, eos_token_id: Optional[int] = None,
             temperature: float = 0.0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             cache_len: Optional[int] = None,
             attn_impl: str = "auto", device_loop: bool = True,
             fold_decode=False, kv_quant: bool = False,
             graphs: Optional[DecodeGraphs] = None,
             prefill_graphs: Optional[PrefillGraphs] = None,
             timings: Optional[dict] = None):
    """Greedy or sampled token ids for a packed, right-padded batch.

    Args:
      inputs_embeds: [B, L, H] packed prompt embeddings.
      lengths: [B] true prompt lengths.
      route_ids: [B, L] route classes (None = all default).
      segment_ids: [B, L]; defaults to positions < lengths.
      temperature: > 0 samples softmax(logits / temperature), top-p
        filtered when ``top_p < 1``; draws come from ``generator``, which
        lives on the embeddings' device (seed 0 there when None).
      fold_decode: False; True/'concat' (compact the default-route adapters
        into one low-rank pair for decode, held beside the full stacks; see
        ops/routed_lora.fold_decode_adapters); or 'dense' (fold the default
        adapter mix into W and rebase the routing table: prefill stays
        identical, decode skips the adapter branch; see
        ops/routed_lora.fold_dense).
      kv_quant: int8 KV cache.
      device_loop: True decodes through a ``DecodeGraph`` (one CUDA-graph
        replay a step on the card, the same step eagerly on the CPU),
        prefilling into the graph's cache; False launches each step's
        kernels from Python.  The ids are the same.
      graphs: the ``DecodeGraphs`` to take the graph from and keep it in
        (a model's, so requests of one shape reuse it); None makes one for
        this call, and so does a fold made here (its params and graph go
        with the call).
      prefill_graphs: the ``PrefillGraphs`` whose captured graphs run the
        prefill (a model's); None prefills launch by launch.  The ids are
        the same.
      timings: if a dict, receives 'prefill_s' and 'decode_s' (host clock
        around device-synchronized phases).

    Returns a list of per-sample lists of generated ids (EOS excluded).
    """
    if fold_decode not in (False, True, "concat", "dense"):
        raise ValueError(f"fold_decode={fold_decode!r}")
    B, L, _ = inputs_embeds.shape
    device = inputs_embeds.device
    cache_len, lengths, segment_ids, route_ids = _prepare(
        inputs_embeds, lengths, segment_ids, route_ids, max_new_tokens,
        cache_len)
    eos = _eos(cfg, eos_token_id)

    routing_table, decode_table = _decode_tables(routing_table, device)
    if routing_table is not None and fold_decode == "dense":
        params, routing_table = fold_dense(params, routing_table)
        decode_table = None
    decode_params = params
    if fold_decode in (True, "concat") and routing_table is not None:
        # One concatenated low-rank pair of the default-route adapters, so
        # a step stops reading the inactive adapter rows.
        decode_params, decode_table = fold_decode_adapters(params,
                                                           routing_table[0])
    graph = None
    if device_loop and max_new_tokens > 1:  # a step to decode
        if graphs is None or (fold_decode and routing_table is not None):
            # a fold's params are this call's: so is its graph
            graphs = DecodeGraphs(1)
        graph = graphs.get(
            decode_params, cfg, B, cache_len, kv_quant=kv_quant,
            routing_table=decode_table, attn_impl=attn_impl)

    t0 = _sync_clock(device) if timings is not None else 0.0
    logits, cache = prefill(params, cfg, inputs_embeds, route_ids,
                            routing_table, segment_ids, lengths, cache_len,
                            attn_impl, kv_quant, graphs=prefill_graphs,
                            decode_graph=graph)
    if timings is not None:
        t1 = _sync_clock(device)
        timings["prefill_s"] = t1 - t0

    do_sample = bool(temperature and temperature > 0.0)
    use_top_p = do_sample and top_p is not None and top_p < 1.0
    if do_sample and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def pick(logits):
        # Deliberately not sampling.sample_logits: its greedy gate and the
        # unconditional top-p sort belong to the serving engines; this
        # loop samples for any temperature > 0 and sorts only when
        # top_p < 1, as the JAX decode loop does.
        if not do_sample:
            return logits.argmax(-1)
        scaled = logits / temperature
        if use_top_p:
            scaled = top_p_filter(scaled.float(), top_p)
        return categorical(generator, scaled)

    eos_id = torch.tensor(-1 if eos is None else int(eos), device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    kv_lens = lengths
    steps = []
    for step in range(max_new_tokens):
        tokens = torch.where(done, eos_id, pick(logits))
        done = done | (tokens == eos_id)
        steps.append(tokens)
        if step == max_new_tokens - 1:
            break
        if graph is not None:
            logits = graph(tokens, kv_lens)
            kv_lens = kv_lens + 1
        else:
            logits, cache, kv_lens = _decode_step(
                decode_params, cfg, cache, tokens, kv_lens, decode_table,
                attn_impl)
    host = torch.stack(steps, dim=1).cpu().numpy()  # the one host fetch
    if timings is not None:
        timings["decode_s"] = time.perf_counter() - t1
    outputs = []
    for b in range(B):
        row = host[b].tolist()
        if eos is not None and eos in row:
            row = row[:row.index(eos)]
        outputs.append(row)
    return outputs


def stream_decode(prefill, decode, prompt_len: int, lengths, *,
                  cfg: ModelConfig, emit, max_new_tokens: Sequence[int],
                  temperatures: Sequence[float],
                  top_ps: Optional[Sequence[float]], generator,
                  cancelled=None, eos_token_id: Optional[int] = None,
                  device=None) -> None:
    """Streaming decode of a packed batch over two backbone calls:
    ``prefill(cache_len)`` (the last valid position's fp32 logits [B, V])
    and ``decode(tokens, kv_lens)`` (host int32 arrays [B]; the next
    logits), so a caller can run them elsewhere (the served backbone of a
    tensor-parallel group, ``MultimodalLM.generate_stream``).

    The loop calls ``emit(b, ("token", id))`` for each row's token the step
    it decodes and ``emit(b, ("done", None))`` once per row (EOS, its
    ``max_new_tokens[b]``, or ``cancelled(b)`` true; rows with a budget of
    0 or less are done before the prefill).  Per-row temperature and top-p
    draw on the device (``sampling.sample_step``, greedy rows bit-identical
    to argmax) from ``generator``; one host fetch of the [B] ids a step.
    The loop ends as soon as every row is done."""
    B = len(max_new_tokens)
    done = [False] * B
    for b in range(B):
        if max_new_tokens[b] <= 0:
            done[b] = True
            emit(b, ("done", None))
    if all(done):
        return
    steps = max(max_new_tokens)
    eos = _eos(cfg, eos_token_id)
    logits = prefill(prompt_len + steps)
    temps = torch.tensor(list(temperatures), dtype=torch.float32,
                         device=device)
    tps = torch.tensor([1.0] * B if top_ps is None else list(top_ps),
                       dtype=torch.float32, device=device)
    kv_lens = np.asarray(_on(lengths, "cpu"), np.int32)
    for step in range(steps):
        sampled = sample_step(generator, logits, temps, tps).cpu().numpy()
        tokens = np.zeros(B, np.int32)
        for b in range(B):
            if not done[b] and cancelled is not None and cancelled(b):
                done[b] = True
                emit(b, ("done", None))
            if done[b]:
                tokens[b] = eos if eos is not None else 0
                continue
            tok = int(sampled[b])
            tokens[b] = tok
            if eos is not None and tok == eos:
                done[b] = True
                emit(b, ("done", None))
                continue
            emit(b, ("token", tok))
            if step == max_new_tokens[b] - 1:
                done[b] = True
                emit(b, ("done", None))
        if all(done):
            return
        logits = decode(tokens, kv_lens)
        kv_lens = kv_lens + 1
