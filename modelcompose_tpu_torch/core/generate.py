"""Greedy generation with a preallocated KV cache (counterpart of
modelcompose_tpu/core/generate.py).

Prefill runs the full routed multimodal forward once and fills the cache;
decode steps run with the 'default' route class only, matching the
reference's decode semantics.  The decode loop is a Python loop that keeps
the argmax and the EOS/done mask on the device, with no per-step host
sync, and fetches the tokens once at the end.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.routed_lora import as_table, fold_dense
from .llama import KVCache, forward, forward_hidden_routed, logits_from_hidden


def _prefill(params, cfg: ModelConfig, inputs_embeds, route_ids,
             routing_table, segment_ids, lengths, max_len: int,
             attn_impl: str = "auto", kv_quant: bool = False):
    """Prompt forward that fills a fresh cache.  Returns (last valid
    position's fp32 logits [B, V], cache)."""
    B = inputs_embeds.shape[0]
    cache = KVCache.zeros(cfg, B, max_len, quantized=kv_quant,
                          device=inputs_embeds.device)
    hidden, cache = forward_hidden_routed(
        params, cfg, inputs_embeds, route_ids=route_ids,
        routing_table=routing_table, segment_ids=segment_ids, cache=cache,
        attn_impl=attn_impl)
    # Only the last valid position feeds decoding: gather it BEFORE the
    # lm_head so prefill skips the [B, L, V] logits product.
    rows = torch.arange(B, device=hidden.device)
    last_h = hidden[rows, lengths.long() - 1][:, None]
    return logits_from_hidden(params, last_h)[:, 0], cache


def _decode_step(params, cfg: ModelConfig, cache, tokens, kv_lens,
                 routing_table, attn_impl: str = "auto"):
    """One decode step.  tokens: [B] ids; kv_lens: [B] valid cache length
    before this token.  Returns (logits [B, V], cache, kv_lens + 1)."""
    embeds = params["embed_tokens"][tokens.long()][:, None]
    logits, cache = forward(
        params, cfg, embeds, route_ids=None, routing_table=routing_table,
        positions=kv_lens[:, None], cache=cache, cache_write_pos=kv_lens,
        kv_lens=kv_lens + 1, attn_impl=attn_impl)
    return logits[:, 0], cache, kv_lens + 1


def _on(a, device, dtype=None) -> torch.Tensor:
    """An array or tensor as a tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _sync_clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(params, cfg: ModelConfig, inputs_embeds, *, lengths,
             route_ids=None, routing_table=None, segment_ids=None,
             max_new_tokens: int = 128, eos_token_id: Optional[int] = None,
             temperature: float = 0.0, cache_len: Optional[int] = None,
             attn_impl: str = "auto", fold_decode=False,
             kv_quant: bool = False, timings: Optional[dict] = None):
    """Greedy token ids for a packed, right-padded batch.

    Args:
      inputs_embeds: [B, L, H] packed prompt embeddings.
      lengths: [B] true prompt lengths.
      route_ids: [B, L] route classes (None = all default).
      segment_ids: [B, L]; defaults to positions < lengths.
      fold_decode: False, or 'dense' (fold the default adapter mix into W
        and rebase the routing table: prefill stays identical, decode skips
        the adapter branch; see ops/routed_lora.fold_dense).
      kv_quant: int8 KV cache.
      timings: if a dict, receives 'prefill_s' and 'decode_s' (host clock
        around device-synchronized phases).

    Returns a list of per-sample lists of generated ids (EOS excluded).
    """
    if temperature and temperature > 0.0:
        raise NotImplementedError(
            "sampling is not ported yet: ROADMAP Queue 1, sampling + beam")
    if fold_decode not in (False, "dense"):
        raise NotImplementedError(
            f"fold_decode={fold_decode!r}: only False and 'dense' are ported")
    B, L, _ = inputs_embeds.shape
    device = inputs_embeds.device
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
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id

    decode_params, decode_table = params, routing_table
    if routing_table is not None:
        routing_table = as_table(routing_table, device)
        decode_table = routing_table
        if fold_decode == "dense":
            params, routing_table = fold_dense(params, routing_table)
            decode_params, decode_table = params, None
        elif not bool(routing_table[0].any()):
            # Already-folded params: the default row is all zero, so decode
            # skips the adapter branch instead of multiplying it by zero.
            decode_table = None

    t0 = _sync_clock(device) if timings is not None else 0.0
    logits, cache = _prefill(params, cfg, inputs_embeds, route_ids,
                             routing_table, segment_ids, lengths, cache_len,
                             attn_impl, kv_quant)
    if timings is not None:
        t1 = _sync_clock(device)
        timings["prefill_s"] = t1 - t0

    eos_id = torch.tensor(-1 if eos is None else int(eos), device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    kv_lens = lengths
    steps = []
    for step in range(max_new_tokens):
        tokens = torch.where(done, eos_id, logits.argmax(-1))
        done = done | (tokens == eos_id)
        steps.append(tokens)
        if step == max_new_tokens - 1:
            break
        logits, cache, kv_lens = _decode_step(decode_params, cfg, cache,
                                              tokens, kv_lens, decode_table,
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
