"""The served backbone: the backbone calls of the serving engines, run in
step on every rank of a tensor-parallel model group.

Rank 0 of the group (the leader) serves requests: it runs the towers, the
packing, the sampling and the engines' bookkeeping.  Every backbone call it
makes through ``ServingBackbone`` is first broadcast to the other ranks
(the followers), with its inputs: each prefill's feature table and pack
plan (every rank assembles the embeddings, whose vocab-split lookup sums
over the group), each decode tick's token ids and cache lengths, each
splice of an admission into the slot pool.  A follower runs
``follow()``: it takes the calls in the leader's order and runs the same
sharded backbone on its own cache shard, so every rank issues the same
collectives in the same order.  With no model group (or a group of one)
nothing is sent and the calls run locally: the single-device engines go
through the same code.

Caches are named by the caller (``"pool"``, ``"admit"``, ``"stream"``), so
a follower holds the same caches as the leader.

With no model group a decoded cache belongs to a captured decode graph
(core/decode_graph), so a tick is one replay: a new cache (the slot pool)
gets a graph of its own for its life, and a prefill asked for
``decode_graph`` fills the cache of the model's graph of that shape
(``MultimodalLM.decode_graphs``), reused by the next request of the shape.
A graph decodes with the params it was made with, and its logits are its
static buffer: the caller reads them before the next decode of that
cache.  Prefills go through the model's captured prefill graphs
(``MultimodalLM.prefill_graphs``, core/prefill_graph): a one-shot prefill
fills the decode graph's cache, or the admission cache the prefill graphs
keep, and a chunked one replays one chunk-step graph a piece; the splice
copies out of that admission cache, which stays for the next admission.
Collectives are not captured, so under a model group every call runs
eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.decode_graph import DecodeGraph
from ..core.generate import _decode_step, prefill_chunked
from ..core.llama import KVCache, local_kv_heads
from ..core.packing import assemble_embeds
from ..core.prefill_graph import prefill
from ..ops.routed_lora import as_table
from . import tp


@dataclasses.dataclass
class _Ref:
    """A tensor of a broadcast call, sent after the header."""
    index: int
    shape: tuple
    dtype: torch.dtype


class ServingBackbone:
    def __init__(self, model):
        self.model = model
        self.group = model.tp_group
        size = 1 if self.group is None else dist.get_world_size(self.group)
        self.mirrored = size > 1
        self.leader = (dist.get_process_group_ranks(self.group)[0]
                       if self.mirrored else 0)
        self.is_leader = not self.mirrored or dist.get_rank() == self.leader
        self.caches: Dict[str, Any] = {}
        self.tables: Dict[str, Any] = {}
        self.graphs: Dict[str, DecodeGraph] = {}  # the graphed caches

    # -- transport ------------------------------------------------------
    def _send(self, op: str, args: Dict[str, Any]) -> None:
        if not self.mirrored:
            return
        tensors = []

        def enc(v):
            if isinstance(v, torch.Tensor):
                tensors.append(v.contiguous())
                return _Ref(len(tensors) - 1, tuple(v.shape), v.dtype)
            if isinstance(v, dict):
                return {k: enc(x) for k, x in v.items()}
            return v
        header = [(op, {k: enc(v) for k, v in args.items()})]
        dist.broadcast_object_list(header, src=self.leader, group=self.group)
        for t in tensors:
            dist.broadcast(t, src=self.leader, group=self.group)

    def _recv(self):
        header = [None]
        dist.broadcast_object_list(header, src=self.leader, group=self.group)
        op, args = header[0]
        refs = []

        def collect(v):
            if isinstance(v, _Ref):
                refs.append(v)
            elif isinstance(v, dict):
                for x in v.values():
                    collect(x)
        collect(args)
        tensors = {}
        for ref in sorted(refs, key=lambda r: r.index):
            t = torch.empty(ref.shape, dtype=ref.dtype,
                            device=self.model.device)
            dist.broadcast(t, src=self.leader, group=self.group)
            tensors[ref.index] = t

        def dec(v):
            if isinstance(v, _Ref):
                return tensors[v.index]
            if isinstance(v, dict):
                return {k: dec(x) for k, x in v.items()}
            return v
        return op, {k: dec(v) for k, v in args.items()}

    def _call(self, op: str, **args):
        if not self.is_leader:
            raise RuntimeError(f"{op}: a follower rank takes its calls from "
                               "the leader (follow())")
        self._send(op, args)
        with tp.scope(self.group):
            return getattr(self, "_" + op)(**args)

    # -- the calls --------------------------------------------------------
    def prefill(self, key: str, feats, plan, cache_len: int,
                kv_quant: bool = False, chunk: Optional[int] = None,
                tick_cb=None, decode_graph: bool = False) -> torch.Tensor:
        """Assemble the packed embeddings and prefill a cache named
        ``key`` (one-shot, or ``chunk``-position pieces with ``tick_cb()``
        between them): the last valid position's fp32 logits [B, V].  The
        cache is the model's prefill graphs' admission cache where they
        run (read it, by a splice, before the next prefill), else a fresh
        one; ``decode_graph`` (one-shot, no model group) fills the cache of
        the model's decode graph of this shape instead, which then decodes
        it."""
        if not self.is_leader:
            raise RuntimeError("prefill: a follower rank takes its calls "
                               "from the leader (follow())")
        self._send("prefill", dict(key=key, feats=feats, plan=plan,
                                   cache_len=cache_len, kv_quant=kv_quant,
                                   chunk=chunk, decode_graph=decode_graph))

        def tick():
            if tick_cb is not None:
                tick_cb()
            self._send("tick_end", {})
        with tp.scope(self.group):
            return self._prefill(key, feats, plan, cache_len, kv_quant,
                                 chunk, tick if chunk else None,
                                 decode_graph)

    def decode(self, key: str, tokens, kv_lens) -> torch.Tensor:
        """One decode step of cache ``key``: tokens [B] and kv_lens [B]
        (host arrays), the fp32 logits [B, V]."""
        return self._call("decode", key=key,
                          tokens=np.asarray(tokens, np.int32),
                          kv_lens=np.asarray(kv_lens, np.int32))

    def new_cache(self, key: str, batch: int, cache_len: int,
                  kv_quant: bool = False) -> None:
        """A zero cache named ``key`` (the slot pool), decoded with the
        model's decode routing table."""
        self._call("new_cache", key=key, batch=batch, cache_len=cache_len,
                   kv_quant=kv_quant)

    def splice(self, dst: str, src: str, slot: int) -> None:
        """Cache ``src`` (batch 1) into row ``slot`` of ``dst``; ``src`` is
        dropped."""
        self._call("splice", dst=dst, src=src, slot=slot)

    def free(self, key: str) -> None:
        self._call("free", key=key)

    def stop(self) -> None:
        """End the followers' ``follow()`` (the leader's last call)."""
        self._call("stop")

    def follow(self) -> None:
        """A follower's loop: run the leader's calls until ``stop``."""
        with tp.scope(self.group):
            self._follow("stop")

    def _follow(self, until: str) -> None:
        while True:
            op, args = self._recv()
            if op == until:
                return
            if op == "prefill":
                tick = (lambda: self._follow("tick_end")) \
                    if args["chunk"] else None
                self._prefill(**args, tick_cb=tick)
            else:
                getattr(self, "_" + op)(**args)

    # -- local work (every rank) -------------------------------------------
    def _tables(self):
        model = self.model
        table = as_table(model.routing_table, model.device)
        return table, model.decode_routing_table()

    def _prefill(self, key, feats, plan, cache_len, kv_quant, chunk,
                 tick_cb=None, decode_graph=False):
        model = self.model
        device = model.device
        embeds = assemble_embeds(model.params["embed_tokens"], plan, feats)
        table, decode_table = self._tables()
        self.tables[key] = decode_table
        self.graphs.pop(key, None)
        graph = None
        if decode_graph and not chunk and self.group is None:
            graph = self.graphs[key] = model.decode_graphs.get(
                model.params, model.cfg, embeds.shape[0], cache_len,
                kv_quant=kv_quant, routing_table=decode_table)
        route_ids = (torch.as_tensor(plan.route_ids, device=device)
                     if model.cfg.routing_active() else None)
        if chunk:
            logits, cache = prefill_chunked(
                model.params, model.cfg, embeds, route_ids, table,
                plan.lengths, cache_len, chunk=chunk, tick_cb=tick_cb,
                kv_quant=kv_quant, graphs=model.prefill_graphs)
        else:
            logits, cache = prefill(
                model.params, model.cfg, embeds, route_ids, table,
                torch.as_tensor(plan.segment_ids, device=device),
                torch.as_tensor(plan.lengths, dtype=torch.int32,
                                device=device),
                cache_len, "auto", kv_quant, graphs=model.prefill_graphs,
                decode_graph=graph)
        self.caches[key] = cache
        return logits

    def _decode(self, key, tokens, kv_lens):
        model = self.model
        if key in self.graphs:
            return self.graphs[key](tokens, kv_lens)
        device = model.device
        logits, self.caches[key], _ = _decode_step(
            model.params, model.cfg, self.caches[key],
            torch.as_tensor(tokens, device=device),
            torch.as_tensor(kv_lens, device=device), self.tables[key])
        return logits

    def _new_cache(self, key, batch, cache_len, kv_quant):
        model = self.model
        self.tables[key] = self._tables()[1]
        self.graphs.pop(key, None)
        if self.group is None:
            graph = self.graphs[key] = DecodeGraph(
                model.params, model.cfg, batch, cache_len,
                kv_quant=kv_quant, routing_table=self.tables[key])
            self.caches[key] = graph.cache
            return
        self.caches[key] = KVCache.zeros(
            model.cfg, batch, cache_len, quantized=kv_quant,
            device=model.device,
            kv_heads=local_kv_heads(model.params, model.cfg))

    def _splice(self, dst, src, slot):
        self.caches[dst].splice(self.caches.pop(src), slot)
        self.tables.pop(src, None)
        self.graphs.pop(src, None)

    def _free(self, key):
        self.caches.pop(key, None)
        self.tables.pop(key, None)
        self.graphs.pop(key, None)

    def _stop(self):
        pass
