"""The decode step as a captured CUDA graph: one replay a token (the port's
counterpart of the JAX package's jitted ``_decode_step`` and of the
``device_loop`` scan in modelcompose_tpu/core/generate.py), and the capture
machinery every graph of the port shares (``CapturedStep``, ``GraphLRU``).

A decode step of the 7B backbone is a few thousand small launches (per
layer: the int8 dequant copies, the GEMMs, norms, RoPE, the cache write and
K2).  Launched from Python one by one, the host sets the pace; captured once
into a ``torch.cuda.CUDAGraph`` and replayed, the card does.

``DecodeGraph`` owns what the graph reads and writes by address: the KV
cache, the static inputs ``tokens [B]`` and ``kv_lens [B]`` and the static
output ``logits [B, V]`` (fp32).  Its params and routing table are the
caller's, kept referenced for the graph's life.  A call copies its inputs
into the static buffers, replays and returns the static logits: a caller
that keeps logits across the next call copies them.  On a CPU tensor the
same step runs eagerly into the same buffers.  On a CUDA tensor a capture
that fails raises; nothing falls back to the eager step.

The capture rules (``CapturedStep``): the capturing call runs the step
eagerly on a side stream (the warm-up a capture needs: every kernel's
first launch builds it and sets its shared-memory attribute, which a
capture cannot do), keeps that result as the call's, and captures the step
on the same stream; K1's and K2's launches inside a capture go into the
capture's records (``ops.flash_attention.capturing``,
``ops.flash_decode.capturing``; K2's scratch lives in its record as long as
the graph), and each replay adds the launches they recorded to the
kernels' counters, so every call counts one step's.  A decode graph
captures at its first call; the prefill and tower graphs, whose shapes
vary more, at their second (core/prefill_graph, models/towers).
Collectives are not captured: a graph under a tensor-parallel model group
raises (callers at ``--tp`` run eagerly, ``device_loop=False``).

``DecodeGraphs`` keeps a bounded set of graphs, keyed by the identity of
every tensor a graph reads (the decode params' leaves), the routing
table's values and the cache's shape; the least recently used graph, with
its cache, its prefill graphs and its memory pool, goes first.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import flash_attention, flash_decode
from ..parallel import tp
from ..tree import tree_leaves
from .llama import KVCache, forward, local_kv_heads

PREFILLS_PER_DECODE = 2  # the prefill graphs a decode graph keeps


def _decode_step(params, cfg: ModelConfig, cache, tokens, kv_lens,
                 routing_table, attn_impl: str = "auto"):
    """One decode step.  tokens: [B] ids; kv_lens: [B] valid cache length
    before this token.  Returns (logits [B, V], cache, kv_lens + 1)."""
    embeds = tp.vocab_embedding(params["embed_tokens"], tokens.long())[:, None]
    logits, cache = forward(
        params, cfg, embeds, route_ids=None, routing_table=routing_table,
        positions=kv_lens[:, None], cache=cache, cache_write_pos=kv_lens,
        kv_lens=kv_lens + 1, attn_impl=attn_impl)
    return logits[:, 0], cache, kv_lens + 1


def refuse_model_group(what: str) -> None:
    """Raise under a tensor-parallel model group: a graph would capture
    its collectives, which it does not."""
    if tp.model_group() is not None:
        raise RuntimeError(
            f"{what} under a tensor-parallel model group: its collectives "
            "are not captured; run it eagerly")


def _empty_like(out):
    """Static buffers shaped as a step's outputs (a tensor, or a tuple of
    tensors and Nones)."""
    if isinstance(out, tuple):
        return tuple(None if t is None else torch.empty_like(t) for t in out)
    return torch.empty_like(out)


def _copy_into(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            if d is not None:
                d.copy_(s)
    else:
        dst.copy_(src)


class SharedPool:
    """One private memory pool and one capture stream per device, shared
    by a set of graphs (a model's prefill graphs, its tower graphs).

    Sound where the set's graphs replay one after another (one caller at a
    time, on one stream), as a model's do: every static input and output
    is allocated outside the captures, so the pool holds only a capture's
    transients, which the next capture of the set reuses, and the few
    tensors a capture leaves alive (K1's segment ids in its record), which
    stay allocated while their graph lives.  The set then holds the pool
    of its largest step instead of one pool a graph.  The captures run on
    the one stream, where the allocator can hand a freed block on.

    A pool whose graphs are all gone is released by PyTorch and its handle
    cannot take a capture again: the next capture then gets a new pool."""

    def __init__(self):
        self._by_device = {}

    def get(self, device):
        """(pool handle, capture stream, the graphs holding the pool) of
        ``device`` for a capture: the live pool, or a new one where no
        graph holds the last.  The caller keeps the list until its capture
        has begun, so the pool stays alive until then."""
        entry = self._by_device.get(device)
        holders = list(entry[2]) if entry is not None else []
        if not holders:
            entry = self._by_device[device] = (
                torch.cuda.graph_pool_handle(), torch.cuda.Stream(device),
                weakref.WeakSet())
        return entry[0], entry[1], holders

    def add(self, device, graph) -> None:
        """Count ``graph``, captured into ``device``'s pool, as holding
        it."""
        self._by_device[device][2].add(graph)


class CapturedStep:
    """A step of fixed shapes over static buffers a subclass owns, run as a
    captured CUDA graph on the card.

    ``run()`` is one call: on a CPU device, and on the card before call
    ``capture_at``, the step runs eagerly (on the current stream) into the
    static outputs ``out``; the call that reaches ``capture_at`` captures
    the step (see the module docstring), later calls replay it.  A
    subclass writes ``_step()``, the step over its static inputs,
    returning a tensor or a tuple of tensors and Nones; ``out`` has that
    structure.  A graph of a ``SharedPool`` captures into its pool on its
    stream; any other into a pool of its own."""

    capture_at = 1
    captures = 0  # a subclass counts its own: captures of every graph
    replays = 0  # and replays of every graph

    def __init__(self, device, shared: "SharedPool" = None):
        self.device = torch.device(device)
        self.calls = 0
        self.out = None  # the static outputs, made by the first call
        self.graph = None
        self.k1 = self.k2 = None  # the capture's launch records
        self.shared = shared

    def _step(self):
        raise NotImplementedError

    def _compute(self):
        with torch.no_grad():
            return self._step()

    def run(self):
        """One call of the step on the static inputs: eagerly, by a
        capture, or by a replay.  Returns the static outputs."""
        self.calls += 1
        if self.graph is not None:
            self.replay()
        elif self.device.type != "cuda" or self.calls < self.capture_at:
            res = self._compute()
            if self.out is None:
                self.out = _empty_like(res)
            _copy_into(self.out, res)
        else:
            self._capture()  # this call's step runs as the warm-up
        return self.out

    def replay(self) -> None:
        """Replay the captured step on the current stream, counting the K1
        and K2 launches it runs."""
        self.graph.replay()
        type(self).replays += 1
        flash_attention.flash_attention_forward.launches += len(
            self.k1.launches)
        flash_decode.flash_decode_attention.launches += len(self.k2.launches)

    def _capture(self) -> None:
        """Run the step once eagerly on a side stream (the warm-up a
        capture needs), keep its outputs as this call's, then capture the
        step on that stream without running it: each call runs the step
        once, so launch counts stay one per step."""
        current = torch.cuda.current_stream(self.device)
        pool, side, holders = (None, torch.cuda.Stream(self.device), None) \
            if self.shared is None else self.shared.get(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self._compute()
        if self.out is None:
            self.out = _empty_like(warm)
        graph = torch.cuda.CUDAGraph()
        # thread-local mode: other threads may use the card meanwhile
        with flash_attention.capturing() as k1, \
                flash_decode.capturing() as k2, torch.cuda.stream(side):
            side.wait_stream(current)  # the static outputs' allocation
            _copy_into(self.out, warm)
            del warm
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            del holders  # the pool is this graph's too now
            try:
                _copy_into(self.out, self._compute())
            finally:
                graph.capture_end()
        current.wait_stream(side)
        if self.shared is not None:
            self.shared.add(self.device, graph)
        self.graph, self.k1, self.k2 = graph, k1, k2
        type(self).captures += 1


class DecodeGraph(CapturedStep):
    """``_decode_step`` of ``batch`` rows over a cache of ``cache_len``
    positions, on the params' device, captured at its first call on the
    card (see the module docstring).  Its buffers are made in the caller's
    grad mode (inference tensors inside ``torch.inference_mode``), and it
    is called in that mode; one thread calls it at a time.  ``prefills``
    holds the prefill graphs that fill its cache (core/prefill_graph),
    which go with it."""

    captures = 0
    replays = 0

    def __init__(self, params, cfg: ModelConfig, batch: int, cache_len: int,
                 *, kv_quant: bool = False, routing_table=None,
                 attn_impl: str = "auto"):
        refuse_model_group("DecodeGraph")
        super().__init__(params["embed_tokens"].device)
        self.params, self.cfg = params, cfg
        self.table, self.attn_impl = routing_table, attn_impl
        self.cache = KVCache.zeros(
            cfg, batch, cache_len, quantized=kv_quant, device=self.device,
            kv_heads=local_kv_heads(params, cfg))
        self.tokens = torch.zeros(batch, dtype=torch.int64,
                                  device=self.device)
        self.kv_lens = torch.ones(batch, dtype=torch.int32,
                                  device=self.device)
        self.prefills = GraphLRU(PREFILLS_PER_DECODE)
        self._pinned = None  # host staging of host inputs, and its event

    @property
    def logits(self):
        """The static logits [B, V] fp32 (None before the first call)."""
        return self.out

    def __call__(self, tokens, kv_lens) -> torch.Tensor:
        """The step's fp32 logits [B, V] for ``tokens`` [B] written at
        positions ``kv_lens`` [B] (tensors or host arrays): the static
        buffer, rewritten by the next call."""
        self._load(tokens, kv_lens)
        return self.run()

    def _load(self, tokens, kv_lens) -> None:
        host = [not isinstance(x, torch.Tensor) for x in (tokens, kv_lens)]
        if self.device.type == "cuda" and any(host):
            if self._pinned is None:
                self._pinned = (torch.zeros((2, self.tokens.shape[0]),
                                            dtype=torch.int64,
                                            pin_memory=True),
                                torch.cuda.Event())
            else:  # the last copy out of the staging buffer is done
                self._pinned[1].synchronize()
        for i, (dst, src) in enumerate(((self.tokens, tokens),
                                        (self.kv_lens, kv_lens))):
            if isinstance(src, torch.Tensor):
                dst.copy_(src, non_blocking=True)
            elif self.device.type == "cuda":
                stage = self._pinned[0][i]
                stage.copy_(torch.from_numpy(np.asarray(src, np.int64)))
                dst.copy_(stage, non_blocking=True)
            else:
                dst.copy_(torch.from_numpy(np.asarray(src)))
        if self.device.type == "cuda" and any(host):
            self._pinned[1].record()

    def _step(self) -> torch.Tensor:
        return _decode_step(self.params, self.cfg, self.cache, self.tokens,
                            self.kv_lens, self.table, self.attn_impl)[0]


def graph_key(params, cfg: ModelConfig, batch: int, cache_len: int,
              kv_quant: bool, routing_table, attn_impl: str):
    """What a graph reads: its params' leaves by identity (a graph keeps
    them referenced, so an id is never reused while it lives), the routing
    table by value, the config, the cache's shape, and the grad mode its
    buffers were made in (an inference tensor is written only in
    inference mode)."""
    table = None
    if routing_table is not None:
        t = routing_table.detach().cpu().numpy() \
            if isinstance(routing_table, torch.Tensor) \
            else np.asarray(routing_table)
        table = (t.shape, t.tobytes())
    leaves = tuple(id(leaf) for _, leaf in tree_leaves(params))
    return (leaves, table, id(cfg), batch, cache_len, bool(kv_quant),
            attn_impl, torch.is_inference_mode_enabled())


class GraphLRU:
    """At most ``limit`` graphs by key, the least recently used dropped
    first (with whatever it owns: its cache, its pool)."""

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError(f"limit {limit} < 1")
        self.limit = limit
        self._graphs: "OrderedDict[tuple, object]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()

    def values(self):
        return list(self._graphs.values())

    def get_or_make(self, key, make: Callable[[], object]):
        """The graph of ``key``, made by ``make()`` (and the oldest
        dropped) when there is none."""
        graph = self._graphs.pop(key, None)
        if graph is None:
            while len(self._graphs) >= self.limit:
                self._graphs.popitem(last=False)
            graph = make()
        self._graphs[key] = graph
        return graph


class DecodeGraphs(GraphLRU):
    """At most ``limit`` decode graphs, each with its cache, the least
    recently used dropped first."""

    def __init__(self, limit: int = 2):
        super().__init__(limit)

    def get(self, params, cfg: ModelConfig, batch: int, cache_len: int, *,
            kv_quant: bool = False, routing_table=None,
            attn_impl: str = "auto") -> DecodeGraph:
        """The graph of this step and cache shape, made (and the oldest
        dropped) when there is none."""
        key = graph_key(params, cfg, batch, cache_len, kv_quant,
                        routing_table, attn_impl)
        return self.get_or_make(key, lambda: DecodeGraph(
            params, cfg, batch, cache_len, kv_quant=kv_quant,
            routing_table=routing_table, attn_impl=attn_impl))
