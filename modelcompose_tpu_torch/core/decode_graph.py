"""The decode step as a captured CUDA graph: one replay a token (the port's
counterpart of the JAX package's jitted ``_decode_step`` and of the
``device_loop`` scan in modelcompose_tpu/core/generate.py).

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

The capture rules it keeps: the first call runs the step eagerly on a
side stream (the warm-up a capture needs: every kernel's first launch
builds it and sets its shared-memory attribute, which a capture cannot
do), keeps that result as the call's, and captures the step on the same
stream; K2's scratch comes from the capture's record
(``ops.flash_decode.capturing``) and lives as long as the graph; each
replay adds the K2 launches the capture recorded to
``flash_decode_attention.launches``, so every call counts one step's.  Collectives are not captured: a graph
under a tensor-parallel model group raises (callers at ``--tp`` decode
eagerly, ``device_loop=False``).

``DecodeGraphs`` keeps a bounded set of graphs, keyed by the identity of
every tensor a graph reads (the decode params' leaves), the routing
table's values and the cache's shape; the least recently used graph, with
its cache and memory pool, goes first.
"""

from __future__ import annotations

from collections import OrderedDict
import numpy as np
import torch

from ..config import ModelConfig
from ..ops import flash_decode
from ..parallel import tp
from ..tree import tree_leaves
from .llama import KVCache, forward, local_kv_heads


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


class DecodeGraph:
    """``_decode_step`` of ``batch`` rows over a cache of ``cache_len``
    positions, on the params' device, captured at its first call on the
    card (see the module docstring).  Its buffers are made in the caller's
    grad mode (inference tensors inside ``torch.inference_mode``), and it
    is called in that mode; one thread calls it at a time."""

    captures = 0  # captures of every graph, so a caller can see reuse
    replays = 0  # replays of every graph

    def __init__(self, params, cfg: ModelConfig, batch: int, cache_len: int,
                 *, kv_quant: bool = False, routing_table=None,
                 attn_impl: str = "auto"):
        if tp.model_group() is not None:
            raise RuntimeError(
                "DecodeGraph under a tensor-parallel model group: its "
                "collectives are not captured; decode eagerly "
                "(device_loop=False)")
        self.device = params["embed_tokens"].device
        self.params, self.cfg = params, cfg
        self.table, self.attn_impl = routing_table, attn_impl
        self.cache = KVCache.zeros(
            cfg, batch, cache_len, quantized=kv_quant, device=self.device,
            kv_heads=local_kv_heads(params, cfg))
        self.tokens = torch.zeros(batch, dtype=torch.int64,
                                  device=self.device)
        self.kv_lens = torch.ones(batch, dtype=torch.int32,
                                  device=self.device)
        self.logits = None  # [B, V] fp32, made by the first step
        self.graph = None
        self.k2 = None  # the capture's flash_decode.CaptureRecord
        self._pinned = None  # host staging of host inputs, and its event

    def __call__(self, tokens, kv_lens) -> torch.Tensor:
        """The step's fp32 logits [B, V] for ``tokens`` [B] written at
        positions ``kv_lens`` [B] (tensors or host arrays): the static
        buffer, rewritten by the next call."""
        self._load(tokens, kv_lens)
        if self.device.type != "cuda":
            logits = self._step()
            if self.logits is None:
                self.logits = torch.empty_like(logits)
            self.logits.copy_(logits)
            return self.logits
        if self.graph is None:
            self._capture()  # this step runs as the capture's warm-up
        else:
            self.replay()
        return self.logits

    def replay(self) -> None:
        """Replay the captured step on the current stream, counting the K2
        launches it runs."""
        self.graph.replay()
        DecodeGraph.replays += 1
        flash_decode.flash_decode_attention.launches += len(
            self.k2.launches)

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
        with torch.no_grad():
            return _decode_step(self.params, self.cfg, self.cache,
                                self.tokens, self.kv_lens, self.table,
                                self.attn_impl)[0]

    def _capture(self) -> None:
        """Run the step once eagerly on a side stream (the warm-up a
        capture needs), keep its logits as this step's, then capture the
        step on that stream without running it: each call runs the step
        once, so launch counts stay one per step."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self._step()
        if self.logits is None:
            self.logits = torch.empty(warm.shape, dtype=warm.dtype,
                                      device=self.device)
        graph = torch.cuda.CUDAGraph()
        # thread-local mode: other threads may use the card meanwhile
        with flash_decode.capturing() as record, torch.cuda.stream(side):
            side.wait_stream(current)  # the static logits' allocation
            self.logits.copy_(warm)
            del warm
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.logits.copy_(self._step())
            finally:
                graph.capture_end()
        current.wait_stream(side)
        self.graph, self.k2 = graph, record
        DecodeGraph.captures += 1


def graph_key(params, cfg: ModelConfig, batch: int, cache_len: int,
              kv_quant: bool, routing_table, attn_impl: str):
    """What a graph reads: its params' leaves by identity (a graph keeps
    them referenced, so an id is never reused while it lives), the routing
    table by value, the config, the cache's shape, and the grad mode its
    buffers were made in (an inference tensor is written only in
    inference mode)."""
    table = None
    if routing_table is not None:
        t = routing_table.detach().cpu().numpy()
        table = (t.shape, t.tobytes())
    leaves = tuple(id(leaf) for _, leaf in tree_leaves(params))
    return (leaves, table, id(cfg), batch, cache_len, bool(kv_quant),
            attn_impl, torch.is_inference_mode_enabled())


class DecodeGraphs:
    """At most ``limit`` decode graphs, each with its cache, the least
    recently used dropped first."""

    def __init__(self, limit: int = 2):
        if limit < 1:
            raise ValueError(f"limit {limit} < 1")
        self.limit = limit
        self._graphs: "OrderedDict[tuple, DecodeGraph]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        self._graphs.clear()

    def get(self, params, cfg: ModelConfig, batch: int, cache_len: int, *,
            kv_quant: bool = False, routing_table=None,
            attn_impl: str = "auto") -> DecodeGraph:
        """The graph of this step and cache shape, made (and the oldest
        dropped) when there is none."""
        key = graph_key(params, cfg, batch, cache_len, kv_quant,
                        routing_table, attn_impl)
        graph = self._graphs.pop(key, None)
        if graph is None:
            while len(self._graphs) >= self.limit:
                self._graphs.popitem(last=False)
            graph = DecodeGraph(params, cfg, batch, cache_len,
                                kv_quant=kv_quant,
                                routing_table=routing_table,
                                attn_impl=attn_impl)
        self._graphs[key] = graph
        return graph
