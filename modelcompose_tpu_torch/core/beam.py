"""Beam-search decoding over the preallocated KV cache (counterpart of
modelcompose_tpu/core/beam.py).

HF ``generate(num_beams=N)`` as transformers 4.31 runs it (the
reference's pinned version), with beams as a batch dimension: one batch-1
routed prefill into a bf16 cache, the cache tiled to ``num_beams`` rows,
then batched decode steps with the parent-beam gather done in place on the
cache; only [num_beams, V] logits cross to the host per step.

The scorer is transcribed from 4.31 ``beam_search``/``BeamSearchScorer``/
``BeamHypotheses`` and runs on the host in float64 numpy, line for line as
the JAX package's:

- candidate scores: ``log_softmax(logits) + beam_score``, top ``2B`` of the
  flattened [B * V] scores (stable order on ties);
- an EOS candidate ranked below ``num_beams`` finalizes that beam's
  hypothesis (tokens without the eos, score including its logprob); lower
  ranked EOS candidates are dropped; non-EOS candidates fill the next
  ``num_beams`` running beams in score order;
- hypothesis score: ``sum_logprobs / len**length_penalty`` with ``len``
  counting the raw text prompt ids plus generated tokens
  (``scoring_prompt_len``: HF's ``input_ids`` never expand the modal
  placeholders);
- early_stopping=False convergence: done when the worst kept hypothesis
  already beats ``best_running / cur_len**length_penalty``;
- at max length the running beams become hypotheses; the best returns.

``num_beams == 1`` callers should use ``generate`` (HF dispatches beam=1
to greedy search).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.routed_lora import as_table
from .decode_graph import DecodeGraphs
from .generate import _decode_step, _prepare, _sync_clock
from .llama import KVCache
from .prefill_graph import PrefillGraphs, prefill
from .sampling import gumbel, top_p_filter


def _tile_beams(cache: KVCache, num_beams: int,
                out: Optional[KVCache] = None) -> KVCache:
    """A batch-1 cache tiled to ``num_beams`` rows on axis 1 of the
    layer-stacked [N, B, S, Hkv, D] tensors: fresh contiguous buffers, or
    ``out`` (a ``num_beams``-row cache of the same length, a decode
    graph's) overwritten in place."""
    if out is not None:
        for dst, src in zip(out.tensors(), cache.tensors()):
            dst.copy_(src.expand_as(dst))
        return out

    def tile(x):
        return x.repeat(1, num_beams, *([1] * (x.dim() - 2)))

    def part(p):
        return {k: tile(v) for k, v in p.items()} if isinstance(p, dict) \
            else tile(p)
    return KVCache(k=part(cache.k), v=part(cache.v))


def _gather_beams(cache: KVCache, beam_idx: torch.Tensor, start: int = 0,
                  stop: Optional[int] = None) -> None:
    """Reorder the cache's rows by parent-beam index, IN PLACE (HF's
    ``_reorder_cache`` ``index_select`` on axis 1), over positions
    [start, stop).

    The buffers stay where they are: K2 keeps its encoded tensor maps keyed
    by the cache's base pointer and shape, so a fresh cache every step
    would re-encode them every step.  Beam search passes ``start`` = the
    prompt length: every beam's prompt rows come from the one tiled
    prefill and are never rewritten, so reordering them changes nothing.
    """
    for t in cache.tensors():
        view = t[:, :, start:stop]
        view.copy_(view.index_select(1, beam_idx))


class _BeamHypotheses:
    """transformers 4.31 BeamHypotheses, transcribed."""

    def __init__(self, num_beams: int, length_penalty: float,
                 early_stopping: bool):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.early_stopping = early_stopping
        self.beams: List[tuple] = []  # (score, tokens)
        self.worst_score = 1e9

    def __len__(self):
        return len(self.beams)

    def add(self, tokens: List[int], sum_logprobs: float, hyp_len: int):
        score = sum_logprobs / (hyp_len ** self.length_penalty)
        if len(self) < self.num_beams or score > self.worst_score:
            self.beams.append((score, tokens))
            if len(self) > self.num_beams:
                worst = min(range(len(self.beams)),
                            key=lambda i: self.beams[i][0])
                del self.beams[worst]
                self.worst_score = min(s for s, _ in self.beams)
            else:
                self.worst_score = min(score, self.worst_score)

    def is_done(self, best_sum_logprobs: float, cur_len: int) -> bool:
        if len(self) < self.num_beams:
            return False
        if self.early_stopping:
            return True
        return self.worst_score >= best_sum_logprobs / (
            cur_len ** self.length_penalty)


def beam_generate(params, cfg: ModelConfig, inputs_embeds, *, lengths,
                  route_ids=None, routing_table=None, segment_ids=None,
                  num_beams: int = 3, max_new_tokens: int = 128,
                  eos_token_id: Optional[int] = None,
                  length_penalty: float = 1.0, early_stopping: bool = False,
                  scoring_prompt_len: Optional[int] = None,
                  cache_len: Optional[int] = None,
                  attn_impl: str = "auto",
                  temperature: float = 0.0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  device_loop: bool = True,
                  graphs: Optional[DecodeGraphs] = None,
                  prefill_graphs: Optional[PrefillGraphs] = None,
                  timings: Optional[dict] = None,
                  _draw_override=None) -> List[List[int]]:
    """Beam-search decode for one packed prompt (batch 1).

    Args mirror ``generate``; ``scoring_prompt_len`` is the raw text prompt
    length used for HF-compatible length normalization (defaults to the
    packed valid length, which matches HF only for text-only prompts).
    Returns ``[best_tokens]`` (eos excluded), like generate.

    temperature > 0 runs stochastic beam sampling, 4.31 ``beam_sample``:
    the candidate scores (logprob + running beam score) are divided by the
    temperature and top-p filtered per beam row, softmaxed over the
    flattened [beams*V], and 2*num_beams candidates drawn without
    replacement (Gumbel top-k, uniforms from ``generator``), then sorted by
    warped score and fed to the same scorer; the warped values become the
    running beam scores (4.31's accumulation, kept for parity).
    ``_draw_override`` is a test hook: per-step arrays of flat candidate
    indices replacing the random draw, so the bookkeeping can be held to
    the JAX package's across RNGs.  ``device_loop`` and ``graphs`` are
    ``generate``'s: a step replays a graph of ``num_beams`` rows whose
    cache the prompt's is tiled into (the parent-beam gather reorders that
    cache in place).  ``prefill_graphs`` is ``generate``'s too.
    ``timings`` receives 'prefill_s' and 'decode_s'.
    """
    if inputs_embeds.shape[0] != 1:
        raise ValueError("beam_generate packs one prompt (the eval protocol)")
    if num_beams < 2:
        raise ValueError("use generate() for num_beams == 1 (HF greedy)")
    device = inputs_embeds.device
    cache_len, lengths, segment_ids, route_ids = _prepare(
        inputs_embeds, lengths, segment_ids, route_ids, max_new_tokens,
        cache_len)
    if routing_table is not None:
        routing_table = as_table(routing_table, device)
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    valid_len = int(lengths[0])
    prompt_len = valid_len if scoring_prompt_len is None \
        else int(scoring_prompt_len)

    # decode runs the default route only (reference decode semantics);
    # beam rows share it
    decode_table = routing_table
    if routing_table is not None and not bool(routing_table[0].any()):
        decode_table = None
    graph = None
    if device_loop and max_new_tokens > 1:  # a step to decode
        if graphs is None:
            graphs = DecodeGraphs(1)
        graph = graphs.get(params, cfg, num_beams, cache_len,
                           routing_table=decode_table, attn_impl=attn_impl)

    t0 = _sync_clock(device) if timings is not None else 0.0
    # the prompt's cache has one row: no decode graph reads it, so it is
    # the prefill graph's own until it is tiled into the beams' cache
    logits, cache = prefill(params, cfg, inputs_embeds, route_ids,
                            routing_table, segment_ids, lengths, cache_len,
                            attn_impl, False, graphs=prefill_graphs)
    if timings is not None:
        t1 = _sync_clock(device)
        timings["prefill_s"] = t1 - t0
    cache = _tile_beams(cache, num_beams,
                        out=None if graph is None else graph.cache)
    logits = logits.repeat(num_beams, 1)
    kv_lens = lengths.repeat(num_beams)

    hyps = _BeamHypotheses(num_beams, length_penalty, early_stopping)
    beam_scores = np.full(num_beams, -1e9, np.float64)
    beam_scores[0] = 0.0
    beam_tokens: List[List[int]] = [[] for _ in range(num_beams)]
    done = False
    do_sample = temperature and temperature > 0.0
    if do_sample and generator is None and _draw_override is None:
        generator = torch.Generator(device=device).manual_seed(0)

    for step_i in range(max_new_tokens):
        host = logits.float().cpu().numpy().astype(np.float64)
        # log_softmax, numerically like torch's
        host = host - host.max(axis=-1, keepdims=True)
        host = host - np.log(np.exp(host).sum(axis=-1, keepdims=True))
        V = host.shape[-1]
        scores = host + beam_scores[:, None]
        if do_sample:
            # 4.31 beam_sample: warp (temperature then top-p) the score
            # rows, softmax over the flattened beams*V, draw 2*num_beams
            # WITHOUT replacement, sort by warped score
            warped = scores / float(temperature)
            if top_p is not None and top_p < 1.0:
                lowest = torch.finfo(torch.float32).min
                warped = top_p_filter(torch.from_numpy(warped).float(),
                                      top_p).double().numpy()
                warped[warped <= lowest] = -np.inf
            flat = warped.reshape(-1)
            if _draw_override is not None:
                drawn = np.asarray(_draw_override[step_i])
            else:
                # Gumbel top-k == categorical sampling w/o replacement.
                # When the combined nucleus holds fewer than 2*num_beams
                # finite entries (sharp temperature + tight top_p), draw
                # only the finite ones — 4.31's torch.multinomial would
                # RAISE here; shrinking the candidate list (the fill loop
                # pads below) is the graceful equivalent.
                noise = gumbel(generator, flat.shape, device)
                z = flat + noise.cpu().numpy().astype(np.float64)
                z[~np.isfinite(flat)] = -np.inf
                n_finite = int(np.isfinite(flat).sum())
                drawn = np.argsort(-z, kind="stable")[
                    : min(2 * num_beams, max(n_finite, 1))]
            order = np.argsort(-flat[drawn], kind="stable")
            top = drawn[order]
        else:
            flat = scores.reshape(-1)
            top = np.argsort(-flat, kind="stable")[: 2 * num_beams]
        cand_scores = flat[top]
        cand_tokens = top % V
        cand_beams = top // V

        cur_len = prompt_len + len(beam_tokens[0])
        next_scores = np.empty(num_beams, np.float64)
        next_tokens = np.empty(num_beams, np.int64)
        next_beams = np.empty(num_beams, np.int64)
        filled = 0
        for rank in range(len(top)):
            tok, sc, src = (int(cand_tokens[rank]), float(cand_scores[rank]),
                            int(cand_beams[rank]))
            if eos is not None and tok == eos:
                if rank >= num_beams:
                    continue
                hyps.add(list(beam_tokens[src]), sc, cur_len)
            else:
                next_scores[filled] = sc
                next_tokens[filled] = tok
                next_beams[filled] = src
                filled += 1
            if filled == num_beams:
                break
        if filled == 0:  # everything drawn was EOS: all beams finalized
            done = True
        while 0 < filled < num_beams:
            # shrunken sampled draw (tight nucleus): replicate the best
            # running candidate so the beam count stays static-shaped
            next_scores[filled] = next_scores[0]
            next_tokens[filled] = next_tokens[0]
            next_beams[filled] = next_beams[0]
            filled += 1
        done = done or hyps.is_done(float(cand_scores.max()), cur_len)
        if done:
            break

        beam_scores = next_scores
        beam_tokens = [beam_tokens[int(b)] + [int(t)]
                       for b, t in zip(next_beams, next_tokens)]
        if step_i == max_new_tokens - 1:
            break  # the last step's logits would never be read
        # rows past the prompt hold this generation's tokens: reorder them
        _gather_beams(cache, torch.as_tensor(next_beams, device=device),
                      valid_len, valid_len + step_i)
        if graph is not None:
            logits = graph(next_tokens, kv_lens)
            kv_lens = kv_lens + 1
        else:
            logits, cache, kv_lens = _decode_step(
                params, cfg, cache, torch.as_tensor(
                    next_tokens, dtype=torch.int32, device=device),
                kv_lens, decode_table, attn_impl)

    if not done:  # max length reached: running beams become hypotheses
        cur_len = prompt_len + len(beam_tokens[0])
        for b in range(num_beams):
            hyps.add(beam_tokens[b], float(beam_scores[b]), cur_len)
    if timings is not None:
        timings["decode_s"] = time.perf_counter() - t1

    best = max(hyps.beams, key=lambda sb: sb[0])[1]
    return [best]
