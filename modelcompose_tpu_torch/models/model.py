"""Top-level multimodal LM: towers + projectors + routed backbone + packing
(counterpart of modelcompose_tpu/models/model.py).

The class is a thin host-side container (params, configs, towers); all
tensor work is in plain functions.  Pipeline per batch:

1. ``encode_modal_inputs``: each modality's frozen tower and its
   projector, with the prefix/suffix soft tokens attached;
2. ``core.packing.plan_pack``: the host-side static-shape splice plan;
3. ``assemble_embeds`` and the routed prefill + decode (greedy, sampled
   or beam search), or the forward and ``causal_lm_loss`` for training.

On the card the towers, the prefill and the decode steps run as captured
CUDA graphs the model keeps (``tower_graphs``, ``prefill_graphs``,
``decode_graphs``); setting ``tower_graphs`` or ``prefill_graphs`` to None
runs that step launch by launch (the functions' ``graphs=None`` path).

Only the towers run without gradient: the projector and the soft tokens
train, as in the JAX package (which stops the gradient at the tower
output).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..constants import IGNORE_INDEX
from ..core import generate as generation
from ..core.beam import beam_generate
from ..core.decode_graph import DecodeGraphs
from ..core.llama import forward, init_params, torch_dtype
from ..core.packing import PackPlan, assemble_embeds, plan_pack
from ..core.prefill_graph import PrefillGraphs
from ..core.sampling import entropy_seed
from ..devices import resolve_device
from ..ops.routed_lora import (active_adapter_set, as_table,
                               compact_active_adapters)
from ..parallel import tp
from ..parallel.serving import ServingBackbone
from .projectors import apply_projector, init_projector, output_len
from .towers import TowerGraphs, build_modal_encoders


STREAM = "stream"  # generate_stream's cache in the served backbone
DECODE_GRAPHS = 2  # the decode graphs (each with its cache) a model keeps


class MultimodalLM:
    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 encoders: Dict[str, Any],
                 projectors: Dict[str, Dict[str, Any]]):
        self.cfg = cfg
        # the decode graphs of generate / generate_stream (their caches and
        # prefill graphs included) and the prefill graphs on caches of
        # their own, least recently used dropped first; new params drop
        # them all
        self.decode_graphs = DecodeGraphs(DECODE_GRAPHS)
        self.prefill_graphs = PrefillGraphs()
        # the towers' encodes (keyed by the towers' own leaves)
        self.tower_graphs = TowerGraphs()
        self.params = params
        self.encoders = encoders
        self.projectors = projectors
        self.routing_table = cfg.routing_table()
        self._compact_cache: Dict[Tuple[int, ...], Any] = {}
        # the model group of sharded params (parallel.mesh
        # .apply_tensor_parallel); every backbone call runs in its tp.scope
        self.tp_group = None
        self._serving = None

    @classmethod
    def random_init(cls, cfg: ModelConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> "MultimodalLM":
        """Random weights made on ``device`` (the card when None) from
        ``generator``, which must live there (seed 0 when none is given)."""
        device = resolve_device(device)
        if generator is not None and generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, weights on "
                             f"{device}")
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        params = init_params(cfg, generator, device)
        encoders = build_modal_encoders(cfg, generator, device)
        projectors = {
            modal: init_projector(cfg.projector_type(modal), generator,
                                  encoders[modal].hidden_size,
                                  cfg.hidden_size,
                                  dtype=torch_dtype(cfg.dtype), device=device)
            for modal in cfg.modalities()}
        return cls(cfg, params, encoders, projectors)

    @property
    def params(self) -> Dict[str, Any]:
        return self._params

    @params.setter
    def params(self, params: Dict[str, Any]) -> None:
        self._params = params
        self.decode_graphs.clear()  # they read the old tensors
        if self.prefill_graphs is not None:
            self.prefill_graphs.clear()

    @property
    def device(self) -> torch.device:
        return self.params["embed_tokens"].device

    def decode_routing_table(self) -> Optional[torch.Tensor]:
        """Routing table for decode steps, or None when the default row is
        all zero (dense-folded params): decode then skips the adapter
        branch instead of multiplying every LoRA stack by zero."""
        table = np.asarray(self.routing_table)
        return as_table(table, self.device) if table[0].any() else None

    def modal_processors(self) -> Dict[str, Any]:
        return {m: enc.modal_processor for m, enc in self.encoders.items()}

    def feature_span_len(self, modal: str) -> int:
        """Packed span of one instance: projector output (video frames
        flattened) + prefix/suffix."""
        enc = self.encoders[modal]
        t = enc.feature_len
        if modal == "video":
            t = enc.num_frames * enc.tokens_per_frame
        t_out = output_len(self.cfg.projector_type(modal), t)
        return t_out + self.cfg.prefix_len(modal) + self.cfg.suffix_len(modal)

    def encode_tower(self, modal: str, raw) -> torch.Tensor:
        """One modality's frozen tower, without gradient: [n, T, d].

        Audio takes the fbank alone, a ``(fbank, padding_mask)`` pair or an
        ``{"audio_inputs", "audio_padding_mask"}`` dict; BEATs' frame mask
        is discarded, as the reference discards it.  Video [n, t, N, d] is
        flattened to [n, t*N, d].  The encode runs through the tower's
        graph of ``tower_graphs`` (eagerly when that is None)."""
        enc = self.encoders[modal]
        graphs = self.tower_graphs

        def encode(*args, **kwargs):
            if graphs is None:
                return enc.encode(*args, **kwargs)
            return graphs.encode(enc, *args, **kwargs)
        with torch.no_grad():
            if modal == "audio":
                if isinstance(raw, dict):
                    out = encode(**raw)
                elif isinstance(raw, tuple):
                    out = encode(*raw)
                else:
                    out = encode(raw)
                return out[0] if isinstance(out, tuple) else out
            x = encode(raw)
            if modal == "video":
                b, t, n, d = x.shape
                x = x.reshape(b, t * n, d)
            return x

    def encode_modal_inputs(self, modal_inputs: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
        """{modal: normalized raw inputs} -> {modal: [n, span, H]}
        projected features with the prefix/suffix soft tokens attached.
        The frozen tower runs without gradient; the projector and the soft
        tokens are differentiable."""
        feats: Dict[str, torch.Tensor] = {}
        for modal, raw in modal_inputs.items():
            x = self.encode_tower(modal, raw)
            feats[modal] = attach_soft_tokens(
                self.params, modal,
                apply_projector(self.cfg.projector_type(modal),
                                self.projectors[modal], x))
        return feats

    def pack(self, input_ids: Sequence[np.ndarray],
             modal_inputs: Dict[str, Any],
             labels: Optional[Sequence[np.ndarray]] = None,
             bucket_len: Optional[int] = None
             ) -> Tuple[Dict[str, torch.Tensor], PackPlan]:
        """The towers, projectors and the host pack plan, without the
        embedding lookup: (features by modality, plan)."""
        feats = self.encode_modal_inputs(modal_inputs)
        feat_spans = {m: (int(f.shape[0]), int(f.shape[1]))
                      for m, f in feats.items()}
        plan = plan_pack(list(input_ids), feat_spans, labels=labels,
                         bucket_len=bucket_len)
        return feats, plan

    def prepare_batch(self, input_ids: Sequence[np.ndarray],
                      modal_inputs: Dict[str, Any],
                      labels: Optional[Sequence[np.ndarray]] = None,
                      bucket_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, PackPlan]:
        feats, plan = self.pack(input_ids, modal_inputs, labels, bucket_len)
        with tp.scope(self.tp_group):
            embeds = assemble_embeds(self.params["embed_tokens"], plan, feats)
        return embeds, plan

    @property
    def serving(self):
        """The model's ``parallel.serving.ServingBackbone``, made at first
        use over ``tp_group``: the serving engines' backbone calls,
        mirrored to the followers of a tensor-parallel group."""
        if self._serving is None:
            self._serving = ServingBackbone(self)
        return self._serving

    def generate(self, input_ids: Sequence[np.ndarray],
                 modal_inputs: Dict[str, Any], max_new_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0,
                 num_beams: int = 1,
                 generator: Optional[torch.Generator] = None,
                 bucket_len: Optional[int] = None, attn_impl: str = "auto",
                 compact_adapters: bool = False, fold_decode=False,
                 kv_quant: bool = False, device_loop: bool = True,
                 timings: Optional[dict] = None) -> List[List[int]]:
        """Answers for a batch of prompts (EOS excluded): greedy, sampled
        (``temperature > 0``, ``top_p``, draws from ``generator`` on the
        model's device), or beam search / beam sampling for one prompt
        (``num_beams > 1``, as HF dispatches it).

        ``fold_decode`` and ``kv_quant`` select the decode variant of
        greedy and sampled decode (see core.generate.generate); beam
        search decodes over a bf16 cache, as the JAX package's does.
        ``device_loop`` (core.generate.generate's) decodes through the
        model's ``decode_graphs``, under ``tp_group`` too (its collectives
        captured in the graphs).  The towers and the prefill run through
        ``tower_graphs`` and ``prefill_graphs``.
        ``timings`` receives the seconds of the towers, projectors and
        packing ('encode_s'), of the prefill and of the decode."""
        with torch.no_grad(), tp.scope(self.tp_group):
            t0 = generation._sync_clock(self.device) if timings is not None \
                else 0.0
            embeds, plan = self.prepare_batch(input_ids, modal_inputs,
                                              bucket_len=bucket_len)
            if timings is not None:
                timings["encode_s"] = generation._sync_clock(self.device) - t0
            route_ids = plan.route_ids if self.cfg.routing_active() else None
            params, table = self.params, self.routing_table
            if compact_adapters and route_ids is not None:
                params, table = self._compacted(np.unique(route_ids))
            if num_beams and num_beams > 1:
                # scoring length = the raw text ids (modal placeholders
                # unexpanded), matching HF's input_ids-based normalization
                return beam_generate(
                    params, self.cfg, embeds, lengths=plan.lengths,
                    route_ids=route_ids, routing_table=table,
                    segment_ids=plan.segment_ids, num_beams=num_beams,
                    max_new_tokens=max_new_tokens,
                    scoring_prompt_len=len(np.asarray(input_ids[0])),
                    temperature=temperature, top_p=top_p,
                    generator=generator, attn_impl=attn_impl,
                    device_loop=device_loop, graphs=self.decode_graphs,
                    prefill_graphs=self.prefill_graphs, timings=timings)
            return generation.generate(
                params, self.cfg, embeds, lengths=plan.lengths,
                route_ids=route_ids, routing_table=table,
                segment_ids=plan.segment_ids, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, generator=generator,
                attn_impl=attn_impl, device_loop=device_loop,
                fold_decode=fold_decode, kv_quant=kv_quant,
                graphs=self.decode_graphs,
                prefill_graphs=self.prefill_graphs, timings=timings)

    def generate_stream(self, input_ids: Sequence[np.ndarray],
                        modal_inputs: Dict[str, Any], *,
                        max_new_tokens: Sequence[int],
                        temperatures: Sequence[float], emit,
                        rng_seed: Optional[int] = None,
                        bucket_len: Optional[int] = None,
                        cancelled=None, top_ps=None) -> None:
        """Batched streaming decode (the serving worker's micro-batch): one
        packed prefill, then each row's tokens emitted the step they decode,
        as ``emit(i, ("token", id))`` and one ``emit(i, ("done", None))``;
        per-row ``max_new_tokens``, temperature, top-p and EOS are honoured,
        and a row whose ``cancelled(i)`` turns true is masked done (the
        batch stops once every row is).  Draws come from a
        ``torch.Generator`` on the model's device seeded by ``rng_seed``,
        else by OS entropy; the loop is ``core.generate.stream_decode``
        over ``serving``'s prefill and decode."""
        if all(n <= 0 for n in max_new_tokens):  # nothing to encode
            for i in range(len(input_ids)):
                emit(i, ("done", None))
            return
        generator = torch.Generator(device=self.device).manual_seed(
            rng_seed if rng_seed is not None else entropy_seed())
        backbone = self.serving
        with torch.no_grad():
            feats, plan = self.pack(input_ids, modal_inputs,
                                    bucket_len=bucket_len)
            try:
                generation.stream_decode(
                    lambda cache_len: backbone.prefill(
                        STREAM, feats, plan, cache_len, decode_graph=True),
                    lambda tokens, kv_lens: backbone.decode(STREAM, tokens,
                                                            kv_lens),
                    plan.segment_ids.shape[1], plan.lengths, cfg=self.cfg,
                    emit=emit, max_new_tokens=list(max_new_tokens),
                    temperatures=list(temperatures), top_ps=top_ps,
                    generator=generator, cancelled=cancelled,
                    device=self.device)
            finally:
                backbone.free(STREAM)

    def loss(self, input_ids: Sequence[np.ndarray],
             labels: Sequence[np.ndarray], modal_inputs: Dict[str, Any],
             bucket_len: Optional[int] = None,
             attn_impl: str = "auto") -> torch.Tensor:
        """Mean shifted CE over the labelled positions of a packed batch,
        differentiable in the backbone, projector and soft tokens."""
        embeds, plan = self.prepare_batch(input_ids, modal_inputs,
                                          labels=labels,
                                          bucket_len=bucket_len)
        route_ids = plan.route_ids if self.cfg.routing_active() else None
        with tp.scope(self.tp_group):
            logits, _ = forward(
                self.params, self.cfg, embeds, route_ids=route_ids,
                routing_table=self.routing_table,
                segment_ids=torch.as_tensor(plan.segment_ids,
                                            device=embeds.device),
                attn_impl=attn_impl)
        return causal_lm_loss(logits, torch.as_tensor(plan.labels,
                                                      device=embeds.device))

    def _compacted(self, route_classes):
        """Adapter stacks gathered to the columns the batch's route classes
        can reach, cached per active set (an eval run's modality mix is
        constant, so the gather happens once)."""
        active = active_adapter_set(self.routing_table, route_classes)
        if active not in self._compact_cache:
            self._compact_cache[active] = compact_active_adapters(
                self.params, self.routing_table, active)
        return self._compact_cache[active]


def attach_soft_tokens(params: Dict[str, Any], modal: str,
                       x: torch.Tensor) -> torch.Tensor:
    """[n, T, H] projected features -> [n, prefix + T + suffix, H] in the
    embedding dtype, with the modality's learned soft tokens."""
    b = x.shape[0]
    parts = []
    prefix = (params.get("prefix_tokens") or {}).get(modal)
    suffix = (params.get("suffix_tokens") or {}).get(modal)
    if prefix is not None:
        parts.append(prefix[None].expand(b, *prefix.shape))
    parts.append(x.to(params["embed_tokens"].dtype))
    if suffix is not None:
        parts.append(suffix[None].expand(b, *suffix.shape))
    return torch.cat(parts, dim=1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   denom=None) -> torch.Tensor:
    """Shifted CE with IGNORE_INDEX masking, the mean over valid targets
    (the JAX package's ``causal_lm_loss``), or their sum over ``denom``
    where given (a data-parallel group's count of valid targets)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if denom is None:
        denom = valid.sum().clamp_min(1)
    return (nll * valid).sum() / denom
