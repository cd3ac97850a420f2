"""Continuous batching: requests join a running packed generation
(counterpart of modelcompose_tpu/serve/slot_engine.py).

A fixed pool of ``max_slots`` decode slots shares one preallocated KV cache
on the device.  An arrival is prefilled batch-1, its cache spliced into a
free slot in place, and from the next tick it decodes alongside the
requests already in flight.  A decode step costs about the same whether it
steps 1 slot or 8 (the weights' reads and the host's launches are the
same), so admission mid-flight turns that slack into throughput.

Greedy tokens of a slot equal a solo run of the same request: rows are
independent under per-row kv_len masking (tests/test_torch_slot_engine.py).

Chunked admission (``prefill_chunk=N``, worker ``--prefill-chunk``): the
admission's prefill runs in N-position pieces and the slots in flight get a
decode tick between pieces (core/generate.prefill_chunked), so an
admission stalls them for one chunk, not the whole prompt.

Every tensor lives on the model's device, which is the card unless the
caller asks for the CPU.  The pool is made and changed only inside
``torch.inference_mode()`` (grad mode is per thread: the scheduler thread
enters it itself).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.llama import KVCache
from ..core.sampling import entropy_seed, sample_step
from ..devices import resolve_device

POOL, ADMIT = "pool", "admit"  # the backbone's cache names


class SlotDecoder:
    """Model-side half: the pooled cache and the per-slot decode state.

    The backbone calls go through the model's ``ServingBackbone``
    (``model.serving``): under tensor parallelism this decoder runs on the
    leader rank and every prefill, splice and tick is mirrored to the
    followers, which hold their shard of the pool."""

    def __init__(self, model, max_slots: int = 8, cache_len: int = 1024,
                 kv_quant: bool = False, prefill_chunk=None, device=None):
        device = resolve_device(device)
        if device.type != model.device.type or device.index not in (
                None, model.device.index):
            raise ValueError(f"model on {model.device}, slot pool asked on "
                             f"{device}")
        self.device = model.device
        self.model = model
        self.cfg = model.cfg
        self.backbone = model.serving
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.kv_quant = kv_quant
        # Chunked admission composes with an int8 pool: each chunk is
        # quantized at append time into an int8 transient, and the splice
        # copies the int8 rows.
        self.prefill_chunk = prefill_chunk
        with torch.inference_mode():
            self.backbone.new_cache(POOL, max_slots, cache_len, kv_quant)
            self.logits = torch.zeros((max_slots, self.cfg.vocab_size),
                                      dtype=torch.float32, device=self.device)
        self.kv_lens = np.ones(max_slots, np.int64)  # host-owned
        self.active = np.zeros(max_slots, bool)  # host-owned

    @property
    def cache(self) -> KVCache:
        """The pooled cache (this rank's heads)."""
        return self.backbone.caches[POOL]

    @torch.inference_mode()
    def admit(self, slot: int, input_ids, modal_inputs,
              tick_cb=None) -> int:
        """Prefill one request and splice it into ``slot``; returns its
        prompt length (its kv_len).  Raises when the prompt alone does not
        fit the slot cache; the engine clamps the token budget to
        ``cache_len - L`` so decode never writes past the buffer."""
        # Pack at the smallest standard bucket (a short prompt then stalls
        # the running ticks for less); fall back to the slot-cache length
        # when that bucket exceeds it or no standard bucket holds the
        # prompt (the fallback encodes the media again).
        plan = None
        try:
            feats, plan = self.model.pack([input_ids], modal_inputs)
        except ValueError:
            pass
        if plan is None or plan.segment_ids.shape[1] > self.cache_len:
            try:
                feats, plan = self.model.pack(
                    [input_ids], modal_inputs, bucket_len=self.cache_len)
            except ValueError as e:
                raise ValueError(
                    f"prompt does not fit the slot cache "
                    f"({self.cache_len}): {e}") from e
        L = int(plan.lengths[0])
        if self.cache_len - L < 1:
            raise ValueError(
                f"prompt ({L} packed positions) exceeds the slot cache "
                f"({self.cache_len})")
        logits1 = self.backbone.prefill(
            ADMIT, feats, plan, self.cache_len, kv_quant=self.kv_quant,
            chunk=self.prefill_chunk, tick_cb=tick_cb)
        self.backbone.splice(POOL, ADMIT, slot)
        self.logits[slot] = logits1[0]
        self.kv_lens[slot] = L
        self.active[slot] = True
        return L

    @torch.inference_mode()
    def step(self, tokens: np.ndarray) -> None:
        """Advance every slot one token.  ``tokens``: [max_slots] ids (an
        idle slot feeds a dummy token; its row is rewritten at the next
        admission).  Only active rows advance their kv_len: an idle row
        stays pinned at 1 however long it idles, so its RoPE position and
        attention span never grow.  The logits are copied out of the
        backbone's (a decode graph's static buffer, which the next tick
        rewrites), so an admission's row written here stays this
        decoder's."""
        self.logits.copy_(self.backbone.decode(POOL, tokens, self.kv_lens))
        self.kv_lens = np.where(self.active, self.kv_lens + 1, 1)

    def host_logits(self) -> np.ndarray:
        return self.logits.float().cpu().numpy()

    @torch.inference_mode()
    def sample(self, generator: torch.Generator, temps: np.ndarray,
               top_ps: np.ndarray) -> np.ndarray:
        """Every slot's next token drawn on the device (temperature and
        HF-exact top-p, greedy rows bit-identical to argmax;
        core/sampling); only the [max_slots] ids come to the host."""
        return sample_step(
            generator, self.logits,
            torch.as_tensor(temps, dtype=torch.float32, device=self.device),
            torch.as_tensor(top_ps, dtype=torch.float32, device=self.device)
        ).cpu().numpy()

    def release(self, slot: int) -> None:
        """Mark the slot idle and pin its kv_len back to 1 (``step`` keeps
        it there)."""
        self.kv_lens[slot] = 1
        self.active[slot] = False


class ContinuousBatchingEngine:
    """The worker's engine under ``--continuous-batching`` (the
    ``BatchingEngine`` API: ``submit`` returns an events queue): a
    scheduler thread admits arrivals into free slots between decode ticks
    and puts ("token", id) / ("done", None) / ("error", exc) per request."""

    def __init__(self, model, prepare, max_slots: int = 8,
                 cache_len: int = 1024, kv_quant: bool = False,
                 rng_seed: Optional[int] = None, prefill_chunk=None,
                 device=None):
        self.decoder = SlotDecoder(model, max_slots, cache_len, kv_quant,
                                   prefill_chunk=prefill_chunk, device=device)
        # prepare: request -> (ids, modal_inputs, max_new, temp[, top_p])
        self.prepare = prepare
        self.eos = model.cfg.eos_token_id
        self._queue: "queue.Queue" = queue.Queue()
        self._slots: Dict[int, Dict[str, Any]] = {}
        self._generator = torch.Generator(device=self.decoder.device)
        self._generator.manual_seed(
            rng_seed if rng_seed is not None else entropy_seed())
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: dict) -> "queue.Queue":
        events: "queue.Queue" = queue.Queue()
        if self._stop.is_set():  # a submit after stop fails fast
            events.put(("error", RuntimeError("engine stopped")))
            return events
        self._queue.put((request, events))
        return events

    def stop(self, timeout: float = 5.0) -> None:
        """End the scheduler thread (idempotent).  Requests in flight and
        still queued get ("error", RuntimeError); later submits fail
        fast."""
        self._stop.set()
        self._thread.join(timeout)
        err = RuntimeError("engine stopped")
        while True:  # submitted but never admitted
            try:
                _, events = self._queue.get_nowait()
            except queue.Empty:
                break
            events.put(("error", err))
        if self._thread.is_alive():
            # the join timed out inside a device call: the scheduler still
            # owns the slots; the stop flag ends its loop when it returns
            return
        for slot, st in list(self._slots.items()):
            st["events"].put(("error", err))
            self.decoder.release(slot)
        self._slots.clear()

    # ------------------------------------------------------------------
    def _admit_pending(self, block: bool) -> None:
        while len(self._slots) < self.decoder.max_slots:
            try:
                request, events = self._queue.get(
                    timeout=0.05 if block and not self._slots else 0)
            except queue.Empty:
                return
            cancel = request.get("_cancel")
            if cancel is not None and cancel.is_set():
                events.put(("done", None))  # the client left before admission
                continue
            slot = next(s for s in range(self.decoder.max_slots)
                        if s not in self._slots)
            try:
                prepared = self.prepare(request)
                ids, modal_inputs, max_new, temp = prepared[:4]
                top_p = prepared[4] if len(prepared) > 4 else 1.0
                if max_new <= 0:
                    events.put(("done", None))
                    continue
                # A tick's failure belongs to the slots in flight, not to
                # the admitting request: the guarded tick keeps it out of
                # this request's error handler.
                tick = self._guarded_tick \
                    if self.decoder.prefill_chunk else None
                L = self.decoder.admit(slot, ids, modal_inputs,
                                       tick_cb=tick)
                max_new = min(max_new, self.decoder.cache_len - L)
            except Exception as e:  # noqa: BLE001 — surface per request
                events.put(("error", e))
                continue
            self._slots[slot] = {"events": events, "generated": 0,
                                 "max_new": max_new, "temp": temp,
                                 "top_p": top_p, "cancel": cancel}
            block = False

    def _loop(self) -> None:
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    self._tick()
                except Exception as e:  # noqa: BLE001 — device errors
                    # reach every request in flight; the scheduler lives on
                    # (a dead thread would hang every later submit)
                    self._fail_slots(e)

    def _fail_slots(self, e: Exception) -> None:
        for slot, st in self._slots.items():
            st["events"].put(("error", e))
            # release the row too, or its kv_len keeps advancing
            self.decoder.release(slot)
        self._slots.clear()

    def _tick(self) -> None:
        self._admit_pending(block=True)
        self._advance_slots()

    def _guarded_tick(self) -> None:
        try:
            self._advance_slots()
        except Exception as e:  # noqa: BLE001 — device errors
            self._fail_slots(e)

    def _advance_slots(self) -> None:
        if not self._slots:
            return
        # one draw on the device for every slot (idle rows greedy), then
        # the host loop sees only token ids
        temps = np.zeros(self.decoder.max_slots, np.float32)
        top_ps = np.ones(self.decoder.max_slots, np.float32)
        for slot, st in self._slots.items():
            temps[slot] = st["temp"]
            top_ps[slot] = st["top_p"]
        sampled = self.decoder.sample(self._generator, temps, top_ps)
        tokens = np.zeros(self.decoder.max_slots, np.int32)
        for slot in list(self._slots):
            st = self._slots[slot]
            if st["cancel"] is not None and st["cancel"].is_set():
                self._finish(slot)
                continue
            tok = int(sampled[slot])
            tokens[slot] = tok
            if self.eos is not None and tok == self.eos:
                self._finish(slot)
                continue
            st["events"].put(("token", tok))
            st["generated"] += 1
            if st["generated"] >= st["max_new"]:
                self._finish(slot)
        if not self._slots:
            return
        self.decoder.step(tokens)

    def _finish(self, slot: int) -> None:
        self._slots.pop(slot)["events"].put(("done", None))
        self.decoder.release(slot)
