"""Model worker: loads a composed checkpoint and serves streamed generation
(counterpart of modelcompose_tpu/serve/model_worker.py).

Rebuild of the reference's worker (reference: modelcompose/serve/
model_worker.py:37-243) on aiohttp: registration and 15 s heartbeats
(reference: constants.py:2), a concurrency cap (the engine's
max_batch/max_slots plays the reference semaphore's role), and
``/worker_generate_stream`` producing b"\\0"-delimited JSON chunks.  The
request carries ``modal_inputs: {modal: [base64/np lists]}``, run through
the towers and packed as the eval path packs them, so every modality is
served.  The model lives on the card unless ``--device`` asks for another.

``aiohttp`` is imported only by ``build_app`` and ``main``, ``requests``
only by the registration: ``ModelWorker.generate_stream`` and the engines
run without either.

Usage: python -m modelcompose_tpu_torch.serve.model_worker \\
    --model-path ckpt --model-base vicuna --controller http://...:21001 \\
    --host 0.0.0.0 --port 21002 --worker-address http://...:21002

Tensor-parallel over N GPUs of one host (``--tp N``, one process a GPU):
``torchrun --nproc-per-node N -m modelcompose_tpu_torch.serve.model_worker
--tp N ...``.  Rank 0 serves HTTP, runs the towers, the packing and the
engines, and mirrors every backbone call to the other ranks
(``parallel/serving.py``); they hold their shard and ``follow``.
"""

from __future__ import annotations

import argparse
import base64
import functools
import json
import queue
import threading
import time
import uuid

import numpy as np

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..data.tokenization import tokenizer_modal_token
from ..devices import resolve_device
from ..utils.logging import build_logger

logger = build_logger("model_worker", "model_worker.log")

MAX_NEW_TOKENS_CAP = 1024  # a request's budget is clamped to this


class BatchingEngine:
    """Micro-batching with per-token streaming: requests arriving within a
    small window run as ONE packed generation, and each receives its
    tokens as they decode (the reference's TextIteratorStreamer semantics,
    reference: model_worker.py:122-192, without a thread per request).

    ``stream_batch(requests, emit)`` must call ``emit(i, event)`` with
    events ("token", id) / ("done", None) / ("error", exc) per request.
    """

    def __init__(self, stream_batch, max_batch: int = 8,
                 batch_wait_ms: float = 5.0):
        self.stream_batch = stream_batch
        self.max_batch = max_batch
        self.batch_wait_s = batch_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: dict) -> "queue.Queue":
        events: "queue.Queue" = queue.Queue()
        self._queue.put((request, events))
        return events

    def stop(self, timeout: float = 5.0) -> None:
        """End the batching thread once the batches before it are done
        (their backbone calls included)."""
        self._queue.put(None)
        self._thread.join(timeout)

    def _loop(self):
        while True:
            first = self._queue.get()
            if first is None:
                return
            batch = [first]
            deadline = time.time() + self.batch_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:  # stop after this batch
                    self._queue.put(None)
                    break
                batch.append(item)
            requests = [b[0] for b in batch]
            queues = [b[1] for b in batch]

            def emit(i, event):
                queues[i].put(event)

            try:
                self.stream_batch(requests, emit)
            except Exception as e:  # surface to every request in the batch
                for q in queues:
                    q.put(("error", e))


def _budget(r: dict) -> int:
    return max(0, min(int(r.get("max_new_tokens", 256)), MAX_NEW_TOKENS_CAP))


class ModelWorker:
    def __init__(self, controller_addr, worker_addr, model_path, model_base,
                 model_name=None, limit_concurrency: int = 5,
                 no_register: bool = False, loader=None,
                 continuous_batching: bool = False,
                 slot_cache_len: int = 1024, prefill_chunk=None,
                 slot_kv_quant: bool = False, device=None):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = uuid.uuid4().hex[:6]
        self.device = resolve_device(device)
        if loader is None:
            from ..models.loader import load_pretrained_model
            loader = functools.partial(load_pretrained_model,
                                       device=self.device)
        self.model_name = model_name or model_path.rstrip("/").split("/")[-1]
        (self.tokenizer, self.model, self.modal_processors,
         self.context_len) = loader(model_path, model_base, self.model_name)
        self.queue_length = 0
        self._queue_lock = threading.Lock()
        if prefill_chunk and not continuous_batching:
            logger.warning("--prefill-chunk has no effect without "
                           "--continuous-batching")
        if continuous_batching:
            from .slot_engine import ContinuousBatchingEngine
            self.engine = ContinuousBatchingEngine(
                self.model, self._prepare_request,
                max_slots=limit_concurrency, cache_len=slot_cache_len,
                prefill_chunk=prefill_chunk, kv_quant=slot_kv_quant,
                device=self.device)
        else:
            self.engine = BatchingEngine(self._stream_batch,
                                         max_batch=limit_concurrency)
        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(
                target=self.heart_beat_worker, daemon=True)
            self.heart_beat_thread.start()

    def close(self) -> None:
        """Stop the engine and end the followers of a tensor-parallel
        group (the leader's last backbone call)."""
        stop = getattr(self.engine, "stop", None)
        if stop is not None:
            stop()
        if self.model.serving.mirrored:
            self.model.serving.stop()

    # -- controller plumbing (reference: model_worker.py:75-106) ------
    def register_to_controller(self):
        import requests
        url = self.controller_addr + "/register_worker"
        data = {"worker_name": self.worker_addr, "check_heart_beat": True,
                "worker_status": self.status()}
        r = requests.post(url, json=data, timeout=5)
        assert r.status_code == 200, r.text

    def heart_beat_worker(self):
        import requests
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                r = requests.post(
                    self.controller_addr + "/receive_heart_beat",
                    json={"worker_name": self.worker_addr,
                          "queue_length": self.queue_length},
                    timeout=5)
                # a controller that restarted or swept this worker as
                # stale answers exist=False: register again, or the model
                # drops out of dispatch (reference: model_worker.py:99-106)
                if not r.json().get("exist", True):
                    self.register_to_controller()
            except Exception as e:
                logger.error(f"heart beat error: {e}")

    def status(self):
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.queue_length}

    # -- generation ----------------------------------------------------
    def decode_modal_inputs(self, modal_inputs: dict) -> dict:
        """Request payloads: vision as base64 PNG/JPEG; audio/video/point as
        nested lists or base64 npy."""
        out = {}
        for modal, items in (modal_inputs or {}).items():
            proc = self.modal_processors[modal]
            if modal == "vision":
                from ..data.image_io import load_image
                from ..data.image_processing import process_images
                imgs = [load_image(base64.b64decode(x)) for x in items]
                out[modal] = process_images(imgs, proc,
                                            image_aspect_ratio="pad")
            elif modal == "audio":
                from ..data.audio_processing import collate_audio_inputs
                arrays = [np.asarray(x, np.float32) for x in items]
                out[modal] = collate_audio_inputs(proc, arrays)
            else:
                out[modal] = np.asarray(items, np.float32)
        return out

    def _merge_modal_inputs(self, decoded: list):
        """Per-request decoded modal inputs as one batch dict: packing takes
        the feature instances in row-major order (core/packing.py), so each
        modality's instances concatenated in request order pack every
        request's media into one generation."""
        merged: dict = {}
        for d in decoded:
            for modal, val in (d or {}).items():
                merged.setdefault(modal, []).append(val)
        out = {}
        for modal, vals in merged.items():
            if isinstance(vals[0], dict):  # audio {inputs, padding_mask}
                out[modal] = {k: np.concatenate([np.asarray(v[k])
                                                 for v in vals], axis=0)
                              for k in vals[0]}
            else:
                out[modal] = np.concatenate([np.asarray(v) for v in vals],
                                            axis=0)
        return out

    def _prepare_request(self, r):
        """request dict -> (ids, modal_inputs, max_new, temperature, top_p)
        for the continuous-batching engine (top_p honoured as in the
        reference worker, reference: serve/model_worker.py:156-178)."""
        ids = np.asarray(tokenizer_modal_token(r["prompt"], self.tokenizer),
                         np.int64)
        modal_inputs = self.decode_modal_inputs(r.get("modal_inputs"))
        return (ids, modal_inputs, _budget(r),
                float(r.get("temperature", 1.0)),
                float(r.get("top_p", 1.0)))

    def _stream_batch(self, requests, emit):
        """Pack the whole micro-batch, media included, into ONE generation
        and stream each request's tokens (MultimodalLM.generate_stream)."""
        ids_rows, decoded = [], []
        for r in requests:
            decoded.append(self.decode_modal_inputs(r.get("modal_inputs")))
            ids_rows.append(np.asarray(
                tokenizer_modal_token(r["prompt"], self.tokenizer),
                np.int64))
        cancels = [r.get("_cancel") for r in requests]

        def cancelled(i):
            return cancels[i] is not None and cancels[i].is_set()

        self.model.generate_stream(
            ids_rows, self._merge_modal_inputs(decoded),
            max_new_tokens=[_budget(r) for r in requests],
            temperatures=[float(r.get("temperature", 1.0))
                          for r in requests],
            top_ps=[float(r.get("top_p", 1.0)) for r in requests],
            emit=emit,
            rng_seed=None,  # OS entropy: a clock seed would repeat draws
            cancelled=cancelled)

    def generate_stream(self, params: dict, cancel=None):
        """Yield b"\\0"-delimited JSON chunks as tokens decode (the
        reference's TextIteratorStreamer wire format, reference:
        model_worker.py:122-192).

        Stop matching is substring (rfind) over the generated text so far,
        the reference's KeywordsStoppingCriteria semantics (reference:
        mm_utils.py:136-139).  On a stop hit, a client disconnect
        (GeneratorExit) or any other exit, the request's cancel event tells
        the engine to drop the row, so it stops taking decode steps."""
        prompt = params["prompt"]
        stop_str = params.get("stop")
        # The HTTP layer passes its own event so it can cancel the row even
        # while this generator runs in an executor thread (closing a
        # running generator raises ValueError and would skip the finally).
        cancel = threading.Event() if cancel is None else cancel
        params = dict(params)
        params["_cancel"] = cancel
        with self._queue_lock:
            self.queue_length += 1
        try:
            events = self.engine.submit(params)
            tokens: list = []
            while True:
                kind, payload = events.get()
                if kind == "error":
                    # in band, as the reference's wire format reports it
                    # (a terminal chunk with error_code != 0)
                    logger.error(f"generation error: {payload}")
                    yield json.dumps(
                        {"text": f"{prompt} [SERVER ERROR: {payload}]",
                         "error_code": 1}).encode() + b"\0"
                    return
                if kind == "done":
                    break
                tokens.append(payload)
                text = self.tokenizer.decode(tokens,
                                             skip_special_tokens=True)
                hit = text.rfind(stop_str) if stop_str else -1
                if hit >= 0:
                    yield json.dumps({"text": prompt + text[:hit],
                                      "error_code": 0}).encode() + b"\0"
                    break
                yield json.dumps({"text": prompt + text,
                                  "error_code": 0}).encode() + b"\0"
        finally:
            # stop hit / disconnect / error / normal end: release the row
            cancel.set()
            with self._queue_lock:
                self.queue_length -= 1
        if not tokens:  # an empty generation still answers the request
            yield json.dumps({"text": prompt,
                              "error_code": 0}).encode() + b"\0"


def build_app(worker: ModelWorker):
    import asyncio

    from aiohttp import web
    routes = web.RouteTableDef()

    @routes.post("/worker_generate_stream")
    async def generate_stream(request):
        params = await request.json()
        resp = web.StreamResponse()
        await resp.prepare(request)
        loop = asyncio.get_event_loop()
        cancel = threading.Event()
        gen = worker.generate_stream(params, cancel=cancel)
        sentinel = object()
        try:
            while True:  # write each chunk the moment it is produced
                chunk = await loop.run_in_executor(None, next, gen, sentinel)
                if chunk is sentinel:
                    break
                await resp.write(chunk)
        finally:
            # Client disconnect / task cancellation: set the event FIRST;
            # it works even while the generator is inside next() in the
            # executor thread, where close() raises ValueError.
            cancel.set()
            try:
                gen.close()
            except ValueError:  # still running in the thread; the event
                pass            # already released the row
        return resp

    @routes.post("/worker_get_status")
    async def get_status(request):
        return web.json_response(worker.status())

    app = web.Application()
    app.add_routes(routes)
    return app


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:21002")
    parser.add_argument("--controller-address", "--controller", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--load-8bit", action="store_true",
                        help="weight-only int8 backbone (reference "
                             "builder.py load_in_8bit role)")
    parser.add_argument("--fold-decode", action="store_true",
                        help="dense-fold the default adapter mix into W "
                             "(production serving setup)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: shard the backbone "
                             "Megatron-style over N GPUs, one process each "
                             "(torchrun --nproc-per-node N); rank 0 serves "
                             "HTTP, the others follow its backbone calls")
    parser.add_argument("--continuous-batching", action="store_true",
                        help="slot-based scheduling: arrivals join the "
                             "running packed generation (serve/"
                             "slot_engine.py)")
    parser.add_argument("--slot-cache-len", type=int, default=1024)
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="chunked admission prefill: decode ticks for "
                             "in-flight requests interleave between "
                             "N-token prefill pieces")
    parser.add_argument("--slot-kv-quant", action="store_true",
                        help="int8-quantized pooled KV cache for the slot "
                             "engine (half the cache bytes; composes with "
                             "--prefill-chunk)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    from ..models.loader import load_pretrained_model
    from ..parallel import distributed
    if args.tp > 1 and not distributed.is_initialized():
        distributed.initialize()  # torchrun's environment
    loader = functools.partial(load_pretrained_model,
                               load_8bit=args.load_8bit,
                               fold_decode_dense=args.fold_decode,
                               tp=args.tp, device=resolve_device(args.device))
    if not distributed.is_primary():
        # a follower: its shard of the backbone, driven by rank 0's calls
        follow(loader, args.model_path, args.model_base, args.model_name)
        return
    worker = ModelWorker(args.controller_address, args.worker_address,
                         args.model_path, args.model_base, args.model_name,
                         args.limit_model_concurrency, args.no_register,
                         loader=loader,
                         continuous_batching=args.continuous_batching,
                         slot_cache_len=args.slot_cache_len,
                         prefill_chunk=args.prefill_chunk,
                         slot_kv_quant=args.slot_kv_quant,
                         device=args.device)
    from aiohttp import web
    try:
        web.run_app(build_app(worker), host=args.host, port=args.port)
    finally:
        worker.close()


def follow(loader, model_path, model_base, model_name=None) -> None:
    """A tensor-parallel follower rank: load the same checkpoint (its
    shard) and run the leader's backbone calls until the leader stops."""
    name = model_name or model_path.rstrip("/").split("/")[-1]
    _, model, _, _ = loader(model_path, model_base, name,
                            load_tokenizer_fn=lambda _: None)
    model.serving.follow()


if __name__ == "__main__":
    main()
