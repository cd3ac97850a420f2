"""Serving controller: worker registry + request dispatch (the port's
copy of modelcompose_tpu/serve/controller.py; it holds no model code).

Rebuild of the reference's FastChat-style controller (reference:
modelcompose/serve/controller.py:28-218) on aiohttp (fastapi/uvicorn are not
in this image): workers register and heartbeat (expiry
CONTROLLER_HEART_BEAT_EXPIRATION, reference: modelcompose/constants.py:1-2),
requests are dispatched by lottery (queue-length-weighted random) or
shortest-queue, and /worker_generate_stream proxies the worker's
b"\\0"-delimited JSON chunk stream.

Usage: python -m modelcompose_tpu_torch.serve.controller --host 0.0.0.0 \\
    --port 21001
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
from typing import Dict, List

import numpy as np
from aiohttp import ClientSession, ClientTimeout, web

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION
from ..utils.logging import build_logger

logger = build_logger("controller", "controller.log")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: int
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = dispatch_method

    # -- registry ----------------------------------------------------
    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: dict) -> bool:
        if worker_status is None:
            return False
        self.worker_info[worker_name] = WorkerInfo(
            model_names=worker_status["model_names"],
            speed=worker_status.get("speed", 1),
            queue_length=worker_status.get("queue_length", 0),
            check_heart_beat=check_heart_beat,
            last_heart_beat=time.time())
        logger.info(f"Register worker: {worker_name}")
        return True

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        if worker_name not in self.worker_info:
            return False
        info = self.worker_info[worker_name]
        info.queue_length = queue_length
        info.last_heart_beat = time.time()
        return True

    def remove_stale_workers(self) -> None:
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        for name in [n for n, i in self.worker_info.items()
                     if i.check_heart_beat and i.last_heart_beat < expire]:
            logger.info(f"Remove stale worker: {name}")
            del self.worker_info[name]

    def list_models(self) -> List[str]:
        names = set()
        for info in self.worker_info.values():
            names.update(info.model_names)
        return sorted(names)

    def get_worker_address(self, model_name: str,
                           rng: np.random.Generator = None) -> str:
        """reference: controller.py:120-171."""
        rng = rng or np.random.default_rng()
        candidates = [(n, i) for n, i in self.worker_info.items()
                      if model_name in i.model_names]
        if not candidates:
            return ""
        if self.dispatch_method == "lottery":
            speeds = np.array([i.speed for _, i in candidates], np.float32)
            if speeds.sum() <= 0:
                return ""
            pick = rng.choice(len(candidates), p=speeds / speeds.sum())
            return candidates[pick][0]
        # shortest queue, normalized by speed
        qlen = [i.queue_length / max(i.speed, 1e-9) for _, i in candidates]
        min_index = int(np.argmin(qlen))
        name = candidates[min_index][0]
        candidates[min_index][1].queue_length += 1
        return name


def build_app(controller: Controller) -> web.Application:
    routes = web.RouteTableDef()

    @routes.post("/register_worker")
    async def register_worker(request):
        data = await request.json()
        ok = controller.register_worker(
            data["worker_name"], data["check_heart_beat"],
            data.get("worker_status"))
        return web.json_response({"exist": ok})

    @routes.post("/receive_heart_beat")
    async def receive_heart_beat(request):
        data = await request.json()
        exist = controller.receive_heart_beat(data["worker_name"],
                                              data["queue_length"])
        return web.json_response({"exist": exist})

    @routes.post("/refresh_all_workers")
    async def refresh_all_workers(request):
        controller.remove_stale_workers()
        return web.json_response({})

    @routes.post("/list_models")
    async def list_models(request):
        return web.json_response({"models": controller.list_models()})

    @routes.post("/get_worker_address")
    async def get_worker_address(request):
        data = await request.json()
        addr = controller.get_worker_address(data["model"])
        return web.json_response({"address": addr})

    @routes.post("/worker_generate_stream")
    async def worker_generate_stream(request):
        data = await request.json()
        addr = controller.get_worker_address(data.get("model", ""))
        resp = web.StreamResponse()
        await resp.prepare(request)
        if not addr:
            await resp.write(json.dumps(
                {"text": "No available worker", "error_code": 2}
            ).encode() + b"\0")
            return resp
        try:
            # no total deadline (aiohttp defaults to 5 min, which would
            # kill long generations mid-stream); keep a connect timeout
            # so a dead worker fails fast
            timeout = ClientTimeout(total=None, sock_connect=10)
            async with ClientSession(timeout=timeout) as session:
                async with session.post(addr + "/worker_generate_stream",
                                        json=data) as upstream:
                    async for chunk in upstream.content.iter_any():
                        await resp.write(chunk)
        except Exception as e:  # noqa: BLE001 — worker died mid-stream
            # terminal in-band error chunk (reference controller
            # semantics): the client must not see a silently truncated
            # stream rendered as a complete answer
            await resp.write(json.dumps(
                {"text": f"worker stream error: {e}", "error_code": 1}
            ).encode() + b"\0")
        return resp

    async def heartbeat_sweeper(app):
        async def sweep():
            while True:
                await asyncio.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
                controller.remove_stale_workers()
        task = asyncio.create_task(sweep())
        yield
        task.cancel()

    app = web.Application()
    app.add_routes(routes)
    app.cleanup_ctx.append(heartbeat_sweeper)
    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument("--dispatch-method", type=str,
                        default="shortest_queue",
                        choices=["lottery", "shortest_queue"])
    args = parser.parse_args()
    controller = Controller(args.dispatch_method)
    web.run_app(build_app(controller), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
