"""Browser chat UI over the controller (the port's copy of
modelcompose_tpu/serve/web_server.py; it holds no model code).

Rebuild of the reference's gradio web server (reference: modelcompose/serve/
gradio_web_server.py) as a dependency-free aiohttp page: lists models from
the controller, posts chats through ``/worker_generate_stream`` with the
vicuna_v1 template, renders the streamed result.

Usage: python -m modelcompose_tpu_torch.serve.web_server \
    --controller-url http://localhost:21001 --port 7860
"""

from __future__ import annotations

import argparse
import html
import json

from aiohttp import ClientSession, web

from ..data.conversation import SeparatorStyle, conv_templates

PAGE = """<!doctype html>
<title>ModelCompose-TPU chat</title>
<h2>ModelCompose-TPU — chat</h2>
<form method=post action=/chat>
  Model: <select name=model>{options}</select><br>
  Message: <input type=text name=message size=90><br>
  Temperature: <input type=number name=temperature value=0.2 step=0.1
                      min=0 max=2>
  Top-p: <input type=number name=top_p value=0.7 step=0.05 min=0 max=1><br>
  <input type=submit value=Send>
</form>
<pre>{answer}</pre>
"""


class WebServer:
    def __init__(self, controller_url: str, conv_mode: str = "vicuna_v1"):
        self.controller_url = controller_url
        self.conv_mode = conv_mode

    async def list_models(self):
        async with ClientSession() as session:
            async with session.post(self.controller_url +
                                    "/list_models") as r:
                return (await r.json())["models"]

    async def handle_index(self, request):
        models = await self.list_models()
        options = "".join(
            f"<option>{html.escape(m)}</option>" for m in models)
        return web.Response(text=PAGE.format(options=options, answer=""),
                            content_type="text/html")

    async def handle_chat(self, request):
        data = await request.post()
        model = data.get("model", "")
        message = data.get("message", "")
        conv = conv_templates[self.conv_mode].copy()
        conv.append_message(conv.roles[0], message)
        conv.append_message(conv.roles[1], None)
        stop = conv.sep if conv.sep_style != SeparatorStyle.TWO \
            else conv.sep2
        # temperature/top_p exposed like the reference UI (default
        # top_p 0.7, reference: serve/gradio_web_server.py:339-340)
        def _num(name, default, lo, hi):
            try:
                return min(hi, max(lo, float(data.get(name, default))))
            except (TypeError, ValueError):
                return default

        payload = {"model": model, "prompt": conv.get_prompt(),
                   "temperature": _num("temperature", 0.2, 0.0, 2.0),
                   # HF's TopPLogitsWarper rejects top_p=0; clamp the
                   # lower bound so a typed 0 doesn't silently degrade to
                   # argmax-only sampling
                   "top_p": _num("top_p", 0.7, 0.01, 1.0),
                   "max_new_tokens": 256, "stop": stop}
        answer = ""
        async with ClientSession() as session:
            async with session.post(
                    self.controller_url + "/worker_generate_stream",
                    json=payload) as r:
                buf = b""
                async for chunk in r.content.iter_any():
                    buf += chunk
                for part in buf.split(b"\0"):
                    if part:
                        answer = json.loads(part).get("text", answer)
        models = await self.list_models()
        options = "".join(
            f"<option>{html.escape(m)}</option>" for m in models)
        # escape model output before HTML interpolation: a generation
        # containing </pre><script>... would otherwise execute in the
        # chat origin (reflected XSS) or garble the transcript
        return web.Response(text=PAGE.format(options=options,
                                             answer=html.escape(answer)),
                            content_type="text/html")


def build_app(server: WebServer) -> web.Application:
    app = web.Application()
    app.router.add_get("/", server.handle_index)
    app.router.add_post("/chat", server.handle_chat)
    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-url", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--conv-mode", type=str, default="vicuna_v1")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    args = parser.parse_args()
    web.run_app(build_app(WebServer(args.controller_url, args.conv_mode)),
                host=args.host, port=args.port)


if __name__ == "__main__":
    main()
