"""Standalone multimodal demo server (counterpart of
modelcompose_tpu/serve/demo_app.py).

Rebuild of the reference's gradio ``demo_app.py`` (reference: demo_app.py:
77-269): loads a merged all-modality checkpoint directly (no controller)
onto the card (or ``--device``), prepends ``image:<image>\\n`` etc. per
uploaded file (reference: demo_app.py:84-97), and greedy-generates.  The
UI is a minimal single-page HTML form served by aiohttp with the same
request semantics (multipart upload per modality + question).

Usage: python -m modelcompose_tpu_torch.serve.demo_app --model-path merged \\
    --model-base vicuna --port 7860
"""

from __future__ import annotations

import argparse
import functools
import html
import io
import tempfile

import numpy as np
from aiohttp import web

from ..data import conversation as conversation_lib
from ..data.conversation import SeparatorStyle, conv_templates
from ..data.tokenization import tokenizer_modal_token
from ..devices import resolve_device

PAGE = """<!doctype html>
<title>ModelCompose-TPU demo</title>
<h2>ModelCompose-TPU — composed multimodal chat</h2>
<form method=post enctype=multipart/form-data action=/generate>
  Image: <input type=file name=image><br>
  Audio (wav): <input type=file name=audio><br>
  Video (mp4): <input type=file name=video><br>
  Point cloud (npy): <input type=file name=point><br>
  Question: <input type=text name=question size=80><br>
  Beams: <input type=number name=num_beams value=1 min=1 max=8><br>
  <input type=submit value=Ask>
</form>
<pre>{answer}</pre>
"""


class DemoApp:
    def __init__(self, model_path, model_base, conv_mode="vicuna_v1",
                 loader=None, device=None):
        if loader is None:
            from ..models.loader import load_pretrained_model
            loader = functools.partial(load_pretrained_model,
                                       device=resolve_device(device))
        name = model_path.rstrip("/").split("/")[-1]
        (self.tokenizer, self.model, self.processors, _) = loader(
            model_path, model_base, name)
        self.conv_mode = conv_mode
        conversation_lib.default_conversation = conv_templates[conv_mode]

    async def handle_index(self, request):
        return web.Response(text=PAGE.format(answer=""),
                            content_type="text/html")

    async def handle_generate(self, request):
        data = await request.post()
        question = data.get("question", "")
        modal_inputs = {}
        prefix = ""
        # per-file modal prompts (reference: demo_app.py:84-97)
        if getattr(data.get("image"), "file", None):
            from ..data.image_io import load_image
            from ..data.image_processing import process_images
            img = load_image(data["image"].file.read())
            modal_inputs["vision"] = process_images(
                [img], self.processors["vision"],
                image_aspect_ratio="pad")
            prefix += "image:<image>\n"
        if getattr(data.get("audio"), "file", None):
            from ..data.audio_processing import collate_audio_inputs
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(data["audio"].file.read())
                f.flush()
                modal_inputs["audio"] = collate_audio_inputs(
                    self.processors["audio"], [f.name])
            prefix += "audio:<audio>\n"
        if getattr(data.get("video"), "file", None):
            with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
                f.write(data["video"].file.read())
                f.flush()
                modal_inputs["video"] = self.processors["video"](f.name)
            prefix += "video:<video>\n"
        if getattr(data.get("point"), "file", None):
            arr = np.load(io.BytesIO(data["point"].file.read()))
            modal_inputs["point"] = self.processors["point"]([arr])
            prefix += "point cloud:<point>\n"

        conv = conv_templates[self.conv_mode].copy()
        conv.append_message(conv.roles[0], prefix + question)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_modal_token(conv.get_prompt(),
                                               self.tokenizer), np.int64)
        # num_beams passthrough (reference: demo_app.py:129-134 forwards
        # it to HF generate)
        try:
            num_beams = min(8, max(1, int(data.get("num_beams", 1) or 1)))
        except (TypeError, ValueError):
            num_beams = 1
        tokens = self.model.generate([ids], modal_inputs,
                                     max_new_tokens=128,
                                     num_beams=num_beams)[0]
        text = self.tokenizer.decode(tokens, skip_special_tokens=True)
        stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        if stop and text.endswith(stop):
            text = text[:-len(stop)]
        # escape the model's output before it goes into the page (XSS)
        return web.Response(text=PAGE.format(
            answer=html.escape(text.strip())), content_type="text/html")


def build_app(demo: DemoApp) -> web.Application:
    app = web.Application()
    app.router.add_get("/", demo.handle_index)
    app.router.add_post("/generate", demo.handle_generate)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--conv-mode", type=str, default="vicuna_v1")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    demo = DemoApp(args.model_path, args.model_base, args.conv_mode,
                   device=args.device)
    web.run_app(build_app(demo), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
