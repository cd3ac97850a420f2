"""Serving smoke test: one request through the controller (reference:
modelcompose/serve/test_message.py; the port's copy of
modelcompose_tpu/serve/test_message.py)."""

from __future__ import annotations

import argparse
import json

import requests


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--worker-address", type=str, default=None)
    parser.add_argument("--model-name", type=str, required=True)
    parser.add_argument("--message", type=str,
                        default="Tell me a story with more than 1000 words.")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    args = parser.parse_args()

    if args.worker_address:
        worker_addr = args.worker_address
    else:
        r = requests.post(args.controller_address + "/list_models")
        models = r.json()["models"]
        print(f"Models: {models}")
        r = requests.post(args.controller_address + "/get_worker_address",
                          json={"model": args.model_name})
        worker_addr = r.json()["address"]
        print(f"worker_addr: {worker_addr}")
    if worker_addr == "":
        return

    headers = {"User-Agent": "modelcompose-tpu Client"}
    payload = {"model": args.model_name,
               "prompt": args.message,
               "max_new_tokens": args.max_new_tokens,
               "temperature": 0.0,
               "stop": "</s>"}
    response = requests.post(worker_addr + "/worker_generate_stream",
                             headers=headers, json=payload, stream=True)
    print(f"{args.message}", end="")
    for chunk in response.iter_lines(decode_unicode=False,
                                     delimiter=b"\0"):
        if chunk:
            data = json.loads(chunk.decode())
            print(data["text"], end="\r")
    print()


if __name__ == "__main__":
    main()
