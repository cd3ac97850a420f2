"""Manually register a model worker with the controller
(reference: modelcompose/serve/register_worker.py; the port's copy of
modelcompose_tpu/serve/register_worker.py)."""

from __future__ import annotations

import argparse

import requests


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str, required=True)
    parser.add_argument("--worker-name", type=str, required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args()

    url = args.controller_address + "/register_worker"
    data = {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    }
    r = requests.post(url, json=data)
    assert r.status_code == 200


if __name__ == "__main__":
    main()
